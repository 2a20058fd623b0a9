"""The split3 route of the ring's block wrappers on the CPU: the plain
three-plane split (``split_planes_reference``, which the pre-pass kernel
``csrc/split_planes.cu`` is held against bit for bit on the card) and a
plain emulation of the six-product arithmetic of the split3 kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), held against f64
attention.

The emulation splits each f32 operand of a product into its three bf16
planes and sums the plane products x_i y_j with i + j <= 2, each a whole
f32 einsum of bf16 values (a product of two 8-bit significands is exact in
f32). Its error against f64 must be at most twice that of the f32 plain
version (``flash_attention_reference``,
``flash_attention_backward_reference``), forward and backward against an
outside lse, at head dims 16, 24 and 64 on
``tests/test_torch_flash_block.py``'s shapes. That checks the plane
algebra: dropping the three smallest plane products is safe. It does not
model how the kernels sum: the tensor cores' accumulator does not round to
nearest, and its drift across a block's tiles is held only on the card, by
``chip_smoke.py``'s f64 gate (each ring's error at most twice the dense
``fma`` kernels' own).
"""

import numpy as np
import pytest
import torch

from trlx_tpu_torch.ops import flash_attention as tfa

NEG_INF = -1e9
PAIRS = [(i, j) for i in range(3) for j in range(3) if i + j <= 2]
#: below 2^-110 the last plane falls under bf16's subnormal spacing (2^-133)
EXACT_FROM = 2.0 ** -110


def _sum_planes(planes):
    """x0 + x1 + x2 in f32, largest first."""
    p = planes.float()
    return (p[0] + p[1]) + p[2]


def _ulp(x: np.ndarray) -> np.ndarray:
    x = np.abs(x.astype(np.float32))
    return np.spacing(x).astype(np.float64)


def test_three_planes_sum_back_to_x(tmp_path):
    """x0 + x1 + x2 is x within one f32 ulp from 2^-110 up (exactly, in
    fact: each residual is exact and the last fits bf16), signs and zeros
    included; below, down through f32's subnormals, within half of bf16's
    subnormal spacing (2^-134), the last plane's rounding."""
    pytest.importorskip("hypothesis")
    from hypothesis import configuration, given, settings
    from hypothesis import strategies as st

    finite_f32 = st.floats(min_value=-2.0 ** 126, max_value=2.0 ** 126, allow_nan=False,
                           allow_infinity=False, width=32)

    @settings(max_examples=300, deadline=None, database=None)
    @given(st.lists(finite_f32, min_size=1, max_size=64))
    def check(values):
        x = torch.tensor(values, dtype=torch.float32)
        planes = tfa.split_planes_reference(x.reshape(1, -1, 1, 1))
        assert planes.shape == (3, 1, len(values), 1, 1) and planes.dtype == torch.bfloat16
        got = _sum_planes(planes).reshape(-1).double().numpy()
        want = x.double().numpy()
        err = np.abs(got - want)
        normal = np.abs(want) >= EXACT_FROM
        assert (err[normal] <= _ulp(want[normal])).all()
        assert (err[~normal] <= 2.0 ** -134).all()

    # hypothesis writes its caches under the test's temporary directory,
    # not in the working directory
    configuration.set_hypothesis_home_dir(tmp_path)
    try:
        check()
    finally:
        configuration.set_hypothesis_home_dir(None)


@pytest.mark.parametrize("exponent", [-110, -100, -60, -1, 0, 30, 125])
def test_three_planes_are_exact_at_the_ends_of_the_range(exponent):
    """Around 2^e at the ends of the range, with every significand bit
    set and signs mixed: the planes sum back to x exactly, and each is the
    previous residual rounded to nearest even."""
    rng = np.random.default_rng(exponent + 200)
    mant = 1.0 + rng.integers(0, 2 ** 23, size=257) / 2.0 ** 23
    mant[0] = 2.0 - 2.0 ** -23  # all 24 bits set
    x = torch.tensor(mant * 2.0 ** exponent * rng.choice([-1.0, 1.0], size=257),
                     dtype=torch.float32)
    planes = tfa.split_planes_reference(x.reshape(1, 1, 1, -1))
    assert torch.equal(_sum_planes(planes).reshape(-1), x)
    rest = x.reshape(1, 1, 1, -1)
    for p in range(3):
        assert torch.equal(planes[p], rest.to(torch.bfloat16))
        rest = rest - planes[p].float()


def test_split_planes_on_the_cpu_is_the_plain_split_and_refuses_other_dtypes():
    x = torch.randn(2, 5, 3, 16).transpose(1, 2)
    assert torch.equal(tfa.split_planes(x), tfa.split_planes_reference(x))
    for bad in (x.bfloat16(), x.double(), x[0]):
        with pytest.raises(ValueError, match="split_planes"):
            tfa.split_planes(bad)


@pytest.mark.parametrize("dtype, Q, variant", [
    (torch.float32, 1, "split3"), (torch.float32, 9, "split3"), (torch.float32, 2048, "split3"),
    (torch.bfloat16, 9, "decode"), (torch.bfloat16, 17, "tile"), (torch.bfloat16, 2048, "tile")])
def test_block_forward_variant(dtype, Q, variant):
    """The ring's block forward takes ``split3`` in f32 at every width and
    the dense call's variant in bf16; dense calls keep ``fma`` in f32."""
    assert tfa.block_forward_variant(dtype, Q) == variant
    if dtype == torch.bfloat16:
        assert variant == tfa.forward_variant(dtype, Q)
    else:
        assert tfa.forward_variant(dtype, Q) == "fma" and tfa.backward_variant(dtype) == "fma"


# ---------------------------------------------------------------------------
# The six-product arithmetic against f64
# ---------------------------------------------------------------------------


def _split3_einsum(eq, a, b):
    """einsum(eq, a, b) of f32 operands through the plane products the
    split3 kernels take (i + j <= 2), smallest terms first, each a whole
    f32 einsum."""
    pa, pb = (tfa.split_planes_reference(x).float() for x in (a, b))
    out = None
    for i, j in sorted(PAIRS, key=lambda ij: -(ij[0] + ij[1])):
        term = torch.einsum(eq, pa[i], pb[j])
        out = term if out is None else out + term
    return out


def _inputs(D, kind, seed=0):
    """tests/test_torch_flash_block.py's block: B = 2, Tq = 24, Tk = 40,
    H = 2, a bias masking 15 % of the pairs (or all of them), from a numpy
    seed; and the outside lse's o, lse + 0.3 and dO, from the random bias's
    block."""
    rng = np.random.default_rng(seed)
    B, Tq, Tk, H = 2, 24, 40, 2
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32))
               for T in (Tq, Tk, Tk))
    live = rng.random((B, 1, Tq, Tk)) < 0.15
    masked = live if kind == "random" else np.ones_like(live)
    bias = torch.from_numpy(np.where(masked, NEG_INF, 0.0).astype(np.float32))
    outside = torch.from_numpy(np.where(live, NEG_INF, 0.0).astype(np.float32))
    o, lse = tfa.flash_attention_reference(q, k, v, outside, False, True)
    do = torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))
    return q, k, v, bias, o, lse + 0.3, do


def _forward(q, k, v, bias, einsum):
    """O [B, Q, H, D] and lse of softmax(q k^T / sqrt(D) + bias) v, each
    product through ``einsum``, in the inputs' dtype."""
    logits = einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5 + bias.to(q.dtype)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = einsum("bhqk,bkhd->bqhd", p, v) / l.squeeze(-1).transpose(1, 2)[..., None]
    return o, (m + torch.log(l)).squeeze(-1)


def _backward(q, k, v, bias, o, lse, do, einsum):
    """dq, dk, dv against the outside (o, lse), each product through
    ``einsum``; delta = rowsum(dO O) in the inputs' dtype."""
    scale = q.shape[-1] ** -0.5
    logits = einsum("bqhd,bkhd->bhqk", q, k) * scale + bias.to(q.dtype)
    p = torch.exp(logits - lse[..., None])
    delta = torch.einsum("bqhd,bqhd->bhq", do, o)
    ds = p * (einsum("bqhd,bkhd->bhqk", do, v) - delta[..., None])
    return (einsum("bhqk,bkhd->bqhd", ds, k) * scale, einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            einsum("bhqk,bqhd->bkhd", p, do))


def _max_err(got, want):
    return (got.double() - want).abs().max().item()


@pytest.mark.parametrize("kind", ["random", "all"])
@pytest.mark.parametrize("D", [16, 24, 64])
def test_six_products_forward_against_f64(D, kind):
    """O and lse of the emulated split3 forward are at most twice as far
    from f64 attention as the f32 plain version's."""
    q, k, v, bias, *_ = _inputs(D, kind)
    exact_o, exact_lse = _forward(*(x.double() for x in (q, k, v)), bias, torch.einsum)
    emu_o, emu_lse = _forward(q, k, v, bias, _split3_einsum)
    plain_o, plain_lse = tfa.flash_attention_reference(q, k, v, bias, False, True)
    assert _max_err(emu_o, exact_o) <= 2 * _max_err(plain_o, exact_o)
    # the lse of a wholly masked block sits at -1e9, where an f32 ulp is 64
    tol = 2 * _max_err(plain_lse, exact_lse) + (64 if kind == "all" else 0)
    assert _max_err(emu_lse, exact_lse) <= tol
    if kind == "random":  # f32 keeps no logit of a wholly masked block (ulp 64 at -1e9)
        assert _max_err(emu_o, exact_o) < 1e-5 * max(1.0, exact_o.abs().max().item())


@pytest.mark.parametrize("kind", ["random", "all"])
@pytest.mark.parametrize("D", [16, 24, 64])
def test_six_products_backward_against_f64_with_outside_lse(D, kind):
    """dq, dk, dv of the emulated split3 backward against an outside lse
    are at most twice as far from f64 as the f32 plain backward's; a
    wholly masked block's are exactly 0 in both."""
    q, k, v, bias, o, lse, do = _inputs(D, kind)
    exact = _backward(*(x.double() for x in (q, k, v)), bias, o.double(), lse.double(),
                      do.double(), torch.einsum)
    emu = _backward(q, k, v, bias, o, lse, do, _split3_einsum)
    plain = tfa.flash_attention_backward_reference(q, k, v, bias, o, lse, do)
    for name, e, p, x in zip(("dq", "dk", "dv"), emu, plain, exact):
        assert _max_err(e, x) <= 2 * _max_err(p, x), name
        if kind == "all":
            assert not e.any() and not p.any(), name
        else:
            assert _max_err(e, x) < 1e-5 * max(1.0, x.abs().max().item()), name


def test_the_dropped_plane_products_are_below_f32_rounding():
    """The three plane products the kernels drop (x1 y2, x2 y1, x2 y2)
    are below 2^-24 of the product's magnitude on these inputs: the six
    kept are the f32 product within f32 rounding."""
    q, k, *_ = _inputs(64, "random")
    pq = tfa.split_planes_reference(q).float()
    pk = tfa.split_planes_reference(k).float()
    dropped = sum(torch.einsum("bqhd,bkhd->bhqk", pq[i], pk[j]).abs()
                  for i, j in ((1, 2), (2, 1), (2, 2)))
    magnitude = torch.einsum("bqhd,bkhd->bhqk", q.abs(), k.abs())
    assert (dropped <= magnitude * 2.0 ** -24).all()
