"""Card-only tests of the port's CUDA kernel path (marker ``cuda``).

They skip without a CUDA device. On a machine with an H100 run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q``
(``--noconftest`` because the suite's conftest configures JAX, which the
port's machine need not have; this file imports no JAX). They hold the
kernel against its plain version at small shapes and pin the wrapper's
contract: refusals raise and do not count, launches count one each, and
the served model runs every attention through the kernel; K1's two bf16
variants (``tile`` for Q > 16, ``decode`` for Q <= 16) match the plain
version at the edges of their shapes, each counter moves only on its own
variant, f32 takes the ``fma`` variant, and a view the 16-byte loads
cannot read is copied and counted; the backward
kernels (dQ, dK/dV) match the plain backward on the same O and LSE, bf16
takes their ``tile`` variant and f32 their ``fma`` variant, the C entry
points refuse a mismatched variant, a misaligned view is copied and
counted, and a training step runs every attention backward through them.
At ILQL's shapes: K1 at the eval prefill (Q = 16, the ``decode`` variant)
and eval step, K2/K3 at the update (T = 64, right padding), and an ILQL
update and eval decode run every attention through the kernels.
K2 with the bias gradient (T5's learned relative position bias) matches the
plain backward's dbias at the T5 update's three attention shapes in both
dtypes, counts its own launches, is refused under the causal flag, and a
T5 update step runs every self-attention backward through it.
At the continuous engine's shapes (``configs/ppo_sentiments.yml`` with
``rollout.engine: continuous``), K1 at the admission prefill (A = 32, Q =
64 over the 112-wide view, a [32, 1, 64, 112] bias) and the slot decode
(128 slots, each at its own column); one GRPO update runs every attention
through the kernels with the value head's gradient exactly zero, and one
continuous-engine phase launches K1 ``tile`` per admission prefill and
reference scoring and ``decode`` per decode step.
"""

import pytest
import torch

from trlx_tpu_torch.ops import attention as attn
from trlx_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(dev, B, Q, K, H=2, D=64, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype) for T in (Q, K, K)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize(
    "case", ["decode", "ragged_bias", "causal", "per_head", "one_key", "all_masked"]
)
def test_kernel_matches_plain(dev, dtype, case):
    B, Q, K = {"decode": (3, 1, 70), "ragged_bias": (2, 33, 95), "causal": (2, 80, 80),
               "per_head": (1, 17, 130), "one_key": (2, 5, 1), "all_masked": (2, 9, 40)}[case]
    q, k, v = _qkv(dev, B, Q, K, dtype=dtype)
    causal = case == "causal"
    bias = None
    if case in ("decode", "ragged_bias"):
        bias = torch.randn(B, 1, Q, K, device=dev)
    elif case == "per_head":
        bias = torch.randn(1, 2, Q, K, device=dev)
    elif case == "all_masked":
        bias = attn.padding_bias(torch.zeros(B, K, dtype=torch.long, device=dev))
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, bias, causal, True)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL[dtype]
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (B, 2, Q)
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse
    # without return_lse the kernel skips the LSE write; O is the same
    assert torch.equal(fa.flash_attention(q, k, v, bias, causal), o)


FWD_COUNTERS = ("FLASH_FWD_LAUNCHES", "FLASH_FWD_TILE_LAUNCHES",
                "FLASH_FWD_DECODE_LAUNCHES", "FLASH_FWD_FMA_LAUNCHES", "FLASH_FWD_COPIES")


def _fwd_counters():
    return {c: getattr(fa, c) for c in FWD_COUNTERS}


def _moved(before):
    return {c: getattr(fa, c) - n for c, n in before.items() if getattr(fa, c) != n}


def _visited_reference(q, k, v, bias, causal):
    """K1's function in plain ops: the plain forward restricted under the
    causal flag to the keys of the tiles K1 visits (as chip_smoke.py's
    ``visited_reference``), so all-padding causal rows are held too."""
    if causal:
        Q, K = q.shape[1], k.shape[1]
        skip = torch.zeros(Q, K, device=q.device).masked_fill_(
            ~fa.visited_keys(Q, K, q.device), float("-inf"))
        bias = skip if bias is None else bias.float() + skip
    return fa.flash_attention_reference(q, k, v, bias, causal, True)


EDGE_Q = (1, 2, 16, 17, 63, 64, 65, 112)
EDGE_K = (1, 63, 64, 65, 112, 576)


@pytest.mark.parametrize("K", EDGE_K)
@pytest.mark.parametrize("Q", EDGE_Q)
def test_bf16_variants_match_plain_at_the_edges(dev, Q, K):
    """Each bf16 variant at the edges of its tiles: no bias, a full-rank,
    a per-head and a broadcast padding bias, the causal flag alone and with
    left padding whose first rows see only padding keys. Only the chosen
    variant's counter (and the total) moves; nothing is copied."""
    B, H = 2, 3
    variant = fa.forward_variant(torch.bfloat16, Q)
    q, k, v = _qkv(dev, B, Q, K, H=H, dtype=torch.bfloat16, seed=1000 * Q + K)
    gen = torch.Generator(device=dev)
    gen.manual_seed(K)
    keep = (torch.rand(B, K, generator=gen, device=dev) > 0.3) | (torch.arange(K, device=dev) < 1)
    left = torch.ones(B, K, dtype=torch.long, device=dev)
    left[0, : min(K, 40)] = 0  # row 0: the first 40 keys are padding
    cases = {
        "none": (None, False),
        "full": (torch.randn(B, 1, Q, K, generator=gen, device=dev), False),
        "per_head": (torch.randn(1, H, Q, K, generator=gen, device=dev), False),
        "padding": (attn.padding_bias(keep.long()), False),
        "causal": (None, True),
        "causal_left_pad": (attn.padding_bias(left), True),
    }
    tol_o, tol_lse = TOL[torch.bfloat16]
    for name, (bias, causal) in cases.items():
        before = _fwd_counters()
        o, lse = fa.flash_attention(q, k, v, bias, causal, True)
        moved = _moved(before)
        o_ref, lse_ref = _visited_reference(q, k, v, bias, causal)
        torch.cuda.synchronize()
        assert moved == {"FLASH_FWD_LAUNCHES": 1, f"FLASH_FWD_{variant.upper()}_LAUNCHES": 1}, name
        assert o.shape == q.shape and o.dtype == torch.bfloat16 and lse.shape == (B, H, Q)
        assert torch.isfinite(o).all() and torch.isfinite(lse).all(), name
        assert (o.float() - o_ref.float()).abs().max().item() <= tol_o, name
        assert (lse - lse_ref).abs().max().item() <= tol_lse, name


@pytest.mark.parametrize("K", [1024, 4096])
def test_tile_variant_holds_over_many_key_tiles(dev, K):
    """The tile variant over 16 and 64 key tiles, with peaked logits and V
    rows that differ: P is the register A operand of O += P V in every key
    tile, so a P fragment that went stale or out of order between tiles
    would weight the wrong V rows. A per-row bias makes each row's peak
    fall in other tiles; V / 4 keeps |O| near 1, the scale TOL is set for."""
    B, Q, H = 2, 130, 3
    q, k, v = _qkv(dev, B, Q, K, H=H, dtype=torch.bfloat16, seed=K)
    q, v = q * 3, v / 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(K + 1)
    bias = 2 * torch.randn(B, 1, Q, K, generator=gen, device=dev)
    tol_o, tol_lse = TOL[torch.bfloat16]
    for b in (None, bias):
        before = _fwd_counters()
        o, lse = fa.flash_attention(q, k, v, b, False, True)
        assert _moved(before) == {"FLASH_FWD_LAUNCHES": 1, "FLASH_FWD_TILE_LAUNCHES": 1}
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, b, False, True)
        torch.cuda.synchronize()
        assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
        assert (lse - lse_ref).abs().max().item() <= tol_lse


@pytest.mark.parametrize("Q", [1, 9, 40], ids=lambda q: f"Q{q}")
def test_bf16_strided_views_read_in_place(dev, Q):
    """q/k/v as views of one packed bf16 projection (the GPT-2 layout):
    read in place by both bf16 variants, no copy."""
    qkv = torch.randn(2, 70, 3 * 128, device=dev).bfloat16()
    q, k, v = (t.view(2, 70, 2, 64) for t in qkv.split(128, dim=-1))
    q = q[:, :Q]
    before = _fwd_counters()
    o = fa.flash_attention(q, k, v, None, Q > 1)
    assert _moved(before) == {
        "FLASH_FWD_LAUNCHES": 1,
        f"FLASH_FWD_{fa.forward_variant(torch.bfloat16, Q).upper()}_LAUNCHES": 1}
    ref, _ = _visited_reference(q, k, v, None, Q > 1)
    assert (o.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16][0]


@pytest.mark.parametrize("Q", [1, 70], ids=lambda q: f"Q{q}")
def test_misaligned_view_is_copied_and_counted(dev, Q):
    """A K/V view whose row stride is not a multiple of 8 elements, and a
    q whose base is off 16 bytes: the wrapper copies each such tensor the
    variant reads with 16-byte loads, counts the copies, and gives the
    result of contiguous inputs."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    q, k, v = _qkv(dev, 2, Q, 70, dtype=torch.bfloat16, seed=8)
    wide = torch.randn(2, 70, 2 * 64 + 4, generator=gen, device=dev).bfloat16()
    k_odd = wide[..., :128].unflatten(-1, (2, 64))  # row stride 132
    k_odd.copy_(k)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    q_odd = flat[1:].view(q.shape)  # base 2 bytes past an allocation
    q_odd.copy_(q)
    assert not fa.aligned_for_16_byte_loads(k_odd) and not fa.aligned_for_16_byte_loads(q_odd)
    want = fa.flash_attention(q, k, v, None, False)
    before = _fwd_counters()
    got = fa.flash_attention(q_odd, k_odd, v, None, False)
    copies = 2 if fa.forward_variant(torch.bfloat16, Q) == "tile" else 1  # decode reads q narrow
    assert _moved(before)["FLASH_FWD_COPIES"] == copies
    assert torch.equal(got, want)


def test_f32_launches_fma_and_bf16_never_does(dev):
    for Q in (1, 16, 17, 64):
        q, k, v = _qkv(dev, 2, Q, 80)
        before = _fwd_counters()
        fa.flash_attention(q, k, v, None, True)
        assert _moved(before) == {"FLASH_FWD_LAUNCHES": 1, "FLASH_FWD_FMA_LAUNCHES": 1}
        before = _fwd_counters()
        fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), None, True)
        assert "FLASH_FWD_FMA_LAUNCHES" not in _moved(before)


def test_entry_point_refuses_a_mismatched_variant(dev):
    """The C entry point returns -1 for a variant that does not fit the
    dtype, Q or alignment, and launches nothing."""
    lib = fa._load()["flash_fwd"]
    stream = torch.cuda.current_stream().cuda_stream

    def call(q, k, v, variant):
        B, Q, H, D = q.shape
        o = torch.empty(q.shape, dtype=q.dtype, device=dev)
        return lib.trlx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), None,
            fa.FORWARD_VARIANTS[variant], fa._DTYPES[q.dtype], B, H, Q, k.shape[1], D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 0, 0, 0, 0,
            float(D ** -0.5), 0, stream)

    q32, k32, v32 = _qkv(dev, 1, 20, 30)
    q, k, v = (x.bfloat16() for x in (q32, k32, v32))
    assert call(q32, k32, v32, "fma") == 0
    assert call(q, k, v, "tile") == 0
    assert call(q[:, :4], k, v, "decode") == 0
    assert call(q, k, v, "fma") == -1          # bf16 never reaches the FMA kernel
    assert call(q32, k32, v32, "tile") == -1   # nor f32 the tensor cores
    assert call(q[:, :4], k, v, "tile") == -1  # Q <= 16 is the decode variant's
    assert call(q, k, v, "decode") == -1       # and Q > 16 the tile's
    flat = torch.empty(k.numel() + 1, dtype=torch.bfloat16, device=dev)
    assert call(q, k, flat[1:].view(k.shape), "tile") == -1  # misaligned V
    torch.cuda.synchronize()


def test_strided_inputs_read_in_place(dev):
    """q/k/v as views of one packed projection (the GPT-2 layout)."""
    qkv = torch.randn(2, 40, 3 * 128, device=dev)
    q, k, v = (t.view(2, 40, 2, 64) for t in qkv.split(128, dim=-1))
    assert not q.is_contiguous()
    ref = fa.flash_attention_reference(q, k, v, None, True)
    torch.testing.assert_close(fa.flash_attention(q, k, v, None, True), ref, atol=1e-4, rtol=0)


def test_launch_counter_and_refusals(dev):
    q, k, v = _qkv(dev, 1, 4, 8)
    before = fa.FLASH_FWD_LAUNCHES
    fa.flash_attention(q, k, v)
    assert fa.FLASH_FWD_LAUNCHES == before + 1
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())
    q32, k32, v32 = _qkv(dev, 1, 4, 8, D=32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q32, k32, v32)
    with pytest.raises(ValueError, match="LSE has no gradient"):
        fa.flash_attention(q.requires_grad_(), k, v, return_lse=True)
    assert fa.FLASH_FWD_LAUNCHES == before + 1


def test_served_model_runs_every_attention_through_the_kernel(dev):
    from trlx_tpu_torch.inference.server import InferenceServer

    cfg = {
        "model": {"model_type": "gpt2", "model_arch": {
            "vocab_size": 64, "n_positions": 64, "n_embd": 128, "n_layer": 2, "n_head": 2}},
        "train": {"seq_length": 12, "dtype": "bfloat16",
                  "rollout": {"slots": 4, "admit_width": 2, "harvest_width": 2, "block_size": 4}},
        "method": {"name": "PPOConfig", "gen_kwargs": {
            "max_new_tokens": 6, "do_sample": True, "eos_token_id": 62, "pad_token_id": 63}},
    }
    server = InferenceServer(cfg, seed=0)
    calls = []
    orig = fa.flash_attention_reference
    fa.flash_attention_reference = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    before = fa.FLASH_FWD_LAUNCHES
    try:
        out = server.generate([[1, 2, 3], [4, 5], [6] * 12])
    finally:
        fa.flash_attention_reference = orig
    stats = server.stats()
    assert all(r["length"] >= 1 for r in out)
    assert not calls
    assert fa.FLASH_FWD_LAUNCHES - before == 2 * (
        stats["engine/prefills"] + stats["engine/decode_steps"]
    )


# Backward tolerances, against the plain backward fed the kernel forward's
# own O and LSE: f32 sums in another order (1e-4 absolute, gradients of
# O(1)); bf16 outputs are rounded to bf16 from f32 sums that differ in
# order, so they may differ by up to 2 bf16 ulps at the largest magnitude
# (2^-7 of max|ref|).
def _bwd_tol(dtype, ref):
    top = max(1.0, ref.float().abs().max().item())
    return 1e-4 * top if dtype == torch.float32 else top / 128


BWD_CASES = {  # B, Q, K, causal, bias kind
    "causal_padding": (3, 112, 112, True, "pad"),
    "causal_small_q": (2, 9, 130, True, None),
    "ragged_bias": (2, 33, 95, False, "full"),
    "per_head": (1, 17, 130, False, "head"),
    "one_key": (2, 5, 1, False, None),
    "all_masked_rows": (2, 112, 112, True, "left_pad"),
    "causal_long": (2, 300, 300, True, None),
    "causal_ragged": (2, 70, 150, True, "pad"),
    # 16 query chunks and 16 key tiles; 64 key tiles with peaked logits:
    # a register A operand gone stale between chunks or tiles, or a ring
    # fault, shows here
    "long_causal": (2, 1024, 1024, True, "pad"),
    "long_k": (2, 128, 4096, False, "peaked"),
    # ILQL's update (configs/ilql_sentiments.yml): T = 64, right padding
    "ilql_update": (4, 64, 64, True, "right_pad"),
}


def _bwd_inputs(dev, case, dtype):
    B, Q, K, causal, kind = BWD_CASES[case]
    q, k, v = _qkv(dev, B, Q, K, dtype=dtype, seed=3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    bias = None
    if kind == "pad":  # padding with the first keys valid
        keep = torch.arange(K, device=dev)[None] < 4
        bias = attn.padding_bias(((torch.rand(B, K, generator=gen, device=dev) > 0.3) | keep).long())
    elif kind == "right_pad":  # samples of 9..K tokens, padded at the end
        n_tok = torch.randint(9, K + 1, (B, 1), generator=gen, device=dev)
        bias = attn.padding_bias((torch.arange(K, device=dev)[None] < n_tok).long())
    elif kind == "left_pad":  # rows 0..69 of row 0 see only padding keys
        mask = torch.ones(B, K, dtype=torch.long, device=dev)
        mask[0, :70] = 0
        bias = attn.padding_bias(mask)
    elif kind == "full":
        bias = torch.randn(B, 1, Q, K, generator=gen, device=dev)
    elif kind == "head":
        bias = torch.randn(1, 2, Q, K, generator=gen, device=dev)
    elif kind == "peaked":  # logits x3 and a per-row bias; V / 4 keeps |O| near 1
        q, v = q * 3, v / 4
        bias = 2 * torch.randn(B, 1, Q, K, generator=gen, device=dev)
    do = torch.randn(B, Q, 2, 64, generator=gen, device=dev).to(dtype)
    return q, k, v, bias, causal, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_backward_kernels_match_plain(dev, dtype, case):
    q, k, v, bias, causal, do = _bwd_inputs(dev, case, dtype)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    got = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, causal)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.isfinite(g).all(), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= _bwd_tol(dtype, w), (name, err)


def test_backward_all_masked_rows_with_zero_do(dev):
    """The PPO path's left-padding rows: dO is zero there (pad rows feed
    only pad rows); the kernels must give the plain backward's gradients
    and nothing non-finite."""
    q, k, v, bias, causal, do = _bwd_inputs(dev, "all_masked_rows", torch.float32)
    do[0, :70] = 0
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    got = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, causal)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= _bwd_tol(torch.float32, w)


def test_backward_unvisited_key_tiles_are_zero(dev):
    """Q <= 16 under the causal flag visits only the first key tile: the
    dK/dV rows of the other tiles are written as zeros."""
    q, k, v, bias, causal, do = _bwd_inputs(dev, "causal_small_q", torch.float32)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    _, dk, dv = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    assert not dk[:, 64:].any() and not dv[:, 64:].any()
    assert dk[:, :9].abs().sum() > 0


def test_backward_through_strided_views_matches_autograd_of_plain(dev):
    """The autograd Function over q/k/v views of one packed projection
    (the GPT-2 layout) against autograd through the plain forward."""
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        qkv = torch.randn(2, 40, 3 * 128, generator=gen, device=dev).requires_grad_()
        q, k, v = (t.view(2, 40, 2, 64) for t in qkv.split(128, dim=-1))
        w = torch.randn(2, 40, 2, 64, generator=gen, device=dev)
        (fn(q, k, v, None, True) * w).sum().backward()
        grads.append(qkv.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4, rtol=0)


BWD_COUNTERS = ("FLASH_BWD_DQ_LAUNCHES", "FLASH_BWD_DKV_LAUNCHES",
                "FLASH_BWD_DQ_TILE_LAUNCHES", "FLASH_BWD_DKV_TILE_LAUNCHES",
                "FLASH_BWD_DQ_FMA_LAUNCHES", "FLASH_BWD_DKV_FMA_LAUNCHES", "FLASH_BWD_COPIES")


def _bwd_counters():
    return {c: getattr(fa, c) for c in BWD_COUNTERS}


@pytest.mark.parametrize("case", ["causal_small_q", "one_key", "causal_padding", "ragged_bias"])
def test_bf16_backward_never_launches_fma_and_f32_always_does(dev, case):
    """bf16 takes the tile variant of both backward kernels, f32 the fma
    variant; each launch moves the total and its variant's counter only."""
    for dtype, variant in ((torch.bfloat16, "TILE"), (torch.float32, "FMA")):
        q, k, v, bias, causal, do = _bwd_inputs(dev, case, dtype)
        o, lse = fa.flash_attention(q, k, v, bias, causal, True)
        before = _bwd_counters()
        fa._launch_backward(q, k, v, bias, o, lse, do, causal)
        moved = {c: getattr(fa, c) - n for c, n in before.items() if getattr(fa, c) != n}
        assert moved == {"FLASH_BWD_DQ_LAUNCHES": 1, "FLASH_BWD_DKV_LAUNCHES": 1,
                         f"FLASH_BWD_DQ_{variant}_LAUNCHES": 1,
                         f"FLASH_BWD_DKV_{variant}_LAUNCHES": 1}, dtype


def test_backward_entry_points_refuse_a_mismatched_variant(dev):
    """The C entry points return -1 for a variant that does not fit the
    dtype or the alignment, and launch nothing."""
    lib = fa._load()["flash_bwd"]
    stream = torch.cuda.current_stream().cuda_stream

    def call(variant, dtype, misaligned_q=False):
        q, k, v, bias, causal, do = _bwd_inputs(dev, "causal_padding", dtype)
        o, lse = fa.flash_attention(q, k, v, bias, causal, True)
        if misaligned_q:
            flat = torch.empty(q.numel() + 1, dtype=dtype, device=dev)
            bad = flat[1:].view(q.shape)
            bad.copy_(q)
            q = bad
        args = [q, k, v, bias, o, lse, do, causal]
        _, inputs, common = fa._backward_args(*args)
        # the packing copied the misaligned q: hand the kernel the view
        inputs = (q, *inputs[1:]) if misaligned_q else inputs
        common = (fa.BACKWARD_VARIANTS[variant], *common[1:])
        ptrs = fa._pointers(inputs)
        dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=dev) for t in inputs[:3])
        return (lib.trlx_flash_bwd_dq(*ptrs, dq.data_ptr(), None, *common, stream),
                lib.trlx_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *common, stream))

    assert call("tile", torch.bfloat16) == (0, 0)
    assert call("fma", torch.float32) == (0, 0)
    assert call("fma", torch.bfloat16) == (-1, -1)  # bf16 never reaches the FMA kernels
    assert call("tile", torch.float32) == (-1, -1)  # nor f32 the tensor cores
    assert call("tile", torch.bfloat16, misaligned_q=True) == (-1, -1)
    torch.cuda.synchronize()


def test_backward_misaligned_views_are_copied_and_counted(dev):
    """q at a base off 16 bytes and k with a row stride that is no multiple
    of 8 elements: the backward's packing copies each once (once for both
    kernels), counts the copies, and gives the gradients of aligned inputs."""
    q, k, v, bias, causal, do = _bwd_inputs(dev, "causal_padding", torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    q_odd = flat[1:].view(q.shape)  # base 2 bytes past an allocation
    q_odd.copy_(q)
    wide = torch.empty(*k.shape[:2], 2 * 64 + 4, dtype=torch.bfloat16, device=dev)
    k_odd = wide[..., :128].unflatten(-1, (2, 64))  # row stride 132
    k_odd.copy_(k)
    want = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    before = _bwd_counters()
    got = fa._launch_backward(q_odd, k_odd, v, bias, o, lse, do, causal)
    assert fa.FLASH_BWD_COPIES - before["FLASH_BWD_COPIES"] == 2
    assert fa.FLASH_BWD_DQ_TILE_LAUNCHES - before["FLASH_BWD_DQ_TILE_LAUNCHES"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_backward_counters_and_refusals(dev):
    q, k, v, bias, causal, do = _bwd_inputs(dev, "one_key", torch.float32)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    dq0, dkv0 = fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES
    fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    assert (fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES) == (dq0 + 1, dkv0 + 1)
    with pytest.raises(ValueError, match="o/do must be"):
        fa._launch_backward(q, k, v, bias, o, lse, do.bfloat16(), causal)
    with pytest.raises(ValueError, match="bad shapes"):
        fa._launch_backward(q, k, v, bias, o, lse[:, :, :1], do, causal)
    assert (fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES) == (dq0 + 1, dkv0 + 1)


def test_training_step_runs_every_attention_backward_through_the_kernels(dev):
    """One PPO update of a 12-layer model on the card: the parameters
    move, and each backward kernel launches once per layer."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.ppo_types import PPORolloutBatch
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    config = TRLConfig.from_dict({
        "model": {"model_type": "gpt2", "model_arch": {
            "vocab_size": 64, "n_positions": 64, "n_embd": 128, "n_layer": 12, "n_head": 2}},
        "train": {"seq_length": 10, "batch_size": 4, "dtype": "bfloat16", "seed": 0},
        "method": {"name": "PPOConfig", "gen_kwargs": {
            "max_new_tokens": 6, "do_sample": True, "eos_token_id": 62, "pad_token_id": 63}},
    })
    trainer = PPOTrainer(config)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q_mask = (torch.arange(10, device=dev)[None] >= torch.tensor([[0], [3], [5], [9]], device=dev)).int()
    q_ids = torch.randint(0, 60, (4, 10), generator=gen, device=dev).int() * q_mask
    out = trainer.sample(q_ids, q_mask)
    mb = PPORolloutBatch(
        query_tokens=q_ids, query_mask=q_mask,
        response_tokens=out.tokens, response_mask=out.response_mask,
        logprobs=out.logprobs, values=out.values,
        rewards=torch.randn(4, 6, generator=gen, device=dev) * out.response_mask,
    )
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    dq0, dkv0, fwd0 = fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES, fa.FLASH_FWD_LAUNCHES
    stats = trainer.train_step(mb)
    torch.cuda.synchronize()
    assert fa.FLASH_BWD_DQ_LAUNCHES - dq0 == 12 and fa.FLASH_BWD_DKV_LAUNCHES - dkv0 == 12
    assert fa.FLASH_FWD_LAUNCHES - fwd0 == 12
    assert all(torch.isfinite(v).all() for v in stats.values())
    assert any(not torch.equal(before[n], p) for n, p in trainer.model.named_parameters())


# ILQL's eval decode (configs/ilql_sentiments.yml): 16 left-padded prompt
# columns over the 64-wide cache (the prefill, K1's decode variant at its
# largest Q) and one query at column 16 + t; batch cut to 4, H = 2
ILQL_DECODE_CASES = {"eval_prefill": (16, 0), "eval_step": (1, 16 + 21)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", list(ILQL_DECODE_CASES))
def test_ilql_eval_decode_shapes_match_plain(dev, dtype, case):
    Q, offset = ILQL_DECODE_CASES[case]
    q, k, v = _qkv(dev, 4, Q, 64, dtype=dtype, seed=7)
    prompt = torch.tensor([[16], [12], [9], [8]], device=dev)
    cols = torch.arange(64, device=dev)[None]
    mask = ((cols >= 16 - prompt) & (cols <= max(offset, 15))).long()
    bias = attn.causal_bias(Q, 64, offset, dev) + attn.padding_bias(mask)
    before = _fwd_counters()
    o, lse = fa.flash_attention(q, k, v, bias, False, True)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, bias, False, True)
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL[dtype]
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse
    variant = "DECODE" if dtype == torch.bfloat16 else "FMA"
    assert _moved(before) == {"FLASH_FWD_LAUNCHES": 1, f"FLASH_FWD_{variant}_LAUNCHES": 1}


def test_ilql_update_and_eval_run_every_attention_through_the_kernels(dev, tmp_path):
    """One ILQL update of a 12-layer model on the card and one eval
    decode: each update launches K1 ``tile``, K2 and K3 once per layer,
    the decode K1 ``decode`` once per layer and forward; the parameters
    and Q heads move, and the target heads stay until the sync."""
    import numpy as np

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.orchestrator.offline_orchestrator import OfflineOrchestrator
    from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer

    config = TRLConfig.from_dict({
        "model": {"model_type": "gpt2", "model_arch": {
            "vocab_size": 64, "n_positions": 64, "n_embd": 128, "n_layer": 12, "n_head": 2}},
        "train": {"seq_length": 24, "batch_size": 8, "dtype": "bfloat16", "seed": 0,
                  "checkpoint_dir": str(tmp_path)},
        "method": {"name": "ILQLConfig", "steps_for_target_q_sync": 2, "gen_kwargs": {
            "max_new_tokens": 8, "eos_token_id": 62, "pad_token_id": 63}},
    })
    trainer = ILQLTrainer(config)
    rng = np.random.default_rng(0)
    samples = [([int(t) for t in rng.integers(0, 60, int(rng.integers(9, 25)))], 4)
               for _ in range(16)]
    OfflineOrchestrator(trainer).make_experience(samples, rng.random(16).tolist())
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    target = [p.clone() for p in trainer.target.parameters()]
    counters = ("FLASH_FWD_TILE_LAUNCHES", "FLASH_FWD_DECODE_LAUNCHES", "FLASH_FWD_FMA_LAUNCHES",
                "FLASH_BWD_DQ_TILE_LAUNCHES", "FLASH_BWD_DKV_TILE_LAUNCHES")
    start = {c: getattr(fa, c) for c in counters}
    stats = trainer.train_step(trainer.store.stacked_slice(np.arange(8)))
    torch.cuda.synchronize()
    assert {c: getattr(fa, c) - n for c, n in start.items()} == {
        "FLASH_FWD_TILE_LAUNCHES": 12, "FLASH_FWD_DECODE_LAUNCHES": 0,
        "FLASH_FWD_FMA_LAUNCHES": 0, "FLASH_BWD_DQ_TILE_LAUNCHES": 12,
        "FLASH_BWD_DKV_TILE_LAUNCHES": 12}
    assert all(torch.isfinite(v).all() for v in stats.values())
    assert all(not torch.equal(before[n], p) for n, p in trainer.model.named_parameters()
               if n.startswith("heads.q"))
    assert all(torch.equal(a, b) for a, b in zip(target, trainer.target.parameters()))
    decode0, forwards0 = fa.FLASH_FWD_DECODE_LAUNCHES, trainer.forwards
    mask = (torch.arange(16, device=dev)[None] >= torch.tensor([[0], [4], [8], [12]], device=dev)).int()
    out = trainer.sample(torch.randint(0, 60, (4, 16), device=dev).int() * mask, mask)
    torch.cuda.synchronize()
    calls = trainer.forwards - forwards0
    assert calls == 8 and fa.FLASH_FWD_DECODE_LAUNCHES - decode0 == 12 * calls
    assert torch.isfinite(out.logprobs).all() and not out.values.any()


# the T5 update's attention shapes at H = 8 (configs/ppo_ul2.yml), batch cut
# to 2: encoder self-attention over 512 prompt columns and decoder
# self-attention over 49 response columns, each with a [B, H, Q, K] learned
# bias (relative table + masks); cross-attention, 49 queries over 512 keys
# with a [B, 1, 1, K] padding bias (its gradient summed from dS)
DBIAS_CASES = {"encoder_self": (2, 512, 512, "full"), "decoder_self": (2, 49, 49, "full"),
               "cross": (2, 49, 512, "pad")}


def _dbias_inputs(dev, case, dtype):
    B, Q, K, kind = DBIAS_CASES[case]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    q, k, v = (torch.randn(B, T, 8, 64, generator=gen, device=dev).to(dtype) for T in (Q, K, K))
    keep = torch.arange(K, device=dev)[None] < 4
    pad = attn.padding_bias(((torch.rand(B, K, generator=gen, device=dev) > 0.2) | keep).long())
    if kind == "full":
        bias = 2 * torch.randn(1, 8, Q, K, generator=gen, device=dev) + pad
    else:
        bias = pad
    do = torch.randn(B, Q, 8, 64, generator=gen, device=dev).to(dtype)
    return q, k, v, bias, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", list(DBIAS_CASES))
def test_backward_dbias_matches_plain(dev, dtype, case):
    """K2's bias gradient (dS, f32) against the plain backward's on the
    same O and LSE: only the order of the sums differs (1e-4 of the
    largest); dQ/dK/dV as without it."""
    q, k, v, bias, do = _dbias_inputs(dev, case, dtype)
    o, lse = fa.flash_attention(q, k, v, bias, False, True)
    before = _bwd_counters()
    dbias0 = fa.FLASH_BWD_DQ_DBIAS_LAUNCHES
    *got, dbias = fa._launch_backward(q, k, v, bias, o, lse, do, False, dbias=True)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, False, True)
    torch.cuda.synchronize()
    assert fa.FLASH_BWD_DQ_DBIAS_LAUNCHES - dbias0 == 1
    variant = "TILE" if dtype == torch.bfloat16 else "FMA"
    assert {c: getattr(fa, c) - n for c, n in before.items() if getattr(fa, c) != n} == {
        "FLASH_BWD_DQ_LAUNCHES": 1, "FLASH_BWD_DKV_LAUNCHES": 1,
        f"FLASH_BWD_DQ_{variant}_LAUNCHES": 1, f"FLASH_BWD_DKV_{variant}_LAUNCHES": 1}
    B, Q, K, _ = DBIAS_CASES[case]
    assert dbias.shape == want[3].shape == (B, 8, Q, K) and dbias.dtype == torch.float32
    assert torch.isfinite(dbias).all()
    err = (dbias - want[3]).abs().max().item()
    assert err <= 1e-4 * max(1.0, want[3].abs().max().item()), err
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert (g.float() - w.float()).abs().max().item() <= _bwd_tol(dtype, w), name


def test_dbias_is_refused_under_the_causal_flag(dev):
    """The C entry point returns -1 for dbias with the causal flag (a
    learned bias carries its causal mask), and the wrappers raise before
    launching."""
    q, k, v, bias, do = _dbias_inputs(dev, "decoder_self", torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, bias, False, True)
    _, inputs, common = fa._backward_args(q, k, v, bias, o, lse, do, True)
    dq = torch.empty_like(inputs[0])
    ds = torch.empty(2, 8, 49, 49, device=dev)
    lib = fa._load()["flash_bwd"]
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.trlx_flash_bwd_dq(*fa._pointers(inputs), dq.data_ptr(), ds.data_ptr(),
                                 *common, stream) == -1
    before = _bwd_counters()
    with pytest.raises(ValueError, match="causal=False"):
        fa._launch_backward(q, k, v, bias, o, lse, do, True, dbias=True)
    assert _bwd_counters() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_learned_bias_function_matches_autograd_of_plain(dev, dtype):
    """The autograd Function with a learned [1, H, Q, K] table under a
    padding bias: the table's gradient from K2 against autograd through
    the plain forward."""
    q0, k0, v0, _, do = _dbias_inputs(dev, "decoder_self", dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    table0 = torch.randn(1, 8, 49, 49, generator=gen, device=dev)
    pad = attn.padding_bias(torch.ones(2, 49, dtype=torch.long, device=dev))
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        xs = [x.clone().requires_grad_() for x in (q0, k0, v0, table0)]
        (fn(*xs[:3], xs[3] + pad).float() * do.float()).sum().backward()
        grads.append([x.grad for x in xs])
    for g, w in zip(*grads):
        assert (g.float() - w.float()).abs().max().item() <= _bwd_tol(dtype, w)


def test_t5_update_step_runs_every_attention_backward_through_the_kernels(dev):
    """One PPO update of a small T5 on the card: K2 and K3 launch once per
    attention (3 per decoder layer, 1 per encoder layer), K2 with the bias
    gradient once per self-attention, and the relative tables move."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.ppo_types import PPORolloutBatch
    from trlx_tpu_torch.trainer.seq2seq_ppo_trainer import Seq2SeqPPOTrainer

    config = TRLConfig.from_dict({
        "model": {"model_type": "t5", "model_arch": {
            "vocab_size": 64, "d_model": 128, "d_kv": 64, "d_ff": 256, "num_layers": 2,
            "num_decoder_layers": 2, "num_heads": 2, "feed_forward_proj": "gated-gelu",
            "tie_word_embeddings": False}},
        "train": {"seq_length": 20, "batch_size": 4, "dtype": "bfloat16", "seed": 0,
                  "trainer": "Seq2SeqPPOTrainer"},
        "method": {"name": "PPOConfig", "gen_kwargs": {
            "max_new_tokens": 6, "do_sample": True, "eos_token_id": 1, "pad_token_id": 0,
            "forced_bos_token_id": 5}},
    })
    trainer = Seq2SeqPPOTrainer(config)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q_mask = (torch.arange(20, device=dev)[None] >= torch.tensor([[0], [3], [5], [19]], device=dev)).int()
    q_ids = torch.randint(2, 60, (4, 20), generator=gen, device=dev).int() * q_mask
    out = trainer.sample(q_ids, q_mask)
    assert (out.tokens[:, 0] == 5).all()
    mb = PPORolloutBatch(
        query_tokens=q_ids, query_mask=q_mask,
        response_tokens=out.tokens, response_mask=out.response_mask,
        logprobs=out.logprobs, values=out.values,
        rewards=torch.randn(4, 6, generator=gen, device=dev) * out.response_mask,
    )
    table = trainer.model.t5.enc_rel_bias.relative_attention_bias.weight.detach().clone()
    before = _bwd_counters()
    dbias0, fwd0 = fa.FLASH_BWD_DQ_DBIAS_LAUNCHES, fa.FLASH_FWD_LAUNCHES
    stats = trainer.train_step(mb)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD_LAUNCHES - fwd0 == 6
    assert fa.FLASH_BWD_DQ_DBIAS_LAUNCHES - dbias0 == 4
    assert {c: getattr(fa, c) - n for c, n in before.items() if getattr(fa, c) != n} == {
        "FLASH_BWD_DQ_LAUNCHES": 6, "FLASH_BWD_DKV_LAUNCHES": 6,
        "FLASH_BWD_DQ_TILE_LAUNCHES": 6, "FLASH_BWD_DKV_TILE_LAUNCHES": 6}
    assert all(torch.isfinite(v).all() for v in stats.values())
    assert not torch.equal(table, trainer.model.t5.enc_rel_bias.relative_attention_bias.weight)


# the continuous engine's K1 shapes at configs/ppo_sentiments.yml (seq_length
# 64, 48 new tokens: the paged view is 112 wide), H cut to 2: an admission
# prefill of 32 left-padded prompts (causal from column 0 plus padding, the
# response columns masked) and one decode step of 128 slots, each at its
# own column 64 + t
ENGINE_CASES = {"admission_prefill": (32, 64), "slot_decode": (128, 1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_shapes_match_plain(dev, dtype, case):
    B, Q = ENGINE_CASES[case]
    q, k, v = _qkv(dev, B, Q, 112, dtype=dtype, seed=3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lens = torch.randint(16, 65, (B, 1), generator=gen, device=dev)
    cols = torch.arange(112, device=dev)[None]
    if Q > 1:
        offset, last = 0, torch.full_like(lens, 63)
    else:
        t = torch.randint(0, 48, (B,), generator=gen, device=dev)
        offset, last = 64 + t, (64 + t)[:, None]
    valid = (cols >= 64 - lens) & (cols <= last)
    bias = attn.causal_bias(Q, 112, offset, dev) + attn.padding_bias(valid.long())
    assert bias.shape == (B, 1, Q, 112)
    before = _fwd_counters()
    o, lse = fa.flash_attention(q, k, v, bias, False, True)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, bias, False, True)
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL[dtype]
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse
    variant = "FMA" if dtype == torch.float32 else ("TILE" if Q > 16 else "DECODE")
    assert _moved(before) == {"FLASH_FWD_LAUNCHES": 1, f"FLASH_FWD_{variant}_LAUNCHES": 1}


def _small_engine_config(tmp_path, **method):
    from trlx_tpu_torch.data.configs import TRLConfig

    return TRLConfig.from_dict({
        "model": {"model_type": "gpt2", "model_arch": {
            "vocab_size": 64, "n_positions": 64, "n_embd": 128, "n_layer": 12, "n_head": 2}},
        # 20 query columns: the prefills, scorings and updates (Q > 16) take
        # K1's tile variant, the decode steps its decode variant
        "train": {"seq_length": 20, "batch_size": 8, "dtype": "bfloat16", "seed": 0,
                  "checkpoint_dir": str(tmp_path),
                  "rollout": {"engine": "continuous", "admit_width": 4, "harvest_width": 4,
                              "block_size": 4}},
        "method": {"name": "PPOConfig", "num_rollouts": 8, "chunk_size": 8, **method,
                   "gen_kwargs": {"max_new_tokens": 6, "do_sample": True,
                                  "eos_token_id": 62, "pad_token_id": 63}},
    })


def _prompts(n=8):
    import numpy as np

    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, 60, int(rng.integers(2, 11)))] for _ in range(n)]


def test_grpo_update_runs_every_attention_through_the_kernels(dev, tmp_path):
    """One grouped collection and one GRPO update of a 12-layer model on
    the card: groups of 4 share a prompt, the stored advantages are
    whitened per group, the update launches K1 ``tile``, K2 and K3 once
    per layer, and the value head's gradient is exactly zero."""
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer

    config = _small_engine_config(tmp_path, name="GRPOConfig", group_size=4)
    config.train.rollout = {}
    trainer = GRPOTrainer(config)
    orch = PPOOrchestrator(trainer, PromptPipeline(_prompts(), 20),
                           reward_fn=lambda samples, **_: [len(set(s.split())) / 6.0
                                                           for s in samples],
                           chunk_size=8)
    orch.make_experience(8)
    buf = trainer.buffer.full
    q = buf.query_tokens.view(2, 4, -1)
    assert (q == q[:, :1]).all()
    adv = buf.rewards[:, 0].view(2, 4)
    assert adv.mean(1).abs().max().item() < 1e-4
    counters = ("FLASH_FWD_TILE_LAUNCHES", "FLASH_FWD_DECODE_LAUNCHES", "FLASH_FWD_FMA_LAUNCHES",
                "FLASH_BWD_DQ_TILE_LAUNCHES", "FLASH_BWD_DKV_TILE_LAUNCHES")
    start = {c: getattr(fa, c) for c in counters}
    stats = trainer.train_step(trainer.buffer.gather(torch.arange(8).numpy()))
    torch.cuda.synchronize()
    assert {c: getattr(fa, c) - n for c, n in start.items()} == {
        "FLASH_FWD_TILE_LAUNCHES": 12, "FLASH_FWD_DECODE_LAUNCHES": 0,
        "FLASH_FWD_FMA_LAUNCHES": 0, "FLASH_BWD_DQ_TILE_LAUNCHES": 12,
        "FLASH_BWD_DKV_TILE_LAUNCHES": 12}
    assert all(torch.isfinite(v).all() for v in stats.values())
    heads = [p for n, p in trainer.model.named_parameters() if n.startswith("v_head.")]
    assert heads and all(not p.grad.any() for p in heads)


def test_continuous_engine_phase_runs_every_attention_through_the_kernels(dev, tmp_path):
    """One continuous-engine collection of a 12-layer model on the card
    (8 slots, admit and harvest 4): every row harvested once, K1 ``tile``
    12 x (admission prefills + reference scorings), ``decode`` 12 x the
    decode steps, no ``fma``; rewards and stats finite."""
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    trainer = PPOTrainer(_small_engine_config(tmp_path))
    orch = PPOOrchestrator(trainer, PromptPipeline(_prompts(), 20),
                           reward_fn=lambda samples, **_: [len(s) / 20.0 for s in samples],
                           chunk_size=8)
    counters = ("FLASH_FWD_TILE_LAUNCHES", "FLASH_FWD_DECODE_LAUNCHES", "FLASH_FWD_FMA_LAUNCHES")
    start = {c: getattr(fa, c) for c in counters}
    stats = orch.make_experience(8)
    torch.cuda.synchronize()
    engine = trainer.rollout_engine_obj
    st = engine.stats
    assert st.admitted == st.completed == st.recycles == 8 and engine.pending == 0
    scorings = 8 // engine.harvest_width
    assert {c: getattr(fa, c) - n for c, n in start.items()} == {
        "FLASH_FWD_TILE_LAUNCHES": 12 * (st.prefills + scorings),
        "FLASH_FWD_DECODE_LAUNCHES": 12 * st.decode_steps, "FLASH_FWD_FMA_LAUNCHES": 0}
    assert len(trainer.buffer) == 8 and torch.isfinite(trainer.buffer.full.rewards).all()
    assert stats["engine/completed"] == 8.0
