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
On left padding whose first rows see only padding, K1's ``p_scale`` matches
the plain one and the autograd Function's gradient is autograd's through
K1's function in plain ops.
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
reference scoring and ``decode`` per decode step. At head dims 256
(GPT-J-6B) and 96 (GPT-NeoX-20B, its 64 x 96 tiles held as 64 x 128 in
shared memory), K1, K2 (also with the bias gradient) and K3 at the paths'
shapes and the edges; at 96 also through the slices of the fused
``query_key_value`` projection, read in place, and one NeoX update step
through the kernels. At head dim 128 (GPT-Neo), the same at its paths'
shapes, its local layers' band bias included (a long band whose first
key tiles are wholly masked), and one GPT-Neo update step, a global and
a local block, through the kernels. At the small head dims 16, 24 and 32 (each tile held
as one 64-column atom), K1, K2 (also with the bias gradient) and K3 at
the randomwalks configs' shapes (H = 6), the stand-ins' and the edges,
also through the slices of GPT-2's fused ``c_attn`` output, and one
update step of a GPT-2 at each of those widths through the kernels;
other head dims are refused before a launch. The ring attention's block
wrappers at every built head dim, in both dtypes, on a diagonal, a wholly
future and a padded past block: ``flash_block_fwd`` (K1, causal flag off)
against the plain forward, ``flash_block_bwd`` (K2 and K3 ``fma`` against
an outside lse) against the plain backward; and the ring at sp = 1 on a
one-rank NCCL mesh against the dense kernels and the naive impl. The int8 KV cache: the
quantizing write (``csrc/kv_quant.cu``) against its plain version bit for
bit at every built head dim, into a linear cache and through paged tables
with a publish into the shared pool; K1's ``decode_int8`` against
dequantization and the plain attention (a row with no live key and its
``p_scale`` included) and bit for bit against the bf16 decode on the
dequantized view; the routes of ``dot_product_attention`` on
``QuantizedKV``; a greedy int8 rollout through both kernels, token for
token with the CPU's; ``HealthMonitor.observe`` on CUDA scalars forcing
no synchronisation; and resumable training: the sampler's CUDA generator
through ``save`` and ``load`` draws the same tokens again, and the
preemption drain under ``async_checkpoint`` raises only once the emergency
step is on disk.
"""

import math

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
                "FLASH_FWD_DECODE_LAUNCHES", "FLASH_FWD_FMA_LAUNCHES", "FLASH_FWD_COPIES",
                "FLASH_FWD_SPLIT3_LAUNCHES", "FLASH_SPLIT_PLANES_LAUNCHES")


def _fwd_counters():
    return {c: getattr(fa, c) for c in FWD_COUNTERS}


def _moved(before):
    return {c: getattr(fa, c) - n for c, n in before.items() if getattr(fa, c) != n}


def _visited_reference(q, k, v, bias, causal, p_scale=False):
    """K1's function in plain ops: the plain forward restricted under the
    causal flag to the keys of the tiles K1 visits (as chip_smoke.py's
    ``visited_reference``), so all-padding causal rows are held too; with
    ``p_scale`` also K1's ``p_scale`` there."""
    if causal:
        Q, K = q.shape[1], k.shape[1]
        skip = torch.zeros(Q, K, device=q.device).masked_fill_(
            ~fa.visited_keys(Q, K, q.device), float("-inf"))
        bias = skip if bias is None else bias.float() + skip
    return fa.flash_attention_reference(q, k, v, bias, causal, True, p_scale)


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
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), None, None,
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
    q32, k32, v32 = _qkv(dev, 1, 4, 8, D=40)
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
    # Q <= 16: row 0's queries see only padding and average the real keys
    # 20..63 of key tile 0, the forward's whole visit
    "small_q_masked_rows": (2, 9, 130, True, "left_pad_in_tile_0"),
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


def _left_pad_bias(dev, B, K, kind):
    """Row 0's first 70 keys (``left_pad``: rows 0..69 see only padding) or
    first 20 (``left_pad_in_tile_0``, for Q <= 16: its queries see only
    padding, its real keys 20..63 lie in the visited key tile 0) are
    padding."""
    mask = torch.ones(B, K, dtype=torch.long, device=dev)
    mask[0, :70 if kind == "left_pad" else 20] = 0
    return attn.padding_bias(mask)


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
    elif kind in ("left_pad", "left_pad_in_tile_0"):
        bias = _left_pad_bias(dev, B, K, kind)
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


#: left padding whose first rows see only padding: at Q = 112 (K1 ``fma``
#: in f32, ``tile`` in bf16) and at Q = 9 (``decode`` in bf16)
MASKED_ROW_CASES = ["all_masked_rows", "small_q_masked_rows"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", MASKED_ROW_CASES)
def test_p_scale_matches_plain_on_rows_with_no_live_key(dev, dtype, case):
    """K1's ``p_scale`` against the plain one of K1's function: exactly 1
    on every row with a live key, 1 / (keys averaged) on the rows that see
    only padding, whose LSE rounds to NEG_INF."""
    q, k, v, bias, causal, _ = _bwd_inputs(dev, case, dtype)
    _, lse, p_scale = fa._launch(q, k, v, bias, causal, True, with_p_scale=True)
    _, want_lse, want = _visited_reference(q, k, v, bias, causal, p_scale=True)
    dead = lse <= attn.NEG_INF / 2
    assert dead.any() and torch.equal(dead, want_lse <= attn.NEG_INF / 2)
    assert torch.equal(p_scale[~dead], torch.ones_like(p_scale[~dead]))
    torch.testing.assert_close(p_scale, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", MASKED_ROW_CASES)
def test_function_gradient_on_rows_with_no_live_key(dev, dtype, case):
    """The autograd Function (K1, dO's rows scaled by ``p_scale``, K2 and
    K3) against autograd through K1's function in plain ops on left
    padding: the rows that see only padding take the derivative of the
    weights their forward used, as every other row does."""
    q, k, v, bias, causal, do = _bwd_inputs(dev, case, dtype)
    grads = []
    for fn in (fa.flash_attention, lambda *a: _visited_reference(*a)[0]):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*xs, bias, causal), xs, do))
    for name, g, w in zip(("dq", "dk", "dv"), *grads):
        assert torch.isfinite(g).all(), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= _bwd_tol(dtype, w), (name, err)


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
                "FLASH_BWD_DQ_FMA_LAUNCHES", "FLASH_BWD_DKV_FMA_LAUNCHES", "FLASH_BWD_COPIES",
                "FLASH_BWD_DQ_SPLIT3_LAUNCHES", "FLASH_BWD_DKV_SPLIT3_LAUNCHES",
                "FLASH_SPLIT_PLANES_LAUNCHES")


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


# Head dim 256 (GPT-J-6B: n_embd 4096 over 16 heads). K1 at the paths'
# shapes (the rollout prefill and decode of configs/ppo_gptj.yml, B = 128,
# 48 prompt + 48 new tokens; the update forward, B = 8, T = 96 causal; the
# serving engine's admission prefill and decode) and at the edges: ragged
# Q/K with a padding bias, all-padding causal rows, 16 key tiles with
# peaked logits. H = 16 at the path shapes, 2 at the edges.
D256_CASES = {  # B, Q, K, H, causal, bias kind
    "rollout_prefill": (128, 48, 96, 16, False, "causal_left_pad"),
    "rollout_decode": (128, 1, 96, 16, False, "pad"),
    "update": (8, 96, 96, 16, True, "pad"),
    "serving_prefill": (8, 512, 576, 16, False, "causal_left_pad"),
    "serving_decode": (32, 1, 576, 16, False, "pad"),
    "ragged": (2, 77, 141, 2, False, "pad"),
    "decode_ragged": (3, 5, 70, 2, False, "full"),
    "all_masked_rows": (2, 112, 112, 2, True, "left_pad"),
    "small_q_masked_rows": (2, 9, 130, 2, True, "left_pad_in_tile_0"),
    "long_k": (2, 130, 1024, 2, False, "peaked"),
}


def _wide_head_inputs(dev, case, dtype, seed=11, D=256):
    B, Q, K, H, causal, kind = {256: D256_CASES, 96: D96_CASES, 128: D128_CASES}.get(
        D, SMALL_CASES)[case]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev) for T in (Q, K, K))
    cols = torch.arange(K, device=dev)[None]
    if kind == "pad":  # padding with the first keys valid
        keep = cols < 4
        bias = attn.padding_bias(((torch.rand(B, K, generator=gen, device=dev) > 0.3) | keep).long())
    elif kind == "causal_left_pad":  # the engine's [B, 1, Q, K] admission bias
        lens = torch.randint(1, Q + 1, (B, 1), generator=gen, device=dev)
        bias = attn.causal_bias(Q, K, 0, dev) + attn.padding_bias(
            ((cols >= Q - lens) & (cols < Q)).long())
    elif kind in ("left_pad", "left_pad_in_tile_0"):
        bias = _left_pad_bias(dev, B, K, kind)
    elif kind == "full":
        bias = torch.randn(B, 1, Q, K, generator=gen, device=dev)
    elif kind.startswith("band"):  # GPT-Neo's local layers: the band plus padding
        bias = _band_bias(dev, gen, B, Q, K, kind)
    else:  # peaked: logits x3 and a per-row bias; V / 4 keeps |O| near 1
        q, v = q * 3, v / 4
        bias = 2 * torch.randn(B, 1, Q, K, generator=gen, device=dev)
    do = torch.randn(B, Q, H, D, generator=gen, device=dev)
    return [x.to(dtype) for x in (q, k, v)], bias, causal, do.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", list(D256_CASES))
def test_head_dim_256_forward_matches_plain(dev, dtype, case):
    """K1 at D = 256 in the variant its dtype and Q pick, against the plain
    version restricted to the keys K1 visits; only that variant's counter
    moves, nothing is copied."""
    (q, k, v), bias, causal, _ = _wide_head_inputs(dev, case, dtype)
    variant = fa.forward_variant(dtype, q.shape[1])
    before = _fwd_counters()
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    assert _moved(before) == {"FLASH_FWD_LAUNCHES": 1, f"FLASH_FWD_{variant.upper()}_LAUNCHES": 1}
    o_ref, lse_ref = _visited_reference(q, k, v, bias, causal)
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL[dtype]
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse
    assert torch.equal(fa.flash_attention(q, k, v, bias, causal), o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ["update", "ragged", "all_masked_rows", "small_q_masked_rows",
                                  "long_k", "decode_ragged"])
def test_head_dim_256_backward_matches_plain(dev, dtype, case):
    """K2 and K3 at D = 256 (K3 as two warpgroups, one per accumulator)
    against the plain backward fed K1's own O and LSE."""
    (q, k, v), bias, causal, do = _wide_head_inputs(dev, case, dtype)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    before = _bwd_counters()
    got = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, causal)
    torch.cuda.synchronize()
    variant = "TILE" if dtype == torch.bfloat16 else "FMA"
    assert {c: getattr(fa, c) - n for c, n in before.items() if getattr(fa, c) != n} == {
        "FLASH_BWD_DQ_LAUNCHES": 1, "FLASH_BWD_DKV_LAUNCHES": 1,
        f"FLASH_BWD_DQ_{variant}_LAUNCHES": 1, f"FLASH_BWD_DKV_{variant}_LAUNCHES": 1}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.isfinite(g).all(), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= _bwd_tol(dtype, w), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_head_dim_256_dbias_matches_plain(dev, dtype):
    """K2 with the bias gradient at D = 256 (a learned [1, H, Q, K] bias
    under a padding bias)."""
    (q, k, v), pad, _, do = _wide_head_inputs(dev, "ragged", dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    bias = 2 * torch.randn(1, 2, 77, 141, generator=gen, device=dev) + pad
    o, lse = fa.flash_attention(q, k, v, bias, False, True)
    *got, dbias = fa._launch_backward(q, k, v, bias, o, lse, do, False, dbias=True)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, False, True)
    torch.cuda.synchronize()
    err = (dbias - want[3]).abs().max().item()
    assert err <= 1e-4 * max(1.0, want[3].abs().max().item()), err
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert (g.float() - w.float()).abs().max().item() <= _bwd_tol(dtype, w), name


# Head dim 96 (GPT-NeoX-20B: hidden 6144 over 64 heads). Each 64 x 96 tile
# is held as 64 x 128 in shared memory (two swizzle atoms, the padding
# zero-filled). K1 at the paths' shapes (configs/ppo_neox20b.yml's rollout
# prefill and decode, B = 64, 48 prompt + 48 new tokens; the update, B =
# 32, T = 96 causal; the serving engine's admission prefill and decode) at
# H = 64, and D = 256's edges at H = 2; q, k and v also as slices of the
# fused [B, T, H, 3 x 96] projection, read in place. O is held relative to
# P|V| + |O| (chip_smoke.py's O_REL_TOL), since V ~ N(0, 1) makes |O|
# reach the bf16 rounding of values near 4.
D96_CASES = {  # B, Q, K, H, causal, bias kind
    "rollout_prefill": (64, 48, 96, 64, False, "causal_left_pad"),
    "rollout_decode": (64, 1, 96, 64, False, "pad"),
    "update": (32, 96, 96, 64, True, "pad"),
    "serving_prefill": (8, 512, 576, 64, False, "causal_left_pad"),
    "serving_decode": (32, 1, 576, 64, False, "pad"),
    "ragged": (2, 77, 141, 2, False, "pad"),
    "decode_ragged": (3, 5, 70, 2, False, "full"),
    "all_masked_rows": (2, 112, 112, 2, True, "left_pad"),
    "small_q_masked_rows": (2, 9, 130, 2, True, "left_pad_in_tile_0"),
    "long_k": (2, 130, 1024, 2, False, "peaked"),
}
O_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}


def _fused(q, k, v):
    """q, k, v as the NeoX attention forms them: slices of [B, T, H, 3 D]
    projections (row strides of 3 H D elements, k's base D in, v's 2 D);
    q's columns and the keys' columns each from their own, so Q may differ
    from K."""
    D = q.shape[-1]
    q_rows = torch.cat([q, torch.zeros_like(q), torch.zeros_like(q)], dim=-1)
    kv_rows = torch.cat([torch.zeros_like(k), k, v], dim=-1)
    return q_rows[..., :D], kv_rows[..., D:2 * D], kv_rows[..., 2 * D:]


def _assert_o_close(q, k, v, bias, causal, o, o_ref, dtype):
    """O within O_REL_TOL of P|V| + |O_ref| elementwise (P: the plain
    weights over the keys K1 visits)."""
    pv = _visited_reference(q.float(), k.float(), v.float().abs(), bias, causal)[0]
    bound = O_REL_TOL[dtype] * (pv + o_ref.float().abs())
    assert ((o.float() - o_ref.float()).abs() <= bound).all()


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", list(D96_CASES))
def test_head_dim_96_forward_matches_plain(dev, dtype, case, fused):
    """K1 at D = 96 in the variant its dtype and Q pick, against the plain
    version restricted to the keys K1 visits; only that variant's counter
    moves, and nothing is copied, the fused projection's slices included."""
    (q, k, v), bias, causal, _ = _wide_head_inputs(dev, case, dtype, D=96)
    if fused:
        q, k, v = _fused(q, k, v)
    variant = fa.forward_variant(dtype, q.shape[1])
    before = _fwd_counters()
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    assert _moved(before) == {"FLASH_FWD_LAUNCHES": 1, f"FLASH_FWD_{variant.upper()}_LAUNCHES": 1}
    o_ref, lse_ref = _visited_reference(q, k, v, bias, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    _assert_o_close(q, k, v, bias, causal, o, o_ref, dtype)
    assert (lse - lse_ref).abs().max().item() <= TOL[dtype][1]
    assert torch.equal(fa.flash_attention(q, k, v, bias, causal), o)


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ["update", "ragged", "all_masked_rows", "small_q_masked_rows",
                                  "long_k", "decode_ragged"])
def test_head_dim_96_backward_matches_plain(dev, dtype, case, fused):
    """K2 and K3 at D = 96 (K3 as two warpgroups, one per accumulator)
    against the plain backward fed K1's own O and LSE; the fused
    projection's slices are read in place."""
    (q, k, v), bias, causal, do = _wide_head_inputs(dev, case, dtype, D=96)
    if fused:
        q, k, v = _fused(q, k, v)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    before = _bwd_counters()
    got = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, causal)
    torch.cuda.synchronize()
    variant = "TILE" if dtype == torch.bfloat16 else "FMA"
    assert {c: getattr(fa, c) - n for c, n in before.items() if getattr(fa, c) != n} == {
        "FLASH_BWD_DQ_LAUNCHES": 1, "FLASH_BWD_DKV_LAUNCHES": 1,
        f"FLASH_BWD_DQ_{variant}_LAUNCHES": 1, f"FLASH_BWD_DKV_{variant}_LAUNCHES": 1}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.isfinite(g).all(), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= _bwd_tol(dtype, w), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_head_dim_96_dbias_matches_plain(dev, dtype):
    """K2 with the bias gradient at D = 96 (a learned [1, H, Q, K] bias
    under a padding bias)."""
    (q, k, v), pad, _, do = _wide_head_inputs(dev, "ragged", dtype, D=96)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    bias = 2 * torch.randn(1, 2, 77, 141, generator=gen, device=dev) + pad
    o, lse = fa.flash_attention(q, k, v, bias, False, True)
    *got, dbias = fa._launch_backward(q, k, v, bias, o, lse, do, False, dbias=True)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, False, True)
    torch.cuda.synchronize()
    err = (dbias - want[3]).abs().max().item()
    assert err <= 1e-4 * max(1.0, want[3].abs().max().item()), err
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert (g.float() - w.float()).abs().max().item() <= _bwd_tol(dtype, w), name


# Head dim 128 (GPT-Neo 1.3B: hidden 2048 over 16 heads; two whole swizzle
# atoms a tile, nothing padded). K1 at the paths' shapes (configs/
# ppo_gptj.yml's geometry, which phase 20 of chip_smoke.py trains: the
# rollout prefill and decode, B = 128, 48 prompt + 48 new tokens; the
# update, B = 8, T = 96, under the causal flag for the global layers and
# under the band with causal off for the local ones; the serving engine's
# admission prefill and decode under the band) at H = 16, a long band
# (T = 512, window 256: the last query tile's first three key tiles are
# wholly masked) and D = 256's edges at H = 2. O is held relative to
# P|V| + |O|, as at 96.
D128_CASES = {  # B, Q, K, H, causal, bias kind
    "rollout_prefill": (128, 48, 96, 16, False, "causal_left_pad"),
    "rollout_decode": (128, 1, 96, 16, False, "pad"),
    "update": (8, 96, 96, 16, True, "pad"),
    "update_local": (8, 96, 96, 16, False, "band_pad"),
    "long_band": (2, 512, 512, 4, False, "band_pad"),
    "serving_prefill_local": (8, 512, 576, 16, False, "band_left_pad"),
    "serving_decode_local": (32, 1, 576, 16, False, "band_rows"),
    "ragged": (2, 77, 141, 2, False, "pad"),
    "decode_ragged": (3, 5, 70, 2, False, "full"),
    "all_masked_rows": (2, 112, 112, 2, True, "left_pad"),
    "small_q_masked_rows": (2, 9, 130, 2, True, "left_pad_in_tile_0"),
    "long_k": (2, 130, 1024, 2, False, "peaked"),
}
GPT_NEO_WINDOW = 256  # GPT-Neo 1.3B's window_size


def _band_bias(dev, gen, B, Q, K, kind):
    """GPT-Neo's local band (window 256) and padding as the model forms
    them: ``band_pad`` from column 0 with the first keys valid,
    ``band_left_pad`` over the engine's left-padded prompt columns,
    ``band_rows`` one query a row at per-row depths."""
    from trlx_tpu_torch.models.gpt_neo import local_causal_bias

    cols = torch.arange(K, device=dev)[None]
    if kind == "band_rows":
        depth = torch.randint(16, K, (B,), generator=gen, device=dev)
        return local_causal_bias(1, K, GPT_NEO_WINDOW, depth) + attn.padding_bias(
            (cols <= depth[:, None]).long())
    band = local_causal_bias(Q, K, GPT_NEO_WINDOW, 0, dev)
    if kind == "band_left_pad":
        lens = torch.randint(1, Q + 1, (B, 1), generator=gen, device=dev)
        return band + attn.padding_bias(((cols >= Q - lens) & (cols < Q)).long())
    keep = cols < 4
    return band + attn.padding_bias(((torch.rand(B, K, generator=gen, device=dev) > 0.3)
                                     | keep).long())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", list(D128_CASES))
def test_head_dim_128_forward_matches_plain(dev, dtype, case):
    """K1 at D = 128 in the variant its dtype and Q pick, against the plain
    version restricted to the keys K1 visits; only that variant's counter
    moves, nothing is copied."""
    (q, k, v), bias, causal, _ = _wide_head_inputs(dev, case, dtype, D=128)
    variant = fa.forward_variant(dtype, q.shape[1])
    before = _fwd_counters()
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    assert _moved(before) == {"FLASH_FWD_LAUNCHES": 1, f"FLASH_FWD_{variant.upper()}_LAUNCHES": 1}
    o_ref, lse_ref = _visited_reference(q, k, v, bias, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    _assert_o_close(q, k, v, bias, causal, o, o_ref, dtype)
    assert (lse - lse_ref).abs().max().item() <= TOL[dtype][1]
    assert torch.equal(fa.flash_attention(q, k, v, bias, causal), o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ["update", "update_local", "long_band", "ragged",
                                  "all_masked_rows", "small_q_masked_rows", "long_k",
                                  "decode_ragged"])
def test_head_dim_128_backward_matches_plain(dev, dtype, case):
    """K2 and K3 at D = 128 (K3 as two warpgroups, one per accumulator)
    against the plain backward fed K1's own O and LSE, the band included."""
    (q, k, v), bias, causal, do = _wide_head_inputs(dev, case, dtype, D=128)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    before = _bwd_counters()
    got = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, causal)
    torch.cuda.synchronize()
    variant = "TILE" if dtype == torch.bfloat16 else "FMA"
    assert {c: getattr(fa, c) - n for c, n in before.items() if getattr(fa, c) != n} == {
        "FLASH_BWD_DQ_LAUNCHES": 1, "FLASH_BWD_DKV_LAUNCHES": 1,
        f"FLASH_BWD_DQ_{variant}_LAUNCHES": 1, f"FLASH_BWD_DKV_{variant}_LAUNCHES": 1}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.isfinite(g).all(), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= _bwd_tol(dtype, w), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_head_dim_128_dbias_matches_plain(dev, dtype):
    """K2 with the bias gradient at D = 128 (a learned [1, H, Q, K] bias
    under a padding bias)."""
    (q, k, v), pad, _, do = _wide_head_inputs(dev, "ragged", dtype, D=128)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    bias = 2 * torch.randn(1, 2, 77, 141, generator=gen, device=dev) + pad
    o, lse = fa.flash_attention(q, k, v, bias, False, True)
    *got, dbias = fa._launch_backward(q, k, v, bias, o, lse, do, False, dbias=True)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, False, True)
    torch.cuda.synchronize()
    err = (dbias - want[3]).abs().max().item()
    assert err <= 1e-4 * max(1.0, want[3].abs().max().item()), err
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert (g.float() - w.float()).abs().max().item() <= _bwd_tol(dtype, w), name


def test_gpt_neo_update_step_runs_every_attention_through_the_kernels(dev):
    """One bf16 PPO-loss backward of a small GPT-Neo (2 heads of 128, a
    global and a local block at window 8, 40 columns) runs every attention
    through K1 ``tile`` (the local block's under the band with the causal
    flag off), then K2 and K3 ``tile``, once a block, with no copy."""
    from trlx_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params

    cfg = GPTNeoConfig(vocab_size=64, max_position_embeddings=128, hidden_size=256,
                       num_layers=2, num_heads=2, window_size=8,
                       attention_layers=("global", "local"), dtype="bfloat16")
    model = CausalLMWithValueHead(cfg, GPTNeoModel, device=dev)
    init_params(model, 0)
    ids = torch.randint(0, 64, (4, 40), device=dev)
    mask = torch.ones_like(ids)
    mask[0, :7] = 0
    before, bwd_before = _fwd_counters(), _bwd_counters()
    copies = (fa.FLASH_FWD_COPIES, fa.FLASH_BWD_COPIES)
    logits, values = model.response_forward(ids, mask, 24)
    (logits.float().logsumexp(-1).sum() + values.sum()).backward()
    torch.cuda.synchronize()
    assert _moved(before) == {"FLASH_FWD_LAUNCHES": 2, "FLASH_FWD_TILE_LAUNCHES": 2}
    assert {c: getattr(fa, c) - n for c, n in bwd_before.items() if getattr(fa, c) != n} == {
        "FLASH_BWD_DQ_LAUNCHES": 2, "FLASH_BWD_DKV_LAUNCHES": 2,
        "FLASH_BWD_DQ_TILE_LAUNCHES": 2, "FLASH_BWD_DKV_TILE_LAUNCHES": 2}
    assert (fa.FLASH_FWD_COPIES, fa.FLASH_BWD_COPIES) == copies
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    with torch.no_grad():  # without a mask the band is made on the model's device
        assert torch.isfinite(model(ids)["logits"]).all()


def test_neox_update_step_runs_every_attention_through_the_kernels(dev):
    """One bf16 PPO-loss backward of a small NeoX (2 heads of 96, the
    20B's head geometry) runs every attention through K1 ``tile``, then K2
    and K3 ``tile``, once a block, reading the fused projection's slices
    with no copy."""
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
    from trlx_tpu_torch.models.neox import NeoXConfig, NeoXModel

    cfg = NeoXConfig(vocab_size=64, max_position_embeddings=128, hidden_size=192,
                     num_hidden_layers=2, num_attention_heads=2, dtype="bfloat16")
    model = CausalLMWithValueHead(cfg, NeoXModel, device=dev)
    init_params(model, 0)
    ids = torch.randint(0, 64, (4, 40), device=dev)
    mask = torch.ones_like(ids)
    mask[0, :7] = 0
    before, bwd_before = _fwd_counters(), _bwd_counters()
    copies = (fa.FLASH_FWD_COPIES, fa.FLASH_BWD_COPIES)
    logits, values = model.response_forward(ids, mask, 24)
    (logits.float().logsumexp(-1).sum() + values.sum()).backward()
    torch.cuda.synchronize()
    assert _moved(before) == {"FLASH_FWD_LAUNCHES": 2, "FLASH_FWD_TILE_LAUNCHES": 2}
    assert {c: getattr(fa, c) - n for c, n in bwd_before.items() if getattr(fa, c) != n} == {
        "FLASH_BWD_DQ_LAUNCHES": 2, "FLASH_BWD_DKV_LAUNCHES": 2,
        "FLASH_BWD_DQ_TILE_LAUNCHES": 2, "FLASH_BWD_DKV_TILE_LAUNCHES": 2}
    assert (fa.FLASH_FWD_COPIES, fa.FLASH_BWD_COPIES) == copies
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


# The small head dims: 16 (the learning guard, the T5 stand-in's d_kv), 24
# (configs/ppo_randomwalks.yml and ilql_randomwalks.yml: 144 wide over 6
# heads) and 32 (the GPT-2 stand-in: 128 wide over 4 heads), each 64 x D
# tile held as one 64-column atom. K1 at the randomwalks paths' shapes
# (H = 6: the rollout's decode step, B = 128 over the 10-wide cache; the
# update, B = 64, T = 10 causal; the reference scoring, B = 128), the GPT-2
# stand-in's served prefill (40 prompt columns over a 64-wide view: the
# ``tile`` variant) and its update (T = 20 causal), and D = 256's edges at
# H = 2; q, k and v also as slices of GPT-2's fused [B, T, 3 H D] ``c_attn``
# output, read in place. O is held relative to P|V| + |O|, as at 96.
SMALL_HEAD_DIMS = (16, 24, 32)
SMALL_CASES = {  # B, Q, K, H, causal, bias kind
    "rollout_decode": (128, 1, 10, 6, False, "pad"),
    "update": (64, 10, 10, 6, True, "pad"),
    "ref_scoring": (128, 10, 10, 6, True, "pad"),
    "standin_prefill": (8, 40, 64, 4, False, "causal_left_pad"),
    "standin_update": (16, 20, 20, 4, True, "pad"),
    "ragged": (2, 77, 141, 2, False, "pad"),
    "decode_ragged": (3, 5, 70, 2, False, "full"),
    "all_masked_rows": (2, 112, 112, 2, True, "left_pad"),
    "small_q_masked_rows": (2, 9, 130, 2, True, "left_pad_in_tile_0"),
    "long_k": (2, 130, 1024, 2, False, "peaked"),
}
SMALL_BWD_CASES = ("update", "standin_update", "ragged", "all_masked_rows",
                   "small_q_masked_rows", "long_k", "decode_ragged")


def _c_attn(q, k, v):
    """q, k, v as GPT-2's attention forms them: [B, T, H, D] views of the
    thirds of a [B, T, 3 H D] projection (row strides of 3 H D elements,
    k's base H D in, v's 2 H D); q's rows and the keys' rows each from
    their own projection, so Q may differ from K."""
    HD = q.shape[2] * q.shape[3]
    q_rows = torch.cat([q.flatten(2), torch.zeros_like(q.flatten(2)).repeat(1, 1, 2)], dim=-1)
    kv_rows = torch.cat([torch.zeros_like(k.flatten(2)), k.flatten(2), v.flatten(2)], dim=-1)
    return (q_rows[..., :HD].unflatten(-1, q.shape[2:]),
            kv_rows[..., HD:2 * HD].unflatten(-1, k.shape[2:]),
            kv_rows[..., 2 * HD:].unflatten(-1, v.shape[2:]))


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "c_attn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", list(SMALL_CASES))
@pytest.mark.parametrize("D", SMALL_HEAD_DIMS, ids=lambda d: f"D{d}")
def test_small_head_dim_forward_matches_plain(dev, D, case, dtype, fused):
    """K1 at D = 16, 24 and 32 in the variant its dtype and Q pick, against
    the plain version restricted to the keys K1 visits; only that variant's
    counter moves, and nothing is copied, the fused projection's slices
    included."""
    (q, k, v), bias, causal, _ = _wide_head_inputs(dev, case, dtype, D=D)
    if fused:
        q, k, v = _c_attn(q, k, v)
        assert all(fa.aligned_for_16_byte_loads(t) for t in (q, k, v))
    variant = fa.forward_variant(dtype, q.shape[1])
    before = _fwd_counters()
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    assert _moved(before) == {"FLASH_FWD_LAUNCHES": 1, f"FLASH_FWD_{variant.upper()}_LAUNCHES": 1}
    o_ref, lse_ref = _visited_reference(q, k, v, bias, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    _assert_o_close(q, k, v, bias, causal, o, o_ref, dtype)
    assert (lse - lse_ref).abs().max().item() <= TOL[dtype][1]
    assert torch.equal(fa.flash_attention(q, k, v, bias, causal), o)


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "c_attn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", SMALL_BWD_CASES)
@pytest.mark.parametrize("D", SMALL_HEAD_DIMS, ids=lambda d: f"D{d}")
def test_small_head_dim_backward_matches_plain(dev, D, case, dtype, fused):
    """K2 and K3 at D = 16, 24 and 32 against the plain backward fed K1's
    own O and LSE; the fused projection's slices are read in place."""
    (q, k, v), bias, causal, do = _wide_head_inputs(dev, case, dtype, D=D)
    if fused:
        q, k, v = _c_attn(q, k, v)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    before = _bwd_counters()
    got = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, causal)
    torch.cuda.synchronize()
    variant = "TILE" if dtype == torch.bfloat16 else "FMA"
    assert {c: getattr(fa, c) - n for c, n in before.items() if getattr(fa, c) != n} == {
        "FLASH_BWD_DQ_LAUNCHES": 1, "FLASH_BWD_DKV_LAUNCHES": 1,
        f"FLASH_BWD_DQ_{variant}_LAUNCHES": 1, f"FLASH_BWD_DKV_{variant}_LAUNCHES": 1}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.isfinite(g).all(), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= _bwd_tol(dtype, w), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("D", SMALL_HEAD_DIMS, ids=lambda d: f"D{d}")
def test_small_head_dim_dbias_matches_plain(dev, D, dtype):
    """K2 with the bias gradient at D = 16 (the T5 stand-in's d_kv), 24 and
    32: a learned [1, H, Q, K] bias under a padding bias, and the T5
    stand-in's decoder self-attention (4 heads, 12 new tokens, T5's causal
    mask folded into the bias)."""
    (q, k, v), pad, _, do = _wide_head_inputs(dev, "ragged", dtype, D=D)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    table = 2 * torch.randn(1, 2, 77, 141, generator=gen, device=dev)
    q2, k2, v2, do2 = (torch.randn(3, 12, 4, D, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
    rel = torch.randn(1, 4, 12, 12, generator=gen, device=dev)
    cases = [((q, k, v), table + pad, do),
             ((q2, k2, v2), rel + attn.causal_bias(12, 12, 0, dev), do2)]
    for (q, k, v), bias, do in cases:
        before = fa.FLASH_BWD_DQ_DBIAS_LAUNCHES
        o, lse = fa.flash_attention(q, k, v, bias, False, True)
        *got, dbias = fa._launch_backward(q, k, v, bias, o, lse, do, False, dbias=True)
        want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, False, True)
        torch.cuda.synchronize()
        assert fa.FLASH_BWD_DQ_DBIAS_LAUNCHES == before + 1
        err = (dbias - want[3]).abs().max().item()
        assert err <= 1e-4 * max(1.0, want[3].abs().max().item()), err
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert (g.float() - w.float()).abs().max().item() <= _bwd_tol(dtype, w), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("width, heads", [(144, 6), (128, 4), (32, 2)],
                         ids=["randomwalks_D24", "standin_D32", "guard_D16"])
def test_small_head_dim_update_step_runs_every_attention_through_the_kernels(
        dev, width, heads, dtype):
    """One PPO-loss backward of a 2-block GPT-2 at the randomwalks configs'
    width (6 heads of 24), the GPT-2 stand-in's (4 of 32) and the learning
    guard's (2 of 16), T = 20: every attention runs K1 (``tile`` in bf16,
    ``fma`` in f32), then K2 and K3 in the dtype's variant, once a block,
    reading the fused ``c_attn`` slices with no copy."""
    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params

    cfg = GPT2Config(vocab_size=64, n_positions=32, n_embd=width, n_layer=2, n_head=heads,
                     dtype=str(dtype).replace("torch.", ""))
    model = CausalLMWithValueHead(cfg, GPT2Model, device=dev)
    init_params(model, 0)
    ids = torch.randint(0, 64, (4, 20), device=dev)
    mask = torch.ones_like(ids)
    mask[0, :7] = 0
    before, bwd_before = _fwd_counters(), _bwd_counters()
    copies = (fa.FLASH_FWD_COPIES, fa.FLASH_BWD_COPIES)
    logits, values = model.response_forward(ids, mask, 10)
    (logits.float().logsumexp(-1).sum() + values.float().sum()).backward()
    torch.cuda.synchronize()
    fwd, bwd = ("TILE", "TILE") if dtype == torch.bfloat16 else ("FMA", "FMA")
    assert _moved(before) == {"FLASH_FWD_LAUNCHES": 2, f"FLASH_FWD_{fwd}_LAUNCHES": 2}
    assert {c: getattr(fa, c) - n for c, n in bwd_before.items() if getattr(fa, c) != n} == {
        "FLASH_BWD_DQ_LAUNCHES": 2, "FLASH_BWD_DKV_LAUNCHES": 2,
        f"FLASH_BWD_DQ_{bwd}_LAUNCHES": 2, f"FLASH_BWD_DKV_{bwd}_LAUNCHES": 2}
    assert (fa.FLASH_FWD_COPIES, fa.FLASH_BWD_COPIES) == copies
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


def test_other_head_dims_are_refused_before_a_launch(dev):
    """Widths the kernels are not built for, such as 40 and 80: the
    wrappers raise naming the built dims, and the C entry points refuse
    them."""
    before = (_fwd_counters(), _bwd_counters())
    for D in (40, 80):
        q, k, v = _qkv(dev, 1, 20, 30, D=D, dtype=torch.bfloat16)
        with pytest.raises(ValueError,
                           match="head dims \\(16, 24, 32, 64, 96, 128, 256\\), got"):
            fa.flash_attention(q, k, v)
        o = torch.empty_like(q)
        lse = torch.empty(1, 2, 20, device=dev)
        with pytest.raises(ValueError, match="head dims"):
            fa._launch_backward(q, k, v, None, o, lse, o, False)
        lib = fa._load()["flash_fwd"]
        assert lib.trlx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), None, None,
            fa.FORWARD_VARIANTS["tile"], 1, 1, 2, 20, 30, D, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], 0, 0, 0, 0, D ** -0.5, 0,
            torch.cuda.current_stream().cuda_stream) == -1
    assert (_fwd_counters(), _bwd_counters()) == before


# ---------------------------------------------------------------------------
# The ring attention's block wrappers, and the ring at sp = 1 through NCCL
# ---------------------------------------------------------------------------

#: one ring block's biases: the diagonal block under the causal mask with
#: padding, a wholly future block (every pair NEG_INF), a past block with a
#: padded tail, and a diagonal block whose first 3 keys are padding (left
#: padding: batch row 0's first 3 query rows have no live key); (Tq, Tk),
#: none a multiple of 64, so bf16 runs K1's ``tile`` and ``decode``
BLOCK_KINDS = {"diagonal": (80, 80), "future": (80, 80), "past_padded": (9, 80),
               "left_padded": (130, 130)}


def _block_case(dev, D, dtype, kind, seed=0):
    """q, k, v, the block's bias, and the bias of the backward's outside
    lse: the padding alone (every row live), or for ``left_padded`` the
    block's own bias, so that its rows with no live key have lse ≈
    NEG_INF and must keep their visit."""
    Tq, Tk = BLOCK_KINDS[kind]
    B = 2
    q, k, v = _qkv(dev, B, Tq, Tk, D=D, dtype=dtype, seed=seed)
    mask = torch.ones(B, Tk, dtype=torch.long, device=dev)
    if kind == "left_padded":
        mask[0, :3] = 0
    else:
        mask[0, Tk - 3:] = 0
    pad = attn.padding_bias(mask)
    bias = pad.expand(B, 1, Tq, Tk)
    if kind in ("diagonal", "left_padded"):
        bias = bias + attn.causal_bias(Tq, Tk, device=dev)
    elif kind == "future":
        bias = torch.full((B, 1, Tq, Tk), attn.NEG_INF, device=dev)
    bias = bias.contiguous()
    return q, k, v, bias, bias if kind == "left_padded" else pad


@pytest.mark.parametrize("kind", list(BLOCK_KINDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("D", fa.HEAD_DIMS, ids=lambda d: f"D{d}")
def test_block_fwd_matches_plain(dev, D, dtype, kind):
    """``flash_block_fwd`` runs K1 with the causal flag off in the variant
    of its dtype and width (``split3`` in f32, after three split
    pre-passes; ``tile`` or ``decode`` in bf16), once, with no copy, and
    gives the plain version's O and LSE; a wholly future block the
    uniform average of V at lse ≈ NEG_INF + log Tk."""
    q, k, v, bias, _ = _block_case(dev, D, dtype, kind)
    before = {**_fwd_counters(), "FLASH_BLOCK_FWD_LAUNCHES": fa.FLASH_BLOCK_FWD_LAUNCHES}
    o, lse = fa.flash_block_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    variant = fa.block_forward_variant(dtype, q.shape[1])
    assert variant == ("split3" if dtype == torch.float32 else fa.forward_variant(dtype, q.shape[1]))
    assert _moved(before) == {"FLASH_FWD_LAUNCHES": 1, "FLASH_BLOCK_FWD_LAUNCHES": 1,
                              f"FLASH_FWD_{variant.upper()}_LAUNCHES": 1,
                              **({"FLASH_SPLIT_PLANES_LAUNCHES": 3} if variant == "split3" else {})}
    B, Tq, H, _ = q.shape
    assert o.shape == (B, H, Tq, D) and o.dtype == dtype and lse.shape == (B, H, Tq)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, bias, False, True)
    tol_o, tol_lse = TOL[dtype]
    assert (o.transpose(1, 2).float() - o_ref.float()).abs().max().item() <= tol_o
    if kind == "future":
        mean = v.float().mean(dim=1)[:, :, None]  # [B, H, 1, D]
        assert (o.float() - mean).abs().max().item() <= tol_o
        assert torch.allclose(lse, torch.full_like(lse, attn.NEG_INF + math.log(k.shape[1])),
                              rtol=1e-7, atol=0)
    else:
        assert (lse - lse_ref).abs().max().item() <= tol_lse


@pytest.mark.parametrize("kind", list(BLOCK_KINDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("D", fa.HEAD_DIMS, ids=lambda d: f"D{d}")
def test_block_bwd_matches_plain_with_outside_lse(dev, D, dtype, kind):
    """``flash_block_bwd`` upcasts to f32 and runs K2 and K3 in ``split3``
    once each, after four split pre-passes, with no copy, against an
    outside lse (the padding's own + 0.3, so P sums to less than 1; for
    ``left_padded`` the block's own, rows with no live key included): the
    plain backward's gradients on the CPU, in f32; a wholly future block's
    exactly 0."""
    q, k, v, bias, lse_bias = _block_case(dev, D, dtype, kind)
    o, lse = fa.flash_attention_reference(q, k, v, lse_bias, False, True)
    o, lse = o.transpose(1, 2), lse + 0.3
    do = torch.randn(o.shape, device=dev).to(dtype)
    before = {**_bwd_counters(), "FLASH_BLOCK_BWD_LAUNCHES": fa.FLASH_BLOCK_BWD_LAUNCHES}
    got = fa.flash_block_bwd(q, k, v, bias, o, lse, do)
    torch.cuda.synchronize()
    moved = {c: getattr(fa, c) - n for c, n in before.items() if getattr(fa, c) != n}
    assert moved == {"FLASH_BWD_DQ_LAUNCHES": 1, "FLASH_BWD_DKV_LAUNCHES": 1,
                     "FLASH_BWD_DQ_SPLIT3_LAUNCHES": 1, "FLASH_BWD_DKV_SPLIT3_LAUNCHES": 1,
                     "FLASH_SPLIT_PLANES_LAUNCHES": 4, "FLASH_BLOCK_BWD_LAUNCHES": 1}
    want = fa.flash_block_bwd(*(x.cpu() for x in (q, k, v, bias, o, lse, do)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = max(1.0, w.abs().max().item())
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * scale, name
        if kind == "future":
            assert not g.any(), name


def _force_visits(bias, lse_rows_live):
    """``bias`` with one entry of every dead 64 x 64 tile raised from
    NEG_INF to NEG_INF / 4, in a row that ``lse_rows_live`` [B, Tq] marks
    live: the entry still weighs exactly 0, but the tile's vote now finds
    a live pair, so the kernels visit it. Returns the new bias and the
    number of tiles forced."""
    forced, n = bias.clone(), 0
    B, _, Tq, Tk = bias.shape
    for b in range(B):
        for q0 in range(0, Tq, 64):
            rows = torch.nonzero(lse_rows_live[b, q0:q0 + 64]).flatten()
            for k0 in range(0, Tk, 64):
                if len(rows) and not (bias[b, 0, q0:q0 + 64, k0:k0 + 64] > attn.NEG_INF / 2).any():
                    forced[b, 0, q0 + rows[0], k0] = attn.NEG_INF / 4
                    n += 1
    return forced, n


@pytest.mark.parametrize("kind", list(BLOCK_KINDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("D", fa.HEAD_DIMS, ids=lambda d: f"D{d}")
def test_block_skip_is_exact_against_a_forced_visit(dev, D, dtype, kind):
    """The dead-tile skip (K1, K2 and K3 ``split3``; the bf16 forward's
    ``tile`` visits every tile) changes no bit: the block wrappers on a
    bias with one entry of every dead tile raised to NEG_INF / 4 (a live
    row's, so the tile is visited and still weighs 0) give O, lse, dq, dk
    and dv equal to the run that skips. Rows with no live key (``left_padded``) keep
    their visit in both runs; the forward's rows are live where they have
    a live key, the backward's where the outside lse is above NEG_INF /
    2."""
    q, k, v, bias, lse_bias = _block_case(dev, D, dtype, kind)
    fwd_live = (bias > attn.NEG_INF / 2).any(dim=-1)[:, 0]
    o_ref, lse = fa.flash_attention_reference(q, k, v, lse_bias, False, True)
    o_ref, lse = o_ref.transpose(1, 2), lse + 0.3
    do = torch.randn(o_ref.shape, device=dev).to(dtype)
    forced, n = _force_visits(bias, fwd_live)
    skipped = fa.flash_block_fwd(q, k, v, bias)
    visited = fa.flash_block_fwd(q, k, v, forced)
    for a, b in zip(skipped, visited):
        assert torch.equal(a, b)
    bwd_live = (lse > attn.NEG_INF / 2).all(dim=1)
    forced_b, n_b = _force_visits(bias, bwd_live)
    skipped = fa.flash_block_bwd(q, k, v, bias, o_ref, lse, do)
    visited = fa.flash_block_bwd(q, k, v, forced_b, o_ref, lse, do)
    for a, b in zip(skipped, visited):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    # the diagonal blocks and the future block have dead tiles to force
    assert (n > 0) == (kind in ("diagonal", "left_padded")) and (n_b > 0) == (kind != "past_padded")


def test_split_planes_matches_plain_bit_for_bit(dev):
    """The split pre-pass (``csrc/split_planes.cu``) against the plain
    split, bit for bit, on a strided view (a head-major tensor seen as
    [B, T, H, D]) of values across f32's range: normal, near bf16's
    smallest normal, subnormal, signed zero."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn(2, 3, 37, 24, generator=gen, device=dev)
    x = x * torch.exp2(torch.randint(-140, 120, x.shape, generator=gen, device=dev).float())
    x.view(-1)[:4] = torch.tensor([0.0, -0.0, 1e-40, -3e-39], device=dev)
    view = x.transpose(1, 2)  # [2, 37, 3, 24], strides of a [B, H, T, D] tensor
    before = fa.FLASH_SPLIT_PLANES_LAUNCHES
    planes = fa.split_planes(view)
    torch.cuda.synchronize()
    assert fa.FLASH_SPLIT_PLANES_LAUNCHES == before + 1
    assert planes.shape == (3, 2, 37, 3, 24) and planes.dtype == torch.bfloat16
    assert planes.is_contiguous()
    want = fa.split_planes_reference(view.cpu())
    assert torch.equal(planes.cpu().view(torch.int16), want.view(torch.int16))


@pytest.fixture
def nccl_mesh(dev, tmp_path):
    """A one-rank NCCL group (a ``file://`` store under the test's
    directory) and ``make_mesh({"dp": -1, "sp": 1})`` over it; the group
    is destroyed after the test."""
    from trlx_tpu_torch.parallel import distributed, make_mesh

    assert distributed.initialize("cuda", init_method=f"file://{tmp_path / 'store'}",
                                  world_size=1, rank=0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        yield make_mesh({"dp": -1, "sp": 1})
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_ring_at_sp_1_through_nccl_matches_dense(nccl_mesh, dtype, causal):
    """``ring_attention_sharded`` on a one-rank NCCL mesh (its ring passes
    nothing): one K1 launch forward (``split3`` in f32, ``tile`` in bf16)
    and one K2 and K3 ``split3`` backward, with the split pre-passes, no
    copy, and the output and gradients of the dense kernels (the causal
    flag and a padding bias); the naive impl agrees."""
    from trlx_tpu_torch.ops import ring_attention as ra

    dev = torch.device("cuda")
    B, T = 2, 130
    q, k, v = (x.requires_grad_() for x in _qkv(dev, B, T, T, dtype=dtype, seed=7))
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[0, T - 3:] = 0
    do = torch.randn(B, T, 2, 64, device=dev).to(dtype)
    before = {**_fwd_counters(), **_bwd_counters(),
              "FLASH_BLOCK_FWD_LAUNCHES": fa.FLASH_BLOCK_FWD_LAUNCHES,
              "FLASH_BLOCK_BWD_LAUNCHES": fa.FLASH_BLOCK_BWD_LAUNCHES}
    out = ra.ring_attention_sharded(q, k, v, nccl_mesh, kv_mask=mask, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    variant = fa.block_forward_variant(dtype, T).upper()
    assert {c: getattr(fa, c) - n for c, n in before.items() if getattr(fa, c) != n} == {
        "FLASH_FWD_LAUNCHES": 1, f"FLASH_FWD_{variant}_LAUNCHES": 1,
        "FLASH_BLOCK_FWD_LAUNCHES": 1, "FLASH_BLOCK_BWD_LAUNCHES": 1,
        "FLASH_BWD_DQ_LAUNCHES": 1, "FLASH_BWD_DKV_LAUNCHES": 1,
        "FLASH_BWD_DQ_SPLIT3_LAUNCHES": 1, "FLASH_BWD_DKV_SPLIT3_LAUNCHES": 1,
        "FLASH_SPLIT_PLANES_LAUNCHES": 4 + 3 * (dtype == torch.float32)}
    dense = fa.flash_attention(q, k, v, attn.padding_bias(mask), causal)
    dense_grads = torch.autograd.grad(dense, (q, k, v), do)
    naive = ra.ring_attention_sharded(q, k, v, nccl_mesh, kv_mask=mask, causal=causal,
                                      impl="naive")
    naive_grads = torch.autograd.grad(naive, (q, k, v), do)
    tol_o = TOL[dtype][0]
    tol_g = 1e-4 if dtype == torch.float32 else 1 / 128
    assert (out.float() - dense.float()).abs().max().item() <= tol_o
    assert (out.float() - naive.float()).abs().max().item() <= tol_o
    for g, d, n in zip(grads, dense_grads, naive_grads):
        scale = max(1.0, d.float().abs().max().item())
        assert (g.float() - d.float()).abs().max().item() <= tol_g * scale
        assert (g.float() - n.float()).abs().max().item() <= tol_g * scale


# ------------------- the rollout cast and async checkpoints ------------------- #

CAST_ARCHS = {  # head dim 64 everywhere: a built instantiation
    "gpt2": {"vocab_size": 64, "n_positions": 64, "n_embd": 128, "n_layer": 2, "n_head": 2},
    "gptj": {"vocab_size": 64, "n_positions": 64, "n_embd": 128, "n_layer": 2, "n_head": 2,
             "rotary_dim": 16},
    "gpt_neox": {"vocab_size": 64, "max_position_embeddings": 64, "hidden_size": 128,
                 "num_hidden_layers": 2, "num_attention_heads": 2, "rotary_pct": 0.25},
    "gpt_neo": {"vocab_size": 64, "max_position_embeddings": 64, "hidden_size": 128,
                "num_layers": 2, "num_heads": 2, "window_size": 4,
                "attention_layers": ["global", "local"]},
    "gpt2_moe": {"vocab_size": 64, "n_positions": 64, "n_embd": 128, "n_layer": 2,
                 "n_head": 2, "n_experts": 4, "moe_every": 2},
}


@pytest.mark.parametrize("family", list(CAST_ARCHS))
@pytest.mark.parametrize("engine", ["fixed", "continuous"])
def test_rollout_cast_collect_is_bit_identical_on_the_card(dev, tmp_path, family, engine):
    """One sampled collect through the kernels with ``rollout_param_cast``
    on and one with it off, from the same seed, the layer norms perturbed:
    ``torch.equal`` tokens, logprobs, values, reference logprobs and
    rewards; the copy's routers, ``fc2`` and norms are the f32 masters."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    runs = {}
    for cast in (True, False):
        cfg = _small_engine_config(tmp_path / str(cast)).to_dict()
        cfg["model"].update(model_type=family, model_arch=dict(CAST_ARCHS[family]))
        cfg["train"]["rollout_param_cast"] = cast
        if engine == "fixed":
            cfg["train"]["rollout"] = {"engine": "fixed"}
        trainer = PPOTrainer(TRLConfig.from_dict(cfg))
        gen = torch.Generator(device=dev).manual_seed(3)
        with torch.no_grad():
            for name, p in trainer.model.named_parameters():
                if ".ln_" in name:
                    p.add_(0.05 * torch.randn(p.shape, generator=gen, device=dev))
        trainer._setup_reference(trainer.model.transformer, trainer.model_config.n_layer)
        orch = PPOOrchestrator(trainer, PromptPipeline(_prompts(), 20),
                               reward_fn=lambda samples, **_: [len(s) / 20.0 for s in samples],
                               chunk_size=8)
        refs, score_ref = [], trainer.score_ref
        trainer.score_ref = lambda *a: refs.append(score_ref(*a)) or refs[-1]
        orch.make_experience(8)
        torch.cuda.synchronize()
        buf = trainer.buffer.full
        runs[cast] = (trainer, {k: getattr(buf, k) for k in (
            "response_tokens", "response_mask", "logprobs", "values", "rewards")},
            torch.cat(refs))
    (on, got, got_ref), (off, want, want_ref) = runs[True], runs[False]
    for key, w in want.items():
        assert torch.equal(got[key], w), key
    assert torch.equal(got_ref, want_ref)
    assert on.rollout_cast_refreshes == 1 and off.rollout_cast_refreshes == 0
    masters = dict(on.model.named_parameters())
    for name, p in on.rollout_model().named_parameters():
        if any(k in name for k in ("router", "fc2", ".ln_")):
            assert p is masters[name], name
        else:
            assert p.dtype == torch.bfloat16 and p.is_cuda, name


def test_async_checkpoint_snapshots_cuda_tensors_before_they_change(dev, tmp_path):
    """An asynchronous save of CUDA state returns with the snapshot in
    page-locked host memory; an in-place update queued right after it
    (the next optimizer step) does not reach the file; the next save of
    the same layout reuses the buffers; ``load`` joins the write."""
    from trlx_tpu_torch.utils import checkpoint as ckpt

    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(1024, 1024, generator=gen, device=dev)
    moments = {"exp_avg": torch.randn(1024, 1024, generator=gen, device=dev)}
    want = (w.clone(), moments["exp_avg"].clone())
    writer = ckpt.CheckpointWriter()
    writer.save(str(tmp_path), {"w": w, "opt": moments, "step": 1}, 1, async_save=True)
    w.mul_(2.0)
    moments["exp_avg"].add_(1.0)
    (bufs,) = writer._buffers.values()
    assert all(b.is_pinned() for b in bufs)
    state = ckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert torch.equal(state["w"], want[0].cpu())
    assert torch.equal(state["opt"]["exp_avg"], want[1].cpu()) and state["step"] == 1
    writer.save(str(tmp_path), {"w": w, "opt": moments, "step": 2}, 2, async_save=True)
    assert next(iter(writer._buffers.values())) is bufs
    ckpt.wait_for_checkpoints()
    state = ckpt.load_checkpoint(str(tmp_path), device=dev)
    assert torch.equal(state["w"], w) and ckpt.all_steps(str(tmp_path)) == [1, 2]


# ------------------------- the int8 KV cache ------------------------- #


def _int8_inputs(dev, B, T, H, D, dtype, seed):
    """K and V [B, T, H, D] with the quantizer's edge rows: an all-zero
    (token, head), exact .5 ties of the f32 scale, and +-absmax."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    k, v = (torch.randn(B, T, H, D, generator=gen, device=dev) * 3 for _ in range(2))
    k[0, 0, 0] = 0.0
    # absmax 127 / 16, so the scale is exactly 1 / 16 and every other
    # value is a tie, (i + 1/2) scales, alternating in sign
    ties = (torch.arange(D, device=dev) % 100 + 0.5) / 16
    ties[0] = 127 / 16
    k[0, -1, -1] = ties * (1 - 2 * (torch.arange(D, device=dev) % 2))
    v[-1, 0, 0] = torch.where(torch.arange(D, device=dev) < D // 2, 4.0, -4.0)
    return k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_quantized_write_matches_plain_bit_for_bit_linear(dev, D, dtype):
    """The quantizing write into a linear int8 cache at [start, start + T)
    equals the plain version (``quantize_kv`` and stores on the CPU) bit
    for bit, values and scales, and counts one launch."""
    from trlx_tpu_torch.models.gpt2 import kv_buffers
    from trlx_tpu_torch.ops import kv_quant

    B, T, H, C = 3, 5, 2, 12
    k, v = _int8_inputs(dev, B, T, H, D, dtype, seed=D)
    got = kv_buffers(1, B, C, H, D, dtype, "int8", device=dev)[0]
    want = kv_buffers(1, B, C, H, D, dtype, "int8")[0]
    before = kv_quant.KV_QUANT_LAUNCHES
    kv_quant.quantized_write(k, v, kv_quant.cache_buffers(got), row_stride=C, start=4)
    assert kv_quant.KV_QUANT_LAUNCHES == before + 1
    kv_quant.quantized_write(k.cpu(), v.cpu(), kv_quant.cache_buffers(want), row_stride=C,
                             start=4)
    assert kv_quant.KV_QUANT_LAUNCHES == before + 1
    for key in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert (want["k"][:, 4:9] != 0).any() and (want["k_scale"][:, :4] == 0).all()


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_quantized_write_matches_plain_bit_for_bit_paged(dev, D):
    """The paged write (rotated block tables, an admitted subset of slots,
    a column sent to the discard sentinel) and its publish into the shared
    pool equal the plain version bit for bit on every real row; the
    sentinels, which several columns may hit, are never read."""
    from trlx_tpu_torch.inference import kv_cache as kvc
    from trlx_tpu_torch.ops import kv_quant

    S, cap, H, T, bs = 4, 16, 2, 8, 4
    k, v = _int8_inputs(dev, 2, T, H, D, torch.bfloat16, seed=7 * D)
    results = []
    for device in (dev, torch.device("cpu")):
        cache = kvc.init_paged_cache(1, S, cap, H, D, torch.bfloat16, "int8", bs, device)[0]
        cache.update(kvc.init_shared_pool(3, bs, H, D, torch.bfloat16, "int8", device))
        tables = kvc.rotate_block_table(cache["block_tables"], 1)[:2]
        positions = torch.arange(T, device=device)[None].repeat(2, 1)
        positions[1, -1] = cap  # the discard sentinel
        phys = kvc.physical_positions(tables, positions, cap)
        slots = torch.tensor([3, 1], device=device)
        publish = torch.tensor([[0, 2, -1, -1], [-1, 1, -1, -1]], device=device)
        pub_blk = torch.gather(publish, 1, (positions // bs).clamp(0, 3))
        pub_rows = torch.where(pub_blk >= 0, pub_blk * bs + positions % bs, 3 * bs)
        kv_quant.quantized_write(
            k.to(device), v.to(device), kv_quant.cache_buffers(cache),
            rows=kv_quant.rows_of(slots, phys, cap + 1),
            publish=kv_quant.cache_buffers(cache, "shared_"), publish_rows=pub_rows)
        results.append({key: t[..., :cap, :, :].cpu() if t.dim() == 4 else t[:-1].cpu()
                        for key, t in cache.items() if key != "block_tables"})
    got, want = results
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _int8_view(dev, B, K, H, D, seed):
    from trlx_tpu_torch.models.gpt2 import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(seed)
    parts = []
    for _ in range(2):
        x = torch.randn(B, K, H, D, generator=gen, device=dev).to(torch.bfloat16)
        values, scale = quantize_kv(x)
        parts.append(attn.QuantizedKV(values, scale, torch.bfloat16))
    return parts


@pytest.mark.parametrize("K", (1, 63, 64, 65, 112, 576))
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_int8_decode_matches_plain(dev, D, K):
    """K1's decode_int8 against dequantization followed by the plain
    version, within the bf16 decode's tolerance, with a padding bias, the
    causal flag, and a batch row with no live key (K1's ``p_scale`` against
    the plain one); it counts its own launches, and its output is the bf16
    decode's on the dequantized view, bit for bit (the math after the load
    is the same)."""
    B, H, Q = 3, 2, 1
    (q,) = _qkv(dev, B, Q, 1, H=H, D=D, dtype=torch.bfloat16, seed=D + K)[:1]
    k, v = _int8_view(dev, B, K, H, D, seed=D * K)
    keep = torch.ones(B, K, dtype=torch.long, device=dev)
    keep[0, : K // 2] = 0
    keep[2] = 0  # no live key
    tol_o, tol_lse = TOL[torch.bfloat16]
    for name, (bias, causal) in {"none": (None, False),
                                 "padding": (attn.padding_bias(keep), False),
                                 "causal": (None, True)}.items():
        before = _fwd_counters(), fa.FLASH_FWD_DECODE_INT8_LAUNCHES
        o, lse, p_scale = fa._launch_int8(q, k, v, bias, causal, True, with_p_scale=True)
        assert fa.FLASH_FWD_DECODE_INT8_LAUNCHES == before[1] + 1, name
        assert _moved(before[0]) == {"FLASH_FWD_LAUNCHES": 1}, name
        o_ref, lse_ref, ps_ref = _visited_reference(
            q, k.dequantize(), v.dequantize(), bias, causal, p_scale=True)
        assert (o.float() - o_ref.float()).abs().max().item() <= tol_o, name
        assert (lse - lse_ref).abs().max().item() <= tol_lse, name
        assert torch.allclose(p_scale, ps_ref, rtol=1e-6, atol=0), name
        o_bf16 = fa.flash_attention(q, k.dequantize(), v.dequantize(), bias, causal)
        assert torch.equal(o, o_bf16), name


def test_int8_attention_routes(dev):
    """``dot_product_attention`` on QuantizedKV: Q <= 16 in bf16 launches
    decode_int8; a wider window, f32 and a query that requires grad run
    K1 on the dequantized view; int8 K/V anywhere else are refused by
    name; a view the 8-byte loads cannot read is copied and counted."""
    B, H, D, K = 2, 2, 64, 80
    k, v = _int8_view(dev, B, K, H, D, seed=3)
    for Q, dtype, grad, variant in ((1, torch.bfloat16, False, "DECODE_INT8"),
                                    (16, torch.bfloat16, False, "DECODE_INT8"),
                                    (17, torch.bfloat16, False, "TILE"),
                                    (1, torch.float32, False, "FMA"),
                                    (1, torch.bfloat16, True, "DECODE")):
        q = torch.randn(B, Q, H, D, device=dev, dtype=dtype, requires_grad=grad)
        kk, vv = (attn.QuantizedKV(t.values, t.scale, dtype) for t in (k, v))
        counter = f"FLASH_FWD_{variant}_LAUNCHES"
        before = getattr(fa, counter)
        attn.dot_product_attention(q, kk, vv)
        assert getattr(fa, counter) == before + 1, (Q, dtype, grad)
    q = torch.randn(B, 1, H, D, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="flash_attention_int8"):
        fa.flash_attention(q, k.values, v.values)
    odd = attn.QuantizedKV(torch.zeros(B, K, H, D + 8, dtype=torch.int8, device=dev)[..., 4:D + 4],
                           k.scale, torch.bfloat16)
    before = fa.FLASH_FWD_COPIES
    o = attn.dot_product_attention(q, odd, v)
    assert fa.FLASH_FWD_COPIES == before + 1 and torch.isfinite(o).all()


def test_int8_sampler_runs_every_decode_through_the_kernels(dev):
    """A greedy fixed-sampler rollout of a tiny bf16 GPT-2 on an int8
    cache: one quantizing write and one decode_int8 launch per layer and
    decode step, no plain attention, and the tokens of the same rollout
    with the plain versions on the CPU."""
    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, init_cache
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
    from trlx_tpu_torch.ops import kv_quant
    from trlx_tpu_torch.ops.sampling import GenerationConfig, make_sampler

    cfg = GPT2Config(vocab_size=64, n_positions=64, n_embd=128, n_layer=2, n_head=2,
                     dtype="bfloat16", kv_cache_dtype="int8")
    gen = GenerationConfig.from_dict({"max_new_tokens": 6, "min_new_tokens": 6,
                                      "do_sample": False, "eos_token_id": 63,
                                      "pad_token_id": 63})
    model = CausalLMWithValueHead(cfg, GPT2Model, device="cpu")
    init_params(model, 0)
    ids = torch.randint(0, 60, (4, 8), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[0, :3] = 0
    outs = []
    for device in (dev, torch.device("cpu")):
        m, calls = model.to(device), []

        def apply(*a, m=m, **kw):
            calls.append(a[0].shape[1])
            return m(*a, **kw)

        sampler = make_sampler(apply, lambda b, c, d=device: init_cache(cfg, b, c, d), gen, 8)
        before = kv_quant.KV_QUANT_LAUNCHES, fa.FLASH_FWD_DECODE_INT8_LAUNCHES
        outs.append(sampler(ids.to(device), mask.to(device)))
        moved = (kv_quant.KV_QUANT_LAUNCHES - before[0],
                 fa.FLASH_FWD_DECODE_INT8_LAUNCHES - before[1])
        if device.type == "cuda":
            torch.cuda.synchronize()
            # every forward writes once a layer; the 8-column prefill and
            # every step are decode-variant widths
            assert len(calls) > 1 and max(calls) <= 16
            assert moved == (2 * len(calls), 2 * len(calls)), moved
        else:
            assert moved == (0, 0)
    assert torch.equal(outs[0].tokens.cpu(), outs[1].tokens)


def test_health_observe_forces_no_synchronisation(dev):
    """``HealthMonitor.observe`` on a row holding CUDA scalars reads none
    of them (no device synchronisation under the sync debug mode's
    ``error``) and observes the host values."""
    from trlx_tpu_torch.telemetry.health import HealthConfig, HealthMonitor

    monitor = HealthMonitor(HealthConfig(enabled=True))
    row = {"losses/total_loss": torch.tensor(1.0, device=dev),
           "health/entropy": torch.tensor(2.0, device=dev), "optimizer/grad_norm": 0.5}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        monitor.observe(row, step=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert monitor.latest == {"optimizer/grad_norm": 0.5}


# ----------------------- resumable training on the card ----------------------- #


def test_cuda_generator_resumes_the_same_sampled_tokens(dev, tmp_path):
    """The sampler's CUDA generator goes through ``save`` and ``load``: a
    fresh trainer that loads the checkpoint samples the same tokens,
    logprobs and values as the trainer that wrote it samples next."""
    import copy

    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    config = _small_engine_config(tmp_path)
    config.train.rollout = {}
    trainer = PPOTrainer(copy.deepcopy(config))
    assert trainer.generator.device.type == "cuda"
    pipe = PromptPipeline(_prompts(), 20)
    ids, mask = torch.from_numpy(pipe.input_ids), torch.from_numpy(pipe.attention_mask)
    trainer.sample(ids, mask)  # the generator moves off its seed
    trainer.save()
    want = trainer.sample(ids, mask)
    fresh = PPOTrainer(copy.deepcopy(config))
    fresh.load(str(tmp_path))
    got = fresh.sample(ids, mask)
    torch.cuda.synchronize()
    for key in ("tokens", "response_mask", "logprobs", "values"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    assert torch.equal(fresh.generator.get_state(), trainer.generator.get_state())


def test_drain_under_async_checkpoint_lands_before_it_raises(dev, tmp_path, monkeypatch):
    """``maybe_drain`` after a SIGTERM under ``async_checkpoint``: the
    emergency save returns before its bytes land (the write is slowed
    here), and the drain joins it, so when ``PreemptionDrain`` is raised
    the step is on disk and loads."""
    import os
    import signal
    import time

    from trlx_tpu_torch.resilience import preemption
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils import checkpoint as ckpt

    config = _small_engine_config(tmp_path)
    config.train.rollout = {}
    config.train.training["async_checkpoint"] = True
    trainer = PPOTrainer(config)
    trainer.step = 7
    write_once = ckpt._write_once

    def slow_write(*args):
        time.sleep(1.0)
        return write_once(*args)

    monkeypatch.setattr(ckpt, "_write_once", slow_write)
    handlers = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    preemption.install_guard()
    try:
        trainer.maybe_drain(phase=0, step=7)  # no signal yet: returns
        assert ckpt.all_steps(str(tmp_path)) == []
        os.kill(os.getpid(), signal.SIGTERM)
        with pytest.raises(preemption.PreemptionDrain) as info:
            trainer.maybe_drain(phase=0, step=7)
        assert info.value.step == 7 and info.value.exit_code == 75
        assert ckpt.all_steps(str(tmp_path)) == [7]
        assert trainer._checkpoints._thread is None
        state = ckpt.load_checkpoint(str(tmp_path), device="cpu")
        assert state["step"] == 7
        assert torch.equal(state["model"]["v_head.fc2.weight"],
                           trainer.model.state_dict()["v_head.fc2.weight"].cpu())
    finally:
        preemption.uninstall_guard()
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == handlers
