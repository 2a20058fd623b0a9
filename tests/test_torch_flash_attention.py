"""The port's flash-attention forward (its plain version, on the CPU)
against the JAX package's Pallas kernel in interpret mode and its
``dot_product_attention``.

Inputs come from a numpy seed and go through both packages in f32; every
case of ``tests/test_flash_attention.py``'s forward class plus decode
(Q = 1), three each at GPT-J's head dim 256, GPT-NeoX-20B's 96 and
the small head dims 16 (the learning guard, the T5 stand-in), 24 (the
randomwalks configs) and 32 (the GPT-2 stand-in), and four at GPT-Neo's
128 (causal + padding, a per-head bias, and its local layers' band bias,
built by each package's ``local_causal_bias``, over 150 keys at a window
of 20, so whole 64-key tiles and the reference's 16-key blocks are
masked, and at one decode row per-row depths), is one parametrised
case. Tolerance: atol 1e-5 (f32; the two sum in a different order). The CUDA kernel itself is compared with this plain
version on the card by ``chip_smoke.py``. The tests at the end pin, on the
CPU, what the wrapper decides before a launch: which K1 variant a dtype
and query count take, which views it copies for the 16-byte loads, and
the causal visit rule the backward kernels repeat.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models import gpt_neo as jneo
from trlx_tpu.ops import attention as jattn
from trlx_tpu.ops.flash_attention import flash_attention as jflash
from trlx_tpu.ops.flash_attention import flash_block_fwd as jflash_block_fwd
from trlx_tpu_torch.models import gpt_neo as tneo
from trlx_tpu_torch.ops import attention as tattn
from trlx_tpu_torch.ops import flash_attention as tflash

ATOL = 1e-5
#: the local band's window in the GPT-Neo cases
BAND_WINDOW = 20
#: the small head dims K1 is built for besides 64, 96, 128 and 256
SMALL_HEAD_DIMS = (16, 24, 32)


def _padding_mask(rng, B, T, keep_first=4):
    return (rng.integers(0, 2, size=(B, T)) | (np.arange(T)[None] < keep_first)).astype(np.int32)


def _case(name):
    """(q, k, v, bias-or-None [numpy], causal) for one named case."""
    rng = np.random.default_rng(abs(hash(name)) % (2**32))

    def rand(*shape):
        return rng.normal(size=shape).astype(np.float32)

    if name == "causal_with_padding":
        B, T, H, D = 2, 48, 4, 32
        mask = _padding_mask(rng, B, T)
        return rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D), ("pad", mask), True
    if name == "unequal_q_k":
        B, Q, K, H, D = 1, 21, 37, 4, 32
        return rand(B, Q, H, D), rand(B, K, H, D), rand(B, K, H, D), None, True
    if name == "per_head_bias":
        B, Q, K, H, D = 1, 24, 40, 4, 32
        return rand(B, Q, H, D), rand(B, K, H, D), rand(B, K, H, D), ("raw", rand(1, H, Q, K)), False
    if name == "padding_only":
        B, T, H, D = 2, 32, 2, 16
        mask = _padding_mask(rng, B, T, keep_first=1)
        return rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D), ("pad", mask), False
    if name == "decode_q1":
        mask = (rng.random((2, 64)) > 0.2).astype(np.int32)
        return rand(2, 1, 3, 16), rand(2, 64, 3, 16), rand(2, 64, 3, 16), ("pad", mask), False
    if name == "decode_q1_head_dim_64":
        # the serving decode shape at tiny batch: per-row causal offsets
        depth = np.array([5, 70])
        mask = (np.arange(80)[None] <= depth[:, None]).astype(np.int32)
        return rand(2, 1, 2, 64), rand(2, 80, 2, 64), rand(2, 80, 2, 64), ("decode", mask, depth), False
    # GPT-J's head dim (D = 256), which K1's second instantiation serves
    if name == "causal_padding_head_dim_256":
        B, T, H, D = 1, 40, 2, 256
        mask = _padding_mask(rng, B, T)
        return rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D), ("pad", mask), True
    if name == "per_head_bias_head_dim_256":
        B, Q, K, H, D = 1, 19, 33, 2, 256
        return rand(B, Q, H, D), rand(B, K, H, D), rand(B, K, H, D), ("raw", rand(1, H, Q, K)), False
    if name == "decode_q1_head_dim_256":
        depth = np.array([3, 41])
        mask = (np.arange(48)[None] <= depth[:, None]).astype(np.int32)
        return (rand(2, 1, 2, 256), rand(2, 48, 2, 256), rand(2, 48, 2, 256),
                ("decode", mask, depth), False)
    # GPT-NeoX-20B's head dim (D = 96), which K1's third instantiation serves
    if name == "causal_padding_head_dim_96":
        B, T, H, D = 2, 70, 2, 96
        mask = _padding_mask(rng, B, T)
        return rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D), ("pad", mask), True
    if name == "per_head_bias_head_dim_96":
        B, Q, K, H, D = 1, 19, 77, 3, 96
        return rand(B, Q, H, D), rand(B, K, H, D), rand(B, K, H, D), ("raw", rand(1, H, Q, K)), False
    if name == "decode_q1_head_dim_96":
        depth = np.array([9, 66])
        mask = (np.arange(72)[None] <= depth[:, None]).astype(np.int32)
        return (rand(2, 1, 4, 96), rand(2, 72, 4, 96), rand(2, 72, 4, 96),
                ("decode", mask, depth), False)
    # GPT-Neo's head dim (D = 128): its global layers' causal flag, a
    # per-head bias, its local layers' band (window 20 over 150 keys: the
    # rows from 84 on mask whole 64-key tiles) with padding, and a decode
    # row at per-row depths under the band
    if name == "causal_padding_head_dim_128":
        B, T, H, D = 2, 70, 2, 128
        mask = _padding_mask(rng, B, T)
        return rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D), ("pad", mask), True
    if name == "per_head_bias_head_dim_128":
        B, Q, K, H, D = 1, 19, 77, 2, 128
        return rand(B, Q, H, D), rand(B, K, H, D), rand(B, K, H, D), ("raw", rand(1, H, Q, K)), False
    if name == "band_head_dim_128":
        B, T, H, D = 2, 150, 2, 128
        mask = _padding_mask(rng, B, T)
        return (rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D),
                ("band", mask, 0, BAND_WINDOW), False)
    if name == "decode_q1_band_head_dim_128":
        depth = np.array([9, 140])
        mask = (np.arange(150)[None] <= depth[:, None]).astype(np.int32)
        return (rand(2, 1, 2, 128), rand(2, 150, 2, 128), rand(2, 150, 2, 128),
                ("band", mask, depth, BAND_WINDOW), False)
    # the small head dims, each a tile padded to one 64-column atom on the
    # card: causal + padding over two key tiles, a per-head bias, one
    # decode row at per-row depths
    kind, _, dim = name.rpartition("_head_dim_")
    if dim.isdigit() and int(dim) in SMALL_HEAD_DIMS:
        D = int(dim)
        if kind == "causal_padding":
            B, T, H = 2, 70, 3
            mask = _padding_mask(rng, B, T)
            return rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D), ("pad", mask), True
        if kind == "per_head_bias":
            B, Q, K, H = 1, 19, 77, 3
            return (rand(B, Q, H, D), rand(B, K, H, D), rand(B, K, H, D),
                    ("raw", rand(1, H, Q, K)), False)
        if kind == "decode_q1":
            depth = np.array([9, 66])
            mask = (np.arange(72)[None] <= depth[:, None]).astype(np.int32)
            return (rand(2, 1, 6, D), rand(2, 72, 6, D), rand(2, 72, 6, D),
                    ("decode", mask, depth), False)
    raise KeyError(name)


CASES = [
    "causal_with_padding", "unequal_q_k", "per_head_bias", "padding_only",
    "decode_q1", "decode_q1_head_dim_64", "causal_padding_head_dim_256",
    "per_head_bias_head_dim_256", "decode_q1_head_dim_256", "causal_padding_head_dim_96",
    "per_head_bias_head_dim_96", "decode_q1_head_dim_96", "causal_padding_head_dim_128",
    "per_head_bias_head_dim_128", "band_head_dim_128", "decode_q1_band_head_dim_128",
    *(f"{kind}_head_dim_{D}" for D in SMALL_HEAD_DIMS
      for kind in ("causal_padding", "per_head_bias", "decode_q1")),
]


def _biases(spec):
    """The same bias built by each package's own helpers."""
    if spec is None:
        return None, None
    kind = spec[0]
    if kind == "raw":
        return jnp.asarray(spec[1]), torch.from_numpy(spec[1])
    if kind == "pad":
        mask = spec[1]
        return (
            jattn.padding_bias(jnp.asarray(mask)),
            tattn.padding_bias(torch.from_numpy(mask)),
        )
    if kind == "band":  # GPT-Neo's local band from the query offset, plus padding
        _, mask, offset, window = spec
        B, K = mask.shape
        Q = 1 if np.ndim(offset) else K
        jb = jattn.combine_biases(
            jneo.local_causal_bias(Q, K, window, offset=jnp.asarray(offset)),
            jattn.padding_bias(jnp.asarray(mask)),
        )
        tb = tattn.combine_biases(
            tneo.local_causal_bias(Q, K, window, torch.as_tensor(offset)),
            tattn.padding_bias(torch.from_numpy(mask)),
        )
        return jb, tb
    _, mask, depth = spec
    K = mask.shape[1]
    jb = jattn.combine_biases(
        jattn.causal_bias(1, K, offset=jnp.asarray(depth)),
        jattn.padding_bias(jnp.asarray(mask)),
    )
    tb = tattn.combine_biases(
        tattn.causal_bias(1, K, offset=torch.from_numpy(depth)),
        tattn.padding_bias(torch.from_numpy(mask)),
    )
    return jb, tb


@pytest.mark.parametrize("name", CASES)
def test_flash_forward_matches_jax(name):
    q, k, v, spec, causal = _case(name)
    jb, tb = _biases(spec)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))

    out = tflash.flash_attention(tq, tk, tv, tb, causal=causal).numpy()
    j_kernel = jflash(jq, jk, jv, jb, causal=causal, block_q=16, block_k=16,
                      interpret=True)
    j_xla = jattn.dot_product_attention(jq, jk, jv, jb, causal=causal)
    np.testing.assert_allclose(out, np.asarray(j_kernel), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, np.asarray(j_xla), atol=ATOL, rtol=0)
    # the port's attention entry point takes the same route on the CPU
    via_dispatch = tattn.dot_product_attention(tq, tk, tv, tb, causal=causal)
    np.testing.assert_array_equal(via_dispatch.numpy(), out)


@pytest.mark.parametrize("name", ["per_head_bias", "padding_only", "decode_q1"])
def test_flash_lse_matches_jax_block_forward(name):
    """The LSE the kernel emits ([B, H, Q] f32) against the JAX package's
    single-block forward, which returns the same statistic."""
    q, k, v, spec, causal = _case(name)
    assert not causal
    jb, tb = _biases(spec)
    o, lse = tflash.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), tb, return_lse=True
    )
    jo, jlse = jflash_block_fwd(
        *(jnp.asarray(x) for x in (q, k, v)), jb, block_q=16, block_k=16,
        interpret=True,
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        o.numpy(), np.transpose(np.asarray(jo), (0, 2, 1, 3)), atol=ATOL, rtol=0
    )


def test_fully_masked_rows_average_the_real_keys():
    """A row whose keys are all masked comes out uniform over the K real
    keys (finite NEG_INF), exactly as ``dot_product_attention``."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(1, T, 2, 16)).astype(np.float32) for T in (3, 5, 5))
    mask = np.zeros((1, 5), np.int32)
    out = tflash.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        tattn.padding_bias(torch.from_numpy(mask)),
    ).numpy()
    np.testing.assert_allclose(out, np.broadcast_to(v.mean(1, keepdims=True), out.shape), atol=ATOL)
    ref = jattn.dot_product_attention(
        *(jnp.asarray(x) for x in (q, k, v)), jattn.padding_bias(jnp.asarray(mask))
    )
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


def test_dot_product_attention_is_the_flash_forward(monkeypatch):
    """Every call of the attention entry point goes to the flash forward
    (the kernel on the card); there is no other route and no option that
    selects one. ``learned_bias`` (T5's relative position bias) takes the
    same route: it only declares that the bias may require grad."""
    calls = []
    monkeypatch.setattr(
        tflash, "flash_attention", lambda *a, **kw: calls.append((a, kw)) or a[0]
    )
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 2, 8)).astype(np.float32)) for _ in range(3))
    bias = torch.zeros(1, 2, 4, 4)
    tattn.dot_product_attention(q, k, v, bias)
    tattn.dot_product_attention(q, k, v, causal=True)
    tattn.dot_product_attention(q, k, v, bias.requires_grad_(), learned_bias=True)
    assert [kw["causal"] for _, kw in calls] == [False, True, False]
    assert calls[0][0][3] is bias and calls[1][0][3] is None and calls[2][0][3] is bias
    with pytest.raises(TypeError):
        tattn.dot_product_attention(q, k, v, bias, force_flash=True)


def test_kernel_wrapper_refuses_other_devices():
    """Off the CPU the wrapper launches the kernel or raises — a tensor on
    a device the kernel does not run on is refused, never computed by the
    plain version. The launch counter does not move."""
    q = torch.empty(1, 4, 2, 64, device="meta")
    before = tflash.FLASH_FWD_LAUNCHES
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention(q, q, q)
    assert tflash.FLASH_FWD_LAUNCHES == before


def test_causal_bias_matches_jax():
    for offset in (0, 3, np.array([0, 2, 5])):
        j = jattn.causal_bias(4, 9, offset=jnp.asarray(offset) if isinstance(offset, np.ndarray) else offset)
        t = tattn.causal_bias(4, 9, offset=torch.from_numpy(offset) if isinstance(offset, np.ndarray) else offset)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize(
    "dtype, Q, variant",
    [
        (torch.bfloat16, 1, "decode"), (torch.bfloat16, 16, "decode"),
        (torch.bfloat16, 17, "tile"), (torch.bfloat16, 512, "tile"),
        (torch.float32, 1, "fma"), (torch.float32, 16, "fma"),
        (torch.float32, 17, "fma"), (torch.float32, 512, "fma"),
    ],
)
def test_forward_variant_boundaries(dtype, Q, variant):
    """bf16 takes the decode variant up to 16 query rows and the tensor-core
    tile above; f32 always takes the FMA parity path. The decode variant
    covers exactly the rows whose query tile is 16 rows (the causal visit
    rule's tile), the tile variant those whose tile is 64."""
    assert tflash.forward_variant(dtype, Q) == variant
    if dtype == torch.bfloat16:
        assert (variant == "decode") == (tflash.forward_block_q(Q) == 16)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8], ids=str)
def test_unsupported_dtype_is_refused_before_any_launch(dtype):
    with pytest.raises(ValueError, match="unsupported dtype"):
        tflash.forward_variant(dtype, 4)
    q = torch.empty(1, 4, 2, 64, dtype=dtype, device="meta")
    counters = ("FLASH_FWD_LAUNCHES", "FLASH_FWD_TILE_LAUNCHES",
                "FLASH_FWD_DECODE_LAUNCHES", "FLASH_FWD_FMA_LAUNCHES", "FLASH_FWD_COPIES")
    before = [getattr(tflash, c) for c in counters]
    with pytest.raises(ValueError, match="dtype"):
        tflash.flash_attention(q, q, q)
    assert [getattr(tflash, c) for c in counters] == before


def test_forward_tiles_and_visit_rule_unchanged():
    """The causal visit rule the backward kernels repeat: 16-row query tiles
    up to Q = 16, 64-row tiles above, 64-key tiles that start before the end
    of the row's query tile."""
    assert [tflash.forward_block_q(Q) for Q in (1, 2, 16, 17, 63, 64, 65, 112)] == [
        16, 16, 16, 64, 64, 64, 64, 64]
    for Q, K in ((1, 576), (16, 65), (17, 150), (112, 112), (130, 300)):
        bq = 16 if Q <= 16 else 64
        want = np.array([[(kj // 64) * 64 < (qi // bq + 1) * bq for kj in range(K)]
                         for qi in range(Q)])
        np.testing.assert_array_equal(tflash.visited_keys(Q, K).numpy(), want)


def test_alignment_rule_for_16_byte_loads():
    """Which views the bf16 variants read in place: a 16-byte-aligned base
    and strides in multiples of 8 elements; a size-1 dim's stride is free.
    Anything else the wrapper copies (and counts) before the launch."""
    ok = tflash.aligned_for_16_byte_loads
    x = torch.zeros(2, 5, 3, 64, dtype=torch.bfloat16)
    assert ok(x)
    qkv = torch.zeros(2, 5, 3 * 3 * 64, dtype=torch.bfloat16)  # GPT-2's packed layout
    assert all(ok(t.view(2, 5, 3, 64)) for t in qkv.split(3 * 64, dim=-1))
    flat = torch.zeros(2 * 5 * 3 * 64 + 8, dtype=torch.bfloat16)
    assert not ok(flat[1:1 + x.numel()].view(2, 5, 3, 64))  # base off by 2 bytes
    assert ok(flat[8:8 + x.numel()].view(2, 5, 3, 64))
    wide = torch.zeros(2, 5, 3 * 64 + 4, dtype=torch.bfloat16)  # row stride 196
    assert not ok(wide[..., :192].unflatten(-1, (3, 64)))
    assert ok(torch.zeros(2, 1, 3, 64, dtype=torch.bfloat16).as_strided((2, 1, 3, 64), (192, 3, 64, 1)))
    assert not ok(torch.zeros(2, 5, 64, 3, dtype=torch.bfloat16).transpose(-1, -2))


@pytest.mark.parametrize("variant, copies", [("tile", 3), ("decode", 2), ("fma", 0)])
def test_kernel_inputs_copy_what_the_variant_cannot_read(variant, copies):
    """A contiguous view at a misaligned base (q) and a row stride that is
    no multiple of 8 elements (k, v) are copied for the variants that read
    them with 16-byte loads, into aligned contiguous tensors with the same
    values; the decode variant reads q narrow and the FMA variant reads
    all three in place. An aligned view is passed through uncopied."""
    shape = (2, 5, 3, 64)
    flat = torch.arange(2 * 5 * 3 * 64 + 1, dtype=torch.float32).bfloat16()
    q = flat[1:].view(shape)
    wide = torch.randn(2, 5, 3 * 64 + 4).bfloat16()
    k = wide[..., :192].unflatten(-1, (3, 64))
    v = wide[..., 4:].unflatten(-1, (3, 64))
    (q2, k2, v2), n = tflash.kernel_inputs(variant, q, k, v)
    assert n == copies
    for before, after, wide_load in zip((q, k, v), (q2, k2, v2), tflash._WIDE_LOADS[variant]):
        assert torch.equal(before, after)
        assert (after is not before) == wide_load
        if wide_load:
            assert tflash.aligned_for_16_byte_loads(after)
    aligned = torch.zeros(shape, dtype=torch.bfloat16)
    (a, b, c), n = tflash.kernel_inputs(variant, aligned, aligned, aligned)
    assert n == 0 and a is aligned and b is aligned and c is aligned
