"""The port's flash-attention backward (its plain version and the autograd
``Function``, on the CPU) against the JAX package's Pallas backward in
interpret mode.

- ``flash_attention_backward_reference`` takes the JAX ``_fwd``'s own O and
  LSE and a random dO, and must give the dQ/dK/dV of the JAX ``_bwd`` run in
  interpret mode with 16-wide blocks, on the three gradient cases of
  ``tests/test_flash_attention.py::TestFlashBackward``, two at GPT-J's
  head dim 256 and three each at GPT-NeoX-20B's 96 and the small head
  dims 16 (the learning guard, the T5 stand-in), 24 (the randomwalks
  configs) and 32 (the GPT-2 stand-in): causal + padding, a per-head bias,
  one decode row; and three at GPT-Neo's 128: causal + padding, its local
  layers' band bias with padding over 150 keys at a window of 20 (whole
  64-key tiles masked), and one decode row under the band at per-row
  depths.
- The port's ``FlashAttention`` gradients (through
  ``dot_product_attention``) must equal ``jax.grad`` of the JAX
  ``flash_attention(..., interpret=True)`` on the same loss.
- A bias that does not require grad gets no gradient. A learned bias (T5's
  relative position bias) does: the plain backward's dbias (dS, summed
  where the bias broadcasts) equals ``jax.grad`` of the reference's
  ``dot_product_attention(learned_bias=True)`` (XLA's einsum path) with
  respect to the bias within 1e-5 of the largest, and the ``Function``'s
  equals torch autograd through the plain forward, also at the T5
  stand-in's head dim 16. A learned bias under the
  causal flag, or a bias that requires grad without ``learned_bias``, is
  refused.
- On PPO's left padding, a row with no live key takes the derivative of
  the weights its forward used (``p_scale``), as autograd through the
  plain forward and ``jax.grad`` of the JAX package's XLA attention do.

Inputs come from a numpy seed, in f32. Tolerance: atol 2e-5 (1e-5 at head
dims 256, 128, 96, 32, 24 and 16) on gradients of O(1) magnitude — both
sides compute in f32 and differ only in the order of their sums (the JAX kernel sums per 16-wide tile, the plain version in
one einsum). The CUDA kernels are held against this plain version on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models import gpt_neo as jneo
from trlx_tpu.ops import attention as jattn
from trlx_tpu.ops import flash_attention as jfa
from trlx_tpu_torch.models import gpt_neo as tneo
from trlx_tpu_torch.ops import attention as tattn
from trlx_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5
#: the cases named by a head dim (GPT-J's 256, GPT-Neo's 128,
#: GPT-NeoX-20B's 96 and the small dims below), held to 1e-5
ATOL_WIDE_HEADS = 1e-5
#: the small head dims K2 and K3 are built for besides 64, 96, 128 and 256
SMALL_HEAD_DIMS = (16, 24, 32)
#: the local band's window in the GPT-Neo cases
BAND_WINDOW = 20


def _atol(name):
    return ATOL_WIDE_HEADS if "_head_dim_" in name else ATOL


CASES = ["causal_padding", "unequal_causal", "per_head_bias",
         "causal_padding_head_dim_256", "per_head_bias_head_dim_256",
         "causal_padding_head_dim_96", "per_head_bias_head_dim_96", "decode_q1_head_dim_96",
         *(f"{kind}_head_dim_{D}" for D in SMALL_HEAD_DIMS
           for kind in ("causal_padding", "per_head_bias", "decode_q1")),
         "causal_padding_head_dim_128", "band_head_dim_128", "decode_q1_band_head_dim_128"]


def _case(name):
    """(q, k, v, bias spec, causal): the JAX backward tests' three cases."""
    rng = np.random.default_rng(CASES.index(name))

    def rand(*shape):
        return rng.normal(size=shape).astype(np.float32)

    if name == "causal_padding":
        B, T, H, D = 2, 48, 4, 32
        mask = (rng.integers(0, 2, size=(B, T)) | (np.arange(T)[None] < 4)).astype(np.int32)
        return rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D), ("pad", mask), True
    if name == "unequal_causal":
        B, Q, K, H, D = 1, 21, 37, 4, 32
        return rand(B, Q, H, D), rand(B, K, H, D), rand(B, K, H, D), None, True
    if name == "per_head_bias":
        B, Q, K, H, D = 1, 24, 40, 4, 32
        return rand(B, Q, H, D), rand(B, K, H, D), rand(B, K, H, D), ("raw", rand(1, H, Q, K)), False
    # GPT-J's head dim (D = 256), which K2's and K3's second instantiations serve
    if name == "causal_padding_head_dim_256":
        B, T, H, D = 1, 40, 2, 256
        mask = (rng.integers(0, 2, size=(B, T)) | (np.arange(T)[None] < 4)).astype(np.int32)
        return rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D), ("pad", mask), True
    if name == "per_head_bias_head_dim_256":
        B, Q, K, H, D = 1, 19, 33, 2, 256
        return rand(B, Q, H, D), rand(B, K, H, D), rand(B, K, H, D), ("raw", rand(1, H, Q, K)), False
    # GPT-NeoX-20B's head dim (D = 96), which K2's and K3's third instantiations serve
    if name == "causal_padding_head_dim_96":
        B, T, H, D = 2, 70, 2, 96
        mask = (rng.integers(0, 2, size=(B, T)) | (np.arange(T)[None] < 4)).astype(np.int32)
        return rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D), ("pad", mask), True
    if name == "per_head_bias_head_dim_96":
        B, Q, K, H, D = 1, 19, 77, 3, 96
        return rand(B, Q, H, D), rand(B, K, H, D), rand(B, K, H, D), ("raw", rand(1, H, Q, K)), False
    if name == "decode_q1_head_dim_96":
        B, K, H, D = 2, 72, 4, 96
        mask = (rng.integers(0, 2, size=(B, K)) | (np.arange(K)[None] < 4)).astype(np.int32)
        return rand(B, 1, H, D), rand(B, K, H, D), rand(B, K, H, D), ("pad", mask), False
    # GPT-Neo's head dim (D = 128): its global layers' causal flag, and its
    # local layers' band (window 20 over 150 keys: the rows from 84 on mask
    # whole 64-key tiles) with padding, at every row and at one decode row
    if name == "causal_padding_head_dim_128":
        B, T, H, D = 2, 70, 2, 128
        mask = (rng.integers(0, 2, size=(B, T)) | (np.arange(T)[None] < 4)).astype(np.int32)
        return rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D), ("pad", mask), True
    if name == "band_head_dim_128":
        B, T, H, D = 2, 150, 2, 128
        mask = (rng.integers(0, 2, size=(B, T)) | (np.arange(T)[None] < 4)).astype(np.int32)
        return (rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D),
                ("band", mask, 0), False)
    if name == "decode_q1_band_head_dim_128":
        depth = np.array([9, 140])
        mask = (np.arange(150)[None] <= depth[:, None]).astype(np.int32)
        return (rand(2, 1, 2, 128), rand(2, 150, 2, 128), rand(2, 150, 2, 128),
                ("band", mask, depth), False)
    # the small head dims, each a tile padded to one 64-column atom on the card
    kind, _, dim = name.rpartition("_head_dim_")
    if dim.isdigit() and int(dim) in SMALL_HEAD_DIMS:
        D = int(dim)
        if kind == "causal_padding":
            B, T, H = 2, 70, 3
            mask = (rng.integers(0, 2, size=(B, T)) | (np.arange(T)[None] < 4)).astype(np.int32)
            return rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D), ("pad", mask), True
        if kind == "per_head_bias":
            B, Q, K, H = 1, 19, 77, 3
            return (rand(B, Q, H, D), rand(B, K, H, D), rand(B, K, H, D),
                    ("raw", rand(1, H, Q, K)), False)
        if kind == "decode_q1":
            B, K, H = 2, 72, 6
            mask = (rng.integers(0, 2, size=(B, K)) | (np.arange(K)[None] < 4)).astype(np.int32)
            return rand(B, 1, H, D), rand(B, K, H, D), rand(B, K, H, D), ("pad", mask), False
    raise KeyError(name)


def _biases(spec):
    if spec is None:
        return None, None
    if spec[0] == "raw":
        return jnp.asarray(spec[1]), torch.from_numpy(spec[1])
    mask = spec[1]
    jb, tb = jattn.padding_bias(jnp.asarray(mask)), tattn.padding_bias(torch.from_numpy(mask))
    if spec[0] == "band":  # GPT-Neo's local band from the query offset, plus padding
        offset, K = spec[2], mask.shape[1]
        Q = 1 if np.ndim(offset) else K
        jb = jb + jneo.local_causal_bias(Q, K, BAND_WINDOW, offset=jnp.asarray(offset))
        tb = tb + tneo.local_causal_bias(Q, K, BAND_WINDOW, torch.as_tensor(offset))
    return jb, tb


def _jax_fwd_bwd(q, k, v, jb, do, causal):
    """The JAX package's forward and backward kernels (interpret mode,
    16-wide blocks) in the public layout: (o, lse, dq, dk, dv)."""
    Q, K = q.shape[1], k.shape[1]
    qt, kt, vt, bias, bq, bk, interpret, scale = jfa._prep_block_inputs(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, 16, 16, True, None
    )
    o, lse = jfa._fwd(qt, kt, vt, bias, scale=scale, block_q=bq, block_k=bk,
                      causal=causal, interpret=interpret)
    dot = jfa._pad_to(jnp.transpose(jnp.asarray(do), (0, 2, 1, 3)), 2, bq)[0]
    dq, dk, dv = jfa._bwd(qt, kt, vt, bias, o, lse, dot, scale=scale,
                          block_q=bq, block_k=bk, causal=causal,
                          interpret=interpret)

    def public(x, n):
        return np.ascontiguousarray(np.transpose(np.asarray(x)[:, :, :n], (0, 2, 1, 3)))

    return (public(o, Q), np.array(lse[:, :, :Q, 0]),
            public(dq, Q), public(dk, K), public(dv, K))


@pytest.mark.parametrize("name", CASES)
def test_plain_backward_matches_jax_bwd(name):
    q, k, v, spec, causal = _case(name)
    jb, tb = _biases(spec)
    do = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    o, lse, jdq, jdk, jdv = _jax_fwd_bwd(q, k, v, jb, do, causal)
    dq, dk, dv = tfa.flash_attention_backward_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), tb,
        torch.from_numpy(o), torch.from_numpy(lse), torch.from_numpy(do), causal,
    )
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), want, atol=_atol(name), rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_function_gradients_match_jax_grad(name):
    q, k, v, spec, causal = _case(name)
    jb, tb = _biases(spec)
    w = np.random.default_rng(11).normal(size=q.shape).astype(np.float32)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, jb, causal=causal, block_q=16,
                                block_k=16, interpret=True)
        return (o * jnp.asarray(w)).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.dot_product_attention(tq, tk, tv, tb, causal=causal)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_atol(name), rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_function_gradients_match_autograd_of_the_plain_forward(name):
    """The recomputation backward equals autograd through the plain
    forward (f32; only summation order differs)."""
    q, k, v, spec, causal = _case(name)
    _, tb = _biases(spec)
    w = torch.from_numpy(np.random.default_rng(5).normal(size=q.shape).astype(np.float32))
    grads = []
    for fn in (tfa.flash_attention, tfa.flash_attention_reference):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*xs, tb, causal) * w).sum().backward()
        grads.append([x.grad for x in xs])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


#: left-padded causal cases (B, T, H, D, pads per batch row): the first rows
#: of each padded sequence see no live key; at T = 100 the forward's key
#: tiles (64 keys) no longer cover every key
LEFT_PAD_CASES = {"short": (2, 9, 2, 16, (3, 0)), "long": (2, 100, 2, 32, (70, 5))}


def _left_pad_case(name):
    B, T, H, D, pads = LEFT_PAD_CASES[name]
    rng = np.random.default_rng(17)
    q, k, v, w = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4))
    mask = (np.arange(T)[None] >= np.asarray(pads)[:, None]).astype(np.int32)
    return q, k, v, w, mask


@pytest.mark.parametrize("name", list(LEFT_PAD_CASES))
def test_rows_with_no_live_key_get_the_derivative_of_their_forward(name):
    """On PPO's left padding a row whose visible keys are all padding
    averages every key at the mask's value. Its LSE rounds to the row's max
    at NEG_INF's magnitude, so exp(S - LSE) sums to the number of keys, not
    1: the ``Function`` scales dO's row by K1's ``p_scale`` and its gradient
    equals autograd through the plain forward, and ``jax.grad`` of the JAX
    package's XLA attention (its CPU path) on the same loss."""
    q, k, v, w, mask = _left_pad_case(name)
    tb = tattn.padding_bias(torch.from_numpy(mask))
    grads = []
    for fn in (tfa.flash_attention, tfa.flash_attention_reference):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*xs, tb, True) * torch.from_numpy(w)).sum().backward()
        grads.append([x.grad for x in xs])

    def jloss(q, k, v):
        o = jattn.dot_product_attention(q, k, v, jattn.padding_bias(jnp.asarray(mask)),
                                        causal=True)
        return (o * jnp.asarray(w)).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    dead = (np.cumsum(mask, axis=1) == 0)  # [B, T]: rows with no live key
    assert dead.any()
    for got, plain, want in zip(*grads, jgrads):
        torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # the rows with no live key carry gradient (q's rows there are not 0)
    assert grads[0][0].numpy()[dead].std() > 0


def test_p_scale_is_one_on_live_rows_and_the_key_count_on_dead_ones():
    q, k, v, _, mask = _left_pad_case("short")
    _, lse, p_scale = tfa.flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)),
        tattn.padding_bias(torch.from_numpy(mask)), True, True, True)
    T = q.shape[1]
    dead = torch.from_numpy(np.cumsum(mask, axis=1) == 0)[:, None].expand_as(p_scale)
    assert (lse[dead] == tattn.NEG_INF).all()
    assert torch.equal(p_scale[~dead], torch.ones_like(p_scale[~dead]))
    # row i of the padded sequence (3 pads) averages keys 0..i and the
    # real keys after the pads: i + 1 + (T - 3) of them, each at NEG_INF
    rows = torch.arange(3, dtype=torch.float32)
    torch.testing.assert_close(p_scale[0, :, :3], (1 / (rows + 1 + T - 3)).expand(2, 3))
    do = torch.ones(q.shape, dtype=torch.bfloat16)
    assert torch.equal(tfa.scale_rows(do, torch.ones_like(p_scale)), do)


def test_bias_gets_no_gradient_and_a_learned_bias_is_refused():
    """A plain bias gets no gradient; a learned bias is refused under the
    causal flag (it carries T5's causal mask itself), and a bias that
    requires grad must be declared ``learned_bias``."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 16, 2, 16)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    bias = torch.from_numpy(rng.normal(size=(1, 1, 16, 16)).astype(np.float32))
    tfa.flash_attention(q, k, v, bias).sum().backward()
    assert bias.grad is None and q.grad is not None
    bias.requires_grad_()
    with pytest.raises(ValueError, match="causal=False"):
        tfa.flash_attention(q, k, v, bias, causal=True)
    with pytest.raises(ValueError, match="learned_bias=True"):
        tattn.dot_product_attention(q, k, v, bias)
    with torch.no_grad():  # without grad mode the bias is plain data
        tfa.flash_attention(q, k, v, bias, causal=True)
        tattn.dot_product_attention(q, k, v, bias)
    tattn.dot_product_attention(q, k, v, bias, learned_bias=True).sum().backward()
    assert bias.grad is not None and bias.grad.shape == bias.shape


# learned-bias cases: (B, Q, K, H, D, bias shape); T5's encoder and decoder
# self-attention biases are [B, H, Q, K] (the relative table plus padding),
# a lone table [1, H, Q, K]
DBIAS_CASES = {
    "full": (2, 21, 37, 4, 32, (2, 4, 21, 37)),
    "per_head": (2, 24, 40, 4, 32, (1, 4, 24, 40)),
    "per_row": (2, 17, 17, 4, 32, (2, 1, 17, 17)),
    "t5_decoder": (3, 9, 9, 4, 8, "rel+pad"),
    # the T5 stand-in's decoder self-attention (examples/pretrained_standin.py:
    # 4 heads of d_kv 16, 12 new tokens)
    "t5_standin_decoder": (2, 12, 12, 4, 16, "rel+pad"),
}


def _dbias_case(name):
    B, Q, K, H, D, spec = DBIAS_CASES[name]
    rng = np.random.default_rng(20 + list(DBIAS_CASES).index(name))
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for T in (Q, K, K))
    w = rng.normal(size=(B, Q, H, D)).astype(np.float32)
    if spec == "rel+pad":
        # a relative table, T5's causal mask and a padding bias, summed as
        # models/t5.py sums them; the gradient is taken w.r.t. the table
        rel = rng.normal(size=(1, H, Q, K)).astype(np.float32)
        fixed = np.where(np.arange(K)[None] <= np.arange(Q)[:, None], 0.0, -1e9)[None, None]
        mask = np.ones((B, K), np.int32)
        mask[1, 6:] = 0
        fixed = (fixed + np.where(mask[:, None, None, :] > 0, 0.0, -1e9)).astype(np.float32)
        return q, k, v, w, rel, fixed
    return q, k, v, w, rng.normal(size=spec).astype(np.float32), np.float32(0)


@pytest.mark.parametrize("name", list(DBIAS_CASES))
def test_plain_dbias_matches_jax_grad_of_the_learned_bias(name):
    q, k, v, w, table, fixed = _dbias_case(name)

    def jloss(b):
        o = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        b + jnp.asarray(fixed), learned_bias=True)
        return (o * jnp.asarray(w)).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    bias = torch.from_numpy(table) + torch.from_numpy(np.asarray(fixed))
    o, lse = tfa.flash_attention_reference(tq, tk, tv, bias, return_lse=True)
    *_, dbias = tfa.flash_attention_backward_reference(
        tq, tk, tv, bias, o, lse, torch.from_numpy(w), with_dbias=True)
    got = tfa.sum_to_shape(dbias, table.shape)
    assert got.shape == table.shape and float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("name", list(DBIAS_CASES))
def test_function_dbias_matches_autograd_of_the_plain_forward(name):
    q, k, v, w, table, fixed = _dbias_case(name)
    grads = []
    for fn in (tfa.flash_attention, tfa.flash_attention_reference):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, table)]
        bias = xs[3] + torch.from_numpy(np.asarray(fixed))
        (fn(*xs[:3], bias) * torch.from_numpy(w)).sum().backward()
        grads.append([x.grad for x in xs])
    for got, want in zip(*grads):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_sum_to_shape_sums_the_broadcast_dims():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    assert torch.equal(tfa.sum_to_shape(x, (2, 3, 4, 5)), x)
    assert torch.equal(tfa.sum_to_shape(x, (1, 3, 4, 5)), x.sum(0, keepdim=True))
    assert torch.equal(tfa.sum_to_shape(x, (2, 1, 1, 5)), x.sum((1, 2), keepdim=True))
    assert torch.equal(tfa.sum_to_shape(x, (4, 5)), x.sum((0, 1)))


def test_visited_keys_follow_the_forward_tiles():
    # Q <= 16: one 16-row tile, which visits only the first key tile
    vk = tfa.visited_keys(16, 130)
    assert vk[:, :64].all() and not vk[:, 64:].any()
    # Q > 16: 64-row tiles; row 63 ends tile 0, row 64 starts tile 1
    vk = tfa.visited_keys(112, 112)
    assert vk[63, :64].all() and not vk[63, 64:].any()
    assert vk[64].all() and vk[111].all()
