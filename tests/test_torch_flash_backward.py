"""The port's flash-attention backward (its plain version and the autograd
``Function``, on the CPU) against the JAX package's Pallas backward in
interpret mode.

- ``flash_attention_backward_reference`` takes the JAX ``_fwd``'s own O and
  LSE and a random dO, and must give the dQ/dK/dV of the JAX ``_bwd`` run in
  interpret mode with 16-wide blocks, on the three gradient cases of
  ``tests/test_flash_attention.py::TestFlashBackward``.
- The port's ``FlashAttention`` gradients (through
  ``dot_product_attention``) must equal ``jax.grad`` of the JAX
  ``flash_attention(..., interpret=True)`` on the same loss.
- A bias that does not require grad gets no gradient. A learned bias (T5's
  relative position bias) does: the plain backward's dbias (dS, summed
  where the bias broadcasts) equals ``jax.grad`` of the reference's
  ``dot_product_attention(learned_bias=True)`` (XLA's einsum path) with
  respect to the bias within 1e-5 of the largest, and the ``Function``'s
  equals torch autograd through the plain forward. A learned bias under the
  causal flag, or a bias that requires grad without ``learned_bias``, is
  refused.

Inputs come from a numpy seed, in f32. Tolerance: atol 2e-5 on gradients
of O(1) magnitude — both sides compute in f32 and differ only in the order
of their sums (the JAX kernel sums per 16-wide tile, the plain version in
one einsum). The CUDA kernels are held against this plain version on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import attention as jattn
from trlx_tpu.ops import flash_attention as jfa
from trlx_tpu_torch.ops import attention as tattn
from trlx_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5


CASES = ["causal_padding", "unequal_causal", "per_head_bias"]


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
    raise KeyError(name)


def _biases(spec):
    if spec is None:
        return None, None
    if spec[0] == "raw":
        return jnp.asarray(spec[1]), torch.from_numpy(spec[1])
    mask = spec[1]
    return jattn.padding_bias(jnp.asarray(mask)), tattn.padding_bias(torch.from_numpy(mask))


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
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


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
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


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
