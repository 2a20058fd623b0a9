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
- The bias gets no gradient, and a bias that requires grad is refused.

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
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 16, 2, 16)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    bias = torch.from_numpy(rng.normal(size=(1, 1, 16, 16)).astype(np.float32))
    tfa.flash_attention(q, k, v, bias).sum().backward()
    assert bias.grad is None and q.grad is not None
    with pytest.raises(NotImplementedError, match="item 10"):
        tfa.flash_attention(q, k, v, bias.requires_grad_())
    with torch.no_grad():  # without grad mode the bias is plain data
        tfa.flash_attention(q, k, v, bias)


def test_visited_keys_follow_the_forward_tiles():
    # Q <= 16: one 16-row tile, which visits only the first key tile
    vk = tfa.visited_keys(16, 130)
    assert vk[:, :64].all() and not vk[:, 64:].any()
    # Q > 16: 64-row tiles; row 63 ends tile 0, row 64 starts tile 1
    vk = tfa.visited_keys(112, 112)
    assert vk[63, :64].all() and not vk[63, 64:].any()
    assert vk[64].all() and vk[111].all()
