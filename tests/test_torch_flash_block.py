"""The port's ring-attention block wrappers, ``flash_block_fwd`` and
``flash_block_bwd`` (their plain versions, on the CPU), against the JAX
package's Pallas ``flash_block_fwd`` and ``flash_block_bwd`` in interpret
mode with 16-wide tiles.

The shapes are ``tests/test_flash_attention.py::TestBlockHelpers``': B =
2, Tq = 24, Tk = 40, H = 2, D = 16, a bias that masks 15 % of the pairs
with -1e9; the backward against an outside logsumexp shifted by +0.3, as
if combined with another block. Beside them: head dim 64 (the ring's
GPT-2 width), a wholly masked block (every pair -1e9: the forward gives
the uniform average with lse ≈ -1e9 + log Tk, the backward against a
finite outside lse gives exactly zero gradients), and bf16 inputs to the
forward. The wholly masked block's forward is held against the JAX ring's
own block math (``trlx_tpu/ops/ring_attention.py::_block_fwd``, XLA): the
Pallas wrapper pads Tk to its 16-wide tiles and gives the padded keys the
same -1e9 as the masked ones, so it averages 48 keys of which 8 are zero
(the ring's combine weighs such a block by 0 either way).

Inputs come from a numpy seed. Tolerances: f32 outputs and lse 5e-6 and
f32 gradients 1e-5, tighter than the 2e-5 and 2e-4 the JAX test holds its
own block helpers to (both sides compute in f32 and differ in the order of
their sums, the JAX kernel per 16-wide tile, the plain version in one
einsum: up to 7e-7 and 1.2e-6 at head dim 64); bf16 outputs 1e-2 (the
JAX kernel rounds the unnormalised weights to bf16 before P.V, the plain
version the normalised ones: a bf16 ulp, 2^-8, of outputs below 1). The
lse of a wholly masked block sits at -1e9, where one f32 ulp is 64: it is
held to a relative 1e-7 there. The CUDA kernels are held against this plain
version on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import flash_attention as jfa
from trlx_tpu.ops import ring_attention as jra
from trlx_tpu_torch.ops import flash_attention as tfa

NEG_INF = -1e9
ATOL_FWD = 5e-6
ATOL_BWD = 1e-5
ATOL_FWD_BF16 = 1e-2
#: where the case's bias masks every pair, the lse's relative tolerance
RTOL_MASKED_LSE = 1e-7

CASES = {  # (D, bias kind)
    "base": (16, "random"),
    "head_dim_64": (64, "random"),
    "masked_block": (16, "all"),
}


def _inputs(D, kind, seed=0):
    rng = np.random.default_rng(seed)
    B, Tq, Tk, H = 2, 24, 40, 2
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for T in (Tq, Tk, Tk))
    masked = rng.random((B, 1, Tq, Tk)) < 0.15 if kind == "random" else np.ones((B, 1, Tq, Tk), bool)
    bias = np.where(masked, NEG_INF, 0.0).astype(np.float32)
    return q, k, v, bias, rng


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, jnp.float32).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_block_fwd_matches_jax(case, dtype):
    D, kind = CASES[case]
    q, k, v, bias, _ = _inputs(D, kind)
    jq, jk, jv = (_j(x, getattr(jnp, dtype)) for x in (q, k, v))
    if kind == "all":
        o_ref, lse_ref = jra._block_fwd(jq, jk, jv, _j(bias), D ** -0.5)
    else:
        o_ref, lse_ref = jfa.flash_block_fwd(jq, jk, jv, _j(bias), block_q=16, block_k=16,
                                             interpret=True)
    o, lse = tfa.flash_block_fwd(*(_t(x, getattr(torch, dtype)) for x in (q, k, v)), _t(bias))
    assert o.shape == o_ref.shape == (2, 2, 24, D) and o.dtype == getattr(torch, dtype)
    assert lse.shape == lse_ref.shape == (2, 2, 24) and lse.dtype == torch.float32
    atol = ATOL_FWD if dtype == "float32" else ATOL_FWD_BF16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_ref, np.float32), atol=atol)
    if kind == "all":
        # the uniform average over the block's keys, at lse ≈ NEG_INF + log Tk
        np.testing.assert_allclose(
            o.float().numpy(), np.broadcast_to(
                _t(v, getattr(torch, dtype)).float().mean(1).numpy()[:, :, None], o.shape),
            atol=atol)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=RTOL_MASKED_LSE)
        np.testing.assert_allclose(lse.numpy(), NEG_INF + np.log(40), rtol=RTOL_MASKED_LSE)
    else:
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL_FWD)


@pytest.mark.parametrize("case", list(CASES))
def test_block_bwd_matches_jax_with_outside_lse(case):
    """Against an outside lse: the random-bias block's own lse + 0.3 (as
    if combined with another block, so P sums to less than 1), and for the
    wholly masked block that same finite lse, which gives P = 0."""
    D, kind = CASES[case]
    q, k, v, bias, rng = _inputs(D, kind)
    _, _, _, live_bias, _ = _inputs(D, "random")
    o, lse = jfa.flash_block_fwd(*(_j(x) for x in (q, k, v, live_bias)),
                                 block_q=16, block_k=16, interpret=True)
    lse_ext = np.asarray(lse) + 0.3
    o = np.asarray(o)
    do = rng.normal(size=o.shape).astype(np.float32)
    want = jfa.flash_block_bwd(*(_j(x) for x in (q, k, v, bias, o, lse_ext, do)),
                               block_q=16, block_k=16, interpret=True)
    got = tfa.flash_block_bwd(*(_t(x) for x in (q, k, v, bias, o, lse_ext, do)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_BWD, err_msg=name)
        if kind == "all":
            assert not g.any(), f"{name}: a wholly masked block must give exactly 0"


def test_block_bwd_upcasts_bf16_inputs():
    """bf16 q, k, v, o, dO run the f32 backward on their upcast values,
    as the TPU wrapper does: the same gradients, in f32."""
    q, k, v, bias, rng = _inputs(64, "random")
    o, lse = tfa.flash_block_fwd(*(_t(x) for x in (q, k, v, bias)))
    do = torch.from_numpy(rng.normal(size=tuple(o.shape)).astype(np.float32))
    bf = [_t(x, torch.bfloat16) for x in (q, k, v)] + [o.to(torch.bfloat16), do.to(torch.bfloat16)]
    got = tfa.flash_block_bwd(*bf[:3], _t(bias), bf[3], lse + 0.3, bf[4])
    want = tfa.flash_block_bwd(*(x.float() for x in bf[:3]), _t(bias), bf[3].float(), lse + 0.3,
                               bf[4].float())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)
