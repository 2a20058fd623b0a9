"""The port's rotary embeddings (``trlx_tpu_torch/ops/rotary.py``) against
the JAX package's (``trlx_tpu/ops/rotary.py``): the angles, and both
conventions (GPT-J's interleaved pairs, GPT-NeoX's halves) at a partial and
a full rotary width, in f32 to 1e-6, and in bf16 bit for bit (sin and cos
are cast to x's dtype before the multiply in both)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import rotary as jrot
from trlx_tpu_torch.ops import rotary as trot

B, T, H, D = 2, 9, 3, 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pos = np.stack([np.arange(T), np.clip(np.arange(T) - 3, 0, None)]).astype(np.int32)
    x = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return pos, x


@pytest.mark.parametrize("rotary_dim", [8, D])
def test_angles_match_jax(rotary_dim):
    pos, _ = _inputs()
    jsin, jcos = jrot.rotary_angles(jnp.asarray(pos), rotary_dim)
    tsin, tcos = trot.rotary_angles(torch.from_numpy(pos), rotary_dim)
    assert tsin.dtype == torch.float32 and tsin.shape == (B, T, rotary_dim // 2)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rotary_dim", [8, D])
@pytest.mark.parametrize("convention", ["interleaved", "half"])
def test_rotation_matches_jax(convention, rotary_dim, dtype):
    pos, x = _inputs(1)
    jfn = getattr(jrot, f"apply_rotary_{convention}")
    tfn = getattr(trot, f"apply_rotary_{convention}")
    jsin, jcos = jrot.rotary_angles(jnp.asarray(pos), rotary_dim)
    tsin, tcos = trot.rotary_angles(torch.from_numpy(pos), rotary_dim)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jfn(jx, jsin, jcos, rotary_dim).astype(jnp.float32))
    got = tfn(tx, tsin, tcos, rotary_dim)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    else:
        # the same casts in the same order: the same bf16 values
        np.testing.assert_array_equal(got.float().numpy(), want)
    # the dims past rotary_dim pass through untouched
    np.testing.assert_array_equal(got[..., rotary_dim:].float().numpy(),
                                  tx[..., rotary_dim:].float().numpy())


def test_interleaved_rotates_pairs_and_half_rotates_halves():
    """At position p the first pair (GPT-J) or the dims 0 and D/2 (NeoX)
    turn by p radians (inv_freq[0] = 1)."""
    pos = torch.tensor([[0, 1, 2]])
    sin, cos = trot.rotary_angles(pos, 4)
    x = torch.zeros(1, 3, 1, 4)
    x[..., 0] = 1.0
    inter = trot.apply_rotary_interleaved(x, sin, cos, 4)
    half = trot.apply_rotary_half(x, sin, cos, 4)
    p = pos[0].float()
    torch.testing.assert_close(inter[0, :, 0, :2], torch.stack([p.cos(), p.sin()], -1))
    torch.testing.assert_close(half[0, :, 0, ::2], torch.stack([p.cos(), p.sin()], -1))
