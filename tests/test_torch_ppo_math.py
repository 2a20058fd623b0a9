"""The port's PPO math against :mod:`trlx_tpu.ops.ppo_math`: GAE with
whitening, ``ppo_loss`` (value and every stats key), the policy entropy,
and the KL controllers, plus the running reward moments and masked
whitening the orchestrator and GAE share.

Inputs come from a numpy seed, in f32 (masks with ragged response ends).
Tolerance: 1e-5 absolute (f32 sums in another order; the GAE recursion is
the same sequence of f32 operations); the KL controllers are host floats
and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import ppo_math as jpm
from trlx_tpu.parallel.collectives import RunningMoments as JRunningMoments
from trlx_tpu_torch.data.method_configs import PPOConfig as TPPOConfig
from trlx_tpu_torch.ops import ppo_math as tpm
from trlx_tpu_torch.utils import RunningMoments as TRunningMoments

ATOL = 1e-5
B, R, V = 5, 9, 13


def _batch(seed):
    rng = np.random.default_rng(seed)
    lengths = np.array([R, 1, 4, 7, R])
    mask = (np.arange(R)[None] < lengths[:, None]).astype(np.int32)

    def f(scale=1.0):
        return (rng.normal(size=(B, R)) * scale).astype(np.float32)

    return {
        "logprobs": f(0.5) - 2, "values": f(), "old_logprobs": f(0.5) - 2,
        "old_values": f(), "rewards": f(), "mask": mask,
        "logits": rng.normal(size=(B, R, V)).astype(np.float32) * 2,
    }


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.99, 0.9)])
def test_gae_and_whitening_match_jax(gamma, lam):
    b = _batch(0)
    ja, jr = jpm.get_advantages_and_returns(
        jnp.asarray(b["values"]), jnp.asarray(b["rewards"]), jnp.asarray(b["mask"]), gamma, lam
    )
    ta, tr = tpm.get_advantages_and_returns(
        _t(b["values"]), _t(b["rewards"]), _t(b["mask"]), gamma, lam
    )
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL, rtol=0)
    assert not ta.requires_grad


@pytest.mark.parametrize("ent_coef", [0.0, 0.01])
def test_ppo_loss_and_every_stat_match_jax(ent_coef):
    b = _batch(1)
    adv, ret = jpm.get_advantages_and_returns(
        jnp.asarray(b["values"]), jnp.asarray(b["rewards"]), jnp.asarray(b["mask"]), 1.0, 0.95
    )
    jent = jpm.policy_entropy(jnp.asarray(b["logits"]))
    tent = tpm.policy_entropy(_t(b["logits"]))
    np.testing.assert_allclose(tent.numpy(), np.asarray(jent), atol=ATOL, rtol=0)
    args = ("logprobs", "values", "old_logprobs", "old_values")
    jloss, jstats = jpm.ppo_loss(
        *(jnp.asarray(b[k]) for k in args), adv, ret, jnp.asarray(b["mask"]),
        0.2, 0.2, 1.0, ent_coef=ent_coef, entropy=jent,
    )
    tloss, tstats = tpm.ppo_loss(
        *(_t(b[k]) for k in args), _t(adv), _t(ret), _t(b["mask"]),
        0.2, 0.2, 1.0, ent_coef=ent_coef, entropy=tent,
    )
    assert set(tstats) == set(jstats)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=ATOL, rtol=0)
    for key in jstats:
        np.testing.assert_allclose(tstats[key].item(), float(jstats[key]), atol=ATOL, rtol=0,
                                   err_msg=key)


def test_ppo_loss_log_ratio_clamp_keeps_the_loss_finite():
    """A log-ratio far outside the clip band must not overflow exp."""
    b = _batch(2)
    lp = b["old_logprobs"] + 200.0
    args = (_t(lp), _t(b["values"]), _t(b["old_logprobs"]), _t(b["old_values"]),
            _t(b["rewards"]), _t(b["values"]), _t(b["mask"]))
    loss, stats = tpm.ppo_loss(*args, 0.2, 0.2, 1.0)
    jloss, _ = jpm.ppo_loss(*(jnp.asarray(np.asarray(a)) for a in args), 0.2, 0.2, 1.0)
    assert np.isfinite(loss.item()) and all(np.isfinite(v.item()) for v in stats.values())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)


@pytest.mark.parametrize("target", [6.0, None])
def test_kl_controllers_match_jax(target):
    jcfg = jpm.PPOConfig(target=target, horizon=500)
    tcfg = TPPOConfig(target=target, horizon=500)
    for kl_coef, kl in [(0.05, 0.3), (0.05, 40.0), (0.2, 6.0), (0.01, -1.0)]:
        assert tpm.kl_controller_update(tcfg, kl_coef, kl, 16) == \
            jpm.kl_controller_update(jcfg, kl_coef, kl, 16)
    assert tpm.adaptive_kl_update(0.1, 12.0, 8, 6.0, 100) == \
        jpm.adaptive_kl_update(0.1, 12.0, 8, 6.0, 100)


def test_running_moments_match_jax():
    rng = np.random.default_rng(4)
    jm, tm = JRunningMoments(), TRunningMoments()
    for n in (7, 1, 12):
        xs = rng.normal(size=n).astype(np.float32) * 3 + 1
        assert tm.update(xs) == jm.update(xs)
        assert (tm.mean, tm.std, tm.var, tm.count) == (jm.mean, jm.std, jm.var, jm.count)
