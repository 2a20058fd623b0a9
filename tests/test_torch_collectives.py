"""The port's collectives (``trlx_tpu_torch/parallel/collectives.py``) and
its multi-process smoke (``parallel/_mp_smoke.py``) on gloo ranks on the
CPU.

One module-scope spawn runs, at once, two ranks of
``tests/_torch_mesh_worker.py``'s statistics case (each rank's rows of a
[6, 5] batch with a mask, and three batches of scores through one
``RunningMoments``, over the data group of ``{dp: -1}``) and two ranks of
``python -m trlx_tpu_torch.parallel._mp_smoke --device cpu`` (the port's
counterpart of ``tests/test_multiprocess.py``, which is ``xfail`` for the
JAX package: one sharded PPO step on the ``tp = 2`` mesh).

Held:
- each rank's global ``whiten`` (and ``shift_mean=False``), ``masked_mean``
  and ``masked_var`` equal the JAX package's functions on the
  concatenated batch within 1e-6;
- the two ranks' ``RunningMoments`` equal the one-process update on the
  concatenated scores, float for float: the exact variance of the whole
  batch, which the JAX package's multi-host branch does not take
  (ROADMAP queue 3); its one-process update equals the port's;
- the row gather and the per-shard objects come back in shard order;
- the smoke's rank 0 prints ``mp_smoke ok: procs=2``;
- on one process the collectives are the plain functions, and the
  autograd ops are identities.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_mesh_worker as worker  # noqa: E402

from trlx_tpu_torch.parallel import collectives as C  # noqa: E402

ATOL = 1e-6


def batch():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32) * 3 + 1)
    mask = torch.from_numpy((rng.random((6, 5)) > 0.3).astype(np.float32))
    mask[0] = 0  # a fully masked row on rank 0
    scores = [rng.normal(size=n).astype(np.float32) * (i + 1) + i
              for i, n in enumerate((4, 8, 6))]
    return x, mask, scores


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    x, mask, scores = batch()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", WORLD_SIZE="2")
    smoke = [subprocess.Popen(
        [sys.executable, "-m", "trlx_tpu_torch.parallel._mp_smoke", "--device", "cpu",
         "--init-method", f"file://{tmp / 'smoke_store'}"],
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=ROOT) for r in range(2)]
    try:
        records = worker.spawn({2: [{"name": "stats", "kind": "stats", "x": x, "mask": mask,
                                     "scores": scores}]}, tmp)
        outs = [p.communicate(timeout=240)[0] for p in smoke]
    finally:
        for p in smoke:
            p.kill()
    return records["stats"], outs, [p.returncode for p in smoke], (x, mask, scores)


def test_global_statistics_equal_jax_on_the_whole_batch(ranks):
    import jax.numpy as jnp

    from trlx_tpu.parallel import collectives as J

    recs, _, _, (x, mask, _) = ranks
    xj, mj = jnp.asarray(x.numpy()), jnp.asarray(mask.numpy())
    want = {
        "whiten": np.asarray(J.whiten(xj, mj)),
        "whiten_keep_mean": np.asarray(J.whiten(xj, mj, shift_mean=False)),
        "mean": np.asarray(J.masked_mean(xj, mj)),
        "var": np.asarray(J.masked_var(xj, mj)),
        "mean_unmasked": np.asarray(J.masked_mean(xj)),
    }
    assert [r["rows"] for r in recs] == [(0, 3), (3, 6)]
    for key, w in want.items():
        if key.startswith("whiten"):
            got = torch.cat([r[key] for r in recs]).numpy()
        else:
            got = recs[0][key].numpy()
            assert torch.equal(recs[0][key], recs[1][key]), key
        np.testing.assert_allclose(got, w, atol=ATOL, rtol=0, err_msg=key)


def test_running_moments_take_the_whole_batch_variance(ranks):
    from trlx_tpu.parallel.collectives import RunningMoments as JaxMoments

    recs, _, _, (_, _, scores) = ranks
    one, jax_one = C.RunningMoments(), JaxMoments()
    for i, s in enumerate(scores):
        want = one.update(s)
        jax_want = jax_one.update(s)
        for rec in recs:
            batch, mean, std, var, count = rec["moments"][i]
            assert batch == want
            assert (mean, std, var, count) == (one.mean, one.std, one.var, one.count)
        np.testing.assert_allclose(want, jax_want, rtol=1e-12)
        np.testing.assert_allclose((one.mean, one.std, one.var),
                                   (jax_one.mean, jax_one.std, jax_one.var), rtol=1e-12)
    # the JAX package's multi-host branch would average the ranks' own
    # variances here: a different, smaller number on these halves
    halves = [s[:len(s) // 2] for s in scores[-1:]] + [s[len(s) // 2:] for s in scores[-1:]]
    within = np.mean([h.astype(np.float64).var() for h in halves])
    assert within < scores[-1].astype(np.float64).var()


def test_row_gather_and_shard_objects_come_in_shard_order(ranks):
    recs, _, _, (x, _, _) = ranks
    for rec in recs:
        assert torch.equal(rec["gathered"], x)
        assert rec["objects"] == [("rank", 0), ("rank", 1)]


def test_mp_smoke_runs_a_sharded_ppo_step_on_two_gloo_ranks(ranks):
    _, outs, rcs, _ = ranks
    assert rcs == [0, 0], "\n".join(outs)
    assert "mp_smoke ok: procs=2 mesh dp=1 fsdp=1 tp=2" in outs[0], outs[0]
    assert "mp_smoke ok" not in outs[1]


def test_one_process_collectives_are_the_plain_functions():
    x, mask, scores = batch()
    x.requires_grad_(True)
    for op in (C.copy_to_group, C.reduce_from_group):
        assert op(x, None) is x
    assert C.gather_from_group(x, None, -1) is x and C.scatter_to_group(x, None, 0) is x
    assert C.gather_param(x, None, 0) is x
    assert C.all_reduce(x, None) is x and C.all_gather(x, None) is x
    assert C.all_gather_object(3, None) == [3]
    from trlx_tpu_torch import utils

    assert utils.whiten is C.whiten and utils.RunningMoments is C.RunningMoments
    w = C.whiten(x.detach(), mask)
    mean = (x.detach() * mask).sum() / mask.sum()
    var = (((x.detach() - mean) ** 2) * mask).sum() / mask.sum()
    torch.testing.assert_close(w, (x.detach() - mean) * torch.rsqrt(var + 1e-8))
    assert C.flatten_dict({"a": {"b": 1, "c": {"d": 2}}, "e": 3}) == {"a/b": 1, "a/c/d": 2, "e": 3}
