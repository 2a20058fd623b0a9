"""The port's ILQL math, storage and offline orchestrator against the JAX
package's, on the same numpy-seeded inputs (CPU, f32).

Held, with their tolerances:

- ``ilql_loss``: the loss and every stat, and its gradients with respect
  to the logits, the Q values and the state values, with padded actions,
  one and two Q heads: 1e-5 relative (plus 1e-7 absolute for gradient
  entries that are zero in exact arithmetic); the frameworks sum in
  another order;
- ``polyak_update``: bit for bit;
- ``build_ilql_batch`` (truncation fold included) and ``make_experience``
  over its three sample forms: integer fields exactly, rewards to 1e-7;
- ``epoch_order``: identical.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.ilql_types import ILQLBatch as JBatch
from trlx_tpu.ops import ilql_math as jm
from trlx_tpu.orchestrator.offline_orchestrator import OfflineOrchestrator as JOrch
from trlx_tpu.pipeline.ilql_storage import ILQLRolloutStorage as JStore
from trlx_tpu.pipeline.ilql_storage import build_ilql_batch as jbuild
from trlx_tpu_torch.data.ilql_types import ILQLBatch as TBatch
from trlx_tpu_torch.data.method_configs import ILQLConfig as TConfig
from trlx_tpu_torch.ops import ilql_math as tm
from trlx_tpu_torch.orchestrator.offline_orchestrator import OfflineOrchestrator as TOrch
from trlx_tpu_torch.pipeline.ilql_storage import ILQLRolloutStorage as TStore
from trlx_tpu_torch.pipeline.ilql_storage import build_ilql_batch as tbuild

FIELDS = ("input_ids", "attention_mask", "rewards", "states_ixs", "actions_ixs", "dones",
          "actions_mask")
INT_FIELDS = tuple(f for f in FIELDS if f != "rewards")


def _samples(seed, n=12, V=30, T=10):
    """(token_lists, action_starts, per-action rewards): lengths 2..T+3 so
    some are cut at T, starts 1..L-1."""
    rng = np.random.default_rng(seed)
    toks, starts, rewards = [], [], []
    for _ in range(n):
        L = int(rng.integers(2, T + 4))
        toks.append([int(x) for x in rng.integers(0, V, L)])
        starts.append(int(rng.integers(1, L)))
        rewards.append([float(r) for r in rng.normal(size=L - starts[-1])])
    return toks, starts, rewards


def _assert_batches_equal(t, j):
    for name in FIELDS:
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        if name in INT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-7, err_msg=name)


def test_build_ilql_batch_matches_jax_with_the_truncation_fold():
    toks, starts, rewards = _samples(0)
    t = tbuild(toks, starts, rewards, pad_token_id=29, max_length=10)
    j = jbuild(toks, starts, rewards, pad_token_id=29, max_length=10)
    _assert_batches_equal(t, j)
    # a cut sample keeps its return: the cut actions' rewards fold onto its last
    cut = [i for i, x in enumerate(toks) if len(x) > 10 and len(x) - starts[i] > 1]
    assert cut
    for i in cut:
        assert np.isclose(t.rewards[i].sum().item(), sum(rewards[i]), atol=1e-5)


def _loss_inputs(seed, two_qs):
    rng = np.random.default_rng(seed)
    toks, starts, per_action = _samples(seed, n=6, V=16, T=9)
    j = jbuild(toks, starts, per_action, pad_token_id=15, max_length=9)
    B, T = np.asarray(j.input_ids).shape
    A, V = np.asarray(j.actions_ixs).shape[1], 16
    assert np.asarray(j.actions_mask).min() == 0  # padded actions are present
    n_q = 2 if two_qs else 1
    arrays = {
        "logits": rng.normal(size=(B, T, V)).astype(np.float32),
        "qs": [rng.normal(size=(B, A, V)).astype(np.float32) for _ in range(n_q)],
        "target_qs": [rng.normal(size=(B, A, V)).astype(np.float32) for _ in range(n_q)],
        "vs": rng.normal(size=(B, A + 1)).astype(np.float32),
    }
    return j, arrays


@pytest.mark.parametrize("two_qs", [True, False], ids=["two_qs", "one_q"])
def test_ilql_loss_stats_and_gradients_match_jax(two_qs):
    jbatch, x = _loss_inputs(1, two_qs)
    kw = dict(tau=0.7, gamma=0.9, cql_scale=0.1, awac_scale=1.0, two_qs=two_qs)

    def jloss(logits, qs, vs):
        return jm.ilql_loss(logits, tuple(qs), tuple(map(jnp.asarray, x["target_qs"])), vs,
                            jbatch, jm.ILQLConfig(**kw))

    (jl, jstats), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x["logits"]), [jnp.asarray(q) for q in x["qs"]], jnp.asarray(x["vs"]))

    tbatch = TBatch(**{f: torch.from_numpy(np.array(getattr(jbatch, f))) for f in FIELDS})
    logits = torch.from_numpy(x["logits"]).requires_grad_()
    qs = [torch.from_numpy(q).requires_grad_() for q in x["qs"]]
    vs = torch.from_numpy(x["vs"]).requires_grad_()
    tl, tstats = tm.ilql_loss(logits, qs, [torch.from_numpy(q) for q in x["target_qs"]], vs,
                              tbatch, TConfig(**kw))
    tl.backward()

    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert set(tstats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(tstats[k].item(), float(jstats[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for got, want in zip([logits.grad, *[q.grad for q in qs], vs.grad],
                         [jgrads[0], *jgrads[1], jgrads[2]]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_ilql_health_is_refused():
    """``health=True``, refused until run-health monitoring was ported, now
    adds the three health stats and leaves the loss and every other stat
    the same bits (their values against the JAX package's are
    ``tests/test_torch_health.py``)."""
    jbatch, x = _loss_inputs(2, True)
    tbatch = TBatch(**{f: torch.from_numpy(np.array(getattr(jbatch, f))) for f in FIELDS})
    args = (torch.from_numpy(x["logits"]), [torch.from_numpy(q) for q in x["qs"]],
            [torch.from_numpy(q) for q in x["target_qs"]], torch.from_numpy(x["vs"]), tbatch,
            TConfig())
    off_loss, off = tm.ilql_loss(*args)
    on_loss, on = tm.ilql_loss(*args, health=True)
    assert torch.equal(on_loss, off_loss)
    assert set(on) - set(off) == {"health/entropy", "health/q_max", "health/td_error_mean"}
    assert all(torch.equal(on[k], v) for k, v in off.items())


def test_polyak_update_is_bit_exact():
    rng = np.random.default_rng(3)
    params = [rng.normal(size=s).astype(np.float32) for s in ((7, 5), (5,), (3, 4, 2))]
    target = [rng.normal(size=p.shape).astype(np.float32) for p in params]
    for alpha in (0.005, 0.5, 0.1):
        want = jm.polyak_update([jnp.asarray(p) for p in params],
                                [jnp.asarray(t) for t in target], alpha)
        got = [torch.from_numpy(t.copy()) for t in target]
        tm.polyak_update([torch.from_numpy(p) for p in params], got, alpha)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_batch_gather_matches_take_along_axis():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    idx = rng.integers(0, 7, size=(3, 4))
    np.testing.assert_array_equal(
        tm.batch_gather(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
        np.asarray(jm.batch_gather(jnp.asarray(x), jnp.asarray(idx))))


class _Tokenizer:
    """Characters as ids (a..z -> 1..26), pad 0."""

    pad_token_id = 0

    def encode(self, text):
        return [ord(c) - 96 for c in text if c.isalpha()]


def _trainer(seq_length):
    return SimpleNamespace(tokenizer=_Tokenizer(), device=torch.device("cpu"),
                           config=SimpleNamespace(train=SimpleNamespace(seq_length=seq_length)),
                           store=None)


SAMPLE_FORMS = {
    "strings": ["abcde", "hello world", "xy", "the quick brown fox"],
    "split_strings": ["abc|defg", "hi|there", "nosplit", "q|rstuvwxyzabcd"],
    "pairs": [("abc", "defg"), ("hello", "x"), ("", "abc"), ("abcdefgh", "ijklmnop")],
    "token_lists": [([5, 6, 7, 8, 9], 2), ([1, 2], 1), ([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13], 4),
                    ([9, 9, 9], 5)],
}


@pytest.mark.parametrize("form", list(SAMPLE_FORMS))
def test_make_experience_matches_jax(form):
    samples = SAMPLE_FORMS[form]
    rewards = [0.5, -1.0, 2.0, 0.25]
    split = "|" if form == "split_strings" else None
    tt, jt = _trainer(10), _trainer(10)
    TOrch(tt, split_token=split).make_experience(samples, rewards)
    JOrch(jt, split_token=split).make_experience(samples, rewards)
    assert len(tt.store) == len(jt.store) == 4
    _assert_batches_equal(tt.store.batch, jt.store.batch)


def test_epoch_order_and_stacked_slices_match_jax():
    toks, starts, rewards = _samples(5, n=37)
    tstore = TStore(tbuild(toks, starts, rewards, max_length=10))
    jstore = JStore(jbuild(toks, starts, rewards, max_length=10))
    for seed in (0, 1000, 1001):
        order = tstore.epoch_order(8, shuffle=True, seed=seed)
        np.testing.assert_array_equal(order, jstore.epoch_order(8, shuffle=True, seed=seed))
        assert order.shape == (4, 8)
        _assert_batches_equal(tstore.stacked_slice(order[1:3]),
                              jstore.stacked_slice(order[1:3]))
    np.testing.assert_array_equal(tstore.epoch_order(8, shuffle=False),
                                  jstore.epoch_order(8, shuffle=False))
    loaded = list(tstore.create_loader(8, seed=3))
    assert len(loaded) == 4 and all(len(mb) == 8 for mb in loaded)
