"""The port's asynchronous actor-learner PPO (``train.async_rl``) and its
streamed phase against the JAX package's (``tests/test_async_rl.py``).

The trainers are ``tests/test_async_rl.py``'s (``harness.tiny_config_dict``
sizes: a 2-block, 32-wide GPT-2 over a 32-token vocabulary; 16 rollouts in
draws of 8, minibatches of 8, 2 PPO epochs, sampled, health on) in f32, on
the continuous engine with 8 slots admitting and harvesting 4 rows at a
time, so that rows are in flight while the learner updates. The port's
trainer starts from the JAX trainer's initial parameters and its engine is
handed the JAX engine's per-row Gumbel noise (``_torch_ppo_phase.py``).

Held against one JAX trainer's two phases (module scope):

- at ``staleness_window: 1``: the weight-push count, the staleness and
  consumption-lag lists exactly equal, tokens and masks exact, logprobs,
  values and rewards at 1e-5, stats rows at 2e-4 and final parameters under
  ``assert_final_params_match`` (``tests/test_torch_ppo_trainer.py``'s
  tolerances);
- the plain overlapped phase (async off, the JAX ``_run_phase``): the same.

Port only: ``staleness_window: 0`` is bitwise the serial plan with no push
and no health event, also with rows left in flight at the forced drain; the
engine's push between a harvest and its refill, the drafts it drops and
``min_inflight_version``; the ``engine.admit`` fault under async gives one
``actor-dead`` event and an ``ActorDeadError`` (no fallback) and the
trainer runs again, while outside async it degrades to the fixed sampler
and begins the phase again; a reward-function error propagates as
itself.
Against the JAX module: ``AsyncRLConfig``'s parsing and messages,
``guard_allows``, the three refusals and ``failure_kind``.
"""

import os

import jax
import numpy as np
import pytest
import torch

os.environ.setdefault("WANDB_DISABLED", "1")

from _torch_ppo_phase import assert_final_params_match, engine_noise
from trlx_tpu.analysis import harness
from trlx_tpu.trainer import async_rl as jasync
from trlx_tpu_torch.models.convert import flax_to_torch
from trlx_tpu_torch.trainer import async_rl as tasync

DP_MESH = {"dp": -1, "fsdp": 1, "tp": 1}
ENGINE = {"engine": "continuous", "slots": 8, "admit_width": 4, "harvest_width": 4}
BUFFER_KEYS = ("query_tokens", "query_mask", "response_tokens", "response_mask",
               "logprobs", "values", "rewards")


def config_dict(async_rl=None, rollout=ENGINE, **method) -> dict:
    cfg = harness.tiny_config_dict("ppo", mesh=dict(DP_MESH))
    cfg["method"].update(num_rollouts=16, chunk_size=8, ppo_epochs=2, **method)
    cfg["train"].update(batch_size=8, dtype="float32", param_dtype="float32",
                        lr_init=1e-3, lr_target=1e-3, rollout=dict(rollout),
                        health={"enabled": True})
    cfg["method"]["gen_kwargs"]["min_new_tokens"] = 1
    if async_rl is not None:
        cfg["train"]["async_rl"] = dict(async_rl)
    return cfg


def reward(samples, queries, response_gt=None):
    return [float(len(s)) for s in samples]


def phase_prompts():
    rng = np.random.default_rng(3)
    return [[int(x) for x in rng.integers(1, 30, size=4)] for _ in range(64)]


# ------------------------------ the JAX runs ------------------------------ #


def _jax_phase(trainer, init_state, keys, num_rollouts=16):
    """``tests/test_async_rl.py::_run_phase``, also returning the phase's
    host state, its buffer and the engine's phase key."""
    from trlx_tpu.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu.pipeline.prompt_pipeline import PromptPipeline

    trainer.state = jax.device_put(init_state, trainer.state_shardings)
    trainer.rng = jax.random.PRNGKey(123)
    trainer.kl_coef = float(trainer.config.method.init_kl_coef)
    trainer.mean_kl = 0.0
    trainer.buffer.clear_history()
    pipe = PromptPipeline(phase_prompts(), trainer.config.train.seq_length)
    orch = PPOOrchestrator(trainer, pipe, reward_fn=reward, chunk_size=8)
    phase = trainer.begin_streamed_phase(seed=11, num_rollouts=num_rollouts)
    orch.make_experience(num_rollouts, 0)
    n_up, rows, kl_seq = trainer.finish_streamed_phase()
    orch.close()
    buf = jax.device_get(trainer.buffer.full)
    return {
        "phase": phase, "n_up": n_up, "rows": rows, "kl_seq": kl_seq, "key": keys[-1],
        "params": jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state.params)),
        "buffer": {k: np.asarray(getattr(buf, k)) for k in BUFFER_KEYS},
        "stats": dict(trainer._last_overlap_stats),
    }


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX trainer at ``staleness_window: 1``: its async phase, then
    (async switched off on the same trainer) its plain overlapped phase,
    each from the same initial state."""
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.trainer.ppo_trainer import PPOTrainer

    cfg = config_dict({"enabled": True, "staleness_window": 1})
    trainer = PPOTrainer(TRLConfig.from_dict(cfg), reward_fn=reward)
    init = jax.device_get(trainer.state)
    keys = []
    engine = trainer.rollout_engine_obj
    start_phase = engine.start_phase

    def recording(params, key, *a, **kw):
        keys.append(np.asarray(key))
        return start_phase(params, key, *a, **kw)

    engine.start_phase = recording
    runs = {"cfg": cfg,
            "init": jax.tree_util.tree_map(np.asarray, init.params)}
    runs["async"] = _jax_phase(trainer, init, keys)
    trainer.async_config = jasync.AsyncRLConfig()
    runs["overlap"] = _jax_phase(trainer, init, keys)
    return runs


# ------------------------------ the port runs ----------------------------- #


def port_trainer(cfg: dict, tmp_path, init=None, reward_fn=reward):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    cfg = dict(cfg, train=dict(cfg["train"], checkpoint_dir=str(tmp_path)))
    trainer = PPOTrainer(TRLConfig.from_dict(cfg), reward_fn=reward_fn, device="cpu")
    if init is not None:
        trainer.model.load_state_dict(flax_to_torch(init))
        trainer._setup_reference(trainer.model.transformer, trainer.model_config.n_layer)
    pipe = PromptPipeline(phase_prompts(), trainer.query_length)
    PPOOrchestrator(trainer, pipe, reward_fn=reward_fn, chunk_size=8)
    return trainer


def port_phase(trainer, overlap=None, phase_key=None, num_rollouts=16):
    """One streamed phase through the phase API; with ``phase_key`` the
    engine samples the JAX engine's noise of that phase."""
    engine = trainer.rollout_engine_obj
    if phase_key is not None:
        vocab = trainer.model_config.vocab_size
        engine.noise_fn = lambda rows, steps: engine_noise(phase_key, rows, steps, vocab)
    phase = trainer.begin_streamed_phase(seed=11, num_rollouts=num_rollouts, overlap=overlap)
    try:
        trainer.orch.make_experience(num_rollouts, 0)
    finally:
        trainer.orch.close()
    n_up, rows, kl_seq = trainer.finish_streamed_phase()
    buf = trainer.buffer.full
    return {
        "phase": phase, "n_up": n_up, "rows": rows, "kl_seq": kl_seq,
        "params": {n: p.detach().clone() for n, p in trainer.model.state_dict().items()},
        "buffer": {k: getattr(buf, k).numpy() for k in BUFFER_KEYS},
        "stats": dict(trainer._last_overlap_stats),
    }


def assert_bitwise(a, b):
    assert a["n_up"] == b["n_up"] and a["kl_seq"] == b["kl_seq"]
    assert set(a["rows"]) == set(b["rows"])
    for key in a["rows"]:
        np.testing.assert_array_equal(a["rows"][key], b["rows"][key], err_msg=key)
    for name, p in a["params"].items():
        assert torch.equal(p, b["params"][name]), name


def assert_matches_jax(got, want, jax_runs):
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(got["buffer"][key], want["buffer"][key], err_msg=key)
    for key in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(got["buffer"][key], want["buffer"][key], atol=1e-5, rtol=0,
                                   err_msg=key)
    assert got["n_up"] == want["n_up"] == 4
    for key, v in want["rows"].items():
        np.testing.assert_allclose(got["rows"][key], np.asarray(v), atol=2e-4, rtol=2e-4,
                                   err_msg=key)
    np.testing.assert_allclose(got["kl_seq"], want["kl_seq"], rtol=1e-6)
    moved = assert_final_params_match(got["params"], {**want, "init": jax_runs["init"]},
                                      jax_runs["cfg"])
    assert moved > 0


@pytest.mark.parametrize("mode", ["async", "overlap"])
def test_the_phase_matches_the_jax_package(tmp_path, jax_runs, mode):
    want = jax_runs[mode]
    cfg = jax_runs["cfg"] if mode == "async" else config_dict()
    got = port_phase(port_trainer(cfg, tmp_path, jax_runs["init"]), phase_key=want["key"])
    assert_matches_jax(got, want, jax_runs)
    ours, theirs = got["phase"], want["phase"]
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.dispatched_during_collect == theirs.dispatched_during_collect
    assert got["stats"]["exp/overlap_streamed_updates"] == \
        want["stats"]["exp/overlap_streamed_updates"]
    if mode == "async":
        assert ours.weight_pushes == theirs.weight_pushes >= 1
        assert ours.staleness == theirs.staleness and max(ours.staleness) == 1
        assert ours.consumed_lag == theirs.consumed_lag
        assert ours.learner_version == theirs.learner_version == 2
        for key in ("async/weight_pushes", "async/staleness_max", "async/staleness_p50",
                    "async/consumed_lag_max", "async/consumed_lag_p50"):
            assert got["stats"][key] == want["stats"][key], key


# ------------------------------ port only -------------------------------- #


@pytest.mark.parametrize("num_rollouts", [16, 20])
def test_staleness0_is_the_serial_plan_bit_for_bit(tmp_path, num_rollouts):
    """``staleness_window: 0`` defers every update while rows are in
    flight: the phase equals the serial plan bit for bit, with no push and
    no health event. At 20 rollouts the harvest target is 20 but the draws
    of 8 submit 24: 4 rows are still in flight at the forced drain, where
    they neither count as staleness nor earn a push."""
    runs = {}
    for name, async_rl, overlap in (("async0", {"enabled": True, "staleness_window": 0}, None),
                                    ("serial", None, False)):
        trainer = port_trainer(config_dict(async_rl), tmp_path / name)
        runs[name] = port_phase(trainer, overlap=overlap, num_rollouts=num_rollouts)
        runs[name]["trainer"] = trainer
    a = runs["async0"]
    assert a["stats"]["async/weight_pushes"] == 0.0 and a["stats"]["async/staleness_max"] == 0.0
    assert a["trainer"].health_monitor.events == []
    assert a["trainer"].rollout_engine_obj.stats.weight_pushes == 0
    if num_rollouts == 20:
        assert a["trainer"].rollout_engine_obj.pending == 4
    assert_bitwise(a, runs["serial"])


def test_engine_push_between_harvest_and_refill(tmp_path):
    """A push staged between a harvest and its refill applies at the next
    safe point and drops no queued row: every row is harvested once, rows
    admitted after it carry the new version, and the engine's forwards run
    the pushed policy from then on."""
    from trlx_tpu_torch.utils import behaviour_snapshot

    trainer = port_trainer(config_dict(), tmp_path)
    engine = trainer.rollout_engine_obj
    assert engine.min_inflight_version() is None
    rng = np.random.default_rng(5)
    N = 24  # 24 rows through 8 slots: the queue backs up past the pool
    ids = rng.integers(1, 30, (N, trainer.query_length)).astype(np.int32)
    engine.start_phase(trainer.rollout_phase_seed())
    engine.submit(ids, np.ones_like(ids))
    assert engine.min_inflight_version() == 0
    pushed = behaviour_snapshot(trainer.model)
    seen, served = {}, []
    forward = engine._apply_fn

    def recorded(*a, params=None, **kw):
        served.append(params)
        return forward(*a, params=params, **kw)

    engine._apply_fn = recorded
    for group in engine.drive(N):
        if not seen:
            engine.push_weights(pushed, version=1)
            assert engine.param_version == 0  # staged, not applied
            assert engine.min_inflight_version() == 0  # busy rows at version 0
            n_before = len(served)
        for j, r in enumerate(group["rows"]):
            assert r not in seen, "row harvested twice"
            seen[r] = group["versions"][j]
    assert set(seen) == set(range(N)) and engine.pending == 0
    assert engine.stats.completed == N and engine.stats.weight_pushes == 1
    assert engine.param_version == 1 and set(seen.values()) == {0, 1}
    versions = [seen[r] for r in range(N)]
    assert versions == sorted(versions)  # admission-monotone in draw order
    assert all(p is None for p in served[:n_before]) and all(p is pushed for p in served[n_before:])
    # the drafts staged for the next verify step are dropped by a push
    engine._staged_drafts = (np.zeros((8, 2)), np.zeros(8))
    engine.push_weights(pushed)
    engine._apply_pending_push()
    assert engine._staged_drafts is None and engine.param_version == 2
    engine.drop_weights()
    assert engine._params is None


def test_engine_admit_fault_under_async_is_an_actor_dead(tmp_path):
    from trlx_tpu_torch.resilience import chaos

    trainer = port_trainer(config_dict({"enabled": True, "staleness_window": 1}), tmp_path)
    chaos.configure([{"site": "engine.admit", "mode": "error", "count": 1}])
    try:
        with pytest.raises(tasync.ActorDeadError, match="async actor died"):
            port_phase(trainer)
        trainer.abort_streamed_phase()
    finally:
        chaos.clear()
    assert trainer.rollout_engine == "continuous"  # not degraded
    assert trainer.health_monitor.event_counts == {"actor-dead": 1}
    assert trainer._behavior_model is None and trainer._stream is None
    run = port_phase(trainer)  # re-enterable
    assert run["n_up"] == 4 and all(np.isfinite(v).all() for v in run["rows"].values())


def test_a_reward_error_under_async_propagates_as_itself(tmp_path):
    def bad_reward(samples, queries, response_gt=None):
        raise TypeError("deterministic reward bug")

    trainer = port_trainer(config_dict({"enabled": True, "staleness_window": 1}), tmp_path,
                           reward_fn=bad_reward)
    with pytest.raises(TypeError, match="deterministic reward bug"):
        port_phase(trainer)
    trainer.abort_streamed_phase()
    assert trainer.rollout_engine == "continuous"
    assert not trainer.health_monitor.event_counts



def test_outside_async_an_engine_failure_begins_the_phase_again_on_the_fixed_sampler(
        tmp_path):
    """Without ``async_rl`` the same fault degrades: one ``engine-fallback``
    event, the open streamed phase aborted and begun again with its plan
    seed, and the phase collected and trained on the fixed sampler."""
    from trlx_tpu_torch.resilience import chaos

    trainer = port_trainer(config_dict(), tmp_path)
    trainer._phase_index = 0
    chaos.configure([{"site": "engine.admit", "mode": "error", "count": 1}])
    try:
        first = trainer.begin_streamed_phase(seed=11)
        trainer.orch.make_experience(16, 0)
    finally:
        chaos.clear()
    assert trainer.rollout_engine == "fixed" and trainer.health_monitor.event_counts == {
        "engine-fallback": 1}
    assert trainer._stream is not first and trainer._last_stream_seed == 11
    assert trainer._stream.next_mb == 2 and len(trainer.buffer) == 16
    n_up, rows, _ = trainer.finish_streamed_phase()
    assert n_up == 4 and all(np.isfinite(v).all() for v in rows.values())


# --------------------------- against the JAX module ----------------------- #

CONFIGS = {
    "full": {"enabled": True, "staleness_window": 2, "actor_fraction": 0.5},
    "none": None,
    "strings": {"staleness_window": "3", "actor_fraction": "0.25"},
    "unknown": {"staleness": 1},
    "negative_window": {"staleness_window": -1},
    "zero_fraction": {"actor_fraction": 0.0},
    "big_fraction": {"actor_fraction": 1.5},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_parses_and_refuses_as_jax(name):
    outcomes = []
    for module in (jasync, tasync):
        try:
            cfg = module.AsyncRLConfig.from_dict(CONFIGS[name])
            outcomes.append(("ok", cfg.enabled, cfg.staleness_window, cfg.actor_fraction))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]


def test_guard_allows_as_jax():
    for version in range(4):
        for inflight in (None, 0, 1, 2, 3):
            for window in range(3):
                assert tasync.guard_allows(version, inflight, window) == \
                    jasync.guard_allows(version, inflight, window)


REFUSALS = {
    "fixed_engine": ({"rollout": {"engine": "fixed"}}, ValueError, "continuous"),
    "overlap_off": ({"phase_overlap": False}, ValueError, "phase_overlap"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_as_jax(tmp_path, name):
    from trlx_tpu.data.configs import TRLConfig as JConfig
    from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPO
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    train, error, match = REFUSALS[name]
    cfg = config_dict({"enabled": True})
    cfg["train"].update(train, checkpoint_dir=str(tmp_path))
    messages = []
    for build in (lambda: JPPO(JConfig.from_dict(cfg), reward_fn=reward),
                  lambda: PPOTrainer(TRLConfig.from_dict(cfg), reward_fn=reward, device="cpu")):
        with pytest.raises(error, match=match) as info:
            build()
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_ilql_refuses_async_rl(tmp_path):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer

    cfg = harness.tiny_config_dict("ilql")
    cfg["train"].update(async_rl={"enabled": True}, checkpoint_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="async_rl") as info:
        ILQLTrainer(TRLConfig.from_dict(cfg), device="cpu")
    assert "train.async_rl is not supported by ILQLTrainer (offline trainer" in str(info.value)


def test_actor_dead_is_retriable_in_both_supervisors():
    from trlx_tpu.resilience import supervisor as jsup
    from trlx_tpu_torch.resilience import supervisor as tsup

    assert tsup.failure_kind(tasync.ActorDeadError("x")) == "retriable"
    assert jsup.failure_kind(jasync.ActorDeadError("x")) == "retriable"
    assert tsup.failure_kind(RuntimeError("x")) == jsup.failure_kind(RuntimeError("x"))
