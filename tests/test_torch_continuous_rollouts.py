"""Continuous-engine rollouts in the PPO trainer (``train.rollout.engine:
continuous``), held three ways on tiny f32 GPT-2 policies:

- the port's engine against the port's fixed sampler under per-row RNG
  (``rollout.per_row_rng``): 24 rows through 16 slots, so the queue
  overflows the pool and slots recycle with rotated block tables; each
  row's tokens, mask, logprobs and values bit for bit (the counterpart of
  ``tests/test_inference_engine.py::test_engine_matches_fixed_sampler_rows``,
  with its slot-lifecycle asserts);
- the port's engine against the JAX package's, both trainers' engines from
  the same parameters, the port's handed the JAX engine's per-row draws
  (``gumbel(fold_in(fold_in(phase_key, row), t))``): tokens and masks
  exact, logprobs and values at 1e-5;
- one whole sampled PPO phase through ``learn()`` in both packages, the
  port's sampler and engine handed the JAX run's draws
  (``tests/_torch_ppo_phase.py::inject_jax_noise``): rollouts in harvest
  order token-exact, logprobs, values and rewards at 1e-5, per-update
  stats at 2e-4, final parameters under ``assert_final_params_match``.

- the same sampled phase with chunked admission prefill and speculative
  decoding on in both packages' engines (``rollout.prefill_chunk``,
  ``rollout.spec_decode``): the same checks, and the chunk and verify
  counters of the collection equal.

Each feature on its own is accepted and runs a collection, and the engine
trainer builds with ``async_rl`` and ``async_checkpoint``. And the
refusals: grouped sampling, seq2seq and ILQL under the continuous engine,
``prefill_chunks_per_pump`` without chunking and ``spec_decode`` under the
fixed engine.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_ppo_phase import (
    N_PROMPTS,
    assert_final_params_match,
    config,
    engine_noise,
    port_trainer,
    registry_names,
    reward_fn,
    run_jax,
    run_port_sampled,
    span_tree,
)

ENGINE = {"engine": "continuous", "slots": 16, "admit_width": 8, "harvest_width": 8,
          "block_size": 4}
PHASE_ENGINE = dict(ENGINE, slots=8)  # 16 rollouts through 8 slots


def engine_config(ckpt_dir, rollout=ENGINE):
    cfg = config(ckpt_dir, train={"rollout": dict(rollout)})
    cfg["method"]["gen_kwargs"]["do_sample"] = True
    return cfg


def prompt_rows(n: int, q: int, seed: int):
    """[n, q] left-padded prompts of 4..q real ids, and their mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 36, size=(n, q)).astype(np.int32)
    lens = rng.integers(4, q + 1, size=n)
    mask = (np.arange(q)[None] >= q - lens[:, None]).astype(np.int32)
    return ids * mask, mask


def drive(engine, ids, mask, start_phase):
    """Submit every row, drive the phase to the end; per draw index, the
    harvested arrays; asserts each row is harvested once."""
    start_phase()
    engine.submit(ids, mask)
    got = {}
    for group in engine.drive(len(ids)):
        for j, r in enumerate(group["rows"]):
            assert r not in got, "row harvested twice"
            got[r] = {k: np.asarray(group[k])[j] for k in (
                "query_tokens", "tokens", "response_mask", "logprobs", "values")}
    assert sorted(got) == list(range(len(ids)))
    return got


@pytest.fixture(scope="module")
def port_pair(tmp_path_factory):
    """The port's continuous trainer and a fixed one under per-row RNG, on
    the same random weights (the same seed)."""
    tmp = tmp_path_factory.mktemp("continuous_pair")
    cont = port_trainer(engine_config(tmp / "cont"))
    fixed = port_trainer(engine_config(tmp / "fixed", {"engine": "fixed", "per_row_rng": True}))
    for a, b in zip(cont.model.state_dict().values(), fixed.model.state_dict().values()):
        assert torch.equal(a, b)
    return cont, fixed


def test_engine_matches_the_per_row_fixed_sampler_bit_for_bit(port_pair):
    cont, fixed = port_pair
    assert fixed.gen_config.per_row_rng and cont.gen_config.per_row_rng
    N, Q = 24, fixed.query_length
    ids, mask = prompt_rows(N, Q, seed=11)
    fixed.generator.manual_seed(42)
    fixed.reset_rollout_phase()
    outs = [fixed.sample(torch.from_numpy(ids[s:s + 8]), torch.from_numpy(mask[s:s + 8]))
            for s in range(0, N, 8)]
    want = {k: torch.cat([getattr(o, k) for o in outs]).numpy()
            for k in ("tokens", "response_mask", "logprobs", "values")}

    cont.generator.manual_seed(42)
    cont.reset_rollout_phase()
    engine = cont.rollout_engine_obj
    assert (engine.num_slots, engine.admit_width, engine.harvest_width) == (16, 8, 8)
    got = drive(engine, ids, mask, lambda: engine.start_phase(cont.rollout_phase_seed()))
    # the slot lifecycle: 24 rows through 16 slots overflowed the pool and
    # recycled slots; the phase drains and counts every row once
    st = engine.stats
    assert engine.pending == 0
    assert st.admitted == st.completed == st.recycles == N
    assert 0 < st.slot_util <= 1.0 and st.prefills == 3
    for r in range(N):
        np.testing.assert_array_equal(got[r]["query_tokens"], ids[r])
        for key in ("tokens", "response_mask", "logprobs", "values"):
            np.testing.assert_array_equal(got[r][key], want[key][r], err_msg=f"row {r} {key}")
    assert len({tuple(want["tokens"][r]) for r in range(N)}) == N  # the rows sampled


def test_per_row_sampling_is_admission_order_invariant(port_pair):
    """A row's tokens depend on its draw index, not its chunk: one 16-wide
    call and two 8-wide calls agree row by row."""
    _, fixed = port_pair
    ids, mask = prompt_rows(16, fixed.query_length, seed=5)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    fixed.generator.manual_seed(9)
    fixed.reset_rollout_phase()
    whole = fixed.sample(ids, mask).tokens
    fixed.generator.manual_seed(9)
    fixed.reset_rollout_phase()
    halves = torch.cat([fixed.sample(ids[s:s + 8], mask[s:s + 8]).tokens for s in (0, 8)])
    assert torch.equal(whole, halves)


@pytest.fixture(scope="module")
def jax_engine_pair(tmp_path_factory):
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.utils.loading import get_trainer

    from trlx_tpu_torch.models.convert import flax_to_torch

    tmp = tmp_path_factory.mktemp("continuous_jax")
    jt = get_trainer("PPOTrainer")(TRLConfig.from_dict(engine_config(tmp / "jax")))
    pt = port_trainer(engine_config(tmp / "port"))
    pt.model.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, jax.device_get(jt.state.params))))
    return jt, pt


def test_engine_matches_the_jax_engine_under_its_noise(jax_engine_pair):
    jt, pt = jax_engine_pair
    N, Q = 24, pt.query_length
    ids, mask = prompt_rows(N, Q, seed=13)
    key = jax.random.PRNGKey(42)
    jengine = jt.rollout_engine_obj
    want = drive(jengine, ids, mask, lambda: jengine.start_phase(jt.rollout_params(), key))
    engine = pt.rollout_engine_obj
    vocab = pt.model_config.vocab_size
    engine.noise_fn = lambda rows, steps: engine_noise(key, rows, steps, vocab)
    try:
        got = drive(engine, ids, mask, lambda: engine.start_phase(0))
    finally:
        engine.noise_fn = None
    counters = ("admitted", "completed", "recycles", "decode_steps")
    assert ({k: getattr(engine.stats, k) for k in counters}
            == {k: getattr(jengine.stats, k) for k in counters})
    for r in range(N):
        for key_ in ("query_tokens", "tokens", "response_mask"):
            np.testing.assert_array_equal(got[r][key_], want[r][key_], err_msg=f"row {r} {key_}")
        for key_ in ("logprobs", "values"):
            np.testing.assert_allclose(got[r][key_], want[r][key_], atol=1e-5, rtol=0,
                                       err_msg=f"row {r} {key_}")


# ------------------------- one learn() phase -------------------------- #


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("continuous_phase")
    jax_run = run_jax(engine_config(tmp / "jax", PHASE_ENGINE), sampled=True)
    cfg = engine_config(tmp / "port", PHASE_ENGINE)
    trainer = port_trainer(cfg, jax_run["init"])
    harvested, stats = [], []
    engine = trainer.rollout_engine_obj
    engine_drive, make_experience = engine.drive, trainer.orch.make_experience

    def recorded_drive(target):
        for group in engine_drive(target):
            harvested.extend(group["rows"])
            yield group

    def recorded_make_experience(*a, **kw):
        out = make_experience(*a, **kw)
        stats.append(out)
        return out

    engine.drive, trainer.orch.make_experience = recorded_drive, recorded_make_experience
    port_run = run_port_sampled(trainer, jax_run)
    return jax_run, dict(port_run, harvested=harvested, collect=stats), cfg


def test_phase_rollouts_land_in_harvest_order(runs):
    jax_run, port_run, _ = runs
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(port_run["buffer"][key], jax_run["buffer"][key], err_msg=key)
    # 16 draws, each harvested once; finish order is not draw order
    assert sorted(port_run["harvested"]) == list(range(16))
    assert port_run["harvested"] != list(range(16))
    (collect,) = port_run["collect"]
    assert collect["engine/admitted"] == collect["engine/completed"] == 16
    assert collect["engine/slot_recycles"] == 16 and collect["engine/prefills"] == 2
    assert 0 < collect["engine/slot_util"] <= 1
    assert port_run["trainer"].rollout_engine_obj.pending == 0


def test_phase_logprobs_values_and_rewards_match(runs):
    jax_run, port_run, _ = runs
    for key in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(port_run["buffer"][key], jax_run["buffer"][key],
                                   atol=1e-5, rtol=0, err_msg=key)


def test_phase_updates_and_final_params_match(runs):
    jax_run, port_run, cfg = runs
    assert set(port_run["rows"]) == set(jax_run["rows"])
    for key, want in jax_run["rows"].items():
        got = port_run["rows"][key]
        assert got.shape == (4,), key
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4, err_msg=key)
    noisy = port_run["noisy"]
    assert sum(int(m.sum()) for m in noisy.values()) < 1e-2 * sum(m.numel() for m in noisy.values())
    moved = assert_final_params_match(
        port_run["trainer"].model.state_dict(), jax_run, cfg, noisy)
    assert moved > 1e-4


def test_phase_span_tree_and_registry_names_match(runs):
    """On the engine: the same spans, nested the same way (the engine's
    ``collect/admit``, ``collect/prefill`` and ``collect/slot_recycle``
    inside ``phase/collect``), and the same registry names, ``engine/*``
    gauges included."""
    jax_run, port_run, _ = runs
    got, want = span_tree(port_run["tracer"]), span_tree(jax_run["tracer"])
    assert got == want
    for name in ("collect/admit", "collect/prefill", "collect/slot_recycle"):
        assert got[name]["parents"] == {"phase/collect": got[name]["count"]}, name
    assert port_run["tracer"].dropped == jax_run["tracer"].dropped == 0
    names = registry_names(port_run["metrics"])
    assert names == registry_names(jax_run["metrics"])
    assert "engine/slot_util" in names["gauges"]


# ------------- one learn() phase with chunking and spec decode ------------- #

FEATURE_ENGINE = dict(PHASE_ENGINE, prefill_chunk=3,
                      spec_decode={"enabled": True, "max_draft": 3, "drafter": "ngram"})
ENGINE_COUNTERS = ("admitted", "completed", "prefills", "prefill_chunks",
                   "prefill_cols_skipped", "decode_steps", "spec_steps", "spec_drafted",
                   "spec_accepted")


@pytest.fixture(scope="module")
def feature_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("continuous_features")
    # prompts that repeat a pair of tokens: the n-gram drafter proposes
    # from the first step on
    rng = np.random.default_rng(4)
    data = ([[int(t) for t in list(rng.integers(0, 36, 2)) * 3][:int(n)]
             for n in rng.integers(3, 7, N_PROMPTS)], reward_fn, None)
    jax_run = run_jax(engine_config(tmp / "jax", FEATURE_ENGINE), data=data, sampled=True)
    cfg = engine_config(tmp / "port", FEATURE_ENGINE)
    port_run = run_port_sampled(port_trainer(cfg, jax_run["init"], data=data), jax_run)
    # one collection a phase: the engines' counters are that collection's
    counters = [{k: getattr(run["trainer"].rollout_engine_obj.stats, k) for k in ENGINE_COUNTERS}
                for run in (port_run, jax_run)]
    return jax_run, dict(port_run, counters=counters), cfg


def test_feature_phase_rollouts_match(feature_runs):
    jax_run, port_run, _ = feature_runs
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(port_run["buffer"][key], jax_run["buffer"][key], err_msg=key)
    for key in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(port_run["buffer"][key], jax_run["buffer"][key],
                                   atol=1e-5, rtol=0, err_msg=key)
    got, want = port_run["counters"]
    assert got == want
    engine = port_run["trainer"].rollout_engine_obj
    assert engine.prefill_chunk == 3 and engine.spec_max_draft == 3
    assert got["prefill_chunks"] > 0 and got["spec_steps"] > 0 and got["completed"] == 16


def test_feature_phase_updates_and_final_params_match(feature_runs):
    jax_run, port_run, cfg = feature_runs
    for key, want in jax_run["rows"].items():
        np.testing.assert_allclose(port_run["rows"][key], np.asarray(want), atol=2e-4,
                                   rtol=2e-4, err_msg=key)
    noisy = port_run["noisy"]
    assert sum(int(m.sum()) for m in noisy.values()) < 1e-2 * sum(m.numel() for m in noisy.values())
    assert assert_final_params_match(
        port_run["trainer"].model.state_dict(), jax_run, cfg, noisy) > 1e-4


@pytest.mark.parametrize("feature", ["prefill_chunk", "spec_decode"])
def test_engine_features_are_accepted_and_run(tmp_path, feature):
    """Each feature on its own builds the trainer's engine with it and runs
    a collection of the phase's 16 rollouts."""
    rollout = dict(ENGINE, prefill_chunk=3) if feature == "prefill_chunk" else dict(
        ENGINE, spec_decode={"enabled": True})
    trainer = port_trainer(engine_config(tmp_path, rollout))
    stats = trainer.orch.make_experience(16, 0)
    engine = trainer.rollout_engine_obj
    assert stats["engine/completed"] == 16 and len(trainer.buffer) == 16
    if feature == "prefill_chunk":
        assert engine.prefill_chunk == 3 and stats["engine/prefill_chunks"] > 0
    else:
        assert engine.spec_max_draft == 4 and engine.spec_drafter is not None


# ------------------------------ refusals ----------------------------- #


REFUSALS = {
    # (trainer, overrides, error, match)
    "grouped_sampling": ("PPOTrainer", {"method": {"group_size": 2}}, NotImplementedError,
                         "grouped"),
    "grpo": ("GRPOTrainer", {"method": {"name": "GRPOConfig", "group_size": 2,
                                        "vf_coef": 0.0}}, NotImplementedError, "grouped"),
    # refused until the asynchronous actor-learner (ROADMAP item 17) and the
    # asynchronous checkpoint write (item 8) landed: error None, the engine
    # trainer builds with them
    "async_rl": ("PPOTrainer", {"train": {"async_rl": {"enabled": True}}}, None, None),
    "async_checkpoint": ("PPOTrainer", {"train": {"async_checkpoint": True}}, None, None),
    # refused until the span tracer (ROADMAP item 19's core) landed
    "telemetry": ("PPOTrainer", {"train": {"telemetry": {"ring_size": 1024}}}, None, None),
    # the reference's own refusals: a chunk budget needs chunking, and the
    # fixed sampler has no verify step
    "prefill_chunk": ("PPOTrainer", {"train": {"rollout": dict(
        ENGINE, prefill_chunks_per_pump=2)}}, ValueError, "prefill_chunk"),
    "spec_decode": ("PPOTrainer", {"train": {"rollout": {
        "engine": "fixed", "spec_decode": {"enabled": True}}}}, ValueError, "spec_decode"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(tmp_path, name):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    trainer, overrides, error, match = REFUSALS[name]
    cfg = engine_config(tmp_path)
    for section, values in overrides.items():
        cfg[section].update(values)
    if error is None:
        from trlx_tpu_torch import telemetry

        with telemetry.scoped_tracer() as tracer:
            built = get_trainer(trainer)(TRLConfig.from_dict(cfg), device="cpu")
        assert tracer._records.maxlen == (1024 if name == "telemetry" else
                                          telemetry.DEFAULT_RING_SIZE)
        assert built.rollout_engine == "continuous"
        for key, value in overrides["train"].items():
            assert built.config.train.training[key] == value, key
        assert built.async_config.enabled == (name == "async_rl")
        return
    with pytest.raises(error, match=match):
        get_trainer(trainer)(TRLConfig.from_dict(cfg), device="cpu")


def test_seq2seq_and_ilql_refuse_the_engine(tmp_path):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    t5 = {"model_type": "t5", "model_arch": {
        "vocab_size": 40, "d_model": 16, "d_kv": 4, "d_ff": 16, "num_layers": 1,
        "num_decoder_layers": 1, "num_heads": 4}}
    for name in ("Seq2SeqPPOTrainer", "Seq2SeqGRPOTrainer"):
        cfg = engine_config(tmp_path)
        cfg["model"] = dict(t5)
        if "GRPO" in name:
            cfg["method"].update(name="GRPOConfig", group_size=2, vf_coef=0.0)
        with pytest.raises(NotImplementedError, match="continuous"):
            get_trainer(name)(TRLConfig.from_dict(cfg), device="cpu")
    cfg = engine_config(tmp_path)
    cfg["method"] = {"name": "ILQLConfig"}
    with pytest.raises(NotImplementedError, match="no rollout engine"):
        get_trainer("ILQLTrainer")(TRLConfig.from_dict(cfg), device="cpu")
