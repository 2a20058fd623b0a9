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

And the refusals: grouped sampling, seq2seq, ILQL, async RL and chunked
prefill under the continuous engine.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_ppo_phase import (
    assert_final_params_match,
    config,
    engine_noise,
    port_trainer,
    run_jax,
    run_port_sampled,
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


# ------------------------------ refusals ----------------------------- #


REFUSALS = {
    # (trainer, overrides, error, match)
    "grouped_sampling": ("PPOTrainer", {"method": {"group_size": 2}}, NotImplementedError,
                         "grouped"),
    "grpo": ("GRPOTrainer", {"method": {"name": "GRPOConfig", "group_size": 2,
                                        "vf_coef": 0.0}}, NotImplementedError, "grouped"),
    "async_rl": ("PPOTrainer", {"train": {"async_rl": {"enabled": True}}}, NotImplementedError,
                 "async_rl"),
    "prefill_chunk": ("PPOTrainer", {"train": {"rollout": dict(ENGINE, prefill_chunk=4)}},
                      NotImplementedError, "prefill_chunk"),
    "spec_decode": ("PPOTrainer", {"train": {"rollout": dict(
        ENGINE, spec_decode={"enabled": True})}}, NotImplementedError, "spec_decode"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(tmp_path, name):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    trainer, overrides, error, match = REFUSALS[name]
    cfg = engine_config(tmp_path)
    for section, values in overrides.items():
        cfg[section].update(values)
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
