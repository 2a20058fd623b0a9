"""The slice as a whole: one greedy PPO phase through ``learn()`` in both
packages, from the same parameters and prompts.

Both trainers run a tiny f32 GPT-2 + value head (the JAX one on the
suite's 8-device CPU mesh, the port on the CPU) through the path the
default config takes: fixed-batch greedy rollouts, the full-copy KL
reference, the reward, running reward scaling, KL shaping, one phase of
the streamed plan's updates (GAE + whitening, ``ppo_loss``, global-norm
clip, AdamW on a cosine schedule), then the end-of-run save and eval.
The port's parameters are loaded from the JAX trainer's initial ones.

Held, with their tolerances (f32 throughout; the frameworks sum in another
order):

- tokens and masks: exact (greedy decoding);
- behaviour logprobs, values, reference logprobs and shaped rewards:
  1e-5;
- per-update stats: 2e-4 relative-or-absolute — four sequential updates
  compound the summation-order differences of the forward and backward;
- final parameters: 1e-5 absolute, except the attention key biases. Their
  gradient is zero in exact arithmetic (the key bias adds one constant to
  a query row's logits, which softmax ignores), so in f32 it is rounding
  noise, and AdamW, which normalises each element, moves them by up to
  ``lr`` per update in a direction the noise decides on either side: they
  are held to twice the summed learning rate;
- the KL coefficient sequence and eval rewards: exact / 1e-6;
- a ``save``/``load`` round trip restores the state exactly;
- the span tree (per-name counts and parent names) and the metrics
  registry's names: equal.

One run of each trainer is shared by the module's tests.
"""

import numpy as np
import pytest
import torch

from _torch_ppo_phase import (
    assert_final_params_match,
    config,
    port_trainer,
    prompts,
    record,
    reward_fn,
    run_jax,
    registry_names,
    run_port,
    span_tree,
)


def _config(ckpt_dir):
    return config(ckpt_dir)


def _port_trainer(tmp_path, init=None):
    return port_trainer(_config(tmp_path / "port"), init)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("ppo_phase")
    jax_run = run_jax(_config(tmp_path / "jax"))
    port_run = run_port(_port_trainer(tmp_path, jax_run["init"]))
    return jax_run, port_run, tmp_path


def test_rollouts_are_token_exact(runs):
    jax_run, port_run, _ = runs
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(port_run["buffer"][key], jax_run["buffer"][key], err_msg=key)
    mask = port_run["buffer"]["response_mask"]
    assert mask[:, :2].all() and not mask.all()  # min_new_tokens holds; some rows end early
    # the prompt text the reward saw is the decoded query ids
    trainer = port_run["trainer"]
    buf = trainer.buffer.full
    texts = trainer.decode_queries(buf.query_tokens, buf.query_mask)
    assert set(texts) <= set(trainer.eval_pipeline.prompts_text)


def test_logprobs_values_ref_and_rewards_match(runs):
    jax_run, port_run, _ = runs
    for key in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(port_run["buffer"][key], jax_run["buffer"][key],
                                   atol=1e-5, rtol=0, err_msg=key)
    np.testing.assert_allclose(port_run["ref"], jax_run["ref"], atol=1e-5, rtol=0)


def test_per_update_stats_and_kl_schedule_match(runs):
    jax_run, port_run, _ = runs
    assert set(port_run["rows"]) == set(jax_run["rows"])
    for key, want in jax_run["rows"].items():
        got = port_run["rows"][key]
        assert got.shape == (4,), key
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4, err_msg=key)
    np.testing.assert_allclose(port_run["kl_seq"], jax_run["kl_seq"], rtol=1e-6)
    assert port_run["trainer"].kl_coef == pytest.approx(jax_run["kl_coef"], rel=1e-6)


def test_final_params_match(runs):
    jax_run, port_run, tmp_path = runs
    got = port_run["trainer"].model.state_dict()
    moved = assert_final_params_match(got, jax_run, _config(tmp_path))
    assert moved > 1e-4  # the phase did move the parameters


def test_eval_rewards_match(runs):
    jax_run, port_run, _ = runs
    assert len(port_run["eval"]) == len(jax_run["eval"]) == 2  # step 0 and the end
    for got, want in zip(port_run["eval"], jax_run["eval"]):
        for key in ("reward/mean", "reward/std"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7)


def test_span_tree_and_registry_names_match(runs):
    """The same spans, nested the same way, and the same registry names
    (no name of either package lacks a counterpart on this path)."""
    jax_run, port_run, _ = runs
    got, want = span_tree(port_run["tracer"]), span_tree(jax_run["tracer"])
    assert got == want
    assert got["phase/collect"]["count"] == got["phase/train"]["count"] == 1
    assert got["train/epoch1_dispatch"]["parents"] == {"collect/land": 2}
    assert port_run["tracer"].dropped == jax_run["tracer"].dropped == 0
    assert registry_names(port_run["metrics"]) == registry_names(jax_run["metrics"])
    gauges = port_run["metrics"].snapshot()["gauges"]
    drain = port_run["tracer"].spans("train/drain")[0].duration_ms
    assert gauges["exp/overlap_drain_ms"] == drain


def test_save_load_round_trip(runs):
    _, port_run, tmp_path = runs
    trainer = port_run["trainer"]
    fresh = _port_trainer(tmp_path)
    fresh.load(trainer.config.train.checkpoint_dir)
    for name, p in trainer.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[name], p, rtol=0, atol=0)
    assert fresh.step == trainer.step == 4
    assert fresh.kl_coef == trainer.kl_coef and fresh.mean_kl == trainer.mean_kl
    assert torch.equal(fresh.generator.get_state(), trainer.generator.get_state())
    assert fresh.orch.state_dict() == trainer.orch.state_dict()
    saved, loaded = trainer.opt.state_dict(), fresh.opt.state_dict()
    assert saved["count"] == loaded["count"] == 4
    for i, state in saved["adamw"]["state"].items():
        for key, value in state.items():
            torch.testing.assert_close(loaded["adamw"]["state"][i][key], value, rtol=0, atol=0)


def test_server_restores_the_trainer_checkpoint(runs):
    """``InferenceServer(checkpoint_dir=...)`` serves the saved policy: its
    state equals the checkpoint's ``"model"`` and its greedy tokens equal
    the trainer's fixed sampler's on the same prompts."""
    from trlx_tpu_torch.inference.server import InferenceServer
    from trlx_tpu_torch.utils.checkpoint import load_checkpoint

    _, port_run, tmp_path = runs
    trainer = port_run["trainer"]
    ckpt = trainer.config.train.checkpoint_dir
    server = InferenceServer(_config(tmp_path / "port"), checkpoint_dir=ckpt, device="cpu")
    saved = load_checkpoint(ckpt, device="cpu")["model"]
    for name, p in server.model.state_dict().items():
        torch.testing.assert_close(p, saved[name], rtol=0, atol=0)
    batch, meta = next(iter(trainer.eval_pipeline.create_loader(8, shuffle=False)))
    out = trainer.sample(batch.input_ids, batch.attention_mask)
    want = [row[: int(n)].tolist() for row, n in zip(out.tokens, out.response_mask.sum(1))]
    rows = [[int(t) for t, m in zip(ids, mask) if m]
            for ids, mask in zip(batch.input_ids.tolist(), batch.attention_mask.tolist())]
    assert [r["tokens"] for r in server.generate(rows)] == want
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        InferenceServer(_config(tmp_path / "port"), checkpoint_dir=str(tmp_path / "none"),
                        device="cpu")


def _schedule_trainer(tmp_path, **train):
    """A port-only trainer (3 phases of 16 rollouts, 2 epochs) whose
    passes are recorded: each as (the update order it ran, the buffer's
    minibatch-major order for that epoch's seed)."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline, get_trainer

    cfg = _config(tmp_path / "port")
    cfg["train"].update(train, epochs=3)
    config = TRLConfig.from_dict(cfg)
    trainer = get_trainer("PPOTrainer")(config, reward_fn=reward_fn, device="cpu")
    pipeline = get_pipeline("PromptPipeline")(prompts(), trainer.query_length)
    get_orchestrator("PPOOrchestrator")(trainer, pipeline, reward_fn=reward_fn, chunk_size=8)
    passes = []
    train_on = trainer._train_on

    def recording(order, *args):
        seed = config.train.seed + len(passes)
        passes.append((np.asarray(order).copy(),
                       trainer.buffer.minibatch_order(8, seed=seed, repeat=2)))
        return train_on(order, *args)

    trainer._train_on = recording
    return trainer, passes


def test_phase_overlap_false_takes_the_minibatch_major_order(tmp_path):
    trainer, passes = _schedule_trainer(tmp_path, phase_overlap=False, total_steps=8)
    trainer.learn()
    assert trainer.step == 8 and len(passes) == 2
    for got, minibatch_major in passes:
        np.testing.assert_array_equal(got, minibatch_major)
    assert (tmp_path / "port" / "8" / "state.pt").exists()


def test_a_total_steps_cutoff_inside_a_pass_runs_stepwise(tmp_path):
    # phase 0 is a whole streamed pass (4 updates); phase 1 falls back to the
    # minibatch-major order and is cut after one minibatch (2 updates): the
    # loop stops there, saves, evaluates
    trainer, passes = _schedule_trainer(tmp_path, total_steps=6)
    logged = []
    record(trainer, "_finish", logged)
    trainer.learn()
    assert trainer.step == 6 and len(passes) == 2 and len(logged) == 1
    assert passes[0][0].shape == (4, 8)  # the stream plan's epoch-major updates
    np.testing.assert_array_equal(passes[1][0], passes[1][1])
    assert (tmp_path / "port" / "6" / "state.pt").exists()
    assert trainer.phase_times[-1]["train_s"] > 0
