"""GRPO through both packages: ``group_whiten``, ``GRPOConfig``, grouped
sampling, PPO's ``scale_reward: "group"``, and one sampled GRPO phase
through ``learn()`` for the causal and the seq2seq trainer.

The phases sample (a greedy GRPO phase would give every rollout of a group
the same tokens, and every advantage 0): the port's sampler is handed the
Gumbel noise of the keys the JAX trainer's sampler drew
(``tests/_torch_ppo_phase.py::inject_jax_noise``). Both trainers run tiny
f32 models (the JAX one on the suite's 8-device CPU mesh, the port on the
CPU) from the same initial parameters.

Held, with their tolerances (those of ``tests/test_torch_ppo_trainer.py``;
the frameworks sum in another order):

- tokens and masks: exact; every group's query rows identical;
- behaviour logprobs and the stored advantages (the rewards slot): 1e-5;
- per-update stats: 2e-4 relative-or-absolute;
- final parameters: ``assert_final_params_match`` (1e-5 absolute), the
  rare elements whose gradient fell below 1e-6 in some update (rounding
  then decides Adam's normalised step there, as for the attention key
  biases) held to the key biases' bound;
- ``group_whiten``: 1e-6 on numpy (the same numpy ops), 1e-5 on tensors;
- the orchestrator's grouped scores: 1e-6.
"""

import numpy as np
import pytest
import torch

from _torch_ppo_phase import (
    assert_final_params_match,
    config,
    port_trainer,
    prompts,
    run_jax,
    run_port_sampled,
)

GROUP = 4
T5_ARCH = {
    "vocab_size": 40, "d_model": 32, "d_kv": 8, "d_ff": 48, "num_layers": 2,
    "num_decoder_layers": 2, "num_heads": 4, "relative_attention_num_buckets": 8,
    "relative_attention_max_distance": 16, "feed_forward_proj": "gated-gelu",
    "tie_word_embeddings": False,
}


def grpo(cfg: dict, trainer: str = "GRPOTrainer", **method) -> dict:
    """``cfg`` as a GRPO run: groups of 4, no value loss, no reward
    scaling, sampled."""
    cfg["train"]["trainer"] = trainer
    cfg["method"].update({"name": "GRPOConfig", "group_size": GROUP, "vf_coef": 0.0,
                          "scale_reward": None, **method})
    cfg["method"]["gen_kwargs"]["do_sample"] = True
    return cfg


def tie_free_reward(samples, queries, response_gt=None):
    """A score with no ties between responses that differ. With ties (a
    share of ids, say), two of a group's rollouts can score alike and a
    symmetric pair around them make their KL-free returns cancel: their
    advantages are then rounding noise, and the clip fraction counts their
    tokens by the noise's sign, which the two frameworks draw differently."""
    return [float(np.mean([np.sin(1.7 * int(t) + 0.3 * i) for i, t in enumerate(s.split())]))
            if s else 0.0 for s in samples]


def causal_data():
    return prompts(), tie_free_reward, None


def causal_config(ckpt_dir):
    """Two chunks of 2 prompts x 4 rollouts, two minibatches of 8, 2
    epochs: 4 updates."""
    return grpo(config(ckpt_dir))


def t5_config(ckpt_dir):
    return grpo({
        "model": {"model_type": "t5", "model_arch": dict(T5_ARCH)},
        "train": {
            "seq_length": 8, "batch_size": 8, "epochs": 1, "total_steps": 4,
            "lr_init": 1e-3, "lr_target": 2e-4, "eval_interval": 1000,
            "checkpoint_interval": 1000, "dtype": "float32", "seed": 3,
            "checkpoint_dir": str(ckpt_dir), "mesh": {"dp": -1, "fsdp": 1, "tp": 1},
        },
        "method": {
            "num_rollouts": 16, "chunk_size": 8, "ppo_epochs": 2, "init_kl_coef": 0.05,
            "target": 6.0, "horizon": 100, "cliprange_reward": 10.0,
            "gen_kwargs": {"max_new_tokens": 5, "min_length": 3, "eos_token_id": 1,
                           "pad_token_id": 0, "forced_bos_token_id": 9},
        },
    }, trainer="Seq2SeqGRPOTrainer")


def t5_data():
    rng = np.random.default_rng(4)
    return ([[int(x) for x in rng.integers(2, 40, int(rng.integers(1, 9)))] for _ in range(16)],
            tie_free_reward, None)


@pytest.fixture(scope="module", params=["causal", "seq2seq"])
def runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"grpo_{request.param}")
    make, data = ((causal_config, causal_data()) if request.param == "causal"
                  else (t5_config, t5_data()))
    jax_run = run_jax(make(tmp / "jax"), data, sampled=True)
    cfg = make(tmp / "port")
    port_run = run_port_sampled(port_trainer(cfg, jax_run["init"], data), jax_run)
    return jax_run, port_run, cfg


def test_grouped_rollouts_are_token_exact(runs):
    jax_run, port_run, _ = runs
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(port_run["buffer"][key], jax_run["buffer"][key], err_msg=key)
    q = port_run["buffer"]["query_tokens"].reshape(-1, GROUP, port_run["buffer"]["query_tokens"].shape[1])
    assert (q == q[:, :1]).all()  # each group is one prompt, contiguous
    assert len({tuple(g[0]) for g in q}) > 1
    # sampling reached the choice: a group's rollouts differ
    r = port_run["buffer"]["response_tokens"].reshape(q.shape[0], GROUP, -1)
    assert any(len({tuple(x) for x in g}) > 1 for g in r)


def test_logprobs_and_group_advantages_match(runs):
    jax_run, port_run, _ = runs
    for key in ("logprobs", "rewards"):
        np.testing.assert_allclose(port_run["buffer"][key], jax_run["buffer"][key],
                                   atol=1e-5, rtol=0, err_msg=key)
    adv, mask = port_run["buffer"]["rewards"], port_run["buffer"]["response_mask"]
    # one advantage per rollout, broadcast over its response, zero past it
    per_row = adv[:, 0]
    np.testing.assert_array_equal(adv, per_row[:, None] * mask)
    assert np.abs(per_row.reshape(-1, GROUP).mean(1)).max() < 1e-5
    assert np.abs(per_row).max() > 0.1


def test_per_update_stats_match(runs):
    jax_run, port_run, _ = runs
    assert set(port_run["rows"]) == set(jax_run["rows"])
    for key, want in jax_run["rows"].items():
        got = port_run["rows"][key]
        assert got.shape == (4,), key
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4, err_msg=key)


def test_final_params_match_and_value_head_untrained(runs):
    jax_run, port_run, cfg = runs
    trainer, noisy = port_run["trainer"], port_run["noisy"]
    # the elements excused as rounding-decided are rare (the key biases,
    # 2 x 32 in the GPT-2, among them)
    assert sum(int(m.sum()) for m in noisy.values()) < 1e-2 * sum(m.numel() for m in noisy.values())
    moved = assert_final_params_match(trainer.model.state_dict(), jax_run, cfg, noisy)
    assert moved > 1e-4
    # vf_coef 0: the value head's gradient is exactly zero (the last
    # update's is still held), so its first Adam moment stays 0
    heads = [p for n, p in trainer.model.named_parameters() if n.startswith("v_head.")]
    assert heads
    for p in heads:
        assert p.grad is not None and not p.grad.any()
        assert not trainer.opt.adamw.state[p]["exp_avg"].any()


# ------------------------------- math ------------------------------- #


def test_group_whiten_matches_jax():
    from trlx_tpu.ops.ppo_math import group_whiten as jgroup_whiten
    from trlx_tpu_torch.ops.ppo_math import group_whiten

    rng = np.random.default_rng(0)
    x = (rng.normal(size=24) * 3).astype(np.float32)
    x[8:12] = 2.5  # a group of equal values: std 0 gives 0
    want = np.asarray(jgroup_whiten(x, 4))
    got_np = group_whiten(x, 4)
    assert isinstance(got_np, np.ndarray) and got_np.dtype == np.float32
    np.testing.assert_allclose(got_np, want, atol=1e-6, rtol=0)
    got_t = group_whiten(torch.from_numpy(x), 4)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_allclose(got_t.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_t.numpy()[8:12], 0.0)
    # population std: a group of (a, b) whitens to (-1, 1) up to the 1e-6
    np.testing.assert_allclose(group_whiten(torch.tensor([1.0, 3.0]), 2).numpy(),
                               [-1.0, 1.0], atol=1e-5)


def test_grpo_config_parses_like_jax():
    import os

    from trlx_tpu.data.configs import TRLConfig as JTRLConfig
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.method_configs import GRPOConfig, PPOConfig

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "grpo_sentiments.yml")
    port, ref = TRLConfig.load_yaml(path), JTRLConfig.load_yaml(path)
    assert type(port.method) is GRPOConfig and isinstance(port.method, PPOConfig)
    assert port.method.to_dict() == ref.method.to_dict()
    assert (port.method.group_size, port.method.vf_coef) == (8, 0.0)
    assert GRPOConfig().group_size == 8 and GRPOConfig().vf_coef == 0.0


def test_api_runs_grpo_trainer(tmp_path):
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer

    cfg = causal_config(tmp_path)
    cfg["train"]["total_steps"] = 1
    prompts = [[1, 2, 3], [4, 5], [6], [7, 8, 9]]
    trainer = trlx_tpu_torch.train(
        reward_fn=lambda samples, **_: [float(len(s)) for s in samples],
        prompts=prompts, config=TRLConfig.from_dict(cfg), device="cpu")
    assert type(trainer) is GRPOTrainer and trainer.step > 0


def test_scale_reward_group_matches_jax_orchestrator():
    """PPO's ``scale_reward: "group"``: the port's orchestrator scales a
    chunk's scores as the JAX one does (whitened per group of the grouped
    trainer, then clipped)."""
    from types import SimpleNamespace

    from trlx_tpu.orchestrator.ppo_orchestrator import PPOOrchestrator as JOrch
    from trlx_tpu.pipeline.prompt_pipeline import PromptPipeline as JPipeline
    from trlx_tpu_torch.data.method_configs import PPOConfig
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline

    method = PPOConfig(scale_reward="group", group_size=4, cliprange_reward=1.5)
    prompts = [[1, 2], [3], [4, 5, 6], [7]]

    def stub(bind=True):
        cfg = SimpleNamespace(method=method, train=SimpleNamespace(rollout_logging_dir=None))
        return SimpleNamespace(config=cfg, group_size=4, bind_prompt_budget=lambda p: None)

    port = PPOOrchestrator(stub(), PromptPipeline(prompts, 4), reward_fn=None, chunk_size=8)
    ref = JOrch(stub(), JPipeline(prompts, 4), reward_fn=None, chunk_size=8)
    rng = np.random.default_rng(1)
    for _ in range(2):
        scores = (rng.normal(size=8) * 4).astype(np.float32)
        want = ref._scale_scores(scores.copy(), method)
        got = port._scale_scores(scores.copy(), method)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert np.abs(got).max() <= 1.5
    assert port.running.mean == pytest.approx(ref.running.mean, rel=1e-12)


def test_grouped_chunk_repeats_each_prompt(tmp_path):
    """The loader draws chunk_size // G prompts, each repeated G times in
    a row, meta lists element-wise and n_real times G."""
    trainer = port_trainer(causal_config(tmp_path))
    orch = trainer.orch
    batch, meta = orch._expand_groups(*orch._draw())
    assert batch.input_ids.shape[0] == 8 and meta["n_real"] == 8
    ids = batch.input_ids.numpy().reshape(2, GROUP, -1)
    assert (ids == ids[:, :1]).all() and not (ids[0, 0] == ids[1, 0]).all()
    assert meta["prompts_text"][:GROUP] == [meta["prompts_text"][0]] * GROUP


# ------------------------------ refusals ----------------------------- #


REFUSALS = {
    # (trainer, method overrides, error, match); the reference's
    # tests/test_grpo.py refusals
    "grpo_config_needs_grpo_trainer": ("PPOTrainer", {}, ValueError, "GRPOTrainer"),
    "group_size_below_2": ("GRPOTrainer", {"group_size": 1}, ValueError, "group_size"),
    "vf_coef": ("GRPOTrainer", {"vf_coef": 0.5}, ValueError, "vf_coef"),
    "scale_reward_group_needs_groups": (
        "PPOTrainer", {"name": "PPOConfig", "scale_reward": "group", "group_size": 1,
                       "vf_coef": 1.0}, ValueError, "group"),
    "seq2seq_grpo_group_size": ("Seq2SeqGRPOTrainer", {"group_size": 1}, ValueError,
                                "group_size"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(tmp_path, name):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    trainer, method, error, match = REFUSALS[name]
    cfg = causal_config(tmp_path)
    cfg["method"].update(method)
    with pytest.raises(error, match=match):
        get_trainer(trainer)(TRLConfig.from_dict(cfg), device="cpu")


def test_chunk_size_must_hold_whole_groups(tmp_path):
    cfg = causal_config(tmp_path)
    cfg["method"]["chunk_size"] = 6
    with pytest.raises(ValueError, match="multiple of group_size"):
        port_trainer(cfg)
