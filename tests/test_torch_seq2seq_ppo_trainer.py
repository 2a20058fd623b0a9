"""The seq2seq slice as a whole: one greedy PPO phase of a T5 policy
through ``learn()`` in both packages, from the same parameters and prompts.

Both trainers (``Seq2SeqPPOTrainer``) run a tiny f32 gated-GELU T5 + value
head with an untied head (the UL2 architecture; the JAX one on the suite's
8-device CPU mesh, the port on the CPU) through the fork's path: the
seq2seq sampler with decoder start 0, a forced BOS, eos 1 and pad 0, the
full-copy KL reference, the reward (which reads ``response_gt``), running
reward scaling, KL shaping, one phase of the streamed plan's updates (GAE +
whitening, the teacher-forced forward on the shifted response, ``ppo_loss``,
global-norm clip, AdamW on a cosine schedule), then the end-of-run save
and eval. The port's parameters are loaded from the JAX trainer's initial
ones.

Held, with their tolerances (the ones of ``tests/test_torch_ppo_trainer.py``;
f32 throughout, the frameworks sum in another order):

- tokens and masks: exact (greedy decoding);
- behaviour logprobs, values, reference logprobs and shaped rewards: 1e-5;
- per-update stats: 2e-4 relative-or-absolute;
- final parameters: 1e-5 absolute;
- the KL coefficient sequence and eval rewards: exact / 1e-6;
- a ``save``/``load`` round trip restores the state exactly.

It also pins what the trainer refuses for seq2seq.
"""

import jax
import numpy as np
import pytest
import torch

from trlx_tpu_torch.models.convert import flax_to_torch

ARCH = {
    "vocab_size": 40, "d_model": 32, "d_kv": 8, "d_ff": 48, "num_layers": 2,
    "num_decoder_layers": 2, "num_heads": 4, "relative_attention_num_buckets": 8,
    "relative_attention_max_distance": 16, "feed_forward_proj": "gated-gelu",
    "tie_word_embeddings": False,
}
N_PROMPTS = 16


def _config(ckpt_dir):
    return {
        "model": {"model_type": "t5", "model_arch": dict(ARCH)},
        "train": {
            "seq_length": 8, "batch_size": 8, "epochs": 1, "total_steps": 4,
            "lr_init": 1e-3, "lr_target": 2e-4, "eval_interval": 1000,
            "checkpoint_interval": 1000, "dtype": "float32", "seed": 3,
            "checkpoint_dir": str(ckpt_dir), "mesh": {"dp": -1, "fsdp": 1, "tp": 1},
            "trainer": "Seq2SeqPPOTrainer",
        },
        "method": {
            "name": "PPOConfig", "num_rollouts": 16, "chunk_size": 8,
            "ppo_epochs": 2, "init_kl_coef": 0.05, "target": 6.0, "horizon": 100,
            "scale_reward": "running", "cliprange_reward": 10.0,
            "gen_kwargs": {"max_new_tokens": 5, "min_length": 3, "do_sample": False,
                           "eos_token_id": 1, "pad_token_id": 0,
                           "forced_bos_token_id": 9},
        },
    }


def _prompts():
    rng = np.random.default_rng(4)
    return [[int(x) for x in rng.integers(2, 40, int(rng.integers(1, 9)))]
            for _ in range(N_PROMPTS)]


def _response_gt():
    return [str(9 + i % 5) for i in range(N_PROMPTS)]


def _reward_fn(samples, queries, response_gt=None):
    # a pure function of the response ids and the ground truth (greedy
    # tokens are exact, so the two runs score identical text)
    return [float(np.mean([int(t) < 20 for t in s.split()])) + float(gt in s.split())
            if s else 0.0 for s, gt in zip(samples, response_gt)]


def _record(obj, name, log):
    orig = getattr(obj, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        log.append(out)
        return out

    setattr(obj, name, wrapper)


def _run_jax(tmp_path):
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.utils.loading import get_orchestrator, get_pipeline, get_trainer

    config = TRLConfig.from_dict(_config(tmp_path / "jax"))
    trainer = get_trainer("Seq2SeqPPOTrainer")(config, reward_fn=_reward_fn)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state.params))
    pipeline = get_pipeline("PromptPipeline")(
        _prompts(), trainer.query_length, response_gt=_response_gt())
    get_orchestrator("PPOOrchestrator")(
        trainer, pipeline, reward_fn=_reward_fn, chunk_size=config.method.chunk_size
    )
    trainer.add_eval_pipeline(pipeline)
    log = {"ref": [], "phase": [], "eval": []}
    _record(trainer, "score_ref", log["ref"])
    _record(trainer, "finish_streamed_phase", log["phase"])
    _record(trainer, "evaluate", log["eval"])
    trainer.learn()
    buf = jax.device_get(trainer.buffer.full)
    return {
        "init": init,
        "params": jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state.params)),
        "buffer": {k: np.asarray(getattr(buf, k)) for k in (
            "query_tokens", "query_mask", "response_tokens", "response_mask",
            "logprobs", "values", "rewards")},
        "ref": np.concatenate([np.asarray(r) for r in log["ref"]]),
        "rows": log["phase"][0][1],
        "kl_seq": log["phase"][0][2],
        "eval": log["eval"],
        "kl_coef": trainer.kl_coef,
    }


def _port_trainer(tmp_path, init=None):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline, get_trainer

    config = TRLConfig.from_dict(_config(tmp_path / "port"))
    trainer = get_trainer(config.train.trainer)(config, reward_fn=_reward_fn, device="cpu")
    if init is not None:
        trainer.model.load_state_dict(flax_to_torch(init))
        trainer.ref.load_state_dict(trainer.model.t5.state_dict())
    pipeline = get_pipeline("PromptPipeline")(
        _prompts(), trainer.query_length, response_gt=_response_gt())
    get_orchestrator("PPOOrchestrator")(
        trainer, pipeline, reward_fn=_reward_fn, chunk_size=config.method.chunk_size
    )
    trainer.add_eval_pipeline(pipeline)
    return trainer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("seq2seq_phase")
    jax_run = _run_jax(tmp_path)
    trainer = _port_trainer(tmp_path, jax_run["init"])
    log = {"ref": [], "phase": [], "eval": []}
    _record(trainer, "score_ref", log["ref"])
    _record(trainer, "_train_on", log["phase"])
    _record(trainer, "evaluate", log["eval"])
    trainer.learn()
    buf = trainer.buffer.full
    port_run = {
        "trainer": trainer,
        "buffer": {k: getattr(buf, k).numpy() for k in jax_run["buffer"]},
        "ref": torch.cat(log["ref"]).numpy(),
        "rows": log["phase"][0][0],
        "kl_seq": log["phase"][0][1],
        "eval": log["eval"],
    }
    return jax_run, port_run, tmp_path


def test_rollouts_are_token_exact(runs):
    jax_run, port_run, _ = runs
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(port_run["buffer"][key], jax_run["buffer"][key], err_msg=key)
    tokens, mask = port_run["buffer"]["response_tokens"], port_run["buffer"]["response_mask"]
    assert (tokens[:, 0] == 9).all()  # the forced BOS
    assert mask[:, :2].all()  # min_length 3 counts the start token


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
    jax_run, port_run, _ = runs
    want = flax_to_torch(jax_run["params"])
    init = flax_to_torch(jax_run["init"])
    got = port_run["trainer"].model.state_dict()
    assert set(got) == set(want)
    moved = 0.0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5, rtol=0, err_msg=name)
        moved = max(moved, float(np.abs(w.numpy() - init[name].numpy()).max()))
    assert moved > 1e-4  # the phase did move the parameters
    table = "t5.enc_rel_bias.relative_attention_bias.weight"
    assert not np.array_equal(got[table].numpy(), init[table].numpy())  # the learned bias trains


def test_eval_rewards_match(runs):
    jax_run, port_run, _ = runs
    assert len(port_run["eval"]) == len(jax_run["eval"]) == 2  # step 0 and the end
    for got, want in zip(port_run["eval"], jax_run["eval"]):
        for key in ("reward/mean", "reward/std"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7)


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


@pytest.mark.parametrize("change,match", [
    ({"model": {"num_layers_unfrozen": 1}}, "num_layers_unfrozen"),
    ({"model": {"ref_branch_layers": 1}}, "hydra"),
    ({"train": {"logprob_chunk": 4}}, "logprob_chunk"),
    ({"train": {"rollout": {"engine": "continuous"}}}, "continuous"),
    ({"train": {"mesh": {"dp": 1, "fsdp": 1, "tp": 1, "pp": 2}}}, "item 14"),
    ({"method": {"gen_kwargs": {"max_length": 1, "eos_token_id": 1, "pad_token_id": 0}}},
     "max_length=1"),
])
def test_refusals(tmp_path, change, match):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    cfg = _config(tmp_path)
    for section, values in change.items():
        cfg[section].update(values)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        get_trainer("T5PPOTrainer")(TRLConfig.from_dict(cfg), reward_fn=_reward_fn,
                                    device="cpu")


def test_decoder_start_defaults_from_the_arch(tmp_path):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    cfg = _config(tmp_path)
    cfg["model"]["model_arch"]["decoder_start_token_id"] = 5
    trainer = get_trainer("Seq2SeqPPOTrainer")(TRLConfig.from_dict(cfg), device="cpu")
    assert trainer.gen_config.decoder_start_token_id == 5
    cfg["method"]["gen_kwargs"]["decoder_start_token_id"] = 2
    trainer = get_trainer("Seq2SeqPPOTrainer")(TRLConfig.from_dict(cfg), device="cpu")
    assert trainer.gen_config.decoder_start_token_id == 2
