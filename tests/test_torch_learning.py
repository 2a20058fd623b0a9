"""The port learns: mean reward must rise, on the CPU, with the port alone
(no JAX). This guards the whole RL path (KL penalty sign, advantage sign,
logprob alignment, optimizer wiring) against regressions that leave
training running but not learning.

- The target-token task and config of ``tests/test_learning.py``: reward
  is the share of response tokens equal to a target; a random policy
  emits it about 1/14 of the time, and mean reward must rise by the same
  0.15 margin within 96 updates.
- GRPO on the same task (``tests/test_grpo.py``'s GRPO learning test:
  groups of 4, no value function, 48 updates): the same 0.15 margin.
- The pretrained stand-in of ``examples/pretrained_standin.py``: a tiny
  GPT-2 pretrained offline on a two-topic corpus, saved in HF format by
  ``transformers`` and loaded through ``model.model_path``; PPO steers it
  toward the positive topic, and mean reward must rise by 0.2, the margin
  of ``tests/test_pretrained_path.py``. The loaded policy must first
  continue a prompt in its topic, which random weights do not.
- Offline ILQL on ``tests/test_learning.py``'s ILQL task: the
  advantage-shifted decode must emit the rewarded token in more than 80 %
  of the eval responses.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

from pretrained_standin import (  # noqa: E402
    NEG,
    POS,
    causal_rl_config,
    make_prompts,
    pretrain_gpt2_checkpoint,
    sentiment_reward,
)


def _target_config(tmp_path):
    """``tests/test_learning.py``'s config."""
    return {
        "model": {"model_type": "gpt2", "model_arch": {
            "vocab_size": 16, "n_positions": 16, "n_embd": 32, "n_layer": 2, "n_head": 2}},
        "train": {"seq_length": 4, "batch_size": 16, "epochs": 12, "total_steps": 96,
                  "eval_interval": 1000, "checkpoint_interval": 100000,
                  "lr_init": 1.0e-3, "lr_target": 1.0e-3, "dtype": "float32", "seed": 7,
                  "checkpoint_dir": str(tmp_path)},
        "method": {"name": "PPOConfig", "num_rollouts": 64, "chunk_size": 64, "ppo_epochs": 2,
                   "init_kl_coef": 0.001, "scale_reward": None,
                   "gen_kwargs": {"max_new_tokens": 6, "min_new_tokens": 6, "top_k": 0,
                                  "do_sample": True, "eos_token_id": 14, "pad_token_id": 15}},
    }


def _recording(reward, means):
    def reward_fn(samples, queries, response_gt=None):
        scores = reward(samples, queries, response_gt)
        means.append(float(np.mean(scores)))
        return scores

    return reward_fn


def _target_reward(samples, queries, response_gt=None):
    return [sum(tok == "5" for tok in s.split()) / 6 for s in samples]


def test_reward_improves_on_the_target_token_task(tmp_path):
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig

    means = []
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 13, size=rng.integers(1, 4))) for _ in range(64)]
    trainer = trlx_tpu_torch.train(
        reward_fn=_recording(_target_reward, means), prompts=prompts,
        eval_prompts=prompts[:16], config=TRLConfig.from_dict(_target_config(tmp_path)),
        device="cpu",
    )
    assert trainer.step == 96
    early, late = np.mean(means[:2]), np.max(means[-4:])
    assert late > early + 0.15, (early, late, means)
    # the last rollouts still have their min_new_tokens live tokens
    assert int(trainer.buffer.full.response_mask.sum(1).min()) >= 6


def test_grpo_reward_improves_on_the_target_token_task(tmp_path):
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer

    cfg = _target_config(tmp_path)
    cfg["train"].update(total_steps=48, trainer="GRPOTrainer")
    cfg["method"].update(name="GRPOConfig", group_size=4, chunk_size=16)
    means = []
    trainer = trlx_tpu_torch.train(
        reward_fn=_recording(_target_reward, means), prompts=[[1, 2, 3, 4]] * 64,
        config=TRLConfig.from_dict(cfg), device="cpu",
    )
    assert type(trainer) is GRPOTrainer and trainer.step == 48
    early, late = np.mean(means[:2]), np.max(means[-4:])
    assert late > early + 0.15, (early, late, means)
    heads = [p for n, p in trainer.model.named_parameters() if n.startswith("v_head.")]
    assert all(not p.grad.any() for p in heads)  # no value-function training


def _topic_fraction(out, topic):
    hits = np.isin(out.tokens.numpy(), topic) & out.response_mask.numpy().astype(bool)
    return hits.sum() / max(out.response_mask.sum().item(), 1)


def test_reward_improves_from_a_pretrained_checkpoint(tmp_path):
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    ckpt = pretrain_gpt2_checkpoint(str(tmp_path / "standin_gpt2"), steps=300)
    cfg = causal_rl_config(ckpt, total_steps=96, epochs=12,
                           checkpoint_dir=str(tmp_path / "ckpt"))
    probe = get_trainer("PPOTrainer")(TRLConfig.from_dict(cfg), device="cpu")
    rng = np.random.default_rng(0)
    ones = torch.ones(16, 8, dtype=torch.long)
    for topic in (POS, NEG):
        out = probe.sample(torch.from_numpy(rng.choice(topic, size=(16, 8))), ones)
        assert _topic_fraction(out, topic) > 0.75  # the loaded weights, not random ones
    del probe

    means = []
    prompts = make_prompts(np.random.default_rng(1), 128, 8)
    trained = trlx_tpu_torch.train(
        model_path=ckpt, reward_fn=_recording(sentiment_reward, means), prompts=prompts,
        config=TRLConfig.from_dict(dict(cfg, model=dict(cfg["model"], model_path=""))),
        device="cpu",
    )
    assert trained.config.model.model_path == ckpt and trained.step == 96
    early, late = float(np.mean(means[:2])), float(np.max(means[-3:]))
    assert late > early + 0.2, (early, late, means)


def test_ilql_decode_prefers_the_rewarded_token(tmp_path):
    """Offline ILQL on ``tests/test_learning.py::ilql_learned``'s task:
    sequences ending in the target token carry reward 1, others 0. The
    advantage-shifted decode must emit the target in more than 80 % of
    the eval responses (a random 13-token policy does in about 37 %)."""
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig

    config = TRLConfig.from_dict({
        "model": {"model_type": "gpt2", "model_arch": {
            "vocab_size": 16, "n_positions": 16, "n_embd": 32, "n_layer": 2, "n_head": 2}},
        "train": {"seq_length": 8, "batch_size": 32, "epochs": 6, "total_steps": 400,
                  "eval_interval": 10000, "checkpoint_interval": 100000, "lr_init": 1.0e-3,
                  "lr_target": 1.0e-3, "dtype": "float32", "seed": 3,
                  "checkpoint_dir": str(tmp_path)},
        "method": {"name": "ILQLConfig", "two_qs": True, "alpha": 0.1,
                   "steps_for_target_q_sync": 10, "betas": [4.0],
                   "gen_kwargs": {"max_new_tokens": 6, "do_sample": True, "top_k": 0,
                                  "eos_token_id": 14, "pad_token_id": 15}},
    })
    target = 5
    rng = np.random.default_rng(0)
    samples, rewards = [], []
    for _ in range(512):
        toks = list(rng.integers(1, 13, size=7))
        if rng.random() < 0.5:
            toks[-1] = target
        samples.append((toks, 1))
        rewards.append(1.0 if toks[-1] == target else 0.0)
    prompts = [[int(t)] for t in rng.integers(1, 13, size=32)]
    trainer = trlx_tpu_torch.train(dataset=(samples, rewards), eval_prompts=prompts,
                                   config=config, device="cpu")
    assert trainer.step == 96  # 16 minibatches x 6 epochs
    trainer.evaluate()
    columns, table = trainer._last_samples
    responses = [row[columns.index("response")] for row in table]
    hit = sum(str(target) in r.split() for r in responses) / len(responses)
    assert hit > 0.8, (hit, responses[:5])
