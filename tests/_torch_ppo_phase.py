"""One greedy PPO phase through ``learn()`` in both packages, from the same
parameters and prompts: the config, prompts and reward, the two runs, and
the final-parameter check the port's PPO parity tests share.

Both trainers run a tiny f32 GPT-2 + value head (the JAX one on the
suite's 8-device CPU mesh, the port on the CPU). The port's parameters
are loaded from the JAX trainer's initial ones, and its KL reference is
taken again from them, as the trainer takes it at construction.
"""

import jax
import numpy as np

from trlx_tpu_torch.models.convert import flax_to_torch

ARCH = {"vocab_size": 40, "n_positions": 32, "n_embd": 32, "n_layer": 2, "n_head": 2}
N_PROMPTS = 24
BUFFER_KEYS = ("query_tokens", "query_mask", "response_tokens", "response_mask",
               "logprobs", "values", "rewards")


def config(ckpt_dir, n_layer: int = 2, model=None, train=None, gen_kwargs=None) -> dict:
    """Two minibatches of 8 from 16 rollouts, 2 PPO epochs: 4 updates."""
    return {
        "model": {"model_type": "gpt2", "model_arch": dict(ARCH, n_layer=n_layer),
                  **(model or {})},
        "train": {
            "seq_length": 6, "batch_size": 8, "epochs": 1, "total_steps": 4,
            "lr_init": 1e-3, "lr_target": 2e-4, "eval_interval": 1000,
            "checkpoint_interval": 1000, "dtype": "float32", "seed": 5,
            "checkpoint_dir": str(ckpt_dir), "mesh": {"dp": -1, "fsdp": 1, "tp": 1},
            **(train or {}),
        },
        "method": {
            "name": "PPOConfig", "num_rollouts": 16, "chunk_size": 8,
            "ppo_epochs": 2, "init_kl_coef": 0.05, "target": 6.0, "horizon": 100,
            "scale_reward": "running", "cliprange_reward": 10.0,
            "gen_kwargs": {"max_new_tokens": 7, "min_new_tokens": 2,
                           "do_sample": False, "eos_token_id": 10, "pad_token_id": 39,
                           **(gen_kwargs or {})},
        },
    }


def prompts():
    rng = np.random.default_rng(9)
    return [[int(x) for x in rng.integers(0, 36, int(rng.integers(1, 7)))]
            for _ in range(N_PROMPTS)]


def reward_fn(samples, queries, response_gt=None):
    # a pure function of the response ids (greedy tokens are exact, so the
    # two runs score identical text)
    return [float(np.mean([int(t) < 20 for t in s.split()])) if s else 0.0
            for s in samples]


def record(obj, name, log):
    orig = getattr(obj, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        log.append(out)
        return out

    setattr(obj, name, wrapper)


def run_jax(cfg: dict) -> dict:
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.utils.loading import get_orchestrator, get_pipeline, get_trainer

    config = TRLConfig.from_dict(cfg)
    trainer = get_trainer("PPOTrainer")(config, reward_fn=reward_fn)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state.params))
    pipeline = get_pipeline("PromptPipeline")(prompts(), trainer.query_length)
    get_orchestrator("PPOOrchestrator")(
        trainer, pipeline, reward_fn=reward_fn, chunk_size=config.method.chunk_size
    )
    trainer.add_eval_pipeline(pipeline)
    log = {"ref": [], "phase": [], "eval": []}
    record(trainer, "score_ref", log["ref"])
    record(trainer, "finish_streamed_phase", log["phase"])
    record(trainer, "evaluate", log["eval"])
    trainer.learn()
    buf = jax.device_get(trainer.buffer.full)
    return {
        "init": init,
        "params": jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state.params)),
        "buffer": {k: np.asarray(getattr(buf, k)) for k in BUFFER_KEYS},
        "ref": np.concatenate([np.asarray(r) for r in log["ref"]]),
        "rows": log["phase"][0][1],
        "kl_seq": log["phase"][0][2],
        "eval": log["eval"],
        "kl_coef": trainer.kl_coef,
        "ref_names": set(flax_to_torch(jax.tree_util.tree_map(np.asarray, trainer.ref_params))),
    }


def port_trainer(cfg: dict, init=None):
    """The port's trainer on ``cfg`` with a bound pipeline and orchestrator;
    with ``init`` (a JAX param tree as numpy) it starts from those
    parameters, its KL reference taken again from them."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline, get_trainer

    config = TRLConfig.from_dict(cfg)
    trainer = get_trainer("PPOTrainer")(config, reward_fn=reward_fn, device="cpu")
    if init is not None:
        trainer.model.load_state_dict(flax_to_torch(init))
        trainer._setup_reference(trainer.model.transformer, trainer.model_config.n_layer)
    pipeline = get_pipeline("PromptPipeline")(prompts(), trainer.query_length)
    get_orchestrator("PPOOrchestrator")(
        trainer, pipeline, reward_fn=reward_fn, chunk_size=config.method.chunk_size
    )
    trainer.add_eval_pipeline(pipeline)
    return trainer


def run_port(trainer) -> dict:
    import torch

    log = {"ref": [], "phase": [], "eval": []}
    record(trainer, "score_ref", log["ref"])
    record(trainer, "_train_on", log["phase"])
    record(trainer, "evaluate", log["eval"])
    trainer.learn()
    buf = trainer.buffer.full
    return {
        "trainer": trainer,
        "buffer": {k: getattr(buf, k).numpy() for k in BUFFER_KEYS},
        "ref": torch.cat(log["ref"]).numpy(),
        "rows": log["phase"][0][0],
        "kl_seq": log["phase"][0][1],
        "eval": log["eval"],
    }


def assert_final_params_match(got, jax_run, cfg: dict) -> float:
    """The port's final state dict ``got`` against the JAX run's: 1e-5
    absolute, except the attention key biases. Their gradient is zero in
    exact arithmetic (the key bias adds one constant to a query row's
    logits, which softmax ignores), so in f32 it is rounding noise, and
    AdamW, which normalises each element, moves them by up to ``lr`` per
    update in a direction the noise decides on either side: they are held
    to twice the summed learning rate. Returns the largest move from the
    initial parameters."""
    want = flax_to_torch(jax_run["params"])
    init = flax_to_torch(jax_run["init"])
    assert set(got) == set(want)
    C = cfg["model"]["model_arch"]["n_embd"]
    key_bias = slice(C, 2 * C)  # c_attn's bias is [q | k | v]
    key_bias_tol = 2 * cfg["train"]["total_steps"] * cfg["train"]["lr_init"]
    moved = 0.0
    for name, w in want.items():
        g = got[name].numpy().copy()
        w = w.numpy().copy()
        if name.endswith("attn.c_attn.bias"):
            np.testing.assert_allclose(g[key_bias], w[key_bias], atol=key_bias_tol, rtol=0)
            g[key_bias] = w[key_bias]
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
        moved = max(moved, float(np.abs(w - init[name].numpy()).max()))
    return moved
