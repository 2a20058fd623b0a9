"""One PPO-family phase through ``learn()`` in both packages, from the same
parameters and prompts: the config, prompts and reward, the two runs, and
the final-parameter check the port's PPO parity tests share.

Both trainers (``train.trainer``, PPO by default) run a tiny f32 GPT-2 +
value head (the JAX one on the suite's 8-device CPU mesh, the port on the
CPU); the seq2seq tests pass their T5 config, prompts and reward. The
port's parameters are loaded from the JAX trainer's initial ones, and its
KL reference is taken again from them, as the trainer takes it at
construction. A sampled run (``sampled=True``) records every key the JAX
trainer's sampler and continuous engine draw from, and
:func:`inject_jax_noise` hands the port's the Gumbel noise of those keys,
so sampled tokens match exactly. Each package's ``learn()`` runs under a
fresh tracer and metrics registry of its own (``scoped_tracer`` /
``scoped_metrics``), returned as ``tracer`` and ``metrics`` for the span
and registry parity checks (:func:`span_tree`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

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


def _data(data):
    """``(prompts, reward, response_gt)``, the GPT-2 phase's by default."""
    return data or (prompts(), reward_fn, None)


def run_jax(cfg: dict, data=None, sampled: bool = False) -> dict:
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.utils.loading import get_orchestrator, get_pipeline, get_trainer

    prompt_list, reward, response_gt = _data(data)
    config = TRLConfig.from_dict(cfg)
    trainer = get_trainer(config.train.trainer)(config, reward_fn=reward)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state.params))
    pipeline = get_pipeline("PromptPipeline")(
        prompt_list, trainer.query_length, response_gt=response_gt)
    get_orchestrator("PPOOrchestrator")(
        trainer, pipeline, reward_fn=reward, chunk_size=config.method.chunk_size
    )
    trainer.add_eval_pipeline(pipeline)
    log = {"ref": [], "phase": [], "eval": [], "sample_keys": [], "phase_keys": []}
    record(trainer, "score_ref", log["ref"])
    record(trainer, "finish_streamed_phase", log["phase"])
    record(trainer, "evaluate", log["eval"])
    if sampled:
        _record_keys(trainer, log)
    from trlx_tpu import telemetry

    with telemetry.scoped_tracer() as tracer, telemetry.scoped_metrics() as metrics:
        trainer.learn()
    buf = jax.device_get(trainer.buffer.full)
    return {
        "trainer": trainer,
        "tracer": tracer,
        "metrics": metrics,
        "sample_keys": log["sample_keys"],
        "phase_keys": log["phase_keys"],
        "init": init,
        "params": jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state.params)),
        "buffer": {k: np.asarray(getattr(buf, k)) for k in BUFFER_KEYS},
        "ref": np.concatenate([np.asarray(r) for r in log["ref"]]),
        "rows": log["phase"][0][1],
        "phase_rows": [p[1] for p in log["phase"]],
        "kl_seq": log["phase"][0][2],
        "eval": log["eval"],
        "kl_coef": trainer.kl_coef,
        "ref_names": set(flax_to_torch(jax.tree_util.tree_map(np.asarray, trainer.ref_params))),
    }


def _record_keys(trainer, log) -> None:
    """Record each key the JAX trainer's sampler is called with (a batch
    key, or [B, 2] row keys under per-row RNG), and each phase key its
    continuous engine starts on."""
    sample_jit = trainer._sample_jit

    def sample(params, ids, mask, key):
        log["sample_keys"].append(np.asarray(key))
        return sample_jit(params, ids, mask, key)

    trainer._sample_jit = sample
    if trainer.rollout_engine == "continuous":
        engine = trainer.rollout_engine_obj
        start_phase = engine.start_phase

        def start(params, key, *a, **kw):
            log["phase_keys"].append(np.asarray(key))
            return start_phase(params, key, *a, **kw)

        engine.start_phase = start


@jax.jit
def _per_row_gumbel(row_keys, steps, like):
    """Each row's Gumbel draw of ``like``'s width under ``fold_in(row_key,
    step)``: the JAX per-row sampler's and engine's noise."""
    keys = jax.vmap(jax.random.fold_in)(row_keys, steps)
    return jax.vmap(lambda k: jax.random.gumbel(k, like.shape, jnp.float32))(keys)


def per_row_noise(row_keys, steps, vocab: int) -> torch.Tensor:
    steps = jnp.asarray(np.broadcast_to(steps, (len(row_keys),)), jnp.int32)
    out = _per_row_gumbel(jnp.asarray(row_keys), steps, jnp.zeros((vocab,), jnp.float32))
    return torch.from_numpy(np.array(out))


def engine_noise(phase_key, rows, steps, vocab: int) -> torch.Tensor:
    """The JAX engine's noise for slots holding draw indices ``rows``
    (idle slots, None, draw row 0's: their emissions are discarded)."""
    from trlx_tpu.ops.sampling import make_row_keys

    idx = np.asarray([0 if r is None else r for r in rows])
    return per_row_noise(np.asarray(make_row_keys(jnp.asarray(phase_key), idx)), steps, vocab)


def split_chain_noise(key, steps: int, shape) -> list:
    """The JAX batch sampler's per-step draws: ``rng, k = split(rng)``
    each step, Gumbel noise of the logits' shape under ``k``."""
    noise, r = [], jnp.asarray(key)
    for _ in range(steps):
        r, k = jax.random.split(r)
        noise.append(torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32))))
    return noise


def inject_jax_noise(trainer, jax_run) -> None:
    """Hand the port trainer's sampler (and continuous engine) the JAX
    run's draws, call by call and phase by phase."""
    keys = iter(jax_run["sample_keys"])
    phase_keys = iter(jax_run["phase_keys"])
    vocab = trainer.model_config.vocab_size
    sampler = trainer._sampler

    def sample(ids, mask, generator=None, **_):
        key = next(keys)
        if key.ndim == 2:  # [B, 2] row keys
            def noise_fn(t):
                return per_row_noise(key, t, vocab)
        else:
            chain = split_chain_noise(key, trainer.gen_config.max_new_tokens,
                                      (ids.shape[0], vocab))

            def noise_fn(t):
                return chain[t]
        return sampler(ids, mask, noise_fn=noise_fn)

    trainer._sampler = sample
    if trainer.rollout_engine == "continuous":
        engine = trainer.rollout_engine_obj
        start_phase, current = engine.start_phase, {}

        def start(seed, *a, **kw):
            current["key"] = next(phase_keys)
            return start_phase(seed, *a, **kw)

        engine.start_phase = start
        engine.noise_fn = lambda rows, steps: engine_noise(current["key"], rows, steps, vocab)


def port_trainer(cfg: dict, init=None, data=None):
    """The port's trainer on ``cfg`` with a bound pipeline and orchestrator;
    with ``init`` (a JAX param tree as numpy) it starts from those
    parameters, its KL reference taken again from them."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline, get_trainer

    prompt_list, reward, response_gt = _data(data)
    config = TRLConfig.from_dict(cfg)
    trainer = get_trainer(config.train.trainer)(config, reward_fn=reward, device="cpu")
    if init is not None:
        trainer.model.load_state_dict(flax_to_torch(init))
        if hasattr(trainer.model, "t5"):
            trainer._setup_reference(trainer.model.t5, trainer.model_config.num_decoder_layers)
        else:
            trainer._setup_reference(trainer.model.transformer, trainer.model_config.n_layer)
    pipeline = get_pipeline("PromptPipeline")(
        prompt_list, trainer.query_length, response_gt=response_gt)
    get_orchestrator("PPOOrchestrator")(
        trainer, pipeline, reward_fn=reward, chunk_size=config.method.chunk_size
    )
    trainer.add_eval_pipeline(pipeline)
    return trainer


#: a nonzero gradient element below this in some update has its Adam step
#: decided by rounding (Adam's eps is 1e-8): ``assert_final_params_match``'s
#: ``noisy``
NOISY_GRAD = 1e-6


def _record_grad_floor(trainer) -> dict:
    """Record, per parameter element, its smallest nonzero gradient
    magnitude over the updates; the returned dict fills as they run."""
    floor = {}
    step = trainer.opt.step

    def recorded_step():
        for name, p in trainer.model.named_parameters():
            if p.grad is not None:  # exact zeros (unused embedding rows) are exact in both
                g = p.grad.abs().masked_fill(p.grad == 0, float("inf"))
                floor[name] = torch.minimum(floor[name], g) if name in floor else g
        return step()

    trainer.opt.step = recorded_step
    return floor


def _port_learn(trainer):
    """``trainer.learn()`` under a fresh tracer and registry; returns them."""
    from trlx_tpu_torch import telemetry

    with telemetry.scoped_tracer() as tracer, telemetry.scoped_metrics() as metrics:
        trainer.learn()
    return tracer, metrics


def span_tree(tracer) -> dict:
    """``{name: {"count": n, "parents": {parent name: n}}}`` over a tracer's
    spans (a top-level span's parent is ``None``)."""
    spans = tracer.spans()
    names = {s.index: s.name for s in spans}
    tree = {}
    for s in spans:
        entry = tree.setdefault(s.name, {"count": 0, "parents": {}})
        entry["count"] += 1
        parent = names.get(s.parent)
        entry["parents"][parent] = entry["parents"].get(parent, 0) + 1
    return tree


def registry_names(registry) -> dict:
    """A metrics registry's instrument names by kind."""
    snap = registry.snapshot()
    return {kind: sorted(snap[kind]) for kind in ("counters", "gauges", "histograms")}


def run_port(trainer) -> dict:
    """The port's greedy phase; also the elements whose gradient fell below
    ``NOISY_GRAD`` in some update, as ``noisy``."""
    log = {"ref": [], "phase": [], "eval": []}
    record(trainer, "score_ref", log["ref"])
    record(trainer, "_train_on", log["phase"])
    record(trainer, "evaluate", log["eval"])
    floor = _record_grad_floor(trainer)
    tracer, metrics = _port_learn(trainer)
    buf = trainer.buffer.full
    return {
        "trainer": trainer,
        "tracer": tracer,
        "metrics": metrics,
        "buffer": {k: getattr(buf, k).numpy() for k in BUFFER_KEYS},
        "ref": torch.cat(log["ref"]).numpy(),
        "rows": log["phase"][0][0],
        "kl_seq": log["phase"][0][1],
        "eval": log["eval"],
        "noisy": {name: f < NOISY_GRAD for name, f in floor.items()},
    }


def run_port_sampled(trainer, jax_run) -> dict:
    """The port's phase under the JAX run's noise (:func:`inject_jax_noise`);
    also records, per parameter element, its smallest nonzero gradient
    magnitude over the updates, and returns the elements below
    ``NOISY_GRAD`` as ``noisy``."""
    inject_jax_noise(trainer, jax_run)
    log = {"phase": []}
    record(trainer, "_train_on", log["phase"])
    floor = _record_grad_floor(trainer)
    tracer, metrics = _port_learn(trainer)
    buf = trainer.buffer.full
    return {
        "trainer": trainer,
        "tracer": tracer,
        "metrics": metrics,
        "buffer": {k: getattr(buf, k).numpy() for k in BUFFER_KEYS},
        "rows": log["phase"][0][0],
        "phase_rows": [p[0] for p in log["phase"]],
        "noisy": {name: f < NOISY_GRAD for name, f in floor.items()},
    }


def assert_final_params_match(got, jax_run, cfg: dict, noisy=None, flipped_at=None) -> float:
    """The port's final state dict ``got`` against the JAX run's: 1e-5
    absolute, except the attention key biases. Their gradient is zero in
    exact arithmetic (the key bias adds one constant to a query row's
    logits, which softmax ignores), so in f32 it is rounding noise, and
    AdamW, which normalises each element, moves them by up to ``lr`` per
    update in a direction the noise decides on either side: they are held
    to twice the summed learning rate (GPT-2's ``c_attn`` bias is [q | k |
    v], NeoX's ``query_key_value`` bias head-major, [q | k | v] a head).
    ``noisy`` ({name: bool mask}) names
    other elements held so, each for the same reason: a gradient so near
    zero in some update (within a few hundred ``eps`` of Adam's) that
    rounding decides that update's normalised step. ``flipped_at`` (an
    update, counted from 1) names the first update in which rounding put
    a token's probability ratio on the other side of the clip boundary
    (the two runs' clip fractions differ by that token): from it on every
    element's step may differ, so all are held to twice the learning rate
    summed over the updates from it to the end. Returns the largest move
    from the initial parameters."""
    want = flax_to_torch(jax_run["params"])
    init = flax_to_torch(jax_run["init"])
    assert set(got) == set(want)
    tol = 2 * cfg["train"]["total_steps"] * cfg["train"]["lr_init"]
    flip_tol = (1e-5 if flipped_at is None else
                2 * (cfg["train"]["total_steps"] - flipped_at + 1) * cfg["train"]["lr_init"])
    moved = 0.0
    for name, w in want.items():
        g = got[name].numpy().copy()
        w = w.numpy().copy()
        key_bias = None
        if name.endswith("attn.c_attn.bias"):
            C = cfg["model"]["model_arch"]["n_embd"]
            key_bias = np.zeros(g.shape, bool)
            key_bias[C:2 * C] = True  # c_attn's bias is [q | k | v]
        elif name.endswith("attn.query_key_value.bias"):
            H = cfg["model"]["model_arch"]["num_attention_heads"]
            key_bias = np.zeros((H, 3, g.size // (3 * H)), bool)
            key_bias[:, 1] = True  # NeoX's is head-major: [q_h | k_h | v_h] per head
            key_bias = key_bias.reshape(g.shape)
        if key_bias is not None:
            np.testing.assert_allclose(g[key_bias], w[key_bias], atol=tol, rtol=0)
            g[key_bias] = w[key_bias]
        if noisy is not None and name in noisy:
            m = noisy[name].numpy()
            np.testing.assert_allclose(g[m], w[m], atol=tol, rtol=0, err_msg=name)
            g[m] = w[m]
        np.testing.assert_allclose(g, w, atol=max(1e-5, flip_tol), rtol=0, err_msg=name)
        moved = max(moved, float(np.abs(w - init[name].numpy()).max()))
    return moved
