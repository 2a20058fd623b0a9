"""Tiny continuous-batching engines in both packages, on the same f32 GPT-2
weights, for the serving-tier parity tests (chunked prefill, the shared
prefix pool, speculative decoding).

The geometry is ``tests/test_chunked_prefill.py``'s: Q = 16 prompt
columns, R = 8 new tokens, a 64-token vocabulary, 4 slots, admit and
harvest 2, block 4. Engines are cached per feature set, so a test module
pays each JAX program's compile once. :func:`drive_rows` runs a prompt set
through either package's engine (the port's handed the JAX engine's
per-row draws), with the prefix pool planned per admission wave as the
server plans it, through ``drive()`` or the serving ``pump()``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from _torch_ppo_phase import engine_noise

Q, R, VOCAB, EOS = 16, 8, 64, 63
ARCH = dict(vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2, n_head=2,
            dtype="float32")
GEOMETRY = dict(query_length=Q, vocab_size=VOCAB, num_slots=4, admit_width=2,
                harvest_width=2, block_size=4)
GEN = dict(max_new_tokens=R, min_new_tokens=1, eos_token_id=EOS, pad_token_id=EOS)
FIELDS = ("tokens", "response_mask", "logprobs", "values")


@functools.lru_cache(maxsize=None)
def jax_model_and_params():
    from trlx_tpu.models.gpt2 import GPT2Config
    from trlx_tpu.models.heads import CausalLMWithValueHead

    cfg = GPT2Config(**ARCH)
    model = CausalLMWithValueHead(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg, model, params


@functools.lru_cache(maxsize=None)
def port_model():
    import torch

    from trlx_tpu_torch.models.convert import flax_to_torch
    from trlx_tpu_torch.models.gpt2 import GPT2Config
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead

    cfg = GPT2Config(**ARCH)
    model = CausalLMWithValueHead(cfg, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jax_model_and_params()[2])
    model.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        model.eval()
    return cfg, model


@functools.lru_cache(maxsize=None)
def jax_engine(prefill_chunk=0, pool_blocks=0, chunks_per_pump=0, spec_max_draft=0,
               do_sample=True):
    from trlx_tpu.inference.engine import ContinuousBatchingEngine
    from trlx_tpu.models.gpt2 import init_cache
    from trlx_tpu.ops.sampling import GenerationConfig

    cfg, model, _ = jax_model_and_params()

    def apply_fn(p, input_ids, attention_mask=None, position_ids=None, cache=None,
                 cache_index=None, last_only=False, skip_heads=False):
        return model.apply({"params": p}, input_ids, attention_mask=attention_mask,
                           position_ids=position_ids, cache=cache, cache_index=cache_index,
                           last_only=last_only, skip_heads=skip_heads)

    return ContinuousBatchingEngine(
        apply_fn=apply_fn, init_cache_fn=functools.partial(init_cache, cfg),
        gen_config=GenerationConfig(**GEN, do_sample=do_sample), **GEOMETRY,
        prefix_pool_blocks=pool_blocks, prefill_chunk=prefill_chunk,
        prefill_chunks_per_pump=chunks_per_pump, spec_max_draft=spec_max_draft,
    )


@functools.lru_cache(maxsize=None)
def port_engine(prefill_chunk=0, pool_blocks=0, chunks_per_pump=0, spec_max_draft=0,
                do_sample=True):
    from trlx_tpu_torch.inference.engine import ContinuousBatchingEngine
    from trlx_tpu_torch.models.gpt2 import init_cache
    from trlx_tpu_torch.ops.sampling import GenerationConfig

    cfg, model = port_model()
    return ContinuousBatchingEngine(
        apply_fn=model, init_cache_fn=functools.partial(init_cache, cfg, device="cpu"),
        gen_config=GenerationConfig(**GEN, do_sample=do_sample), **GEOMETRY,
        prefix_pool_blocks=pool_blocks, prefill_chunk=prefill_chunk,
        prefill_chunks_per_pump=chunks_per_pump, spec_max_draft=spec_max_draft,
        model_config=cfg, device="cpu",
    )


def mixed_prompts(n, seed=0, lo=2, hi=Q, sort=True):
    """Left-padded prompts of lo..hi real tokens; sorted by length, so
    admission groups are length-homogeneous and leading pad chunks skip."""
    rng = np.random.default_rng(seed)
    ids = np.full((n, Q), EOS, np.int32)
    mask = np.zeros((n, Q), np.int32)
    for i in range(n):
        real = int(rng.integers(lo, hi + 1))
        ids[i, Q - real:] = rng.integers(1, 60, real)
        mask[i, Q - real:] = 1
    if sort:
        order = np.argsort(mask.sum(axis=1), kind="stable")
        ids, mask = ids[order], mask[order]
    return ids, mask


def shared_prompts(n, seed=11, prefixes=1):
    """Full-length prompts whose leading half is one of ``prefixes``
    common prefixes (left-padded prompts share only when they pad alike)."""
    rng = np.random.default_rng(seed)
    heads = rng.integers(1, 60, (prefixes, Q // 2)).astype(np.int32)
    ids = rng.integers(1, 60, (n, Q)).astype(np.int32)
    ids[:, :Q // 2] = heads[np.arange(n) % prefixes]
    return ids, np.ones((n, Q), np.int32)


def draftable_prompts(n):
    """Cyclic 2-token prompts: every suffix recurs, so the n-gram drafter
    proposes from the first step on."""
    ids = np.zeros((n, Q), np.int32)
    for i in range(n):
        ids[i] = ([1 + (i % 4), 2 + (i % 4)] * Q)[:Q]
    return ids, np.ones((n, Q), np.int32)


def is_jax(engine) -> bool:
    return type(engine).__module__.startswith("trlx_tpu.")


def drive_rows(engine, ids, mask, key, pool=None, pump=False):
    """Run a prompt set through ``engine``; returns ``{row: fields}``.
    ``key`` seeds the JAX engine's phase, and the port's draws are the JAX
    engine's under it. ``pool`` (a ``PrefixBlockPool`` of the engine's
    package) plans sharing per admission wave, a later wave reading the
    blocks an earlier one published once ready; ``pump`` drives through
    the serving ``pump()`` instead of ``drive()``."""
    N = ids.shape[0]
    if is_jax(engine):
        engine.start_phase(jax_model_and_params()[2], key)
    else:
        engine.start_phase(0)
        engine.noise_fn = lambda rows, steps: engine_noise(key, rows, steps, VOCAB)
    published_by_row = {}

    def on_admitted(rows):
        for row in rows:
            blocks = published_by_row.pop(row, None)
            if blocks:
                pool.mark_ready(blocks)

    engine._admit_listener = on_admitted if pool is not None else None
    got = {}

    def land(group):
        arrs = {k: np.asarray(group[k]) for k in FIELDS}
        for j, r in enumerate(group["rows"]):
            assert r not in got, "row harvested twice"
            got[r] = {k: v[j] for k, v in arrs.items()}
            if pool is not None:
                pool.release(acquired.pop(r))

    acquired = {}
    try:
        if pool is None and not pump:
            engine.submit(ids, mask)
            for group in engine.drive(N):
                land(group)
            return got
        fed = 0
        while len(got) < N:
            free = engine.free_capacity
            if fed < N and free > 0:
                take = min(free, engine.admit_width, N - fed)
                shared_maps = publish_maps = None
                if pool is not None:
                    plans = [pool.plan_admission(ids[i], mask[i]) for i in range(fed, fed + take)]
                    shared_maps = np.stack([p.shared_map for p in plans])
                    publish_maps = np.stack([p.publish_map for p in plans])
                rows = engine.submit(ids[fed:fed + take], mask[fed:fed + take],
                                     shared_maps=shared_maps, publish_maps=publish_maps)
                if pool is not None:
                    for row, plan in zip(rows, plans):
                        acquired[row] = plan.acquired
                        if plan.published:
                            published_by_row[row] = plan.published
                fed += take
            for group in engine.pump():
                land(group)
        return got
    finally:
        engine._admit_listener = None
        if not is_jax(engine):
            engine.noise_fn = None


def assert_rows_match(got, want, atol=1e-5):
    """Tokens and masks exact, logprobs and values to ``atol``."""
    assert set(got) == set(want)
    for r in want:
        for k in ("tokens", "response_mask"):
            np.testing.assert_array_equal(got[r][k], want[r][k], err_msg=f"row {r} {k}")
        for k in ("logprobs", "values"):
            np.testing.assert_allclose(got[r][k], want[r][k], atol=atol, rtol=0,
                                       err_msg=f"row {r} {k}")
