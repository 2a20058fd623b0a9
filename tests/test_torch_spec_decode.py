"""Speculative decoding in the port, held against the JAX package's.

- The drafters: :class:`NGramDrafter` and :class:`TrieDrafter` fed the
  same operation sequences as the JAX ones (the units of
  ``tests/test_spec_decode.py``, the accept-rate degrade and probe, and
  random token streams over a random trie), their drafts and stats equal.
- ``accept_drafts`` against the JAX function on seeded logits, with the
  port handed the Gumbel noise of the JAX per-row keys: tokens and accept
  masks exact, logprobs and values 1e-6.
- The engine: spec on against spec off in the port (tokens and masks
  exact, logprobs and values 1e-5: the verify forward's wider matmuls may
  round differently from the one-token step's), an all-rejecting drafter
  still progressing, and the port's spec engine against the JAX spec
  engine under the JAX draws (rows at 1e-5, the spec counters equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import trlx_tpu.serving.spec_drafter as jax_drafter
import trlx_tpu_torch.serving.spec_drafter as port_drafter
from _torch_engines import (
    assert_rows_match,
    draftable_prompts,
    drive_rows,
    jax_engine,
    port_engine,
)
from _torch_ppo_phase import per_row_noise

# ------------------------------ drafters ------------------------------ #


def _ngram_units(mod):
    out = []
    d = mod.NGramDrafter(max_draft=4)
    d.observe_context(0, [5, 6, 7, 8, 5, 6, 7])
    out.append(d.draft(0))
    d.observe_tokens(0, [9])
    out += [d.draft(0), d.draft(1)]
    d.forget(0)
    out.append(d.draft(0))
    d = mod.NGramDrafter(max_draft=2)
    d.observe_context(0, [1, 2, 3, 4, 5, 1, 2])
    out.append(d.draft(0))
    return out, d.stats()


def _ewma_degrade_and_probe(mod):
    d = mod.NGramDrafter(max_draft=2, min_accept_ewma=0.4, ewma_alpha=0.5)
    d.observe_context(0, [1, 2, 3, 1, 2])
    d.set_tenant(0, "acme")
    out = [d.draft(0)]
    for _ in range(8):
        d.observe_accept(0, 2, 0)
    out.append(d.accept_ewma("acme"))
    out += [d.draft(0) for _ in range(mod.DEGRADE_PROBE_EVERY)]
    for _ in range(8):
        d.observe_accept(0, 2, 2)
    out += [d.accept_ewma("acme"), d.draft(0)]
    # another tenant is untouched; reset keeps the EWMAs, drops histories
    d.observe_context(1, [4, 4, 4])
    d.set_tenant(1, "beta")
    out += [d.draft(1), d.accept_ewma("beta")]
    d.reset()
    out += [d.draft(0), d.accept_ewma("acme")]
    return out, d.stats()


def _trie_units(mod, pool_mod):
    out = []
    pool = pool_mod.PrefixBlockPool(pool_blocks=8, block_size=4, n_blocks=2)
    plan = pool.plan_admission(np.asarray([3, 4, 5, 6, 7, 8, 9, 10]), np.ones(8, np.int32))
    pool.mark_ready(plan.published)
    d = mod.TrieDrafter(pool=pool, max_draft=3)
    d.observe_context(0, [1, 2, 3, 4, 5])
    out += [d.draft(0), d.trie_hits]
    d.observe_context(1, [3, 4, 5, 9, 3, 4, 5])
    out += [d.draft(1), d.trie_hits]  # own history wins over the chain
    d.observe_context(2, [11, 12, 13])
    out.append(d.draft(2))
    pool.plan_admission(np.asarray([11, 12, 13, 14, 1, 1, 1, 1]), np.ones(8, np.int32))
    out += [d.draft(2), pool.ready_chains()]  # not ready: not a corpus
    return out, d.stats()


@pytest.mark.parametrize("scenario", ["ngram_units", "ewma_degrade_and_probe", "trie_units"])
def test_drafter_units_match_jax(scenario):
    import trlx_tpu.serving.prefix_cache as jax_pool
    import trlx_tpu_torch.serving.prefix_cache as port_pool

    runs = {
        "ngram_units": lambda mod, _: _ngram_units(mod),
        "ewma_degrade_and_probe": lambda mod, _: _ewma_degrade_and_probe(mod),
        "trie_units": _trie_units,
    }[scenario]
    want = runs(jax_drafter, jax_pool)
    got = runs(port_drafter, port_pool)
    assert got == want
    if scenario == "trie_units":
        assert got[0][0] == [6, 7, 8] and got[0][2] == [9, 3, 4]


@pytest.mark.parametrize("max_draft,min_ngram,max_ngram", [(4, 2, 4), (2, 1, 3), (3, 3, 3)])
def test_ngram_drafter_random_streams_match_jax(max_draft, min_ngram, max_ngram):
    """Rows fed random chunks of a small alphabet (so n-grams recur, also
    overlapping ones), forgotten and re-seeded now and then: every draw of
    the port's indexed self-lookup equals the JAX drafter's scan."""
    rng = np.random.default_rng(max_draft + 10 * min_ngram)
    ops = [(int(rng.integers(3)), int(rng.integers(4)), rng.integers(0, 4, int(rng.integers(1, 5))))
           for _ in range(300)]
    logs = []
    for mod in (jax_drafter, port_drafter):
        d = mod.NGramDrafter(max_draft=max_draft, min_ngram=min_ngram, max_ngram=max_ngram)
        log = []
        for kind, row, toks in ops:
            toks = [int(t) for t in toks]
            if kind == 0 and row % 2:
                d.observe_context(row, toks)
            elif kind == 0:
                d.forget(row)
            else:
                d.observe_tokens(row, toks)
            log.append([d.draft(r) for r in range(4)])
        log.append(d.stats())
        logs.append(log)
    assert logs[1] == logs[0]
    assert logs[1][-1]["spec_drafter/hits"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trie_drafter_random_streams_match_jax(seed):
    """Random rows over a random trie (a few prefix families, so chains
    nest and several match with continuations of different depth): every
    draw of the port's indexed trie lookup equals the JAX drafter's scan,
    also while blocks turn ready and get evicted between draws."""
    import trlx_tpu.serving.prefix_cache as jax_pool
    import trlx_tpu_torch.serving.prefix_cache as port_pool

    rng = np.random.default_rng(seed)
    bs, nb = 4, 6
    families = rng.integers(0, 12, (3, 2 * bs))
    prompts = []
    for _ in range(24):
        p = rng.integers(0, 12, nb * bs)
        p[:2 * bs] = families[rng.integers(3)]
        prompts.append(p)
    ops = [(rng.integers(24), rng.integers(4), rng.integers(0, 12, int(rng.integers(1, 4))))
           for _ in range(120)]
    logs = []
    for mod, pool_mod in ((jax_drafter, jax_pool), (port_drafter, port_pool)):
        pool = pool_mod.PrefixBlockPool(10, bs, nb)
        d = mod.TrieDrafter(pool=pool, max_draft=4, min_ngram=2, max_ngram=3)
        held, log = [], []
        for row in range(4):
            d.observe_context(row, [row, row + 1])
        for i, (p, row, toks) in enumerate(ops):
            plan = pool.plan_admission(prompts[p], np.ones(nb * bs, np.int32))
            pool.mark_ready(plan.published)
            held.append(plan.acquired)
            if len(held) > 3:
                pool.release(held.pop(0))
            d.observe_tokens(int(row), [int(t) for t in toks])
            log.append((i, [d.draft(r) for r in range(4)], d.trie_hits))
        log.append(d.stats())
        logs.append(log)
    assert logs[1] == logs[0]
    assert logs[1][-1]["spec_drafter/trie_hits"] > 0


# ---------------------------- accept_drafts ---------------------------- #


@pytest.mark.parametrize("do_sample", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_accept_drafts_matches_jax(do_sample, seed):
    """Seeded logits whose rows are peaked at random targets (so drafts
    match often, and partly), a finished row, a short draft and the budget
    edge; the port's draws are the Gumbel noise of the JAX per-row keys at
    steps t0 + j."""
    import torch

    from trlx_tpu.ops.sampling import GenerationConfig as JGen
    from trlx_tpu.ops.sampling import accept_drafts as jax_accept
    from trlx_tpu.ops.sampling import make_row_keys

    from trlx_tpu_torch.ops.sampling import GenerationConfig, accept_drafts

    B, D, V = 6, 4, 32
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, 28, (B, D))
    logits = rng.normal(size=(B, D, V)).astype(np.float32)
    logits[np.arange(B)[:, None], np.arange(D)[None], targets] += 30.0
    values = rng.normal(size=(B, D)).astype(np.float32)
    draft = targets.copy()
    draft[1, 2] = (draft[1, 2] + 1) % 28  # a mismatch mid-draft
    draft[2, 0] = (draft[2, 0] + 1) % 28  # rejected at once
    lens = np.asarray([4, 4, 4, 2, 4, 4])
    t0 = np.asarray([0, 1, 2, 3, 5, 6])  # row 5 runs into the budget (R = 8)
    finished = np.asarray([False, False, False, False, True, False])
    n_real = np.full((B,), 4)
    kw = dict(max_new_tokens=8, eos_token_id=30, pad_token_id=31, do_sample=do_sample)
    keys = make_row_keys(jax.random.PRNGKey(seed), np.arange(B))
    want = jax_accept(
        JGen(**kw, per_row_rng=True), jnp.asarray(logits), jnp.asarray(values),
        jnp.asarray(t0, jnp.int32), jnp.asarray(finished), jnp.asarray(~finished),
        jnp.asarray(n_real, jnp.int32), jnp.asarray(draft, jnp.int32),
        jnp.asarray(lens, jnp.int32), keys, budget=8,
    )
    noise = None
    if do_sample:
        noise = torch.stack([per_row_noise(np.asarray(keys), t0 + j, V)
                             for j in range(1, D + 1)], dim=1)
    got = accept_drafts(
        GenerationConfig(**kw), torch.from_numpy(logits), torch.from_numpy(values),
        torch.from_numpy(t0), torch.from_numpy(finished), torch.from_numpy(~finished),
        torch.from_numpy(n_real), torch.from_numpy(draft), torch.from_numpy(lens),
        noise=noise, budget=8,
    )
    w_toks, w_acc, w_lps, w_vals, w_n, w_fin = (np.asarray(x) for x in want)
    g_toks, g_acc, g_lps, g_vals, g_n, g_fin = (x.numpy() for x in got)
    np.testing.assert_array_equal(g_toks, w_toks)
    np.testing.assert_array_equal(g_acc, w_acc)
    np.testing.assert_array_equal(g_n, w_n)
    np.testing.assert_array_equal(g_fin, w_fin)
    np.testing.assert_allclose(g_lps, w_lps, atol=1e-6, rtol=0)
    np.testing.assert_allclose(g_vals, w_vals, atol=1e-6, rtol=0)
    assert 0 < g_n.sum() < B * D and g_n[4] == 0


# ------------------------------- engine -------------------------------- #


@pytest.mark.parametrize("do_sample", [True, False])
def test_spec_engine_matches_spec_off(do_sample):
    """Spec on and off decode the same rows, and every counter of the
    verify steps adds up; greedy rows (which repeat themselves on these
    random weights) accept drafts and so take fewer steps."""
    off = port_engine(do_sample=do_sample)
    on = port_engine(spec_max_draft=3, do_sample=do_sample)
    ids, mask = draftable_prompts(8)
    key = jax.random.PRNGKey(42)
    want = drive_rows(off, ids, mask, key)
    got = drive_rows(on, ids, mask, key)
    assert_rows_match(got, want)
    st = on.stats
    assert st.spec_steps >= 1 and st.spec_drafted > 0
    if not do_sample:
        assert st.spec_accepted > 0 and st.decode_steps < off.stats.decode_steps
    assert len(st.spec_draft_lens) == st.spec_row_steps
    d = st.to_dict()
    assert d["engine/spec_tokens_per_step"] >= 1.0
    assert 0 <= d["engine/spec_accept_rate"] <= 1


class JunkDrafter:
    """Proposes pad tokens every step: near-certain rejection."""

    def __init__(self, token=63, n=3):
        self.token, self.n = token, n

    def draft(self, row):
        return [self.token] * self.n

    def observe_context(self, row, tokens):
        pass

    def observe_tokens(self, row, tokens):
        pass

    def observe_accept(self, row, n_proposed, n_accepted):
        pass

    def forget(self, row):
        pass

    def reset(self):
        pass


def test_all_rejected_still_progresses():
    """Every verify step commits at least the anchor of each live row, so a
    drafter that is always wrong slows decode to one token a step but never
    stalls or changes it."""
    off, on = port_engine(), port_engine(spec_max_draft=3)
    saved = on.spec_drafter
    on.spec_drafter = JunkDrafter()
    try:
        rng = np.random.default_rng(5)
        ids = rng.integers(1, 60, (8, 16)).astype(np.int32)
        mask = np.ones_like(ids)
        key = jax.random.PRNGKey(3)
        want = drive_rows(off, ids, mask, key)
        got = drive_rows(on, ids, mask, key)
    finally:
        on.spec_drafter = saved
    assert_rows_match(got, want)
    st = on.stats
    assert st.spec_steps == st.decode_steps
    assert st.spec_drafted > 0 and st.spec_accepted < st.spec_drafted / 10


@pytest.mark.parametrize("prompts", ["draftable", "random"])
def test_spec_engine_matches_the_jax_spec_engine(prompts):
    jeng, peng = jax_engine(spec_max_draft=3), port_engine(spec_max_draft=3)
    if prompts == "draftable":
        ids, mask = draftable_prompts(8)
    else:
        rng = np.random.default_rng(8)
        ids = rng.integers(1, 8, (8, 16)).astype(np.int32)  # a small alphabet repeats
        mask = np.ones_like(ids)
    key = jax.random.PRNGKey(19)
    want = drive_rows(jeng, ids, mask, key)
    got = drive_rows(peng, ids, mask, key)
    assert_rows_match(got, want)
    for name in ("decode_steps", "spec_steps", "spec_row_steps", "spec_drafted",
                 "spec_accepted", "spec_draft_lens"):
        assert getattr(peng.stats, name) == getattr(jeng.stats, name), name
    assert peng.stats.spec_steps > 0


def test_greedy_spec_engine_matches_the_jax_one():
    """Greedy decoding (how deterministic requests are served) drafts from
    repeats of the policy's own output."""
    jeng = jax_engine(spec_max_draft=3, do_sample=False)
    peng = port_engine(spec_max_draft=3, do_sample=False)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 60, (8, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    key = jax.random.PRNGKey(0)
    want = drive_rows(jeng, ids, mask, key)
    got = drive_rows(peng, ids, mask, key)
    assert_rows_match(got, want)
    for name in ("decode_steps", "spec_steps", "spec_drafted", "spec_accepted"):
        assert getattr(peng.stats, name) == getattr(jeng.stats, name), name
