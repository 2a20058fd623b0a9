"""Chunked admission prefill (``rollout.prefill_chunk``) in the port, held
against the JAX package's and against the port's monolithic prefill.

Engines: ``tests/_torch_engines.py``'s tiny f32 GPT-2 in both packages
(Q = 16, R = 8, 4 slots, admit 2, block 4, chunks of 4), the port's handed
the JAX engine's per-row draws. Tolerances: tokens and masks exact;
logprobs and values 1e-5 (the chunked forward attends a prompt-wide view,
so its sums run over fewer, exactly-zero-weighted columns than the
monolithic one's; the reference's own chunked and monolithic prefill
differ by up to 4.8e-7 on this tier). Host arithmetic (the chunk width,
the chunk plan, the FLOP price) is compared exactly.
"""

import jax
import numpy as np
import pytest

from _torch_engines import (
    Q,
    assert_rows_match,
    drive_rows,
    jax_engine,
    jax_model_and_params,
    mixed_prompts,
    port_engine,
    shared_prompts,
)


@pytest.mark.parametrize("q,requested,block", [
    (64, 16, 16), (64, 20, 16), (8, 4, 2), (8, 4, 14), (8, 64, 2), (64, 0, 16),
    (64, -1, 16), (512, 128, 16), (12, 5, 4), (7, 3, 1),
])
def test_choose_prefill_chunk_matches_jax(q, requested, block):
    from trlx_tpu.inference.kv_cache import choose_prefill_chunk as jax_choose

    from trlx_tpu_torch.inference.kv_cache import choose_prefill_chunk

    assert choose_prefill_chunk(q, requested, block) == jax_choose(q, requested, block)


def _plans(seed):
    """Per case: a prompt mask and, with sharing, a pool plan per row."""
    from trlx_tpu.serving.prefix_cache import PrefixBlockPool

    ids, mask = mixed_prompts(2, seed=seed, lo=1, hi=Q, sort=False)
    pool = PrefixBlockPool(8, 4, 6)
    first = pool.plan_admission(ids[0], mask[0])
    pool.mark_ready(first.published)
    plans = [first, pool.plan_admission(ids[0], mask[0])]
    return mask, np.stack([p.shared_map for p in plans]), np.stack([p.publish_map for p in plans])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("sharing", [False, True])
def test_plan_chunk_need_matches_jax(seed, sharing):
    mask, shared, publish = _plans(seed)
    jeng, peng = jax_engine(4, pool_blocks=8), port_engine(4, pool_blocks=8)
    args = (mask, shared, publish) if sharing else (mask, None, None)
    want = jeng._plan_chunk_need(*args)
    got = peng._plan_chunk_need(*args)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (Q // 4,)


def test_chunk_flop_cost_matches_jax():
    """The price of one skipped chunk: the JAX engine reads it off its
    traced chunk program; the port computes the same dot-FLOPs."""
    from trlx_tpu_torch.inference.engine import prefill_dot_flops

    jeng, peng = jax_engine(4), port_engine(4)
    jeng.start_phase(jax_model_and_params()[2], jax.random.PRNGKey(0))
    want = jeng._chunk_flop_cost()
    assert want > 0
    assert peng._chunk_flop_cost() == want
    # the chunked pair costs less than the monolithic prefill at this shape
    cfg = peng.model_config
    A, W, cap = peng.admit_width, peng.prefill_chunk, peng.capacity
    chunked = (Q // W - 1) * want + prefill_dot_flops(cfg, A, W, Q, heads=True)
    assert chunked < prefill_dot_flops(cfg, A, Q, cap, heads=True)


def test_chunked_matches_monolithic_mixed_lengths():
    """Chunked against monolithic in the port, on mixed-length prompts
    whose shortest groups skip their leading pad chunks (never launched:
    their cache positions keep what they held, and every read of them is
    masked)."""
    mono, chunked = port_engine(0), port_engine(4)
    ids, mask = mixed_prompts(8, seed=3)
    key = jax.random.PRNGKey(7)
    want = drive_rows(mono, ids, mask, key)
    got = drive_rows(chunked, ids, mask, key)
    assert_rows_match(got, want)
    st = chunked.stats
    assert st.prefill_chunks > 0 and st.prefill_cols_skipped > 0
    assert st.prefill_flops_saved > 0
    assert mono.stats.prefill_chunks == 0


def test_all_rows_shorter_than_one_chunk():
    """Every row of every group fits in the final chunk: each group runs
    only its finish chunk, and the rows still match the monolithic
    prefill's."""
    mono, chunked = port_engine(0), port_engine(4)
    ids, mask = mixed_prompts(4, seed=9, lo=1, hi=3, sort=False)
    key = jax.random.PRNGKey(13)
    want = drive_rows(mono, ids, mask, key)
    got = drive_rows(chunked, ids, mask, key)
    assert_rows_match(got, want)
    st = chunked.stats
    n_scan = chunked.n_prefill_chunks - 1
    assert st.prefill_chunks == st.prefills == 2
    assert st.prefill_cols_skipped == st.prefills * n_scan * chunked.prefill_chunk


def test_chunked_sharing_matches_monolithic():
    """Sharing on: pool-covered blocks are gathered, never recomputed, and
    the rows equal the monolithic sharing engine's and the unshared
    engine's."""
    from trlx_tpu_torch.serving.prefix_cache import PrefixBlockPool

    mono, mono_sh, chunked_sh = port_engine(0), port_engine(0, 16), port_engine(4, 16)
    ids, mask = shared_prompts(8)
    key = jax.random.PRNGKey(5)
    want = drive_rows(mono, ids, mask, key)
    for engine in (mono_sh, chunked_sh):
        pool = PrefixBlockPool(16, engine.block_size, engine.n_blocks)
        assert_rows_match(drive_rows(engine, ids, mask, key, pool=pool), want)
        assert all(n.refcount == 0 for n in pool._nodes.values())
    st = chunked_sh.stats
    assert st.prefix_hit_blocks > 0 and st.prefill_cols_skipped > 0
    assert st.prefill_flops_saved > 0


@pytest.mark.parametrize("prompts", ["mixed", "shared"])
def test_chunked_engine_matches_the_jax_chunked_engine(prompts):
    """The port's chunked engine (with the prefix pool on shared prompts)
    against the JAX package's, under the JAX engine's draws: the same rows,
    the same chunk plan and sharing counters."""
    from trlx_tpu.serving.prefix_cache import PrefixBlockPool as JPool

    from trlx_tpu_torch.serving.prefix_cache import PrefixBlockPool

    pool_blocks = 16 if prompts == "shared" else 0
    jeng, peng = jax_engine(4, pool_blocks), port_engine(4, pool_blocks)
    if prompts == "shared":
        ids, mask = shared_prompts(8, seed=4, prefixes=2)
    else:
        ids, mask = mixed_prompts(8, seed=12)
    key = jax.random.PRNGKey(21)
    pools = [None, None]
    if pool_blocks:
        pools = [cls(pool_blocks, jeng.block_size, jeng.n_blocks) for cls in (JPool, PrefixBlockPool)]
    want = drive_rows(jeng, ids, mask, key, pool=pools[0])
    got = drive_rows(peng, ids, mask, key, pool=pools[1])
    assert_rows_match(got, want)
    for name in ("prefills", "prefill_chunks", "prefill_cols_skipped", "decode_steps",
                 "prefix_lookup_blocks", "prefix_hit_blocks", "prefix_published_blocks"):
        assert getattr(peng.stats, name) == getattr(jeng.stats, name), name
    if pool_blocks:
        assert peng.stats.prefix_hit_blocks > 0
        assert pools[1].stats() == pools[0].stats()


def test_pump_chunk_budget_interleaves_decode():
    """One chunk forward per pump: an admission burst's prefill spreads over
    pump iterations with decode steps between them, the rows unchanged."""
    chunked, budgeted = port_engine(4), port_engine(4, chunks_per_pump=1)
    ids, mask = mixed_prompts(8, seed=21, lo=Q, hi=Q)  # all full length
    key = jax.random.PRNGKey(17)
    want = drive_rows(chunked, ids, mask, key, pump=True)
    got = drive_rows(budgeted, ids, mask, key, pump=True)
    assert_rows_match(got, want)
    assert budgeted.stats.prefill_chunks == chunked.stats.prefill_chunks
    assert budgeted.stats.decode_steps > chunked.stats.decode_steps
    # mid-admission: a budgeted pump leaves the group in flight
    budgeted.start_phase(0)
    budgeted.submit(ids[:2], mask[:2])
    budgeted.pump()
    assert budgeted._inflight_admission is not None
    while budgeted._inflight_admission is not None:
        budgeted.pump()
    assert budgeted.stats.prefills == 1


def test_budgeted_pump_matches_the_jax_budgeted_pump():
    jeng, peng = jax_engine(4, chunks_per_pump=1), port_engine(4, chunks_per_pump=1)
    ids, mask = mixed_prompts(8, seed=22, lo=6)
    key = jax.random.PRNGKey(23)
    want = drive_rows(jeng, ids, mask, key, pump=True)
    got = drive_rows(peng, ids, mask, key, pump=True)
    assert_rows_match(got, want)
    for name in ("prefill_chunks", "prefill_cols_skipped", "decode_steps"):
        assert getattr(peng.stats, name) == getattr(jeng.stats, name), name


@pytest.mark.parametrize("spec", [0, 3])
def test_budgeted_pump_streams_only_the_rows_tokens(spec):
    """While a budgeted admission is in flight, decode steps run for the
    other slots. A slot whose last row ran to its token budget (without
    eos) is harvested unfinished, and the row being admitted into it must
    not be streamed, or drafted from, what that stale slot emits: every
    row's streamed tokens (and, with spec decode, its drafter history) are
    exactly its harvested tokens."""
    engine = port_engine(4, chunks_per_pump=1, spec_max_draft=spec, do_sample=False)
    ids, mask = mixed_prompts(12, seed=31, lo=Q, hi=Q)
    streamed = {}
    histories = {}
    drafter = engine.spec_drafter
    if drafter is not None:
        forget = drafter.forget

        def record(row):
            histories[row] = list(drafter._hist.get(row, []))
            forget(row)

        drafter.forget = record
    engine.token_sink = lambda emitted: [streamed.setdefault(r, []).append(t)
                                         for r, t in emitted.items()]
    try:
        got = drive_rows(engine, ids, mask, jax.random.PRNGKey(0), pump=True)
    finally:
        engine.token_sink = None
        if drafter is not None:
            drafter.forget = forget
    assert any(int(got[r]["response_mask"].sum()) == 8 for r in got)  # budget-ended rows
    for r, row in got.items():
        n = int(row["response_mask"].sum())
        assert streamed.get(r, []) == list(row["tokens"][:n]), f"row {r}"
        if drafter is not None:
            real = [int(t) for t in ids[r][mask[r].astype(bool)]]
            assert histories[r] == real + list(row["tokens"][:n]), f"row {r}"
