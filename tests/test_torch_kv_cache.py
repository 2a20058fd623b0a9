"""The port's paged KV cache against the JAX package's, exactly.

Same pool contents, block tables (rotated, as a recycled slot gets them)
and new K/V rows go through ``paged_write_read`` in both packages; the
returned logical views and the updated pools must be bit-identical,
including rows parked at the out-of-bounds discard sentinel (the port's
pool carries one extra trailing position where those writes land).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.inference import kv_cache as jkv
from trlx_tpu_torch.inference import kv_cache as tkv

B, CAP, H, D, BS = 3, 24, 2, 4, 4
NB = CAP // BS


def _pools(rng):
    k = rng.normal(size=(B, CAP, H, D)).astype(np.float32)
    v = rng.normal(size=(B, CAP, H, D)).astype(np.float32)
    return k, v


def _tables(turns):
    base = np.arange(NB, dtype=np.int32)
    return np.stack([np.roll(base, -t) for t in turns]).astype(np.int32)


def _run_both(k_pool, v_pool, tables, k_new, v_new, index, view_len=0):
    jcache = {"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool),
              "block_tables": jnp.asarray(tables)}
    jk, jv, jnew = jkv.paged_write_read(
        jcache, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(index),
        jnp.float32, view_len=view_len,
    )
    pad = np.zeros((B, 1, H, D), np.float32)
    tcache = {
        "k": torch.from_numpy(np.concatenate([k_pool, pad], 1)),
        "v": torch.from_numpy(np.concatenate([v_pool, pad], 1)),
        "block_tables": torch.from_numpy(tables),
    }
    tk, tv = tkv.paged_write_read(
        tcache, torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(np.asarray(index)), torch.float32, view_len=view_len,
    )
    return (jk, jv, jnew), (tk, tv, tcache)


@pytest.mark.parametrize(
    "case",
    ["decode_oob_rows", "prefill_scalar_index", "narrowed_view", "per_column", "past_capacity"],
)
def test_paged_write_read_matches_jax_exactly(case):
    rng = np.random.default_rng(len(case))
    k_pool, v_pool = _pools(rng)
    tables = _tables([0, 2, 5])
    view_len = 0
    if case == "decode_oob_rows":
        T, index = 1, np.array([7, CAP, 13], np.int32)  # row 1 parked OOB
    elif case == "prefill_scalar_index":
        T, index = 10, np.int32(0)
    elif case == "narrowed_view":
        T, index, view_len = 4, np.int32(4), 12
    elif case == "per_column":
        T = 3
        index = np.array([[5, 6, CAP], [0, 1, 2], [CAP, CAP, CAP]], np.int32)
    else:  # a window that runs past capacity: the overflow drops
        T, index = 4, np.array([CAP - 2, 0, CAP - 1], np.int32)
    k_new = rng.normal(size=(B, T, H, D)).astype(np.float32)
    v_new = rng.normal(size=(B, T, H, D)).astype(np.float32)
    (jk, jv, jnew), (tk, tv, tcache) = _run_both(
        k_pool, v_pool, tables, k_new, v_new, index, view_len
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tcache["k"][:, :CAP].numpy(), np.asarray(jnew["k"]))
    np.testing.assert_array_equal(tcache["v"][:, :CAP].numpy(), np.asarray(jnew["v"]))


def test_slot_indexed_write_matches_jax_slice_and_merge():
    """The port's admission prefill writes straight into the admitted slots
    of the full pool (``cache["slots"]``); the JAX engine slices those
    slots out, writes, and merges back. Same pool afterwards."""
    rng = np.random.default_rng(7)
    k_pool, v_pool = _pools(rng)
    slots = np.array([2, 0])
    tables = _tables([1, 3])
    T = 6
    k_new = rng.normal(size=(2, T, H, D)).astype(np.float32)
    v_new = rng.normal(size=(2, T, H, D)).astype(np.float32)
    jcache = {"k": jnp.asarray(k_pool[slots]), "v": jnp.asarray(v_pool[slots]),
              "block_tables": jnp.asarray(tables)}
    jk, _, jnew = jkv.paged_write_read(
        jcache, jnp.asarray(k_new), jnp.asarray(v_new), 0, jnp.float32
    )
    merged = k_pool.copy()
    merged[slots] = np.asarray(jnew["k"])
    pad = np.zeros((B, 1, H, D), np.float32)
    tcache = {
        "k": torch.from_numpy(np.concatenate([k_pool, pad], 1)),
        "v": torch.from_numpy(np.concatenate([v_pool, pad], 1)),
        "block_tables": torch.from_numpy(tables),
        "slots": torch.from_numpy(slots),
    }
    tk, _ = tkv.paged_write_read(
        tcache, torch.from_numpy(k_new), torch.from_numpy(v_new), 0, torch.float32
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tcache["k"][:, :CAP].numpy(), merged)


@pytest.mark.parametrize("turns", [0, 1, 5, 8])
def test_table_helpers_match_jax(turns):
    table = _tables([0])[0]
    np.testing.assert_array_equal(
        tkv.rotate_block_table(torch.from_numpy(table), turns).numpy(),
        np.asarray(jkv.rotate_block_table(jnp.asarray(table), turns)),
    )
    tables = _tables([turns, 2 * turns, 1])
    np.testing.assert_array_equal(
        tkv.logical_view_index(torch.from_numpy(tables), CAP).numpy(),
        np.asarray(jkv.logical_view_index(jnp.asarray(tables), CAP)),
    )
    pos = np.array([[0, 3, 4, CAP - 1], [CAP, CAP + 3, -1, 9], [5, 6, 7, 8]], np.int32)
    np.testing.assert_array_equal(
        tkv.physical_positions(torch.from_numpy(tables), torch.from_numpy(pos), CAP).numpy(),
        np.asarray(jkv.physical_positions(jnp.asarray(tables), jnp.asarray(pos), CAP)),
    )


@pytest.mark.parametrize("capacity,requested", [(576, 16), (70, 16), (13, 4), (8, 100)])
def test_choose_block_size_matches_jax(capacity, requested):
    assert tkv.choose_block_size(capacity, requested) == jkv.choose_block_size(
        capacity, requested
    )


def test_init_paged_cache_layout():
    cache = tkv.init_paged_cache(2, 3, 20, 2, 4, torch.float32, block_size=8)
    assert len(cache) == 2
    assert cache[0]["k"].shape == (3, 21, 2, 4)  # + the discard position
    assert cache[0]["block_tables"].shape == (3, 4)  # block size 8 -> 5
    assert cache[0]["block_tables"] is cache[1]["block_tables"]
    # an int8 cache: int8 values and bf16 scales, the discard position too
    int8 = tkv.init_paged_cache(1, 3, 20, 2, 4, torch.float32, kv_cache_dtype="int8")[0]
    assert int8["k"].shape == (3, 21, 2, 4) and int8["k"].dtype == torch.int8
    assert int8["v_scale"].shape == (3, 21, 2, 1) and int8["v_scale"].dtype == torch.bfloat16
