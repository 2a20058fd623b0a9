"""Paged/block KV cache for the continuous-batching engine (counterpart of
:mod:`trlx_tpu.inference.kv_cache`).

Physical storage keeps per-slot regions of ``capacity`` positions (the
fixed cache's ``[B, capacity, H, Dh]`` layout), and a per-slot **block
table** maps logical block ``j`` to a physical block of the slot's region.
Writes and reads both resolve through the table; reads gather the slot's
**logical view**, so attention over the paged cache is the computation the
fixed cache runs (a gather permutes, it never re-associates a sum).

The JAX package drops out-of-bounds scatter writes (position ``capacity``
is the "discard this write" sentinel of idle and finished slots). PyTorch
has no dropping scatter, so each physical region carries one extra
trailing position, ``capacity``, where discarded writes land; no read ever
gathers it. The port writes in place where the JAX package returns
updated buffers.

**Cross-request prefix sharing** (the serving tier,
:mod:`trlx_tpu_torch.serving.prefix_cache`): an engine built with a prefix
pool gives each layer a flat pool ``shared_k``/``shared_v`` of
``pool_blocks * block_size`` positions (plus one discard position, as the
per-slot regions), and per-slot ``shared_tables`` (logical block ``j``
READS from pool block ``shared_tables[b, j]`` when ``>= 0``) and, during
admission prefill, ``publish_tables`` (prefill WRITES logical block ``j``
into pool block ``publish_tables[b, j]`` when ``>= 0``). Private writes
to shared columns are dropped, and the view is overlaid from the pool
after the writes, so a publisher reads its own just-written bits. A
shared block's bits are the donor's, which equal what the reader's own
prefill would compute for the same leading ``(ids, mask)`` columns; the
read side is a gather.

``kv_cache_dtype`` is honoured as in the linear cache
(``models/gpt2.py::kv_buffers``): an int8 cache, and its pool, hold int8
values and per-(position, head) bf16 scales (``*_scale`` keys). One launch
quantizes a step's K and V and stores values and scales at their physical
rows, and at their pool rows when the step publishes
(:func:`~trlx_tpu_torch.ops.kv_quant.quantized_write`); the view is
gathered and overlaid as int8 values and scales, which attention reads as
they are (:class:`~trlx_tpu_torch.ops.attention.QuantizedKV`). The int8
paged and linear caches hold identical bits per logical position.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def choose_block_size(capacity: int, requested: int) -> int:
    """Largest divisor of ``capacity`` that is <= ``requested`` (the logical
    view must be exactly ``capacity`` wide)."""
    if capacity < 1:
        raise ValueError(f"cache capacity must be >= 1, got {capacity}")
    bs = max(1, min(int(requested), capacity))
    while capacity % bs:
        bs -= 1
    return bs


def choose_prefill_chunk(query_length: int, requested: int, block_size: int) -> int:
    """Effective chunked-prefill width for ``rollout.prefill_chunk``: the
    largest divisor of ``query_length`` that is ``<= requested`` and a
    ``block_size`` multiple (a pool-covered block is then never split
    across a run/skip boundary), else the largest plain divisor (skip
    decisions are column-granular, so only the skipping's efficiency
    depends on alignment). ``requested <= 0`` disables chunking."""
    if requested <= 0:
        return 0
    hi = min(int(requested), int(query_length))
    fallback = 1
    for w in range(hi, 0, -1):
        if query_length % w:
            continue
        if w % block_size == 0:
            return w
        if fallback == 1:
            fallback = w
    return fallback


def identity_block_tables(n_slots: int, n_blocks: int, device=None) -> torch.Tensor:
    """[B, n_blocks] int32 identity mapping (fresh slots)."""
    return (
        torch.arange(n_blocks, dtype=torch.int32, device=device)[None, :]
        .expand(n_slots, n_blocks)
        .contiguous()
    )


def rotate_block_table(table: torch.Tensor, turns: int) -> torch.Tensor:
    """Rotate a table by ``turns`` blocks along its last axis (the engine
    hands a recycled slot a rotated table, so block-table resolution is
    exercised on every recycle)."""
    n = table.shape[-1]
    k = int(turns) % n
    if k == 0:
        return table
    return torch.cat([table[..., k:], table[..., :k]], dim=-1)


def init_paged_cache(
    n_layer: int,
    n_slots: int,
    capacity: int,
    n_head: int,
    head_dim: int,
    dtype,
    kv_cache_dtype: str = "bfloat16",
    block_size: int = 16,
    device=None,
) -> List[Dict[str, torch.Tensor]]:
    """Per-layer paged KV buffers ``[B, capacity + 1, H, Dh]`` (the extra
    position is the discard sentinel; an int8 cache adds its scales
    ``[B, capacity + 1, H, 1]``) plus ``"block_tables"``, whose presence
    routes ``models/gpt2.py::write_cache`` onto the paged path. One table
    tensor is shared by every layer; ``kv_cache_dtype`` resolves at
    ``capacity``."""
    from trlx_tpu_torch.models.gpt2 import kv_buffers

    bs = choose_block_size(capacity, block_size)
    tables = identity_block_tables(n_slots, capacity // bs, device)
    layers = kv_buffers(
        n_layer, n_slots, capacity, n_head, head_dim, dtype,
        kv_cache_dtype, device=device, extra_positions=1,
    )
    return [dict(layer, block_tables=tables) for layer in layers]


def empty_share_tables(n_slots: int, n_blocks: int, device=None) -> torch.Tensor:
    """[B, n_blocks] int32 all ``-1``: no block shared or published."""
    return torch.full((n_slots, n_blocks), -1, dtype=torch.int32, device=device)


def init_shared_pool(
    pool_blocks: int,
    block_size: int,
    n_head: int,
    head_dim: int,
    dtype,
    kv_cache_dtype: str = "bfloat16",
    device=None,
) -> Dict[str, torch.Tensor]:
    """Per-layer shared-prefix pool buffers ``[pool_blocks * block_size +
    1, H, Dh]`` in the private regions' layout (an ``"int8"`` pool carries
    bf16 scales ``[..., H, 1]`` as the int8 cache does); the last position
    is the discard sentinel of rows that publish nothing."""
    from trlx_tpu_torch.models.gpt2 import torch_dtype

    if pool_blocks < 1:
        raise ValueError(f"prefix pool needs >= 1 block, got {pool_blocks}")
    shape = (pool_blocks * block_size + 1, n_head, head_dim)
    if kv_cache_dtype == "int8":
        sshape = shape[:2] + (1,)
        return {
            "shared_k": torch.zeros(shape, dtype=torch.int8, device=device),
            "shared_v": torch.zeros(shape, dtype=torch.int8, device=device),
            "shared_k_scale": torch.zeros(sshape, dtype=torch.bfloat16, device=device),
            "shared_v_scale": torch.zeros(sshape, dtype=torch.bfloat16, device=device),
        }
    dt = torch_dtype(dtype)
    return {
        "shared_k": torch.zeros(shape, dtype=dt, device=device),
        "shared_v": torch.zeros(shape, dtype=dt, device=device),
    }


#: cache-dict keys of the shared-prefix pool (global, never indexed by
#: slot) and of the per-slot share metadata
SHARED_POOL_KEYS = ("shared_k", "shared_v", "shared_k_scale", "shared_v_scale")
SHARE_TABLE_KEYS = ("shared_tables", "publish_tables")


def physical_positions(
    block_tables: torch.Tensor,  # [B, n_blocks] int
    positions: torch.Tensor,  # [B, T] logical positions (may be >= capacity)
    capacity: int,
) -> torch.Tensor:
    """[B, T] physical positions; out-of-range logical positions map to
    ``capacity`` (the discard sentinel)."""
    n_blocks = block_tables.shape[-1]
    bs = capacity // n_blocks
    pos = positions.long()
    blk = (pos // bs).clamp(0, n_blocks - 1)
    phys = torch.gather(block_tables.long(), 1, blk) * bs + pos % bs
    # the table gather clamps: keep out-of-range positions out of range
    return torch.where((pos >= 0) & (pos < capacity), phys, capacity)


def logical_view_index(block_tables: torch.Tensor, capacity: int) -> torch.Tensor:
    """[B, capacity] gather index: physical position of each logical one."""
    n_blocks = block_tables.shape[-1]
    bs = capacity // n_blocks
    offs = torch.arange(bs, device=block_tables.device)[None, None, :]
    phys = block_tables.long()[:, :, None] * bs + offs
    return phys.reshape(block_tables.shape[0], capacity)


def _publish_rows(pool: torch.Tensor, pub_pos: torch.Tensor, rows: torch.Tensor) -> None:
    """Scatter ``rows`` [B, T, ...] into the flat shared pool at
    ``pub_pos`` [B, T] (in place); rows without a publish assignment land
    on the pool's discard sentinel. The host allocator never gives two
    rows the same block, so real writes do not collide."""
    pool[pub_pos.reshape(-1)] = rows.reshape((-1,) + rows.shape[2:]).to(pool.dtype)


def _shared_gather(
    shared_tables: torch.Tensor,  # [B, n_blocks] int, -1 = private
    pool: torch.Tensor,  # [pool positions + 1, H, Dh]
    capacity: int,
    view_len: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per logical position, the shared-pool value (garbage where the block
    is private) and the [B, width] bool mask of shared positions: the
    read-side overlay. ``view_len > 0`` narrows it to the leading
    ``view_len`` positions (shared blocks all lie in the prompt region)."""
    n_blocks = shared_tables.shape[-1]
    bs = capacity // n_blocks
    width = view_len if 0 < view_len < capacity else capacity
    cols = torch.arange(width, device=shared_tables.device)
    sh_blk = shared_tables.long()[:, cols // bs]  # [B, width]
    safe = (sh_blk * bs + cols[None, :] % bs).clamp(0, pool.shape[0] - 2)
    return pool[safe], sh_blk >= 0


def paged_write_read(
    cache_kv: Dict[str, torch.Tensor],
    k: torch.Tensor,  # [B, T, H, Dh] new keys
    v: torch.Tensor,
    cache_index,  # int / [B] logical base position, or [B, T] per column
    dtype,
    view_len: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the new K/V rows through the block table (in place; the
    discard sentinel absorbs out-of-range rows), then return the logical
    view ``(k_full, v_full)`` [B, view, H, Dh] for attention (on an int8
    cache two :class:`~trlx_tpu_torch.ops.attention.QuantizedKV`).

    ``cache_kv["slots"]`` (optional, [B] long) names the pool rows the B
    batch rows live in — the engine's admission prefill writes straight
    into the admitted slots of the full pool; without it row b is slot b.
    A [B, T] ``cache_index`` names each column's logical position (the
    verify step's drafted window parks its unused columns at
    ``capacity``, the discard sentinel). ``view_len > 0`` narrows the
    returned view (and the shared overlay); writes always resolve at full
    capacity.

    With ``shared_tables`` (the prefix pool), private writes to shared
    columns are dropped, ``publish_tables`` columns are also written into
    the pool, and shared positions of the view are read from the pool
    after all writes. Every pool op runs on the caller's stream, so a
    publishing prefill's scatter lands before a later group's gather."""
    B, T = k.shape[0], k.shape[1]
    pool_k, pool_v = cache_kv["k"], cache_kv["v"]
    capacity = pool_k.shape[1] - 1
    tables = cache_kv["block_tables"]
    dev = pool_k.device
    slots = cache_kv.get("slots")
    if slots is None:
        slots = torch.arange(B, device=dev)
    idx = torch.as_tensor(cache_index, device=dev).long()
    if idx.dim() == 2:
        positions = idx
    else:
        positions = idx.expand(B)[:, None] + torch.arange(T, device=dev)[None, :]
    phys = physical_positions(tables, positions, capacity)
    shared_tables = cache_kv.get("shared_tables")
    pub_pos = None
    if shared_tables is not None:
        bs = capacity // shared_tables.shape[-1]
        col_blk = (positions // bs).clamp(0, shared_tables.shape[-1] - 1)
        in_range = (positions >= 0) & (positions < capacity)
        shared_at = torch.gather(shared_tables.long(), 1, col_blk) >= 0
        phys = torch.where(shared_at & in_range, capacity, phys)
        publish_tables = cache_kv.get("publish_tables")
        if publish_tables is not None:
            sentinel = cache_kv["shared_k"].shape[0] - 1
            pub_blk = torch.gather(publish_tables.long(), 1, col_blk)
            pub_pos = torch.where(
                (pub_blk >= 0) & in_range, pub_blk * bs + positions % bs, sentinel
            )
    rows = slots[:, None]
    view = logical_view_index(tables, capacity)
    if 0 < view_len < capacity:
        view = view[:, :view_len]
    if "k_scale" in cache_kv:
        return _int8_write_read(cache_kv, k, v, dtype, rows, phys, pub_pos, view, capacity,
                                view_len)
    if pub_pos is not None:
        _publish_rows(cache_kv["shared_k"], pub_pos, k)
        _publish_rows(cache_kv["shared_v"], pub_pos, v)
    pool_k[rows, phys] = k.to(pool_k.dtype)
    pool_v[rows, phys] = v.to(pool_v.dtype)
    k_full, v_full = pool_k[rows, view].to(dtype), pool_v[rows, view].to(dtype)
    if shared_tables is not None:
        out = []
        for full, key in ((k_full, "shared_k"), (v_full, "shared_v")):
            vals, mask = _shared_gather(shared_tables, cache_kv[key], capacity, view_len)
            out.append(torch.where(mask[..., None, None], vals.to(dtype), full))
        k_full, v_full = out
    return k_full, v_full


def _int8_write_read(cache_kv, k, v, dtype, rows, phys, pub_pos, view, capacity, view_len):
    """:func:`paged_write_read`'s int8 arm: one quantizing write of values
    and scales at the physical rows (and the publish rows), then the
    logical view of values and scales, each overlaid from the pool where a
    block is shared (``overlay(full, pool_key, scale_key)`` of the JAX
    package, before its dequantization, which is elementwise). Returns two
    :class:`~trlx_tpu_torch.ops.attention.QuantizedKV`."""
    from trlx_tpu_torch.ops.attention import QuantizedKV
    from trlx_tpu_torch.ops.kv_quant import cache_buffers, quantized_write, rows_of

    publish = cache_buffers(cache_kv, "shared_") if pub_pos is not None else None
    quantized_write(k, v, cache_buffers(cache_kv), rows=rows_of(rows[:, 0], phys, capacity + 1),
                    publish=publish, publish_rows=pub_pos)
    shared_tables = cache_kv.get("shared_tables")
    out = []
    for key in ("k", "v"):
        values, scale = cache_kv[key][rows, view], cache_kv[key + "_scale"][rows, view]
        if shared_tables is not None:
            pool_vals, mask = _shared_gather(
                shared_tables, cache_kv["shared_" + key], capacity, view_len)
            pool_scale, _ = _shared_gather(
                shared_tables, cache_kv["shared_" + key + "_scale"], capacity, view_len)
            mask = mask[..., None, None]
            values = torch.where(mask, pool_vals, values)
            scale = torch.where(mask, pool_scale, scale)
        out.append(QuantizedKV(values, scale, dtype))
    return tuple(out)
