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

The shared-prefix pool comes with the serving-tier slice and raises here.
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
    position is the discard sentinel) plus ``"block_tables"``, whose
    presence routes ``models/gpt2.py::write_cache`` onto the paged path.
    One table tensor is shared by every layer."""
    from trlx_tpu_torch.models.gpt2 import kv_buffers

    bs = choose_block_size(capacity, block_size)
    tables = identity_block_tables(n_slots, capacity // bs, device)
    layers = kv_buffers(
        n_layer, n_slots, capacity + 1, n_head, head_dim, dtype,
        kv_cache_dtype, device=device,
    )
    return [dict(layer, block_tables=tables) for layer in layers]


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
    view ``(k_full, v_full)`` [B, view, H, Dh] for attention.

    ``cache_kv["slots"]`` (optional, [B] long) names the pool rows the B
    batch rows live in — the engine's admission prefill writes straight
    into the admitted slots of the full pool; without it row b is slot b.
    ``view_len > 0`` narrows the returned view; writes always resolve at
    full capacity."""
    if "shared_tables" in cache_kv:
        raise NotImplementedError(
            "the shared-prefix KV pool comes with the serving-tier slice"
        )
    if "k_scale" in cache_kv:
        raise NotImplementedError("the int8 KV cache comes with a later slice")
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
    rows = slots[:, None]
    pool_k[rows, phys] = k.to(pool_k.dtype)
    pool_v[rows, phys] = v.to(pool_v.dtype)
    view = logical_view_index(tables, capacity)
    if 0 < view_len < capacity:
        view = view[:, :view_len]
    return pool_k[rows, view].to(dtype), pool_v[rows, view].to(dtype)
