"""Host-side shared-prefix block pool: radix trie + refcounts (counterpart
of :mod:`trlx_tpu.serving.prefix_cache`).

The allocator behind cross-request prefix KV reuse. Device storage is the
per-layer ``shared_k``/``shared_v`` pool the engine carries when built with
``prefix_pool_blocks > 0`` (:mod:`trlx_tpu_torch.inference.kv_cache`); this
module decides which pool block holds which prefix content, and for every
admitted request builds the per-row ``shared_map``/``publish_map`` the
prefill consumes.

Why sharing is exact: a padded prompt column's K/V depends only on the
leading columns' ``(token, mask)`` pairs (causal attention bounds the ids,
and the position ids are a cumsum of the leading mask). The trie keys each
block on the exact ``(ids, mask)`` content of its ``block_size`` columns,
and a request shares block ``j`` only when blocks ``0..j`` all match.
Left-padded prompts therefore share only when they pad alike (in practice:
equal prompt lengths with a common leading prefix).

Lifecycle per pool block:

- **publish**: the first request with an unseen prefix block allocates a
  free pool block (``publish_map[j] = block``), its prefill writes the bits
  in, and the block becomes ``ready`` once that prefill has been launched
  (:meth:`mark_ready`, from the engine's admit listener: the engine's
  stream orders the write before any later reader's gather);
- **share**: later requests whose leading blocks match a ready chain map
  them read-only (``shared_map[j] = block``) and take a reference;
- **copy on divergence**: published blocks are immutable; a request whose
  content diverges inside block ``j`` gets a fresh block for it;
- **release**: references drop at request completion (a double release
  raises); refcount-0 leaves are evicted least recently used when the pool
  is full.

:attr:`PrefixBlockPool.version` counts changes to the set of ready chains
(a block turning ready, or leaving the trie), so a reader of
:meth:`~PrefixBlockPool.ready_chains` can cache what it derives from them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class DoubleFreeError(RuntimeError):
    """A shared block was released more times than it was acquired."""


@dataclass
class _Node:
    """One trie node = one pool block holding one block's columns."""

    key: Tuple
    block_id: int
    parent: Optional["_Node"]
    ready: bool = False
    refcount: int = 0
    tick: int = 0
    children: Dict[Tuple, "_Node"] = field(default_factory=dict)


@dataclass
class AdmissionPlan:
    """Per-request sharing decision: the prefill maps plus the blocks
    this request now holds references on (released at completion)."""

    shared_map: np.ndarray  # [n_blocks] int32, -1 = private
    publish_map: np.ndarray  # [n_blocks] int32, -1 = no publish
    acquired: List[int]  # pool blocks refcounted to this request
    published: List[int]  # subset of acquired pending mark_ready
    hit_blocks: int  # ready blocks reused (true cross-request hits)


class PrefixBlockPool:
    """Refcounted trie allocator over ``pool_blocks`` shared KV blocks."""

    def __init__(self, pool_blocks: int, block_size: int, n_blocks: int):
        if pool_blocks < 1:
            raise ValueError(f"pool_blocks={pool_blocks} must be >= 1")
        self.pool_blocks = int(pool_blocks)
        self.block_size = int(block_size)
        self.n_blocks = int(n_blocks)  # logical blocks per slot
        self._free: List[int] = list(range(self.pool_blocks))
        self._root: Dict[Tuple, _Node] = {}
        self._nodes: Dict[int, _Node] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.version = 0

    # ------------------------------ helpers ---------------------------- #

    def _block_key(self, ids, mask, j: int) -> Tuple:
        bs = self.block_size
        sl = slice(j * bs, (j + 1) * bs)
        return (
            tuple(int(x) for x in ids[sl]),
            tuple(int(x) for x in mask[sl]),
        )

    def _alloc(self) -> Optional[int]:
        if self._free:
            return self._free.pop(0)
        victim = self._evictable()
        if victim is None:
            return None
        self._evict(victim)
        return self._free.pop(0)

    def _evictable(self) -> Optional[_Node]:
        """Oldest refcount-0 leaf (children pin their parents: evicting
        an interior block would orphan a chain someone can still walk)."""
        best = None
        for node in self._nodes.values():
            if node.refcount == 0 and node.ready and not node.children:
                if best is None or node.tick < best.tick:
                    best = node
        return best

    def _remove(self, node: _Node) -> None:
        siblings = (
            node.parent.children if node.parent is not None else self._root
        )
        siblings.pop(node.key, None)
        self._nodes.pop(node.block_id, None)
        self._free.append(node.block_id)
        if node.ready:
            self.version += 1

    def _evict(self, node: _Node) -> None:
        self._remove(node)
        self.evictions += 1

    # ------------------------------- API -------------------------------- #

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def plan_admission(
        self, ids, mask, eligible_blocks: Optional[int] = None
    ) -> AdmissionPlan:
        """Sharing decision for one request's padded prompt columns.

        Walks the trie over the leading blocks: ready matches are
        shared (refcount acquired), the first unseen block starts a
        publish chain (fresh pool blocks — divergence NEVER mutates a
        published block), an in-flight (not yet ready) match stops the
        walk (its bits are not readable yet; this request keeps those
        blocks private). ``eligible_blocks`` caps the walk (default:
        every full block that fits the prompt columns).
        """
        ids = np.asarray(ids).reshape(-1)
        mask = np.asarray(mask).reshape(-1)
        n_eligible = (
            min(self.n_blocks, len(ids) // self.block_size)
            if eligible_blocks is None
            else min(eligible_blocks, self.n_blocks)
        )
        shared = np.full((self.n_blocks,), -1, np.int32)
        publish = np.full((self.n_blocks,), -1, np.int32)
        acquired: List[int] = []
        published: List[int] = []
        hit_blocks = 0
        level = self._root
        parent: Optional[_Node] = None
        publishing = False
        self._tick += 1
        for j in range(n_eligible):
            key = self._block_key(ids, mask, j)
            node = level.get(key)
            if node is not None and not publishing:
                if not node.ready:
                    # someone is publishing this very block right now —
                    # its bits are not readable yet; stay private from
                    # here down (no wait states on the admission path)
                    break
                node.refcount += 1
                node.tick = self._tick
                shared[j] = node.block_id
                acquired.append(node.block_id)
                hit_blocks += 1
                parent, level = node, node.children
                continue
            # miss (or divergence below a block we just published):
            # allocate fresh — published blocks are immutable
            block_id = self._alloc()
            if block_id is None:
                break  # pool exhausted: rest stays private
            node = _Node(key=key, block_id=block_id, parent=parent)
            node.refcount = 1
            node.tick = self._tick
            level[key] = node
            self._nodes[block_id] = node
            shared[j] = block_id  # publisher reads its own publish
            publish[j] = block_id
            acquired.append(block_id)
            published.append(block_id)
            publishing = True
            parent, level = node, node.children
        self.hits += hit_blocks
        self.misses += len(published)
        return AdmissionPlan(
            shared_map=shared,
            publish_map=publish,
            acquired=acquired,
            published=published,
            hit_blocks=hit_blocks,
        )

    def mark_ready(self, blocks: Sequence[int]) -> None:
        """Published blocks become readable (their prefill dispatched)."""
        for b in blocks:
            node = self._nodes.get(int(b))
            if node is not None and not node.ready:
                node.ready = True
                self.version += 1

    def abandon(self, blocks: Sequence[int]) -> None:
        """Roll back a planned admission whose engine submit FAILED:
        drop the plan's references, and remove never-ready published
        nodes entirely — their prefill will never dispatch, so leaving
        them would permanently break the trie walk for that prefix
        (readers stop at a not-ready node) AND pin the pool blocks
        (``_evictable`` skips un-ready nodes). Walks leaf-first so a
        removed child unpins its parent within the same call."""
        for b in reversed(list(blocks)):
            node = self._nodes.get(int(b))
            if node is None:
                continue
            if node.refcount > 0:
                node.refcount -= 1
            if not node.ready and node.refcount == 0 and not node.children:
                self._remove(node)

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per listed block (request completed)."""
        for b in blocks:
            node = self._nodes.get(int(b))
            if node is None or node.refcount < 1:
                raise DoubleFreeError(
                    f"shared prefix block {int(b)} released more times "
                    "than acquired"
                )
            node.refcount -= 1

    def ready_chains(self) -> List[List[int]]:
        """Mask-filtered token sequences of every ready root-to-node
        chain — the speculative drafter's global n-gram corpus
        (:mod:`trlx_tpu_torch.serving.spec_drafter`). A chain stops at the first
        not-ready node (its bits are not readable, so its *content* is
        not trustworthy as a draft source either)."""
        out: List[List[int]] = []

        def walk(node: _Node, prefix: List[int]) -> None:
            if not node.ready:
                return
            ids, mask = node.key
            toks = prefix + [int(t) for t, m in zip(ids, mask) if m]
            if toks:
                out.append(toks)
            for child in node.children.values():
                walk(child, toks)

        for node in self._root.values():
            walk(node, [])
        return out

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "prefix_pool/hits": float(self.hits),
            "prefix_pool/misses": float(self.misses),
            "prefix_pool/hit_rate": (self.hits / total) if total else 0.0,
            "prefix_pool/free_blocks": float(self.free_blocks),
            "prefix_pool/evictions": float(self.evictions),
        }
