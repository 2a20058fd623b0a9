"""PPO rollout buffer and the phase's update plan (counterpart of
:mod:`trlx_tpu.pipeline.ppo_buffer`: ``make_stream_plan``, ``StreamPlan``
and ``PPORolloutBuffer``).

Rollout chunks arrive batched on the trainer's device and stay there;
minibatches are index gathers. Two modes:

- **chunk mode** (the default): chunks append to a list, concatenated on
  first use;
- **stream mode** (:meth:`PPORolloutBuffer.begin_stream`): rows land in a
  store preallocated at the phase's planned size, so a minibatch of landed
  rows can be gathered while collection is still running. The streamed
  phase (:mod:`trlx_tpu_torch.trainer.ppo_trainer`) runs each epoch-1
  minibatch of its :class:`StreamPlan` as soon as its rows exist.

Each landed row carries a host-side behaviour-policy version tag (0 unless
the asynchronous actor-learner pushed weights mid-phase), read back by
:meth:`PPORolloutBuffer.row_versions`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from trlx_tpu_torch.data.ppo_types import PPORolloutBatch, concat_rollouts


@dataclass(frozen=True)
class StreamPlan:
    """The update schedule of one phase, fixed before collection.

    Epoch-1 minibatch ``k`` is rows ``[k B, (k+1) B)`` in landing order;
    epochs 2..ppo_epochs each take a fresh global permutation of the
    scheduled rows (``residual``). Rows a non-dividing final chunk
    over-collects are stored but never scheduled."""

    total: int  # rollouts the schedule covers (n_minibatches * batch_size)
    batch_size: int
    ppo_epochs: int
    epoch1: np.ndarray  # [n_minibatches, batch_size] row indices
    residual: np.ndarray  # [n_minibatches * (ppo_epochs - 1), batch_size]

    @property
    def n_minibatches(self) -> int:
        return self.epoch1.shape[0]

    @property
    def n_updates(self) -> int:
        return self.n_minibatches * self.ppo_epochs

    def rows_needed(self, k: int) -> int:
        """Rollouts that must have landed before epoch-1 minibatch ``k``
        (0-based) can run."""
        return (k + 1) * self.batch_size

    def ready(self, k: int, landed: int) -> bool:
        return landed >= self.rows_needed(k)

    def updates(self) -> np.ndarray:
        """[n_updates, batch_size] row indices in execution order
        (epoch-major)."""
        return np.concatenate([self.epoch1, self.residual])


def _alloc_store(chunk: PPORolloutBatch, capacity: int) -> PPORolloutBatch:
    """A zero store of ``capacity`` rows with ``chunk``'s trailing shapes,
    dtypes and device."""
    return PPORolloutBatch(**{
        f.name: getattr(chunk, f.name).new_zeros(
            (capacity,) + tuple(getattr(chunk, f.name).shape[1:]))
        for f in dataclasses.fields(PPORolloutBatch)
    })


def _write_rows(store: PPORolloutBatch, chunk: PPORolloutBatch, offset: int) -> None:
    """Copy ``chunk``'s rows into ``store`` at ``offset``, in place (cast
    to the store's dtypes)."""
    for f in dataclasses.fields(PPORolloutBatch):
        src = getattr(chunk, f.name)
        getattr(store, f.name)[offset:offset + src.shape[0]].copy_(src)


def make_stream_plan(
    total: int, batch_size: int, ppo_epochs: int, seed: int = 0
) -> StreamPlan:
    """The phase schedule for ``total`` rollouts, from ``seed`` (the same
    ``np.random.default_rng`` draws as the JAX package)."""
    n_mb = total // batch_size
    if n_mb < 1:
        raise ValueError(
            f"stream plan needs at least one minibatch "
            f"({total} rollouts < batch_size {batch_size})"
        )
    rng = np.random.default_rng(seed)
    n_sched = n_mb * batch_size
    epoch1 = np.arange(n_sched).reshape(n_mb, batch_size)
    residual = (
        np.stack(
            [rng.permutation(n_sched) for _ in range(ppo_epochs - 1)]
        ).reshape(n_mb * (ppo_epochs - 1), batch_size)
        if ppo_epochs > 1
        else np.zeros((0, batch_size), np.int64)
    )
    return StreamPlan(n_sched, batch_size, ppo_epochs, epoch1, residual)


class PPORolloutBuffer:
    """Accumulates rollout chunks (or, in stream mode, rows in a
    preallocated store); serves minibatches by index."""

    def __init__(self):
        self._chunks: List[PPORolloutBatch] = []
        self._full: Optional[PPORolloutBatch] = None
        self._chunk_versions: List[np.ndarray] = []
        self._store: Optional[PPORolloutBatch] = None  # stream mode
        self._capacity = 0
        self._landed = 0
        self._streaming = False
        self._row_versions: Optional[np.ndarray] = None

    def begin_stream(self, capacity: int) -> None:
        """Switch to stream mode for the coming phase; ``capacity`` is the
        planned rollout total (a final chunk that overshoots it grows the
        store). The buffer must be empty."""
        if len(self):
            raise ValueError(
                "begin_stream on a non-empty buffer — clear_history() "
                "the previous phase's experience first"
            )
        if capacity < 1:
            raise ValueError(f"stream capacity must be >= 1, got {capacity}")
        self._streaming = True
        self._store = None
        self._capacity = int(capacity)
        self._landed = 0
        self._full = None
        self._row_versions = np.zeros(self._capacity, np.int64)
        self._chunk_versions = []

    @property
    def streaming(self) -> bool:
        return self._streaming

    def push(self, batch: PPORolloutBatch, versions=None) -> None:
        """Append one rollout chunk. ``versions`` (host ints, one per row)
        tags each row with the behaviour-policy version that generated it;
        an untagged chunk reads as version 0."""
        n = batch.batch_size
        v = np.zeros(n, np.int64) if versions is None else np.asarray(versions, np.int64)
        if v.shape != (n,):
            raise ValueError(f"versions must be [{n}] host ints, got shape {v.shape}")
        if not self._streaming:
            self._chunks.append(batch)
            self._chunk_versions.append(v)
            self._full = None
            return
        if self._store is None:
            self._store = _alloc_store(batch, max(self._capacity, n))
            self._capacity = self._store.batch_size
            self._row_versions = np.resize(self._row_versions, self._capacity)
        if self._landed + n > self._capacity:
            # a non-dividing final chunk overshoots the plan: grow to the
            # next power-of-two bucket, as the JAX package does (where a
            # new capacity is a new compiled program)
            new_capacity = max(self._capacity, 1)
            while new_capacity < self._landed + n:
                new_capacity *= 2
            grown = _alloc_store(batch, new_capacity)
            _write_rows(grown, self._store, 0)
            self._store, self._capacity = grown, new_capacity
            self._row_versions = np.resize(self._row_versions, new_capacity)
        _write_rows(self._store, batch, self._landed)
        self._row_versions[self._landed:self._landed + n] = v
        self._landed += n
        self._full = None

    def clear_history(self) -> None:
        """Drop all experience (the on-policy refresh) and leave stream
        mode."""
        self._chunks = []
        self._full = None
        self._chunk_versions = []
        self._store = None
        self._capacity = 0
        self._landed = 0
        self._streaming = False
        self._row_versions = None

    def __len__(self) -> int:
        if self._streaming:
            return self._landed
        return sum(c.batch_size for c in self._chunks)

    @property
    def full(self) -> PPORolloutBatch:
        if self._streaming:
            if self._store is None:
                raise ValueError("rollout buffer is empty")
            if self._landed == self._store.batch_size:
                return self._store
            return PPORolloutBatch(**{  # the landed prefix, a view
                f.name: getattr(self._store, f.name)[:self._landed]
                for f in dataclasses.fields(PPORolloutBatch)
            })
        if self._full is None:
            if not self._chunks:
                raise ValueError("rollout buffer is empty")
            self._full = concat_rollouts(self._chunks)
        return self._full

    def row_versions(self, idx) -> np.ndarray:
        """Behaviour-policy version of each row of ``idx`` (host ints, any
        shape)."""
        idx = np.asarray(idx)
        if self._streaming:
            if self._row_versions is None:
                raise ValueError("rollout buffer is empty")
            if idx.size and int(idx.max()) >= self._landed:
                raise ValueError(
                    f"row_versions of row {int(idx.max())} but only "
                    f"{self._landed} rollouts have landed"
                )
            return self._row_versions[idx]
        if not self._chunks:
            raise ValueError("rollout buffer is empty")
        return np.concatenate(self._chunk_versions)[idx]

    def gather(self, idx) -> PPORolloutBatch:
        """Rows ``idx`` ([B] or [n, B]) of the buffer; in stream mode every
        index must have landed."""
        idx = np.asarray(idx)
        if self._streaming:
            if idx.size and int(idx.max()) >= self._landed:
                raise ValueError(
                    f"gather of row {int(idx.max())} but only "
                    f"{self._landed} rollouts have landed"
                )
            if self._store is None:
                raise ValueError("rollout buffer is empty")
            return self._store.select(idx)
        return self.full.select(idx)

    def minibatch_order(
        self,
        batch_size: int,
        seed: int = 0,
        repeat: int = 1,
        n_minibatches: Optional[int] = None,
    ) -> np.ndarray:
        """[n_mb * repeat, batch_size] row indices of one minibatch-major
        pass (the ``phase_overlap: false`` schedule): the buffer shuffled
        with ``np.random.default_rng(seed)``, cut into minibatches, each
        repeated ``repeat`` times in a row — the order of the JAX
        package's ``stacked_minibatches`` and (``repeat`` 1) of its
        buffer's ``create_loader``."""
        n = len(self)
        n_mb = n // batch_size
        if n_mb == 0:
            raise ValueError(f"buffer smaller than one minibatch ({n} < {batch_size})")
        if n_minibatches is not None:
            n_mb = min(n_mb, n_minibatches)
        order = np.arange(n)
        np.random.default_rng(seed).shuffle(order)
        return np.repeat(order[: n_mb * batch_size].reshape(n_mb, batch_size), repeat, axis=0)
