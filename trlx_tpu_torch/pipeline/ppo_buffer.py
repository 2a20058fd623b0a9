"""PPO rollout buffer and the phase's update plan (counterpart of
:mod:`trlx_tpu.pipeline.ppo_buffer`: ``make_stream_plan``, ``StreamPlan``
and ``PPORolloutBuffer``).

Rollout chunks arrive batched on the trainer's device and stay there;
minibatches are index gathers. The JAX package can run a phase's epoch-1
updates while later chunks still decode; the port runs the same
:class:`StreamPlan` serially, after collection, which the JAX package pins
bitwise to its overlapped execution (``tests/test_phase_overlap.py``).
"""

from __future__ import annotations

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

    def updates(self) -> np.ndarray:
        """[n_updates, batch_size] row indices in execution order
        (epoch-major)."""
        return np.concatenate([self.epoch1, self.residual])


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
    """Accumulates rollout chunks; serves minibatches by index."""

    def __init__(self):
        self._chunks: List[PPORolloutBatch] = []
        self._full: Optional[PPORolloutBatch] = None

    def push(self, batch: PPORolloutBatch) -> None:
        self._chunks.append(batch)
        self._full = None

    def clear_history(self) -> None:
        """Drop all experience (the on-policy refresh)."""
        self._chunks = []
        self._full = None

    def __len__(self) -> int:
        return sum(c.batch_size for c in self._chunks)

    @property
    def full(self) -> PPORolloutBatch:
        if self._full is None:
            if not self._chunks:
                raise ValueError("rollout buffer is empty")
            self._full = concat_rollouts(self._chunks)
        return self._full

    def gather(self, idx) -> PPORolloutBatch:
        """Rows ``idx`` ([B] or [n, B]) of the buffer."""
        return self.full.select(np.asarray(idx))

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
