"""ILQL rollout storage: the offline dataset as one padded
:class:`~trlx_tpu_torch.data.ilql_types.ILQLBatch` (counterpart of
:mod:`trlx_tpu.pipeline.ilql_storage`). Minibatches are row gathers of
it, in the JAX package's seeded order."""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from trlx_tpu_torch.data.ilql_types import ILQLBatch


def build_ilql_batch(
    token_lists: Sequence[Sequence[int]],
    action_starts: Sequence[int],
    rewards_per_sample: Sequence[Sequence[float]],
    pad_token_id: int = 0,
    max_length: Optional[int] = None,
) -> ILQLBatch:
    """Pack tokenized samples into a padded batch (on the CPU).

    For a sample of length L whose actions start at token ``s`` (tokens
    ``s..L-1`` are the response):

    - ``actions_ixs``: ``s-1 .. L-2``, the state before each action; the
      padding repeats the last index (masked out by ``actions_mask``);
    - ``states_ixs``: ``s-1 .. L-1``, padded with ``L-1``;
    - ``dones``: 1 for every state but the final one.

    A sample longer than ``max_length`` is cut, and the rewards of the
    actions cut off are added to the last kept one, so the return is
    kept."""
    n = len(token_lists)
    T = max_length or max(len(t) for t in token_lists)
    A = max(max(len(t) - max(s, 1) for t, s in zip(token_lists, action_starts)), 1)
    S = A + 1

    input_ids = np.full((n, T), pad_token_id, np.int64)
    attention_mask = np.zeros((n, T), np.int32)
    rewards = np.zeros((n, A), np.float32)
    actions_ixs = np.zeros((n, A), np.int64)
    states_ixs = np.zeros((n, S), np.int64)
    dones = np.zeros((n, S), np.int32)
    actions_mask = np.zeros((n, A), np.int32)

    for i, (toks, s, rs) in enumerate(zip(token_lists, action_starts, rewards_per_sample)):
        toks = list(toks)[:T]
        L = len(toks)
        s = max(min(s, L - 1), 1)
        input_ids[i, :L] = toks
        attention_mask[i, :L] = 1
        n_actions = L - s
        ixs = np.arange(s - 1, L - 1)
        actions_ixs[i, :n_actions] = ixs
        actions_ixs[i, n_actions:] = ixs[-1] if n_actions else 0
        states_ixs[i, : n_actions + 1] = np.arange(s - 1, L)
        states_ixs[i, n_actions + 1:] = L - 1
        dones[i, :n_actions] = 1
        actions_mask[i, :n_actions] = 1
        rs = list(rs)
        if len(rs) > n_actions > 0:
            tail = float(np.sum(rs[n_actions - 1:]))
            rs = rs[: n_actions - 1] + [tail]
        rewards[i, : len(rs)] = rs

    return ILQLBatch(
        input_ids=torch.from_numpy(input_ids),
        attention_mask=torch.from_numpy(attention_mask),
        rewards=torch.from_numpy(rewards),
        states_ixs=torch.from_numpy(states_ixs),
        actions_ixs=torch.from_numpy(actions_ixs),
        dones=torch.from_numpy(dones),
        actions_mask=torch.from_numpy(actions_mask),
    )


class ILQLRolloutStorage:
    """Holds one packed batch (on the trainer's device); serves shuffled
    minibatches."""

    def __init__(self, batch: ILQLBatch):
        self.batch = batch

    def __len__(self) -> int:
        return len(self.batch)

    def epoch_order(self, batch_size: int, shuffle: bool = True, seed: int = 0) -> np.ndarray:
        """One epoch's sample order as [minibatches, batch_size] rows:
        ``np.random.default_rng(seed)``'s shuffle, cut to whole
        minibatches."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        n_mb = len(self) // batch_size
        return order[: n_mb * batch_size].reshape(n_mb, batch_size)

    def create_loader(self, batch_size: int, shuffle: bool = True, seed: int = 0) -> Iterator[ILQLBatch]:
        for rows in self.epoch_order(batch_size, shuffle, seed):
            yield self.batch.select(rows)

    def stacked_slice(self, order_rows: np.ndarray) -> ILQLBatch:
        """Minibatch rows [k, B] gathered into one [k, B, ...] batch."""
        return self.batch.select(order_rows)
