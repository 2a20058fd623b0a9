"""Offline (ILQL) experience from a reward-labeled dataset (counterpart of
:mod:`trlx_tpu.orchestrator.offline_orchestrator`): tokenize the samples,
find each one's first action, normalise the returns across the dataset,
place each on its sample's last action, and install an
:class:`~trlx_tpu_torch.pipeline.ilql_storage.ILQLRolloutStorage` on the
trainer."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from trlx_tpu_torch.orchestrator import register_orchestrator
from trlx_tpu_torch.pipeline.ilql_storage import ILQLRolloutStorage, build_ilql_batch


@register_orchestrator
class OfflineOrchestrator:
    """
    :param trainer: an :class:`~trlx_tpu_torch.trainer.ilql_trainer.ILQLTrainer`.
    :param split_token: splits a string sample into prompt and response.
    """

    def __init__(self, trainer, split_token: Optional[str] = None):
        self.trainer = trainer
        self.split_token = split_token
        trainer.orch = self

    def make_experience(self, samples: Sequence, rewards: Sequence[float]) -> ILQLRolloutStorage:
        """``samples``: strings (tokenized with the trainer's tokenizer; with
        ``split_token`` split into prompt and response, else every token
        after the first is an action), (prompt, response) string pairs, or
        (token_list, action_start) pairs. ``rewards``: one per sample."""
        tokenizer = self.trainer.tokenizer
        token_lists: List[List[int]] = []
        action_starts: List[int] = []
        for sample in samples:
            if isinstance(sample, str):
                if self.split_token and self.split_token in sample:
                    sample = tuple(sample.split(self.split_token, 1))
                else:
                    token_lists.append(list(tokenizer.encode(sample)))
                    action_starts.append(1)
                    continue
            if isinstance(sample, (tuple, list)) and len(sample) == 2 and isinstance(sample[0], str):
                p_toks = list(tokenizer.encode(sample[0]))
                token_lists.append(p_toks + list(tokenizer.encode(sample[1])))
                action_starts.append(max(len(p_toks), 1))
            else:
                toks, start = sample
                token_lists.append([int(t) for t in toks])
                action_starts.append(int(start))

        rewards = np.asarray(list(rewards), dtype=np.float32)
        print(
            f"[offline] {len(token_lists)} samples, "
            f"reward mean {rewards.mean():.3f} std {rewards.std():.3f}"
        )
        std = rewards.std()
        if std > 0:
            rewards = (rewards - rewards.mean()) / std

        rewards_per_sample = []
        for toks, start, r in zip(token_lists, action_starts, rewards):
            rs = [0.0] * max(len(toks) - max(start, 1), 1)
            rs[-1] = float(r)
            rewards_per_sample.append(rs)

        pad_id = 0
        if tokenizer is not None and tokenizer.pad_token_id is not None:
            pad_id = tokenizer.pad_token_id
        batch = build_ilql_batch(
            token_lists, action_starts, rewards_per_sample, pad_token_id=pad_id,
            max_length=self.trainer.config.train.seq_length,
        )
        store = ILQLRolloutStorage(batch.to(self.trainer.device))
        self.trainer.store = store
        return store
