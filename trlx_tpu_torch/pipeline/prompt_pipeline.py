"""Prompt pipeline: text or token-id prompts -> fixed-shape left-padded
batches (counterpart of :mod:`trlx_tpu.pipeline.prompt_pipeline`).

Prompts are tokenized and left-padded to the query length once, at
construction; left padding puts the last prompt token at a fixed column.
Ground-truth responses ride along as host strings for the reward function.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from trlx_tpu_torch.data import PromptBatch
from trlx_tpu_torch.pipeline import register_datapipeline


def left_pad(seqs: Sequence[Sequence[int]], length: int, pad_id: int):
    """Left-pad token id lists to ``length`` (int32 ids and mask); longer
    lists keep their last ``length`` tokens."""
    ids = np.full((len(seqs), length), pad_id, dtype=np.int32)
    mask = np.zeros((len(seqs), length), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[-length:]
        if s:
            ids[i, -len(s):] = s
            mask[i, -len(s):] = 1
    return ids, mask


@register_datapipeline
class PromptPipeline:
    """(prompt, optional response_gt) pairs, pre-tokenized.

    :param prompts: strings (needs ``tokenizer``) or token-id lists.
    :param max_prompt_length: the fixed query length Q.
    :param tokenizer: object with ``encode``/``decode``/``pad_token_id``.
    :param response_gt: optional ground-truth responses for the reward.
    """

    def __init__(
        self,
        prompts: Union[List[str], List[List[int]]],
        max_prompt_length: int,
        tokenizer=None,
        response_gt: Optional[List[str]] = None,
    ):
        if response_gt is not None and len(response_gt) != len(prompts):
            raise ValueError("response_gt length must match prompts")
        self.tokenizer = tokenizer
        self.prompts_text: List[Optional[str]] = []
        token_lists: List[List[int]] = []
        for p in prompts:
            if isinstance(p, str):
                if tokenizer is None:
                    raise ValueError("string prompts require a tokenizer")
                token_lists.append(list(tokenizer.encode(p)))
                self.prompts_text.append(p)
            else:
                token_lists.append([int(t) for t in p])
                self.prompts_text.append(None)
        pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
        self.input_ids, self.attention_mask = left_pad(
            token_lists, max_prompt_length, pad_id
        )
        # token-list prompts are decoded once, from the padded/truncated
        # ids, so the text matches what the model sees
        for i, text in enumerate(self.prompts_text):
            if text is None:
                ids = self.input_ids[i][self.attention_mask[i] > 0]
                self.prompts_text[i] = (
                    tokenizer.decode(ids, skip_special_tokens=True)
                    if tokenizer is not None
                    else " ".join(map(str, ids.tolist()))
                )
        self.response_gt = list(response_gt) if response_gt is not None else None
        self.prompt_lengths = self.attention_mask.sum(axis=1)

    @property
    def min_prompt_tokens(self) -> int:
        return int(self.prompt_lengths.min()) if len(self) else 0

    @property
    def max_prompt_tokens(self) -> int:
        return int(self.prompt_lengths.max()) if len(self) else 0

    def __len__(self) -> int:
        return len(self.input_ids)

    def create_loader(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
    ) -> Iterable[Tuple[PromptBatch, Dict[str, Any]]]:
        """Yield ``(PromptBatch, meta)`` with host strings in ``meta``.
        Batches are always full size: with ``drop_last=False`` the tail
        batch is filled by repeating earlier rows and ``meta["n_real"]``
        counts the real ones. ``shuffle`` permutes with
        ``np.random.default_rng(seed)``."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        batches = []
        for start in range(0, n, batch_size):
            idx = order[start : start + batch_size]
            n_real = len(idx)
            if n_real < batch_size:
                if drop_last:
                    continue
                idx = np.concatenate([idx, order[np.arange(batch_size - n_real) % n]])
            batches.append((idx, n_real))

        def gen():
            for idx, n_real in batches:
                yield PromptBatch(
                    input_ids=torch.from_numpy(self.input_ids[idx]),
                    attention_mask=torch.from_numpy(self.attention_mask[idx]),
                ), {
                    "n_real": n_real,
                    "prompts_text": [self.prompts_text[i] for i in idx],
                    "response_gt": (
                        [self.response_gt[i] for i in idx]
                        if self.response_gt is not None else None
                    ),
                }

        return gen()
