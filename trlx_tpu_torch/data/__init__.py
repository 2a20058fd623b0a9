"""Config schema and batch types (counterpart of :mod:`trlx_tpu.data`)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class PromptBatch:
    """Tokenized prompt batch, left-padded to a fixed length."""

    input_ids: torch.Tensor  # [B, Q] int32, left-padded
    attention_mask: torch.Tensor  # [B, Q]

    def __len__(self) -> int:
        return self.input_ids.shape[0]
