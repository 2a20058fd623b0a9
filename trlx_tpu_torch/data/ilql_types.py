"""ILQL batch type (counterpart of :mod:`trlx_tpu.data.ilql_types`)."""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch


@dataclass
class ILQLBatch:
    """A batch of offline ILQL experience, padded to fixed shapes.

    Shapes: B = batch, T = padded sequence length, A = padded number of
    actions (response tokens), S = A + 1 states. Token ids and gather
    indices are int64 (``torch.gather`` indexes with them), masks int32.

    :param input_ids: [B, T] token ids (prompt + response), right-padded.
    :param attention_mask: [B, T] 1 on real tokens.
    :param rewards: [B, A] f32 per-action rewards (the normalised return
        on each sample's last action).
    :param states_ixs: [B, S] positions of the states.
    :param actions_ixs: [B, A] positions of the states the actions are
        taken from.
    :param dones: [B, S] 1 on every state but the terminal one.
    :param actions_mask: [B, A] 1 on real (non-padding) actions.
    """

    input_ids: torch.Tensor
    attention_mask: torch.Tensor
    rewards: torch.Tensor
    states_ixs: torch.Tensor
    actions_ixs: torch.Tensor
    dones: torch.Tensor
    actions_mask: torch.Tensor

    def __len__(self) -> int:
        return self.input_ids.shape[0]

    def _map(self, fn) -> "ILQLBatch":
        return ILQLBatch(**{f.name: fn(getattr(self, f.name)) for f in fields(self)})

    def select(self, idx) -> "ILQLBatch":
        """Rows ``idx`` of every field (a [k, B] index stacks k batches)."""
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.input_ids.device)
        return self._map(lambda x: x[idx])

    def to(self, device) -> "ILQLBatch":
        return self._map(lambda x: x.to(device))
