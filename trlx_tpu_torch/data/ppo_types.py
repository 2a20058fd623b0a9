"""PPO rollout data types (counterpart of :mod:`trlx_tpu.data.ppo_types`
and the sampler's ``SampleOutput``).

Rollouts stay batched with static shapes from the moment they are
produced: queries left-padded to the query length Q, responses
right-padded to the response length R, every field a tensor on the
trainer's device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import torch


@dataclass
class SampleOutput:
    """What the fixed-batch sampler emits, each [B, R].

    :param tokens: int32 response tokens (pad after a row finishes).
    :param response_mask: int32, 1 on real response tokens (eos included).
    :param logprobs: f32 behaviour logprobs of the tokens (0 past the end).
    :param values: f32 value estimates at each response position.
    """

    tokens: torch.Tensor
    response_mask: torch.Tensor
    logprobs: torch.Tensor
    values: torch.Tensor


@dataclass
class PPORolloutBatch:
    """A batch of PPO experience. B = batch, Q = query length, R =
    response length.

    :param query_tokens: [B, Q] int32, left-padded prompts.
    :param query_mask: [B, Q] 1 on real prompt tokens.
    :param response_tokens: [B, R] int32, right-padded responses.
    :param response_mask: [B, R] 1 on real response tokens.
    :param logprobs: [B, R] behaviour-policy logprobs.
    :param values: [B, R] rollout-time values.
    :param rewards: [B, R] -kl_coef * (logp - ref_logp), plus the scalar
        score at the last real token.
    """

    query_tokens: torch.Tensor
    query_mask: torch.Tensor
    response_tokens: torch.Tensor
    response_mask: torch.Tensor
    logprobs: torch.Tensor
    values: torch.Tensor
    rewards: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.query_tokens.shape[0]

    def select(self, idx) -> "PPORolloutBatch":
        """Rows ``idx`` ([n] or [m, n] indices) of every field."""
        idx = torch.as_tensor(idx, device=self.query_tokens.device)
        return PPORolloutBatch(
            **{f.name: getattr(self, f.name)[idx] for f in dataclasses.fields(self)}
        )


def concat_rollouts(batches: Sequence[PPORolloutBatch]) -> PPORolloutBatch:
    """Concatenate rollout batches along the batch axis."""
    if len(batches) == 1:
        return batches[0]
    return PPORolloutBatch(**{
        f.name: torch.cat([getattr(b, f.name) for b in batches])
        for f in dataclasses.fields(PPORolloutBatch)
    })
