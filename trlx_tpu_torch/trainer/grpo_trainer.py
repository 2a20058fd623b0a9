"""GRPO: group-relative PPO without a value function (counterpart of
:mod:`trlx_tpu.trainer.grpo_trainer`).

Per prompt, ``group_size`` rollouts are sampled (the orchestrator repeats
each drawn prompt G times, contiguously); each rollout's KL-shaped return
is normalised against its own group,

    A_i = (R_i - mean_group) / (std_group + 1e-6),

broadcast over the response tokens and stored in the buffer's rewards slot
at experience time, so minibatch shuffling never splits a group. The
update is PPO's clipped surrogate on those advantages, with no GAE and no
value loss (``vf_coef`` must be 0: the value head stays in the model and
gets no gradient).
"""

from __future__ import annotations

from trlx_tpu_torch.data.ppo_types import PPORolloutBatch
from trlx_tpu_torch.ops.ppo_math import group_whiten
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.trainer.seq2seq_ppo_trainer import Seq2SeqPPOTrainer


class GRPOMixin:
    """GRPO over a PPO-family trainer: grouped sampling (through
    ``self.group_size``, which the orchestrator reads), group-normalised
    advantages stored at experience time, no value-function training. Run
    health leaves out the value function's explained variance: the returns
    slot carries a placeholder, so it would read as a perfect fit; the
    ``health/reward_*`` stats describe the group-whitened advantages the
    updates see."""

    def __init__(self, config, *args, **kwargs):
        method = config.method
        if method.group_size < 2:
            raise ValueError(
                f"GRPO needs group_size >= 2 (got {method.group_size}): a "
                "single-rollout group has a zero-variance baseline"
            )
        if method.vf_coef:
            raise ValueError(
                f"GRPO has no value function (vf_coef={method.vf_coef}); "
                "the returns slot carries a placeholder, so a nonzero "
                "vf_coef would regress values onto stale rollout values"
            )
        super().__init__(config, *args, **kwargs)
        self._health_ev = False

    def _shape_rewards(self, logprobs, ref_logprobs, response_mask, scores, kl_coef):
        """Group-normalised per-sequence advantages of the KL-shaped
        returns, broadcast over the response tokens; rows arrive
        group-contiguous from the orchestrator."""
        rewards, mean_kl = super()._shape_rewards(
            logprobs, ref_logprobs, response_mask, scores, kl_coef
        )
        adv = group_whiten(rewards.sum(1), self.group_size)
        return adv[:, None] * response_mask.float(), mean_kl

    def _advantages_and_returns(self, mb: PPORolloutBatch):
        """No GAE: the stored rewards are the advantages. Returns are the
        stored values, so the (zero-weighted) value loss starts at 0."""
        return mb.rewards, mb.values


@register_trainer
class GRPOTrainer(GRPOMixin, PPOTrainer):
    """GRPO over the causal PPO path."""


@register_trainer
class Seq2SeqGRPOTrainer(GRPOMixin, Seq2SeqPPOTrainer):
    """GRPO over the seq2seq T5/UL2 path (decoder rollouts grouped per
    encoder prompt)."""
