"""PPO math: GAE, the clipped-surrogate loss, policy entropy, group
whitening and the KL controllers (counterpart of :mod:`trlx_tpu.ops.ppo_math`;
the config is :class:`trlx_tpu_torch.data.method_configs.PPOConfig`).

Means are masked by the real response mask. GAE's reversed scan over time
is a loop over the R response positions on [B] tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from trlx_tpu_torch.data.method_configs import PPOConfig
from trlx_tpu_torch.utils import masked_mean, whiten


def policy_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Per-position entropy H = logsumexp(l) - sum softmax(l) * l, in f32."""
    logits = logits.float()
    p = torch.softmax(logits, dim=-1)
    return torch.logsumexp(logits, dim=-1) - (p * logits).sum(-1)


def group_whiten(values, group_size: int):
    """Normalise within contiguous groups of ``group_size``: (v - group
    mean) / (group std + 1e-6), the std over N (``correction=0``, as
    numpy's). Takes a host numpy array (the orchestrator's ``scale_reward:
    "group"``) or a tensor (GRPO's advantages); returns the same kind,
    flat."""
    grouped = values.reshape(-1, group_size)
    if isinstance(grouped, torch.Tensor):
        mean = grouped.mean(1, keepdim=True)
        std = grouped.std(1, keepdim=True, correction=0)
    else:
        mean = grouped.mean(axis=1, keepdims=True)
        std = grouped.std(axis=1, keepdims=True)
    return ((grouped - mean) / (std + 1e-6)).reshape(-1)


@torch.no_grad()
def get_advantages_and_returns(
    values: torch.Tensor,  # [B, R]
    rewards: torch.Tensor,  # [B, R]
    mask: torch.Tensor,  # [B, R] 1 on real response tokens
    gamma: float,
    lam: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over the response positions. Positions past the response
    (mask 0) carry zero advantage; the next-step value is masked so an
    episode ends at its last real token. Advantages are whitened over the
    real tokens. Returns ``(advantages, returns)``, detached."""
    mask = mask.to(values.dtype)
    values = values * mask
    rewards = rewards * mask
    zero = torch.zeros_like(values[:, :1])
    next_values = torch.cat([values[:, 1:], zero], dim=1)
    next_mask = torch.cat([mask[:, 1:], zero], dim=1)
    deltas = rewards + gamma * next_values * next_mask - values
    adv = torch.zeros_like(deltas)
    carry = torch.zeros_like(deltas[:, 0])
    for t in range(deltas.shape[1] - 1, -1, -1):
        carry = deltas[:, t] + gamma * lam * carry * next_mask[:, t]
        adv[:, t] = carry
    advantages = adv * mask
    returns = advantages + values
    return whiten(advantages, mask) * mask, returns


def ppo_loss(
    logprobs: torch.Tensor,  # [B, R] new policy logprobs of the taken tokens
    values: torch.Tensor,  # [B, R] new value predictions
    old_logprobs: torch.Tensor,  # [B, R] behaviour logprobs
    old_values: torch.Tensor,  # [B, R] rollout-time values
    advantages: torch.Tensor,  # [B, R]
    returns: torch.Tensor,  # [B, R]
    mask: torch.Tensor,  # [B, R]
    cliprange: float,
    cliprange_value: float,
    vf_coef: float,
    ent_coef: float = 0.0,
    entropy: Optional[torch.Tensor] = None,  # [B, R] per-position entropy
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped-surrogate PPO loss; returns (scalar loss, stats) with the
    JAX package's stats keys. The log-ratio is clamped to +-30 before
    ``exp`` (far outside the clip band: a finite loss never changes).
    ``ent_coef`` with ``entropy`` subtracts an entropy bonus."""
    mask = mask.to(values.dtype)
    n = mask.sum().clamp_min(1.0)

    values_clipped = torch.clamp(
        values, old_values - cliprange_value, old_values + cliprange_value
    )
    vf_loss1 = (values - returns) ** 2
    vf_loss2 = (values_clipped - returns) ** 2
    vf_loss = 0.5 * (torch.maximum(vf_loss1, vf_loss2) * mask).sum() / n
    vf_clipfrac = ((vf_loss2 > vf_loss1) * mask).sum() / n

    log_ratio = (logprobs - old_logprobs) * mask
    ratio = torch.exp(log_ratio.clamp(-30.0, 30.0))
    approx_kl = ((ratio - 1.0) - log_ratio).sum() / n

    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * ratio.clamp(1.0 - cliprange, 1.0 + cliprange)
    pg_loss = (torch.maximum(pg_loss1, pg_loss2) * mask).sum() / n
    pg_clipfrac = ((pg_loss2 > pg_loss1) * mask).sum() / n

    loss = pg_loss + vf_coef * vf_loss
    mean_entropy = torch.zeros((), device=values.device)
    if entropy is not None:
        mean_entropy = (entropy * mask).sum() / n
        if ent_coef:
            loss = loss - ent_coef * mean_entropy

    stats = {
        "losses/total_loss": loss,
        "losses/policy_loss": pg_loss,
        "losses/value_loss": vf_loss,
        "losses/entropy": mean_entropy,
        "policy/approx_kl": approx_kl,
        "policy/clipfrac": pg_clipfrac,
        "values/clipfrac": vf_clipfrac,
        "policy/ratio_mean": (ratio * mask).sum() / n,
        "values/value_mean": masked_mean(values, mask),
        "returns/mean": masked_mean(returns, mask),
        "advantages/mean": masked_mean(advantages, mask),
    }
    return loss, {k: v.detach() for k, v in stats.items()}


def adaptive_kl_update(
    kl_coef: float, current_kl: float, n_steps: int, target: float, horizon: int
) -> float:
    """Proportional KL controller (Ziegler et al.)."""
    err = min(max(current_kl / target - 1.0, -0.2), 0.2)
    return kl_coef * (1.0 + err * n_steps / horizon)


def kl_controller_update(
    config: PPOConfig, kl_coef: float, current_kl: float, n_steps: int
) -> float:
    """Adaptive controller when ``config.target`` is set, else fixed."""
    if config.target is None:
        return kl_coef
    return adaptive_kl_update(kl_coef, current_kl, n_steps, config.target, config.horizon)
