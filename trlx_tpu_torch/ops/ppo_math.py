"""PPO math: GAE, the clipped-surrogate loss, policy entropy, group
whitening and the KL controllers (counterpart of :mod:`trlx_tpu.ops.ppo_math`;
the config is :class:`trlx_tpu_torch.data.method_configs.PPOConfig`).

Means are masked by the real response mask. GAE's reversed scan over time
is a loop over the R response positions on [B] tensors.

Under a mesh each rank holds its rows of the minibatch and passes the data
group (``group``): the whitening's statistics, the loss's token count and
every stat are the global minibatch's (all-reduced sums and counts), and
the loss is this rank's sum over the global count, so that the data
group's gradients *sum* to the one-process gradient.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from trlx_tpu_torch.data.method_configs import PPOConfig
from trlx_tpu_torch.parallel.collectives import Group, all_reduce, whiten


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
    group: Group = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over the response positions. Positions past the response
    (mask 0) carry zero advantage; the next-step value is masked so an
    episode ends at its last real token. Advantages are whitened over the
    real tokens (of every rank of ``group``). Returns ``(advantages,
    returns)``, detached."""
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
    return whiten(advantages, mask, group=group) * mask, returns


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
    health: bool = False,
    health_ev: bool = True,
    group: Group = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped-surrogate PPO loss; returns (scalar loss, stats) with the
    JAX package's stats keys. The log-ratio is clamped to +-30 before
    ``exp`` (far outside the clip band: a finite loss never changes).
    ``ent_coef`` with ``entropy`` subtracts an entropy bonus.

    ``health`` (``train.health.enabled``) adds the stats the run-health
    detectors read: ``health/entropy`` (also at ``ent_coef=0``, when the
    caller passes the entropy), ``health/log_ratio_max|min`` over real
    tokens, and the value function's explained variance
    ``health/value_explained_var`` (not with ``health_ev=False``: GRPO's
    returns carry a placeholder). They are outputs only: the loss is the
    same bits with health on or off.

    ``group`` (the data group under a mesh): ``n`` is the global count of
    real tokens, the loss this rank's sum over it, and the stats the
    global minibatch's."""
    mask = mask.to(values.dtype)
    n = all_reduce(mask.sum(), group).clamp_min(1.0)

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
        "values/value_mean": (values * mask).sum() / n,
        "returns/mean": (returns * mask).sum() / n,
        "advantages/mean": (advantages * mask).sum() / n,
    }
    stats = {k: v.detach() for k, v in stats.items()}
    if group is not None:
        # every stat above is a sum over this rank's tokens / the global n
        keys = list(stats)
        summed = all_reduce(torch.stack([stats[k].float() for k in keys]), group)
        stats = dict(zip(keys, summed.unbind(0)))
    if health:
        with torch.no_grad():
            stats.update(_health_stats(log_ratio, values, returns, mask, n, health_ev, group))
            if entropy is not None:
                stats["health/entropy"] = stats["losses/entropy"]
    return loss, stats


def _health_stats(log_ratio, values, returns, mask, n, health_ev: bool,
                  group: Group = None) -> Dict[str, torch.Tensor]:
    """:func:`ppo_loss`'s log-ratio extremes over real tokens (finite
    fills, never +-inf: the fetched row feeds EWMA state) and, with
    ``health_ev``, the value function's explained variance; over every
    rank of ``group``."""
    real = mask > 0
    stats = {
        "health/log_ratio_max": all_reduce(torch.where(
            real, log_ratio, torch.full_like(log_ratio, -1e30)).max(), group, "max"),
        "health/log_ratio_min": all_reduce(torch.where(
            real, log_ratio, torch.full_like(log_ratio, 1e30)).min(), group, "min"),
    }
    if health_ev:
        err = returns - values
        ret_mean, err_mean = all_reduce(
            torch.stack([(returns * mask).sum(), (err * mask).sum()]), group).unbind(0)
        ret_mean, err_mean = ret_mean / n, err_mean / n
        var_ret, var_err = all_reduce(torch.stack([
            (((returns - ret_mean) ** 2) * mask).sum(),
            (((err - err_mean) ** 2) * mask).sum()]), group).unbind(0)
        var_ret, var_err = var_ret / n, var_err / n
        stats["health/value_explained_var"] = 1.0 - var_err / var_ret.clamp_min(1e-8)
    return stats


def reward_health_stats(rewards: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The per-sequence shaped returns' mean, std and q10/q50/q90 over the
    batch (``health/reward_*``; a collapsed ``reward_std`` is the
    reward-saturation detector's series). Quantiles interpolate linearly,
    as ``jnp.quantile``; the std is over N."""
    seq = (rewards * mask.to(rewards.dtype)).sum(1)
    q = torch.quantile(seq, torch.tensor([0.1, 0.5, 0.9], dtype=seq.dtype, device=seq.device))
    return {
        "health/reward_mean": seq.mean(),
        "health/reward_std": seq.std(correction=0),
        "health/reward_q10": q[0],
        "health/reward_q50": q[1],
        "health/reward_q90": q[2],
    }


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
