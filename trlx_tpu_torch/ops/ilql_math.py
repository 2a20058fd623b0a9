"""ILQL loss and the target-Q sync (counterpart of
:mod:`trlx_tpu.ops.ilql_math`: ``batch_gather``, ``ilql_loss`` and
``polyak_update``; the config is
:class:`trlx_tpu_torch.data.method_configs.ILQLConfig`).

The loss is the JAX package's term for term: TD regression of both Q
heads on ``reward + gamma * V(s')`` (``V`` zeroed at terminals), expectile
regression of ``V`` on the target heads' ``min Q`` at ``tau``, a CQL
cross-entropy of the Q heads on the dataset actions, and an AWAC
cross-entropy of the LM logits on every real next token. Padded actions
are left out through ``actions_mask``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import torch

from trlx_tpu_torch.data.ilql_types import ILQLBatch


def batch_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along axis 1 with batched indices: ``x[b, idx[b, i], ...]``."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def _take_last(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, labels.long()[..., None])[..., 0]


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -_take_last(torch.log_softmax(logits, dim=-1), labels)


def ilql_loss(
    logits: torch.Tensor,  # [B, T, V] LM logits
    qs: Sequence[torch.Tensor],  # [B, A, V] each, at the action states
    target_qs: Sequence[torch.Tensor],  # the same, from the target heads
    vs: torch.Tensor,  # [B, S] state values
    batch: ILQLBatch,
    config,
    health: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The ILQL loss and its stats. ``health`` (``train.health.enabled``)
    adds the training-dynamics stats the run-health detectors read: the
    policy entropy over real next-token positions (``health/entropy``), the
    largest Q of a real action (``health/q_max``) and the mean absolute TD
    error (``health/td_error_mean``). They are outputs only: the loss is
    the same bits with health on or off."""
    # the action taken from state s_t is input_ids[:, 1:][actions_ixs]
    actions = torch.gather(batch.input_ids[:, 1:], 1, batch.actions_ixs.long())  # [B, A]
    terminal_mask = batch.dones[:, :-1].float() * batch.actions_mask.float()
    n_nonterminal = terminal_mask.sum().clamp_min(1.0)

    Q = [_take_last(q, actions) for q in qs]
    target_q = [_take_last(tq, actions).detach() for tq in target_qs]
    min_target = target_q[0]
    for tq in target_q[1:]:
        min_target = torch.minimum(min_target, tq)

    v_cur = vs[:, :-1]
    v_next = vs[:, 1:] * batch.dones[:, 1:].to(vs.dtype)  # zero at terminals
    q_target = batch.rewards + config.gamma * v_next.detach()

    loss_q = sum(((q - q_target) ** 2 * terminal_mask).sum() / n_nonterminal for q in Q)

    diff = min_target - v_cur
    loss_v = (
        (
            (diff >= 0).float() * config.tau * diff**2
            + (diff < 0).float() * (1 - config.tau) * diff**2
        )
        * terminal_mask
    ).sum() / n_nonterminal

    loss_cql = sum((_ce(q, actions) * terminal_mask).sum() / n_nonterminal for q in qs)

    attn = batch.attention_mask[:, 1:].float()
    awac_ce = _ce(logits[:, :-1], batch.input_ids[:, 1:])
    loss_awac = (awac_ce * attn).sum() / attn.sum().clamp_min(1.0)

    loss = loss_q + loss_v + config.cql_scale * loss_cql + config.awac_scale * loss_awac
    stats = {
        "losses/total_loss": loss,
        "losses/loss_q": loss_q,
        "losses/loss_v": loss_v,
        "losses/loss_cql": loss_cql,
        "losses/loss_awac": loss_awac,
        "values/q_mean": (Q[0] * terminal_mask).sum() / n_nonterminal,
        "values/v_mean": (v_cur * terminal_mask).sum() / n_nonterminal,
    }
    if health:
        from trlx_tpu_torch.ops.ppo_math import policy_entropy

        with torch.no_grad():
            ent = policy_entropy(logits[:, :-1])
            stats["health/entropy"] = (ent * attn).sum() / attn.sum().clamp_min(1.0)
            # a finite fill, never -inf: the fetched value feeds EWMA state
            stats["health/q_max"] = torch.where(
                terminal_mask > 0, Q[0], torch.full_like(Q[0], -1e30)).max()
            stats["health/td_error_mean"] = (
                (Q[0] - q_target).abs() * terminal_mask).sum() / n_nonterminal
    return loss, {k: v.detach() for k, v in stats.items()}


@torch.no_grad()
def polyak_update(
    params: Iterable[torch.Tensor], target_params: Iterable[torch.Tensor], alpha: float
) -> None:
    """``target <- alpha * params + (1 - alpha) * target``, in place, with
    the JAX package's rounding (``torch.lerp`` rounds differently)."""
    for p, t in zip(params, target_params):
        t.copy_(alpha * p + (1 - alpha) * t)
