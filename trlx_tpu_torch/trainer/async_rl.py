"""Asynchronous actor-learner PPO (counterpart of
:mod:`trlx_tpu.trainer.async_rl`).

- The **actors** are the continuous-batching engine
  (:mod:`trlx_tpu_torch.inference.engine`): finished rollouts land in the
  buffer's stream store (:mod:`trlx_tpu_torch.pipeline.ppo_buffer`), each
  row tagged with the behaviour-policy **version** it was admitted under.
- The **learner** runs each planned epoch-1 minibatch as soon as its rows
  have landed, and while the actors still have work in flight pushes a
  copy of the refreshed policy to the engine
  (``engine.push_weights``), which applies it at its next safe point.
  The per-token behaviour logprobs are recorded at decode time, so PPO's
  importance ratio stays exact about what generated each token.
- The **version-lag guard** (:func:`guard_allows`) defers an update
  whenever it would put an in-flight rollout more than
  ``staleness_window`` learner versions behind.

``staleness_window: 0`` defers every update while anything is in flight:
the phase runs its plan after collection, equal bit for bit to the serial
run of the same plan, with no weight push.

A dead actor (any engine-layer failure, the ``engine.admit`` fault site
included) becomes an ``actor-dead`` health event and
:class:`ActorDeadError`, which the resilience supervisor retries from the
last checkpoint. The ``staleness-breach`` detector reads each phase's
largest staleness (``async/staleness``).

The learner and the engine share one device and one CUDA stream: the
learner's launches are ordered between the engine's, as the JAX package's
single controller orders its dispatches.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Optional


class ActorDeadError(RuntimeError):
    """An actor (the rollout engine) died or stalled mid-phase. The
    supervisor (:func:`trlx_tpu_torch.resilience.supervisor.failure_kind`)
    classifies it retriable: the learner's last checkpoint is intact and a
    restart builds a fresh engine."""


@dataclass(frozen=True)
class AsyncRLConfig:
    """The parsed ``train.async_rl`` section.

    :param enabled: off (the default) changes nothing. On, the PPO phase
        runs the actor-learner schedule above; it needs
        ``train.rollout.engine: continuous`` and ``train.phase_overlap``.
    :param staleness_window: the most learner updates any in-flight
        rollout's behaviour version may lag; ``0`` is the bitwise-serial
        mode. Also the ``staleness-breach`` detector's default threshold.
    :param actor_fraction: the share of the devices the engine runs on, in
        (0, 1]. The port trains on one device, where the JAX package's
        ``actor_submesh`` returns ``None`` for every fraction: the actors
        share the learner's device whatever the value. A device subset of
        its own waits for multi-GPU training (ROADMAP item 14).
    """

    enabled: bool = False
    staleness_window: int = 1
    actor_fraction: float = 1.0

    def __post_init__(self):
        if self.staleness_window < 0:
            raise ValueError(
                f"train.async_rl.staleness_window="
                f"{self.staleness_window} must be >= 0 (0 = the "
                "bitwise-serial degenerate mode)"
            )
        if not 0.0 < self.actor_fraction <= 1.0:
            raise ValueError(
                f"train.async_rl.actor_fraction={self.actor_fraction} "
                "must be in (0, 1]"
            )

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "AsyncRLConfig":
        d = dict(d or {})
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"Unknown train.async_rl keys: {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        if d.get("staleness_window") is not None:
            d["staleness_window"] = int(d["staleness_window"])
        if d.get("actor_fraction") is not None:
            d["actor_fraction"] = float(d["actor_fraction"])
        return cls(**d)


def guard_allows(
    learner_version: int,
    min_inflight_version: Optional[int],
    staleness_window: int,
) -> bool:
    """The version-lag guard: may the learner run its next update?

    ``min_inflight_version`` is the oldest behaviour version any
    not-yet-harvested rollout will carry
    (:meth:`~trlx_tpu_torch.inference.engine.ContinuousBatchingEngine.min_inflight_version`);
    ``None`` (nothing in flight) always allows. Otherwise the update is
    allowed when the oldest in-flight work stays within the window after
    it: ``(learner_version + 1) - min_inflight_version <=
    staleness_window``."""
    if min_inflight_version is None:
        return True
    return (learner_version + 1) - min_inflight_version <= staleness_window


__all__ = ["ActorDeadError", "AsyncRLConfig", "guard_allows"]
