"""Supervised auto-resume: bounded restarts from the last good checkpoint
(the port's copy of :mod:`trlx_tpu.resilience.supervisor`).

:func:`trlx_tpu_torch.train` runs each training attempt under
:func:`run_supervised`. With ``train.resilience.enabled`` the supervisor
installs the preemption guard, arms the chaos schedule and classifies
every failure that escapes an attempt:

- **preemption** (:class:`PreemptionDrain`: the trainer has written its
  emergency checkpoint): restart, resuming from it, unless
  ``resume_on_preemption`` is off;
- **retriable** (transient host I/O by the
  :mod:`~trlx_tpu_torch.utils.retry` taxonomy, or a
  :class:`~trlx_tpu_torch.telemetry.health.HealthAbort`): restart from
  the latest good checkpoint;
- **permanent** (a structure mismatch, a config error, a divergence):
  re-raise at once.

Restarts are bounded by ``max_restarts``; past it
:class:`RestartBudgetExhausted` chains the last failure. Each attempt
rebuilds the trainer from scratch and resumes only when a checkpoint
exists. Before a rebuild the failed attempt's exception lets go of its
frames (its type and message stay), the cycles it leaves are collected
and CUDA's cache is emptied, so the card never holds two trainers.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback
from dataclasses import dataclass, field, fields
from typing import Any, Callable, Dict, List, Optional

from trlx_tpu_torch.resilience import chaos, preemption
from trlx_tpu_torch.resilience.preemption import PreemptionDrain
from trlx_tpu_torch.utils.retry import RetryPolicy, classify_io_error, set_default_policy


class RestartBudgetExhausted(RuntimeError):
    """The restart budget ran out; the last failure is the ``__cause__``."""


@dataclass
class ResilienceConfig:
    """``train.resilience``.

    :param enabled: off (the default) changes nothing: no handlers, no
        retry policy of its own, one attempt.
    :param max_restarts: restarts (not attempts) the supervisor may spend.
    :param restart_delay_s: the delay before a restart, doubled per
        restart.
    :param resume_on_preemption: restart in process after a drain (False
        re-raises, so that the scheduler's next job resumes).
    :param preempt_signals: the signals the guard takes.
    :param retry: :class:`~trlx_tpu_torch.utils.retry.RetryPolicy` keys for
        every wrapped I/O path during the run.
    :param chaos: :mod:`~trlx_tpu_torch.resilience.chaos` specs armed for
        the run.
    """

    enabled: bool = False
    max_restarts: int = 2
    restart_delay_s: float = 0.0
    resume_on_preemption: bool = True
    preempt_signals: List[str] = field(default_factory=lambda: ["SIGTERM", "SIGINT"])
    retry: Dict[str, Any] = field(default_factory=dict)
    chaos: List[Dict[str, Any]] = field(default_factory=list)

    @classmethod
    def from_dict(cls, config: Optional[Dict[str, Any]]) -> "ResilienceConfig":
        config = dict(config or {})
        known = {f.name for f in fields(cls)}
        unknown = set(config) - known
        if unknown:
            raise ValueError(
                f"Unknown train.resilience keys: {sorted(unknown)} (known: {sorted(known)})"
            )
        out = cls(**config)
        if out.max_restarts < 0:
            raise ValueError("train.resilience.max_restarts must be >= 0")
        RetryPolicy.from_dict(out.retry)  # refuse bad keys before the run
        return out


def failure_kind(error: BaseException) -> str:
    """``"preemption"``, ``"retriable"`` or ``"permanent"``.

    A HealthAbort is retriable: its detector has dumped the forensics, and
    ``on_error: abort`` under a supervisor means "restore the last good
    checkpoint". The asynchronous actor-learner's ``ActorDeadError`` is
    retriable for the same reason: the orchestrator has emitted the
    ``actor-dead`` event, the learner's checkpoint is intact and a
    restart builds a fresh engine. KeyboardInterrupt and SystemExit are
    never eaten."""
    from trlx_tpu_torch.telemetry.health import HealthAbort
    from trlx_tpu_torch.trainer.async_rl import ActorDeadError

    if isinstance(error, PreemptionDrain):
        return "preemption"
    if isinstance(error, (HealthAbort, ActorDeadError)):
        return "retriable"
    if not isinstance(error, Exception):
        return "permanent"
    if classify_io_error(error) == "transient":
        return "retriable"
    return "permanent"


def release_attempt(error: BaseException) -> None:
    """Let go of everything a failed attempt's exception holds: clear the
    frames of its traceback and of those it chains (their locals hold the
    trainer, its optimizer and CUDA tensors), drop the tracebacks, collect
    the trainer's reference cycles and return CUDA's cached blocks."""
    import torch

    seen, stack = set(), [error]
    while stack:
        exc = stack.pop()
        if exc is None or id(exc) in seen:
            continue
        seen.add(id(exc))
        if exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
            exc.__traceback__ = None
        stack += [exc.__cause__, exc.__context__]
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def run_supervised(attempt: Callable[[bool], Any], config, *,
                   sleep: Callable[[float], None] = time.sleep) -> Any:
    """``attempt(resume)`` under ``config.train``'s resilience section.
    Disabled: exactly one attempt with the caller's
    ``resume_from_checkpoint``, no handler touched."""
    rc = ResilienceConfig.from_dict(config.train.resilience)
    resume = bool(config.train.resume_from_checkpoint)
    if not rc.enabled:
        return attempt(resume)

    from trlx_tpu_torch.utils.checkpoint import has_checkpoint

    preemption.install_guard(rc.preempt_signals)
    if rc.retry:
        set_default_policy(RetryPolicy.from_dict(rc.retry))
    # always: configure() also arms TRLX_CHAOS when the config has no list
    chaos.configure(rc.chaos)
    restarts = 0
    try:
        while True:
            try:
                return attempt(resume)
            except BaseException as error:
                kind = failure_kind(error)
                if kind == "permanent" or (kind == "preemption" and not rc.resume_on_preemption):
                    raise
                restarts += 1
                if restarts > rc.max_restarts:
                    raise RestartBudgetExhausted(
                        f"restart budget exhausted ({rc.max_restarts} restarts) — last "
                        f"failure: {type(error).__name__}: {error}"
                    ) from error
                release_attempt(error)
                preemption.clear_request()
                resume = has_checkpoint(config.train.checkpoint_dir)
                print(
                    f"resilience: restart {restarts}/{rc.max_restarts} after {kind} "
                    f"({type(error).__name__}: {error}) — "
                    + (f"resuming from {config.train.checkpoint_dir!r}" if resume
                       else "no checkpoint yet, starting fresh"),
                    file=sys.stderr,
                )
            if rc.restart_delay_s > 0:
                sleep(rc.restart_delay_s * (2 ** (restarts - 1)))
    finally:
        preemption.uninstall_guard()
        chaos.clear()
        if rc.retry:
            set_default_policy(None)
