"""Deterministic fault injection at named host-side sites (the port's copy
of :mod:`trlx_tpu.resilience.chaos`).

Code on a recovery path calls :func:`check` at each *site*; with no spec
configured the call is one list-emptiness test. A configured spec fires at
its site, matched by ``(site, phase, step)``, for exactly ``count``
triggers and then goes quiet, which is how a transient failure (fails
twice, then the filesystem recovers) is made reproducible.

==================  ====================================================
site                where / what a spec injects
==================  ====================================================
``checkpoint.save`` :mod:`~trlx_tpu_torch.utils.checkpoint`'s write (on
                    the writer thread under ``async_checkpoint``):
                    ``error`` a transient OSError, ``permanent`` a
                    structure mismatch
``checkpoint.load`` the checkpoint read, the same modes
``writer.write``    the background JSONL writer's file append
                    (``disk_full`` = ENOSPC)
``engine.admit``    :meth:`ContinuousBatchingEngine.submit
                    <trlx_tpu_torch.inference.engine.ContinuousBatchingEngine.submit>`:
                    an admission failure on the rollout engine or the
                    inference server
``logger.emit``     accepted in a spec for the JAX package's schedules;
                    nothing in the port fires it: the JAX site wraps its
                    Logger's wandb emission, and the port's Logger writes
                    JSON lines only
``preempt``         the trainer's phase boundary: a real SIGTERM to this
                    process (the preemption drain then runs)
``slow_step``       the trainer's phase boundary: a host ``stall`` of
                    ``delay_s`` seconds
==================  ====================================================

Specs come from :func:`configure` (the supervisor passes
``train.resilience.chaos``) and from the ``TRLX_CHAOS`` environment
variable (a JSON list of spec dicts), which is armed even when the
config's list is empty. Every firing is kept in :func:`events`.
"""

from __future__ import annotations

import errno
import json
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Sequence, Union

SITES = (
    "checkpoint.save",
    "checkpoint.load",
    "writer.write",
    "engine.admit",
    "logger.emit",
    "preempt",
    "slow_step",
)

MODES = ("error", "permanent", "disk_full", "preempt", "stall")

#: the environment variable holding a JSON list of spec dicts
ENV_VAR = "TRLX_CHAOS"


class ChaosInjectedIOError(OSError):
    """An injected transient I/O failure (transient through its OSError
    base in :func:`~trlx_tpu_torch.utils.retry.classify_io_error`)."""


class ChaosInjectedStructureError(ValueError):
    """An injected permanent failure, worded as a structure mismatch so
    that :mod:`~trlx_tpu_torch.utils.checkpoint` translates it as it does
    a real one."""


@dataclass
class ChaosSpec:
    """One scheduled injection.

    :param site: a name of :data:`SITES`.
    :param mode: ``error`` (transient OSError), ``permanent`` (structure
        mismatch ValueError), ``disk_full`` (ENOSPC), ``preempt`` (SIGTERM
        to this process), ``stall`` (a host sleep of ``delay_s``).
    :param phase: fire only when the site reports this phase (None: any).
    :param step: fire only at this step (None: any).
    :param count: firings before the spec goes quiet.
    :param delay_s: the stall's length for ``mode="stall"``.
    """

    site: str
    mode: str = "error"
    phase: Optional[int] = None
    step: Optional[int] = None
    count: int = 1
    delay_s: float = 0.0
    remaining: int = field(init=False, default=0)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown chaos site {self.site!r}; known: {SITES}")
        if self.mode not in MODES:
            raise ValueError(f"unknown chaos mode {self.mode!r}; known: {MODES}")
        if self.count < 1:
            raise ValueError("chaos spec count must be >= 1")
        self.remaining = int(self.count)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "ChaosSpec":
        known = {f.name for f in fields(cls) if f.init}
        unknown = set(config) - known
        if unknown:
            raise ValueError(
                f"Unknown chaos-spec keys: {sorted(unknown)} (known: {sorted(known)})"
            )
        return cls(**config)


class ChaosController:
    """A process-wide injection schedule; thread-safe (the checkpoint and
    rollout writer threads and the train loop reach sites at once)."""

    def __init__(self):
        self._specs: List[ChaosSpec] = []
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def configure(self, specs: Sequence[Union[ChaosSpec, Dict[str, Any]]]) -> None:
        """Replace the schedule, and clear the event log, with ``specs``
        and those of :data:`ENV_VAR`."""
        parsed = [s if isinstance(s, ChaosSpec) else ChaosSpec.from_dict(s) for s in specs]
        parsed += _env_specs()
        with self._lock:
            self._specs = parsed
            self._events = []

    def clear(self) -> None:
        with self._lock:
            self._specs = []
            self._events = []

    def active(self) -> bool:
        return bool(self._specs)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def check(self, site: str, *, phase: Optional[int] = None,
              step: Optional[int] = None) -> None:
        """Fire the first matching armed spec (raise, signal or stall by
        its mode); with no spec, one truthiness test."""
        if not self._specs:
            return
        with self._lock:
            spec = self._match(site, phase, step)
            if spec is None:
                return
            spec.remaining -= 1
            self._events.append({"site": site, "mode": spec.mode, "phase": phase,
                                 "step": step, "remaining": spec.remaining})
        _fire(spec, site)

    def _match(self, site: str, phase: Optional[int],
               step: Optional[int]) -> Optional[ChaosSpec]:
        for spec in self._specs:
            if spec.site != site or spec.remaining <= 0:
                continue
            if spec.phase is not None and spec.phase != phase:
                continue
            if spec.step is not None and spec.step != step:
                continue
            return spec
        return None


def _env_specs() -> List[ChaosSpec]:
    raw = os.environ.get(ENV_VAR, "")
    if not raw:
        return []
    try:
        entries = json.loads(raw)
    except json.JSONDecodeError as e:
        raise ValueError(f"{ENV_VAR} must be a JSON list of chaos-spec dicts: {e}") from e
    return [ChaosSpec.from_dict(d) for d in entries]


def _fire(spec: ChaosSpec, site: str) -> None:
    print(f"chaos: injecting {spec.mode!r} at site {site!r} "
          f"({spec.remaining} firings left)", file=sys.stderr)
    if spec.mode == "error":
        raise ChaosInjectedIOError(errno.EIO, f"chaos: injected transient I/O error at {site}")
    if spec.mode == "disk_full":
        raise ChaosInjectedIOError(errno.ENOSPC, f"chaos: injected disk-full at {site}")
    if spec.mode == "permanent":
        raise ChaosInjectedStructureError(
            f"chaos: injected checkpoint structure mismatch at {site} "
            "(tree structures do not match)"
        )
    if spec.mode == "preempt":
        # a real signal: the preemption guard's handler (or, with no guard,
        # the default disposition) runs as under a scheduler's SIGTERM
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if spec.mode == "stall":
        time.sleep(max(float(spec.delay_s), 0.0))


# ------------------------- the process's controller ------------------------ #

_controller = ChaosController()


def configure(specs: Sequence[Union[ChaosSpec, Dict[str, Any]]]) -> None:
    _controller.configure(specs)


def clear() -> None:
    _controller.clear()


def active() -> bool:
    return _controller.active()


def events() -> List[Dict[str, Any]]:
    return _controller.events()


def check(site: str, *, phase: Optional[int] = None, step: Optional[int] = None) -> None:
    _controller.check(site, phase=phase, step=step)
