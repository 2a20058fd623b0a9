"""Preemption-safe shutdown (the port's copy of
:mod:`trlx_tpu.resilience.preemption`): SIGTERM or SIGINT becomes a drain
at the next phase boundary.

A preemptible GPU's termination notice is a signal, and its default
disposition ends the process mid-phase, in the worst case mid-checkpoint.
:class:`PreemptionGuard` turns the signal into a request flag; the
trainers poll it at their phase boundaries
(:meth:`BaseRLTrainer.maybe_drain
<trlx_tpu_torch.trainer.BaseRLTrainer.maybe_drain>`) and drain: an
emergency checkpoint, joined before anything else happens, the flight
dump, then :class:`PreemptionDrain` (exit code 75, EX_TEMPFAIL, so a
scheduler can tell "preempted, resumable" from a crash). The supervisor
(:mod:`~trlx_tpu_torch.resilience.supervisor`) catches the drain and
resumes from the checkpoint it just wrote, or re-raises, per
``train.resilience.resume_on_preemption``.

Only the main thread can take signals; installing from another thread
warns and leaves the default disposition in place.
"""

from __future__ import annotations

import signal
import sys
import threading
from typing import Dict, Optional, Sequence

#: BSD sysexits' EX_TEMPFAIL: "try again later"
PREEMPTION_EXIT_CODE = 75


class PreemptionDrain(Exception):
    """Raised by the trainer's drain once the emergency checkpoint is on
    disk; carries the resume point."""

    exit_code = PREEMPTION_EXIT_CODE

    def __init__(self, message: str, step: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None):
        super().__init__(message)
        self.step = step
        self.checkpoint_dir = checkpoint_dir


class PreemptionGuard:
    """Handlers that record the signal instead of dying; ``uninstall``
    puts back exactly the handlers ``install`` replaced."""

    def __init__(self, signals: Sequence[str] = ("SIGTERM", "SIGINT")):
        self.signal_names = tuple(signals)
        self._signums = []
        for name in self.signal_names:
            num = getattr(signal, name, None)
            if num is None:
                raise ValueError(f"unknown signal name {name!r}")
            self._signums.append(num)
        self._previous: Dict[int, object] = {}
        self._received: Optional[int] = None
        self._announced = False
        self._installed = False

    def _handler(self, signum, frame) -> None:
        # runs between any two bytecodes of the interrupted thread: one
        # assignment, no print (that thread may hold stderr's lock); the
        # announcement is made at the poll site
        self._received = signum

    def _announce(self) -> None:
        if self._received is not None and not self._announced:
            self._announced = True
            print(f"resilience: received {signal.Signals(self._received).name} — will "
                  "drain at the next phase boundary (emergency checkpoint + flight dump)",
                  file=sys.stderr)

    def install(self) -> bool:
        """Install the handlers; False, with a warning, off the main
        thread, where CPython refuses ``signal.signal``."""
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            print("resilience: preemption guard skipped — signals can only be "
                  "intercepted on the main thread", file=sys.stderr)
            return False
        for num in self._signums:
            self._previous[num] = signal.signal(num, self._handler)
        self._installed = True
        return True

    def uninstall(self) -> None:
        if not self._installed:
            return
        for num, prev in self._previous.items():
            signal.signal(num, prev)
        self._previous.clear()
        self._installed = False

    def requested(self) -> bool:
        self._announce()
        return self._received is not None

    def clear(self) -> None:
        self._received = None
        self._announced = False

    @property
    def received_signal(self) -> Optional[str]:
        if self._received is None:
            return None
        return signal.Signals(self._received).name


# --------------------------- the process's guard --------------------------- #

_guard: Optional[PreemptionGuard] = None


def install_guard(signals: Sequence[str] = ("SIGTERM", "SIGINT")) -> PreemptionGuard:
    """Install (or replace) the process's guard and return it."""
    global _guard
    if _guard is not None:
        _guard.uninstall()
    _guard = PreemptionGuard(signals)
    _guard.install()
    return _guard


def uninstall_guard() -> None:
    global _guard
    if _guard is not None:
        _guard.uninstall()
        _guard = None


def drain_requested() -> bool:
    """Whether a guarded signal arrived (False, never raising, with no
    guard)."""
    return _guard is not None and _guard.requested()


def clear_request() -> None:
    if _guard is not None:
        _guard.clear()


def received_signal() -> Optional[str]:
    return _guard.received_signal if _guard is not None else None
