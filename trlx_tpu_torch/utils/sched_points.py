"""Cooperative-scheduler yield points (the port's copy of
:mod:`trlx_tpu.utils.sched_points`).

Host code that a deterministic interleaving harness may drive calls
:func:`yield_point` at every lock, queue or shared-attribute touch. With no
hook installed the call is one global load and a falsy branch. A scheduler
that installs a hook parks the calling thread there and picks the next
runnable thread from a seeded RNG, so every interleaving is replayable.
The port has no such scheduler yet (the race auditor is ROADMAP item 21);
the engine's weight-push lock already goes through :func:`guard`.

Threads created inside instrumented code call :func:`announce_thread`
right after ``Thread.start()`` so the scheduler adopts them before they do
any observable work.

This module is dependency-free: it must be importable from the deepest
utility layers without cycles.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Iterator, Optional

# Single mutable cell so the fast path is one global read. Writes happen
# only from install()/uninstall() under _hook_lock; readers tolerate
# staleness (a late no-op yield is harmless).
_HOOK: Optional[Callable[[str], None]] = None
_ANNOUNCE: Optional[Callable[[threading.Thread], None]] = None
_hook_lock = threading.Lock()


def yield_point(tag: str) -> None:
    """Mark a schedulable point named ``tag`` (e.g. ``writer.enqueue``).

    No-op unless a scheduler installed a hook. Production call sites pay
    one global load when uninstrumented.
    """
    hook = _HOOK
    if hook is not None:
        hook(tag)


def announce_thread(thread: threading.Thread) -> None:
    """Tell an installed scheduler about a thread created by
    instrumented code, so it is adopted before it runs observably."""
    announce = _ANNOUNCE
    if announce is not None:
        announce(thread)


@contextmanager
def guard(lock: threading.Lock, tag: str) -> Iterator[None]:
    """``with guard(self._lock, "writer.lock"):`` — a plain ``with lock``
    when uninstrumented; under the scheduler it yields before acquiring
    and spins acquire(blocking=False)+yield on contention, so a thread
    parked *inside* a critical section can never wedge the schedule
    (the contender parks instead of blocking in C)."""
    hook = _HOOK
    if hook is None:
        with lock:
            yield
        return
    hook(tag)
    while not lock.acquire(blocking=False):
        hook(tag + ".wait")
    try:
        yield
    finally:
        lock.release()


def instrumented() -> bool:
    """True while a scheduler hook is installed (lets blocking calls
    switch to poll-and-yield loops the scheduler can serialize)."""
    return _HOOK is not None


def install(
    hook: Callable[[str], None],
    announce: Optional[Callable[[threading.Thread], None]] = None,
) -> None:
    """Install the scheduler hook. Exactly one scheduler may be active."""
    global _HOOK, _ANNOUNCE
    with _hook_lock:
        if _HOOK is not None:
            raise RuntimeError("a sched_points hook is already installed")
        _HOOK = hook
        _ANNOUNCE = announce


def uninstall() -> None:
    """Remove the scheduler hook; always runs in a finally block of the
    harness so a crashed schedule cannot leave production code parked."""
    global _HOOK, _ANNOUNCE
    with _hook_lock:
        _HOOK = None
        _ANNOUNCE = None
