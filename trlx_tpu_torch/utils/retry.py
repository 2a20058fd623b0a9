"""Bounded exponential backoff for host-side I/O (the port's copy of
:mod:`trlx_tpu.utils.retry`).

A flaky filesystem under the checkpoint directory or a momentarily full
disk under the rollout log must not end a long run; a checkpoint whose
layout changed, a config typo or a programming error must keep failing
at once. :func:`retry_call` draws that line with a ``classify`` function
that maps each exception to ``"transient"`` (retried with backoff,
bounded by attempts and an optional wall-clock budget) or
``"permanent"`` (re-raised at once). :func:`classify_io_error` is the
default taxonomy, shared by checkpoint save and load
(:mod:`~trlx_tpu_torch.utils.checkpoint`), the background rollout writer
and the server's admission.

Every retry is appended to the bounded :data:`retry_log`, so tests and
``chip_smoke.py`` can count the retries a scenario took.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, List, Optional

from trlx_tpu_torch.utils import monotonic

#: permanent whatever the filesystem's state: the path itself is wrong,
#: and a retry fails the same way
PERMANENT_IO_ERRORS = (
    FileNotFoundError,
    NotADirectoryError,
    IsADirectoryError,
    PermissionError,
)

#: transient OS and network failures
TRANSIENT_IO_ERRORS = (
    TimeoutError,
    ConnectionError,
    BrokenPipeError,
    InterruptedError,
)


def classify_io_error(error: BaseException) -> str:
    """``"transient"`` or ``"permanent"`` for a host I/O failure: any other
    :class:`OSError` (EIO, ENOSPC, ESTALE) is transient, since the
    environment may recover; any exception outside the OSError family
    (a ValueError, TypeError or KeyError) is permanent, since retrying a
    deterministic Python error only delays it."""
    if isinstance(error, PERMANENT_IO_ERRORS):
        return "permanent"
    if isinstance(error, TRANSIENT_IO_ERRORS):
        return "transient"
    if isinstance(error, OSError):
        return "transient"
    return "permanent"


@dataclass
class RetryPolicy:
    """Backoff ``base_delay_s * multiplier^k``, each wait capped at
    ``max_delay_s``, at most ``max_attempts`` calls and, unless it is None,
    ``timeout_s`` seconds in all."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    timeout_s: Optional[float] = None

    @classmethod
    def from_dict(cls, config: Optional[Dict[str, Any]]) -> "RetryPolicy":
        config = dict(config or {})
        known = {f.name for f in fields(cls)}
        unknown = set(config) - known
        if unknown:
            raise ValueError(
                f"Unknown retry-policy keys: {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        out = cls(**config)
        if out.max_attempts < 1:
            raise ValueError("retry max_attempts must be >= 1")
        return out


# the module default; the resilience supervisor sets it from
# ``train.resilience.retry`` for the supervised run, so one config section
# tunes every wrapped I/O path
_default_policy = RetryPolicy()


def default_policy() -> RetryPolicy:
    return _default_policy


def set_default_policy(policy: Optional[RetryPolicy]) -> None:
    global _default_policy
    _default_policy = policy or RetryPolicy()


#: the retries this process made, newest last, at most ``_RETRY_LOG_CAP``:
#: ``{"what", "attempt", "delay_s", "error"}``
retry_log: List[Dict[str, Any]] = []
_RETRY_LOG_CAP = 256


def reset_retry_log() -> None:
    retry_log.clear()


def _note_retry(what: str, attempt: int, delay: float, error: BaseException) -> None:
    retry_log.append({
        "what": what,
        "attempt": attempt,
        "delay_s": round(delay, 4),
        "error": f"{type(error).__name__}: {error}",
    })
    if len(retry_log) > _RETRY_LOG_CAP:
        del retry_log[: len(retry_log) - _RETRY_LOG_CAP]
    print(
        f"retry: {what} failed transiently ({type(error).__name__}: {error}); "
        f"attempt {attempt} — backing off {delay:.2f}s",
        file=sys.stderr,
    )


def retry_call(
    fn: Callable[[], Any],
    *,
    policy: Optional[RetryPolicy] = None,
    classify: Callable[[BaseException], str] = classify_io_error,
    describe: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """``fn()``, retried with bounded backoff while it fails transiently.

    A permanent error, and a transient one past the attempt or time
    budget, re-raises unchanged (callers keep their own translation)."""
    policy = policy or default_policy()
    delay = policy.base_delay_s
    started = monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except Exception as error:
            if classify(error) != "transient" or attempt >= policy.max_attempts:
                raise
            if (policy.timeout_s is not None
                    and (monotonic() - started) + delay > policy.timeout_s):
                raise
            _note_retry(describe, attempt, delay, error)
            sleep(delay)
            delay = min(delay * policy.multiplier, policy.max_delay_s)
