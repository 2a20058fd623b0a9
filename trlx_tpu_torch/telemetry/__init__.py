"""Run telemetry (counterpart of :mod:`trlx_tpu.telemetry`):

- :mod:`~trlx_tpu_torch.telemetry.tracer`: spans on one monotonic clock,
  the phase loop's single timing source (``with telemetry.span(
  "phase/collect"): ...``), per-name p50/p95 stats and a chrome-trace
  JSONL exporter;
- :mod:`~trlx_tpu_torch.telemetry.metrics`: the typed rank-0 metrics
  registry (counters, gauges with sample rings, histograms) that absorbs
  the ``exp/*``, ``engine/*``, ``async/*`` and ``mem/*`` stats;
  ``telemetry.get_metrics()``;
- :mod:`~trlx_tpu_torch.telemetry.device_metrics`: the card's allocator
  gauges (``torch.cuda.memory_stats``);
- :mod:`~trlx_tpu_torch.telemetry.profiler`: ``torch.profiler`` windows,
  ``train.profile_phase: N`` exports one chrome trace of exactly phase N;
- :mod:`~trlx_tpu_torch.telemetry.health`: run-health detectors over the
  per-update stats rows (``train.health``);
- :mod:`~trlx_tpu_torch.telemetry.flight_recorder`: crash forensics, a
  bounded ring of phase records dumped as one JSON file;
- :mod:`~trlx_tpu_torch.telemetry.run_ledger`: per-run manifests appended
  to a ledger JSONL (``train.run_dir``, ``TRLX_RUN_LEDGER``);
  ``python -m trlx_tpu_torch.telemetry --inspect/--compare/--watch``;
- :mod:`~trlx_tpu_torch.telemetry.request_trace`: the serving tier's
  per-request span chains (``serve/request`` and its disjoint stages),
  emitted at harvest from the layers' host marks;
- :mod:`~trlx_tpu_torch.telemetry.trace_report`: the critical-path,
  tenant-tail and decode-bubble report over an exported span log
  (``python -m trlx_tpu_torch.telemetry --trace-report``).

Attribution (``attribution.py``, ``device_metrics.static_vs_measured``)
is ROADMAP item 19's remainder.

The module-level :func:`span` / :func:`get_tracer` API routes through one
process-global tracer, enabled by default on the main process only
(rank-0 gating); ``TRLX_TELEMETRY=0/1`` overrides. Importing this package
imports no ``torch``: the rank check imports
:mod:`trlx_tpu_torch.parallel.distributed` on first use.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional

from trlx_tpu_torch.telemetry.tracer import (  # noqa: F401
    DEFAULT_RING_SIZE,
    NULL_SPAN,
    Span,
    Tracer,
    chrome_counter_events,
    chrome_trace_events,
    chrome_trace_from_jsonl,
    env_ring_size,
    export_chrome_jsonl,
    monotonic,
    quantile,
)
from trlx_tpu_torch.telemetry.metrics import (  # noqa: F401  (after tracer: shares its clock)
    NULL_INSTRUMENT,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    configure_metrics,
    flatten_snapshot,
    get_metrics,
    scoped_metrics,
    split_metric_label,
)

__all__ = [
    "DEFAULT_RING_SIZE",
    "NULL_SPAN",
    "Span",
    "Tracer",
    "chrome_counter_events",
    "chrome_trace_events",
    "chrome_trace_from_jsonl",
    "configure",
    "configure_from_dict",
    "configure_metrics",
    "env_ring_size",
    "export_chrome_jsonl",
    "get_metrics",
    "get_tracer",
    "monotonic",
    "now",
    "quantile",
    "scoped_metrics",
    "scoped_tracer",
    "span",
    "warn_on_span_drops",
]

_tracer: Optional[Tracer] = None


def _default_enabled() -> bool:
    env = os.environ.get("TRLX_TELEMETRY", "").lower()
    if env in ("0", "false", "off"):
        return False
    if env in ("1", "true", "on"):
        return True
    try:
        # rank-0 gating (several processes trace on the main one only);
        # lazy, so that importing telemetry imports no torch
        from trlx_tpu_torch.parallel.distributed import is_main_process

        return is_main_process()
    except Exception:
        return True


def get_tracer() -> Tracer:
    """The process-global tracer (created on first use; ring capacity
    from ``TRLX_TELEMETRY_RING`` when set)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer(
            enabled=_default_enabled(), max_records=env_ring_size()
        )
    return _tracer


def span(name: str, force: bool = False, **attrs):
    """Open a span on the global tracer (see :meth:`Tracer.span`)."""
    return get_tracer().span(name, force=force, **attrs)


def now() -> float:
    """The shared monotonic clock, in seconds."""
    return monotonic()


@contextmanager
def scoped_tracer(tracer: Optional[Tracer] = None):
    """Temporarily install ``tracer`` (default: a fresh enabled one) as
    the process-global tracer; the previous tracer — records, enabled
    flag, everything — is restored on exit. Harnesses that drive
    instrumented code (the tests) use this so their measurement
    neither wipes nor leaks into the caller's span history."""
    global _tracer
    prev = get_tracer()
    installed = tracer if tracer is not None else Tracer(enabled=True)
    _tracer = installed
    try:
        yield installed
    finally:
        _tracer = prev


_drops_warned = False


def warn_on_span_drops(tracer: Optional[Tracer] = None) -> int:
    """Return the tracer's ``dropped`` count, warning ONCE on stderr
    when it is nonzero. Silent ring evictions skew every per-name p50
    (the oldest — often slowest, compile-bearing — spans vanish first),
    so any consumer aggregating span stats for a report should surface
    this."""
    global _drops_warned
    t = tracer if tracer is not None else get_tracer()
    dropped = int(t.dropped)
    if dropped and not _drops_warned:
        import sys

        print(
            f"warning: span ring dropped {dropped} spans (oldest "
            "evicted) — per-name p50/p95 stats cover a truncated "
            "window; raise the ring with "
            "telemetry.configure(max_records=...)",
            file=sys.stderr,
        )
        _drops_warned = True
    return dropped


def configure(
    enabled: Optional[bool] = None, max_records: Optional[int] = None
) -> Tracer:
    """Adjust the global tracer; returns it. ``max_records`` resizes
    the ring (newest records kept; forced evictions count as dropped)."""
    tracer = get_tracer()
    if enabled is not None:
        tracer.enabled = bool(enabled)
    if max_records is not None:
        tracer.set_max_records(max_records)
    return tracer


def configure_from_dict(d) -> Tracer:
    """Apply the ``train.telemetry`` config section (and return the
    global tracer). One knob today — ``ring_size``, the span-ring
    capacity (an evicting ring truncates every per-name span
    statistic). Unknown keys refuse loudly, like every other config
    section. Precedence: an explicit ``TRLX_TELEMETRY_RING`` env var wins over
    the config — the operator at the terminal outranks the YAML."""
    d = dict(d or {})
    known = {"ring_size"}
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"Unknown train.telemetry keys: {sorted(unknown)} "
            f"(known: {sorted(known)})"
        )
    ring = d.get("ring_size")
    if ring is not None:
        # validate BEFORE precedence: a bad YAML value must refuse on
        # every machine, not only the ones without an env override
        ring = int(ring)
        if ring < 1:
            raise ValueError(
                f"train.telemetry.ring_size={ring} must be >= 1"
            )
        # a VALID env override wins; a malformed one (which
        # env_ring_size already ignores) must not ALSO block the
        # config — validity decides precedence, not mere presence
        raw = os.environ.get("TRLX_TELEMETRY_RING")
        try:
            env_valid = raw is not None and int(raw) > 0
        except ValueError:
            env_valid = False
        if not env_valid:
            return configure(max_records=ring)
    return get_tracer()
