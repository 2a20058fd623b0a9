"""Structured span tracer on one monotonic clock (counterpart of
:mod:`trlx_tpu.telemetry.tracer`; the port keeps its own copy).

A :class:`Span` is a context manager stamped from ONE monotonic clock
(:func:`monotonic`, which :mod:`trlx_tpu_torch.utils` re-exports as the
port's clock), nested via a per-thread stack, exception-safe (the span
closes with ``status="error"`` and re-raises), and recorded into a bounded
ring that the run ledger, the flight recorder and the chrome-trace
exporter read.

Cost model, because spans sit on the collect critical path:

- **enabled** (default on rank 0): two ``time.monotonic()`` calls, one
  list push/pop, one deque append per span: no device work, no
  synchronisation. Any ``torch.cuda.synchronize`` belongs to the
  *instrumented code*, never to the tracer; spans are placed only at
  boundaries that already synchronise (the drain, the residual epochs,
  the phase end).
- **disabled**: :func:`Tracer.span` returns the shared :data:`NULL_SPAN`
  singleton: one attribute read and a call, nothing allocated.
- **forced** (``force=True``): measured even when the tracer is disabled
  (so span durations can be the single source of always-on stats like
  ``exp/overlap_drain_ms``) but recorded only when enabled. Use it for
  the phase-boundary spans whose durations feed reported stats; never in
  per-token loops.

The module imports only the standard library, so the port's low-level
utilities can take their clock from here, and a span can never touch the
device.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

#: The single monotonic clock (seconds). Every reported duration in the
#: port (the Logger, spans, the engine's request marks) derives from this.
monotonic: Callable[[], float] = time.monotonic

#: default span-ring capacity; override per process with the
#: ``TRLX_TELEMETRY_RING`` env var or ``train.telemetry.ring_size``
#: (per-request serving spans multiply span volume)
DEFAULT_RING_SIZE = 65536


def env_ring_size() -> int:
    """The span-ring capacity the environment asks for
    (``TRLX_TELEMETRY_RING``), falling back to :data:`DEFAULT_RING_SIZE`.
    A malformed value falls back too — a typo must not kill the run that
    was trying to observe itself."""
    raw = os.environ.get("TRLX_TELEMETRY_RING", "")
    try:
        n = int(raw)
    except ValueError:
        return DEFAULT_RING_SIZE
    return n if n > 0 else DEFAULT_RING_SIZE


class _NullSpan:
    """Shared no-op span returned while the tracer is disabled."""

    __slots__ = ()

    name = ""
    status = "ok"
    start = 0.0
    end = 0.0
    depth = 0
    parent = None
    index = -1
    duration_ms = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One timed region. Use as a context manager:

    ``with tracer.span("phase/collect", rollouts=128) as sp: ...``

    After exit, ``sp.duration_ms`` is the measured wall-clock and
    ``sp.status`` is ``"error"`` if the body raised (the exception
    propagates — a span never swallows)."""

    __slots__ = (
        "name", "attrs", "start", "end", "status",
        "index", "parent", "depth", "thread_id", "thread_name", "_tracer",
    )

    def __init__(
        self,
        name: str,
        attrs: Optional[Dict[str, Any]] = None,
        tracer: Optional["Tracer"] = None,
    ):
        self.name = name
        self.attrs: Dict[str, Any] = attrs or {}
        self.start = 0.0
        self.end = 0.0
        self.status = "ok"
        self.index = -1
        self.parent: Optional[int] = None
        self.depth = 0
        self.thread_id = 0
        self.thread_name = ""
        self._tracer = tracer  # None: forced-but-unrecorded span

    @property
    def duration_ms(self) -> float:
        return max(0.0, (self.end - self.start) * 1000.0)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        if self._tracer is not None:
            self._tracer._open(self)
        self.start = monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end = monotonic()
        if exc_type is not None:
            self.status = "error"
        if self._tracer is not None:
            self._tracer._close(self)
        return False  # never swallow

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "start_s": self.start,
            "duration_ms": self.duration_ms,
            "depth": self.depth,
            "index": self.index,
            "parent": self.parent,
            "status": self.status,
            "attrs": dict(self.attrs),
        }


class Tracer:
    """Thread-safe span recorder with a bounded ring buffer.

    The per-thread span stack gives nesting (parent/depth) for free on
    whatever thread opens the span; completed spans land in one shared
    deque (``maxlen`` drops the oldest — ``dropped`` counts them so a
    truncated trace is visible, never silent)."""

    def __init__(
        self, enabled: bool = True, max_records: int = DEFAULT_RING_SIZE
    ):
        self.enabled = enabled
        self.dropped = 0
        self._records: "deque[Span]" = deque(maxlen=max_records)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._next_index = 0

    # ------------------------------- API -------------------------------- #

    def span(self, name: str, force: bool = False, **attrs):
        """A new span (or :data:`NULL_SPAN` when disabled and not
        forced). ``force=True`` spans measure time regardless of the
        enabled flag but are only *recorded* when enabled."""
        if not self.enabled:
            return Span(name, attrs or None, None) if force else NULL_SPAN
        return Span(name, attrs or None, self)

    def record(self, span: Span, parent: Optional[int] = None) -> Optional[int]:
        """Record an externally-stamped span — explicit ``start``/``end``
        already set by the caller, never touching the per-thread stack.

        Spans built retrospectively (the JAX package's per-request serving
        traces, stamped at harvest long after each stage ran) cannot be
        context managers: the caller stamps start/
        end/thread fields and links parents by recorded index (``parent``
        overrides any pre-set ``span.parent``). Returns the assigned
        index, or ``None`` when the tracer is disabled (nothing recorded
        — the disabled-mode cost contract)."""
        if not self.enabled:
            return None
        if parent is not None:
            span.parent = parent
        with self._lock:
            span.index = self._next_index
            self._next_index += 1
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(span)
        return span.index

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0
            self._next_index = 0

    def set_max_records(self, max_records: int) -> None:
        """Resize the ring, keeping the newest records; evictions a
        shrink forces are counted in ``dropped`` like any other."""
        with self._lock:
            evicted = max(0, len(self._records) - int(max_records))
            self._records = deque(self._records, maxlen=int(max_records))
            self.dropped += evicted

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Completed spans in close order (optionally filtered by name)."""
        with self._lock:
            records = list(self._records)
        if name is not None:
            records = [s for s in records if s.name == name]
        return records

    def last(self, name: str) -> Optional[Span]:
        with self._lock:
            for s in reversed(self._records):
                if s.name == name:
                    return s
        return None

    def ancestors(self, span: Span) -> List[Span]:
        """Enclosing spans of ``span``, innermost first (resolved via
        recorded indices — parents close after children, so by the time
        a tree is inspected the whole chain is in the ring)."""
        by_index = {s.index: s for s in self.spans()}
        out: List[Span] = []
        parent = span.parent
        while parent is not None and parent in by_index:
            s = by_index[parent]
            out.append(s)
            parent = s.parent
        return out

    def stats(self, prefix: str = "") -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregates: count, p50/p95/max/total ms.

        Percentiles use nearest-rank on the closed spans — the perf
        lockfile gates p50 (jitter-robust) and records p95 for tails."""
        groups: Dict[str, List[float]] = {}
        for s in self.spans():
            if prefix and not s.name.startswith(prefix):
                continue
            groups.setdefault(s.name, []).append(s.duration_ms)
        out: Dict[str, Dict[str, float]] = {}
        for name, durs in sorted(groups.items()):
            durs.sort()
            out[name] = {
                "count": float(len(durs)),
                "p50_ms": quantile(durs, 0.5),
                "p95_ms": quantile(durs, 0.95),
                "max_ms": durs[-1],
                "total_ms": sum(durs),
            }
        return out

    # ----------------------------- internal ----------------------------- #

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, span: Span) -> None:
        stack = self._stack()
        with self._lock:
            span.index = self._next_index
            self._next_index += 1
        span.parent = stack[-1].index if stack else None
        span.depth = len(stack)
        thread = threading.current_thread()
        span.thread_id = thread.ident or 0
        span.thread_name = thread.name
        stack.append(span)

    def _close(self, span: Span) -> None:
        stack = self._stack()
        # exception-tolerant pop: an abandoned inner span (a generator
        # that never resumed, say) must not wedge the stack forever
        while stack:
            top = stack.pop()
            if top is span:
                break
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(span)


def quantile(sorted_durs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile of an ascending-sorted sequence."""
    if not sorted_durs:
        return 0.0
    ix = min(len(sorted_durs) - 1, max(0, int(round(q * (len(sorted_durs) - 1)))))
    return sorted_durs[ix]


# --------------------------- Perfetto / chrome --------------------------- #

def chrome_trace_events(spans: Iterable[Span]) -> List[Dict[str, Any]]:
    """Spans as chrome-tracing "complete" (``ph: X``) events: ``ts`` /
    ``dur`` in microseconds on the shared monotonic timebase, ``tid`` =
    the opening thread, span attrs + status under ``args``.

    Prepends chrome ``metadata`` (``ph: M``) name events — one
    ``process_name`` plus a ``thread_name`` per distinct tid — so
    Perfetto/chrome:tracing label the tracks with real thread names
    (main loop vs the background writer) instead of bare integer tids."""
    pid = os.getpid()
    complete = []
    tid_names: Dict[int, str] = {}
    for s in spans:
        name = getattr(s, "thread_name", "") or f"tid-{s.thread_id}"
        tid_names.setdefault(s.thread_id, name)
        complete.append(
            {
                "name": s.name,
                "ph": "X",
                "ts": round(s.start * 1e6, 3),
                "dur": round((s.end - s.start) * 1e6, 3),
                "pid": pid,
                "tid": s.thread_id,
                "args": {**s.attrs, "status": s.status, "depth": s.depth},
            }
        )
    if not complete:
        return []
    meta: List[Dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            # the project's name: traces from either package load alike
            "args": {"name": "trlx_tpu"},
        }
    ]
    for tid, name in sorted(tid_names.items()):
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": name},
            }
        )
    return meta + complete


def chrome_counter_events(
    series: Dict[str, Sequence[tuple]],
) -> List[Dict[str, Any]]:
    """Gauge timeseries as chrome-tracing counter-track (``ph: C``)
    events, so memory/occupancy ride alongside the span tracks in one
    Perfetto timeline: ``series`` maps a counter name (``mem/hbm_live``,
    ``engine/slot_util``) to ``(t, value)`` samples on the shared
    monotonic timebase — exactly what
    :meth:`~trlx_tpu_torch.telemetry.metrics.MetricsRegistry.gauge_series`
    returns. Perfetto draws each name as its own stepped area chart."""
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    for name in sorted(series):
        for t, value in series[name]:
            events.append(
                {
                    "name": name,
                    "ph": "C",
                    "ts": round(t * 1e6, 3),
                    "pid": pid,
                    "args": {"value": value},
                }
            )
    return events


def export_chrome_jsonl(
    path: str,
    spans: Iterable[Span],
    writer=None,
    counters: Optional[Dict[str, Sequence[tuple]]] = None,
) -> int:
    """Append the span stream to ``path`` as JSONL (one trace event per
    line). Returns the number of events written.

    Pass a caller-owned ``BackgroundJSONLWriter`` (``utils/
    async_writer.py``) to queue the write off your critical path — you
    own its flush/close cadence, exactly as rollout logging does. With
    no writer the write is plain synchronous file I/O (spawning a
    thread just to join it would be the same blocking with extra cost)
    — fine for end-of-run exports, not for per-phase hot paths. Load
    in Perfetto/chrome via :func:`chrome_trace_from_jsonl` (the array
    wrapper).

    ``counters`` adds counter-track events (gauge timeseries — see
    :func:`chrome_counter_events`) to the same file; they share the
    span events' timebase, so a ``mem/hbm_live`` step lines up under
    the phase span that caused it."""
    events = chrome_trace_events(spans)
    if counters:
        events += chrome_counter_events(counters)
    if not events:
        return 0
    if writer is not None:
        writer.submit(path, events)
        return len(events)
    with open(path, "a", encoding="utf-8") as fh:
        fh.write("\n".join(json.dumps(e) for e in events) + "\n")
    return len(events)


def chrome_trace_from_jsonl(jsonl_path: str, out_path: str) -> int:
    """Wrap a span JSONL stream into the JSON-array file
    chrome://tracing and ui.perfetto.dev load directly."""
    events = []
    with open(jsonl_path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump({"traceEvents": events}, fh)
    return len(events)
