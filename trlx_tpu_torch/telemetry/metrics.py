"""Typed rank-0 metrics registry: one snapshot-able namespace (counterpart
of :mod:`trlx_tpu.telemetry.metrics`; the port keeps its own copy).

The :class:`MetricsRegistry` absorbs the port's ad-hoc stats dicts (the
collect row with the engine's ``engine/*`` occupancy, the trainer's
``_last_overlap_stats`` with ``exp/overlap_*``, ``async/*`` and ``mem/*``)
into three typed instruments:

- :class:`Counter`: monotone ``inc()``; totals;
- :class:`Gauge`: ``set()`` last-value, plus a bounded ``(t, value)``
  sample ring on the tracer's clock, so a gauge is also a timeseries (the
  chrome counter-track export reads it);
- :class:`Histogram`: ``observe()`` with cumulative count/sum/min/max and
  a bounded window for p50/p95.

``snapshot()`` renders the whole namespace as plain JSON-able dicts, which
the run ledger and the flight recorder embed.

Cost model, as the tracer's: **enabled**, one dict lookup per access plus
one float op per mutation; **disabled**, every accessor returns the shared
:data:`NULL_INSTRUMENT` singleton. Rank-0 gating follows the tracer's
(``TRLX_TELEMETRY`` overrides).

Single-thread contract: the instrument table is guarded by the registry's
``_lock`` (creation may race), but the instruments themselves are mutated
and read from the trainer's host loop only; a background thread hands its
values to that loop instead of recording them.

The module imports only the standard library (its clock is the tracer's).
"""

from __future__ import annotations

import threading
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Tuple

from trlx_tpu_torch.telemetry.tracer import monotonic, quantile

#: bound on each gauge's (t, value) sample ring and each histogram's
#: percentile window — memory stays bounded on arbitrarily long runs
DEFAULT_MAX_SAMPLES = 4096


class _NullInstrument:
    """Shared no-op instrument returned while the registry is disabled:
    every mutator exists on the one singleton, so a disabled hot path
    costs an attribute read and a call."""

    __slots__ = ()

    name = ""
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


NULL_INSTRUMENT = _NullInstrument()


class Counter:
    """Monotone counter. ``inc`` only — a counter that can go down is a
    gauge wearing the wrong type (the registry enforces the split)."""

    __slots__ = ("name", "value")

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-value gauge with a bounded timeseries: every ``set`` appends
    ``(monotonic(), value)`` to the sample ring, so occupancy /
    live-memory gauges double as Perfetto counter tracks
    (:func:`~trlx_tpu_torch.telemetry.tracer.chrome_counter_events`)."""

    __slots__ = ("name", "value", "samples")

    kind = "gauge"

    def __init__(self, name: str, max_samples: int = DEFAULT_MAX_SAMPLES):
        self.name = name
        self.value = 0.0
        self.samples: "deque[Tuple[float, float]]" = deque(
            maxlen=max_samples
        )

    def set(self, value: float) -> None:
        v = float(value)
        self.value = v
        self.samples.append((monotonic(), v))


class Histogram:
    """Distribution instrument: cumulative count/sum/min/max plus a
    bounded recent window for nearest-rank percentiles (the same
    estimator the span stats use)."""

    __slots__ = ("name", "count", "sum", "min", "max", "_window")

    kind = "histogram"

    def __init__(self, name: str, max_samples: int = DEFAULT_MAX_SAMPLES):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._window: "deque[float]" = deque(maxlen=max_samples)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self._window.append(v)

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        durs = sorted(self._window)
        return {
            "count": self.count,
            "mean": self.sum / self.count,
            "p50": quantile(durs, 0.5),
            "p95": quantile(durs, 0.95),
            "min": self.min,
            "max": self.max,
        }


class MetricsRegistry:
    """Get-or-create instrument namespace. Thread-safe creation (the
    engine's drive loop and the background writer both meter); mutation
    is per-instrument and relies on the GIL like the tracer's ring."""

    def __init__(
        self,
        enabled: bool = True,
        max_samples: int = DEFAULT_MAX_SAMPLES,
    ):
        self.enabled = enabled
        self.max_samples = int(max_samples)
        self._instruments: Dict[str, Any] = {}
        self._lock = threading.Lock()

    # ------------------------------ access ------------------------------ #

    def _get(self, name: str, cls, **kwargs):
        if not self.enabled:
            return NULL_INSTRUMENT
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, **kwargs)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} is a {inst.kind}, not a "
                f"{cls.kind} — one name, one type"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, max_samples=self.max_samples)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram, max_samples=self.max_samples)

    def absorb(
        self, row: Optional[Dict[str, Any]], prefix: str = ""
    ) -> int:
        """Fold an ad-hoc stats dict into the registry as gauges (the
        migration path for ``engine/*`` occupancy, ``async/*``
        attribution, ``mem/hbm_*`` rows): numeric values become
        ``gauge(prefix + key).set(value)``; everything else is skipped.
        Returns the number of gauges set."""
        if not self.enabled or not row:
            return 0
        n = 0
        for key, value in row.items():
            if isinstance(value, bool) or not isinstance(
                value, (int, float)
            ):
                continue
            self.gauge(prefix + key).set(float(value))
            n += 1
        return n

    # ----------------------------- reading ------------------------------ #

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """The whole namespace as plain dicts:
        ``{"counters": {name: value}, "gauges": {name: value},
        "histograms": {name: summary}}`` — JSON-able, embedded verbatim
        by the run ledger and the flight recorder."""
        with self._lock:
            instruments = list(self._instruments.values())
        out: Dict[str, Dict[str, Any]] = {
            "counters": {},
            "gauges": {},
            "histograms": {},
        }
        for inst in sorted(instruments, key=lambda i: i.name):
            if isinstance(inst, Counter):
                out["counters"][inst.name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][inst.name] = inst.value
            elif isinstance(inst, Histogram):
                out["histograms"][inst.name] = inst.summary()
        return out

    def gauge_series(
        self, names: Optional[Iterable[str]] = None
    ) -> Dict[str, List[Tuple[float, float]]]:
        """Per-gauge ``(t, value)`` samples (every gauge, or ``names``)
        — the Perfetto counter-track export's input."""
        with self._lock:
            instruments = list(self._instruments.values())
        wanted = set(names) if names is not None else None
        out: Dict[str, List[Tuple[float, float]]] = {}
        for inst in instruments:
            if not isinstance(inst, Gauge) or not inst.samples:
                continue
            if wanted is not None and inst.name not in wanted:
                continue
            out[inst.name] = list(inst.samples)
        return out


def split_metric_label(name: str) -> "Tuple[str, str]":
    """``(base, label)`` of a possibly-labeled metric name:
    ``serve/queue_wait_ms[tenant=gold]`` → ``("serve/queue_wait_ms",
    "[tenant=gold]")``; unlabeled names return ``(name, "")``. One
    parser for every consumer of the flat ``[k=v]``-suffix convention
    (tenant histograms today)."""
    if name.endswith("]"):
        cut = name.find("[")
        if cut > 0:
            return name[:cut], name[cut:]
    return name, ""


def flatten_snapshot(
    snap: Optional[Dict[str, Dict[str, Any]]]
) -> Dict[str, float]:
    """A :meth:`MetricsRegistry.snapshot` as one flat numeric dict —
    counters/gauges keep their names, histogram summaries flatten to
    ``name/p50``-style keys. The run-ledger movers diff compares these.

    Labeled histogram names keep their label TERMINAL:
    ``serve/queue_wait_ms[tenant=gold]`` flattens to
    ``serve/queue_wait_ms/p50[tenant=gold]`` — the metric family stays
    one contiguous prefix, so the ``--compare`` movers diff sorts and
    matches tenant-labeled series next to their aggregates instead of
    splitting the family at the bracket."""
    out: Dict[str, float] = {}
    if not snap:
        return out
    for name, value in (snap.get("counters") or {}).items():
        out[name] = float(value)
    for name, value in (snap.get("gauges") or {}).items():
        out[name] = float(value)
    for name, summary in (snap.get("histograms") or {}).items():
        base, label = split_metric_label(name)
        for stat, value in (summary or {}).items():
            out[f"{base}/{stat}{label}"] = float(value)
    return out


# ------------------------------ global wiring ----------------------------- #

_registry: Optional[MetricsRegistry] = None


def get_metrics() -> MetricsRegistry:
    """The process-global registry (created on first use; enabled on
    rank 0 by default, same gating as the tracer)."""
    global _registry
    if _registry is None:
        from trlx_tpu_torch.telemetry import _default_enabled

        _registry = MetricsRegistry(enabled=_default_enabled())
    return _registry


def configure_metrics(
    enabled: Optional[bool] = None, max_samples: Optional[int] = None
) -> MetricsRegistry:
    """Adjust the global registry; returns it."""
    registry = get_metrics()
    if enabled is not None:
        registry.enabled = bool(enabled)
    if max_samples is not None:
        registry.max_samples = int(max_samples)
    return registry


@contextmanager
def scoped_metrics(registry: Optional[MetricsRegistry] = None):
    """Temporarily install ``registry`` (default: a fresh enabled one)
    as the process-global registry — the metrics twin of
    :func:`~trlx_tpu_torch.telemetry.scoped_tracer`, for harnesses and tests
    that must neither wipe nor leak into the embedding process's
    namespace."""
    global _registry
    prev = get_metrics()
    installed = (
        registry if registry is not None else MetricsRegistry(enabled=True)
    )
    _registry = installed
    try:
        yield installed
    finally:
        _registry = prev
