"""Crash-forensics flight recorder: the last N phases, dumped on failure
(counterpart of :mod:`trlx_tpu.telemetry.flight_recorder`).

When a run dies (an uncaught exception in ``learn``, a detector hitting
the ``dump``/``abort`` policy, or ``train.flight_dump_phase`` asking), the
:class:`FlightRecorder` writes ONE self-contained JSON forensics file from
a bounded ring of per-phase records: the fetched stats row, the KL
sequence, the span-tree aggregate of the phase (per-name stats of the
spans closed since the previous record), the card's allocator gauges
(:mod:`~trlx_tpu_torch.telemetry.device_metrics`), the metrics-registry
snapshot, the detectors' EWMA state and the tripped events, stamped with
the config fingerprint. Every field is data the phase loop already holds
on the host.

:func:`inspect_dump` renders the triage view of a dump: tripped
detectors, the last-good-phase stats diff and the span p50 deltas.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

SCHEMA_VERSION = 1


def _span_stats_window(
    since_index: int,
) -> "tuple[Dict[str, Dict[str, float]], int]":
    """Per-name span stats over the spans closed SINCE ``since_index``
    (the previous phase record), not run-cumulative aggregates — a
    100-phase run's final slow phase must move its record's p50s, and a
    cumulative nearest-rank p50 would dilute one slow sample to
    nothing. Returns (stats, new_high_watermark)."""
    from trlx_tpu_torch import telemetry

    try:
        all_spans = telemetry.get_tracer().spans()
    except Exception:
        return {}, since_index
    if all_spans and max(s.index for s in all_spans) < since_index:
        # the tracer was cleared (indices restarted at 0): a stale
        # watermark would filter every span forever — restart the window
        since_index = -1
    spans = [s for s in all_spans if s.index > since_index]
    if not spans:
        return {}, since_index
    groups: Dict[str, list] = {}
    high = since_index
    for s in spans:
        groups.setdefault(s.name, []).append(s.duration_ms)
        high = max(high, s.index)
    out: Dict[str, Dict[str, float]] = {}
    for name, durs in sorted(groups.items()):
        durs.sort()
        out[name] = {
            "count": float(len(durs)),
            "p50_ms": telemetry.quantile(durs, 0.5),
            "p95_ms": telemetry.quantile(durs, 0.95),
            "total_ms": sum(durs),
        }
    return out, high


def _memory_snapshot() -> Dict[str, int]:
    try:
        from trlx_tpu_torch.telemetry.device_metrics import snapshot

        return snapshot()
    except Exception:
        return {}


def _metrics_snapshot() -> Dict[str, Any]:
    """The metrics-registry namespace at this phase boundary (counters,
    gauges, histogram summaries) — empty when the registry is disabled
    or telemetry import fails (forensics must never add a failure
    mode)."""
    try:
        from trlx_tpu_torch import telemetry

        return telemetry.get_metrics().snapshot()
    except Exception:
        return {}


class FlightRecorder:
    """Bounded ring of phase records + the dump that ships them.

    One recorder per trainer (built by the base trainer when
    ``train.health.enabled``). Not thread-safe by design: records land
    from the phase loop's thread at phase boundaries.
    """

    def __init__(
        self,
        capacity: int = 16,
        directory: str = "health_dumps",
        fingerprint: str = "",
        config: Optional[Dict[str, Any]] = None,
    ):
        self.capacity = int(capacity)
        self.directory = directory
        self.fingerprint = fingerprint
        self._config = config
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        # run-level event mirror: deduped (the detector-trip dump path
        # records the offending row's events, then the phase epilogue
        # records the same phase's events again) and bounded
        self._all_events: List[Dict[str, Any]] = []
        self._event_keys: set = set()
        self._max_events = 512
        self.dumped: List[str] = []
        self._dump_reasons: set = set()
        self._exception_dumped = False
        self._seq = 0
        self._span_watermark = -1  # spans already covered by a record

    def __len__(self) -> int:
        return len(self._ring)

    # ------------------------------ recording ----------------------------- #

    def record_phase(
        self,
        phase: Optional[int],
        step: Optional[int] = None,
        stats_row: Optional[Dict[str, Any]] = None,
        kl_seq: Optional[Sequence[float]] = None,
        events: Sequence[Any] = (),
        detector_state: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Append one phase record to the ring. ``stats_row`` is the
        phase's last fetched stats row (host floats; device leaves are
        dropped, never forced); ``events`` are the phase's
        :class:`~trlx_tpu_torch.telemetry.health.HealthEvent` trips."""
        from trlx_tpu_torch.telemetry.health import _host_float

        row: Dict[str, float] = {}
        for key, value in (stats_row or {}).items():
            v = _host_float(value)
            if v is not None:
                row[key] = v
        event_dicts = [
            e.to_dict() if hasattr(e, "to_dict") else dict(e) for e in events
        ]
        has_error = any(
            e.get("severity") == "error" for e in event_dicts
        )
        spans, self._span_watermark = _span_stats_window(self._span_watermark)
        rec = {
            "phase": phase,
            "step": step,
            "stats": row,
            "kl_seq": [float(k) for k in (kl_seq or [])],
            "spans": spans,
            "memory": _memory_snapshot(),
            "metrics": _metrics_snapshot(),
            "events": event_dicts,
            "detectors": detector_state or {},
            "good": not has_error,
            "recorded_unix": time.time(),
        }
        self._ring.append(rec)
        self._fold_events(event_dicts)
        return rec

    def _fold_events(
        self, event_dicts: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        """Dedupe ``event_dicts`` into the bounded run-level mirror;
        returns the genuinely-new ones."""
        fresh: List[Dict[str, Any]] = []
        for e in event_dicts:
            ekey = (
                e.get("detector"), e.get("series"),
                e.get("step"), e.get("value"),
            )
            if ekey not in self._event_keys:
                self._event_keys.add(ekey)
                self._all_events.append(e)
                fresh.append(e)
        if len(self._all_events) > self._max_events:
            del self._all_events[: len(self._all_events) - self._max_events]
        return fresh

    def note_events(
        self,
        events: Sequence[Any],
        detector_state: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Fold events into the run mirror AND the newest ring record
        WITHOUT appending a new record — the exception-dump path uses
        this for events a crash preempted out of a phase epilogue. A
        fresh stats-less record here would become the dump's final
        phase and empty the --inspect last-good stats diff."""
        event_dicts = [
            e.to_dict() if hasattr(e, "to_dict") else dict(e) for e in events
        ]
        fresh = self._fold_events(event_dicts)
        if not self._ring:
            if fresh:
                self.record_phase(
                    None, events=fresh, detector_state=detector_state
                )
            return
        rec = self._ring[-1]
        if fresh:
            rec["events"] = list(rec["events"]) + fresh
            if any(e.get("severity") == "error" for e in fresh):
                rec["good"] = False
        if detector_state:
            rec["detectors"] = detector_state

    # ------------------------------- dumping ------------------------------ #

    def _dump_path(self, reason: str) -> str:
        slug = "".join(
            c if c.isalnum() or c in "-_" else "-" for c in reason
        )[:48]
        self._seq += 1
        return os.path.join(
            self.directory,
            f"flight_{slug}_{os.getpid()}_{self._seq}.json",
        )

    def dump(
        self,
        reason: str,
        error: Optional[BaseException] = None,
        path: Optional[str] = None,
        once: bool = False,
    ) -> Optional[str]:
        """Write one self-contained forensics JSON; returns its path.

        ``once=True`` dedupes by ``reason`` (the detector ``dump``
        policy calls this per offending row — one anomaly, one file)."""
        if once and reason in self._dump_reasons:
            return None
        self._dump_reasons.add(reason)
        payload: Dict[str, Any] = {
            "schema_version": SCHEMA_VERSION,
            "reason": reason,
            "created_unix": time.time(),
            "fingerprint": self.fingerprint,
            "platform": _platform_info(),
            "config": self._config,
            "error": _error_info(error),
            "phases": list(self._ring),
            "events": list(self._all_events),
        }
        path = path or self._dump_path(reason)
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, default=float)
        self.dumped.append(path)
        return path

    def dump_on_exception(self, error: BaseException) -> Optional[str]:
        """The uncaught-exception hook (learn epilogues, api.train): at
        most ONE exception dump per recorder, and none when the abort
        policy already dumped for the detector that raised."""
        if self._exception_dumped:
            return None
        from trlx_tpu_torch.telemetry.health import HealthAbort

        self._exception_dumped = True
        if isinstance(error, HealthAbort) and self.dumped:
            return None  # the abort policy's dump already has the story
        return self.dump(
            f"exception:{type(error).__name__}", error=error
        )


def _platform_info() -> Dict[str, Any]:
    """The JAX recorder's platform keys, from torch: ``backend`` (``cuda``
    or ``cpu``), the device kind (``torch.cuda.get_device_name``) and the
    device count."""
    try:
        import torch

        if torch.cuda.is_available():
            return {"backend": "cuda", "device_kind": torch.cuda.get_device_name(0),
                    "n_devices": torch.cuda.device_count()}
        return {"backend": "cpu", "device_kind": "cpu", "n_devices": 1}
    except Exception:
        return {}


def _error_info(error: Optional[BaseException]) -> Optional[Dict[str, str]]:
    if error is None:
        return None
    return {
        "type": type(error).__name__,
        "message": str(error),
        "traceback": "".join(
            traceback.format_exception(type(error), error, error.__traceback__)
        )[-4000:],
    }


# ------------------------------ inspection ------------------------------- #


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e4 or abs(v) < 1e-3:
        return f"{v:.3e}"
    return f"{v:.4g}"


def inspect_dump(payload: Dict[str, Any]) -> str:
    """Human triage view of one flight dump (pure; the CLI prints it).

    Sections: run header, tripped-detector table, last-good vs final
    phase stats diff (largest relative movers), and span p50 deltas
    between those two phases."""
    lines: List[str] = []
    reason = payload.get("reason", "?")
    err = payload.get("error") or {}
    platform = payload.get("platform") or {}
    phases = payload.get("phases") or []
    events = payload.get("events") or []
    lines.append(f"flight dump: reason={reason}")
    lines.append(
        f"  fingerprint={payload.get('fingerprint', '')}  "
        f"platform={platform.get('backend', '?')}"
        f"/{platform.get('device_kind', '?')}"
        f"  phases_recorded={len(phases)}  events={len(events)}"
    )
    err_type = err.get("type")
    if err_type:
        lines.append(f"  error: {err_type}: {err.get('message', '')}")

    # tripped detectors
    if events:
        lines.append("")
        lines.append("tripped detectors:")
        by_det: Dict[str, List[Dict[str, Any]]] = {}
        for e in events:
            by_det.setdefault(e.get("detector", "?"), []).append(e)
        for det, evs in sorted(by_det.items()):
            first, last = evs[0], evs[-1]
            lines.append(
                f"  {det:20} x{len(evs):<3} [{last.get('severity', '?')}] "
                f"steps {first.get('step')}..{last.get('step')}  "
                f"last: {last.get('message', '')}"
            )
    else:
        lines.append("")
        lines.append("tripped detectors: none")

    # metrics-registry snapshot of the final recorded phase: the
    # unified namespace (engine occupancy, async bubbles, mem gauges,
    # serving histograms) the run held when it went down. Tenant-labeled
    # rows render in their own per-tenant table below — crowding them
    # into this capped list would truncate exactly the multi-tenant
    # triage the labels exist for.
    from trlx_tpu_torch.telemetry.metrics import split_metric_label

    def tenant_of(name: str):
        """(base, tenant) via the one shared label parser — None tenant
        for unlabeled (or differently-labeled) names."""
        base, label = split_metric_label(name)
        if label.startswith("[tenant="):
            return base, label[len("[tenant="):-1]
        return name, None

    final_metrics = (phases[-1].get("metrics") or {}) if phases else {}
    flat_metrics: List[tuple] = []
    tenant_rows: List[tuple] = []  # (tenant, base metric, summary)
    scalar_tenant_rows: List[tuple] = []  # (tenant, name, rendered)
    for section in ("counters", "gauges"):
        for name, value in (final_metrics.get(section) or {}).items():
            base, tenant = tenant_of(name)
            if tenant is not None:
                scalar_tenant_rows.append(
                    (tenant, base, _fmt(float(value)))
                )
            else:
                flat_metrics.append((name, _fmt(float(value))))
    for name, summary in (final_metrics.get("histograms") or {}).items():
        if not summary.get("count"):
            continue
        base, tenant = tenant_of(name)
        if tenant is not None:
            tenant_rows.append((tenant, base, summary))
            continue
        flat_metrics.append(
            (
                name,
                f"p50={_fmt(float(summary.get('p50', 0.0)))} "
                f"n={int(summary['count'])}",
            )
        )
    if flat_metrics:
        lines.append("")
        lines.append("metrics snapshot (final phase):")
        for name, rendered in sorted(flat_metrics)[:16]:
            lines.append(f"  {name:32} {rendered:>16}")
        if len(flat_metrics) > 16:
            lines.append(f"  ... {len(flat_metrics) - 16} more")
    if tenant_rows or scalar_tenant_rows:
        lines.append("")
        lines.append("serving metrics by tenant (final phase):")
        lines.append(
            f"  {'tenant':12} {'metric':28} {'n':>6} {'p50':>10} "
            f"{'p95':>10} {'max':>10}"
        )
        for tenant, base, summary in sorted(tenant_rows):
            lines.append(
                f"  {tenant:12} {base:28} {int(summary['count']):>6} "
                f"{_fmt(float(summary.get('p50', 0.0))):>10} "
                f"{_fmt(float(summary.get('p95', 0.0))):>10} "
                f"{_fmt(float(summary.get('max', 0.0))):>10}"
            )
        for tenant, base, rendered in sorted(scalar_tenant_rows):
            lines.append(f"  {tenant:12} {base:28} {rendered:>6}")

    # last-good vs final phase
    final = phases[-1] if phases else None
    good = None
    for rec in reversed(phases[:-1] if len(phases) > 1 else []):
        if rec.get("good"):
            good = rec
            break
    if final is not None and good is not None:
        lines.append("")
        lines.append(
            f"last-good phase {good.get('phase')} -> final phase "
            f"{final.get('phase')} stats diff (largest relative movers):"
        )
        good_row = good.get("stats") or {}
        final_row = final.get("stats") or {}
        movers = []
        for key in sorted(set(good_row) & set(final_row)):
            a, b = float(good_row[key]), float(final_row[key])
            # signed relative move for DISPLAY (a collapse must read as
            # negative); magnitude only for ranking
            rel = (b - a) / max(abs(a), 1e-9)
            movers.append((abs(rel), key, a, b, rel))
        movers.sort(reverse=True)
        for _mag, key, a, b, rel in movers[:12]:
            lines.append(
                f"  {key:32} {_fmt(a):>12} -> {_fmt(b):>12} "
                f"({rel * 100.0:+.0f}%)"
            )
        good_spans = good.get("spans") or {}
        final_spans = final.get("spans") or {}
        span_rows = []
        for name in sorted(set(good_spans) & set(final_spans)):
            p50_a = float(good_spans[name].get("p50_ms", 0.0))
            p50_b = float(final_spans[name].get("p50_ms", 0.0))
            if p50_a > 0.0 or p50_b > 0.0:
                span_rows.append((name, p50_a, p50_b))
        if span_rows:
            lines.append("")
            lines.append("span p50 deltas (ms):")
            for name, a, b in span_rows:
                lines.append(f"  {name:32} {a:>10.2f} -> {b:>10.2f}")
    elif final is not None:
        lines.append("")
        lines.append(
            "no earlier good phase in the ring — every recorded phase "
            "carries error-severity events (raise health.flight_capacity "
            "to keep more history)"
        )
    return "\n".join(lines)


def load_dump(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        payload = json.load(fh)
    version = payload.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: flight-dump schema_version {version!r} != "
            f"{SCHEMA_VERSION} (written by a different build?)"
        )
    return payload
