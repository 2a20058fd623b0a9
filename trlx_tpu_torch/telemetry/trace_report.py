"""Critical-path analysis of per-request serving traces (counterpart of
:mod:`trlx_tpu.telemetry.trace_report`; the port keeps its own copy).

``python -m trlx_tpu_torch.telemetry --trace-report <spans.jsonl>`` reads
the chrome-trace JSONL a server exports (phase spans, counter tracks, and
the per-request chains of :mod:`trlx_tpu_torch.telemetry.request_trace` all
share one file) and renders three answers the aggregate ``serve/*``
histograms cannot give:

1. **Per-request critical path**: each completed request's end-to-end wall
   decomposed into the disjoint stages (queue wait, quota hold, prefill,
   decode, harvest wait, delivery). The stages are emitted contiguous on
   one mark chain, so their sum must equal the request's e2e up to
   clock rounding: the per-request ``residual_pct`` column is the
   self-check (a big residual means a truncated or corrupted trace, e.g.
   span-ring eviction).
2. **Per-tenant / per-SLO-class tail breakdown**: which stage the p95
   request's latency is actually made of, per tenant and per SLO class.
3. **Decode-cadence bubble estimate**: inter-decode-step gaps per request
   against the trace's median step time. The host marks measure host
   walls, not device occupancy; but a decode loop that runs every step
   back to back has near-constant cadence, so per-request *excess* gap
   over the median step is a measured bound on host-loop/admission
   bubbles: zero on a gap-free trace, and attributable (the
   ``serve/decode_segment`` epochs mark which admissions interrupted).

Pure host/stdlib; a viewer plus machine output (``--json``), never a gate.
Either package's span log reads alike.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from trlx_tpu_torch.telemetry.request_trace import ROOT, STAGES
from trlx_tpu_torch.telemetry.tracer import quantile

#: residual above this fraction of e2e marks a request's chain broken
DEFAULT_RESIDUAL_TOLERANCE_PCT = 5.0


def load_request_spans(path: str) -> List[Dict[str, Any]]:
    """The request-trace events of one span JSONL: ``ph == "X"`` lines
    whose args carry a ``trace_id``. Other lines (phase spans, counter
    tracks, metadata, torn tails) are skipped, not fatal — one trace
    file serves many consumers."""
    events: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if not isinstance(ev, dict) or ev.get("ph") != "X":
                continue
            if not isinstance(ev.get("args"), dict):
                continue
            if "trace_id" not in ev["args"]:
                continue
            events.append(ev)
    return events


def build_requests(
    events: Sequence[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Group request-trace events by ``trace_id`` into per-request
    views: root identity/attrs, per-stage ms sums, the decode-step
    offsets, and the residual self-check. Requests missing their root
    span are returned with ``complete=False`` (a truncated trace must
    be visible, never silently dropped)."""
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    order: List[str] = []
    for ev in events:
        tid = str(ev["args"]["trace_id"])
        if tid not in by_trace:
            order.append(tid)
        by_trace.setdefault(tid, []).append(ev)
    out: List[Dict[str, Any]] = []
    for tid in order:
        evs = by_trace[tid]
        root = next((e for e in evs if e.get("name") == ROOT), None)
        stage_ms = {name: 0.0 for name in STAGES}
        step_offsets: List[float] = []
        spec_segments = 0
        spec_accepted = 0
        for e in evs:
            name = e.get("name", "")
            if name in stage_ms:
                stage_ms[name] += float(e.get("dur", 0.0)) / 1000.0
            if name == "serve/decode" and "step_offsets_ms" in e["args"]:
                step_offsets = [
                    float(x) for x in e["args"]["step_offsets_ms"]
                ]
            if name == "serve/decode" and "spec_segments" in e["args"]:
                spec_segments = int(e["args"]["spec_segments"])
                spec_accepted = int(e["args"].get("accepted", 0))
        view: Dict[str, Any] = {
            "trace_id": tid,
            "complete": root is not None,
            "stage_ms": {k: round(v, 3) for k, v in stage_ms.items()},
            "stage_sum_ms": round(sum(stage_ms.values()), 3),
            "step_offsets_ms": step_offsets,
            "spec_segments": spec_segments,
            "spec_accepted": spec_accepted,
        }
        if root is not None:
            args = root["args"]
            e2e = float(root.get("dur", 0.0)) / 1000.0
            view.update(
                tenant=str(args.get("tenant", "?")),
                slo_class=str(args.get("slo_class", "?")),
                status=str(args.get("status", "ok")),
                stream=bool(args.get("stream", False)),
                tokens=int(args.get("tokens", 0)),
                e2e_ms=round(e2e, 3),
                e2e_hist_ms=float(args.get("e2e_ms", e2e)),
                residual_pct=round(
                    abs(e2e - view["stage_sum_ms"])
                    / max(e2e, 1e-9)
                    * 100.0,
                    3,
                )
                if e2e > 0
                else 0.0,
                dominant_stage=max(
                    STAGES, key=lambda s: stage_ms[s]
                ),
            )
        out.append(view)
    return out


def tenant_tail_breakdown(
    requests: Sequence[Dict[str, Any]], key: str = "tenant"
) -> Dict[str, Dict[str, Any]]:
    """Per-``key`` (tenant or slo_class) tail summary: request count,
    e2e p50/p95 (nearest-rank, the repo's estimator), and the
    **dominant stage of the p95 request** — the stage its latency is
    mostly made of, which is what an operator pages on."""
    groups: Dict[str, List[Dict[str, Any]]] = {}
    for r in requests:
        if not r.get("complete"):
            continue
        groups.setdefault(str(r.get(key, "?")), []).append(r)
    out: Dict[str, Dict[str, Any]] = {}
    for name, rows in sorted(groups.items()):
        rows = sorted(rows, key=lambda r: r["e2e_ms"])
        durs = [r["e2e_ms"] for r in rows]
        ix = min(
            len(rows) - 1, max(0, int(round(0.95 * (len(rows) - 1))))
        )
        tail = rows[ix]
        out[name] = {
            "count": len(rows),
            "e2e_p50_ms": quantile(durs, 0.5),
            "e2e_p95_ms": quantile(durs, 0.95),
            "p95_dominant_stage": tail["dominant_stage"],
            "p95_dominant_ms": tail["stage_ms"][tail["dominant_stage"]],
        }
    return out


def decode_bubbles(
    requests: Sequence[Dict[str, Any]],
) -> Dict[str, Any]:
    """The decode-cadence device-bubble estimate. Per request the
    inter-step dispatch gaps come from its ``step_offsets_ms``; the
    reference cadence is the **median gap across the whole trace** (the
    phase's steady-state step time). A request's ``bubble_ms`` is its
    summed excess gap over that median — exactly zero on a gap-free
    trace (every gap == median), positive where the host loop stalled
    the cadence (admissions, harvests, GC, quota waits between pump
    iterations).

    Requests whose ``serve/decode`` span carries ``spec_segments > 0``
    ran speculative multi-token verify steps: their steps commit 1..D+1
    tokens each through a wider program, so neither "uniform cadence"
    nor "one token per step" holds and the excess-gap bound would read
    the verify steps themselves as host bubbles. They are excluded from
    both the median and the bubble rows and accounted explicitly
    (``n_spec_excluded``/``spec_tokens_accepted``) — never silently."""
    all_gaps: List[float] = []
    per_req: List[Dict[str, Any]] = []
    n_spec = 0
    spec_accepted = 0
    for r in requests:
        if r.get("spec_segments"):
            n_spec += 1
            spec_accepted += int(r.get("spec_accepted", 0))
            per_req.append({"trace_id": r["trace_id"], "gaps": []})
            continue
        offs = r.get("step_offsets_ms") or []
        gaps = [
            round(offs[i] - offs[i - 1], 3) for i in range(1, len(offs))
        ]
        per_req.append({"trace_id": r["trace_id"], "gaps": gaps})
        all_gaps.extend(gaps)
    median = quantile(sorted(all_gaps), 0.5) if all_gaps else 0.0
    rows: List[Dict[str, Any]] = []
    for r, g in zip(requests, per_req):
        if not g["gaps"]:
            continue
        bubble = sum(max(0.0, gap - median) for gap in g["gaps"])
        rows.append(
            {
                "trace_id": r["trace_id"],
                "tenant": r.get("tenant", "?"),
                "steps": len(g["gaps"]) + 1,
                "max_gap_ms": round(max(g["gaps"]), 3),
                "bubble_ms": round(bubble, 3),
            }
        )
    return {
        "median_step_ms": round(median, 3),
        "total_bubble_ms": round(
            sum(row["bubble_ms"] for row in rows), 3
        ),
        "requests": rows,
        "n_spec_excluded": n_spec,
        "spec_tokens_accepted": spec_accepted,
    }


def report_json(path: str) -> Dict[str, Any]:
    """The machine summary the smokes assert on."""
    requests = build_requests(load_request_spans(path))
    complete = [r for r in requests if r.get("complete")]
    return {
        "requests": requests,
        "n_requests": len(requests),
        "n_complete": len(complete),
        "max_residual_pct": max(
            (r["residual_pct"] for r in complete), default=0.0
        ),
        "tenants": tenant_tail_breakdown(complete, "tenant"),
        "slo_classes": tenant_tail_breakdown(complete, "slo_class"),
        "bubbles": decode_bubbles(complete),
    }


def _fmt_ms(v: float) -> str:
    return f"{v:.1f}"


def render_report(
    path: str,
    tolerance_pct: float = DEFAULT_RESIDUAL_TOLERANCE_PCT,
) -> str:
    """The human triage view (same spirit as ``--inspect``)."""
    summary = report_json(path)
    requests = summary["requests"]
    lines: List[str] = []
    lines.append(
        f"trace report: {path}  requests={summary['n_requests']} "
        f"complete={summary['n_complete']}  "
        f"max_residual={summary['max_residual_pct']:.2f}%"
    )
    incomplete = [r for r in requests if not r.get("complete")]
    if incomplete:
        lines.append(
            f"WARNING: {len(incomplete)} request chain(s) have no root "
            "span — the span ring likely evicted (raise "
            "telemetry.ring_size / TRLX_TELEMETRY_RING)"
        )

    lines.append("")
    lines.append("critical path per request (ms):")
    short = {name: name.split("/", 1)[1] for name in STAGES}
    header = (
        f"  {'trace_id':24} {'tenant':10} {'slo':12} "
        + " ".join(f"{short[s]:>12}" for s in STAGES)
        + f" {'e2e':>10} {'resid%':>7}"
    )
    lines.append(header)
    for r in requests:
        if not r.get("complete"):
            lines.append(f"  {r['trace_id']:24} <no root span>")
            continue
        flag = (
            " !" if r["residual_pct"] > tolerance_pct else ""
        )
        lines.append(
            f"  {r['trace_id']:24} {r['tenant']:10} {r['slo_class']:12} "
            + " ".join(
                f"{_fmt_ms(r['stage_ms'][s]):>12}" for s in STAGES
            )
            + f" {_fmt_ms(r['e2e_ms']):>10} {r['residual_pct']:>6.2f}{flag}"
        )

    for key, title in (
        ("tenants", "per-tenant tail breakdown"),
        ("slo_classes", "per-SLO-class tail breakdown"),
    ):
        groups = summary[key]
        if not groups:
            continue
        lines.append("")
        lines.append(f"{title}:")
        lines.append(
            f"  {'group':14} {'count':>5} {'p50 ms':>10} {'p95 ms':>10} "
            f"  p95 dominant stage"
        )
        for name, row in groups.items():
            lines.append(
                f"  {name:14} {row['count']:>5} "
                f"{_fmt_ms(row['e2e_p50_ms']):>10} "
                f"{_fmt_ms(row['e2e_p95_ms']):>10}   "
                f"{row['p95_dominant_stage']} "
                f"({_fmt_ms(row['p95_dominant_ms'])} ms)"
            )

    bubbles = summary["bubbles"]
    lines.append("")
    lines.append(
        "decode-cadence bubbles (excess inter-step gap over the "
        f"trace median step {bubbles['median_step_ms']:.3f} ms; "
        "host-loop/admission stalls — a device-occupancy bound the "
        "dispatch spans cannot give):"
    )
    if bubbles["requests"]:
        lines.append(
            f"  {'trace_id':24} {'tenant':10} {'steps':>6} "
            f"{'max gap ms':>11} {'bubble ms':>10}"
        )
        for row in bubbles["requests"]:
            lines.append(
                f"  {row['trace_id']:24} {row['tenant']:10} "
                f"{row['steps']:>6} {row['max_gap_ms']:>11.3f} "
                f"{row['bubble_ms']:>10.3f}"
            )
        lines.append(
            f"  total bubble: {bubbles['total_bubble_ms']:.3f} ms"
        )
    else:
        lines.append("  no decode-cadence data (step offsets absent)")
    if bubbles.get("n_spec_excluded"):
        lines.append(
            f"  {bubbles['n_spec_excluded']} request(s) excluded: "
            "speculative verify steps commit multiple tokens per step "
            f"({bubbles['spec_tokens_accepted']} draft tokens accepted) "
            "— the uniform-cadence bound does not apply"
        )
    return "\n".join(lines)
