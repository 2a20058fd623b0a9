"""Per-request distributed tracing for the serving tier (counterpart of
:mod:`trlx_tpu.telemetry.request_trace`; the port keeps its own copy).

The ``serve/*`` histograms answer "how is the tier doing"; they cannot
answer the operational question a multi-tenant tier exists for: *where did
THIS request's latency go, and which stage is the tail made of?* This
module is the request-granular half: a ``trace_id`` minted at
``InferenceServer.submit`` rides the typed
:class:`~trlx_tpu_torch.serving.scheduler.Request` through the scheduler
queue, quota admission, the prefix-cache plan, engine prefill, decode and
harvest, and at delivery the whole lifecycle is emitted as one parented
span chain into the process-global span tracer, exported into the **same**
chrome-trace JSONL as the phase spans and counter tracks.

The chain is built *retrospectively*: the stages of one request interleave
with every other request's on the single serving thread, so they can never
be context managers on the tracer's thread stack. Instead each layer stamps
host marks on the shared telemetry clock (scheduler: quota-block/pick;
engine: admit/first-token/done/harvest; streaming: first-push/close) and
:func:`emit_request_trace` turns the marks into explicitly stamped spans
recorded via :meth:`~trlx_tpu_torch.telemetry.tracer.Tracer.record`. Each
request renders as its own track, named by tenant (synthetic tids above
:data:`REQUEST_TRACK_BASE` keep them clear of real thread ids).

Critical-path contract (what ``--trace-report`` relies on): the spans named
in :data:`STAGES` are **disjoint and contiguous**, clamped onto the mark
chain submitted <= quota-block <= picked <= admitted <= first-token <= done
<= completed <= delivered, so per request they sum to the root
``serve/request`` duration exactly, and to the request's ``serve/e2e_ms``
histogram observation up to the (host-trivial) delivery stage. Overlay spans
(``serve/prefix_plan``, ``serve/stream``, ``serve/decode_segment``) carry
extra structure and are *excluded* from the sum.

Cost model: everything here is host bookkeeping; no kernel launch changes.
With the tracer disabled the serving layer skips mark collection and
emission entirely: the per-span cost stays the tracer's ``NULL_SPAN``
contract.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from trlx_tpu_torch.telemetry.tracer import Span, Tracer

#: synthetic-tid floor for per-request trace tracks: far above any
#: real thread id, so request tracks never collide with the serving
#: thread's own span track
REQUEST_TRACK_BASE = 1 << 22

#: root span of every request trace
ROOT = "serve/request"

#: the disjoint critical-path stages (in lifecycle order); per request
#: their durations sum to the root span's — the ``--trace-report``
#: decomposition invariant
STAGES = (
    "serve/queue",
    "serve/quota_hold",
    "serve/prefill",
    "serve/decode",
    "serve/harvest_wait",
    "serve/deliver",
)

#: overlay spans: extra structure, excluded from the critical-path sum
OVERLAYS = ("serve/prefix_plan", "serve/stream", "serve/decode_segment")


#: process-wide mint counter: request_ids are per-server (each
#: InferenceServer counts from 0), so two servers in one process would
#: otherwise mint colliding ids — and the analyzer groups by trace_id,
#: merging the collided chains into one corrupted view
_mint_seq = itertools.count()


def mint_trace_id(request_id: int) -> str:
    """A globally unique trace id for one serving request: the pid keeps
    ids distinct when several serving processes append into one span
    log, the process-wide mint sequence keeps them distinct across
    servers within a process, and the (per-server) request id keeps the
    id humanly correlatable with the request it traces."""
    return f"req-{os.getpid():x}-{next(_mint_seq):x}-{int(request_id):x}"


def request_track(request_id: int, tenant: str) -> Tuple[int, str]:
    """(synthetic tid, track name) for a request's trace track —
    one track per request, *named by tenant* so a trace viewer groups a
    tenant's requests visually."""
    return REQUEST_TRACK_BASE + int(request_id), f"tenant:{tenant}"


def _stamp(
    name: str,
    start: float,
    end: float,
    tid: int,
    tname: str,
    attrs: Dict[str, Any],
) -> Span:
    span = Span(name, attrs)
    span.start = start
    span.end = max(start, end)
    span.thread_id = tid
    span.thread_name = tname
    return span


def emit_request_trace(
    tracer: Tracer,
    *,
    trace_id: str,
    request_id: int,
    tenant: str,
    priority: int,
    slo_class: str,
    streamed: bool,
    tokens: int,
    marks: Dict[str, float],
    timing: Dict[str, float],
    delivered: float,
    status: str = "ok",
    quota_blocked_at: Optional[float] = None,
    picked_at: Optional[float] = None,
    step_times: Optional[Sequence[float]] = None,
    step_epochs: Optional[Sequence[int]] = None,
    plan_window: Optional[Tuple[float, float]] = None,
    stream_window: Optional[Tuple[float, float]] = None,
) -> Optional[int]:
    """Record one completed request's span chain; returns the root
    span's index (``None`` when the tracer is disabled).

    ``marks`` is the engine's raw mark dict
    (:meth:`~trlx_tpu_torch.inference.engine.ContinuousBatchingEngine.
    pop_request_record`); ``timing`` its ms decomposition (the same
    values the ``serve/*`` histograms observed, carried as root attrs
    so tests and the analyzer can tie the chain to the histogram
    observation without joining streams). ``status`` is ``"ok"`` or
    ``"abandoned"`` (the request was ``pop_result``-ed mid-flight; its
    row still decoded to harvest, and the chain still closes —
    trace completeness covers every *completed row*, not just every
    claimed result)."""
    if not tracer.enabled:
        return None
    submitted = float(marks["submitted"])
    completed = float(marks["completed"])
    # clamp the chain monotone: every mark is a host stamp from a
    # different layer; a sub-ms inversion (e.g. a pick and an admit in
    # the same pump iteration) must not produce a negative stage
    blocked = quota_blocked_at
    picked = picked_at if picked_at else None
    admitted = max(submitted, float(marks.get("admitted", submitted)))
    if blocked is not None:
        blocked = min(max(float(blocked), submitted), admitted)
        picked = min(max(float(picked or blocked), blocked), admitted)
    first = max(admitted, float(marks.get("first_token", admitted)))
    done = min(max(float(marks.get("done", completed)), first), completed)
    completed = max(completed, first)
    delivered = max(float(delivered), completed)

    tid, tname = request_track(request_id, tenant)
    base = {"trace_id": trace_id, "tenant": tenant}
    root = _stamp(
        ROOT,
        submitted,
        delivered,
        tid,
        tname,
        dict(
            base,
            request_id=int(request_id),
            priority=int(priority),
            slo_class=slo_class,
            stream=bool(streamed),
            tokens=int(tokens),
            status=status,
            **{k: round(float(v), 3) for k, v in timing.items()},
        ),
    )
    if status != "ok":
        root.status = status
    root_ix = tracer.record(root)
    if root_ix is None:
        return None

    def child(name, start, end, parent=None, depth=1, **attrs):
        span = _stamp(name, start, end, tid, tname, dict(base, **attrs))
        span.depth = depth
        if attrs.get("status", "ok") != "ok":
            # the chrome exporter writes args["status"] from the SPAN
            # field — an attr alone would export as "ok"
            span.status = attrs["status"]
        return tracer.record(
            span, parent=root_ix if parent is None else parent
        )

    # --- the disjoint critical-path stages --------------------------- #
    if blocked is not None:
        child("serve/queue", submitted, blocked)
        child("serve/quota_hold", blocked, picked)
        child("serve/queue", picked, admitted, leg="post-quota")
    else:
        child("serve/queue", submitted, admitted)
    prefill_attrs: Dict[str, Any] = {}
    chunk_offs = marks.get("prefill_chunk_offsets")
    if chunk_offs:
        # chunked prefill (rollout.prefill_chunk): one entry per
        # dispatched chunk window — the prompt-column offset it started
        # at and its dispatch wall relative to admission, so
        # --trace-report can attribute a chunked admission's spread
        # across pump iterations (stall-free admission evidence)
        prefill_attrs["chunks"] = len(chunk_offs)
        prefill_attrs["chunk_cols"] = [int(c["col"]) for c in chunk_offs]
        prefill_attrs["chunk_offsets_ms"] = [
            float(c["ms"]) for c in chunk_offs
        ]
    child("serve/prefill", admitted, first, **prefill_attrs)
    decode_attrs: Dict[str, Any] = {"tokens": int(tokens)}
    if marks.get("spec_segments"):
        # speculative verify steps committed > 1 token each: the
        # cadence estimator must not read tokens > steps (or the wider
        # per-step walls) as host bubbles
        decode_attrs["spec_segments"] = int(marks["spec_segments"])
        decode_attrs["accepted"] = int(marks.get("spec_accepted", 0))
    offsets: List[float] = []
    if step_times:
        offsets = [
            round(max(0.0, (t - first)) * 1000.0, 3) for t in step_times
        ]
        decode_attrs["steps"] = len(offsets)
        decode_attrs["step_offsets_ms"] = offsets
    decode_ix = child("serve/decode", first, done, **decode_attrs)
    child("serve/harvest_wait", done, completed)
    child("serve/deliver", completed, delivered, status=status)

    # --- overlays ---------------------------------------------------- #
    if plan_window is not None:
        child("serve/prefix_plan", plan_window[0], plan_window[1])
    if streamed and stream_window is not None:
        child("serve/stream", stream_window[0], stream_window[1])
    if step_times and step_epochs and decode_ix is not None:
        # decode segments: maximal runs of this row's decode steps with
        # no interleaved admission prefill (epoch constant). Segment
        # boundaries are where the host loop left decode to admit —
        # the admission-bubble structure, visible on the timeline.
        seg_start = first
        run_start = 0
        for i in range(1, len(step_times) + 1):
            if i == len(step_times) or step_epochs[i] != step_epochs[run_start]:
                child(
                    "serve/decode_segment",
                    seg_start,
                    float(step_times[i - 1]),
                    parent=decode_ix,
                    depth=2,
                    seg=step_epochs[run_start],
                    steps=i - run_start,
                )
                seg_start = float(step_times[i - 1])
                run_start = i
    return root_ix
