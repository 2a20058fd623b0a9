"""The serving tier's telemetry, the port against the JAX package.

- **The servers** (module scope, one of each package on the same params,
  carried across with ``models/convert.py``): the test harness's tiny PPO
  config, f32, greedy, 8 slots, each package under
  a fresh tracer and metrics registry of its own. Two rounds of traffic go
  through each: a clean two-tenant round (``gold`` priority 10 and
  ``bronze`` priority 0, one request streamed), then the SLO round, where
  the global registry starts from the same
  ``serve/queue_wait_ms[tenant=pressured]`` observations, over the
  ``pressured`` tenant's 0 ms budget, and equal-priority ``quiet`` traffic
  (submitted first) competes with ``pressured`` traffic for fewer slots
  than requests. Both servers must give the same tokens, the same
  ``completion_order`` (which a server whose scheduler reads no registry
  cannot give), the same request chains and ``serve/*`` counts, zero
  health events after the clean round and ``slo-breach`` after the SLO
  round.
- **Trace emission and the report**: the same host marks through both
  ``emit_request_trace``; both ``report_json``/``render_report`` (and both
  CLIs) on one span log the JAX package wrote; the port's own copies of
  ``tests/test_trace_report.py``'s cases.
- **Metrics**: ``observe_request_metrics`` in both packages.
- **The drafter's state** against the JAX drafter's, and a resumed
  ``spec_decode`` run drafting as its uninterrupted twin.
- ``python -m trlx_tpu_torch.inference --mt-smoke --device cpu``.
"""

import json

import numpy as np
import pytest
import torch

from trlx_tpu_torch.telemetry.request_trace import (
    REQUEST_TRACK_BASE,
    ROOT,
    STAGES,
    emit_request_trace,
    mint_trace_id,
    request_track,
)
from trlx_tpu_torch.telemetry.trace_report import (
    build_requests,
    load_request_spans,
    render_report,
    report_json,
)
from trlx_tpu_torch.telemetry.tracer import Span, Tracer, chrome_trace_events, export_chrome_jsonl

ROLLOUT = {"slots": 8, "admit_width": 4, "harvest_width": 4, "block_size": 4}
SERVING = {
    "slo_classes": {
        "standard": {"queue_wait_budget_ms": 120000},
        "interactive": {"queue_wait_budget_ms": 120000},
        "zero": {"queue_wait_budget_ms": 0},
    },
    "tenants": {
        "gold": {"priority": 10, "slo_class": "interactive"},
        "bronze": {"priority": 0, "slo_class": "standard"},
        "quiet": {"priority": 0, "slo_class": "standard"},
        "pressured": {"priority": 0, "slo_class": "zero"},
    },
}
SEEDED_WAITS = [1.0 + 0.25 * i for i in range(12)]  # pressured's queue waits, ms


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops on one intra-op thread: the suite's parallel workers share
    the cores, and these tests' hundreds of small forwards slow most when
    each worker's thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config():
    from trlx_tpu.analysis import harness

    cfg = harness.tiny_config_dict("ppo")
    cfg["train"]["dtype"] = "float32"
    cfg["train"]["rollout"] = dict(ROLLOUT)
    cfg["train"]["serving"] = json.loads(json.dumps(SERVING))
    cfg["method"]["gen_kwargs"]["do_sample"] = False
    return cfg


def _prompts(n, seed, prefix=(5, 6, 7, 8)):
    rng = np.random.default_rng(seed)
    return [list(prefix) + [int(x) for x in rng.integers(1, 30, int(rng.integers(1, 5)))]
            for _ in range(n)]


def _chains(spans):
    """request id -> sorted names of the spans of its trace, and the
    trace ids that lack a root."""
    by_trace = {}
    for span in spans:
        if "trace_id" in (span.attrs or {}):
            by_trace.setdefault(span.attrs["trace_id"], []).append(span)
    out, rootless = {}, []
    for trace_id, chain in by_trace.items():
        roots = [s for s in chain if s.name == ROOT]
        if len(roots) != 1:
            rootless.append(trace_id)
            continue
        out[roots[0].attrs["request_id"]] = sorted(s.name for s in chain)
    return out, rootless


def _counts(metrics):
    return {k: v["count"] if isinstance(v, dict) else v for k, v in metrics.items()}


def _serve(server, pkg):
    """Both rounds through one server; what the tests compare."""
    from trlx_tpu import telemetry as jtel
    from trlx_tpu_torch import telemetry as ttel

    tel = jtel if pkg == "jax" else ttel
    out = {}
    bronze = server.submit(_prompts(5, 0), tenant="bronze")
    gold = server.submit(_prompts(5, 1), tenant="gold")
    stream_rid = server.submit(_prompts(1, 2), tenant="gold", stream=True)[0]
    streamed = list(server.stream(stream_rid))
    clean = bronze + gold + [stream_rid]
    res = server.wait(clean)
    out["clean"] = {"tokens": [res[r]["tokens"] for r in clean], "streamed": streamed,
                    "order": list(server.completion_order),
                    "events": list(server.health_events), "metrics": server.metrics()}
    registry = tel.get_metrics()
    hist = registry.histogram("serve/queue_wait_ms[tenant=pressured]")
    for v in SEEDED_WAITS:
        hist.observe(v)
    quiet = server.submit(_prompts(6, 3), tenant="quiet")
    pressured = server.submit(_prompts(6, 4), tenant="pressured")
    res = server.wait(quiet + pressured)
    out["slo"] = {"tokens": [res[r]["tokens"] for r in quiet + pressured],
                  "order": list(server.completion_order[len(clean):]),
                  "quiet": quiet, "pressured": pressured,
                  "events": list(server.health_events), "metrics": server.metrics()}
    out["spans"] = tel.get_tracer().spans()
    out["dropped"] = tel.get_tracer().dropped
    out["trace_requests"] = server.engine.trace_requests
    return out


@pytest.fixture(scope="module")
def runs():
    import jax

    from trlx_tpu import telemetry as jtel
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.inference.server import InferenceServer as JServer
    from trlx_tpu.telemetry.metrics import scoped_metrics as jscoped_metrics
    from trlx_tpu_torch import telemetry as ttel
    from trlx_tpu_torch.inference.server import InferenceServer as TServer
    from trlx_tpu_torch.models.convert import flax_to_torch

    out = {}
    with jtel.scoped_tracer(), jscoped_metrics():
        jserver = JServer(TRLConfig.from_dict(_config()))
        out["jax"] = _serve(jserver, "jax")
    params = flax_to_torch(jax.tree_util.tree_map(np.asarray, jserver.params))
    with ttel.scoped_tracer(), ttel.scoped_metrics():
        tserver = TServer(_config(), params=params, device="cpu")
        out["port"] = _serve(tserver, "port")
    return out


def test_slo_pressure_orders_completions_as_the_jax_server(runs):
    """The fault this slice repairs: the port's scheduler reads the
    ``serve/*`` histograms, so the pressured tenant (submitted second, same
    priority) is served first, in the JAX server's order."""
    jax_run, port = runs["jax"]["slo"], runs["port"]["slo"]
    assert port["order"] == jax_run["order"]
    assert port["tokens"] == jax_run["tokens"]
    first = port["order"][:len(port["pressured"])]
    assert sorted(first) == sorted(port["pressured"])  # pressure beat FIFO
    assert len(port["order"]) == len(port["quiet"]) + len(port["pressured"])


def test_clean_round_matches_with_traces_metrics_and_no_health_events(runs):
    jax_run, port = runs["jax"], runs["port"]
    assert port["clean"]["tokens"] == jax_run["clean"]["tokens"]
    assert port["clean"]["streamed"] == port["clean"]["tokens"][-1]
    assert port["clean"]["order"] == jax_run["clean"]["order"]
    assert port["clean"]["events"] == [] and jax_run["clean"]["events"] == []
    assert _counts(port["clean"]["metrics"]) == _counts(jax_run["clean"]["metrics"])
    assert port["clean"]["metrics"]["serve/requests_completed[tenant=gold]"] == 6
    assert port["trace_requests"] and jax_run["trace_requests"]


def test_every_completed_request_has_one_complete_chain_as_in_jax(runs):
    jax_chains, jax_rootless = _chains(runs["jax"]["spans"])
    port_chains, port_rootless = _chains(runs["port"]["spans"])
    assert jax_rootless == port_rootless == []
    n = len(runs["port"]["clean"]["order"]) + len(runs["port"]["slo"]["order"])
    assert len(port_chains) == n and port_chains == jax_chains
    assert runs["port"]["dropped"] == 0
    for spans in (runs["port"]["spans"],):
        roots = [s for s in spans if s.name == ROOT]
        for root in roots:
            stages = sorted((s for s in spans if s.parent == root.index and s.name in STAGES),
                            key=lambda s: s.start)
            assert stages[0].start == root.start and stages[-1].end == root.end
            assert all(a.end == b.start for a, b in zip(stages, stages[1:]))
    names = set().union(*port_chains.values())
    assert {"serve/stream", "serve/decode_segment"} <= names


def test_zero_budget_trips_slo_breach_in_both(runs):
    def breaches(run):
        return sorted({e.series for e in run["slo"]["events"] if e.detector == "slo-breach"})

    assert breaches(runs["port"]) == breaches(runs["jax"]) == [
        "serve/slo_queue_wait_ratio[tenant=pressured]"]
    assert _counts(runs["port"]["slo"]["metrics"]) == _counts(runs["jax"]["slo"]["metrics"])


def test_observe_request_metrics_matches_the_jax_package():
    from trlx_tpu.inference.server import SERVE_HISTOGRAMS as J_HISTOGRAMS
    from trlx_tpu.inference.server import observe_request_metrics as jobserve
    from trlx_tpu.telemetry.metrics import MetricsRegistry as JRegistry
    from trlx_tpu_torch.inference.server import SERVE_HISTOGRAMS, observe_request_metrics
    from trlx_tpu_torch.telemetry.metrics import MetricsRegistry

    assert SERVE_HISTOGRAMS == J_HISTOGRAMS
    rng = np.random.default_rng(0)
    jreg, treg = JRegistry(enabled=True), MetricsRegistry(enabled=True)
    for i in range(20):
        timing = {k: float(v) for k, v in zip(
            ("queue_wait_ms", "prefill_ms", "ttft_ms", "decode_ms", "e2e_ms"),
            rng.random(5) * 100)}
        tenant = (None, "gold", "bronze")[i % 3]
        tokens = int(rng.integers(0, 9))
        jobserve(jreg, timing, tokens, tenant=tenant)
        observe_request_metrics(treg, timing, tokens, tenant=tenant)
    assert treg.snapshot() == jreg.snapshot()


# ------------------------------ emission ------------------------------- #


def _marks(submitted=10.0, admitted=10.2, first=10.25, done=10.45, completed=10.5):
    return {"submitted": submitted, "admitted": admitted, "first_token": first,
            "done": done, "completed": completed}


def _timing(marks):
    ms = 1000.0
    return {
        "queue_wait_ms": (marks["admitted"] - marks["submitted"]) * ms,
        "prefill_ms": (marks["first_token"] - marks["admitted"]) * ms,
        "ttft_ms": (marks["first_token"] - marks["submitted"]) * ms,
        "decode_ms": (marks["completed"] - marks["first_token"]) * ms,
        "e2e_ms": (marks["completed"] - marks["submitted"]) * ms,
    }


def _emit(tracer, rid=1, tenant="gold", emit=emit_request_trace, **kwargs):
    marks = kwargs.pop("marks", _marks())
    defaults = dict(
        trace_id=kwargs.pop("trace_id", None) or mint_trace_id(rid),
        request_id=rid, tenant=tenant, priority=5, slo_class="interactive",
        streamed=False, tokens=4, marks=marks, timing=_timing(marks),
        delivered=marks["completed"] + 0.001,
    )
    defaults.update(kwargs)
    return emit(tracer, **defaults)


def _full_emit_kwargs():
    marks = _marks()
    marks["prefill_chunk_offsets"] = [{"col": 0, "ms": 1.5}, {"col": 4, "ms": 3.25}]
    marks["spec_segments"], marks["spec_accepted"] = 2, 3
    first = marks["first_token"]
    return dict(
        marks=marks, streamed=True, status="abandoned",
        quota_blocked_at=marks["submitted"] + 0.05, picked_at=marks["submitted"] + 0.15,
        step_times=[first + 0.01 * i for i in range(1, 6)], step_epochs=[3, 3, 4, 4, 5],
        plan_window=(10.19, 10.195), stream_window=(first + 0.011, marks["completed"]),
    )


def _span_rows(tracer):
    return [(s.index, s.name, s.parent, s.depth, s.start, s.end, s.status, s.thread_id,
             s.thread_name, dict(s.attrs)) for s in tracer.spans()]


@pytest.mark.parametrize("case", ["plain", "full"])
def test_emission_matches_the_jax_emitter_exactly(case):
    from trlx_tpu.telemetry.request_trace import emit_request_trace as jemit
    from trlx_tpu.telemetry.tracer import Tracer as JTracer

    kwargs = _full_emit_kwargs() if case == "full" else {}
    jtracer, ttracer = JTracer(enabled=True), Tracer(enabled=True)
    j_ix = _emit(jtracer, rid=7, emit=jemit, trace_id="req-x-7", **dict(kwargs))
    t_ix = _emit(ttracer, rid=7, trace_id="req-x-7", **dict(kwargs))
    assert t_ix == j_ix
    assert _span_rows(ttracer) == _span_rows(jtracer)


# -------------- the port's copies of tests/test_trace_report.py -------------- #


def test_emit_chain_is_parented_contiguous_and_sums_to_root():
    tracer = Tracer(enabled=True)
    root_ix = _emit(tracer, rid=3)
    spans = tracer.spans()
    root = next(s for s in spans if s.name == ROOT)
    assert root.index == root_ix
    assert (root.attrs["tenant"], root.attrs["slo_class"], root.attrs["priority"],
            root.attrs["status"]) == ("gold", "interactive", 5, "ok")
    children = [s for s in spans if s.name in STAGES]
    assert all(c.parent == root_ix for c in children)
    assert sum(c.duration_ms for c in children) == pytest.approx(root.duration_ms, rel=1e-6)
    ordered = sorted(children, key=lambda s: s.start)
    assert ordered[0].start == root.start
    for a, b in zip(ordered, ordered[1:]):
        assert a.end == pytest.approx(b.start)
    assert ordered[-1].end == pytest.approx(root.end)
    tid, tname = request_track(3, "gold")
    assert tid >= REQUEST_TRACK_BASE
    assert all(s.thread_id == tid and s.thread_name == "tenant:gold" for s in spans)


def test_emit_quota_hold_stage_present_when_blocked():
    tracer = Tracer(enabled=True)
    marks = _marks()
    _emit(tracer, marks=marks, quota_blocked_at=marks["submitted"] + 0.05,
          picked_at=marks["submitted"] + 0.15)
    by_name = {}
    for s in tracer.spans():
        by_name.setdefault(s.name, []).append(s)
    assert by_name["serve/quota_hold"][0].duration_ms == pytest.approx(100.0)
    assert len(by_name["serve/queue"]) == 2  # the legs before and after the hold
    stage_sum = sum(s.duration_ms for s in tracer.spans() if s.name in STAGES)
    assert stage_sum == pytest.approx(by_name[ROOT][0].duration_ms, rel=1e-6)


def test_emit_clamps_inverted_marks_nonnegative():
    tracer = Tracer(enabled=True)
    marks = _marks()
    marks["first_token"] = marks["admitted"] - 0.5  # a host-stamp inversion
    _emit(tracer, marks=marks)
    assert all(s.end >= s.start for s in tracer.spans())


def test_emit_abandoned_status_survives_chrome_export():
    tracer = Tracer(enabled=True)
    _emit(tracer, status="abandoned")
    events = {e["name"]: e for e in chrome_trace_events(tracer.spans()) if e.get("ph") == "X"}
    assert events[ROOT]["args"]["status"] == "abandoned"
    assert events["serve/deliver"]["args"]["status"] == "abandoned"


def test_emit_disabled_tracer_records_nothing():
    tracer = Tracer(enabled=False)
    assert _emit(tracer) is None
    tracer.enabled = True
    assert tracer.spans() == []


def test_emit_decode_segments_and_stream_overlay():
    tracer = Tracer(enabled=True)
    marks = _marks()
    first = marks["first_token"]
    _emit(tracer, streamed=True, marks=marks,
          step_times=[first + 0.01 * i for i in range(1, 5)], step_epochs=[3, 3, 4, 4],
          stream_window=(first + 0.011, marks["completed"]))
    spans = {s.name: s for s in tracer.spans()}
    decode = spans["serve/decode"]
    assert decode.attrs["steps"] == 4 and len(decode.attrs["step_offsets_ms"]) == 4
    segs = [s for s in tracer.spans() if s.name == "serve/decode_segment"]
    assert len(segs) == 2  # split at the interleaved admission
    assert all(s.parent == decode.index for s in segs)
    assert segs[0].attrs["steps"] == segs[1].attrs["steps"] == 2
    assert "serve/stream" in spans


def _synthetic_log(tmp_path, gap_after_step=None, package="port"):
    """``tests/test_trace_report.py``'s two-tenant log, written by
    ``package``'s emitter and exporter: gold decode-dominated with a 10 ms
    cadence (one 40 ms stall after ``gap_after_step``), bronze
    queue-dominated behind a quota hold."""
    if package == "jax":
        from trlx_tpu.telemetry.request_trace import emit_request_trace as emit
        from trlx_tpu.telemetry.tracer import Tracer as tracer_cls
        from trlx_tpu.telemetry.tracer import export_chrome_jsonl as export
    else:
        emit, tracer_cls, export = emit_request_trace, Tracer, export_chrome_jsonl
    tracer = tracer_cls(enabled=True)
    marks = _marks(submitted=1.0, admitted=1.01, first=1.02, done=1.10, completed=1.11)
    times, t = [], 1.02
    for i in range(8):
        t += 0.010
        if gap_after_step is not None and i == gap_after_step:
            t += 0.040
        times.append(t)
    _emit(tracer, rid=1, tenant="gold", emit=emit, marks=marks, step_times=times,
          step_epochs=[1] * len(times))
    marks_b = _marks(submitted=1.0, admitted=2.0, first=2.01, done=2.05, completed=2.06)
    _emit(tracer, rid=2, tenant="bronze", emit=emit, slo_class="standard", marks=marks_b,
          quota_blocked_at=1.2, picked_at=1.99,
          step_times=[2.01 + 0.010 * i for i in range(1, 5)], step_epochs=[2] * 4)
    path = tmp_path / f"spans_{package}.jsonl"
    export(str(path), tracer.spans())
    return str(path)


def test_report_residual_zero_and_tenant_tails(tmp_path):
    path = _synthetic_log(tmp_path)
    rep = report_json(path)
    assert rep["n_requests"] == rep["n_complete"] == 2
    assert rep["max_residual_pct"] < 5.0
    assert rep["tenants"]["gold"]["p95_dominant_stage"] == "serve/decode"
    assert rep["tenants"]["bronze"]["p95_dominant_stage"] in ("serve/queue", "serve/quota_hold")
    assert rep["slo_classes"]["standard"]["count"] == 1
    rendered = render_report(path)
    for section in ("critical path per request", "per-tenant tail breakdown",
                    "decode-cadence bubbles"):
        assert section in rendered


@pytest.mark.parametrize("gap_after_step, max_gap, bubble", [(None, 10.0, 0.0), (3, 50.0, 40.0)],
                         ids=["gap_free_is_zero", "admission_stall_attributed"])
def test_bubble_estimator(tmp_path, gap_after_step, max_gap, bubble):
    rep = report_json(_synthetic_log(tmp_path, gap_after_step))
    gold = next(r for r in rep["bubbles"]["requests"] if r["tenant"] == "gold")
    assert gold["max_gap_ms"] == pytest.approx(max_gap, abs=1.0)
    assert gold["bubble_ms"] == pytest.approx(bubble, abs=1.0)
    assert rep["bubbles"]["median_step_ms"] == pytest.approx(10.0)
    assert rep["bubbles"]["total_bubble_ms"] >= gold["bubble_ms"]
    if gap_after_step is None:
        assert gold["bubble_ms"] == 0.0


def test_incomplete_chain_is_reported_not_dropped(tmp_path):
    tracer = Tracer(enabled=True)
    orphan = Span("serve/queue", {"trace_id": "req-dead-1"})
    orphan.start, orphan.end = 1.0, 1.5
    tracer.record(orphan)
    path = tmp_path / "spans.jsonl"
    export_chrome_jsonl(str(path), tracer.spans())
    views = build_requests(load_request_spans(str(path)))
    assert len(views) == 1 and not views[0]["complete"]
    rep = render_report(str(path))
    assert "no root span" in rep and "WARNING" in rep


def test_trace_report_cli(tmp_path, capsys):
    from trlx_tpu_torch.telemetry.__main__ import main

    path = _synthetic_log(tmp_path)
    assert main(["--trace-report", path]) == 0
    assert "critical path per request" in capsys.readouterr().out
    assert main(["--trace-report", path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["n_complete"] == 2
    assert main(["--trace-report", str(tmp_path / "missing.jsonl")]) == 2


def test_mint_trace_id_unique_across_servers_in_one_process():
    a, b = mint_trace_id(0), mint_trace_id(0)
    assert a != b and a.split("-")[-1] == b.split("-")[-1] == "0"


def test_engine_step_log_pruned_as_requests_pop():
    """The cadence log is bounded by the in-flight window: entries below
    every un-popped request's admit window drop, and the absolute
    admit/done indices stay valid through the pruning."""
    from trlx_tpu_torch.inference.engine import ContinuousBatchingEngine

    eng = object.__new__(ContinuousBatchingEngine)
    eng.trace_requests = True
    eng._step_base = 0
    eng._step_log = [(float(i), 0) for i in range(10)]
    eng._req_times = {
        1: {"submitted": 0.0, "admitted": 0.1, "first_token": 0.2, "completed": 1.0,
            "admit_step": 0, "done_step": 4},
        2: {"submitted": 0.0, "admitted": 0.5, "first_token": 0.6, "completed": 1.0,
            "admit_step": 6, "done_step": 10},
    }
    eng._prune_step_log()
    assert eng._step_base == 0  # row 1 still pins the floor
    assert eng.pop_request_record(1)["step_times"] == [0.0, 1.0, 2.0, 3.0]
    eng._prune_step_log()
    assert eng._step_base == 6 and len(eng._step_log) == 4
    assert eng.pop_request_record(2)["step_times"] == [6.0, 7.0, 8.0, 9.0]
    eng._prune_step_log()
    assert eng._step_log == [] and eng._step_base == 10


# ------------------------------- the report ------------------------------ #


@pytest.mark.parametrize("gap_after_step", [None, 3])
def test_report_matches_the_jax_report_on_its_span_log(tmp_path, gap_after_step):
    from trlx_tpu.telemetry import trace_report as jreport

    path = _synthetic_log(tmp_path, gap_after_step, package="jax")
    assert report_json(path) == jreport.report_json(path)
    assert render_report(path) == jreport.render_report(path)


# ------------------------------ the drafter ------------------------------ #


def test_drafter_state_round_trips_as_the_jax_drafter():
    from trlx_tpu.serving.spec_drafter import NGramDrafter as JDrafter
    from trlx_tpu_torch.serving.spec_drafter import NGramDrafter

    drafters = [JDrafter(max_draft=3, min_accept_ewma=0.7),
                NGramDrafter(max_draft=3, min_accept_ewma=0.7)]
    for d in drafters:
        for row, tenant in ((0, "acme"), (1, "acme"), (2, "zeta")):
            d.set_tenant(row, tenant)
            d.observe_context(row, [1, 2, 1, 2, 1])
        for row, (drafted, accepted) in enumerate([(3, 0), (3, 0), (2, 2)]):
            d.observe_accept(row, drafted, accepted)
        for _ in range(3):
            d.draft(0)  # acme degraded: suppressed draws count
    want = drafters[0].state_dict()
    assert drafters[1].state_dict() == want and want["suppressed"]
    fresh = NGramDrafter(max_draft=3, min_accept_ewma=0.7)
    fresh.load_state_dict(want)
    assert fresh.state_dict() == want


def _spec_config(ckpt):
    cfg = {
        "model": {"model_type": "gpt2", "model_arch": {
            "vocab_size": 32, "n_positions": 32, "n_embd": 16, "n_layer": 1, "n_head": 2}},
        "train": {"seq_length": 6, "batch_size": 8, "epochs": 8, "total_steps": 4,
                  "lr_init": 1e-3, "lr_target": 1e-3, "eval_interval": 10000,
                  "checkpoint_interval": 100000, "checkpoint_dir": str(ckpt),
                  "mesh": {"dp": -1, "fsdp": 1, "tp": 1}, "dtype": "float32",
                  "rollout": {"engine": "continuous", "slots": 4, "admit_width": 2,
                              "harvest_width": 2, "block_size": 2,
                              "spec_decode": {"enabled": True, "max_draft": 3,
                                              "drafter": "ngram", "min_accept_ewma": 0.9}}},
        "method": {"name": "PPOConfig", "num_rollouts": 16, "chunk_size": 8, "ppo_epochs": 1,
                   "gen_kwargs": {"max_new_tokens": 10, "do_sample": False,
                                  "eos_token_id": 30, "pad_token_id": 31}},
    }
    return cfg


def _train_logged(cfg, preempt: bool):
    """A greedy ``spec_decode`` PPO run (preempted at its first phase
    boundary and resumed when ``preempt``): every ``draft`` call's row and
    proposal in order, and every drafter state loaded."""
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.serving import spec_drafter

    log, loaded = [], []
    draft, load = spec_drafter.NGramDrafter.draft, spec_drafter.NGramDrafter.load_state_dict

    def logged(self, row):
        out = draft(self, row)
        log.append((row, tuple(out)))
        return out

    def loading(self, state):
        loaded.append(json.loads(json.dumps(state)))
        return load(self, state)

    if preempt:
        cfg["train"]["resilience"] = {"enabled": True, "chaos": [
            {"site": "preempt", "mode": "preempt", "phase": 0}]}
    rng = np.random.default_rng(0)
    prompts = [[int(a), int(b)] * 3 for a, b in rng.integers(1, 30, (16, 2))]
    spec_drafter.NGramDrafter.draft = logged
    spec_drafter.NGramDrafter.load_state_dict = loading
    try:
        trainer = trlx_tpu_torch.train(reward_fn=lambda samples, queries, response_gt=None:
                                       [float(len(s)) for s in samples],
                                       prompts=prompts, config=TRLConfig.from_dict(cfg),
                                       device="cpu")
    finally:
        spec_drafter.NGramDrafter.draft = draft
        spec_drafter.NGramDrafter.load_state_dict = load
    return trainer, log, loaded


def test_resumed_spec_decode_run_drafts_as_its_uninterrupted_twin(tmp_path):
    """``min_accept_ewma > 0``: the accept EWMAs of phase 0 decide which rows
    draft in phase 1, so the resumed run must carry them (host state
    ``spec_drafter``): it resumes on degraded EWMAs (where a fresh drafter
    would start at 1.0 and draft) and drafts call for call as the
    uninterrupted run."""
    plain, plain_log, _ = _train_logged(_spec_config(tmp_path / "plain"), preempt=False)
    resumed, resumed_log, loaded = _train_logged(_spec_config(tmp_path / "resumed"),
                                                 preempt=True)
    assert plain.step == resumed.step == 4
    assert resumed_log == plain_log
    assert len(loaded) == 1 and min(loaded[0]["ewma"].values()) < 0.9
    drafter = resumed.rollout_engine_obj.spec_drafter
    assert drafter.state_dict() == plain.rollout_engine_obj.spec_drafter.state_dict()
    assert drafter.degraded_draws > 0
    host = resumed.host_state_dict()
    assert host["spec_drafter"] == drafter.state_dict() and host["rollout_row_cursor"] >= 0


# -------------------------------- the CLI -------------------------------- #


def test_mt_smoke_cli_passes_on_the_cpu(tmp_path):
    from trlx_tpu_torch import telemetry
    from trlx_tpu_torch.inference.__main__ import main

    span_log = tmp_path / "mt.jsonl"
    with telemetry.scoped_tracer(), telemetry.scoped_metrics():
        assert main(["--mt-smoke", "--device", "cpu", "--span-log", str(span_log)]) == 0
    rep = report_json(str(span_log))
    assert rep["n_complete"] == rep["n_requests"] == 18
    # zero up to the report's rounding (each of 6 stages and the e2e to 1 us)
    assert all(abs(r["e2e_ms"] - r["stage_sum_ms"]) <= 0.0035 for r in rep["requests"])
