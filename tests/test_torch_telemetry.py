"""The port's telemetry core against the JAX package's (CPU, host-only).

Held, each on the same inputs through both packages:

- the tracer: nested spans, an error span, ``force`` on a disabled tracer,
  ring eviction and ``dropped`` give equal per-name counts, parents,
  depths and statuses; spans recorded with explicit stamps through
  ``Tracer.record`` export identical ``export_chrome_jsonl`` lines (and
  identical ``chrome_trace_from_jsonl`` files and counter events), and
  ``quantile`` returns identical values;
- ``configure_from_dict``: the same ring sizes, refusals and messages,
  and the same ``TRLX_TELEMETRY_RING`` precedence; ``env_ring_size``;
- the metrics registry: the same mutations give equal ``snapshot()`` and
  ``flatten_snapshot`` (the gauges' sample stamps aside), the same type
  conflict and the same disabled behaviour;
- the flight recorder's ``spans`` and ``metrics`` sections over the same
  explicitly stamped spans and registry;
- the run ledger: fixed manifests give identical ``compare_runs`` text and
  ``--compare --json`` output, ``resolve_run`` resolves the same specs,
  ``render_phase_row`` and ``watch(follow=False)`` print the same lines,
  and ``append_ab_manifest`` appends the same line (or fails alike);
- the CLI: both ``main(argv)`` in process print the same stdout with the
  same exit codes, 2 included, ``--trace-report`` over a span log the JAX
  package wrote among them;
- ``_stream_eligible``: the port's method and the JAX one, each called on
  a ``SimpleNamespace`` self over its own package's config, agree across
  ``phase_overlap`` x ``profile_dir`` x ``profile_phase``;
- the profiler: a port ``PhaseProfiler`` window on phase 1 of a tiny CPU
  ``learn()`` writes exactly one trace (none when the phase is never
  reached), ``profile_dir`` alone writes the first updates' trace and
  keeps the run off the streamed phase, and ``close()`` stops a window an
  exception left open;
- the run ledger through ``learn()``: ``run_dir`` gets ``manifest.json``
  (``status`` ``ok``, or ``error`` when the run raised), a one-line
  ``ledger.jsonl`` and one ``phases.jsonl`` row per phase;
  ``TRLX_RUN_LEDGER`` takes the manifest instead of ``run_dir``'s ledger.
"""

import io
import json
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from trlx_tpu import telemetry as jt
from trlx_tpu.telemetry import __main__ as jcli
from trlx_tpu.telemetry import flight_recorder as jfr
from trlx_tpu.telemetry import metrics as jm
from trlx_tpu.telemetry import run_ledger as jl
from trlx_tpu_torch import telemetry as tt
from trlx_tpu_torch.telemetry import __main__ as tcli
from trlx_tpu_torch.telemetry import flight_recorder as tfr
from trlx_tpu_torch.telemetry import metrics as tm
from trlx_tpu_torch.telemetry import run_ledger as tl

PACKAGES = {"jax": (jt, jm, jfr, jl, jcli), "port": (tt, tm, tfr, tl, tcli)}


def both(fn):
    """``fn(*package modules)`` for each package: ``(jax result, port result)``."""
    return fn(*PACKAGES["jax"]), fn(*PACKAGES["port"])


# ------------------------------- tracer -------------------------------- #


def _span_scenario(tel, *_):
    """Nested spans, an error span, a thread's span, a forced span on a
    disabled tracer and a ring that evicts: everything but the durations."""
    tracer = tel.Tracer(enabled=True, max_records=6)
    with tracer.span("phase/collect", rollouts=8):
        for _ in range(3):
            with tracer.span("collect/land"):
                with tracer.span("train/epoch1_dispatch"):
                    pass
    with pytest.raises(ValueError):
        with tracer.span("phase/train"):
            with tracer.span("train/drain"):
                raise ValueError("boom")

    def worker():
        with tracer.span("writer/flush"):
            pass

    t = threading.Thread(target=worker, name="rollout-writer")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    with tracer.span("after") as after:
        pass
    tracer.enabled = False
    with tracer.span("forced", force=True) as forced:
        pass
    ghost = tracer.span("ghost")
    tracer.enabled = True
    names = {s.index: s.name for s in tracer.spans()}
    return {
        "spans": [(s.name, names.get(s.parent), s.depth, s.status, s.thread_name)
                  for s in tracer.spans()],
        "counts": {k: v["count"] for k, v in tracer.stats().items()},
        "dropped": tracer.dropped,
        "after_root": (after.parent, after.depth),
        "forced": (forced.duration_ms >= 0.0, forced.name, tracer.last("forced")),
        "ghost_is_null": ghost is tel.NULL_SPAN,
        "shrunk": _shrink(tracer),
    }


def _shrink(tracer):
    tracer.set_max_records(2)
    return tracer.dropped, [s.name for s in tracer.spans()]


def test_tracer_spans_nest_fail_force_and_evict_alike():
    want, got = both(_span_scenario)
    assert got == want
    assert want["dropped"] == 5 and want["shrunk"] == (9, ["writer/flush", "after"])
    assert want["ghost_is_null"] and want["forced"][2] is None


def _stamped(tel, *_):
    """Spans with explicit stamps through ``Tracer.record``, parented by
    index, on this thread's identity."""
    tracer = tel.Tracer(enabled=True, max_records=16)
    ident, tname = threading.get_ident(), threading.current_thread().name
    rows = [("phase/collect", None, 5.0, 6.25, {"rollouts": 8}),
            ("collect/decode", 0, 5.125, 5.5, {}),
            ("collect/land", 0, 5.5, 6.0, {"landed": 8}),
            ("train/epoch1_dispatch", 2, 5.75, 5.875, {"minibatch": 0}),
            ("phase/train", None, 6.25, 7.0, {"updates": 4})]
    recorded = []
    for name, parent, start, end, attrs in rows:
        sp = tel.Span(name, dict(attrs))
        sp.start, sp.end = start, end
        sp.thread_id, sp.thread_name = ident, tname
        recorded.append(tracer.record(
            sp, parent=None if parent is None else recorded[parent]))
    return tracer


def test_recorded_spans_export_identical_chrome_lines(tmp_path):
    def export(tel, *_):
        tracer = _stamped(tel)
        path = str(tmp_path / f"{tel.__name__}.jsonl")
        counters = {"mem/hbm_live_bytes": [(5.0, 1.0), (6.5, 2.0)]}
        n = tel.export_chrome_jsonl(path, tracer.spans(), counters=counters)
        wrapped = path + ".json"
        tel.chrome_trace_from_jsonl(path, wrapped)
        return (n, open(path).read(), open(wrapped).read(), tracer.stats(),
                [tracer.ancestors(s) and [a.name for a in tracer.ancestors(s)]
                 for s in tracer.spans()])

    want, got = both(export)
    assert got == want
    assert want[0] == 5 + 2 + 2  # spans, process + thread names, counters


def test_quantile_is_identical():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 100, 101):
        durs = sorted(rng.exponential(3.0, n).tolist())
        for q in (0.0, 0.25, 0.5, 0.95, 1.0):
            assert tt.quantile(durs, q) == jt.quantile(durs, q)


# ------------------------------- config -------------------------------- #


def _config_scenario(tel, *_):
    out = []
    with tel.scoped_tracer(tel.Tracer(enabled=True, max_records=100)) as tracer:
        for env, section in ((None, {"ring_size": 32}), ("64", {"ring_size": 16}),
                             ("64k", {"ring_size": 48}), ("0", {"ring_size": 24}),
                             (None, {"ringsize": 8}), (None, {"ring_size": 0}),
                             ("64", {"ring_size": -3}), (None, None), (None, {}),
                             (None, {"ring_size": "40"})):
            if env is None:
                os.environ.pop("TRLX_TELEMETRY_RING", None)
            else:
                os.environ["TRLX_TELEMETRY_RING"] = env
            try:
                assert tel.configure_from_dict(section) is tracer
                out.append(tracer._records.maxlen)
            except ValueError as e:
                out.append(("ValueError", str(e)))
            out.append(tel.env_ring_size())
    return out


def test_configure_from_dict_refusals_and_env_precedence(monkeypatch):
    monkeypatch.delenv("TRLX_TELEMETRY_RING", raising=False)
    want, got = both(_config_scenario)
    assert got == want
    assert ("ValueError", "train.telemetry.ring_size=0 must be >= 1") in want
    assert want[:2] == [32, 65536]


# ------------------------------ registry ------------------------------- #


def _registry_scenario(_tel, metrics, *__):
    reg = metrics.MetricsRegistry(enabled=True, max_samples=3)
    reg.counter("engine/decode_steps").inc()
    reg.counter("engine/decode_steps").inc(2.5)
    for v in (0.5, 0.75, 0.25, 1.0):
        reg.gauge("engine/slot_util").set(v)
    for v in (10.0, 30.0, 20.0, 40.0, 5.0):
        reg.histogram("serve/ttft_ms").observe(v)
        reg.histogram("serve/ttft_ms[tenant=gold]").observe(2 * v)
    reg.histogram("serve/empty")
    n = reg.absorb({"async/learner_idle_ms": 12.5, "note": "text", "flag": True,
                    "exp/overlap_streamed_updates": 3, "mem/hbm_peak_bytes": float(2**30)},
                   prefix="")
    with pytest.raises(TypeError) as conflict:
        reg.gauge("engine/decode_steps")
    series = {k: [v for _, v in s] for k, s in reg.gauge_series().items()}
    reg.enabled = False
    null = (reg.counter("x") is metrics.NULL_INSTRUMENT, reg.absorb({"y": 1.0}))
    reg.enabled = True
    snap = reg.snapshot()
    return snap, metrics.flatten_snapshot(snap), n, str(conflict.value), series, null


def test_registry_snapshots_and_flattening_are_equal():
    want, got = both(_registry_scenario)
    assert got == want
    snap, flat = want[0], want[1]
    assert snap["gauges"]["engine/slot_util"] == 1.0 and want[2] == 3
    assert want[4]["engine/slot_util"] == [0.75, 0.25, 1.0]  # the last max_samples
    assert "serve/ttft_ms/p50[tenant=gold]" in flat
    for name in ("serve/queue_wait_ms[tenant=gold]", "plain", "odd["):
        assert tm.split_metric_label(name) == jm.split_metric_label(name)


def test_scoped_metrics_and_module_api():
    def scenario(tel, metrics, *_):
        outer = tel.get_metrics()
        with tel.scoped_metrics() as inner:
            assert tel.get_metrics() is inner and inner is not outer
            inner.counter("a").inc()
            tel.configure_metrics(max_samples=7)
            got = (inner.max_samples, inner.snapshot())
        assert tel.get_metrics() is outer
        with tel.scoped_tracer() as tracer:
            with tel.span("phase/eval"):
                pass
            assert tel.get_tracer() is tracer
            spans = [s.name for s in tracer.spans()]
        return got, spans, isinstance(tel.now(), float)

    want, got = both(scenario)
    assert got == want


def test_phase_memory_stats_are_empty_on_the_cpu():
    from trlx_tpu.telemetry import device_metrics as jd
    from trlx_tpu_torch.telemetry import device_metrics as td

    assert td.phase_memory_stats() == jd.phase_memory_stats() == {}


def test_span_drop_warning(capsys):
    def scenario(tel, *_):
        tel._drops_warned = False
        tracer = tel.Tracer(enabled=True, max_records=2)
        for i in range(5):
            with tracer.span(f"s{i}"):
                pass
        counts = [tel.warn_on_span_drops(tracer), tel.warn_on_span_drops(tracer)]
        tel._drops_warned = False
        return counts, capsys.readouterr().err

    want, got = both(scenario)
    assert got == want and want[0] == [3, 3] and "dropped 3 spans" in want[1]


# ---------------------------- flight recorder --------------------------- #


def test_flight_record_spans_and_metrics_sections_are_equal(tmp_path):
    def scenario(tel, _metrics, fr, *__):
        with tel.scoped_tracer(_stamped(tel)), tel.scoped_metrics() as reg:
            reg.gauge("exp/overlap_drain_ms").set(1.5)
            reg.histogram("serve/ttft_ms[tenant=gold]").observe(4.0)
            recorder = fr.FlightRecorder(capacity=4, directory=str(tmp_path / tel.__name__),
                                         fingerprint="cafe01")
            first = recorder.record_phase(0, step=4, stats_row={"losses/total_loss": 0.5})
            second = recorder.record_phase(1, step=8, stats_row={"losses/total_loss": 0.25})
            with tel.span("phase/collect"):
                pass
            third = recorder.record_phase(2, step=12, stats_row={"losses/total_loss": 0.125})
            path = recorder.dump("test-reason")
        payload = fr.load_dump(path)
        text = fr.inspect_dump(payload)
        return ([first["spans"], second["spans"], sorted(third["spans"]),
                 first["metrics"], third["metrics"]],
                text.split("\n", 2)[2])

    want, got = both(scenario)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert want[0][0]["collect/land"]["total_ms"] == 500.0
    assert want[0][1] == {} and want[0][2] == ["phase/collect"]


# ------------------------------ run ledger ------------------------------ #


def _manifest(ledger, run_id, value, p50, kind="device_kind"):
    m = ledger.build_manifest(
        "train/PPOTrainer", run_id=run_id, config={"train": {"seed": 1}},
        payload={"value": value, "status": "ok", "flag": True},
        span_stats={"phase/collect": {"count": 2, "p50_ms": p50, "total_ms": 2 * p50},
                    "phase/train": {"count": 2, "p50_ms": 3 * p50}},
        metrics={"counters": {"c": 1.0}, "gauges": {"exp/overlap_drain_ms": p50 / 10},
                 "histograms": {"serve/ttft_ms[tenant=gold]": {"count": 2, "p50": p50}}},
        attribution=[{"program": "ppo.train_step", "mfu": value / 1000}],
        health_events={"kl-spike": int(value) % 3},
    )
    # fields that differ between calls and packages, fixed for the diff
    m.update(date="2026-01-01 00:00:00", created_unix=0.0, git_sha="abc1234",
             platform={"backend": "cuda", kind: "NVIDIA H100 80GB HBM3"})
    return m


def _ledger_scenario(*mods, path):
    ledger = mods[3]
    if os.path.exists(path):
        os.remove(path)
    for run_id, value, p50 in (("run_a", 100.0, 500.0), ("run_b", 90.0, 600.0),
                               ("run_c", 90.0, 600.0)):
        ledger.append_manifest(_manifest(ledger, run_id, value, p50), path)
    with open(path, "a") as fh:
        fh.write('{"torn": ')  # a run that died mid-append
    resolved = [ledger.resolve_run(spec, path)["run_id"]
                for spec in ("run_a", "~1", "~2", "last", "prev", "0", "-1", path)]
    try:
        ledger.resolve_run("nope", path)
    except ValueError as e:
        missing = str(e).replace(path, "<ledger>")
    a, b, c = ledger.load_ledger(path)
    mismatch = dict(b, fingerprint="deadbeef0000")
    return (resolved, missing, ledger.compare_runs(a, b), ledger.compare_runs(b, c),
            ledger.compare_runs(a, mismatch), ledger.compare_runs(a, b, top=2),
            ledger.flatten_numeric(a), ledger.numeric_payload({"x": 1, "y": True, "z": "s"}))


def test_compare_runs_and_resolution_are_identical(tmp_path):
    want, got = both(lambda *m: _ledger_scenario(*m, path=str(tmp_path / "ledger.jsonl")))
    assert got == want
    assert want[0] == ["run_a", "run_c", "run_b", "run_c", "run_b", "run_a", "run_c", "run_c"]
    assert "-10.0%" in want[2] and "movers: none" in want[3]
    assert "fingerprints differ" in want[4]


def test_ab_manifests_append_alike(tmp_path, monkeypatch, capsys):
    """``append_ab_manifest``: the same A/B record gives the same ledger
    line (stamps, sha and platform aside), and an unwritable ledger the
    same ``None`` and warning."""
    record = {"metric": "rollout_tokens_per_s", "baseline": 100.0, "candidate": 125.5,
              "speedup": 1.255, "flag": True, "note": "text", "nested": {"x": 1.0}}

    def scenario(*mods):
        tel, ledger = mods[0], mods[3]
        path = str(tmp_path / f"{tel.__name__}.jsonl")
        monkeypatch.setenv("TRLX_RUN_LEDGER", path)
        with tel.scoped_tracer(), mods[1].scoped_metrics():
            written = ledger.append_ab_manifest("ab/phase_overlap", record)
            monkeypatch.setenv("TRLX_RUN_LEDGER", str(tmp_path))  # a directory
            failed = ledger.append_ab_manifest("ab/phase_overlap", record)
        (line,) = ledger.load_ledger(path)
        for key in ("run_id", "date", "created_unix", "git_sha", "platform"):
            line.pop(key)
        return os.path.basename(written), failed, line, capsys.readouterr().err.split("(")[0]

    want, got = both(scenario)
    assert got[1:] == want[1:]
    assert want[1] is None and want[3] == "run_ledger: A/B manifest append failed "
    assert want[2]["payload"]["speedup"] == 1.255 and want[2]["kind"] == "ab/phase_overlap"


PHASE_ROWS = [
    {"phase": 0, "step": 4, "stats": {"losses/total_loss": 0.5, "exp/scores_mean": 0.25},
     "spans": {"phase/collect": {"p50_ms": 120.0}, "phase/train": {"p50_ms": 80.4}},
     "memory": {}, "events": []},
    {"phase": 1, "step": 8, "stats": {"losses/total_loss": 0.4, "health/entropy": 3.5,
                                      "policy/mean_rollout_kl": 1e-5},
     "spans": {"phase/collect": {"p50_ms": 130.0}},
     "memory": {"peak_bytes_in_use": 3 * 2**30},
     "events": [{"detector": "kl-spike", "severity": "error"},
                {"detector": "grad-spike", "severity": "warning"}]},
    {"phase": 2},
]


def test_phase_rows_and_watch_print_the_same(tmp_path):
    def scenario(*mods):
        ledger = mods[3]
        run_dir = str(tmp_path / mods[0].__name__ / "run")
        writer = ledger.PhaseLogWriter(run_dir)
        for row in PHASE_ROWS:
            writer.append(row)
        with open(writer.path, "a") as fh:
            fh.write("not json\n")
        out = io.StringIO()
        n = ledger.watch(run_dir, follow=False, out=out)
        paths = [os.path.relpath(ledger.phases_path(p), str(tmp_path))
                 for p in (run_dir, writer.path, str(tmp_path / "later"))]
        try:
            ledger.watch(str(tmp_path / "nope"), follow=False, out=out)
        except FileNotFoundError:
            missing = True
        return ([ledger.render_phase_row(r) for r in PHASE_ROWS], n, out.getvalue(),
                [p.split(os.sep, 1)[-1] for p in paths], missing)

    want, got = both(scenario)
    assert got == want
    assert want[1] == 3 and "events: grad-spike,kl-spike" in want[0][1]


# --------------------------------- CLI ---------------------------------- #


def test_cli_prints_the_same_with_the_same_exit_codes(tmp_path, capsys):
    ledger = str(tmp_path / "ledger.jsonl")
    for run_id, value, p50 in (("run_a", 100.0, 500.0), ("run_b", 90.0, 600.0)):
        tl.append_manifest(_manifest(tl, run_id, value, p50), ledger)
    run_dir = str(tmp_path / "run")
    writer = tl.PhaseLogWriter(run_dir)
    for row in PHASE_ROWS[:2]:
        writer.append(row)
    recorder = tfr.FlightRecorder(capacity=4, directory=str(tmp_path / "dumps"),
                                  fingerprint="cafe01")
    recorder.record_phase(0, step=4, stats_row={"losses/total_loss": 0.5})
    recorder.record_phase(1, step=8, stats_row={"losses/total_loss": 0.75},
                          events=[{"detector": "kl-spike", "severity": "error",
                                   "step": 8, "message": "kl"}])
    dump = recorder.dump("test-reason")
    (tmp_path / "bad.json").write_text("{")
    # a span log with two request chains (a quota hold, decode steps),
    # written by the JAX package's emitter and exporter
    from trlx_tpu.telemetry.request_trace import emit_request_trace

    tracer = jt.Tracer(enabled=True)
    for rid, tenant, blocked in ((0, "gold", None), (1, "bronze", 1.2)):
        marks = {"submitted": 1.0, "admitted": 1.5 + rid, "first_token": 1.6 + rid,
                 "done": 1.9 + rid, "completed": 2.0 + rid}
        emit_request_trace(
            tracer, trace_id=f"req-cli-{rid}", request_id=rid, tenant=tenant, priority=rid,
            slo_class="standard", streamed=False, tokens=4, marks=marks,
            timing={"e2e_ms": (marks["completed"] - 1.0) * 1000.0}, delivered=2.1 + rid,
            quota_blocked_at=blocked, picked_at=1.4 if blocked else None,
            step_times=[1.6 + rid + 0.01 * i for i in range(1, 6)], step_epochs=[1] * 5)
    spans = str(tmp_path / "spans.jsonl")
    jt.export_chrome_jsonl(spans, tracer.spans())
    argvs = [
        ["--compare", "~2", "~1", "--ledger", ledger],
        ["--compare", "run_a", "run_b", "--ledger", ledger, "--json"],
        ["--compare", "x", "y", "--ledger", ledger],
        ["--compare", "~1", "~2", "--ledger", str(tmp_path / "none.jsonl")],
        ["--watch", run_dir, "--no-follow"],
        ["--watch", str(tmp_path / "nope"), "--no-follow"],
        ["--inspect", dump],
        ["--inspect", dump, "--json"],
        ["--inspect", str(tmp_path / "bad.json")],
        ["--inspect", str(tmp_path / "missing.json")],
        ["--trace-report", spans],
        ["--trace-report", spans, "--json"],
        ["--trace-report", str(tmp_path / "missing.jsonl")],
    ]
    results = {}
    for name, (*_, cli) in PACKAGES.items():
        results[name] = []
        for argv in argvs:
            rc = cli.main(argv)
            out = capsys.readouterr()
            results[name].append((rc, out.out, out.err))
    assert results["port"] == results["jax"]
    assert [r[0] for r in results["jax"]] == [0, 0, 2, 2, 0, 2, 0, 0, 2, 2, 0, 0, 2]
    assert "critical path per request" in results["port"][-3][1]
    assert json.loads(results["port"][-2][1])["n_complete"] == 2
    # no subtool: the help (wrapped to each program name's width), exit 2
    assert tcli.main([]) == jcli.main([]) == 2


def test_the_module_runs_as_a_script(tmp_path):
    import subprocess
    import sys

    run_dir = tmp_path / "run"
    writer = tl.PhaseLogWriter(str(run_dir))
    writer.append(PHASE_ROWS[0])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "trlx_tpu_torch.telemetry", "--watch",
                          str(run_dir), "--no-follow"], capture_output=True, text=True,
                         cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == tl.render_phase_row(PHASE_ROWS[0])


# --------------------------- stream eligibility ------------------------- #


def _tiny_config(train=None):
    return {
        "model": {"model_type": "gpt2", "model_arch": {
            "vocab_size": 40, "n_positions": 32, "n_embd": 32, "n_layer": 2, "n_head": 2}},
        "train": {"seq_length": 6, "batch_size": 8, "epochs": 2, "total_steps": 8,
                  "eval_interval": 1000, "checkpoint_interval": 1000, "dtype": "float32",
                  "seed": 5, **(train or {})},
        "method": {"name": "PPOConfig", "num_rollouts": 16, "chunk_size": 8, "ppo_epochs": 2,
                   "init_kl_coef": 0.05, "target": 6.0, "horizon": 100,
                   "gen_kwargs": {"max_new_tokens": 5, "min_new_tokens": 2, "do_sample": True,
                                  "eos_token_id": 10, "pad_token_id": 39}},
    }


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("profile_dir", [None, "profiles"])
@pytest.mark.parametrize("profile_phase", [None, 0, 1])
def test_stream_eligible_matches_the_jax_rule(overlap, profile_dir, profile_phase):
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JaxPPO
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    train = {"phase_overlap": overlap, "profile_dir": profile_dir,
             "profile_phase": profile_phase}
    for extra in ({}, {"eval_interval": 2}, {"total_steps": 6}):
        cfg = _tiny_config({**train, **extra})
        for it in (0, 4, 8):
            want = JaxPPO._stream_eligible(
                SimpleNamespace(config=JaxConfig.from_dict(cfg), orch=object()), it)
            got = PPOTrainer._stream_eligible(
                SimpleNamespace(config=TRLConfig.from_dict(cfg), orch=object()), it)
            assert bool(got) == bool(want), (extra, it)
    if overlap:
        legacy = profile_dir is not None and profile_phase is None
        cfg = TRLConfig.from_dict(_tiny_config(train))
        assert bool(PPOTrainer._stream_eligible(
            SimpleNamespace(config=cfg, orch=object()), 0)) is not legacy


# ------------------------- learn(): profiler, ledger --------------------- #


def _prompts():
    rng = np.random.default_rng(9)
    return [[int(x) for x in rng.integers(0, 36, int(rng.integers(1, 7)))] for _ in range(24)]


def _reward(samples, queries, response_gt=None):
    return [float(len(s)) for s in samples]


def _learn(tmp, reward=_reward, **train):
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig

    cfg = _tiny_config({"checkpoint_dir": str(tmp / "ckpt"), **train})
    with tt.scoped_tracer() as tracer, tt.scoped_metrics() as metrics:
        trainer = trlx_tpu_torch.train(reward_fn=reward, prompts=_prompts(),
                                       config=TRLConfig.from_dict(cfg), device="cpu")
    return trainer, tracer, metrics


def _traces(directory) -> list:
    return sorted(os.listdir(directory)) if os.path.isdir(directory) else []


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """Two PPO phases with the four item-19 keys on and health on."""
    tmp = tmp_path_factory.mktemp("profiled")
    trainer, tracer, metrics = _learn(
        tmp, telemetry={"ring_size": 4096}, run_dir=str(tmp / "run"),
        profile_dir=str(tmp / "prof"), profile_phase=1, health={"enabled": True})
    return tmp, trainer, tracer, metrics


def test_profile_phase_writes_exactly_one_trace(profiled):
    tmp, trainer, tracer, _ = profiled
    assert _traces(tmp / "prof") == ["phase_1.pt.trace.json"]
    trace = json.load(open(tmp / "prof" / "phase_1.pt.trace.json"))
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])
    assert not trainer._phase_profiler.active and trainer._phase_profiler.done
    counts = {k: v["count"] for k, v in tracer.stats().items()}
    assert counts["phase/collect"] == counts["phase/train"] == 2  # both phases streamed
    assert tracer.dropped == 0


def test_run_dir_holds_the_manifest_ledger_and_phase_rows(profiled, capsys):
    tmp, trainer, tracer, metrics = profiled
    run = tmp / "run"
    assert sorted(os.listdir(run)) == ["ledger.jsonl", "manifest.json", "phases.jsonl"]
    manifest = json.load(open(run / "manifest.json"))
    (line,) = open(run / "ledger.jsonl").read().splitlines()
    assert json.loads(line) == manifest
    assert manifest["payload"]["status"] == "ok" and manifest["kind"] == "train/PPOTrainer"
    assert manifest["platform"]["backend"] == "cpu" and "torch_version" in manifest["platform"]
    assert manifest["span_stats"]["phase/train"]["count"] == 2.0
    assert "exp/overlap_drain_ms" in manifest["metrics"]["gauges"]
    rows = [json.loads(r) for r in open(run / "phases.jsonl")]
    assert [r["phase"] for r in rows] == [0, 1] and "detectors" not in rows[0]
    assert all(r["spans"]["phase/train"]["count"] == 1.0 for r in rows)
    assert tcli.main(["--watch", str(run), "--no-follow"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 2
    # the phase's drain span is its exp/overlap_drain_ms
    drains = [s.duration_ms for s in tracer.spans("train/drain")]
    assert metrics.snapshot()["gauges"]["exp/overlap_drain_ms"] == drains[-1]


def test_no_trace_when_the_phase_is_never_reached(tmp_path):
    _learn(tmp_path, profile_dir=str(tmp_path / "prof"), profile_phase=5)
    assert _traces(tmp_path / "prof") == []


def test_profile_dir_alone_traces_the_first_updates_off_the_stream(tmp_path):
    trainer, tracer, _ = _learn(tmp_path, profile_dir=str(tmp_path / "prof"))
    assert _traces(tmp_path / "prof") == ["first_updates.pt.trace.json"]
    assert tracer.spans("train/epoch1_dispatch") == []  # no streamed phase
    assert trainer._profiling is None
    assert not trainer._phase_profiler.active


def test_an_error_closes_the_window_and_records_the_run(tmp_path, monkeypatch):
    import torch

    ledger = tmp_path / "env_ledger.jsonl"
    monkeypatch.setenv("TRLX_RUN_LEDGER", str(ledger))
    calls = [0]

    def failing(samples, queries, response_gt=None):
        calls[0] += 1
        if calls[0] > 3:  # the second phase's collection, its window open
            raise RuntimeError("reward service down")
        return _reward(samples, queries)

    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    seen = []
    learn = PPOTrainer.learn

    def recorded(self):
        seen.append(self)
        return learn(self)

    monkeypatch.setattr(PPOTrainer, "learn", recorded)
    with pytest.raises(RuntimeError, match="reward service down"):
        _learn(tmp_path, reward=failing, run_dir=str(tmp_path / "run"),
               profile_dir=str(tmp_path / "prof"), profile_phase=1)
    (trainer,) = seen
    assert not trainer._phase_profiler.active and not torch.autograd._profiler_enabled()
    assert _traces(tmp_path / "prof") == ["phase_1.pt.trace.json"]
    manifest = json.load(open(tmp_path / "run" / "manifest.json"))
    assert manifest["payload"]["status"] == "error"
    assert manifest["payload"]["error"] == "RuntimeError: reward service down"
    # TRLX_RUN_LEDGER takes the ledger line instead of run_dir's
    assert [json.loads(r)["run_id"] for r in open(ledger)] == [manifest["run_id"]]
    assert not (tmp_path / "run" / "ledger.jsonl").exists()


def test_a_failing_first_collect_closes_a_phase_0_window(tmp_path):
    import torch

    def failing(samples, queries, response_gt=None):
        raise RuntimeError("reward service down")

    with pytest.raises(RuntimeError, match="reward service down"):
        _learn(tmp_path, reward=failing, profile_dir=str(tmp_path / "prof"), profile_phase=0)
    assert not torch.autograd._profiler_enabled()
    assert _traces(tmp_path / "prof") == ["phase_0.pt.trace.json"]


def test_close_stops_a_window_an_exception_left_open(tmp_path):
    import torch

    from trlx_tpu_torch.telemetry.profiler import PhaseProfiler

    prof = PhaseProfiler(str(tmp_path), target_phase=0, device="cpu")
    prof.on_phase_start(1)
    assert not prof.active
    prof.on_phase_start(0)
    assert prof.active and torch.autograd._profiler_enabled()
    try:
        raise KeyError("mid-phase")
    except KeyError:
        pass
    finally:
        prof.close()  # as learn's epilogue runs it
    assert not prof.active and not torch.autograd._profiler_enabled()
    assert _traces(tmp_path) == ["phase_0.pt.trace.json"]
    prof.close()  # idempotent


def test_a_window_is_armed_once(tmp_path):
    from trlx_tpu_torch.telemetry.profiler import PhaseProfiler

    prof = PhaseProfiler(str(tmp_path), target_phase=0)
    prof.on_phase_start(0)
    prof.on_phase_end()
    assert prof.done and prof.trace_path == str(tmp_path / "phase_0.pt.trace.json")
    prof.on_phase_start(0)
    assert not prof.active
    assert PhaseProfiler(None, None).enabled is False
    assert PhaseProfiler(None, 3).profile_dir == "profiles"
