"""The port's run-health monitoring against the JAX package's (CPU).

Held:

- one numpy-seeded stream of stats rows (KL and gradient spikes, an
  entropy collapse, a ratio explosion, a reward flatline, NaN and overflow
  precursors, trips inside cooldowns) trips the same events in both
  monitors: detector, severity, series, step, phase, value and message;
- the JAX monitor's ``state_dict`` loads into the port's and the port's
  into the JAX one's, and both then trip the same events on the rest of
  the stream;
- ``HealthConfig.from_dict`` refuses the same configs with the same
  messages;
- the flight recorder's dump carries the JAX record's keys, at the top and
  in each phase record, and the same stats, KL sequence and events;
- one greedy PPO phase through both packages' ``learn()`` with
  ``train.health`` on (the detectors tuned so that several trip in four
  updates, and ``flight_dump_phase: 0``): the ``health/*`` stats of every
  update within the phase tests' 2e-4, the same events (values to 2e-4),
  a flight dump from each with the same keys; the port's final parameters
  with health on and off ``torch.equal``;
- ILQL's three health stats against the JAX ``ilql_loss`` (1e-5), and a
  GRPO trainer's update stats without ``health/value_explained_var``;
- a continuous-engine collect that fails degrades to the fixed sampler
  with one ``engine-fallback`` event, which no ``on_error`` policy acts on.
"""

import copy
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ppo_phase import config, port_trainer, run_jax, run_port, span_tree
from trlx_tpu.telemetry import flight_recorder as jfr
from trlx_tpu.telemetry import health as jh
from trlx_tpu_torch.telemetry import flight_recorder as tfr
from trlx_tpu_torch.telemetry import health as th

EVENT_KEYS = ("detector", "severity", "series", "step", "phase", "value", "message")


def _stream(seed: int, n: int = 80):
    """Stats rows with planted anomalies; a few keys arrive as numpy
    scalars, as fetched rows do."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {
            "policy/approx_kl": float(0.06 + 0.01 * rng.normal()),
            "optimizer/grad_norm": np.float32(2.0 + 0.2 * rng.normal()),
            "health/entropy": float(3.0 + 0.05 * rng.normal()),
            "health/log_ratio_max": float(0.5 + 0.1 * rng.normal()),
            "health/reward_std": float(0.3 + 0.02 * rng.normal()),
            "losses/total_loss": np.float64(1.0 + 0.1 * rng.normal()),
            "exp/score_std": float(0.5),
        }
        if i in (20, 23, 60):
            row["policy/approx_kl"] = 5.0  # spikes; 23 inside 20's cooldown
        if i in (30, 31):
            row["optimizer/grad_norm"] = np.float32(80.0)
        if 40 <= i < 46:
            row["health/entropy"] = 0.5  # a collapse
        if i in (35, 70):
            row["health/log_ratio_max"] = 6.0
        if 50 <= i < 62:
            row["health/reward_std"] = 0.0  # a flatline
        if i == 55:
            row["losses/total_loss"] = float("nan")
        if i in (56, 57):
            row["losses/total_loss"] = 3e9  # overflow precursors
        if i == 65:
            row["health/entropy"] = float("inf")
        rows.append(row)
    return rows


def _events(evs):
    out = []
    for ev in evs:
        d = ev.to_dict()
        v = d["value"]
        out.append({k: ("nan" if k == "value" and isinstance(v, float) and math.isnan(v) else d[k])
                    for k in EVENT_KEYS} | {"window": d["window"]})
    return out


def _feed(monitor, rows, start=0):
    events = []
    for i, row in enumerate(rows, start):
        events += monitor.observe(row, step=i if i % 3 else None, phase=i // 10)
    return events


HEALTH = {"enabled": True, "warmup": 4, "cooldown": 4, "window": 8,
          "detectors": {"reward-saturation": {"patience": 4}}}


def test_event_stream_matches_jax():
    rows = _stream(0)
    jmon = jh.HealthMonitor(jh.HealthConfig.from_dict(HEALTH), "fp")
    tmon = th.HealthMonitor(th.HealthConfig.from_dict(HEALTH), "fp")
    want, got = _feed(jmon, rows), _feed(tmon, rows)
    assert len(want) >= 8
    assert {e.detector for e in want} >= {"kl-spike", "grad-spike", "entropy-collapse",
                                          "ratio-explosion", "reward-saturation",
                                          "nan-precursor"}
    assert _events(got) == _events(want)
    assert tmon.event_counts == jmon.event_counts
    assert tmon.state_summary() == jmon.state_summary()
    assert tmon.health_summary() == jmon.health_summary()
    assert th.format_events(got) == jh.format_events(want)
    assert th.detector_defaults_table() == jh.detector_defaults_table()
    assert th.config_fingerprint({"a": [1, 2]}) == jh.config_fingerprint({"a": [1, 2]})


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_loads_across_packages(direction):
    rows = _stream(1)
    head, tail = rows[:45], rows[45:]
    jmon = jh.HealthMonitor(jh.HealthConfig.from_dict(HEALTH), "fp")
    tmon = th.HealthMonitor(th.HealthConfig.from_dict(HEALTH), "fp")
    src, dst = (jmon, tmon) if direction == "jax_to_port" else (tmon, jmon)
    _feed(src, head)
    dst.load_state_dict(json.loads(json.dumps(src.state_dict())))
    assert dst.state_dict() == src.state_dict()
    assert _events(_feed(dst, tail, 45)) == _events(_feed(src, tail, 45))


@pytest.mark.parametrize("bad", [
    {"enabled": True, "bogus": 1},
    {"on_error": "explode"},
    {"detectors": {"no-such": {}}},
    {"disable": ["no-such"]},
    {"detectors": {"kl-spike": {"zmx": 3}}},
    {"detectors": {"kl-spike": {"severity": "fatal"}}},
    {"detectors": {"kl-spike": {"kind": "above"}}},
])
def test_config_refusals_match_jax(bad):
    with pytest.raises(ValueError) as want:
        jh.HealthConfig.from_dict(bad)
    with pytest.raises(ValueError) as got:
        th.HealthConfig.from_dict(bad)
    assert str(got.value) == str(want.value)


def test_host_float_skips_what_is_not_on_the_host():
    assert th._host_float(torch.tensor(2.5)) == 2.5
    assert th._host_float(torch.zeros(3)) is None
    assert th._host_float(True) is None and th._host_float(np.float32(1.5)) == 1.5
    assert th._host_float("x") is None


def test_flight_dump_carries_the_jax_record(tmp_path):
    rows = _stream(2, 12)
    dumps = []
    for pkg, fr, hm in (("jax", jfr, jh), ("port", tfr, th)):
        monitor = hm.HealthMonitor(hm.HealthConfig.from_dict(HEALTH), "fp")
        rec = fr.FlightRecorder(capacity=4, directory=str(tmp_path / pkg), fingerprint="fp",
                                config={"train": {"seed": 1}})
        for phase in range(3):
            events = _feed(monitor, rows[4 * phase:4 * phase + 4], 4 * phase)
            rec.record_phase(phase, step=4 * phase + 4, stats_row=rows[4 * phase + 3],
                             kl_seq=[0.1, 0.2], events=events,
                             detector_state=monitor.state_summary())
        with open(rec.dump("manual")) as fh:
            dumps.append(json.load(fh))
    want, got = dumps
    assert set(got) == set(want)
    assert len(got["phases"]) == len(want["phases"]) == 3
    for g, w in zip(got["phases"], want["phases"]):
        assert set(g) == set(w)
        for key in ("phase", "step", "stats", "kl_seq", "events", "detectors", "good"):
            assert g[key] == w[key], key
    assert got["config"] == want["config"] and got["reason"] == want["reason"]
    assert "last-good phase" in tfr.inspect_dump(got) or "tripped detectors" in tfr.inspect_dump(got)


# --------------------------- the PPO phase --------------------------- #


#: detectors tuned so that a four-update phase trips some: no warmup, a
#: ratio bound the updates' log-ratios pass, a KL z-score any rise passes,
#: and the reward flatline's eps above the collect row's score std. The
#: floors (1e-3) keep values at rounding-noise level (the first update's
#: log-ratio, the greedy phase's rollout KL, both ~1e-7) from deciding a
#: trip on one side only
PHASE_HEALTH = {
    "enabled": True, "warmup": 0, "cooldown": 1, "flight_capacity": 4,
    "detectors": {"ratio-explosion": {"threshold": 1e-3},
                  "kl-spike": {"zmax": 0.0, "min_abs": 1e-3},
                  "grad-spike": {"zmax": 0.0, "min_abs": 0.0},
                  "reward-saturation": {"eps": 10.0, "patience": 1}},
}


def _health_config(ckpt_dir, dump_dir, on=True):
    health = dict(PHASE_HEALTH, dump_dir=str(dump_dir)) if on else {"enabled": False}
    return config(ckpt_dir, train={"health": health, "flight_dump_phase": 0 if on else None})


@pytest.fixture(scope="module")
def health_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("health_phase")
    jax_run = run_jax(_health_config(tmp / "jax", tmp / "jax_dumps"))
    on = run_port(port_trainer(_health_config(tmp / "port", tmp / "port_dumps"),
                               jax_run["init"]))
    off = run_port(port_trainer(_health_config(tmp / "off", tmp / "off_dumps", on=False),
                                jax_run["init"]))
    return jax_run, on, off, tmp


def test_ppo_phase_health_stats_match_jax(health_runs):
    jax_run, port_run, _, _ = health_runs
    want = {k: v for k, v in jax_run["rows"].items() if k.startswith("health/")}
    got = {k: v for k, v in port_run["rows"].items() if k.startswith("health/")}
    assert set(got) == set(want) == {
        "health/entropy", "health/log_ratio_max", "health/log_ratio_min",
        "health/value_explained_var", "health/reward_mean", "health/reward_std",
        "health/reward_q10", "health/reward_q50", "health/reward_q90"}
    for key, w in want.items():
        np.testing.assert_allclose(got[key], np.asarray(w), atol=2e-4, rtol=2e-4, err_msg=key)


def test_ppo_phase_events_match_jax(health_runs):
    jax_run, port_run, _, _ = health_runs
    want = jax_run["trainer"].health_monitor.events
    got = port_run["trainer"].health_monitor.events
    assert len(want) >= 4
    assert [(e.detector, e.severity, e.series, e.step, e.phase) for e in got] == [
        (e.detector, e.severity, e.series, e.step, e.phase) for e in want]
    np.testing.assert_allclose([e.value for e in got], [e.value for e in want],
                               atol=2e-4, rtol=2e-4)
    # one zero-length health/<detector> marker span per trip, in both
    markers = {name: entry for name, entry in span_tree(port_run["tracer"]).items()
               if name.startswith("health/")}
    assert markers == {name: entry for name, entry in span_tree(jax_run["tracer"]).items()
                       if name.startswith("health/")}
    assert sum(m["count"] for m in markers.values()) == len(got)


def test_ppo_phase_flight_dump_matches_the_jax_record(health_runs):
    jax_run, port_run, _, tmp = health_runs
    (jpath,), (tpath,) = (r["trainer"].flight_recorder.dumped for r in (jax_run, port_run))
    with open(jpath) as fh:
        want = json.load(fh)
    with open(tpath) as fh:
        got = json.load(fh)
    assert set(got) == set(want) and got["reason"] == want["reason"] == "flight_dump_phase:0"
    assert [set(p) for p in got["phases"]] == [set(p) for p in want["phases"]]
    assert [p["phase"] for p in got["phases"]] == [p["phase"] for p in want["phases"]]
    # the span and registry sections hold the same names
    assert [sorted(p["spans"]) for p in got["phases"]] == [
        sorted(p["spans"]) for p in want["phases"]]
    assert [{k: sorted(v) for k, v in p["metrics"].items()} for p in got["phases"]] == [
        {k: sorted(v) for k, v in p["metrics"].items()} for p in want["phases"]]


def test_health_is_bitwise_inert(health_runs):
    _, on, off, _ = health_runs
    a, b = on["trainer"].model.state_dict(), off["trainer"].model.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in a)
    assert off["trainer"].health_monitor is None
    assert not any(k.startswith("health/") for k in off["rows"])


def test_ilql_health_stats_match_jax():
    from test_torch_ilql_math import FIELDS, TBatch, _loss_inputs

    from trlx_tpu.ops import ilql_math as jm
    from trlx_tpu_torch.data.method_configs import ILQLConfig as TConfig
    from trlx_tpu_torch.ops import ilql_math as tm

    jbatch, x = _loss_inputs(3, True)
    kw = dict(tau=0.7, gamma=0.9, cql_scale=0.1, awac_scale=1.0, two_qs=True)
    _, jstats = jm.ilql_loss(jnp.asarray(x["logits"]), tuple(map(jnp.asarray, x["qs"])),
                             tuple(map(jnp.asarray, x["target_qs"])), jnp.asarray(x["vs"]),
                             jbatch, jm.ILQLConfig(**kw), health=True)
    tbatch = TBatch(**{f: torch.from_numpy(np.array(getattr(jbatch, f))) for f in FIELDS})
    _, tstats = tm.ilql_loss(torch.from_numpy(x["logits"]), [torch.from_numpy(q) for q in x["qs"]],
                             [torch.from_numpy(q) for q in x["target_qs"]],
                             torch.from_numpy(x["vs"]), tbatch, TConfig(**kw), health=True)
    for key in ("health/entropy", "health/q_max", "health/td_error_mean"):
        np.testing.assert_allclose(tstats[key].item(), float(jstats[key]), rtol=1e-5, atol=0,
                                   err_msg=key)


def test_grpo_carries_no_value_explained_variance(tmp_path):
    from trlx_tpu.analysis import harness
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.ops.ppo_math import ppo_loss
    from trlx_tpu_torch.trainer import get_trainer

    cfg = copy.deepcopy(harness.tiny_config_dict("grpo"))
    cfg["train"].update(dtype="float32", checkpoint_dir=str(tmp_path),
                        mesh={"dp": -1, "fsdp": 1, "tp": 1}, health={"enabled": True})
    trainer = get_trainer("GRPOTrainer")(TRLConfig.from_dict(cfg), device="cpu")
    assert trainer._health_enabled and trainer._health_ev is False
    rng = np.random.default_rng(0)
    t = [torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32)) for _ in range(6)]
    _, stats = ppo_loss(*t, torch.ones(4, 5), 0.2, 0.2, 0.0, health=True, health_ev=False)
    assert "health/log_ratio_max" in stats and "health/value_explained_var" not in stats


def test_engine_failure_degrades_to_the_fixed_sampler_with_an_event(tmp_path):
    """A failure on the continuous engine's collect path switches the
    trainer to the fixed sampler, records one ``engine-fallback`` warning
    in the monitor (no ``on_error`` policy: the abort policy does not
    fire), and collects the phase on the fixed sampler."""
    cfg = config(tmp_path / "ckpt", train={
        "health": {"enabled": True, "on_error": "abort"},
        "rollout": {"engine": "continuous", "slots": 8, "block_size": 4}})
    trainer = port_trainer(cfg)
    orch = trainer.orch

    def broken(num_rollouts, iter_count):
        raise RuntimeError("engine lost")

    orch._make_experience_continuous = broken
    trainer._phase_index = 0
    from trlx_tpu_torch import telemetry

    with telemetry.scoped_tracer() as tracer:
        orch.make_experience(cfg["method"]["num_rollouts"], 0)
    assert [s.name for s in tracer.spans("health/engine-fallback")] == ["health/engine-fallback"]
    assert trainer.rollout_engine == "fixed" and len(trainer.buffer) == 16
    (ev,) = [e for e in trainer.health_monitor.events if e.detector == "engine-fallback"]
    assert (ev.severity, ev.series, ev.step, ev.phase) == ("warning", "engine", 0, 0)
    assert "engine lost" in ev.message
