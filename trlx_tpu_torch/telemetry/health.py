"""Run-health monitoring: training-dynamics detectors over the stats stream
(counterpart of :mod:`trlx_tpu.telemetry.health`; the port keeps its own
copy).

The failure modes that end RLHF runs (KL blowups, entropy collapse, PPO
ratio explosions, gradient spikes, reward saturation, the slide into NaN)
show in the per-update stats rows long before the loss curve looks wrong.
The :class:`HealthMonitor` reads each row the moment it reaches the host.

- **No extra device traffic**: the monitor only consumes values that are
  already on the host, the stats rows every train path fetches anyway. A
  tensor still on a CUDA device is skipped, never read (reading it would
  synchronise the device). The device-side health scalars (entropy under
  ``ent_coef=0``, log-ratio extremes, value explained variance, reward
  quantiles) are extra outputs of the update's stats
  (``ops/ppo_math.py``, ``ops/ilql_math.py``) under the same ``health``
  flag, so they ride the existing fetch.
- **Bitwise-inert**: ``health.enabled`` does not perturb training. The
  detectors are host arithmetic over fetched floats; the device stats are
  outputs of the step, never inputs to the loss.
- **Streaming**: each watched series keeps an EWMA mean and variance and a
  bounded window, O(1) per observation.

A tripped rule emits a :class:`HealthEvent` into the Logger (one
``health_event`` JSON line) and, at ``error`` severity, applies the
``health.on_error`` policy: ``warn`` (default), ``dump`` (write a
flight-recorder forensics file) or ``abort`` (dump, then raise
:class:`HealthAbort`). The trainer also writes a zero-length
``health/<id>`` marker span per trip
(:meth:`~trlx_tpu_torch.trainer.BaseRLTrainer.observe_health`).

The detectors, their series and their defaults are the JAX package's, so
one stream of rows trips the same events in both monitors, and either
monitor's :meth:`HealthMonitor.state_dict` loads into the other.
"""

from __future__ import annotations

import hashlib
import json
import math
from collections import deque
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Sequence, Tuple


class HealthAbort(RuntimeError):
    """Raised by the ``health.on_error: abort`` policy after the flight
    dump is written — crash-fast instead of training on into garbage."""


#: severity levels, weakest first
SEVERITIES = ("info", "warning", "error")

#: stat-key prefixes the nan-precursor rule scans (everything numeric the
#: step reports about the model's dynamics)
NAN_WATCH_PREFIXES = (
    "losses/", "policy/", "values/", "returns/", "advantages/",
    "optimizer/", "health/",
)

#: The detector registry: id -> spec. ``series`` lists candidate stat
#: keys (every candidate present in a row is evaluated against its own
#: per-key state — different train paths surface different keys).
#: Kinds:
#:   zscore   — value spikes ``zmax`` sigmas above its EWMA (armed after
#:              ``warmup`` observations; absolute floor ``min_abs`` so
#:              microscopic series can't trip on noise)
#:   collapse — value drops below ``frac`` x its EWMA baseline, baseline
#:              itself above ``min_baseline`` (armed after warmup)
#:   above    — value exceeds an absolute ``threshold`` (always armed)
#:   flatline — value stays below ``eps`` for ``patience`` consecutive
#:              observations (armed after warmup)
#:   nonfinite— any watched stat is NaN/Inf or exceeds ``huge`` in
#:              magnitude (always armed; the precursor fires on the huge
#:              value BEFORE check_anomalies sees the NaN it becomes)
DEFAULT_DETECTORS: Dict[str, Dict[str, Any]] = {
    "kl-spike": dict(
        series=("policy/mean_rollout_kl", "policy/approx_kl"),
        kind="zscore", severity="error", zmax=8.0, min_abs=0.05,
    ),
    "entropy-collapse": dict(
        series=("health/entropy",),
        kind="collapse", severity="error", frac=0.4, min_baseline=0.2,
    ),
    "ratio-explosion": dict(
        series=("health/log_ratio_max",),
        kind="above", severity="error", threshold=4.0,
    ),
    "grad-spike": dict(
        series=("optimizer/grad_norm",),
        kind="zscore", severity="warning", zmax=12.0, min_abs=1.0,
    ),
    "reward-saturation": dict(
        series=("health/reward_std", "exp/score_std"),
        kind="flatline", severity="warning", eps=1e-6, patience=8,
    ),
    "nan-precursor": dict(
        series=(), kind="nonfinite", severity="error", huge=1e8,
    ),
    # async actor–learner circuit-breaker (docs/async_pipeline.md): the
    # per-phase max rollout staleness (learner updates ahead of the
    # oldest consumed row's behavior policy). The version-lag guard
    # should make a breach impossible; a trip therefore means the guard
    # or the version tagging is broken — error severity so the
    # health.on_error policy (warn/dump/abort) is the breaker. The
    # effective threshold is injected from train.async_rl's
    # staleness_window when async RL is enabled (BaseRLTrainer._setup_
    # health); the registry default never trips on its own.
    "staleness-breach": dict(
        series=("async/staleness",),
        kind="above", severity="error", threshold=1e9,
    ),
    # serving-tier SLO watch (docs/serving.md): the serving loop feeds
    # one row per harvest group with the measured queue-wait p95 over
    # each tenant's SLO-class budget, keyed per tenant
    # (serve/slo_queue_wait_ratio[tenant=acme] — matched by PREFIX
    # since tenant names are dynamic). A ratio > 1 means that tenant's
    # requests waited longer than its class promises; warning severity
    # (a breach wants scheduling/capacity attention, not an abort), and
    # it flows through the same event sinks as every detector.
    "slo-breach": dict(
        series=(), series_prefix=("serve/slo_queue_wait_ratio",),
        kind="above", severity="warning", threshold=1.0,
    ),
}


@dataclass
class HealthConfig:
    """``train.health`` section (plain dict in YAML, parsed here).

    :param enabled: master switch — off (the default) keeps every jitted
        program and stats row byte-identical to a pre-health build.
    :param on_error: policy for ``error``-severity trips: ``warn`` logs,
        ``dump`` writes a flight-recorder forensics file, ``abort``
        dumps then raises :class:`HealthAbort`.
    :param window: recent-values window per series (event context) and
        the EWMA half-life scale (alpha = 2/(window+1)).
    :param warmup: observations per series before z-score/collapse/
        flatline rules arm (startup transients must not trip).
    :param cooldown: observations a tripped detector+series stays quiet
        after an event (one anomaly = one event, not one per row).
    :param flight_capacity: phase records the flight ring retains.
    :param dump_dir: directory flight dumps are written into.
    :param detectors: per-id parameter overrides, e.g.
        ``{"kl-spike": {"zmax": 12.0}}``.
    :param disable: detector ids to turn off.
    """

    enabled: bool = False
    on_error: str = "warn"
    window: int = 32
    warmup: int = 8
    cooldown: int = 16
    flight_capacity: int = 16
    dump_dir: str = "health_dumps"
    max_events: int = 256
    detectors: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    disable: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, config: Optional[Dict[str, Any]]) -> "HealthConfig":
        config = dict(config or {})
        known = {f.name for f in fields(cls)}
        unknown = set(config) - known
        if unknown:
            raise ValueError(
                f"Unknown train.health keys: {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        out = cls(**config)
        if out.on_error not in ("warn", "dump", "abort"):
            raise ValueError(
                f'train.health.on_error={out.on_error!r} must be one of '
                f'"warn" | "dump" | "abort"'
            )
        for did in list(out.detectors) + list(out.disable):
            if did not in DEFAULT_DETECTORS:
                raise ValueError(
                    f"unknown health detector {did!r}; known: "
                    f"{sorted(DEFAULT_DETECTORS)}"
                )
        for did, overrides in out.detectors.items():
            # same loudness as the top-level keys: a tuning typo
            # ("zmx") silently keeping the old threshold is worse than
            # a refusal. series/kind are structural, not tunable.
            tunable = set(DEFAULT_DETECTORS[did]) - {
                "series", "series_prefix", "kind",
            }
            unknown_params = set(overrides) - tunable
            if unknown_params:
                raise ValueError(
                    f"unknown keys for health detector {did!r}: "
                    f"{sorted(unknown_params)} (tunable: {sorted(tunable)})"
                )
            severity = overrides.get("severity")
            if severity is not None and severity not in SEVERITIES:
                # a misspelled severity would silently never match the
                # on_error policy's `== "error"` filter
                raise ValueError(
                    f"health detector {did!r}: severity {severity!r} "
                    f"must be one of {SEVERITIES}"
                )
        return out


def config_fingerprint(config_dict: Dict[str, Any]) -> str:
    """Short stable hash of a run config — stamped into every event and
    flight dump so forensics files self-identify which config produced
    them (two dumps with different fingerprints are not comparable)."""
    blob = json.dumps(config_dict, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12]


@dataclass
class HealthEvent:
    """One detector trip. ``window`` carries the recent series values
    (newest last) so the dump/inspect view shows the run-up, not just
    the offending point."""

    detector: str
    severity: str
    series: str
    value: float
    step: int
    phase: Optional[int]
    message: str
    fingerprint: str = ""
    zscore: Optional[float] = None
    baseline: Optional[float] = None
    threshold: Optional[float] = None
    window: List[float] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "detector": self.detector,
            "severity": self.severity,
            "series": self.series,
            "value": self.value,
            "step": self.step,
            "phase": self.phase,
            "message": self.message,
            "fingerprint": self.fingerprint,
            "window": list(self.window),
        }
        for key in ("zscore", "baseline", "threshold"):
            v = getattr(self, key)
            if v is not None:
                out[key] = v
        return out


class _SeriesState:
    """EWMA mean/variance + bounded recent window for one stat key."""

    __slots__ = ("count", "mean", "var", "window", "flat_run")

    def __init__(self, window: int):
        self.count = 0
        self.mean = 0.0
        self.var = 0.0
        self.window: "deque[float]" = deque(maxlen=window)
        self.flat_run = 0  # consecutive sub-eps observations (flatline)

    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))

    def update(self, value: float, alpha: float) -> None:
        self.count += 1
        if self.count == 1:
            self.mean = value
            self.var = 0.0
        else:
            delta = value - self.mean
            self.mean += alpha * delta
            # EW variance of the residual around the moving mean
            self.var = (1.0 - alpha) * (self.var + alpha * delta * delta)
        self.window.append(value)


def _host_float(value: Any) -> Optional[float]:
    """``value`` as a host float, or None when it is not already host-side.

    The monitor never forces a device read: a tensor on a CUDA device is
    skipped here (reading it would synchronise the device) and observed
    later from the fetched row it lands in. A CPU tensor of one element
    is a host value."""
    if isinstance(value, (bool,)):
        return None
    if isinstance(value, (int, float)):
        return float(value)
    module = type(value).__module__
    if module.startswith("torch"):
        if getattr(value, "device", None) is None or value.device.type != "cpu":
            return None
        return float(value) if value.numel() == 1 else None
    # numpy scalars / 0-d arrays without importing numpy at module top
    if module.startswith("numpy"):
        try:
            return float(value)
        except (TypeError, ValueError):
            return None
    return None


class HealthMonitor:
    """Streaming detector engine over per-update/per-phase stats rows.

    ``observe`` is the whole API: feed it every host-side stats row in
    arrival order; it returns the :class:`HealthEvent` list that row
    tripped (usually empty). State is per stat key, so rows of different
    shapes (update rows, orchestrator collect rows) interleave freely.
    """

    def __init__(self, config: Optional[HealthConfig] = None,
                 fingerprint: str = ""):
        self.config = config or HealthConfig(enabled=True)
        self.fingerprint = fingerprint
        self._alpha = 2.0 / (max(int(self.config.window), 2) + 1.0)
        self._series: Dict[str, _SeriesState] = {}
        # cooldown horizon per (detector, series) — per the config
        # contract "one anomaly = one event": keyed by BOTH so one
        # detector's trip cannot silence a different detector watching
        # the same key (a grad-spike warning must not mask a NaN)
        self._quiet: Dict[Tuple[str, str], int] = {}
        self._observations = 0
        self.events: List[HealthEvent] = []
        self.event_counts: Dict[str, int] = {}
        self.latest: Dict[str, float] = {}
        self._specs: Dict[str, Dict[str, Any]] = {}
        for did, spec in DEFAULT_DETECTORS.items():
            if did in self.config.disable:
                continue
            merged = dict(spec)
            merged.update(self.config.detectors.get(did, {}))
            self._specs[did] = merged

    # ---------------------------- checkpointing ---------------------------- #

    def state_dict(self) -> Dict[str, Any]:
        """Resume-carried detector state. The EWMA baselines, warmup
        counts, flatline runs, and cooldown horizons all feed whether
        the next observation trips an event: a monitor rebuilt empty
        after a supervisor restart would re-warm from scratch and stay
        silent through exactly the post-resume steps most likely to
        regress. Everything here is host JSON scalars — safe for the
        checkpoint metadata pickle."""
        return {
            "series": {
                key: {
                    "count": st.count,
                    "mean": st.mean,
                    "var": st.var,
                    "window": list(st.window),
                    "flat_run": st.flat_run,
                }
                for key, st in sorted(self._series.items())
            },
            "quiet": [
                [detector, series, horizon]
                for (detector, series), horizon in sorted(self._quiet.items())
            ],
            "observations": self._observations,
            "event_counts": dict(self.event_counts),
            "latest": dict(self.latest),
            "events": [ev.to_dict() for ev in self.events],
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._series = {}
        for key, st_state in state["series"].items():
            st = _SeriesState(self.config.window)
            st.count = int(st_state["count"])
            st.mean = float(st_state["mean"])
            st.var = float(st_state["var"])
            st.window.extend(float(v) for v in st_state["window"])
            st.flat_run = int(st_state["flat_run"])
            self._series[key] = st
        self._quiet = {
            (detector, series): int(horizon)
            for detector, series, horizon in state["quiet"]
        }
        self._observations = int(state["observations"])
        self.event_counts = {
            k: int(v) for k, v in state["event_counts"].items()
        }
        self.latest = {k: float(v) for k, v in state["latest"].items()}
        self.events = [HealthEvent(**ev) for ev in state["events"]]

    # ------------------------------ internals ----------------------------- #

    def _state(self, key: str) -> _SeriesState:
        st = self._series.get(key)
        if st is None:
            st = self._series[key] = _SeriesState(self.config.window)
        return st

    def _emit(
        self,
        events: List[HealthEvent],
        detector: str,
        spec: Dict[str, Any],
        key: str,
        value: float,
        step: int,
        phase: Optional[int],
        message: str,
        st: _SeriesState,
        **extra: Any,
    ) -> None:
        self._quiet[(detector, key)] = (
            self._observations + int(self.config.cooldown)
        )
        ev = HealthEvent(
            detector=detector,
            severity=spec["severity"],
            series=key,
            value=value,
            step=step,
            phase=phase,
            message=message,
            fingerprint=self.fingerprint,
            window=[round(v, 6) for v in st.window],
            **extra,
        )
        events.append(ev)
        self.events.append(ev)
        if len(self.events) > self.config.max_events:
            del self.events[: len(self.events) - self.config.max_events]
        self.event_counts[detector] = self.event_counts.get(detector, 0) + 1

    def _evaluate(
        self,
        events: List[HealthEvent],
        detector: str,
        spec: Dict[str, Any],
        key: str,
        value: float,
        step: int,
        phase: Optional[int],
    ) -> None:
        st = self._state(key)
        kind = spec["kind"]
        warm = st.count >= int(self.config.warmup)
        cooled = self._observations >= self._quiet.get((detector, key), -1)
        if not cooled:
            return
        if kind == "zscore" and warm:
            baseline = st.mean
            zmax = float(spec["zmax"])
            min_abs = float(spec["min_abs"])
            # std floor: a dead-flat series (std ~ 0) would make any
            # nonzero delta an infinite z; floor by a fraction of the
            # baseline magnitude plus an absolute epsilon
            std = max(st.std(), 0.05 * abs(baseline), 1e-8)
            z = (value - baseline) / std
            if z > zmax and value > min_abs:
                self._emit(
                    events, detector, spec, key, value, step, phase,
                    f"{key} = {value:.4g} is {z:.1f} sigma above its "
                    f"EWMA {baseline:.4g} (zmax {spec['zmax']})",
                    st, zscore=round(z, 2), baseline=baseline,
                )
        elif kind == "collapse" and warm:
            baseline = st.mean
            bound = float(spec["frac"]) * baseline
            min_baseline = float(spec["min_baseline"])
            if baseline > min_baseline and value < bound:
                self._emit(
                    events, detector, spec, key, value, step, phase,
                    f"{key} = {value:.4g} collapsed below "
                    f"{spec['frac']} x its EWMA {baseline:.4g}",
                    st, baseline=baseline, threshold=bound,
                )
        elif kind == "above":
            threshold = float(spec["threshold"])
            above = value > threshold
            if above:
                self._emit(
                    events, detector, spec, key, value, step, phase,
                    f"{key} = {value:.4g} exceeds the absolute bound "
                    f"{threshold:.4g}",
                    st, threshold=threshold,
                )
        elif kind == "flatline":
            eps = float(spec["eps"])
            patience = int(spec["patience"])
            if abs(value) < eps:
                st.flat_run += 1
            else:
                st.flat_run = 0
            if warm and st.flat_run >= patience:
                self._emit(
                    events, detector, spec, key, value, step, phase,
                    f"{key} has been < {spec['eps']:g} for "
                    f"{st.flat_run} consecutive rows — the signal "
                    f"saturated (no gradient information left in it)",
                    st, threshold=float(spec["eps"]),
                )
                st.flat_run = 0

    # -------------------------------- API --------------------------------- #

    def observe(
        self,
        row: Dict[str, Any],
        step: Optional[int] = None,
        phase: Optional[int] = None,
    ) -> List[HealthEvent]:
        """Feed one host-side stats row; returns the events it tripped.

        ``step`` defaults to an internal observation counter so callers
        without a loop counter still get ordered events. Tensors on a CUDA
        device in the row are skipped, never read."""
        if not row:
            return []
        if step is None:
            step = self._observations
        values: Dict[str, float] = {}
        for key, raw in row.items():
            v = _host_float(raw)
            if v is not None:
                values[key] = v
        if not values:
            return []
        events: List[HealthEvent] = []

        # nonfinite precursor first: a NaN would poison the EWMAs below
        nonfinite = self._specs.get("nan-precursor")
        huge = float(nonfinite["huge"]) if nonfinite is not None else 0.0
        for key in list(values):
            v = values[key]
            if not math.isfinite(v):
                # prefix-scoped like the huge branch (a bookkeeping
                # stat outside the watch list must not abort a run),
                # with the same cooldown as every other rule: a
                # persistently-NaN key is one anomaly, not one event
                # per row
                if (
                    nonfinite is not None
                    and key.startswith(NAN_WATCH_PREFIXES)
                    and self._observations
                    >= self._quiet.get(("nan-precursor", key), -1)
                ):
                    self._emit(
                        events, "nan-precursor", nonfinite, key, v, step,
                        phase, f"{key} went non-finite ({v})",
                        self._state(key),
                    )
                del values[key]  # keep the EWMA state finite
            elif (
                nonfinite is not None
                and key.startswith(NAN_WATCH_PREFIXES)
                and abs(v) > huge
            ):
                if (
                    self._observations
                    >= self._quiet.get(("nan-precursor", key), -1)
                ):
                    self._emit(
                        events, "nan-precursor", nonfinite, key, v, step,
                        phase,
                        f"|{key}| = {abs(v):.3g} exceeds "
                        f"{nonfinite['huge']:.0g} — overflow precursor",
                        self._state(key),
                    )
                # an overflow-magnitude sample would poison the EWMA
                # baseline (one 2e8 entropy row makes the NEXT normal
                # row a spurious collapse) — keep it out of the state,
                # like the non-finite branch
                del values[key]

        # evaluate every detector against every candidate series present
        # (pre-update stats = the baseline the new value is judged by);
        # prefix-series detectors (slo-breach) match dynamically-named
        # keys like serve/slo_queue_wait_ratio[tenant=...]
        for did, spec in self._specs.items():
            if spec["kind"] == "nonfinite":
                continue
            candidates = [k for k in spec["series"] if k in values]
            for prefix in spec.get("series_prefix", ()):
                candidates.extend(
                    k for k in sorted(values)
                    if k.startswith(prefix) and k not in candidates
                )
            for key in candidates:
                self._evaluate(
                    events, did, spec, key, values[key], step, phase
                )

        # then advance each series exactly once
        for key, v in values.items():
            self._state(key).update(v, self._alpha)
        self.latest.update(values)
        self._observations += 1
        return events

    def state_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-series EWMA snapshot for the flight recorder."""
        out: Dict[str, Dict[str, float]] = {}
        for key, st in sorted(self._series.items()):
            out[key] = {
                "count": float(st.count),
                "ewma": round(st.mean, 6),
                "std": round(st.std(), 6),
                "last": round(st.window[-1], 6) if st.window else 0.0,
            }
        return out

    def recent_events(self, phase: Optional[int] = None) -> List[HealthEvent]:
        if phase is None:
            return list(self.events)
        return [ev for ev in self.events if ev.phase == phase]

    def health_summary(self) -> Dict[str, float]:
        """Latest value of every ``health/`` series."""
        return {
            k: round(v, 6)
            for k, v in sorted(self.latest.items())
            if k.startswith("health/")
        }


def detector_defaults_table() -> List[Tuple[str, str, str, str]]:
    """(id, kind, severity, params) rows of the detector registry."""
    rows = []
    for did, spec in sorted(DEFAULT_DETECTORS.items()):
        params = ", ".join(
            f"{k}={v}" for k, v in sorted(spec.items())
            if k not in ("series", "series_prefix", "kind", "severity")
        )
        rows.append((did, spec["kind"], spec["severity"], params))
    return rows


def format_events(events: Sequence[HealthEvent]) -> str:
    lines = []
    for ev in events:
        lines.append(
            f"[{ev.severity}] {ev.detector} @ step {ev.step}"
            f"{'' if ev.phase is None else f' phase {ev.phase}'}: "
            f"{ev.message}"
        )
    return "\n".join(lines)
