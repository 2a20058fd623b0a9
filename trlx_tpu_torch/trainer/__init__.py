"""Trainer layer (counterpart of :mod:`trlx_tpu.trainer`): the trainer
registry and the part of ``BaseRLTrainer`` the PPO and ILQL paths use —
generation defaults from a tokenizer, the log/eval/save cadence, the host
text boundary, evaluation (scored by the reward function, the metric
function, both or neither), the non-finite-loss check, and run-health
monitoring (``train.health``: the detectors of
:mod:`~trlx_tpu_torch.telemetry.health` over every fetched stats row, their
events on the Logger and as zero-length ``health/<detector>`` marker spans,
and the crash-forensics flight recorder with ``train.flight_dump_phase``),
the preemption drain at phase boundaries (:meth:`BaseRLTrainer.maybe_drain`),
and the telemetry the JAX base trainer wires: the span ring sized from
``train.telemetry`` at construction, the ``phase/eval`` span, the live
``<run_dir>/phases.jsonl`` feed riding the flight recorder, and the run
ledger's manifest at ``learn``'s end (:meth:`BaseRLTrainer.append_run_ledger`).
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.utils import monotonic

_TRAINERS: Dict[str, type] = {}

#: ``train`` keys of the shared schema whose features the port does not
#: have yet: (default, the ROADMAP item that brings it). A value other than
#: the default is refused instead of silently ignored.
UNPORTED_TRAIN_KEYS = {
    "pp_microbatches": (2, "14.5 (pipeline parallelism)"),
    "pp_virtual_stages": (1, "14.5 (pipeline parallelism)"),
    "pp_remat": (False, "14.5 (pipeline parallelism)"),
}


def register_trainer(name=None):
    """Decorator registering a trainer class under its (lowercase) name."""

    def register_class(cls, key: str):
        _TRAINERS[key] = cls
        setattr(sys.modules[__name__], key, cls)
        return cls

    if isinstance(name, type):
        return register_class(name, name.__name__.lower())

    def wrap(cls):
        return register_class(cls, (name or cls.__name__).lower())

    return wrap


def get_trainer(name: str) -> type:
    key = name.lower()
    if key not in _TRAINERS:
        import trlx_tpu_torch.trainer.grpo_trainer  # noqa: F401
        import trlx_tpu_torch.trainer.ilql_trainer  # noqa: F401
        import trlx_tpu_torch.trainer.ppo_trainer  # noqa: F401
        import trlx_tpu_torch.trainer.seq2seq_ppo_trainer  # noqa: F401
    if key in _TRAINERS:
        return _TRAINERS[key]
    raise ValueError(f"Unknown trainer: {name!r}. Registered: {sorted(_TRAINERS)}")


def refuse_unported(config, trainer=None) -> None:
    """Raise on a configured training feature the port does not have,
    naming the ROADMAP item that brings it (``train.rollout``'s chunked
    prefill and speculative decoding are refused where it is parsed,
    :class:`~trlx_tpu_torch.inference.RolloutEngineConfig`), and on a mesh
    of more than one rank that ``trainer`` cannot train under
    (:func:`refuse_mesh`)."""
    train = config.train
    for key, (default, item) in UNPORTED_TRAIN_KEYS.items():
        value = train.training.get(key, default)
        if value != default:
            raise NotImplementedError(
                f"train.{key}={value!r} is not ported yet (ROADMAP item {item})"
            )
    refuse_mesh(config, trainer)


#: model families the PPO-family trainers shard, and the mesh axes each
#: takes (GPT-Neo's local band is not wired for tp: ROADMAP item 14)
MESH_FAMILIES = {"gpt2": ("dp", "fsdp", "tp"), "gptj": ("dp", "fsdp", "tp"),
                 "gpt_neox": ("dp", "fsdp", "tp"), "gpt_neo": ("dp", "fsdp")}


def requested_mesh(config) -> Dict[str, int]:
    """``train.mesh`` with the defaults filled: every axis's asked size,
    -1 (all remaining ranks) left as it is."""
    from trlx_tpu_torch.parallel.mesh import AXES, AXIS_DP

    mesh = dict(config.train.training.get("mesh") or {})
    return {axis: int(mesh.get(axis, -1 if axis == AXIS_DP else 1)) for axis in AXES}


def refuse_mesh(config, trainer=None) -> None:
    """Refuse, by name and ROADMAP item, what no trainer runs under a mesh
    of more than one rank: ``pp`` (14.5), ``ep`` (14.6), and ``sp`` in the
    trainers (14.3), whatever the world; and, once the mesh asks for more
    than one rank (an axis above 1, or the ``-1`` axis over a world of
    several), ILQL and the seq2seq trainers, a family other than gpt2,
    gptj, gpt_neox and gpt_neo (gpt2_moe: 14.6), tp for gpt_neo, the
    continuous engine as a rollout source, ``async_rl`` (14.4) and bf16
    Adam moments."""
    import torch.distributed as dist

    sizes = requested_mesh(config)
    for axis, item in (("pp", "14.5 (pipeline parallelism)"),
                       ("ep", "14.6 (expert parallelism, parallel/moe.py)"),
                       ("sp", "14.3 (the trainers' sp-sharded decode cache)")):
        if sizes[axis] not in (-1, 1):
            raise NotImplementedError(
                f"train.mesh {axis}={sizes[axis]} is not ported to the trainers yet "
                f"(ROADMAP item {item})"
            )
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not any(v > 1 for v in sizes.values()) and not (-1 in sizes.values() and world > 1):
        return
    where = f"train.mesh={config.train.training.get('mesh')}"
    name = type(trainer).__name__ if trainer is not None else "this trainer"
    if not getattr(trainer, "supports_mesh", False):
        raise NotImplementedError(
            f"{where}: {name} trains on one rank; dp/fsdp/tp training covers the "
            "PPO and GRPO trainers of the causal families (ILQL, seq2seq T5 and its "
            "GRPO under a mesh: ROADMAP item 14)"
        )
    family = config.model.model_type.lower().replace("-", "_")
    family = {"neox": "gpt_neox"}.get(family, family)
    if family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{where}: model_type {config.model.model_type!r} trains on one rank "
            "(gpt2_moe's sharded path is ROADMAP item 14.6)"
        )
    for axis in ("dp", "fsdp", "tp"):
        if sizes[axis] > 1 and axis not in MESH_FAMILIES[family]:
            raise NotImplementedError(
                f"{where}: {axis} > 1 is not wired for {family} (its local attention "
                "band under tensor parallelism: ROADMAP item 14)"
            )
    rollout = dict(config.train.rollout or {})
    if rollout.get("engine", "fixed") == "continuous":
        raise NotImplementedError(
            f"{where}: the continuous engine as a rollout source runs on one rank "
            "(ROADMAP items 14 and 15); use rollout.engine: fixed"
        )
    if dict(config.train.training.get("async_rl") or {}).get("enabled"):
        raise NotImplementedError(
            f"{where}: async_rl runs on one rank (the actors' own device subset: "
            "ROADMAP item 14.4)"
        )
    if config.train.adam_moment_dtype == "bfloat16":
        raise NotImplementedError(
            f"{where}: adam_moment_dtype bfloat16 trains on one rank: its rounding noise "
            "is drawn over the flat global moments (ROADMAP item 14)"
        )


class BaseRLTrainer:
    """Shared trainer behaviour; subclasses provide ``sample``, ``learn``,
    ``save`` and ``load``. ``logit_mask`` ([V, V] bool: token ``i`` may
    follow token ``j`` where ``logit_mask[j, i]``) restricts ILQL's eval
    decode."""

    def __init__(
        self,
        config,
        reward_fn: Optional[Callable] = None,
        metric_fn: Optional[Callable] = None,
        tokenizer=None,
        logit_mask=None,
    ):
        self.config = config
        self.reward_fn = reward_fn
        self.metric_fn = metric_fn
        self.tokenizer = tokenizer
        self.logit_mask = logit_mask
        self.orch = None  # back-reference installed by the orchestrator
        self.eval_pipeline = None
        self.logger = None
        self._final_stats: Dict[str, Any] = {}  # the run ledger's payload
        # the span ring's capacity (train.telemetry.ring_size), sized
        # before any phase emits spans
        telemetry.configure_from_dict(config.train.training.get("telemetry"))
        self._setup_health()

    # --- run health ----------------------------------------------------- #

    def _setup_health(self) -> None:
        """Parse ``train.health`` and, when enabled, build the detector
        monitor and the flight recorder (on the main process only), and
        with ``train.run_dir`` the live ``phases.jsonl`` feed, which rides
        the flight recorder's phase records. ``_health_enabled`` also gates
        the health stats of the update (``ops/ppo_math.py``,
        ``ops/ilql_math.py``). Under ``async_rl`` the staleness-breach
        detector's threshold defaults to the staleness window, as in the
        JAX package; the streamed phase feeds it each phase's largest
        staleness (``async/staleness``)."""
        from trlx_tpu_torch.telemetry.health import HealthConfig

        training = self.config.train.training
        health_dict = dict(training.get("health") or {})
        async_dict = dict(training.get("async_rl") or {})
        if async_dict.get("enabled") and health_dict.get("enabled"):
            detectors = dict(health_dict.get("detectors") or {})
            if "staleness-breach" not in detectors:
                detectors["staleness-breach"] = {
                    "threshold": float(async_dict.get("staleness_window", 1))}
                health_dict["detectors"] = detectors
        self.health_config = HealthConfig.from_dict(health_dict)
        self._health_enabled = bool(self.health_config.enabled)
        self._health_ev = True  # GRPO opts out (its returns carry a placeholder)
        self.health_monitor = None
        self.flight_recorder = None
        self._phase_log = None  # the run_dir's live --watch feed
        if not self._health_enabled:
            return
        from trlx_tpu_torch.parallel.distributed import is_main_process

        if not is_main_process():
            return
        from trlx_tpu_torch.telemetry.flight_recorder import FlightRecorder
        from trlx_tpu_torch.telemetry.health import HealthMonitor, config_fingerprint

        config_dict = self.config.to_dict()
        fingerprint = config_fingerprint(config_dict)
        self.health_monitor = HealthMonitor(self.health_config, fingerprint)
        self.flight_recorder = FlightRecorder(
            capacity=self.health_config.flight_capacity,
            directory=self.health_config.dump_dir,
            fingerprint=fingerprint,
            config=config_dict,
        )
        run_dir = self.config.train.training.get("run_dir")
        if run_dir:
            from trlx_tpu_torch.telemetry.run_ledger import PhaseLogWriter

            self._phase_log = PhaseLogWriter(run_dir)

    def observe_health(
        self, row: Dict[str, Any], step: Optional[int] = None, phase: Optional[int] = None
    ) -> None:
        """Feed one fetched stats row to the detectors. Values still on a
        CUDA device are skipped, never read. Each trip is a zero-length
        ``health/<detector>`` marker span (on the trace timeline next to
        the phase whose stats produced it) and goes to the Logger (a
        ``health_event`` line; stderr without one); an ``error`` trip
        applies ``health.on_error``: ``warn``, ``dump`` (the flight
        record, the offending row in it) or ``abort`` (dump, then
        :class:`~trlx_tpu_torch.telemetry.health.HealthAbort`)."""
        monitor = self.health_monitor
        if monitor is None:
            return
        events = monitor.observe(row, step=step, phase=phase)
        if not events:
            return
        for ev in events:
            with telemetry.span("health/" + ev.detector, severity=ev.severity,
                                series=ev.series, step=ev.step):
                pass
            if self.logger is not None:
                self.logger.log_health_event(ev.to_dict(), step=ev.step)
            else:
                print(f"health: {ev.severity} {ev.detector}: {ev.message}", file=sys.stderr)
        errors = [ev for ev in events if ev.severity == "error"]
        policy = self.health_config.on_error
        if not errors or policy == "warn":
            return
        recorder = self.flight_recorder
        try:
            # the offending row and its events land in the ring first, so
            # the dump's last record shows the anomaly itself; a failed
            # forensics write never ends a run the dump policy continues
            recorder.record_phase(phase, step=errors[0].step, stats_row=row, events=events,
                                  detector_state=monitor.state_summary())
            for ev in errors:
                path = recorder.dump("detector:" + ev.detector, once=True)
                if path:
                    print(f"health: flight record dumped to {path}", file=sys.stderr)
        except Exception as dump_err:
            print(f"health: flight dump FAILED ({type(dump_err).__name__}: {dump_err})",
                  file=sys.stderr)
        if policy == "abort":
            from trlx_tpu_torch.telemetry.health import HealthAbort

            first = errors[0]
            raise HealthAbort(
                f"health.on_error=abort: detector {first.detector!r} tripped at step "
                f"{first.step} ({first.message}); flight record(s): {recorder.dumped}"
            )

    def observe_health_rows(
        self,
        rows: Dict[str, Any],
        step0: Optional[int] = None,
        phase: Optional[int] = None,
        phase_row: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Feed fetched per-update rows (each value an [n_updates] host
        array) to the detectors row by row (step ``step0 + r + 1``, or the
        monitor's own count without ``step0``), then ``phase_row`` (series
        constant across the phase, the rollout KL) once. Returns the last
        row with ``phase_row`` for the flight record."""
        last: Dict[str, Any] = {}
        if self.health_monitor is None or not rows:
            return last
        n_rows = len(rows[next(iter(rows))])
        for r in range(n_rows):
            last = {key: float(v[r]) for key, v in rows.items()}
            self.observe_health(last, step=None if step0 is None else step0 + r + 1,
                                phase=phase)
        if phase_row:
            self.observe_health(phase_row, phase=phase)
            last = {**last, **phase_row}
        return last

    def emit_health_event(
        self,
        detector: str,
        severity: str,
        message: str,
        series: str = "resilience",
        value: float = 1.0,
        step: Optional[int] = None,
        phase: Optional[int] = None,
    ) -> None:
        """Record one host-originated event (a graceful degradation, such
        as the orchestrator's engine fallback) in the monitor's log, as a
        marker span and on the Logger; never applies ``health.on_error``."""
        from trlx_tpu_torch.telemetry.health import HealthEvent

        monitor = self.health_monitor
        ev = HealthEvent(
            detector=detector, severity=severity, series=series, value=float(value),
            step=int(step) if step is not None else -1, phase=phase, message=message,
            fingerprint=monitor.fingerprint if monitor is not None else "",
        )
        if monitor is not None:
            monitor.events.append(ev)
            monitor.event_counts[detector] = monitor.event_counts.get(detector, 0) + 1
        with telemetry.span("health/" + detector, severity=severity, series=series,
                            step=ev.step):
            pass
        if self.logger is not None:
            self.logger.log_health_event(ev.to_dict(), step=step)
        else:
            print(f"health: {severity} {detector}: {message}", file=sys.stderr)

    def record_flight_phase(
        self,
        phase: Optional[int],
        step: Optional[int] = None,
        stats_row: Optional[Dict[str, Any]] = None,
        kl_seq: Optional[List[float]] = None,
    ) -> None:
        """Append one phase record to the flight ring (no-op with health
        off), mirror it into ``<run_dir>/phases.jsonl`` and honour
        ``train.flight_dump_phase``."""
        recorder = self.flight_recorder
        if recorder is None:
            return
        monitor = self.health_monitor
        rec = recorder.record_phase(
            phase, step=step, stats_row=stats_row, kl_seq=kl_seq,
            events=monitor.recent_events(phase), detector_state=monitor.state_summary(),
        )
        if self._phase_log is not None:
            # the live --watch feed: the record without the detectors'
            # EWMA state (bulky and meaningless line by line)
            self._phase_log.append({k: v for k, v in rec.items() if k != "detectors"})
        want = self.config.train.training.get("flight_dump_phase")
        if want is not None and phase == want:
            path = recorder.dump(f"flight_dump_phase:{phase}", once=True)
            if path:
                print(f"health: flight record dumped to {path}", file=sys.stderr)

    def flight_dump_on_exception(self, error: BaseException) -> None:
        """``learn``'s (and ``train``'s) exception hook: write the crash
        forensics file, at most once per recorder (not again after an
        abort whose detector dumped)."""
        recorder = self.flight_recorder
        if recorder is None:
            return
        try:
            monitor = self.health_monitor
            if monitor.events:
                # events a crash preempted out of a phase record join the
                # newest record (the recorder dedupes)
                recorder.note_events(monitor.events, detector_state=monitor.state_summary())
            path = recorder.dump_on_exception(error)
        except Exception:
            return  # forensics never masks the real failure
        if path:
            print(f"health: flight record dumped to {path}", file=sys.stderr)

    def append_run_ledger(self, status: str = "ok",
                          error: Optional[BaseException] = None) -> None:
        """``learn``'s epilogue hook: append this run's manifest (config
        fingerprint, platform, git sha, span stats, metrics snapshot,
        health-event counts, the final stats and ``status``) to the ledger
        JSONL (``$TRLX_RUN_LEDGER``, else ``<run_dir>/ledger.jsonl``) and
        write ``<run_dir>/manifest.json``. Active only when
        ``train.run_dir`` or ``$TRLX_RUN_LEDGER`` is set, on the main
        process; best-effort (a full disk never masks the run's real
        outcome)."""
        import os

        run_dir = self.config.train.training.get("run_dir")
        ledger_env = os.environ.get("TRLX_RUN_LEDGER")
        if not run_dir and not ledger_env:
            return
        try:
            from trlx_tpu_torch.parallel.distributed import is_main_process

            if not is_main_process():
                return
            import json

            from trlx_tpu_torch.telemetry.run_ledger import (
                append_manifest,
                build_manifest,
                numeric_payload,
            )

            body: Dict[str, Any] = {"status": status}
            if error is not None:
                body["error"] = f"{type(error).__name__}: {error}"
            body.update(numeric_payload(self._final_stats))
            monitor = self.health_monitor
            manifest = build_manifest(
                kind=f"train/{type(self).__name__}",
                config=self.config.to_dict(),
                payload=body,
                health_events=dict(monitor.event_counts) if monitor is not None else {},
            )
            ledger = ledger_env or (os.path.join(run_dir, "ledger.jsonl") if run_dir else None)
            if ledger:
                append_manifest(manifest, ledger)
            if run_dir:
                os.makedirs(run_dir, exist_ok=True)
                with open(os.path.join(run_dir, "manifest.json"), "w", encoding="utf-8") as fh:
                    json.dump(manifest, fh, default=float)
        except Exception as e:
            print(f"run_ledger: manifest append failed ({type(e).__name__}: {e})",
                  file=sys.stderr)

    def maybe_drain(self, phase: Optional[int] = None, step: Optional[int] = None) -> None:
        """The phase-boundary resilience hook: the ``slow_step`` and
        ``preempt`` fault-injection sites, then, when a guarded SIGTERM or
        SIGINT has arrived since the last boundary, the drain: the
        emergency checkpoint through ``save`` (retried on transient I/O)
        and joined, so that it is on disk even under
        ``train.async_checkpoint``, the flight dump, then
        :class:`~trlx_tpu_torch.resilience.preemption.PreemptionDrain`.
        With no guard installed it costs one flag read."""
        from trlx_tpu_torch.resilience import chaos, preemption
        from trlx_tpu_torch.utils.checkpoint import wait_for_checkpoints

        chaos.check("slow_step", phase=phase, step=step)
        chaos.check("preempt", phase=phase, step=step)
        if not preemption.drain_requested():
            return
        directory = self.config.train.checkpoint_dir
        print(f"resilience: draining at phase boundary (step {step}) — writing emergency "
              f"checkpoint to {directory!r}", file=sys.stderr)
        self.save()
        wait_for_checkpoints()  # the drain's whole point is that it landed
        recorder = self.flight_recorder
        if recorder is not None:
            try:
                path = recorder.dump("preemption", once=True)
                if path:
                    print(f"health: flight record dumped to {path}", file=sys.stderr)
            except Exception:
                pass  # forensics never block the drain
        raise preemption.PreemptionDrain(
            f"preempted ({preemption.received_signal()}): drained at step {step} with an "
            f"emergency checkpoint in {directory!r}",
            step=step, checkpoint_dir=directory,
        )

    def host_state_dict(self) -> Dict[str, Any]:
        """Host state a checkpoint carries beside the tensors: the
        detectors' EWMA baselines, warmup counts and cooldowns, which
        decide whether the next rows trip an event."""
        state: Dict[str, Any] = {}
        if self.health_monitor is not None:
            state["health_monitor"] = self.health_monitor.state_dict()
        return state

    def load_host_state_dict(self, state: Dict[str, Any]) -> None:
        """Inverse of :meth:`host_state_dict`; missing keys are fine."""
        monitor_state = (state or {}).get("health_monitor")
        if monitor_state is not None and self.health_monitor is not None:
            self.health_monitor.load_state_dict(monitor_state)

    def add_eval_pipeline(self, pipeline) -> None:
        self.eval_pipeline = pipeline

    def intervals(self, step: int) -> Dict[str, bool]:
        """Log/eval/save cadence."""
        t = self.config.train
        return {
            "do_log": step % t.log_interval == 0,
            "do_eval": step % t.eval_interval == 0,
            "do_save": step > 0 and step % t.checkpoint_interval == 0,
        }

    def check_anomalies(self, stats: Dict[str, Any], step: int) -> None:
        """Raise when fetched loss stats (scalars or per-update rows) are
        non-finite (``train.detect_anomalies``)."""
        if not self.config.train.detect_anomalies:
            return
        for key, v in stats.items():
            if not key.startswith("losses/"):
                continue
            arr = np.asarray(v, dtype=np.float64)
            finite = np.isfinite(arr)
            if not finite.all():
                first_bad = int(np.argmin(finite.ravel()))
                at = step if arr.ndim == 0 else step + first_bad + 1
                raise RuntimeError(
                    f"non-finite {key} ({float(arr.ravel()[first_bad])}) "
                    f"detected at step {at} — training diverged; inspect the "
                    "learning rate / reward scale, or resume from the last "
                    f"checkpoint in {self.config.train.checkpoint_dir!r}"
                )

    # --- host text boundary ------------------------------------------- #

    def apply_tokenizer_gen_defaults(self, gen_kwargs: Dict[str, Any]) -> None:
        """Default eos/pad from the tokenizer when the config did not set
        them (pad falls back to eos; a pad id of 0 is kept)."""
        if self.tokenizer is None:
            return
        gen_kwargs.setdefault("eos_token_id", self.tokenizer.eos_token_id)
        gen_kwargs.setdefault(
            "pad_token_id",
            self.tokenizer.pad_token_id
            if self.tokenizer.pad_token_id is not None
            else self.tokenizer.eos_token_id,
        )

    def _detokenize(self, ids: List[int]) -> str:
        if self.tokenizer is not None:
            return self.tokenizer.decode(ids, skip_special_tokens=True)
        return " ".join(map(str, ids))

    def decode_responses(self, tokens: torch.Tensor, response_mask: torch.Tensor) -> List[str]:
        """Responses truncated at their mask, as text (without a tokenizer,
        the ids joined by spaces)."""
        tokens, lengths = tokens.cpu().numpy(), response_mask.sum(1).cpu().numpy()
        return [self._detokenize(row[: int(n)].tolist()) for row, n in zip(tokens, lengths)]

    def gather_sample(self, out):
        """The global batch's sample from this rank's rows (the PPO
        trainers' mesh; one rank's is the whole)."""
        return out

    def decode_queries(self, q_ids: torch.Tensor, q_mask: torch.Tensor) -> List[str]:
        q_ids, q_mask = q_ids.cpu().numpy(), q_mask.cpu().numpy()
        return [self._detokenize(row[m.astype(bool)].tolist()) for row, m in zip(q_ids, q_mask)]

    # --- evaluation ----------------------------------------------------- #

    @property
    def eval_batch_size(self) -> int:
        return getattr(self.config.method, "chunk_size", None) or self.config.train.batch_size

    def evaluate(self) -> Dict[str, Any]:
        """Sample the eval prompts in full-size batches, score them with
        the reward (and metric) function, and keep a sample table, inside
        a ``phase/eval`` span."""
        if self.eval_pipeline is None:
            return {}
        with telemetry.span("phase/eval"):
            t0 = monotonic()
            all_queries, all_texts, all_gt = [], [], []
            for batch, meta in self.eval_pipeline.create_loader(
                self.eval_batch_size, shuffle=False, drop_last=False
            ):
                out = self.gather_sample(self.sample(batch.input_ids, batch.attention_mask))
                n_real = meta["n_real"]
                all_texts += self.decode_responses(out.tokens, out.response_mask)[:n_real]
                all_queries += meta["prompts_text"][:n_real]
                if meta["response_gt"] is not None:
                    all_gt += meta["response_gt"][:n_real]
            stats: Dict[str, Any] = {"time/generate": monotonic() - t0}
            columns = ["query", "response"]
            table = [list(t) for t in zip(all_queries, all_texts)]
            from trlx_tpu_torch.parallel.distributed import is_main_process

            # under a mesh the first rank alone scores (and logs) the eval
            main = is_main_process()
            if self.reward_fn is not None and main:
                scores = np.asarray(
                    self.reward_fn(
                        samples=all_texts, queries=all_queries,
                        response_gt=all_gt if all_gt else None,
                    ),
                    dtype=np.float32,
                )
                stats["reward/mean"] = float(scores.mean())
                stats["reward/std"] = float(scores.std())
                columns.append("reward")
                table = [row + [float(s)] for row, s in zip(table, scores)]
            if self.metric_fn is not None and main:
                t1 = monotonic()
                for k, v in self.metric_fn(all_texts).items():
                    stats[f"metrics/{k}"] = float(np.asarray(v, dtype=np.float32).mean())
                stats["time/metric"] = monotonic() - t1
            self._last_samples = (columns, table)
            return stats
