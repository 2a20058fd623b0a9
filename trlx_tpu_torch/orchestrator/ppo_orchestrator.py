"""PPO experience collection (counterpart of
:mod:`trlx_tpu.orchestrator.ppo_orchestrator`: ``_make_experience_fixed``,
``_make_experience_continuous``, ``_expand_groups``, ``_scale_scores``,
``state_dict``).

On the fixed-batch sampler, per chunk: draw prompts (each repeated
``group_size`` times, contiguously, for a grouped trainer), sample
(behaviour logprobs and values come out of the sampler), score the KL
reference, decode the responses, call the user reward ``(samples,
queries, response_gt)``, scale and clip the scores, shape the rewards
(``trainer.compute_rewards``), and push the chunk to the trainer's buffer.
Chunks run one after another. On the continuous engine
(``train.rollout.engine: continuous``), the phase's prompts are submitted
up front and each harvest group goes through the same steps as it
completes: rows land in harvest order, tagged with the behaviour-policy
version each was admitted under. After every landing, on both paths,
``trainer.on_rollouts_landed()`` lets an open streamed phase run the
epoch-1 minibatches whose rows now exist.

A failure on the engine path degrades to the fixed sampler for the rest
of the run, with an ``engine-fallback`` health event and the phase begun
again (a streamed phase with the same plan seed). Under ``train.async_rl``
an engine-layer failure (the engine's own call raised, which
``_engine_step`` marks) is a dead actor instead: an ``actor-dead`` health
event and :class:`~trlx_tpu_torch.trainer.async_rl.ActorDeadError`, which
the supervisor retries; a learner-side or reward-function error
propagates as itself.

The collect stats row feeds the trainer's run-health detectors
(``exp/score_std`` is the reward-saturation series) and is absorbed into
the metrics registry.

Timing is span-sourced, with the JAX orchestrator's names: each path runs
inside a forced ``phase/collect`` span (``exp/experience_time``), with
``collect/prompt_draw``, the forced ``collect/dispatch`` (the sampler call
on the fixed path, the phase start and every submit on the engine:
``exp/dispatch_time``), ``collect/decode`` (the responses' fetch and
detokenisation: ``exp/generate_time``), ``collect/score`` (the reward:
``exp/score_time``) and ``collect/land`` (reward shaping, the push, and
the streamed phase's epoch-1 updates the landing hook runs) inside it.
The port's samplers run to their end inside the call, so generation's cost
lands in ``exp/dispatch_time`` on the fixed path, and ``exp/generate_time``
is the fetch (which waits for the reference forward queued behind the
sampler) and the detokenisation alone. In the JAX package the sampler call
only enqueues, and generation lands in ``exp/generate_time``; the sum of
the two stats reads as generation in both. As there, the reference
forward's launch is in no sub-span.

Under a mesh of more than one rank (the fixed path only) every rank
draws the same global chunk; the trainer samples this rank's rows of it
and scores their reference, the responses are decoded and scored on each
data shard's first rank, and the scores, texts and rollout tensors are
gathered to every rank (``trainer.gather_scored``,
``trainer.gather_sample``) before the scaling, the shaping and the push:
the store, the running moments and the KL are the global chunk's on every
rank, as in a one-process run.

Under ``train.rollout_logging_dir`` each scored batch's rows (query,
response, raw score) go to ``<dir>/run_<time>-<pid>/rollouts_<step>.jsonl``
through a :class:`~trlx_tpu_torch.utils.async_writer.BackgroundJSONLWriter`,
flushed at each phase's end (also when collection raises, without masking
its error) and stopped by :meth:`PPOOrchestrator.close`; under a mesh,
by rank 0 alone.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.ppo_types import PPORolloutBatch
from trlx_tpu_torch.ops.ppo_math import group_whiten
from trlx_tpu_torch.orchestrator import register_orchestrator
from trlx_tpu_torch.utils import RunningMoments, infinite_loader


@register_orchestrator
class PPOOrchestrator:
    """
    :param trainer: a :class:`~trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer`.
    :param pipeline: prompt pipeline (queries + optional response_gt).
    :param reward_fn: ``(samples, queries, response_gt) -> [float]``.
    :param chunk_size: rollouts per generation chunk: a grouped trainer
        (``trainer.group_size`` G > 1) draws ``chunk_size // G`` prompts.
    """

    def __init__(self, trainer, pipeline, reward_fn: Callable, chunk_size: int = 128):
        self.trainer = trainer
        self.pipeline = pipeline
        self.reward_fn = reward_fn
        self.chunk_size = chunk_size
        trainer.bind_prompt_budget(pipeline)
        self.group_size = int(getattr(trainer, "group_size", 1) or 1)
        if chunk_size % self.group_size:
            raise ValueError(
                f"chunk_size={chunk_size} must be a multiple of "
                f"group_size={self.group_size} (each prompt yields "
                f"{self.group_size} rollouts)"
            )
        # the prompt stream: pass e is shuffled with seed e
        self._loader = infinite_loader(
            lambda seed: pipeline.create_loader(
                chunk_size // self.group_size, shuffle=True, seed=seed, drop_last=False
            )
        )
        self._draws = 0  # prompt draws so far: the stream's position
        self.running = RunningMoments()
        self.ref_mean = trainer.config.method.ref_mean
        self.ref_std = trainer.config.method.ref_std
        trainer.orch = self
        # the pid keeps apart two runs that share a logging directory and
        # start in the same second
        self._run_id = f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
        self._rollout_writer = None
        from trlx_tpu_torch.parallel.distributed import is_main_process

        if trainer.config.train.rollout_logging_dir and is_main_process():
            from trlx_tpu_torch.utils.async_writer import BackgroundJSONLWriter

            self._rollout_writer = BackgroundJSONLWriter()
        # the engine call that raised (set by _engine_step): tells a dead
        # actor from a learner-side error raised in the same loop
        self._engine_error: Optional[BaseException] = None

    def _engine_step(self, fn, *args, **kwargs):
        """One engine call (start_phase, submit, the next harvest group),
        its failure marked as the engine's."""
        try:
            return fn(*args, **kwargs)
        except StopIteration:
            raise
        except BaseException as e:
            self._engine_error = e
            raise

    def close(self, reraise: bool = True) -> None:
        """Stop the rollout writer, draining what is queued; a write error
        that an exception path's flush held back raises here (not with
        ``reraise=False``)."""
        if self._rollout_writer is not None:
            writer, self._rollout_writer = self._rollout_writer, None
            writer.close(reraise=reraise)

    def _log_rollouts(self, queries, texts, scores, iter_count: int) -> None:
        """Queue a scored batch's rows for ``train.rollout_logging_dir``,
        under this run's own directory."""
        if self._rollout_writer is None:
            return
        directory = os.path.join(self.trainer.config.train.rollout_logging_dir,
                                 f"run_{self._run_id}")
        os.makedirs(directory, exist_ok=True)
        self._rollout_writer.submit(
            os.path.join(directory, f"rollouts_{iter_count}.jsonl"),
            [{"query": q, "response": s, "score": float(r)}
             for q, s, r in zip(queries, texts, scores)],
        )

    def _draw(self):
        self._draws += 1
        return next(self._loader)

    def state_dict(self) -> Dict[str, Any]:
        """Reward-scaling moments, reference stats and the prompt-stream
        position: what a checkpoint needs to continue the same run."""
        return {
            "running": {
                "mean": self.running.mean,
                "std": self.running.std,
                "var": self.running.var,
                "count": self.running.count,
            },
            "ref_mean": self.ref_mean,
            "ref_std": self.ref_std,
            "prompt_draws": self._draws,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for key, value in (state.get("running") or {}).items():
            setattr(self.running, key, float(value))
        self.ref_mean = state.get("ref_mean", self.ref_mean)
        self.ref_std = state.get("ref_std", self.ref_std)
        # fast-forward the deterministic prompt stream (host index draws)
        while self._draws < int(state.get("prompt_draws", 0)):
            self._draw()

    def _expand_groups(self, batch, meta):
        """Repeat each prompt ``group_size`` times, contiguously (the meta
        lists element-wise, ``n_real`` times G), so that a group's
        rollouts are neighbours when the trainer shapes their rewards."""
        G = self.group_size
        if G <= 1:
            return batch, meta
        batch = type(batch)(
            input_ids=batch.input_ids.repeat_interleave(G, dim=0),
            attention_mask=batch.attention_mask.repeat_interleave(G, dim=0),
        )
        meta = {
            k: ([x for x in v for _ in range(G)] if isinstance(v, list) else v)
            for k, v in meta.items()
        }
        if "n_real" in meta:
            meta["n_real"] = meta["n_real"] * G
        return batch, meta

    def score(self, samples, queries, response_gt):
        return self.reward_fn(samples=samples, queries=queries, response_gt=response_gt)

    def _scale_scores(self, scores: np.ndarray, method) -> np.ndarray:
        """Reward scaling and clip: the reference stats come from the
        first batch when unset; the running moments always advance."""
        if self.ref_mean is None:
            self.ref_mean, self.ref_std = float(scores.mean()), float(scores.std())
        self.running.update(scores)
        if method.scale_reward == "running":
            if self.running.std > 0:
                scores = scores / self.running.std
        elif method.scale_reward == "ref" and self.ref_std:
            scores = scores / self.ref_std
        elif method.scale_reward == "group":
            # rows are group-contiguous (_expand_groups)
            scores = group_whiten(scores, self.group_size)
        if method.cliprange_reward:
            scores = np.clip(scores, -method.cliprange_reward, method.cliprange_reward)
        return scores

    def make_experience(self, num_rollouts: int = 128, iter_count: int = 0) -> Dict[str, float]:
        """Collect at least ``num_rollouts`` rollouts (whole chunks or
        harvest groups) into the trainer's buffer on the trainer's rollout
        engine, then flush the rollout log; returns the collect stats."""
        writer = self._rollout_writer
        try:
            stats = self._collect(num_rollouts, iter_count)
        except BaseException:
            if writer is not None:
                writer.flush(reraise=False)  # queued rows land; this error wins
            raise
        if writer is not None:
            writer.flush(reraise=True)
        return stats

    def _collect(self, num_rollouts: int, iter_count: int) -> Dict[str, float]:
        if getattr(self.trainer, "rollout_engine", "fixed") == "continuous":
            try:
                return self._make_experience_continuous(num_rollouts, iter_count)
            except Exception as e:
                from trlx_tpu_torch.resilience.preemption import PreemptionDrain
                from trlx_tpu_torch.telemetry.health import HealthAbort

                engine_failed, self._engine_error = self._engine_error is e, None
                if isinstance(e, (HealthAbort, PreemptionDrain)):
                    raise  # policy decisions, not engine failures
                async_cfg = getattr(self.trainer, "async_config", None)
                if async_cfg is not None and async_cfg.enabled:
                    # a dead actor goes to the supervisor, never to the
                    # fixed sampler (which would change the run's whole
                    # schedule); any other error propagates as itself, so
                    # that a deterministic reward bug is not retried
                    if engine_failed:
                        self._actor_dead(e, iter_count)
                    raise
                self._degrade_engine(e, iter_count)
        return self._make_experience_fixed(num_rollouts, iter_count)

    def _actor_dead(self, error: BaseException, iter_count: int) -> None:
        """The async engine failed: emit an ``actor-dead`` health event and
        raise :class:`~trlx_tpu_torch.trainer.async_rl.ActorDeadError`
        (retriable: the supervisor restarts from the last checkpoint with
        a fresh engine). The trainer aborts the open streamed phase as the
        error unwinds through ``_collect_phase``."""
        from trlx_tpu_torch.trainer.async_rl import ActorDeadError

        tr = self.trainer
        print(f"resilience: async actor died mid-phase ({type(error).__name__}: {error}); "
              "raising for the supervisor (restart from the last good checkpoint)",
              file=sys.stderr)
        tr.emit_health_event(
            detector="actor-dead", severity="error", series="async",
            message=(f"async actor (continuous engine) died mid-phase "
                     f"({type(error).__name__}: {error}); supervisor restart requested"),
            step=iter_count, phase=tr.health_phase_id,
        )
        raise ActorDeadError(
            f"async actor died mid-phase at iteration {iter_count} "
            f"({type(error).__name__}: {error})"
        ) from error

    def _degrade_engine(self, error: BaseException, iter_count: int) -> None:
        """Fall back from the continuous engine to the fixed sampler for
        the rest of the run: switch the trainer's engine, emit an
        ``engine-fallback`` health event (warning severity: degrading is
        the alternative to the abort policy, never its trigger), and begin
        the phase again, since rows the failed engine landed cannot fill
        its plan: an open streamed phase is aborted and begun again with
        the same plan seed (its epoch-1 updates already run stay)."""
        tr = self.trainer
        print(f"resilience: continuous rollout engine failed ({type(error).__name__}: "
              f"{error}); falling back to the fixed sampler for the rest of the run",
              file=sys.stderr)
        tr.rollout_engine = "fixed"
        tr._rollout_engine_obj = None  # drop the failed slot pool
        tr.emit_health_event(
            detector="engine-fallback", severity="warning", series="engine",
            message=(f"continuous rollout engine failed ({type(error).__name__}: {error}); "
                     "degraded to the fixed sampler"),
            step=iter_count, phase=tr.health_phase_id,
        )
        if getattr(tr, "_stream", None) is not None:
            tr.abort_streamed_phase()
            tr.begin_streamed_phase(seed=tr._last_stream_seed)
        else:
            tr.buffer.clear_history()
            tr.reset_rollout_phase()

    def _make_experience_fixed(self, num_rollouts: int, iter_count: int) -> Dict[str, float]:
        tr = self.trainer
        method = tr.config.method
        collected = 0
        generate_time = dispatch_time = score_time = 0.0
        all_scores = []
        with telemetry.span("phase/collect", force=True,
                            rollouts=int(num_rollouts)) as collect_sp:
            while collected < num_rollouts:
                with telemetry.span("collect/prompt_draw"):
                    batch, meta = self._draw()
                batch, meta = self._expand_groups(batch, meta)
                with telemetry.span("collect/dispatch", force=True) as sp:
                    out = tr.sample(batch.input_ids, batch.attention_mask)
                dispatch_time += sp.duration_ms / 1000.0
                query_tokens = batch.input_ids.to(tr.device)
                query_mask = batch.attention_mask.to(tr.device)
                # this rank's rows under a mesh (all of them on one rank)
                ref_logprobs = tr.score_ref(
                    tr.local_rows(query_tokens), tr.local_rows(query_mask),
                    out.tokens, out.response_mask,
                )
                # the fetch waits for the sampler and the reference: where
                # generation's cost lands on the host
                with telemetry.span("collect/decode", force=True) as sp:
                    texts = tr.decode_responses(out.tokens, out.response_mask)
                generate_time += sp.duration_ms / 1000.0
                with telemetry.span("collect/score", force=True) as sp:
                    scores = None
                    if tr.scores_here:
                        scores = np.asarray(
                            self.score(texts, tr.local_rows(meta["prompts_text"]),
                                       tr.local_rows(meta["response_gt"])),
                            dtype=np.float32,
                        )
                    scores, texts = tr.gather_scored(scores, texts)
                score_time += sp.duration_ms / 1000.0
                out, ref_logprobs = tr.gather_sample(out), tr.gather_rows(ref_logprobs)
                all_scores.append(scores.copy())
                self._log_rollouts(meta["prompts_text"], texts, scores, iter_count)
                scores = self._scale_scores(scores, method)
                with telemetry.span("collect/land") as land_sp:
                    rewards = tr.compute_rewards(
                        out.logprobs, ref_logprobs, out.response_mask, scores
                    )
                    tr.buffer.push(PPORolloutBatch(
                        query_tokens=query_tokens,
                        query_mask=query_mask,
                        response_tokens=out.tokens,
                        response_mask=out.response_mask,
                        logprobs=out.logprobs,
                        values=out.values,
                        rewards=rewards,
                    ))
                    collected += len(batch)
                    land_sp.set(landed=collected)
                    tr.on_rollouts_landed()
        return self._finish_collect_stats(
            collect_sp.duration_ms / 1000.0, collected, all_scores, generate_time,
            dispatch_time, score_time, iter_count,
        )

    def _make_experience_continuous(self, num_rollouts: int, iter_count: int) -> Dict[str, float]:
        """One phase through the continuous-batching engine: submit the
        phase's prompt draws (row index = draw order, the per-row noise
        identity) until ``num_rollouts`` rounded up to whole harvest groups
        are pending, then score and land each harvest group as it
        completes."""
        tr = self.trainer
        method = tr.config.method
        collected = 0
        generate_time = score_time = 0.0
        all_scores = []
        engine = tr.rollout_engine_obj
        Hw = engine.harvest_width
        target = -(-int(num_rollouts) // Hw) * Hw
        have_gt = self.pipeline.response_gt is not None
        meta_by_row = {}
        with telemetry.span("phase/collect", force=True,
                            rollouts=int(num_rollouts)) as collect_sp:
            with telemetry.span("collect/dispatch", force=True) as sp:
                self._engine_step(engine.start_phase, tr.rollout_phase_seed())
                while engine.pending + engine.stats.completed < target:
                    with telemetry.span("collect/prompt_draw"):
                        batch, meta = self._draw()
                    batch, meta = self._expand_groups(batch, meta)
                    rows = self._engine_step(
                        engine.submit, batch.input_ids.numpy(), batch.attention_mask.numpy())
                    q_dtype = batch.input_ids.dtype  # the fixed path's query dtype
                    for i, r in enumerate(rows):
                        meta_by_row[r] = (meta["prompts_text"][i],
                                          meta["response_gt"][i] if have_gt else None)
            dispatch_time = sp.duration_ms / 1000.0
            # the harvested host arrays, on the device in the fixed path's dtypes
            dtypes = {"query_tokens": q_dtype, "query_mask": q_dtype, "tokens": torch.int32,
                      "response_mask": torch.int32, "logprobs": torch.float32,
                      "values": torch.float32}
            # harvest groups pulled through _engine_step, so that the failure
            # mark covers the engine's own raises and not the loop body's
            groups = iter(engine.drive(target))
            while True:
                try:
                    group = self._engine_step(next, groups)
                except StopIteration:
                    break
                query_tokens, query_mask, tokens, response_mask, logprobs, values = (
                    torch.from_numpy(group[k]).to(device=tr.device, dtype=dt)
                    for k, dt in dtypes.items())
                ref_logprobs = tr.score_ref(query_tokens, query_mask, tokens, response_mask)
                with telemetry.span("collect/decode", force=True) as sp:
                    texts = tr.decode_responses(tokens, response_mask)
                generate_time += sp.duration_ms / 1000.0
                rows = group["rows"]
                queries = [meta_by_row[r][0] for r in rows]
                with telemetry.span("collect/score", force=True) as sp:
                    scores = np.asarray(
                        self.score(texts, queries,
                                   [meta_by_row[r][1] for r in rows] if have_gt else None),
                        dtype=np.float32,
                    )
                score_time += sp.duration_ms / 1000.0
                all_scores.append(scores.copy())
                self._log_rollouts(queries, texts, scores, iter_count)
                scores = self._scale_scores(scores, method)
                with telemetry.span("collect/land") as land_sp:
                    rewards = tr.compute_rewards(logprobs, ref_logprobs, response_mask, scores)
                    tr.buffer.push(
                        PPORolloutBatch(
                            query_tokens=query_tokens,
                            query_mask=query_mask,
                            response_tokens=tokens,
                            response_mask=response_mask,
                            logprobs=logprobs,
                            values=values,
                            rewards=rewards,
                        ),
                        versions=group["versions"],
                    )
                    collected += len(rows)
                    land_sp.set(landed=collected)
                    tr.on_rollouts_landed()
        return self._finish_collect_stats(
            collect_sp.duration_ms / 1000.0, collected, all_scores, generate_time,
            dispatch_time, score_time, iter_count, extra=engine.stats.to_dict(),
        )

    def _finish_collect_stats(self, exp_time, collected, all_scores, generate_time,
                              dispatch_time, score_time, iter_count,
                              extra=None) -> Dict[str, float]:
        """The collect stats row (the same keys on both engines, the
        engine's counters added on the continuous one), absorbed into the
        metrics registry, observed by run health and logged."""
        scores_cat = np.concatenate(all_scores)
        stats = {
            "exp/generate_time": generate_time,
            "exp/dispatch_time": dispatch_time,
            "exp/score_time": score_time,
            "exp/experience_time": exp_time,
            "exp/score_mean": float(scores_cat.mean()),
            "exp/score_std": float(scores_cat.std()),
            "exp/running_mean": float(self.running.mean),
            "exp/running_std": float(self.running.std),
            "exp/rollouts_per_sec": collected / max(exp_time, 1e-9),
            "policy/mean_rollout_kl": float(self.trainer.mean_kl),
            **(extra or {}),
        }
        # the registry and run health read the row too (exp/score_std is
        # the reward-saturation series), all but the rollout KL: the JAX
        # package's is still a device scalar here, which its registry and
        # monitor skip, and the phase's update rows observe it once
        host_row = {k: v for k, v in stats.items() if k != "policy/mean_rollout_kl"}
        telemetry.get_metrics().absorb(host_row)
        self.trainer.observe_health(host_row, step=iter_count,
                                    phase=self.trainer.health_phase_id)
        if self.trainer.logger is not None:
            self.trainer.logger.log(stats, step=iter_count)
        return stats
