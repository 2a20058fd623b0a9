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
completes: rows land in harvest order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from trlx_tpu_torch.data.ppo_types import PPORolloutBatch
from trlx_tpu_torch.ops.ppo_math import group_whiten
from trlx_tpu_torch.orchestrator import register_orchestrator
from trlx_tpu_torch.utils import RunningMoments, infinite_loader, monotonic


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
        engine; returns the collect stats."""
        if getattr(self.trainer, "rollout_engine", "fixed") == "continuous":
            return self._make_experience_continuous(num_rollouts, iter_count)
        return self._make_experience_fixed(num_rollouts, iter_count)

    def _make_experience_fixed(self, num_rollouts: int, iter_count: int) -> Dict[str, float]:
        tr = self.trainer
        method = tr.config.method
        t0 = monotonic()
        collected = 0
        generate_time = score_time = 0.0
        all_scores = []
        while collected < num_rollouts:
            batch, meta = self._expand_groups(*self._draw())
            t1 = monotonic()
            out = tr.sample(batch.input_ids, batch.attention_mask)
            query_tokens = batch.input_ids.to(tr.device)
            query_mask = batch.attention_mask.to(tr.device)
            ref_logprobs = tr.score_ref(
                query_tokens, query_mask, out.tokens, out.response_mask
            )
            texts = tr.decode_responses(out.tokens, out.response_mask)
            generate_time += monotonic() - t1
            t1 = monotonic()
            scores = np.asarray(
                self.score(texts, meta["prompts_text"], meta["response_gt"]),
                dtype=np.float32,
            )
            score_time += monotonic() - t1
            all_scores.append(scores.copy())
            scores = self._scale_scores(scores, method)
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
        return self._finish_collect_stats(
            t0, collected, all_scores, generate_time, score_time, iter_count
        )

    def _make_experience_continuous(self, num_rollouts: int, iter_count: int) -> Dict[str, float]:
        """One phase through the continuous-batching engine: submit the
        phase's prompt draws (row index = draw order, the per-row noise
        identity) until ``num_rollouts`` rounded up to whole harvest groups
        are pending, then score and land each harvest group as it
        completes."""
        tr = self.trainer
        method = tr.config.method
        t0 = monotonic()
        collected = 0
        generate_time = score_time = 0.0
        all_scores = []
        engine = tr.rollout_engine_obj
        Hw = engine.harvest_width
        target = -(-int(num_rollouts) // Hw) * Hw
        have_gt = self.pipeline.response_gt is not None
        meta_by_row = {}
        engine.start_phase(tr.rollout_phase_seed())
        while engine.pending + engine.stats.completed < target:
            batch, meta = self._expand_groups(*self._draw())
            rows = engine.submit(batch.input_ids.numpy(), batch.attention_mask.numpy())
            q_dtype = batch.input_ids.dtype  # the fixed path's query dtype
            for i, r in enumerate(rows):
                meta_by_row[r] = (meta["prompts_text"][i],
                                  meta["response_gt"][i] if have_gt else None)
        dispatch_time = monotonic() - t0
        # the harvested host arrays, on the device in the fixed path's dtypes
        dtypes = {"query_tokens": q_dtype, "query_mask": q_dtype, "tokens": torch.int32,
                  "response_mask": torch.int32, "logprobs": torch.float32,
                  "values": torch.float32}
        for group in engine.drive(target):
            t1 = monotonic()
            query_tokens, query_mask, tokens, response_mask, logprobs, values = (
                torch.from_numpy(group[k]).to(device=tr.device, dtype=dt)
                for k, dt in dtypes.items())
            ref_logprobs = tr.score_ref(query_tokens, query_mask, tokens, response_mask)
            texts = tr.decode_responses(tokens, response_mask)
            generate_time += monotonic() - t1
            rows = group["rows"]
            t1 = monotonic()
            scores = np.asarray(
                self.score(texts, [meta_by_row[r][0] for r in rows],
                           [meta_by_row[r][1] for r in rows] if have_gt else None),
                dtype=np.float32,
            )
            score_time += monotonic() - t1
            all_scores.append(scores.copy())
            scores = self._scale_scores(scores, method)
            rewards = tr.compute_rewards(logprobs, ref_logprobs, response_mask, scores)
            tr.buffer.push(PPORolloutBatch(
                query_tokens=query_tokens,
                query_mask=query_mask,
                response_tokens=tokens,
                response_mask=response_mask,
                logprobs=logprobs,
                values=values,
                rewards=rewards,
            ))
            collected += len(rows)
        return self._finish_collect_stats(
            t0, collected, all_scores, generate_time, score_time, iter_count,
            extra={"exp/dispatch_time": dispatch_time, **engine.stats.to_dict()},
        )

    def _finish_collect_stats(self, t0, collected, all_scores, generate_time,
                              score_time, iter_count, extra=None) -> Dict[str, float]:
        """The collect stats row (the same keys on both engines, the
        engine's counters added on the continuous one), logged."""
        exp_time = monotonic() - t0
        scores_cat = np.concatenate(all_scores)
        stats = {
            "exp/generate_time": generate_time,
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
        if self.trainer.logger is not None:
            self.trainer.logger.log(stats, step=iter_count)
        return stats
