"""PPO experience collection on the fixed-batch sampler (counterpart of
:mod:`trlx_tpu.orchestrator.ppo_orchestrator`: ``_make_experience_fixed``,
``_scale_scores``, ``state_dict``).

Per chunk: draw prompts, sample (behaviour logprobs and values come out of
the sampler), score the full-copy KL reference, decode the responses, call
the user reward ``(samples, queries, response_gt)``, scale and clip the
scores, shape per-token rewards with the KL penalty, and push the chunk to
the trainer's buffer. Chunks run one after another.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

from trlx_tpu_torch.data.ppo_types import PPORolloutBatch
from trlx_tpu_torch.orchestrator import register_orchestrator
from trlx_tpu_torch.utils import RunningMoments, infinite_loader, monotonic


@register_orchestrator
class PPOOrchestrator:
    """
    :param trainer: a :class:`~trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer`.
    :param pipeline: prompt pipeline (queries + optional response_gt).
    :param reward_fn: ``(samples, queries, response_gt) -> [float]``.
    :param chunk_size: prompts per generation chunk.
    """

    def __init__(self, trainer, pipeline, reward_fn: Callable, chunk_size: int = 128):
        self.trainer = trainer
        self.pipeline = pipeline
        self.reward_fn = reward_fn
        self.chunk_size = chunk_size
        trainer.bind_prompt_budget(pipeline)
        # the prompt stream: pass e is shuffled with seed e
        self._loader = infinite_loader(
            lambda seed: pipeline.create_loader(
                chunk_size, shuffle=True, seed=seed, drop_last=False
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
        if method.cliprange_reward:
            scores = np.clip(scores, -method.cliprange_reward, method.cliprange_reward)
        return scores

    def make_experience(self, num_rollouts: int = 128, iter_count: int = 0) -> Dict[str, float]:
        """Collect at least ``num_rollouts`` rollouts (whole chunks) into
        the trainer's buffer; returns the collect stats."""
        tr = self.trainer
        method = tr.config.method
        t0 = monotonic()
        collected = 0
        generate_time = score_time = 0.0
        all_scores = []
        while collected < num_rollouts:
            batch, meta = self._draw()
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
            "policy/mean_rollout_kl": float(tr.mean_kl),
        }
        if tr.logger is not None:
            tr.logger.log(stats, step=iter_count)
        return stats
