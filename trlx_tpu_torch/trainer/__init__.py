"""Trainer layer (counterpart of :mod:`trlx_tpu.trainer`): the trainer
registry and the part of ``BaseRLTrainer`` the PPO and ILQL paths use —
generation defaults from a tokenizer, the log/eval/save cadence, the host
text boundary, evaluation (scored by the reward function, the metric
function, both or neither) and the non-finite-loss check. Health
monitoring, the flight recorder and the run ledger are ROADMAP item 19.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch.utils import monotonic

_TRAINERS: Dict[str, type] = {}

#: ``train`` keys of the shared schema whose features the port does not
#: have yet: (default, the ROADMAP item that brings it). A value other than
#: the default is refused instead of silently ignored.
UNPORTED_TRAIN_KEYS = {
    "async_rl": ({}, "17 (async actor-learner)"),
    "resilience": ({}, "18 (the supervisor)"),
    "resume_from_checkpoint": (False, "18 (resume)"),
    "health": ({}, "19 (health monitoring)"),
    "run_dir": (None, "19 (run ledger)"),
    "flight_dump_phase": (None, "19 (flight recorder)"),
    "profile_dir": (None, "19 (profiler windows)"),
    "profile_phase": (None, "19 (profiler windows)"),
    "rollout_logging_dir": (None, "7 (rollout logging)"),
    "pp_microbatches": (2, "14 (pipeline parallelism)"),
    "pp_virtual_stages": (1, "14 (pipeline parallelism)"),
    "pp_remat": (False, "14 (pipeline parallelism)"),
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


def refuse_unported(config) -> None:
    """Raise on a configured training feature the port does not have,
    naming the ROADMAP item that brings it (``train.rollout``'s chunked
    prefill and speculative decoding are refused where it is parsed,
    :class:`~trlx_tpu_torch.inference.RolloutEngineConfig`)."""
    train = config.train
    for key, (default, item) in UNPORTED_TRAIN_KEYS.items():
        value = train.training.get(key, default)
        if key in ("async_rl", "resilience", "health"):
            value = {} if not (value or {}).get("enabled") else value
        if value != default:
            raise NotImplementedError(
                f"train.{key}={value!r} is not ported yet (ROADMAP item {item})"
            )
    mesh = train.training.get("mesh") or {}
    if any(size not in (-1, 1) for size in mesh.values()):
        raise NotImplementedError(
            f"train.mesh={mesh}: the port runs on one device; multi-GPU "
            "parallelism is ROADMAP item 14"
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

    def decode_queries(self, q_ids: torch.Tensor, q_mask: torch.Tensor) -> List[str]:
        q_ids, q_mask = q_ids.cpu().numpy(), q_mask.cpu().numpy()
        return [self._detokenize(row[m.astype(bool)].tolist()) for row, m in zip(q_ids, q_mask)]

    # --- evaluation ----------------------------------------------------- #

    @property
    def eval_batch_size(self) -> int:
        return getattr(self.config.method, "chunk_size", None) or self.config.train.batch_size

    def evaluate(self) -> Dict[str, Any]:
        """Sample the eval prompts in full-size batches, score them with
        the reward (and metric) function, and keep a sample table."""
        if self.eval_pipeline is None:
            return {}
        t0 = monotonic()
        all_queries, all_texts, all_gt = [], [], []
        for batch, meta in self.eval_pipeline.create_loader(
            self.eval_batch_size, shuffle=False, drop_last=False
        ):
            out = self.sample(batch.input_ids, batch.attention_mask)
            n_real = meta["n_real"]
            all_texts += self.decode_responses(out.tokens, out.response_mask)[:n_real]
            all_queries += meta["prompts_text"][:n_real]
            if meta["response_gt"] is not None:
                all_gt += meta["response_gt"][:n_real]
        stats: Dict[str, Any] = {"time/generate": monotonic() - t0}
        columns = ["query", "response"]
        table = [list(t) for t in zip(all_queries, all_texts)]
        if self.reward_fn is not None:
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
        if self.metric_fn is not None:
            t1 = monotonic()
            for k, v in self.metric_fn(all_texts).items():
                stats[f"metrics/{k}"] = float(np.asarray(v, dtype=np.float32).mean())
            stats["time/metric"] = monotonic() - t1
        self._last_samples = (columns, table)
        return stats
