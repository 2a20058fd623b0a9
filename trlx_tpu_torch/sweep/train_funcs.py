"""Trainables for :func:`~trlx_tpu_torch.sweep.run_local_sweep` and
:func:`~trlx_tpu_torch.sweep.run_ray_sweep` (the port's
:mod:`trlx_tpu.sweep.train_funcs`): each takes one trial's flat
hyperparameter dict, applies it to its yml, trains and returns the final
stats for the executor to rank. ``device`` is the trainer's (``None``:
CUDA)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POSITIVE = frozenset({
    "good", "great", "excellent", "amazing", "wonderful", "best", "love",
    "loved", "beautiful", "enjoyable", "brilliant", "fantastic", "perfect",
    "fun", "happy", "masterpiece", "superb", "delightful",
})
NEGATIVE = frozenset({
    "bad", "worst", "terrible", "awful", "boring", "hate", "hated", "poor",
    "horrible", "disappointing", "waste", "dull", "mess", "stupid",
    "annoying", "ugly", "painful",
})
PROMPT_STUBS = (
    "This movie was", "I thought the film", "The acting in this",
    "What a truly", "Honestly the plot", "The director has",
    "From the first scene", "My favorite part", "The ending was",
    "Overall I would", "The cinematography looked", "Every single actor",
)


def ppo_randomwalks_train(params: Dict[str, Any], device=None) -> Optional[Dict[str, Any]]:
    """PPO on the synthetic random-walks task
    (:mod:`trlx_tpu_torch.examples.randomwalks`), the fast sweep target."""
    from trlx_tpu_torch.examples.randomwalks import main

    return main(params, device=device)


def lexicon_sentiment(samples) -> list:
    """Positive minus negative words of the examples' lexicon a sample."""
    scores = []
    for s in samples:
        words = [w.strip(".,!?") for w in s.lower().split()]
        scores.append(float(sum(w in POSITIVE for w in words) - sum(w in NEGATIVE for w in words)))
    return scores


def ppo_sentiments_train(params: Dict[str, Any], device=None) -> Optional[Dict[str, Any]]:
    """PPO on ``configs/ppo_sentiments.yml``. It needs the policy's HF
    checkpoint and its tokenizer on disk: ``model.model_path`` and
    ``model.tokenizer_path`` (``lvwerra/gpt2-imdb`` in the yml; pass local
    directories as ``model.model_path`` / ``model.tokenizer_path`` in the
    trial's params or the sweep yml). Neither is in the repository; a
    missing one raises ``FileNotFoundError`` before any training. The
    reward is the examples' sentiment lexicon."""
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig

    config = TRLConfig.load_yaml(os.path.join(ROOT, "configs", "ppo_sentiments.yml"))
    if params:
        config.update(**params)
    for key in ("model_path", "tokenizer_path"):
        path = getattr(config.model, key)
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"ppo_sentiments_train needs model.{key} to be a local directory "
                f"(the HF gpt2-imdb checkpoint and its tokenizer); got {path!r}"
            )

    def reward_fn(samples, queries=None, response_gt=None):
        return lexicon_sentiment(samples)

    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=list(PROMPT_STUBS) * 16,
                                   config=config, device=device)
    return trainer._final_stats
