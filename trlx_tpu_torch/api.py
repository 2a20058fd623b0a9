"""One-call user API: ``trlx_tpu_torch.train(...)`` (counterpart of
:func:`trlx_tpu.api.train`, the online PPO branch).

A ``reward_fn`` selects online PPO: build the trainer, the prompt pipeline
and the orchestrator from the config's registry names, bind the eval
pipeline, and run ``learn()`` once. Offline ILQL (``dataset``) is ROADMAP
item 11; the resilience supervisor's restarts are item 18.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline, get_trainer

_DEFAULT_PPO_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs",
    "ppo_sentiments.yml",
)


def train(
    model_path: Optional[str] = None,
    reward_fn: Optional[Callable] = None,
    dataset=None,
    prompts: Optional[List] = None,
    response_gt: Optional[List[str]] = None,
    eval_prompts: Optional[List] = None,
    metric_fn: Optional[Callable] = None,
    config: Optional[TRLConfig] = None,
    tokenizer=None,
    device=None,
):
    """Train a policy with PPO against ``reward_fn`` and return the
    trainer.

    :param model_path: an HF checkpoint directory to start from (sets
        ``config.model.model_path``).
    :param reward_fn: ``(samples, queries, response_gt) -> [float]``.
    :param prompts: strings (tokenized with ``tokenizer``) or token-id lists.
    :param response_gt: optional ground-truth responses for the reward.
    :param eval_prompts: eval prompts (default: the training prompts).
    :param device: ``None`` means CUDA (raises without it); ``"cpu"`` runs
        the kernels' plain versions.
    """
    if reward_fn is None:
        if dataset is not None:
            raise NotImplementedError(
                "offline ILQL (`dataset`) is not ported yet (ROADMAP item 11)"
            )
        raise ValueError("`reward_fn` (online PPO) is required")
    config = config or TRLConfig.load_yaml(_DEFAULT_PPO_CONFIG)
    if model_path:
        config.model.model_path = model_path
    if prompts is None:
        raise ValueError("online PPO requires `prompts`")
    trainer = get_trainer(config.train.trainer)(
        config, reward_fn=reward_fn, metric_fn=metric_fn, tokenizer=tokenizer,
        device=device,
    )
    pipeline = get_pipeline(config.train.pipeline)(
        prompts, trainer.query_length, trainer.tokenizer, response_gt=response_gt
    )
    get_orchestrator(config.train.orchestrator)(
        trainer, pipeline, reward_fn=reward_fn, chunk_size=config.method.chunk_size
    )
    # the training prompts (and their ground truths) double as eval prompts
    eval_pipeline = pipeline if eval_prompts is None else get_pipeline(
        config.train.pipeline
    )(eval_prompts, trainer.query_length, trainer.tokenizer)
    trainer.add_eval_pipeline(eval_pipeline)
    trainer.learn()
    return trainer
