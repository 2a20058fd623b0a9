"""One-call user API: ``trlx_tpu_torch.train(...)`` (counterpart of
:func:`trlx_tpu.api.train`).

A ``reward_fn`` selects online PPO: build the trainer, the prompt pipeline
and the orchestrator from the config's registry names, bind the eval
pipeline, and run ``learn()`` once. A reward-labeled ``dataset`` selects
offline ILQL: the trainer and orchestrator become ``ILQLTrainer`` and
``OfflineOrchestrator`` (recorded back in the config), the orchestrator
packs the dataset, and the eval prompts default to the first 64 samples'
prompts. The resilience supervisor's restarts are ROADMAP item 18.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import ILQLConfig
from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline, get_trainer

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
_DEFAULT_PPO_CONFIG = os.path.join(_CONFIGS, "ppo_sentiments.yml")
_DEFAULT_ILQL_CONFIG = os.path.join(_CONFIGS, "ilql_sentiments.yml")


def train(
    model_path: Optional[str] = None,
    reward_fn: Optional[Callable] = None,
    dataset=None,
    prompts: Optional[List] = None,
    response_gt: Optional[List[str]] = None,
    eval_prompts: Optional[List] = None,
    metric_fn: Optional[Callable] = None,
    config: Optional[TRLConfig] = None,
    split_token: Optional[str] = None,
    logit_mask=None,
    tokenizer=None,
    device=None,
):
    """Train a policy with PPO against ``reward_fn`` or with ILQL on
    ``dataset``, and return the trainer.

    :param model_path: an HF checkpoint directory to start from (sets
        ``config.model.model_path``).
    :param reward_fn: ``(samples, queries, response_gt) -> [float]``.
    :param dataset: ``(samples, rewards)`` for offline ILQL; a sample is a
        string, a (prompt, response) pair or a (token_list, action_start)
        pair.
    :param prompts: strings (tokenized with ``tokenizer``) or token-id lists.
    :param response_gt: optional ground-truth responses for the reward.
    :param eval_prompts: eval prompts (default: the training prompts; for
        ILQL the prompts of the first 64 samples).
    :param split_token: splits ILQL's string samples into prompt and
        response.
    :param logit_mask: [V, V] bool adjacency for ILQL's eval decode.
    :param device: ``None`` means CUDA (raises without it); ``"cpu"`` runs
        the kernels' plain versions.
    """
    if reward_fn is None:
        if dataset is None:
            raise ValueError("Either `reward_fn` (PPO) or `dataset` (ILQL) is required")
        return _train_offline(model_path, dataset, eval_prompts, metric_fn, config,
                              split_token, logit_mask, tokenizer, device)
    config = config or TRLConfig.load_yaml(_DEFAULT_PPO_CONFIG)
    if isinstance(config.method, ILQLConfig):
        raise ValueError(
            "`reward_fn` selects online PPO, but the config's method is "
            "ILQLConfig — use a PPO method section (e.g. "
            "configs/ppo_sentiments.yml), or pass `dataset` for offline ILQL"
        )
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


def _train_offline(model_path, dataset, eval_prompts, metric_fn, config, split_token,
                   logit_mask, tokenizer, device):
    samples, rewards = dataset
    samples, rewards = list(samples), list(rewards)
    config = config or TRLConfig.load_yaml(_DEFAULT_ILQL_CONFIG)
    if model_path:
        config.model.model_path = model_path
    if not isinstance(config.method, ILQLConfig):
        raise ValueError(
            "`dataset` selects offline ILQL, but the config's method is "
            f"{type(config.method).__name__} — use an ILQLConfig method "
            "section (e.g. configs/ilql_sentiments.yml)"
        )
    config.train.trainer = "ILQLTrainer"
    config.train.orchestrator = "OfflineOrchestrator"
    if eval_prompts is None:
        # the samples' prompts: a string itself, a pair's prompt, or the
        # tokens before the first action
        eval_prompts = []
        for s in samples[:64]:
            if isinstance(s, str):
                eval_prompts.append(s)
            elif len(s) == 2 and isinstance(s[0], str):
                eval_prompts.append(s[0])
            else:
                toks, start = s
                eval_prompts.append([int(t) for t in toks[: max(int(start), 1)]])
    trainer = get_trainer(config.train.trainer)(
        config, metric_fn=metric_fn, tokenizer=tokenizer, logit_mask=logit_mask, device=device,
    )
    get_orchestrator(config.train.orchestrator)(trainer, split_token=split_token).make_experience(
        samples, rewards
    )
    trainer.add_eval_pipeline(
        get_pipeline(config.train.pipeline)(eval_prompts, trainer.query_length, trainer.tokenizer)
    )
    trainer.learn()
    return trainer
