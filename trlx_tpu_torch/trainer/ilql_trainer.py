"""ILQL trainer: offline Q-learning on a reward-labeled dataset
(counterpart of :mod:`trlx_tpu.trainer.ilql_trainer`).

- The policy is a :class:`CausalLMWithILQLHeads` (GPT-2) with random
  weights from ``train.seed``, or its backbone loaded from
  ``model.model_path`` (the heads still come from the seed).
  ``model.num_layers_unfrozen`` freezes as ILQL reads it: ``0`` freezes
  every block and the embeddings (``trainer/common.py::freeze_layers``).
- The target heads are a copy of the Q heads taken at construction. After
  update ``n`` (counted from 1) with ``n % steps_for_target_q_sync == 0``
  they move to ``alpha * q + (1 - alpha) * target``.
- One update: the forward with the action and state gathers (every
  attention through K1, the backward through K2 and K3 on CUDA), the
  target heads' Q values from the action states' hidden under
  ``no_grad``, ``ilql_loss``, backward, the global-norm clip and AdamW.
  The JAX package runs up to 32 updates in one scanned dispatch; the port
  runs one per step, with the same per-step stats rows and the same
  epoch order (``seed + epoch``) and eval/save cadence.
- The eval decode samples ``log_softmax(logits) + beta * (min target Q -
  V)`` at each step, masked by ``logit_mask`` on the last input token,
  through :func:`~trlx_tpu_torch.ops.sampling.make_sampler` with
  ``with_values=False`` and the trainer's ``torch.Generator``.
- ``self.forwards`` counts the forwards the trainer makes (update
  forwards, the sampler's prefills and decode steps): each runs the
  attention forward once per layer.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from trlx_tpu_torch.data.ilql_types import ILQLBatch
from trlx_tpu_torch.data.method_configs import DEFAULT_ILQL_GEN_KWARGS
from trlx_tpu_torch.models.heads import CausalLMWithILQLHeads, ILQLHeads, init_params
from trlx_tpu_torch.models.registry import get_model_family, load_arch
from trlx_tpu_torch.ops.ilql_math import ilql_loss, polyak_update
from trlx_tpu_torch.ops.sampling import GenerationConfig, make_sampler, validate_gen_config
from trlx_tpu_torch.trainer import BaseRLTrainer, refuse_unported, register_trainer
from trlx_tpu_torch.trainer.common import freeze_layers, make_optimizer
from trlx_tpu_torch.utils import monotonic, resolve_device, set_seed
from trlx_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from trlx_tpu_torch.utils.logging import Logger


def q_parameters(heads: ILQLHeads):
    """The Q heads' parameters, in the order of both live and target."""
    return [p for head in heads.q_heads() for p in head.parameters()]


@register_trainer
class ILQLTrainer(BaseRLTrainer):
    """
    :param config: :class:`~trlx_tpu_torch.data.configs.TRLConfig` with an
        ``ILQLConfig`` method.
    :param reward_fn: optional ``(samples, queries, response_gt) ->
        [float]`` scoring the eval samples.
    :param metric_fn: optional ``samples -> {name: values}`` for eval.
    :param tokenizer: optional tokenizer (``encode``/``decode``).
    :param logit_mask: optional [V, V] bool adjacency for the eval decode.
    :param device: ``None`` means CUDA (raises without it); ``"cpu"`` runs
        the plain versions of the kernels.
    """

    def __init__(
        self,
        config,
        reward_fn: Optional[Callable] = None,
        metric_fn: Optional[Callable] = None,
        tokenizer=None,
        logit_mask=None,
        device=None,
    ):
        super().__init__(config, reward_fn, metric_fn, tokenizer, logit_mask)
        method, train = config.method, config.train
        if (train.rollout or {}).get("engine", "fixed") != "fixed":
            raise NotImplementedError(
                f"train.rollout engine {train.rollout.get('engine')!r} is not "
                "supported by ILQLTrainer (offline trainer; no rollout engine)"
            )
        if (train.training.get("async_rl") or {}).get("enabled"):
            raise NotImplementedError(
                "train.async_rl is not supported by ILQLTrainer (offline "
                "trainer; there is no actor/collect loop to run asynchronously)"
            )
        refuse_unported(config)
        self.device = resolve_device(device)
        if tokenizer is None and config.model.tokenizer_path:
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(
                config.model.tokenizer_path, local_files_only=True
            )
            if self.tokenizer.pad_token_id is None:
                self.tokenizer.pad_token = self.tokenizer.eos_token

        self._setup_model()
        self.opt = make_optimizer(train, train.total_steps, self.model.parameters())
        self.generator = set_seed(train.seed, self.device)  # sampling noise

        # the eval-decode defaults under the config's keys, also when code
        # assigned method.gen_kwargs directly (bypassing from_dict's merge)
        gen_kwargs = {**DEFAULT_ILQL_GEN_KWARGS, **(method.gen_kwargs or {})}
        self.apply_tokenizer_gen_defaults(gen_kwargs)
        self.gen_config = GenerationConfig.from_dict(gen_kwargs)
        validate_gen_config(self.gen_config, self.model_config.vocab_size, provided=set(gen_kwargs))
        self.beta = float(method.betas[0])
        self.query_length = min(
            train.seq_length, max(train.seq_length - self.gen_config.max_new_tokens, 1)
        )
        self.allowed = (
            None if logit_mask is None
            else torch.as_tensor(np.asarray(logit_mask), dtype=torch.bool, device=self.device)
        )
        self.store = None  # installed by OfflineOrchestrator.make_experience
        self.step = 0  # updates taken
        self.forwards = 0
        self._rebuild_sampler()

    def _setup_model(self) -> None:
        """The policy of ``model.model_type`` (random weights from
        ``train.seed``, then the backbone from ``model.model_path`` if set),
        the target heads from its initial Q heads, and ILQL's freezing:
        sets ``family``, ``model_config``, ``model`` and ``target``."""
        config = self.config
        self.family = get_model_family(config.model.model_type)
        if self.family.is_seq2seq:
            raise NotImplementedError(
                f"model_type {config.model.model_type!r}: ILQLTrainer trains a "
                "causal LM (the JAX package's ILQL has no seq2seq path)"
            )
        self.model_config, backbone = load_arch(self.family, config.model, config.train)
        two_qs = config.method.two_qs
        self.model = CausalLMWithILQLHeads(
            self.model_config, two_qs, self.family.backbone_cls, device=self.device
        )
        init_params(self.model, config.train.seed)
        if backbone is not None:
            self.model.transformer.load_state_dict(backbone)
        self.target = ILQLHeads(self.model_config, two_qs, with_v=False, device=self.device)
        self.target.load_state_dict({
            k: v for k, v in self.model.heads.state_dict().items() if not k.startswith("v_head.")
        })
        self.target.requires_grad_(False)
        freeze_layers(self.model, config.model.num_layers_unfrozen, self.model_config.n_layer,
                      zero_freezes_all=True)

    def _rebuild_sampler(self) -> None:
        """(Re)build the eval sampler from ``self.gen_config``."""
        self._sampler = make_sampler(
            self._sample_apply,
            functools.partial(self.family.init_cache, self.model_config, device=self.device),
            self.gen_config,
            self.query_length,
            with_values=False,
        )

    # ------------------------------------------------------------------ #

    def shift_logits(self, raw_logits, target_qs, vs, input_ids, last_only: bool) -> torch.Tensor:
        """``log_softmax(raw) + beta * (min target Q - V)``, then the
        ``logit_mask`` row of each position's input token (the last one
        under ``last_only``)."""
        min_q = target_qs[0]
        for tq in target_qs[1:]:
            min_q = torch.minimum(min_q, tq)
        logits = torch.log_softmax(raw_logits, dim=-1) + self.beta * (min_q - vs[..., None])
        if self.allowed is not None:
            ids = input_ids[:, -1:] if last_only else input_ids
            logits = logits.masked_fill(~self.allowed[ids.long()], -1e9)
        return logits

    def _sample_apply(self, input_ids, attention_mask=None, position_ids=None, cache=None,
                      cache_index=None, last_only: bool = False) -> Dict[str, Any]:
        """The eval decode's forward: the shifted logits and the cache. It
        reads only V from the live heads and Q from the target heads (the
        JAX sampler's live Q heads go unread, and XLA prunes them)."""
        self.forwards += 1
        out = self.model.transformer(
            input_ids, attention_mask=attention_mask, position_ids=position_ids,
            cache=cache, cache_index=cache_index, compute_logits=not last_only,
        )
        hidden, raw = out["hidden"], out["logits"]
        if last_only:
            hidden = hidden[:, -1:]
            raw = self.model.transformer.logits(hidden)
        logits = self.shift_logits(
            raw, self.target.q(hidden), self.model.heads.v(hidden), input_ids, last_only
        )
        return {"logits": logits, "cache": out["cache"]}

    def sample(self, prompt_ids, prompt_mask):
        """Eval-decode a prompt batch with the shifted logits."""
        return self._sampler(
            prompt_ids.to(self.device), prompt_mask.to(self.device), generator=self.generator
        )

    @property
    def eval_batch_size(self) -> int:
        return self.config.train.batch_size

    # ------------------------------------------------------------------ #

    def _loss(self, mb: ILQLBatch):
        self.forwards += 1
        out = self.model(
            mb.input_ids, attention_mask=mb.attention_mask,
            actions_ixs=mb.actions_ixs, states_ixs=mb.states_ixs,
        )
        with torch.no_grad():
            target_qs = self.target.q(out["action_hidden"])
        return ilql_loss(out["logits"], out["qs"], target_qs, out["vs"], mb, self.config.method)

    def train_step(self, mb: ILQLBatch) -> Dict[str, torch.Tensor]:
        """One ILQL update on a minibatch, then the target sync when due;
        returns its stats (device scalars), ``optimizer/grad_norm``
        included."""
        method = self.config.method
        loss, stats = self._loss(mb)
        self.opt.zero_grad()
        loss.backward()
        stats["optimizer/grad_norm"] = self.opt.step()
        self.step += 1
        if self.step % method.steps_for_target_q_sync == 0:
            polyak_update(q_parameters(self.model.heads), q_parameters(self.target),
                          method.alpha)
        return stats

    def learn(self) -> Dict[str, Any]:
        """The offline loop: eval at step 0; per epoch, the minibatches of
        ``epoch_order(seed + epoch)`` one update each; eval and save on
        their intervals; at ``total_steps`` save, then eval."""
        train = self.config.train
        if self.store is None:
            raise ValueError("no offline data: run OfflineOrchestrator.make_experience")
        n_minibatches = max(len(self.store) // train.batch_size, 1)
        total_steps = min(train.total_steps, train.epochs * n_minibatches)
        self.logger = Logger()
        self.logger.log(self.evaluate(), step=0)
        iter_count = self.step
        final_stats: Dict[str, Any] = {}
        if iter_count >= total_steps:
            return final_stats
        # a loaded trainer continues the schedule where its step left it
        epoch0, row0 = divmod(iter_count, n_minibatches)
        for epoch in range(epoch0, train.epochs):
            order = self.store.epoch_order(train.batch_size, shuffle=True, seed=train.seed + epoch)
            for rows in order[row0 if epoch == epoch0 else 0:]:
                t0 = monotonic()
                stats = self.train_step(self.store.stacked_slice(rows))
                values = torch.stack([v.float() for v in stats.values()]).tolist()
                step_stats = dict(zip(stats, values))
                iter_count += 1
                self.check_anomalies(step_stats, iter_count)
                step_stats["time/batch"] = monotonic() - t0
                if iter_count % train.log_interval == 0:
                    self.logger.log(step_stats, step=iter_count)
                    final_stats = dict(step_stats)
                iv = self.intervals(iter_count)
                if iv["do_eval"] and iter_count < total_steps:
                    self._eval(iter_count, final_stats)
                if iv["do_save"] and iter_count < total_steps:
                    self.save()
                if iter_count >= total_steps:
                    self.save()
                    self._eval(iter_count, final_stats)
                    return final_stats
        return final_stats

    def _eval(self, step: int, final_stats: Dict[str, Any]) -> None:
        eval_stats = self.evaluate()
        self.logger.log(eval_stats, step=step)
        final_stats.update(eval_stats)

    # ------------------------------------------------------------------ #

    def save(self, directory: Optional[str] = None) -> None:
        """Checkpoint the policy and heads, the target heads, the optimizer,
        the update count and the sampling generator as step
        ``self.step``."""
        state = {
            "model": self.model.state_dict(),
            "target": self.target.state_dict(),
            "optimizer": self.opt.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
        }
        save_checkpoint(directory or self.config.train.checkpoint_dir, state, self.step)

    def load(self, directory: str) -> None:
        """Restore the latest checkpoint under ``directory``."""
        state = load_checkpoint(directory, device="cpu")
        self.model.load_state_dict(state["model"])
        self.target.load_state_dict(state["target"])
        self.opt.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
