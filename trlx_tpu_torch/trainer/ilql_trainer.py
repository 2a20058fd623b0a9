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
- Under ``train.rollout_param_cast`` (default on) with a compute dtype
  other than the parameters', the eval decode runs on a compute-dtype
  copy of the policy and the target heads (:meth:`rollout_bundle`, the
  PPO trainer's cast: bit-identical, ``fc2`` and the layer norms kept
  f32), made on first use after the last update or ``load``.
- A ``gpt2_moe`` policy adds the router's load-balancing penalty to each
  update's loss and stats, as the PPO trainer does.
- ``save`` runs on a thread under ``train.async_checkpoint``, which
  ``learn`` joins at its end (:mod:`trlx_tpu_torch.utils.checkpoint`).
  ``train.resume_from_checkpoint`` resumes the schedule inside ``learn``;
  the preemption drain runs at the chunk boundaries. ``learn`` appends
  the run's manifest to the run ledger at its end (``train.run_dir`` or
  ``$TRLX_RUN_LEDGER``), as the PPO trainer does.
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
from trlx_tpu_torch.models.gpt2_moe import (
    apply_router_penalty,
    collect_moe_losses,
    moe_loss_summary,
)
from trlx_tpu_torch.models.heads import CausalLMWithILQLHeads, ILQLHeads, init_params
from trlx_tpu_torch.models.registry import get_model_family, load_arch
from trlx_tpu_torch.ops.ilql_math import ilql_loss, polyak_update
from trlx_tpu_torch.ops.sampling import GenerationConfig, make_sampler, validate_gen_config
from trlx_tpu_torch.trainer import BaseRLTrainer, refuse_unported, register_trainer
from trlx_tpu_torch.trainer.common import freeze_layers, make_optimizer
from trlx_tpu_torch.utils import (
    compute_dtype_cast,
    monotonic,
    resolve_device,
    rollout_cast_dtype,
    set_seed,
)
from trlx_tpu_torch.utils.checkpoint import (
    CheckpointWriter,
    has_checkpoint,
    load_checkpoint,
    translate_structure_errors,
)
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
        refuse_unported(config, self)
        self.device = resolve_device(device)
        if tokenizer is None and config.model.tokenizer_path:
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(
                config.model.tokenizer_path, local_files_only=True
            )
            if self.tokenizer.pad_token_id is None:
                self.tokenizer.pad_token = self.tokenizer.eos_token

        self._setup_model()
        self._rollout_bundle = None
        self.rollout_cast_refreshes = 0
        self.opt = make_optimizer(train, train.total_steps, self.model.parameters())
        self.generator = set_seed(train.seed, self.device)  # sampling noise
        self._checkpoints = CheckpointWriter()

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

    @property
    def rollout_cast_dtype(self) -> Optional[torch.dtype]:
        """The eval decode's weight dtype under ``train.rollout_param_cast``,
        or ``None`` (off, or the compute dtype is the parameters')."""
        return rollout_cast_dtype(self.config.train, self.model_config)

    def rollout_bundle(self):
        """``(policy, target heads)`` for the eval decode: compute-dtype
        copies when the cast is on (made on first use after the last
        update or ``load``; ``rollout_cast_refreshes`` counts them), else
        the live modules."""
        dtype = self.rollout_cast_dtype
        if dtype is None:
            return self.model, self.target
        if self._rollout_bundle is None:
            self._rollout_bundle = (compute_dtype_cast(self.model, dtype),
                                    compute_dtype_cast(self.target, dtype))
            self.rollout_cast_refreshes += 1
        return self._rollout_bundle

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
        model, target = self.rollout_bundle()
        out = model.transformer(
            input_ids, attention_mask=attention_mask, position_ids=position_ids,
            cache=cache, cache_index=cache_index, compute_logits=not last_only,
        )
        hidden, raw = out["hidden"], out["logits"]
        if last_only:
            hidden = hidden[:, -1:]
            raw = model.transformer.logits(hidden)
        logits = self.shift_logits(
            raw, target.q(hidden), model.heads.v(hidden), input_ids, last_only
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
        with collect_moe_losses(self.model) as moe:
            out = self.model(
                mb.input_ids, attention_mask=mb.attention_mask,
                actions_ixs=mb.actions_ixs, states_ixs=mb.states_ixs,
            )
        with torch.no_grad():
            target_qs = self.target.q(out["action_hidden"])
        loss, stats = ilql_loss(out["logits"], out["qs"], target_qs, out["vs"], mb,
                                self.config.method, health=self._health_enabled)
        if self.family.is_moe:
            loss, stats = apply_router_penalty(
                loss, stats, moe_loss_summary(moe), self.model_config
            )
        return loss, stats

    def train_step(self, mb: ILQLBatch) -> Dict[str, torch.Tensor]:
        """One ILQL update on a minibatch, then the target sync when due;
        returns its stats (device scalars), ``optimizer/grad_norm``
        included."""
        method = self.config.method
        self._rollout_bundle = None  # stale after this update
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
        their intervals; at ``total_steps`` save, then eval. Under
        ``train.resume_from_checkpoint`` with a checkpoint on disk it first
        loads the newest one and continues the exact schedule: epoch ``s //
        n_minibatches``, minibatch ``s % n_minibatches`` of that epoch's
        seeded order, with no step-0 eval (the uninterrupted run made none
        there, and its sampling would move the generator). The preemption
        drain runs after each chunk of the JAX trainer's fused updates."""
        train = self.config.train
        if self.store is None:
            raise ValueError("no offline data: run OfflineOrchestrator.make_experience")
        if train.resume_from_checkpoint and has_checkpoint(train.checkpoint_dir):
            self.load(train.checkpoint_dir)
        n_minibatches = max(len(self.store) // train.batch_size, 1)
        total_steps = min(train.total_steps, train.epochs * n_minibatches)
        self.logger = Logger()
        try:
            result = self._learn_body(total_steps, n_minibatches)
        except BaseException as e:
            self.flight_dump_on_exception(e)  # no-op with health off
            self.append_run_ledger(status="error", error=e)
            raise
        else:
            self.append_run_ledger(status="ok")
            return result
        finally:
            self._checkpoints.wait()  # the end save ran beside the final eval

    def _learn_body(self, total_steps: int, n_minibatches: int) -> Dict[str, Any]:
        train = self.config.train
        iter_count = self.step
        if iter_count == 0:
            self.logger.log(self.evaluate(), step=0)
        final_stats: Dict[str, Any] = {}
        self._final_stats = final_stats  # the run ledger's payload
        if iter_count >= total_steps:
            return final_stats
        # a loaded trainer continues the schedule where its step left it
        epoch0, row0 = divmod(iter_count, n_minibatches)
        chunk = {"index": -1, "left": 0}
        for epoch in range(epoch0, train.epochs):
            order = self.store.epoch_order(train.batch_size, shuffle=True, seed=train.seed + epoch)
            start = row0 if epoch == epoch0 else 0
            for r, rows in enumerate(order[start:]):
                if not chunk["left"]:
                    self._next_health_chunk(chunk, iter_count, len(order) - start - r,
                                            total_steps)
                t0 = monotonic()
                stats = self.train_step(self.store.stacked_slice(rows))
                values = torch.stack([v.float() for v in stats.values()]).tolist()
                step_stats = dict(zip(stats, values))
                iter_count += 1
                self._observe_update(step_stats, iter_count, chunk)
                self.check_anomalies(step_stats, iter_count)
                step_stats["time/batch"] = monotonic() - t0
                if iter_count % train.log_interval == 0:
                    self.logger.log(step_stats, step=iter_count)
                    final_stats = self._final_stats = dict(step_stats)
                iv = self.intervals(iter_count)
                if iv["do_eval"] and iter_count < total_steps:
                    self._eval(iter_count, final_stats)
                if iv["do_save"] and iter_count < total_steps:
                    self.save()
                if iter_count >= total_steps:
                    self.save()
                    self._eval(iter_count, final_stats)
                    return final_stats
                if not chunk["left"]:
                    # the JAX trainer's phase boundary: its fused chunk's end
                    self.maybe_drain(phase=chunk["index"], step=iter_count)
        return final_stats

    def _next_health_chunk(self, chunk, step: int, remaining: int, total_steps: int) -> None:
        """Open the next run-health "phase": the JAX trainer's fused chunk
        of up to 32 updates, cut at the epoch's end, ``total_steps`` and
        the eval and save boundaries, so events and flight records carry
        its phase ids."""
        train = self.config.train
        k = min(32, remaining, total_steps - step)
        for boundary in (train.eval_interval, train.checkpoint_interval):
            k = min(k, boundary - step % boundary)
        chunk.update(index=chunk["index"] + 1, left=max(k, 1))

    def _observe_update(self, step_stats: Dict[str, float], step: int, chunk) -> None:
        """Feed one update's fetched row to the detectors (before the
        non-finite check), and after a chunk's last update append its
        flight record."""
        chunk["left"] -= 1
        if self.health_monitor is None:
            return
        row = {k: step_stats[k] for k in sorted(step_stats)}
        self.observe_health(row, step=step, phase=chunk["index"])
        if not chunk["left"]:
            self.record_flight_phase(chunk["index"], step=step, stats_row=row)

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
        host = self.host_state_dict()
        if host:
            state["host"] = host
        self._checkpoints.save(
            directory or self.config.train.checkpoint_dir, state, self.step,
            async_save=bool(self.config.train.training.get("async_checkpoint", False)),
        )

    def load(self, directory: str) -> None:
        """Restore the newest checkpoint under ``directory`` (after every
        write in flight has landed)."""
        state = load_checkpoint(directory, device="cpu")
        self._rollout_bundle = None
        with translate_structure_errors(directory):
            self.model.load_state_dict(state["model"])
            self.target.load_state_dict(state["target"])
            self.opt.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
        self.load_host_state_dict(state.get("host"))
