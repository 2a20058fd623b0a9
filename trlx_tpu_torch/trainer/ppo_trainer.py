"""PPO trainer on the fixed-batch sampler (counterpart of
:mod:`trlx_tpu.trainer.ppo_trainer`).

- The policy is a :class:`CausalLMWithValueHead` with random weights
  from ``train.seed``, or its backbone loaded from ``model.model_path``
  (an HF checkpoint directory; the value head still comes from the seed).
  The module's parameters and the optimizer are the train state;
  ``model.num_layers_unfrozen > 0`` freezes the blocks below the top ones
  and the embeddings.
- The frozen KL reference is taken from the initial weights at
  construction: a full copy of the backbone, or with a hydra branch
  (``model.ref_branch_layers``, which follows a positive
  ``num_layers_unfrozen`` when unset) a copy of its top blocks, ``ln_f``
  and ``wte`` only, run from the live policy trunk's activation at the
  branch point.
- ``train.logprob_chunk > 0`` (with ``ent_coef`` 0) computes the update's
  logprobs chunk by chunk of response positions under
  ``torch.utils.checkpoint``, so the [B, R, V] f32 logits never exist.
- ``train.rollout.engine: continuous`` collects through the
  continuous-batching engine (:mod:`trlx_tpu_torch.inference.engine`),
  built on first use over the same policy module; rows then land in
  harvest order. Under it, or ``rollout.per_row_rng: true``, the fixed
  sampler draws each row's noise from (phase seed, row draw index, step)
  as the engine does: one seed per collect phase, drawn from the sampling
  generator, and a cursor over the phase's rows.
- One update: ``_advantages_and_returns`` (GAE and whitening on the
  minibatch; GRPO overrides it), the policy forward over
  [query; response] with the heads on the response-predicting positions
  only, ``ppo_loss``, backward (every attention through
  :class:`~trlx_tpu_torch.ops.flash_attention.FlashAttention`, whose
  backward is the dQ and dK/dV kernels on CUDA), the global-norm clip and
  AdamW.
- Update schedule per phase, as the JAX package chooses it: the streamed
  phase's :class:`~trlx_tpu_torch.pipeline.ppo_buffer.StreamPlan`
  (epoch-major) run serially after collection when no eval/checkpoint
  boundary or ``total_steps`` cutoff falls inside the pass; else (and
  always under ``phase_overlap: false``) the minibatch-major order. One
  loop runs either order; after each minibatch's last update the KL
  controller advances and the boundaries are checked.
- ``self.forwards`` counts the policy/reference forwards the trainer
  makes (rollout prefill and decode steps, reference scoring, update
  forwards): each runs the attention forward once per layer.
- The family-specific wiring sits in hooks that the seq2seq trainer
  (:mod:`trlx_tpu_torch.trainer.seq2seq_ppo_trainer`) overrides, as the
  reference's does: ``_setup_model``, ``_amend_gen_kwargs``,
  ``_check_response_budget``, ``_make_sampler``, ``bind_prompt_budget``,
  ``score_ref``, ``_forward_logprobs_values`` and
  ``_supports_continuous_engine``; GRPO
  (:mod:`trlx_tpu_torch.trainer.grpo_trainer`) overrides
  ``_shape_rewards`` and ``_advantages_and_returns``.
  ``self.phase_times`` records each phase's collect and train seconds
  and its rollout tokens.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch.data.method_configs import GRPOConfig
from trlx_tpu_torch.data.ppo_types import PPORolloutBatch, SampleOutput
from trlx_tpu_torch.inference import RolloutEngineConfig
from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
from trlx_tpu_torch.models.registry import get_model_family, load_arch
from trlx_tpu_torch.ops.ppo_math import (
    get_advantages_and_returns,
    kl_controller_update,
    policy_entropy,
    ppo_loss,
)
from trlx_tpu_torch.ops.sampling import (
    GenerationConfig,
    make_sampler,
    validate_gen_config,
)
from trlx_tpu_torch.pipeline.ppo_buffer import PPORolloutBuffer, make_stream_plan
from trlx_tpu_torch.trainer import BaseRLTrainer, refuse_unported, register_trainer
from trlx_tpu_torch.trainer.common import freeze_layers, make_optimizer
from trlx_tpu_torch.utils import (
    chunked_logprobs,
    logprobs_from_logits,
    monotonic,
    resolve_device,
    set_seed,
)
from trlx_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from trlx_tpu_torch.utils.logging import Logger


@register_trainer
class PPOTrainer(BaseRLTrainer):
    """
    :param config: :class:`~trlx_tpu_torch.data.configs.TRLConfig`.
    :param reward_fn: ``(samples, queries, response_gt) -> [float]``, used
        by :meth:`evaluate` (the orchestrator scores rollouts).
    :param metric_fn: optional ``samples -> {name: values}`` for eval.
    :param tokenizer: optional tokenizer (``encode``/``decode``).
    :param device: ``None`` means CUDA (raises without it); ``"cpu"`` runs
        the plain versions of the kernels.
    """

    def __init__(
        self,
        config,
        reward_fn: Optional[Callable] = None,
        metric_fn: Optional[Callable] = None,
        tokenizer=None,
        device=None,
    ):
        super().__init__(config, reward_fn, metric_fn, tokenizer)
        method, train = config.method, config.train
        refuse_unported(config)
        # grouped sampling: the orchestrator repeats each drawn prompt
        # group_size times; checked before the model is built
        self.group_size = int(getattr(method, "group_size", 1) or 1)
        if method.scale_reward == "group" and self.group_size < 2:
            raise ValueError(
                'scale_reward "group" needs method.group_size >= 2 '
                f"(got {self.group_size})"
            )
        from trlx_tpu_torch.trainer.grpo_trainer import GRPOMixin

        if isinstance(method, GRPOConfig) and not isinstance(self, GRPOMixin):
            # plain PPO would silently train on ungrouped rollouts with vf_coef 0
            raise ValueError(
                "method GRPOConfig requires a GRPO trainer (GRPOTrainer / "
                f"Seq2SeqGRPOTrainer); got {type(self).__name__}"
            )
        self.rollout_config = RolloutEngineConfig.from_dict(train.rollout)
        self.rollout_engine = self.rollout_config.engine
        if self.rollout_engine == "continuous":
            self._validate_continuous_engine()
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

        gen_kwargs = dict(method.gen_kwargs)
        self.apply_tokenizer_gen_defaults(gen_kwargs)
        self._amend_gen_kwargs(gen_kwargs)
        self.gen_config = GenerationConfig.from_dict(gen_kwargs)
        if self.rollout_config.rows_per_row_rng:
            import dataclasses

            self.gen_config = dataclasses.replace(self.gen_config, per_row_rng=True)
        validate_gen_config(self.gen_config, self.model_config.vocab_size, provided=set(gen_kwargs))
        self._check_response_budget()
        self._gen_budget_cap = self.gen_config.max_new_tokens
        self._bound_min_prompts: Dict[str, int] = {}
        self.query_length = train.seq_length
        if train.training.get("logprob_chunk", 0):
            self._check_logprob_chunk(train.training["logprob_chunk"])

        self.buffer = PPORolloutBuffer()
        self.kl_coef = float(method.init_kl_coef)
        self.mean_kl = 0.0
        self.step = 0  # updates taken
        self.forwards = 0
        self.phase_times: List[Dict[str, float]] = []
        self._phase_index = -1
        self._plan = None
        self._rollout_engine_obj = None
        self.reset_rollout_phase()
        self._rebuild_sampler()

    # ------------------------------------------------------------------ #

    def _setup_model(self) -> None:
        """Build the policy of ``model.model_type`` (random weights from
        ``train.seed``, then the backbone from ``model.model_path`` if
        set), take the KL reference from those initial weights and freeze
        per ``num_layers_unfrozen``: sets ``family``, ``model_config``,
        ``model`` and ``ref``."""
        config = self.config
        self.family = get_model_family(config.model.model_type)
        self.model_config, backbone = load_arch(self.family, config.model, config.train)
        self.model = CausalLMWithValueHead(
            self.model_config, self.family.backbone_cls, device=self.device
        )
        init_params(self.model, config.train.seed)
        if backbone is not None:
            self.model.transformer.load_state_dict(backbone)
        self._setup_reference(self.model.transformer, self.model_config.n_layer)
        freeze_layers(self.model, config.model.num_layers_unfrozen, self.model_config.n_layer)

    def _setup_reference(self, backbone, n_layer: int) -> None:
        """The frozen KL reference from ``backbone``'s current (initial)
        weights: the hydra branch of depth ``ref_branch`` when it is
        positive and the family supports one, else a full copy. Sets
        ``ref_branch``, ``use_hydra``, ``branch_start`` and ``ref``."""
        model = self.config.model
        self.ref_branch = model.resolved_ref_branch_layers
        if not 0 <= self.ref_branch <= n_layer:
            # unset, the depth follows num_layers_unfrozen: name the key
            # the user wrote
            key = ("model.ref_branch_layers" if model.ref_branch_layers is not None
                   else "model.num_layers_unfrozen")
            raise ValueError(f"{key}={self.ref_branch} must be in [0, n_layer={n_layer}]")
        self.use_hydra = self.ref_branch > 0 and self._supports_hydra()
        self.branch_start = n_layer - self.ref_branch if self.use_hydra else None
        if self.use_hydra:
            self.ref = backbone.hydra_branch(self.branch_start)
        else:
            self.ref = copy.deepcopy(backbone).requires_grad_(False)

    def _supports_hydra(self) -> bool:
        return True

    def _supports_logprob_chunk(self) -> bool:
        """Whether the trainer's update forward has a chunked logprob path
        (the seq2seq trainer's does not)."""
        return True

    def _check_logprob_chunk(self, chunk: int) -> None:
        if chunk < 0:
            raise ValueError(f"train.logprob_chunk={chunk} must be >= 0")
        if not self._supports_logprob_chunk():
            raise NotImplementedError(
                f"train.logprob_chunk is not supported by {type(self).__name__} "
                "(a causal-path feature; the seq2seq forward computes its own "
                "logits); remove the key"
            )
        if self.gen_config.max_new_tokens % chunk:
            raise ValueError(
                f"train.logprob_chunk={chunk} must divide gen max_new_tokens="
                f"{self.gen_config.max_new_tokens}"
            )

    def _amend_gen_kwargs(self, gen_kwargs: Dict[str, Any]) -> None:
        """Family defaults for the generation kwargs (none for causal LMs)."""

    def _check_response_budget(self) -> None:
        """Every rollout must have a response token. For causal LMs
        ``max_length`` caps prompt + generated, which only the bound
        pipeline's real prompt lengths decide (:meth:`bind_prompt_budget`)."""

    def _make_sampler(self):
        return make_sampler(
            self._apply,
            functools.partial(self.family.init_cache, self.model_config, device=self.device),
            self.gen_config,
            self.query_length,
        )

    def _rebuild_sampler(self) -> None:
        self._sampler = self._make_sampler()
        self._rollout_engine_obj = None  # built again on the new gen_config

    def _apply(self, *args, **kwargs):
        self.forwards += 1
        return self.model(*args, **kwargs)

    def bind_prompt_budget(self, pipeline, role: str = "train") -> None:
        """Check (and size) the decode budget against a pipeline's real
        prompt lengths when ``gen_kwargs.max_length`` caps prompt +
        generated: a training prompt that already fills it would leave a
        zero-length response, whose terminal score PPO drops."""
        max_len = self.gen_config.max_length
        longest = pipeline.max_prompt_tokens
        if max_len <= 0 or not len(pipeline):
            return
        if longest >= max_len:
            msg = (
                f"a prompt with {longest} real tokens fills gen_kwargs "
                f"max_length={max_len} (prompt + generated), leaving zero "
                "response tokens"
            )
            if role == "train":
                raise ValueError(msg)
            import warnings

            warnings.warn(msg + " (eval will score an empty string)")
        self._bound_min_prompts[role] = pipeline.min_prompt_tokens
        budget = max_len - min(self._bound_min_prompts.values())
        new = min(self._gen_budget_cap, budget) if budget > 0 else self._gen_budget_cap
        if new != self.gen_config.max_new_tokens:
            import dataclasses

            self.gen_config = dataclasses.replace(self.gen_config, max_new_tokens=new)
            self._rebuild_sampler()

    def add_eval_pipeline(self, pipeline) -> None:
        super().add_eval_pipeline(pipeline)
        self.bind_prompt_budget(pipeline, role="eval")

    def sample(self, prompt_ids, prompt_mask) -> SampleOutput:
        """Roll out a prompt batch with the current policy (under per-row
        RNG, as the phase's next rows)."""
        per_row = {}
        if self.gen_config.per_row_rng:
            per_row = {"rows": self.take_rows(prompt_ids.shape[0]),
                       "phase_seed": self.rollout_phase_seed()}
        return self._sampler(
            prompt_ids.to(self.device), prompt_mask.to(self.device),
            generator=self.generator, **per_row,
        )

    # ------------------------ continuous engine ------------------------ #

    def _supports_continuous_engine(self) -> bool:
        """Whether the policy has the engine's causal apply/cache contract
        (the seq2seq trainer's does not)."""
        return True

    def _validate_continuous_engine(self) -> None:
        if not self._supports_continuous_engine():
            raise NotImplementedError(
                "train.rollout engine 'continuous' is not supported by "
                f"{type(self).__name__} (causal-LM decode path); use engine: fixed"
            )
        # a pp mesh axis, which the reference also refuses here, is
        # refused earlier with the rest of multi-GPU parallelism
        if self.group_size > 1:
            raise NotImplementedError(
                "train.rollout engine 'continuous' does not support grouped "
                "sampling (method.group_size > 1 / GRPO) yet: harvest groups "
                "complete in finish order, breaking the group-contiguity the "
                "grouped reward shaping assumes; use engine: fixed"
            )

    def reset_rollout_phase(self) -> None:
        """Start a fresh per-row RNG phase: the next sampler or engine call
        draws a new phase seed and row indices restart at 0."""
        self._rollout_phase_seed = None
        self._rollout_row_cursor = 0

    def rollout_phase_seed(self) -> int:
        """The phase's per-row noise seed, drawn from the sampling
        generator on first use."""
        if self._rollout_phase_seed is None:
            self._rollout_phase_seed = int(torch.randint(
                2**62, (1,), generator=self.generator, device=self.generator.device
            ))
        return self._rollout_phase_seed

    def take_rows(self, n: int) -> List[int]:
        """Draw indices of the phase's next ``n`` rows (advances the
        cursor): the fixed sampler's per-row noise identity."""
        start = self._rollout_row_cursor
        self._rollout_row_cursor += n
        return list(range(start, start + n))

    @property
    def rollout_engine_obj(self):
        """The continuous-batching engine, built on first use (after
        ``bind_prompt_budget`` has settled the decode budget)."""
        if self._rollout_engine_obj is None:
            self._rollout_engine_obj = self._build_rollout_engine()
        return self._rollout_engine_obj

    def _build_rollout_engine(self):
        """The engine over the trainer's own policy module (the fixed
        sampler's per-use bf16 cast, its forwards counted) and the family's
        KV cache: ``rollout.slots`` slots, else one per chunk rollout."""
        from trlx_tpu_torch.inference.engine import ContinuousBatchingEngine

        cfg = self.rollout_config
        chunk = int(getattr(self.config.method, "chunk_size", 0) or self.config.train.batch_size)
        return ContinuousBatchingEngine(
            apply_fn=self._apply,
            init_cache_fn=functools.partial(
                self.family.init_cache, self.model_config, device=self.device
            ),
            gen_config=self.gen_config,
            query_length=self.query_length,
            vocab_size=self.model_config.vocab_size,
            num_slots=cfg.slots or chunk,
            admit_width=cfg.admit_width,
            harvest_width=cfg.harvest_width,
            block_size=cfg.block_size,
            done_poll_interval=cfg.poll_interval,
            device=self.device,
        )

    @torch.no_grad()
    def score_ref(self, q_ids, q_mask, r_ids, r_mask) -> torch.Tensor:
        """[B, R] logprobs of the responses under the frozen reference; the
        LM head runs on the response-predicting positions only.

        With the hydra branch, the live policy trunk runs up to the branch
        point (trained or frozen per ``num_layers_unfrozen``: under
        ``(0, k)`` the trunk trains and the reference drifts with it, as in
        the reference), then the frozen branch from that activation: one
        scoring costs ``n_layer`` blocks, not two full passes."""
        self.forwards += 1
        Q = self.query_length
        ids = torch.cat([q_ids, r_ids], 1)
        mask = torch.cat([q_mask, r_mask.to(q_mask.dtype)], 1)
        if self.use_hydra:
            trunk = self.model.transformer(
                ids, attention_mask=mask, capture_hidden_at=self.branch_start
            )
            out = self.ref(
                ids, attention_mask=mask, start_layer=self.branch_start,
                hidden_override=trunk["branch_hidden"], compute_logits=False,
            )
        else:
            out = self.ref(ids, attention_mask=mask, compute_logits=False)
        logits = self.ref.logits(out["hidden"][:, Q - 1 : -1])
        return logprobs_from_logits(logits, r_ids)

    @torch.no_grad()
    def compute_rewards(self, logprobs, ref_logprobs, response_mask, scores) -> torch.Tensor:
        """The chunk's stored rewards (:meth:`_shape_rewards`); records its
        mean sequence KL in ``mean_kl``."""
        rewards, mean_kl = self._shape_rewards(
            logprobs, ref_logprobs, response_mask, scores, self.kl_coef
        )
        self.mean_kl = float(mean_kl)
        return rewards

    def _shape_rewards(self, logprobs, ref_logprobs, response_mask, scores, kl_coef):
        """Per-token shaped rewards: -kl_coef * (logp - ref_logp), plus the
        score at each row's last real token; returns ``(rewards, mean
        sequence KL)``."""
        maskf = response_mask.float()
        kl = (logprobs - ref_logprobs) * maskf
        rewards = -kl_coef * kl
        last = (response_mask.sum(1) - 1).clamp_min(0).long()
        rows = torch.arange(rewards.shape[0], device=rewards.device)
        rewards[rows, last] += torch.as_tensor(scores, dtype=torch.float32, device=rewards.device)
        return rewards, kl.sum(1).mean()

    def _advantages_and_returns(self, mb: PPORolloutBatch):
        """``(advantages, returns)`` for the PPO loss: GAE over the stored
        values and rewards, advantages whitened."""
        method = self.config.method
        return get_advantages_and_returns(
            mb.values, mb.rewards, mb.response_mask, method.gamma, method.lam
        )

    # ------------------------------------------------------------------ #

    def _forward_logprobs_values(self, mb: PPORolloutBatch):
        """Policy forward over [query; response] -> (logprobs, values,
        entropy or None) at the response positions."""
        self.forwards += 1
        ids = torch.cat([mb.query_tokens, mb.response_tokens], 1)
        mask = torch.cat([mb.query_mask, mb.response_mask.to(mb.query_mask.dtype)], 1)
        chunk = self.config.train.training.get("logprob_chunk", 0)
        if chunk and not self.config.method.ent_coef:  # entropy needs full-vocab terms
            hidden, values = self.model.response_hidden(ids, mask, self.query_length)
            logprobs = chunked_logprobs(
                self.model.transformer.logits, hidden, mb.response_tokens, chunk
            )
            return logprobs, values.float(), None
        logits, values = self.model.response_forward(ids, mask, self.query_length)
        logprobs = logprobs_from_logits(logits, mb.response_tokens)
        entropy = policy_entropy(logits) if self.config.method.ent_coef else None
        return logprobs, values.float(), entropy

    def train_step(self, mb: PPORolloutBatch) -> Dict[str, torch.Tensor]:
        """One PPO update on a minibatch; returns its stats (device
        scalars), ``optimizer/grad_norm`` included."""
        method = self.config.method
        advantages, returns = self._advantages_and_returns(mb)
        logprobs, values, entropy = self._forward_logprobs_values(mb)
        loss, stats = ppo_loss(
            logprobs, values, mb.logprobs, mb.values, advantages, returns,
            mb.response_mask, method.cliprange, method.cliprange_value,
            method.vf_coef, ent_coef=method.ent_coef, entropy=entropy,
        )
        self.opt.zero_grad()
        loss.backward()
        stats["optimizer/grad_norm"] = self.opt.step()
        self.step += 1
        return stats

    def _record_train_time(self, seconds: float) -> None:
        if self.phase_times:  # the current phase's entry (none without an orchestrator)
            self.phase_times[-1]["train_s"] = seconds

    def _train_on(self, order: np.ndarray, ends: np.ndarray, iter_count: int,
                  total_steps: int, final_stats: Dict[str, Any]):
        """Run the updates of ``order`` ([n_updates, B] row indices) in
        turn. Update ``ends[k]`` is minibatch ``k``'s last in the pass;
        after it the KL controller advances, the loss stats of the updates
        since the previous end are checked, the minibatch is logged with
        the stats of that update, and eval, save and the ``total_steps``
        cutoff are checked (a cutoff ends the run: save, then eval).
        ``final_stats`` holds the last logged stats. Returns ``(rows,
        kl_seq, iter_count, done)``: each stat as a host array over the
        updates run, the KL coefficient on entry and after each
        minibatch, the update count, and whether the run ended."""
        train, method = self.config.train, self.config.method
        t0 = monotonic()
        pending, fetched, kl_seq, done = [], [], [self.kl_coef], False
        start = iter_count
        for u, idx in enumerate(order):
            pending.append(self.train_step(self.buffer.gather(idx)))
            if u != ends[len(kl_seq) - 1]:
                continue
            keys = list(pending[0])
            new = torch.stack(
                [torch.stack([s[k].float() for k in keys]) for s in pending]
            ).cpu().numpy()  # [updates since the previous end, stats]
            self.check_anomalies(dict(zip(keys, new.T)), start + len(fetched))
            fetched.extend(new)
            pending = []
            kl_seq.append(kl_controller_update(
                method, kl_seq[-1], self.mean_kl, train.batch_size
            ))
            self.kl_coef = kl_seq[-1]
            iter_count += method.ppo_epochs
            seconds = monotonic() - t0
            self._record_train_time(seconds)
            step_stats = {k: float(v) for k, v in zip(keys, new[-1])}
            step_stats["time/batch"] = seconds / (len(kl_seq) - 1)
            step_stats["policy/kl_coef"] = self.kl_coef
            step_stats["policy/mean_rollout_kl"] = self.mean_kl
            iv = self.intervals(iter_count)
            at_end = iter_count >= total_steps
            if iv["do_log"]:
                self.logger.log(step_stats, step=iter_count)
                final_stats.clear()
                final_stats.update(step_stats)
            if iv["do_eval"]:
                self._eval(iter_count, final_stats)
            if iv["do_save"] and not at_end:
                self.save()
            if at_end:
                self._finish(iter_count, final_stats)
                done = True
                break
        rows = {k: np.asarray([r[i] for r in fetched], np.float32) for i, k in enumerate(keys)}
        return rows, kl_seq, iter_count, done

    def _stream_eligible(self, iter_count: int) -> bool:
        """Whether the coming pass takes the streamed phase's plan: overlap
        on, at least one minibatch, and no eval/checkpoint boundary or
        ``total_steps`` cutoff strictly inside the pass."""
        train, method = self.config.train, self.config.method
        n_mb = method.num_rollouts // train.batch_size
        if not train.phase_overlap or self.orch is None or n_mb < 1:
            return False
        pass_steps = n_mb * method.ppo_epochs
        if iter_count + pass_steps > min(train.total_steps, train.epochs * pass_steps):
            return False
        return not any(
            s % train.eval_interval == 0 or s % train.checkpoint_interval == 0
            for s in (iter_count + method.ppo_epochs * k for k in range(1, n_mb))
        )

    def _collect_phase(self, iter_count: int, seed: int) -> None:
        """Collect one phase of experience into the (emptied) buffer and
        fix its update plan when the pass is eligible for one."""
        method, train = self.config.method, self.config.train
        self._phase_index += 1
        self.buffer.clear_history()
        self.reset_rollout_phase()
        self._plan = (
            make_stream_plan(method.num_rollouts, train.batch_size, method.ppo_epochs, seed)
            if self._stream_eligible(iter_count)
            else None
        )
        t0 = monotonic()
        self.orch.make_experience(method.num_rollouts, iter_count)
        self.phase_times.append({
            "phase": self._phase_index,
            "collect_s": monotonic() - t0,
            "rollout_tokens": int(self.buffer.full.response_mask.sum()),
        })

    def learn(self) -> Dict[str, Any]:
        """The PPO loop: per phase, collect ``num_rollouts`` with the
        current policy, then ``ppo_epochs`` passes of minibatch updates;
        eval and save on their intervals, and save + eval at the end."""
        train, method = self.config.train, self.config.method
        self._phase_index = -1
        if len(self.buffer) == 0 and self.orch is not None:
            self._collect_phase(0, seed=train.seed)
        n_minibatches = (
            self._plan.n_minibatches if self._plan is not None
            else max(len(self.buffer) // train.batch_size, 1)
        )
        total_steps = min(train.total_steps, train.epochs * method.ppo_epochs * n_minibatches)
        self.logger = Logger()
        return self._learn_body(total_steps, n_minibatches)

    def _learn_body(self, total_steps: int, n_minibatches: int) -> Dict[str, Any]:
        train, method = self.config.train, self.config.method
        E = method.ppo_epochs
        self.logger.log(self.evaluate(), step=0)
        iter_count = 0
        final_stats: Dict[str, Any] = {}
        for epoch in range(train.epochs):
            if self._plan is not None:
                # epoch-major: minibatch k's last update is in the last epoch
                order, n_mb = self._plan.updates(), self._plan.n_minibatches
                ends = (E - 1) * n_mb + np.arange(n_mb)
            else:
                # minibatch-major: each minibatch's E updates in a row
                order = self.buffer.minibatch_order(
                    train.batch_size, seed=train.seed + epoch, repeat=E,
                    n_minibatches=n_minibatches,
                )
                ends = np.arange(E - 1, len(order), E)
            _, _, iter_count, done = self._train_on(
                order, ends, iter_count, total_steps, final_stats
            )
            if done:
                break
            if self.orch is not None and epoch < train.epochs - 1:
                self._collect_phase(iter_count, seed=train.seed + epoch + 1)
        return final_stats

    def _eval(self, step: int, final_stats: Dict[str, Any]) -> None:
        eval_stats = self.evaluate()
        self.logger.log(eval_stats, step=step)
        final_stats.update(eval_stats)

    def _finish(self, step: int, final_stats: Dict[str, Any]) -> None:
        """The end of the run: save, then a final eval."""
        self.save()
        self._eval(step, final_stats)

    # ------------------------------------------------------------------ #

    def save(self, directory: Optional[str] = None) -> None:
        """Checkpoint the policy, optimizer, update count, KL state,
        sampling generator and orchestrator state as step ``self.step``."""
        state = {
            "model": self.model.state_dict(),
            "optimizer": self.opt.state_dict(),
            "step": self.step,
            "kl_coef": float(self.kl_coef),
            "mean_kl": float(self.mean_kl),
            "generator": self.generator.get_state(),
            # mid-phase, the per-row phase seed and cursor decide the
            # remaining rows' noise
            "rollout_phase_seed": self._rollout_phase_seed,
            "rollout_row_cursor": self._rollout_row_cursor,
        }
        if self.orch is not None:
            state["orchestrator"] = self.orch.state_dict()
        save_checkpoint(directory or self.config.train.checkpoint_dir, state, self.step)

    def load(self, directory: str) -> None:
        """Restore the latest checkpoint under ``directory``."""
        state = load_checkpoint(directory, device="cpu")
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.kl_coef = float(state["kl_coef"])
        self.mean_kl = float(state["mean_kl"])
        self.generator.set_state(state["generator"])
        self._rollout_phase_seed = state.get("rollout_phase_seed")
        self._rollout_row_cursor = int(state.get("rollout_row_cursor", 0))
        if self.orch is not None and "orchestrator" in state:
            self.orch.load_state_dict(state["orchestrator"])
