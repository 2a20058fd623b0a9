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
  ``num_layers_unfrozen`` when unset) a copy of its top blocks, ``ln_f``,
  ``wte`` and an untied head (GPT-J's ``lm_head``) only, run from the live
  policy trunk's activation at the branch point.
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
- Update schedule per phase, as the JAX package chooses it: the
  **streamed phase** when no eval/checkpoint boundary or ``total_steps``
  cutoff falls inside the pass (and ``phase_overlap`` is on, the
  default); else the minibatch-major order, one update after another.
  The streamed phase (:meth:`begin_streamed_phase`,
  :meth:`on_rollouts_landed`, :meth:`finish_streamed_phase`) fixes its
  epoch-major :class:`~trlx_tpu_torch.pipeline.ppo_buffer.StreamPlan`
  before collection, freezes a behaviour snapshot of the policy that every
  rollout forward of the phase runs on, and runs each epoch-1 minibatch
  as soon as its rows have landed, on both rollout engines, while later
  chunks still sample; epochs 2..``ppo_epochs`` follow collection. The
  updates run where the serial schedule would put them in the data, so
  an overlapped phase equals the serial run of its plan bit for bit. The
  KL controller advances once per minibatch after the phase (it feeds
  only the next collection).
- ``train.async_rl`` (:mod:`trlx_tpu_torch.trainer.async_rl`) runs the
  streamed phase as an actor-learner schedule on the continuous engine:
  the version-lag guard decides when an epoch-1 minibatch may run, and
  after each one a copy of the refreshed policy is pushed to the engine
  mid-generation.
- ``train.rollout_param_cast`` (default on), when the compute dtype is
  not the parameters' dtype: the sampler, the continuous engine and the
  hydra trunk run on a compute-dtype copy of the policy
  (:func:`~trlx_tpu_torch.utils.compute_dtype_cast`, :meth:`rollout_model`),
  made on first use after the last update (so once per collect) and
  dropped by each update and by ``load``; the frozen reference is cast
  once, for good. Every op already rounds its weights to the compute
  dtype per use, so the outputs are bit-identical; ``fc2``, the MoE
  router and the layer norms keep their f32 masters. The seq2seq trainer
  keeps its masters, as the JAX package's does.
- A ``gpt2_moe`` policy's update adds the router's load-balancing penalty
  (:func:`~trlx_tpu_torch.models.gpt2_moe.apply_router_penalty`) to the
  loss and its stats, from the losses the switch layers collect in that
  forward only; ``logprob_chunk`` is off for it, as in the JAX package.
- ``save`` writes through :mod:`trlx_tpu_torch.utils.checkpoint`: under
  ``train.async_checkpoint`` it returns once the state is in host memory
  and the write runs on a thread, which ``learn`` joins at its end and
  ``load`` before it reads; two steps are kept. ``learn`` resumes from the
  newest checkpoint under ``train.resume_from_checkpoint``, and at each
  pass boundary, before the next collect, runs the preemption drain
  (:meth:`~trlx_tpu_torch.trainer.BaseRLTrainer.maybe_drain`); GRPO and
  seq2seq PPO inherit both.
- ``train.mesh`` of more than one rank (one process per rank, started
  by :func:`~trlx_tpu_torch.parallel.distributed.initialize`): dp, fsdp
  and tp training (:meth:`_shard_models`). The policy, the value head,
  the frozen reference and the optimizer state are sharded by the
  family's JAX partition rules (:mod:`~trlx_tpu_torch.parallel.partition`);
  each rank samples its rows of every global chunk (:meth:`sample`: the
  generator draws the global chunk's noise, so a rank's rows draw what a
  one-process run draws), scores its reference, decodes, and the reward
  function sees each row once, on its data shard's first rank; the chunk
  is then gathered to every rank (:meth:`gather_scored`,
  :meth:`gather_sample`), so that reward scaling, shaping, GRPO's group
  whitening and the store are the global ones, and every rank takes its
  rows of each global minibatch in the same order. The loss and its
  stats read the global token count, the data group's gradients are
  summed, and the clip reads the global norm. A checkpoint holds the
  one-device layout (rank 0 writes, every rank reads its shards).
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

import contextlib
import copy
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.method_configs import GRPOConfig
from trlx_tpu_torch.data.ppo_types import PPORolloutBatch, SampleOutput
from trlx_tpu_torch.inference import RolloutEngineConfig
from trlx_tpu_torch.models.gpt2_moe import (
    apply_router_penalty,
    collect_moe_losses,
    moe_loss_summary,
)
from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
from trlx_tpu_torch.models.registry import get_model_family, load_arch
from trlx_tpu_torch.ops.ppo_math import (
    get_advantages_and_returns,
    kl_controller_update,
    policy_entropy,
    ppo_loss,
    reward_health_stats,
)
from trlx_tpu_torch.ops.sampling import (
    GenerationConfig,
    make_sampler,
    validate_gen_config,
)
from trlx_tpu_torch.parallel import collectives
from trlx_tpu_torch.parallel.distributed import barrier, is_main_process
from trlx_tpu_torch.pipeline.ppo_buffer import (
    PPORolloutBuffer,
    StreamPlan,
    make_stream_plan,
)
from trlx_tpu_torch.telemetry.device_metrics import phase_memory_stats
from trlx_tpu_torch.telemetry.profiler import PhaseProfiler, start_trace, stop_trace
from trlx_tpu_torch.trainer import BaseRLTrainer, refuse_unported, register_trainer
from trlx_tpu_torch.trainer.async_rl import AsyncRLConfig, guard_allows
from trlx_tpu_torch.trainer.common import freeze_layers, make_optimizer
from trlx_tpu_torch.utils import (
    behaviour_snapshot,
    chunked_logprobs,
    compute_dtype_cast,
    logprobs_from_logits,
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
    wait_for_checkpoints,
)
from trlx_tpu_torch.utils.logging import Logger


class _StreamedPhase:
    """Host state of one streamed phase: the plan, the cursor over its
    epoch-1 minibatches, their stats (device tensors until the phase
    closes) and the clock marks the overlap stats come from."""

    def __init__(self, plan: StreamPlan, overlap: bool):
        self.plan = plan
        self.overlap = overlap
        self.next_mb = 0  # epoch-1 minibatches run so far
        self.epoch1_stats: List[Dict[str, torch.Tensor]] = []
        self.t_first_dispatch: Optional[float] = None
        self.dispatched_during_collect = 0


class _AsyncStreamedPhase(_StreamedPhase):
    """The actor-learner phase's extra state: the learner's version, the
    staleness and consumption lag of each epoch-1 minibatch, the time
    row-ready minibatches waited behind the guard, the learner's busy
    time and the weight-push count. The plan is the streamed phase's:
    async decides when its updates run and what the engine decodes with,
    never which rows they take."""

    def __init__(self, plan: StreamPlan, overlap: bool):
        super().__init__(plan, overlap)
        self.learner_version = 0
        self.staleness: List[int] = []  # in-flight lag after each update
        self.consumed_lag: List[int] = []  # the rows' age when trained
        self.weight_pushes = 0
        self.guard_hold_ms = 0.0
        self.t_guard_hold: Optional[float] = None
        self.learner_busy_ms = 0.0
        self.t_begin = monotonic()
        # set before the closing drain: rows still in flight then (an
        # over-submitted harvest group) never land in this plan, so they
        # neither count as staleness nor earn a push
        self.collect_done = False


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

    #: trains under a mesh of more than one rank (``refuse_mesh``)
    supports_mesh = True
    #: the policy's and the reference's shards under a mesh
    shards = ref_shards = None

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
        refuse_unported(config, self)
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
        # the actors are the continuous engine; on one device they share
        # it with the learner whatever actor_fraction says
        self.async_config = AsyncRLConfig.from_dict(train.training.get("async_rl"))
        if self.async_config.enabled:
            self._validate_async_rl()
        self.device = resolve_device(device)
        self.mesh = self._make_mesh()
        if tokenizer is None and config.model.tokenizer_path:
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(
                config.model.tokenizer_path, local_files_only=True
            )
            if self.tokenizer.pad_token_id is None:
                self.tokenizer.pad_token = self.tokenizer.eos_token

        self._rollout_module = None
        self._behavior_model = None  # the streamed phase's snapshot
        self.rollout_cast_refreshes = 0
        self._setup_model()
        self.opt = make_optimizer(train, train.total_steps, self.model.parameters())
        if self.shards is not None:
            self.opt.grad_sq_sum = self.shards.grad_sq_sum
        self.generator = set_seed(train.seed, self.device)  # sampling noise
        self._checkpoints = CheckpointWriter()

        gen_kwargs = dict(method.gen_kwargs)
        self.apply_tokenizer_gen_defaults(gen_kwargs)
        self._amend_gen_kwargs(gen_kwargs)
        self.gen_config = GenerationConfig.from_dict(gen_kwargs)
        if self.rollout_config.rows_per_row_rng:
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
        self._health_phase = -1  # phase ids when the phase API runs outside learn
        self._stream: Optional[_StreamedPhase] = None
        self._last_stream_seed = 0
        self._last_overlap_stats: Dict[str, float] = {}
        # the single-phase profiler window (train.profile_phase), built
        # again by learn; and the legacy first-updates trace's profiler
        # (train.profile_dir alone) while it runs
        self._phase_profiler = PhaseProfiler(None, None)
        self._profiling = None
        self._rollout_engine_obj = None
        # a checkpoint's drafter state, applied when the engine is built
        self._drafter_state: Optional[Dict[str, Any]] = None
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
        self.rollout_config.check_model(self.model_config)
        self.model = CausalLMWithValueHead(
            self.model_config, self.family.backbone_cls, device=self.device
        )
        init_params(self.model, config.train.seed)
        if backbone is not None:
            self.model.transformer.load_state_dict(backbone)
        self._setup_reference(self.model.transformer, self.model_config.n_layer)
        freeze_layers(self.model, config.model.num_layers_unfrozen, self.model_config.n_layer)
        self._shard_models()

    # ------------------------------ the mesh ----------------------------- #

    def _make_mesh(self):
        """The mesh of ``train.mesh`` over the process group's ranks: a
        :class:`~trlx_tpu_torch.parallel.mesh.MeshGroups`, or ``None`` for
        a world of one rank. A mesh that asks for another number of ranks
        than the world has raises, naming the launch it needs."""
        import math

        import torch.distributed as dist

        from trlx_tpu_torch.parallel.mesh import MeshGroups, mesh_sizes
        from trlx_tpu_torch.trainer import requested_mesh

        train = self.config.train
        asked = requested_mesh(self.config)
        fixed = math.prod(v for v in asked.values() if v != -1)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if (world % fixed if -1 in asked.values() else world != fixed):
            raise ValueError(
                f"train.mesh={train.training.get('mesh')} needs {fixed} ranks, the world "
                f"has {world}: launch one process per rank (torchrun --nproc_per_node "
                f"{fixed}), or set the mesh to the world"
            )
        sizes = mesh_sizes(train.training.get("mesh"), world)
        return None if world == 1 else MeshGroups(sizes)

    def _shard_models(self) -> None:
        """Under a mesh: the policy's and the reference's placements from
        the family's partition rules, their tensor-parallel forwards, and
        each parameter cut to this rank's shard (``shards``,
        ``ref_shards``; ``None`` on one rank)."""
        self.shards = self.ref_shards = None
        if self.mesh is None:
            return
        from trlx_tpu_torch.parallel.partition import (
            apply_tensor_parallel,
            make_shardings,
            shard_params,
        )

        def shard(module):
            placements = make_shardings(module, self.mesh.sizes, self.family.partition_rules,
                                        self.family.tp_fused)
            return shard_params(module, apply_tensor_parallel(module, placements, self.mesh),
                                self.mesh)

        self.shards, self.ref_shards = shard(self.model), shard(self.ref)

    def _unsharded(self, shards, grad: bool = False):
        """``shards``' fsdp-gathered context (a no-op on one rank)."""
        return contextlib.nullcontext() if shards is None else shards.unsharded(grad=grad)

    @property
    def _copy_gather(self):
        """The rollout copies' ``gather`` under a mesh (each policy
        parameter cast, then fsdp-gathered), else ``None``."""
        if self.shards is None:
            return None
        return lambda name, p, dtype=None: self.shards.gathered(name, p, dtype=dtype)

    @property
    def data_group(self):
        """The data group (dp x fsdp) under a mesh, else ``None``."""
        return None if self.mesh is None else self.mesh.data_group

    def local_rows(self, x):
        """This rank's rows of a global batch ``x`` (a tensor or a list)."""
        return x if self.mesh is None or x is None else x[self.mesh.rows(len(x))]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch from every data shard's rows ``x``."""
        return x if self.mesh is None else self.mesh.gather_rows(x)

    def gather_sample(self, out: SampleOutput) -> SampleOutput:
        return out if self.mesh is None else SampleOutput(
            **{f: self.mesh.gather_rows(getattr(out, f))
               for f in ("tokens", "response_mask", "logprobs", "values")})

    @property
    def scores_here(self) -> bool:
        """Whether the reward function runs on this rank: every rank on
        one, else the first rank of each data shard."""
        return self.mesh is None or self.mesh.is_data_leader

    def gather_scored(self, scores, texts):
        """``(scores, texts)`` of the global chunk from each data shard's
        scoring rank (the reward function saw each row once)."""
        if self.mesh is None:
            return scores, texts
        shards = self.mesh.gather_data_objects((scores, texts))
        return (np.concatenate([s for s, _ in shards]),
                [t for _, ts in shards for t in ts])

    def _all_finished(self, finished: torch.Tensor) -> bool:
        """The sampler's early exit under a mesh: every rank's rows done."""
        return bool(collectives.all_reduce(finished.all().to(torch.int64),
                                           self.mesh.world_group, "min"))

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
        if self.rollout_cast_dtype is not None:
            # inference-only: cast once, for good (half its memory)
            compute_dtype_cast(self.ref, self.rollout_cast_dtype, in_place=True)
        self._rollout_module = None

    # ------------------- rollout-phase weight precision ------------------ #

    def _supports_rollout_cast(self) -> bool:
        """Whether the policy's outputs are bit-identical on compute-dtype
        weights (every op casts per use; the seq2seq trainer's T5 does not
        qualify in the JAX package, and keeps its masters here too)."""
        return True

    @property
    def rollout_cast_dtype(self) -> Optional[torch.dtype]:
        """The dtype the rollout phase's weights are cast to, or ``None``
        when ``train.rollout_param_cast`` is off, the trainer keeps its
        masters, or the compute dtype is the parameters' dtype."""
        if not self._supports_rollout_cast():
            return None
        return rollout_cast_dtype(self.config.train, self.model_config)

    def rollout_model(self) -> torch.nn.Module:
        """The policy the rollout phase runs: while a streamed phase is
        open, its behaviour snapshot (the masters change under it);
        otherwise the compute-dtype copy when the cast is on (made from
        the masters on first use after the last update or ``load``;
        ``rollout_cast_refreshes`` counts the copies, snapshots
        included), else the policy itself."""
        if self._behavior_model is not None:
            return self._behavior_model
        if self.rollout_cast_dtype is None and self.shards is None:
            return self.model
        if self._rollout_module is None:
            # under a mesh, a copy whose fsdp shards are gathered (each cast
            # first): the policy the rollout forwards run, tp-local
            self._rollout_module = compute_dtype_cast(self.model, self.rollout_cast_dtype,
                                                      gather=self._copy_gather)
            self.rollout_cast_refreshes += 1
        return self._rollout_module

    def _drop_rollout_cast(self) -> None:
        """The masters are about to change: the copy is stale, and through
        the update it is dead weight at the memory peak."""
        self._rollout_module = None

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

    @property
    def _cache_kw(self) -> Dict[str, int]:
        """The KV cache's tensor-parallel head split, under tp > 1."""
        tp = 1 if self.mesh is None else self.mesh.size("tp")
        return {"tp": tp} if tp > 1 else {}

    def _make_sampler(self):
        return make_sampler(
            self._apply,
            functools.partial(self.family.init_cache, self.model_config, device=self.device,
                              **self._cache_kw),
            self.gen_config,
            self.query_length,
        )

    def _rebuild_sampler(self) -> None:
        self._sampler = self._make_sampler()
        self._rollout_engine_obj = None  # built again on the new gen_config

    def _apply(self, *args, params=None, **kwargs):
        """One rollout forward: of ``params`` (a policy the engine was
        pushed), else of :meth:`rollout_model`."""
        self.forwards += 1
        return (params if params is not None else self.rollout_model())(*args, **kwargs)

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
            self.gen_config = dataclasses.replace(self.gen_config, max_new_tokens=new)
            self._rebuild_sampler()

    def add_eval_pipeline(self, pipeline) -> None:
        super().add_eval_pipeline(pipeline)
        self.bind_prompt_budget(pipeline, role="eval")

    def sample(self, prompt_ids, prompt_mask) -> SampleOutput:
        """Roll out a prompt batch with the current policy (under per-row
        RNG, as the phase's next rows). Under a mesh ``prompt_ids`` is the
        global batch and this rank samples its rows of it, drawing their
        noise as a one-process run of the whole batch would."""
        per_row = {}
        B = prompt_ids.shape[0]
        rows = slice(0, B) if self.mesh is None else self.mesh.rows(B)
        if self.gen_config.per_row_rng:
            per_row = {"rows": self.take_rows(B)[rows],
                       "phase_seed": self.rollout_phase_seed()}
        if self.mesh is not None:
            per_row["shard"] = (rows.start, B, self._all_finished)
        return self._sampler(
            prompt_ids[rows].to(self.device), prompt_mask[rows].to(self.device),
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

    def _validate_async_rl(self) -> None:
        """``train.async_rl`` needs the continuous engine (whose own checks
        refuse seq2seq and grouped sampling) and ``phase_overlap``."""
        if self.rollout_engine != "continuous":
            raise ValueError(
                "train.async_rl.enabled requires train.rollout.engine: "
                "'continuous' — the asynchronous actors run the "
                "slot-admission engine (docs/async_pipeline.md); add "
                "rollout: {engine: continuous} or disable async_rl"
            )
        if not self.config.train.phase_overlap:
            raise ValueError(
                "train.async_rl.enabled requires train.phase_overlap: "
                "true (the streamed landing hook is how the async "
                "learner consumes rollouts); drop phase_overlap: false "
                "or disable async_rl"
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
            drafter = self._rollout_engine_obj.spec_drafter
            if self._drafter_state is not None and drafter is not None:
                drafter.load_state_dict(self._drafter_state)
            self._drafter_state = None
        return self._rollout_engine_obj

    def _build_rollout_engine(self):
        """The engine over the trainer's rollout policy (the fixed
        sampler's, :meth:`rollout_model`, its forwards counted) and the family's
        KV cache: ``rollout.slots`` slots, else one per chunk rollout, with
        the rollout section's chunked prefill and speculative decoding."""
        from trlx_tpu_torch.inference.engine import ContinuousBatchingEngine

        cfg = self.rollout_config
        chunk = int(getattr(self.config.method, "chunk_size", 0) or self.config.train.batch_size)
        spec = cfg.spec_decode
        spec_on = spec is not None and spec.enabled
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
            prefill_chunk=cfg.prefill_chunk,
            prefill_chunks_per_pump=cfg.prefill_chunks_per_pump,
            # the trainer has no prefix pool, so spec_decode.drafter: trie
            # is the per-row n-gram drafter here, as in the reference
            spec_max_draft=spec.max_draft if spec_on else 0,
            spec_min_accept_ewma=spec.min_accept_ewma if spec_on else 0.0,
            model_config=self.model_config,
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
        with self._unsharded(self.ref_shards):
            if self.use_hydra:
                trunk = self.rollout_model().transformer(
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
            mb.values, mb.rewards, mb.response_mask, method.gamma, method.lam,
            group=self.data_group,
        )

    # ------------------------------------------------------------------ #

    def _forward_logprobs_values(self, mb: PPORolloutBatch):
        """Policy forward over [query; response] -> (logprobs, values,
        entropy or None) at the response positions."""
        self.forwards += 1
        ids = torch.cat([mb.query_tokens, mb.response_tokens], 1)
        mask = torch.cat([mb.query_mask, mb.response_mask.to(mb.query_mask.dtype)], 1)
        chunk = self.config.train.training.get("logprob_chunk", 0)
        # entropy needs full-vocab terms; an MoE forward collects its
        # router losses once, not per recomputed chunk
        if chunk and not self.config.method.ent_coef and not self.family.is_moe:
            hidden, values = self.model.response_hidden(ids, mask, self.query_length)
            logprobs = chunked_logprobs(
                self.model.transformer.logits, hidden, mb.response_tokens, chunk
            )
            return logprobs, values.float(), None
        logits, values = self.model.response_forward(ids, mask, self.query_length)
        logprobs = logprobs_from_logits(logits, mb.response_tokens)
        # also under health at ent_coef=0: the entropy-collapse detector's
        # series (the loss reads it only with a bonus coefficient)
        entropy = (policy_entropy(logits)
                   if self.config.method.ent_coef or self._health_enabled else None)
        return logprobs, values.float(), entropy

    def train_step(self, mb: PPORolloutBatch) -> Dict[str, torch.Tensor]:
        """One PPO update on a minibatch; returns its stats (device
        scalars), ``optimizer/grad_norm`` included. Under a mesh ``mb`` is
        the global minibatch: this rank trains on its rows, the policy's
        fsdp shards gathered through the forward and the backward, and
        the gradients summed over the data group before the step."""
        method = self.config.method
        self._drop_rollout_cast()
        local = mb if self.mesh is None else PPORolloutBatch(**{
            f.name: getattr(mb, f.name)[self.mesh.rows(mb.batch_size)]
            for f in dataclasses.fields(mb)})
        advantages, returns = self._advantages_and_returns(local)
        with self._unsharded(self.shards, grad=True):
            with collect_moe_losses(self.model) as moe:
                logprobs, values, entropy = self._forward_logprobs_values(local)
            loss, stats = ppo_loss(
                logprobs, values, local.logprobs, local.values, advantages, returns,
                local.response_mask, method.cliprange, method.cliprange_value,
                method.vf_coef, ent_coef=method.ent_coef, entropy=entropy,
                health=self._health_enabled, health_ev=self._health_ev,
                group=self.data_group,
            )
            if self.family.is_moe:
                loss, stats = apply_router_penalty(
                    loss, stats, moe_loss_summary(moe), self.model_config
                )
            self.opt.zero_grad()
            # inside the context: a chunked head recomputes on the gathered weights
            loss.backward()
        if self.shards is not None:
            self.shards.sync_grads(self.opt.params)
        stats["optimizer/grad_norm"] = self.opt.step()
        if self._health_enabled:
            # the shaped returns' distribution, an output of the step only
            stats.update(reward_health_stats(mb.rewards, mb.response_mask))
        self.step += 1
        return stats

    def _record_train_time(self, seconds: float) -> None:
        if self.phase_times:  # the current phase's entry (none without an orchestrator)
            self.phase_times[-1]["train_s"] = seconds

    # ------------------------- the streamed phase ------------------------ #

    @property
    def health_phase_id(self) -> int:
        """The phase id of health events and flight records: ``learn``'s
        phase counter, else (the phase API called outside ``learn``) the
        count of streamed phases begun."""
        return self._phase_index if self._phase_index >= 0 else self._health_phase

    def begin_streamed_phase(self, seed: int = 0, num_rollouts: Optional[int] = None,
                             overlap: Optional[bool] = None) -> _StreamedPhase:
        """Open a streamed phase: fix the plan of ``num_rollouts``
        (default ``method.num_rollouts``) from ``seed``, put the buffer in
        stream mode, start a fresh per-row noise phase and take the
        behaviour snapshot every rollout forward of the phase runs on.
        ``overlap`` (default ``train.phase_overlap``) ``False`` runs the
        same plan serially, every update at :meth:`finish_streamed_phase`;
        under ``train.async_rl`` any other value opens the actor-learner
        phase."""
        if self._stream is not None:
            raise RuntimeError(
                "a streamed phase is already active; finish_streamed_phase "
                "(or abort_streamed_phase after an error) before beginning "
                "another"
            )
        method, train = self.config.method, self.config.train
        total = int(num_rollouts if num_rollouts is not None else method.num_rollouts)
        plan = make_stream_plan(total, train.batch_size, method.ppo_epochs, seed)
        self.buffer.clear_history()
        self.buffer.begin_stream(plan.total)
        self._health_phase += 1
        self._last_stream_seed = seed  # the engine fallback begins the phase again
        self.reset_rollout_phase()
        # the snapshot owns its tensors (with the cast off the policy
        # itself would be the masters, which the epoch-1 updates step in
        # place); the lazy cast copy is not needed beside it
        self._rollout_module = None
        self._behavior_model = behaviour_snapshot(self.model, self.rollout_cast_dtype,
                                                  gather=self._copy_gather)
        if self.rollout_cast_dtype is not None:
            self.rollout_cast_refreshes += 1
        phase_cls = (_AsyncStreamedPhase
                     if self.async_config.enabled and overlap is not False else _StreamedPhase)
        self._stream = phase_cls(
            plan, overlap=train.phase_overlap if overlap is None else bool(overlap))
        return self._stream

    def on_rollouts_landed(self) -> None:
        """The orchestrator's hook after each landing: run every epoch-1
        minibatch whose rows now exist (none outside a streamed phase or
        in its serial mode)."""
        st = self._stream
        if st is None or not st.overlap:
            return
        self._dispatch_ready_minibatches()

    def _dispatch_ready_minibatches(self, force: bool = False) -> None:
        """Run the ready epoch-1 minibatches in plan order (``force``: all
        the plan still owes, at the phase's close). Under async the
        version-lag guard may hold them back while rows are in flight.
        Their stats stay on the device; nothing here reads the device."""
        st = self._stream
        plan = st.plan
        is_async = isinstance(st, _AsyncStreamedPhase)
        landed = len(self.buffer)
        while st.next_mb < plan.n_minibatches and (force or plan.ready(st.next_mb, landed)):
            if is_async and not force:
                engine = self._rollout_engine_obj
                inflight = engine.min_inflight_version() if engine is not None else None
                if not guard_allows(st.learner_version, inflight,
                                    self.async_config.staleness_window):
                    if st.t_guard_hold is None:
                        st.t_guard_hold = monotonic()
                    return
            if is_async and st.t_guard_hold is not None:
                st.guard_hold_ms += (monotonic() - st.t_guard_hold) * 1000.0
                st.t_guard_hold = None
            # one span per epoch-1 update: during collection it nests
            # inside phase/collect (via collect/land), which is how the
            # trace shows what overlapped; forced, since its start is the
            # overlap window's mark
            with telemetry.span("train/epoch1_dispatch", force=True,
                                minibatch=st.next_mb) as sp:
                stats = self.train_step(self.buffer.gather(plan.epoch1[st.next_mb]))
            if st.t_first_dispatch is None:
                st.t_first_dispatch = sp.start
            st.epoch1_stats.append(stats)
            st.next_mb += 1
            if is_async:
                self._after_async_update(st, plan, sp.duration_ms)

    def _after_async_update(self, st: _AsyncStreamedPhase, plan: StreamPlan,
                            busy_ms: float) -> None:
        """After one epoch-1 update of the actor-learner phase: record its
        consumption lag (the learner's version minus the oldest version
        among the minibatch's rows), advance the learner's version, record
        the in-flight staleness after the update and, while the engine
        still has rows pending, push it a copy of the refreshed policy
        (applied at its next safe point). Once collection has closed, no
        push: nothing in flight can land in this plan, and a push would
        only perturb the next phase; that is also why the
        ``staleness_window: 0`` phase stays bitwise serial."""
        consumed = plan.epoch1[st.next_mb - 1]
        st.consumed_lag.append(
            int(st.learner_version - int(self.buffer.row_versions(consumed).min())))
        st.learner_version += 1
        st.learner_busy_ms += busy_ms
        if st.collect_done:
            st.staleness.append(0)
            return
        engine = self._rollout_engine_obj
        inflight = engine.min_inflight_version() if engine is not None else None
        st.staleness.append(0 if inflight is None
                            else max(0, st.learner_version - int(inflight)))
        if engine is None or not engine.pending:
            return
        with telemetry.span("async/weight_push", force=True,
                            version=st.learner_version) as push_sp:
            # a copy taken now: the masters go on changing before the safe point
            engine.push_weights(behaviour_snapshot(self.model, self.rollout_cast_dtype),
                                version=st.learner_version)
        st.weight_pushes += 1
        st.learner_busy_ms += push_sp.duration_ms

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finish_streamed_phase(self):
        """Close the open streamed phase: run what the plan still owes
        (every epoch-1 minibatch in serial mode, then epochs
        2..``ppo_epochs``), advance the KL controller once per minibatch
        and return ``(n_updates, rows, kl_seq)``: each stat as an
        [n_updates] host array in execution order (epoch-major) and the KL
        coefficient on entry and after each minibatch. Records
        ``_last_overlap_stats`` (the ``exp/overlap_*`` stats, the
        ``mem/*`` allocator gauges, and the ``async/*`` stats under async),
        absorbs them into the metrics registry, and feeds run health every
        row, then the phase row (the rollout KL, and ``async/staleness``,
        the ``staleness-breach`` series), then the phase's flight record.

        Its timing is span-sourced: ``phase/train`` around everything
        after collection, ``train/drain`` (what the host still waits for
        of epoch 1 after collection, all of it in serial mode) and
        ``train/residual`` (epochs 2..``ppo_epochs``), each forced, so
        that the stats hold with the tracer off; their durations are
        ``exp/overlap_drain_ms`` and ``exp/phase_residual_ms``."""
        st = self._stream
        if st is None:
            raise RuntimeError("no streamed phase is active")
        method, train = self.config.method, self.config.train
        plan = st.plan
        is_async = isinstance(st, _AsyncStreamedPhase)
        if is_async:
            st.collect_done = True
        residual_ms = 0.0
        residual_stats = []
        with telemetry.span("phase/train", force=True, updates=plan.n_updates) as train_sp:
            t_collect_end = train_sp.start
            st.dispatched_during_collect = st.next_mb
            with telemetry.span("train/drain", force=True) as drain_sp:
                self._dispatch_ready_minibatches(force=True)
                self._sync_device()
            drain_ms = drain_sp.duration_ms
            # the snapshot and any weights the engine was pushed are dead
            # weight through the remaining epochs
            self._behavior_model = None
            if self._rollout_engine_obj is not None:
                self._rollout_engine_obj.drop_weights()
            if plan.residual.size:
                with telemetry.span("train/residual", force=True) as res_sp:
                    residual_stats = [self.train_step(self.buffer.gather(idx))
                                      for idx in plan.residual]
                    self._sync_device()
                residual_ms = res_sp.duration_ms
            # one device-to-host copy for every stat of the phase
            pending = st.epoch1_stats + residual_stats
            keys = sorted(pending[0])
            fetched = torch.stack(
                [torch.stack([s[k].float() for k in keys]) for s in pending]).cpu().numpy()
        rows = {k: np.asarray(fetched[:, i], np.float32) for i, k in enumerate(keys)}
        kl_seq = [float(self.kl_coef)]
        for _ in range(plan.n_minibatches):
            kl_seq.append(kl_controller_update(
                method, kl_seq[-1], self.mean_kl, train.batch_size))
        self.kl_coef = kl_seq[-1]

        window_ms = (max(0.0, (t_collect_end - st.t_first_dispatch) * 1000.0)
                     if st.t_first_dispatch is not None else 0.0)
        if method.ppo_epochs > 1 and residual_ms > 0.0:
            # one epoch's serial cost, estimated from the residual epochs
            saved_ms = max(0.0, residual_ms / (method.ppo_epochs - 1) - drain_ms)
        else:
            saved_ms = max(0.0, window_ms - drain_ms)
        self._last_overlap_stats = {
            "exp/overlap_saved_ms": saved_ms,
            "exp/overlap_drain_ms": drain_ms,
            "exp/overlap_window_ms": window_ms,
            "exp/overlap_streamed_updates": float(st.dispatched_during_collect),
            "exp/phase_residual_ms": residual_ms,
        }
        # the allocator's live and peak bytes beside the phase's timing
        # (empty on the CPU)
        self._last_overlap_stats.update(phase_memory_stats())
        staleness_max: Optional[float] = None
        if is_async:
            st.learner_busy_ms += residual_ms
            staleness = np.asarray(st.staleness or [0], np.float64)
            lag = np.asarray(st.consumed_lag or [0], np.float64)
            wall_ms = max((monotonic() - st.t_begin) * 1000.0, 1e-9)
            staleness_max = float(staleness.max())
            engine = self._rollout_engine_obj
            self._last_overlap_stats.update({
                "async/staleness_p50": float(np.percentile(staleness, 50)),
                "async/staleness_max": staleness_max,
                "async/consumed_lag_p50": float(np.percentile(lag, 50)),
                "async/consumed_lag_max": float(lag.max()),
                "async/weight_pushes": float(st.weight_pushes),
                "async/guard_hold_ms": st.guard_hold_ms,
                "async/learner_idle_ms": drain_ms + st.guard_hold_ms,
                "async/learner_occupancy": min(st.learner_busy_ms / wall_ms, 1.0),
                "async/actor_occupancy": engine.stats.slot_util if engine is not None else 0.0,
            })
        # closed before the detectors read the rows, so that an abort
        # policy raising there leaves the trainer re-enterable
        self._stream = None
        telemetry.get_metrics().absorb(self._last_overlap_stats)
        if self.health_monitor is not None:
            phase_id = self.health_phase_id
            phase_row: Dict[str, Any] = {"policy/mean_rollout_kl": float(self.mean_kl)}
            if staleness_max is not None:
                phase_row["async/staleness"] = staleness_max
            last_row: Dict[str, Any] = {}
            try:
                last_row = self.observe_health_rows(rows, phase=phase_id, phase_row=phase_row)
            finally:
                self.record_flight_phase(phase_id, stats_row=last_row, kl_seq=kl_seq)
        return plan.n_updates, rows, kl_seq

    def abort_streamed_phase(self) -> None:
        """Drop an open streamed phase without running its remaining
        updates (error recovery): the plan, the behaviour snapshot, the
        engine's pushed and staged weights, and the buffer's partial
        experience. Epoch-1 updates already run are not rolled back."""
        self._stream = None
        self._behavior_model = None
        if self._rollout_engine_obj is not None:
            self._rollout_engine_obj.drop_weights()
        self.buffer.clear_history()

    # ------------------------------ the loop ----------------------------- #

    def _train_on(self, order: np.ndarray, ends: np.ndarray, iter_count: int,
                  total_steps: int, final_stats: Dict[str, Any], health_pass=None):
        """Run one pass's updates and its boundaries. With a streamed
        phase open, the pass is the phase's plan (``order`` and ``ends``
        describe it): :meth:`finish_streamed_phase` runs what it still
        owes, then each minibatch is logged with the stats of its last
        update (in the last epoch). Otherwise the updates of ``order``
        ([n_updates, B] row indices) run in turn; update ``ends[k]`` is
        minibatch ``k``'s last in the pass, after which the KL controller
        advances, the loss stats of the updates since the previous end are
        checked and the minibatch is logged with the stats of that update.
        Eval, save and the ``total_steps`` cutoff are checked after each
        minibatch (a cutoff ends the run: save, then eval). ``final_stats``
        holds the last logged stats. Returns ``(rows, kl_seq, iter_count,
        done)``: each stat as a host array over the updates run, the KL
        coefficient on entry and after each minibatch, the update count,
        and whether the run ended.

        Run health reads the fetched rows as the JAX package's paths do:
        the streamed phase observes every row at its close; ``"fused"``
        (a minibatch-major pass no eval/save boundary or cutoff splits)
        observes every update's row at its update number, then the
        phase's rollout KL once and the phase's flight record; ``None``
        (the stepwise path) observes each logged, saved or final
        minibatch's last row at its update number, then the KL and the
        flight record at the pass's end. Rows are observed before the
        non-finite check, so a NaN row reaches the detectors first.

        A fused pass runs inside a ``phase/train`` span that closes before
        its last minibatch's boundaries, as the JAX package's single
        dispatch does; the profiler window closes there too (after the
        pass on the stepwise path), and the legacy first-updates trace
        stops at the first minibatch end at or past update 10."""
        if self._stream is not None:
            return self._finish_streamed_pass(iter_count, total_steps, final_stats)
        with contextlib.ExitStack() as fused_span:
            if health_pass is not None:
                fused_span.enter_context(
                    telemetry.span("phase/train", force=True, updates=len(order)))
            train, method = self.config.train, self.config.method
            t0 = monotonic()
            pending, fetched, kl_seq, done = [], [], [self.kl_coef], False
            start = iter_count
            monitor = self.health_monitor
            for u, idx in enumerate(order):
                pending.append(self.train_step(self.buffer.gather(idx)))
                if u != ends[len(kl_seq) - 1]:
                    continue
                keys = sorted(pending[0])
                new = torch.stack(
                    [torch.stack([s[k].float() for k in keys]) for s in pending]
                ).cpu().numpy()  # [updates since the previous end, stats]
                if monitor is not None and health_pass is not None:
                    self.observe_health_rows(dict(zip(keys, new.T)), step0=start + len(fetched),
                                             phase=self._phase_index)
                self.check_anomalies(dict(zip(keys, new.T)), start + len(fetched))
                fetched.extend(new)
                pending = []
                kl_seq.append(kl_controller_update(
                    method, kl_seq[-1], self.mean_kl, train.batch_size
                ))
                self.kl_coef = kl_seq[-1]
                iter_count += method.ppo_epochs
                if self._profiling is not None and iter_count >= 10:
                    stop_trace(self._profiling, self._legacy_trace_path(), self.device)
                    self._profiling = None
                seconds = monotonic() - t0
                self._record_train_time(seconds)
                step_stats = {k: float(v) for k, v in zip(keys, new[-1])}
                step_stats["time/batch"] = seconds / (len(kl_seq) - 1)
                step_stats["policy/kl_coef"] = self.kl_coef
                step_stats["policy/mean_rollout_kl"] = self.mean_kl
                iv = self.intervals(iter_count)
                at_end = iter_count >= total_steps
                if monitor is not None and health_pass is None and (
                        iv["do_log"] or iv["do_save"] or at_end):
                    # the phase-constant rollout KL is observed once, at the end
                    self.observe_health(
                        {k: v for k, v in step_stats.items() if k != "policy/mean_rollout_kl"},
                        step=iter_count, phase=self._phase_index)
                if health_pass is not None and len(kl_seq) > len(ends):
                    if monitor is not None:
                        self.observe_health({"policy/mean_rollout_kl": self.mean_kl},
                                            phase=self._phase_index)
                        self.record_flight_phase(self._phase_index, step=iter_count,
                                                 stats_row=step_stats, kl_seq=kl_seq)
                    fused_span.close()
                    self._phase_profiler.on_phase_end(self.device)
                done = self._boundaries(iter_count, total_steps, step_stats, final_stats)
                if done:
                    break
            if monitor is not None and health_pass is None and not done:
                # the stepwise pass's end: the rollout KL once, then the record
                self.observe_health({"policy/mean_rollout_kl": self.mean_kl},
                                    step=iter_count, phase=self._phase_index)
                self.record_flight_phase(self._phase_index, step=iter_count,
                                         stats_row=step_stats)
        if health_pass is None:
            self._phase_profiler.on_phase_end(self.device)
        rows = {k: np.asarray([r[i] for r in fetched], np.float32) for i, k in enumerate(keys)}
        return rows, kl_seq, iter_count, done

    def _finish_streamed_pass(self, iter_count: int, total_steps: int,
                              final_stats: Dict[str, Any]):
        """:meth:`_train_on` for an open streamed phase: close it, then
        log each minibatch with the stats of its last update (row
        ``(ppo_epochs - 1) * n_minibatches + k``), the phase's overlap
        stats beside them, and check the boundaries."""
        E = self.config.method.ppo_epochs
        t0 = monotonic()
        n_up, rows, kl_seq = self.finish_streamed_phase()
        seconds = monotonic() - t0
        self._record_train_time(seconds)
        # the phase's updates are done and fetched: close the window here
        # (the boundaries below hold the end-of-run save and eval)
        self._phase_profiler.on_phase_end(self.device)
        self.check_anomalies(rows, iter_count)
        n_mb, done = n_up // E, False
        for k in range(n_mb):
            iter_count += E
            step_stats = {key: float(v[(E - 1) * n_mb + k]) for key, v in rows.items()}
            step_stats["time/batch"] = seconds / n_mb
            step_stats["policy/kl_coef"] = kl_seq[k + 1]
            step_stats["policy/mean_rollout_kl"] = self.mean_kl
            step_stats.update(self._last_overlap_stats)
            done = self._boundaries(iter_count, total_steps, step_stats, final_stats)
            if done:
                break
        return rows, kl_seq, iter_count, done

    def _boundaries(self, iter_count: int, total_steps: int, step_stats: Dict[str, Any],
                    final_stats: Dict[str, Any]) -> bool:
        """A minibatch's end: log, eval and save on their intervals, and
        at ``total_steps`` the end of the run (save, then eval). Returns
        whether the run ended."""
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
        return at_end

    def _stream_eligible(self, iter_count: int) -> bool:
        """Whether the coming pass runs as a streamed phase: overlap on,
        an orchestrator, at least one minibatch, no legacy profiler trace
        (``profile_dir`` without ``profile_phase``: the first updates'
        trace needs the minibatch-major path; a ``profile_phase`` window
        profiles the streamed phase itself), and no eval/checkpoint
        boundary or ``total_steps`` cutoff strictly inside the pass."""
        train, method = self.config.train, self.config.method
        training = train.training
        legacy_profile = training.get("profile_dir") and training.get("profile_phase") is None
        n_mb = method.num_rollouts // train.batch_size
        if not train.phase_overlap or self.orch is None or legacy_profile or n_mb < 1:
            return False
        pass_steps = n_mb * method.ppo_epochs
        if iter_count + pass_steps > min(train.total_steps, train.epochs * pass_steps):
            return False
        return not any(
            s % train.eval_interval == 0 or s % train.checkpoint_interval == 0
            for s in (iter_count + method.ppo_epochs * k for k in range(1, n_mb))
        )

    def _collect_phase(self, iter_count: int, seed: int) -> None:
        """Collect one phase of experience into the (emptied) buffer:
        through a streamed phase when the pass is eligible for one (its
        epoch-1 updates may run during collection); a failure aborts the
        phase, so that a retry starts clean."""
        method = self.config.method
        self._phase_index += 1
        # the profiler window, if it is for this phase, opens before any
        # of the phase's device work
        self._phase_profiler.on_phase_start(self._phase_index)
        self.buffer.clear_history()
        self.reset_rollout_phase()
        if self._stream_eligible(iter_count):
            self.begin_streamed_phase(seed=seed)
        t0 = monotonic()
        try:
            self.orch.make_experience(method.num_rollouts, iter_count)
        except BaseException:
            if self._stream is not None:
                self.abort_streamed_phase()
            raise
        self.phase_times.append({
            "phase": self._phase_index,
            "collect_s": monotonic() - t0,
            "rollout_tokens": int(self.buffer.full.response_mask.sum()),
        })

    def learn(self) -> Dict[str, Any]:
        """The PPO loop: per phase, collect ``num_rollouts`` with the
        current policy, then ``ppo_epochs`` passes of minibatch updates;
        eval and save on their intervals, and save + eval at the end.

        Under ``train.resume_from_checkpoint`` with a checkpoint on disk it
        first loads the newest one: a finished run returns ``{}`` without
        collecting; a run resumed at update ``s`` continues the schedule
        the uninterrupted run would follow (the checkpoint is taken on a
        pass boundary, as the drain and the end-of-pass saves take it):
        epoch ``s // pass_steps``, collected with that epoch's seed
        ``train.seed + epoch``, and no step-0 eval, which the
        uninterrupted run did not make there and whose sampling would move
        the generator. An error aborts an open streamed phase.

        ``train.profile_phase: N`` profiles phase N (counted from 0, the
        first collect) into ``train.profile_dir``; ``profile_dir`` alone
        traces the first updates. The run's manifest goes to the run
        ledger at the end (``status`` ``ok`` or ``error``) when
        ``train.run_dir`` or ``$TRLX_RUN_LEDGER`` is set."""
        train, method = self.config.train, self.config.method
        if train.resume_from_checkpoint and has_checkpoint(train.checkpoint_dir):
            self.load(train.checkpoint_dir)
            if self.step >= train.total_steps:
                self._final_stats = {}
                return {}  # a finished run: nothing to collect or train
        training = train.training
        # built before the first collection, so that phase 0 is profileable
        self._phase_profiler = PhaseProfiler(training.get("profile_dir"),
                                             training.get("profile_phase"), self.device)
        self._phase_index = -1
        start_step = self.step
        pass_steps = method.ppo_epochs * max(method.num_rollouts // train.batch_size, 1)
        self._epoch0 = start_step // pass_steps
        if len(self.buffer) == 0 and self.orch is not None:
            try:
                self._collect_phase(start_step, seed=train.seed + self._epoch0)
            except BaseException:
                self._phase_profiler.close()  # a phase-0 window is open
                raise
        # a streamed phase schedules its plan's rows; a non-dividing final
        # chunk's extra rows are stored but never trained
        n_minibatches = (
            self._stream.plan.n_minibatches if self._stream is not None
            else max(len(self.buffer) // train.batch_size, 1)
        )
        total_steps = min(train.total_steps, train.epochs * method.ppo_epochs * n_minibatches)
        self.logger = Logger(enabled=is_main_process())
        try:
            result = self._learn_body(total_steps, n_minibatches, start_step)
        except BaseException as e:
            if self._stream is not None:
                self.abort_streamed_phase()
            # crash forensics: one flight dump on the way down (no-op with
            # health off; none again after an abort's own dump)
            self.flight_dump_on_exception(e)
            # a failed run is history too: its manifest records the error
            self.append_run_ledger(status="error", error=e)
            raise
        else:
            self.append_run_ledger(status="ok")
            return result
        finally:
            # every exit stops a live profiler (the phase window and the
            # legacy trace), then joins an asynchronous end save, which ran
            # beside the final eval
            try:
                self._phase_profiler.close()
                if self._profiling is not None:
                    prof, self._profiling = self._profiling, None
                    stop_trace(prof, self._legacy_trace_path(), self.device)
            finally:
                self._checkpoints.wait()

    def _legacy_trace_path(self) -> str:
        import os

        return os.path.join(self.config.train.training["profile_dir"],
                            "first_updates.pt.trace.json")

    def _learn_body(self, total_steps: int, n_minibatches: int,
                    start_step: int = 0) -> Dict[str, Any]:
        train, method = self.config.train, self.config.method
        E = method.ppo_epochs
        if start_step == 0:
            # with a streamed phase open the sampler runs its behaviour
            # snapshot: the policy from before the phase's updates
            self.logger.log(self.evaluate(), step=0)
        iter_count = start_step
        final_stats: Dict[str, Any] = {}
        self._final_stats = final_stats  # filled in place as the run logs
        if iter_count >= total_steps:
            return final_stats
        training = train.training
        if training.get("profile_dir") and training.get("profile_phase") is None:
            # the legacy trace: the first updates from here (a
            # profile_phase window traces one whole phase instead)
            self._profiling = start_trace(self.device)
        for epoch in range(self._epoch0, train.epochs):
            if self._stream is not None:
                # epoch-major: minibatch k's last update is in the last epoch
                plan = self._stream.plan
                order, n_mb = plan.updates(), plan.n_minibatches
                ends = (E - 1) * n_mb + np.arange(n_mb)
                health_pass = "streamed"
            else:
                # minibatch-major: each minibatch's E updates in a row
                order = self.buffer.minibatch_order(
                    train.batch_size, seed=train.seed + epoch, repeat=E,
                    n_minibatches=n_minibatches,
                )
                ends = np.arange(E - 1, len(order), E)
                health_pass = "fused" if self._profiling is None and self._whole_pass(
                    iter_count, total_steps, n_minibatches) else None
            _, _, iter_count, done = self._train_on(
                order, ends, iter_count, total_steps, final_stats, health_pass
            )
            if done:
                break
            if self.orch is not None and epoch < train.epochs - 1:
                # the preemption drain point: after this boundary's eval and
                # save (the saved generator has the eval's draws), before
                # the next phase's collection
                self.maybe_drain(phase=self._phase_index, step=iter_count)
                self._collect_phase(iter_count, seed=train.seed + epoch + 1)
        return final_stats

    def _whole_pass(self, iter_count: int, total_steps: int, n_minibatches: int) -> bool:
        """Whether a minibatch-major pass is one the JAX package runs as a
        single fused dispatch (no eval or save boundary and no
        ``total_steps`` cutoff inside it), which decides where run health
        reads its rows (:meth:`_train_on`)."""
        train, E = self.config.train, self.config.method.ppo_epochs
        interior = [iter_count + E * k for k in range(1, n_minibatches)]
        return (len(self.buffer) >= train.batch_size
                and iter_count + E * n_minibatches <= total_steps
                and not any(s % train.eval_interval == 0
                            or (s > 0 and s % train.checkpoint_interval == 0)
                            for s in interior))

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
        sampling generator and orchestrator state as step ``self.step``
        (on a thread under ``train.async_checkpoint``), inside a
        ``phase/checkpoint`` span."""
        with telemetry.span("phase/checkpoint"):
            state = {
                "model": self._full_model_state(),
                "optimizer": self._full_opt_state(),
                "step": self.step,
                "kl_coef": float(self.kl_coef),
                "mean_kl": float(self.mean_kl),
                "generator": self.generator.get_state(),
            }
            if self.orch is not None:
                state["orchestrator"] = self.orch.state_dict()
            host = self.host_state_dict()
            if host:
                state["host"] = host
            if not is_main_process():
                return  # rank 0 writes the one-device layout
            self._checkpoints.save(
                directory or self.config.train.checkpoint_dir, state, self.step,
                async_save=bool(self.config.train.training.get("async_checkpoint", False)),
            )

    def _full_model_state(self) -> Dict[str, torch.Tensor]:
        """The policy's state dict in the one-device layout."""
        return self.model.state_dict() if self.shards is None else self.shards.full_state_dict()

    def _full_opt_state(self) -> Dict[str, Any]:
        """The optimizer's state with its moments in the one-device layout."""
        state = self.opt.state_dict()
        if self.shards is None:
            return state
        return self._map_opt_state(state, self.shards.full_tensor, "local")

    def _map_opt_state(self, state: Dict[str, Any], fn, shape_of: str) -> Dict[str, Any]:
        """``state`` (:class:`~trlx_tpu_torch.trainer.common.ClippedAdamW`'s)
        with ``fn(name, moment)`` applied to each per-parameter moment of
        the ``shape_of`` (``"local"`` or ``"full"``) shape."""
        adamw = dict(state.get("adamw") or {})
        moments = {}
        for idx, entry in (adamw.get("state") or {}).items():
            p = self.opt.params[int(idx)]
            name = self.shards.names[id(p)]
            shape = (tuple(p.shape) if shape_of == "local"
                     else self.shards.placements[name].full_shape)
            moments[idx] = {k: (fn(name, v) if torch.is_tensor(v) and tuple(v.shape) == shape
                                and v.dim() > 0 else v) for k, v in entry.items()}
        if "state" in adamw:
            adamw["state"] = moments
        return {**state, "adamw": adamw} if "adamw" in state else state

    def host_state_dict(self) -> Dict[str, Any]:
        """The base trainer's host state, plus what the rollouts carry
        across a checkpoint: the per-row phase seed (drawn from the
        sampling generator; the counterpart of the JAX trainer's
        ``rollout_phase_key``) and draw cursor, which decide every remaining
        row's noise mid-phase (at a phase boundary they are None and 0),
        and the continuous engine's drafter state (its accept EWMAs and
        probe counters decide whether a row drafts at all)."""
        state = super().host_state_dict()
        state["rollout_phase_seed"] = self._rollout_phase_seed
        state["rollout_row_cursor"] = int(self._rollout_row_cursor)
        drafter = getattr(self._rollout_engine_obj, "spec_drafter", None)
        if drafter is not None:
            state["spec_drafter"] = drafter.state_dict()
        elif self._drafter_state is not None:  # loaded, engine not built yet
            state["spec_drafter"] = self._drafter_state
        return state

    def load_host_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_host_state_dict(state)
        state = state or {}
        self._rollout_phase_seed = state.get("rollout_phase_seed")
        self._rollout_row_cursor = int(state.get("rollout_row_cursor", 0))
        drafter_state = state.get("spec_drafter")
        if drafter_state is not None and self.rollout_engine == "continuous":
            drafter = getattr(self._rollout_engine_obj, "spec_drafter", None)
            if drafter is not None:
                drafter.load_state_dict(drafter_state)
            else:  # applied when the engine is built
                self._drafter_state = drafter_state

    def load(self, directory: str) -> None:
        """Restore the newest checkpoint under ``directory`` (after every
        write in flight has landed); a checkpoint of another freezing
        layout raises the ``ValueError`` that names it."""
        if self.mesh is not None:
            # rank 0's write has landed before any rank reads
            wait_for_checkpoints()
            barrier()
        state = load_checkpoint(directory, device="cpu")
        self._drop_rollout_cast()
        with translate_structure_errors(directory):
            model_state, opt_state = state["model"], state["optimizer"]
            if self.shards is not None:
                model_state = self.shards.local_state_dict(model_state)
                opt_state = self._map_opt_state(opt_state, self.shards.local_tensor, "full")
            self.model.load_state_dict(model_state)
            self.opt.load_state_dict(opt_state)
        self.step = int(state["step"])
        self.kl_coef = float(state["kl_coef"])
        self.mean_kl = float(state["mean_kl"])
        self.generator.set_state(state["generator"])
        if self.orch is not None and "orchestrator" in state:
            self.orch.load_state_dict(state["orchestrator"])
        self.load_host_state_dict(state.get("host"))
