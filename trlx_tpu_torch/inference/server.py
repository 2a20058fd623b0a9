"""Multi-tenant serving over the continuous-batching engine (counterpart of
:mod:`trlx_tpu.inference.server`).

Request lifecycle: ``submit`` left-pads, types and enqueues with the QoS
scheduler (host); the serving pump moves scheduler picks into engine slots
as they vacate; ``flush``/``wait`` run the pump to completion; results
(tokens, logprobs, values and the latency decomposition) are kept until
``pop_result``/``wait`` hands them out. ``submit(..., stream=True)`` opens
a per-request token queue fed by the engine's per-step tap.

The weights, in order: explicit ``params``, then the policy of a port
trainer checkpoint (``checkpoint_dir``), then a converted HF checkpoint
(``model.model_path``, whose ``config.json`` also gives the architecture),
then random weights from the seed. Serving is causal-only, as in the
reference.

Not yet ported (later slices): the shared-prefix pool
(``serving.prefix_cache_blocks > 0`` raises), speculative decoding
and chunked prefill (refused by
:class:`~trlx_tpu_torch.inference.RolloutEngineConfig`), the health
monitor, request tracing and the ``serve/*`` histograms.
"""

from __future__ import annotations

import functools
import itertools
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.serving.scheduler import DEFAULT_TENANT
from trlx_tpu_torch.utils import monotonic, resolve_device


class InferenceServer:
    """Submit/poll multi-tenant batched generation against a policy.

    :param config: :class:`TRLConfig` (or its dict form): ``model`` picks
        the architecture (``model_arch``), ``method.gen_kwargs`` the
        generation parameters, ``train.rollout`` the engine geometry,
        ``train.serving`` the QoS/streaming section.
    :param params: optional state dict of the policy
        (:class:`~trlx_tpu_torch.models.heads.CausalLMWithValueHead` names;
        :func:`trlx_tpu_torch.models.convert.flax_to_torch` carries the JAX
        package's params across). Without it (and without
        ``checkpoint_dir``) the backbone comes from ``model.model_path``,
        else random from ``seed``, and the value head from ``seed``.
    :param seed: seeds the random weights and the sampling noise.
    :param device: ``None`` means CUDA (raises without it).
    :param tokenizer: optional tokenizer for string prompts.
    :param checkpoint_dir: a port trainer's ``checkpoint_dir``: the policy
        (key ``"model"``) of its latest checkpoint is served.
    :param serving: optional dict overriding ``train.serving``.
    """

    def __init__(
        self,
        config: Union[TRLConfig, Dict[str, Any]],
        params: Optional[Mapping[str, Any]] = None,
        seed: int = 0,
        device=None,
        tokenizer=None,
        checkpoint_dir: Optional[str] = None,
        serving: Optional[Dict[str, Any]] = None,
    ):
        from trlx_tpu_torch.inference import RolloutEngineConfig
        from trlx_tpu_torch.inference.engine import ContinuousBatchingEngine
        from trlx_tpu_torch.models.gpt2 import torch_dtype
        from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
        from trlx_tpu_torch.models.registry import get_model_family, load_arch
        from trlx_tpu_torch.ops.sampling import (
            GenerationConfig,
            validate_gen_config,
        )
        from trlx_tpu_torch.serving import ServingConfig
        from trlx_tpu_torch.serving.scheduler import build_scheduler
        from trlx_tpu_torch.serving.streaming import StreamRouter
        from trlx_tpu_torch.utils.checkpoint import load_checkpoint

        self.device = resolve_device(device)
        if not isinstance(config, TRLConfig):
            config = TRLConfig.from_dict(config)
        self.config = config
        train = config.train
        self.family = get_model_family(config.model.model_type)
        self.model_config, backbone = load_arch(self.family, config.model, train)
        self.model = CausalLMWithValueHead(
            self.model_config, self.family.backbone_cls, device=self.device
        )
        if params is not None:
            self.model.load_state_dict(
                {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
            )
        elif checkpoint_dir is not None:
            self.model.load_state_dict(load_checkpoint(checkpoint_dir, device="cpu")["model"])
        else:
            init_params(self.model, seed)
            if backbone is not None:
                self.model.transformer.load_state_dict(backbone)
        # serve a compute-dtype copy of the weights: every op casts its
        # parameters to the compute dtype per use, so casting once is
        # exact; the value head's last layer computes in f32 and stays
        compute = torch_dtype(self.model_config.dtype)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if not name.startswith("v_head.fc2."):
                    p.data = p.data.to(compute)
        self.model.eval()

        self.tokenizer = tokenizer
        if tokenizer is None and config.model.tokenizer_path:
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(
                config.model.tokenizer_path, local_files_only=True
            )

        gen_kwargs = dict(config.method.gen_kwargs)
        self.gen_config = GenerationConfig.from_dict(gen_kwargs)
        validate_gen_config(
            self.gen_config, self.model_config.vocab_size,
            provided=set(gen_kwargs),
        )
        self.query_length = train.seq_length
        total = self.query_length + self.gen_config.max_new_tokens
        if total > self.model_config.n_positions:
            raise ValueError(
                f"seq_length + max_new_tokens = {total} exceeds the model's "
                f"n_positions={self.model_config.n_positions}"
            )

        rollout = RolloutEngineConfig.from_dict(train.rollout)
        num_slots = rollout.slots or int(
            getattr(config.method, "chunk_size", 0) or train.batch_size
        )
        self.serving_config = ServingConfig.from_dict(
            serving if serving is not None else train.serving
        )
        if self.serving_config.prefix_cache_blocks > 0:
            raise NotImplementedError(
                "serving.prefix_cache_blocks > 0: the shared-prefix pool "
                "comes with the serving-tier slice"
            )
        self.engine = ContinuousBatchingEngine(
            apply_fn=self.model,
            init_cache_fn=functools.partial(
                self.family.init_cache, self.model_config, device=self.device
            ),
            gen_config=self.gen_config,
            query_length=self.query_length,
            vocab_size=self.model_config.vocab_size,
            num_slots=num_slots,
            admit_width=rollout.admit_width,
            harvest_width=rollout.harvest_width,
            block_size=rollout.block_size,
            done_poll_interval=rollout.poll_interval,
            device=self.device,
        )
        self.engine.start_phase(seed)
        self.scheduler = build_scheduler(self.serving_config)
        self._router = StreamRouter(maxlen=self.serving_config.stream_buffer)
        self._requests: Dict[int, Any] = {}  # request_id -> Request
        self._row_to_req: Dict[int, int] = {}  # engine row -> request_id
        self._req_row: Dict[int, int] = {}  # request_id -> engine row
        self._streams: Dict[int, Any] = {}  # rid -> TokenStream
        self._results: Dict[int, Dict[str, Any]] = {}
        self._open: Dict[int, bool] = {}
        self._next_request = itertools.count()

    # ------------------------------ API -------------------------------- #

    def _encode(self, prompt) -> List[int]:
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompts require a tokenizer")
            return list(self.tokenizer.encode(prompt))
        return [int(t) for t in prompt]

    def _pad_prompt(self, toks: List[int], i: int):
        Q = self.query_length
        if not toks:
            raise ValueError(f"prompt {i} is empty")
        if len(toks) > Q:
            raise ValueError(f"prompt {i} has {len(toks)} tokens > seq_length={Q}")
        V = self.model_config.vocab_size
        if min(toks) < 0 or max(toks) >= V:
            raise ValueError(f"prompt {i} has token ids outside [0, {V})")
        ids = np.full((Q,), self.gen_config.pad_token_id, np.int64)
        mask = np.zeros((Q,), np.int64)
        ids[Q - len(toks):] = toks  # left-pad, as the trainer does
        mask[Q - len(toks):] = 1
        return ids, mask

    def submit(
        self,
        prompts: Sequence[Any],
        tenant: str = DEFAULT_TENANT,
        priority: Optional[int] = None,
        slo_class: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        stream: bool = False,
    ) -> List[int]:
        """Enqueue prompts (strings with a tokenizer, or token-id lists)
        with the QoS scheduler; returns request ids. The whole batch is
        validated before anything is enqueued."""
        from trlx_tpu_torch.serving.scheduler import Request
        from trlx_tpu_torch.serving.streaming import TokenStream

        tenant_cfg = self.scheduler.tenant_config(tenant)
        prio = tenant_cfg.priority if priority is None else int(priority)
        slo = tenant_cfg.slo_class if slo_class is None else slo_class
        now = monotonic()
        reqs = []
        for i, p in enumerate(prompts):
            ids, mask = self._pad_prompt(self._encode(p), i)
            req = Request(
                request_id=next(self._next_request),
                tenant=tenant,
                prompt_ids=ids,
                prompt_mask=mask,
                priority=prio,
                slo_class=slo,
                max_tokens=self.engine.R,
                deadline=(
                    now + deadline_ms / 1000.0 if deadline_ms is not None else None
                ),
                stream=bool(stream),
                cost=float(int(mask.sum()) + self.engine.R),
                submitted_at=now,
            )
            self.scheduler.validate(req)
            reqs.append(req)
        rids = []
        for req in reqs:
            rid = req.request_id
            self.scheduler.submit(req)
            self._requests[rid] = req
            self._open[rid] = True
            if stream:
                self._streams[rid] = TokenStream(
                    rid, maxlen=self.serving_config.stream_buffer,
                    pump=self._pump_once,
                )
            rids.append(rid)
        return rids

    def stream(self, request_id: int):
        """The :class:`~trlx_tpu_torch.serving.streaming.TokenStream` of a
        ``stream=True`` request (pumps the serving loop as needed)."""
        s = self._streams.get(request_id)
        if s is None:
            raise KeyError(
                f"request {request_id} was not submitted with stream=True"
            )
        return s

    # --------------------------- serving pump --------------------------- #

    def _engine_submit(self, batch) -> None:
        """Move scheduler picks into the engine's admission queue."""
        rows = self.engine.submit(
            np.stack([req.prompt_ids for req in batch]),
            np.stack([req.prompt_mask for req in batch]),
            submit_times=[req.submitted_at for req in batch],
        )
        for row, req in zip(rows, batch):
            self._row_to_req[row] = req.request_id
            self._req_row[req.request_id] = row
            if req.stream:
                s = self._streams.get(req.request_id)
                if s is not None:
                    self._router.attach(row, s)

    def _submit_placeholders(self, n: int) -> None:
        """Pad the engine queue with ``n`` release-on-admission rows so the
        final partial harvest group fills (each costs one decode step)."""
        Q = self.query_length
        ids = np.full((n, Q), self.gen_config.pad_token_id, np.int64)
        mask = np.zeros((n, Q), np.int64)
        mask[:, Q - 1] = 1
        self.engine.submit(ids, mask, release=True)

    def _pump_once(self) -> bool:
        """One serving iteration: feed the engine from the scheduler,
        advance decode a step, land harvested groups. Returns whether
        anything progressed."""
        engine = self.engine
        free = engine.free_capacity
        if free > 0 and self.scheduler.has_work():
            batch = self.scheduler.next_batch(free)
            if batch:
                self._engine_submit(batch)
        Hw = engine.harvest_width
        if not self.scheduler.has_work() and engine.pending and engine.pending % Hw:
            self._submit_placeholders(Hw - engine.pending % Hw)
        # the tap costs a per-step fetch: only pay while someone streams
        engine.token_sink = self._router.on_tokens if self._router.active else None
        busy_before = engine.pending
        groups = engine.pump()
        for group in groups:
            self._land_group(group)
        return bool(groups) or busy_before > 0

    def _land_group(self, group) -> None:
        mask = group["response_mask"]
        for j, row in enumerate(group["rows"]):
            timing = self.engine.pop_request_timing(row)
            rid = self._row_to_req.pop(row, None)
            stream = self._router.pop(row)
            if stream is not None:
                stream.close()
            if rid is None or not self._open.get(rid):
                continue  # placeholder / already-closed row
            length = int(mask[j].sum())
            self._results[rid] = {
                "tokens": group["tokens"][j, :length].tolist(),
                "length": length,
                "tenant": self._requests[rid].tenant,
                "logprobs": group["logprobs"][j, :length].tolist(),
                "values": group["values"][j, :length].tolist(),
                "timing": timing,
            }
            if self.tokenizer is not None:
                self._results[rid]["text"] = self.tokenizer.decode(
                    self._results[rid]["tokens"], skip_special_tokens=True
                )
            self._open[rid] = False

    def flush(self) -> int:
        """Drive the serving loop until every submitted request has
        completed; returns the number of newly completed requests."""
        open_before = [r for r, o in self._open.items() if o]
        while any(self._open.get(r) for r in open_before):
            if not self._pump_once():
                if self.scheduler.has_work():
                    time.sleep(0.002)  # quota-throttled tenants refill
                else:
                    raise RuntimeError(
                        "serving pump stalled with open requests but "
                        "nothing pending — request bookkeeping bug"
                    )
        return sum(1 for r in open_before if not self._open.get(r))

    def poll(self, request_id: int) -> Optional[Dict[str, Any]]:
        """Completed result for ``request_id`` (None while in flight)."""
        return self._results.get(request_id)

    def pop_result(self, request_id: int) -> Optional[Dict[str, Any]]:
        row = self._req_row.pop(request_id, None)
        if row is not None:
            self._router.close(row)
        self._open.pop(request_id, None)
        self._requests.pop(request_id, None)
        self._streams.pop(request_id, None)
        return self._results.pop(request_id, None)

    def wait(self, request_ids: Sequence[int]) -> Dict[int, Dict[str, Any]]:
        """Drive until every id has a result; returns and pops them."""
        if any(r not in self._results for r in request_ids):
            self.flush()
        still = [r for r in request_ids if r not in self._results]
        if still:
            raise RuntimeError(
                f"requests {still} did not complete — were they submitted?"
            )
        return {r: self.pop_result(r) for r in request_ids}

    def generate(self, prompts: Sequence[Any], **submit_kwargs) -> List[Dict[str, Any]]:
        """Blocking convenience: submit + wait, results in prompt order."""
        rids = self.submit(prompts, **submit_kwargs)
        done = self.wait(rids)
        return [done[r] for r in rids]

    def stats(self) -> Dict[str, float]:
        """Engine counters (cumulative) plus scheduler accounting."""
        out = self.engine.stats.to_dict()
        out["scheduler/admitted"] = float(self.scheduler.admitted)
        out["scheduler/pending"] = float(self.scheduler.pending)
        out["scheduler/throttled_rounds"] = float(self.scheduler.throttled_rounds)
        return out
