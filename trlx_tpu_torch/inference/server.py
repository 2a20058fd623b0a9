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

The serving features, as in the reference: ``serving.prefix_cache_blocks
> 0`` builds the shared-prefix pool (:class:`PrefixBlockPool`: a plan per
admitted request, released at completion); ``rollout.prefill_chunk`` and
``prefill_chunks_per_pump`` chunk the admission prefill; an enabled
``rollout.spec_decode`` drafts with the trie drafter bound to the pool (or
the n-gram drafter). ``model.model_arch.kv_cache_dtype`` (``int8``, or
``auto`` at the engine's capacity) gives an int8 cache and an int8 pool.
The engine's spans and ``engine/*`` gauges land in the port's tracer and
metrics registry (:mod:`trlx_tpu_torch.telemetry`), and so does the serving
tier's own telemetry, as in the reference:

- every completed request feeds the ``serve/*`` latency histograms and
  their per-tenant twins (:func:`observe_request_metrics`); the QoS
  scheduler is built over that registry, so a tenant whose queue-wait p95
  nears its SLO class budget is boosted; :meth:`InferenceServer.metrics`
  is the ``serve/*`` slice of the snapshot;
- a :class:`~trlx_tpu_torch.telemetry.health.HealthMonitor` watches each
  harvest group (non-finite logprobs or values trip ``nan-precursor``, a
  tenant's queue-wait p95 over its budget trips ``slo-breach``);
- with the tracer enabled, every completed row emits its request's span
  chain (:mod:`trlx_tpu_torch.telemetry.request_trace`) from the
  scheduler's, the engine's and the stream's marks; disabled, nothing is
  collected.
"""

from __future__ import annotations

import functools
import itertools
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.serving.scheduler import DEFAULT_TENANT, tenant_metric_key
from trlx_tpu_torch.telemetry.request_trace import emit_request_trace, mint_trace_id
from trlx_tpu_torch.utils import compute_dtype_cast, monotonic, resolve_device
from trlx_tpu_torch.utils.retry import retry_call

#: the per-request latency histograms every served request feeds: the
#: series QoS scheduling reads and the smokes assert
SERVE_HISTOGRAMS = (
    "serve/queue_wait_ms",
    "serve/prefill_ms",
    "serve/ttft_ms",
    "serve/decode_per_token_ms",
    "serve/e2e_ms",
)


def observe_request_metrics(
    registry,
    timing: Dict[str, float],
    tokens: int,
    tenant: Optional[str] = None,
) -> None:
    """Feed one completed request's timing decomposition (the ``timing`` of
    :meth:`~trlx_tpu_torch.inference.engine.ContinuousBatchingEngine.pop_request_record`)
    into the latency histograms: queue wait, prefill, time to first token,
    per-token decode (``decode_ms`` over the generated token count),
    end to end. With ``tenant`` given each observation also lands in the
    tenant-labelled twin (``serve/queue_wait_ms[tenant=acme]``), so
    per-tenant SLOs can be asserted, not just aggregates."""
    values = {
        "serve/queue_wait_ms": timing.get("queue_wait_ms", 0.0),
        "serve/prefill_ms": timing.get("prefill_ms", 0.0),
        "serve/ttft_ms": timing.get("ttft_ms", 0.0),
        "serve/decode_per_token_ms": timing.get("decode_ms", 0.0) / max(1, int(tokens)),
        "serve/e2e_ms": timing.get("e2e_ms", 0.0),
    }
    for key, value in values.items():
        registry.histogram(key).observe(value)
        if tenant is not None:
            registry.histogram(tenant_metric_key(key, tenant)).observe(value)
    registry.counter("serve/requests_completed").inc()
    if tenant is not None:
        registry.counter(tenant_metric_key("serve/requests_completed", tenant)).inc()


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
        from trlx_tpu_torch.serving import PrefixBlockPool, ServingConfig, TrieDrafter
        from trlx_tpu_torch.serving.scheduler import build_scheduler
        from trlx_tpu_torch.serving.streaming import StreamRouter
        from trlx_tpu_torch.telemetry.health import HealthConfig, HealthMonitor
        from trlx_tpu_torch.utils.checkpoint import load_checkpoint

        self.device = resolve_device(device)
        if not isinstance(config, TRLConfig):
            config = TRLConfig.from_dict(config)
        self.config = config
        train = config.train
        self.family = get_model_family(config.model.model_type)
        self.model_config, backbone = load_arch(self.family, config.model, train)
        rollout = RolloutEngineConfig.from_dict(train.rollout)
        rollout.check_model(self.model_config)
        # built in param_dtype: with bfloat16 the policy is made in bf16 on
        # the device directly (no f32 copy at any time); the value head's
        # last layer computes in f32 and is kept in f32 in either build
        self.model = CausalLMWithValueHead(
            self.model_config, self.family.backbone_cls, device=self.device
        )
        self.model.v_head.fc2.float()
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
        # serve the weights cast to the compute dtype once, by the rule the
        # trainers' rollout cast follows (the same leaves stay f32), so a
        # server loaded from a trainer's checkpoint gives its outputs
        compute_dtype_cast(self.model, torch_dtype(self.model_config.dtype), in_place=True)
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

        num_slots = rollout.slots or int(
            getattr(config.method, "chunk_size", 0) or train.batch_size
        )
        self.serving_config = ServingConfig.from_dict(
            serving if serving is not None else train.serving
        )
        spec = rollout.spec_decode
        spec_on = spec is not None and spec.enabled
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
            prefix_pool_blocks=self.serving_config.prefix_cache_blocks,
            prefill_chunk=rollout.prefill_chunk,
            prefill_chunks_per_pump=rollout.prefill_chunks_per_pump,
            spec_max_draft=spec.max_draft if spec_on else 0,
            spec_min_accept_ewma=spec.min_accept_ewma if spec_on else 0.0,
            model_config=self.model_config,
            device=self.device,
        )
        self.prefix_pool = (
            PrefixBlockPool(
                self.serving_config.prefix_cache_blocks,
                self.engine.block_size,
                self.engine.n_blocks,
            )
            if self.serving_config.prefix_cache_blocks > 0
            else None
        )
        if spec_on and spec.drafter == "trie" and self.engine.spec_max_draft:
            # the pool's published chains become the global draft corpus
            # (pool=None, sharing off, keeps pure n-gram drafting)
            self.engine.spec_drafter = TrieDrafter(
                pool=self.prefix_pool,
                max_draft=self.engine.spec_max_draft,
                min_accept_ewma=spec.min_accept_ewma,
            )
        self.engine._admit_listener = self._on_admitted
        self.engine.start_phase(seed)
        # the span ring's capacity (train.telemetry.ring_size): request
        # traces multiply span volume, so the ring is sized before traffic
        telemetry.configure_from_dict(train.training.get("telemetry"))
        self._registry = telemetry.get_metrics()
        # request tracing: with the tracer enabled the engine logs the
        # decode cadence and done marks; disabled, the host loop's
        # per-step cost stays as it was
        self.engine.trace_requests = telemetry.get_tracer().enabled
        self.scheduler = build_scheduler(self.serving_config, registry=self._registry)
        self._router = StreamRouter(maxlen=self.serving_config.stream_buffer)
        # generation-health watch: non-finite logprobs/values in a served
        # group trip nan-precursor, a tenant's queue-wait p95 over its SLO
        # budget trips slo-breach; zero events is healthy serving
        self.health_monitor = HealthMonitor(HealthConfig.from_dict({"enabled": True}))
        self._requests: Dict[int, Any] = {}  # request_id -> Request
        # Requests kept until their row harvests: pop_result may drop
        # _requests mid-flight, but an abandoned request's span chain must
        # still close when its row completes
        self._trace_reqs: Dict[int, Any] = {}
        self._plan_windows: Dict[int, Tuple[float, float]] = {}  # rid -> (t0, t1)
        self._row_to_req: Dict[int, int] = {}  # engine row -> request_id
        self._req_row: Dict[int, int] = {}  # request_id -> engine row
        self._acquired: Dict[int, List[int]] = {}  # rid -> pool blocks
        self._published_by_row: Dict[int, List[int]] = {}
        self._streams: Dict[int, Any] = {}  # rid -> TokenStream
        self._results: Dict[int, Dict[str, Any]] = {}
        self._open: Dict[int, bool] = {}
        self._next_request = itertools.count()
        self.completion_order: List[int] = []
        self._groups_served = 0

    # ------------------------------ API -------------------------------- #

    @property
    def health_events(self) -> List[Any]:
        return list(self.health_monitor.events)

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
        tracing = telemetry.get_tracer().enabled
        reqs = []
        for i, p in enumerate(prompts):
            ids, mask = self._pad_prompt(self._encode(p), i)
            request_id = next(self._next_request)
            req = Request(
                request_id=request_id,
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
                trace_id=mint_trace_id(request_id),
            )
            self.scheduler.validate(req)
            reqs.append(req)
        rids = []
        for req in reqs:
            rid = req.request_id
            self.scheduler.submit(req)
            self._requests[rid] = req
            if tracing:
                self._trace_reqs[rid] = req
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

    def _on_admitted(self, rows: List[int]) -> None:
        """Engine admit listener: the blocks these rows published become
        readable for later admission groups (their prefill has been
        launched on the engine's stream, ahead of any later gather)."""
        if self.prefix_pool is None:
            return
        for row in rows:
            published = self._published_by_row.pop(row, None)
            if published:
                self.prefix_pool.mark_ready(published)

    def _engine_submit(self, batch) -> None:
        """Move scheduler picks into the engine's admission queue, each
        with its prefix-sharing plan when the pool is on."""
        tracing = telemetry.get_tracer().enabled
        plans = []
        if self.prefix_pool is not None:
            eligible = self.query_length // self.engine.block_size
            for req in batch:
                t_plan = monotonic() if tracing else 0.0
                plans.append(self.prefix_pool.plan_admission(
                    req.prompt_ids, req.prompt_mask, eligible_blocks=eligible
                ))
                if tracing:
                    # the request trace's prefix-plan overlay
                    self._plan_windows[req.request_id] = (t_plan, monotonic())
        ids = np.stack([req.prompt_ids for req in batch])
        mask = np.stack([req.prompt_mask for req in batch])
        # admission sits on the request path: a transient failure (the
        # engine.admit site models one) is retried with bounded backoff
        # instead of bouncing the requests
        try:
            rows = retry_call(
                lambda: self.engine.submit(
                    ids, mask,
                    shared_maps=np.stack([p.shared_map for p in plans]) if plans else None,
                    publish_maps=np.stack([p.publish_map for p in plans]) if plans else None,
                    submit_times=[req.submitted_at for req in batch],
                ),
                describe="inference-server admission",
            )
        except Exception:
            # a permanent failure: roll the plans back, or their references
            # and never-ready published blocks would pin the pool for good
            for plan in plans:
                if plan.acquired:
                    self.prefix_pool.abandon(plan.acquired)
            for req in batch:
                self._plan_windows.pop(req.request_id, None)
            raise
        for i, (row, req) in enumerate(zip(rows, batch)):
            self._row_to_req[row] = req.request_id
            self._req_row[req.request_id] = row
            if self.engine.spec_drafter is not None:
                # one tenant's unpredictable text degrades that tenant's
                # drafting, not everyone's
                self.engine.spec_drafter.set_tenant(row, req.tenant)
            if plans:
                if plans[i].acquired:
                    self._acquired[req.request_id] = plans[i].acquired
                if plans[i].published:
                    self._published_by_row[row] = plans[i].published
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

    def _observe_group(self, group) -> None:
        """One health row per harvest group: the served logprobs and
        values (response columns), and every measured tenant's queue-wait
        p95 over its SLO budget."""
        lp = np.asarray(group["logprobs"])
        vals = np.asarray(group["values"])
        m = np.asarray(group["response_mask"]).astype(bool)
        picked = lp[m] if m.any() else lp.ravel()
        row = {
            "health/logprob_mean": float(picked.mean()),
            "health/logprob_min": float(picked.min()),
            "health/value_mean": float(vals[m].mean() if m.any() else 0.0),
        }
        row.update(self.scheduler.slo_ratio_rows())
        self.health_monitor.observe(row, step=self._groups_served)
        self._groups_served += 1

    def _land_group(self, group) -> None:
        mask = group["response_mask"]
        self._observe_group(group)
        for j, row in enumerate(group["rows"]):
            record = self.engine.pop_request_record(row)
            timing = record["timing"] if record else None
            rid = self._row_to_req.pop(row, None)
            self._published_by_row.pop(row, None)
            # references drop for every harvested row with a plan, also a
            # request closed early (it would pin pool blocks otherwise)
            if rid is not None:
                acquired = self._acquired.pop(rid, None)
                if acquired and self.prefix_pool is not None:
                    self.prefix_pool.release(acquired)
            stream = self._router.pop(row)
            if stream is not None:
                stream.close()
            length = int(mask[j].sum()) if rid is not None else 0
            if rid is None or not self._open.get(rid):
                # a placeholder, or a request closed early: its row still
                # decoded to harvest, so its span chain closes here too
                self._finish_trace(rid, record, stream, length, status="abandoned")
                continue
            req = self._requests[rid]
            if timing is not None:
                observe_request_metrics(self._registry, timing, length, tenant=req.tenant)
            self._results[rid] = {
                "tokens": group["tokens"][j, :length].tolist(),
                "length": length,
                "tenant": req.tenant,
                "logprobs": group["logprobs"][j, :length].tolist(),
                "values": group["values"][j, :length].tolist(),
                "timing": timing,
            }
            if self.tokenizer is not None:
                self._results[rid]["text"] = self.tokenizer.decode(
                    self._results[rid]["tokens"], skip_special_tokens=True
                )
            self._open[rid] = False
            self.completion_order.append(rid)
            self._finish_trace(rid, record, stream, length)

    def _finish_trace(self, rid, record, stream, tokens: int, status: str = "ok") -> None:
        """Close one harvested request's trace: the kept scheduler marks,
        the engine's popped record and the stream's delivery marks become
        the parented span chain. No-op for placeholder rows, for requests
        submitted while tracing was off, and with the tracer disabled now."""
        req = self._trace_reqs.pop(rid, None) if rid is not None else None
        plan_window = self._plan_windows.pop(rid, None) if rid is not None else None
        tracer = telemetry.get_tracer()
        if req is None or record is None or not tracer.enabled:
            return
        stream_window = None
        if stream is not None and stream.first_push_at is not None:
            stream_window = (stream.first_push_at, stream.closed_at or stream.first_push_at)
        emit_request_trace(
            tracer,
            trace_id=req.trace_id,
            request_id=req.request_id,
            tenant=req.tenant,
            priority=req.priority,
            slo_class=req.slo_class,
            streamed=req.stream,
            tokens=tokens,
            marks=record["marks"],
            timing=record["timing"],
            delivered=monotonic(),
            status=status,
            quota_blocked_at=req.quota_blocked_at,
            picked_at=req.picked_at or None,
            step_times=record.get("step_times"),
            step_epochs=record.get("step_epochs"),
            plan_window=plan_window,
            stream_window=stream_window,
        )

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
        """Engine counters (cumulative) plus scheduler, prefix-pool and
        drafter accounting."""
        out = self.engine.stats.to_dict()
        out["scheduler/admitted"] = float(self.scheduler.admitted)
        out["scheduler/pending"] = float(self.scheduler.pending)
        out["scheduler/throttled_rounds"] = float(self.scheduler.throttled_rounds)
        if self.prefix_pool is not None:
            out.update(self.prefix_pool.stats())
        if self.engine.spec_drafter is not None:
            out.update(self.engine.spec_drafter.stats())
        return out

    def metrics(self) -> Dict[str, Any]:
        """The ``serve/*`` slice of the metrics-registry snapshot: the
        per-request latency histograms (summaries) and counters, aggregate
        and tenant-labelled keys."""
        snap = self._registry.snapshot()
        out: Dict[str, Any] = {}
        for section in ("counters", "gauges", "histograms"):
            for name, value in snap.get(section, {}).items():
                if name.startswith("serve/"):
                    out[name] = value
        return out
