"""Continuous-batching decode engine (counterpart of
:mod:`trlx_tpu.inference.engine`): a fixed pool of B decode slots fed by a
host-side admission queue.

- ``decode_step`` advances every slot one token;
- the step after a row emits eos (or exhausts its budget) the host sees
  its ``done`` flag, harvests finished rows in fixed-width groups, and
  prefills queued prompts into the vacated slots;
- each row samples with Gumbel noise from a generator seeded by (phase
  seed, row draw index, step) (:func:`trlx_tpu_torch.ops.sampling.row_noise`),
  so a row's tokens never depend on admission order or batch composition;
- the KV cache is the paged cache (:mod:`trlx_tpu_torch.inference.kv_cache`):
  a recycled slot gets a rotated block table.

Three serving features, each off by default:

- **the shared-prefix pool** (``prefix_pool_blocks > 0``): rows submitted
  with a ``shared_map`` read their leading blocks from the global pool and
  rows with a ``publish_map`` write theirs into it
  (:mod:`trlx_tpu_torch.serving.prefix_cache` plans both);
- **chunked admission prefill** (``prefill_chunk > 0``): the prompt
  columns run in block-aligned chunks against a prompt-wide view, and the
  host skips every chunk no row of the group needs (leading pad columns,
  blocks served from the pool): such a chunk is never launched;
- **speculative decoding** (``spec_max_draft > 0``): a host drafter
  proposes up to that many tokens per slot, and one verify forward of the
  anchor plus the drafts accepts the longest prefix on which the policy's
  own samples equal the drafts
  (:func:`trlx_tpu_torch.ops.sampling.accept_drafts`): the tokens of the
  one-token loop, at fewer forwards when drafts land.

Where the JAX package jits donated-state programs, the port runs eager
PyTorch and updates :class:`EngineState`'s tensors in place. Admission
prefill runs over the admitted rows only (no dummy rows — eager PyTorch
has no fixed program shape to keep) and writes their K/V straight into
their slots of the pool.

Weight pushes (the asynchronous actor-learner,
:mod:`trlx_tpu_torch.trainer.async_rl`): :meth:`ContinuousBatchingEngine.push_weights`
stages a ``(policy, version)`` pair, which the host loop applies only at a
safe point: before an admission group begins, never while one is
mid-prefill. Rows already decoding go on under the new policy (their
recorded logprobs stay the true behaviour logprobs); each row is tagged
with the version it was admitted under, and each harvest group carries
those tags (``versions``). :meth:`~ContinuousBatchingEngine.min_inflight_version`
reads the oldest version any unharvested row will carry.

Telemetry, at the JAX engine's sites: the forced spans ``collect/admit``
(a group's slot reservation and staging), ``collect/prefill`` (each
monolithic prefill, chunk run or finish chunk launch) and
``collect/slot_recycle`` (each harvest group's refill), and the
``engine/*`` registry gauges (``slot_util`` at each paid done-poll, the
prefix and chunk counters after each admission, the speculative rates
after each verify step). Per-request marks (submit, admit, first token,
harvest) ride each row to
:meth:`~ContinuousBatchingEngine.pop_request_record`; with
``trace_requests`` on, the host loop also stamps the done polls, the chunk
windows and the speculative segments, and logs each decode step's wall and
admission epoch: the decode-cadence slice of the serving tier's request
traces (:mod:`trlx_tpu_torch.telemetry.request_trace`).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.inference.kv_cache import (
    SHARE_TABLE_KEYS,
    SHARED_POOL_KEYS,
    choose_block_size,
    choose_prefill_chunk,
    empty_share_tables,
    identity_block_tables,
    init_shared_pool,
)
from trlx_tpu_torch.ops.sampling import (
    GenerationConfig,
    accept_drafts,
    choose_tokens,
    row_noise,
)
from trlx_tpu_torch.utils import monotonic, resolve_device, sched_points


@dataclasses.dataclass
class EngineState:
    """Device state of the slot pool; every tensor's leading axis is the
    slot axis (the cache's shared-prefix pool excepted). Updated in place."""

    cache: List[Dict[str, torch.Tensor]]  # paged KV cache, per layer
    t: torch.Tensor  # [B] long tokens emitted by the current occupant
    n_real: torch.Tensor  # [B] long real prompt length
    logits_last: torch.Tensor  # [B, V] f32 logits at the next decision
    value_last: torch.Tensor  # [B] f32 value estimate at that decision
    active: torch.Tensor  # [B] bool — slot holds an unharvested row
    finished: torch.Tensor  # [B] bool — row hit eos / length cap
    out_tokens: torch.Tensor  # [B, R] long (pad after eos)
    out_mask: torch.Tensor  # [B, R] long
    out_logprobs: torch.Tensor  # [B, R] f32
    out_values: torch.Tensor  # [B, R] f32
    query_ids: torch.Tensor  # [B, Q] long (left-padded prompt)
    query_mask: torch.Tensor  # [B, Q] long
    row_index: torch.Tensor  # [B] long global draw index of the occupant


@dataclasses.dataclass
class EngineStats:
    """Host-side occupancy/throughput counters for one phase (mutated only
    by the thread running the drive/pump loop)."""

    admitted: int = 0
    completed: int = 0
    prefills: int = 0  # admission groups prefilled
    decode_steps: int = 0  # decode and verify forwards
    recycles: int = 0
    occupancy_sum: int = 0  # sum over steps of busy slots
    num_slots: int = 0
    done_polls: int = 0  # [B]-bool device->host fetches
    weight_pushes: int = 0  # staged policies applied at a safe point
    released: int = 0  # placeholder rows force-finished on admission
    # chunked prefill: chunk forwards RUN (the finish chunk included),
    # prompt columns whose forward was skipped, and the dot-FLOPs those
    # skipped chunks would have cost
    prefill_chunks: int = 0
    prefill_cols_skipped: int = 0
    prefill_flops_saved: float = 0.0
    # prefix sharing, per admitted real row: blocks looked up, blocks read
    # from the pool without this row publishing them, blocks it published
    prefix_lookup_blocks: int = 0
    prefix_hit_blocks: int = 0
    prefix_published_blocks: int = 0
    # speculative decoding: verify steps, (row, step) pairs that drafted,
    # draft tokens proposed and accepted (anchors excluded), and the
    # proposed lengths
    spec_steps: int = 0
    spec_row_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_draft_lens: List[int] = dataclasses.field(default_factory=list)

    @property
    def slot_util(self) -> float:
        denom = self.num_slots * self.decode_steps
        return self.occupancy_sum / denom if denom else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        if not self.prefix_lookup_blocks:
            return 0.0
        return self.prefix_hit_blocks / self.prefix_lookup_blocks

    @property
    def prefix_blocks_saved(self) -> int:
        """Private-region prefix blocks never written (read from or
        redirected into the shared pool)."""
        return self.prefix_hit_blocks + self.prefix_published_blocks

    @property
    def spec_accept_rate(self) -> float:
        return self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0

    @property
    def spec_tokens_per_step(self) -> float:
        """Tokens committed per drafted (row, step): the anchor plus the
        accepted draft prefix."""
        if not self.spec_row_steps:
            return 0.0
        return 1.0 + self.spec_accepted / self.spec_row_steps

    @property
    def spec_draft_len_p50(self) -> float:
        return float(np.median(self.spec_draft_lens)) if self.spec_draft_lens else 0.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "engine/admitted": float(self.admitted),
            "engine/completed": float(self.completed),
            "engine/prefills": float(self.prefills),
            "engine/decode_steps": float(self.decode_steps),
            "engine/slot_recycles": float(self.recycles),
            "engine/slot_util": round(self.slot_util, 4),
            "engine/done_polls": float(self.done_polls),
            "engine/weight_pushes": float(self.weight_pushes),
            "engine/released": float(self.released),
            "engine/prefill_chunks": float(self.prefill_chunks),
            "engine/prefill_cols_skipped": float(self.prefill_cols_skipped),
            "engine/prefill_flops_saved": float(self.prefill_flops_saved),
            "engine/prefix_hit_rate": round(self.prefix_hit_rate, 4),
            "engine/prefix_blocks_saved": float(self.prefix_blocks_saved),
            "engine/spec_draft_len_p50": round(self.spec_draft_len_p50, 4),
            "engine/spec_accept_rate": round(self.spec_accept_rate, 4),
            "engine/spec_tokens_per_step": round(self.spec_tokens_per_step, 4),
        }


def prefill_dot_flops(model_config, rows: int, width: int, view: int,
                      heads: bool = False) -> float:
    """Dot-FLOPs (2 per multiply-add) of a GPT-2 or GPT-J forward (the same
    12 E^2 projection multiply-adds a token and layer) of ``width``
    columns of ``rows`` rows attending a ``view``-wide cache: per layer the
    QKV, output and MLP projections and the two attention products; with
    ``heads``, the LM head and the value head at one position a row
    (the prefill's ``last_only``). What the JAX package's engine reads off
    its traced program."""
    E, L = model_config.n_embd, model_config.n_layer
    n = rows * width
    flops = L * (24 * n * E * E + 4 * n * view * E)
    if heads:
        flops += 2 * rows * (E * model_config.vocab_size + 2 * E * E + 2 * E)
    return float(flops)


class ContinuousBatchingEngine:
    """Slot-admission decode over a paged KV cache.

    :param apply_fn: the model forward ``apply_fn(input_ids,
        attention_mask, position_ids, cache, cache_index[, last_only,
        skip_heads]) -> {"logits", "values"}`` (a
        :class:`CausalLMWithValueHead`). Once a weight push has been
        applied, every call also passes ``params=`` the pushed policy
        module.
    :param init_cache_fn: ``(batch, capacity, extra_positions=) -> linear
        KV buffers`` (the family's ``init_cache``); the engine asks for one
        extra position per slot (the discard sentinel), the cache dtype
        resolving at ``capacity``, and adds the block tables (and, on an
        int8 cache, an int8 prefix pool).
    :param gen_config: generation parameters; the engine always samples
        per row.
    :param num_slots: decode-slot pool size B.
    :param admit_width: most rows per admission prefill (0 = B // 4).
    :param harvest_width: completed rows per harvest group (0 =
        ``admit_width``); must be <= ``num_slots``.
    :param block_size: requested paged-KV block size (shrunk to divide
        Q + max_new_tokens).
    :param done_poll_interval: fetch the [B] ``done`` flags every k-th
        decode step (sticky flags: the latest fetch is exact).
    :param prefix_pool_blocks: size in blocks of the shared-prefix pool;
        0 disables sharing.
    :param prefill_chunk: chunked admission prefill width in prompt
        columns (rounded by :func:`choose_prefill_chunk`); 0 = the
        monolithic prefill.
    :param prefill_chunks_per_pump: with chunking, the most chunk forwards
        one :meth:`pump` launches before it advances decode (0 =
        unbounded); :meth:`drive` always completes an admission inline.
    :param spec_max_draft: speculative decoding's draft cap per slot per
        verify step (0 = off; shrunk to R - 1).
    :param spec_drafter: the host drafter
        (:mod:`trlx_tpu_torch.serving.spec_drafter` API); ``None`` with
        ``spec_max_draft > 0`` builds the n-gram drafter.
    :param spec_min_accept_ewma: the default drafter's accept-rate floor.
    :param model_config: the model's architecture, read by
        :meth:`_chunk_flop_cost` (``None``: skipped chunks are priced 0).
    :param device: ``None`` means CUDA (raises without it).
    """

    def __init__(
        self,
        *,
        apply_fn: Callable,
        init_cache_fn: Callable,
        gen_config: GenerationConfig,
        query_length: int,
        vocab_size: int,
        num_slots: int,
        admit_width: int = 0,
        harvest_width: int = 0,
        block_size: int = 16,
        done_poll_interval: int = 1,
        prefix_pool_blocks: int = 0,
        prefill_chunk: int = 0,
        prefill_chunks_per_pump: int = 0,
        spec_max_draft: int = 0,
        spec_drafter=None,
        spec_min_accept_ewma: float = 0.0,
        model_config=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.gen_config = dataclasses.replace(gen_config, per_row_rng=True)
        self.Q = int(query_length)
        self.R = int(self.gen_config.max_new_tokens)
        self.capacity = self.Q + self.R
        self.vocab_size = int(vocab_size)
        self.num_slots = int(num_slots)
        self.block_size = choose_block_size(self.capacity, block_size)
        self.n_blocks = self.capacity // self.block_size
        self.prefix_pool_blocks = int(prefix_pool_blocks)
        if spec_max_draft < 0:
            raise ValueError(
                f"spec_max_draft={spec_max_draft} must be >= 0 (0 "
                "disables speculative decoding)"
            )
        # a draft wider than R - 1 could never be fully accepted
        self.spec_max_draft = min(int(spec_max_draft), max(0, self.R - 1))
        self.spec_drafter = spec_drafter
        if self.spec_max_draft > 0 and self.spec_drafter is None:
            from trlx_tpu_torch.serving.spec_drafter import NGramDrafter

            self.spec_drafter = NGramDrafter(
                max_draft=self.spec_max_draft,
                min_accept_ewma=float(spec_min_accept_ewma),
            )
        self.prefill_chunk = choose_prefill_chunk(
            self.Q, int(prefill_chunk), self.block_size
        )
        self.n_prefill_chunks = self.Q // self.prefill_chunk if self.prefill_chunk else 0
        self.prefill_chunks_per_pump = int(prefill_chunks_per_pump)
        if self.prefill_chunks_per_pump < 0:
            raise ValueError(
                f"prefill_chunks_per_pump={prefill_chunks_per_pump} "
                "must be >= 0 (0 = unbounded)"
            )
        if self.prefill_chunks_per_pump and not self.prefill_chunk:
            raise ValueError(
                "prefill_chunks_per_pump needs chunked prefill "
                "(prefill_chunk > 0) — there is nothing to budget on the "
                "monolithic prefill"
            )
        self.model_config = model_config
        #: host callback ``{row: token_id} -> None`` fired per decode step
        #: with the step's live emissions (the streaming tap; each step it
        #: is set costs a token fetch)
        self.token_sink: Optional[Callable[[Dict[int, int]], None]] = None
        #: ``(rows, steps) -> [B, V]`` Gumbel noise used in place of
        #: :func:`row_noise` when set (the tests hand it the JAX package's
        #: draws); ``rows[b]`` is slot b's draw index, None when idle
        self.noise_fn: Optional[Callable[[List[Optional[int]], List[int]], torch.Tensor]] = None
        self.done_poll_interval = int(done_poll_interval)
        if self.done_poll_interval < 1:
            raise ValueError(
                f"done_poll_interval={done_poll_interval} must be >= 1"
            )
        self.admit_width = min(
            admit_width or max(1, self.num_slots // 4), self.num_slots
        )
        self.harvest_width = harvest_width or self.admit_width
        if self.harvest_width > self.num_slots:
            raise ValueError(
                f"harvest_width={self.harvest_width} cannot exceed "
                f"num_slots={self.num_slots} (a harvest group must fit "
                "in the pool or the drain deadlocks)"
            )
        self._apply_fn = apply_fn
        self._init_cache_fn = init_cache_fn

        self._state: Optional[EngineState] = None
        self._phase_seed = 0
        # queue entries: (ids, mask, row, shared_map|None, publish_map|None,
        # release)
        self._queue: List[Tuple] = []
        self._free: List[int] = []
        self._busy_rows: Dict[int, int] = {}  # slot -> row index
        self._done_slots: List[int] = []
        # the admission group mid-prefill (slots reserved, some chunks
        # launched): the budgeted pump advances it, drive() completes it
        self._inflight_admission: Optional[Dict[str, Any]] = None
        # spec decode: the next step's drafted (draft, lens), dropped by an
        # admission or a harvest (anything that changes the pool's rows)
        self._staged_drafts: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._recycle_counts = np.zeros(self.num_slots, np.int64)
        # host copy of each slot's step counter: equals the device ``t``
        # while the row is live, which is all the noise seeds need
        self._t_host = np.zeros(self.num_slots, np.int64)
        self._next_row = 0
        self._steps_since_poll = 0
        self._awaiting_first: Set[int] = set()
        self._gen = torch.Generator(device=self.device)
        # behaviour-policy versions (the asynchronous actor-learner): the
        # policy the forwards run (None: apply_fn's own), its version, the
        # version each slot's occupant was admitted under, and the staged
        # (policy, version) pair, one reference swapped under _push_lock
        # so that it is never seen torn
        self._params = None
        self.param_version = 0
        self._slot_versions = np.zeros(self.num_slots, np.int64)
        self._pending_push: Optional[Tuple[Any, int]] = None
        self._push_lock = threading.Lock()
        #: host callback fired with the admitted rows' draw indices after a
        #: group's last prefill launch: the server marks newly published
        #: prefix blocks ready here (the engine's one stream orders those
        #: writes before any later group's gather)
        self._admit_listener: Optional[Callable[[List[int]], None]] = None
        self.stats = EngineStats(num_slots=self.num_slots)
        # per-request latency marks (host clock), popped by the server
        self._req_times: Dict[int, Dict[str, float]] = {}
        #: request tracing: with this on, the host loop also logs one
        #: (step wall, admission epoch) pair per decode step and stamps the
        #: done-poll marks, so the server can emit per-request
        #: decode-cadence spans. Off (the default, and the trainers'
        #: collect path) adds no host work per step.
        self.trace_requests = False
        # the cadence log is pruned as rows harvest (entries below every
        # in-flight row's admit window drop; _step_base keeps the marks'
        # absolute indices valid): a long-lived server's memory stays
        # bounded by its in-flight window, not its lifetime
        self._step_log: List[Tuple[float, int]] = []
        self._step_base = 0

    # ------------------------------ state ------------------------------ #

    def init_state(self) -> EngineState:
        """Fresh all-idle pool. Idle slots are ``active=False,
        finished=True``: ``choose_tokens`` emits (pad, 0, 0.0, 0.0) for
        them and their cache writes land on the discard sentinel."""
        B, Q, R, V = self.num_slots, self.Q, self.R, self.vocab_size
        dev = self.device
        tables = identity_block_tables(B, self.n_blocks, dev)
        # one trailing discard position per slot region; the cache dtype
        # resolves at the capacity itself, as the JAX engine's does
        cache = [
            dict(layer, block_tables=tables)
            for layer in self._init_cache_fn(B, self.capacity, extra_positions=1)
        ]
        if self.prefix_pool_blocks > 0:
            # one share table, read by every layer (as the block tables);
            # the state keeps no publish tables: publishing happens at
            # admission, and decode writes land at positions >= Q, which
            # no plan shares
            shared = empty_share_tables(B, self.n_blocks, dev)
            for layer in cache:
                kv = layer["k"]
                layer.update(
                    init_shared_pool(
                        self.prefix_pool_blocks, self.block_size, kv.shape[2],
                        kv.shape[3], kv.dtype,
                        "int8" if "k_scale" in layer else "bfloat16", device=dev,
                    ),
                    shared_tables=shared,
                )
        i64, f32 = torch.int64, torch.float32
        return EngineState(
            cache=cache,
            t=torch.zeros(B, dtype=i64, device=dev),
            n_real=torch.zeros(B, dtype=i64, device=dev),
            logits_last=torch.zeros(B, V, dtype=f32, device=dev),
            value_last=torch.zeros(B, dtype=f32, device=dev),
            active=torch.zeros(B, dtype=torch.bool, device=dev),
            finished=torch.ones(B, dtype=torch.bool, device=dev),
            out_tokens=torch.full(
                (B, R), self.gen_config.pad_token_id, dtype=i64, device=dev
            ),
            out_mask=torch.zeros(B, R, dtype=i64, device=dev),
            out_logprobs=torch.zeros(B, R, dtype=f32, device=dev),
            out_values=torch.zeros(B, R, dtype=f32, device=dev),
            query_ids=torch.zeros(B, Q, dtype=i64, device=dev),
            query_mask=torch.zeros(B, Q, dtype=i64, device=dev),
            row_index=torch.full((B,), -1, dtype=i64, device=dev),
        )

    def _min_new(self, n_real: torch.Tensor):
        cfg = self.gen_config
        if cfg.min_new_tokens > 0 or cfg.min_length > 0:
            return torch.clamp(cfg.min_length - n_real, min=cfg.min_new_tokens)
        return None

    def _noise(self, steps) -> Optional[torch.Tensor]:
        """[B, V] Gumbel noise of every slot's occupant at ``steps[b]``
        (None when decoding greedily)."""
        if not self.gen_config.do_sample:
            return None
        rows = [self._busy_rows.get(s) for s in range(self.num_slots)]
        if self.noise_fn is not None:
            return self.noise_fn(rows, list(steps)).to(self.device)
        return row_noise(
            self._phase_seed, rows, steps, self.vocab_size, self.device, self._gen
        )

    # ---------------------------- device work --------------------------- #

    def _forward(self, *args, **kwargs):
        """``apply_fn`` under the applied weight push, if any."""
        if self._params is not None:
            kwargs["params"] = self._params
        return self._apply_fn(*args, **kwargs)

    def _slice_group_cache(self, adm) -> List[Dict[str, torch.Tensor]]:
        """The admitted slots' cache: the whole pool addressed through the
        group's freshly rotated tables and slot rows (plus the group's
        share/publish maps and the global prefix pool when sharing). One
        implementation for the monolithic prefill and every chunk."""
        group = []
        for layer in self._state.cache:
            g = {key: layer[key] for key in ("k", "v", "k_scale", "v_scale") if key in layer}
            g.update(block_tables=adm["tables"], slots=adm["slot_t"])
            if self.prefix_pool_blocks > 0:
                g.update({k: layer[k] for k in SHARED_POOL_KEYS if k in layer})
                g.update(zip(SHARE_TABLE_KEYS, (adm["shared_map"], adm["publish_map"])))
            group.append(g)
        return group

    def _merge_group_cache(self, adm) -> None:
        """Hand the admitted slots their tables (the K/V and the pool were
        written in place)."""
        cache = self._state.cache
        cache[0]["block_tables"][adm["slot_t"]] = adm["tables"]  # shared by every layer
        if self.prefix_pool_blocks > 0:
            cache[0]["shared_tables"][adm["slot_t"]] = adm["shared_map"]

    def _seed_slots(self, adm, out) -> None:
        """Seed the admitted slots' sampling state from the prefill's
        last-position logits and values."""
        cfg, st, slot_t = self.gen_config, self._state, adm["slot_t"]
        ids, mask = adm["ids"], adm["mask"]
        A = ids.shape[0]
        n_real = mask.sum(-1)
        if cfg.max_length > 0:
            finished0 = n_real >= cfg.max_length
        else:
            finished0 = torch.zeros(A, dtype=torch.bool, device=self.device)
        self._merge_group_cache(adm)
        st.t[slot_t] = 0
        st.n_real[slot_t] = n_real
        st.logits_last[slot_t] = out["logits"][:, -1].float()
        st.value_last[slot_t] = out["values"][:, -1].float()
        st.active[slot_t] = True
        st.finished[slot_t] = finished0
        st.out_tokens[slot_t] = cfg.pad_token_id
        st.out_mask[slot_t] = 0
        st.out_logprobs[slot_t] = 0.0
        st.out_values[slot_t] = 0.0
        st.query_ids[slot_t] = ids
        st.query_mask[slot_t] = mask
        st.row_index[slot_t] = adm["row_t"]

    @torch.no_grad()
    def prefill(self, adm) -> None:
        """Monolithic admission: forward the group's prompts ([A, Q],
        left-padded) over the capacity-wide view, write their K/V through
        the fresh tables into their slots, and seed the slots."""
        A, R = adm["ids"].shape[0], self.R
        mask = adm["mask"]
        out = self._forward(
            adm["ids"],
            attention_mask=torch.cat([mask, mask.new_zeros(A, R)], dim=1),
            position_ids=adm["positions"],
            cache=self._slice_group_cache(adm),
            cache_index=0,
            last_only=True,
        )
        self._seed_slots(adm, out)

    @torch.no_grad()
    def prefill_chunks(self, adm, chunks: List[int]) -> None:
        """Forward the listed prompt-column chunks (heads skipped: only
        their K/V is wanted), each against the prompt-wide (Q) view: prompt
        queries never attend the decode region, whose masked columns carry
        exactly-zero softmax weight in the monolithic prefill."""
        W = self.prefill_chunk
        cache = self._slice_group_cache(adm)
        for c in chunks:
            cols = slice(c * W, (c + 1) * W)
            self._forward(
                adm["ids"][:, cols],
                attention_mask=adm["mask"],  # Q-wide view
                position_ids=adm["positions"][:, cols],
                cache=cache,
                cache_index=c * W,
                skip_heads=True,
            )

    @torch.no_grad()
    def prefill_finish(self, adm) -> None:
        """The final chunk, always run (every left-padded row's last real
        column lives there): its last-position logits and values seed the
        slots."""
        off = self.Q - self.prefill_chunk
        out = self._forward(
            adm["ids"][:, off:],
            attention_mask=adm["mask"],  # Q-wide view
            position_ids=adm["positions"][:, off:],
            cache=self._slice_group_cache(adm),
            cache_index=off,
            last_only=True,
        )
        self._seed_slots(adm, out)

    @torch.no_grad()
    def decode_step(self):
        """One token for every slot. Finished/idle slots ride along with
        pad emissions whose output and cache writes are discarded.
        Returns ``(done, token, emitted)`` [B] device tensors; ``emitted``
        marks the tokens that land in a row's output (live and within its
        budget: a row that ran to its budget waits for its harvest group
        still live, and what it samples then is nobody's token)."""
        cfg, st, dev = self.gen_config, self._state, self.device
        B, Q, R, cap = self.num_slots, self.Q, self.R, self.capacity
        noise = self._noise(self._t_host)
        token, live, logprob, value_out, finished = choose_tokens(
            cfg, st.logits_last, st.t, st.finished, st.value_last,
            st.n_real, min_new=self._min_new(st.n_real), noise=noise,
        )
        live_b = live == 1
        # emissions land at [slot, t] for live rows within the budget;
        # every other row writes its current value back (no-op)
        write = (live_b & (st.t < R))[:, None]
        col = st.t.clamp(max=R - 1)[:, None]
        for buf, val in (
            (st.out_tokens, token), (st.out_mask, live),
            (st.out_logprobs, logprob), (st.out_values, value_out),
        ):
            cur = buf.gather(1, col)
            buf.scatter_(1, col, torch.where(write, val[:, None].to(buf.dtype), cur))
        # forward the sampled token at per-row cache slot Q + t; non-live
        # rows write at capacity (the paged cache's discard sentinel)
        slot_pos = torch.arange(cap, device=dev)[None, :]
        cache_mask = (slot_pos <= Q + st.t[:, None]).long() * torch.cat(
            [st.query_mask, st.query_mask.new_ones(B, R)], dim=1
        )
        out = self._forward(
            token.long()[:, None],
            attention_mask=cache_mask,
            position_ids=(st.n_real + st.t)[:, None],
            cache=st.cache,
            cache_index=torch.where(live_b, Q + st.t, cap),
        )
        st.logits_last = out["logits"][:, 0].float()
        st.value_last = out["values"][:, 0].float()
        t_next = torch.where(live_b, st.t + 1, st.t)
        done = st.active & (finished | (t_next >= R))
        st.t = t_next
        st.finished = finished
        return done, token, write[:, 0]

    @torch.no_grad()
    def verify_step(self, draft: np.ndarray, draft_len: np.ndarray):
        """Drafted multi-token decode: sample each slot's anchor from the
        carried logits (always the right next token, so an all-rejected
        step still commits it), forward the anchor plus up to D drafted
        tokens in one pass through the paged cache, and accept the longest
        draft prefix on which the policy's samples equal the drafts.
        Accepted emissions land where sequential decode puts them. Drafted
        columns write their K/V at Q + t + j whether accepted or not: what
        lies past the accepted frontier is masked (exactly-zero softmax
        weight) until a later step overwrites it; columns past the draft
        write to the discard sentinel. The carried logits and value are
        re-anchored at the last accepted column, so verify and decode steps
        mix freely. Returns ``(done, tokens, accepted)``: [B] and [B, D+1];
        ``accepted`` marks the columns that land in a row's output (as
        ``decode_step``'s ``emitted``)."""
        cfg, st, dev = self.gen_config, self._state, self.device
        B, Q, R, cap, D = self.num_slots, self.Q, self.R, self.capacity, self.spec_max_draft
        min_new = self._min_new(st.n_real)
        token0, live0, lp0, v0, fin1 = choose_tokens(
            cfg, st.logits_last, st.t, st.finished, st.value_last, st.n_real,
            min_new=min_new, noise=self._noise(self._t_host),
        )
        draft_t = torch.as_tensor(draft, device=dev).long()
        lens = torch.as_tensor(draft_len, device=dev).long()
        col = torch.arange(D + 1, device=dev)[None, :]
        inputs = torch.cat([token0.long()[:, None], draft_t], dim=1)
        # per-column targets: the anchor and the drafted columns land at
        # Q + t + j, every other column on the discard sentinel
        write_pos = torch.where(
            (live0 == 1)[:, None] & (col <= lens[:, None]), Q + st.t[:, None] + col, cap
        )
        slot_pos = torch.arange(cap, device=dev)[None, :]
        # window-wide validity; the causal bias (offset = the first
        # target) narrows query j to keys <= Q + t + j, and the columns it
        # excludes carry exactly-zero weight: per query, the one-token
        # step's attention
        cache_mask = (slot_pos <= Q + st.t[:, None] + D).long() * torch.cat(
            [st.query_mask, st.query_mask.new_ones(B, R)], dim=1
        )
        out = self._forward(
            inputs,
            attention_mask=cache_mask,
            position_ids=(st.n_real + st.t)[:, None] + col,
            cache=st.cache,
            cache_index=write_pos,
        )
        logits_seq = out["logits"].float()
        values_seq = out["values"].float()
        noise = None
        if cfg.do_sample:
            noise = torch.stack(
                [self._noise(self._t_host + j) for j in range(1, D + 1)], dim=1
            )
        d_toks, d_acc, d_lps, d_vals, n_acc, fin = accept_drafts(
            cfg, logits_seq[:, :-1], values_seq[:, :-1], st.t, fin1, live0 == 1,
            st.n_real, draft_t, lens, noise=noise, min_new=min_new, budget=R,
        )
        tokens = torch.cat([token0[:, None], d_toks], dim=1)
        acc = torch.cat([live0[:, None], d_acc], dim=1)
        # each accepted column j lands at [slot, t + j] within the budget;
        # the targets of a row are distinct, so a one-hot over the R
        # columns places them
        landed = (acc == 1) & (st.t[:, None] + col < R)
        hit = ((st.t[:, None] + col)[:, :, None] == torch.arange(R, device=dev)) & (
            landed[:, :, None]
        )  # [B, D+1, R]
        any_hit = hit.any(1)
        for buf, val in (
            (st.out_tokens, tokens), (st.out_mask, acc),
            (st.out_logprobs, torch.cat([lp0[:, None], d_lps], dim=1)),
            (st.out_values, torch.cat([v0[:, None], d_vals], dim=1)),
        ):
            placed = torch.where(hit, val[:, :, None].to(buf.dtype), 0).sum(1)
            buf.copy_(torch.where(any_hit, placed.to(buf.dtype), buf))
        rows = torch.arange(B, device=dev)
        st.logits_last = logits_seq[rows, n_acc]
        st.value_last = values_seq[rows, n_acc]
        t_next = st.t + live0.long() + n_acc
        done = st.active & (fin | (t_next >= R))
        st.t = t_next
        st.finished = fin
        return done, tokens, landed.to(torch.int32)

    @torch.no_grad()
    def refill(self, slots: List[int]) -> Dict[str, np.ndarray]:
        """Harvest ``slots``' finished rollouts (host arrays) and free the
        slots, idle again (``finished``, as :meth:`init_state` leaves
        them): a row that ran to its token budget is harvested unfinished,
        and its slot would otherwise go on emitting live tokens, which the
        stream tap and the drafter would credit to the next row while that
        row's budgeted admission is in flight. The reference engine leaves
        the flag as it was."""
        st = self._state
        idx = torch.as_tensor(slots, dtype=torch.long).to(self.device)
        fields = {
            "query_tokens": st.query_ids,
            "query_mask": st.query_mask,
            "tokens": st.out_tokens,
            "response_mask": st.out_mask,
            "logprobs": st.out_logprobs,
            "values": st.out_values,
            "row_index": st.row_index,
        }
        outs = {k: v[idx].cpu().numpy() for k, v in fields.items()}
        st.active[idx] = False
        st.finished[idx] = True
        return outs

    @torch.no_grad()
    def release(self, slots: List[int]) -> None:
        """Force-finish ``slots`` right after admission: a padding
        placeholder costs one decode step instead of a full budget."""
        idx = torch.as_tensor(slots, dtype=torch.long).to(self.device)
        self._state.finished[idx] = True

    # ----------------------------- host loop ---------------------------- #

    def start_phase(self, seed: int, row_start: int = 0) -> None:
        """Reset the pool for a new phase; ``seed`` seeds the per-row
        sampling noise, ``row_start`` offsets the global draw index. The
        phase starts on ``apply_fn``'s own policy at version 0; a pushed
        or staged policy is dropped."""
        self._phase_seed = int(seed)
        self.drop_weights()
        self.param_version = 0
        self._slot_versions[:] = 0
        self._state = self.init_state()
        self._queue = []
        self._free = list(range(self.num_slots))
        self._busy_rows = {}
        self._done_slots = []
        self._inflight_admission = None
        self._staged_drafts = None
        if self.spec_drafter is not None and hasattr(self.spec_drafter, "reset"):
            self.spec_drafter.reset()
        self._recycle_counts[:] = 0
        self._t_host[:] = 0
        self._next_row = row_start
        self._steps_since_poll = 0
        self._awaiting_first = set()
        self.stats = EngineStats(num_slots=self.num_slots)
        self._req_times = {}
        self._step_log = []
        self._step_base = 0

    def push_weights(self, params, version: Optional[int] = None) -> None:
        """Stage a refreshed behaviour policy (a module that owns its
        tensors: the learner goes on updating its masters) tagged
        ``version`` (default: the current one plus 1). The swap happens at
        the host loop's next safe point, never here, so a push that lands
        between a harvest and its refill cannot disturb the queued
        admission group. Pushes before the safe point coalesce: only the
        newest is applied. The staged pair is written as one reference
        under the push lock."""
        sched_points.yield_point("engine.push")
        with sched_points.guard(self._push_lock, "engine.push_lock"):
            self._pending_push = (
                params, int(version) if version is not None else self.param_version + 1
            )

    def _apply_pending_push(self) -> None:
        """The safe point: apply a staged push (the drafts staged for the
        next verify step are dropped: its targets come from the new
        policy)."""
        sched_points.yield_point("engine.safe_point")
        with sched_points.guard(self._push_lock, "engine.push_lock"):
            staged, self._pending_push = self._pending_push, None
            if staged is None:
                return
            self._params, self.param_version = staged
        self._staged_drafts = None
        self.stats.weight_pushes += 1

    def drop_weights(self) -> None:
        """Forget the applied and the staged push (the learner closed or
        abandoned its phase): ``apply_fn``'s own policy serves again and
        the pushed copies can be freed."""
        with sched_points.guard(self._push_lock, "engine.push_lock"):
            self._pending_push = None
        self._params = None

    def min_inflight_version(self) -> Optional[int]:
        """The oldest behaviour version any not-yet-harvested row will
        carry: the admission versions of the occupied slots (decoding or
        awaiting harvest) and, while prompts are queued, the version they
        will be admitted under (a staged push's, else the current one).
        ``None`` when nothing is in flight."""
        with sched_points.guard(self._push_lock, "engine.push_lock"):
            staged = self._pending_push
            current = self.param_version
        versions = [int(self._slot_versions[s]) for s in self._busy_rows]
        if self._queue:
            versions.append(staged[1] if staged is not None else current)
        return min(versions) if versions else None

    def submit(self, prompt_ids, prompt_mask, *, shared_maps=None, publish_maps=None,
               release: bool = False, submit_times=None) -> List[int]:
        """Enqueue prompts (host arrays, [n, Q]); returns their global row
        indices (draw order — the per-row noise identity).

        ``shared_maps`` / ``publish_maps`` ([n, n_blocks] int, -1 =
        private) are the serving tier's per-row prefix-sharing plans
        (needs ``prefix_pool_blocks > 0``); ``release=True`` marks padding
        placeholders (force-finished on admission); ``submit_times``
        backdates the latency marks to when the request entered the
        serving tier. Carries the ``engine.admit`` fault-injection site
        (:mod:`~trlx_tpu_torch.resilience.chaos`): an injected admission
        failure drives the orchestrator's fallback to the fixed sampler
        and the server's admission retry."""
        from trlx_tpu_torch.resilience import chaos

        chaos.check("engine.admit")
        ids = np.asarray(prompt_ids)
        mask = np.asarray(prompt_mask)
        if ids.ndim != 2 or ids.shape[1] != self.Q:
            raise ValueError(
                f"submit expects [n, Q={self.Q}] prompt ids, got {ids.shape}"
            )
        if (shared_maps is not None or publish_maps is not None) and (
            self.prefix_pool_blocks < 1
        ):
            raise ValueError(
                "prefix-sharing maps need an engine built with "
                "prefix_pool_blocks > 0"
            )
        rows = []
        t_submit = monotonic()
        for i in range(ids.shape[0]):
            row = self._next_row
            self._next_row += 1
            self._queue.append((
                ids[i], mask[i], row,
                None if shared_maps is None else np.asarray(shared_maps[i], np.int64),
                None if publish_maps is None else np.asarray(publish_maps[i], np.int64),
                bool(release),
            ))
            self._req_times[row] = {
                "submitted": (
                    float(submit_times[i])
                    if submit_times is not None
                    else t_submit
                )
            }
            rows.append(row)
        return rows

    @property
    def pending(self) -> int:
        """Rows submitted but not yet harvested."""
        return len(self._queue) + len(self._busy_rows)

    @property
    def free_capacity(self) -> int:
        """Slots with neither an occupant nor a queued claim."""
        return self.num_slots - len(self._busy_rows) - len(self._queue)

    def pop_request_record(self, row: int) -> Optional[Dict[str, Any]]:
        """The trace record of a HARVESTED row (popped; None for an
        unknown or unfinished row): the ``timing`` decomposition in ms,
        ``queue_wait_ms`` (submit → admission), ``prefill_ms`` (admission →
        first token on the host), ``ttft_ms``, ``decode_ms`` (first token →
        harvest) and ``e2e_ms``; the raw ``marks`` (seconds on the shared
        telemetry clock); and, under
        :attr:`trace_requests`, the row's decode-cadence slice:
        ``step_times`` (the host wall of each decode step while the row was
        live) and ``step_epochs`` (the admission count at each step: an
        epoch change mid-row means the host loop interrupted this row's
        decode run to admit another group). The first-token mark is taken
        when the first step after the group's prefill has been fetched to
        the host, so on a GPU it includes the device time, not just the
        launch."""
        marks = self._req_times.get(row)
        if not marks or "completed" not in marks:
            return None
        self._req_times.pop(row, None)
        submitted = marks["submitted"]
        admitted = marks.get("admitted", submitted)
        first = marks.get("first_token", admitted)
        completed = marks["completed"]
        ms = 1000.0
        record: Dict[str, Any] = {
            "timing": {
                "queue_wait_ms": max(0.0, (admitted - submitted) * ms),
                "prefill_ms": max(0.0, (first - admitted) * ms),
                "ttft_ms": max(0.0, (first - submitted) * ms),
                "decode_ms": max(0.0, (completed - first) * ms),
                "e2e_ms": max(0.0, (completed - submitted) * ms),
            },
            "marks": dict(marks),
        }
        if self._step_log and "admit_step" in marks:
            base = self._step_base
            lo = max(0, int(marks["admit_step"]) - base)
            hi = min(int(marks.get("done_step", base + len(self._step_log))) - base,
                     len(self._step_log))
            window = self._step_log[lo:hi]
            record["step_times"] = [t for t, _ in window]
            record["step_epochs"] = [e for _, e in window]
        return record

    def _plan_chunk_need(self, prompt_mask, shared_map, publish_map) -> np.ndarray:
        """[n_prefill_chunks] bool: which prompt-column chunks any row of
        the group needs computed. A column is needed when it is a real
        (non-pad) column not read from the shared pool, or when its block
        is being published (the donor computes what it publishes, pad
        columns included: readers gather the donor's bits). Leading
        all-pad chunks of a left-padded group and fully pool-covered
        chunks come out unneeded."""
        Q, W = self.Q, self.prefill_chunk
        mask = np.asarray(prompt_mask)
        first_real = Q - mask.sum(axis=1)
        cols = np.arange(Q)
        needed = cols[None, :] >= first_real[:, None]
        if shared_map is not None:
            col_blk = np.minimum(cols // self.block_size, self.n_blocks - 1)
            covered = (shared_map[:, col_blk] >= 0) & (publish_map[:, col_blk] < 0)
            publishes = publish_map[:, col_blk] >= 0
            needed = (needed & ~covered) | publishes
        return needed.reshape(mask.shape[0], Q // W, W).any(2).any(0)

    def _begin_admission(self) -> None:
        """Reserve slots for the next group of at most ``admit_width``
        queued prompts and stage its arrays, inside a ``collect/admit``
        span; the launches happen in :meth:`_advance_admission`."""
        with telemetry.span("collect/admit", force=True):
            sharing = self.prefix_pool_blocks > 0
            nb_prompt = self.Q // self.block_size  # shareable prompt blocks
            take = min(len(self._free), len(self._queue), self.admit_width)
            slots = [self._free.pop(0) for _ in range(take)]
            entries = [self._queue.pop(0) for _ in range(take)]
            shared_map = np.full((take, self.n_blocks), -1, np.int64)
            publish_map = np.full((take, self.n_blocks), -1, np.int64)
            released_slots = []
            for i, (slot, (ids, mask, row, sh_row, pub_row, release)) in enumerate(
                zip(slots, entries)
            ):
                self._busy_rows[slot] = row
                self._slot_versions[slot] = self.param_version
                if release:
                    released_slots.append(slot)
                if sh_row is not None:
                    shared_map[i, :len(sh_row)] = sh_row
                if pub_row is not None:
                    publish_map[i, :len(pub_row)] = pub_row
                if sharing and not release:
                    self.stats.prefix_lookup_blocks += nb_prompt
                    self.stats.prefix_hit_blocks += int(
                        np.sum((shared_map[i] >= 0) & (publish_map[i] < 0))
                    )
                    self.stats.prefix_published_blocks += int(np.sum(publish_map[i] >= 0))
                if self.spec_drafter is not None and not release:
                    # seed the row's history with its real prompt tokens
                    self.spec_drafter.observe_context(
                        row, [int(x) for x in ids[mask.astype(bool)]]
                    )
            dev, nb = self.device, self.n_blocks
            prompt_mask = np.stack([e[1] for e in entries])
            mask = torch.as_tensor(prompt_mask, dtype=torch.long).to(dev)
            turns = torch.as_tensor(
                [int(self._recycle_counts[s]) for s in slots], dtype=torch.long
            ).to(dev)
            adm = {
                "take": take,
                "entries": entries,
                "slots": slots,
                "slot_t": torch.as_tensor(slots, dtype=torch.long).to(dev),
                "row_t": torch.as_tensor([e[2] for e in entries], dtype=torch.long).to(dev),
                "ids": torch.as_tensor(np.stack([e[0] for e in entries]),
                                       dtype=torch.long).to(dev),
                "mask": mask,
                "positions": (mask.cumsum(-1) - 1).clamp_min(0),
                # a recycled slot gets a rotated table
                "tables": ((torch.arange(nb, device=dev)[None, :] + turns[:, None]) % nb).to(
                    torch.int32
                ),
                "shared_map": None,
                "publish_map": None,
                "released_slots": released_slots,
                "need": None,
                "next_chunk": 0,
                # (first prompt column, host wall) per chunk-run launch
                "chunk_walls": [],
                "t_admit": monotonic(),
            }
            if sharing:
                adm["shared_map"] = torch.as_tensor(shared_map, dtype=torch.int32).to(dev)
                adm["publish_map"] = torch.as_tensor(publish_map, dtype=torch.int32).to(dev)
            if self.prefill_chunk > 0:
                adm["need"] = self._plan_chunk_need(
                    prompt_mask,
                    shared_map if sharing else None,
                    publish_map if sharing else None,
                )
            self._inflight_admission = adm

    def _advance_admission(self, budget: Optional[int]) -> Tuple[bool, int]:
        """Launch the in-flight admission's next prefill work: the whole
        group (monolithic, or ``budget=None``), else at most ``budget``
        chunk forwards (skipped chunks are free and never count). Returns
        ``(admission complete, chunk forwards launched)``."""
        adm = self._inflight_admission
        if self.prefill_chunk == 0:
            with telemetry.span("collect/prefill", force=True, admitted=adm["take"]):
                self.prefill(adm)
            self._finalize_admission()
            return True, 1
        n_scan = self.n_prefill_chunks - 1
        need = adm["need"]
        spent = 0
        if adm["next_chunk"] < n_scan:
            idx = [c for c in range(adm["next_chunk"], n_scan) if need[c]]
            if budget is not None and budget > 0 and len(idx) > budget:
                run = idx[:budget]
                hi = run[-1] + 1
            else:
                run, hi = idx, n_scan
            if run:
                with telemetry.span("collect/prefill", force=True, admitted=adm["take"],
                                    chunks=len(run)):
                    self.prefill_chunks(adm, run)
                self.stats.prefill_chunks += len(run)
                spent = len(run)
                if self.trace_requests:
                    adm["chunk_walls"].append((run[0] * self.prefill_chunk, monotonic()))
            adm["next_chunk"] = hi
            if hi < n_scan or (budget is not None and spent >= budget):
                return False, spent
        # the finish chunk always runs: every left-padded row's last real
        # column lives there
        with telemetry.span("collect/prefill", force=True, admitted=adm["take"], chunks=1,
                            finish=True):
            self.prefill_finish(adm)
        self.stats.prefill_chunks += 1
        if self.trace_requests:
            adm["chunk_walls"].append((n_scan * self.prefill_chunk, monotonic()))
        skipped = int(n_scan - np.count_nonzero(need[:n_scan]))
        self.stats.prefill_cols_skipped += skipped * self.prefill_chunk
        if skipped:
            self.stats.prefill_flops_saved += skipped * self._chunk_flop_cost(adm["take"])
        self._finalize_admission()
        return True, spent + 1

    def _finalize_admission(self) -> None:
        """Bookkeeping after the group's last prefill launch: placeholder
        release, latency marks, stats, and the admit listener (published
        prefix blocks become readable only now: every chunk that writes
        them has been launched)."""
        adm = self._inflight_admission
        self._inflight_admission = None
        if adm["released_slots"]:
            self.release(adm["released_slots"])
            self.stats.released += len(adm["released_slots"])
        # per-chunk-run offsets (first column, ms after admission; traced
        # runs only): the serve/prefill span carries them
        chunk_offsets = [{"col": int(col), "ms": round((t - adm["t_admit"]) * 1000.0, 3)}
                         for col, t in adm["chunk_walls"]]
        for slot, entry in zip(adm["slots"], adm["entries"]):
            self._t_host[slot] = 0
            marks = self._req_times.get(entry[2])
            if marks is not None:
                marks["admitted"] = adm["t_admit"]
                if chunk_offsets:
                    marks["prefill_chunk_offsets"] = chunk_offsets
                if self.trace_requests:
                    # the row's decode-cadence window starts at the current
                    # step-log position (absolute: survives pruning)
                    marks["admit_step"] = self._step_base + len(self._step_log)
            self._awaiting_first.add(entry[2])
        self.stats.prefills += 1
        self.stats.admitted += adm["take"]
        # new occupants joined the pool: a staged draft matrix no longer
        # covers it
        self._staged_drafts = None
        registry = telemetry.get_metrics()
        if self.prefix_pool_blocks > 0:
            registry.gauge("engine/prefix_hit_rate").set(self.stats.prefix_hit_rate)
            registry.gauge("engine/prefix_blocks_saved").set(self.stats.prefix_blocks_saved)
        if self.prefill_chunk > 0:
            registry.gauge("engine/prefill_chunks").set(float(self.stats.prefill_chunks))
            registry.gauge("engine/prefill_cols_skipped").set(
                float(self.stats.prefill_cols_skipped))
            registry.gauge("engine/prefill_flops_saved").set(
                float(self.stats.prefill_flops_saved))
        if self._admit_listener is not None:
            self._admit_listener([e[2] for e in adm["entries"]])

    def _chunk_flop_cost(self, rows: Optional[int] = None) -> float:
        """Dot-FLOPs of one non-final prefill chunk forward over ``rows``
        rows (default ``admit_width``, the JAX package's program width): W
        columns against the prompt-wide view, heads skipped. 0.0 without a
        ``model_config``."""
        if self.model_config is None or not self.prefill_chunk:
            return 0.0
        rows = self.admit_width if rows is None else int(rows)
        return prefill_dot_flops(self.model_config, rows, self.prefill_chunk, self.Q)

    def _admit(self) -> None:
        """Complete every possible admission inline (the drive() and
        unbudgeted-pump path)."""
        if self._inflight_admission is not None:
            self._advance_admission(None)
        while self._free and self._queue:
            self._begin_admission()
            self._advance_admission(None)

    def _pump_admission(self, budget: int) -> None:
        """Advance admission by at most ``budget`` chunk forwards this pump
        iteration (``rollout.prefill_chunks_per_pump``): a large admission
        burst interleaves with decode steps instead of stalling them."""
        remaining = budget
        while remaining > 0:
            if self._inflight_admission is None:
                # a staged push applies only between groups: a group's
                # whole prefill runs under one version
                self._apply_pending_push()
                if not (self._free and self._queue):
                    return
                self._begin_admission()
            done, spent = self._advance_admission(remaining)
            remaining -= max(1, spent)
            if not done:
                return

    def _harvest_ready(self) -> Iterator[Dict[str, Any]]:
        """Yield fixed-width harvest groups while enough slots are done."""
        C = self.harvest_width
        while len(self._done_slots) >= C:
            slots = self._done_slots[:C]
            self._done_slots = self._done_slots[C:]
            with telemetry.span("collect/slot_recycle", force=True, harvested=C):
                outs = self.refill(slots)
            rows = [self._busy_rows.pop(s) for s in slots]
            versions = [int(self._slot_versions[s]) for s in slots]
            t_done = monotonic()
            for r in rows:
                marks = self._req_times.get(r)
                if marks is not None:
                    marks["completed"] = t_done
            for s in slots:
                self._recycle_counts[s] += 1
                self._free.append(s)
            if self.spec_drafter is not None:
                for r in rows:
                    self.spec_drafter.forget(r)
                self._staged_drafts = None
            self.stats.recycles += C
            self.stats.completed += C
            outs["rows"] = rows  # host-side draw indices, harvest order
            outs["versions"] = versions  # each row's admission version
            if self.trace_requests:
                self._prune_step_log()
            yield outs

    def _prune_step_log(self) -> None:
        """Drop cadence-log entries no un-popped request can still
        reference (everything below the minimum in-flight ``admit_step``;
        un-admitted rows stamp at or past the current end, so they never
        constrain). ``_step_base`` keeps the retained marks' absolute
        indices valid."""
        if not self._step_log:
            return
        end = self._step_base + len(self._step_log)
        floor = min((int(m["admit_step"]) for m in self._req_times.values()
                     if "admit_step" in m), default=end)
        drop = min(floor, end) - self._step_base
        if drop > 0:
            del self._step_log[:drop]
            self._step_base += drop

    def drive(self, target: int) -> Iterator[Dict[str, Any]]:
        """Run admission/decode/harvest until ``target`` completed rows
        have been yielded (in ``harvest_width`` groups)."""
        C = self.harvest_width
        if target % C:
            raise ValueError(
                f"target={target} must be a multiple of harvest_width={C}"
            )
        if target > self.pending + self.stats.completed:
            raise ValueError(
                f"drive(target={target}) but only {self.pending} rows are "
                "pending — submit the phase's prompts first"
            )
        yielded = 0
        self._steps_since_poll = 0
        while yielded < target:
            for group in self._harvest_ready():
                yield group
                yielded += len(group["rows"])
                if yielded >= target:
                    return
            # the safe point for a staged push: harvest bookkeeping is
            # settled, the queued group is about to prefill (never while a
            # group is mid-prefill: its chunks run under one version)
            if self._inflight_admission is None:
                self._apply_pending_push()
            self._admit()
            if not self._busy_rows:
                raise RuntimeError(
                    "engine starved: no active slots and no full harvest "
                    f"group ({len(self._done_slots)} done < {C})"
                )
            self._step_once()

    def pump(self) -> List[Dict[str, Any]]:
        """One serving-loop iteration: harvest every ready group, admit
        queued prompts into vacated slots (at most
        ``prefill_chunks_per_pump`` chunk forwards when set), then advance
        decode one step. Returns the harvested groups (possibly empty)."""
        groups = list(self._harvest_ready())
        if self.prefill_chunks_per_pump > 0:
            self._pump_admission(self.prefill_chunks_per_pump)
        else:
            if self._inflight_admission is None:
                self._apply_pending_push()
            self._admit()
        if self._busy_rows:
            self._step_once()
        return groups

    def _step_once(self) -> None:
        """Advance every slot one step: the drafted verify step when spec
        decode is on and any slot proposed a draft, else the one-token
        decode step (draftless rounds never pay the wider forward)."""
        if self.spec_max_draft > 0:
            draft, lens = self._take_drafts()
            if lens.any():
                self._verify_once(draft, lens)
                return
        self._decode_once()

    def _take_drafts(self) -> Tuple[np.ndarray, np.ndarray]:
        """The next step's per-slot drafts: the staged ones if no
        admission or harvest dropped them, else drafted now."""
        if self._staged_drafts is not None:
            staged, self._staged_drafts = self._staged_drafts, None
            return staged
        return self._draft_now()

    def _draft_now(self) -> Tuple[np.ndarray, np.ndarray]:
        """Up to ``spec_max_draft`` proposed tokens per busy, not-done
        slot: [B, D] matrix and [B] lengths."""
        D = self.spec_max_draft
        draft = np.zeros((self.num_slots, D), np.int64)
        lens = np.zeros((self.num_slots,), np.int64)
        if self.spec_drafter is None:
            return draft, lens
        done = set(self._done_slots)
        for slot, row in self._busy_rows.items():
            if slot in done:
                continue
            toks = list(self.spec_drafter.draft(row))[:D]
            if toks:
                draft[slot, :len(toks)] = toks
                lens[slot] = len(toks)
        return draft, lens

    def _verify_once(self, draft: np.ndarray, lens: np.ndarray) -> None:
        """One verify step: land its accepted tokens in the drafter's
        histories and the stream tap, draft the next step, poll."""
        done, toks, acc = self.verify_step(draft, lens)
        self.stats.decode_steps += 1
        self.stats.spec_steps += 1
        self.stats.occupancy_sum += len(self._busy_rows)
        if self.trace_requests:
            self._step_log.append((monotonic(), self.stats.prefills))
        tok_host = toks.cpu().numpy()
        acc_host = acc.cpu().numpy()
        for slot, row in self._busy_rows.items():
            n_cols = int(acc_host[slot].sum())  # anchor + accepted drafts
            self._t_host[slot] += n_cols
            if lens[slot]:
                n_drafted = int(lens[slot])
                n_accepted = max(0, n_cols - 1)
                self.stats.spec_row_steps += 1
                self.stats.spec_drafted += n_drafted
                self.stats.spec_accepted += n_accepted
                self.stats.spec_draft_lens.append(n_drafted)
                self.spec_drafter.observe_accept(row, n_drafted, n_accepted)
                marks = self._req_times.get(row) if self.trace_requests else None
                if marks is not None:
                    # the serve/decode span's spec_segments/accepted keep
                    # the report's cadence estimator off multi-token steps
                    marks["spec_segments"] = marks.get("spec_segments", 0) + 1
                    marks["spec_accepted"] = marks.get("spec_accepted", 0) + n_accepted
            if n_cols:
                self.spec_drafter.observe_tokens(
                    row, [int(t) for t in tok_host[slot, :n_cols]]
                )
        if self.token_sink is not None:
            # one sink call per accepted depth keeps the one-token
            # {row: token} contract, in emission order
            for j in range(acc_host.shape[1]):
                emitted = {
                    row: int(tok_host[slot, j])
                    for slot, row in self._busy_rows.items()
                    if acc_host[slot, j]
                }
                if emitted:
                    self.token_sink(emitted)
        registry = telemetry.get_metrics()
        registry.gauge("engine/spec_accept_rate").set(self.stats.spec_accept_rate)
        registry.gauge("engine/spec_tokens_per_step").set(self.stats.spec_tokens_per_step)
        self._staged_drafts = self._draft_now()
        self._poll_done(done)

    def _decode_once(self) -> None:
        done, token, emitted_mask = self.decode_step()
        self.stats.decode_steps += 1
        self.stats.occupancy_sum += len(self._busy_rows)
        if self.trace_requests:
            # one (step wall, admission epoch) pair per decode step: an
            # epoch change inside a row's window marks the admission that
            # interrupted its decode run
            self._step_log.append((monotonic(), self.stats.prefills))
        for slot in self._busy_rows:
            self._t_host[slot] += 1
        if self.token_sink is not None or self.spec_drafter is not None:
            # the stream tap, and the drafter's histories through
            # draftless steps
            tok_host = token.cpu().numpy()
            emitted_host = emitted_mask.cpu().numpy()
            emitted = {
                row: int(tok_host[slot])
                for slot, row in self._busy_rows.items()
                if emitted_host[slot]
            }
            if self.spec_drafter is not None:
                for row, tok in emitted.items():
                    self.spec_drafter.observe_tokens(row, [tok])
            if self.token_sink is not None and emitted:
                self.token_sink(emitted)
        self._poll_done(done)

    def _poll_done(self, done: torch.Tensor) -> None:
        """Amortized done polling (the flags are sticky, so fetching every
        k-th step's flags is exact). The fetch waits for the device, so it
        is also where the first-token marks are taken."""
        self._steps_since_poll += 1
        if self._steps_since_poll < self.done_poll_interval:
            return
        self._steps_since_poll = 0
        done_host = done.cpu().numpy()
        self.stats.done_polls += 1
        # occupancy timeseries: one gauge sample per paid done-poll
        telemetry.get_metrics().gauge("engine/slot_util").set(self.stats.slot_util)
        now = monotonic()
        for row in self._awaiting_first:
            marks = self._req_times.get(row)
            if marks is not None:
                marks["first_token"] = now
        self._awaiting_first = set()
        for slot, row in self._busy_rows.items():
            if done_host[slot] and slot not in self._done_slots:
                self._done_slots.append(slot)
                if self.trace_requests:
                    # the host-visible decode end, where the harvest-wait
                    # stage starts (with polling every k steps it lags the
                    # device by up to k - 1 steps)
                    marks = self._req_times.get(row)
                    if marks is not None:
                        marks["done"] = now
                        marks["done_step"] = self._step_base + len(self._step_log)
