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

Where the JAX package jits donated-state programs, the port runs eager
PyTorch and updates :class:`EngineState`'s tensors in place. Admission
prefill runs over the admitted rows only (no dummy rows — eager PyTorch
has no fixed program shape to keep) and writes their K/V straight into
their slots of the pool. Chunked prefill, the shared-prefix pool,
speculative decoding, weight pushes and request tracing come with later
slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

from trlx_tpu_torch.inference.kv_cache import (
    choose_block_size,
    identity_block_tables,
)
from trlx_tpu_torch.ops.sampling import GenerationConfig, choose_tokens, row_noise
from trlx_tpu_torch.utils import monotonic, resolve_device


@dataclasses.dataclass
class EngineState:
    """Device state of the slot pool; every tensor's leading axis is the
    slot axis. Updated in place."""

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
    prefills: int = 0  # admission prefill forwards
    decode_steps: int = 0  # decode forwards
    recycles: int = 0
    occupancy_sum: int = 0  # sum over steps of busy slots
    num_slots: int = 0
    done_polls: int = 0  # [B]-bool device->host fetches
    released: int = 0  # placeholder rows force-finished on admission

    @property
    def slot_util(self) -> float:
        denom = self.num_slots * self.decode_steps
        return self.occupancy_sum / denom if denom else 0.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "engine/admitted": float(self.admitted),
            "engine/completed": float(self.completed),
            "engine/prefills": float(self.prefills),
            "engine/decode_steps": float(self.decode_steps),
            "engine/slot_recycles": float(self.recycles),
            "engine/slot_util": round(self.slot_util, 4),
            "engine/done_polls": float(self.done_polls),
            "engine/released": float(self.released),
        }


class ContinuousBatchingEngine:
    """Slot-admission decode over a paged KV cache.

    :param apply_fn: the model forward ``apply_fn(input_ids,
        attention_mask, position_ids, cache, cache_index[, last_only]) ->
        {"logits", "values"}`` (a :class:`CausalLMWithValueHead`).
    :param init_cache_fn: ``(batch, capacity) -> linear KV buffers`` (the
        family's ``init_cache``); the engine allocates one extra position
        per slot (the discard sentinel) and adds the block tables.
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
        # queue entries: (ids, mask, row, release)
        self._queue: List[Tuple[np.ndarray, np.ndarray, int, bool]] = []
        self._free: List[int] = []
        self._busy_rows: Dict[int, int] = {}  # slot -> row index
        self._done_slots: List[int] = []
        self._recycle_counts = np.zeros(self.num_slots, np.int64)
        # host copy of each slot's step counter: equals the device ``t``
        # while the row is live, which is all the noise seeds need
        self._t_host = np.zeros(self.num_slots, np.int64)
        self._next_row = 0
        self._steps_since_poll = 0
        self._awaiting_first: Set[int] = set()
        self._gen = torch.Generator(device=self.device)
        self.stats = EngineStats(num_slots=self.num_slots)
        # per-request latency marks (host clock), popped by the server
        self._req_times: Dict[int, Dict[str, float]] = {}

    # ------------------------------ state ------------------------------ #

    def init_state(self) -> EngineState:
        """Fresh all-idle pool. Idle slots are ``active=False,
        finished=True``: ``choose_tokens`` emits (pad, 0, 0.0, 0.0) for
        them and their cache writes land on the discard sentinel."""
        B, Q, R, V = self.num_slots, self.Q, self.R, self.vocab_size
        dev = self.device
        tables = identity_block_tables(B, self.n_blocks, dev)
        cache = [
            dict(layer, block_tables=tables)
            for layer in self._init_cache_fn(B, self.capacity + 1)
        ]
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

    # ---------------------------- device work --------------------------- #

    @torch.no_grad()
    def prefill(self, slots, prompt_ids, prompt_mask, row_index, table_turns) -> None:
        """Admission: forward the admitted prompts ([A, Q] host arrays,
        left-padded), write their K/V through freshly rotated block tables
        into their slots, and seed the slots' sampling state."""
        cfg, st, dev = self.gen_config, self._state, self.device
        A, R, nb = len(slots), self.R, self.n_blocks
        slot_t = torch.as_tensor(np.asarray(slots), dtype=torch.long).to(dev)
        ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long).to(dev)
        mask = torch.as_tensor(np.asarray(prompt_mask), dtype=torch.long).to(dev)
        turns = torch.as_tensor(np.asarray(table_turns), dtype=torch.long).to(dev)
        tables = (
            (torch.arange(nb, device=dev)[None, :] + turns[:, None]) % nb
        ).to(torch.int32)
        group_cache = [
            {"k": layer["k"], "v": layer["v"], "block_tables": tables,
             "slots": slot_t}
            for layer in st.cache
        ]
        n_real = mask.sum(-1)
        out = self._apply_fn(
            ids,
            attention_mask=torch.cat([mask, mask.new_zeros(A, R)], dim=1),
            position_ids=(mask.cumsum(-1) - 1).clamp_min(0),
            cache=group_cache,
            cache_index=0,
            last_only=True,
        )
        st.cache[0]["block_tables"][slot_t] = tables  # shared by every layer
        logits_last = out["logits"][:, -1].float()
        value_last = out["values"][:, -1].float()
        if cfg.max_length > 0:
            finished0 = n_real >= cfg.max_length
        else:
            finished0 = torch.zeros(A, dtype=torch.bool, device=dev)
        st.t[slot_t] = 0
        st.n_real[slot_t] = n_real
        st.logits_last[slot_t] = logits_last
        st.value_last[slot_t] = value_last
        st.active[slot_t] = True
        st.finished[slot_t] = finished0
        st.out_tokens[slot_t] = cfg.pad_token_id
        st.out_mask[slot_t] = 0
        st.out_logprobs[slot_t] = 0.0
        st.out_values[slot_t] = 0.0
        st.query_ids[slot_t] = ids
        st.query_mask[slot_t] = mask
        st.row_index[slot_t] = torch.as_tensor(
            np.asarray(row_index), dtype=torch.long
        ).to(dev)

    @torch.no_grad()
    def decode_step(self):
        """One token for every slot. Finished/idle slots ride along with
        pad emissions whose output and cache writes are discarded.
        Returns ``(done, token, live)`` [B] device tensors."""
        cfg, st, dev = self.gen_config, self._state, self.device
        B, Q, R, cap = self.num_slots, self.Q, self.R, self.capacity
        noise = None
        if cfg.do_sample:
            rows = [self._busy_rows.get(s) for s in range(B)]
            if self.noise_fn is not None:
                noise = self.noise_fn(rows, self._t_host.tolist()).to(dev)
            else:
                noise = row_noise(
                    self._phase_seed, rows, self._t_host, self.vocab_size, dev,
                    self._gen,
                )
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
        out = self._apply_fn(
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
        return done, token, live

    @torch.no_grad()
    def refill(self, slots: List[int]) -> Dict[str, np.ndarray]:
        """Harvest ``slots``' finished rollouts (host arrays) and free the
        slots."""
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
        sampling noise, ``row_start`` offsets the global draw index."""
        self._phase_seed = int(seed)
        self._state = self.init_state()
        self._queue = []
        self._free = list(range(self.num_slots))
        self._busy_rows = {}
        self._done_slots = []
        self._recycle_counts[:] = 0
        self._t_host[:] = 0
        self._next_row = row_start
        self._steps_since_poll = 0
        self._awaiting_first = set()
        self.stats = EngineStats(num_slots=self.num_slots)
        self._req_times = {}

    def submit(self, prompt_ids, prompt_mask, *, release: bool = False,
               submit_times=None) -> List[int]:
        """Enqueue prompts (host arrays, [n, Q]); returns their global row
        indices (draw order — the per-row noise identity). ``release=True``
        marks padding placeholders (force-finished on admission);
        ``submit_times`` backdates the latency marks to when the request
        entered the serving tier."""
        ids = np.asarray(prompt_ids)
        mask = np.asarray(prompt_mask)
        if ids.ndim != 2 or ids.shape[1] != self.Q:
            raise ValueError(
                f"submit expects [n, Q={self.Q}] prompt ids, got {ids.shape}"
            )
        rows = []
        t_submit = monotonic()
        for i in range(ids.shape[0]):
            row = self._next_row
            self._next_row += 1
            self._queue.append((ids[i], mask[i], row, bool(release)))
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

    def pop_request_timing(self, row: int) -> Optional[Dict[str, float]]:
        """Latency decomposition of a HARVESTED row, in ms (popped):
        ``queue_wait_ms`` (submit → admission), ``prefill_ms`` (admission →
        first token on the host), ``ttft_ms``, ``decode_ms`` (first token →
        harvest), ``e2e_ms``. The first-token mark is taken when the first
        decode step after admission has been fetched to the host, so on a
        GPU it includes the device time, not just the dispatch."""
        marks = self._req_times.get(row)
        if not marks or "completed" not in marks:
            return None
        self._req_times.pop(row, None)
        submitted = marks["submitted"]
        admitted = marks.get("admitted", submitted)
        first = marks.get("first_token", admitted)
        completed = marks["completed"]
        ms = 1000.0
        return {
            "queue_wait_ms": max(0.0, (admitted - submitted) * ms),
            "prefill_ms": max(0.0, (first - admitted) * ms),
            "ttft_ms": max(0.0, (first - submitted) * ms),
            "decode_ms": max(0.0, (completed - first) * ms),
            "e2e_ms": max(0.0, (completed - submitted) * ms),
        }

    def _admit_group(self) -> None:
        """Admit the next group of at most ``admit_width`` queued prompts
        into free slots: one prefill forward."""
        take = min(len(self._free), len(self._queue), self.admit_width)
        slots = [self._free.pop(0) for _ in range(take)]
        entries = [self._queue.pop(0) for _ in range(take)]
        t_admit = monotonic()
        self.prefill(
            slots,
            np.stack([e[0] for e in entries]),
            np.stack([e[1] for e in entries]),
            [e[2] for e in entries],
            [int(self._recycle_counts[s]) for s in slots],
        )
        released = []
        for slot, (_, _, row, release) in zip(slots, entries):
            self._busy_rows[slot] = row
            self._t_host[slot] = 0
            if release:
                released.append(slot)
            marks = self._req_times.get(row)
            if marks is not None:
                marks["admitted"] = t_admit
            self._awaiting_first.add(row)
        if released:
            self.release(released)
            self.stats.released += len(released)
        self.stats.prefills += 1
        self.stats.admitted += take

    def _admit(self) -> None:
        while self._free and self._queue:
            self._admit_group()

    def _harvest_ready(self) -> Iterator[Dict[str, Any]]:
        """Yield fixed-width harvest groups while enough slots are done."""
        C = self.harvest_width
        while len(self._done_slots) >= C:
            slots = self._done_slots[:C]
            self._done_slots = self._done_slots[C:]
            outs = self.refill(slots)
            rows = [self._busy_rows.pop(s) for s in slots]
            t_done = monotonic()
            for r in rows:
                marks = self._req_times.get(r)
                if marks is not None:
                    marks["completed"] = t_done
            for s in slots:
                self._recycle_counts[s] += 1
                self._free.append(s)
            self.stats.recycles += C
            self.stats.completed += C
            outs["rows"] = rows  # host-side draw indices, harvest order
            yield outs

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
            self._admit()
            if not self._busy_rows:
                raise RuntimeError(
                    "engine starved: no active slots and no full harvest "
                    f"group ({len(self._done_slots)} done < {C})"
                )
            self._decode_once()

    def pump(self) -> List[Dict[str, Any]]:
        """One serving-loop iteration: harvest every ready group, admit
        queued prompts into vacated slots, then advance decode one step.
        Returns the harvested groups (possibly empty)."""
        groups = list(self._harvest_ready())
        self._admit()
        if self._busy_rows:
            self._decode_once()
        return groups

    def _decode_once(self) -> None:
        done, token, live = self.decode_step()
        self.stats.decode_steps += 1
        self.stats.occupancy_sum += len(self._busy_rows)
        for slot in self._busy_rows:
            self._t_host[slot] += 1
        if self.token_sink is not None:
            tok_host = token.cpu().numpy()
            live_host = live.cpu().numpy()
            emitted = {
                row: int(tok_host[slot])
                for slot, row in self._busy_rows.items()
                if live_host[slot]
            }
            if emitted:
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
        now = monotonic()
        for row in self._awaiting_first:
            marks = self._req_times.get(row)
            if marks is not None:
                marks["first_token"] = now
        self._awaiting_first = set()
        for slot in self._busy_rows:
            if done_host[slot] and slot not in self._done_slots:
                self._done_slots.append(slot)
