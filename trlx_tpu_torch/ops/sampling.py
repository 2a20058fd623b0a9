"""Token selection and the fixed-batch samplers (counterpart of
:mod:`trlx_tpu.ops.sampling`: ``GenerationConfig``, ``validate_gen_config``,
``suppress_eos_before_min``, ``filter_logits``, ``choose_tokens``,
``accept_drafts``, ``make_sampler`` and ``make_seq2seq_sampler``).

Sampling is ``argmax(filtered_logits + gumbel_noise)``, which is how
``jax.random.categorical`` samples, so a test that injects the JAX
package's Gumbel draws gets the same tokens. At runtime the engine draws
the noise from per-row ``torch.Generator``\\ s seeded from (phase seed, row
draw index, step) — each row's tokens depend on its own seed and logits,
never on admission order or batch composition (:func:`row_noise`). The
fixed-batch sampler draws one [B, V] block of noise per decode step from
the caller's generator (:func:`gumbel_noise`); under ``per_row_rng`` it
draws each row as the engine does, from the rows' draw indices, so the two
engines give a row the same tokens; or it takes the noise from an injected
``noise_fn`` (the tests hand it the JAX package's draws). The
seq2seq sampler draws the same way: the reference's key lineage there is
one ``split`` per step of a batch key.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from trlx_tpu_torch.data.ppo_types import SampleOutput


@dataclass(frozen=True)
class GenerationConfig:
    """Generation parameters (same fields and defaults as
    :class:`trlx_tpu.ops.sampling.GenerationConfig`)."""

    max_new_tokens: int = 48
    min_new_tokens: int = 0
    min_length: int = 0
    max_length: int = 0
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    do_sample: bool = True
    eos_token_id: int = 50256
    pad_token_id: int = 50256
    forced_bos_token_id: int = -1
    decoder_start_token_id: int = 0
    decode_segment_size: int = 8
    per_row_rng: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GenerationConfig":
        d = dict(d)
        # reference configs write HF's ``max_length`` as their gen budget
        if "max_length" in d and "max_new_tokens" not in d:
            d["max_new_tokens"] = d["max_length"]
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        # reference YAMLs write numeric fields as floats (``top_k: 0.0``)
        for name in ("max_new_tokens", "min_new_tokens", "min_length",
                     "max_length", "top_k",
                     "eos_token_id", "pad_token_id", "forced_bos_token_id",
                     "decoder_start_token_id", "decode_segment_size"):
            if name in d and d[name] is not None:
                d[name] = int(d[name])
        return cls(**d)


def validate_gen_config(cfg: GenerationConfig, vocab_size, provided=None) -> None:
    """Fail loudly on token ids outside the model's vocab. With
    ``provided`` (the keys the user actually set), only those are checked."""
    if not vocab_size:
        return
    for name in ("eos_token_id", "pad_token_id", "forced_bos_token_id",
                 "decoder_start_token_id"):
        if provided is not None and name not in provided:
            continue
        tid = getattr(cfg, name)
        if tid is None or tid < 0:
            continue
        if tid >= vocab_size:
            raise ValueError(
                f"gen_kwargs {name}={tid} is outside the model vocab "
                f"(vocab_size={vocab_size}) — check that the generation "
                f"config matches the checkpoint/arch"
            )


def suppress_eos_before_min(logits, t, cfg: GenerationConfig, min_new=None):
    """Mask the eos logit while ``t < min_new`` (HF MinLengthLogitsProcessor
    semantics, applied before top-k/top-p); no-op when eos is unset."""
    if min_new is None or cfg.eos_token_id is None or cfg.eos_token_id < 0:
        return logits
    active = torch.as_tensor(t < min_new, device=logits.device)
    if active.dim() == 0:
        active = active[None]
    eos_col = torch.zeros(logits.shape[-1], dtype=torch.bool, device=logits.device)
    eos_col[cfg.eos_token_id] = True
    return logits.masked_fill(active[:, None] & eos_col[None, :], float("-inf"))


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Set every element outside the top-k of the last axis to -inf."""
    if k >= x.shape[-1]:
        return x
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    return x.masked_fill(x < kth, float("-inf"))


def filter_logits(logits: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    """Temperature / top-k / top-p filtering (f32 in, f32 out)."""
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    if cfg.top_k > 0:
        logits = topk_mask(logits, cfg.top_k)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative prob exceeds top_p (>= 1 token)
        kth = (cum - probs < cfg.top_p).sum(-1, keepdim=True)
        threshold = torch.gather(sorted_logits, -1, kth - 1)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    return logits


def choose_tokens(
    gen_config: GenerationConfig,
    logits_last: torch.Tensor,  # [B, V] f32 raw logits
    t,  # int or [B] per-row decode step
    finished: torch.Tensor,  # [B] bool
    value_last: torch.Tensor,  # [B] f32
    n_real: torch.Tensor,  # [B] real prompt lengths
    min_new=None,  # int/[B] eos-suppression horizon (None = off)
    noise: Optional[torch.Tensor] = None,  # [B, V] Gumbel draws (sampling)
):
    """One decode step's token selection, with the JAX package's exact
    semantics. Returns ``(token, live_i32, logprob, value_out,
    finished_next)``: finished rows emit ``(pad, 0, 0.0, 0.0)``; the
    behaviour logprob is taken under the RAW logits; ``finished_next``
    folds in eos and the total-length cap. Sampling needs ``noise``."""
    B = logits_last.shape[0]
    dev = logits_last.device
    t = torch.as_tensor(t, device=dev)
    choice_logits = suppress_eos_before_min(logits_last, t, gen_config, min_new)
    if gen_config.do_sample:
        if noise is None:
            raise ValueError("choose_tokens: do_sample needs Gumbel noise")
        token = torch.argmax(filter_logits(choice_logits, gen_config) + noise, dim=-1)
    else:
        token = torch.argmax(choice_logits, dim=-1)
    token = token.to(torch.int32)
    if gen_config.forced_bos_token_id >= 0:
        token = torch.where(
            t == 0,
            torch.full((B,), gen_config.forced_bos_token_id, dtype=torch.int32, device=dev),
            token,
        )
    pad = torch.full_like(token, gen_config.pad_token_id)
    token = torch.where(finished, pad, token)
    logprob = (
        torch.gather(logits_last, -1, token.long()[:, None])[:, 0]
        - torch.logsumexp(logits_last, dim=-1)
    )
    live = ~finished
    zero = torch.zeros_like(logprob)
    logprob = torch.where(live, logprob, zero)
    value_out = torch.where(live, value_last, zero)
    finished = finished | (token == gen_config.eos_token_id)
    if gen_config.max_length > 0:
        finished = finished | (n_real + t + 1 >= gen_config.max_length)
    return token, live.to(torch.int32), logprob, value_out, finished


def accept_drafts(
    gen_config: GenerationConfig,
    logits_seq: torch.Tensor,  # [B, D, V] f32: column j-1 predicts token t0 + j
    values_seq: torch.Tensor,  # [B, D] f32 value estimates at those columns
    t0: torch.Tensor,  # [B] decode step of the anchor token
    finished: torch.Tensor,  # [B] bool AFTER the anchor (its finished_next)
    accepted0: torch.Tensor,  # [B] bool: the anchor token was live
    n_real: torch.Tensor,  # [B] real prompt lengths
    draft: torch.Tensor,  # [B, D] proposed tokens for t0+1..t0+D
    draft_len: torch.Tensor,  # [B] valid draft columns (0..D)
    noise: Optional[torch.Tensor] = None,  # [B, D, V] Gumbel draws at t0+1..t0+D
    min_new=None,
    budget: int = 0,  # R: tokens past it are never accepted
):
    """Longest-prefix draft acceptance, the speculative verify step's token
    rule: at every drafted position run :func:`choose_tokens` (under the
    row's own noise at step ``t0 + j``) and accept draft ``j`` iff every
    earlier position was accepted and the sample equals the draft. Token
    ``t`` of a row is a function of its noise at ``t`` and its logits at
    ``t``, and the accepted prefix reproduces the one-token loop's inputs,
    so accepted tokens are the tokens that loop would have sampled.
    Returns ``(tokens, accepted, logprobs, values, n_accepted,
    finished_next)``, [B, D] and [B]; ``accepted`` is a contiguous int32
    prefix mask per row."""
    B, D = draft.shape[0], draft.shape[1]
    dev = logits_seq.device
    acc_prev = torch.as_tensor(accepted0, device=dev).bool()
    fin = finished
    n_acc = torch.zeros(B, dtype=torch.long, device=dev)
    t0 = torch.as_tensor(t0, device=dev).long()
    draft = draft.to(dev)
    draft_len = torch.as_tensor(draft_len, device=dev)
    toks, accs, lps, vals = [], [], [], []
    for j in range(1, D + 1):
        token, live, logprob, value_out, fin_next = choose_tokens(
            gen_config, logits_seq[:, j - 1], t0 + j, fin, values_seq[:, j - 1],
            n_real, min_new=min_new,
            noise=None if noise is None else noise[:, j - 1],
        )
        ok = (
            acc_prev & (live == 1) & (j <= draft_len)
            & (token.long() == draft[:, j - 1].long()) & (t0 + j < budget)
        )
        # finished advances only along the accepted prefix: a rejected
        # position's eos is sampled again by a later step
        fin = torch.where(ok, fin_next, fin)
        n_acc = n_acc + ok.long()
        acc_prev = ok
        toks.append(token)
        accs.append(ok.to(torch.int32))
        lps.append(logprob)
        vals.append(value_out)
    return (
        torch.stack(toks, 1), torch.stack(accs, 1), torch.stack(lps, 1),
        torch.stack(vals, 1), n_acc, fin,
    )


def _mix64(x: int) -> int:
    """splitmix64 finaliser: a well-spread 64-bit hash of ``x``."""
    x &= 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def row_seed(phase_seed: int, row: int, t: int) -> int:
    """Generator seed of (phase seed, row draw index, step)."""
    h = _mix64(phase_seed)
    h = _mix64(h ^ (row + 0x9E3779B97F4A7C15))
    h = _mix64(h ^ (t + 0xD1B54A32D192ED03))
    return h & 0x7FFFFFFFFFFFFFFF


def row_noise(
    phase_seed: int,
    rows: Sequence[Optional[int]],  # draw index per slot, None = idle slot
    steps: Sequence[int],
    vocab_size: int,
    device,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """[B, V] f32 Gumbel noise, row b drawn from a generator seeded with
    :func:`row_seed` ``(phase_seed, rows[b], steps[b])``. Idle slots
    (``None``) draw nothing and get a constant row: their emissions are
    discarded."""
    device = torch.device(device)
    gen = generator or torch.Generator(device=device)
    noise = torch.zeros((len(rows), vocab_size), dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for b, (row, t) in enumerate(zip(rows, steps)):
        if row is None:
            continue
        gen.manual_seed(row_seed(phase_seed, int(row), int(t)))
        noise[b] = torch.rand(vocab_size, generator=gen, device=device)
    u = noise.clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, f32: -log(-log(U)), U clamped off 0."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def make_sampler(
    apply_fn: Callable,
    init_cache_fn: Callable,
    gen_config: GenerationConfig,
    query_length: int,
    with_values: bool = True,
):
    """Build ``sampler(prompt_ids, prompt_mask, generator=None,
    noise_fn=None, rows=None, phase_seed=0) -> SampleOutput``, the
    fixed-batch rollout sampler.

    ``apply_fn(input_ids, attention_mask=, position_ids=, cache=,
    cache_index=, last_only=)`` is the policy forward (logits, values and
    the in-place KV cache; with ``with_values=False`` no values are read
    and the sampler's come out as zeros); ``init_cache_fn(batch,
    capacity)`` builds the linear KV buffers of capacity Q + R. The prompt prefill computes the
    heads for its last position only; then one token per step for R steps,
    each row's token, behaviour logprob and value chosen by
    :func:`choose_tokens` (finished rows emit ``(pad, 0, 0.0, 0.0)``).
    Decoding runs in segments of ``gcd(R, decode_segment_size)`` steps; at
    each segment start, once every row is finished, the rest is emitted as
    pads without another forward (the JAX package's early exit). The
    forward after the last token, whose logits nothing reads, is not run.
    Sampling draws each step's noise from ``generator``; under
    ``gen_config.per_row_rng`` from :func:`row_noise` of ``phase_seed``,
    ``rows`` (the rows' draw indices) and the step; or from
    ``noise_fn(t)`` ([B, V] Gumbel draws) when given.

    ``shard=(start, global_batch, all_finished)`` samples rows ``start ..
    start + B`` of a global batch, as a data-parallel rank does: the
    generator draws the global batch's noise and the rows take theirs
    (``noise_fn`` may return the global batch's too), and the early exit
    waits for ``all_finished(finished)``, every rank's rows, so that each
    rank draws what a one-process run of the global batch draws."""
    Q = query_length
    R = gen_config.max_new_tokens
    cap = Q + R
    seg = (
        math.gcd(R, gen_config.decode_segment_size)
        if gen_config.decode_segment_size > 0
        else R
    )

    def last_values(out, col: int) -> torch.Tensor:
        if with_values:
            return out["values"][:, col].float()
        logits = out["logits"]
        return torch.zeros(logits.shape[0], device=logits.device)

    @torch.no_grad()
    def sampler(prompt_ids, prompt_mask, generator=None, noise_fn=None,
                rows=None, phase_seed: int = 0, shard=None) -> SampleOutput:
        B = prompt_ids.shape[0]
        dev = prompt_ids.device
        start, global_b, all_finished = shard or (0, B, lambda f: bool(f.all()))
        per_row = gen_config.per_row_rng and gen_config.do_sample and noise_fn is None
        if per_row:
            if rows is None or len(rows) != B:
                raise ValueError("per_row_rng sampling needs each row's draw index (rows)")
            scratch = torch.Generator(device=dev)  # reseeded per row and step
        prompt_mask = prompt_mask.long()
        n_real = prompt_mask.sum(-1)
        min_new = None
        if gen_config.min_new_tokens > 0 or gen_config.min_length > 0:
            min_new = (gen_config.min_length - n_real).clamp_min(
                gen_config.min_new_tokens
            )
        cache = init_cache_fn(B, cap)
        out = apply_fn(
            prompt_ids,
            attention_mask=torch.cat([prompt_mask, prompt_mask.new_zeros(B, R)], 1),
            position_ids=(prompt_mask.cumsum(-1) - 1).clamp_min(0),
            cache=cache,
            cache_index=0,
            last_only=True,
        )
        logits_last = out["logits"][:, -1].float()
        value_last = last_values(out, -1)
        finished = (
            n_real >= gen_config.max_length if gen_config.max_length > 0
            else torch.zeros(B, dtype=torch.bool, device=dev)
        )
        tokens = torch.full((B, R), gen_config.pad_token_id, dtype=torch.int32, device=dev)
        mask = torch.zeros((B, R), dtype=torch.int32, device=dev)
        logprobs = torch.zeros((B, R), device=dev)
        values = torch.zeros((B, R), device=dev)
        full_mask = torch.cat([prompt_mask, prompt_mask.new_ones(B, R)], 1)
        slots = torch.arange(cap, device=dev)[None, :]
        for t in range(R):
            if t % seg == 0 and seg < R and all_finished(finished):
                break  # every later step would emit (pad, 0, 0.0, 0.0)
            noise = None
            if noise_fn is not None:
                noise = noise_fn(t)
            elif per_row:
                noise = row_noise(phase_seed, rows, [t] * B, logits_last.shape[-1], dev, scratch)
            elif gen_config.do_sample:
                noise = gumbel_noise((global_b, logits_last.shape[-1]), generator, dev)
            if noise is not None and noise.shape[0] != B:
                noise = noise[start:start + B]
            token, live, lp, value_out, finished = choose_tokens(
                gen_config, logits_last, t, finished, value_last, n_real,
                min_new=min_new, noise=noise,
            )
            tokens[:, t], mask[:, t], logprobs[:, t], values[:, t] = (
                token, live, lp, value_out
            )
            if t == R - 1:
                break
            out = apply_fn(
                token[:, None].long(),
                attention_mask=(slots <= Q + t).long() * full_mask,
                position_ids=(n_real + t)[:, None],
                cache=cache,
                cache_index=Q + t,
            )
            logits_last = out["logits"][:, 0].float()
            value_last = last_values(out, 0)
        return SampleOutput(
            tokens=tokens, response_mask=mask, logprobs=logprobs, values=values
        )

    return sampler


def make_seq2seq_sampler(model, init_cache_fn: Callable, gen_config: GenerationConfig):
    """Build ``sampler(prompt_ids, prompt_mask, generator=None,
    noise_fn=None) -> SampleOutput``, the encoder-decoder rollout sampler
    (the fork's T5 ``generate`` path).

    ``model`` has ``encode(ids, mask)``, ``init_cross_kv(hidden)``,
    ``decoder_rel_bias(capacity)`` and ``decode(ids, encoder_mask=,
    decoder_mask=, cache=, cache_index=, cross_kv=, rel_bias=)`` returning
    logits and values (:class:`~trlx_tpu_torch.models.heads.T5WithValueHead`);
    ``init_cache_fn(batch, capacity)`` builds the decoder's linear KV
    buffers. Per call: the encoder runs once, the cross-attention K/V once,
    and the decoder's [1, H, C, C] relative bias once (each step reads its
    row). The decoder-start token fills cache slot 0 (capacity R + 1, the
    start stripped from the response); ``forced_bos_token_id`` is emitted
    at step 0 when set. As in the reference, a finished row emits the pad
    with mask 0 but keeps the pad's behaviour logprob (under the raw
    logits) and the step's value; ``min_length`` and ``max_length`` count
    decoder tokens including the start token. The decode after the last
    token, whose logits nothing reads, is not run. Sampling draws each
    step's noise from ``generator``, or from ``noise_fn(t)`` ([B, V] Gumbel
    draws) when given."""
    R = gen_config.max_new_tokens
    cap = R + 1  # slot 0 = the decoder start token
    min_new = None
    if gen_config.min_new_tokens > 0 or gen_config.min_length > 0:
        min_new = max(gen_config.min_new_tokens, gen_config.min_length - 1)

    @torch.no_grad()
    def sampler(prompt_ids, prompt_mask, generator=None, noise_fn=None) -> SampleOutput:
        B = prompt_ids.shape[0]
        dev = prompt_ids.device
        encoder_hidden = model.encode(prompt_ids, prompt_mask)
        cross_kv = model.init_cross_kv(encoder_hidden)
        cache = init_cache_fn(B, cap)
        rel_bias = model.decoder_rel_bias(cap)
        slots = torch.arange(cap, device=dev)[None, :]

        def decode(ids, t):
            out = model.decode(
                ids, encoder_mask=prompt_mask,
                decoder_mask=(slots <= t).long().expand(B, cap),
                cache=cache, cache_index=t, cross_kv=cross_kv, rel_bias=rel_bias,
            )
            return out["logits"][:, -1].float(), out["values"][:, -1].float()

        start = torch.full((B, 1), gen_config.decoder_start_token_id, dtype=torch.long, device=dev)
        logits_last, value_last = decode(start, 0)
        finished = torch.full((B,), gen_config.max_length > 0 and 1 >= gen_config.max_length,
                              dtype=torch.bool, device=dev)
        tokens = torch.empty((B, R), dtype=torch.int32, device=dev)
        mask = torch.empty((B, R), dtype=torch.int32, device=dev)
        logprobs = torch.empty((B, R), device=dev)
        values = torch.empty((B, R), device=dev)
        for t in range(R):
            choice_logits = suppress_eos_before_min(logits_last, t, gen_config, min_new)
            if gen_config.do_sample:
                noise = (
                    noise_fn(t) if noise_fn is not None
                    else gumbel_noise(logits_last.shape, generator, dev)
                )
                token = torch.argmax(filter_logits(choice_logits, gen_config) + noise, dim=-1)
            else:
                token = torch.argmax(choice_logits, dim=-1)
            token = token.to(torch.int32)
            if t == 0 and gen_config.forced_bos_token_id >= 0:
                token = torch.full_like(token, gen_config.forced_bos_token_id)
            token = torch.where(finished, torch.full_like(token, gen_config.pad_token_id), token)
            tokens[:, t] = token
            mask[:, t] = (~finished).to(torch.int32)
            logprobs[:, t] = (
                torch.gather(logits_last, -1, token.long()[:, None])[:, 0]
                - torch.logsumexp(logits_last, dim=-1)
            )
            values[:, t] = value_last
            finished = finished | (token == gen_config.eos_token_id)
            if gen_config.max_length > 0 and t + 2 >= gen_config.max_length:
                finished = torch.ones_like(finished)  # start + t + 1 generated
            if t < R - 1:
                logits_last, value_last = decode(token[:, None].long(), t + 1)
        return SampleOutput(
            tokens=tokens, response_mask=mask, logprobs=logprobs, values=values
        )

    return sampler
