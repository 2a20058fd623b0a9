"""T5/UL2 encoder-decoder in PyTorch (counterpart of
:mod:`trlx_tpu.models.t5`).

The same architecture, numerics and cache contract as the flax module:

- RMS layer norm without bias or mean-centering, in f32, scaled by its f32
  weight before the cast to the compute dtype; pre-norm residuals;
- relative position bias buckets (encoder bidirectional, decoder causal),
  one table per stack, shared by its layers; the bias is f32 [1, H, Q, K];
- unscaled attention: q is pre-multiplied by ``sqrt(d_kv)`` to cancel the
  ``D^-0.5`` of the shared attention core (exact in bf16 for d_kv = 64);
- ReLU or gated-GELU feed-forward (``gelu(approximate="tanh")``, HF's
  ``gelu_new``), tied or untied LM head (the tied one rescales by
  ``d_model**-0.5``);
- a decoder self-attention KV cache written in place through
  :func:`trlx_tpu_torch.models.gpt2.write_cache`, and cross-attention K/V
  computed once per prompt batch for the seq2seq sampler.

Every attention goes through
:func:`trlx_tpu_torch.ops.attention.dot_product_attention`: K1 forward, K2
and K3 backward on a CUDA tensor. The self-attentions pass their bias as a
learned bias: it carries the relative position table, whose gradient K2
returns. Linear weights are f32 masters cast to the compute dtype per use.
Parameter names follow the flax tree (``enc.{i}.SelfAttention.q``, ...;
:mod:`trlx_tpu_torch.models.convert` maps ``enc_<i>``/``dec_<i>``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.models.gpt2 import Linear, kv_buffers, torch_dtype, write_cache
from trlx_tpu_torch.ops.attention import causal_bias, dot_product_attention, padding_bias

Cache = List[Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class T5Config:
    """Architecture hyperparameters (HF ``T5Config`` field names)."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # "relu" | "gated-gelu"
    tie_word_embeddings: bool = True
    decoder_start_token_id: int = 0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "T5Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def is_gated_act(self) -> bool:
        return "gated" in self.feed_forward_proj


def _factory(config: T5Config, device=None) -> Dict[str, Any]:
    return {"device": device, "dtype": torch_dtype(config.param_dtype)}


class T5LayerNorm(nn.Module):
    """RMS norm: no mean subtraction, no bias, f32 accumulation; the f32
    weight multiplies before the cast to the compute dtype."""

    def __init__(self, n: int, eps: float, compute_dtype, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n, device=device, dtype=dtype))
        self.eps = eps
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.eps)
        return (xf * self.weight.float()).to(self.compute_dtype)


def _log_buckets(num_buckets: int, max_exact: int, max_distance: int) -> torch.Tensor:
    """[max_distance + 1] int64: the log-spaced bucket of each distance n
    (entries below ``max_exact`` unused), in f32 exactly as the reference
    forms it. Computed on the CPU: the bucket edges of the encoder's table
    (n = 16, 32, 64 at 32 buckets over 128) sit where the f32 quotient is a
    whole number, and a device ``log`` that rounds otherwise would move
    them by one bucket. Beyond ``max_distance`` the bucket is the last."""
    n = torch.arange(max_distance + 1)
    ratio = torch.log(n.clamp_min(1).float() / max_exact) / torch.log(
        torch.tensor(max_distance / max_exact, dtype=torch.float32)
    )
    large = max_exact + (ratio * (num_buckets - max_exact)).to(torch.int64)
    return large.clamp_max(num_buckets - 1)


def relative_position_bucket(
    relative_position: torch.Tensor,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """T5's log-spaced relative position bucketing; the integers equal the
    reference's for every distance."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    table = _log_buckets(num_buckets, max_exact, max_distance).to(
        device=n.device, dtype=n.dtype
    )
    large = table[n.clamp_max(max_distance)]
    return ret + torch.where(n < max_exact, n, large)


class RelPosBias(nn.Module):
    """Relative attention bias table -> [1, H, Q, K] f32 additive bias."""

    def __init__(self, config: T5Config, bidirectional: bool, device=None):
        super().__init__()
        self.config = config
        self.bidirectional = bidirectional
        self.relative_attention_bias = nn.Embedding(
            config.relative_attention_num_buckets, config.num_heads,
            **_factory(config, device),
        )

    def forward(self, q_positions: torch.Tensor, k_positions: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        rel = k_positions[None, :] - q_positions[:, None]  # [Q, K]
        buckets = relative_position_bucket(
            rel, self.bidirectional, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance,
        )
        bias = self.relative_attention_bias(buckets)  # [Q, K, H]
        return bias.permute(2, 0, 1)[None].float()


class T5Attention(nn.Module):
    def __init__(self, config: T5Config, device=None):
        super().__init__()
        self.config = config
        inner = config.num_heads * config.d_kv
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        self.q = Linear(config.d_model, inner, dt, bias=False, **fk)
        self.k = Linear(config.d_model, inner, dt, bias=False, **fk)
        self.v = Linear(config.d_model, inner, dt, bias=False, **fk)
        self.o = Linear(inner, config.d_model, dt, bias=False, **fk)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, D] (already layer-normed)
        kv_source: Optional[torch.Tensor] = None,  # cross-attention keys source
        bias: Optional[torch.Tensor] = None,  # additive [*, H or 1, Q, K]
        cache_kv: Optional[Dict[str, torch.Tensor]] = None,
        cache_index=None,
        static_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross k, v
        learned_bias: bool = False,  # the bias carries the relative position table
    ) -> torch.Tensor:
        cfg = self.config
        B, T, _ = x.shape
        q = self.q(x).view(B, T, cfg.num_heads, cfg.d_kv)
        if static_kv is not None:
            k, v = static_kv
        else:
            k, v = self.project_kv(x if kv_source is None else kv_source)
            if cache_kv is not None:
                k, v = write_cache(cache_kv, k, v, cache_index, torch_dtype(cfg.dtype))
        # T5 attention is unscaled: cancel the core's 1/sqrt(d)
        q = q * math.sqrt(cfg.d_kv)
        out = dot_product_attention(q, k, v, bias, learned_bias=learned_bias)
        return self.o(out.reshape(B, T, cfg.num_heads * cfg.d_kv))

    def project_kv(self, src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """K and V [B, S, H, Dh] of ``src`` (the decode path's cross K/V)."""
        cfg = self.config
        B, S, _ = src.shape
        return (
            self.k(src).view(B, S, cfg.num_heads, cfg.d_kv),
            self.v(src).view(B, S, cfg.num_heads, cfg.d_kv),
        )


class T5FF(nn.Module):
    def __init__(self, config: T5Config, device=None):
        super().__init__()
        self.gated = config.is_gated_act
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        if self.gated:
            self.wi_0 = Linear(config.d_model, config.d_ff, dt, bias=False, **fk)
            self.wi_1 = Linear(config.d_model, config.d_ff, dt, bias=False, **fk)
        else:
            self.wi = Linear(config.d_model, config.d_ff, dt, bias=False, **fk)
        self.wo = Linear(config.d_ff, config.d_model, dt, bias=False, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            # HF "gated-gelu" resolves to gelu_new (the tanh approximation)
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = torch.relu(self.wi(x))
        return self.wo(h)


def _norm(config: T5Config, device=None) -> T5LayerNorm:
    return T5LayerNorm(
        config.d_model, config.layer_norm_epsilon, torch_dtype(config.dtype),
        **_factory(config, device),
    )


class T5EncoderBlock(nn.Module):
    def __init__(self, config: T5Config, device=None):
        super().__init__()
        self.ln_self = _norm(config, device)
        self.SelfAttention = T5Attention(config, device)
        self.ln_ff = _norm(config, device)
        self.DenseReluDense = T5FF(config, device)

    def forward(self, x, bias):
        x = x + self.SelfAttention(self.ln_self(x), bias=bias, learned_bias=True)
        return x + self.DenseReluDense(self.ln_ff(x))


class T5DecoderBlock(nn.Module):
    def __init__(self, config: T5Config, device=None):
        super().__init__()
        self.ln_self = _norm(config, device)
        self.SelfAttention = T5Attention(config, device)
        self.ln_cross = _norm(config, device)
        self.EncDecAttention = T5Attention(config, device)
        self.ln_ff = _norm(config, device)
        self.DenseReluDense = T5FF(config, device)

    def forward(self, x, self_bias, cross_bias, encoder_hidden=None,
                cache_kv=None, cache_index=None, cross_kv=None):
        x = x + self.SelfAttention(
            self.ln_self(x), bias=self_bias, cache_kv=cache_kv,
            cache_index=cache_index, learned_bias=True,
        )
        x = x + self.EncDecAttention(
            self.ln_cross(x), kv_source=encoder_hidden, bias=cross_bias,
            static_kv=cross_kv,
        )
        return x + self.DenseReluDense(self.ln_ff(x))


class T5Model(nn.Module):
    """Encoder-decoder with an explicit decode cache: ``forward`` (the
    teacher-forced training forward), ``encode``, ``decode`` (with an
    optional KV cache and precomputed cross K/V), ``logits`` and
    ``init_cross_kv``."""

    def __init__(self, config: T5Config, device=None):
        super().__init__()
        self.config = config
        fk = _factory(config, device)
        self.shared = nn.Embedding(config.vocab_size, config.d_model, **fk)
        self.enc_rel_bias = RelPosBias(config, bidirectional=True, device=device)
        self.dec_rel_bias = RelPosBias(config, bidirectional=False, device=device)
        self.enc = nn.ModuleList(T5EncoderBlock(config, device) for _ in range(config.num_layers))
        self.dec = nn.ModuleList(
            T5DecoderBlock(config, device) for _ in range(config.num_decoder_layers)
        )
        self.enc_final_ln = _norm(config, device)
        self.dec_final_ln = _norm(config, device)
        if not config.tie_word_embeddings:
            self.lm_head = Linear(
                config.d_model, config.vocab_size, torch_dtype(config.dtype), bias=False, **fk
            )

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.shared(ids).to(torch_dtype(self.config.dtype))

    def encode(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        T = input_ids.shape[1]
        x = self._embed(input_ids)
        pos = torch.arange(T, device=input_ids.device)
        bias = self.enc_rel_bias(pos, pos)  # [1, H, T, T]
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask)
        for block in self.enc:
            x = block(x, bias)
        return self.enc_final_ln(x)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """f32 logits: the tied head rescales by ``d_model**-0.5`` and sums
        compute-dtype products in f32; the untied head rounds its product
        to the compute dtype, as the reference's Dense does."""
        cfg = self.config
        if cfg.tie_word_embeddings:
            hidden = hidden * (cfg.d_model ** -0.5)
            emb = self.shared.weight.to(hidden.dtype)
            return torch.matmul(hidden.float(), emb.float().t())
        return self.lm_head(hidden).float()

    def init_cross_kv(self, encoder_hidden: torch.Tensor):
        """Per decoder layer, the cross-attention (K, V) of the encoder
        output."""
        return tuple(b.EncDecAttention.project_kv(encoder_hidden) for b in self.dec)

    def decoder_rel_bias(self, capacity: int, device=None) -> torch.Tensor:
        """The decoder's [1, H, C, C] relative bias over a cache of
        ``capacity`` slots: :meth:`decode` slices row ``cache_index`` of it,
        the same numbers as building the row per step."""
        pos = torch.arange(capacity, device=device or self.shared.weight.device)
        return self.dec_rel_bias(pos, pos)

    def decode(
        self,
        decoder_input_ids: torch.Tensor,  # [B, T]
        encoder_hidden: Optional[torch.Tensor] = None,
        encoder_mask: Optional[torch.Tensor] = None,
        decoder_mask: Optional[torch.Tensor] = None,  # [B, T] (training) / [B, C] (cache)
        cache: Optional[Cache] = None,
        cache_index: Optional[int] = None,
        cross_kv: Optional[Tuple] = None,
        rel_bias: Optional[torch.Tensor] = None,  # [1, H, C, C], with a cache
    ) -> Dict[str, Any]:
        """Returns ``{"logits", "hidden", "cache"}``; the cache is written
        in place at ``cache_index``. With a cache, the self-attention's
        relative bias is row ``cache_index`` of ``rel_bias``
        (:meth:`decoder_rel_bias`, built here when not given)."""
        T = decoder_input_ids.shape[1]
        dev = decoder_input_ids.device
        x = self._embed(decoder_input_ids)
        if cache is None:
            pos = torch.arange(T, device=dev)
            rel = self.dec_rel_bias(pos, pos)
            causal = causal_bias(T, T, device=dev)
        else:
            C = cache[0]["k"].shape[1]
            table = self.decoder_rel_bias(C, dev) if rel_bias is None else rel_bias
            rel = table[:, :, cache_index:cache_index + T]
            causal = causal_bias(T, C, cache_index, device=dev)
        self_bias = rel + causal
        if decoder_mask is not None:
            self_bias = self_bias + padding_bias(decoder_mask)
        cross_bias = padding_bias(encoder_mask) if encoder_mask is not None else None
        for i, block in enumerate(self.dec):
            x = block(
                x, self_bias, cross_bias,
                encoder_hidden=encoder_hidden,
                cache_kv=cache[i] if cache is not None else None,
                cache_index=cache_index,
                cross_kv=cross_kv[i] if cross_kv is not None else None,
            )
        x = self.dec_final_ln(x)
        return {"logits": self.logits(x), "hidden": x, "cache": cache}

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        decoder_input_ids: Optional[torch.Tensor] = None,
        decoder_attention_mask: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Teacher-forced forward: logits and hidden states over the
        decoder sequence, plus the encoder output."""
        encoder_hidden = self.encode(input_ids, attention_mask)
        out = self.decode(
            decoder_input_ids,
            encoder_hidden=encoder_hidden,
            encoder_mask=attention_mask,
            decoder_mask=decoder_attention_mask,
        )
        out["encoder_hidden"] = encoder_hidden
        return out


def init_t5_cache(config: T5Config, batch_size: int, capacity: int, device=None) -> Cache:
    """Fixed-capacity decoder self-attention KV buffers."""
    return kv_buffers(
        config.num_decoder_layers, batch_size, capacity, config.num_heads,
        config.d_kv, config.dtype, device=device,
    )


def shift_tokens_right(
    input_ids: torch.Tensor, pad_token_id: int, decoder_start_token_id: int
) -> torch.Tensor:
    """Teacher-forcing shift: the start token, then the ids but the last;
    a ``-100`` label becomes the pad."""
    shifted = torch.cat(
        [torch.full_like(input_ids[:, :1], decoder_start_token_id), input_ids[:, :-1]], 1
    )
    return torch.where(shifted == -100, torch.full_like(shifted, pad_token_id), shifted)
