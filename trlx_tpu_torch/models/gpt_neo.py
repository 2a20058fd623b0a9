"""GPT-Neo causal LM in PyTorch (counterpart of :mod:`trlx_tpu.models.gpt_neo`;
EleutherAI's GPT-Neo 1.3B and 2.7B, whose 16 or 20 heads of 128 run the
kernels' head-dim-128 instantiation on a CUDA tensor).

Against GPT-2 (:mod:`trlx_tpu_torch.models.gpt2`): separate bias-free
``q_proj``/``k_proj``/``v_proj`` and an ``out_proj`` with a bias;
**unscaled** attention logits, done as the JAX model does them, by
multiplying q by ``sqrt(head_dim)`` (computed in q's dtype: 11.3125 in bf16
at 128, not 11.3137) to cancel the attention core's ``1/sqrt(head_dim)``;
an MLP of ``nn.Linear`` layers ``c_fc``/``c_proj`` with ``gelu_new``; and
layers that alternate global and local attention per ``attention_types``.
A global layer takes the shared causal-LM dispatch (the kernel's causal
flag without a cache, the offset causal bias with one); a local layer
attends within a sliding window of ``window_size`` positions, which the
causal flag cannot express, so it always takes an explicit band bias
(:func:`local_causal_bias`, plus the padding bias) with ``causal=False``.
The learned position embeddings and the tied LM head with f32 logits are
GPT-2's. The forward, the cache contract and the hydra arguments are the
shared :class:`~trlx_tpu_torch.models.gpt2.DecoderLM`'s, whose
:meth:`~trlx_tpu_torch.models.gpt2.DecoderLM.attention_masks` hook this
model overrides, keyed by the absolute layer index, so a hydra branch
gives each of its blocks its own layer's treatment.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.models.gpt2 import (
    Cache,
    DecoderLM,
    GPT2Model,
    LayerNorm,
    Linear,
    _factory,
    kv_buffers,
    torch_dtype,
    validate_kv_cache_dtype,
    write_cache,
)
from trlx_tpu_torch.ops.attention import (
    NEG_INF,
    causal_dispatch,
    combine_biases,
    dot_product_attention,
    padding_bias,
)


def expand_attention_types(attention_types, n_layer: int) -> Tuple[str, ...]:
    """HF ``[[["global", "local"], 12]]`` -> the per-layer type tuple."""
    if not attention_types:
        return tuple("global" for _ in range(n_layer))
    layers: List[str] = []
    for pattern, repeat in attention_types:
        layers.extend(list(pattern) * repeat)
    if len(layers) != n_layer:
        raise ValueError(
            f"attention_types expands to {len(layers)} layers, expected {n_layer}"
        )
    return tuple(layers)


@dataclass(frozen=True)
class GPTNeoConfig:
    """Architecture hyperparameters (HF ``GPTNeoConfig`` field names; the
    defaults are GPT-Neo 1.3B's widths). ``n_layer``, ``n_embd``, ``n_head``
    and ``n_positions`` name them as the server and trainers read them."""

    vocab_size: int = 50257
    max_position_embeddings: int = 2048
    hidden_size: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: Optional[int] = None  # None -> 4 * hidden
    window_size: int = 256
    attention_layers: Tuple[str, ...] = ()  # per layer "global"/"local"; () -> all global
    layer_norm_epsilon: float = 1e-5
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"  # "bfloat16" | "int8" | "auto"

    def __post_init__(self):
        validate_kv_cache_dtype(self.kv_cache_dtype)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GPTNeoConfig":
        d = dict(d)
        if "attention_types" in d and "attention_layers" not in d:
            d["attention_layers"] = expand_attention_types(
                d.pop("attention_types"), d.get("num_layers", cls.num_layers)
            )
        if isinstance(d.get("attention_layers"), list):
            d["attention_layers"] = tuple(d["attention_layers"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def layer_types(self) -> Tuple[str, ...]:
        return self.attention_layers or tuple("global" for _ in range(self.num_layers))

    @property
    def inner_dim(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def n_layer(self) -> int:
        return self.num_layers

    @property
    def n_embd(self) -> int:
        return self.hidden_size

    @property
    def n_head(self) -> int:
        return self.num_heads

    @property
    def n_positions(self) -> int:
        return self.max_position_embeddings

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def local_causal_bias(
    q_len: int,
    kv_len: int,
    window: int,
    offset=0,
    device=None,
) -> torch.Tensor:
    """[1, 1, Q, K] additive f32 band bias: query i (at column i + offset)
    sees key column j iff j <= i + offset and i + offset - j < window, HF
    GPT-Neo's sliding window in the reference's column arithmetic. A [B]
    tensor ``offset`` (rows at different cache depths, the continuous
    engine's per-row ``cache_index``) gives [B, 1, Q, K]. A [B, Q]
    ``offset`` (the speculative verify step's per-column targets) is
    refused: the JAX package's band cannot take it (ROADMAP queue 3)."""
    if isinstance(offset, torch.Tensor):
        device = offset.device if device is None else device
        if offset.dim() == 2:
            raise NotImplementedError(
                "GPT-Neo's local attention band takes an int or a [B] cache_index, "
                f"not the verify step's [B, Q] one (got {tuple(offset.shape)}): the "
                "JAX package's local_causal_bias cannot either (ROADMAP queue 3), so "
                "spec_decode does not run on a GPT-Neo with local layers"
            )
    k_pos = torch.arange(kv_len, device=device)
    q_pos = torch.arange(q_len, device=device)
    if isinstance(offset, torch.Tensor) and offset.dim():
        q_abs = q_pos[None, :, None] + offset.to(device=device).long()[:, None, None]
        kb = k_pos[None, None, :]
        visible = (kb <= q_abs) & (q_abs - kb < window)  # [B, Q, K]
        return torch.where(visible, 0.0, NEG_INF).to(torch.float32)[:, None]
    q_abs = q_pos[:, None] + (offset.to(device) if isinstance(offset, torch.Tensor) else offset)
    visible = (k_pos[None, :] <= q_abs) & (q_abs - k_pos[None, :] < window)
    return torch.where(visible, 0.0, NEG_INF).to(torch.float32)[None, None]


@functools.lru_cache(maxsize=None)
def unscale_factor(head_dim: int, dtype: torch.dtype) -> float:
    """``sqrt(head_dim)`` as the reference forms it, in q's dtype (11.3125
    in bf16 at 128): q times it cancels the attention core's
    ``1/sqrt(head_dim)``, since GPT-Neo does not scale its logits."""
    return float(torch.tensor(head_dim, dtype=dtype) ** 0.5)


class GPTNeoAttention(nn.Module):
    """Type-agnostic: the caller hands a local layer the band bias and a
    global layer the causal dispatch."""

    def __init__(self, config: GPTNeoConfig, device=None):
        super().__init__()
        self.config = config
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        E = config.hidden_size
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, Linear(E, E, dt, bias=False, **fk))
        self.out_proj = Linear(E, E, dt, **fk)

    def forward(self, x, bias, cache_kv=None, cache_index=None, causal=False):
        cfg = self.config
        B, T, _ = x.shape
        H, hd = cfg.num_heads, cfg.head_dim
        q = self.q_proj(x).view(B, T, H, hd)
        k = self.k_proj(x).view(B, T, H, hd)
        v = self.v_proj(x).view(B, T, H, hd)
        if cache_kv is not None:
            # bias width == attention view width (a prompt-only mask, the
            # chunked prefill, narrows the cache view to match)
            view_len = bias.shape[-1] if bias is not None else None
            k, v = write_cache(
                cache_kv, k, v, cache_index, torch_dtype(cfg.dtype), view_len
            )
        q = q * unscale_factor(hd, q.dtype)
        out = dot_product_attention(q, k, v, bias, causal=causal)
        return self.out_proj(out.reshape(B, T, cfg.hidden_size))


class GPTNeoMLP(nn.Module):
    def __init__(self, config: GPTNeoConfig, device=None):
        super().__init__()
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        self.c_fc = Linear(config.hidden_size, config.inner_dim, dt, **fk)
        self.c_proj = Linear(config.inner_dim, config.hidden_size, dt, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))  # gelu_new


class GPTNeoBlock(nn.Module):
    def __init__(self, config: GPTNeoConfig, device=None):
        super().__init__()
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, eps, dt, **fk)
        self.attn = GPTNeoAttention(config, device)
        self.ln_2 = LayerNorm(config.hidden_size, eps, dt, **fk)
        self.mlp = GPTNeoMLP(config, device)

    def forward(self, x, bias, cache_kv=None, cache_index=None, causal=False):
        x = x + self.attn(self.ln_1(x), bias, cache_kv, cache_index, causal)
        return x + self.mlp(self.ln_2(x))


class GPTNeoModel(DecoderLM):
    """GPT-Neo transformer with learned positions, the tied LM head and an
    explicit KV cache; the interface of
    :class:`~trlx_tpu_torch.models.gpt2.GPT2Model`.

    ``branch_start=k`` builds a hydra branch: blocks ``k`` and up, ``ln_f``
    and ``wte`` (the tied head) only, under their full model's names."""

    # the embeddings (each table rounded to the compute dtype before the
    # add) and the tied head are GPT-2's
    embed = GPT2Model.embed
    logits = GPT2Model.logits

    def __init__(self, config: GPTNeoConfig, device=None, branch_start: Optional[int] = None):
        super().__init__()
        self.config = config
        self.first_layer = branch_start or 0
        fk = _factory(config, device)
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size, **fk)
        if branch_start is None:
            self.wpe = nn.Embedding(config.max_position_embeddings, config.hidden_size, **fk)
        # keyed by layer index, so a branch's blocks keep their names
        self.h = nn.ModuleDict(
            {str(i): GPTNeoBlock(config, device)
             for i in range(self.first_layer, config.num_layers)}
        )
        self.ln_f = LayerNorm(
            config.hidden_size, config.layer_norm_epsilon, torch_dtype(config.dtype), **fk
        )

    def attention_masks(self, q_len, cache, cache_index, attention_mask):
        """Global layers take the shared causal dispatch; local layers the
        band (the reference's ``local_causal_bias``) plus the padding bias,
        with ``causal=False``. With a cache the band spans the attention
        view (the mask's width, as the dispatch's) from ``cache_index``."""
        global_mask = causal_dispatch(q_len, cache, cache_index, attention_mask)
        types = self.config.layer_types
        if "local" not in types[self.first_layer:]:
            return lambda i: global_mask
        if cache is None:
            kv_len, offset = q_len, 0
        else:
            kv_len = (attention_mask.shape[-1] if attention_mask is not None
                      else cache[0]["k"].shape[1])
            offset = cache_index
        pad = padding_bias(attention_mask) if attention_mask is not None else None
        band = local_causal_bias(q_len, kv_len, self.config.window_size, offset,
                                 self.wte.weight.device)
        local_mask = (combine_biases(band, pad), False)
        return lambda i: local_mask if types[i] == "local" else global_mask


def init_gpt_neo_cache(config: GPTNeoConfig, batch_size: int, capacity: int,
                       device=None, extra_positions: int = 0) -> Cache:
    return kv_buffers(
        config.num_layers, batch_size, capacity, config.num_heads, config.head_dim,
        config.dtype, config.kv_cache_dtype, device=device,
        extra_positions=extra_positions,
    )
