"""GPT-NeoX causal LM in PyTorch (counterpart of :mod:`trlx_tpu.models.neox`;
the reference's 20B PPO config, ``configs/ppo_neox20b.yml``).

Against GPT-J (:mod:`trlx_tpu_torch.models.gptj`): one fused
``query_key_value`` projection with a bias, whose output keeps HF's
head-major ``[H, 3 Dh]`` layout (q, k and v are slices of its ``[B, T, H,
3 Dh]`` view, so an HF checkpoint converts without a permutation);
rotary on the first ``int(Dh * rotary_pct)`` dims of each head in the
half-rotation convention; a ``dense`` output projection with a bias;
separate layer norms for the attention and the MLP (``ln_1``, ``ln_2``),
in parallel (``x + attn(ln_1(x)) + mlp(ln_2(x))``) or in sequence, chosen
by ``use_parallel_residual``; the MLP with the tanh-approximate GELU, as
the JAX package has it (HF's GPT-NeoX uses the exact ``gelu``: ROADMAP
queue 3); and an untied LM head without a bias whose logits are computed
in the compute dtype and returned in f32. The forward, the cache contract
and the hydra arguments are the shared
:class:`~trlx_tpu_torch.models.gpt2.DecoderLM`'s, so the trainers,
samplers, engine and server take the family as they take GPT-2 and GPT-J.

At D = 96 (hidden 6144 over 64 heads) every attention runs the kernels'
head-dim-96 instantiation on a CUDA tensor; v is read in place from the
fused projection (q and k are new tensors after the rotary).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.models.gpt2 import (
    Cache,
    DecoderLM,
    LayerNorm,
    Linear,
    _factory,
    kv_buffers,
    torch_dtype,
    validate_kv_cache_dtype,
    write_cache,
)
from trlx_tpu_torch.ops.attention import dot_product_attention
from trlx_tpu_torch.ops.rotary import apply_rotary_half, rotary_angles


@dataclass(frozen=True)
class NeoXConfig:
    """Architecture hyperparameters (HF ``GPTNeoXConfig`` field names; the
    defaults are GPT-NeoX-20B's). ``n_layer``, ``n_embd``, ``n_head`` and
    ``n_positions`` name them as the server and trainers read them."""

    vocab_size: int = 50432
    max_position_embeddings: int = 2048
    hidden_size: int = 6144
    num_hidden_layers: int = 44
    num_attention_heads: int = 64
    rotary_pct: float = 0.25
    rotary_emb_base: float = 10000.0
    use_parallel_residual: bool = True
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"  # "bfloat16" | "int8" | "auto"

    def __post_init__(self):
        validate_kv_cache_dtype(self.kv_cache_dtype)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NeoXConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def n_layer(self) -> int:
        return self.num_hidden_layers

    @property
    def n_embd(self) -> int:
        return self.hidden_size

    @property
    def n_head(self) -> int:
        return self.num_attention_heads

    @property
    def n_positions(self) -> int:
        return self.max_position_embeddings

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)


class NeoXAttention(nn.Module):
    def __init__(self, config: NeoXConfig, device=None):
        super().__init__()
        self.config = config
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        E = config.hidden_size
        self.query_key_value = Linear(E, 3 * E, dt, **fk)
        self.dense = Linear(E, E, dt, **fk)

    def forward(self, x, bias, sin, cos, cache_kv=None, cache_index=None, causal=False):
        cfg = self.config
        B, T, _ = x.shape
        hd, rd = cfg.head_dim, cfg.rotary_dim
        # HF layout: [B, T, H, 3 Dh], q/k/v slices per head; head-major, so
        # a tensor-parallel rank's contiguous column slice is whole heads
        qkv = self.query_key_value(x).view(B, T, -1, 3 * hd)
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        q = apply_rotary_half(q, sin, cos, rd)
        k = apply_rotary_half(k, sin, cos, rd)
        if cache_kv is not None:
            # bias width == attention view width (a prompt-only mask, the
            # chunked prefill, narrows the cache view to match)
            view_len = bias.shape[-1] if bias is not None else None
            k, v = write_cache(
                cache_kv, k, v, cache_index, torch_dtype(cfg.dtype), view_len
            )
        out = dot_product_attention(q, k, v, bias, causal=causal)
        return self.dense(out.reshape(B, T, -1))


class NeoXMLP(nn.Module):
    def __init__(self, config: NeoXConfig, device=None):
        super().__init__()
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        self.dense_h_to_4h = Linear(config.hidden_size, 4 * config.hidden_size, dt, **fk)
        self.dense_4h_to_h = Linear(4 * config.hidden_size, config.hidden_size, dt, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(x), approximate="tanh"))


class NeoXBlock(nn.Module):
    def __init__(self, config: NeoXConfig, device=None):
        super().__init__()
        self.config = config
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        eps = config.layer_norm_eps
        self.ln_1 = LayerNorm(config.hidden_size, eps, dt, **fk)
        self.attn = NeoXAttention(config, device)
        self.ln_2 = LayerNorm(config.hidden_size, eps, dt, **fk)
        self.mlp = NeoXMLP(config, device)

    def forward(self, x, bias, sin, cos, cache_kv=None, cache_index=None, causal=False):
        attn_out = self.attn(self.ln_1(x), bias, sin, cos, cache_kv, cache_index, causal)
        if self.config.use_parallel_residual:
            return x + attn_out + self.mlp(self.ln_2(x))
        x = x + attn_out
        return x + self.mlp(self.ln_2(x))


class NeoXModel(DecoderLM):
    """GPT-NeoX transformer with the untied, bias-free LM head and an
    explicit KV cache; the interface of
    :class:`~trlx_tpu_torch.models.gpt2.GPT2Model`.

    ``branch_start=k`` builds a hydra branch: blocks ``k`` and up, ``ln_f``,
    ``lm_head`` and ``wte`` (what the JAX trainer's reference subset keeps:
    everything but the trunk blocks), under their full model's names."""

    def __init__(self, config: NeoXConfig, device=None, branch_start: Optional[int] = None):
        super().__init__()
        self.config = config
        self.first_layer = branch_start or 0
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size, **fk)
        # keyed by layer index, so a branch's blocks keep their names
        self.h = nn.ModuleDict(
            {str(i): NeoXBlock(config, device)
             for i in range(self.first_layer, config.num_hidden_layers)}
        )
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_eps, dt, **fk)
        self.lm_head = Linear(config.hidden_size, config.vocab_size, dt, bias=False, **fk)

    def embed(self, input_ids, position_ids) -> torch.Tensor:
        return self.embed_tokens(input_ids).to(torch_dtype(self.config.dtype))

    def block_args(self, position_ids, x) -> tuple:
        """The rotary (sin, cos) every block takes: formed also when a
        branch runs from ``hidden_override``."""
        return rotary_angles(position_ids.expand(x.shape[0], x.shape[1]),
                             self.config.rotary_dim, self.config.rotary_emb_base)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """LM head on (already ``ln_f``-normalised) hidden states: a
        compute-dtype product without a bias, returned in f32."""
        return self.lm_head(hidden).float()


def init_neox_cache(config: NeoXConfig, batch_size: int, capacity: int, device=None,
                     extra_positions: int = 0, tp: int = 1) -> Cache:
    return kv_buffers(
        config.num_hidden_layers, batch_size, capacity, config.num_attention_heads // tp,
        config.head_dim, config.dtype, config.kv_cache_dtype, device=device,
        extra_positions=extra_positions,
    )
