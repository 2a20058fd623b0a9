"""GPT-J causal LM in PyTorch (counterpart of :mod:`trlx_tpu.models.gptj`;
the reference's 6B PPO config, ``configs/ppo_gptj.yml``).

Against GPT-2 (:mod:`trlx_tpu_torch.models.gpt2`): no position embeddings
(rotary, the interleaved convention, on the first ``rotary_dim`` dims of
each head's queries and keys), attention and MLP computed *in parallel*
from one layer norm (``x + attn(ln_1(x)) + mlp(ln_1(x))``), bias-free
q/k/v/out projections, and an untied LM head with a bias whose logits are
computed in the compute dtype and returned in f32, as the flax module's
``Dense`` does. The forward, the cache contract (linear or paged, written
in place through :func:`~trlx_tpu_torch.models.gpt2.write_cache`) and the
hydra arguments are GPT-2's, from the shared
:class:`~trlx_tpu_torch.models.gpt2.DecoderLM`, so the trainers, samplers,
engine and server take either family. The rotary angles are formed from
the position ids also when a hydra branch runs from ``hidden_override``.

At D = 256 (n_embd 4096 over 16 heads) every attention runs the kernels'
head-dim-256 instantiation on a CUDA tensor.
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
from trlx_tpu_torch.ops.rotary import apply_rotary_interleaved, rotary_angles


@dataclass(frozen=True)
class GPTJConfig:
    """Architecture hyperparameters (HF ``GPTJConfig`` field names; the
    defaults are GPT-J-6B's)."""

    vocab_size: int = 50400
    n_positions: int = 2048
    n_embd: int = 4096
    n_layer: int = 28
    n_head: int = 16
    rotary_dim: int = 64
    layer_norm_epsilon: float = 1e-5
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"  # "bfloat16" | "int8" | "auto"

    def __post_init__(self):
        validate_kv_cache_dtype(self.kv_cache_dtype)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GPTJConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class GPTJAttention(nn.Module):
    def __init__(self, config: GPTJConfig, device=None):
        super().__init__()
        self.config = config
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        E = config.n_embd
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Linear(E, E, dt, bias=False, **fk))

    def forward(self, x, bias, sin, cos, cache_kv=None, cache_index=None, causal=False):
        cfg = self.config
        B, T, _ = x.shape
        hd = cfg.n_embd // cfg.n_head
        # the head count is the projections' width over the head dim (a
        # tensor-parallel rank's heads)
        q = self.q_proj(x).view(B, T, -1, hd)
        k = self.k_proj(x).view(B, T, -1, hd)
        v = self.v_proj(x).view(B, T, -1, hd)
        q = apply_rotary_interleaved(q, sin, cos, cfg.rotary_dim)
        k = apply_rotary_interleaved(k, sin, cos, cfg.rotary_dim)
        if cache_kv is not None:
            # bias width == attention view width (a prompt-only mask, the
            # chunked prefill, narrows the cache view to match)
            view_len = bias.shape[-1] if bias is not None else None
            k, v = write_cache(
                cache_kv, k, v, cache_index, torch_dtype(cfg.dtype), view_len
            )
        out = dot_product_attention(q, k, v, bias, causal=causal)
        return self.out_proj(out.reshape(B, T, -1))


class GPTJMLP(nn.Module):
    def __init__(self, config: GPTJConfig, device=None):
        super().__init__()
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        self.fc_in = Linear(config.n_embd, 4 * config.n_embd, dt, **fk)
        self.fc_out = Linear(4 * config.n_embd, config.n_embd, dt, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(F.gelu(self.fc_in(x), approximate="tanh"))


class GPTJBlock(nn.Module):
    def __init__(self, config: GPTJConfig, device=None):
        super().__init__()
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        self.ln_1 = LayerNorm(config.n_embd, config.layer_norm_epsilon, dt, **fk)
        self.attn = GPTJAttention(config, device)
        self.mlp = GPTJMLP(config, device)

    def forward(self, x, bias, sin, cos, cache_kv=None, cache_index=None, causal=False):
        h = self.ln_1(x)
        attn_out = self.attn(h, bias, sin, cos, cache_kv, cache_index, causal)
        return x + attn_out + self.mlp(h)  # parallel residual branches


class GPTJModel(DecoderLM):
    """GPT-J transformer with the untied, biased LM head and an explicit KV
    cache; the interface of :class:`~trlx_tpu_torch.models.gpt2.GPT2Model`.

    ``branch_start=k`` builds a hydra branch: blocks ``k`` and up, ``ln_f``,
    ``lm_head`` and ``wte`` (what the JAX trainer's reference subset keeps:
    everything but the trunk blocks), under their full model's names."""

    def __init__(self, config: GPTJConfig, device=None, branch_start: Optional[int] = None):
        super().__init__()
        self.config = config
        self.first_layer = branch_start or 0
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        self.wte = nn.Embedding(config.vocab_size, config.n_embd, **fk)
        # keyed by layer index, so a branch's blocks keep their names
        self.h = nn.ModuleDict(
            {str(i): GPTJBlock(config, device) for i in range(self.first_layer, config.n_layer)}
        )
        self.ln_f = LayerNorm(config.n_embd, config.layer_norm_epsilon, dt, **fk)
        self.lm_head = Linear(config.n_embd, config.vocab_size, dt, **fk)

    def embed(self, input_ids, position_ids) -> torch.Tensor:
        return self.embed_tokens(input_ids).to(torch_dtype(self.config.dtype))

    def block_args(self, position_ids, x) -> tuple:
        """The rotary (sin, cos) every block takes: formed also when a
        branch runs from ``hidden_override``."""
        return rotary_angles(position_ids.expand(x.shape[0], x.shape[1]), self.config.rotary_dim)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """LM head on (already ``ln_f``-normalised) hidden states: a
        compute-dtype product with its bias, returned in f32."""
        return self.lm_head(hidden).float()


def init_gptj_cache(config: GPTJConfig, batch_size: int, capacity: int, device=None,
                     extra_positions: int = 0, tp: int = 1) -> Cache:
    return kv_buffers(
        config.n_layer, batch_size, capacity, config.n_head // tp,
        config.n_embd // config.n_head, config.dtype, config.kv_cache_dtype,
        device=device, extra_positions=extra_positions,
    )
