"""GPT-2 causal LM in PyTorch (counterpart of :mod:`trlx_tpu.models.gpt2`).

The same architecture, numerics and cache contract as the flax module:

- each projection runs in the compute dtype (``config.dtype``) with
  parameters stored in ``config.param_dtype`` and cast per use (a no-op
  once a server has cast its weights to the compute dtype);
- layer norms compute in f32 and round to the compute dtype; the tied LM
  head returns f32 logits (products of compute-dtype values summed in f32);
- every attention goes through
  :func:`trlx_tpu_torch.ops.attention.dot_product_attention`, so on a CUDA
  tensor it runs the hand-written flash kernel;
- the KV cache is a list over layers of ``{"k": [B, C, H, Dh], "v": ...}``
  (plus ``"block_tables"`` for the engine's paged cache,
  :mod:`trlx_tpu_torch.inference.kv_cache`). Where the JAX package
  returns updated buffers, the port writes them in place.

Parameter names follow the flax tree (``h.{i}.attn.c_attn``, ...);
:mod:`trlx_tpu_torch.models.convert` carries JAX params across and
:mod:`trlx_tpu_torch.models.conversion` loads HF checkpoints. The hydra
KL reference's arguments are the flax module's (``capture_hidden_at``,
``start_layer``, ``hidden_override``); :meth:`GPT2Model.hydra_branch`
builds the frozen branch. The int8 cache comes with a later slice and
raises until then.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.ops.attention import causal_dispatch, dot_product_attention

Cache = List[Dict[str, torch.Tensor]]

VALID_KV_CACHE_DTYPES = ("bfloat16", "int8", "auto")


def validate_kv_cache_dtype(value: str) -> None:
    if value not in VALID_KV_CACHE_DTYPES:
        raise ValueError(
            f"kv_cache_dtype={value!r} is not supported (choose one of "
            f"{VALID_KV_CACHE_DTYPES})"
        )


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (dtypes pass through)."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


@dataclass(frozen=True)
class GPT2Config:
    """Architecture hyperparameters (HF ``GPT2Config`` field names)."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"  # "int8"/"auto" come with a later slice

    def __post_init__(self):
        validate_kv_cache_dtype(self.kv_cache_dtype)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GPT2Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` (flax ``Dense``
    with ``dtype``/``param_dtype``): input, weight and bias (if any) are
    cast to the compute dtype per use."""

    def __init__(self, in_features, out_features, compute_dtype, **kw):
        super().__init__(in_features, out_features, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """Layer norm computed in f32, returned in the compute dtype."""

    def __init__(self, n, eps, compute_dtype, **kw):
        super().__init__(n, eps=eps, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        )
        return y.to(self.compute_dtype)


def _factory(config: GPT2Config, device=None) -> Dict[str, Any]:
    return {"device": device, "dtype": torch_dtype(config.param_dtype)}


class MLP(nn.Module):
    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        self.c_fc = Linear(config.n_embd, 4 * config.n_embd, dt, **fk)
        self.c_proj = Linear(4 * config.n_embd, config.n_embd, dt, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class Attention(nn.Module):
    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        self.config = config
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        self.c_attn = Linear(config.n_embd, 3 * config.n_embd, dt, **fk)
        self.c_proj = Linear(config.n_embd, config.n_embd, dt, **fk)

    def forward(self, x, bias, cache_kv=None, cache_index=None, causal=False):
        cfg = self.config
        B, T, _ = x.shape
        hd = cfg.n_embd // cfg.n_head
        q, k, v = self.c_attn(x).split(cfg.n_embd, dim=-1)
        q = q.view(B, T, cfg.n_head, hd)
        k = k.view(B, T, cfg.n_head, hd)
        v = v.view(B, T, cfg.n_head, hd)
        if cache_kv is not None:
            # write this step's K/V at cache_index, then attend over the
            # view the bias was built for (mask width == view width)
            view_len = bias.shape[-1] if bias is not None else None
            k, v = write_cache(
                cache_kv, k, v, cache_index, torch_dtype(cfg.dtype), view_len
            )
        out = dot_product_attention(q, k, v, bias, causal=causal)
        return self.c_proj(out.reshape(B, T, cfg.n_embd))


class Block(nn.Module):
    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.n_embd, eps, dt, **fk)
        self.attn = Attention(config, device)
        self.ln_2 = LayerNorm(config.n_embd, eps, dt, **fk)
        self.mlp = MLP(config, device)

    def forward(self, x, bias, cache_kv=None, cache_index=None, causal=False):
        x = x + self.attn(self.ln_1(x), bias, cache_kv, cache_index, causal)
        return x + self.mlp(self.ln_2(x))


class GPT2Model(nn.Module):
    """GPT-2 transformer with the tied-embedding LM head and an explicit KV
    cache. ``cache=None``: full-sequence causal forward. ``cache`` given:
    keys/values are written at ``cache_index`` (an int, or a [B] tensor of
    per-row positions) and ``attention_mask`` must cover the cache view.

    ``branch_start=k`` builds a hydra branch: blocks ``k`` and up, ``ln_f``
    and ``wte`` (the tied head) only, under their full model's names; it
    runs from a captured activation (``start_layer`` and
    ``hidden_override``)."""

    def __init__(self, config: GPT2Config, device=None, branch_start: Optional[int] = None):
        super().__init__()
        self.config = config
        self.first_layer = branch_start or 0
        fk = _factory(config, device)
        self.wte = nn.Embedding(config.vocab_size, config.n_embd, **fk)
        if branch_start is None:
            self.wpe = nn.Embedding(config.n_positions, config.n_embd, **fk)
        # keyed by layer index, so a branch's blocks keep their names
        self.h = nn.ModuleDict(
            {str(i): Block(config, device) for i in range(self.first_layer, config.n_layer)}
        )
        self.ln_f = LayerNorm(
            config.n_embd, config.layer_norm_epsilon,
            torch_dtype(config.dtype), **fk,
        )

    def hydra_branch(self, branch_start: int) -> "GPT2Model":
        """A frozen copy of blocks ``branch_start`` and up, ``ln_f`` and
        ``wte``: the hydra KL reference (the trunk blocks and ``wpe`` are
        left out)."""
        branch = GPT2Model(self.config, self.wte.weight.device, branch_start)
        kept = branch.state_dict().keys()
        branch.load_state_dict({k: v for k, v in self.state_dict().items() if k in kept})
        return branch.requires_grad_(False)

    def embed(self, input_ids, position_ids) -> torch.Tensor:
        # each table rounds to the compute dtype before the add. Engine rows
        # past their token budget ride along (outputs discarded) at
        # positions that can pass the table's end: clamp them, since an
        # out-of-range index is a device-side fault on a GPU
        dt = torch_dtype(self.config.dtype)
        position_ids = position_ids.clamp(0, self.config.n_positions - 1)
        return self.wte(input_ids).to(dt) + self.wpe(position_ids).to(dt)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied LM head: compute-dtype operands, f32 products and sums."""
        emb = self.wte.weight.to(torch_dtype(self.config.dtype))
        return torch.matmul(hidden.float(), emb.float().t())

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T]
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        cache: Optional[Cache] = None,
        cache_index=None,
        start_layer: int = 0,
        hidden_override: Optional[torch.Tensor] = None,
        capture_hidden_at: Optional[int] = None,
        compute_logits: bool = True,
    ) -> Dict[str, Any]:
        """Returns ``{"logits", "hidden", "cache"}``.

        The hydra arguments: ``start_layer=k`` with ``hidden_override``
        runs blocks ``k`` and up from that activation instead of the
        embeddings; ``capture_hidden_at=k`` returns the activation entering
        block ``k`` as ``"branch_hidden"`` and stops there (``logits`` and
        ``hidden`` are then ``None``). XLA prunes the blocks above the
        capture from the JAX trunk when only the capture is read; eager
        PyTorch would run them, so the pass ends at the capture."""
        if start_layer < self.first_layer:
            raise ValueError(
                f"start_layer={start_layer}: this branch holds blocks "
                f"{self.first_layer} and up"
            )
        if hidden_override is not None:
            T = hidden_override.shape[1]
            x = hidden_override.to(torch_dtype(self.config.dtype))
        else:
            T = input_ids.shape[1]
            if position_ids is None:
                if attention_mask is not None and cache is None:
                    position_ids = (attention_mask.long().cumsum(-1) - 1).clamp_min(0)
                else:
                    position_ids = torch.arange(T, device=input_ids.device)[None]
            x = self.embed(input_ids, position_ids)
        bias, causal = causal_dispatch(T, cache, cache_index, attention_mask)
        for i in range(start_layer, self.config.n_layer):
            if i == capture_hidden_at:
                return {"logits": None, "hidden": None, "cache": cache, "branch_hidden": x}
            x = self.h[str(i)](x, bias, cache[i] if cache is not None else None,
                               cache_index, causal)
        x = self.ln_f(x)
        return {
            "logits": self.logits(x) if compute_logits else None,
            "hidden": x,
            "cache": cache,
        }


def write_cache(cache_kv, k, v, cache_index, dtype, view_len=None):
    """Write this step's K/V into the capacity buffers at ``cache_index``
    (in place) and return ``(k, v)``, the buffers to attend over.

    - linear ``{"k", "v"}``: ``cache_index`` is an int (or 0-dim tensor);
      like ``lax.dynamic_update_slice`` the start clamps so the update
      fits;
    - paged (``"block_tables"`` present, the engine's cache): writes
      resolve through the block tables (``cache_index`` may be a per-row
      [B] tensor), reads return the logical view
      (:func:`trlx_tpu_torch.inference.kv_cache.paged_write_read`).

    ``view_len`` narrows the returned view to the leading ``view_len``
    positions; writes always resolve at full capacity."""
    if "block_tables" in cache_kv:
        from trlx_tpu_torch.inference.kv_cache import paged_write_read

        return paged_write_read(
            cache_kv, k, v, cache_index, dtype, view_len=view_len or 0
        )
    if "k_scale" in cache_kv:
        raise NotImplementedError("the int8 KV cache comes with a later slice")
    capacity, T = cache_kv["k"].shape[1], k.shape[1]
    start = min(max(int(cache_index), 0), capacity - T)
    cache_kv["k"][:, start:start + T] = k.to(cache_kv["k"].dtype)
    cache_kv["v"][:, start:start + T] = v.to(cache_kv["v"].dtype)
    if view_len is not None and 0 < view_len < capacity:
        return cache_kv["k"][:, :view_len], cache_kv["v"][:, :view_len]
    return cache_kv["k"], cache_kv["v"]


def kv_buffers(
    n_layer: int,
    batch_size: int,
    capacity: int,
    n_head: int,
    head_dim: int,
    dtype,
    kv_cache_dtype: str = "bfloat16",
    device=None,
) -> Cache:
    """Per-layer fixed-capacity KV buffers in the compute dtype."""
    if kv_cache_dtype != "bfloat16":
        raise NotImplementedError(
            f"kv_cache_dtype={kv_cache_dtype!r}: the int8 KV cache (and "
            "'auto', which resolves to it) comes with a later slice"
        )
    shape = (batch_size, capacity, n_head, head_dim)
    dt = torch_dtype(dtype)
    return [
        {"k": torch.zeros(shape, dtype=dt, device=device),
         "v": torch.zeros(shape, dtype=dt, device=device)}
        for _ in range(n_layer)
    ]


def init_cache(config: GPT2Config, batch_size: int, capacity: int, device=None) -> Cache:
    return kv_buffers(
        config.n_layer, batch_size, capacity, config.n_head,
        config.n_embd // config.n_head, config.dtype, config.kv_cache_dtype,
        device=device,
    )
