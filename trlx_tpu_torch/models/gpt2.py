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
  returns updated buffers, the port writes them in place. An int8 cache
  (``kv_cache_dtype: int8``, or ``auto`` up to
  :data:`INT8_KV_MAX_CAPACITY`) holds int8 ``k``/``v`` and bf16
  ``k_scale``/``v_scale`` [B, C, H, 1]: one launch quantizes and stores a
  step's K and V (:func:`~trlx_tpu_torch.ops.kv_quant.quantized_write`),
  and attention reads the int8 values and scales where they lie
  (:class:`~trlx_tpu_torch.ops.attention.QuantizedKV`).

Parameter names follow the flax tree (``h.{i}.attn.c_attn``, ...);
:mod:`trlx_tpu_torch.models.convert` carries JAX params across and
:mod:`trlx_tpu_torch.models.conversion` loads HF checkpoints. The hydra
KL reference's arguments are the flax module's (``capture_hidden_at``,
``start_layer``, ``hidden_override``); :meth:`GPT2Model.hydra_branch`
builds the frozen branch.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.ops.attention import QuantizedKV, causal_dispatch, dot_product_attention

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
    kv_cache_dtype: str = "bfloat16"  # "bfloat16" | "int8" | "auto"

    def __post_init__(self):
        validate_kv_cache_dtype(self.kv_cache_dtype)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GPT2Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` (flax ``Dense``
    with ``dtype``/``param_dtype``): input, weight and bias (if any) are
    cast to the compute dtype per use. Under tensor parallelism
    (:func:`~trlx_tpu_torch.parallel.partition.apply_tensor_parallel` sets
    ``tp`` and ``tp_mode``) its weight is this rank's slice and ``tp``
    runs the forward."""

    tp = None  # a parallel.partition.TensorParallel
    tp_mode: Optional[str] = None  # "col", "row" or "col_gather"

    def __init__(self, in_features, out_features, compute_dtype, **kw):
        super().__init__(in_features, out_features, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.linear(self, x)
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
        # the head count is the projection's width over the head dim: under
        # tensor parallelism c_attn's output is this rank's heads of each
        # of q, k and v
        q, k, v = self.c_attn(x).chunk(3, dim=-1)
        q = q.view(B, T, -1, hd)
        k = k.view(B, T, -1, hd)
        v = v.view(B, T, -1, hd)
        if cache_kv is not None:
            # write this step's K/V at cache_index, then attend over the
            # view the bias was built for (mask width == view width)
            view_len = bias.shape[-1] if bias is not None else None
            k, v = write_cache(
                cache_kv, k, v, cache_index, torch_dtype(cfg.dtype), view_len
            )
        out = dot_product_attention(q, k, v, bias, causal=causal)
        return self.c_proj(out.reshape(B, T, -1))


class Block(nn.Module):
    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        dt, fk = torch_dtype(config.dtype), _factory(config, device)
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.n_embd, eps, dt, **fk)
        self.attn = Attention(config, device)
        self.ln_2 = LayerNorm(config.n_embd, eps, dt, **fk)
        self.mlp = self.make_mlp(config, device)

    def make_mlp(self, config, device=None) -> nn.Module:
        return MLP(config, device)

    def forward(self, x, bias, cache_kv=None, cache_index=None, causal=False):
        x = x + self.attn(self.ln_1(x), bias, cache_kv, cache_index, causal)
        return x + self.mlp(self.ln_2(x))


class DecoderLM(nn.Module):
    """The decoder-only skeleton the causal families share: the hydra
    branch, the embeddings or ``hidden_override``, the attention dispatch,
    the block loop with its capture, ``ln_f`` and the output dict. A family
    sets ``config``, ``first_layer``, ``wte``, ``h`` (blocks keyed by layer
    index) and ``ln_f``, and defines ``embed(input_ids, position_ids)``,
    ``block_args(position_ids, x)`` (what each block takes between the bias
    and the cache: GPT-J's rotary angles), ``logits(hidden)`` and, where
    its layers attend differently, ``attention_masks`` (GPT-Neo's local
    layers); its constructor takes ``branch_start`` and keeps what a branch
    holds. Under tensor parallelism ``tp`` (a
    :class:`~trlx_tpu_torch.parallel.partition.TensorParallel`) gathers the
    token embedding's hidden shards (:meth:`embed_tokens`) and sums a tied
    head's partial logits."""

    tp = None

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """``wte`` at ``input_ids``, its hidden shards gathered under tp."""
        x = self.wte(input_ids)
        return x if self.tp is None else self.tp.embed(x)

    def block_args(self, position_ids: torch.Tensor, x: torch.Tensor) -> tuple:
        return ()

    def attention_masks(self, q_len: int, cache, cache_index, attention_mask):
        """``layer index -> (bias, causal)`` for the blocks' attention,
        keyed by the absolute layer index: every layer takes the shared
        causal dispatch here."""
        mask = causal_dispatch(q_len, cache, cache_index, attention_mask)
        return lambda i: mask

    def hydra_branch(self, branch_start: int) -> "DecoderLM":
        """A frozen copy of what the constructor keeps for ``branch_start``
        (blocks ``branch_start`` and up and the head's weights): the hydra
        KL reference, the trunk blocks left out."""
        branch = type(self)(self.config, self.wte.weight.device, branch_start)
        kept = branch.state_dict().keys()
        branch.load_state_dict({k: v for k, v in self.state_dict().items() if k in kept})
        return branch.requires_grad_(False)

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

        Position ids default to ``cumsum(mask) - 1`` under left padding for
        a full forward, else ``arange(T)``. The hydra arguments:
        ``start_layer=k`` with ``hidden_override`` runs blocks ``k`` and up
        from that activation instead of the embeddings; ``capture_hidden_at=k``
        returns the activation entering block ``k`` as ``"branch_hidden"``
        and stops there (``logits`` and ``hidden`` are then ``None``). XLA
        prunes the blocks above the capture from the JAX trunk when only the
        capture is read; eager PyTorch would run them, so the pass ends at
        the capture."""
        if start_layer < self.first_layer:
            raise ValueError(
                f"start_layer={start_layer}: this branch holds blocks "
                f"{self.first_layer} and up"
            )
        src = input_ids if hidden_override is None else hidden_override
        T = src.shape[1]
        if position_ids is None:
            if attention_mask is not None and cache is None:
                position_ids = (attention_mask.long().cumsum(-1) - 1).clamp_min(0)
            else:
                position_ids = torch.arange(T, device=src.device)[None]
        if hidden_override is not None:
            x = hidden_override.to(torch_dtype(self.config.dtype))
        else:
            x = self.embed(input_ids, position_ids)
        extra = self.block_args(position_ids, x)
        masks = self.attention_masks(T, cache, cache_index, attention_mask)
        for i in range(start_layer, self.config.n_layer):
            if i == capture_hidden_at:
                return {"logits": None, "hidden": None, "cache": cache, "branch_hidden": x}
            bias, causal = masks(i)
            x = self.h[str(i)](x, bias, *extra, cache[i] if cache is not None else None,
                               cache_index, causal)
        x = self.ln_f(x)
        return {
            "logits": self.logits(x) if compute_logits else None,
            "hidden": x,
            "cache": cache,
        }


class GPT2Model(DecoderLM):
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
            {str(i): self.make_block(i, device)
             for i in range(self.first_layer, config.n_layer)}
        )
        self.ln_f = LayerNorm(
            config.n_embd, config.layer_norm_epsilon,
            torch_dtype(config.dtype), **fk,
        )

    def make_block(self, i: int, device=None) -> nn.Module:
        """Block ``i`` (the MoE family swaps some blocks' MLP)."""
        return Block(self.config, device)

    def embed(self, input_ids, position_ids) -> torch.Tensor:
        # each table rounds to the compute dtype before the add. Engine rows
        # past their token budget ride along (outputs discarded) at
        # positions that can pass the table's end: clamp them, since an
        # out-of-range index is a device-side fault on a GPU
        dt = torch_dtype(self.config.dtype)
        position_ids = position_ids.clamp(0, self.config.n_positions - 1)
        return self.embed_tokens(input_ids).to(dt) + self.wpe(position_ids).to(dt)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied LM head: compute-dtype operands, f32 products and sums."""
        emb = self.wte.weight.to(torch_dtype(self.config.dtype))
        if self.tp is not None:
            return self.tp.tied_logits(hidden, emb)
        return torch.matmul(hidden.float(), emb.float().t())


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the head dim (the plain version of
    the quantizing cache write, ``csrc/kv_quant.cu``): per (batch, token,
    head) scale = max(absmax, 1e-8) / 127 in f32, values round(x / scale)
    half to even and clipped to [-127, 127], the scale stored rounded to
    bf16. Returns ``(int8 values, bf16 scale[..., :1])``."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(x32 / scale).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


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

    An int8 cache (``"k_scale"`` present) quantizes the new K and V and
    stores values and scales in one launch
    (:func:`~trlx_tpu_torch.ops.kv_quant.quantized_write`) and returns
    the view as two :class:`~trlx_tpu_torch.ops.attention.QuantizedKV`,
    which dequantize to the JAX package's ``values * scale`` in ``dtype``.

    ``view_len`` narrows the returned view to the leading ``view_len``
    positions; writes always resolve at full capacity."""
    if "block_tables" in cache_kv:
        from trlx_tpu_torch.inference.kv_cache import paged_write_read

        return paged_write_read(
            cache_kv, k, v, cache_index, dtype, view_len=view_len or 0
        )
    capacity, T = cache_kv["k"].shape[1], k.shape[1]
    start = min(max(int(cache_index), 0), capacity - T)
    narrow = view_len is not None and 0 < view_len < capacity
    if "k_scale" in cache_kv:
        from trlx_tpu_torch.ops.kv_quant import cache_buffers, quantized_write

        quantized_write(k, v, cache_buffers(cache_kv), row_stride=capacity, start=start)
        width = view_len if narrow else capacity
        return tuple(
            QuantizedKV(cache_kv[key][:, :width], cache_kv[key + "_scale"][:, :width], dtype)
            for key in ("k", "v")
        )
    cache_kv["k"][:, start:start + T] = k.to(cache_kv["k"].dtype)
    cache_kv["v"][:, start:start + T] = v.to(cache_kv["v"].dtype)
    if narrow:
        return cache_kv["k"][:, :view_len], cache_kv["v"][:, :view_len]
    return cache_kv["k"], cache_kv["v"]


#: The capacity up to which ``kv_cache_dtype: "auto"`` picks the int8 cache,
#: measured on the H100 (the TPU's 512 does not carry over): 0, since int8
#: decoded slower than bf16 at every capacity measured. chip_smoke.py phase
#: 23's sweep on an NVIDIA H100 80GB HBM3 at 700.00 W (GPT-2 small's greedy
#: fixed sampler, 48 new tokens, medians of 5 interleaved pairs of decode
#: tokens/s, int8 / bf16): B=128 at capacity 112 21 887 / 23 662 (0.925),
#: B=128 at 576 14 094 / 16 879 (0.835), B=32 at 1088 3 944 / 6 355 (0.621),
#: B=8 at 2048 1 039 / 1 423 (0.730). The int8 decode kernel itself took
#: 0.0439 ms against the bf16 decode's 0.0245 at B=32 K=576 (half the bytes,
#: more work per byte), and each step adds the Python of the int8 route.
INT8_KV_MAX_CAPACITY = 0


def resolve_kv_cache_dtype(kv_cache_dtype: str, capacity: int) -> str:
    """Resolve ``"auto"`` by cache capacity (int8 up to
    :data:`INT8_KV_MAX_CAPACITY`, else bf16) and warn when an explicit
    ``"int8"`` is asked for past it, where the int8 cache decodes slower
    than bf16 on the card."""
    if kv_cache_dtype == "auto":
        return "int8" if capacity <= INT8_KV_MAX_CAPACITY else "bfloat16"
    if kv_cache_dtype == "int8" and capacity > INT8_KV_MAX_CAPACITY:
        warnings.warn(
            f"kv_cache_dtype='int8' with a {capacity}-token cache: measured "
            f"SLOWER than bfloat16 beyond {INT8_KV_MAX_CAPACITY} tokens on the "
            "H100 (chip_smoke.py phase_kv_int8's sweep); set "
            "kv_cache_dtype='auto' to pick the faster layout per shape, or "
            "'bfloat16' to silence this"
        )
    return kv_cache_dtype


def kv_buffers(
    n_layer: int,
    batch_size: int,
    capacity: int,
    n_head: int,
    head_dim: int,
    dtype,
    kv_cache_dtype: str = "bfloat16",
    device=None,
    extra_positions: int = 0,
) -> Cache:
    """Per-layer fixed-capacity KV buffers, shared by every causal family:
    in the compute dtype, or for ``"int8"`` int8 values and per (token,
    head) bf16 scales [B, C, H, 1]; ``"auto"`` resolves by capacity
    (:func:`resolve_kv_cache_dtype`). ``extra_positions`` trailing
    positions past ``capacity`` (the paged cache's discard sentinel) are
    allocated too; the dtype resolves at ``capacity``."""
    kv_cache_dtype = resolve_kv_cache_dtype(kv_cache_dtype, capacity)
    shape = (batch_size, capacity + extra_positions, n_head, head_dim)
    if kv_cache_dtype == "int8":
        sshape = shape[:3] + (1,)
        return [
            {"k": torch.zeros(shape, dtype=torch.int8, device=device),
             "v": torch.zeros(shape, dtype=torch.int8, device=device),
             "k_scale": torch.zeros(sshape, dtype=torch.bfloat16, device=device),
             "v_scale": torch.zeros(sshape, dtype=torch.bfloat16, device=device)}
            for _ in range(n_layer)
        ]
    validate_kv_cache_dtype(kv_cache_dtype)
    dt = torch_dtype(dtype)
    return [
        {"k": torch.zeros(shape, dtype=dt, device=device),
         "v": torch.zeros(shape, dtype=dt, device=device)}
        for _ in range(n_layer)
    ]


def init_cache(config: GPT2Config, batch_size: int, capacity: int, device=None,
               extra_positions: int = 0, tp: int = 1) -> Cache:
    """The linear KV cache; ``tp`` > 1 holds a tensor-parallel rank's
    ``n_head // tp`` heads."""
    return kv_buffers(
        config.n_layer, batch_size, capacity, config.n_head // tp,
        config.n_embd // config.n_head, config.dtype, config.kv_cache_dtype,
        device=device, extra_positions=extra_positions,
    )
