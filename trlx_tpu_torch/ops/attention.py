"""Attention core and mask/bias helpers (counterpart of
:mod:`trlx_tpu.ops.attention`).

Every attention of the causal families and of T5 funnels through
:func:`dot_product_attention`. Masks are additive f32 biases with the
finite ``NEG_INF`` (a fully-masked row degrades to uniform weights instead
of NaN). Dispatch: every call goes to the flash forward
(:mod:`trlx_tpu_torch.ops.flash_attention`), which launches the
hand-written kernel on a CUDA tensor and runs its plain version on a CPU
tensor. A learned bias (T5's relative position bias, ``learned_bias=True``)
takes the same route: where the reference pins it to XLA's einsum for its
gradient, the port's dQ kernel returns that gradient.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e9  # large-negative mask value; avoids -inf NaN propagation


def causal_bias(
    q_len: int,
    kv_len: int,
    offset: Union[int, torch.Tensor] = 0,
    device=None,
) -> torch.Tensor:
    """[1, 1, Q, K] additive f32 bias: query i attends key j iff
    j <= i + offset. A [B] tensor ``offset`` (rows decoding at different
    depths) yields [B, 1, Q, K]."""
    if isinstance(offset, torch.Tensor):
        device = offset.device if device is None else device
    k_pos = torch.arange(kv_len, device=device)
    q_pos = torch.arange(q_len, device=device)
    if isinstance(offset, torch.Tensor) and offset.dim():
        q_abs = q_pos[None, :, None] + offset.to(device=device).long()[:, None, None]
        mask = k_pos[None, None, :] <= q_abs  # [B, Q, K]
        return _bias_from(mask)[:, None]
    q_abs = q_pos[:, None] + (offset.to(device) if isinstance(offset, torch.Tensor) else offset)
    return _bias_from(k_pos[None, :] <= q_abs)[None, None]


def _bias_from(mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, 0.0, NEG_INF).to(torch.float32)


def padding_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, 1, 1, K] additive bias from a 0/1 key-validity mask."""
    return _bias_from(attention_mask[:, None, None, :] > 0)


def combine_biases(*biases: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for b in biases:
        if b is None:
            continue
        out = b if out is None else out + b
    return out


def causal_dispatch(q_len: int, cache, cache_index, attention_mask):
    """Shared causal-mask dispatch for the causal-LM families; returns
    ``(bias, causal_flag)`` for :func:`dot_product_attention`.

    Without a KV cache the causal structure is a flag (the kernel masks in
    place and skips future key tiles); with one, the offset-shifted causal
    mask is an explicit bias. With a cache the mask width is the attention
    view width (``models/gpt2.py::write_cache`` narrows the returned K/V
    view to it)."""
    pad = padding_bias(attention_mask) if attention_mask is not None else None
    if cache is None:
        return pad, True
    kv_len = (
        attention_mask.shape[-1]
        if attention_mask is not None
        else cache[0]["k"].shape[1]
    )
    offset = cache_index
    if isinstance(offset, torch.Tensor) and offset.dim() == 2:
        # [B, Q] per-column targets: the window is consecutive from each
        # row's first target, so the causal offset is the base column
        offset = offset[:, 0]
    device = attention_mask.device if attention_mask is not None else None
    return combine_biases(causal_bias(q_len, kv_len, offset, device), pad), False


def dot_product_attention(
    q: torch.Tensor,  # [B, Q, H, D]
    k: torch.Tensor,  # [B, K, H, D]
    v: torch.Tensor,  # [B, K, H, D]
    bias: Optional[torch.Tensor] = None,  # [B or 1, 1 or H, Q, K] additive
    *,
    causal: bool = False,
    learned_bias: bool = False,
) -> torch.Tensor:
    """Multi-head attention; returns [B, Q, H, D] in q's dtype.

    ``learned_bias=True`` declares that ``bias`` carries trained
    parameters (T5's relative position table) and may require grad; its
    gradient then comes from the dQ kernel (the plain backward on a CPU
    tensor). The route is the same either way: K1 forward, K2 and K3
    backward. A bias that requires grad without the declaration is
    refused, since the reference would give it no gradient."""
    from trlx_tpu_torch.ops.flash_attention import flash_attention

    if (not learned_bias and bias is not None and bias.requires_grad
            and torch.is_grad_enabled()):
        raise ValueError(
            "dot_product_attention: the bias requires grad; pass "
            "learned_bias=True for a learned bias"
        )
    return flash_attention(q, k, v, bias, causal=causal)
