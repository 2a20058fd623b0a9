"""Rotary position embeddings, both conventions (counterpart of
:mod:`trlx_tpu.ops.rotary`).

GPT-J rotates interleaved pairs (``rotate_every_two``); GPT-NeoX rotates
concatenated halves (``rotate_half``). The casts follow the JAX package's
order: the angles in f32, then sin and cos cast to x's dtype before the
multiply, so bf16 results round where the JAX package's do.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rotary_angles(
    position_ids: torch.Tensor,  # [B, T]
    rotary_dim: int,
    base: float = 10000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (sin, cos) of shape [B, T, rotary_dim/2], float32."""
    dev = position_ids.device
    inv_freq = 1.0 / (
        base ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=dev) / rotary_dim)
    )
    angles = position_ids.float()[..., None] * inv_freq  # [B, T, D/2]
    return torch.sin(angles), torch.cos(angles)


def apply_rotary_interleaved(
    x: torch.Tensor,  # [B, T, H, D] (first rotary_dim dims rotated)
    sin: torch.Tensor,  # [B, T, rotary_dim/2]
    cos: torch.Tensor,
    rotary_dim: int,
) -> torch.Tensor:
    """GPT-J convention: pairs (x0,x1),(x2,x3),... rotate together."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    sin2 = sin.repeat_interleave(2, dim=-1)[:, :, None, :]  # [B, T, 1, rotary_dim]
    cos2 = cos.repeat_interleave(2, dim=-1)[:, :, None, :]
    x1 = rot[..., ::2]
    x2 = rot[..., 1::2]
    rotated = torch.stack([-x2, x1], dim=-1).reshape(rot.shape)
    rot = rot * cos2.to(x.dtype) + rotated * sin2.to(x.dtype)
    return torch.cat([rot, rest], dim=-1) if rest.shape[-1] else rot


def apply_rotary_half(
    x: torch.Tensor,  # [B, T, H, D]
    sin: torch.Tensor,  # [B, T, rotary_dim/2]
    cos: torch.Tensor,
    rotary_dim: int,
) -> torch.Tensor:
    """GPT-NeoX convention: first and second halves of the rotary dims
    rotate against each other."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    sin2 = torch.cat([sin, sin], dim=-1)[:, :, None, :]
    cos2 = torch.cat([cos, cos], dim=-1)[:, :, None, :]
    half = rotary_dim // 2
    rotated = torch.cat([-rot[..., half:], rot[..., :half]], dim=-1)
    rot = rot * cos2.to(x.dtype) + rotated * sin2.to(x.dtype)
    return torch.cat([rot, rest], dim=-1) if rest.shape[-1] else rot
