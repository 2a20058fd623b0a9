"""The quantizing cache write of the int8 KV cache: one launch quantizes a
step's new K and V and stores their int8 values and bf16 scales at their
destination rows (``csrc/kv_quant.cu``).

Counterpart of the int8 branches of :func:`trlx_tpu.models.gpt2.write_cache`
and :func:`trlx_tpu.inference.kv_cache.paged_write_read`, where XLA fuses
``quantize_kv`` with the ``dynamic_update_slice`` or scatter that stores
it. The destination is addressed by flat rows: a buffer ``[S, C, H, D]``
(values) and ``[S, C, H, 1]`` (scales) is ``S * C`` rows of ``H`` heads,
and row ``b * row_stride + start + t`` (the linear cache's
``[start, start + T)``) or ``rows[b, t]`` (the paged cache's physical
positions, slot region included) takes token ``t`` of batch row ``b``. The
paged path's shared-prefix pool takes the same values again at
``publish_rows`` in the same launch.

Dispatch is by the tensor's device, never by a fallback: a CPU tensor runs
the plain version (:func:`~trlx_tpu_torch.models.gpt2.quantize_kv` and
indexed stores), a CUDA tensor launches the kernel or raises. Nothing is
imported or built when this module is imported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

#: kernel launches since import (or since a caller reset it), incremented
#: only where :func:`quantized_write` launches its CUDA kernel
KV_QUANT_LAUNCHES = 0

Buffers = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def cache_buffers(cache_kv: Dict[str, torch.Tensor], prefix: str = "") -> Buffers:
    """``(k, v, k_scale, v_scale)`` of an int8 cache dict (``prefix``
    ``"shared_"`` for the shared-prefix pool)."""
    return tuple(cache_kv[prefix + key] for key in ("k", "v", "k_scale", "v_scale"))


def _flat_rows(B: int, T: int, row_stride: int, start: int, device) -> torch.Tensor:
    b = torch.arange(B, device=device)[:, None]
    return b * row_stride + start + torch.arange(T, device=device)[None, :]


def quantized_write_reference(
    k: torch.Tensor, v: torch.Tensor, dst: Buffers, rows: torch.Tensor,
    publish: Optional[Buffers] = None, publish_rows: Optional[torch.Tensor] = None,
) -> None:
    """The plain version: :func:`~trlx_tpu_torch.models.gpt2.quantize_kv`
    of K and V, then indexed stores of values and scales at ``rows`` [B,
    T] (and at ``publish_rows`` of ``publish``)."""
    from trlx_tpu_torch.models.gpt2 import quantize_kv

    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    for bufs, at in ((dst, rows), (publish, publish_rows)):
        if bufs is None:
            continue
        flat = at.reshape(-1)
        for buf, part in zip(bufs, (kq, vq, ks, vs)):
            tail = part.shape[2:]
            buf.view(-1, *tail)[flat] = part.reshape(-1, *tail)


def quantized_write(
    k: torch.Tensor,  # [B, T, H, D] in the compute dtype
    v: torch.Tensor,
    dst: Buffers,  # int8 [S, C, H, D] x 2, bf16 [S, C, H, 1] x 2, contiguous
    rows: Optional[torch.Tensor] = None,  # [B, T] flat destination rows
    row_stride: int = 0,
    start: int = 0,
    publish: Optional[Buffers] = None,  # the shared pool, [P, H, D] / [P, H, 1]
    publish_rows: Optional[torch.Tensor] = None,  # [B, T] flat pool rows
) -> None:
    """Quantize K and V over the head dim and store values and scales in
    place: token ``t`` of row ``b`` at flat row ``rows[b, t]``, or without
    ``rows`` at ``b * row_stride + start + t``; with ``publish`` also at
    ``publish_rows[b, t]`` of the pool. Bit for bit the plain version on
    every row written once (rows that several tokens target, the discard
    sentinels, take one of them)."""
    global KV_QUANT_LAUNCHES
    B, T, H, D = k.shape
    if v.shape != k.shape or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise ValueError(
            f"quantized_write: k and v must be one [B, T, H, D] f32 or bf16 shape, got "
            f"{k.dtype} {tuple(k.shape)} / {v.dtype} {tuple(v.shape)}")
    for bufs in (dst, publish):
        if bufs is None:
            continue
        ok = (len(bufs) == 4 and all(b.is_contiguous() for b in bufs)
              and bufs[0].dtype == bufs[1].dtype == torch.int8
              and bufs[2].dtype == bufs[3].dtype == torch.bfloat16
              and all(b.shape[-2:] == (H, D) for b in bufs[:2])
              and all(b.shape[-2:] == (H, 1) for b in bufs[2:]))
        if not ok:
            raise ValueError(
                "quantized_write: a destination is contiguous int8 values [..., H, D] "
                "and bf16 scales [..., H, 1] (k, v, k_scale, v_scale)")
    if (publish is None) != (publish_rows is None):
        raise ValueError("quantized_write: publish and publish_rows go together")
    if k.device.type == "cpu":
        if rows is None:
            rows = _flat_rows(B, T, row_stride, start, k.device)
        quantized_write_reference(k, v, dst, rows, publish, publish_rows)
        return
    _launch(k, v, dst, rows, row_stride, start, publish, publish_rows)
    KV_QUANT_LAUNCHES += 1


def _launch(k, v, dst, rows, row_stride, start, publish, publish_rows) -> None:
    from trlx_tpu_torch.ops.flash_attention import _load

    B, T, H, D = k.shape
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("quantized_write: K and V need a contiguous head dim")
    index = [t.contiguous().long() if t is not None else None for t in (rows, publish_rows)]
    devices = {t.device for t in (k, v, *dst, *(publish or ()), *index) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"quantized_write: inputs on several devices {devices}")
    lib = _load()["kv_quant"]
    pub = publish if publish is not None else (None,) * 4
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        rc = lib.trlx_kv_quant_write(
            k.data_ptr(), v.data_ptr(), _DTYPES[k.dtype], B, T, H, D,
            *k.stride()[:3], *v.stride()[:3],
            *(t.data_ptr() for t in dst),
            index[0].data_ptr() if index[0] is not None else None, int(row_stride), int(start),
            *(t.data_ptr() if t is not None else None for t in pub),
            index[1].data_ptr() if index[1] is not None else None,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"kv_quant kernel launch failed: CUDA error {rc}")


def rows_of(slots: torch.Tensor, positions: torch.Tensor, region: int) -> torch.Tensor:
    """[B, T] flat rows of ``positions`` [B, T] in the slots' regions of
    ``region`` positions each (the paged cache's ``capacity + 1``)."""
    return slots.long()[:, None] * region + positions.long()


__all__ = [
    "KV_QUANT_LAUNCHES",
    "cache_buffers",
    "quantized_write",
    "quantized_write_reference",
    "rows_of",
]
