"""Flash-attention forward: the hand-written Hopper kernel, its plain
PyTorch version, and the launch counter.

Counterpart of :mod:`trlx_tpu.ops.flash_attention` (the forward half:
``_fwd_kernel``). The kernel is CUDA C++ for ``sm_90a`` in
``trlx_tpu_torch/csrc/flash_fwd.cu``; it is compiled with ``nvcc`` at first
use into ``trlx_tpu_torch/_build/`` (a file named by the source's content
hash, so an edited source rebuilds) and bound through a plain C function
loaded with ``ctypes``. Nothing is imported or built when this module is
imported.

Dispatch is by the tensor's device, never by a fallback:

- a CPU tensor takes :func:`flash_attention_reference`, the plain version
  (the CPU tests run it against the JAX package);
- a CUDA tensor launches the kernel, or raises.

The backward kernels (``_dq_kernel``/``_dkv_kernel``) belong to the
training slice; until then a CUDA input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import torch

from trlx_tpu_torch.ops.attention import NEG_INF, causal_bias

#: kernel launches since import (or since a caller reset it): incremented
#: only where :func:`flash_attention` launches the CUDA kernel
FLASH_FWD_LAUNCHES = 0

HEAD_DIM = 64  # the head dim the kernel is built for (GPT-2's)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "flash_fwd.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    return "nvcc"


def build(verbose: bool = False) -> str:
    """Compile the kernel (if this source has not been built yet) and
    return the shared library's path."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"libflash_fwd_{digest.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose and (proc.stdout or proc.stderr):
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.trlx_flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 13
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        _lib = lib
    return _lib


def flash_attention_reference(
    q: torch.Tensor,  # [B, Q, H, D]
    k: torch.Tensor,  # [B, K, H, D]
    v: torch.Tensor,  # [B, K, H, D]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Q, K]
    causal: bool = False,
    return_lse: bool = False,
):
    """The plain version: the same function as the kernel in plain tensor
    ops — logits and softmax in f32, finite ``NEG_INF`` masking, weights
    cast to V's dtype before the second product, output in q's dtype.
    Returns ``o`` [B, Q, H, D] (and ``lse`` [B, H, Q] f32)."""
    Q, K = q.shape[1], k.shape[1]
    if causal:
        cb = causal_bias(Q, K, device=q.device)
        bias = cb if bias is None else cb + bias.float()
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float()
    ).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def flash_attention(
    q: torch.Tensor,  # [B, Q, H, D]
    k: torch.Tensor,  # [B, K, H, D]
    v: torch.Tensor,  # [B, K, H, D]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Q, K]
    causal: bool = False,
    return_lse: bool = False,
):
    """Attention forward over the [B, T, H, D] layout; returns ``o``
    [B, Q, H, D] in q's dtype (and ``lse`` [B, H, Q] f32 with
    ``return_lse``). ``causal=True`` masks query i against keys > i in the
    kernel and skips wholly-future key tiles. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises.

    Fully-masked rows: with an explicit bias the kernel averages the K
    real values, as the plain version does. Under ``causal=True`` a query
    row whose visible keys are all padding (a left-padding row, whose
    output callers discard) averages only the keys of the tiles it
    visits, as the TPU kernel does."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, causal, return_lse)
    o, lse = _launch(q, k, v, bias, causal, return_lse)
    return (o, lse) if return_lse else o


def _launch(
    q, k, v, bias, causal, return_lse
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    global FLASH_FWD_LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q/k/v must share one dtype of "
            f"{sorted(map(str, _DTYPES))}, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: bad shapes q{tuple(q.shape)} "
            f"k{tuple(k.shape)} v{tuple(v.shape)}"
        )
    B, Q, H, D = q.shape
    K = k.shape[1]
    if D != HEAD_DIM or k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(
            f"flash_attention: the kernel is built for head dim {HEAD_DIM} "
            f"and matching q/k batch and heads; got q{tuple(q.shape)} "
            f"k{tuple(k.shape)}"
        )
    if any(
        t is not None and t.requires_grad for t in (q, k, v, bias)
    ) and torch.is_grad_enabled():
        raise NotImplementedError(
            "flash_attention has no backward on CUDA yet: the dQ and dK/dV "
            "kernels (trlx_tpu/ops/flash_attention.py::_dq_kernel, "
            "_dkv_kernel) come with the training slice"
        )
    devices = {t.device for t in (q, k, v, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: inputs on several devices {devices}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if bias is not None:
        if bias.dim() != 4:
            raise ValueError(
                f"flash_attention: bias must be rank-4, got {tuple(bias.shape)}"
            )
        bias = bias.float().expand(B, H, Q, K)  # size-1 dims get stride 0
        sb = bias.stride()
    else:
        sb = (0, 0, 0, 0)
    o = torch.empty((B, Q, H, D), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((B, H, Q), dtype=torch.float32, device=q.device)
        if return_lse
        else None  # the kernel skips the write
    )
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.trlx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            o.data_ptr(), lse.data_ptr() if lse is not None else None,
            _DTYPES[q.dtype], B, H, Q, K, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            *sb,
            float(D ** -0.5), int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    FLASH_FWD_LAUNCHES += 1
    return o, lse


__all__ = [
    "FLASH_FWD_LAUNCHES",
    "NEG_INF",
    "build",
    "flash_attention",
    "flash_attention_reference",
]
