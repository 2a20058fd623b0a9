"""Flash attention: the hand-written Hopper kernels, their plain PyTorch
versions, the autograd ``Function`` that joins them, and the launch
counters.

Counterpart of :mod:`trlx_tpu.ops.flash_attention`: ``_fwd_kernel`` (K1,
``csrc/flash_fwd.cu``), ``_dq_kernel`` (K2) and ``_dkv_kernel`` (K3, both
``csrc/flash_bwd.cu``), and the ``jax.custom_vjp`` around them
(:class:`FlashAttention`). K1 has three variants, one per dtype and
query count (:func:`forward_variant`): ``tile`` (bf16, Q > 16, tensor
cores), ``decode`` (bf16, Q <= 16, a GEMV on the CUDA cores) and ``fma``
(f32, the parity path). K2 and K3 have two, one per dtype
(:func:`backward_variant`): ``tile`` (bf16, tensor cores) and ``fma``
(f32). K2 also returns the bias's gradient (dS, for T5's learned
relative position bias) when the bias requires grad. Each source is CUDA
C++ for ``sm_90a``, compiled with ``nvcc`` at first use into ``trlx_tpu_torch/_build/`` (a file named by the hash of the
source and the header it includes, so an edit rebuilds; the two sources
build in parallel) and bound through plain C functions loaded with
``ctypes``. Nothing is imported or built when this module is imported.

Dispatch is by the tensor's device, never by a fallback:

- a CPU tensor takes the plain versions (:func:`flash_attention_reference`,
  :func:`flash_attention_backward_reference`), which the CPU tests run
  against the JAX package;
- a CUDA tensor launches the kernels, or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Dict, Optional, Tuple

import torch

from trlx_tpu_torch.ops.attention import NEG_INF, causal_bias

#: kernel launches since import (or since a caller reset them): each is
#: incremented only where its wrapper launches its CUDA kernel.
#: ``FLASH_FWD_LAUNCHES`` counts every K1 launch, the three after it the
#: launches of each K1 variant
FLASH_FWD_LAUNCHES = 0
FLASH_FWD_TILE_LAUNCHES = 0
FLASH_FWD_DECODE_LAUNCHES = 0
FLASH_FWD_FMA_LAUNCHES = 0
#: q/k/v copies K1's wrapper made before a launch (a last dim that is not
#: contiguous, or a view the 16-byte loads cannot read in place)
FLASH_FWD_COPIES = 0
#: every K2 (dQ) and K3 (dK/dV) launch, then each kernel's launches by
#: variant
FLASH_BWD_DQ_LAUNCHES = 0
FLASH_BWD_DKV_LAUNCHES = 0
FLASH_BWD_DQ_TILE_LAUNCHES = 0
FLASH_BWD_DQ_FMA_LAUNCHES = 0
FLASH_BWD_DKV_TILE_LAUNCHES = 0
FLASH_BWD_DKV_FMA_LAUNCHES = 0
#: K2 launches that also wrote the bias gradient (counted in the two above
#: as well)
FLASH_BWD_DQ_DBIAS_LAUNCHES = 0
#: q/k/v/o/dO copies the backward's argument packing made (a view the
#: variant cannot read in place), once per packing
FLASH_BWD_COPIES = 0

HEAD_DIM = 64  # the head dim the kernels are built for (GPT-2's)
KEY_TILE = 64  # the forward kernel's key tile
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: K1's variants, by the code its C entry point takes
FORWARD_VARIANTS = {"fma": 0, "tile": 1, "decode": 2}
#: per variant, whether it reads (q, k, v) with 16-byte loads
_WIDE_LOADS = {
    "fma": (False, False, False),
    "tile": (True, True, True),
    "decode": (False, True, True),
}
#: K2's and K3's variants, by the code their C entry points take
BACKWARD_VARIANTS = {"fma": 0, "tile": 1}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {
    "flash_fwd": os.path.join(_PKG_DIR, "csrc", "flash_fwd.cu"),
    "flash_bwd": os.path.join(_PKG_DIR, "csrc", "flash_bwd.cu"),
}
#: the header both sources include (hashed with each)
HEADER = os.path.join(_PKG_DIR, "csrc", "hopper_tile.cuh")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
#: the device code's flags; the library adds the host side's
NVCC_DEVICE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
NVCC_FLAGS = [*NVCC_DEVICE_FLAGS, "-shared", "-Xcompiler", "-fPIC"]

_lib: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    return "nvcc"


def _library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (SOURCES[name], HEADER):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def _run_nvcc(cmds: Dict[str, list]) -> Dict[str, Tuple[int, str]]:
    """Run one ``nvcc`` per entry, all started together; ``{name:
    (return code, what it printed)}``."""
    procs = {
        name: subprocess.Popen(
            [_nvcc(), *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        for name, args in cmds.items()
    }
    results = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        results[name] = (proc.returncode, log)
    return results


def build() -> Dict[str, str]:
    """Compile every kernel source not built yet (one ``nvcc`` each, all
    started together) and return ``{name: shared library path}``."""
    paths = {name: _library_path(name) for name in SOURCES}
    tmps = {}
    for name, out in paths.items():
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmps[name] = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    results = _run_nvcc(
        {name: [*NVCC_FLAGS, "-o", tmp, SOURCES[name]] for name, tmp in tmps.items()}
    )
    failed = []
    for name, (rc, log) in results.items():
        if rc != 0:
            os.unlink(tmps[name])
            failed.append(f"nvcc failed ({rc}) building {SOURCES[name]}:\n{log}")
            continue
        os.replace(tmps[name], paths[name])  # atomic: no process loads half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def ptxas_reports() -> Dict[str, str]:
    """``{name: ptxas -v output}`` per kernel source (registers, shared
    memory and spills of each kernel): its device code compiled again with
    the library's device flags into a temporary directory, so the report
    holds whether or not :func:`build` compiled the library in this
    process."""
    with tempfile.TemporaryDirectory() as tmp:
        results = _run_nvcc({
            name: [*NVCC_DEVICE_FLAGS, "-cubin", "-Xptxas=-v",
                   "-o", os.path.join(tmp, f"{name}.cubin"), src]
            for name, src in SOURCES.items()
        })
    failed = [f"nvcc -cubin failed ({rc}) on {SOURCES[n]}:\n{log}"
              for n, (rc, log) in results.items() if rc != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: log for name, (_, log) in results.items()}


def _load() -> Dict[str, ctypes.CDLL]:
    if not _lib:
        paths = build()
        fwd = ctypes.CDLL(paths["flash_fwd"])
        fwd.trlx_flash_fwd.restype = ctypes.c_int
        fwd.trlx_flash_fwd.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 13
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        bwd = ctypes.CDLL(paths["flash_bwd"])
        # dq and dbias, or dk and dv
        for fn in (bwd.trlx_flash_bwd_dq, bwd.trlx_flash_bwd_dkv):
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] * 9
                + [ctypes.c_int] * 7
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
            )
        _lib.update(flash_fwd=fwd, flash_bwd=bwd)
    return _lib


def forward_variant(dtype: torch.dtype, Q: int) -> str:
    """The K1 variant for ``Q`` query rows in ``dtype``: ``fma`` for f32
    (the parity path: tensor cores would make it TF32), ``decode`` for bf16
    with ``Q <= 16`` (the 16-row query tile of :func:`forward_block_q`) and
    ``tile`` for bf16 with more rows (the 64-row tile)."""
    if dtype == torch.float32:
        return "fma"
    if dtype == torch.bfloat16:
        return "decode" if Q <= 16 else "tile"
    raise ValueError(
        f"flash_attention: unsupported dtype {dtype}; the kernel is built "
        f"for {sorted(map(str, _DTYPES))}"
    )


def backward_variant(dtype: torch.dtype) -> str:
    """The K2/K3 variant for ``dtype``: ``tile`` for bf16 (the tensor
    cores) and ``fma`` for f32 (the parity path: tensor cores would make it
    TF32)."""
    if dtype == torch.float32:
        return "fma"
    if dtype == torch.bfloat16:
        return "tile"
    raise ValueError(
        f"flash_attention backward: unsupported dtype {dtype}; the kernels "
        f"are built for {sorted(map(str, _DTYPES))}"
    )


def forward_block_q(Q: int) -> int:
    """The forward kernel's query tile for ``Q`` query rows."""
    return 16 if Q <= 16 else 64


def visited_keys(Q: int, K: int, device=None) -> torch.Tensor:
    """[Q, K] bool: the keys the forward kernel visits for each query row
    under the causal flag — the 64-key tiles that start before the end of
    the row's query tile (``csrc/flash_fwd.cu``)."""
    bq = forward_block_q(Q)
    tile_end = (torch.arange(Q, device=device) // bq + 1) * bq
    tile_start = torch.arange(K, device=device) // KEY_TILE * KEY_TILE
    return tile_start[None, :] < tile_end[:, None]


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


def sum_to_shape(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` summed over the dims where ``shape`` broadcasts (leading dims
    it lacks, and dims of size 1): a broadcast input's gradient."""
    lead = x.dim() - len(shape)
    if lead:
        x = x.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and x.shape[i] != 1)
    return x.sum(dim=dims, keepdim=True) if dims else x


def flash_attention_backward_reference(
    q: torch.Tensor,  # [B, Q, H, D]
    k: torch.Tensor,  # [B, K, H, D]
    v: torch.Tensor,  # [B, K, H, D]
    bias: Optional[torch.Tensor],  # broadcastable to [B, H, Q, K]
    o: torch.Tensor,  # [B, Q, H, D], the forward's output
    lse: torch.Tensor,  # [B, H, Q] f32, the forward's LSE
    do: torch.Tensor,  # [B, Q, H, D]
    causal: bool = False,
    with_dbias: bool = False,
):
    """The plain version of the backward kernels: the TPU kernels'
    recomputation in plain tensor ops. P = exp(S - LSE) in f32 (not
    rounded), delta = rowsum(dO * O) in f32, dP from dO and V widened to
    f32, dS = P * (dP - delta); dQ from dS cast to K's dtype, dK and dV
    from f32 P and dS; dQ and dK scaled once at the end. Under ``causal``
    keys in the tiles the forward kernel skipped carry no weight
    (:func:`visited_keys`), so on a row whose visible keys are all masked
    P sums to 1 over the tiles the kernel visited. Returns ``(dq, dk,
    dv)`` in the dtypes of q, k, v; with ``with_dbias`` also dS [B, H, Q,
    K] f32, the bias's gradient before the sum over the dims where the
    bias broadcasts (unscaled: the bias is added after the scale; K2's
    output, which needs ``causal=False``)."""
    Q, K = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        logits = logits + causal_bias(Q, K, device=q.device)
    p = torch.exp(logits - lse[..., None])
    if causal:
        p = p * visited_keys(Q, K, q.device)
    do32 = do.float()
    delta = torch.einsum("bqhd,bqhd->bhq", do32, o.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    grads = (dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)
    if with_dbias:
        _check_dbias(bias, causal)
        return (*grads, ds)
    return grads


def _check_dbias(bias, causal) -> None:
    """A bias gradient needs a bias and no causal flag: a learned bias
    carries its own causal mask, and K2 then visits every key tile."""
    if bias is None:
        raise ValueError("flash_attention backward: no bias to differentiate")
    if causal:
        raise ValueError(
            "flash_attention: a bias that requires grad (a learned bias) "
            "takes causal=False; fold the causal mask into the bias"
        )


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the counterpart of ``_flash`` with
    ``_flash_fwd``/``_flash_bwd``): the forward saves q, k, v, bias, O and
    LSE; the backward launches the dQ kernel and then the dK/dV kernel on
    CUDA tensors, or runs the plain backward on CPU tensors. A bias that
    requires grad (T5's learned relative position bias, which the TPU
    package leaves on XLA's einsum path) gets its gradient from the dQ
    kernel, summed over the dims where it broadcasts; any other bias gets
    none, as the TPU wrapper returns a zero cotangent for it."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, bias, causal, True)
        else:
            o, lse = _launch(q, k, v, bias, causal, True)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        with_dbias = ctx.needs_input_grad[3]
        backward = (
            flash_attention_backward_reference if q.device.type == "cpu"
            else _launch_backward
        )
        grads = backward(q, k, v, bias, o, lse, do, ctx.causal, with_dbias)
        dbias = sum_to_shape(grads[3], bias.shape).to(bias.dtype) if with_dbias else None
        return (*grads[:3], dbias, None)


def flash_attention(
    q: torch.Tensor,  # [B, Q, H, D]
    k: torch.Tensor,  # [B, K, H, D]
    v: torch.Tensor,  # [B, K, H, D]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Q, K]
    causal: bool = False,
    return_lse: bool = False,
):
    """Attention over the [B, T, H, D] layout; returns ``o`` [B, Q, H, D]
    in q's dtype (and ``lse`` [B, H, Q] f32 with ``return_lse``).
    ``causal=True`` masks query i against keys > i in the kernel and skips
    wholly-future key tiles. When q, k, v or the bias requires grad (and
    grad mode is on) the call goes through :class:`FlashAttention`, whose
    backward runs the backward kernels (a bias that requires grad takes
    ``causal=False``: its gradient comes from the dQ kernel, which then
    visits every key tile); otherwise no LSE is allocated unless asked
    for. A CPU tensor runs the plain versions; a CUDA tensor launches the
    kernels or raises.

    Fully-masked rows: with an explicit bias the kernel averages the K
    real values, as the plain version does. Under ``causal=True`` a query
    row whose visible keys are all padding (a left-padding row, whose
    output callers discard) averages only the keys of the tiles it
    visits, as the TPU kernel does."""
    grad_bias = bias is not None and bias.requires_grad
    if torch.is_grad_enabled() and grad_bias:
        _check_dbias(bias, causal)
    if torch.is_grad_enabled() and (grad_bias or any(t.requires_grad for t in (q, k, v))):
        if return_lse:
            raise ValueError("flash_attention: the LSE has no gradient; "
                             "call with return_lse=False to differentiate")
        return FlashAttention.apply(q, k, v, bias, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, causal, return_lse)
    o, lse = _launch(q, k, v, bias, causal, return_lse)
    return (o, lse) if return_lse else o


def _check(q, k, v, bias, name: str) -> None:
    """Refuse what the kernels were not built for (before any launch)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"{name}: q/k/v must share one dtype of "
            f"{sorted(map(str, _DTYPES))}, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)}"
        )
    B, _, H, D = q.shape
    if D != HEAD_DIM or k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(
            f"{name}: the kernel is built for head dim {HEAD_DIM} and "
            f"matching q/k batch and heads; got q{tuple(q.shape)} "
            f"k{tuple(k.shape)}"
        )
    if bias is not None and bias.dim() != 4:
        raise ValueError(f"{name}: bias must be rank-4, got {tuple(bias.shape)}")
    devices = {t.device for t in (q, k, v, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")


def aligned_for_16_byte_loads(t: torch.Tensor) -> bool:
    """Whether the 16-byte loads of the bf16 variants (K1's ``tile`` and
    ``decode``, K2's and K3's ``tile``) read ``t`` [B, T, H, D] in place:
    a 16-byte-aligned base, a contiguous last dim, and strides in multiples
    of 8 elements (a dimension of size 1 is never stepped, so its stride
    does not matter). The C entry points refuse what fails this
    (``csrc/hopper_tile.cuh::aligned16``)."""
    return (
        t.data_ptr() % 16 == 0
        and t.stride(-1) == 1
        and all(n == 1 or s % 8 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]))
    )


def _read_in_place(tensors, wide_loads):
    """``tensors`` as a kernel reads them in place, and how many of them
    had to be copied for that: one read with 16-byte loads must pass
    :func:`aligned_for_16_byte_loads`, any other needs a contiguous last
    dim. A view the kernel cannot read in place is copied, never sent to
    another variant or to the plain version."""
    out, copies = [], 0
    for t, wide in zip(tensors, wide_loads):
        if not (aligned_for_16_byte_loads(t) if wide else t.stride(-1) == 1):
            # clone, not contiguous(): a contiguous view at a misaligned
            # base must move too
            t = t.clone(memory_format=torch.contiguous_format)
            copies += 1
        out.append(t)
    return out, copies


def kernel_inputs(variant: str, q, k, v):
    """``(q, k, v)`` as K1's ``variant`` reads them in place, and how many
    were copied (:func:`_read_in_place`). The 16-byte loads read K and V
    in both bf16 variants, and Q in the tile variant."""
    return _read_in_place((q, k, v), _WIDE_LOADS[variant])


def backward_kernel_inputs(variant: str, q, k, v, o, do):
    """``(q, k, v, o, do)`` as K2's and K3's ``variant`` reads them in
    place, and how many were copied (:func:`_read_in_place`). The tile
    variant reads all five with 16-byte loads, the fma variant none."""
    return _read_in_place((q, k, v, o, do), (variant == "tile",) * 5)


def _bias_view(bias, B, H, Q, K):
    """The bias as f32 [B, H, Q, K] with stride 0 on broadcast dims (no
    copy), and its four strides; ``(None, zeros)`` without one."""
    if bias is None:
        return None, (0, 0, 0, 0)
    bias = bias.float().expand(B, H, Q, K)
    return bias, bias.stride()


def _launch(
    q, k, v, bias, causal, return_lse
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    global FLASH_FWD_LAUNCHES, FLASH_FWD_COPIES
    _check(q, k, v, bias, "flash_attention")
    B, Q, H, D = q.shape
    K = k.shape[1]
    variant = forward_variant(q.dtype, Q)
    (q, k, v), copies = kernel_inputs(variant, q, k, v)
    FLASH_FWD_COPIES += copies
    bias, sb = _bias_view(bias, B, H, Q, K)
    o = torch.empty((B, Q, H, D), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((B, H, Q), dtype=torch.float32, device=q.device)
        if return_lse
        else None  # the kernel skips the write
    )
    lib = _load()["flash_fwd"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.trlx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            o.data_ptr(), lse.data_ptr() if lse is not None else None,
            FORWARD_VARIANTS[variant], _DTYPES[q.dtype], B, H, Q, K, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            *sb,
            float(D ** -0.5), int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed ({variant} variant): CUDA error {rc}"
        )
    FLASH_FWD_LAUNCHES += 1
    globals()[f"FLASH_FWD_{variant.upper()}_LAUNCHES"] += 1
    return o, lse


def _backward_args(q, k, v, bias, o, lse, do, causal):
    """Check the backward's inputs and pack, once, the arguments both
    backward kernels take: ``(variant, inputs, common)``. A view the
    variant cannot read in place is copied here and counted in
    ``FLASH_BWD_COPIES``."""
    global FLASH_BWD_COPIES
    _check(q, k, v, bias, "flash_attention backward")
    B, Q, H, D = q.shape
    K = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Q):
        raise ValueError(
            f"flash_attention backward: bad shapes o{tuple(o.shape)} "
            f"do{tuple(do.shape)} lse{tuple(lse.shape)} for q{tuple(q.shape)}"
        )
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(
            f"flash_attention backward: o/do must be {q.dtype} and lse "
            f"float32, got {o.dtype}/{do.dtype}/{lse.dtype}"
        )
    variant = backward_variant(q.dtype)
    (q, k, v, o, do), copies = backward_kernel_inputs(variant, q, k, v, o, do)
    FLASH_BWD_COPIES += copies
    lse = lse.contiguous()
    bias, sb = _bias_view(bias, B, H, Q, K)
    strides = (ctypes.c_longlong * 19)(
        *(s for t in (q, k, v, o, do) for s in t.stride()[:3]), *sb
    )
    # the tensors ride along so their memory outlives the launch
    inputs = (q, k, v, bias, o, do, lse)
    common = (BACKWARD_VARIANTS[variant], _DTYPES[q.dtype], B, H, Q, K, D,
              strides, float(D ** -0.5), int(bool(causal)))
    return variant, inputs, common


def _pointers(tensors):
    return [t.data_ptr() if t is not None else None for t in tensors]


def _launch_packed(name: str, args, dbias: bool = False) -> list:
    """K2 (``name`` ``"dq"``) or K3 (``"dkv"``) on the current stream from
    the arguments :func:`_backward_args` packed; returns its contiguous
    outputs (``[dq]``, ``[dq, dbias]`` with ``dbias``, or ``[dk, dv]``).
    ``dbias`` asks K2 for the bias gradient, a contiguous [B, H, Q, K] f32
    tensor (the C side refuses it under the causal flag)."""
    global FLASH_BWD_DQ_DBIAS_LAUNCHES
    variant, inputs, common = args
    like = inputs[:1] if name == "dq" else inputs[1:3]
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in like]
    if dbias:
        B, H, Q, K = common[2:6]
        outs.append(torch.empty((B, H, Q, K), dtype=torch.float32, device=like[0].device))
    ptrs = [t.data_ptr() for t in outs]
    if name == "dq" and not dbias:
        ptrs.append(None)
    lib = _load()["flash_bwd"]
    device = inputs[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"trlx_flash_bwd_{name}")(
            *_pointers(inputs), *ptrs, *common, stream
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_bwd_{name} kernel launch failed ({variant} variant"
            f"{', dbias' if dbias else ''}): CUDA error {rc}"
        )
    counter = f"FLASH_BWD_{name.upper()}"
    globals()[f"{counter}_LAUNCHES"] += 1
    globals()[f"{counter}_{variant.upper()}_LAUNCHES"] += 1
    FLASH_BWD_DQ_DBIAS_LAUNCHES += dbias
    return outs


def _launch_dq(q, k, v, bias, o, lse, do, causal) -> torch.Tensor:
    """The dQ kernel alone on the current stream; returns contiguous dq."""
    return _launch_packed("dq", _backward_args(q, k, v, bias, o, lse, do, causal))[0]


def _launch_dkv(q, k, v, bias, o, lse, do, causal) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel alone on the current stream; returns contiguous
    ``(dk, dv)``."""
    dk, dv = _launch_packed("dkv", _backward_args(q, k, v, bias, o, lse, do, causal))
    return dk, dv


def _launch_backward(q, k, v, bias, o, lse, do, causal, dbias: bool = False):
    """The dQ kernel, then the dK/dV kernel, from one packing of their
    arguments; returns ``(dq, dk, dv)``, and with ``dbias`` K2's [B, H, Q,
    K] f32 bias gradient after them."""
    if dbias:
        _check_dbias(bias, causal)
    args = _backward_args(q, k, v, bias, o, lse, do, causal)
    dq, *ds = _launch_packed("dq", args, dbias)
    return (dq, *_launch_packed("dkv", args), *ds)


__all__ = [
    "BACKWARD_VARIANTS",
    "FLASH_BWD_COPIES",
    "FLASH_BWD_DKV_FMA_LAUNCHES",
    "FLASH_BWD_DKV_LAUNCHES",
    "FLASH_BWD_DKV_TILE_LAUNCHES",
    "FLASH_BWD_DQ_DBIAS_LAUNCHES",
    "FLASH_BWD_DQ_FMA_LAUNCHES",
    "FLASH_BWD_DQ_LAUNCHES",
    "FLASH_BWD_DQ_TILE_LAUNCHES",
    "FLASH_FWD_COPIES",
    "FLASH_FWD_DECODE_LAUNCHES",
    "FLASH_FWD_FMA_LAUNCHES",
    "FLASH_FWD_LAUNCHES",
    "FLASH_FWD_TILE_LAUNCHES",
    "FORWARD_VARIANTS",
    "FlashAttention",
    "NEG_INF",
    "backward_kernel_inputs",
    "backward_variant",
    "build",
    "flash_attention",
    "flash_attention_backward_reference",
    "flash_attention_reference",
    "forward_variant",
    "kernel_inputs",
    "sum_to_shape",
    "visited_keys",
]
