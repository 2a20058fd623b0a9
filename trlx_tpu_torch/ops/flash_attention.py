"""Flash attention: the hand-written Hopper kernels, their plain PyTorch
versions, the autograd ``Function`` that joins them, and the launch
counters.

Counterpart of :mod:`trlx_tpu.ops.flash_attention`: ``_fwd_kernel`` (K1,
``csrc/flash_fwd.cu``), ``_dq_kernel`` (K2) and ``_dkv_kernel`` (K3, both
``csrc/flash_bwd.cu``), the ``jax.custom_vjp`` around them
(:class:`FlashAttention`), and the ring attention's block wrappers
(:func:`flash_block_fwd` on K1, :func:`flash_block_bwd` on K2 and K3
against an outside LSE). Dense calls take K1 in one of three variants,
by dtype and query count (:func:`forward_variant`): ``tile`` (bf16, Q >
16, tensor cores), ``decode`` (bf16, Q <= 16, a GEMV on the CUDA cores)
and ``fma`` (f32, the parity path), and the int8 KV cache's decode takes
``decode_int8`` (:func:`flash_attention_int8`: ``decode`` reading int8 K/V
and their scales where the cache holds them); and K2 and K3 in one of two, by dtype
(:func:`backward_variant`): ``tile`` (bf16, tensor cores) and ``fma``
(f32). The ring's block wrappers take ``split3`` in f32 (K1,
:func:`block_forward_variant`; K2 and K3 always, the backward running in
f32): f32 on the tensor cores through three bf16 planes of each operand,
which the split pre-pass (:func:`split_planes`, ``csrc/split_planes.cu``)
writes; ``split3`` skips a key tile that weighs exactly 0.
K2 also returns the bias's gradient (dS, for T5's learned relative
position bias) when the bias requires grad. Each source is CUDA C++ for
``sm_90a``, compiled with ``nvcc`` at first use into
``trlx_tpu_torch/_build/`` (a file named by the hash of the source and
the header it includes, so an edit rebuilds; the sources build in
parallel, the int8 cache's quantizing write, ``csrc/kv_quant.cu``, among
them: :mod:`trlx_tpu_torch.ops.kv_quant`) and bound through plain C
functions loaded with ``ctypes``.
Nothing is imported or built when this module is imported.

The kernels are templates over the head dim, built for
:data:`HEAD_DIMS` (16, 24, 32, 64, 96, 128 and 256); the C entry points
dispatch to the instantiation by D, and :func:`_check` refuses any other D
before a launch. Where D is not a whole number of 64-column swizzle atoms
the tile variants pad the tile in shared memory, the padding zero-filled
by the copies and never written back: at D = 96 (GPT-NeoX-20B) to 128
columns, read in place from the fused ``query_key_value`` projection's
``[B, T, H, 288]`` view; at D = 16, 24 and 32 (the learning guard and the
T5 stand-in, the randomwalks configs, the GPT-2 stand-in) to one atom of
64, read in place from GPT-2's fused ``c_attn`` output (a head of 24
starts at a multiple of 48 bytes, inside 16-byte-aligned rows of 432
elements).

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
#: K1's decode over the int8 KV cache (:func:`flash_attention_int8`),
#: counted in ``FLASH_FWD_LAUNCHES`` as well
FLASH_FWD_DECODE_INT8_LAUNCHES = 0
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
#: the split3 variants' launches (f32 through three bf16 planes on the
#: tensor cores; only the ring's block wrappers launch them), counted in
#: each kernel's total as well, and the split pre-pass's launches
#: (``csrc/split_planes.cu``): one per f32 operand the block wrappers split,
#: q, k and v forward, q, k, v and dO backward
FLASH_FWD_SPLIT3_LAUNCHES = 0
FLASH_BWD_DQ_SPLIT3_LAUNCHES = 0
FLASH_BWD_DKV_SPLIT3_LAUNCHES = 0
FLASH_SPLIT_PLANES_LAUNCHES = 0
#: K2 launches that also wrote the bias gradient (counted in the two above
#: as well)
FLASH_BWD_DQ_DBIAS_LAUNCHES = 0
#: q/k/v/o/dO copies the backward's argument packing made (a view the
#: variant cannot read in place), once per packing
FLASH_BWD_COPIES = 0
#: the ring's block wrappers' launches: K1 under :func:`flash_block_fwd`,
#: K2 then K3 under :func:`flash_block_bwd` (one each per call; counted in
#: the kernels' own counters as well)
FLASH_BLOCK_FWD_LAUNCHES = 0
FLASH_BLOCK_BWD_LAUNCHES = 0

#: the head dims the kernels are built for (the learning guard's and the T5
#: stand-in's 16, the randomwalks configs' 24, the GPT-2 stand-in's 32,
#: GPT-2's 64, GPT-NeoX-20B's 96, GPT-Neo's 128, GPT-J's 256;
#: ``csrc/hopper_tile.cuh::kHeadDims``); any other is refused before a launch
HEAD_DIMS = (16, 24, 32, 64, 96, 128, 256)
KEY_TILE = 64  # the forward kernel's key tile
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: K1's variants, by the code its C entry point takes (``decode_int8`` has
#: an entry point of its own, ``trlx_flash_fwd_int8``)
FORWARD_VARIANTS = {"fma": 0, "tile": 1, "decode": 2, "split3": 3, "decode_int8": 4}
#: per variant, whether it reads (q, k, v) with 16-byte loads
_WIDE_LOADS = {
    "fma": (False, False, False),
    "tile": (True, True, True),
    "decode": (False, True, True),
}
#: K2's and K3's variants, by the code their C entry points take; split3
#: has entry points of its own (``trlx_flash_bwd_{dq,dkv}_split3``), which
#: take no code
BACKWARD_VARIANTS = {"fma": 0, "tile": 1}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {
    "flash_fwd": os.path.join(_PKG_DIR, "csrc", "flash_fwd.cu"),
    "flash_bwd": os.path.join(_PKG_DIR, "csrc", "flash_bwd.cu"),
    "split_planes": os.path.join(_PKG_DIR, "csrc", "split_planes.cu"),
    # the int8 KV cache's quantizing write (ops/kv_quant.py)
    "kv_quant": os.path.join(_PKG_DIR, "csrc", "kv_quant.cu"),
}
#: the header every source includes (hashed with each)
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
            [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 13
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        # q, k, v, k_scale, v_scale, bias, o, lse, p_scale; B, H, Q, K, D;
        # the strides of q, k, v, the two scales and the bias
        fwd.trlx_flash_fwd_int8.restype = ctypes.c_int
        fwd.trlx_flash_fwd_int8.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 19
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
        # the split3 backward: q3, k3, v3, do3, bias, o, dout, lse, then dq,
        # or dk and dv
        for fn, outs in ((bwd.trlx_flash_bwd_dq_split3, 1), (bwd.trlx_flash_bwd_dkv_split3, 2)):
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] * (8 + outs)
                + [ctypes.c_int] * 5
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
            )
        split = ctypes.CDLL(paths["split_planes"])
        split.trlx_split_planes.restype = ctypes.c_int
        split.trlx_split_planes.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
            + [ctypes.c_void_p]
        )
        quant = ctypes.CDLL(paths["kv_quant"])
        quant.trlx_kv_quant_write.restype = ctypes.c_int
        quant.trlx_kv_quant_write.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
            + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 6
        )
        _lib.update(flash_fwd=fwd, flash_bwd=bwd, split_planes=split, kv_quant=quant)
    return _lib


def forward_variant(dtype: torch.dtype, Q: int) -> str:
    """The K1 variant of a dense call (:func:`flash_attention` and its
    ``Function``, every model, trainer and server) for ``Q`` query rows in
    ``dtype``: ``fma`` for f32 (the parity path: one TF32 pass on the
    tensor cores would break the f32 tolerances), ``decode`` for bf16 with
    ``Q <= 16`` (the 16-row query tile of :func:`forward_block_q`) and
    ``tile`` for bf16 with more rows (the 64-row tile). The ring's block
    forward takes :func:`block_forward_variant` instead."""
    if dtype == torch.float32:
        return "fma"
    if dtype == torch.bfloat16:
        return "decode" if Q <= 16 else "tile"
    raise ValueError(
        f"flash_attention: unsupported dtype {dtype}; the kernel is built "
        f"for {sorted(map(str, _DTYPES))}"
    )


def block_forward_variant(dtype: torch.dtype, Q: int) -> str:
    """The K1 variant of the ring's block forward (:func:`flash_block_fwd`)
    for ``Q`` query rows in ``dtype``: ``split3`` for f32 (the tensor cores
    on three bf16 planes of each operand, :func:`split_planes`), else the
    dense call's (:func:`forward_variant`: ``tile``, or ``decode`` at ``Q
    <= 16``)."""
    return "split3" if dtype == torch.float32 else forward_variant(dtype, Q)


def backward_variant(dtype: torch.dtype) -> str:
    """The K2/K3 variant of a dense backward (:class:`FlashAttention`) for
    ``dtype``: ``tile`` for bf16 (the tensor cores) and ``fma`` for f32 (the
    parity path: one TF32 pass would break the f32 tolerances). The ring's
    block backward (:func:`flash_block_bwd`) runs in f32 and always takes
    ``split3``."""
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


def split_planes_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain three-plane split of an f32 tensor: ``[3, *x.shape]`` bf16
    planes x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1), each
    rounded to nearest even. Each residual is exact in f32 and holds at
    most 16, then 8, significant bits, so x0 + x1 + x2 is x wherever the
    planes stay in bf16's normal range (``csrc/hopper_tile.cuh``'s
    split3). The pre-pass kernel is held against it bit for bit."""
    planes, rest = [], x.float()
    for _ in range(3):
        plane = rest.to(torch.bfloat16)
        planes.append(plane)
        rest = rest - plane.float()
    return torch.stack(planes)


def split_planes(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32 [B, T, H, D], any strides) as its three bf16 planes,
    one contiguous ``[3, B, T, H, D]`` tensor: on a CUDA tensor the
    pre-pass kernel (``csrc/split_planes.cu``, counted in
    ``FLASH_SPLIT_PLANES_LAUNCHES``), on a CPU tensor
    :func:`split_planes_reference`."""
    global FLASH_SPLIT_PLANES_LAUNCHES
    if x.dtype != torch.float32 or x.dim() != 4:
        raise ValueError(f"split_planes: takes f32 [B, T, H, D], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return split_planes_reference(x)
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    lib = _load()["split_planes"]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.trlx_split_planes(x.data_ptr(), out.data_ptr(), *x.shape, *x.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"split_planes kernel launch failed: CUDA error {rc}")
    FLASH_SPLIT_PLANES_LAUNCHES += 1
    return out


def flash_attention_reference(
    q: torch.Tensor,  # [B, Q, H, D]
    k: torch.Tensor,  # [B, K, H, D]
    v: torch.Tensor,  # [B, K, H, D]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Q, K]
    causal: bool = False,
    return_lse: bool = False,
    return_p_scale: bool = False,
):
    """The plain version: the same function as the kernel in plain tensor
    ops — logits and softmax in f32, finite ``NEG_INF`` masking, weights
    cast to V's dtype before the second product, output in q's dtype.
    Returns ``o`` [B, Q, H, D] (and ``lse`` [B, H, Q] f32, and with
    ``return_p_scale`` also K1's ``p_scale`` [B, H, Q] f32: see
    :func:`p_scale_reference`)."""
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
    if return_p_scale:
        lse = torch.logsumexp(logits, dim=-1)
        return out, lse, p_scale_reference(logits, lse)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def p_scale_reference(logits: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Per row, the factor that turns the backward's P = exp(S - LSE) into
    the softmax weights the forward used (K1's ``p_scale`` output,
    ``csrc/hopper_tile.cuh::p_scale_of``): exactly 1 on a row with a live
    key, and 1 / sum(exp(S - LSE)) on a row whose keys are all masked. There
    the row's max sits at NEG_INF's magnitude, where f32's spacing (64 at
    1e9) swallows log(l), so the LSE rounds to the max and exp(S - LSE) sums
    to the number of keys averaged rather than to 1. ``logits`` [B, H, Q,
    K] f32 with every mask added, ``lse`` their logsumexp."""
    dead = lse <= 0.5 * NEG_INF
    total = torch.exp(logits - lse[..., None]).sum(-1)
    return torch.where(dead, 1.0 / total, torch.ones_like(total))


def scale_rows(do: torch.Tensor, p_scale: torch.Tensor) -> torch.Tensor:
    """``do`` [B, Q, H, D] with each row multiplied by ``p_scale`` [B, H,
    Q] in f32 and rounded back to do's dtype. Every gradient of the
    backward is linear in dO, so this gives rows with no live key the
    derivative of the weights their forward used, and leaves every other
    row (a factor of exactly 1) bit for bit as it was."""
    return (do * p_scale.transpose(1, 2)[..., None]).to(do.dtype)


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
    kernel_tiles: bool = True,
):
    """The plain version of the backward kernels: the TPU kernels'
    recomputation in plain tensor ops. P = exp(S - LSE) in f32 (not
    rounded), delta = rowsum(dO * O) in f32, dP from dO and V widened to
    f32, dS = P * (dP - delta); dQ from dS cast to K's dtype, dK and dV
    from f32 P and dS; dQ and dK scaled once at the end. Under ``causal``
    with ``kernel_tiles`` keys in the tiles the forward kernel skipped
    carry no weight (:func:`visited_keys`), as in K2 and K3: a row whose
    visible keys are all masked averaged only the keys of those tiles in
    K1. The CPU path passes ``kernel_tiles=False``, since its plain forward
    averaged every key there. On such a row exp(S - LSE) sums to the
    number of keys averaged, not to 1; :class:`FlashAttention` scales dO's
    row first (:func:`scale_rows`). Returns ``(dq, dk, dv)`` in the dtypes
    of q, k, v; with ``with_dbias`` also dS [B, H, Q, K] f32, the bias's
    gradient before the sum over the dims where the bias broadcasts
    (unscaled: the bias is added after the scale; K2's output, which needs
    ``causal=False``)."""
    Q, K = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        logits = logits + causal_bias(Q, K, device=q.device)
    p = torch.exp(logits - lse[..., None])
    if causal and kernel_tiles:
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
    LSE, and K1's ``p_scale``; the backward scales dO's rows by it
    (:func:`scale_rows`: a row with no live key takes the derivative of
    the weights its forward used, every other row stays as it was), then
    launches the dQ kernel and the dK/dV kernel on CUDA tensors, or runs
    the plain backward on CPU tensors. A bias that
    requires grad (T5's learned relative position bias, which the TPU
    package leaves on XLA's einsum path) gets its gradient from the dQ
    kernel, summed over the dims where it broadcasts; any other bias gets
    none, as the TPU wrapper returns a zero cotangent for it."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal):
        if q.device.type == "cpu":
            o, lse, p_scale = flash_attention_reference(q, k, v, bias, causal, True, True)
        else:
            o, lse, p_scale = _launch(q, k, v, bias, causal, True, with_p_scale=True)
        ctx.save_for_backward(q, k, v, bias, o, lse, p_scale)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse, p_scale = ctx.saved_tensors
        with_dbias = ctx.needs_input_grad[3]
        if bias is not None:  # without one every row has a live key
            do = scale_rows(do, p_scale)
        if q.device.type == "cpu":
            grads = flash_attention_backward_reference(
                q, k, v, bias, o, lse, do, ctx.causal, with_dbias, kernel_tiles=False)
        else:
            grads = _launch_backward(q, k, v, bias, o, lse, do, ctx.causal, with_dbias)
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
    row whose visible keys are all padding (a left-padding row) averages
    only the keys of the tiles it visits, as the TPU kernel does, where
    the plain version averages every key at the mask's value. Either way
    the gradient is the derivative of the weights that row's forward used
    (:func:`scale_rows`)."""
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


def flash_attention_int8_reference(q, k, v, bias=None, causal=False):
    """The plain version of K1 over the int8 cache: the view dequantized to
    the compute dtype (:meth:`~trlx_tpu_torch.ops.attention.QuantizedKV.dequantize`,
    the JAX package's ``values * scale``), then
    :func:`flash_attention_reference`."""
    return flash_attention_reference(q, k.dequantize(), v.dequantize(), bias, causal)


def flash_attention_int8(
    q: torch.Tensor,  # [B, Q, H, D]
    k,  # QuantizedKV: int8 [B, K, H, D] and bf16 scales [B, K, H, 1]
    v,
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Q, K]
    causal: bool = False,
) -> torch.Tensor:
    """Attention over the int8 KV cache's K and V; returns ``o`` [B, Q, H,
    D] in q's dtype. On a CUDA tensor in bf16 with Q <= 16 (the decode
    step; :func:`forward_variant` gives ``decode``) it launches K1's
    ``decode_int8`` variant, which reads the int8 values and their scales
    where they lie. Every other call (a prefill, a chunk or verify window
    wider than 16 columns, f32's ``fma``, a query that requires grad) runs
    :func:`flash_attention` on the dequantized view: elementwise work the
    JAX package also does outside its kernel. A CPU tensor runs the plain
    versions."""
    from trlx_tpu_torch.ops.attention import QuantizedKV

    if not (isinstance(k, QuantizedKV) and isinstance(v, QuantizedKV)):
        raise ValueError("flash_attention_int8: k and v are both QuantizedKV")
    if (q.device.type == "cpu" or forward_variant(q.dtype, q.shape[1]) != "decode"
            or (torch.is_grad_enabled() and q.requires_grad)):
        return flash_attention(q, k.dequantize(), v.dequantize(), bias, causal)
    return _launch_int8(q, k, v, bias, causal, False)[0]


def flash_block_fwd(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, H, D]
    v: torch.Tensor,  # [B, Tk, H, D]
    bias: Optional[torch.Tensor],  # broadcastable to [B, H, Tq, Tk]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring block's forward with its logsumexp (the counterpart of the
    TPU package's ``flash_block_fwd``): K1 with the causal flag off, since a
    ring block carries its positions in the bias. Returns ``(o, lse)``: o
    [B, H, Tq, D] in q's dtype, softmax-normalised within the block (a
    view of K1's [B, Tq, H, D] output), and lse [B, H, Tq] f32. The scale
    is 1/sqrt(D), the one the ring passes; the TPU wrapper's tile sizes
    and interpret flag have no counterpart. A wholly masked block (every
    bias ``NEG_INF``) gives the uniform average and lse ≈ NEG_INF + log
    Tk, which the ring's combine weighs by exactly 0. Not differentiable
    by itself: the ring's ``Function`` calls :func:`flash_block_bwd`. A
    CPU tensor runs the plain version, a CUDA tensor K1 in the variant of
    :func:`block_forward_variant`: f32 ``split3`` after the split pre-pass
    of q, k and v (three launches, counted in
    ``FLASH_SPLIT_PLANES_LAUNCHES``), bf16 ``tile`` (``decode`` at Tq <=
    16). ``split3`` skips a key tile that weighs exactly 0
    (``csrc/hopper_tile.cuh::dead_tile``); ``tile`` visits every
    tile (its vote cost more than the skip saved)."""
    global FLASH_BLOCK_FWD_LAUNCHES
    if q.device.type == "cpu":
        o, lse = flash_attention_reference(q, k, v, bias, False, True)
    else:
        split3 = block_forward_variant(q.dtype, q.shape[1]) == "split3"
        o, lse = _launch_split3(q, k, v, bias) if split3 else _launch(q, k, v, bias, False, True)
        FLASH_BLOCK_FWD_LAUNCHES += 1
    return o.transpose(1, 2), lse


def flash_block_bwd(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, H, D]
    v: torch.Tensor,  # [B, Tk, H, D]
    bias: Optional[torch.Tensor],  # broadcastable to [B, H, Tq, Tk]
    o: torch.Tensor,  # [B, H, Tq, D], the combined output
    lse: torch.Tensor,  # [B, H, Tq] f32, the combined logsumexp
    do: torch.Tensor,  # [B, H, Tq, D]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring block's gradients against an outside (combined) logsumexp
    (the counterpart of the TPU package's ``flash_block_bwd``). Because
    ``lse`` and ``o`` are the ring's global ones, P = exp(S - lse) are the
    global softmax weights and delta = rowsum(dO * O) the global delta,
    which is what K2 and K3 recompute in-kernel. Every input is upcast to
    f32 first, as the TPU wrapper does, so K2 and K3 run their ``split3``
    variant (f32 on the tensor cores through three bf16 planes) after the
    split pre-pass of q, k, v and dO (four launches, counted in
    ``FLASH_SPLIT_PLANES_LAUNCHES``); O and dO reach delta as [B, Tq, H,
    D] views, read in place. A (query tile, key tile) whose bias leaves no
    pair live, in rows whose lse is above NEG_INF / 2, is skipped: its P
    is exactly 0. Returns ``(dq [B, Tq, H, D], dk, dv [B, Tk, H, D])`` in
    f32. A CPU tensor runs the plain backward, a CUDA tensor K2 then K3."""
    global FLASH_BLOCK_BWD_LAUNCHES
    q, k, v = (t.float() for t in (q, k, v))
    o, do = (t.float().transpose(1, 2) for t in (o, do))
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, bias, o, lse, do)
    grads = _launch_split3_backward(q, k, v, bias, o, lse, do)
    FLASH_BLOCK_BWD_LAUNCHES += 1
    return grads


def _check(q, k, v, bias, name: str) -> None:
    """Refuse what the kernels were not built for (before any launch)."""
    if torch.int8 in (k.dtype, v.dtype):
        raise ValueError(
            f"{name}: K/V of dtype int8 (the int8 KV cache) go through "
            "flash_attention_int8, whose decode_int8 variant reads them; no other route "
            "takes them")
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
    if D not in HEAD_DIMS:
        raise ValueError(
            f"{name}: the kernels are built for head dims {HEAD_DIMS}, got {D}"
        )
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(
            f"{name}: q and k must match in batch, heads and head dim; got "
            f"q{tuple(q.shape)} k{tuple(k.shape)}"
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


def _launch(q, k, v, bias, causal, return_lse, with_p_scale: bool = False):
    """K1 on the current stream: ``(o, lse)``, ``lse`` None unless asked
    for; with ``with_p_scale`` also its [B, H, Q] f32 ``p_scale``
    (:func:`p_scale_reference` is its plain version)."""
    global FLASH_FWD_LAUNCHES, FLASH_FWD_COPIES
    _check(q, k, v, bias, "flash_attention")
    B, Q, H, D = q.shape
    K = k.shape[1]
    variant = forward_variant(q.dtype, Q)
    (q, k, v), copies = kernel_inputs(variant, q, k, v)
    FLASH_FWD_COPIES += copies
    bias, sb = _bias_view(bias, B, H, Q, K)
    o = torch.empty((B, Q, H, D), dtype=q.dtype, device=q.device)
    lse, p_scale = (
        torch.empty((B, H, Q), dtype=torch.float32, device=q.device)
        if wanted
        else None  # the kernel skips the write
        for wanted in (return_lse, with_p_scale)
    )
    lib = _load()["flash_fwd"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.trlx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            o.data_ptr(), *_pointers((lse, p_scale)),
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
    return (o, lse, p_scale) if with_p_scale else (o, lse)


def aligned_for_8_byte_loads(t: torch.Tensor) -> bool:
    """Whether ``decode_int8``'s 8-byte loads read the int8 values ``t`` [B,
    K, H, D] in place: an 8-byte-aligned base, a contiguous last dim and
    strides in multiples of 8 (``csrc/flash_fwd.cu::aligned8``)."""
    return (
        t.data_ptr() % 8 == 0
        and t.stride(-1) == 1
        and all(n == 1 or s % 8 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]))
    )


def _launch_int8(q, k, v, bias, causal, return_lse, with_p_scale: bool = False):
    """K1 ``decode_int8`` on the current stream: ``(o, lse)``, ``lse`` None
    unless asked for, and with ``with_p_scale`` also K1's ``p_scale``.
    Values the 8-byte loads cannot read in place are copied and counted in
    ``FLASH_FWD_COPIES``; the scales are read through their strides."""
    global FLASH_FWD_LAUNCHES, FLASH_FWD_DECODE_INT8_LAUNCHES, FLASH_FWD_COPIES
    B, Q, H, D = q.shape
    K = k.values.shape[1]
    if q.dtype != torch.bfloat16 or Q > 16 or q.device.type != "cuda" or q.dim() != 4:
        raise ValueError(
            f"flash_attention_int8: the decode_int8 variant takes bf16 q [B, Q <= 16, H, D] "
            f"on a CUDA device, got {q.dtype} {tuple(q.shape)} on {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention_int8: the kernels are built for head dims {HEAD_DIMS}, got {D}")
    for t in (k, v):
        if (t.values.dtype != torch.int8 or t.values.shape != (B, K, H, D)
                or t.scale.dtype != torch.bfloat16 or t.scale.shape != (B, K, H, 1)):
            raise ValueError(
                f"flash_attention_int8: K/V must be int8 [{B}, K, {H}, {D}] with bf16 scales "
                f"[{B}, K, {H}, 1], got {t.values.dtype} {tuple(t.values.shape)} / "
                f"{t.scale.dtype} {tuple(t.scale.shape)}")
    if bias is not None and bias.dim() != 4:
        raise ValueError(f"flash_attention_int8: bias must be rank-4, got {tuple(bias.shape)}")
    devices = {t.device for t in (q, k.values, k.scale, v.values, v.scale, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"flash_attention_int8: inputs on several devices {devices}")
    values = []
    for t in (k.values, v.values):
        if not aligned_for_8_byte_loads(t):
            t = t.clone(memory_format=torch.contiguous_format)
            FLASH_FWD_COPIES += 1
        values.append(t)
    (q,), copies = _read_in_place((q,), (False,))
    FLASH_FWD_COPIES += copies
    bias, sb = _bias_view(bias, B, H, Q, K)
    o = torch.empty((B, Q, H, D), dtype=q.dtype, device=q.device)
    lse, p_scale = (
        torch.empty((B, H, Q), dtype=torch.float32, device=q.device) if wanted else None
        for wanted in (return_lse, with_p_scale)
    )
    lib = _load()["flash_fwd"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.trlx_flash_fwd_int8(
            q.data_ptr(), values[0].data_ptr(), values[1].data_ptr(),
            k.scale.data_ptr(), v.scale.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            o.data_ptr(), *_pointers((lse, p_scale)),
            B, H, Q, K, D,
            *q.stride()[:3], *values[0].stride()[:3], *values[1].stride()[:3],
            *k.scale.stride()[:3], *v.scale.stride()[:3], *sb,
            float(D ** -0.5), int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed (decode_int8 variant): CUDA error {rc}")
    FLASH_FWD_LAUNCHES += 1
    FLASH_FWD_DECODE_INT8_LAUNCHES += 1
    return (o, lse, p_scale) if with_p_scale else (o, lse)


def _check_backward(q, k, v, bias, o, lse, do, name: str) -> None:
    """:func:`_check`, and o, dO and the LSE against q."""
    _check(q, k, v, bias, name)
    B, Q, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Q):
        raise ValueError(
            f"{name}: bad shapes o{tuple(o.shape)} "
            f"do{tuple(do.shape)} lse{tuple(lse.shape)} for q{tuple(q.shape)}"
        )
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(
            f"{name}: o/do must be {q.dtype} and lse "
            f"float32, got {o.dtype}/{do.dtype}/{lse.dtype}"
        )


def _launch_split3(q, k, v, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 ``split3`` on f32 q, k, v (the causal flag off): the split
    pre-pass of each, then the kernel on their planes; returns ``(o [B,
    Q, H, D] f32, lse [B, H, Q] f32)``."""
    global FLASH_FWD_LAUNCHES, FLASH_FWD_SPLIT3_LAUNCHES
    _check(q, k, v, bias, "flash_block_fwd")
    B, Q, H, D = q.shape
    K = k.shape[1]
    q3, k3, v3 = (split_planes(t) for t in (q, k, v))
    bias, sb = _bias_view(bias, B, H, Q, K)
    o = torch.empty((B, Q, H, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Q), dtype=torch.float32, device=q.device)
    lib = _load()["flash_fwd"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.trlx_flash_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
            bias.data_ptr() if bias is not None else None, o.data_ptr(), lse.data_ptr(), None,
            FORWARD_VARIANTS["split3"], _DTYPES[torch.float32], B, H, Q, K, D,
            *q3.stride()[1:4], *k3.stride()[1:4], *v3.stride()[1:4], *sb,
            float(D ** -0.5), 0, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed (split3 variant): CUDA error {rc}")
    FLASH_FWD_LAUNCHES += 1
    FLASH_FWD_SPLIT3_LAUNCHES += 1
    return o, lse


def _launch_split3_backward(q, k, v, bias, o, lse, do):
    """K2 then K3 ``split3`` on f32 inputs (the causal flag off): the split
    pre-pass of q, k, v and dO, then each kernel on their planes, with O
    and dO read in place for delta (a view whose head dim is not
    contiguous is copied and counted in ``FLASH_BWD_COPIES``); returns
    ``(dq, dk, dv)`` contiguous f32."""
    global FLASH_BWD_COPIES
    _check_backward(q, k, v, bias, o, lse, do, "flash_block_bwd")
    B, Q, H, D = q.shape
    K = k.shape[1]
    (o, do), copies = _read_in_place((o, do), (False, False))
    FLASH_BWD_COPIES += copies
    lse = lse.contiguous()
    planes = [split_planes(t) for t in (q, k, v, do)]
    bias, sb = _bias_view(bias, B, H, Q, K)
    strides = (ctypes.c_longlong * 10)(*o.stride()[:3], *do.stride()[:3], *sb)
    inputs = [*planes, bias, o, do, lse]
    dq = torch.empty((B, Q, H, D), dtype=torch.float32, device=q.device)
    dk, dv = (torch.empty((B, K, H, D), dtype=torch.float32, device=q.device) for _ in range(2))
    lib = _load()["flash_bwd"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for name, outs in (("dq", (dq,)), ("dkv", (dk, dv))):
            rc = getattr(lib, f"trlx_flash_bwd_{name}_split3")(
                *_pointers(inputs), *(t.data_ptr() for t in outs), B, H, Q, K, D, strides,
                float(D ** -0.5), stream)
            if rc != 0:
                raise RuntimeError(
                    f"flash_bwd_{name} kernel launch failed (split3 variant): CUDA error {rc}")
            globals()[f"FLASH_BWD_{name.upper()}_LAUNCHES"] += 1
            globals()[f"FLASH_BWD_{name.upper()}_SPLIT3_LAUNCHES"] += 1
    return dq, dk, dv


def _backward_args(q, k, v, bias, o, lse, do, causal):
    """Check the backward's inputs and pack, once, the arguments both
    backward kernels take: ``(variant, inputs, common)``. A view the
    variant cannot read in place is copied here and counted in
    ``FLASH_BWD_COPIES``."""
    global FLASH_BWD_COPIES
    _check_backward(q, k, v, bias, o, lse, do, "flash_attention backward")
    B, Q, H, D = q.shape
    K = k.shape[1]
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
    "FLASH_BLOCK_BWD_LAUNCHES",
    "FLASH_BLOCK_FWD_LAUNCHES",
    "FLASH_BWD_COPIES",
    "FLASH_BWD_DKV_FMA_LAUNCHES",
    "FLASH_BWD_DKV_LAUNCHES",
    "FLASH_BWD_DKV_SPLIT3_LAUNCHES",
    "FLASH_BWD_DKV_TILE_LAUNCHES",
    "FLASH_BWD_DQ_DBIAS_LAUNCHES",
    "FLASH_BWD_DQ_FMA_LAUNCHES",
    "FLASH_BWD_DQ_LAUNCHES",
    "FLASH_BWD_DQ_SPLIT3_LAUNCHES",
    "FLASH_BWD_DQ_TILE_LAUNCHES",
    "FLASH_FWD_COPIES",
    "FLASH_FWD_DECODE_INT8_LAUNCHES",
    "FLASH_FWD_DECODE_LAUNCHES",
    "FLASH_FWD_FMA_LAUNCHES",
    "FLASH_FWD_LAUNCHES",
    "FLASH_FWD_SPLIT3_LAUNCHES",
    "FLASH_FWD_TILE_LAUNCHES",
    "FLASH_SPLIT_PLANES_LAUNCHES",
    "FORWARD_VARIANTS",
    "FlashAttention",
    "NEG_INF",
    "backward_kernel_inputs",
    "backward_variant",
    "block_forward_variant",
    "build",
    "flash_attention",
    "flash_attention_backward_reference",
    "flash_attention_int8",
    "flash_attention_int8_reference",
    "flash_attention_reference",
    "flash_block_bwd",
    "flash_block_fwd",
    "forward_variant",
    "kernel_inputs",
    "p_scale_reference",
    "scale_rows",
    "split_planes",
    "split_planes_reference",
    "sum_to_shape",
    "visited_keys",
]
