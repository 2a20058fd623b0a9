"""Ring attention: exact attention with the sequence sharded over the
mesh's ``sp`` axis (counterpart of :mod:`trlx_tpu.ops.ring_attention`).

Rank ``i`` of an ``sp`` ring of ``n`` holds query, key and value block
``i`` of the sequence (global positions ``[i * T/n, (i + 1) * T/n)``). The
key/value blocks pass around the ring, one rank on per step, and each step
folds one block into the rank's output, so the [T, T] score matrix never
exists. The pass to the next rank is one ``torch.distributed``
``batch_isend_irecv`` on the ring's process group (the TPU package's
``ppermute(i -> i+1)``); a ring of one passes nothing.

- :func:`ring_flash_attention` (``impl="flash"``): each block runs the
  flash block kernels (:func:`~trlx_tpu_torch.ops.flash_attention.
  flash_block_fwd` on K1, ``flash_block_bwd`` on K2 and K3 on a CUDA
  tensor; their plain versions on a CPU tensor); the blocks' normalised
  outputs combine by their logsumexp, and the backward is a second ring
  pass that recomputes each block's weights from the combined logsumexp,
  dq accumulating at home while dk and dv ride the ring back to theirs.
- :func:`ring_attention` (``impl="naive"``): the online softmax in plain
  f32 tensor ops, differentiated by autograd through the exchange.

Each pass is a generator (:func:`ring_fwd_steps`, :func:`ring_bwd_steps`)
over one step function per block (``_fwd_step``, ``_bwd_step``) that
yields what the rank passes on and takes what it receives, so any
exchange can drive it: :func:`run_ring` drives it over a process group,
and a driver that holds every rank's pass in one process (``chip_smoke.py``
runs the ``sp = 4`` ring's ranks in lockstep on one card) over a list.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from trlx_tpu_torch.ops.attention import NEG_INF
from trlx_tpu_torch.ops.flash_attention import flash_block_bwd, flash_block_fwd
from trlx_tpu_torch.parallel.mesh import AXIS_SP


def _block_bias(mask_blk, q_pos, k_pos, causal):
    """[B, 1, Tq, Tk] f32 additive bias from the block's key validity
    ([B, Tk]) and, under ``causal``, the global positions."""
    bias = torch.where(mask_blk[:, None, None, :] > 0, 0.0, NEG_INF).float()
    if causal:
        bias = bias + torch.where(k_pos[None, :] <= q_pos[:, None], 0.0, NEG_INF)[None, None]
    return bias


def _positions(block: int, size: int, device) -> torch.Tensor:
    """Global positions of the ``block``-th block of ``size``."""
    return block * size + torch.arange(size, device=device)


def _combine(out, lse, o_i, lse_i):
    """Fold a block's normalised output ``o_i`` [B, H, Tq, D] and its
    logsumexp ``lse_i`` into the running ``(out, lse)`` by their weights
    (f32). A wholly masked block (lse_i ≈ NEG_INF) weighs exactly 0."""
    m_new = torch.maximum(lse, lse_i)
    w_old = torch.exp(lse - m_new)
    w_new = torch.exp(lse_i - m_new)
    denom = torch.clamp_min(w_old + w_new, 1e-30)
    out = (out * w_old[..., None] + o_i * w_new[..., None]) / denom[..., None]
    return out, m_new + torch.log(denom)


def _fwd_step(q, blocks, q_pos, src, causal, out, lse):
    """One forward ring step: the key/value block from rank ``src``
    (``blocks`` = (k, v, kv_mask)) through :func:`flash_block_fwd`, its
    output rounded to q's dtype and folded in f32 into ``(out, lse)``."""
    k_blk, v_blk, mask_blk = blocks
    bias = _block_bias(mask_blk, q_pos, _positions(src, k_blk.shape[1], q.device), causal)
    o_i, lse_i = flash_block_fwd(q, k_blk, v_blk, bias)
    return _combine(out, lse, o_i.float(), lse_i)


def _bwd_step(q, blocks, q_pos, src, causal, o, lse, do, dq):
    """One backward ring step: the gradients of the block from rank
    ``src`` (``blocks`` = (k, v, kv_mask, dk, dv), dk/dv f32 accumulating
    for that rank) against the global ``o``, ``lse`` and ``do`` through
    :func:`flash_block_bwd`. Returns ``(dq, blocks)`` with this block's
    share added."""
    k_blk, v_blk, mask_blk, dk_blk, dv_blk = blocks
    bias = _block_bias(mask_blk, q_pos, _positions(src, k_blk.shape[1], q.device), causal)
    dq_i, dk_i, dv_i = flash_block_bwd(q, k_blk, v_blk, bias, o, lse, do)
    return dq + dq_i, (k_blk, v_blk, mask_blk, dk_blk + dk_i, dv_blk + dv_i)


def ring_fwd_steps(q, k, v, kv_mask, n: int, idx: int, causal: bool):
    """The forward pass of rank ``idx`` of a ring of ``n``, as a generator.

    q [B, Tq, H, D], k/v [B, Tk, H, D], kv_mask [B, Tk] (nonzero = a valid
    key) are the rank's own blocks. After every step but the last it
    yields the blocks it passes to rank ``idx + 1``, ``(k, v, kv_mask)``,
    and takes the ones rank ``idx - 1`` passed it. Returns ``(out
    [B, Tq, H, D] in q's dtype, lse [B, H, Tq] f32)``."""
    B, Tq, H, D = q.shape
    q_pos = _positions(idx, Tq, q.device)
    out = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, Tq), float("-inf"), device=q.device)
    blocks = (k, v, kv_mask)
    for i in range(n):
        out, lse = _fwd_step(q, blocks, q_pos, (idx - i) % n, causal, out, lse)
        if i < n - 1:
            blocks = yield blocks
    return out.transpose(1, 2).to(q.dtype), lse


def ring_bwd_steps(q, k, v, kv_mask, out, lse, dout, n: int, idx: int, causal: bool):
    """The backward pass of rank ``idx`` of a ring of ``n``, as a
    generator, from :func:`ring_fwd_steps`' ``out`` and ``lse`` and the
    output's cotangent ``dout`` [B, Tq, H, D]. After every step but the
    last it yields ``(k, v, kv_mask, dk, dv)`` for rank ``idx + 1``, and
    after the last ``(dk, dv)`` alone: the exchange brings each rank's
    gradients home. Every block runs in f32 (:func:`flash_block_bwd`);
    returns ``(dq, dk, dv)`` in the dtypes of q, k, v."""
    q_pos = _positions(idx, q.shape[1], q.device)
    o = out.float().transpose(1, 2)
    do = dout.float().transpose(1, 2)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    zeros = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    blocks = (k, v, kv_mask, zeros, zeros)
    for i in range(n):
        dq, blocks = _bwd_step(q, blocks, q_pos, (idx - i) % n, causal, o, lse, do, dq)
        if i < n - 1:
            blocks = yield blocks
    dk, dv = yield blocks[3:]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _ring(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _pass_on(tensors, group, step: int = 1):
    """Send ``tensors`` to the rank ``step`` places on along ``group``'s
    ring and return those received from the rank ``step`` places back, in
    one ``batch_isend_irecv`` (one tag per tensor). A ring of one passes
    nothing: the identity."""
    n, idx = _ring(group)
    if n == 1:
        return tuple(tensors)
    ranks = dist.get_process_group_ranks(group)
    to, frm = ranks[(idx + step) % n], ranks[(idx - step) % n]
    received = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    ops = []
    for tag, (t, r) in enumerate(zip(tensors, received)):
        ops += [dist.P2POp(dist.isend, t.contiguous(), to, group, tag),
                dist.P2POp(dist.irecv, r, frm, group, tag)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(received)


def run_ring(steps, group):
    """Drive a ring pass (:func:`ring_fwd_steps`, :func:`ring_bwd_steps`)
    over ``group``'s point-to-point exchange; returns the pass's result."""
    try:
        outgoing = next(steps)
        while True:
            outgoing = steps.send(_pass_on(outgoing, group))
    except StopIteration as stop:
        return stop.value


class RingFlashAttention(torch.autograd.Function):
    """The ring with the flash block kernels and a recomputing backward
    (the counterpart of the TPU package's ``custom_vjp``): the forward
    saves the rank's q, k, v, mask, output and logsumexp, O(Tq·D) a rank
    whatever the global length; the backward is the second ring pass."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, group, causal):
        n, idx = _ring(group)
        out, lse = run_ring(ring_fwd_steps(q, k, v, kv_mask, n, idx, causal), group)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        n, idx = _ring(ctx.group)
        grads = run_ring(
            ring_bwd_steps(q, k, v, kv_mask, out, lse, dout, n, idx, ctx.causal), ctx.group)
        return (*grads, None, None, None)


def ring_flash_attention(q, k, v, kv_mask, group, causal: bool = True):
    """Ring attention through the flash block kernels on ``group``'s ring
    (the rank's blocks, layouts as :func:`ring_fwd_steps`); returns the
    rank's output [B, Tq, H, D] in q's dtype, differentiable in q, k,
    v."""
    return RingFlashAttention.apply(q, k, v, kv_mask, group, causal)


class _PassOn(torch.autograd.Function):
    """Tensors passed to the ring's next rank; the backward passes their
    cotangents back to the previous one."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return _pass_on(tensors, group)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_pass_on(grads, ctx.group, step=-1))


def ring_attention(q, k, v, kv_mask, group, causal: bool = True):
    """The naive ring (the TPU package's ``ring_attention``): an online
    softmax over the blocks in plain f32 tensor ops, differentiated by
    autograd through the exchange, so it stores every step's [Tq, Tk]
    scores. A yardstick for :func:`ring_flash_attention`; same layouts."""
    n, idx = _ring(group)
    B, Tq, H, D = q.shape
    q32 = q.float()
    q_pos = _positions(idx, Tq, q.device)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    k_blk, v_blk, mask_blk = k, v, kv_mask
    for i in range(n):
        k_pos = _positions((idx - i) % n, k_blk.shape[1], q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * D ** -0.5
        logits = logits + _block_bias(mask_blk, q_pos, k_pos, causal)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        correction = torch.exp(m - new_m)
        p = torch.exp(logits - new_m[..., None])
        l = l * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        m = new_m
        if i < n - 1:
            k_blk, v_blk = _PassOn.apply(group, k_blk, v_blk)
            (mask_blk,) = _pass_on((mask_blk,), group)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)


def ring_attention_sharded(
    q: torch.Tensor,  # [B / (dp * fsdp), T / sp, H, D]: this rank's shard
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    kv_mask: Optional[torch.Tensor] = None,  # [B / (dp * fsdp), T / sp]
    axis_name: str = AXIS_SP,
    causal: bool = True,
    impl: str = "flash",  # "flash" (recomputing backward) | "naive" (autograd)
) -> torch.Tensor:
    """Ring attention over ``mesh``'s ``axis_name`` ring, the counterpart
    of the TPU package's ``shard_map`` entry point. Where that takes
    global arrays, each rank passes its own shard and gets its own: q, k,
    v [B / (dp * fsdp), T / sp, H, D] and kv_mask [B / (dp * fsdp),
    T / sp] (default all valid), the batch split over the batch axes and
    the sequence over ``axis_name`` in rank order
    (:func:`~trlx_tpu_torch.parallel.mesh.local_shard` cuts them from a
    tensor every rank holds); returns the rank's output shard [B / (dp *
    fsdp), T / sp, H, D] in q's dtype. The tensors must lie on the mesh's
    device type: CUDA tensors on an NCCL mesh, CPU tensors on a gloo
    one."""
    if impl not in ("flash", "naive"):
        raise ValueError(f"impl must be 'flash' or 'naive', got {impl!r}")
    if q.device.type != mesh.device_type:
        raise ValueError(f"ring_attention_sharded: {q.device.type} tensors on a "
                         f"{mesh.device_type} mesh")
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    base = ring_flash_attention if impl == "flash" else ring_attention
    return base(q, k, v, kv_mask, mesh.get_group(axis_name), causal)
