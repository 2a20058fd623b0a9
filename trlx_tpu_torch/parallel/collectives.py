"""Distributed statistics and the collectives of sharded training
(counterpart of :mod:`trlx_tpu.parallel.collectives`).

- ``masked_mean``, ``masked_var`` and ``whiten`` take an optional process
  ``group``: with one of more than one rank, the sums and the count are
  all-reduced over it first, so that the statistics are the global
  batch's, as the reference's ``get_global_statistics``
  (``trlx/utils/modeling.py:9-34``) computes them. Without it they are the
  one-process functions the JAX package's jitted code computes.
- :class:`RunningMoments` (``scale_reward: running``) takes the exact
  variance of the whole batch: with a ``group`` it gathers every rank's
  scores and runs the one-process update on them, so a world-N run equals
  the world-1 run. (The JAX package's multi-host branch averages the hosts'
  variances and drops the spread between their means; ROADMAP queue 3.)
- The tensor collectives (:func:`all_reduce`, :func:`all_gather`) run in
  f32 (int64 for integers) on the wire, whatever the tensor's dtype, so
  that gloo, which lacks bf16 on some builds, and NCCL sum alike. On gloo,
  a CUDA tensor's gather is an all-reduce of a zero-filled buffer that each
  rank fills at its own offset (gloo carries only ``all_reduce`` and
  ``broadcast`` for CUDA tensors); elsewhere it is ``all_gather``.
- The autograd functions are tensor parallelism's and fsdp's: an identity
  whose backward all-reduces (:func:`copy_to_group`), an all-reduce whose
  backward is the identity (:func:`reduce_from_group`), a gather whose
  backward takes this rank's slice (:func:`gather_from_group`) and its
  inverse (:func:`scatter_to_group`), and a shard's all-gather whose
  backward sums the full gradient over the group and keeps this rank's
  slice (:func:`gather_param`, a reduce-scatter).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

Group = Optional[Any]  # a torch.distributed ProcessGroup, or None


def group_size(group: Group) -> int:
    """Ranks in ``group`` (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy in the wire dtype (f32, or int64 for integers)."""
    dtype = torch.float32 if x.is_floating_point() else torch.int64
    return x.detach().to(dtype).contiguous().clone()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, group: Group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` (``sum``, ``max`` or ``min``), in
    ``x``'s dtype; ``x`` itself without a group of more than one rank."""
    if group_size(group) <= 1:
        return x
    buf = _wire(x)
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(x.dtype)


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    n = group_size(group)
    if n <= 1:
        return x
    r = group_rank(group)
    buf = _wire(x)
    if buf.is_cuda and dist.get_backend(group) == "gloo":
        out = buf.new_zeros((n,) + tuple(buf.shape))
        out[r] = buf
        dist.all_reduce(out, group=group)
        parts = list(out.unbind(0))
    else:
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim).to(x.dtype)


def all_gather_object(obj: Any, group: Group) -> List[Any]:
    """Every rank's ``obj`` (pickled), in group-rank order."""
    if group_size(group) <= 1:
        return [obj]
    out: List[Any] = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _own_slice(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    n = group_size(group)
    return x.chunk(n, dim)[group_rank(group)].contiguous()


# ----------------------------- autograd ops ------------------------------ #


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim), None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(shard, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(all_reduce(g, ctx.group), ctx.group, ctx.dim), None, None


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``group`` (a
    column-parallel layer's input)."""
    return x if group_size(group) <= 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over ``group``; the backward is the identity (a
    row-parallel layer's partial outputs)."""
    return x if group_size(group) <= 1 else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group: Group, dim: int = -1) -> torch.Tensor:
    """The ranks' slices concatenated along ``dim``; the backward keeps
    this rank's slice of the (replicated) gradient."""
    return x if group_size(group) <= 1 else _GatherFromGroup.apply(x, group, dim)


def scatter_to_group(x: torch.Tensor, group: Group, dim: int = -1) -> torch.Tensor:
    """This rank's slice of a replicated ``x`` along ``dim``; the backward
    gathers the slices' gradients."""
    return x if group_size(group) <= 1 else _ScatterToGroup.apply(x, group, dim)


def gather_param(shard: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """A parameter's shards gathered along ``dim``; the backward sums the
    full gradient over ``group`` and keeps this rank's slice, so the
    shard's ``.grad`` is the gradient summed over the group's data."""
    if group_size(group) <= 1:
        return shard
    if not shard.requires_grad or not torch.is_grad_enabled():
        return all_gather(shard.detach(), group, dim)
    return _GatherParam.apply(shard, group, dim)


# ------------------------------ statistics ------------------------------- #


def _sum_and_count(x: torch.Tensor, mask: Optional[torch.Tensor], group: Group):
    if mask is None:
        s, c = x.sum(), torch.tensor(float(x.numel()), device=x.device, dtype=x.dtype)
    else:
        mask = mask.to(x.dtype)
        s, c = (x * mask).sum(), mask.sum()
    if group_size(group) > 1:
        s, c = all_reduce(torch.stack([s, c]), group).unbind(0)
    return s, c


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                group: Group = None) -> torch.Tensor:
    """Mean of ``x`` over the real (mask 1) entries of the global batch."""
    s, c = _sum_and_count(x, mask, group)
    return s / c.clamp_min(1.0)


def masked_var(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
               mean: Optional[torch.Tensor] = None, group: Group = None) -> torch.Tensor:
    """Variance (over N) of ``x`` over the real entries of the global batch."""
    if mean is None:
        mean = masked_mean(x, mask, group)
    centered = x - mean
    return masked_mean(centered * centered, mask, group)


def whiten(x: torch.Tensor, mask: Optional[torch.Tensor] = None, shift_mean: bool = True,
           eps: float = 1e-8, group: Group = None) -> torch.Tensor:
    """Masked zero-mean (unless ``shift_mean=False``), unit-variance
    normalisation with the global batch's statistics; the ``eps`` keeps a
    constant (or fully masked) batch finite."""
    mean = masked_mean(x, mask, group)
    var = masked_var(x, mask, mean, group)
    whitened = (x - mean) * torch.rsqrt(var + eps)
    if not shift_mean:
        whitened = whitened + mean
    return whitened


def logprobs_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log-prob of ``labels`` under ``logits`` (log-softmax, then gather)."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, labels.long()[..., None])[..., 0]


class RunningMoments:
    """Running mean/std of reward scalars across rollout chunks: host
    floats updated per chunk with the parallel variance combination
    (Bessel-corrected std), as the reference's (``modeling.py:83-104``).
    With a ``group`` of more than one rank, :meth:`update` first gathers
    every rank's scores: the update is the one-process update on the
    whole batch."""

    def __init__(self):
        self.mean = 0.0
        self.std = 1.0
        self.var = 1.0
        self.count = 1e-24

    def update(self, xs, group: Group = None) -> Tuple[float, float]:
        """Update from a batch; returns (batch_mean, batch_std)."""
        xs = np.asarray(xs, dtype=np.float64).reshape(-1)
        if group_size(group) > 1:
            xs = np.concatenate(all_gather_object(xs, group))
        xs_count = xs.size
        xs_mean = float(xs.mean())
        xs_var = float(xs.var())
        delta = xs_mean - self.mean
        tot_count = self.count + xs_count
        new_sum = xs_var * xs_count
        old_sum = self.var * self.count + delta**2 * self.count * xs_count / tot_count
        self.mean += delta * xs_count / tot_count
        self.var = (old_sum + new_sum) / tot_count
        self.std = float(np.sqrt(self.var * tot_count / max(tot_count - 1, 1)))
        self.count = tot_count
        return xs_mean, float(np.sqrt(xs_var * xs_count / max(xs_count - 1, 1)))


def flatten_dict(d: dict, parent_key: str = "", sep: str = "/") -> dict:
    """Flatten nested stat dicts for logging (``modeling.py:44-57``)."""
    items = {}
    for k, v in d.items():
        key = parent_key + sep + k if parent_key else k
        if isinstance(v, dict):
            items.update(flatten_dict(v, key, sep))
        else:
            items[key] = v
    return items
