"""Small helpers shared across the port: the clock, device resolution,
seeding, the rollout phase's compute-dtype weight cast and the chunked
logprobs (the port's own copies of :func:`trlx_tpu.utils.set_seed` /
``infinite_loader`` / ``compute_dtype_cast``). ``masked_mean``, ``whiten``,
``logprobs_from_logits`` and ``RunningMoments`` are re-exported from
:mod:`trlx_tpu_torch.parallel.collectives`, whose functions without a
process group are the one-process ones."""

from __future__ import annotations

import copy
import random
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

# the one-process statistics are the collectives' with no group
from trlx_tpu_torch.parallel.collectives import (  # noqa: F401
    RunningMoments,
    logprobs_from_logits,
    masked_mean,
    whiten,
)

# the port's one clock (seconds) for every host-side duration: the
# tracer's, so that spans, the Logger and the engine's marks share it
from trlx_tpu_torch.telemetry.tracer import monotonic  # noqa: F401


def resolve_device(device: Optional[object] = None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and missing —
    entry points never fall back to the CPU; callers pass ``"cpu"``
    explicitly to run the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: trlx_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain versions"
        )
    return dev


def set_seed(seed: int, device=None) -> torch.Generator:
    """Seed the host RNGs (``random``, numpy) and return a
    ``torch.Generator`` on ``device`` seeded with ``seed``: the port
    threads explicit generators instead of the global torch RNG."""
    random.seed(seed)
    np.random.seed(seed)
    gen = torch.Generator(device=torch.device("cpu" if device is None else device))
    gen.manual_seed(int(seed))
    return gen


#: parameter-name components the rollout cast leaves in their storage
#: dtype: the value/Q heads' ``fc2`` and the MoE ``router`` compute in f32
#: (the JAX package's ``ROLLOUT_CAST_EXCLUDE``), and the port also keeps
#: every layer norm (``ln_*``) f32, since its norms consume their
#: parameters in f32 (the reference rounds them; ROADMAP queue 3)
ROLLOUT_CAST_EXCLUDE = ("router", "fc2", "ln_")


def cast_excluded(name: str) -> bool:
    """Whether parameter ``name`` keeps its storage dtype under the cast."""
    return any(part in ROLLOUT_CAST_EXCLUDE[:2] or part.startswith(ROLLOUT_CAST_EXCLUDE[2])
               for part in name.split("."))


def _cast_targets(module: nn.Module, dtype: torch.dtype):
    """``(name, parameter)`` of each floating parameter the cast rounds."""
    return [(n, p) for n, p in module.named_parameters()
            if p.is_floating_point() and p.dtype != dtype and not cast_excluded(n)]


def rollout_cast_dtype(train, model_config) -> Optional[torch.dtype]:
    """The compute dtype the rollout phase's weights are cast to under
    ``train.rollout_param_cast`` (default on), or ``None`` when it is off
    or the compute dtype is already the parameters' dtype."""
    dtype = getattr(torch, str(model_config.dtype))
    if (not train.training.get("rollout_param_cast", True)
            or dtype == getattr(torch, str(model_config.param_dtype))):
        return None
    return dtype


@torch.no_grad()
def compute_dtype_cast(module: nn.Module, dtype, in_place: bool = False,
                       gather: Optional[Callable] = None) -> nn.Module:
    """The rollout phase's weights in the compute dtype ``dtype``.

    Every projection, embedding and head already rounds its parameters to
    the compute dtype per use, so a module whose parameters hold those
    rounded values gives bit-identical outputs and reads half the bytes.
    The parameters :func:`cast_excluded` names keep their dtype.

    - ``in_place=False``: a copy of ``module`` whose cast parameters are
      new compute-dtype tensors (no gradient); every other parameter and
      buffer is shared with ``module``, so the copy costs only the cast
      tensors, and an excluded parameter reads the live master.
    - ``in_place=True``: ``module``'s own parameters are replaced by their
      cast (a frozen module, such as the KL reference: cast once, for
      good, which also halves its memory).
    - ``gather`` (under a mesh, ``(name, shard, dtype) -> tensor``): each
      parameter of the copy is ``gather`` of its shard, cast (to
      ``dtype``, or ``None`` to keep its own) before the gather; ``dtype``
      ``None`` then makes a gathered copy without a cast."""
    if dtype is not None and not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, str(dtype))
    targets = _cast_targets(module, dtype) if dtype is not None else []
    if in_place:
        for _, p in targets:
            p.data = p.data.to(dtype)
        return module
    cast = {id(p) for _, p in targets}
    memo = {id(p): p for p in module.parameters()}
    memo.update({id(b): b for b in module.buffers()})
    for name, p in module.named_parameters():
        want = dtype if id(p) in cast else None
        t = gather(name, p, want) if gather is not None else (
            p.detach().to(want) if want is not None else p)
        if t is not p:
            memo[id(p)] = nn.Parameter(t.detach(), requires_grad=False)
    return copy.deepcopy(module, memo)


def behaviour_snapshot(module: nn.Module, dtype=None,
                       gather: Optional[Callable] = None) -> nn.Module:
    """A frozen copy of ``module`` that owns every tensor an update can
    change: the streamed phase's behaviour policy and each asynchronous
    weight push. With ``dtype`` (the rollout cast) the parameters
    :func:`compute_dtype_cast` rounds are new ``dtype`` tensors; every
    other trainable parameter is cloned, so an optimizer step on the
    masters leaves the copy as it was. Frozen parameters and buffers are
    shared: no update touches them. ``gather`` (under a mesh) gathers
    each parameter's shard, after its cast, as :func:`compute_dtype_cast`
    does."""
    if dtype is not None:
        dtype = dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))
    cast = {id(p) for _, p in _cast_targets(module, dtype)} if dtype is not None else set()
    memo = {id(b): b for b in module.buffers()}
    for name, p in module.named_parameters():
        want = dtype if id(p) in cast else None
        t = gather(name, p, want) if gather is not None else p
        if id(p) in cast and gather is None:
            memo[id(p)] = nn.Parameter(p.detach().to(dtype), requires_grad=False)
        elif t is not p:
            memo[id(p)] = nn.Parameter(t.detach(), requires_grad=False)
        elif p.requires_grad:
            memo[id(p)] = nn.Parameter(p.detach().clone(), requires_grad=False)
        else:
            memo[id(p)] = p
    return copy.deepcopy(module, memo)


def infinite_loader(factory: Callable[[int], Iterable]) -> Iterable:
    """Cycle ``factory(epoch)`` forever (prompt draws); raises instead of
    spinning when a pass yields nothing."""
    epoch = 0
    while True:
        yielded = False
        for item in factory(epoch):
            yielded = True
            yield item
        if not yielded:
            raise ValueError("infinite_loader: underlying loader is empty")
        epoch += 1


def chunked_logprobs(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    hidden: torch.Tensor,  # [B, R, d]
    labels: torch.Tensor,  # [B, R]
    chunk: int,
) -> torch.Tensor:
    """``logprobs_from_logits(logits_fn(hidden), labels)``, ``chunk``
    positions at a time, each chunk under ``torch.utils.checkpoint``: the
    forward keeps only each chunk's inputs and the backward recomputes its
    logits, so the [B, R, V] f32 logits never exist at once."""
    from torch.utils.checkpoint import checkpoint

    R = labels.shape[1]
    if R % chunk:
        raise ValueError(
            f"train.logprob_chunk={chunk} does not divide the bound response "
            f"width {R} (bind_prompt_budget shrank the decode budget); pick a "
            "chunk dividing both"
        )

    def one(h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return logprobs_from_logits(logits_fn(h), t)

    return torch.cat([
        checkpoint(one, hidden[:, s:s + chunk], labels[:, s:s + chunk], use_reentrant=False)
        for s in range(0, R, chunk)
    ], 1)
