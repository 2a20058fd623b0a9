"""Small helpers shared across the port: the clock, device resolution,
seeding, the rollout phase's compute-dtype weight cast, masked statistics
and running reward moments (the port's own copies of
:func:`trlx_tpu.utils.set_seed` / ``infinite_loader`` /
``compute_dtype_cast`` and of ``whiten``, ``logprobs_from_logits`` and
``RunningMoments`` from :mod:`trlx_tpu.parallel.collectives`)."""

from __future__ import annotations

import copy
import random
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

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
def compute_dtype_cast(module: nn.Module, dtype, in_place: bool = False) -> nn.Module:
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
      good, which also halves its memory)."""
    dtype = dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))
    targets = _cast_targets(module, dtype)
    if in_place:
        for _, p in targets:
            p.data = p.data.to(dtype)
        return module
    memo = {id(p): p for p in module.parameters()}
    memo.update({id(b): b for b in module.buffers()})
    memo.update({id(p): nn.Parameter(p.detach().to(dtype), requires_grad=False)
                 for _, p in targets})
    return copy.deepcopy(module, memo)


def behaviour_snapshot(module: nn.Module, dtype=None) -> nn.Module:
    """A frozen copy of ``module`` that owns every tensor an update can
    change: the streamed phase's behaviour policy and each asynchronous
    weight push. With ``dtype`` (the rollout cast) the parameters
    :func:`compute_dtype_cast` rounds are new ``dtype`` tensors; every
    other trainable parameter is cloned, so an optimizer step on the
    masters leaves the copy as it was. Frozen parameters and buffers are
    shared: no update touches them."""
    if dtype is not None:
        dtype = dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))
    cast = {id(p) for _, p in _cast_targets(module, dtype)} if dtype is not None else set()
    memo = {id(b): b for b in module.buffers()}
    for p in module.parameters():
        if id(p) in cast:
            memo[id(p)] = nn.Parameter(p.detach().to(dtype), requires_grad=False)
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


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(x.dtype)
    return (x * mask).sum() / mask.sum().clamp_min(1.0)


def whiten(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Masked zero-mean, unit-variance normalisation; the ``eps`` keeps a
    constant (or fully masked) batch finite."""
    mean = masked_mean(x, mask)
    var = masked_mean((x - mean) ** 2, mask)
    return (x - mean) * torch.rsqrt(var + eps)


def logprobs_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log-prob of ``labels`` under ``logits`` (log-softmax, then gather)."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, labels.long()[..., None])[..., 0]


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


class RunningMoments:
    """Running mean/std of reward scalars across rollout chunks: host
    floats updated per chunk with the parallel variance combination
    (Bessel-corrected std), as the JAX package's single-host path."""

    def __init__(self):
        self.mean = 0.0
        self.std = 1.0
        self.var = 1.0
        self.count = 1e-24

    def update(self, xs: np.ndarray) -> Tuple[float, float]:
        """Update from a batch; returns (batch_mean, batch_std)."""
        xs = np.asarray(xs, dtype=np.float64)
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
