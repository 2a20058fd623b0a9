"""Small helpers shared across the port: the clock, device resolution,
seeding, masked statistics and running reward moments (the port's own
copies of :func:`trlx_tpu.utils.set_seed` / ``infinite_loader`` and of
``whiten``, ``logprobs_from_logits`` and ``RunningMoments`` from
:mod:`trlx_tpu.parallel.collectives`)."""

from __future__ import annotations

import random
import time
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

#: the port's monotonic clock (seconds) for every host-side duration
monotonic: Callable[[], float] = time.monotonic


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
