"""Shared trainer machinery: layer freezing and the optimizer (counterpart
of :mod:`trlx_tpu.trainer.common`: ``unfrozen_param_mask``,
``stochastic_round``, ``scale_by_adam_low_precision`` and
``make_optimizer``).

There is no ``TrainState``: the module's parameters and the optimizer's
state are the state. Freezing is ``requires_grad=False``; frozen
parameters take no part in the optimizer (no moments, no update, no
weight decay) nor in the clip's global norm, as under the JAX package's
``optax.masked`` with stopped gradients.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn


def freeze_layers(model: nn.Module, num_layers_unfrozen: int, n_layer: int,
                  zero_freezes_all: bool = False) -> None:
    """``num_layers_unfrozen`` as the JAX package's ``unfrozen_param_mask``
    reads it. The PPO path: ``k <= 0`` trains every parameter; ``k > 0``
    trains only the top ``k`` blocks, the final layer norm and the heads
    (the embeddings below the branch point freeze too). ILQL's
    (``zero_freezes_all``): a negative ``k`` trains everything, ``0``
    freezes every block, ``k > 0`` the bottom ``n_layer - k``, and both
    freeze ``wte`` and ``wpe``."""
    if num_layers_unfrozen > n_layer:
        raise ValueError(
            f"model.num_layers_unfrozen={num_layers_unfrozen} exceeds "
            f"n_layer={n_layer}"
        )
    if num_layers_unfrozen < 0 or (num_layers_unfrozen == 0 and not zero_freezes_all):
        model.requires_grad_(True)
        return
    first_trainable = n_layer - num_layers_unfrozen
    for name, p in model.named_parameters():
        m = re.search(r"(?:^|\.)h\.(\d+)\.", name)
        if m:
            p.requires_grad_(int(m.group(1)) >= first_trainable)
        elif re.search(r"(?:^|\.)(wte|wpe)\.", name):
            p.requires_grad_(first_trainable == 0 and not zero_freezes_all)
        else:
            p.requires_grad_(True)


def cosine_lr(count: int, lr_init: float, lr_target: float, total_steps: int) -> float:
    """``optax.cosine_decay_schedule(lr_init, max(total_steps, 1), alpha=
    lr_target / lr_init)`` at ``count`` (the number of updates before this
    one); the schedule holds ``lr_target`` after ``total_steps``."""
    decay_steps = max(total_steps, 1)
    alpha = lr_target / lr_init if lr_init else 1.0
    t = min(count, decay_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
    return lr_init * ((1.0 - alpha) * cosine + alpha)


class ClippedAdamW:
    """Global-norm gradient clip, then AdamW under the cosine schedule:
    the JAX package's ``chain(clip_by_global_norm, adamw)``.

    - The clip is optax's: when the norm reaches ``grad_clip`` every
      gradient becomes ``g / norm * grad_clip`` (no epsilon).
    - AdamW is ``torch.optim.AdamW``, whose update
      ``p * (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps)`` is optax's
      ``adamw`` term for term; they differ only in rounding order.
    - The learning rate of update ``n`` is :func:`cosine_lr` at ``n``.
    - Under a mesh the parameters are this rank's shards, and
      ``grad_sq_sum`` (``(params, grads) -> squared global norm``, the
      trainer's :meth:`~trlx_tpu_torch.parallel.partition.ShardedModule.grad_sq_sum`)
      sums the squares over the mesh, each element once; AdamW then runs
      on the shards.
    """

    grad_sq_sum: Optional[Callable] = None

    def __init__(self, params: Iterable[nn.Parameter], train, total_steps: int):
        self.params: List[nn.Parameter] = [p for p in params if p.requires_grad]
        self.grad_clip = float(train.grad_clip)
        self.lr_init, self.lr_target = float(train.lr_init), float(train.lr_target)
        self.total_steps = int(total_steps)
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params,
            lr=cosine_lr(0, self.lr_init, self.lr_target, self.total_steps),
            betas=tuple(train.opt_betas),
            eps=float(train.opt_eps),
            weight_decay=float(train.weight_decay),
        )

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, update, advance the schedule; returns the gradient's
        global norm before the clip (a device scalar)."""
        held = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in held]
        if self.grad_sq_sum is not None:
            norm = torch.sqrt(self.grad_sq_sum(held, grads))
        else:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        keep = norm < self.grad_clip  # optax scales only when norm >= max
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.grad_clip))
        lr = cosine_lr(self.count, self.lr_init, self.lr_target, self.total_steps)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _check_state_keys(state, ("adamw", "count"))
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def _check_state_keys(state: Dict[str, Any], keys: Tuple[str, ...]) -> None:
    """Refuse an optimizer state of the other ``adam_moment_dtype``'s
    layout in words that ``utils.checkpoint.translate_structure_errors``
    turns into its actionable ``ValueError``."""
    if set(state) != set(keys):
        raise ValueError(
            f"optimizer state structure mismatch: missing key(s) "
            f"{sorted(set(keys) - set(state))}, unexpected key(s) "
            f"{sorted(set(state) - set(keys))}"
        )


#: the literal seed of the moments' rounding noise, folded with the update
#: count: the JAX contract (``key(0x5EED)`` folded with the count), so the
#: rounding is reproducible per update with no RNG state to checkpoint
ROUNDING_SEED = 0x5EED


def _rounded_f32(x32: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``x32`` stochastically rounded, still f32 (its low 16 bits zero, so
    a cast to bf16 is exact); ``noise`` (int32 in [0, 2^16)) is consumed."""
    bits = noise.add_(x32.view(torch.int32)).bitwise_and_(-65536)  # 0xFFFF0000 as int32
    # adding noise to an inf/nan bit pattern would walk into nan space
    return torch.where(torch.isfinite(x32), bits.view(torch.float32), x32)


def _draw_noise(x32: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randint(0, 1 << 16, x32.shape, generator=generator, device=x32.device,
                         dtype=torch.int32)


def stochastic_round(x32: torch.Tensor, dtype: torch.dtype,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """f32 -> ``dtype`` with stochastic rounding (unbiased: E[out] == x),
    as the JAX package's ``stochastic_round``: add uniform noise below the
    kept mantissa bits of the IEEE-754 pattern (``noise & 0xFFFF``), then
    truncate (mask ``0xFFFF0000``). Non-finite inputs cast plainly; max
    finite can round up to inf, as in JAX.

    ``noise`` is int32 (or uint32 bits viewed as int32) of ``x32``'s shape;
    without it the bits are drawn from ``generator`` on ``x32``'s device.
    The int32 two's-complement add gives JAX's wrapping uint32 add bit for
    bit (the only pattern that overflows int32 is a NaN, cast plainly)."""
    if dtype == torch.float32:
        return x32
    if dtype != torch.bfloat16:
        raise ValueError(f"stochastic_round supports bfloat16, got {dtype}")
    x32 = x32.float()
    noise = _draw_noise(x32, generator) if noise is None else noise.to(torch.int32) & 0xFFFF
    return _rounded_f32(x32, noise).to(torch.bfloat16)


#: elements of the flat moments an update step processes at once: bounds
#: its f32 temporaries (~17 B an element, ~285 MB) whatever the model size
CHUNK = 1 << 24


class LowPrecisionAdamW:
    """Global-norm clip, then AdamW with both moments stored in bf16 by
    :func:`stochastic_round` under the cosine schedule: the JAX package's
    ``chain(clip_by_global_norm, scale_by_adam_low_precision,
    add_decayed_weights, scale_by_learning_rate)``.

    Per update ``n`` (counting this one), in f32: ``mu = b1 m + (1 - b1)
    g``, ``nu = b2 v + (1 - b2) g^2``; the step ``(mu / c1) / (sqrt(nu /
    c2) + eps)`` with ``c = 1 - b^n``, from the unrounded moments; ``+
    weight_decay p``; ``x -cosine_lr(n - 1)``. Only the stored moments are
    rounded, with noise from a generator seeded by (``ROUNDING_SEED``,
    ``n``) alone: a resumed run rounds as an uninterrupted one.

    ``mu`` and ``nu`` are one flat bf16 buffer each on the parameters'
    device (4 B per trainable parameter), in parameter order. An update
    walks them in ``CHUNK``-element ranges (mu's noise drawn before nu's
    in each): the f32 math runs on flat temporaries of one range and on
    ``torch._foreach_*`` lists of the parameters' and gradients' slices in
    it, so an update is a few dozen launches a range whatever the number
    of parameters. A parameter without a gradient takes a zero one, as a
    JAX leaf does. ``noise_fn`` (``n -> (mu bits, nu bits)``, int32 of the
    buffers' length) replaces the draws, for tests."""

    def __init__(self, params: Iterable[nn.Parameter], train, total_steps: int):
        self.params: List[nn.Parameter] = [p for p in params if p.requires_grad]
        if not self.params:
            raise ValueError("the optimizer has no trainable parameter")
        self.grad_clip = float(train.grad_clip)
        self.lr_init, self.lr_target = float(train.lr_init), float(train.lr_target)
        self.total_steps = int(total_steps)
        self.b1, self.b2 = (float(b) for b in train.opt_betas)
        self.eps, self.weight_decay = float(train.opt_eps), float(train.weight_decay)
        self.count = 0
        offsets, total = [], 0
        for p in self.params:
            offsets.append(total)
            total += p.numel()
        #: per range [lo, hi) of the flat moments, the (parameter, start,
        #: end) slices it covers
        self.chunks = [(lo, min(lo + CHUNK, total), [
            (i, max(lo, o) - o, min(lo + CHUNK, o + p.numel()) - o)
            for i, (o, p) in enumerate(zip(offsets, self.params))
            if o < lo + CHUNK and o + p.numel() > lo]) for lo in range(0, total, CHUNK)]
        device = self.params[0].device
        self.mu = torch.zeros(total, dtype=torch.bfloat16, device=device)
        self.nu = torch.zeros_like(self.mu)
        self.generator = torch.Generator(device=device)
        self.noise_fn: Optional[Callable[[int], Tuple[torch.Tensor, torch.Tensor]]] = None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, update, advance the schedule; returns the gradient's
        global norm before the clip (a device scalar)."""
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(p, dtype=torch.float32)
                 for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax scales only when norm >= max, as g / norm * max
        keep, one = norm < self.grad_clip, torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, self.grad_clip))
        n = self.count + 1
        if self.noise_fn is not None:
            noise = self.noise_fn(n)
        else:
            self.generator.manual_seed((ROUNDING_SEED << 32) | n)
            noise = None
        c1 = float(1.0 - torch.tensor(self.b1) ** n)  # f32 powers, as JAX's
        c2 = float(1.0 - torch.tensor(self.b2) ** n)
        lr = cosine_lr(self.count, self.lr_init, self.lr_target, self.total_steps)
        flat_p = [p.view(-1) for p in self.params]
        flat_g = [g.reshape(-1) for g in grads]
        for lo, hi, slices in self.chunks:
            ps = [flat_p[i][a:b] for i, a, b in slices]
            gs = [flat_g[i][a:b] for i, a, b in slices]
            sizes = [b - a for _, a, b in slices]
            mu32 = self.mu[lo:hi].float().mul_(self.b1)
            torch._foreach_add_(mu32.split(sizes), gs, alpha=1.0 - self.b1)
            nu32 = self.nu[lo:hi].float().mul_(self.b2)
            torch._foreach_addcmul_(nu32.split(sizes), gs, gs, value=1.0 - self.b2)
            for k, (stored, x32) in enumerate(((self.mu, mu32), (self.nu, nu32))):
                bits = (_draw_noise(x32, self.generator) if noise is None
                        else noise[k][lo:hi].to(x32.device, torch.int32) & 0xFFFF)
                stored[lo:hi].copy_(_rounded_f32(x32, bits))
            update = mu32.div_(c1).div_(nu32.div_(c2).sqrt_().add_(self.eps)).split(sizes)
            torch._foreach_add_(update, ps, alpha=self.weight_decay)
            torch._foreach_add_(ps, update, alpha=-lr)
        self.count = n
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _check_state_keys(state, ("count", "mu", "nu"))
        for key in ("mu", "nu"):
            t = state[key]
            if t.dtype != self.mu.dtype or t.shape != self.mu.shape:
                raise ValueError(
                    f"optimizer state size mismatch: {key} is {t.dtype} "
                    f"{tuple(t.shape)}, this optimizer's {self.mu.dtype} "
                    f"{tuple(self.mu.shape)}"
                )
            getattr(self, key).copy_(t)
        self.count = int(state["count"])


MOMENT_DTYPES = ("float32", "bfloat16")


def make_optimizer(train, total_steps: int, params: Iterable[nn.Parameter]):
    """Clip -> AdamW(cosine ``lr_init`` -> ``lr_target`` over
    ``total_steps``) over the parameters that require grad, its moments
    in ``train.adam_moment_dtype``: :class:`ClippedAdamW` for float32,
    :class:`LowPrecisionAdamW` for bfloat16."""
    # the raw string first: a typo ("bf16") gets the JAX package's message
    if train.adam_moment_dtype not in MOMENT_DTYPES:
        raise ValueError(
            f"train.adam_moment_dtype must be float32 or bfloat16, got "
            f"{train.adam_moment_dtype!r}"
        )
    if train.adam_moment_dtype == "bfloat16":
        return LowPrecisionAdamW(params, train, total_steps)
    return ClippedAdamW(params, train, total_steps)
