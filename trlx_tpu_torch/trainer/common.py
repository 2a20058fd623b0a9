"""Shared trainer machinery: layer freezing and the optimizer (counterpart
of :mod:`trlx_tpu.trainer.common`: ``unfrozen_param_mask`` and
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
from typing import Any, Dict, Iterable, List

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
    """

    def __init__(self, params: Iterable[nn.Parameter], train, total_steps: int):
        if train.adam_moment_dtype != "float32":
            raise NotImplementedError(
                f"train.adam_moment_dtype={train.adam_moment_dtype!r}: the "
                "port keeps Adam moments in float32 (bf16 moments with "
                "stochastic rounding are ROADMAP item 5)"
            )
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
        grads = [p.grad for p in self.params if p.grad is not None]
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
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(train, total_steps: int, params: Iterable[nn.Parameter]) -> ClippedAdamW:
    """Clip -> AdamW(cosine ``lr_init`` -> ``lr_target`` over
    ``total_steps``) over the parameters that require grad."""
    return ClippedAdamW(params, train, total_steps)
