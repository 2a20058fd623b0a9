"""GPT-2 with switch-MoE MLPs (counterpart of
:mod:`trlx_tpu.models.gpt2_moe`), on one device: the dense switch path.

- Every ``moe_every``-th block (blocks ``i % moe_every == moe_every - 1``)
  replaces its MLP with :class:`SwitchMLP`: an f32 router, top-1 by the
  first maximum, and ``n_experts`` tanh-GELU experts that each compute
  every token in the compute dtype; the one-hot × gate select (the gate is
  the chosen expert's probability) sums in f32. The residual stays in the
  block, which is otherwise GPT-2's.
- The JAX package shards the experts over an ``ep`` mesh axis only when
  that axis is larger than one device (``moe_apply``'s ``all_to_all``
  dispatch with a capacity); the port's trainers run this family on one
  rank, so the dense path is the whole family here, and
  ``capacity_factor`` is kept for the config's sake. Expert parallelism
  is ROADMAP item 14.6.
- The load-balancing losses are collected only inside
  :func:`collect_moe_losses` (the training forwards), never in the
  sampler: ``aux_loss = E · Σ f·P`` with ``f`` the argmax fractions (no
  gradient) and ``P`` the mean probabilities, ``router_z =
  mean(logsumexp²)`` and ``max_load = max f``;
  :func:`moe_loss_summary` reduces them over the blocks and
  :func:`apply_router_penalty` adds ``router_aux_coef · aux +
  router_z_coef · z`` to a loss and its stats.
- The attention is GPT-2's, through the flash kernels at head dim 64 on
  a CUDA tensor. There is no HF checkpoint of this family
  (:func:`no_checkpoint`); weights come from ``model_arch`` and a seed.

Parameter names follow the flax tree: ``h.1.mlp.router`` [D, E],
``wi`` [E, D, F], ``bi`` [E, F], ``wo`` [E, F, D], ``bo`` [E, D], in the
JAX layout (no transpose).
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.models.gpt2 import (
    Block,
    GPT2Model,
    _factory,
    torch_dtype,
    validate_kv_cache_dtype,
)


@dataclass(frozen=True)
class GPT2MoEConfig:
    """GPT-2's architecture plus the switch knobs (the JAX package's
    ``GPT2MoEConfig`` fields, and the port's ``kv_cache_dtype``)."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    n_experts: int = 4
    moe_every: int = 2  # blocks moe_every - 1, 2 * moe_every - 1, ... are switch blocks
    capacity_factor: float = 2.0
    router_aux_coef: float = 0.01
    router_z_coef: float = 0.001
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"

    def __post_init__(self):
        validate_kv_cache_dtype(self.kv_cache_dtype)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GPT2MoEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def moe_blocks(self) -> List[bool]:
        return [i % self.moe_every == self.moe_every - 1 for i in range(self.n_layer)]


class SwitchMLP(nn.Module):
    """Top-1 switch MLP: router, ``n_experts`` GELU experts, gate-weighted
    output. ``losses`` is a list while :func:`collect_moe_losses` is open
    (one dict appended per forward), else ``None``."""

    def __init__(self, config: GPT2MoEConfig, device=None):
        super().__init__()
        self.config = config
        D, E = config.n_embd, config.n_experts
        Fw = 4 * D
        fk = _factory(config, device)
        self.router = nn.Parameter(torch.empty(D, E, **fk))
        self.wi = nn.Parameter(torch.empty(E, D, Fw, **fk))
        self.bi = nn.Parameter(torch.empty(E, Fw, **fk))
        self.wo = nn.Parameter(torch.empty(E, Fw, D, **fk))
        self.bo = nn.Parameter(torch.empty(E, D, **fk))
        self.losses: Optional[list] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, D]
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        E = cfg.n_experts
        shape = x.shape
        toks = x.reshape(-1, cfg.n_embd).to(dt)
        # the router in f32: near-tied logits argmax alike in both packages
        logits = toks.float() @ self.router.float()
        probs = torch.softmax(logits, dim=-1)  # [N, E]
        expert = torch.argmax(probs, dim=-1)  # the first maximum, as jnp.argmax
        onehot = F.one_hot(expert, E).float()
        if self.losses is not None:
            frac = onehot.mean(0)  # argmax: no gradient, as the paper prescribes
            self.losses.append({
                "aux_loss": E * torch.sum(frac * probs.mean(0)),
                "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
                "max_load": frac.max(),
            })
        gate = torch.gather(probs, -1, expert[:, None])  # [N, 1]
        h = torch.einsum("nd,edf->enf", toks, self.wi.to(dt))
        h = F.gelu(h + self.bi.to(dt)[:, None], approximate="tanh")
        out_e = torch.einsum("enf,efd->end", h, self.wo.to(dt)) + self.bo.to(dt)[:, None]
        y = torch.einsum("end,ne->nd", out_e.float(), onehot * gate)
        return y.reshape(shape).to(dt)


class MoEBlock(Block):
    """GPT-2's block with the MLP swapped for :class:`SwitchMLP`."""

    def make_mlp(self, config, device=None) -> nn.Module:
        return SwitchMLP(config, device)


class GPT2MoEModel(GPT2Model):
    """GPT-2 trunk with switch MLPs at blocks ``i % moe_every ==
    moe_every - 1``; :class:`~trlx_tpu_torch.models.gpt2.GPT2Model`'s
    interface (embeddings, tied head, caches, hydra branch)."""

    def __init__(self, config: GPT2MoEConfig, device=None, branch_start: Optional[int] = None):
        if not any(config.moe_blocks()):
            raise ValueError(
                f"gpt2_moe with n_layer={config.n_layer}, moe_every={config.moe_every} "
                "has no MoE blocks; lower moe_every or use the dense gpt2 family"
            )
        super().__init__(config, device, branch_start)

    def make_block(self, i: int, device=None) -> nn.Module:
        return (MoEBlock if self.config.moe_blocks()[i] else Block)(self.config, device)


@contextlib.contextmanager
def collect_moe_losses(model: nn.Module) -> Iterator[list]:
    """Collect the router losses of every :class:`SwitchMLP` forward of
    ``model`` inside the block into the yielded list (empty for a model
    without switch layers)."""
    losses: list = []
    layers = [m for m in model.modules() if isinstance(m, SwitchMLP)]
    for m in layers:
        m.losses = losses
    try:
        yield losses
    finally:
        for m in layers:
            m.losses = None


def moe_loss_summary(losses: list) -> Dict[str, torch.Tensor]:
    """The collected losses over the switch blocks: the mean ``aux_loss``
    and ``router_z``, the max ``max_load``."""
    if not losses:
        raise ValueError("no MoE losses were collected: is this an MoE model?")
    return {
        "aux_loss": torch.stack([d["aux_loss"] for d in losses]).mean(),
        "router_z": torch.stack([d["router_z"] for d in losses]).mean(),
        "max_load": torch.stack([d["max_load"] for d in losses]).max(),
    }


def apply_router_penalty(loss, stats: Dict[str, Any], moe: Dict[str, torch.Tensor], cfg):
    """Add the router's load-balancing penalty to a training loss and the
    routing health to its stats (``losses/total_loss`` includes the
    penalty; ``losses/moe_aux``, ``losses/router_z``, ``moe/max_load``)."""
    penalty = cfg.router_aux_coef * moe["aux_loss"] + cfg.router_z_coef * moe["router_z"]
    stats = dict(stats)
    stats["losses/total_loss"] = stats["losses/total_loss"] + penalty.detach()
    stats["losses/moe_aux"] = moe["aux_loss"].detach()
    stats["losses/router_z"] = moe["router_z"].detach()
    stats["moe/max_load"] = moe["max_load"].detach()
    return loss + penalty, stats


def no_checkpoint(path: str, dtype: str = "float32"):
    raise ValueError(
        "gpt2_moe has no HF checkpoint counterpart; train from scratch "
        "(model_arch) or convert a dense GPT-2 and grow experts offline"
    )
