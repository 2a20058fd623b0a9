"""Method-config registry: string name -> RL-method config class
(counterpart of :mod:`trlx_tpu.data.method_configs`).

The JAX package registers ``PPOConfig``, ``GRPOConfig`` and
``ILQLConfig`` from its math and trainer modules; the port keeps the
pure-data dataclasses here, so parsing a config imports no model or math
code.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, Optional, Tuple

# name (lowercase) -> method config class
_METHODS: Dict[str, type] = {}


def register_method(name=None):
    """Decorator registering a method config class under a string key."""

    def register_class(cls, key: str):
        _METHODS[key] = cls
        return cls

    if isinstance(name, type):
        return register_class(name, name.__name__.lower())

    def wrap(cls):
        return register_class(cls, (name or cls.__name__).lower())

    return wrap


def get_method(name: str) -> type:
    """Look up a method config class by its registered (case-insensitive) name."""
    key = name.lower()
    if key in _METHODS:
        return _METHODS[key]
    raise ValueError(
        f"Unknown method config: {name!r}. Registered: {sorted(_METHODS)}"
    )


@dataclass
class MethodConfig:
    """Base config for an RL method.

    :param name: registry key used by YAML `method.name` dispatch.
    """

    name: str = ""

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        known = {f.name for f in fields(cls)}
        unknown = set(config) - known
        if unknown:
            raise ValueError(
                f"Unknown keys for {cls.__name__}: {sorted(unknown)}"
            )
        return cls(**config)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@register_method
@dataclass
class PPOConfig(MethodConfig):
    """PPO hyperparameters; the same fields and defaults as
    ``trlx_tpu.ops.ppo_math.PPOConfig``."""

    name: str = "PPOConfig"
    ppo_epochs: int = 4
    num_rollouts: int = 128
    chunk_size: int = 128
    init_kl_coef: float = 0.2
    target: Optional[float] = 6.0
    horizon: int = 10000
    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    vf_coef: float = 1.0
    ent_coef: float = 0.0
    group_size: int = 1
    scale_reward: Optional[str] = None
    ref_mean: Optional[float] = None
    ref_std: Optional[float] = None
    cliprange_reward: float = 10.0
    gen_kwargs: Dict[str, Any] = field(
        default_factory=lambda: dict(
            max_new_tokens=48, top_k=0, top_p=1.0, do_sample=True
        )
    )


@register_method
@dataclass
class GRPOConfig(PPOConfig):
    """GRPO hyperparameters (``trlx_tpu.trainer.grpo_trainer.GRPOConfig``):
    PPO's, with rollouts sampled in groups of ``group_size`` per prompt and
    no value loss (GAE's ``gamma``/``lam`` are unused)."""

    name: str = "GRPOConfig"
    group_size: int = 8
    vf_coef: float = 0.0


#: ILQL's eval-decode defaults where a config omits ``gen_kwargs``
#: (``trlx_tpu.ops.ilql_math.DEFAULT_ILQL_GEN_KWARGS``).
DEFAULT_ILQL_GEN_KWARGS: Dict[str, Any] = {
    "max_new_tokens": 48,
    "do_sample": True,
    "top_k": 20,
}


@register_method
@dataclass
class ILQLConfig(MethodConfig):
    """ILQL hyperparameters; the same fields and defaults as
    ``trlx_tpu.ops.ilql_math.ILQLConfig``. ``from_dict`` makes ``betas`` a
    tuple and merges ``gen_kwargs`` over the eval-decode defaults (a bare
    ``gen_kwargs:`` line gives the defaults)."""

    name: str = "ILQLConfig"
    tau: float = 0.7
    gamma: float = 0.99
    cql_scale: float = 0.1
    awac_scale: float = 1.0
    alpha: float = 0.005
    steps_for_target_q_sync: int = 5
    betas: Tuple[float, ...] = (4.0,)
    two_qs: bool = True
    gen_kwargs: Dict[str, Any] = field(
        default_factory=lambda: dict(DEFAULT_ILQL_GEN_KWARGS)
    )

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        if "betas" in config:
            config = dict(config, betas=tuple(config["betas"]))
        if "gen_kwargs" in config:
            config = dict(
                config,
                gen_kwargs={**DEFAULT_ILQL_GEN_KWARGS, **(config["gen_kwargs"] or {})},
            )
        return super().from_dict(config)
