"""Method-config registry: string name -> RL-method config class
(counterpart of :mod:`trlx_tpu.data.method_configs`).

The JAX package registers ``PPOConfig`` from its PPO math module; the port
keeps the pure-data dataclass here (the PPO math comes with the training
slice), so parsing a config imports no model or math code.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, Optional

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
