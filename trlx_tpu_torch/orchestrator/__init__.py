"""Orchestrators: experience collection (counterpart of
:mod:`trlx_tpu.orchestrator`): the orchestrator registry (PPO's online
and ILQL's offline orchestrator register on first lookup)."""

from __future__ import annotations

import sys
from typing import Dict

_ORCHESTRATORS: Dict[str, type] = {}


def register_orchestrator(name=None):
    """Decorator registering an orchestrator class under its (lowercase)
    name."""

    def register_class(cls, key: str):
        _ORCHESTRATORS[key] = cls
        setattr(sys.modules[__name__], key, cls)
        return cls

    if isinstance(name, type):
        return register_class(name, name.__name__.lower())

    def wrap(cls):
        return register_class(cls, (name or cls.__name__).lower())

    return wrap


def get_orchestrator(name: str) -> type:
    key = name.lower()
    if key not in _ORCHESTRATORS:
        import trlx_tpu_torch.orchestrator.offline_orchestrator  # noqa: F401
        import trlx_tpu_torch.orchestrator.ppo_orchestrator  # noqa: F401
    if key in _ORCHESTRATORS:
        return _ORCHESTRATORS[key]
    raise ValueError(
        f"Unknown orchestrator: {name!r}. Registered: {sorted(_ORCHESTRATORS)}"
    )
