"""Pipelines and rollout stores (counterpart of :mod:`trlx_tpu.pipeline`):
the pipeline registry. A pipeline is a host-side container that yields
fixed-shape batches — padding happens once, at construction."""

from __future__ import annotations

import sys
from typing import Dict

_DATAPIPELINES: Dict[str, type] = {}


def register_datapipeline(name=None):
    """Decorator registering a pipeline class under its (lowercase) name."""

    def register_class(cls, key: str):
        _DATAPIPELINES[key] = cls
        setattr(sys.modules[__name__], key, cls)
        return cls

    if isinstance(name, type):
        return register_class(name, name.__name__.lower())

    def wrap(cls):
        return register_class(cls, (name or cls.__name__).lower())

    return wrap


def get_datapipeline(name: str) -> type:
    key = name.lower()
    if key not in _DATAPIPELINES:
        import trlx_tpu_torch.pipeline.prompt_pipeline  # noqa: F401
    if key in _DATAPIPELINES:
        return _DATAPIPELINES[key]
    raise ValueError(
        f"Unknown pipeline: {name!r}. Registered: {sorted(_DATAPIPELINES)}"
    )
