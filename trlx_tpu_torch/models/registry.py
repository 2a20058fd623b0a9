"""Model-family registry: ``model.model_type`` -> architecture kit
(counterpart of :mod:`trlx_tpu.models.registry`; ``gpt2``, and ``t5``
with its alias ``ul2``, the seq2seq family).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict


@dataclass(frozen=True)
class ModelFamily:
    name: str
    config_cls: type
    backbone_cls: type
    init_cache: Callable  # (config, batch, capacity, device) -> cache
    is_seq2seq: bool = False


_FAMILIES: Dict[str, ModelFamily] = {}


def register_model_family(family: ModelFamily, *aliases: str) -> ModelFamily:
    for key in (family.name, *aliases):
        _FAMILIES[key.lower()] = family
    return family


def get_model_family(name: str) -> ModelFamily:
    key = name.lower()
    if key not in _FAMILIES:
        _register_builtins()
    if key in _FAMILIES:
        return _FAMILIES[key]
    raise ValueError(
        f"Unknown model_type: {name!r}. Registered: {sorted(_FAMILIES)}"
    )


def hidden_size_of(config: Any) -> int:
    for attr in ("n_embd", "hidden_size", "d_model"):
        if hasattr(config, attr):
            return getattr(config, attr)
    raise ValueError(f"no hidden size on {type(config).__name__}")


def _register_builtins() -> None:
    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, init_cache

    from trlx_tpu_torch.models.t5 import T5Config, T5Model, init_t5_cache

    register_model_family(ModelFamily("gpt2", GPT2Config, GPT2Model, init_cache))
    register_model_family(
        ModelFamily("t5", T5Config, T5Model, init_t5_cache, is_seq2seq=True), "ul2"
    )
