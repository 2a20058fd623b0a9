"""Model-family registry: ``model.model_type`` -> architecture kit
(counterpart of :mod:`trlx_tpu.models.registry`; ``gpt2``, and ``t5``
with its alias ``ul2``, the seq2seq family), and :func:`load_arch`, the
architecture and weights a config asks for.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelFamily:
    name: str
    config_cls: type
    backbone_cls: type
    init_cache: Callable  # (config, batch, capacity, device) -> cache
    load_checkpoint: Callable  # (HF checkpoint dir, dtype) -> (config, state dict)
    is_seq2seq: bool = False


_FAMILIES: Dict[str, ModelFamily] = {}

#: the JAX package's other families (and aliases), refused by name
UNPORTED_FAMILIES = ("gptj", "gpt-j", "gpt_neo", "gpt-neo", "gpt_neox", "neox", "gpt-neox",
                     "gpt2_moe", "gpt2-moe")


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
    if key in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"model_type {name!r} is not ported yet (ROADMAP item 13, other families)"
        )
    raise ValueError(
        f"Unknown model_type: {name!r}. Registered: {sorted(_FAMILIES)}"
    )


def hidden_size_of(config: Any) -> int:
    for attr in ("n_embd", "hidden_size", "d_model"):
        if hasattr(config, attr):
            return getattr(config, attr)
    raise ValueError(f"no hidden size on {type(config).__name__}")


def load_arch(family: ModelFamily, model, train) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """(architecture config, backbone state dict or ``None``) for the
    ``model`` and ``train`` config sections. Without ``model.model_path``
    the architecture is ``model.model_arch`` and there are no weights; with
    it the checkpoint's ``config.json`` defines the architecture, its
    weights are converted in ``train.param_dtype``, and ``model_arch``
    contributes only ``dtype`` and ``param_dtype``. Both default to the
    ``train`` section's."""
    arch = dict(model.model_arch)
    arch.setdefault("dtype", train.dtype)
    arch.setdefault("param_dtype", train.param_dtype)
    if not model.model_path:
        return family.config_cls.from_dict(arch), None
    config, state = family.load_checkpoint(model.model_path, dtype=train.param_dtype)
    return dataclasses.replace(
        config, dtype=arch["dtype"], param_dtype=arch["param_dtype"]
    ), state


def _register_builtins() -> None:
    from trlx_tpu_torch.models.conversion import load_gpt2_checkpoint, load_t5_checkpoint
    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, init_cache
    from trlx_tpu_torch.models.t5 import T5Config, T5Model, init_t5_cache

    register_model_family(
        ModelFamily("gpt2", GPT2Config, GPT2Model, init_cache, load_gpt2_checkpoint)
    )
    register_model_family(
        ModelFamily("t5", T5Config, T5Model, init_t5_cache, load_t5_checkpoint,
                    is_seq2seq=True),
        "ul2",
    )
