"""Model-family registry: ``model.model_type`` -> architecture kit
(counterpart of :mod:`trlx_tpu.models.registry`; ``gpt2``, ``gptj`` with
its alias ``gpt-j``, ``gpt_neo`` with its alias ``gpt-neo``, ``gpt_neox``
with its aliases ``neox`` and ``gpt-neox``, ``gpt2_moe`` with its alias
``gpt2-moe`` (switch-MoE GPT-2; ``is_moe``), and ``t5`` with its alias
``ul2``, the seq2seq family), and :func:`load_arch`, the architecture and
weights a config asks for.
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
    init_cache: Callable  # (config, batch, capacity, device, extra_positions) -> cache
    load_checkpoint: Callable  # (HF checkpoint dir, dtype) -> (config, state dict)
    is_seq2seq: bool = False
    is_moe: bool = False  # switch-MoE: router losses join the training loss


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
    from trlx_tpu_torch.models.conversion import (
        load_gpt2_checkpoint,
        load_gpt_neo_checkpoint,
        load_gptj_checkpoint,
        load_neox_checkpoint,
        load_t5_checkpoint,
    )
    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, init_cache
    from trlx_tpu_torch.models.gpt2_moe import GPT2MoEConfig, GPT2MoEModel, no_checkpoint
    from trlx_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel, init_gpt_neo_cache
    from trlx_tpu_torch.models.gptj import GPTJConfig, GPTJModel, init_gptj_cache
    from trlx_tpu_torch.models.neox import NeoXConfig, NeoXModel, init_neox_cache
    from trlx_tpu_torch.models.t5 import T5Config, T5Model, init_t5_cache

    register_model_family(
        ModelFamily("gpt2", GPT2Config, GPT2Model, init_cache, load_gpt2_checkpoint)
    )
    register_model_family(
        ModelFamily("gptj", GPTJConfig, GPTJModel, init_gptj_cache, load_gptj_checkpoint),
        "gpt-j",
    )
    register_model_family(
        ModelFamily("gpt_neo", GPTNeoConfig, GPTNeoModel, init_gpt_neo_cache,
                    load_gpt_neo_checkpoint),
        "gpt-neo",
    )
    register_model_family(
        ModelFamily("gpt_neox", NeoXConfig, NeoXModel, init_neox_cache, load_neox_checkpoint),
        "neox", "gpt-neox",
    )
    register_model_family(
        ModelFamily("gpt2_moe", GPT2MoEConfig, GPT2MoEModel, init_cache, no_checkpoint,
                    is_moe=True),
        "gpt2-moe",
    )
    register_model_family(
        ModelFamily("t5", T5Config, T5Model, init_t5_cache, load_t5_checkpoint,
                    is_seq2seq=True),
        "ul2",
    )
