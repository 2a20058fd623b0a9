"""Model-family registry: ``model.model_type`` -> architecture kit
(counterpart of :mod:`trlx_tpu.models.registry`; ``gpt2``, ``gptj`` with
its alias ``gpt-j``, ``gpt_neo`` with its alias ``gpt-neo``, ``gpt_neox``
with its aliases ``neox`` and ``gpt-neox``, ``gpt2_moe`` with its alias
``gpt2-moe`` (switch-MoE GPT-2; ``is_moe``), and ``t5`` with its alias
``ul2``, the seq2seq family), and :func:`load_arch`, the architecture and
weights a config asks for.

Each family carries its ``partition_rules``, copied from the JAX family's
table (``PARTITION_RULES`` in ``trlx_tpu/models/gpt2.py``,
``GPTJ_PARTITION_RULES``, ``NEOX_PARTITION_RULES``,
``GPT_NEO_PARTITION_RULES``, ``GPT2_MOE_PARTITION_RULES``,
``T5_PARTITION_RULES``): ``(regex over the flax path, per-dim mesh axes)``,
read by :mod:`trlx_tpu_torch.parallel.partition`, and ``tp_fused``, the
parameters whose tensor-parallel slice is taken per fused segment (GPT-2's
``c_attn`` [q | k | v]).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

#: the JAX families' partition rules: attention and MLP input projections
#: shard their output dim over tp, output projections their input dim
GPT2_PARTITION_RULES = (
    (r"wte/embedding", (None, "tp")),
    (r"attn/c_attn/kernel", (None, "tp")),
    (r"attn/c_proj/kernel", ("tp", None)),
    (r"mlp/c_fc/kernel", (None, "tp")),
    (r"mlp/c_proj/kernel", ("tp", None)),
)
GPTJ_PARTITION_RULES = (
    (r"wte/embedding", (None, "tp")),
    (r"attn/(q_proj|k_proj|v_proj)/kernel", (None, "tp")),
    (r"attn/out_proj/kernel", ("tp", None)),
    (r"mlp/fc_in/kernel", (None, "tp")),
    (r"mlp/fc_out/kernel", ("tp", None)),
    (r"lm_head/kernel", (None, "tp")),
)
NEOX_PARTITION_RULES = (
    (r"wte/embedding", (None, "tp")),
    (r"attn/query_key_value/kernel", (None, "tp")),
    (r"attn/dense/kernel", ("tp", None)),
    (r"mlp/dense_h_to_4h/kernel", (None, "tp")),
    (r"mlp/dense_4h_to_h/kernel", ("tp", None)),
    (r"lm_head/kernel", (None, "tp")),
)
GPT_NEO_PARTITION_RULES = (
    (r"wte/embedding", (None, "tp")),
    (r"attn/(q_proj|k_proj|v_proj)/kernel", (None, "tp")),
    (r"attn/out_proj/kernel", ("tp", None)),
    (r"mlp/c_fc/kernel", (None, "tp")),
    (r"mlp/c_proj/kernel", ("tp", None)),
)
GPT2_MOE_PARTITION_RULES = GPT2_PARTITION_RULES + (
    (r"mlp/router", (None, None)),
    (r"mlp/wi", ("ep", None, None)),
    (r"mlp/bi", ("ep", None)),
    (r"mlp/wo", ("ep", None, None)),
    (r"mlp/bo", ("ep", None)),
)
T5_PARTITION_RULES = (
    (r"shared/embedding", (None, "tp")),
    (r"(SelfAttention|EncDecAttention)/(q|k|v)/kernel", (None, "tp")),
    (r"(SelfAttention|EncDecAttention)/o/kernel", ("tp", None)),
    (r"DenseReluDense/(wi|wi_0|wi_1)/kernel", (None, "tp")),
    (r"DenseReluDense/wo/kernel", ("tp", None)),
    (r"lm_head/kernel", (None, "tp")),
)


@dataclass(frozen=True)
class ModelFamily:
    name: str
    config_cls: type
    backbone_cls: type
    init_cache: Callable  # (config, batch, capacity, device, extra_positions) -> cache
    load_checkpoint: Callable  # (HF checkpoint dir, dtype) -> (config, state dict)
    is_seq2seq: bool = False
    is_moe: bool = False  # switch-MoE: router losses join the training loss
    partition_rules: Sequence = ()
    #: {port name regex: segments} of fused tp-sharded parameters
    tp_fused: Tuple[Tuple[str, int], ...] = ()


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
        ModelFamily("gpt2", GPT2Config, GPT2Model, init_cache, load_gpt2_checkpoint,
                    partition_rules=GPT2_PARTITION_RULES,
                    tp_fused=((r"attn\.c_attn\.", 3),))
    )
    register_model_family(
        ModelFamily("gptj", GPTJConfig, GPTJModel, init_gptj_cache, load_gptj_checkpoint,
                    partition_rules=GPTJ_PARTITION_RULES),
        "gpt-j",
    )
    register_model_family(
        ModelFamily("gpt_neo", GPTNeoConfig, GPTNeoModel, init_gpt_neo_cache,
                    load_gpt_neo_checkpoint, partition_rules=GPT_NEO_PARTITION_RULES),
        "gpt-neo",
    )
    register_model_family(
        ModelFamily("gpt_neox", NeoXConfig, NeoXModel, init_neox_cache, load_neox_checkpoint,
                    partition_rules=NEOX_PARTITION_RULES),
        "neox", "gpt-neox",
    )
    register_model_family(
        ModelFamily("gpt2_moe", GPT2MoEConfig, GPT2MoEModel, init_cache, no_checkpoint,
                    is_moe=True, partition_rules=GPT2_MOE_PARTITION_RULES,
                    tp_fused=((r"attn\.c_attn\.", 3),)),
        "gpt2-moe",
    )
    register_model_family(
        ModelFamily("t5", T5Config, T5Model, init_t5_cache, load_t5_checkpoint,
                    is_seq2seq=True, partition_rules=T5_PARTITION_RULES),
        "ul2",
    )
