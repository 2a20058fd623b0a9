"""Carry the JAX package's policy params across to the port.

:func:`flax_to_torch` takes the flax param tree of
``CausalLMWithValueHead``, ``T5WithValueHead`` or ``CausalLMWithILQLHeads``
(or a sub-tree of one) as a nested dict of numpy
arrays (the caller does the ``np.asarray``; nothing here imports JAX) and
returns the port's state dict. Flax names map one to one:

- ``transformer/h_0/attn/c_attn/kernel`` -> ``transformer.h.0.attn.c_attn.weight``
  (flax ``Dense`` kernels are [in, out]; ``nn.Linear`` weights are
  [out, in], so kernels are transposed);
- ``.../ln_1/scale`` -> ``.../ln_1.weight``; ``.../bias`` -> ``.bias``;
- ``transformer/wte/embedding`` -> ``transformer.wte.weight``;
- GPT-J: ``transformer/h_0/attn/q_proj/kernel`` ->
  ``transformer.h.0.attn.q_proj.weight`` (likewise ``k_proj``, ``v_proj``,
  ``out_proj``, ``mlp/fc_in``, ``mlp/fc_out``), and the untied head
  ``transformer/lm_head/{kernel,bias}`` -> ``transformer.lm_head.{weight,bias}``;
- GPT-Neo: ``transformer/h_0/attn/q_proj/kernel`` ->
  ``transformer.h.0.attn.q_proj.weight`` (likewise ``k_proj``, ``v_proj``,
  and ``out_proj`` with its bias; ``mlp/c_fc``, ``mlp/c_proj`` as GPT-2's),
  ``transformer/wpe/embedding`` -> ``transformer.wpe.weight``; the head is
  tied to ``wte``;
- GPT-NeoX: ``transformer/h_0/attn/query_key_value/kernel`` ->
  ``transformer.h.0.attn.query_key_value.weight`` (its head-major [H, 3 Dh]
  output layout kept; likewise ``attn/dense``, ``mlp/dense_h_to_4h``,
  ``mlp/dense_4h_to_h``), ``transformer/h_0/ln_2/scale`` ->
  ``transformer.h.0.ln_2.weight``, ``transformer/ln_f/scale`` ->
  ``transformer.ln_f.weight``, and the bias-free untied head
  ``transformer/lm_head/kernel`` -> ``transformer.lm_head.weight``;
- gpt2_moe: ``transformer/h_1/mlp/router`` -> ``transformer.h.1.mlp.router``
  (likewise ``wi``, ``bi``, ``wo``, ``bo``: stacked expert tensors, kept in
  the flax layout, not transposed);
- ``v_head/fc1/kernel`` -> ``v_head.fc1.weight``;
- ILQL: ``heads/q1_head/fc2/kernel`` -> ``heads.q1_head.fc2.weight`` (the
  ``CausalLMWithILQLHeads`` tree), and the JAX ILQL trainer's
  ``target_q_params`` tree ``q1_head/fc1/kernel`` -> ``q1_head.fc1.weight``
  (the target :class:`~trlx_tpu_torch.models.heads.ILQLHeads`);
- T5: ``t5/enc_0/SelfAttention/q/kernel`` -> ``t5.enc.0.SelfAttention.q.weight``
  (``enc_<i>``/``dec_<i>`` are module lists), ``t5/dec_0/ln_self/weight``
  -> ``t5.dec.0.ln_self.weight`` (``T5LayerNorm``'s leaf is ``weight``),
  ``t5/shared/embedding`` -> ``t5.shared.weight``,
  ``t5/enc_rel_bias/relative_attention_bias/embedding`` ->
  ``t5.enc_rel_bias.relative_attention_bias.weight``, ``t5/lm_head/kernel``
  -> ``t5.lm_head.weight``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "weight": "weight", "bias": "bias",
         # gpt2_moe's switch MLP: raw parameters in the flax layout
         "router": "router", "wi": "wi", "bi": "bi", "wo": "wo", "bo": "bo"}


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def torch_name(path: Tuple[str, ...]) -> str:
    """Flax path -> port parameter name."""
    *mods, leaf = path
    if leaf not in _LEAF:
        raise ValueError(f"unexpected flax param leaf {'/'.join(path)!r}")
    mods = [re.sub(r"^(h|enc|dec)_(\d+)$", r"\1.\2", m) for m in mods]
    return ".".join(mods + [_LEAF[leaf]])


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax names) -> the port's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _walk(params):
        arr = np.asarray(value)
        if path[-1] == "kernel":
            arr = arr.T
        out[torch_name(path)] = torch.from_numpy(np.array(arr, order="C"))  # own copy
    return out


def flax_path(name: str, leaf: str) -> str:
    """Port parameter name -> "/"-joined flax path, the inverse of
    :func:`torch_name` given the flax ``leaf`` (``kernel``, ``scale``,
    ``embedding``, ... ): ``transformer.h.0.attn.c_attn.weight`` with
    ``kernel`` -> ``transformer/h_0/attn/c_attn/kernel``."""
    parts, out = name.split(".")[:-1], []
    i = 0
    while i < len(parts):
        if parts[i] in ("h", "enc", "dec") and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return "/".join(out + [leaf])


def flax_paths(module: torch.nn.Module) -> Dict[str, Tuple[str, bool]]:
    """``{port parameter name: (flax path, transposed)}`` for every
    parameter of ``module``: a ``Linear``'s weight is a flax ``kernel``
    (stored transposed), an ``Embedding``'s an ``embedding``, a
    ``LayerNorm``'s a ``scale``; any other leaf keeps its name."""
    out: Dict[str, Tuple[str, bool]] = {}
    for mod_name, mod in module.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            leaf, transposed = pname, False
            if pname == "weight":
                if isinstance(mod, torch.nn.Linear):
                    leaf, transposed = "kernel", True
                elif isinstance(mod, torch.nn.Embedding):
                    leaf = "embedding"
                elif isinstance(mod, torch.nn.LayerNorm):
                    leaf = "scale"
            out.setdefault(name, (flax_path(name, leaf), transposed))
    return out
