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
         "weight": "weight", "bias": "bias"}


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
