"""HF checkpoint directory -> the port's config and state dict (counterpart
of the GPT-2, GPT-J, GPT-Neo, GPT-NeoX and T5 parts of
:mod:`trlx_tpu.models.conversion`).

The JAX package loads through ``transformers``; the port reads the
directory itself, so it needs neither ``transformers`` nor ``safetensors``:

- ``config.json`` with :mod:`json`;
- the weights from ``model.safetensors`` (:func:`read_safetensors`, a
  reader of its own), from ``pytorch_model.bin`` (``torch.load`` with
  ``weights_only=True``), or from a sharded set of either format named by
  its ``*.index.json`` (:func:`read_hf_weights`).

What the maps handle:

- GPT-2: keys come with or without the ``transformer.`` prefix; HF's
  ``Conv1D`` stores [in, out] and the port's ``nn.Linear`` [out, in], so
  the projection weights transpose; the head is tied to ``wte`` (a
  safetensors file leaves ``lm_head.weight`` out), and the causal-mask
  buffers of older checkpoints (``attn.bias``, ``attn.masked_bias``) are
  not weights.
- GPT-J: keys come with or without the ``transformer.`` prefix; HF's
  ``nn.Linear`` is already [out, in], so nothing transposes (the JAX
  converter does, for flax's [in, out] kernels); the head is untied and
  has a bias (``lm_head.weight``, ``lm_head.bias``); the attention's mask
  buffers (``attn.bias``, ``attn.masked_bias``) and the rotary table
  (``embed_positions``) are not weights; a ``config.json`` without
  ``rotary_dim`` rotates the whole head.
- GPT-Neo: keys come with or without the ``transformer.`` prefix; the
  attention's projections sit under ``attn.attention.`` (``q_proj``,
  ``k_proj``, ``v_proj`` bias-free, ``out_proj`` with a bias); HF's
  ``nn.Linear`` is already [out, in], so nothing transposes (the JAX
  converter does, for flax's [in, out] kernels); the head is tied to
  ``wte`` (``lm_head.weight`` is its copy, left out), and the attention's
  mask buffers (``attn.attention.bias``, ``attn.attention.masked_bias``)
  are not weights; ``attention_types`` expands to the per-layer global and
  local types.
- GPT-NeoX: keys come with or without the ``gpt_neox.`` prefix (the head,
  ``embed_out.weight``, has none); HF's ``nn.Linear`` is already [out, in],
  so nothing transposes, and the fused ``query_key_value`` keeps HF's
  head-major [H, 3 Dh] output layout; the head is untied and has no bias;
  the per-layer buffers of older checkpoints (``attention.bias``, the
  causal mask, ``attention.masked_bias`` and
  ``attention.rotary_emb.inv_freq``) are not weights: the projection biases
  are ``attention.query_key_value.bias`` and ``attention.dense.bias``. The
  MLP is 4 x ``hidden_size`` wide, as in the JAX package; a checkpoint
  whose ``intermediate_size`` says otherwise is refused.
- T5/UL2: HF's ``nn.Linear`` is already [out, in], so nothing transposes
  (the JAX converter does, for flax's [in, out] kernels); the embeddings
  are ``shared`` (safetensors leaves the tied ``*.embed_tokens`` copies
  out); the relative position tables live in block 0 of each stack and
  map to ``enc_rel_bias`` / ``dec_rel_bias``; an untied checkpoint (UL2)
  carries ``lm_head.weight``.

Every tensor is cast to the requested dtype (``train.param_dtype`` in the
trainers).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Tuple

import torch

from trlx_tpu_torch.models.gpt2 import GPT2Config, torch_dtype
from trlx_tpu_torch.models.gpt_neo import GPTNeoConfig, expand_attention_types
from trlx_tpu_torch.models.gptj import GPTJConfig
from trlx_tpu_torch.models.neox import NeoXConfig
from trlx_tpu_torch.models.t5 import T5Config

SAFETENSORS_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "BOOL": torch.bool,  # the causal-mask buffers of older GPT-NeoX checkpoints
}

# the weight files of an HF checkpoint directory, in the order HF prefers
# them: (single file, index of a sharded set)
WEIGHT_FILES = (
    ("model.safetensors", "model.safetensors.index.json"),
    ("pytorch_model.bin", "pytorch_model.bin.index.json"),
)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.safetensors`` file: an 8-byte little-endian header length,
    a JSON header (per tensor its dtype, shape and byte offsets into the
    data that follows), then the raw little-endian bytes. Each tensor is
    copied out of the file's buffer."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        data = fh.read()
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(
                f"{path}: tensor {name!r} has dtype {info['dtype']}; the reader "
                f"supports {sorted(SAFETENSORS_DTYPES)}"
            )
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        shape = [int(s) for s in info["shape"]]
        start, end = info["data_offsets"]
        numel = 1
        for s in shape:
            numel *= s
        if end - start != numel * dtype.itemsize or end > len(data):
            raise ValueError(
                f"{path}: tensor {name!r} spans bytes [{start}, {end}) of "
                f"{len(data)}, which does not hold {shape} {info['dtype']}"
            )
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            # a bytearray of its own: the tensor owns aligned memory
            out[name] = torch.frombuffer(bytearray(data[start:end]), dtype=dtype).reshape(shape)
    return out


def _read_weight_file(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def read_hf_weights(model_path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the checkpoint directory ``model_path``, by HF name,
    on the CPU: ``model.safetensors``, its sharded index, then
    ``pytorch_model.bin`` and its sharded index, the first found."""
    for single, index in WEIGHT_FILES:
        path = os.path.join(model_path, single)
        if os.path.exists(path):
            return _read_weight_file(path)
        path = os.path.join(model_path, index)
        if os.path.exists(path):
            with open(path) as fh:
                weight_map = json.load(fh)["weight_map"]
            out: Dict[str, torch.Tensor] = {}
            for shard in sorted(set(weight_map.values())):
                out.update(_read_weight_file(os.path.join(model_path, shard)))
            missing = sorted(set(weight_map) - set(out))
            if missing:
                raise ValueError(f"{path} names tensors no shard holds: {missing[:5]}")
            return out
    raise FileNotFoundError(
        f"no weights under {model_path!r}: expected one of "
        f"{[name for pair in WEIGHT_FILES for name in pair]}"
    )


def _hf_config(model_path: str) -> Dict[str, Any]:
    with open(os.path.join(model_path, "config.json")) as fh:
        return json.load(fh)


def gpt2_config_from_hf(model_path: str) -> GPT2Config:
    """The ``config.json`` of an HF GPT-2 checkpoint directory ->
    :class:`GPT2Config`."""
    d = _hf_config(model_path)
    return GPT2Config(
        vocab_size=d["vocab_size"],
        n_positions=d.get("n_positions", 1024),
        n_embd=d["n_embd"],
        n_layer=d["n_layer"],
        n_head=d["n_head"],
        layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-5),
    )


# HF Conv1D layers: their [in, out] weights transpose into nn.Linear's
_CONV1D = ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")


def convert_gpt2_state_dict(
    state_dict: Mapping[str, torch.Tensor], config: GPT2Config, dtype="float32"
) -> Dict[str, torch.Tensor]:
    """HF ``GPT2LMHeadModel`` (or ``GPT2Model``) state dict -> the state
    dict of :class:`~trlx_tpu_torch.models.gpt2.GPT2Model`."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}
    transposed = {f"h.{i}.{mod}.weight" for i in range(config.n_layer) for mod in _CONV1D}
    names = ["wte.weight", "wpe.weight", "ln_f.weight", "ln_f.bias"] + [
        f"h.{i}.{mod}.{leaf}"
        for i in range(config.n_layer)
        for mod in ("ln_1", "ln_2", *_CONV1D)
        for leaf in ("weight", "bias")
    ]
    missing = [n for n in names if n not in sd]
    if missing:
        raise KeyError(f"GPT-2 checkpoint lacks {missing[:5]}")
    dt = torch_dtype(dtype)
    return {
        n: (sd[n].t() if n in transposed else sd[n]).to(dt).contiguous() for n in names
    }


def gptj_config_from_hf(model_path: str) -> GPTJConfig:
    """The ``config.json`` of an HF GPT-J checkpoint directory ->
    :class:`GPTJConfig`. The MLP is 4 x ``n_embd`` wide, as in the JAX
    package; a checkpoint whose ``n_inner`` says otherwise is refused."""
    d = _hf_config(model_path)
    if d.get("n_inner") not in (None, 4 * d["n_embd"]):
        raise ValueError(
            f"{model_path}: n_inner={d['n_inner']}; the GPT-J MLP is built "
            f"4 x n_embd = {4 * d['n_embd']} wide"
        )
    return GPTJConfig(
        vocab_size=d["vocab_size"],
        n_positions=d.get("n_positions", 2048),
        n_embd=d["n_embd"],
        n_layer=d["n_layer"],
        n_head=d["n_head"],
        rotary_dim=d.get("rotary_dim") or (d["n_embd"] // d["n_head"]),
        layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-5),
    )


def convert_gptj_state_dict(
    state_dict: Mapping[str, torch.Tensor], config: GPTJConfig, dtype="float32"
) -> Dict[str, torch.Tensor]:
    """HF ``GPTJForCausalLM`` state dict -> the state dict of
    :class:`~trlx_tpu_torch.models.gptj.GPTJModel` (no transposes: both
    sides store [out, in]; the untied head keeps its bias)."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}
    names = ["wte.weight", "ln_f.weight", "ln_f.bias", "lm_head.weight", "lm_head.bias"] + [
        f"h.{i}.{leaf}"
        for i in range(config.n_layer)
        for leaf in ("ln_1.weight", "ln_1.bias",
                     *(f"attn.{p}_proj.weight" for p in ("q", "k", "v", "out")),
                     "mlp.fc_in.weight", "mlp.fc_in.bias",
                     "mlp.fc_out.weight", "mlp.fc_out.bias")
    ]
    missing = [n for n in names if n not in sd]
    if missing:
        raise KeyError(f"GPT-J checkpoint lacks {missing[:5]}")
    dt = torch_dtype(dtype)
    return {n: sd[n].to(dt).contiguous() for n in names}


def gpt_neo_config_from_hf(model_path: str) -> GPTNeoConfig:
    """The ``config.json`` of an HF GPT-Neo checkpoint directory ->
    :class:`GPTNeoConfig`, the fields the JAX package's reads."""
    d = _hf_config(model_path)
    return GPTNeoConfig(
        vocab_size=d["vocab_size"],
        max_position_embeddings=d.get("max_position_embeddings", 2048),
        hidden_size=d["hidden_size"],
        num_layers=d["num_layers"],
        num_heads=d["num_heads"],
        intermediate_size=d.get("intermediate_size"),
        window_size=d.get("window_size", 256),
        attention_layers=expand_attention_types(
            d.get("attention_types") or [], d["num_layers"]
        ),
        layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-5),
    )


def convert_gpt_neo_state_dict(
    state_dict: Mapping[str, torch.Tensor], config: GPTNeoConfig, dtype="float32"
) -> Dict[str, torch.Tensor]:
    """HF ``GPTNeoForCausalLM`` state dict -> the state dict of
    :class:`~trlx_tpu_torch.models.gpt_neo.GPTNeoModel` (no transposes: both
    sides store [out, in]; the tied ``lm_head.weight`` and the mask buffers
    are left out)."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}
    names = {n: n for n in ("wte.weight", "wpe.weight", "ln_f.weight", "ln_f.bias")}
    for i in range(config.num_layers):
        for leaf in ("ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias",
                     "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight",
                     "mlp.c_proj.bias"):
            names[f"h.{i}.{leaf}"] = f"h.{i}.{leaf}"
        for leaf in ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                     "out_proj.weight", "out_proj.bias"):
            names[f"h.{i}.attn.{leaf}"] = f"h.{i}.attn.attention.{leaf}"
    missing = [hf for hf in names.values() if hf not in sd]
    if missing:
        raise KeyError(f"GPT-Neo checkpoint lacks {missing[:5]}")
    dt = torch_dtype(dtype)
    return {port: sd[hf].to(dt).contiguous() for port, hf in names.items()}


def neox_config_from_hf(model_path: str) -> NeoXConfig:
    """The ``config.json`` of an HF GPT-NeoX checkpoint directory ->
    :class:`NeoXConfig`. The MLP is 4 x ``hidden_size`` wide, as in the JAX
    package (whose model ignores ``intermediate_size``); a checkpoint whose
    ``intermediate_size`` says otherwise is refused."""
    d = _hf_config(model_path)
    if d.get("intermediate_size") not in (None, 4 * d["hidden_size"]):
        raise ValueError(
            f"{model_path}: intermediate_size={d['intermediate_size']}; the "
            f"GPT-NeoX MLP is built 4 x hidden_size = {4 * d['hidden_size']} wide"
        )
    return NeoXConfig(
        vocab_size=d["vocab_size"],
        max_position_embeddings=d.get("max_position_embeddings", 2048),
        hidden_size=d["hidden_size"],
        num_hidden_layers=d["num_hidden_layers"],
        num_attention_heads=d["num_attention_heads"],
        rotary_pct=d.get("rotary_pct", 0.25),
        rotary_emb_base=d.get("rotary_emb_base", 10000.0),
        use_parallel_residual=d.get("use_parallel_residual", True),
        layer_norm_eps=d.get("layer_norm_eps", 1e-5),
    )


# port name -> HF name within a GPT-NeoX layer (both sides [out, in])
_NEOX_LAYER = {
    "ln_1": "input_layernorm",
    "ln_2": "post_attention_layernorm",
    "attn.query_key_value": "attention.query_key_value",
    "attn.dense": "attention.dense",
    "mlp.dense_h_to_4h": "mlp.dense_h_to_4h",
    "mlp.dense_4h_to_h": "mlp.dense_4h_to_h",
}


def convert_neox_state_dict(
    state_dict: Mapping[str, torch.Tensor], config: NeoXConfig, dtype="float32"
) -> Dict[str, torch.Tensor]:
    """HF ``GPTNeoXForCausalLM`` state dict -> the state dict of
    :class:`~trlx_tpu_torch.models.neox.NeoXModel` (no transposes; the
    untied head has no bias; the attention buffers are left out)."""
    sd = {k.removeprefix("gpt_neox."): v for k, v in state_dict.items()}
    names = {  # port name -> HF name
        "wte.weight": "embed_in.weight",
        "ln_f.weight": "final_layer_norm.weight",
        "ln_f.bias": "final_layer_norm.bias",
        "lm_head.weight": "embed_out.weight",
    }
    for i in range(config.num_hidden_layers):
        for port, hf in _NEOX_LAYER.items():
            for leaf in ("weight", "bias"):
                names[f"h.{i}.{port}.{leaf}"] = f"layers.{i}.{hf}.{leaf}"
    missing = [hf for hf in names.values() if hf not in sd]
    if missing:
        raise KeyError(f"GPT-NeoX checkpoint lacks {missing[:5]}")
    dt = torch_dtype(dtype)
    return {port: sd[hf].to(dt).contiguous() for port, hf in names.items()}


def t5_config_from_hf(model_path: str) -> T5Config:
    """The ``config.json`` of an HF T5/UL2 checkpoint directory ->
    :class:`T5Config`."""
    d = _hf_config(model_path)
    return T5Config(
        vocab_size=d["vocab_size"],
        d_model=d["d_model"],
        d_kv=d["d_kv"],
        d_ff=d["d_ff"],
        num_layers=d["num_layers"],
        num_decoder_layers=d.get("num_decoder_layers") or d["num_layers"],
        num_heads=d["num_heads"],
        relative_attention_num_buckets=d.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=d.get("relative_attention_max_distance", 128),
        layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-6),
        feed_forward_proj=d.get("feed_forward_proj", "relu"),
        tie_word_embeddings=d.get("tie_word_embeddings", True),
        decoder_start_token_id=d.get("decoder_start_token_id", 0) or 0,
    )


def convert_t5_state_dict(
    state_dict: Mapping[str, torch.Tensor], config: T5Config, dtype="float32"
) -> Dict[str, torch.Tensor]:
    """HF ``T5ForConditionalGeneration`` state dict -> the state dict of
    :class:`~trlx_tpu_torch.models.t5.T5Model` (no transposes: both sides
    store [out, in])."""
    ff = ("wi_0", "wi_1", "wo") if config.is_gated_act else ("wi", "wo")
    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    names = {  # port name -> HF name
        "shared.weight": "shared.weight",
        "enc_rel_bias.relative_attention_bias.weight": f"encoder.{rel}",
        "dec_rel_bias.relative_attention_bias.weight": f"decoder.{rel}",
        "enc_final_ln.weight": "encoder.final_layer_norm.weight",
        "dec_final_ln.weight": "decoder.final_layer_norm.weight",
    }
    if not config.tie_word_embeddings:
        names["lm_head.weight"] = "lm_head.weight"

    def block(port: str, hf: str, layers) -> None:
        for j, (ln, attn) in enumerate(layers):
            names[f"{port}.{ln}.weight"] = f"{hf}.layer.{j}.layer_norm.weight"
            for w in (("q", "k", "v", "o") if attn != "DenseReluDense" else ff):
                names[f"{port}.{attn}.{w}.weight"] = f"{hf}.layer.{j}.{attn}.{w}.weight"

    for i in range(config.num_layers):
        block(f"enc.{i}", f"encoder.block.{i}",
              (("ln_self", "SelfAttention"), ("ln_ff", "DenseReluDense")))
    for i in range(config.num_decoder_layers):
        block(f"dec.{i}", f"decoder.block.{i}",
              (("ln_self", "SelfAttention"), ("ln_cross", "EncDecAttention"),
               ("ln_ff", "DenseReluDense")))
    missing = [hf for hf in names.values() if hf not in state_dict]
    if missing:
        raise KeyError(f"T5 checkpoint lacks {missing[:5]}")
    dt = torch_dtype(dtype)
    return {port: state_dict[hf].to(dt).contiguous() for port, hf in names.items()}


def load_gpt2_checkpoint(
    model_path: str, dtype="float32"
) -> Tuple[GPT2Config, Dict[str, torch.Tensor]]:
    """An HF GPT-2 checkpoint directory -> (:class:`GPT2Config`, the
    backbone's state dict in ``dtype``, on the CPU)."""
    config = gpt2_config_from_hf(model_path)
    return config, convert_gpt2_state_dict(read_hf_weights(model_path), config, dtype)


def load_gptj_checkpoint(
    model_path: str, dtype="float32"
) -> Tuple[GPTJConfig, Dict[str, torch.Tensor]]:
    """An HF GPT-J checkpoint directory -> (:class:`GPTJConfig`, the
    backbone's state dict in ``dtype``, on the CPU)."""
    config = gptj_config_from_hf(model_path)
    return config, convert_gptj_state_dict(read_hf_weights(model_path), config, dtype)


def load_gpt_neo_checkpoint(
    model_path: str, dtype="float32"
) -> Tuple[GPTNeoConfig, Dict[str, torch.Tensor]]:
    """An HF GPT-Neo checkpoint directory -> (:class:`GPTNeoConfig`, the
    backbone's state dict in ``dtype``, on the CPU)."""
    config = gpt_neo_config_from_hf(model_path)
    return config, convert_gpt_neo_state_dict(read_hf_weights(model_path), config, dtype)


def load_neox_checkpoint(
    model_path: str, dtype="float32"
) -> Tuple[NeoXConfig, Dict[str, torch.Tensor]]:
    """An HF GPT-NeoX checkpoint directory -> (:class:`NeoXConfig`, the
    backbone's state dict in ``dtype``, on the CPU)."""
    config = neox_config_from_hf(model_path)
    return config, convert_neox_state_dict(read_hf_weights(model_path), config, dtype)


def load_t5_checkpoint(
    model_path: str, dtype="float32"
) -> Tuple[T5Config, Dict[str, torch.Tensor]]:
    """An HF T5/UL2 checkpoint directory -> (:class:`T5Config`, the
    backbone's state dict in ``dtype``, on the CPU)."""
    config = t5_config_from_hf(model_path)
    return config, convert_t5_state_dict(read_hf_weights(model_path), config, dtype)
