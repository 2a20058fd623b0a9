"""Tiny T5 policies for the port's seq2seq parity tests: the JAX package's
``T5WithValueHead`` and the port's, on the same f32 weights.

The weights come from a numpy seed (the flax init only gives the tree its
shapes) and cross to the port through ``flax_to_torch``. Two
architectures, as the fork's family has them: ReLU with the tied LM head
(T5 1.0) and gated-GELU with an untied head (T5 1.1 / UL2). Both have 2
encoder and 2 decoder layers, ``d_model`` 32, ``d_kv`` 8, 4 heads and 8
relative position buckets.
"""

import jax
import jax.numpy as jnp
import numpy as np

from trlx_tpu.models.heads import T5WithValueHead as JT5WithValueHead
from trlx_tpu.models.t5 import T5Config as JT5Config
from trlx_tpu_torch.models.convert import flax_to_torch
from trlx_tpu_torch.models.heads import T5WithValueHead as TT5WithValueHead
from trlx_tpu_torch.models.t5 import T5Config as TT5Config

VOCAB = 40
ARCHS = {
    "relu_tied": dict(feed_forward_proj="relu", tie_word_embeddings=True),
    "gated_untied": dict(feed_forward_proj="gated-gelu", tie_word_embeddings=False),
}


def arch(name: str) -> dict:
    return dict(
        vocab_size=VOCAB, d_model=32, d_kv=8, d_ff=48, num_layers=2,
        num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=16, decoder_start_token_id=0,
        dtype="float32", param_dtype="float32", **ARCHS[name],
    )


def numpy_params(name: str, seed: int = 0):
    """The flax param tree of ``T5WithValueHead`` with every leaf drawn
    from ``np.random.default_rng(seed)``: layer-norm weights near 1,
    relative position tables N(0, 1), the rest N(0, 0.2)."""
    model = JT5WithValueHead(JT5Config(**arch(name)))
    shapes = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
        decoder_input_ids=jnp.zeros((1, 2), jnp.int32),
    )["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [getattr(p, "key", str(p)) for p in path]
        if keys[-1] == "weight":  # T5LayerNorm
            return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        if "relative_attention_bias" in keys:
            return rng.normal(size=leaf.shape).astype(np.float32)
        return (0.2 * rng.normal(size=leaf.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(name: str, params) -> TT5WithValueHead:
    model = TT5WithValueHead(TT5Config(**arch(name)), device="cpu")
    model.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    return model


def prompts(B: int, S: int, seed: int = 1):
    """[B, S] left-padded int32 prompt ids in [2, VOCAB) and their mask;
    row lengths S, then decreasing."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, size=(B, S)).astype(np.int32)
    lens = np.maximum(S - 2 * np.arange(B), 1)
    mask = (np.arange(S)[None] >= S - lens[:, None]).astype(np.int32)
    return ids * mask, mask
