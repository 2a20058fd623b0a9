"""The port's fixed-batch sampler against the JAX package's ``make_sampler``
on the same weights and prompts.

Tiny f32 GPT-2 with a value head; prompts left-padded from a numpy seed.
Greedy decoding, and sampling with the port handed the JAX sampler's own
Gumbel draws (``jax.random.categorical`` is argmax(logits + gumbel(key))
with ``rng, key = split(rng)`` per step), must give exactly the same
tokens and masks; behaviour logprobs and values agree to 1e-5 (f32, the
two frameworks sum in another order). A short ``max_length`` finishes
every row early, so the segmented decode takes its early exit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models.gpt2 import GPT2Config as JGPT2Config
from trlx_tpu.models.gpt2 import init_cache as jinit_cache
from trlx_tpu.models.heads import CausalLMWithValueHead as JPolicy
from trlx_tpu.ops import sampling as js
from trlx_tpu_torch.models.convert import flax_to_torch
from trlx_tpu_torch.models.gpt2 import GPT2Config as TGPT2Config
from trlx_tpu_torch.models.gpt2 import init_cache as tinit_cache
from trlx_tpu_torch.models.heads import CausalLMWithValueHead as TPolicy
from trlx_tpu_torch.ops import sampling as ts

ARCH = dict(vocab_size=24, n_positions=40, n_embd=32, n_layer=2, n_head=2,
            dtype="float32", param_dtype="float32")
B, Q = 4, 7
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jmodel = JPolicy(JGPT2Config(**ARCH))
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.normal(size=a.shape).astype(np.float32), params
    )
    tmodel = TPolicy(TGPT2Config(**ARCH), device="cpu")
    tmodel.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


def _prompts():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 20, size=(B, Q)).astype(np.int32)
    lens = np.array([Q, 3, 1, 5])
    mask = (np.arange(Q)[None] >= Q - lens[:, None]).astype(np.int32)
    return ids * mask, mask


CASES = {
    "greedy": dict(do_sample=False, max_new_tokens=8),
    "greedy_min_new": dict(do_sample=False, max_new_tokens=8, min_new_tokens=5),
    "sample_top_k": dict(do_sample=True, max_new_tokens=8, top_k=6, temperature=0.8),
    # every row hits the 9-token total cap by step 8: the last segment of
    # 4 steps is skipped without a forward
    "early_exit": dict(do_sample=True, max_new_tokens=12, max_length=9,
                       decode_segment_size=4),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fixed_sampler_matches_jax(models, name):
    jmodel, params, tmodel = models
    kw = dict(CASES[name], eos_token_id=3, pad_token_id=23)
    jcfg, tcfg = js.GenerationConfig.from_dict(kw), ts.GenerationConfig.from_dict(kw)
    R = jcfg.max_new_tokens
    ids, mask = _prompts()

    def apply_fn(p, input_ids, attention_mask=None, position_ids=None,
                 cache=None, cache_index=None, last_only=False):
        return jmodel.apply({"params": p}, input_ids, attention_mask=attention_mask,
                            position_ids=position_ids, cache=cache,
                            cache_index=cache_index, last_only=last_only)

    jsampler = js.make_sampler(apply_fn, functools.partial(jinit_cache, JGPT2Config(**ARCH)),
                               jcfg, Q)
    rng = jax.random.PRNGKey(7)
    jout = jax.jit(jsampler)(params, jnp.asarray(ids), jnp.asarray(mask), rng)

    keys, r = [], rng
    for _ in range(R):
        r, k = jax.random.split(r)
        keys.append(k)
    noise = [np.array(jax.random.gumbel(k, (B, ARCH["vocab_size"]), jnp.float32)) for k in keys]
    forwards = []

    def counting_model(*a, **k):
        forwards.append(1)
        return tmodel(*a, **k)

    tsampler = ts.make_sampler(
        counting_model, functools.partial(tinit_cache, tmodel.config), tcfg, Q
    )
    tout = tsampler(torch.from_numpy(ids), torch.from_numpy(mask),
                    noise_fn=lambda t: torch.from_numpy(noise[t]))

    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.response_mask.numpy(), np.asarray(jout.response_mask))
    for key in ("logprobs", "values"):
        np.testing.assert_allclose(
            getattr(tout, key).numpy(), np.asarray(getattr(jout, key)), atol=ATOL, rtol=0
        )
    mask_out = tout.response_mask.numpy()
    if name == "early_exit":
        assert not mask_out[:, 8:].any()
        assert len(forwards) == 1 + 8  # prefill + steps 0..7; the rest skipped
    else:
        assert mask_out[:, 0].all()
        assert len(forwards) == R  # prefill + R - 1 decode forwards
    if name == "greedy_min_new":
        assert mask_out[:, :5].all()  # eos held off for 5 tokens


def test_lm_only_matches_jax(models):
    """The backbone forward without the value head."""
    jmodel, params, tmodel = models
    ids, mask = _prompts()
    jout = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                        method=jmodel.lm_only)
    tout = tmodel.lm_only(torch.from_numpy(ids), torch.from_numpy(mask))
    real = mask.astype(bool)
    np.testing.assert_allclose(tout["logits"].detach().numpy()[real],
                               np.asarray(jout["logits"])[real], atol=1e-4, rtol=0)
    assert "values" not in tout


def test_runtime_noise_comes_from_the_generator(models):
    """Without injected noise, sampling draws from the caller's
    generator: the same seed gives the same tokens."""
    _, _, tmodel = models
    cfg = ts.GenerationConfig.from_dict(dict(do_sample=True, max_new_tokens=5,
                                             eos_token_id=3, pad_token_id=23))
    sampler = ts.make_sampler(tmodel, functools.partial(tinit_cache, tmodel.config), cfg, Q)
    ids, mask = (torch.from_numpy(x) for x in _prompts())
    outs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(5)
        outs.append(sampler(ids, mask, generator=gen).tokens)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
