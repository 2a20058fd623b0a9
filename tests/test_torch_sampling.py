"""The port's token selection against the JAX package's.

``choose_tokens`` must give exactly the same tokens and finished flags
(logprobs to 1e-6, f32) under greedy decoding, and under sampling when the
port is handed the Gumbel noise of the JAX package's per-row
``fold_in(row_key, t)`` lineage (``jax.random.categorical`` is
argmax(logits + gumbel)). ``filter_logits`` (temperature, top-k, top-p)
must keep exactly the same tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import sampling as js
from trlx_tpu_torch.ops import sampling as ts

B, V = 6, 40


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    finished = np.array([False, True, False, False, True, False])
    value = rng.normal(size=(B,)).astype(np.float32)
    n_real = rng.integers(1, 8, size=(B,)).astype(np.int32)
    t = np.array([0, 1, 2, 3, 5, 7], np.int32)
    return logits, finished, value, n_real, t


def _gen_cfg(**kw):
    base = {"eos_token_id": 3, "pad_token_id": 4, "max_new_tokens": 8}
    base.update(kw)
    return js.GenerationConfig.from_dict(base), ts.GenerationConfig.from_dict(base)


def _jax_noise(row_keys, t):
    keys_t = jax.vmap(jax.random.fold_in)(row_keys, jnp.asarray(t, jnp.int32))
    return np.array(jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys_t))


CONFIGS = {
    "greedy": dict(do_sample=False),
    "greedy_min_new_and_max_length": dict(do_sample=False, min_new_tokens=3, max_length=9),
    "sample": dict(do_sample=True),
    "sample_temperature_top_k": dict(do_sample=True, temperature=0.7, top_k=5),
    "sample_top_p": dict(do_sample=True, top_p=0.8),
    "sample_forced_bos": dict(do_sample=True, forced_bos_token_id=9),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_choose_tokens_matches_jax(name):
    jcfg, tcfg = _gen_cfg(**CONFIGS[name])
    jcfg = dataclasses.replace(jcfg, per_row_rng=True)
    logits, finished, value, n_real, t = _inputs(len(name))
    min_new = None
    if jcfg.min_new_tokens or jcfg.min_length:
        min_new = np.maximum(jcfg.min_new_tokens, jcfg.min_length - n_real)
    row_keys = js.make_row_keys(jax.random.PRNGKey(3), np.arange(10, 10 + B))
    jout = js.choose_tokens(
        jcfg, jnp.asarray(logits), jnp.asarray(t), jnp.asarray(finished),
        jnp.asarray(value), jnp.asarray(n_real),
        min_new=None if min_new is None else jnp.asarray(min_new),
        row_keys=row_keys if jcfg.do_sample else None,
    )
    noise = torch.from_numpy(_jax_noise(row_keys, t)) if tcfg.do_sample else None
    tout = ts.choose_tokens(
        tcfg, torch.from_numpy(logits), torch.from_numpy(t).long(),
        torch.from_numpy(finished), torch.from_numpy(value),
        torch.from_numpy(n_real).long(),
        min_new=None if min_new is None else torch.from_numpy(min_new).long(),
        noise=noise,
    )
    token, live, logprob, value_out, fin = (np.asarray(x) for x in jout)
    np.testing.assert_array_equal(tout[0].numpy(), token)
    np.testing.assert_array_equal(tout[1].numpy(), live)
    np.testing.assert_allclose(tout[2].numpy(), logprob, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tout[3].numpy(), value_out)
    np.testing.assert_array_equal(tout[4].numpy(), fin)


@pytest.mark.parametrize(
    "kw", [dict(top_k=5), dict(top_p=0.7), dict(temperature=0.5, top_k=3, top_p=0.9), dict(top_p=0.05)]
)
def test_filter_logits_matches_jax(kw):
    jcfg, tcfg = _gen_cfg(**kw)
    logits, *_ = _inputs(11)
    j = np.asarray(js.filter_logits(jnp.asarray(logits), jcfg))
    t = ts.filter_logits(torch.from_numpy(logits), tcfg).numpy()
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    np.testing.assert_allclose(t[~np.isinf(t)], j[~np.isinf(j)], rtol=1e-6)


def test_suppress_eos_matches_jax():
    jcfg, tcfg = _gen_cfg()
    logits, _, _, n_real, t = _inputs(5)
    min_new = np.array([0, 2, 3, 4, 9, 1])
    j = js.suppress_eos_before_min(jnp.asarray(logits), jnp.asarray(t), jcfg, jnp.asarray(min_new))
    tt = ts.suppress_eos_before_min(torch.from_numpy(logits), torch.from_numpy(t), tcfg, torch.from_numpy(min_new))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(j))


@pytest.mark.parametrize(
    "d",
    [
        {"max_length": 20, "top_k": 0.0, "eos_token_id": 7.0},
        {"max_new_tokens": 64, "min_new_tokens": 48, "do_sample": True, "unknown": 1},
    ],
)
def test_generation_config_parses_like_jax(d):
    assert dataclasses.asdict(ts.GenerationConfig.from_dict(d)) == dataclasses.asdict(
        js.GenerationConfig.from_dict(d)
    )


def test_validate_gen_config_like_jax():
    cfg = ts.GenerationConfig.from_dict({"eos_token_id": 99})
    with pytest.raises(ValueError, match="outside the model vocab"):
        ts.validate_gen_config(cfg, 32, provided={"eos_token_id"})
    with pytest.raises(ValueError, match="outside the model vocab"):
        js.validate_gen_config(js.GenerationConfig.from_dict({"eos_token_id": 99}), 32, provided={"eos_token_id"})
    ts.validate_gen_config(ts.GenerationConfig(), 32, provided=set())  # defaults unchecked


def test_row_noise_depends_only_on_row_and_step():
    """A row's noise depends on (phase seed, row draw index, step) only —
    not on its slot or on the other rows — which keeps each row's tokens
    independent of admission order."""
    a = ts.row_noise(5, [11, None, 12], [0, 0, 3], V, "cpu")
    b = ts.row_noise(5, [12, 11], [3, 0], V, "cpu")
    np.testing.assert_array_equal(a[0].numpy(), b[1].numpy())
    np.testing.assert_array_equal(a[2].numpy(), b[0].numpy())
    assert torch.isfinite(a).all()
    c = ts.row_noise(5, [11], [1], V, "cpu")
    d = ts.row_noise(6, [11], [0], V, "cpu")
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], d[0])
