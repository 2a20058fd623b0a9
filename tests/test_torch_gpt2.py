"""The port's GPT-2 policy (``CausalLMWithValueHead``) against the JAX
package's on the same weights, carried across by ``models/convert.py``.

Tiny f32 model, inputs from a numpy seed. Logits and values must match to
1e-4 for the forward without a cache, a prefill into the paged cache
(rotated block tables) and into the linear cache, and one decode step
after each (per-row positions, one row parked at the discard sentinel for
the paged cache). Also: every PPO config in ``configs/`` parses in both
packages to the same values of the fields the port reads, and the port
carries the rest of the yml as given.
"""

import glob
import os
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from trlx_tpu.data.configs import TRLConfig as JTRLConfig
from trlx_tpu.inference import kv_cache as jkv
from trlx_tpu.models.gpt2 import GPT2Config as JGPT2Config
from trlx_tpu.models.gpt2 import init_cache as jinit_cache
from trlx_tpu.models.heads import CausalLMWithValueHead as JPolicy
from trlx_tpu_torch.data.configs import TRLConfig as TTRLConfig
from trlx_tpu_torch.inference import kv_cache as tkv
from trlx_tpu_torch.models.convert import flax_to_torch
from trlx_tpu_torch.models.gpt2 import GPT2Config as TGPT2Config
from trlx_tpu_torch.models.gpt2 import init_cache as tinit_cache
from trlx_tpu_torch.models.heads import CausalLMWithValueHead as TPolicy

ARCH = dict(vocab_size=32, n_positions=32, n_embd=32, n_layer=2, n_head=2,
            dtype="float32", param_dtype="float32")
B, Q, R, BS = 3, 6, 4, 2
CAP = Q + R
TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    jmodel = JPolicy(JGPT2Config(**ARCH))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    # flax's zero-initialised biases would hide a bias mix-up: perturb all
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), params
    )
    tmodel = TPolicy(TGPT2Config(**ARCH), device="cpu")
    tmodel.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


def _prompts():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 32, size=(B, Q)).astype(np.int32)
    lens = np.array([Q, 2, 4])
    mask = (np.arange(Q)[None] >= Q - lens[:, None]).astype(np.int32)
    return ids, mask


def _close(t_out, j_out, key, where=None):
    a, b = t_out[key].detach().numpy(), np.asarray(j_out[key])
    if where is not None:
        a, b = a[where], b[where]
    np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_convert_names_cover_the_port_state_dict(models):
    _, params, tmodel = models
    converted = flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    assert set(converted) == set(tmodel.state_dict())
    k = np.asarray(params["transformer"]["h_1"]["attn"]["c_attn"]["kernel"])
    np.testing.assert_array_equal(converted["transformer.h.1.attn.c_attn.weight"].numpy(), k.T)


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_without_cache_matches_jax(models, last_only):
    jmodel, params, tmodel = models
    ids, mask = _prompts()
    j = jmodel.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                     last_only=last_only)
    with torch.no_grad():
        t = tmodel(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long(),
                   last_only=last_only)
    _close(t, j, "logits")
    _close(t, j, "values")


@pytest.mark.parametrize("loss", ["logprobs_and_values", "values_only"])
def test_response_forward_gradients_match_jax(models, loss):
    """Parameter gradients through ``response_forward`` (the PPO update's
    forward) against ``jax.grad``. The tied ``wte`` gets gradient from the
    f32 LM head and from the embedding lookup: the ``values_only`` loss
    never reaches the head, so it holds the embedding part alone, and the
    other loss both parts together. f32; tolerance 1e-5."""
    jmodel, params, tmodel = models
    ids, mask = _prompts()
    rng = np.random.default_rng(3)
    resp = rng.integers(0, ARCH["vocab_size"], size=(B, R)).astype(np.int32)
    full_ids = np.concatenate([ids, resp], 1)
    full_mask = np.concatenate([mask, np.ones((B, R), np.int32)], 1)
    w = rng.normal(size=(B, R)).astype(np.float32)

    def jloss(p):
        logits, values = jmodel.apply({"params": p}, jnp.asarray(full_ids),
                                      jnp.asarray(full_mask), Q, method=jmodel.response_forward)
        out = (values * w).sum()
        if loss == "logprobs_and_values":
            logp = jax.nn.log_softmax(logits, -1)
            out = out + (jnp.take_along_axis(logp, jnp.asarray(resp)[..., None], -1)[..., 0] * w).sum()
        return out

    jgrads = flax_to_torch(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(params)))
    logits, values = tmodel.response_forward(
        torch.from_numpy(full_ids).long(), torch.from_numpy(full_mask).long(), Q
    )
    out = (values * torch.from_numpy(w)).sum()
    if loss == "logprobs_and_values":
        logp = torch.log_softmax(logits, -1)
        out = out + (torch.gather(logp, -1, torch.from_numpy(resp).long()[..., None])[..., 0]
                     * torch.from_numpy(w)).sum()
    names = [n for n, _ in tmodel.named_parameters()]
    grads = torch.autograd.grad(out, [p for _, p in tmodel.named_parameters()], allow_unused=True)
    for name, g in zip(names, grads):
        want = jgrads[name].numpy()
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)
    assert np.abs(jgrads["transformer.wte.weight"].numpy()).max() > 0


def _jax_paged_cache(turns):
    cache = jkv.init_paged_cache(2, B, CAP, 2, 16, jnp.float32, block_size=BS)
    nb = CAP // BS
    tables = np.stack([np.roll(np.arange(nb), -t) for t in turns]).astype(np.int32)
    return tuple(dict(layer, block_tables=jnp.asarray(tables)) for layer in cache), tables


@pytest.mark.parametrize("layout", ["paged", "linear"])
def test_prefill_and_decode_step_match_jax(models, layout):
    jmodel, params, tmodel = models
    ids, mask = _prompts()
    if layout == "paged":
        jcache, tables = _jax_paged_cache([0, 1, 3])
        tcache = tkv.init_paged_cache(2, B, CAP, 2, 16, torch.float32, block_size=BS)
        tcache[0]["block_tables"].copy_(torch.from_numpy(tables))
    else:
        jcache = jinit_cache(JGPT2Config(**ARCH), B, CAP)
        tcache = tinit_cache(TGPT2Config(**ARCH), B, CAP)
    cache_mask = np.concatenate([mask, np.zeros((B, R), np.int32)], 1)
    positions = np.clip(np.cumsum(mask, -1) - 1, 0, None)

    def run_jax(tok, m, pos, cache, index, **kw):
        return jmodel.apply({"params": params}, jnp.asarray(tok), attention_mask=jnp.asarray(m),
                            position_ids=jnp.asarray(pos), cache=cache, cache_index=index, **kw)

    def run_torch(tok, m, pos, cache, index, **kw):
        with torch.no_grad():
            return tmodel(torch.from_numpy(tok).long(), attention_mask=torch.from_numpy(m).long(),
                          position_ids=torch.from_numpy(pos).long(), cache=cache,
                          cache_index=index, **kw)

    j = run_jax(ids, cache_mask, positions, jcache, 0)
    t = run_torch(ids, cache_mask, positions, tcache, 0)
    _close(t, j, "logits")
    _close(t, j, "values")

    # one decode step: the greedy token at cache column Q (+ t per row)
    token = np.asarray(j["logits"])[:, -1].argmax(-1).astype(np.int32)[:, None]
    n_real = mask.sum(-1)
    if layout == "paged":
        step = np.array([0, 2, 0])
        index = np.array([Q, Q + 2, CAP], np.int32)  # row 2 parked at the sentinel
        j_index, t_index = jnp.asarray(index), torch.from_numpy(index).long()
    else:
        step = np.zeros(B, np.int64)
        j_index = t_index = Q
    dec_mask = (np.arange(CAP)[None] <= (Q + step)[:, None]).astype(np.int32) * np.concatenate(
        [mask, np.ones((B, R), np.int32)], 1
    )
    pos = (n_real + step)[:, None]
    j2 = run_jax(token, dec_mask, pos, j["cache"], j_index)
    t2 = run_torch(token, dec_mask, pos, t["cache"], t_index)
    live = slice(0, 2) if layout == "paged" else slice(None)
    _close(t2, j2, "logits", where=live)
    _close(t2, j2, "values", where=live)
    for jl, tl in zip(j2["cache"], t2["cache"]):
        np.testing.assert_allclose(tl["k"][:, :CAP].numpy(), np.asarray(jl["k"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tl["v"][:, :CAP].numpy(), np.asarray(jl["v"]), atol=1e-5, rtol=0)


def test_unported_arguments_raise():
    with pytest.raises(NotImplementedError, match="int8"):
        tinit_cache(TGPT2Config(**dict(ARCH, kv_cache_dtype="int8")), 1, 8)


# the methods the port has: PPO, GRPO and ILQL
PORTED_CONFIGS = sorted(
    p for p in glob.glob(os.path.join(ROOT, "configs", "*.yml"))
    if any(m in open(p).read() for m in ("PPOConfig", "GRPOConfig", "ILQLConfig"))
)


@pytest.mark.parametrize("path", PORTED_CONFIGS, ids=os.path.basename)
def test_configs_parse_like_jax(path):
    tcfg, jcfg = TTRLConfig.load_yaml(path), JTRLConfig.load_yaml(path)
    td, jd = tcfg.to_dict(), jcfg.to_dict()
    assert td["method"] == jd["method"]
    with open(path) as fh:
        yml = yaml.safe_load(fh)
    for name in ("model", "train"):
        section = getattr(tcfg, name)
        kept = {f.name for f in fields(section)} - {"training"}
        # the fields the port reads hold the JAX package's values
        assert {k: td[name][k] for k in kept} == {k: jd[name][k] for k in kept}
        # the training-only keys are carried exactly as the yml gives them
        given = yml.get(name) or {}
        assert section.training == {k: v for k, v in given.items() if k not in kept}
    assert TTRLConfig.from_dict(td).to_dict() == td


def test_config_keys_outside_the_schema_raise():
    cfg = {"model": {}, "train": {"seq_length": 8, "project_name": "p"},
           "method": {"name": "PPOConfig"}}
    assert TTRLConfig.from_dict(cfg).train.training == {"project_name": "p"}
    JTRLConfig.from_dict(cfg)  # the same keys parse in the JAX package
    for section, key in (("train", "epoch"), ("model", "n_layer")):
        bad = dict(cfg, **{section: dict(cfg[section], **{key: 1})})
        with pytest.raises(ValueError, match="Unknown keys"):
            TTRLConfig.from_dict(bad)
        with pytest.raises(ValueError, match="Unknown keys"):
            JTRLConfig.from_dict(bad)
