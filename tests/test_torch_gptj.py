"""The port's GPT-J (``trlx_tpu_torch/models/gptj.py``) against the JAX
package's on the same weights, carried across by ``models/convert.py``.

Tiny f32 models, inputs from numpy seeds (rotary on 8 of each head's 16
dims, so both the rotated and the passed-through dims are held):

- the policy's logits and values without a cache, and the parameter
  gradients through ``response_forward`` over the untied, biased head:
  1e-5;
- a prefill and a decode step through the linear cache and through the
  paged cache (rotated block tables, per-row positions), against the JAX
  model and against the port's full forward of the whole sequence: 1e-5;
- the hydra arguments (``capture_hidden_at``, ``start_layer``,
  ``hidden_override``) and the branch, which holds ``lm_head``: 1e-5;
- the HF loader: a tiny ``GPTJForCausalLM`` written with
  ``save_pretrained`` gives the JAX loader's tensors bit for bit, and the
  port's forward agrees with HF's;
- the fixed sampler, greedy and under the JAX sampler's Gumbel draws, and
  the continuous engine behind both packages' ``InferenceServer``,
  greedy: the same tokens;
- one greedy PPO ``learn()`` phase with ``num_layers_unfrozen: 1`` (a
  1-block hydra reference, the bottom block and ``wte`` frozen) through
  both packages: the same rollouts, reference logprobs within 1e-5, the
  final parameters within ``tests/_torch_ppo_phase.py``'s bounds, frozen
  leaves bit-identical with no Adam state;
- the registry: ``gptj`` and ``gpt-j`` build, so do ``gpt_neox`` and its
  aliases and ``gpt_neo`` and its alias, the JAX package's other family
  (``gpt2_moe``) is refused by name, and ``configs/ppo_gptj.yml``'s ``tp: 4`` mesh is refused in one
  process, naming the four ranks it needs.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ppo_phase import (
    assert_final_params_match,
    config,
    port_trainer,
    run_jax,
    run_port,
)
from trlx_tpu.inference import kv_cache as jkv
from trlx_tpu.models.gptj import GPTJConfig as JGPTJConfig
from trlx_tpu.models.gptj import GPTJModel as JGPTJModel
from trlx_tpu.models.gptj import init_gptj_cache as jinit_cache
from trlx_tpu.models.heads import CausalLMWithValueHead as JPolicy
from trlx_tpu.ops import sampling as js
from trlx_tpu_torch.inference import kv_cache as tkv
from trlx_tpu_torch.models.convert import flax_to_torch
from trlx_tpu_torch.models.gptj import GPTJConfig, GPTJModel, init_gptj_cache
from trlx_tpu_torch.models.heads import CausalLMWithValueHead
from trlx_tpu_torch.ops import sampling as ts

ARCH = dict(vocab_size=40, n_positions=64, n_embd=32, n_layer=2, n_head=2, rotary_dim=8,
            dtype="float32", param_dtype="float32")
B, Q, R, BS = 3, 6, 4, 2
CAP = Q + R
TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    jmodel = JPolicy(JGPTJConfig(**ARCH), backbone_cls=JGPTJModel)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    # flax's zero-initialised biases would hide a bias mix-up: perturb all
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params
    )
    tmodel = CausalLMWithValueHead(GPTJConfig(**ARCH), GPTJModel, device="cpu")
    tmodel.load_state_dict(flax_to_torch(params))
    return jmodel, params, tmodel


def _prompts(q=Q):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, ARCH["vocab_size"], size=(B, q)).astype(np.int32)
    lens = np.array([q, 2, 4])
    mask = (np.arange(q)[None] >= q - lens[:, None]).astype(np.int32)
    return ids * mask, mask


def _apply_jax(jmodel, params, tok, m=None, pos=None, cache=None, index=None, **kw):
    return jmodel.apply({"params": params}, jnp.asarray(tok),
                        attention_mask=None if m is None else jnp.asarray(m),
                        position_ids=None if pos is None else jnp.asarray(pos),
                        cache=cache, cache_index=index, **kw)


def _apply_port(tmodel, tok, m=None, pos=None, cache=None, index=None, **kw):
    as_t = lambda x: None if x is None else torch.from_numpy(np.asarray(x)).long()
    with torch.no_grad():
        return tmodel(as_t(tok), attention_mask=as_t(m), position_ids=as_t(pos),
                      cache=cache, cache_index=index, **kw)


def _close(got, want, where=None):
    got, want = got.detach().numpy(), np.asarray(want)
    if where is not None:
        got, want = got[where], want[where]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_convert_names_cover_the_port_state_dict(models):
    _, params, tmodel = models
    converted = flax_to_torch(params)
    assert set(converted) == set(tmodel.state_dict())
    assert {"transformer.lm_head.weight", "transformer.lm_head.bias"} <= set(converted)
    assert not any(n.endswith(("q_proj.bias", "k_proj.bias", "v_proj.bias", "out_proj.bias"))
                   for n in converted)
    k = params["transformer"]["h_1"]["attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(converted["transformer.h.1.attn.q_proj.weight"].numpy(), k.T)
    assert tuple(tmodel.v_head.fc1.weight.shape) == (2 * ARCH["n_embd"], ARCH["n_embd"])


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_without_cache_matches_jax(models, last_only):
    jmodel, params, tmodel = models
    ids, mask = _prompts()
    j = _apply_jax(jmodel, params, ids, mask, last_only=last_only)
    t = _apply_port(tmodel, ids, mask, last_only=last_only)
    _close(t["logits"], j["logits"])
    _close(t["values"], j["values"])


def test_response_forward_gradients_match_jax(models):
    """Parameter gradients through ``response_forward`` (the PPO update's
    forward) against ``jax.grad``: the untied head's weight and bias, the
    rotary attention and the parallel residual. f32; 1e-5."""
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
        logp = jax.nn.log_softmax(logits, -1)
        return (values * w).sum() + (
            jnp.take_along_axis(logp, jnp.asarray(resp)[..., None], -1)[..., 0] * w).sum()

    jgrads = flax_to_torch(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(params)))
    logits, values = tmodel.response_forward(
        torch.from_numpy(full_ids).long(), torch.from_numpy(full_mask).long(), Q)
    logp = torch.log_softmax(logits, -1)
    out = (values * torch.from_numpy(w)).sum() + (
        torch.gather(logp, -1, torch.from_numpy(resp).long()[..., None])[..., 0]
        * torch.from_numpy(w)).sum()
    named = list(tmodel.named_parameters())
    grads = torch.autograd.grad(out, [p for _, p in named], allow_unused=True)
    for (name, _), g in zip(named, grads):
        want = jgrads[name].numpy()
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=name)
    assert np.abs(jgrads["transformer.lm_head.bias"].numpy()).max() > 0


def _paged_caches(turns):
    hd = ARCH["n_embd"] // ARCH["n_head"]
    jcache = jkv.init_paged_cache(2, B, CAP, 2, hd, jnp.float32, block_size=BS)
    nb = CAP // BS
    tables = np.stack([np.roll(np.arange(nb), -t) for t in turns]).astype(np.int32)
    jcache = tuple(dict(layer, block_tables=jnp.asarray(tables)) for layer in jcache)
    tcache = tkv.init_paged_cache(2, B, CAP, 2, hd, torch.float32, block_size=BS)
    tcache[0]["block_tables"].copy_(torch.from_numpy(tables))
    return jcache, tcache


@pytest.mark.parametrize("layout", ["paged", "linear"])
def test_prefill_and_decode_match_jax_and_the_full_forward(models, layout):
    """Prefill into the cache and one decode step (the greedy token at
    column Q, rotary position n_real per row; for the paged cache one row
    at another depth and one parked at the discard sentinel), against the
    JAX model and, on the live rows, against the port's full forward of
    the whole sequence."""
    jmodel, params, tmodel = models
    ids, mask = _prompts()
    if layout == "paged":
        jcache, tcache = _paged_caches([0, 1, 3])
    else:
        jcache = jinit_cache(JGPTJConfig(**ARCH), B, CAP)
        tcache = init_gptj_cache(GPTJConfig(**ARCH), B, CAP)
    cache_mask = np.concatenate([mask, np.zeros((B, R), np.int32)], 1)
    positions = np.clip(np.cumsum(mask, -1) - 1, 0, None)
    j = _apply_jax(jmodel, params, ids, cache_mask, positions, jcache, 0)
    t = _apply_port(tmodel, ids, cache_mask, positions, tcache, 0)
    _close(t["logits"], j["logits"])
    _close(t["values"], j["values"])

    token = np.asarray(j["logits"])[:, -1].argmax(-1).astype(np.int32)[:, None]
    n_real = mask.sum(-1)
    if layout == "paged":
        step = np.array([0, 2, 0])
        index = np.array([Q, Q + 2, CAP], np.int32)  # row 2 parked at the sentinel
        j_index, t_index = jnp.asarray(index), torch.from_numpy(index).long()
        live = [0]  # row 1 writes at Q + 2 past unwritten columns: held against JAX only
    else:
        step = np.zeros(B, np.int64)
        j_index = t_index = Q
        live = [0, 1, 2]
    dec_mask = (np.arange(CAP)[None] <= (Q + step)[:, None]).astype(np.int32) * np.concatenate(
        [mask, np.ones((B, R), np.int32)], 1)
    pos = (n_real + step)[:, None]
    j2 = _apply_jax(jmodel, params, token, dec_mask, pos, j["cache"], j_index)
    t2 = _apply_port(tmodel, token, dec_mask, pos, t["cache"], t_index)
    rows = slice(0, 2) if layout == "paged" else slice(None)
    _close(t2["logits"], j2["logits"], rows)
    _close(t2["values"], j2["values"], rows)
    for jl, tl in zip(j2["cache"], t2["cache"]):
        np.testing.assert_allclose(tl["k"][:, :CAP].numpy(), np.asarray(jl["k"]), atol=TOL, rtol=0)
        np.testing.assert_allclose(tl["v"][:, :CAP].numpy(), np.asarray(jl["v"]), atol=TOL, rtol=0)
    # the cached step against the full forward over [prompt; token]
    full = _apply_port(tmodel, np.concatenate([ids, token], 1),
                       np.concatenate([mask, np.ones((B, 1), np.int32)], 1))
    np.testing.assert_allclose(t2["logits"][live, 0].numpy(), full["logits"][live, -1].numpy(),
                               atol=TOL, rtol=0)


def test_hydra_arguments_match_the_jax_model():
    """``capture_hidden_at`` returns the activation entering the block (the
    port stops there); ``start_layer`` + ``hidden_override`` run the rest
    from it on a branch that holds those blocks, ``ln_f``, ``lm_head`` and
    ``wte``; the rotary positions come from the mask in both."""
    n_layer = 4
    arch = dict(ARCH, n_layer=n_layer)
    jmodel = JGPTJModel(JGPTJConfig(**arch))
    ids, mask = np.ones((3, 7), np.int32), np.ones((3, 7), np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    ids = rng.integers(0, 40, size=ids.shape).astype(np.int32)
    mask[0, :2] = 0
    model = GPTJModel(GPTJConfig(**arch), device="cpu")
    model.load_state_dict(flax_to_torch(params))
    for k in range(n_layer):
        jtrunk = _apply_jax(jmodel, params, ids, mask, capture_hidden_at=k)
        trunk = _apply_port(model, ids, mask, capture_hidden_at=k)
        assert trunk["hidden"] is None and trunk["logits"] is None
        _close(trunk["branch_hidden"], jtrunk["branch_hidden"])
        branch = model.hydra_branch(k)
        assert sorted(branch.h) == [str(i) for i in range(k, n_layer)]
        assert {n.split(".")[0] for n in branch.state_dict()} == {"wte", "h", "ln_f", "lm_head"} - (
            {"h"} if k == n_layer else set())
        assert not any(p.requires_grad for p in branch.parameters())
        with torch.no_grad():
            out = branch(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long(),
                         start_layer=k, hidden_override=trunk["branch_hidden"])
        jout = jmodel.apply({"params": params}, ids, attention_mask=mask, start_layer=k,
                            hidden_override=jtrunk["branch_hidden"])
        for key in ("hidden", "logits"):
            _close(out[key], jout[key])
        _close(out["logits"], jtrunk["logits"])  # the branch equals the full pass


def _hf_model(tmp_path, fmt):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPTJConfig(
        vocab_size=40, n_positions=64, n_embd=32, n_layer=2, n_head=2, rotary_dim=8,
        n_inner=None, activation_function="gelu_new", resid_pdrop=0.0, embd_pdrop=0.0,
        attn_pdrop=0.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.GPTJForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for p in model.parameters():  # zero-initialised biases would hide a mix-up
            p.add_(0.05 * torch.randn_like(p))
    model.save_pretrained(tmp_path, safe_serialization=fmt == "safetensors")
    return model


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_loader_matches_the_jax_loader_bit_for_bit_and_hf(tmp_path, fmt):
    from trlx_tpu.models import conversion as jconv
    from trlx_tpu_torch.models import conversion as tconv

    hf = _hf_model(tmp_path, fmt)
    jcfg, jparams = jconv.load_gptj_checkpoint(str(tmp_path))
    tcfg, state = tconv.load_gptj_checkpoint(str(tmp_path))
    assert tcfg.rotary_dim == jcfg.rotary_dim == 8
    assert (tcfg.n_embd, tcfg.n_layer, tcfg.n_head, tcfg.vocab_size) == (
        jcfg.n_embd, jcfg.n_layer, jcfg.n_head, jcfg.vocab_size)
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(state) == set(want)
    for name, t in state.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[name]), name
    model = GPTJModel(dataclasses.replace(tcfg, dtype="float32"), device="cpu")
    model.load_state_dict(state)
    ids, mask = _prompts()
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    with torch.no_grad():
        got = model(ids, attention_mask=mask)["logits"]
        ref = hf(ids, attention_mask=mask,
                 position_ids=(mask.cumsum(-1) - 1).clamp_min(0)).logits
    real = mask.bool()
    torch.testing.assert_close(got[real], ref[real], atol=1e-4, rtol=0)


def test_loader_defaults_rotary_dim_to_the_head_dim(tmp_path):
    import json

    from trlx_tpu_torch.models.conversion import gptj_config_from_hf

    d = dict(vocab_size=40, n_positions=64, n_embd=32, n_layer=2, n_head=2, rotary_dim=None)
    (tmp_path / "config.json").write_text(json.dumps(d))
    assert gptj_config_from_hf(str(tmp_path)).rotary_dim == 16
    (tmp_path / "config.json").write_text(json.dumps(dict(d, n_inner=64)))
    with pytest.raises(ValueError, match="n_inner"):
        gptj_config_from_hf(str(tmp_path))


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_fixed_sampler_matches_jax(models, sampled):
    """Tokens and masks exact, logprobs and values to 1e-5; sampled, the
    port is handed the JAX sampler's Gumbel draws."""
    jmodel, params, tmodel = models
    kw = dict(do_sample=sampled, max_new_tokens=R + 2, eos_token_id=3, pad_token_id=39)
    jcfg, tcfg = js.GenerationConfig.from_dict(kw), ts.GenerationConfig.from_dict(kw)
    ids, mask = _prompts()

    def apply_fn(p, input_ids, **k):
        return jmodel.apply({"params": p}, input_ids, **k)

    jsampler = js.make_sampler(apply_fn, functools.partial(jinit_cache, JGPTJConfig(**ARCH)),
                               jcfg, Q)
    rng = jax.random.PRNGKey(7)
    jout = jax.jit(jsampler)(params, jnp.asarray(ids), jnp.asarray(mask), rng)
    keys, r = [], rng
    for _ in range(jcfg.max_new_tokens):
        r, k = jax.random.split(r)
        keys.append(k)
    noise = [np.array(jax.random.gumbel(k, (B, ARCH["vocab_size"]), jnp.float32)) for k in keys]
    tsampler = ts.make_sampler(tmodel, functools.partial(init_gptj_cache, tmodel.config),
                               tcfg, Q)
    tout = tsampler(torch.from_numpy(ids), torch.from_numpy(mask),
                    noise_fn=lambda t: torch.from_numpy(noise[t]))
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.response_mask.numpy(), np.asarray(jout.response_mask))
    for key in ("logprobs", "values"):
        np.testing.assert_allclose(getattr(tout, key).numpy(), np.asarray(getattr(jout, key)),
                                   atol=TOL, rtol=0)


def _server_config():
    from trlx_tpu.analysis import harness

    cfg = harness.tiny_config_dict("ppo")
    arch = {k: v for k, v in ARCH.items() if k not in ("dtype", "param_dtype")}
    cfg["model"] = {"model_type": "gptj", "model_arch": arch}
    cfg["train"].update(seq_length=8, dtype="float32",
                        rollout={"engine": "continuous", "slots": 4, "admit_width": 2,
                                 "harvest_width": 2, "block_size": 4})
    cfg["method"]["gen_kwargs"].update(max_new_tokens=R + 2, do_sample=False,
                                       eos_token_id=3, pad_token_id=39)
    return cfg


def test_continuous_engine_servers_give_the_same_tokens():
    """Both packages' ``InferenceServer`` over the continuous engine and the
    paged cache (GPT-J's rotary positions at admission and at every decode
    step), greedy, on the same weights: the same tokens per request."""
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.inference.server import InferenceServer as JServer
    from trlx_tpu_torch.inference.server import InferenceServer as TServer

    jserver = JServer(TRLConfig.from_dict(_server_config()))
    params = flax_to_torch(jax.tree_util.tree_map(np.asarray, jserver.params))
    tserver = TServer(_server_config(), params=params, device="cpu")
    assert isinstance(tserver.model.transformer, GPTJModel)
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(4, 39, int(rng.integers(1, 9)))] for _ in range(10)]
    want, got = jserver.generate(prompts), tserver.generate(prompts)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g["length"] for g in got] == [w["length"] for w in want]
    assert tserver.stats()["engine/completed"] == 10


def _ppo_config(tmp_path):
    arch = {k: v for k, v in ARCH.items() if k not in ("dtype", "param_dtype")}
    return config(tmp_path, model={"model_type": "gptj", "model_arch": arch,
                                   "num_layers_unfrozen": 1})


@pytest.fixture(scope="module")
def ppo_runs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("gptj_ppo")
    jax_run = run_jax(_ppo_config(tmp_path / "jax"))
    cfg = _ppo_config(tmp_path / "port")
    return cfg, jax_run, run_port(port_trainer(cfg, jax_run["init"]))


def test_ppo_phase_rollouts_and_refs_match(ppo_runs):
    _, jax_run, port_run = ppo_runs
    trainer = port_run["trainer"]
    assert trainer.use_hydra and trainer.branch_start == 1
    names = set(trainer.ref.state_dict())
    assert names == jax_run["ref_names"]
    assert {n.split(".")[0] for n in names} == {"wte", "h", "ln_f", "lm_head"}
    assert {n.split(".")[1] for n in names if n.startswith("h.")} == {"1"}
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(port_run["buffer"][key], jax_run["buffer"][key], err_msg=key)
    for key in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(port_run["buffer"][key], jax_run["buffer"][key],
                                   atol=TOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(port_run["ref"], jax_run["ref"], atol=TOL, rtol=0)


def test_ppo_phase_final_params_and_frozen_leaves(ppo_runs):
    cfg, jax_run, port_run = ppo_runs
    trainer = port_run["trainer"]
    state = trainer.model.state_dict()
    assert assert_final_params_match(state, jax_run, cfg) > 1e-4
    init = flax_to_torch(jax_run["init"])
    frozen = {n for n, p in trainer.model.named_parameters() if not p.requires_grad}
    assert frozen == {n for n in init if n.startswith(("transformer.h.0.", "transformer.wte."))}
    for n in frozen:
        assert torch.equal(state[n], init[n]), n
    for n in init:
        if n.startswith(("transformer.h.1.", "transformer.ln_f.", "transformer.lm_head.",
                         "v_head.")):
            assert not torch.equal(state[n], init[n]), n
    named = dict(trainer.model.named_parameters())
    with_state = {id(p) for p in trainer.opt.adamw.state}
    assert with_state == {id(named[n]) for n in init if n not in frozen}


def test_registry_builds_gptj_and_refuses_the_other_families():
    from trlx_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
    from trlx_tpu_torch.models.neox import NeoXConfig, NeoXModel
    from trlx_tpu_torch.models.registry import get_model_family

    for name in ("gptj", "gpt-j", "GPTJ"):
        family = get_model_family(name)
        assert family.backbone_cls is GPTJModel and family.config_cls is GPTJConfig
    for name in ("gpt_neox", "neox", "gpt-neox"):
        family = get_model_family(name)
        assert family.backbone_cls is NeoXModel and family.config_cls is NeoXConfig
        assert family.name == "gpt_neox" and not family.is_seq2seq
    for name in ("gpt_neo", "gpt-neo"):
        family = get_model_family(name)
        assert family.backbone_cls is GPTNeoModel and family.config_cls is GPTNeoConfig
        assert family.name == "gpt_neo" and not family.is_seq2seq
    # gpt2_moe, refused by name until ROADMAP item 13's last family landed,
    # now resolves under both names
    from trlx_tpu_torch.models.gpt2_moe import GPT2MoEConfig, GPT2MoEModel

    for name in ("gpt2_moe", "gpt2-moe"):
        family = get_model_family(name)
        assert family.backbone_cls is GPT2MoEModel and family.config_cls is GPT2MoEConfig
        assert family.name == "gpt2_moe" and family.is_moe and not family.is_seq2seq
    with pytest.raises(ValueError, match="Unknown model_type"):
        get_model_family("gpt3")


def test_ppo_gptj_yml_mesh_is_refused_until_one_device(tmp_path):
    """``configs/ppo_gptj.yml`` as written asks for ``tp: 4``: in one
    process the trainer refuses it, naming the four ranks to launch; with
    the mesh set to one device it builds (here at a tiny width, random
    weights, no checkpoint)."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    cfg = TRLConfig.load_yaml(os.path.join(ROOT, "configs", "ppo_gptj.yml")).to_dict()
    arch = {k: v for k, v in ARCH.items() if k not in ("dtype", "param_dtype")}
    cfg["model"].update(model_path="", tokenizer_path="", model_arch=arch)
    cfg["train"].update(checkpoint_dir=str(tmp_path))
    cfg["method"]["gen_kwargs"].update(max_new_tokens=4, min_new_tokens=4)
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 1"):
        PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    cfg["train"]["mesh"] = {"dp": -1, "fsdp": 1, "tp": 1}
    trainer = PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    assert isinstance(trainer.model.transformer, GPTJModel)
    assert trainer.use_hydra and trainer.branch_start == ARCH["n_layer"] - 2
