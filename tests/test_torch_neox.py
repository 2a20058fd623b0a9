"""The port's GPT-NeoX (``trlx_tpu_torch/models/neox.py``) against the JAX
package's on the same weights, carried across by ``models/convert.py``.

Tiny f32 models with the 20B's head geometry (width 192, 2 heads of 96,
rotary on 24 of each head's 96 dims, so both the rotated and the
passed-through dims are held), inputs from numpy seeds:

- the policy's logits and values without a cache (1e-5), and the parameter
  gradients through ``response_forward`` over the untied, bias-free head
  (1e-5 of each tensor's largest gradient, at least 1: at width 192 they
  reach 17.6, and two f32 summation orders differ by ~1e-6 of that), with
  the parallel and the sequential residual;
- a prefill and a decode step through the linear cache and through the
  paged cache (rotated block tables, per-row positions), against the JAX
  model and against the port's full forward of the whole sequence: 1e-5;
- the hydra arguments (``capture_hidden_at``, ``start_layer``,
  ``hidden_override``) and the branch, which holds ``lm_head``: 1e-5;
- the HF loader: a tiny ``GPTNeoXForCausalLM`` written with
  ``save_pretrained`` (safetensors and ``.bin``), with the three buffers of
  older checkpoints added, gives the JAX loader's tensors bit for bit; an
  ``intermediate_size`` other than 4 x width is refused; the port against
  HF's forward at the JAX package's own bounds
  (``tests/test_gptj_neox_parity.py``: atol 3e-4, rtol 2e-3), and the
  reference's tanh GELU against HF's exact one measured (ROADMAP queue 3);
- the fixed sampler, greedy and under the JAX sampler's Gumbel draws, and
  the continuous engine behind both packages' ``InferenceServer``,
  greedy: the same tokens;
- one greedy PPO ``learn()`` phase with ``num_layers_unfrozen: 1`` (a
  1-block hydra reference, the bottom block and ``wte`` frozen) through
  both packages: the same rollouts, reference logprobs within 1e-5, the
  final parameters within ``tests/_torch_ppo_phase.py``'s bounds (the
  elements whose gradient fell below 1e-6 in some update, and the key
  biases, to the summed learning rate), frozen leaves bit-identical with
  no Adam state;
- a server built with ``param_dtype: bfloat16`` holds and serves the same
  bits as the f32 build cast to bf16;
- ``configs/ppo_neox20b.yml``'s ``fsdp: 8, tp: 4`` mesh is refused in one
  process, naming the 32 ranks it needs.
"""

import dataclasses
import functools
import json
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
from trlx_tpu.models.heads import CausalLMWithValueHead as JPolicy
from trlx_tpu.models.neox import NeoXConfig as JNeoXConfig
from trlx_tpu.models.neox import NeoXModel as JNeoXModel
from trlx_tpu.models.neox import init_neox_cache as jinit_cache
from trlx_tpu.ops import sampling as js
from trlx_tpu_torch.inference import kv_cache as tkv
from trlx_tpu_torch.models.convert import flax_to_torch
from trlx_tpu_torch.models.heads import CausalLMWithValueHead
from trlx_tpu_torch.models.neox import NeoXConfig, NeoXModel, init_neox_cache
from trlx_tpu_torch.ops import sampling as ts

ARCH = dict(vocab_size=301, max_position_embeddings=128, hidden_size=192,
            num_hidden_layers=2, num_attention_heads=2, rotary_pct=0.25,
            dtype="float32", param_dtype="float32")
HD = ARCH["hidden_size"] // ARCH["num_attention_heads"]  # 96, the 20B's head dim
B, Q, R, BS = 3, 6, 4, 2
CAP = Q + R
TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _perturbed(params, seed=0):
    """flax's zero-initialised biases would hide a bias mix-up: perturb all."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def _policies(parallel: bool):
    arch = dict(ARCH, use_parallel_residual=parallel)
    jmodel = JPolicy(JNeoXConfig(**arch), backbone_cls=JNeoXModel)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = CausalLMWithValueHead(NeoXConfig(**arch), NeoXModel, device="cpu")
    tmodel.load_state_dict(flax_to_torch(params))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def models():
    return _policies(parallel=True)


@pytest.fixture(scope="module")
def sequential():
    return _policies(parallel=False)


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
    assert "transformer.lm_head.weight" in converted
    assert "transformer.lm_head.bias" not in converted
    assert {"transformer.h.1.ln_2.weight", "transformer.h.1.attn.query_key_value.bias",
            "transformer.h.1.attn.dense.bias"} <= set(converted)
    k = params["transformer"]["h_1"]["attn"]["query_key_value"]["kernel"]
    np.testing.assert_array_equal(
        converted["transformer.h.1.attn.query_key_value.weight"].numpy(), k.T)
    assert tuple(tmodel.v_head.fc1.weight.shape) == (2 * ARCH["hidden_size"], ARCH["hidden_size"])
    assert tmodel.config.rotary_dim == 24 and tmodel.config.head_dim == 96


@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("residual", ["parallel", "sequential"])
def test_forward_without_cache_matches_jax(request, residual, last_only):
    jmodel, params, tmodel = request.getfixturevalue(
        "models" if residual == "parallel" else "sequential")
    ids, mask = _prompts()
    j = _apply_jax(jmodel, params, ids, mask, last_only=last_only)
    t = _apply_port(tmodel, ids, mask, last_only=last_only)
    _close(t["logits"], j["logits"])
    _close(t["values"], j["values"])


@pytest.mark.parametrize("residual", ["parallel", "sequential"])
def test_response_forward_gradients_match_jax(request, residual):
    """Parameter gradients through ``response_forward`` (the PPO update's
    forward) against ``jax.grad``: the untied head, the fused projection,
    the half rotary and both residual wirings. f32; 1e-5 of each tensor's
    largest gradient (at least 1)."""
    jmodel, params, tmodel = request.getfixturevalue(
        "models" if residual == "parallel" else "sequential")
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
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0, err_msg=name)
    assert np.abs(jgrads["transformer.h.0.attn.query_key_value.bias"].numpy()).max() > 0


def _paged_caches(turns):
    jcache = jkv.init_paged_cache(2, B, CAP, 2, HD, jnp.float32, block_size=BS)
    nb = CAP // BS
    tables = np.stack([np.roll(np.arange(nb), -t) for t in turns]).astype(np.int32)
    jcache = tuple(dict(layer, block_tables=jnp.asarray(tables)) for layer in jcache)
    tcache = tkv.init_paged_cache(2, B, CAP, 2, HD, torch.float32, block_size=BS)
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
        jcache = jinit_cache(JNeoXConfig(**ARCH), B, CAP)
        tcache = init_neox_cache(NeoXConfig(**ARCH), B, CAP)
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
    full = _apply_port(tmodel, np.concatenate([ids, token], 1),
                       np.concatenate([mask, np.ones((B, 1), np.int32)], 1))
    np.testing.assert_allclose(t2["logits"][live, 0].numpy(), full["logits"][live, -1].numpy(),
                               atol=TOL, rtol=0)


def test_hydra_arguments_match_the_jax_model():
    """``capture_hidden_at`` returns the activation entering the block (the
    port stops there); ``start_layer`` + ``hidden_override`` run the rest
    from it on a branch that holds those blocks, ``ln_f``, ``lm_head`` and
    ``wte``; the rotary positions come from the mask in both."""
    n_layer = 3
    arch = dict(ARCH, num_hidden_layers=n_layer)
    jmodel = JNeoXModel(JNeoXConfig(**arch))
    ids, mask = np.ones((3, 7), np.int32), np.ones((3, 7), np.int32)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    ids = np.random.default_rng(5).integers(0, ARCH["vocab_size"], size=ids.shape).astype(np.int32)
    mask[0, :2] = 0
    model = NeoXModel(NeoXConfig(**arch), device="cpu")
    model.load_state_dict(flax_to_torch(params))
    for k in range(n_layer):
        jtrunk = _apply_jax(jmodel, params, ids, mask, capture_hidden_at=k)
        trunk = _apply_port(model, ids, mask, capture_hidden_at=k)
        assert trunk["hidden"] is None and trunk["logits"] is None
        _close(trunk["branch_hidden"], jtrunk["branch_hidden"])
        branch = model.hydra_branch(k)
        assert sorted(branch.h) == [str(i) for i in range(k, n_layer)]
        assert {n.split(".")[0] for n in branch.state_dict()} == {"wte", "h", "ln_f", "lm_head"}
        assert not any(p.requires_grad for p in branch.parameters())
        with torch.no_grad():
            out = branch(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long(),
                         start_layer=k, hidden_override=trunk["branch_hidden"])
        jout = jmodel.apply({"params": params}, ids, attention_mask=mask, start_layer=k,
                            hidden_override=jtrunk["branch_hidden"])
        for key in ("hidden", "logits"):
            _close(out[key], jout[key])
        _close(out["logits"], jtrunk["logits"])  # the branch equals the full pass


HF_ARCH = dict(vocab_size=301, max_position_embeddings=128, hidden_size=192,
               num_hidden_layers=2, num_attention_heads=2, rotary_pct=0.25,
               use_parallel_residual=True, intermediate_size=768, hidden_dropout=0.0,
               attention_dropout=0.0, tie_word_embeddings=False)
#: the per-layer buffers older GPT-NeoX checkpoints carry (not weights)
OLD_BUFFERS = ("attention.bias", "attention.masked_bias", "attention.rotary_emb.inv_freq")


def _hf_model(perturb: bool, **overrides):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.GPTNeoXForCausalLM(
        transformers.GPTNeoXConfig(**dict(HF_ARCH, **overrides))).eval()
    if perturb:
        with torch.no_grad():
            for p in model.parameters():  # zero-initialised biases would hide a mix-up
                p.add_(0.05 * torch.randn_like(p))
    return model


def _save_with_old_buffers(model, path, fmt):
    """``save_pretrained``, then the weights file rewritten with the three
    buffers of older checkpoints added to every layer."""
    model.save_pretrained(path, safe_serialization=fmt == "safetensors")
    n, p = HF_ARCH["num_hidden_layers"], HF_ARCH["max_position_embeddings"]
    extra = {}
    for i in range(n):
        pre = f"gpt_neox.layers.{i}."
        extra[pre + "attention.bias"] = torch.tril(torch.ones(p, p, dtype=torch.bool))[None, None]
        extra[pre + "attention.masked_bias"] = torch.tensor(-1e9)
        extra[pre + "attention.rotary_emb.inv_freq"] = 1.0 / 10000 ** (
            torch.arange(0, 24, 2, dtype=torch.float32) / 24)
    if fmt == "safetensors":
        from safetensors.torch import load_file, save_file

        file = os.path.join(path, "model.safetensors")
        save_file({**load_file(file), **extra}, file, metadata={"format": "pt"})
    else:
        file = os.path.join(path, "pytorch_model.bin")
        torch.save({**torch.load(file, weights_only=True), **extra}, file)
    return extra


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_loader_matches_the_jax_loader_bit_for_bit(tmp_path, fmt):
    """Both packages' loaders on one checkpoint (``gpt_neox.`` names, the
    fused ``query_key_value``, ``embed_out``, and the three buffers of older
    checkpoints, which are skipped): the same tensors, bit for bit."""
    from trlx_tpu.models import conversion as jconv
    from trlx_tpu_torch.models import conversion as tconv
    from trlx_tpu_torch.models.conversion import read_hf_weights

    extra = _save_with_old_buffers(_hf_model(perturb=True), str(tmp_path), fmt)
    assert set(extra) <= set(read_hf_weights(str(tmp_path)))
    jcfg, jparams = jconv.load_neox_checkpoint(str(tmp_path))
    tcfg, state = tconv.load_neox_checkpoint(str(tmp_path))
    fields = ("vocab_size", "max_position_embeddings", "hidden_size", "num_hidden_layers",
              "num_attention_heads", "rotary_pct", "rotary_emb_base", "use_parallel_residual",
              "layer_norm_eps")
    assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(state) == set(want)
    assert not any(n.endswith(("attn.bias", "masked_bias", "inv_freq")) for n in state)
    for name, t in state.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[name]), name


def test_loader_refuses_another_mlp_width(tmp_path):
    from trlx_tpu_torch.models.conversion import neox_config_from_hf

    d = {k: v for k, v in HF_ARCH.items() if "dropout" not in k}
    (tmp_path / "config.json").write_text(json.dumps(d))
    assert neox_config_from_hf(str(tmp_path)).hidden_size == 192
    (tmp_path / "config.json").write_text(json.dumps(dict(d, intermediate_size=512)))
    with pytest.raises(ValueError, match="intermediate_size=512"):
        neox_config_from_hf(str(tmp_path))


def _port_and_hf_logits(tmp_path, hf):
    from trlx_tpu_torch.models.conversion import load_neox_checkpoint

    hf.save_pretrained(tmp_path)
    tcfg, state = load_neox_checkpoint(str(tmp_path))
    model = NeoXModel(dataclasses.replace(tcfg, dtype="float32"), device="cpu")
    model.load_state_dict(state)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 301, size=(2, 11)))
    with torch.no_grad():
        return model(ids)["logits"].numpy(), hf(input_ids=ids).logits.numpy()


def test_port_matches_hf_at_the_reference_bounds(tmp_path):
    """The port on an HF ``GPTNeoXForCausalLM`` (its own init, exact GELU)
    against HF's forward, at the bounds the JAX package holds its model to
    (``tests/test_gptj_neox_parity.py``)."""
    got, want = _port_and_hf_logits(tmp_path, _hf_model(perturb=False))
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=2e-3)


def test_reference_tanh_gelu_against_hf_exact_gelu(tmp_path):
    """The port mirrors the JAX model's tanh-approximate GELU; HF's
    GPT-NeoX applies the exact one (``GPTNeoXConfig().hidden_act``). On
    perturbed weights the port matches an HF model built with the tanh
    GELU (``gelu_new``) to 1e-4, and differs from the exact-GELU one by more
    than the reference's bounds: the size ROADMAP queue 3 records."""
    tanh, exact = (_port_and_hf_logits(tmp_path / act, _hf_model(perturb=True, hidden_act=act))
                   for act in ("gelu_new", "gelu"))
    np.testing.assert_allclose(*tanh, atol=1e-4, rtol=0)
    gap = np.abs(exact[0] - exact[1]).max()
    assert 3e-4 < gap < 0.1, gap


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_fixed_sampler_matches_jax(models, sampled):
    """Tokens and masks exact, logprobs and values to 1e-5; sampled, the
    port is handed the JAX sampler's Gumbel draws."""
    jmodel, params, tmodel = models
    kw = dict(do_sample=sampled, max_new_tokens=R + 2, eos_token_id=3, pad_token_id=300)
    jcfg, tcfg = js.GenerationConfig.from_dict(kw), ts.GenerationConfig.from_dict(kw)
    ids, mask = _prompts()

    def apply_fn(p, input_ids, **k):
        return jmodel.apply({"params": p}, input_ids, **k)

    jsampler = js.make_sampler(apply_fn, functools.partial(jinit_cache, JNeoXConfig(**ARCH)),
                               jcfg, Q)
    rng = jax.random.PRNGKey(7)
    jout = jax.jit(jsampler)(params, jnp.asarray(ids), jnp.asarray(mask), rng)
    keys, r = [], rng
    for _ in range(jcfg.max_new_tokens):
        r, k = jax.random.split(r)
        keys.append(k)
    noise = [np.array(jax.random.gumbel(k, (B, ARCH["vocab_size"]), jnp.float32)) for k in keys]
    tsampler = ts.make_sampler(tmodel, functools.partial(init_neox_cache, tmodel.config),
                               tcfg, Q)
    tout = tsampler(torch.from_numpy(ids), torch.from_numpy(mask),
                    noise_fn=lambda t: torch.from_numpy(noise[t]))
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.response_mask.numpy(), np.asarray(jout.response_mask))
    for key in ("logprobs", "values"):
        np.testing.assert_allclose(getattr(tout, key).numpy(), np.asarray(getattr(jout, key)),
                                   atol=TOL, rtol=0)


def _server_config(**arch):
    from trlx_tpu.analysis import harness

    cfg = harness.tiny_config_dict("ppo")
    model_arch = {k: v for k, v in ARCH.items() if k not in ("dtype", "param_dtype")}
    cfg["model"] = {"model_type": "gpt_neox", "model_arch": dict(model_arch, **arch)}
    # no tp axis (the JAX server would shard the 301-wide head over it), so
    # the JAX engine rounds its widths to the 8 CPU devices' dp: 8 slots
    cfg["train"].update(seq_length=8, dtype="float32", mesh={"dp": -1, "fsdp": 1, "tp": 1},
                        rollout={"engine": "continuous", "slots": 8, "admit_width": 2,
                                 "harvest_width": 2, "block_size": 4})
    cfg["method"]["gen_kwargs"].update(max_new_tokens=R + 2, do_sample=False,
                                       eos_token_id=3, pad_token_id=300)
    return cfg


def _server_prompts():
    rng = np.random.default_rng(4)
    return [[int(t) for t in rng.integers(4, 300, int(rng.integers(1, 9)))] for _ in range(10)]


def test_continuous_engine_servers_give_the_same_tokens():
    """Both packages' ``InferenceServer`` over the continuous engine and the
    paged cache (NeoX's rotary positions at admission and at every decode
    step), greedy, on the same weights: the same tokens per request."""
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.inference.server import InferenceServer as JServer
    from trlx_tpu_torch.inference.server import InferenceServer as TServer

    jserver = JServer(TRLConfig.from_dict(_server_config()))
    params = flax_to_torch(jax.tree_util.tree_map(np.asarray, jserver.params))
    tserver = TServer(_server_config(), params=params, device="cpu")
    assert isinstance(tserver.model.transformer, NeoXModel)
    prompts = _server_prompts()
    want, got = jserver.generate(prompts), tserver.generate(prompts)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g["length"] for g in got] == [w["length"] for w in want]
    assert tserver.stats()["engine/completed"] == 10


def test_bf16_server_build_matches_the_f32_build_and_cast():
    """``param_dtype: bfloat16`` builds the policy in bf16 directly, with the
    value head's last layer in f32 as the f32 build's cast keeps it (the
    f32 build keeps its layer norms f32 too, by the trainers' rollout-cast
    rule, at the same values): the same parameters, bit for bit, and the
    same served tokens, logprobs and values as the f32 build cast to
    bf16."""
    from trlx_tpu_torch.inference.server import InferenceServer
    from trlx_tpu_torch.utils import cast_excluded

    servers = {}
    for param_dtype in ("float32", "bfloat16"):
        cfg = _server_config(dtype="bfloat16", param_dtype=param_dtype)
        cfg["train"]["dtype"] = "bfloat16"
        servers[param_dtype] = InferenceServer(cfg, seed=3, device="cpu")
    f32, bf16 = (dict(servers[k].model.named_parameters()) for k in ("float32", "bfloat16"))
    assert set(f32) == set(bf16)
    for name, p in bf16.items():
        want = torch.float32 if name.startswith("v_head.fc2.") else torch.bfloat16
        cast = torch.float32 if cast_excluded(name) else torch.bfloat16
        assert p.dtype == want and f32[name].dtype == cast, name
        assert torch.equal(p.float(), f32[name].float()), name
    got = [servers[k].generate(_server_prompts()) for k in ("float32", "bfloat16")]
    for a, b in zip(*got):
        assert a["tokens"] == b["tokens"]
        np.testing.assert_array_equal(a["logprobs"], b["logprobs"])
        np.testing.assert_array_equal(a["values"], b["values"])


def _ppo_config(tmp_path):
    arch = {k: v for k, v in ARCH.items() if k not in ("dtype", "param_dtype")}
    return config(tmp_path, model={"model_type": "gpt_neox", "model_arch": arch,
                                   "num_layers_unfrozen": 1})


@pytest.fixture(scope="module")
def ppo_runs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("neox_ppo")
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
    # at width 192 a few hundred elements a tensor meet a gradient below
    # 1e-6 in some update, where rounding decides Adam's step: ``noisy``
    assert assert_final_params_match(state, jax_run, cfg, noisy=port_run["noisy"]) > 1e-4
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


def test_ppo_neox20b_yml_mesh_is_refused_until_one_device(tmp_path):
    """``configs/ppo_neox20b.yml`` as written asks for ``fsdp: 8, tp: 4``:
    in one process the trainer refuses it, naming the 32 ranks to launch;
    with the mesh set to one device it
    builds (here at a tiny width, random weights, no checkpoint), its
    2-block hydra reference included."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    cfg = TRLConfig.load_yaml(os.path.join(ROOT, "configs", "ppo_neox20b.yml")).to_dict()
    arch = {k: v for k, v in ARCH.items() if k not in ("dtype", "param_dtype")}
    cfg["model"].update(model_path="", tokenizer_path="", model_arch=dict(arch, num_hidden_layers=3))
    cfg["train"].update(checkpoint_dir=str(tmp_path))
    cfg["method"]["gen_kwargs"].update(max_new_tokens=4, min_new_tokens=4)
    with pytest.raises(ValueError, match="needs 32 ranks, the world has 1"):
        PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    cfg["train"]["mesh"] = {"dp": -1, "fsdp": 1, "tp": 1}
    trainer = PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    assert isinstance(trainer.model.transformer, NeoXModel)
    assert trainer.use_hydra and trainer.branch_start == 1
