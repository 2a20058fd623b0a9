"""The port's GPT-Neo (``trlx_tpu_torch/models/gpt_neo.py``) against the JAX
package's on the same weights, carried across by ``models/convert.py``.

Tiny f32 models with GPT-Neo 1.3B's head geometry (width 256, 2 heads of
128) and its alternating layers (4 blocks: global, local, global, local)
at a window of 5, so that sequences of up to 16 tokens make the local band
truncate; weights at GPT-Neo's init scale (:func:`_perturbed` says why),
inputs from numpy seeds:

- the policy's logits and values without a cache, with and without left
  padding, also ``last_only`` (1e-5), and the parameter gradients through
  ``response_forward`` over the tied head (1e-5 of each tensor's largest
  gradient, at least 1: two f32 summation orders differ by ~1e-6 of it);
- a prefill and a decode step through the linear cache and through the
  paged cache (rotated block tables, per-row cache indices, one row
  parked at the discard sentinel), against the JAX model, its K/V buffers
  included, and against the port's full forward of the whole sequence:
  1e-5;
- the hydra arguments (``capture_hidden_at``, ``start_layer``,
  ``hidden_override``) at every block, two of them local, and the branch,
  which holds ``wte`` and ``ln_f`` but no ``wpe``: 1e-5;
- ``local_causal_bias`` against the JAX one bit for bit, with a scalar and
  a [B] offset; a [B, Q] offset (the verify step's) raises in both;
- the HF loader: a tiny ``GPTNeoForCausalLM`` written with
  ``save_pretrained`` (safetensors and ``.bin``), with the two attention
  buffers of older checkpoints added, gives the JAX loader's tensors bit
  for bit; the port against HF's forward at the JAX package's own bounds
  (``tests/test_gpt_neo_parity.py``: atol 3e-4, rtol 2e-3);
- the fixed sampler, greedy and under the JAX sampler's Gumbel draws, and
  the continuous engine behind both packages' ``InferenceServer``, greedy,
  with the monolithic and the chunked prefill: the same tokens;
- ``spec_decode`` on a config with local layers is refused by name, by the
  server and by the trainer; on an all-global GPT-Neo it builds;
- two greedy PPO ``learn()`` phases with ``num_layers_unfrozen: 2`` (a
  2-block hydra reference, one global and one local block; the bottom two
  blocks, ``wte`` and ``wpe`` frozen) through both packages: the same
  rollouts, reference logprobs within 1e-5, the final parameters within
  ``tests/_torch_ppo_phase.py``'s bounds, frozen leaves bit-identical with
  no Adam state.
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
from trlx_tpu.models import gpt_neo as jneo
from trlx_tpu.models.heads import CausalLMWithValueHead as JPolicy
from trlx_tpu.ops import sampling as js
from trlx_tpu_torch.inference import kv_cache as tkv
from trlx_tpu_torch.models import gpt_neo as tneo
from trlx_tpu_torch.models.convert import flax_to_torch
from trlx_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel, init_gpt_neo_cache
from trlx_tpu_torch.models.heads import CausalLMWithValueHead
from trlx_tpu_torch.ops import sampling as ts

LAYERS = ("global", "local", "global", "local")
ARCH = dict(vocab_size=301, max_position_embeddings=64, hidden_size=256, num_layers=4,
            num_heads=2, window_size=5, attention_layers=LAYERS, dtype="float32",
            param_dtype="float32")
HD = ARCH["hidden_size"] // ARCH["num_heads"]  # 128, GPT-Neo 1.3B's head dim
B, Q, R, BS = 3, 10, 4, 2
CAP = Q + R
TOL = 1e-5


def _perturbed(params, seed=0):
    """Weights and embeddings drawn at GPT-Neo's own init scale, N(0, 0.02)
    (HF's ``initializer_range``, the port's ``init_params``), and the
    biases and layer-norm parameters perturbed by 0.05 (flax's zero biases
    would hide a bias mix-up). GPT-Neo does not scale its logits: at
    flax's default init plus the perturbation they reach ~74 at width 256,
    where f32 summation order alone moves the outputs by ~1e-4 (each
    package's f32 forward lies that far from an f64 one)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        noise = rng.normal(size=a.shape).astype(np.float32)
        if path[-1].key in ("kernel", "embedding"):
            return 0.02 * noise
        return np.asarray(a) + 0.05 * noise

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def models():
    jmodel = JPolicy(jneo.GPTNeoConfig(**ARCH), backbone_cls=jneo.GPTNeoModel)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = CausalLMWithValueHead(GPTNeoConfig(**ARCH), GPTNeoModel, device="cpu")
    tmodel.load_state_dict(flax_to_torch(params))
    return jmodel, params, tmodel


def _prompts(q=Q, padded=True):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, ARCH["vocab_size"], size=(B, q)).astype(np.int32)
    lens = np.array([q, 3, 7]) if padded else np.full(B, q)
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
    assert {"transformer.wpe.weight", "transformer.h.1.attn.out_proj.bias",
            "transformer.h.3.attn.q_proj.weight", "transformer.h.3.mlp.c_fc.bias"} <= set(converted)
    assert not any(n.endswith(("q_proj.bias", "k_proj.bias", "v_proj.bias")) for n in converted)
    assert not any("lm_head" in n for n in converted)  # the head is tied to wte
    k = params["transformer"]["h_1"]["attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(converted["transformer.h.1.attn.q_proj.weight"].numpy(), k.T)
    cfg = tmodel.config
    assert cfg.head_dim == 128 and cfg.layer_types == LAYERS
    assert (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_positions) == (4, 256, 2, 64)


def test_config_expands_hf_attention_types():
    cfg = GPTNeoConfig.from_dict({"num_layers": 4, "attention_types": [[["global", "local"], 2]]})
    assert cfg.layer_types == LAYERS
    assert GPTNeoConfig().layer_types == ("global",) * 24  # no types: all global
    with pytest.raises(ValueError, match="expands to 2 layers, expected 4"):
        GPTNeoConfig.from_dict({"num_layers": 4, "attention_types": [[["global", "local"], 1]]})


@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "left_padded"])
def test_forward_without_cache_matches_jax(models, padded, last_only):
    jmodel, params, tmodel = models
    ids, mask = _prompts(q=14, padded=padded)
    j = _apply_jax(jmodel, params, ids, mask, last_only=last_only)
    t = _apply_port(tmodel, ids, mask, last_only=last_only)
    _close(t["logits"], j["logits"])
    _close(t["values"], j["values"])


def test_response_forward_gradients_match_jax(models):
    """Parameter gradients through ``response_forward`` (the PPO update's
    forward) against ``jax.grad``: the tied head, the learned positions,
    the unscaled logits and both layer types (16 columns, window 5). f32;
    1e-5 of each tensor's largest gradient (at least 1)."""
    jmodel, params, tmodel = models
    ids, mask = _prompts()
    rng = np.random.default_rng(3)
    resp = rng.integers(0, ARCH["vocab_size"], size=(B, 6)).astype(np.int32)
    full_ids = np.concatenate([ids, resp], 1)
    full_mask = np.concatenate([mask, np.ones((B, 6), np.int32)], 1)
    w = rng.normal(size=(B, 6)).astype(np.float32)

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
    assert np.abs(jgrads["transformer.wpe.weight"].numpy()).max() > 0


def _paged_caches(turns):
    n = ARCH["num_layers"]
    jcache = jkv.init_paged_cache(n, B, CAP, 2, HD, jnp.float32, block_size=BS)
    nb = CAP // BS
    tables = np.stack([np.roll(np.arange(nb), -t) for t in turns]).astype(np.int32)
    jcache = tuple(dict(layer, block_tables=jnp.asarray(tables)) for layer in jcache)
    tcache = tkv.init_paged_cache(n, B, CAP, 2, HD, torch.float32, block_size=BS)
    tcache[0]["block_tables"].copy_(torch.from_numpy(tables))
    return jcache, tcache


@pytest.mark.parametrize("layout", ["paged", "linear"])
def test_prefill_and_decode_match_jax_and_the_full_forward(models, layout):
    """Prefill 10 prompt columns into the cache (the local band truncates at
    5) and one decode step at column Q (for the paged cache per-row
    indices: one row at another depth, one parked at the discard
    sentinel, so the band takes a [B] offset), against the JAX model, its
    K/V buffers included, and, on the live rows, against the port's full
    forward of the whole sequence."""
    jmodel, params, tmodel = models
    ids, mask = _prompts()
    if layout == "paged":
        jcache, tcache = _paged_caches([0, 1, 3])
    else:
        jcache = jneo.init_gpt_neo_cache(jneo.GPTNeoConfig(**ARCH), B, CAP)
        tcache = init_gpt_neo_cache(GPTNeoConfig(**ARCH), B, CAP)
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
    from it on a branch that holds those blocks, ``ln_f`` and ``wte``, each
    block with its own layer's mask (the branches at blocks 1 and 3 start
    on a local layer); the positions come from the mask in both."""
    jmodel = jneo.GPTNeoModel(jneo.GPTNeoConfig(**ARCH))
    ids, mask = np.ones((3, 12), np.int32), np.ones((3, 12), np.int32)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    ids = np.random.default_rng(5).integers(0, ARCH["vocab_size"], size=ids.shape).astype(np.int32)
    mask[0, :2] = 0
    model = GPTNeoModel(GPTNeoConfig(**ARCH), device="cpu")
    model.load_state_dict(flax_to_torch(params))
    for k in range(ARCH["num_layers"]):
        jtrunk = _apply_jax(jmodel, params, ids, mask, capture_hidden_at=k)
        trunk = _apply_port(model, ids, mask, capture_hidden_at=k)
        assert trunk["hidden"] is None and trunk["logits"] is None
        _close(trunk["branch_hidden"], jtrunk["branch_hidden"])
        branch = model.hydra_branch(k)
        assert sorted(branch.h) == [str(i) for i in range(k, ARCH["num_layers"])]
        assert {n.split(".")[0] for n in branch.state_dict()} == {"wte", "h", "ln_f"}
        assert not any(p.requires_grad for p in branch.parameters())
        with torch.no_grad():
            out = branch(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long(),
                         start_layer=k, hidden_override=trunk["branch_hidden"])
        jout = jmodel.apply({"params": params}, ids, attention_mask=mask, start_layer=k,
                            hidden_override=jtrunk["branch_hidden"])
        for key in ("hidden", "logits"):
            _close(out[key], jout[key])
        _close(out["logits"], jtrunk["logits"])  # the branch equals the full pass


@pytest.mark.parametrize("offset", ["scalar", "rows"])
def test_local_causal_bias_matches_jax(offset):
    off = 3 if offset == "scalar" else np.array([0, 4, 11, 17])
    want = np.asarray(jneo.local_causal_bias(5, 20, 4, offset=jnp.asarray(off)))
    got = tneo.local_causal_bias(5, 20, 4, torch.as_tensor(off)).numpy()
    assert got.shape == want.shape == ((1, 1, 5, 20) if offset == "scalar" else (4, 1, 5, 20))
    np.testing.assert_array_equal(got, want)


def test_verify_step_offsets_are_refused_in_both_packages():
    """The speculative verify step's [B, Q] ``cache_index``: the JAX band
    fails on it (ROADMAP queue 3), and the port refuses it by name."""
    off = np.arange(15).reshape(3, 5)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jneo.local_causal_bias(5, 20, 4, offset=jnp.asarray(off))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        tneo.local_causal_bias(5, 20, 4, torch.from_numpy(off))


HF_ARCH = dict(vocab_size=301, max_position_embeddings=64, hidden_size=256, num_layers=4,
               num_heads=2, attention_types=[[["global", "local"], 2]], window_size=5,
               resid_dropout=0.0, embed_dropout=0.0, attention_dropout=0.0)


def _hf_model(perturb: bool):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.GPTNeoForCausalLM(transformers.GPTNeoConfig(**HF_ARCH)).eval()
    if perturb:
        with torch.no_grad():
            for p in model.parameters():  # zero-initialised biases would hide a mix-up
                p.add_(0.05 * torch.randn_like(p))
    return model


def _save_with_old_buffers(model, path, fmt):
    """``save_pretrained``, then the weights file rewritten with the two
    attention buffers of older checkpoints added to every layer."""
    model.save_pretrained(path, safe_serialization=fmt == "safetensors")
    p = HF_ARCH["max_position_embeddings"]
    extra = {}
    for i in range(HF_ARCH["num_layers"]):
        pre = f"transformer.h.{i}.attn.attention."
        extra[pre + "bias"] = torch.tril(torch.ones(p, p, dtype=torch.bool))[None, None]
        extra[pre + "masked_bias"] = torch.tensor(-1e9)
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
    """Both packages' loaders on one checkpoint (``transformer.`` names,
    ``attn.attention.*``, the tied ``lm_head.weight`` in the ``.bin``, and
    the two buffers of older checkpoints, which are skipped): the same
    config and tensors, bit for bit."""
    from trlx_tpu.models import conversion as jconv
    from trlx_tpu_torch.models import conversion as tconv
    from trlx_tpu_torch.models.conversion import read_hf_weights

    extra = _save_with_old_buffers(_hf_model(perturb=True), str(tmp_path), fmt)
    assert set(extra) <= set(read_hf_weights(str(tmp_path)))
    jcfg, jparams = jconv.load_gpt_neo_checkpoint(str(tmp_path))
    tcfg, state = tconv.load_gpt_neo_checkpoint(str(tmp_path))
    fields = ("vocab_size", "max_position_embeddings", "hidden_size", "num_layers",
              "num_heads", "intermediate_size", "window_size", "attention_layers",
              "layer_norm_epsilon")
    assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    assert tcfg.layer_types == LAYERS
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, {"transformer": jparams}))
    want = {n.removeprefix("transformer."): t for n, t in want.items()}
    assert set(state) == set(want)
    assert not any(n.endswith(("attn.bias", "masked_bias")) or "lm_head" in n for n in state)
    for name, t in state.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[name]), name


def test_port_matches_hf_at_the_reference_bounds(tmp_path):
    """The port on an HF ``GPTNeoForCausalLM`` (its own init) against HF's
    forward over 13 tokens (the band truncates at 5), at the bounds the JAX
    package holds its model to (``tests/test_gpt_neo_parity.py``)."""
    from trlx_tpu_torch.models.conversion import load_gpt_neo_checkpoint

    hf = _hf_model(perturb=False)
    hf.save_pretrained(tmp_path)
    tcfg, state = load_gpt_neo_checkpoint(str(tmp_path))
    model = GPTNeoModel(dataclasses.replace(tcfg, dtype="float32"), device="cpu")
    model.load_state_dict(state)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 301, size=(2, 13)))
    with torch.no_grad():
        got, want = model(ids)["logits"].numpy(), hf(input_ids=ids).logits.numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=2e-3)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_fixed_sampler_matches_jax(models, sampled):
    """Tokens and masks exact, logprobs and values to 1e-5; sampled, the
    port is handed the JAX sampler's Gumbel draws. 10 + 6 columns: the
    band truncates in the prefill and at every decode step."""
    jmodel, params, tmodel = models
    kw = dict(do_sample=sampled, max_new_tokens=R + 2, eos_token_id=3, pad_token_id=300)
    jcfg, tcfg = js.GenerationConfig.from_dict(kw), ts.GenerationConfig.from_dict(kw)
    ids, mask = _prompts()

    def apply_fn(p, input_ids, **k):
        return jmodel.apply({"params": p}, input_ids, **k)

    jsampler = js.make_sampler(
        apply_fn, functools.partial(jneo.init_gpt_neo_cache, jneo.GPTNeoConfig(**ARCH)), jcfg, Q)
    rng = jax.random.PRNGKey(7)
    jout = jax.jit(jsampler)(params, jnp.asarray(ids), jnp.asarray(mask), rng)
    keys, r = [], rng
    for _ in range(jcfg.max_new_tokens):
        r, k = jax.random.split(r)
        keys.append(k)
    noise = [np.array(jax.random.gumbel(k, (B, ARCH["vocab_size"]), jnp.float32)) for k in keys]
    tsampler = ts.make_sampler(tmodel, functools.partial(init_gpt_neo_cache, tmodel.config),
                               tcfg, Q)
    tout = tsampler(torch.from_numpy(ids), torch.from_numpy(mask),
                    noise_fn=lambda t: torch.from_numpy(noise[t]))
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.response_mask.numpy(), np.asarray(jout.response_mask))
    for key in ("logprobs", "values"):
        np.testing.assert_allclose(getattr(tout, key).numpy(), np.asarray(getattr(jout, key)),
                                   atol=TOL, rtol=0)


def _server_config(prefill_chunk=0, spec_decode=None, **arch):
    from trlx_tpu.analysis import harness

    cfg = harness.tiny_config_dict("ppo")
    model_arch = {k: v for k, v in ARCH.items() if k not in ("dtype", "param_dtype")}
    cfg["model"] = {"model_type": "gpt_neo",
                    "model_arch": {**model_arch, "attention_layers": list(LAYERS), **arch}}
    rollout = {"engine": "continuous", "slots": 8, "admit_width": 2, "harvest_width": 2,
               "block_size": 4, "prefill_chunk": prefill_chunk}
    if spec_decode:
        rollout["spec_decode"] = spec_decode
    # no tp axis (the JAX server would shard the 301-wide vocab over it), so
    # the JAX engine rounds its widths to the 8 CPU devices' dp: 8 slots
    cfg["train"].update(seq_length=12, dtype="float32", mesh={"dp": -1, "fsdp": 1, "tp": 1},
                        rollout=rollout)
    cfg["method"]["gen_kwargs"].update(max_new_tokens=R, do_sample=False,
                                       eos_token_id=3, pad_token_id=300)
    return cfg


@pytest.mark.parametrize("prefill_chunk", [0, 4], ids=["monolithic", "chunked"])
def test_continuous_engine_servers_give_the_same_tokens(prefill_chunk):
    """Both packages' ``InferenceServer`` over the continuous engine and the
    paged cache, greedy, on the same weights: the same tokens per request.
    12 prompt columns and 4 new tokens at window 5: the band truncates in
    the admission prefill (monolithic, or in 4-column chunks over the
    narrowed prompt view with an int offset) and at every decode step (a
    [B] offset per slot)."""
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.inference.server import InferenceServer as JServer
    from trlx_tpu_torch.inference.server import InferenceServer as TServer

    jserver = JServer(TRLConfig.from_dict(_server_config(prefill_chunk)))
    params = flax_to_torch(jax.tree_util.tree_map(np.asarray, jserver.params))
    tserver = TServer(_server_config(prefill_chunk), params=params, device="cpu")
    assert isinstance(tserver.model.transformer, GPTNeoModel)
    assert tserver.engine.prefill_chunk == prefill_chunk
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(4, 300, int(rng.integers(1, 13)))]
               for _ in range(10)]
    want, got = jserver.generate(prompts), tserver.generate(prompts)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g["length"] for g in got] == [w["length"] for w in want]
    stats = tserver.stats()
    assert stats["engine/completed"] == 10
    assert (stats["engine/prefill_chunks"] > 0) == bool(prefill_chunk)


def test_spec_decode_with_local_layers_is_refused(tmp_path):
    """``rollout.spec_decode`` on a GPT-Neo with local layers is refused by
    name, by the server and by the trainer, before any engine is built; an
    all-global GPT-Neo takes it."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.inference.server import InferenceServer
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    spec = {"enabled": True, "max_draft": 2}
    with pytest.raises(NotImplementedError, match="spec_decode.*local.*ROADMAP queue 3"):
        InferenceServer(_server_config(spec_decode=spec), device="cpu")
    cfg = _ppo_config(tmp_path)
    cfg["train"]["rollout"] = {"engine": "continuous", "spec_decode": spec}
    with pytest.raises(NotImplementedError, match="spec_decode.*local.*ROADMAP queue 3"):
        PPOTrainer(TRLConfig.from_dict(cfg), device="cpu")
    server = InferenceServer(
        _server_config(spec_decode=spec, attention_layers=["global"] * 4), device="cpu")
    assert server.engine.spec_max_draft == 2


def _ppo_config(tmp_path):
    arch = {k: v for k, v in ARCH.items() if k not in ("dtype", "param_dtype")}
    return config(tmp_path, model={"model_type": "gpt_neo",
                                   "model_arch": dict(arch, attention_layers=list(LAYERS)),
                                   "num_layers_unfrozen": 2},
                  train={"total_steps": 8, "epochs": 2})


@pytest.fixture(scope="module")
def ppo_runs(tmp_path_factory):
    """Both packages' two phases from the JAX trainer's initial parameters,
    its backbone drawn at GPT-Neo's init scale (:func:`_perturbed`)."""
    from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer

    init_params = JPPOTrainer._init_params

    def at_gpt_neo_scale(self, rng):
        params = init_params(self, rng)
        return dict(params, transformer=_perturbed(params["transformer"], seed=2))

    tmp_path = tmp_path_factory.mktemp("gpt_neo_ppo")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPPOTrainer, "_init_params", at_gpt_neo_scale)
        jax_run = run_jax(_ppo_config(tmp_path / "jax"))
    cfg = _ppo_config(tmp_path / "port")
    return cfg, jax_run, run_port(port_trainer(cfg, jax_run["init"]))


def test_ppo_phases_rollouts_and_refs_match(ppo_runs):
    """Two collect phases (16 rollouts each, 6 + 7 columns over window 5):
    the same rollouts and rewards, reference logprobs within 1e-5, and the
    reference the 2-block hydra branch (blocks 2 and 3: one global, one
    local) with ``wte`` and ``ln_f``."""
    _, jax_run, port_run = ppo_runs
    trainer = port_run["trainer"]
    assert trainer.use_hydra and trainer.branch_start == 2 and trainer.step == 8
    assert len(jax_run["phase_rows"]) == 2
    names = set(trainer.ref.state_dict())
    assert names == jax_run["ref_names"]
    assert {n.split(".")[0] for n in names} == {"wte", "h", "ln_f"}
    assert {n.split(".")[1] for n in names if n.startswith("h.")} == {"2", "3"}
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(port_run["buffer"][key], jax_run["buffer"][key], err_msg=key)
    for key in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(port_run["buffer"][key], jax_run["buffer"][key],
                                   atol=TOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(port_run["ref"], jax_run["ref"], atol=TOL, rtol=0)


def test_ppo_phases_final_params_and_frozen_leaves(ppo_runs):
    cfg, jax_run, port_run = ppo_runs
    trainer = port_run["trainer"]
    state = trainer.model.state_dict()
    assert assert_final_params_match(state, jax_run, cfg, noisy=port_run["noisy"]) > 1e-4
    init = flax_to_torch(jax_run["init"])
    frozen = {n for n, p in trainer.model.named_parameters() if not p.requires_grad}
    assert frozen == {n for n in init if n.startswith(
        ("transformer.h.0.", "transformer.h.1.", "transformer.wte.", "transformer.wpe."))}
    for n in frozen:
        assert torch.equal(state[n], init[n]), n
    for n in init:
        if n.startswith(("transformer.h.2.", "transformer.h.3.", "transformer.ln_f.", "v_head.")):
            assert not torch.equal(state[n], init[n]), n
    named = dict(trainer.model.named_parameters())
    with_state = {id(p) for p in trainer.opt.adamw.state}
    assert with_state == {id(named[n]) for n in init if n not in frozen}
