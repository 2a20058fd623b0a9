"""The port's int8 KV cache against the JAX package's (CPU, numpy-seeded
inputs, tiny widths).

Held, with their tolerances:

- ``quantize_kv``: the int8 values and the bf16 scales bit for bit, from
  f32 and bf16 inputs, with all-zero (token, head) rows, exact ties of the
  scale and +-absmax;
- ``write_cache`` on a linear int8 cache (a prefill, then a step into a
  narrowed view) and ``paged_write_read`` on a paged one (rotated block
  tables, a shared-prefix pool that one row publishes into and another
  reads from): the stored values and scales bit for bit, the view the
  attention reads (the port's ``QuantizedKV`` dequantized) to 1e-6 of the
  JAX package's dequantized view (f32);
- a greedy fixed-sampler rollout on an int8 cache, GPT-2 and GPT-J, and
  both packages' ``InferenceServer`` over the continuous engine with an
  int8 cache, the int8 prefix pool and chunked prefill: the same tokens;
  logprobs and values to 1e-5 (f32);
- ``resolve_kv_cache_dtype`` against the port's own
  ``INT8_KV_MAX_CAPACITY``, and ``"auto"`` through every causal family's
  ``init_cache``.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.inference import kv_cache as jkv
from trlx_tpu.models import gpt2 as jg
from trlx_tpu.ops import sampling as js
from trlx_tpu_torch.inference import kv_cache as tkv
from trlx_tpu_torch.models import gpt2 as tg
from trlx_tpu_torch.models.convert import flax_to_torch
from trlx_tpu_torch.ops import sampling as ts
from trlx_tpu_torch.ops.attention import QuantizedKV

TOL = 1e-5


def _edge_inputs(seed, shape=(3, 5, 2, 24)):
    """Values with the quantizer's edges: an all-zero (token, head), a row
    of exact ties (absmax 127/16, so the scale is exactly 1/16 and every
    other value is (i + 1/2) scales), and a row at +-absmax."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    D = shape[-1]
    x[0, 0, 0] = 0.0
    ties = (np.arange(D) % 100 + 0.5) / 16
    ties[0] = 127 / 16
    x[0, -1, -1] = ties * (1 - 2 * (np.arange(D) % 2))
    x[-1, 0, 0] = np.where(np.arange(D) < D // 2, 4.0, -4.0)
    return x


def _bits(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(dtype):
    x = _edge_inputs(0)
    jq, js_ = jg.quantize_kv(jnp.asarray(x).astype(dtype))
    tq, ts_ = tg.quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts_.dtype == torch.bfloat16 and ts_.shape == (3, 5, 2, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts_), _bits(js_))
    # the edges are what they claim: a zero row, ties, and +-127
    assert (tq[0, 0, 0] == 0).all() and ts_[0, 0, 0].item() == pytest.approx(1e-8 / 127, rel=1e-2)
    assert tq[0, -1, -1, 0].item() == 127 and tq[0, -1, -1, 1].item() == -2  # 1.5 -> 2
    assert tq[-1, 0, 0].abs().eq(127).all()


def _int8_layers(n, B, C, H, D):
    return (jg.kv_buffers(n, B, C, H, D, jnp.float32, "int8"),
            tg.kv_buffers(n, B, C, H, D, torch.float32, "int8"))


def _assert_view(t_view, j_view):
    assert isinstance(t_view, QuantizedKV)
    np.testing.assert_allclose(t_view.dequantize().numpy(), np.asarray(j_view), atol=1e-6, rtol=0)


def test_linear_write_cache_matches_jax():
    B, C, H, D = 3, 12, 2, 24
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (jl,), (tl,) = _int8_layers(1, B, C, H, D)
    for index, T, view_len in ((0, 5, None), (5, 1, 8)):
        k = _edge_inputs(10 + index, (B, T, H, D))
        v = _edge_inputs(20 + index, (B, T, H, D))
        jk, jv, jl = jg.write_cache(jl, jnp.asarray(k), jnp.asarray(v), index, jnp.float32,
                                    view_len)
        tk, tv = tg.write_cache(tl, torch.from_numpy(k), torch.from_numpy(v), index,
                                torch.float32, view_len)
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(_bits(tl[key]), _bits(jl[key]), err_msg=key)
        _assert_view(tk, jk)
        _assert_view(tv, jv)
        assert tk.values.shape[1] == (view_len or C)


def _paged_pair(B, cap, H, D, bs, pool_blocks, seed):
    """Both packages' int8 paged layers on the same contents: rotated block
    tables, random private regions, a random pool."""
    rng = np.random.default_rng(seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jl = dict(jkv.init_paged_cache(1, B, cap, H, D, jnp.float32, "int8", bs)[0])
        tl = tkv.init_paged_cache(1, B, cap, H, D, torch.float32, "int8", bs)[0]
    jl.update(jkv.init_shared_pool(pool_blocks, bs, H, D, jnp.float32, "int8"))
    tl.update(tkv.init_shared_pool(pool_blocks, bs, H, D, torch.float32, "int8"))
    tables = np.array(jkv.rotate_block_table(jl["block_tables"], 1))
    jl["block_tables"], tl["block_tables"] = jnp.asarray(tables), torch.from_numpy(tables)
    for key, n in (("k", cap), ("v", cap)):
        q = rng.integers(-127, 128, size=(B, n, H, D)).astype(np.int8)
        s = rng.uniform(0.01, 0.1, size=(B, n, H, 1)).astype(np.float32)
        jl[key], jl[key + "_scale"] = jnp.asarray(q), jnp.asarray(s).astype(jnp.bfloat16)
        tl[key][:, :cap] = torch.from_numpy(q)
        tl[key + "_scale"][:, :cap] = torch.from_numpy(s).bfloat16()
        pq = rng.integers(-127, 128, size=(pool_blocks * bs, H, D)).astype(np.int8)
        ps = rng.uniform(0.01, 0.1, size=(pool_blocks * bs, H, 1)).astype(np.float32)
        jl["shared_" + key] = jnp.asarray(pq)
        jl["shared_" + key + "_scale"] = jnp.asarray(ps).astype(jnp.bfloat16)
        tl["shared_" + key][:-1] = torch.from_numpy(pq)
        tl["shared_" + key + "_scale"][:-1] = torch.from_numpy(ps).bfloat16()
    return jl, tl


def test_paged_write_read_with_the_shared_pool_matches_jax():
    """Row 0 publishes its first two blocks into pool blocks 2 and 0; row 1
    reads its first block from pool block 1 (its own write there drops) and
    publishes nothing; row 2 is private. A prefill at per-row depths, then
    a decode step into a narrowed view."""
    B, cap, H, D, bs, P = 3, 12, 2, 16, 4, 3
    jl, tl = _paged_pair(B, cap, H, D, bs, P, seed=5)
    shared = np.array([[-1, -1, -1], [1, -1, -1], [-1, -1, -1]], np.int32)
    publish = np.array([[2, 0, -1], [-1, -1, -1], [-1, -1, -1]], np.int32)
    for key, table in (("shared_tables", shared), ("publish_tables", publish)):
        jl[key], tl[key] = jnp.asarray(table), torch.from_numpy(table)
    for index, T, view_len in ((np.array([0, 0, 2]), 8, 0), (np.array([8, 8, 10]), 1, 11)):
        k = _edge_inputs(30 + T, (B, T, H, D))
        v = _edge_inputs(40 + T, (B, T, H, D))
        jk, jv, jl = jkv.paged_write_read(jl, jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(index), jnp.float32, view_len)
        tk, tv = tkv.paged_write_read(tl, torch.from_numpy(k), torch.from_numpy(v),
                                      torch.from_numpy(index), torch.float32, view_len)
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(_bits(tl[key][:, :cap]), _bits(jl[key]), err_msg=key)
            np.testing.assert_array_equal(_bits(tl["shared_" + key][:-1]),
                                          _bits(jl["shared_" + key]), err_msg="shared_" + key)
        _assert_view(tk, jk)
        _assert_view(tv, jv)
    # the pool took row 0's published blocks, and row 1 read pool block 1
    assert not np.array_equal(_bits(tl["shared_k"][2 * bs:3 * bs]), 0)


def _family(name):
    if name == "gpt2":
        from trlx_tpu.models.gpt2 import GPT2Config as JC
        from trlx_tpu.models.gpt2 import GPT2Model as JM
        from trlx_tpu.models.gpt2 import init_cache as jinit
        from trlx_tpu_torch.models.gpt2 import GPT2Config as TC
        from trlx_tpu_torch.models.gpt2 import GPT2Model as TM
        from trlx_tpu_torch.models.gpt2 import init_cache as tinit

        arch = dict(vocab_size=40, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    else:
        from trlx_tpu.models.gptj import GPTJConfig as JC
        from trlx_tpu.models.gptj import GPTJModel as JM
        from trlx_tpu.models.gptj import init_gptj_cache as jinit
        from trlx_tpu_torch.models.gptj import GPTJConfig as TC
        from trlx_tpu_torch.models.gptj import GPTJModel as TM
        from trlx_tpu_torch.models.gptj import init_gptj_cache as tinit

        arch = dict(vocab_size=40, n_positions=64, n_embd=32, n_layer=2, n_head=2,
                    rotary_dim=8)
    arch.update(dtype="float32", param_dtype="float32", kv_cache_dtype="int8")
    return arch, (JC, JM, jinit), (TC, TM, tinit)


@pytest.mark.parametrize("family", ["gpt2", "gptj"])
def test_fixed_sampler_on_an_int8_cache_matches_jax(family):
    from trlx_tpu.models.heads import CausalLMWithValueHead as JPolicy
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead

    arch, (JC, JM, jinit), (TC, TM, tinit) = _family(family)
    jmodel = JPolicy(JC(**arch), backbone_cls=JM)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    tmodel = CausalLMWithValueHead(TC(**arch), TM, device="cpu")
    tmodel.load_state_dict(flax_to_torch(params))
    B, Q = 3, 6
    kw = dict(do_sample=False, max_new_tokens=6, eos_token_id=3, pad_token_id=39)
    jcfg, tcfg = js.GenerationConfig.from_dict(kw), ts.GenerationConfig.from_dict(kw)
    ids = rng.integers(0, 39, size=(B, Q)).astype(np.int32)
    mask = (np.arange(Q)[None] >= Q - np.array([Q, 2, 4])[:, None]).astype(np.int32)
    ids = ids * mask

    def apply_fn(p, input_ids, **k):
        return jmodel.apply({"params": p}, input_ids, **k)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsampler = js.make_sampler(apply_fn, functools.partial(jinit, JC(**arch)), jcfg, Q)
        jout = jax.jit(jsampler)(params, jnp.asarray(ids), jnp.asarray(mask),
                                 jax.random.PRNGKey(7))
        tsampler = ts.make_sampler(tmodel, functools.partial(tinit, tmodel.config), tcfg, Q)
        cache = tinit(tmodel.config, B, Q + 6)
        tout = tsampler(torch.from_numpy(ids), torch.from_numpy(mask))
    assert cache[0]["k"].dtype == torch.int8
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.response_mask.numpy(), np.asarray(jout.response_mask))
    for key in ("logprobs", "values"):
        np.testing.assert_allclose(getattr(tout, key).numpy(), np.asarray(getattr(jout, key)),
                                   atol=TOL, rtol=0, err_msg=key)


def _server_config(family):
    from trlx_tpu.analysis import harness

    arch, *_ = _family(family)
    cfg = harness.tiny_config_dict("ppo")
    cfg["model"] = {"model_type": family,
                    "model_arch": {k: v for k, v in arch.items()
                                   if k not in ("dtype", "param_dtype")}}
    cfg["train"].update(
        seq_length=16, dtype="float32",
        rollout={"engine": "continuous", "slots": 8, "admit_width": 4, "harvest_width": 4,
                 "block_size": 4, "prefill_chunk": 8},
        serving={"prefix_cache_blocks": 8})
    cfg["method"]["gen_kwargs"].update(max_new_tokens=6, do_sample=False, eos_token_id=3,
                                       pad_token_id=39)
    return cfg


@pytest.mark.parametrize("family", ["gpt2", "gptj"])
def test_servers_on_an_int8_cache_and_pool_give_the_same_tokens(family):
    """Both packages' ``InferenceServer`` (continuous engine, paged int8
    cache, the int8 prefix pool, chunked prefill; prompts sharing a
    12-token system prefix, so blocks are published and read), greedy, on
    the same weights: the same tokens per request."""
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.inference.server import InferenceServer as JServer
    from trlx_tpu_torch.inference.server import InferenceServer as TServer

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jserver = JServer(TRLConfig.from_dict(_server_config(family)))
        params = flax_to_torch(jax.tree_util.tree_map(np.asarray, jserver.params))
        tserver = TServer(_server_config(family), params=params, device="cpu")
        layer = tserver.engine.init_state().cache[0]
        assert layer["k"].dtype == torch.int8 and layer["shared_k"].dtype == torch.int8
        rng = np.random.default_rng(4)
        system = [int(t) for t in rng.integers(4, 39, 12)]
        prompts = [system + [int(t) for t in rng.integers(4, 39, int(rng.integers(1, 4)))]
                   for _ in range(8)]
        prompts += [[int(t) for t in rng.integers(4, 39, int(rng.integers(1, 16)))]
                    for _ in range(4)]
        want, got = jserver.generate(prompts), tserver.generate(prompts)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert tserver.stats()["prefix_pool/hits"] > 0


def test_resolve_kv_cache_dtype_against_the_ports_threshold():
    cap = tg.INT8_KV_MAX_CAPACITY
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cap > 0:
            assert tg.resolve_kv_cache_dtype("auto", cap) == "int8"
            assert tg.resolve_kv_cache_dtype("int8", cap) == "int8"
        assert tg.resolve_kv_cache_dtype("auto", cap + 1) == "bfloat16"
        assert tg.resolve_kv_cache_dtype("bfloat16", 1 << 20) == "bfloat16"
    assert not caught
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert tg.resolve_kv_cache_dtype("int8", cap + 1) == "int8"  # honoured
    assert len(caught) == 1 and "SLOWER" in str(caught[0].message)


@pytest.mark.parametrize("family", ["gpt2", "gptj", "gpt_neox", "gpt_neo", "gpt2_moe"])
def test_auto_resolves_per_family_at_the_capacity(family):
    """``"auto"`` through each causal family's ``init_cache`` allocates the
    layout the threshold gives at that capacity, and the engine's discard
    position does not move it."""
    from trlx_tpu_torch.models.registry import get_model_family

    fam = get_model_family(family)
    arch = {
        "gpt2": dict(vocab_size=32, n_positions=64, n_embd=16, n_layer=2, n_head=2),
        "gpt2_moe": dict(vocab_size=32, n_positions=64, n_embd=16, n_layer=2, n_head=2),
        "gptj": dict(vocab_size=32, n_positions=64, n_embd=16, n_layer=2, n_head=2,
                     rotary_dim=4),
        "gpt_neox": dict(vocab_size=32, max_position_embeddings=64, hidden_size=16,
                         num_hidden_layers=2, num_attention_heads=2),
        "gpt_neo": dict(vocab_size=32, max_position_embeddings=64, hidden_size=16,
                        num_layers=2, num_heads=2, window_size=8),
    }[family]
    cfg = fam.config_cls.from_dict(dict(arch, kv_cache_dtype="auto", dtype="float32"))
    cap = max(tg.INT8_KV_MAX_CAPACITY, 1)
    for capacity in (cap, cap + 1):
        want = tg.resolve_kv_cache_dtype("auto", capacity)
        for extra in (0, 1):
            layer = fam.init_cache(cfg, 1, capacity, extra_positions=extra)[0]
            assert layer["k"].shape[1] == capacity + extra
            assert ("k_scale" in layer) == (want == "int8"), (capacity, extra)
