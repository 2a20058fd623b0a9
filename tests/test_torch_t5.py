"""The port's T5/UL2 model (``trlx_tpu_torch/models/t5.py`` and
``T5WithValueHead``) against the JAX package's on the same f32 weights.

- ``relative_position_bucket``: the integers equal the reference's for
  every relative distance in [-1023, 1023], both directions, at the
  fork's 32 buckets over 128 and at the tests' 8 over 16;
- ``shift_tokens_right``: exact;
- ``encode``, the teacher-forced forward (logits, values) and cached
  decode step by step (with the decoder's relative bias built per step and
  sliced from the sampler's [1, H, C, C] table): within 1e-4 of max(1,
  |reference|) — both sides compute in f32 and differ only in the order of
  their sums; relu/tied and gated-gelu/untied;
- the learned bias's gradient reaches both relative position tables, as
  ``jax.grad`` of the reference's forward gives it (1e-4 of the largest);
- the registry's ``t5``/``ul2`` family and the flax name mapping.

Module-scoped fixtures share one JAX model per architecture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_t5_models import ARCHS, VOCAB, numpy_params, port_model, prompts
from trlx_tpu.models import t5 as jt5
from trlx_tpu_torch.models import t5 as tt5
from trlx_tpu_torch.models.convert import flax_to_torch

B, S, T = 3, 9, 5
TOL = 1e-4


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


@pytest.fixture(scope="module", params=list(ARCHS))
def models(request):
    jmodel, params = numpy_params(request.param)
    return request.param, jmodel, params, port_model(request.param, params)


def _inputs():
    ids, mask = prompts(B, S)
    rng = np.random.default_rng(3)
    dec = rng.integers(2, VOCAB, size=(B, T)).astype(np.int32)
    dec[:, 0] = 0  # the start token
    dec_mask = np.ones((B, T), np.int32)
    dec_mask[1, 3:] = 0
    return ids, mask, dec, dec_mask


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 16)])
def test_relative_position_bucket_is_exact(bidirectional, buckets, max_distance):
    rel = np.arange(-1023, 1024, dtype=np.int32)
    want = np.asarray(jt5.relative_position_bucket(
        jnp.asarray(rel), bidirectional, buckets, max_distance))
    got = tt5.relative_position_bucket(
        torch.from_numpy(rel).long(), bidirectional, buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)
    # the [Q, K] layout RelPosBias builds
    pos = torch.arange(40)
    grid = tt5.relative_position_bucket(pos[None] - pos[:, None], bidirectional,
                                        buckets, max_distance)
    jpos = jnp.arange(40)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jt5.relative_position_bucket(
        jpos[None] - jpos[:, None], bidirectional, buckets, max_distance)))


def test_shift_tokens_right_is_exact():
    ids = np.array([[5, 6, -100, 7], [-100, 1, 2, 3]], np.int32)
    want = np.asarray(jt5.shift_tokens_right(jnp.asarray(ids), 0, 9))
    got = tt5.shift_tokens_right(torch.from_numpy(ids), 0, 9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_state_dict_covers_the_flax_tree(models):
    name, _, params, tmodel = models
    converted = flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    assert set(converted) == set(tmodel.state_dict())
    assert ("t5.lm_head.weight" in converted) == (name == "gated_untied")
    assert "t5.dec.1.EncDecAttention.o.weight" in converted
    assert "t5.enc_rel_bias.relative_attention_bias.weight" in converted


def test_encode_matches_jax(models):
    _, jmodel, params, tmodel = models
    ids, mask, _, _ = _inputs()
    want = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                        method=jmodel.encode)
    got = tmodel.encode(torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got, want)


def test_teacher_forced_forward_matches_jax(models):
    _, jmodel, params, tmodel = models
    ids, mask, dec, dec_mask = _inputs()
    want = jmodel.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                        decoder_input_ids=jnp.asarray(dec),
                        decoder_attention_mask=jnp.asarray(dec_mask))
    got = tmodel(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                 decoder_input_ids=torch.from_numpy(dec),
                 decoder_attention_mask=torch.from_numpy(dec_mask))
    for key in ("logits", "values", "encoder_hidden"):
        _close(got[key], want[key])


@pytest.mark.parametrize("table", [False, True], ids=["per_step_bias", "sliced_table"])
def test_cached_decode_matches_jax(models, table):
    _, jmodel, params, tmodel = models
    ids, mask, dec, _ = _inputs()
    p = {"params": params}
    jenc = jmodel.apply(p, jnp.asarray(ids), jnp.asarray(mask), method=jmodel.encode)
    jxkv = jmodel.apply(p, jenc, method=jmodel.init_cross_kv)
    jcache = jt5.init_t5_cache(jmodel.config, B, T)
    with torch.no_grad():
        tenc = tmodel.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        txkv = tmodel.init_cross_kv(tenc)
        tcache = tt5.init_t5_cache(tmodel.config, B, T)
        rel = tmodel.decoder_rel_bias(T) if table else None
        slots = np.arange(T)[None]
        for t in range(T):
            dmask = (slots <= t).astype(np.int32).repeat(B, 0)
            want = jmodel.apply(p, jnp.asarray(dec[:, t:t + 1]), encoder_mask=jnp.asarray(mask),
                                decoder_mask=jnp.asarray(dmask), cache=jcache, cache_index=t,
                                cross_kv=jxkv, method=jmodel.decode)
            jcache = want["cache"]
            got = tmodel.decode(torch.from_numpy(dec[:, t:t + 1]).long(),
                                encoder_mask=torch.from_numpy(mask),
                                decoder_mask=torch.from_numpy(dmask), cache=tcache,
                                cache_index=t, cross_kv=txkv, rel_bias=rel)
            for key in ("logits", "values"):
                _close(got[key], want[key])


def test_learned_bias_gradient_reaches_the_tables(models):
    """d(loss)/d(relative position tables) through the port's
    FlashAttention (the plain backward's dbias on the CPU) against
    ``jax.grad`` of the reference's forward (XLA's einsum path)."""
    _, jmodel, params, tmodel = models
    ids, mask, dec, dec_mask = _inputs()
    w = np.random.default_rng(4).normal(size=(B, T, VOCAB)).astype(np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                           decoder_input_ids=jnp.asarray(dec),
                           decoder_attention_mask=jnp.asarray(dec_mask))
        return (out["logits"] * w).sum() + out["values"].sum()

    jgrads = jax.grad(jloss)(params)["t5"]
    tmodel.zero_grad()
    out = tmodel(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                 decoder_input_ids=torch.from_numpy(dec),
                 decoder_attention_mask=torch.from_numpy(dec_mask))
    ((out["logits"] * torch.from_numpy(w)).sum() + out["values"].sum()).backward()
    for table in ("enc_rel_bias", "dec_rel_bias"):
        want = np.asarray(jgrads[table]["relative_attention_bias"]["embedding"])
        got = getattr(tmodel.t5, table).relative_attention_bias.weight.grad
        assert float(np.abs(want).max()) > 1e-3  # the table does get a gradient
        _close(got, want)


def test_registry_has_the_seq2seq_family():
    from trlx_tpu_torch.models.registry import get_model_family

    for name in ("t5", "UL2"):
        family = get_model_family(name)
        assert family.is_seq2seq and family.config_cls is tt5.T5Config
    assert not get_model_family("gpt2").is_seq2seq
    cfg = tt5.T5Config.from_dict({"feed_forward_proj": "gated-gelu", "unknown": 1})
    assert cfg.is_gated_act and not tt5.T5Config().is_gated_act
