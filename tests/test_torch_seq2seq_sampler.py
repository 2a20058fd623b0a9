"""The port's seq2seq sampler (``ops/sampling.py::make_seq2seq_sampler``)
against the JAX package's on the same T5 policy and prompts.

Tiny f32 gated-GELU T5 (the UL2 architecture) with a value head; prompts
left-padded from a numpy seed. Greedy decoding, and sampling with the port
handed the JAX sampler's own Gumbel draws (``jax.random.categorical`` is
argmax(logits + gumbel(key)) with ``rng, key = split(rng)`` per step), must
give exactly the same tokens and masks, forced BOS, ``min_length`` (eos
held off) and ``max_length`` (rows cut, counting the start token)
included. Behaviour logprobs and values agree to 1e-5 of max(1, |ref|)
(f32; the two frameworks sum in another order, and logprobs reach -6
here), finished rows' too (the reference keeps the pad's logprob and the
step's value there). The port's logprobs and
values also equal its own teacher-forced recompute, the alignment the PPO
update relies on.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_t5_models import VOCAB, numpy_params, port_model, prompts
from trlx_tpu.models.t5 import init_t5_cache as jinit_cache
from trlx_tpu.ops import sampling as js
from trlx_tpu_torch.models.t5 import init_t5_cache as tinit_cache
from trlx_tpu_torch.models.t5 import shift_tokens_right
from trlx_tpu_torch.ops import sampling as ts
from trlx_tpu_torch.utils import logprobs_from_logits

B, S, R = 4, 9, 6
ATOL = 1e-5
EOS, PAD = 1, 0  # eos as in configs/ppo_ul2.yml

CASES = {
    "greedy": dict(do_sample=False),
    "greedy_forced_bos_min_length": dict(do_sample=False, forced_bos_token_id=7, min_length=4),
    "sample_top_k": dict(do_sample=True, top_k=6, temperature=0.8, forced_bos_token_id=7),
    "sample_max_length": dict(do_sample=True, max_length=4),
}


@pytest.fixture(scope="module")
def models():
    jmodel, params = numpy_params("gated_untied", seed=5)
    return jmodel, params, port_model("gated_untied", params)


def _gen_kwargs(name):
    return dict(CASES[name], max_new_tokens=R, eos_token_id=EOS, pad_token_id=PAD,
                decoder_start_token_id=0)


def _jax_sample(jmodel, params, ids, mask, cfg, rng):
    sampler = js.make_seq2seq_sampler(
        lambda p, i, m: jmodel.apply({"params": p}, i, m, method=jmodel.encode),
        lambda p, i, **kw: jmodel.apply({"params": p}, i, method=jmodel.decode, **kw),
        lambda p, e: jmodel.apply({"params": p}, e, method=jmodel.init_cross_kv),
        functools.partial(jinit_cache, jmodel.config),
        cfg,
    )
    return jax.jit(sampler)(params, jnp.asarray(ids), jnp.asarray(mask), rng)


def _split_chain_noise(rng):
    """The reference's per-step draws: ``rng, key = split(rng)`` each step,
    Gumbel noise of the logits' shape under ``key``."""
    noise = []
    for _ in range(R):
        rng, key = jax.random.split(rng)
        noise.append(np.array(jax.random.gumbel(key, (B, VOCAB), jnp.float32)))
    return noise


@pytest.mark.parametrize("name", list(CASES))
def test_seq2seq_sampler_matches_jax(models, name):
    jmodel, params, tmodel = models
    kw = _gen_kwargs(name)
    jcfg, tcfg = js.GenerationConfig.from_dict(kw), ts.GenerationConfig.from_dict(kw)
    ids, mask = prompts(B, S, seed=6)
    rng = jax.random.PRNGKey(11)
    jout = _jax_sample(jmodel, params, ids, mask, jcfg, rng)
    noise = _split_chain_noise(rng)
    calls = {"encode": 0, "decode": 0}

    class Counting:
        def __getattr__(self, attr):
            fn = getattr(tmodel, attr)
            if attr not in calls:
                return fn

            def counted(*a, **k):
                calls[attr] += 1
                return fn(*a, **k)
            return counted

    sampler = ts.make_seq2seq_sampler(
        Counting(), functools.partial(tinit_cache, tmodel.config), tcfg)
    tout = sampler(torch.from_numpy(ids), torch.from_numpy(mask),
                   noise_fn=lambda t: torch.from_numpy(noise[t]))

    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.response_mask.numpy(), np.asarray(jout.response_mask))
    for key in ("logprobs", "values"):
        want = np.asarray(getattr(jout, key))
        np.testing.assert_allclose(getattr(tout, key).numpy(), want, rtol=0, err_msg=key,
                                   atol=ATOL * max(1.0, float(np.abs(want).max())))
    # one encoder pass; the start token and R - 1 decoder calls (the call
    # after the last token, whose logits nothing reads, is skipped)
    assert calls == {"encode": 1, "decode": R}
    tokens, m = tout.tokens.numpy(), tout.response_mask.numpy()
    assert m[:, 0].all()
    if "forced_bos_token_id" in kw:
        assert (tokens[:, 0] == 7).all()
    if name == "greedy_forced_bos_min_length":
        assert m[:, :3].all()  # eos held off until the 4th decoder token
    if name == "sample_max_length":
        assert m[:, :3].all() and not m[:, 3:].any()  # start + 3 tokens = 4
        assert (tokens[:, 3:] == PAD).all()
    if name == "greedy":
        assert not m.all()  # some row emitted eos and was padded after it


def test_logprobs_and_values_match_the_teacher_forced_recompute(models):
    """The emitted behaviour logprobs and values equal the port's
    teacher-forced forward on ``shift_tokens_right(response)`` under the
    decoder mask ``[1, mask[:-1]]`` (the PPO update's alignment)."""
    _, _, tmodel = models
    tcfg = ts.GenerationConfig.from_dict(_gen_kwargs("sample_top_k"))
    ids, mask = (torch.from_numpy(x) for x in prompts(B, S, seed=6))
    gen = torch.Generator()
    gen.manual_seed(3)
    out = ts.make_seq2seq_sampler(tmodel, functools.partial(tinit_cache, tmodel.config),
                                  tcfg)(ids, mask, generator=gen)
    dec_mask = torch.cat([torch.ones_like(out.response_mask[:, :1]),
                          out.response_mask[:, :-1]], 1)
    with torch.no_grad():
        res = tmodel(ids, attention_mask=mask,
                     decoder_input_ids=shift_tokens_right(out.tokens.long(), PAD, 0),
                     decoder_attention_mask=dec_mask)
    live = out.response_mask.bool()
    lp = logprobs_from_logits(res["logits"], out.tokens)
    torch.testing.assert_close(out.logprobs[live], lp[live], atol=ATOL, rtol=0)
    torch.testing.assert_close(out.values[live], res["values"][live], atol=ATOL, rtol=0)


def test_runtime_noise_comes_from_the_generator(models):
    _, _, tmodel = models
    tcfg = ts.GenerationConfig.from_dict(_gen_kwargs("sample_top_k"))
    sampler = ts.make_seq2seq_sampler(tmodel, functools.partial(tinit_cache, tmodel.config),
                                      tcfg)
    ids, mask = (torch.from_numpy(x) for x in prompts(B, S, seed=6))
    outs = []
    for seed in (5, 5, 6):
        gen = torch.Generator()
        gen.manual_seed(seed)
        outs.append(sampler(ids, mask, generator=gen).tokens)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
