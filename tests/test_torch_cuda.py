"""Card-only tests of the port's CUDA kernel path (marker ``cuda``).

They skip without a CUDA device. On a machine with an H100 run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q``
(``--noconftest`` because the suite's conftest configures JAX, which the
port's machine need not have; this file imports no JAX). They hold the
kernel against its plain version at small shapes and pin the wrapper's
contract: refusals raise and do not count, launches count one each, and
the served model runs every attention through the kernel; the backward
kernels (dQ, dK/dV) match the plain backward on the same O and LSE, and a
training step runs every attention backward through them.
"""

import pytest
import torch

from trlx_tpu_torch.ops import attention as attn
from trlx_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(dev, B, Q, K, H=2, D=64, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype) for T in (Q, K, K)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize(
    "case", ["decode", "ragged_bias", "causal", "per_head", "one_key", "all_masked"]
)
def test_kernel_matches_plain(dev, dtype, case):
    B, Q, K = {"decode": (3, 1, 70), "ragged_bias": (2, 33, 95), "causal": (2, 80, 80),
               "per_head": (1, 17, 130), "one_key": (2, 5, 1), "all_masked": (2, 9, 40)}[case]
    q, k, v = _qkv(dev, B, Q, K, dtype=dtype)
    causal = case == "causal"
    bias = None
    if case in ("decode", "ragged_bias"):
        bias = torch.randn(B, 1, Q, K, device=dev)
    elif case == "per_head":
        bias = torch.randn(1, 2, Q, K, device=dev)
    elif case == "all_masked":
        bias = attn.padding_bias(torch.zeros(B, K, dtype=torch.long, device=dev))
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, bias, causal, True)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL[dtype]
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (B, 2, Q)
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse
    # without return_lse the kernel skips the LSE write; O is the same
    assert torch.equal(fa.flash_attention(q, k, v, bias, causal), o)


def test_strided_inputs_read_in_place(dev):
    """q/k/v as views of one packed projection (the GPT-2 layout)."""
    qkv = torch.randn(2, 40, 3 * 128, device=dev)
    q, k, v = (t.view(2, 40, 2, 64) for t in qkv.split(128, dim=-1))
    assert not q.is_contiguous()
    ref = fa.flash_attention_reference(q, k, v, None, True)
    torch.testing.assert_close(fa.flash_attention(q, k, v, None, True), ref, atol=1e-4, rtol=0)


def test_launch_counter_and_refusals(dev):
    q, k, v = _qkv(dev, 1, 4, 8)
    before = fa.FLASH_FWD_LAUNCHES
    fa.flash_attention(q, k, v)
    assert fa.FLASH_FWD_LAUNCHES == before + 1
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())
    q32, k32, v32 = _qkv(dev, 1, 4, 8, D=32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q32, k32, v32)
    with pytest.raises(ValueError, match="LSE has no gradient"):
        fa.flash_attention(q.requires_grad_(), k, v, return_lse=True)
    assert fa.FLASH_FWD_LAUNCHES == before + 1


def test_served_model_runs_every_attention_through_the_kernel(dev):
    from trlx_tpu_torch.inference.server import InferenceServer

    cfg = {
        "model": {"model_type": "gpt2", "model_arch": {
            "vocab_size": 64, "n_positions": 64, "n_embd": 128, "n_layer": 2, "n_head": 2}},
        "train": {"seq_length": 12, "dtype": "bfloat16",
                  "rollout": {"slots": 4, "admit_width": 2, "harvest_width": 2, "block_size": 4}},
        "method": {"name": "PPOConfig", "gen_kwargs": {
            "max_new_tokens": 6, "do_sample": True, "eos_token_id": 62, "pad_token_id": 63}},
    }
    server = InferenceServer(cfg, seed=0)
    calls = []
    orig = fa.flash_attention_reference
    fa.flash_attention_reference = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    before = fa.FLASH_FWD_LAUNCHES
    try:
        out = server.generate([[1, 2, 3], [4, 5], [6] * 12])
    finally:
        fa.flash_attention_reference = orig
    stats = server.stats()
    assert all(r["length"] >= 1 for r in out)
    assert not calls
    assert fa.FLASH_FWD_LAUNCHES - before == 2 * (
        stats["engine/prefills"] + stats["engine/decode_steps"]
    )


# Backward tolerances, against the plain backward fed the kernel forward's
# own O and LSE: f32 sums in another order (1e-4 absolute, gradients of
# O(1)); bf16 outputs are rounded to bf16 from f32 sums that differ in
# order, so they may differ by up to 2 bf16 ulps at the largest magnitude
# (2^-7 of max|ref|).
def _bwd_tol(dtype, ref):
    top = max(1.0, ref.float().abs().max().item())
    return 1e-4 * top if dtype == torch.float32 else top / 128


BWD_CASES = {  # B, Q, K, causal, bias kind
    "causal_padding": (3, 112, 112, True, "pad"),
    "causal_small_q": (2, 9, 130, True, None),
    "ragged_bias": (2, 33, 95, False, "full"),
    "per_head": (1, 17, 130, False, "head"),
    "one_key": (2, 5, 1, False, None),
    "all_masked_rows": (2, 112, 112, True, "left_pad"),
    "causal_long": (2, 300, 300, True, None),
    "causal_ragged": (2, 70, 150, True, "pad"),
}


def _bwd_inputs(dev, case, dtype):
    B, Q, K, causal, kind = BWD_CASES[case]
    q, k, v = _qkv(dev, B, Q, K, dtype=dtype, seed=3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    bias = None
    if kind == "pad":  # padding with the first keys valid
        keep = torch.arange(K, device=dev)[None] < 4
        bias = attn.padding_bias(((torch.rand(B, K, generator=gen, device=dev) > 0.3) | keep).long())
    elif kind == "left_pad":  # rows 0..69 of row 0 see only padding keys
        mask = torch.ones(B, K, dtype=torch.long, device=dev)
        mask[0, :70] = 0
        bias = attn.padding_bias(mask)
    elif kind == "full":
        bias = torch.randn(B, 1, Q, K, generator=gen, device=dev)
    elif kind == "head":
        bias = torch.randn(1, 2, Q, K, generator=gen, device=dev)
    do = torch.randn(B, Q, 2, 64, generator=gen, device=dev).to(dtype)
    return q, k, v, bias, causal, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_backward_kernels_match_plain(dev, dtype, case):
    q, k, v, bias, causal, do = _bwd_inputs(dev, case, dtype)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    got = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, causal)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.isfinite(g).all(), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= _bwd_tol(dtype, w), (name, err)


def test_backward_all_masked_rows_with_zero_do(dev):
    """The PPO path's left-padding rows: dO is zero there (pad rows feed
    only pad rows); the kernels must give the plain backward's gradients
    and nothing non-finite."""
    q, k, v, bias, causal, do = _bwd_inputs(dev, "all_masked_rows", torch.float32)
    do[0, :70] = 0
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    got = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, causal)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= _bwd_tol(torch.float32, w)


def test_backward_unvisited_key_tiles_are_zero(dev):
    """Q <= 16 under the causal flag visits only the first key tile: the
    dK/dV rows of the other tiles are written as zeros."""
    q, k, v, bias, causal, do = _bwd_inputs(dev, "causal_small_q", torch.float32)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    _, dk, dv = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    assert not dk[:, 64:].any() and not dv[:, 64:].any()
    assert dk[:, :9].abs().sum() > 0


def test_backward_through_strided_views_matches_autograd_of_plain(dev):
    """The autograd Function over q/k/v views of one packed projection
    (the GPT-2 layout) against autograd through the plain forward."""
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        qkv = torch.randn(2, 40, 3 * 128, generator=gen, device=dev).requires_grad_()
        q, k, v = (t.view(2, 40, 2, 64) for t in qkv.split(128, dim=-1))
        w = torch.randn(2, 40, 2, 64, generator=gen, device=dev)
        (fn(q, k, v, None, True) * w).sum().backward()
        grads.append(qkv.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4, rtol=0)


def test_backward_counters_and_refusals(dev):
    q, k, v, bias, causal, do = _bwd_inputs(dev, "one_key", torch.float32)
    o, lse = fa.flash_attention(q, k, v, bias, causal, True)
    dq0, dkv0 = fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES
    fa._launch_backward(q, k, v, bias, o, lse, do, causal)
    assert (fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES) == (dq0 + 1, dkv0 + 1)
    with pytest.raises(ValueError, match="o/do must be"):
        fa._launch_backward(q, k, v, bias, o, lse, do.bfloat16(), causal)
    with pytest.raises(ValueError, match="bad shapes"):
        fa._launch_backward(q, k, v, bias, o, lse[:, :, :1], do, causal)
    assert (fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES) == (dq0 + 1, dkv0 + 1)


def test_training_step_runs_every_attention_backward_through_the_kernels(dev):
    """One PPO update of a 12-layer model on the card: the parameters
    move, and each backward kernel launches once per layer."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.ppo_types import PPORolloutBatch
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    config = TRLConfig.from_dict({
        "model": {"model_type": "gpt2", "model_arch": {
            "vocab_size": 64, "n_positions": 64, "n_embd": 128, "n_layer": 12, "n_head": 2}},
        "train": {"seq_length": 10, "batch_size": 4, "dtype": "bfloat16", "seed": 0},
        "method": {"name": "PPOConfig", "gen_kwargs": {
            "max_new_tokens": 6, "do_sample": True, "eos_token_id": 62, "pad_token_id": 63}},
    })
    trainer = PPOTrainer(config)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q_mask = (torch.arange(10, device=dev)[None] >= torch.tensor([[0], [3], [5], [9]], device=dev)).int()
    q_ids = torch.randint(0, 60, (4, 10), generator=gen, device=dev).int() * q_mask
    out = trainer.sample(q_ids, q_mask)
    mb = PPORolloutBatch(
        query_tokens=q_ids, query_mask=q_mask,
        response_tokens=out.tokens, response_mask=out.response_mask,
        logprobs=out.logprobs, values=out.values,
        rewards=torch.randn(4, 6, generator=gen, device=dev) * out.response_mask,
    )
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    dq0, dkv0, fwd0 = fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES, fa.FLASH_FWD_LAUNCHES
    stats = trainer.train_step(mb)
    torch.cuda.synchronize()
    assert fa.FLASH_BWD_DQ_LAUNCHES - dq0 == 12 and fa.FLASH_BWD_DKV_LAUNCHES - dkv0 == 12
    assert fa.FLASH_FWD_LAUNCHES - fwd0 == 12
    assert all(torch.isfinite(v).all() for v in stats.values())
    assert any(not torch.equal(before[n], p) for n, p in trainer.model.named_parameters())
