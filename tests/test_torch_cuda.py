"""Card-only tests of the port's CUDA kernel path (marker ``cuda``).

They skip without a CUDA device. On a machine with an H100 run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q``
(``--noconftest`` because the suite's conftest configures JAX, which the
port's machine need not have; this file imports no JAX). They hold the
kernel against its plain version at small shapes and pin the wrapper's
contract: refusals raise and do not count, launches count one each, and
the served model runs every attention through the kernel.
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
    with pytest.raises(NotImplementedError, match="_dq_kernel"):
        fa.flash_attention(q.requires_grad_(), k, v)
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
