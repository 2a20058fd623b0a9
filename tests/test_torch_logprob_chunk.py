"""``train.logprob_chunk``: the update's logprobs computed chunk by chunk
of response positions, each chunk under ``torch.utils.checkpoint``, so the
[B, R, V] f32 logits never exist at once.

Held (f32 on the CPU): chunked equals unchunked in the logprobs (1e-6:
the same products over another batching of rows) and in the gradient of
every parameter (1e-5 relative, 1e-6 absolute: the head's weight gradient
sums the rows chunk by chunk, in another order); a greedy PPO phase with ``logprob_chunk: 4``
through both ``learn()``s matches the JAX trainer at the same chunk, with
the tolerances of ``tests/test_torch_ppo_trainer.py``; the refusals (a
negative chunk, one that does not divide ``max_new_tokens`` or the bound
response width, the seq2seq trainer) raise as the reference's do; a
nonzero ``ent_coef`` takes the unchunked path, whose entropy needs every
vocabulary term.
"""

import numpy as np
import pytest
import torch

from _torch_ppo_phase import assert_final_params_match, config, port_trainer, run_jax, run_port
from trlx_tpu_torch.utils import chunked_logprobs, logprobs_from_logits

CHUNK, R = 4, 8


def _config(tmp_path, chunk=CHUNK, **method):
    cfg = config(tmp_path, train={"logprob_chunk": chunk}, gen_kwargs={"max_new_tokens": R})
    cfg["method"].update(method)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("logprob_chunk")
    jax_run = run_jax(_config(tmp_path / "jax"))
    cfg = _config(tmp_path / "port")
    port_run = run_port(port_trainer(cfg, jax_run["init"]))
    return cfg, jax_run, port_run, tmp_path


def test_chunked_logprobs_equal_the_full_ones_with_their_gradient():
    gen = torch.Generator().manual_seed(0)
    hidden = torch.randn(3, 12, 16, generator=gen, requires_grad=True)
    emb = torch.randn(50, 16, generator=gen, requires_grad=True)
    labels = torch.randint(0, 50, (3, 12), generator=gen)
    weights = torch.randn(3, 12, generator=gen)

    def head(h):
        return h @ emb.t()

    full = logprobs_from_logits(head(hidden), labels)
    full_grads = torch.autograd.grad((full * weights).sum(), (hidden, emb))
    for chunk in (1, 4, 12):
        got = chunked_logprobs(head, hidden, labels, chunk)
        torch.testing.assert_close(got, full, rtol=0, atol=1e-6)
        grads = torch.autograd.grad((got * weights).sum(), (hidden, emb))
        for g, w in zip(grads, full_grads):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="bound response width 12"):
        chunked_logprobs(head, hidden, labels, 5)


def test_update_forward_chunked_equals_unchunked(runs):
    cfg, jax_run, port_run, tmp_path = runs
    trainer = port_trainer(cfg, jax_run["init"])
    mb = port_run["trainer"].buffer.gather(np.arange(8))
    out = {}
    for chunk in (CHUNK, 0):
        trainer.config.train.training["logprob_chunk"] = chunk
        logprobs, values, entropy = trainer._forward_logprobs_values(mb)
        assert entropy is None
        params = [p for p in trainer.model.parameters() if p.requires_grad]
        loss = (logprobs * mb.response_mask).sum() + values.sum()
        out[chunk] = (logprobs.detach(), torch.autograd.grad(loss, params))
    torch.testing.assert_close(out[CHUNK][0], out[0][0], rtol=0, atol=1e-6)
    for g, w in zip(out[CHUNK][1], out[0][1]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_phase_matches_the_jax_trainer_at_the_same_chunk(runs):
    cfg, jax_run, port_run, _ = runs
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(port_run["buffer"][key], jax_run["buffer"][key], err_msg=key)
    assert port_run["buffer"]["response_tokens"].shape[1] == R
    for key in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(port_run["buffer"][key], jax_run["buffer"][key],
                                   atol=1e-5, rtol=0, err_msg=key)
    for key, want in jax_run["rows"].items():
        np.testing.assert_allclose(port_run["rows"][key], np.asarray(want), atol=2e-4,
                                   rtol=2e-4, err_msg=key)
    moved = assert_final_params_match(port_run["trainer"].model.state_dict(), jax_run, cfg)
    assert moved > 1e-4


def test_entropy_bonus_takes_the_unchunked_path(tmp_path):
    from trlx_tpu_torch.data.ppo_types import PPORolloutBatch

    trainer = port_trainer(_config(tmp_path, ent_coef=0.01))
    B = 4
    zeros = torch.zeros(B, R)
    mb = PPORolloutBatch(
        query_tokens=torch.ones(B, 6, dtype=torch.long), query_mask=torch.ones(B, 6, dtype=torch.long),
        response_tokens=torch.ones(B, R, dtype=torch.long),
        response_mask=torch.ones(B, R, dtype=torch.long),
        logprobs=zeros, values=zeros, rewards=zeros,
    )
    _, _, entropy = trainer._forward_logprobs_values(mb)
    assert entropy is not None and entropy.shape == (B, R)


@pytest.mark.parametrize("chunk,error,match", [
    (-1, ValueError, "must be >= 0"),
    (3, ValueError, "must divide gen max_new_tokens=8"),
])
def test_refusals_match_the_reference(tmp_path, chunk, error, match):
    from trlx_tpu.data.configs import TRLConfig as JTRLConfig
    from trlx_tpu.utils.loading import get_trainer as jget_trainer
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    cfg = _config(tmp_path, chunk=chunk)
    with pytest.raises(error, match=match):
        get_trainer("PPOTrainer")(TRLConfig.from_dict(cfg), device="cpu")
    with pytest.raises(error, match=match):
        jget_trainer("PPOTrainer")(JTRLConfig.from_dict(cfg))


def test_seq2seq_refuses_logprob_chunk(tmp_path):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    cfg = {
        "model": {"model_type": "t5", "model_arch": {
            "vocab_size": 40, "d_model": 16, "d_kv": 8, "d_ff": 32, "num_layers": 1,
            "num_decoder_layers": 1, "num_heads": 2}},
        "train": {"seq_length": 6, "batch_size": 4, "dtype": "float32", "logprob_chunk": 2,
                  "trainer": "Seq2SeqPPOTrainer", "checkpoint_dir": str(tmp_path)},
        "method": {"name": "PPOConfig", "num_rollouts": 4, "chunk_size": 4,
                   "gen_kwargs": {"max_new_tokens": 4, "eos_token_id": 1, "pad_token_id": 0}},
    }
    with pytest.raises(NotImplementedError, match="logprob_chunk is not supported by Seq2SeqPPOTrainer"):
        get_trainer("Seq2SeqPPOTrainer")(TRLConfig.from_dict(cfg), device="cpu")
