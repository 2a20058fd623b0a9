"""The port's HF checkpoint loader (``trlx_tpu_torch/models/conversion.py``)
against the JAX package's loaders and against HF's own torch forward.

``transformers`` writes tiny random checkpoints offline (every weight
perturbed from a numpy seed, so a bias or layer-norm mix-up shows): a
``GPT2LMHeadModel``, a gated-GELU T5 with an untied head (T5 1.1 / UL2)
and a ReLU T5 with the tied head (T5 1.0), in safetensors and in
``pytorch_model.bin``, and one sharded set of each format. For each:

- the port's state dict equals the JAX loader's param tree carried across
  by ``flax_to_torch``, exactly (both read the same f32 numbers);
- the port's f32 logits equal the JAX model's on the loaded weights and
  HF's torch forward, to 1e-5, at the real positions of left-padded rows.

Also: the safetensors reader against the ``safetensors`` package (F32,
F16, BF16, I64, an empty tensor), ``chip_smoke.py``'s writer read back by
both, ``model_arch`` giving only the dtypes once ``model_path`` is set,
and the trainers and the server starting from a checkpoint directory.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.models import conversion as jconv
from trlx_tpu.models.gpt2 import GPT2Model as JGPT2Model
from trlx_tpu.models.t5 import T5Model as JT5Model
from trlx_tpu_torch.models import conversion
from trlx_tpu_torch.models.convert import flax_to_torch
from trlx_tpu_torch.models.gpt2 import GPT2Model
from trlx_tpu_torch.models.t5 import T5Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 40
TOL = 1e-5
# (family, architecture, how it is saved)
CASES = [
    ("gpt2", "gpt2", "safetensors"),
    ("gpt2", "gpt2", "bin"),
    ("gpt2", "gpt2", "sharded_safetensors"),
    ("t5", "gated_untied", "safetensors"),
    ("t5", "gated_untied", "bin"),
    ("t5", "relu_tied", "safetensors"),
    ("t5", "relu_tied", "sharded_bin"),
]


def _hf_model(arch: str, seed: int):
    import transformers

    torch.manual_seed(seed)
    if arch == "gpt2":
        model = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=VOCAB, n_positions=32, n_embd=32, n_layer=2, n_head=2,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))
    else:
        gated = arch == "gated_untied"
        model = transformers.T5ForConditionalGeneration(transformers.T5Config(
            vocab_size=VOCAB, d_model=32, d_kv=8, d_ff=48, num_layers=2,
            num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
            relative_attention_max_distance=16, dropout_rate=0.0, initializer_factor=0.1,
            feed_forward_proj="gated-gelu" if gated else "relu",
            tie_word_embeddings=not gated, decoder_start_token_id=0,
            pad_token_id=0, eos_token_id=1))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():  # zero biases and unit norms hide mix-ups
            p.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    return model.eval()


def _save(model, path: str, fmt: str) -> None:
    shard = {"max_shard_size": "40KB"} if fmt.startswith("sharded") else {}
    model.save_pretrained(path, safe_serialization=fmt.endswith("safetensors"), **shard)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for i, (family, arch, fmt) in enumerate(CASES):
        model = _hf_model(arch, seed=i)
        path = str(root / f"{arch}_{fmt}")
        _save(model, path, fmt)
        out[(arch, fmt)] = (path, model)
    return out


def _inputs(B=3, S=7, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, size=(B, S)).astype(np.int64)
    lens = np.maximum(S - 2 * np.arange(B), 1)
    mask = (np.arange(S)[None] >= S - lens[:, None]).astype(np.int64)
    return ids * mask, mask


def test_sharded_sets_are_sharded(checkpoints):
    for arch, fmt in (("gpt2", "sharded_safetensors"), ("relu_tied", "sharded_bin")):
        path, _ = checkpoints[(arch, fmt)]
        index = [f for f in os.listdir(path) if f.endswith(".index.json")]
        shards = [f for f in os.listdir(path) if f.endswith((".safetensors", ".bin"))]
        assert len(index) == 1 and len(shards) > 1, os.listdir(path)


@pytest.mark.parametrize("family,arch,fmt", CASES, ids=[f"{a}-{f}" for _, a, f in CASES])
def test_state_dict_matches_the_jax_loader(checkpoints, family, arch, fmt):
    path, _ = checkpoints[(arch, fmt)]
    load, jload = ((conversion.load_gpt2_checkpoint, jconv.load_gpt2_checkpoint)
                   if family == "gpt2" else
                   (conversion.load_t5_checkpoint, jconv.load_t5_checkpoint))
    config, state = load(path)
    jconfig, jparams = jload(path)
    for field in ("vocab_size", "n_layer", "n_embd", "n_head", "num_layers",
                  "num_decoder_layers", "d_kv", "feed_forward_proj",
                  "tie_word_embeddings", "decoder_start_token_id"):
        assert getattr(config, field, None) == getattr(jconfig, field, None), field
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(state) == set(want)
    for name, w in want.items():
        assert state[name].dtype == torch.float32
        torch.testing.assert_close(state[name], w, rtol=0, atol=0, msg=name)
    if family == "t5":
        assert ("lm_head.weight" in state) == (arch == "gated_untied")


def _port_model(family, path):
    load = conversion.load_gpt2_checkpoint if family == "gpt2" else conversion.load_t5_checkpoint
    config, state = load(path)
    config = type(config)(**{**config.__dict__, "dtype": "float32"})
    model = (GPT2Model if family == "gpt2" else T5Model)(config, device="cpu")
    model.load_state_dict(state)
    return model, config


@pytest.mark.parametrize("family,arch,fmt", CASES, ids=[f"{a}-{f}" for _, a, f in CASES])
def test_logits_match_jax_and_hf(checkpoints, family, arch, fmt):
    path, hf = checkpoints[(arch, fmt)]
    model, _ = _port_model(family, path)
    ids, mask = _inputs()
    real = mask.astype(bool)
    with torch.no_grad():
        if family == "gpt2":
            got = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))["logits"]
            jconfig, jparams = jconv.load_gpt2_checkpoint(path)
            jconfig = type(jconfig)(**{**jconfig.__dict__, "dtype": "float32"})
            jout = JGPT2Model(jconfig).apply(
                {"params": jparams}, jnp.asarray(ids, jnp.int32),
                attention_mask=jnp.asarray(mask, jnp.int32))["logits"]
            positions = np.clip(np.cumsum(mask, -1) - 1, 0, None)
            want_hf = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                         position_ids=torch.from_numpy(positions)).logits
            where = real
        else:
            dec, dec_mask = _inputs(S=5, seed=1)
            dec_mask[:, 0] = 1  # the decoder start column is always real
            args = [torch.from_numpy(a) for a in (ids, mask, dec, dec_mask)]
            got = model(*args)["logits"]
            jconfig, jparams = jconv.load_t5_checkpoint(path)
            jconfig = type(jconfig)(**{**jconfig.__dict__, "dtype": "float32"})
            jout = JT5Model(jconfig).apply(
                {"params": jparams}, *(jnp.asarray(a, jnp.int32) for a in (ids, mask, dec, dec_mask))
            )["logits"]
            want_hf = hf(input_ids=args[0], attention_mask=args[1], decoder_input_ids=args[2],
                         decoder_attention_mask=args[3]).logits
            where = dec_mask.astype(bool)
    got = got.numpy()
    np.testing.assert_allclose(got[where], np.asarray(jout)[where], atol=TOL, rtol=0)
    np.testing.assert_allclose(got[where], want_hf.numpy()[where], atol=TOL, rtol=0)


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=gen),
        "f16": torch.randn(4, generator=gen).half(),
        "bf16": torch.randn(2, 3, 2, generator=gen).bfloat16(),
        "i64": torch.arange(-3, 9).reshape(3, 4),
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = conversion.read_safetensors(path)
    assert set(got) == set(tensors)
    for name, want in tensors.items():
        assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
        assert torch.equal(got[name], want), name
    save_file({"f64": torch.zeros(2, dtype=torch.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        conversion.read_safetensors(path)


def test_chip_smoke_writer_round_trips(tmp_path):
    from safetensors.torch import load_file

    sys.path.insert(0, ROOT)
    import chip_smoke

    gen = torch.Generator().manual_seed(1)
    tensors = {"b.weight": torch.randn(3, 4, generator=gen),
               "a.bias": torch.randn(5, generator=gen)}
    path = str(tmp_path / "model.safetensors")
    chip_smoke.write_safetensors(tensors, path)
    for read in (load_file, conversion.read_safetensors):
        got = read(path)
        assert set(got) == set(tensors)
        for name, want in tensors.items():
            assert torch.equal(got[name], want), name


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="no weights"):
        conversion.read_hf_weights(str(tmp_path))


def _ppo_config(tmp_path, family, path, **model):
    causal = family == "gpt2"
    return {
        "model": {"model_type": family, "model_path": path,
                  # with model_path only the dtypes of model_arch count
                  "model_arch": {"n_layer": 7, "num_layers": 7, "dtype": "float32"}, **model},
        "train": {"seq_length": 6, "batch_size": 4, "total_steps": 2, "dtype": "bfloat16",
                  "checkpoint_dir": str(tmp_path / "ckpt"),
                  **({} if causal else {"trainer": "Seq2SeqPPOTrainer"})},
        "method": {"name": "PPOConfig", "num_rollouts": 4, "chunk_size": 4, "ppo_epochs": 1,
                   "gen_kwargs": {"max_new_tokens": 3, "eos_token_id": 1,
                                  "pad_token_id": 0 if not causal else 39}},
    }


@pytest.mark.parametrize("family,arch", [("gpt2", "gpt2"), ("t5", "gated_untied")])
def test_trainer_starts_from_model_path(checkpoints, tmp_path, family, arch):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.models.heads import init_params
    from trlx_tpu_torch.trainer import get_trainer

    path, _ = checkpoints[(arch, "safetensors")]
    config = TRLConfig.from_dict(_ppo_config(tmp_path, family, path))
    trainer = get_trainer(config.train.trainer)(config, device="cpu")
    _, state = (conversion.load_gpt2_checkpoint if family == "gpt2"
                else conversion.load_t5_checkpoint)(path)
    assert trainer.model_config.dtype == "float32"  # model_arch's dtype
    backbone = trainer.model.transformer if family == "gpt2" else trainer.model.t5
    for module in (backbone, trainer.ref):
        got = module.state_dict()
        assert set(got) == set(state)
        for name, want in state.items():
            assert torch.equal(got[name], want), name
    # the value head is not in the checkpoint: it comes from the seed
    fresh = type(trainer.model)(trainer.model_config, device="cpu")
    init_params(fresh, config.train.seed)
    for name, p in trainer.model.v_head.state_dict().items():
        assert torch.equal(p, fresh.v_head.state_dict()[name]), name


def test_server_starts_from_model_path(checkpoints, tmp_path):
    from trlx_tpu_torch.inference.server import InferenceServer

    path, _ = checkpoints[("gpt2", "bin")]
    cfg = _ppo_config(tmp_path, "gpt2", path)
    server = InferenceServer(cfg, device="cpu")
    _, state = conversion.load_gpt2_checkpoint(path)
    got = server.model.transformer.state_dict()
    for name, want in state.items():
        assert torch.equal(got[name], want), name  # the f32 compute dtype casts nothing
    out = server.generate([[3, 4, 5], [6]])
    assert len(out) == 2 and all(len(r["tokens"]) >= 1 for r in out)
