"""``train.rollout_param_cast``: the rollout phase on a compute-dtype copy
of the masters (the JAX package's ``compute_dtype_cast`` and
``PPOTrainer.rollout_params``), held bit for bit against the port's own
per-use path.

Every causal family (gpt2, gptj, gpt_neox, gpt_neo, gpt2_moe) at a tiny
width in bf16 over f32 masters, every parameter perturbed (so the layer
norms are not 1 and 0): one sampled collect with the cast on and one with
it off, from the same seed, give ``torch.equal`` tokens, masks, behaviour
logprobs, values, reference logprobs and rewards; also with the hydra
reference and on the continuous engine. The port keeps ``fc2``, the MoE
router and the layer norms f32 (the reference rounds its norms, which
moves its outputs: ROADMAP queue 3), so the port is not held to the
reference's cast. Also: the copy is made once per collect and again
after ``load``; a server loaded from a trainer's checkpoint serves that
copy; T5 keeps its masters; ILQL's eval decode is bit-identical
under the cast; in f32 the cast is off, so the f32 parity tests
(``tests/test_torch_ppo_trainer.py`` and the rest, run with the key at
its default, on) hold the same path as before.
"""

import numpy as np
import pytest
import torch

from _torch_ppo_phase import config, port_trainer, record

ARCHS = {
    "gpt2": dict(vocab_size=40, n_positions=32, n_embd=32, n_layer=2, n_head=2),
    "gptj": dict(vocab_size=40, n_positions=32, n_embd=32, n_layer=2, n_head=2, rotary_dim=8),
    "gpt_neox": dict(vocab_size=40, max_position_embeddings=32, hidden_size=32,
                     num_hidden_layers=2, num_attention_heads=2, rotary_pct=0.5),
    "gpt_neo": dict(vocab_size=40, max_position_embeddings=32, hidden_size=32, num_layers=2,
                    num_heads=2, window_size=3, attention_layers=("global", "local")),
    "gpt2_moe": dict(vocab_size=40, n_positions=32, n_embd=32, n_layer=2, n_head=2,
                     n_experts=4, moe_every=2),
}
CASES = {
    **{family: (family, {}, {}) for family in ARCHS},
    "gpt2_hydra": ("gpt2", {"num_layers_unfrozen": 1}, {}),
    "gpt2_moe_hydra": ("gpt2_moe", {"num_layers_unfrozen": 1}, {}),
    "gpt2_engine": ("gpt2", {}, {"rollout": {"engine": "continuous", "slots": 8,
                                             "admit_width": 8, "harvest_width": 8,
                                             "block_size": 4}}),
}
BUFFER = ("query_tokens", "query_mask", "response_tokens", "response_mask", "logprobs",
          "values", "rewards")


def _config(tmp, family, model=None, train=None, cast=True):
    cfg = config(tmp, model={"model_type": family, "model_arch": dict(ARCHS[family]),
                             **(model or {})},
                 train={"dtype": "bfloat16", "rollout_param_cast": cast, **(train or {})})
    cfg["method"]["gen_kwargs"]["do_sample"] = True
    return cfg


def _perturb(trainer, seed: int = 0) -> None:
    """The same perturbed f32 masters in every trainer built from the
    same config, and the reference taken again from them."""
    gen = torch.Generator().manual_seed(seed)
    state = {n: p + 0.05 * torch.randn(p.shape, generator=gen)
             for n, p in trainer.model.state_dict().items()}
    trainer.model.load_state_dict(state)
    trainer._setup_reference(trainer.model.transformer, trainer.model_config.n_layer)


def _collect(trainer):
    refs = []
    record(trainer, "score_ref", refs)
    trainer.orch.make_experience(16, 0)
    buf = trainer.buffer.full
    return {**{k: getattr(buf, k) for k in BUFFER}, "ref": torch.cat(refs)}


@pytest.mark.parametrize("case", list(CASES))
def test_a_collect_on_the_cast_is_bit_identical(tmp_path, case):
    family, model, train = CASES[case]
    runs = {}
    for cast in (True, False):
        trainer = port_trainer(_config(tmp_path / str(cast), family, model, train, cast))
        _perturb(trainer)
        runs[cast] = (trainer, _collect(trainer))
    (on, got), (off, want) = runs[True], runs[False]
    assert on.rollout_cast_dtype == torch.bfloat16 and off.rollout_cast_dtype is None
    assert on.rollout_cast_refreshes == 1 and off.rollout_model() is off.model
    for key, w in want.items():
        assert torch.equal(got[key], w), key
    assert got["response_mask"].sum() > 16 and not torch.equal(got["logprobs"], got["ref"] * 0)
    # the rollout ran on the copy: bf16 projections, f32 norms and heads
    dtypes = {n: p.dtype for n, p in on.rollout_model().named_parameters()}
    assert {n for n, d in dtypes.items() if d == torch.float32} == {
        n for n in dtypes if any(x in n for x in ("fc2", "router", ".ln_"))}


def test_fc2_router_and_norms_keep_f32_and_the_reference_halves(tmp_path):
    trainer = port_trainer(_config(tmp_path, "gpt2_moe"))
    cast = trainer.rollout_model()
    params = dict(cast.named_parameters())
    masters = dict(trainer.model.named_parameters())
    for name in ("transformer.h.1.mlp.router", "v_head.fc2.weight", "v_head.fc2.bias",
                 "transformer.h.0.ln_1.weight", "transformer.ln_f.bias"):
        assert params[name].dtype == torch.float32
        assert params[name] is masters[name], name  # shared: the live master
    for name in ("transformer.h.1.mlp.wi", "transformer.h.1.mlp.bo", "transformer.wte.weight",
                 "transformer.h.0.attn.c_attn.weight", "v_head.fc1.weight"):
        assert params[name].dtype == torch.bfloat16 and not params[name].requires_grad, name
        assert torch.equal(params[name], masters[name].detach().to(torch.bfloat16)), name
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    # the frozen full-copy reference was cast once, for good
    ref = dict(trainer.ref.named_parameters())
    assert ref["h.1.mlp.router"].dtype == torch.float32 and ref["ln_f.weight"].dtype == torch.float32
    assert ref["h.1.mlp.wi"].dtype == torch.bfloat16
    ref_bytes = sum(p.numel() * p.element_size() for p in ref.values())
    f32_bytes = sum(p.numel() * 4 for p in ref.values())
    assert ref_bytes < 0.51 * f32_bytes


def test_a_server_from_a_trained_checkpoint_serves_the_rollout_copy(tmp_path):
    """``InferenceServer`` casts by the trainers' rule: loaded from a
    trainer's checkpoint (its norms perturbed, as training moves them), its
    parameters equal the trainer's rollout copy, f32 leaves included, and
    its forward gives the copy's logits and values bit for bit."""
    from trlx_tpu_torch.inference.server import InferenceServer

    cfg = _config(tmp_path / "run", "gpt2_moe")
    trainer = port_trainer(cfg)
    _perturb(trainer)
    trainer.save(str(tmp_path / "ckpt"))
    server = InferenceServer(cfg, checkpoint_dir=str(tmp_path / "ckpt"), device="cpu")
    cast = trainer.rollout_model()
    served = dict(server.model.named_parameters())
    for name, p in cast.named_parameters():
        assert served[name].dtype == p.dtype and torch.equal(served[name], p), name
    assert served["transformer.h.0.ln_1.weight"].dtype == torch.float32
    ids = torch.randint(0, 36, (2, 6), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = server.model(ids), cast(ids)
    for key in ("logits", "values"):
        assert torch.equal(got[key], want[key]), key


def test_one_copy_per_collect_and_a_fresh_one_after_load(tmp_path):
    trainer = port_trainer(_config(tmp_path, "gpt2", train={"epochs": 2, "total_steps": 8}))
    made_at = {}  # copy count -> the update count when it was first served
    rollout_model = trainer.rollout_model

    def recorded():
        model = rollout_model()
        made_at.setdefault(trainer.rollout_cast_refreshes, trainer.step)
        return model

    trainer.rollout_model = recorded
    trainer.learn()
    # two collects (steps 0 and 4), each a streamed phase whose behaviour
    # snapshot is its one cast copy (the step-0 eval reuses the first, and
    # the epoch-1 updates run beside it), and the final eval (step 8)
    # makes a third: one copy per set of masters
    assert made_at == {1: 0, 2: 4, 3: 8} and trainer.step == 8
    assert trainer.rollout_cast_refreshes == 3
    copy_before = trainer._rollout_module
    trainer.load(trainer.config.train.checkpoint_dir)
    assert trainer._rollout_module is None
    trainer.evaluate()
    assert trainer.rollout_cast_refreshes == 4 and trainer._rollout_module is not copy_before


def test_t5_keeps_its_masters(tmp_path):
    from test_torch_seq2seq_ppo_trainer import ARCH, _config as t5_config

    cfg = t5_config(tmp_path)
    cfg["train"]["dtype"] = "bfloat16"
    cfg["train"]["rollout_param_cast"] = True
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    trainer = get_trainer("Seq2SeqPPOTrainer")(TRLConfig.from_dict(cfg), device="cpu")
    assert ARCH["d_model"] == trainer.model_config.d_model
    assert trainer.rollout_cast_dtype is None and trainer.rollout_model() is trainer.model
    assert all(p.dtype == torch.float32 for p in trainer.ref.parameters())


def test_ilql_eval_decode_is_bit_identical(tmp_path):
    from test_torch_ilql_trainer import _config as ilql_config
    from test_torch_ilql_trainer import port_trainer as ilql_trainer

    runs = {}
    for cast in (True, False):
        cfg = ilql_config(tmp_path / str(cast), dtype="bfloat16", rollout_param_cast=cast)
        trainer = ilql_trainer(cfg)
        gen = torch.Generator().manual_seed(0)
        trainer.model.load_state_dict({
            n: p + 0.05 * torch.randn(p.shape, generator=gen)
            for n, p in trainer.model.state_dict().items()})
        trainer.target.load_state_dict({
            n: p + 0.05 * torch.randn(p.shape, generator=gen)
            for n, p in trainer.target.state_dict().items()})
        batch, _ = next(iter(trainer.eval_pipeline.create_loader(
            16, shuffle=False, drop_last=False)))
        runs[cast] = (trainer, trainer.sample(batch.input_ids, batch.attention_mask))
    (on, got), (off, want) = runs[True], runs[False]
    assert on.rollout_cast_refreshes == 1 and off.rollout_bundle() == (off.model, off.target)
    model, target = on.rollout_bundle()
    assert model.heads.q1_head.fc2.weight.dtype == torch.float32
    assert target.q1_head.fc1.weight.dtype == torch.bfloat16
    for key in ("tokens", "response_mask"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    assert got.response_mask.sum() > 0
    on.train_step(on.store.stacked_slice(np.arange(16)))  # an update makes the copy stale
    assert on._rollout_bundle is None


def test_f32_compute_leaves_the_cast_off(tmp_path):
    cfg = _config(tmp_path, "gpt2")
    cfg["train"]["dtype"] = "float32"
    trainer = port_trainer(cfg)
    assert trainer.config.train.training["rollout_param_cast"] is True
    assert trainer.rollout_cast_dtype is None and trainer.rollout_model() is trainer.model
    assert trainer.rollout_cast_refreshes == 0
