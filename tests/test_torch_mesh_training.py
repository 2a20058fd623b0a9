"""The port's dp, fsdp and tp training (``trainer/ppo_trainer.py`` under
``train.mesh``) in gloo process groups on the CPU, against the JAX
package's sharded run and against the port's own one-process run.

One sampled PPO phase (a 2-block GPT-2 at n_embd 128, 4 heads of 32, so
that fsdp shards every block's projections and the value head, and tp
splits the heads 2 and 2; 16 rollouts in chunks of 8, two minibatches, two
epochs: 4 updates) runs through the JAX package's ``learn()`` on the
suite's 8 virtual devices under ``{dp: -1, fsdp: 2, tp: 2}``, recording
every sampler key; the port's runs start from the JAX run's initial
parameters and draw the Gumbel noise of those keys (the global chunk's,
of which each rank's sampler takes its rows). A GRPO phase (groups of 4)
does the same under ``{dp: -1}`` on the JAX side.

``tests/_torch_mesh_worker.py`` (torch and the port only, no JAX) runs
each world once for the module, the two worlds at once: world 2 runs PPO
under ``{dp: 2}``, ``{fsdp: 2}`` and ``{tp: 2}``, GRPO under ``{fsdp: 2}``,
and restores the one-process run's checkpoint under ``{tp: 2}``; world 4
runs PPO under ``{fsdp: 2, tp: 2}``. Each mesh learns twice, streamed and
with every phase's epoch-1 updates held to its end, which must give
``torch.equal`` shards.

Held:
- the rollout store's tokens and masks exactly against both the JAX run
  and the one-process port run; logprobs, values and rewards within 1e-5
  of the JAX run's and 2e-6 of the one-process run's;
- the final parameters against the JAX run by
  ``tests/_torch_ppo_phase.py::assert_final_params_match`` (1e-5; the
  attention key biases and the elements whose gradient fell below 1e-6 in
  some update, whose Adam step rounding decides, within twice the summed
  learning rate), and against the one-process port run within 5e-6 on
  every other element (the mesh changes only the order of the sums: up
  to ~1e-6 here; the exempt elements move up to ~2e-5);
- each update's stats within 1e-5 of the one-process run's (1e-4
  relative), and the KL sequence within 1e-6;
- every parameter the JAX specs shard holds at most its share on a rank;
- a checkpoint written at world 2 (``{fsdp: 2}``) and at world 4 loads at
  world 1, and the one-process run's loads at world 2 (``{tp: 2}``), with
  ``torch.equal`` parameters and Adam moments;
- PPO with the hydra reference (one branch block, the block below it and
  the embeddings frozen) under ``{tp: 2}`` against the one-process run of
  the same config, its frozen leaves bit-identical;
- GPT-J and NeoX under ``{tp: 2}`` and GPT-Neo under ``{fsdp: 2}`` (world
  2, the same spawn): the policy's logits, values and every gradient of
  a fixed loss within 1e-5 of one process's;
- each refusal of ``trainer/__init__.py::refuse_mesh`` raises with its
  ROADMAP item.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from _torch_ppo_phase import assert_final_params_match, run_jax, split_chain_noise
from trlx_tpu_torch.models.convert import flax_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_mesh_worker as worker  # noqa: E402

ARCH = {"vocab_size": 40, "n_positions": 32, "n_embd": 128, "n_layer": 2, "n_head": 4}
#: (mesh, world, JAX run)
MESHES = {
    "dp2": ({"dp": 2, "fsdp": 1, "tp": 1}, 2, "ppo"),
    "fsdp2": ({"dp": 1, "fsdp": 2, "tp": 1}, 2, "ppo"),
    "tp2": ({"dp": 1, "fsdp": 1, "tp": 2}, 2, "ppo"),
    "fsdp2_tp2": ({"dp": 1, "fsdp": 2, "tp": 2}, 4, "ppo"),
    "grpo_fsdp2": ({"dp": 1, "fsdp": 2, "tp": 1}, 2, "grpo"),
    # against the one-process run only
    "hydra_tp2": ({"dp": 1, "fsdp": 1, "tp": 2}, 2, "hydra"),
}
#: the meshes held against the JAX package's run too
JAX_HELD = [n for n, (_, _, kind) in MESHES.items() if kind != "hydra"]
#: the JAX runs' meshes: the mixed one for PPO (its compile costs ~1 s over
#: the dp-only run's); GRPO's sharded JAX run equals its unsharded one by
#: the JAX package's own tests, and the dp-only run compiles ~6 s sooner
JAX_MESH = {"ppo": {"dp": -1, "fsdp": 2, "tp": 2}, "grpo": {"dp": -1, "fsdp": 1, "tp": 1}}
ATOL_JAX = 1e-5
ATOL_WORLD1 = 2e-6
ATOL_PARAMS_WORLD1 = 5e-6


def config(ckpt_dir, mesh, kind="ppo") -> dict:
    cfg = {
        "model": {"model_type": "gpt2", "model_arch": dict(ARCH),
                  # the hydra reference (one branch block) and freezing below it
                  **({"num_layers_unfrozen": 1} if kind == "hydra" else {})},
        "train": {
            "seq_length": 6, "batch_size": 8, "epochs": 1, "total_steps": 4,
            "lr_init": 1e-3, "lr_target": 2e-4, "eval_interval": 1000,
            "checkpoint_interval": 1000, "dtype": "float32", "seed": 5,
            "checkpoint_dir": str(ckpt_dir), "mesh": dict(mesh),
        },
        "method": {
            "name": "PPOConfig", "num_rollouts": 16, "chunk_size": 8,
            "ppo_epochs": 2, "init_kl_coef": 0.05, "target": 6.0, "horizon": 100,
            "scale_reward": "running", "cliprange_reward": 10.0,
            "gen_kwargs": {"max_new_tokens": 7, "min_new_tokens": 2, "do_sample": True,
                           "eos_token_id": 10, "pad_token_id": 39},
        },
    }
    if kind == "grpo":
        cfg["train"]["trainer"] = "GRPOTrainer"
        cfg["method"].update(name="GRPOConfig", group_size=4, vf_coef=0.0, scale_reward=None)
    return cfg


def noise_of(jax_run, cfg) -> list:
    """Per sampler call of the JAX run, its per-step [B, V] Gumbel draws."""
    R = cfg["method"]["gen_kwargs"]["max_new_tokens"]
    return [split_chain_noise(key, R, (cfg["method"]["chunk_size"], ARCH["vocab_size"]))
            for key in jax_run["sample_keys"]]


def learn_world1(cfg, init, noise):
    """The port's one-process run: the worker's build, noise and records."""
    trainer, phases, _ = worker.learn(cfg, init, noise)
    return trainer, phases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, the one-process port runs, and every mesh's record
    (rank 0's, with each rank's bytes), from one spawn per world."""
    tmp = tmp_path_factory.mktemp("mesh")
    data = (worker.prompts(), worker.reward_fn, None)
    base = {}
    for kind in ("ppo", "grpo"):
        jax_run = run_jax(config(tmp / f"jax_{kind}", JAX_MESH[kind], kind), data, sampled=True)
        init = flax_to_torch(jax_run["init"])
        noise = noise_of(jax_run, config(tmp, {}, kind))
        one, phases = learn_world1(config(tmp / f"one_{kind}", {"dp": -1}, kind), init, noise)
        base[kind] = {"jax": jax_run, "init": init, "noise": noise, "one": one,
                      "one_phases": phases}
    # the hydra reference under tp: the port's one-process run on the PPO
    # run's weights and noise (test_torch_hydra.py holds that run's path
    # against the JAX package)
    one, phases = learn_world1(config(tmp / "one_hydra", {"dp": -1}, "hydra"),
                               base["ppo"]["init"], base["ppo"]["noise"])
    base["hydra"] = {**base["ppo"], "jax": None, "one": one, "one_phases": phases}
    # the one-process run's end checkpoint, which world 2 restores
    one_ckpt = tmp / "one_ppo"
    tasks = {2: [], 4: []}
    for name, (mesh, world, kind) in MESHES.items():
        case = {"name": name, "cfg": config(tmp / name, mesh, kind),
                "init": base[kind]["init"], "noise": base[kind]["noise"]}
        tasks[world].append(case)
    tasks[2].append({"name": "load_tp2", "cfg": config(tmp / "load", MESHES["tp2"][0]),
                     "init": base["ppo"]["init"], "noise": [], "load": str(one_ckpt)})
    for name, (family, mesh) in MODEL_CASES.items():
        tasks[2].append({"name": name, "kind": "model", "family": family,
                         "mesh": mesh, **model_inputs(family)})
    records = worker.spawn(tasks, tmp)
    return {"base": base, "records": records, "tmp": tmp, "one_ckpt": one_ckpt}


#: the other families' sharded forward and backward, at world 2: GPT-J's
#: separate q/k/v projections and untied, biased head over vocabulary
#: shards, NeoX's head-major query_key_value (a contiguous column shard is
#: whole heads), GPT-Neo under fsdp (its tp is refused)
MODEL_ARCHS = {
    "gptj": {"vocab_size": 40, "n_positions": 32, "n_embd": 128, "n_layer": 2, "n_head": 4,
             "rotary_dim": 16, "dtype": "float32"},
    "gpt_neox": {"vocab_size": 40, "max_position_embeddings": 32, "hidden_size": 128,
                 "num_hidden_layers": 2, "num_attention_heads": 4, "dtype": "float32"},
    "gpt_neo": {"vocab_size": 40, "max_position_embeddings": 32, "hidden_size": 128,
                "num_layers": 2, "num_heads": 4, "attention_layers": ["global", "local"],
                "window_size": 3, "dtype": "float32"},
}
MODEL_CASES = {"gptj_tp2": ("gptj", {"dp": 1, "tp": 2}),
               "neox_tp2": ("gpt_neox", {"dp": 1, "tp": 2}),
               "neo_fsdp2": ("gpt_neo", {"dp": 1, "fsdp": 2})}
#: the sharded forward and gradients against one process's, f32
ATOL_MODEL = 1e-5


def model_inputs(family: str) -> dict:
    """The family's initial weights (N(0, 0.02) from a seed), a left-padded
    [4, 8] batch and the loss's fixed weights over the logits."""
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
    from trlx_tpu_torch.models.registry import get_model_family

    f = get_model_family(family)
    model = CausalLMWithValueHead(f.config_cls.from_dict(MODEL_ARCHS[family]), f.backbone_cls)
    init_params(model, 3)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 40, (4, 8)))
    mask = torch.ones(4, 8, dtype=torch.long)
    mask[0, :3] = 0
    weights = torch.from_numpy(rng.normal(size=(4, 8, 40)).astype(np.float32))
    return {"arch": MODEL_ARCHS[family], "init": model.state_dict(), "ids": ids,
            "mask": mask, "weights": weights}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_other_families_shard_as_one_process_computes(runs, name):
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead
    from trlx_tpu_torch.models.registry import get_model_family

    family, mesh = MODEL_CASES[name]
    f = get_model_family(family)
    inputs = model_inputs(family)
    model = CausalLMWithValueHead(f.config_cls.from_dict(inputs["arch"]), f.backbone_cls)
    model.load_state_dict(inputs["init"])
    out = model(inputs["ids"], attention_mask=inputs["mask"])
    ((out["logits"] * inputs["weights"]).sum() + (out["values"] ** 2).sum()).backward()
    for rec in runs["records"][name]:
        torch.testing.assert_close(rec["logits"], out["logits"].detach(), atol=ATOL_MODEL, rtol=0)
        torch.testing.assert_close(rec["values"], out["values"].detach(), atol=ATOL_MODEL,
                                   rtol=0)
        for n, p in model.named_parameters():
            torch.testing.assert_close(rec["grads"][n], p.grad, atol=ATOL_MODEL, rtol=1e-5,
                                       msg=n)
        held = sum(h for h, _ in rec["bytes"].values())
        assert held < sum(full for _, full in rec["bytes"].values())


def _mesh(runs, name):
    mesh, world, kind = MESHES[name]
    recs = runs["records"][name]
    assert len(recs) == world
    return recs[0], recs, runs["base"][kind], config(runs["tmp"], mesh, kind)


@pytest.mark.parametrize("name", list(MESHES))
def test_rollouts_are_token_exact(runs, name):
    rec, _, base, _ = _mesh(runs, name)
    one = base["one"].buffer.full
    for key in worker.BUFFER_KEYS:
        got = rec["buffer"][key]
        want_one = getattr(one, key)
        exact = key in ("query_tokens", "query_mask", "response_tokens", "response_mask")
        if base["jax"] is not None:
            want_jax = base["jax"]["buffer"][key]
            if exact:
                np.testing.assert_array_equal(got.numpy(), want_jax, err_msg=key)
            else:
                np.testing.assert_allclose(got.numpy(), want_jax, atol=ATOL_JAX, rtol=0,
                                           err_msg=key)
        if exact:
            assert torch.equal(got, want_one), key
        else:
            torch.testing.assert_close(got, want_one, atol=ATOL_WORLD1, rtol=0, msg=key)
    # sampling reached the choice
    assert len({tuple(r) for r in rec["buffer"]["response_tokens"].numpy()}) > 1


@pytest.mark.parametrize("name", JAX_HELD)
def test_final_params_match_jax(runs, name):
    rec, _, base, cfg = _mesh(runs, name)
    noisy = {n: f < 1e-6 for n, f in rec["floor"].items()}
    moved = assert_final_params_match(rec["params"], base["jax"], cfg, noisy=noisy)
    assert moved > 1e-4


@pytest.mark.parametrize("name", list(MESHES))
def test_final_params_match_the_one_process_run(runs, name):
    """Tighter than against JAX: 5e-6 outside the exempt elements."""
    rec, _, base, cfg = _mesh(runs, name)
    one = base["one"].model.state_dict()
    tol = 2 * cfg["train"]["total_steps"] * cfg["train"]["lr_init"]
    C = ARCH["n_embd"]
    assert set(one) == set(rec["params"])
    frozen = {n for n, p in base["one"].model.named_parameters() if not p.requires_grad}
    assert (len(frozen) > 0) == (MESHES[name][2] == "hydra")
    for n, want in one.items():
        if n in frozen:
            assert torch.equal(rec["params"][n], want), n
            continue
        got = rec["params"][n].clone()
        exempt = torch.zeros_like(got, dtype=torch.bool)
        if n in rec["floor"]:
            exempt |= rec["floor"][n] < 1e-6
        if n.endswith("attn.c_attn.bias"):
            exempt[C:2 * C] = True
        torch.testing.assert_close(got[exempt], want[exempt], atol=tol, rtol=0, msg=n)
        torch.testing.assert_close(got[~exempt], want[~exempt], atol=ATOL_PARAMS_WORLD1,
                                   rtol=0, msg=n)


@pytest.mark.parametrize("name", list(MESHES))
def test_update_stats_match_the_one_process_run(runs, name):
    rec, _, base, _ = _mesh(runs, name)
    rows, kl_seq = base["one_phases"][0][0], base["one_phases"][0][1]
    assert set(rec["rows"]) == set(rows)
    for k, v in rows.items():
        np.testing.assert_allclose(rec["rows"][k], v, atol=1e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(rec["kl_seq"], kl_seq, atol=1e-6, rtol=0)
    if base["jax"] is None:
        return
    # the JAX run's too, to the parity tests' 1e-5 on the losses
    for k in ("losses/total_loss", "losses/policy_loss", "optimizer/grad_norm"):
        np.testing.assert_allclose(rec["rows"][k], base["jax"]["rows"][k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", list(MESHES))
def test_streamed_phase_equals_the_serial_plan(runs, name):
    _, recs, _, _ = _mesh(runs, name)
    assert all(r["serial_equal"] for r in recs)


@pytest.mark.parametrize("name", list(MESHES))
def test_each_rank_holds_at_most_its_share(runs, name):
    mesh, world, _ = MESHES[name]
    _, recs, _, _ = _mesh(runs, name)
    sharded = 0
    for rec in recs:
        for n, spec in rec["specs"].items():
            held, full = rec["bytes"][n]
            share = np.prod([mesh[a] for a in spec if a])
            assert held * share <= full, (n, spec, held, full)
            sharded += share > 1
        # two Adam moments per trainable shard, none for a frozen one
        assert rec["opt_bytes"] == 2 * sum(rec["bytes"][n][0] for n in rec["trainable"])
    if mesh["fsdp"] > 1 or mesh["tp"] > 1:
        assert sharded > 0
        # the reference too (a full copy, or the hydra branch's top block)
        held, full = recs[0]["ref_bytes"]["h.1.mlp.c_fc.weight"]
        assert held < full


def _world1_trainer(runs, ckpt_dir):
    return worker.build(config(ckpt_dir, {"dp": -1}), runs["base"]["ppo"]["init"])


@pytest.mark.parametrize("name", ["fsdp2", "fsdp2_tp2"])
def test_a_mesh_checkpoint_loads_at_world_1(runs, name):
    rec, _, _, _ = _mesh(runs, name)
    trainer = _world1_trainer(runs, runs["tmp"] / f"reload_{name}")
    trainer.load(str(runs["tmp"] / name))  # the mesh run's end checkpoint
    for n, p in trainer.model.state_dict().items():
        assert torch.equal(p, rec["params"][n]), n
    assert trainer.step == 4


def test_the_one_process_checkpoint_loads_at_world_2(runs):
    rec = runs["records"]["load_tp2"][0]
    one = runs["base"]["ppo"]["one"]
    assert rec["loaded_step"] == one.step == 4
    for n, p in one.model.state_dict().items():
        assert torch.equal(rec["loaded_params"][n], p), n
    want = one.opt.state_dict()["adamw"]["state"]
    got = rec["loaded_opt"]["adamw"]["state"]
    for i, st in want.items():
        for k, v in st.items():
            assert torch.equal(got[i][k], v), (i, k)


#: (train/model/method overrides at world 1 asking for a mesh, trainer,
#: the match): every refusal names its ROADMAP item
REFUSALS = {
    "sp": ({"train": {"mesh": {"dp": 1, "sp": 2}}}, "PPOTrainer", "item 14.3"),
    "pp": ({"train": {"mesh": {"dp": 1, "pp": 2}}}, "PPOTrainer", "item 14.5"),
    "ep": ({"train": {"mesh": {"dp": 1, "ep": 2}}}, "PPOTrainer", "item 14.6"),
    "gpt2_moe": ({"train": {"mesh": {"dp": 2}}, "model": {"model_type": "gpt2_moe"}},
                 "PPOTrainer", "item 14.6"),
    "gpt_neo_tp": ({"train": {"mesh": {"dp": 1, "tp": 2}}, "model": {"model_type": "gpt_neo"}},
                   "PPOTrainer", "ROADMAP item 14"),
    "engine": ({"train": {"mesh": {"dp": 2}, "rollout": {"engine": "continuous"}}},
               "PPOTrainer", "items 14 and 15"),
    "async_rl": ({"train": {"mesh": {"dp": 2}, "async_rl": {"enabled": True}}},
                 "PPOTrainer", "item 14.4"),
    "ilql": ({"train": {"mesh": {"dp": 2}}}, "ILQLTrainer", "ROADMAP item 14"),
    "seq2seq": ({"train": {"mesh": {"dp": 2}}}, "Seq2SeqPPOTrainer", "ROADMAP item 14"),
    "bf16_moments": ({"train": {"mesh": {"dp": 2}, "adam_moment_dtype": "bfloat16"}},
                     "PPOTrainer", "ROADMAP item 14"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_unsupported_meshes_are_refused_by_name(tmp_path, name):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    override, trainer, match = REFUSALS[name]
    cfg = config(tmp_path, {})
    cfg["train"].pop("mesh")
    if trainer == "ILQLTrainer":
        cfg["method"] = {"name": "ILQLConfig"}
    if trainer == "Seq2SeqPPOTrainer":
        cfg["model"] = {"model_type": "t5", "model_arch": {
            "vocab_size": 40, "d_model": 32, "d_kv": 8, "d_ff": 48, "num_layers": 2,
            "num_heads": 4}}
    for section, values in override.items():
        cfg[section].update(values)
    cfg["train"]["trainer"] = trainer
    # at world 1 a mesh of two ranks is refused by name before the world
    # size is checked
    with pytest.raises(NotImplementedError, match=match):
        get_trainer(trainer)(TRLConfig.from_dict(cfg), device="cpu")


def test_world_mismatch_names_the_launch(tmp_path):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    cfg = config(tmp_path, {"dp": -1, "fsdp": 2, "tp": 2})
    with pytest.raises(ValueError, match=r"needs 4 ranks, the world has 1.*nproc_per_node 4"):
        get_trainer("PPOTrainer")(TRLConfig.from_dict(cfg), device="cpu")
    json.dumps(cfg)  # the config stays plain data
