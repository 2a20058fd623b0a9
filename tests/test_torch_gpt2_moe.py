"""The gpt2_moe family (switch-MoE GPT-2, the dense switch path) against
the JAX package's on the same weights, carried across by
``models/convert.py``.

A tiny f32 policy of 4 blocks with switch MLPs at blocks 1 and 3 (4
experts, ``moe_every`` 2), every parameter perturbed so that no bias is
zero and the router picks different experts for different tokens. Held,
with their tolerances (f32; the frameworks sum in another order):

- logits, values and ``moe_loss_summary`` (aux, z, max load) of the
  training forward: 1e-5; the router's and the experts' gradients of a
  loss with the router penalty: 1e-5 relative-or-absolute;
- one greedy PPO phase (a 2-block model) and three ILQL updates through
  both packages' trainers (the JAX ones on the suite's CPU mesh, whose ``ep`` axis is 1,
  so its dense path): tokens exact, buffers 1e-5, per-update stats
  (``losses/moe_aux``, ``losses/router_z``, ``moe/max_load`` among them)
  2e-4, final parameters as ``_torch_ppo_phase.assert_final_params_match``
  (with its ``noisy`` elements, whose gradient fell below 1e-6 in some
  update);
- port only: the hydra reference equals the full copy at init, the
  continuous engine equals the per-row fixed sampler bit for bit, the
  sampler collects no router losses;
- refusals: no MoE block (both packages), an HF checkpoint, an ``ep``
  mesh (ROADMAP item 14.6).

The JAX models and both PPO runs are built once per module.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ppo_phase import (
    assert_final_params_match,
    config,
    port_trainer,
    prompts,
    record,
    reward_fn,
    run_jax,
    run_port,
)
from trlx_tpu_torch.models.convert import flax_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

from ilql_randomwalks import make_dataset  # noqa: E402
from randomwalks import make_task  # noqa: E402

MOE = {"n_experts": 4, "moe_every": 2, "router_aux_coef": 0.01, "router_z_coef": 0.001}
ARCH = dict(vocab_size=40, n_positions=32, n_embd=32, n_layer=4, n_head=2, **MOE)
TOL = 1e-5


def _perturbed(params, seed: int):
    """Every leaf plus N(0, 0.05²); each router drawn N(0, 1) instead, so
    the tokens spread over the experts (at flax's init scale one expert
    takes them all)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if "router" in jax.tree_util.keystr(path):
            return rng.normal(size=a.shape).astype(np.float32)
        return a + 0.05 * rng.normal(size=a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def models():
    from trlx_tpu.models.gpt2_moe import GPT2MoEConfig as JConfig
    from trlx_tpu.models.gpt2_moe import GPT2MoEModel as JModel
    from trlx_tpu.models.heads import CausalLMWithValueHead as JPolicy
    from trlx_tpu_torch.models.gpt2_moe import GPT2MoEConfig, GPT2MoEModel
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead

    arch = dict(ARCH, dtype="float32", param_dtype="float32")
    jmodel = JPolicy(JConfig(**arch), backbone_cls=JModel)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = _perturbed(params, 0)
    tmodel = CausalLMWithValueHead(GPT2MoEConfig(**arch), GPT2MoEModel, device="cpu")
    tmodel.load_state_dict(flax_to_torch(params))
    return jmodel, params, tmodel


def _inputs(B=3, T=9, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, ARCH["vocab_size"], size=(B, T)).astype(np.int32)
    lens = np.array([T, 4, 7])[:B]
    mask = (np.arange(T)[None] >= T - lens[:, None]).astype(np.int32)
    return ids, mask


def _jax_forward(jmodel, params, ids, mask):
    from trlx_tpu.models.gpt2_moe import moe_loss_summary

    out, state = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                              mutable=["moe_losses"])
    return out, moe_loss_summary(state["moe_losses"])


def test_convert_carries_the_switch_leaves(models):
    _, params, tmodel = models
    state = flax_to_torch(params)
    assert set(state) == set(tmodel.state_dict())
    mlp = params["transformer"]["h_1"]["mlp"]
    for leaf in ("router", "wi", "bi", "wo", "bo"):  # the flax layout, not transposed
        np.testing.assert_array_equal(state[f"transformer.h.1.mlp.{leaf}"].numpy(), mlp[leaf])
    assert "transformer.h.0.mlp.c_fc.weight" in state  # block 0 stays dense
    assert tuple(state["transformer.h.3.mlp.wi"].shape) == (4, 32, 128)


def test_forward_and_router_losses_match_jax(models):
    from trlx_tpu_torch.models.gpt2_moe import collect_moe_losses, moe_loss_summary

    jmodel, params, tmodel = models
    ids, mask = _inputs()
    want, jmoe = _jax_forward(jmodel, params, ids, mask)
    with torch.no_grad(), collect_moe_losses(tmodel) as sown:
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(sown) == 2  # blocks 1 and 3
    moe = moe_loss_summary(sown)
    for key in ("logits", "values"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=TOL, rtol=0,
                                   err_msg=key)
    for key in ("aux_loss", "router_z", "max_load"):
        np.testing.assert_allclose(float(moe[key]), float(jmoe[key]), atol=TOL, rtol=0,
                                   err_msg=key)
    # the routing is not trivial: the tokens spread over more than one expert
    assert 0.25 <= float(moe["max_load"]) < 1.0
    # outside the collection nothing is recorded (the sampler's forwards)
    with torch.no_grad():
        tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    assert all(m.losses is None for m in tmodel.modules() if hasattr(m, "losses"))


def test_cached_decode_matches_the_full_forward(models):
    """Prefill into the linear cache, then one step per position: the
    logits at each position equal the full forward's (the switch layers
    route the single decode token alike)."""
    from trlx_tpu_torch.models.gpt2 import init_cache

    _, _, tmodel = models
    ids, _ = _inputs()
    ids = torch.from_numpy(ids).long()
    B, T = ids.shape
    with torch.no_grad():
        full = tmodel(ids)["logits"]
        cache = init_cache(tmodel.config, B, T, device="cpu")
        out = tmodel(ids[:, :5], cache=cache, cache_index=0)
        steps = [out["logits"][:, -1]]
        for t in range(5, T):
            mask = torch.ones(B, T, dtype=torch.long)
            mask[:, t + 1:] = 0
            out = tmodel(ids[:, t:t + 1], attention_mask=mask, cache=cache, cache_index=t,
                         position_ids=torch.full((B, 1), t))
            steps.append(out["logits"][:, -1])
    torch.testing.assert_close(torch.stack(steps, 1), full[:, 4:], atol=TOL, rtol=0)


def test_router_and_expert_gradients_with_the_penalty_match_jax(models):
    from trlx_tpu.models.gpt2_moe import apply_router_penalty as japply
    from trlx_tpu_torch.models.gpt2_moe import (
        apply_router_penalty,
        collect_moe_losses,
        moe_loss_summary,
    )

    jmodel, params, tmodel = models
    # left-padded: the router losses average over every token, pads
    # included, so the gradient reaches the parameters through the rows
    # that see no live key as well
    ids, mask = _inputs()
    assert (mask == 0).any()
    w = np.random.default_rng(2).normal(size=(3, 9, ARCH["vocab_size"])).astype(np.float32)
    cfg = tmodel.config

    def jloss(p):
        out, moe = _jax_forward(jmodel, p, ids, mask)
        base = jnp.sum(out["logits"] * w) * 1e-2 + jnp.sum(out["values"])
        loss, _ = japply(base, {"losses/total_loss": base}, moe, cfg)
        return loss

    jgrads = flax_to_torch(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, params))))
    model = copy.deepcopy(tmodel)
    with collect_moe_losses(model) as sown:
        out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    base = (out["logits"] * torch.from_numpy(w)).sum() * 1e-2 + out["values"].sum()
    loss, stats = apply_router_penalty(base, {"losses/total_loss": base.detach()},
                                       moe_loss_summary(sown), cfg)
    loss.backward()
    assert set(stats) == {"losses/total_loss", "losses/moe_aux", "losses/router_z",
                          "moe/max_load"}
    grads = {n: p.grad for n, p in model.named_parameters()}
    for layer in (1, 3):
        for leaf in ("router", "wi", "bi", "wo", "bo"):
            name = f"transformer.h.{layer}.mlp.{leaf}"
            assert grads[name].abs().max() > 0, name
            torch.testing.assert_close(grads[name], jgrads[name], atol=TOL, rtol=1e-4,
                                       msg=name)
    for name in ("transformer.h.0.mlp.c_fc.weight", "transformer.wte.weight",
                 "v_head.fc1.weight"):
        torch.testing.assert_close(grads[name], jgrads[name], atol=TOL, rtol=1e-4, msg=name)


def test_a_model_without_switch_blocks_is_refused_in_both_packages():
    from trlx_tpu.models.gpt2_moe import GPT2MoEConfig as JConfig
    from trlx_tpu.models.gpt2_moe import GPT2MoEModel as JModel
    from trlx_tpu_torch.models.gpt2_moe import GPT2MoEConfig, GPT2MoEModel

    arch = dict(ARCH, n_layer=1, moe_every=2)
    with pytest.raises(ValueError, match="no MoE blocks"):
        JModel(JConfig(**arch)).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    with pytest.raises(ValueError, match="no MoE blocks"):
        GPT2MoEModel(GPT2MoEConfig(**arch), device="cpu")


# ----------------------------- PPO phase ----------------------------- #


def _ppo_config(ckpt_dir, **model):
    """Two blocks, block 1 a switch block (the PPO phase's JAX compile
    dominates this file's time)."""
    return config(ckpt_dir, model={"model_type": "gpt2_moe",
                                   "model_arch": dict(ARCH, n_layer=2), **model})


@pytest.fixture(scope="module")
def ppo_runs(tmp_path_factory):
    """The suite's prompts, 1 to 6 tokens left-padded to ``seq_length``:
    the router losses average over the pads too, whose query rows see no
    live key."""
    tmp = tmp_path_factory.mktemp("moe_ppo")
    assert min(map(len, prompts())) < 6
    data = (prompts(), reward_fn, None)
    jax_run = run_jax(_ppo_config(tmp / "jax"), data)
    port_run = run_port(port_trainer(_ppo_config(tmp / "port"), jax_run["init"], data))
    return jax_run, port_run, tmp


def test_ppo_phase_matches_jax(ppo_runs):
    jax_run, port_run, tmp = ppo_runs
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(port_run["buffer"][key], jax_run["buffer"][key],
                                      err_msg=key)
    for key in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(port_run["buffer"][key], jax_run["buffer"][key],
                                   atol=TOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(port_run["ref"], jax_run["ref"], atol=TOL, rtol=0)
    assert {"losses/moe_aux", "losses/router_z", "moe/max_load"} <= set(jax_run["rows"])
    assert set(port_run["rows"]) == set(jax_run["rows"])
    for key, want in jax_run["rows"].items():
        np.testing.assert_allclose(port_run["rows"][key], np.asarray(want), atol=2e-4,
                                   rtol=2e-4, err_msg=key)
    load = port_run["rows"]["moe/max_load"]
    assert ((load >= 0.25) & (load <= 1.0)).all()
    got = port_run["trainer"].model.state_dict()
    assert assert_final_params_match(got, jax_run, _ppo_config(tmp),
                                     noisy=port_run["noisy"]) > 1e-4


def test_hydra_reference_equals_the_full_copy_at_init(tmp_path):
    """The hydra branch (the top block, a switch block) from the trunk's
    activation scores the responses as the full frozen copy does while
    the trunk is still the initial one; the branch holds only the top
    block's switch layer."""
    full = port_trainer(_ppo_config(tmp_path / "full"))
    hydra = port_trainer(_ppo_config(tmp_path / "hydra", num_layers_unfrozen=1))
    assert hydra.use_hydra and not full.use_hydra
    assert sorted(n for n in hydra.ref.state_dict() if ".mlp." in n) == [
        f"h.1.mlp.{leaf}" for leaf in ("bi", "bo", "router", "wi", "wo")]
    batch, _ = next(iter(full.eval_pipeline.create_loader(8, shuffle=False)))
    out = full.sample(batch.input_ids, batch.attention_mask)
    args = (batch.input_ids, batch.attention_mask, out.tokens, out.response_mask)
    torch.testing.assert_close(hydra.score_ref(*args), full.score_ref(*args), atol=TOL, rtol=0)


def test_continuous_engine_matches_the_per_row_fixed_sampler(tmp_path):
    from test_torch_continuous_rollouts import ENGINE, drive, prompt_rows

    def trainer(name, rollout):
        cfg = _ppo_config(tmp_path / name)
        cfg["train"]["rollout"] = dict(rollout)
        cfg["method"]["gen_kwargs"]["do_sample"] = True
        return port_trainer(cfg)

    cont = trainer("cont", ENGINE)
    fixed = trainer("fixed", {"engine": "fixed", "per_row_rng": True})
    N, Q = 16, fixed.query_length
    ids, mask = prompt_rows(N, Q, seed=11)
    fixed.generator.manual_seed(42)
    fixed.reset_rollout_phase()
    outs = [fixed.sample(torch.from_numpy(ids[s:s + 8]), torch.from_numpy(mask[s:s + 8]))
            for s in range(0, N, 8)]
    want = {k: torch.cat([getattr(o, k) for o in outs]).numpy()
            for k in ("tokens", "response_mask", "logprobs", "values")}
    cont.generator.manual_seed(42)
    cont.reset_rollout_phase()
    engine = cont.rollout_engine_obj
    got = drive(engine, ids, mask, lambda: engine.start_phase(cont.rollout_phase_seed()))
    for r in range(N):
        for key in ("tokens", "response_mask", "logprobs", "values"):
            np.testing.assert_array_equal(got[r][key], want[key][r], err_msg=f"row {r} {key}")


# ----------------------------- ILQL steps ---------------------------- #


ILQL_ARCH = dict(vocab_size=12, n_positions=16, n_embd=32, n_layer=2, n_head=2, **MOE)


def _ilql_config(ckpt_dir) -> dict:
    return {
        "model": {"model_type": "gpt2_moe", "model_arch": dict(ILQL_ARCH)},
        "train": {
            "seq_length": 8, "batch_size": 16, "epochs": 1, "total_steps": 3,
            "eval_interval": 1000, "checkpoint_interval": 100000, "lr_init": 1e-3,
            "lr_target": 1e-3, "mesh": {"dp": -1, "fsdp": 1, "tp": 1}, "dtype": "float32",
            "orchestrator": "OfflineOrchestrator", "trainer": "ILQLTrainer",
            "checkpoint_dir": str(ckpt_dir),
        },
        "method": {
            "name": "ILQLConfig", "steps_for_target_q_sync": 2, "alpha": 0.5,
            "gen_kwargs": {"max_new_tokens": 6, "do_sample": False, "eos_token_id": 10,
                           "pad_token_id": 11},
        },
    }


def test_ilql_updates_match_jax(tmp_path):
    from trlx_tpu.data.configs import TRLConfig as JTRLConfig
    from trlx_tpu.utils.loading import get_orchestrator as jorch
    from trlx_tpu.utils.loading import get_trainer as jtrainer
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_trainer

    _, _, _, _, info = make_task(n_nodes=10, walk_length=6)
    samples, rewards = make_dataset(info, n_walks=64)
    jt = jtrainer("ILQLTrainer")(JTRLConfig.from_dict(_ilql_config(tmp_path / "jax")))
    jorch("OfflineOrchestrator")(jt).make_experience(samples, rewards)
    numpy = lambda tree: jax.tree_util.tree_map(np.asarray, jax.device_get(tree))  # noqa: E731
    init = {"params": numpy(jt.state.params), "target": numpy(jt.state.target_q_params)}
    jrows = []
    chunk = jt._train_chunk_jit

    def recording_chunk(state, mbs):
        state, stats = chunk(state, mbs)
        jrows.append(numpy(stats))
        return state, stats

    jt._train_chunk_jit = recording_chunk
    jt.learn()

    pt = get_trainer("ILQLTrainer")(TRLConfig.from_dict(_ilql_config(tmp_path / "port")),
                                    device="cpu")
    pt.model.load_state_dict(flax_to_torch(init["params"]))
    pt.target.load_state_dict(flax_to_torch(init["target"]))
    get_orchestrator("OfflineOrchestrator")(pt).make_experience(samples, rewards)
    prows = []
    record(pt, "train_step", prows)
    pt.learn()
    want = {k: np.concatenate([r[k] for r in jrows]) for k in jrows[0]}
    got = {k: np.array([float(r[k]) for r in prows]) for k in prows[0]}
    assert {"losses/moe_aux", "losses/router_z", "moe/max_load"} <= set(want)
    assert set(got) == set(want) and len(prows) == 3
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=2e-4, rtol=2e-4, err_msg=key)
    final = flax_to_torch(numpy(jt.state.params))
    for name, p in pt.model.state_dict().items():
        if ".mlp." in name and name.startswith("transformer.h.1."):
            torch.testing.assert_close(p, final[name], atol=1e-5, rtol=0, msg=name)


# ------------------------------ refusals ----------------------------- #


def test_hf_checkpoint_and_ep_mesh_are_refused(tmp_path):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    cfg = _ppo_config(tmp_path, model_path=str(tmp_path / "hf"))
    with pytest.raises(ValueError, match="no HF checkpoint"):
        get_trainer("PPOTrainer")(TRLConfig.from_dict(cfg), device="cpu")
    cfg = _ppo_config(tmp_path)
    cfg["train"]["mesh"] = {"dp": 1, "fsdp": 1, "tp": 1, "ep": 2}
    with pytest.raises(NotImplementedError, match="item 14.6"):
        get_trainer("PPOTrainer")(TRLConfig.from_dict(cfg), device="cpu")
