"""The ILQL slice as a whole: ``CausalLMWithILQLHeads`` and a whole greedy
``learn()`` through both packages from the same parameters and data.

Both trainers run the tiny f32 GPT-2 of ``tests/test_ilql.py``'s
``ilql_trained`` fixture (the JAX one on the suite's 8-device CPU mesh,
the port on the CPU) on the same randomwalks dataset with its adjacency
``logit_mask``: 128 walks, 6 updates of 16, target sync every 2 updates
at alpha 0.5, greedy evals at steps 0, 3 and 6. The port starts from the
JAX trainer's initial parameters and target heads.

Held, with their tolerances (f32; the frameworks sum in another order):

- the model's logits, Q values, values and action hidden states, with the
  gathers and on the ``last_only`` path: 1e-5;
- per-update stats: 2e-4 relative-or-absolute (six sequential updates
  compound the order differences), as in ``tests/test_torch_ppo_trainer.py``;
- final parameters: ``_torch_ppo_phase.assert_final_params_match`` (1e-5,
  the attention key biases to twice the summed learning rate); final
  target heads: 1e-5;
- eval tokens: exact, greedy and (after training) sampled under the JAX
  key lineage's Gumbel noise; eval metrics: exact.

Also: which parameters move under ``num_layers_unfrozen`` 0 and 1 (the
JAX package's ``unfrozen_param_mask`` with ``zero_freezes_all``), a
``save``/``load`` round trip, the refusals by name and the API's
``dataset`` branch. Every checkpoint goes to a ``tmp_path``.
"""

import copy
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ppo_phase import assert_final_params_match, record
from trlx_tpu_torch.models.convert import flax_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

from ilql_randomwalks import make_dataset  # noqa: E402
from randomwalks import make_task  # noqa: E402

ARCH = {"vocab_size": 12, "n_positions": 16, "n_embd": 32, "n_layer": 2, "n_head": 2}


def _config(ckpt_dir, **train) -> dict:
    """``tests/test_ilql.py::ilql_trained``'s config (its default learning
    rate written out), checkpoints under ``ckpt_dir``."""
    return {
        "model": {"model_type": "gpt2", "model_arch": dict(ARCH)},
        "train": {
            "seq_length": 8, "batch_size": 16, "epochs": 1, "total_steps": 6,
            "eval_interval": 3, "checkpoint_interval": 100000, "lr_init": 1e-4,
            "lr_target": 1e-4, "mesh": {"dp": -1, "fsdp": 1, "tp": 1}, "dtype": "float32",
            "orchestrator": "OfflineOrchestrator", "trainer": "ILQLTrainer",
            "checkpoint_dir": str(ckpt_dir), **train,
        },
        "method": {
            "name": "ILQLConfig", "steps_for_target_q_sync": 2, "alpha": 0.5,
            "gen_kwargs": {"max_new_tokens": 6, "do_sample": False, "eos_token_id": 10,
                           "pad_token_id": 11},
        },
    }


def _task():
    _, metric_fn, prompts, logit_mask, info = make_task(n_nodes=10, walk_length=6)
    samples, rewards = make_dataset(info, n_walks=128)
    return metric_fn, prompts, logit_mask, samples, rewards


def _jax_trainer(cfg):
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.utils.loading import get_orchestrator, get_pipeline, get_trainer

    metric_fn, prompts, logit_mask, samples, rewards = _task()
    trainer = get_trainer("ILQLTrainer")(TRLConfig.from_dict(cfg), metric_fn=metric_fn,
                                         logit_mask=logit_mask)
    get_orchestrator("OfflineOrchestrator")(trainer).make_experience(samples, rewards)
    trainer.add_eval_pipeline(get_pipeline("PromptPipeline")(prompts, trainer.query_length))
    return trainer


def port_trainer(cfg, init=None, device="cpu"):
    """The port's trainer on ``cfg`` with the randomwalks data and eval
    prompts bound; with ``init`` (the JAX params and target trees as
    numpy) it starts from those."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline, get_trainer

    metric_fn, prompts, logit_mask, samples, rewards = _task()
    trainer = get_trainer("ILQLTrainer")(TRLConfig.from_dict(cfg), metric_fn=metric_fn,
                                         logit_mask=logit_mask, device=device)
    if init is not None:
        trainer.model.load_state_dict(flax_to_torch(init["params"]))
        trainer.target.load_state_dict(flax_to_torch(init["target"]))
    get_orchestrator("OfflineOrchestrator")(trainer).make_experience(samples, rewards)
    trainer.add_eval_pipeline(get_pipeline("PromptPipeline")(prompts, trainer.query_length))
    return trainer


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ilql")
    cfg = _config(tmp / "jax")
    jt = _jax_trainer(cfg)
    init = {"params": _numpy(jt.state.params), "target": _numpy(jt.state.target_q_params)}
    jrows, jsamples = [], []
    chunk = jt._train_chunk_jit

    def recording_chunk(state, mbs):
        state, stats = chunk(state, mbs)
        jrows.append(_numpy(stats))
        return state, stats

    jt._train_chunk_jit = recording_chunk
    record(jt, "sample", jsamples)
    jevals = []
    record(jt, "evaluate", jevals)
    jt.learn()

    pcfg = _config(tmp / "port")
    pt = port_trainer(pcfg, init)
    prows, psamples, pevals = [], [], []
    record(pt, "train_step", prows)
    record(pt, "sample", psamples)
    record(pt, "evaluate", pevals)
    pt.learn()
    jax_run = {
        "init": init["params"], "params": _numpy(jt.state.params),
        "target": _numpy(jt.state.target_q_params), "init_target": init["target"],
        "rows": {k: np.concatenate([r[k] for r in jrows]) for k in jrows[0]},
        "tokens": [np.asarray(s.tokens) for s in jsamples], "evals": jevals,
    }
    port_run = {
        "rows": {k: np.array([float(r[k]) for r in prows]) for k in prows[0]},
        "tokens": [s.tokens.numpy() for s in psamples], "evals": pevals,
    }
    return jt, pt, jax_run, port_run, pcfg


def test_model_matches_jax_with_gathers_and_on_the_last_only_path(runs):
    from trlx_tpu_torch.models.gpt2 import GPT2Config
    from trlx_tpu_torch.models.heads import CausalLMWithILQLHeads

    jt, pt, jax_run, _, _ = runs
    model = CausalLMWithILQLHeads(GPT2Config.from_dict(dict(ARCH, dtype="float32")))
    model.load_state_dict(flax_to_torch(jax_run["params"]))
    mb = pt.store.stacked_slice(np.arange(16))
    kw = {k: getattr(mb, k) for k in ("attention_mask", "actions_ixs", "states_ixs")}
    with torch.no_grad():
        got = model(mb.input_ids, **kw)
        got_last = model(mb.input_ids, attention_mask=mb.attention_mask, last_only=True)
    params = jax.tree_util.tree_map(jnp.asarray, jax_run["params"])
    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    ids = jnp.asarray(mb.input_ids.numpy())
    want = jt.model.apply({"params": params}, ids, **jkw)
    want_last = jt.model.apply({"params": params}, ids, attention_mask=jkw["attention_mask"],
                               last_only=True)
    for g, w in ((got, want), (got_last, want_last)):
        for key in ("logits", "vs", "action_hidden"):
            np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]), atol=1e-5, rtol=0,
                                       err_msg=key)
        assert len(g["qs"]) == len(w["qs"]) == 2
        for gq, wq in zip(g["qs"], w["qs"]):
            np.testing.assert_allclose(gq.numpy(), np.asarray(wq), atol=1e-5, rtol=0)
    assert got_last["logits"].shape == (16, 1, ARCH["vocab_size"])
    with pytest.raises(ValueError, match="last_only"):
        model(mb.input_ids, last_only=True, actions_ixs=mb.actions_ixs)
    # the target heads map the JAX target tree's names one to one
    assert set(flax_to_torch(jax_run["target"])) == set(pt.target.state_dict())


def test_flax_to_torch_carries_the_ilql_param_tree(runs):
    from trlx_tpu_torch.models.gpt2 import GPT2Config
    from trlx_tpu_torch.models.heads import CausalLMWithILQLHeads

    _, _, jax_run, _, _ = runs
    state = flax_to_torch(jax_run["init"])
    want = CausalLMWithILQLHeads(GPT2Config.from_dict(ARCH)).state_dict()
    assert {n: tuple(t.shape) for n, t in state.items()} == {
        n: tuple(t.shape) for n, t in want.items()}
    head = jax_run["init"]["heads"]["q2_head"]["fc2"]
    np.testing.assert_array_equal(state["heads.q2_head.fc2.weight"].numpy(), head["kernel"].T)
    np.testing.assert_array_equal(state["heads.v_head.fc1.bias"].numpy(),
                                  jax_run["init"]["heads"]["v_head"]["fc1"]["bias"])


def test_flax_to_torch_carries_the_target_q_tree(runs):
    from trlx_tpu_torch.models.gpt2 import GPT2Config
    from trlx_tpu_torch.models.heads import ILQLHeads

    _, pt, jax_run, _, _ = runs
    state = flax_to_torch(jax_run["init_target"])
    want = ILQLHeads(GPT2Config.from_dict(ARCH), with_v=False).state_dict()
    assert {n: tuple(t.shape) for n, t in state.items()} == {
        n: tuple(t.shape) for n, t in want.items()}
    # the JAX trainer's initial target is its Q heads' copy, as the port's
    heads = flax_to_torch({"heads": jax_run["init"]["heads"]})
    assert all(torch.equal(t, heads["heads." + n]) for n, t in state.items())


def test_learn_matches_jax_update_for_update(runs):
    _, pt, jax_run, port_run, _ = runs
    assert pt.step == 6 and len(port_run["rows"]["losses/total_loss"]) == 6
    assert set(port_run["rows"]) == set(jax_run["rows"])
    for key, want in jax_run["rows"].items():
        np.testing.assert_allclose(port_run["rows"][key], want, rtol=2e-4, atol=2e-4,
                                   err_msg=key)


def test_final_params_and_target_heads_match_jax(runs):
    _, pt, jax_run, _, cfg = runs
    moved = assert_final_params_match(pt.model.state_dict(), jax_run, cfg)
    assert moved > 1e-5
    got = pt.target.state_dict()
    want = flax_to_torch(jax_run["target"])
    start = flax_to_torch(jax_run["init_target"])
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    # three syncs at alpha 0.5 moved the target heads
    assert any(not torch.equal(got[n], start[n]) for n in got)


def test_greedy_eval_tokens_are_exact(runs):
    _, _, jax_run, port_run, _ = runs
    assert len(port_run["tokens"]) == len(jax_run["tokens"]) == 3  # steps 0, 3 and 6
    for got, want in zip(port_run["tokens"], jax_run["tokens"]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port_run["evals"], jax_run["evals"]):
        assert {k: v for k, v in got.items() if not k.startswith("time/")} == {
            k: v for k, v in want.items() if not k.startswith("time/")}
        assert "metrics/optimality" in got and "reward/mean" not in got


def test_sampled_eval_tokens_match_under_the_jax_noise(runs):
    jt, pt, _, port_run, _ = runs
    jt.gen_config = dataclasses.replace(jt.gen_config, do_sample=True, top_k=5)
    jt._build_jitted_fns()
    pt.gen_config = dataclasses.replace(pt.gen_config, do_sample=True, top_k=5)
    pt._rebuild_sampler()
    batch, _ = next(pt.eval_pipeline.create_loader(16, drop_last=False))
    ids, mask = batch.input_ids.numpy(), batch.attention_mask.numpy()
    key = jax.random.PRNGKey(11)
    want = jt._sample_jit(jt.rollout_bundle(), jnp.asarray(ids), jnp.asarray(mask), key)
    noise, r = [], key
    for _ in range(pt.gen_config.max_new_tokens):
        r, k = jax.random.split(r)
        noise.append(np.array(jax.random.gumbel(k, (16, ARCH["vocab_size"]), jnp.float32)))
    got = pt._sampler(batch.input_ids, batch.attention_mask,
                      noise_fn=lambda t: torch.from_numpy(noise[t]))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.response_mask.numpy(), np.asarray(want.response_mask))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs), atol=1e-5, rtol=0)
    assert not got.values.any()  # the ILQL sampler reads no values
    # the noise reached the choice: the last greedy eval (same parameters
    # and prompts) decoded other tokens
    assert not np.array_equal(got.tokens.numpy(), port_run["tokens"][-1])


@pytest.mark.parametrize("unfrozen", [0, 1])
def test_freezing_moves_the_leaves_the_jax_mask_trains(runs, tmp_path, unfrozen):
    from trlx_tpu.trainer.common import unfrozen_param_mask

    _, _, jax_run, _, _ = runs
    mask = unfrozen_param_mask(jax_run["init"], unfrozen, ARCH["n_layer"], zero_freezes_all=True)
    trainable = {n for n, m in flax_to_torch(
        jax.tree_util.tree_map(lambda keep: np.asarray([keep]), mask)).items() if m.item()}
    cfg = _config(tmp_path, total_steps=2, eval_interval=1000)
    cfg["model"]["num_layers_unfrozen"] = unfrozen
    pt = port_trainer(cfg)
    start = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    pt.learn()
    moved = {n for n, p in pt.model.named_parameters() if not torch.equal(p, start[n])}
    assert moved == trainable
    assert {"transformer.wte.weight", "transformer.wpe.weight"} <= set(start) - moved
    blocks = {n.split(".")[2] for n in moved if n.startswith("transformer.h.")}
    assert blocks == (set() if unfrozen == 0 else {"1"})


def test_save_load_round_trip(runs, tmp_path):
    _, pt, _, _, cfg = runs
    pt.save(str(tmp_path))
    fresh = port_trainer(copy.deepcopy(cfg))
    fresh.load(str(tmp_path))
    for a, b in ((fresh.model, pt.model), (fresh.target, pt.target)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb) and all(torch.equal(sa[n], sb[n]) for n in sb)
    saved, loaded = pt.opt.state_dict(), fresh.opt.state_dict()
    assert loaded["count"] == saved["count"] == 6
    assert all(torch.equal(loaded["adamw"]["state"][i][k], v)
               for i, st in saved["adamw"]["state"].items() for k, v in st.items())
    assert fresh.step == pt.step == 6
    assert torch.equal(fresh.generator.get_state(), pt.generator.get_state())


REFUSALS = {
    "continuous_engine": ({"train": {"rollout": {"engine": "continuous"}}}, "no rollout engine"),
    "async_rl": ({"train": {"async_rl": {"enabled": True}}}, "async_rl"),
    "mesh": ({"train": {"mesh": {"dp": 2, "fsdp": 1, "tp": 1}}}, "item 14"),
    "pp": ({"train": {"pp_microbatches": 4}}, "item 14"),
    "resume": ({"train": {"resume_from_checkpoint": True}}, "item 18"),
    "health": ({"train": {"health": {"enabled": True}}}, "item 19"),
    "moe_family": ({"model": {"model_type": "gpt2_moe"}}, "item 13"),
    "seq2seq_family": ({"model": {"model_type": "t5"}}, "causal LM"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_unported_features_are_refused_by_name(tmp_path, name):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    override, match = REFUSALS[name]
    cfg = _config(tmp_path)
    for section, values in override.items():
        cfg[section].update(values)
    with pytest.raises(NotImplementedError, match=match):
        get_trainer("ILQLTrainer")(TRLConfig.from_dict(cfg), device="cpu")


def test_train_with_a_dataset_runs_ilql_on_the_cpu_only_when_asked(tmp_path):
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig

    _, _, _, samples, rewards = _task()
    # the default config (configs/ilql_sentiments.yml) on the default
    # device: CUDA, which this machine lacks
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trlx_tpu_torch.train(dataset=(samples, rewards))
    cfg = _config(tmp_path, total_steps=1, eval_interval=1000)
    cfg["train"].update(trainer="PPOTrainer", orchestrator="PPOOrchestrator")
    trainer = trlx_tpu_torch.train(dataset=(samples, rewards), config=TRLConfig.from_dict(cfg),
                                   device="cpu")
    assert type(trainer).__name__ == "ILQLTrainer" and trainer.step == 1
    assert (trainer.config.train.trainer, trainer.config.train.orchestrator) == (
        "ILQLTrainer", "OfflineOrchestrator")
    # eval prompts: the first 64 samples' tokens before their first action
    pipe = trainer.eval_pipeline
    assert len(pipe) == 64
    assert pipe.prompts_text[:3] == [str(s[0][0]) for s in samples[:3]]
    ppo = _config(tmp_path)
    ppo["method"] = {"name": "PPOConfig"}
    with pytest.raises(ValueError, match="ILQLConfig method"):
        trlx_tpu_torch.train(dataset=(samples, rewards), config=TRLConfig.from_dict(ppo),
                             device="cpu")
    with pytest.raises(ValueError, match="PPO method"):
        trlx_tpu_torch.train(reward_fn=lambda **k: [], prompts=[[1]],
                             config=TRLConfig.from_dict(_config(tmp_path)), device="cpu")
