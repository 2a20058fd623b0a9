"""The hydra KL reference and layer freezing against the JAX package, at
``bench.py::_workload_config``'s two freezing definitions on a 4-layer
model with a 2-layer branch:

- ``(0, 2)``, the faithful one: every layer trains and a 2-layer hydra
  branch scores the KL reference (the trunk trains, so the reference
  drifts with it);
- ``(2, None)``: the bottom 2 blocks and the embeddings freeze, and the
  branch depth follows ``num_layers_unfrozen``.

Held for each (f32 on the CPU; tolerances as in
``tests/test_torch_ppo_trainer.py``): the reference holds the top blocks,
``ln_f`` and ``wte`` only, named as the JAX trainer's; at init it scores
what the policy scores; one scoring runs the trunk below the branch point
only, then the branch; a greedy PPO phase through both ``learn()``s gives
exact tokens, reference logprobs and rewards within 1e-5 and the final
parameters within the shared bounds; frozen parameters come out
bit-identical and hold no Adam state. The model-level hydra arguments
(``capture_hidden_at``, ``start_layer``, ``hidden_override``) are held
against the JAX ``GPT2Model``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ppo_phase import assert_final_params_match, config, port_trainer, run_jax, run_port
from trlx_tpu_torch.models.convert import flax_to_torch

N_LAYER = 4
DEFINITIONS = {  # (num_layers_unfrozen, ref_branch_layers), as bench.py names them
    "faithful_0_2": {"num_layers_unfrozen": 0, "ref_branch_layers": 2},
    "frozen_2_none": {"num_layers_unfrozen": 2},
}


def _config(tmp_path, name):
    return config(tmp_path, n_layer=N_LAYER, model=DEFINITIONS[name])


@pytest.fixture(scope="module", params=list(DEFINITIONS))
def runs(request, tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp(request.param)
    jax_run = run_jax(_config(tmp_path / "jax", request.param))
    cfg = _config(tmp_path / "port", request.param)
    port_run = run_port(port_trainer(cfg, jax_run["init"]))
    return request.param, cfg, jax_run, port_run


def _score_inputs(B=8, Q=6, R=4):
    rng = np.random.default_rng(0)
    q_ids = torch.from_numpy(rng.integers(0, 38, size=(B, Q)))
    q_mask = torch.ones(B, Q, dtype=torch.long)
    q_mask[1, :3] = 0  # left padding
    r_ids = torch.from_numpy(rng.integers(0, 38, size=(B, R)))
    return q_ids * q_mask, q_mask, r_ids, torch.ones(B, R, dtype=torch.long)


def test_reference_is_the_branch_subset(runs):
    _, _, jax_run, port_run = runs
    trainer = port_run["trainer"]
    assert trainer.use_hydra and trainer.branch_start == 2
    names = set(trainer.ref.state_dict())
    assert names == jax_run["ref_names"]
    assert {n.split(".")[0] for n in names} == {"wte", "ln_f", "h"}
    assert {n.split(".")[1] for n in names if n.startswith("h.")} == {"2", "3"}
    assert not any(p.requires_grad for p in trainer.ref.parameters())


def test_score_ref_matches_policy_at_init(runs):
    name, cfg, jax_run, _ = runs
    trainer = port_trainer(cfg, jax_run["init"])
    q_ids, q_mask, r_ids, r_mask = _score_inputs()
    ref = trainer.score_ref(q_ids, q_mask, r_ids, r_mask)
    with torch.no_grad():
        logits = trainer.model.transformer(
            torch.cat([q_ids, r_ids], 1), attention_mask=torch.cat([q_mask, r_mask], 1)
        )["logits"][:, q_ids.shape[1] - 1 : -1]
    want = torch.gather(torch.log_softmax(logits, -1), -1, r_ids[..., None])[..., 0]
    torch.testing.assert_close(ref, want, rtol=0, atol=1e-6)


def test_one_scoring_runs_the_trunk_below_the_branch_then_the_branch(runs):
    name, cfg, jax_run, _ = runs
    trainer = port_trainer(cfg, jax_run["init"])
    calls = {}
    for owner, module in (("policy", trainer.model.transformer), ("ref", trainer.ref)):
        for i, block in module.h.items():
            block.register_forward_hook(
                lambda *_, key=(owner, int(i)): calls.__setitem__(key, calls.get(key, 0) + 1)
            )
    trainer.score_ref(*_score_inputs())
    assert calls == {("policy", 0): 1, ("policy", 1): 1, ("ref", 2): 1, ("ref", 3): 1}


def test_rollouts_refs_and_rewards_match(runs):
    _, _, jax_run, port_run = runs
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(port_run["buffer"][key], jax_run["buffer"][key], err_msg=key)
    for key in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(port_run["buffer"][key], jax_run["buffer"][key],
                                   atol=1e-5, rtol=0, err_msg=key)
    np.testing.assert_allclose(port_run["ref"], jax_run["ref"], atol=1e-5, rtol=0)


def test_per_update_stats_match(runs):
    _, _, jax_run, port_run = runs
    for key, want in jax_run["rows"].items():
        np.testing.assert_allclose(port_run["rows"][key], np.asarray(want), atol=2e-4,
                                   rtol=2e-4, err_msg=key)
    np.testing.assert_allclose(port_run["kl_seq"], jax_run["kl_seq"], rtol=1e-6)


def test_final_params_match(runs):
    _, cfg, jax_run, port_run = runs
    moved = assert_final_params_match(port_run["trainer"].model.state_dict(), jax_run, cfg)
    assert moved > 1e-4


def test_frozen_leaves_bit_identical_without_adam_state(runs):
    name, _, jax_run, port_run = runs
    trainer = port_run["trainer"]
    init = flax_to_torch(jax_run["init"])
    frozen = {n for n, p in trainer.model.named_parameters() if not p.requires_grad}
    if name == "frozen_2_none":
        assert frozen == {n for n in init if n.startswith((
            "transformer.h.0.", "transformer.h.1.", "transformer.wte.", "transformer.wpe."))}
    else:
        assert not frozen
    state = trainer.model.state_dict()
    for n in frozen:
        assert torch.equal(state[n], init[n]), n
    trainable = [n for n in init if n not in frozen]
    assert all(not torch.equal(state[n], init[n]) for n in trainable
               if n.startswith(("transformer.h.3.", "transformer.ln_f.", "v_head.")))
    ids = {id(p) for p in trainer.opt.params}
    with_state = {id(p) for p in trainer.opt.adamw.state}
    named = dict(trainer.model.named_parameters())
    assert ids == with_state == {id(named[n]) for n in trainable}


def test_branch_depth_is_validated_naming_the_key(tmp_path):
    from trlx_tpu.data.configs import TRLConfig as JTRLConfig
    from trlx_tpu.utils.loading import get_trainer as jget_trainer
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer import get_trainer

    for model, key in (({"ref_branch_layers": 5}, "model.ref_branch_layers=5"),
                       ({"num_layers_unfrozen": 5}, "model.num_layers_unfrozen=5")):
        cfg = config(tmp_path, n_layer=N_LAYER, model=model)
        with pytest.raises(ValueError, match=key):
            get_trainer("PPOTrainer")(TRLConfig.from_dict(cfg), device="cpu")
        with pytest.raises(ValueError, match=key):
            jget_trainer("PPOTrainer")(JTRLConfig.from_dict(cfg))


def test_hydra_arguments_match_the_jax_model():
    """``capture_hidden_at`` returns the activation entering the block (and
    the port stops there); ``start_layer`` + ``hidden_override`` run the
    rest from it, on a branch that holds only those blocks."""
    from trlx_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from trlx_tpu.models.gpt2 import GPT2Model as JGPT2Model
    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    arch = dict(vocab_size=40, n_positions=32, n_embd=32, n_layer=N_LAYER, n_head=2,
                dtype="float32")
    jmodel = JGPT2Model(JGPT2Config(**arch))
    ids, mask = np.ones((3, 7), np.int32), np.ones((3, 7), np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    ids = rng.integers(0, 40, size=ids.shape).astype(np.int32)
    mask[0, :2] = 0
    model = GPT2Model(GPT2Config(**arch), device="cpu")
    model.load_state_dict(flax_to_torch(params))
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    for k in range(N_LAYER):
        jtrunk = jmodel.apply({"params": params}, ids, attention_mask=mask, capture_hidden_at=k)
        with torch.no_grad():
            trunk = model(tids, attention_mask=tmask, capture_hidden_at=k)
            assert trunk["hidden"] is None and trunk["logits"] is None
            np.testing.assert_allclose(trunk["branch_hidden"].numpy(),
                                       np.asarray(jtrunk["branch_hidden"]), atol=1e-5, rtol=0)
            branch = model.hydra_branch(k)
            assert not hasattr(branch, "wpe") and sorted(branch.h) == [str(i) for i in range(k, N_LAYER)]
            out = branch(tids, attention_mask=tmask, start_layer=k,
                         hidden_override=trunk["branch_hidden"])
        jout = jmodel.apply({"params": params}, ids, attention_mask=mask, start_layer=k,
                            hidden_override=jtrunk["branch_hidden"])
        for key in ("hidden", "logits"):
            np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), atol=1e-5,
                                       rtol=0, err_msg=f"{key} from block {k}")
        np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jtrunk["logits"]),
                                   atol=1e-5, rtol=0)  # the branch equals the full pass
