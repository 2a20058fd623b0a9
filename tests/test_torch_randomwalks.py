"""The randomwalks slice: ``configs/ppo_randomwalks.yml`` and
``ilql_randomwalks.yml`` (144 wide, 6 heads of 24, the head dim the
kernels are built for since this slice) through both packages, and the
copies ``chip_smoke.py`` keeps of the example tasks (it may import neither
``examples/`` nor the JAX package).

- ``chip_smoke.py``'s copies equal ``examples/randomwalks.py``'s task and
  ``examples/ilql_randomwalks.py``'s dataset (adjacency, BFS distances,
  prompts, ``logit_mask``, the reward and metric on fixed walks, the 1000
  walks and their rewards), ``examples/pretrained_standin.py``'s token
  layout, prompts, reward and PPO config, and
  ``tests/test_torch_learning.py``'s target-token config, exactly.
- ``ppo_randomwalks.yml`` at its widths, cut to 2 blocks and 2 collects
  (16 updates), sampled, through both packages' ``learn()`` from the same
  parameters, the port's sampler handed the Gumbel noise of the JAX key
  lineage (``_torch_ppo_phase.inject_jax_noise``): the stored tokens
  exactly; logprobs and rewards 1e-5; every update's stats 2e-4 relative
  or absolute (16 sequential updates compound the order differences), the
  two clip fractions to one token of the update's minibatch (a ratio
  within rounding of the clip boundary may fall on either side); the
  final parameters by ``assert_final_params_match``, whose rounding-decided
  elements (a gradient below 1e-6 in some update) stay under 5 %; where a
  token fell on the other side of the clip boundary, every element from
  that update on to twice the learning rate summed over the updates left
  (``flipped_at``).
- ``CausalLMWithILQLHeads`` at ``ilql_randomwalks.yml``'s widths (6
  blocks): logits, Q values, values and action hidden states 1e-5 on the
  randomwalks dataset's walks.

f32 on the CPU (the JAX package on the suite's 8-device CPU mesh); the
port's CUDA kernels at D = 24 are held on the card by ``chip_smoke.py``
(phases 2, 16 and 17) and ``tests/test_torch_cuda.py``. The JAX run is
built once, at module scope.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ppo_phase import (
    assert_final_params_match,
    port_trainer,
    run_jax,
    run_port_sampled,
)
from trlx_tpu_torch.models.convert import flax_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))

import chip_smoke  # noqa: E402
import pretrained_standin  # noqa: E402
from ilql_randomwalks import make_dataset  # noqa: E402
from randomwalks import make_task  # noqa: E402

N_LAYER = 2  # the yml's 6 blocks cut to 2
N_COLLECTS = 2  # 128 rollouts a collect: 2 minibatches of 64 x 4 epochs = 8 updates


def _yml(name: str) -> dict:
    from trlx_tpu.data.configs import TRLConfig

    return TRLConfig.load_yaml(os.path.join(ROOT, "configs", name)).to_dict()


def test_task_copy_equals_the_example():
    want = make_task()
    got = chip_smoke.randomwalks_task()
    for key in ("adj", "dists", "goal", "n_nodes", "walk_length"):
        np.testing.assert_array_equal(got[4][key], want[4][key], err_msg=key)
    assert got[2] == want[2]  # the prompts: one per start node
    np.testing.assert_array_equal(got[3], want[3])  # the logit mask
    assert got[0].__name__ == want[0].__name__ == "reward_fn"
    # the reward and the metric on fixed walks: optimal, longer, invalid,
    # early eos, never reaching the goal
    adj, dists = want[4]["adj"], want[4]["dists"]
    rng = np.random.default_rng(0)
    samples, queries = [], []
    for start in range(1, 21):
        walk, node = [], start
        for _ in range(int(rng.integers(1, 10))):
            # mostly along an edge, sometimes to any node (an invalid walk)
            node = int(rng.choice(np.nonzero(adj[node])[0])) if rng.random() < 0.8 else int(
                rng.integers(0, 21))
            walk.append(node)
        samples.append(" ".join(map(str, walk)))
        queries.append(str(start))
    samples[0] = ""
    samples[1] = "21 0"
    rewards = want[0](samples, queries)
    assert got[0](samples, queries) == rewards
    assert 0 < sum(r > 0 for r in rewards) < len(rewards)
    assert got[1](samples) == want[1](samples)
    assert float(dists.max()) > 1


def test_dataset_copy_equals_the_example():
    info = make_task()[4]
    want = make_dataset(info)
    got = chip_smoke.randomwalks_dataset(info)
    assert got == want and len(got[0]) == 1000
    assert 0 < np.mean([r > 0 for r in got[1]]) < 1


def test_standin_and_guard_copies_equal_their_sources(tmp_path):
    from test_torch_learning import _target_config, _target_reward

    for name in ("VOCAB", "POS", "NEG", "EOS", "PAD"):
        assert getattr(chip_smoke, "STANDIN_" + name) == getattr(pretrained_standin, name), name
    assert (chip_smoke.standin_prompts(np.random.default_rng(1), 128, 8)
            == pretrained_standin.make_prompts(np.random.default_rng(1), 128, 8))
    samples = ["2 3 40", "", "61 59 -1", "7 7 7 33"]
    assert (chip_smoke.standin_reward(samples, samples)
            == pretrained_standin.sentiment_reward(samples, samples))
    for family in ("gpt2", "t5"):
        assert (chip_smoke.standin_rl_config("ckpt", family, checkpoint_dir="x")
                == pretrained_standin._rl_config("ckpt", family, checkpoint_dir="x"))
    assert chip_smoke.target_token_config(str(tmp_path)) == _target_config(tmp_path)
    assert chip_smoke.target_token_reward(samples, samples) == _target_reward(samples, samples)
    # the stand-ins' checkpoints, as phase 18 writes them: their head dims
    gpt2, t5 = chip_smoke.STANDIN_GPT2_HF_CONFIG, chip_smoke.STANDIN_T5_HF_CONFIG
    assert gpt2["n_embd"] // gpt2["n_head"] == 32 and t5["d_kv"] == 16


def _config(ckpt_dir) -> dict:
    cfg = _yml("ppo_randomwalks.yml")
    cfg["model"]["model_arch"]["n_layer"] = N_LAYER
    cfg["train"].update(total_steps=8 * N_COLLECTS, checkpoint_dir=str(ckpt_dir))
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("randomwalks")
    reward_fn, _, prompts, _, _ = make_task()
    data = (prompts, reward_fn, None)
    jax_run = run_jax(_config(tmp / "jax"), data, sampled=True)
    cfg = _config(tmp / "port")
    trainer = port_trainer(cfg, jax_run["init"], data)
    tokens, train_step = [], trainer.train_step

    def counted_step(mb):  # each update's live response tokens
        tokens.append(int(mb.response_mask.sum()))
        return train_step(mb)

    trainer.train_step = counted_step
    port_run = run_port_sampled(trainer, jax_run)
    port_run["update_tokens"] = tokens
    return jax_run, port_run, cfg


def test_the_yml_is_head_dim_24():
    arch = _yml("ppo_randomwalks.yml")["model"]["model_arch"]
    assert arch["n_embd"] // arch["n_head"] == 24
    assert _yml("ilql_randomwalks.yml")["model"]["model_arch"] == arch


def test_rollouts_are_token_exact(runs):
    jax_run, port_run, _ = runs
    for key in ("query_tokens", "query_mask", "response_tokens", "response_mask"):
        np.testing.assert_array_equal(port_run["buffer"][key], jax_run["buffer"][key], err_msg=key)
    # sampling reached the choice, and some walks reach the goal
    assert len({tuple(r) for r in port_run["buffer"]["response_tokens"]}) > 10
    for key in ("logprobs", "rewards"):
        np.testing.assert_allclose(port_run["buffer"][key], jax_run["buffer"][key],
                                   atol=1e-5, rtol=0, err_msg=key)


def test_every_update_matches(runs):
    jax_run, port_run, _ = runs
    assert len(port_run["phase_rows"]) == len(jax_run["phase_rows"]) == N_COLLECTS
    tokens = np.asarray(port_run["update_tokens"]).reshape(N_COLLECTS, 8)
    for got_rows, want_rows, n in zip(port_run["phase_rows"], jax_run["phase_rows"], tokens):
        assert set(got_rows) == set(want_rows)
        for key, want in want_rows.items():
            got = np.asarray(got_rows[key])
            assert got.shape == (8,), key
            if key.endswith("clipfrac"):  # one token of the minibatch either side
                assert (np.abs(got - np.asarray(want)) * n <= 1 + 1e-3).all(), (key, got, want)
            else:
                np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4,
                                           err_msg=key)


def test_final_params_match(runs):
    jax_run, port_run, cfg = runs
    trainer, noisy = port_run["trainer"], port_run["noisy"]
    assert trainer.step == 8 * N_COLLECTS
    assert sum(int(m.sum()) for m in noisy.values()) < 5e-2 * sum(
        m.numel() for m in noisy.values())
    flips = [8 * c + u + 1 for c, (got, want) in enumerate(zip(port_run["phase_rows"],
                                                              jax_run["phase_rows"]))
             for u in range(8) if any(abs(float(got[k][u]) - float(want[k][u])) > 1e-6
                                      for k in want if k.endswith("clipfrac"))]
    moved = assert_final_params_match(trainer.model.state_dict(), jax_run, cfg, noisy,
                                      flipped_at=min(flips, default=None))
    assert moved > 1e-4


def test_ilql_model_at_the_yml_width_matches_jax():
    from trlx_tpu.models import CausalLMWithILQLHeads as JaxILQL
    from trlx_tpu.models.gpt2 import GPT2Config as JaxConfig
    from trlx_tpu_torch.models.gpt2 import GPT2Config
    from trlx_tpu_torch.models.heads import CausalLMWithILQLHeads

    arch = dict(_yml("ilql_randomwalks.yml")["model"]["model_arch"], dtype="float32")
    samples, _ = make_dataset(make_task()[4], n_walks=16)
    T = max(len(s) for s, _ in samples)
    ids = np.full((16, T), 22, np.int64)
    mask = np.zeros((16, T), np.int64)
    for i, (walk, _) in enumerate(samples):
        ids[i, :len(walk)], mask[i, :len(walk)] = walk, 1
    actions = np.minimum(np.arange(1, T)[None], mask.sum(1, keepdims=True) - 1).repeat(1, 0)
    states = np.minimum(np.arange(T)[None], mask.sum(1, keepdims=True) - 1)
    jmodel = JaxILQL(JaxConfig(**arch), two_qs=True)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(ids[:, :4]))["params"]
    want = jmodel.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                        actions_ixs=jnp.asarray(actions), states_ixs=jnp.asarray(states))
    model = CausalLMWithILQLHeads(GPT2Config.from_dict(arch))
    model.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                    actions_ixs=torch.from_numpy(actions), states_ixs=torch.from_numpy(states))
    assert model.config.n_layer == 6 and model.config.n_embd // model.config.n_head == 24
    for key in ("logits", "vs", "action_hidden"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=0,
                                   err_msg=key)
    assert len(got["qs"]) == len(want["qs"]) == 2
    for g, w in zip(got["qs"], want["qs"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
