"""The port's sweep (``trlx_tpu_torch/sweep/``), ``TRLConfig.update`` and its
random-walks example against the JAX package's (``trlx_tpu/sweep/``,
``trlx_tpu/data/configs.py``, ``examples/randomwalks.py``).

- Every strategy draws the same values from the same ``random.Random``;
  both sweep ymls and a grid + random space give the JAX executor's trials
  for the same seed, and the same best.
- Both CLIs, on one dummy script, write the same results JSON; the port's
  ``--device`` reaches the script's ``main``; ``--server-address`` is
  refused without Ray and with ``--local``.
- ``TRLConfig.update`` sets and refuses as the JAX one on nested, dotted,
  bare and unknown keys.
- The port's ``make_task`` gives the example's prompts, rewards, metric
  and mask, and its ``main`` (2 updates on the CPU) returns
  ``metrics/optimality``.
"""

import json
import os
import random
import sys

import numpy as np
import pytest
import yaml

import trlx_tpu.sweep as jsweep
import trlx_tpu_torch.sweep as tsweep
from trlx_tpu.data.configs import TRLConfig as JConfig
from trlx_tpu.sweep.__main__ import cli as jcli
from trlx_tpu_torch.data.configs import TRLConfig as TConfig
from trlx_tpu_torch.sweep.__main__ import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))


@pytest.fixture(autouse=True)
def _sys_path(monkeypatch):
    """The CLIs put the script's folder on ``sys.path``: undone after each
    test."""
    monkeypatch.setattr(sys, "path", list(sys.path))


STRATEGY_CASES = {
    "uniform": [0.1, 0.5], "quniform": [0.0, 1.0, 0.25], "loguniform": [1e-5, 1e-2],
    "qloguniform": [1e-2, 1.0, 0.01], "randn": [0.0, 1.0], "qrandn": [0.0, 1.0, 0.5],
    "randint": [2, 10], "qrandint": [0, 100, 10], "lograndint": [1, 1000],
    "qlograndint": [1, 1000, 5], "choice": ["a", "b"], "grid_search": [1, 2, 3],
    "grid": [4, 5],
}


def test_strategies_are_the_jax_ones_and_draw_alike():
    assert tsweep.STRATEGIES == jsweep.STRATEGIES and set(STRATEGY_CASES) == set(
        tsweep.STRATEGIES)
    for strategy, values in STRATEGY_CASES.items():
        t, j = tsweep.ParamStrategy("x", strategy, values), jsweep.ParamStrategy(
            "x", strategy, values)
        assert t.is_grid == j.is_grid and t.grid_values() == j.grid_values(), strategy
        trng, jrng = random.Random(3), random.Random(3)
        assert [t.sample(trng) for _ in range(50)] == [j.sample(jrng) for _ in range(50)]
    for pkg in (tsweep, jsweep):
        with pytest.raises(ValueError, match="Unknown strategy"):
            pkg.ParamStrategy("x", "bogus", [1, 2])


def _yml(name):
    with open(os.path.join(ROOT, "configs", "sweeps", name)) as f:
        return yaml.safe_load(f)


SPACES = {
    "ppo_randomwalks_sweep": _yml("ppo_randomwalks_sweep.yml"),
    "ppo_sweep": _yml("ppo_sweep.yml"),
    "grid_and_random": {
        "tune_config": {"mode": "min", "metric": "loss", "num_samples": 3},
        "lr": {"strategy": "loguniform", "values": [1e-5, 1e-3]},
        "layers": {"strategy": "grid_search", "values": [2, 4]},
        "heads": {"strategy": "grid", "values": [1, 3]},
        "coef": {"strategy": "qrandn", "values": [0.0, 1.0, 0.25]},
        "kind": {"strategy": "choice", "values": ["a", "b", "c"]},
    },
}


@pytest.mark.parametrize("name", list(SPACES))
@pytest.mark.parametrize("seed", [0, 7])
def test_local_sweep_draws_the_jax_trials(name, seed):
    cfg = SPACES[name]

    def trainable(params):  # a deterministic score with a history to pop
        score = sum(v if isinstance(v, (int, float)) else len(v) for v in params.values())
        return {cfg.get("tune_config", {}).get("metric", "reward/mean"): score,
                "history": [{"step": 1}]}

    runs = {}
    for label, pkg in (("port", tsweep), ("jax", jsweep)):
        tc = pkg.get_tune_config(cfg)
        runs[label] = pkg.run_local_sweep(trainable, pkg.get_param_space(cfg), tc,
                                          seed=seed, log_fn=None)
    (tbest, ttrials), (jbest, jtrials) = runs["port"], runs["jax"]
    assert ttrials == jtrials and tbest == jbest
    assert all("history" in t and "history" not in t["result"] for t in ttrials)
    assert tsweep.get_tune_config(cfg) == jsweep.get_tune_config(cfg)


def test_search_alg_and_scheduler_names_as_jax():
    for tc in ({"search_alg": "random"}, {"search_alg": None}, {"scheduler": "fifo"}, {}):
        tc = dict(tc, mode="max", metric="m")
        assert tsweep.get_search_alg(tc) is jsweep.get_search_alg(tc) is None
        assert tsweep.get_scheduler(tc) is jsweep.get_scheduler(tc) is None
    for fn in ("get_search_alg", "get_scheduler"):
        key = "search_alg" if fn == "get_search_alg" else "scheduler"
        for pkg in (tsweep, jsweep):
            with pytest.raises(ValueError, match="Unknown"):
                getattr(pkg, fn)({key: "bogus", "mode": "max", "metric": "m"})


SCRIPT = (
    "def main(overrides, device=None):\n"
    "    assert device in (None, 'cpu')\n"
    "    return {'reward/mean': -abs(overrides['lr_init'] - 1e-4),\n"
    "            'device': 0.0 if device is None else 1.0}\n"
)


def test_both_clis_write_the_same_results(tmp_path):
    script = tmp_path / "train_script.py"
    script.write_text(SCRIPT)
    sweep_yml = tmp_path / "sweep.yml"
    sweep_yml.write_text(yaml.safe_dump({
        "tune_config": {"mode": "max", "metric": "reward/mean", "num_samples": 5},
        "lr_init": {"strategy": "loguniform", "values": [1e-5, 1e-3]},
        "vf_coef": {"strategy": "grid", "values": [0.5, 1.0]},
    }))
    outs = {}
    for label, cli in (("port", tcli), ("jax", jcli)):
        out = tmp_path / f"{label}.json"
        best = cli([str(script), "--config", str(sweep_yml), "--local", "--seed", "3",
                    "--output", str(out)])
        outs[label] = json.loads(out.read_text())
        assert best == outs[label]["best"]
    assert outs["port"] == outs["jax"] and len(outs["port"]["trials"]) == 10
    out = tmp_path / "cpu.json"
    tcli([str(script), "--config", str(sweep_yml), "--local", "--device", "cpu",
          "--output", str(out)])
    assert {t["result"]["device"] for t in json.loads(out.read_text())["trials"]} == {1.0}
    for argv in ([str(script), "--config", str(sweep_yml), "--local",
                  "--server-address", "h:1"],):
        for cli in (tcli, jcli):
            with pytest.raises(SystemExit, match="conflicts with --local"):
                cli(argv)
    try:
        import ray  # noqa: F401
    except ImportError:
        for cli in (tcli, jcli):
            with pytest.raises(SystemExit, match="requires ray"):
                cli([str(script), "--config", str(sweep_yml), "--server-address", "h:1"])


def test_wandb_failure_is_printed_not_raised(tmp_path, monkeypatch, capsys):
    from trlx_tpu_torch.sweep import wandb_report

    def failing(*a, **kw):
        raise RuntimeError("no wandb here")

    monkeypatch.setattr(wandb_report, "log_trials", failing)
    script = tmp_path / "s.py"
    script.write_text(SCRIPT)
    sweep_yml = tmp_path / "sweep.yml"
    sweep_yml.write_text(yaml.safe_dump({
        "tune_config": {"metric": "reward/mean", "num_samples": 2},
        "lr_init": {"strategy": "uniform", "values": [1e-5, 1e-3]}}))
    out = tmp_path / "r.json"
    tcli([str(script), "--config", str(sweep_yml), "--local", "--output", str(out)])
    assert len(json.loads(out.read_text())["trials"]) == 2
    assert "wandb reporting failed: RuntimeError: no wandb here" in capsys.readouterr().err


def _configs():
    path = os.path.join(ROOT, "configs", "ppo_randomwalks.yml")
    return JConfig.load_yaml(path), TConfig.load_yaml(path)


UPDATES = {
    "nested": {"train": {"lr_init": 1e-5, "batch_size": 8},
               "method": {"ppo_epochs": 2, "gen_kwargs": {"top_k": 3, "extra": 1}},
               "model": {"model_arch": {"n_layer": 2}}},
    "nested_training_key": {"train": {"mesh": {"dp": 2}, "seed": 4}},
    "dotted": {"train.lr_init": 3e-4, "method.init_kl_coef": 0.02,
               "model.num_layers_unfrozen": 1},
    "bare": {"lr_init": 1e-3, "init_kl_coef": 0.07, "ppo_epochs": 2, "vf_coef": 0.5,
             "model_type": "gpt2"},
    "unknown_bare": {"lr_init": 1e-3, "not_a_key": 1},
    "unknown_dotted": {"train.not_a_key": 1},
    "unknown_nested": {"train": {"not_a_key": 1, "lr_init": 2.0}},
    "unknown_section": {"nowhere.lr_init": 1},
}


@pytest.mark.parametrize("name", list(UPDATES))
def test_update_agrees_with_the_jax_config(name):
    jcfg, tcfg = _configs()
    kwargs = UPDATES[name]
    errors = []
    for cfg in (jcfg, tcfg):
        try:
            cfg.update(**json.loads(json.dumps(kwargs)))
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    if errors[0] is not None:
        assert "Unknown config keys" in errors[0]
        return
    want, got = jcfg.to_dict(), tcfg.to_dict()
    for section in ("model", "train", "method"):
        for key, value in got[section].items():
            if key in want[section]:
                assert value == want[section][key] or (
                    isinstance(value, tuple) and list(value) == list(want[section][key])
                ), (section, key, value, want[section][key])
    if name == "nested_training_key":  # merged into the yml's mesh, as in JAX
        assert tcfg.train.training["mesh"] == jcfg.train.mesh == {"dp": 2, "fsdp": 1, "tp": 1}


def test_make_task_is_the_example():
    from randomwalks import make_task as jmake_task

    from trlx_tpu_torch.examples.randomwalks import make_task

    want, got = jmake_task(), make_task()
    for key in ("adj", "dists", "goal", "n_nodes", "walk_length"):
        np.testing.assert_array_equal(got[4][key], want[4][key], err_msg=key)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[3], want[3])
    adj = want[4]["adj"]
    rng = np.random.default_rng(0)
    samples, queries = ["", "21 0"], ["1", "2"]
    for start in range(1, 21):
        walk, node = [], start
        for _ in range(int(rng.integers(1, 10))):
            node = int(rng.choice(np.nonzero(adj[node])[0])) if rng.random() < 0.8 else int(
                rng.integers(0, 21))
            walk.append(node)
        samples.append(" ".join(map(str, walk)))
        queries.append(str(start))
    rewards = want[0](samples, queries)
    assert got[0](samples, queries) == rewards and 0 < sum(r > 0 for r in rewards)
    assert got[1](samples) == want[1](samples)


def test_main_returns_optimality(tmp_path, monkeypatch):
    """``main`` on ``configs/ppo_randomwalks.yml`` cut to 2 updates of one
    64-rollout collect and one block returns the sweep's metric (the card
    runs the sweep yml on the uncut yml); the CLI imports it by path."""
    from trlx_tpu_torch.examples import randomwalks
    from trlx_tpu_torch.sweep.__main__ import import_main

    assert import_main(randomwalks.__file__).__name__ == "main"
    monkeypatch.chdir(tmp_path)  # the yml's checkpoint_dir is relative
    stats = randomwalks.main({"total_steps": 2, "epochs": 1, "eval_interval": 1000,
                              "num_rollouts": 64, "chunk_size": 64,
                              "model_arch": {"n_layer": 1}}, device="cpu")
    assert np.isfinite(stats["metrics/optimality"]) and 0 <= stats["metrics/optimality"] <= 1


def test_sentiments_trainable_states_its_checkpoint_requirement(tmp_path, monkeypatch):
    from trlx_tpu_torch.sweep import train_funcs

    monkeypatch.chdir(tmp_path)  # the yml's lvwerra/gpt2-imdb is not a directory here
    with pytest.raises(FileNotFoundError, match="model.model_path"):
        train_funcs.ppo_sentiments_train({"lr_init": 1e-5}, device="cpu")
    with pytest.raises(ValueError, match="Unknown config keys"):
        train_funcs.ppo_sentiments_train({"not_a_key": 1}, device="cpu")
    assert train_funcs.lexicon_sentiment(["A great, fun film", "boring and bad", ""]) == [
        2.0, -2.0, 0.0]
