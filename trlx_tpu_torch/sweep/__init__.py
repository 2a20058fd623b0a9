"""Hyperparameter sweeps (the port's copy of :mod:`trlx_tpu.sweep`, which
follows the reference's ``trlx/sweep.py`` and ``trlx/ray_tune/``).

The same YAML schema (``configs/sweeps/*.yml``): a ``tune_config`` section
(metric, mode, search_alg, scheduler, num_samples) and one ``{strategy,
values}`` entry per hyperparameter, over the reference's 13 strategies.
Two executors:

- **Ray Tune** when ray imports: ``tune.Tuner`` with resources, as the
  reference;
- **the built-in sequential executor** otherwise: the grid of the grid
  strategies times random draws of the rest from ``random.Random(seed)``,
  in the JAX executor's order (the same seed draws the same trials), each
  trial one ``main(overrides) -> final stats`` call in this process, the
  best by the metric.
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

STRATEGIES = (
    "uniform",
    "quniform",
    "loguniform",
    "qloguniform",
    "randn",
    "qrandn",
    "randint",
    "qrandint",
    "lograndint",
    "qlograndint",
    "choice",
    "grid_search",
    "grid",
)


@dataclass
class ParamStrategy:
    """One hyperparameter's search strategy (`ray_tune/__init__.py:35-82`)."""

    name: str
    strategy: str
    values: List[Any]

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"Unknown strategy {self.strategy!r} for {self.name!r}; "
                f"valid: {STRATEGIES}"
            )

    @property
    def is_grid(self) -> bool:
        return self.strategy in ("grid_search", "grid")

    def grid_values(self) -> List[Any]:
        return list(self.values)

    def sample(self, rng: random.Random) -> Any:
        s, v = self.strategy, self.values
        if s == "uniform":
            return rng.uniform(v[0], v[1])
        if s == "quniform":
            return round(rng.uniform(v[0], v[1]) / v[2]) * v[2]
        if s == "loguniform":
            return math.exp(rng.uniform(math.log(v[0]), math.log(v[1])))
        if s == "qloguniform":
            x = math.exp(rng.uniform(math.log(v[0]), math.log(v[1])))
            return round(x / v[2]) * v[2]
        if s == "randn":
            return rng.gauss(v[0], v[1])
        if s == "qrandn":
            return round(rng.gauss(v[0], v[1]) / v[2]) * v[2]
        if s == "randint":
            return rng.randrange(int(v[0]), int(v[1]))
        if s == "qrandint":
            x = rng.randrange(int(v[0]), int(v[1]))
            q = int(v[2])
            return (x // q) * q
        if s == "lograndint":
            return int(math.exp(rng.uniform(math.log(v[0]), math.log(v[1]))))
        if s == "qlograndint":
            x = int(math.exp(rng.uniform(math.log(v[0]), math.log(v[1]))))
            q = int(v[2])
            return (x // q) * q
        if s in ("choice", "grid_search", "grid"):
            return rng.choice(list(v))
        raise AssertionError(s)

    def to_ray(self):
        from ray import tune

        s, v = self.strategy, self.values
        mapping: Dict[str, Callable] = {
            "uniform": lambda: tune.uniform(*v),
            "quniform": lambda: tune.quniform(*v),
            "loguniform": lambda: tune.loguniform(*v),
            "qloguniform": lambda: tune.qloguniform(*v),
            "randn": lambda: tune.randn(*v),
            "qrandn": lambda: tune.qrandn(*v),
            "randint": lambda: tune.randint(*v),
            "qrandint": lambda: tune.qrandint(*v),
            "lograndint": lambda: tune.lograndint(*v),
            "qlograndint": lambda: tune.qlograndint(*v),
            "choice": lambda: tune.choice(v),
            "grid_search": lambda: tune.grid_search(list(v)),
            "grid": lambda: tune.grid_search(list(v)),
        }
        return mapping[s]()


def get_param_space(config: Dict[str, Any]) -> Dict[str, ParamStrategy]:
    """YAML dict (minus ``tune_config``) -> param strategies
    (`ray_tune/__init__.py:4-87`)."""
    space = {}
    for name, spec in config.items():
        if name == "tune_config":
            continue
        space[name] = ParamStrategy(name, spec["strategy"], spec["values"])
    return space


def get_tune_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize the ``tune_config`` section (`ray_tune/__init__.py:152-165`)."""
    tune_config = dict(config.get("tune_config", {}))
    tune_config.setdefault("mode", "max")
    tune_config.setdefault("metric", "reward/mean")
    tune_config.setdefault("num_samples", 10)
    return tune_config


def run_local_sweep(
    trainable: Callable[[Dict[str, Any]], Dict[str, Any]],
    param_space: Dict[str, ParamStrategy],
    tune_config: Dict[str, Any],
    seed: int = 0,
    log_fn: Optional[Callable[[str], None]] = print,
) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Built-in executor: grid over grid-strategies x random samples of the
    rest. Returns (best trial record, all trial records)."""
    rng = random.Random(seed)
    metric = tune_config["metric"]
    mode = tune_config["mode"]
    num_samples = int(tune_config["num_samples"])

    grid_params = {k: v for k, v in param_space.items() if v.is_grid}
    rand_params = {k: v for k, v in param_space.items() if not v.is_grid}

    if grid_params:
        grid_combos = [
            dict(zip(grid_params, combo))
            for combo in itertools.product(
                *(p.grid_values() for p in grid_params.values())
            )
        ]
    else:
        grid_combos = [{}]

    trials: List[Dict[str, Any]] = []
    for combo in grid_combos:
        for _ in range(num_samples if rand_params else 1):
            params = dict(combo)
            params.update({k: p.sample(rng) for k, p in rand_params.items()})
            result = trainable(dict(params)) or {}
            # a trainable may return per-step history under "history"
            # (replayed into wandb line plots, `wandb_report.log_trials`)
            history = result.pop("history", None) if isinstance(result, dict) else None
            record = {"params": params, "result": result}
            if history:
                record["history"] = history
            trials.append(record)
            if log_fn:
                log_fn(f"[sweep] trial {len(trials)}: {params} -> "
                       f"{metric}={result.get(metric)}")

    def key(t):
        v = t["result"].get(metric)
        if v is None:
            return -float("inf") if mode == "max" else float("inf")
        return v

    best = max(trials, key=key) if mode == "max" else min(trials, key=key)
    if log_fn:
        log_fn(f"[sweep] best: {best['params']} -> {best['result'].get(metric)}")
    return best, trials


def get_search_alg(tune_config: Dict[str, Any]):
    """Search algorithm by name (`ray_tune/__init__.py:90-124`):
    ``bayesopt`` / ``bohb`` / ``random`` (None). Raises if the named
    algorithm's optional dependency is missing, as the reference does."""
    name = (tune_config.get("search_alg") or "random").lower()
    if name in ("random", "", "none"):
        return None
    mode, metric = tune_config["mode"], tune_config["metric"]
    if name == "bayesopt":
        from ray.tune.search.bayesopt import BayesOptSearch

        return BayesOptSearch(metric=metric, mode=mode)
    if name == "bohb":
        from ray.tune.search.bohb import TuneBOHB

        return TuneBOHB(metric=metric, mode=mode)
    raise ValueError(f"Unknown search_alg: {name!r} (random | bayesopt | bohb)")


def get_scheduler(tune_config: Dict[str, Any]):
    """Trial scheduler by name (`ray_tune/__init__.py:127-149`):
    ``hyperband`` (ASHA early stopping), ``bohb`` (HyperBandForBOHB — the
    scheduler TuneBOHB requires), or ``fifo`` (None). ``search_alg: bohb``
    implies the bohb scheduler when none is named."""
    name = (tune_config.get("scheduler") or "").lower()
    if not name or name in ("fifo", "none"):
        # TuneBOHB is only valid with HyperBandForBOHB — pair automatically
        if (tune_config.get("search_alg") or "").lower() == "bohb":
            name = "bohb"
        else:
            return None
    if name == "hyperband":
        from ray.tune.schedulers import AsyncHyperBandScheduler

        return AsyncHyperBandScheduler()
    if name == "bohb":
        from ray.tune.schedulers.hb_bohb import HyperBandForBOHB

        return HyperBandForBOHB()
    raise ValueError(f"Unknown scheduler: {name!r} (fifo | hyperband | bohb)")


def run_ray_sweep(trainable, param_space, tune_config, num_cpus=4, num_gpus=0,
                  server_address=None):
    """Ray Tune executor (`sweep.py:21-49`); requires ray installed.
    ``server_address`` connects to a remote cluster via the Ray client
    (reference `sweep.py:87-90`: ``ray.init("ray://...")``)."""
    import ray
    from ray import tune

    if server_address:
        # client mode rejects non-default kwargs like ignore_reinit_error
        # (the reference likewise calls ray.init("ray://...") bare)
        ray.init(address=f"ray://{server_address}")
    else:
        ray.init(ignore_reinit_error=True)
    search_alg = get_search_alg(tune_config)
    # metric/mode go to exactly one place: a pre-configured searcher already
    # carries them, and Ray rejects receiving them twice
    metric_mode = (
        {} if search_alg is not None
        else {"metric": tune_config["metric"], "mode": tune_config["mode"]}
    )
    tuner = tune.Tuner(
        tune.with_resources(trainable, resources={"cpu": num_cpus, "gpu": num_gpus}),
        param_space={k: p.to_ray() for k, p in param_space.items()},
        tune_config=tune.TuneConfig(
            num_samples=tune_config["num_samples"],
            search_alg=search_alg,
            scheduler=get_scheduler(tune_config),
            **metric_mode,
        ),
    )
    results = tuner.fit()
    # explicit metric/mode: with a pre-configured searcher TuneConfig
    # carries neither, and a bare get_best_result() would raise
    best = results.get_best_result(
        metric=tune_config["metric"], mode=tune_config["mode"]
    )
    return best, results
