"""Sweep CLI: ``python -m trlx_tpu_torch.sweep script.py --config sweep.yml``
(the port's :mod:`trlx_tpu.sweep.__main__`, after the reference's
``trlx/sweep.py``).

Imports the script's ``main`` as the trainable (called with a dict of
hyperparameter overrides; it applies them with ``TRLConfig.update`` and
returns the final stats), builds the parameter space from the sweep YAML,
and runs the trials: on Ray when it imports and ``--local`` is absent,
else on the built-in sequential executor, whose records go to
``--output`` as ``{"best", "trials"}``. ``--device cpu`` hands the
script's ``main`` ``device="cpu"`` (the trials then run the kernels'
plain versions); without it ``main`` runs on its own default, CUDA for
the port's examples.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import sys

import yaml

from trlx_tpu_torch.sweep import (
    get_param_space,
    get_tune_config,
    run_local_sweep,
    run_ray_sweep,
)


def import_main(script_path: str):
    """The script's ``main``."""
    spec = importlib.util.spec_from_file_location("sweep_script", script_path)
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.dirname(os.path.abspath(script_path)))
    spec.loader.exec_module(module)
    if not hasattr(module, "main"):
        raise ValueError(f"{script_path} must define main(overrides: dict)")
    return module.main


def cli(argv=None):
    parser = argparse.ArgumentParser(description="trlx_tpu_torch hyperparameter sweep")
    parser.add_argument("script", help="training script defining main(overrides)")
    parser.add_argument("--config", required=True, help="sweep YAML")
    parser.add_argument("--num-cpus", type=int, default=4)
    parser.add_argument("--num-gpus", type=int, default=0)
    parser.add_argument(
        "--server-address",
        default=None,
        help="remote Ray cluster address (host:port), connected via ray://",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--output", default="sweep_results.json", help="trial records output"
    )
    parser.add_argument(
        "--local",
        action="store_true",
        help="force the built-in executor even if ray is installed",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="passed to the script's main as device= (e.g. cpu); "
             "default: the script's own",
    )
    args = parser.parse_args(argv)

    with open(args.config) as f:
        sweep_config = yaml.safe_load(f)
    param_space = get_param_space(sweep_config)
    tune_config = get_tune_config(sweep_config)
    trainable = import_main(args.script)
    if args.device is not None:
        trainable = functools.partial(trainable, device=args.device)

    use_ray = not args.local
    if use_ray:
        try:
            import ray  # noqa: F401
        except ImportError:
            if args.server_address:
                raise SystemExit(
                    "--server-address requires ray to be installed "
                    "(pip install ray[tune])"
                )
            use_ray = False
    elif args.server_address:
        raise SystemExit("--server-address conflicts with --local")

    if use_ray:
        best, results = run_ray_sweep(
            trainable, param_space, tune_config, args.num_cpus, args.num_gpus,
            server_address=args.server_address,
        )
        print(f"best config: {best.config}")
    else:
        best, trials = run_local_sweep(
            trainable, param_space, tune_config, seed=args.seed
        )
        with open(args.output, "w") as f:
            json.dump({"best": best, "trials": trials}, f, indent=2, default=float)
        try:
            # replay the trials into wandb runs, then the report, under one
            # project, or the report's runsets would query another
            from trlx_tpu_torch.sweep.wandb_report import create_report, log_trials

            project = os.environ.get("WANDB_PROJECT", "trlx_tpu_torch-sweeps")
            log_trials(trials, tune_config, project=project)
            create_report(
                project,
                param_space,
                tune_config.get("metric", "reward/mean"),
                trials,
                best,
            )
        except Exception as e:
            # best-effort, never silent: the records are already on disk
            print(f"wandb reporting failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
    return best


if __name__ == "__main__":
    cli()
