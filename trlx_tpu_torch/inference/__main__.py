"""Serving smoke: ``python -m trlx_tpu_torch.inference --smoke [--device cpu]``.

The port's counterpart of ``python -m trlx_tpu.inference --smoke``: build a
tiny random-weight GPT-2 policy, serve a prompt batch through
:class:`~trlx_tpu_torch.inference.server.InferenceServer`, and assert every
request completes with finite logprobs and values. Prints one JSON line
with the completion lengths and the engine's counters. Runs on CUDA unless
``--device cpu`` is given (and fails without CUDA otherwise).
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def tiny_config_dict() -> dict:
    """A tiny PPO config (the JAX package's test-harness shapes)."""
    return {
        "model": {
            "model_type": "gpt2",
            "model_arch": {
                "vocab_size": 32, "n_positions": 32, "n_embd": 32,
                "n_layer": 2, "n_head": 2,
            },
        },
        "train": {
            "seq_length": 8, "batch_size": 8, "dtype": "float32",
            "rollout": {
                "slots": 4, "admit_width": 2, "harvest_width": 2,
                "block_size": 4,
            },
        },
        "method": {
            "name": "PPOConfig",
            "gen_kwargs": {
                "max_new_tokens": 6, "do_sample": True,
                "eos_token_id": 30, "pad_token_id": 31,
            },
        },
    }


def serving_smoke(device=None, n_prompts: int = 6) -> int:
    import numpy as np

    from trlx_tpu_torch.inference.server import InferenceServer

    server = InferenceServer(tiny_config_dict(), seed=0, device=device)
    rng = np.random.default_rng(0)
    prompts = [
        [int(x) for x in rng.integers(1, 30, int(rng.integers(2, 8)))]
        for _ in range(n_prompts)
    ]
    ids = server.submit(prompts)
    results = server.wait(ids)
    failures = [
        rid for rid in ids
        if results[rid]["length"] < 1
        or not all(math.isfinite(x) for x in results[rid]["logprobs"])
        or not all(math.isfinite(x) for x in results[rid]["values"])
    ]
    record = {
        "device": str(server.device),
        "completed": len(ids) - len(failures),
        "submitted": len(ids),
        "lengths": [results[r]["length"] for r in ids],
        **server.stats(),
    }
    print(json.dumps(record))
    if failures:
        print(f"serving-smoke FAIL: requests {failures} incomplete or "
              "non-finite", file=sys.stderr)
        return 1
    print("serving-smoke PASS: all requests completed", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m trlx_tpu_torch.inference",
        description="continuous-batching serving utilities (PyTorch port)",
    )
    parser.add_argument(
        "--smoke", action="store_true",
        help="serve a tiny random policy and assert every request completes",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain versions)",
    )
    args = parser.parse_args(argv)
    if args.smoke:
        return serving_smoke(device=args.device)
    parser.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
