"""Multi-process smoke worker: one rank of an N-process sharded PPO step
(counterpart of :mod:`trlx_tpu.parallel._mp_smoke`).

Every rank starts the process group
(:func:`~trlx_tpu_torch.parallel.distributed.initialize`: NCCL on the
card, one device per rank; gloo with ``--device cpu``), passes a startup
barrier and a host-value broadcast, builds the port's ``PPOTrainer`` on a
mesh over all ranks (``tp = 2`` when the world is even, ``fsdp = 2`` when
it divides by 4, ``dp`` the rest) and runs one sharded PPO step: each rank
samples its rows of one global batch, scores the reference, the rollouts
are gathered, and one update runs on the global minibatch, its collectives
over the dp, fsdp and tp groups. Rank 0 prints ``mp_smoke ok: procs=N``
with the mesh and the (global) loss. Imports only torch and the port.

Run one process per rank with the launcher's environment::

    torchrun --nproc_per_node 2 -m trlx_tpu_torch.parallel._mp_smoke
    RANK=r WORLD_SIZE=2 python -m trlx_tpu_torch.parallel._mp_smoke \\
        --device cpu --init-method file:///tmp/store
"""

from __future__ import annotations

import argparse
import math
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="'cpu' for gloo ranks (default: CUDA)")
    parser.add_argument("--init-method", default=None,
                        help="rendezvous URL (default: the launcher's env://)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.ppo_types import PPORolloutBatch
    from trlx_tpu_torch.parallel.distributed import (
        barrier,
        broadcast_host_value,
        initialize,
        is_main_process,
    )
    from trlx_tpu_torch.trainer import get_trainer

    device_type = "cpu" if args.device == "cpu" else "cuda"
    if not initialize(device_type, init_method=args.init_method):
        raise RuntimeError("mp_smoke: no launcher environment (RANK, WORLD_SIZE)")
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        barrier()  # startup
        value = broadcast_host_value(1234 if rank == 0 else -1)
        assert int(value) == 1234, value
        tp = 2 if world % 2 == 0 else 1
        fsdp = 2 if world % 4 == 0 else 1
        dp = world // (tp * fsdp)
        B, Q, R = max(dp * fsdp * 2, 8), 8, 6
        config = TRLConfig.from_dict({
            "model": {"model_type": "gpt2", "model_arch": {
                "vocab_size": 256, "n_positions": 32, "n_embd": 128, "n_layer": 2,
                "n_head": 4}},
            "train": {"seq_length": Q, "batch_size": B, "dtype": "float32",
                      "mesh": {"dp": dp, "fsdp": fsdp, "tp": tp}},
            "method": {"name": "PPOConfig", "num_rollouts": B, "chunk_size": B,
                       "gen_kwargs": {"max_new_tokens": R, "do_sample": True,
                                      "eos_token_id": 254, "pad_token_id": 255}},
        })
        trainer = get_trainer("PPOTrainer")(config, reward_fn=lambda **kw: [0.0],
                                            device=args.device)
        assert trainer.mesh is not None and trainer.mesh.world == world
        # identical host inputs on every rank; each samples its rows
        rng = np.random.default_rng(0)
        prompt_ids = torch.as_tensor(rng.integers(1, 250, size=(B, Q)), dtype=torch.int32)
        prompt_mask = torch.ones((B, Q), dtype=torch.int32)
        out = trainer.sample(prompt_ids, prompt_mask)
        dev = trainer.device
        ref_lp = trainer.score_ref(trainer.local_rows(prompt_ids).to(dev),
                                   trainer.local_rows(prompt_mask).to(dev),
                                   out.tokens, out.response_mask)
        out, ref_lp = trainer.gather_sample(out), trainer.gather_rows(ref_lp)
        rewards = trainer.compute_rewards(out.logprobs, ref_lp, out.response_mask,
                                          np.zeros((B,), np.float32))
        mb = PPORolloutBatch(
            query_tokens=prompt_ids.to(dev), query_mask=prompt_mask.to(dev),
            response_tokens=out.tokens, response_mask=out.response_mask,
            logprobs=out.logprobs, values=out.values, rewards=rewards,
        )
        stats = trainer.train_step(mb)
        loss = float(stats["losses/total_loss"])
        assert math.isfinite(loss), loss
        barrier()  # done
        if is_main_process():
            print(f"mp_smoke ok: procs={world} mesh dp={dp} fsdp={fsdp} tp={tp} "
                  f"loss={loss:.4f}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
