"""One rank of ``tests/test_torch_ring_attention.py``'s gloo rings.

``RANK=r WORLD_SIZE=n python tests/_torch_ring_worker.py LAYOUT STORE OUT``
starts the rank's gloo group through
``trlx_tpu_torch.parallel.distributed.initialize`` (the rank and world size
from the environment, the rendezvous through the ``file://`` store
``STORE``), builds ``make_mesh(LAYOUT)`` on the CPU and runs the port's
``ring_attention_sharded`` on its shard of :func:`ring_inputs`, causal on
and off, ``impl="flash"`` and ``"naive"``: the output and the (q, k, v)
gradients of sum(out²). It saves them, with what the mesh and the runtime
report, as ``OUT/rank<r>.pt``. Imports only torch, numpy and the port, so
the rank's process never loads JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from trlx_tpu_torch.ops.ring_attention import ring_attention_sharded
from trlx_tpu_torch.parallel import (
    BATCH_AXES,
    batch_sharding,
    local_batch_size,
    make_mesh,
    replicated,
)
from trlx_tpu_torch.parallel import distributed
from trlx_tpu_torch.parallel.mesh import AXIS_SP, AXIS_TP, local_shard

#: (causal, impl) for every case the rank runs
CASES = [(causal, impl) for causal in (True, False) for impl in ("flash", "naive")]


def case_name(causal: bool, impl: str) -> str:
    return f"{impl}_{'causal' if causal else 'full'}"


def ring_inputs(B: int, T: int = 16, H: int = 2, D: int = 8, seed: int = 0):
    """q, k, v [B, T, H, D] f32 ~ N(0, 1) from a numpy seed and kv_mask
    [B, T] int32 with a padded tail of 3 keys on row 0
    (``tests/test_ring_attention.py``'s inputs)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    kv_mask = np.ones((B, T), np.int32)
    kv_mask[0, T - 3:] = 0
    return q, k, v, kv_mask


def batch_for(layout: dict) -> int:
    """The global batch of a layout: ``tests/test_ring_attention.py``'s
    8 // sp * 2, rounded up to a multiple of the batch shards."""
    shards = layout.get("dp", 1) * layout.get("fsdp", 1)
    return max(8 // layout["sp"] * 2, shards)


def run(layout: dict) -> dict:
    rank = dist.get_rank()
    mesh = make_mesh(layout, device_type="cpu")
    q, k, v, kv_mask = (torch.from_numpy(x) for x in ring_inputs(batch_for(layout)))
    record = {
        "mesh_shape": list(mesh.shape), "dim_names": list(mesh.mesh_dim_names),
        "coordinate": list(mesh.get_coordinate()),
        "main": distributed.is_main_process(),
        "broadcast": distributed.broadcast_host_value(100 + rank),
        "local_batch": local_batch_size(mesh, 8),
        # the DTensor placements cut the batch as local_shard does, and
        # replicate whole
        "batch_sharding_ok": torch.equal(
            distribute_tensor(q, mesh, batch_sharding(mesh)).to_local(),
            local_shard(q, mesh, axis_name=AXIS_TP, batch_axes=BATCH_AXES)),
        "replicated_ok": torch.equal(
            distribute_tensor(q, mesh, replicated(mesh)).to_local(), q),
    }
    for causal, impl in CASES:
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = ring_attention_sharded(*(local_shard(x, mesh) for x in leaves), mesh,
                                     kv_mask=local_shard(kv_mask, mesh), causal=causal,
                                     impl=impl)
        out.pow(2).sum().backward()
        record[case_name(causal, impl)] = {
            "out": out.detach(),
            **{g: local_shard(x.grad, mesh) for g, x in zip(("dq", "dk", "dv"), leaves)}}
    try:
        ring_attention_sharded(q, k, v, mesh, impl="dense")
    except ValueError as err:
        record["impl_refused"] = str(err)
    distributed.barrier()
    record["sp_rank"] = dist.get_rank(mesh.get_group(AXIS_SP))
    return record


def main() -> int:
    layout, store, out_dir = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
    if not distributed.initialize("cpu", init_method=f"file://{store}"):
        raise RuntimeError("initialize started no process group")
    try:
        record = run(layout)
    finally:
        dist.destroy_process_group()
    torch.save(record, os.path.join(out_dir, f"rank{int(os.environ['RANK'])}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
