"""Device mesh construction and axis conventions (counterpart of
:mod:`trlx_tpu.parallel.mesh`).

One ``torch.distributed.device_mesh.DeviceMesh`` over six named axes, in
the TPU package's order, with one process (rank) per device:

- ``dp``   — data parallel: batch sharded, parameters replicated;
- ``fsdp`` — fully-sharded data parallel: batch and parameters sharded;
- ``tp``   — tensor parallel;
- ``sp``   — sequence parallel (ring attention, ``ops/ring_attention.py``);
- ``pp``   — pipeline parallel;
- ``ep``   — expert parallel.

Ranks fill the mesh in row-major order, as the TPU package reshapes its
device list, so ``sp`` neighbours are adjacent ranks. Of these axes the
port runs ``sp`` (ring attention) and ``dp``/``fsdp`` as batch sharding of
its inputs; the trainers still refuse any mesh larger than one device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_PP = "pp"
AXIS_EP = "ep"
#: the mesh's axes, in the TPU package's order
AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP, AXIS_SP, AXIS_PP, AXIS_EP)
#: data is sharded over both dp and fsdp (dp major)
BATCH_AXES = (AXIS_DP, AXIS_FSDP)


def mesh_sizes(mesh_config: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """Every axis's size for ``n`` devices from ``{"dp": -1, "sp": 2, ...}``
    (``dp`` defaults to -1, the others to 1). Exactly one axis may be -1,
    "all remaining devices". Raises the TPU package's ``ValueError`` on an
    unknown axis, two wildcards, a count the fixed axes do not divide, or
    a product that is not ``n``."""
    mesh_config = dict(mesh_config or {})
    sizes = {axis: mesh_config.get(axis, -1 if axis == AXIS_DP else 1) for axis in AXES}
    unknown = set(mesh_config) - set(sizes)
    if unknown:
        raise ValueError(f"Unknown mesh axes: {sorted(unknown)}")
    wildcard = [k for k, v in sizes.items() if v == -1]
    if len(wildcard) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {wildcard}")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wildcard:
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes product {fixed}")
        sizes[wildcard[0]] = n // fixed
    elif fixed != n:
        raise ValueError(f"Mesh {sizes} needs {fixed} devices, have {n}")
    return sizes


def make_mesh(mesh_config: Optional[Dict[str, int]] = None,
              device_type: str = "cuda") -> "torch.distributed.device_mesh.DeviceMesh":
    """The ``DeviceMesh`` over the initialised process group's ranks with
    :func:`mesh_sizes` of its world size, its dims named :data:`AXES`.
    ``device_type`` is ``"cuda"`` (the NCCL group of
    :func:`~trlx_tpu_torch.parallel.distributed.initialize`) or ``"cpu"``
    (its gloo group). Raises when no process group is initialised: a
    single process starts a world of one with ``initialize(world_size=1,
    rank=0, init_method=...)``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call trlx_tpu_torch.parallel.distributed."
            "initialize first (world_size=1 for a single process)"
        )
    sizes = mesh_sizes(mesh_config, dist.get_world_size())
    shape = tuple(sizes[axis] for axis in AXES)
    return DeviceMesh(device_type, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The size of the mesh's axis ``axis``."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def batch_sharding(mesh) -> Tuple:
    """DTensor placements for [B, ...] data: dim 0 split over dp, then
    fsdp (dp major), every other axis replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if axis in BATCH_AXES else Replicate()
                 for axis in mesh.mesh_dim_names)


def replicated(mesh) -> Tuple:
    """DTensor placements that replicate over every axis."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def local_batch_size(mesh, global_batch_size: int) -> int:
    """Per-shard batch size; raises when the dp x fsdp shards do not
    divide ``global_batch_size``."""
    n = axis_size(mesh, AXIS_DP) * axis_size(mesh, AXIS_FSDP)
    if global_batch_size % n != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} data shards")
    return global_batch_size // n


def local_shard(x: torch.Tensor, mesh, axis_name: str = AXIS_SP,
                batch_axes: Tuple[str, ...] = BATCH_AXES) -> torch.Tensor:
    """This rank's shard of ``x`` [B, T, ...], a tensor every rank holds
    whole: B split over ``batch_axes`` (the first major), T over
    ``axis_name`` (the TPU package's ``P(batch_axes, axis_name)``). A view,
    [B / prod(batch axes), T / size(axis_name), ...]."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    b_shards, b_index = 1, 0
    for axis in batch_axes:
        b_shards, b_index = b_shards * axis_size(mesh, axis), b_index * axis_size(mesh, axis) + coord[axis]
    t_shards = axis_size(mesh, axis_name)
    B, T = x.shape[:2]
    if B % b_shards or T % t_shards:
        raise ValueError(f"local_shard: [{B}, {T}, ...] does not split into {b_shards} x "
                         f"{t_shards} shards")
    b, t = B // b_shards, T // t_shards
    return x[b * b_index:b * (b_index + 1), t * coord[axis_name]:t * (coord[axis_name] + 1)]
