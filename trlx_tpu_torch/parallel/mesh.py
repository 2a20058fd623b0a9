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
port runs ``sp`` (ring attention, over a ``DeviceMesh``) and ``dp``,
``fsdp`` and ``tp`` in the PPO-family trainers, over the process groups of
:class:`MeshGroups`: the data group (``dp`` x ``fsdp``, dp major: each
rank's rows of the global batch, :meth:`MeshGroups.rows`, and the rollout
store's row gather, :meth:`MeshGroups.gather_rows`), the ``fsdp`` group
(parameter shards), the ``tp`` group (tensor parallelism) and the world.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

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


class MeshGroups:
    """This rank's place in the mesh of ``sizes`` (every axis's size, as
    :func:`mesh_sizes` gives them) and the process groups over each set of
    axes the trainers reduce over: :meth:`group` of ``("dp", "fsdp")`` is
    the data group, ordered dp major, so that a rank's index in it is its
    data shard. Every rank builds every group (``new_group`` is
    collective), in the same order; a set of axes whose size is 1 has no
    group (``None``). Without a process group the world is one rank."""

    #: the axis sets whose groups are built
    GROUP_AXES = ((AXIS_DP,), (AXIS_FSDP,), (AXIS_TP,), BATCH_AXES)

    def __init__(self, sizes: Dict[str, int]):
        self.sizes = dict(sizes)
        self.world = math.prod(self.sizes[a] for a in AXES)
        running = dist.is_initialized()
        if (dist.get_world_size() if running else 1) != self.world:
            raise ValueError(f"mesh {self.sizes} needs {self.world} ranks, the world has "
                             f"{dist.get_world_size() if running else 1}")
        self.rank = dist.get_rank() if running else 0
        self.coord = dict(zip(AXES, _unravel(self.rank, [self.sizes[a] for a in AXES])))
        self._groups: Dict[Tuple[str, ...], object] = {}
        for axes in self.GROUP_AXES:
            if self.size(*axes) > 1:
                self._groups[axes] = self._build(axes)
        self.world_group = dist.group.WORLD if self.world > 1 else None

    def _build(self, axes: Tuple[str, ...]):
        others = [a for a in AXES if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(self.sizes[a]) for a in others)):
            coord = dict(zip(others, fixed))
            ranks = []
            for inner in itertools.product(*(range(self.sizes[a]) for a in axes)):
                coord.update(zip(axes, inner))
                ranks.append(_ravel([coord[a] for a in AXES], [self.sizes[a] for a in AXES]))
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def size(self, *axes: str) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def index(self, *axes: str) -> int:
        """This rank's index in the group over ``axes`` (the first major)."""
        return _ravel([self.coord[a] for a in axes], [self.sizes[a] for a in axes])

    def group(self, *axes: str):
        """The process group over ``axes``; ``None`` when their size is 1."""
        return self._groups.get(tuple(axes)) if self.size(*axes) > 1 else None

    @property
    def data_size(self) -> int:
        return self.size(*BATCH_AXES)

    @property
    def data_index(self) -> int:
        return self.index(*BATCH_AXES)

    @property
    def data_group(self):
        return self.group(*BATCH_AXES)

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (its data shard);
        raises when the data shards do not divide ``n``."""
        if n % self.data_size:
            raise ValueError(f"a batch of {n} rows does not split into {self.data_size} "
                             "data shards (dp x fsdp)")
        b = n // self.data_size
        return slice(b * self.data_index, b * (self.data_index + 1))

    @property
    def is_data_leader(self) -> bool:
        """Whether this rank is its data shard's first (every axis but dp
        and fsdp at 0): the rank that runs the host work a shard's rows
        need once, such as the reward function."""
        return all(self.coord[a] == 0 for a in AXES if a not in BATCH_AXES)

    def gather_data_objects(self, obj) -> list:
        """Each data shard's leader's ``obj``, in data-shard order (every
        rank calls it; the others' objects are dropped)."""
        from trlx_tpu_torch.parallel.collectives import all_gather_object

        objs = all_gather_object(obj, self.world_group)
        dims = [self.sizes[a] for a in AXES]
        leaders = []
        for d in range(self.data_size):
            coord = dict.fromkeys(AXES, 0)
            coord.update(zip(BATCH_AXES, _unravel(d, [self.sizes[a] for a in BATCH_AXES])))
            leaders.append(_ravel([coord[a] for a in AXES], dims))
        return [objs[r] for r in leaders]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data shard's rows of ``x`` [b, ...], concatenated in shard
        order: the global batch [b * data_size, ...] on every rank."""
        from trlx_tpu_torch.parallel.collectives import all_gather

        return all_gather(x, self.data_group, 0)


def _unravel(index: int, dims: Sequence[int]):
    out = []
    for d in reversed(dims):
        out.append(index % d)
        index //= d
    return tuple(reversed(out))


def _ravel(coord: Sequence[int], dims: Sequence[int]) -> int:
    index = 0
    for c, d in zip(coord, dims):
        index = index * d + c
    return index
