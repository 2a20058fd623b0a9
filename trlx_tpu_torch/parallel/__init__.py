"""Parallelism layer (counterpart of :mod:`trlx_tpu.parallel`): the device
mesh and its process groups (``mesh``), the process runtime
(``distributed``), parameter partitioning (``partition``) and the global
statistics and collectives of sharded training (``collectives``). The
pipeline and MoE are not ported yet (ROADMAP items 14.5 and 14.6)."""

from trlx_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_FSDP,
    AXIS_TP,
    BATCH_AXES,
    batch_sharding,
    local_batch_size,
    make_mesh,
    replicated,
)

__all__ = [
    "AXIS_DP",
    "AXIS_FSDP",
    "AXIS_TP",
    "BATCH_AXES",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "local_batch_size",
]
