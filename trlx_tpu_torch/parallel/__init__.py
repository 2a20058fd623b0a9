"""Parallelism layer: the device mesh and the process runtime (counterpart
of :mod:`trlx_tpu.parallel`'s ``mesh`` and ``distributed``). Partitioning,
collectives, the pipeline and MoE are not ported yet (ROADMAP item 14)."""

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
