"""Multi-process runtime: process-group start, barriers, host-side value
exchange (counterpart of :mod:`trlx_tpu.parallel.distributed`).

One process per device (two ranks may share one only on a backend the
caller names). A launcher (``torchrun``) sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address in the
environment; :func:`initialize` reads them. The group runs NCCL for CUDA,
and gloo only when the caller asks for the CPU: CUDA tensors never go
through gloo.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize(device_type: str = "cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Start the default process group; returns whether one is running.

    The rank and world size come from the arguments, else from the
    launcher's ``RANK`` and ``WORLD_SIZE``; ``init_method`` defaults to
    ``env://`` (the launcher's ``MASTER_ADDR``/``MASTER_PORT``). A single
    process that nothing launched and that passes none of them starts no
    group (a no-op), as does a second call. On ``"cuda"`` the group is
    NCCL and the process takes device ``LOCAL_RANK`` (else its rank modulo
    the device count); on ``"cpu"`` it is gloo. ``backend`` overrides the
    device type's backend only when the caller names one (``chip_smoke.py``
    runs two ranks that share one card on gloo, since NCCL refuses two
    ranks on one device); nothing chooses it on its own."""
    if device_type not in BACKENDS:
        raise ValueError(f"initialize: device_type must be one of {sorted(BACKENDS)}, "
                         f"got {device_type!r}")
    if dist.is_initialized():
        return True
    env_rank, env_world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if init_method is None and world_size is None and env_world is None:
        return False
    rank = int(env_rank or 0) if rank is None else rank
    world_size = int(env_world or 1) if world_size is None else world_size
    if device_type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend or BACKENDS[device_type],
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def barrier() -> None:
    """Wait for every rank (no-op in a single process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def is_main_process() -> bool:
    """Rank-0 gating for logging and IO."""
    return not dist.is_initialized() or dist.get_rank() == 0


def broadcast_host_value(value: Any):
    """``value`` as rank 0 holds it (pickled through the group), so that a
    host-side decision agrees across ranks; in a single process, itself."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]
