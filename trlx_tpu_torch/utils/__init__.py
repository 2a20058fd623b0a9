"""Small host helpers shared across the port."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

#: the port's monotonic clock (seconds) for every host-side duration
monotonic: Callable[[], float] = time.monotonic


def resolve_device(device: Optional[object] = None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and missing —
    entry points never fall back to the CPU; callers pass ``"cpu"``
    explicitly to run the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: trlx_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain versions"
        )
    return dev
