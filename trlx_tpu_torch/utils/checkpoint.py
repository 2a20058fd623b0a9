"""Trainer checkpoints (the port's counterpart of
:mod:`trlx_tpu.utils.checkpoint`): one ``torch.save`` file per saved step,
``<checkpoint_dir>/<step>/state.pt``, written atomically. The Orbax layout
and the JAX package's full set of host-state carriers are ROADMAP item 8.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


def save_checkpoint(directory: str, state: Dict[str, Any], step: int) -> str:
    """Write ``state`` as step ``step``; returns the file's path."""
    step_dir = os.path.join(directory, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".pt", dir=step_dir)
    os.close(fd)
    try:
        torch.save(state, tmp)
        path = os.path.join(step_dir, STATE_FILE)
        os.replace(tmp, path)  # a reader never sees half a file
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def latest_step(directory: str) -> Optional[int]:
    """The highest step with a complete checkpoint under ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name) for name in os.listdir(directory)
        if name.isdigit() and os.path.exists(os.path.join(directory, name, STATE_FILE))
    ]
    return max(steps) if steps else None


def load_checkpoint(directory: str, device=None) -> Dict[str, Any]:
    """The latest checkpoint's state, its tensors on ``device``."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory!r}")
    return torch.load(
        os.path.join(directory, str(step), STATE_FILE),
        map_location=device, weights_only=True,
    )
