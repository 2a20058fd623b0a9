"""A JSON-lines stats logger (the stdout half of
:class:`trlx_tpu.utils.logging.Logger`; no wandb)."""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, Optional

from trlx_tpu_torch.utils import monotonic


class Logger:
    """``log(stats, step)`` writes one JSON object per call, with the step
    and the seconds since the logger started, to ``stream`` (stdout)."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stdout
        self.start = monotonic()

    def log(self, stats: Dict[str, Any], step: Optional[int] = None) -> None:
        row = {"step": step, "time": monotonic() - self.start}
        row.update({k: float(v) for k, v in stats.items()})
        self.stream.write(json.dumps(row) + "\n")
        self.stream.flush()
