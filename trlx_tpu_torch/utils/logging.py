"""A JSON-lines stats logger (the stdout half of
:class:`trlx_tpu.utils.logging.Logger`; no wandb), with its run-health
event line."""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, Optional

from trlx_tpu_torch.utils import monotonic


class Logger:
    """``log(stats, step)`` writes one JSON object per call, with the step
    and the seconds since the logger started, to ``stream`` (stdout)."""

    def __init__(self, stream=None, enabled: bool = True):
        self.stream = stream or sys.stdout
        self.start = monotonic()
        self.enabled = enabled  # off on every rank but the first of a mesh

    def log(self, stats: Dict[str, Any], step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        row = {"step": step, "time": monotonic() - self.start}
        row.update({k: float(v) for k, v in stats.items()})
        self.stream.write(json.dumps(row) + "\n")
        self.stream.flush()

    def log_health_event(self, event: Dict[str, Any], step: Optional[int] = None) -> None:
        """Write one run-health event (:mod:`trlx_tpu_torch.telemetry.health`)
        as a ``health_event`` JSON line on the stats stream, next to the
        rows that tripped it."""
        if not self.enabled:
            return
        record = {"step": step, "time": round(monotonic() - self.start, 2),
                  "health_event": event}
        self.stream.write(json.dumps(record, default=float) + "\n")
        self.stream.flush()
