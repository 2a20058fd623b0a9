"""``torch.profiler`` windows: one chrome trace per phase (counterpart of
:mod:`trlx_tpu.telemetry.profiler`).

``train.profile_phase: N`` opens the profiler for exactly phase N (one
collect and train pair) and closes it at the phase boundary, exporting one
chrome trace into ``train.profile_dir`` (default ``profiles``) whose
timeline lines up with the span tree the tracer recorded for the same
phase. ``train.profile_dir`` without ``profile_phase`` is the legacy trace
of the first updates (:func:`start_trace` / :func:`stop_trace`, driven by
the PPO trainer).

On a CUDA device the profiler records CPU and CUDA activities (the CUDA
kernel events are the device's timeline); on the CPU, CPU activities only.
A profiler that fails to start or to export raises: a run asked to profile
never goes on unprofiled. The stop synchronises the trainer's device first,
so that the window's device work lands inside the trace; that boundary
already synchronises in every caller (the phase's stats were fetched).
"""

from __future__ import annotations

import os
from typing import Any, Optional


def start_trace(device: Any = None):
    """Start and return a ``torch.profiler.profile`` over CPU activities,
    and CUDA activities too when ``device`` is a CUDA device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device or "cpu").type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, path: str, device: Any = None) -> str:
    """Synchronise ``device`` (when CUDA), stop ``prof`` and export its
    chrome trace to ``path`` (its directory created); returns ``path``."""
    import torch

    device = torch.device(device or "cpu")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(path)
    return path


class PhaseProfiler:
    """Start/stop a ``torch.profiler`` trace around one phase.

    Drive with :meth:`on_phase_start` (before the phase's collection
    starts) and :meth:`on_phase_end` (after the phase's updates are
    fetched). Exactly one window per run. :meth:`close` from a ``finally``
    stops a still-open window (and exports what it caught, best-effort),
    so that an exception mid-phase cannot leak a running profiler into the
    next run."""

    def __init__(self, profile_dir: Optional[str], target_phase: Optional[int],
                 device: Any = None):
        self.profile_dir = profile_dir or "profiles"
        self.target = target_phase
        self.device = device
        self.active = False
        self.done = False
        self.trace_path: Optional[str] = None
        self._prof = None

    @property
    def enabled(self) -> bool:
        return self.target is not None

    def _path(self) -> str:
        return os.path.join(self.profile_dir, f"phase_{self.target}.pt.trace.json")

    def on_phase_start(self, phase_index: int) -> None:
        if not self.enabled or self.active or self.done:
            return
        if phase_index != self.target:
            return
        self._prof = start_trace(self.device)
        self.active = True

    def on_phase_end(self, sync: Any = None) -> None:
        """Close the window if one is open: synchronise ``sync`` (a
        device, default the profiler's) so that the phase's device work
        lands inside the trace, stop, and export the trace."""
        if not self.active:
            return
        prof, self._prof = self._prof, None
        self.active = False
        self.done = True  # exactly one window per run
        self.trace_path = stop_trace(prof, self._path(), sync if sync is not None else self.device)

    def close(self) -> None:
        if not self.active:
            return
        prof, self._prof = self._prof, None
        self.active = False
        try:
            self.trace_path = stop_trace(prof, self._path(), self.device)
        except Exception:
            pass  # the error that left the window open is the one to report
