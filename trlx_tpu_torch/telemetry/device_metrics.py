"""Device-memory metrics from the card's caching allocator (counterpart of
:mod:`trlx_tpu.telemetry.device_metrics`).

:func:`device_memory_stats` reads ``torch.cuda.memory_stats()`` per visible
device and :func:`snapshot` aggregates it under the JAX module's gauge
names (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``,
``largest_alloc_size``, ``num_allocs``); :func:`phase_memory_stats` is
the per-phase ``mem/*`` row the trainer logs and the metrics registry
absorbs. Everything is empty on a machine
without a CUDA device, so callers log unconditionally and the keys vanish
on the CPU, as they do on the JAX package's CPU backend. Reading the
allocator's counters is host bookkeeping: it synchronises nothing.
"""

from __future__ import annotations

from typing import Dict, List

# allocator gauges surfaced when present: the max across devices (the
# binding device)
_GAUGE_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
               "largest_alloc_size", "bytes_limit", "bytes_reservable_limit")
# monotonically increasing counters: the sum across devices
_COUNTER_KEYS = ("num_allocs",
                 "bytes_transferred_to_device",
                 "bytes_transferred_from_device")
#: the JAX gauge names and the ``torch.cuda.memory_stats`` keys they read
_TORCH_KEYS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "bytes_reserved": "reserved_bytes.all.current",
    "num_allocs": "allocation.all.allocated",
}


def device_memory_stats() -> List[Dict[str, int]]:
    """Per visible CUDA device, its allocator counters under the JAX
    names; ``[]`` without a CUDA device or when the API raises."""
    try:
        import torch

        if not torch.cuda.is_available():
            return []
        out = []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out.append({name: int(stats[key]) for name, key in _TORCH_KEYS.items()
                        if key in stats})
            out[-1]["bytes_limit"] = int(torch.cuda.get_device_properties(i).total_memory)
        return out
    except Exception:
        return []


def snapshot() -> Dict[str, int]:
    """Aggregated allocator gauges across devices: the max per gauge and
    the sum per counter; ``{}`` on the CPU."""
    per_device = device_memory_stats()
    if not per_device:
        return {}
    agg: Dict[str, int] = {}
    for key in _GAUGE_KEYS:
        vals = [s[key] for s in per_device if key in s]
        if vals:
            agg[key] = max(vals)
    for key in _COUNTER_KEYS:
        vals = [s[key] for s in per_device if key in s]
        if vals:
            agg[key] = sum(vals)
    return agg



def phase_memory_stats(prefix: str = "mem/") -> Dict[str, float]:
    """Loggable per-phase memory stats under the JAX package's names
    (``mem/hbm_live_bytes``, ``mem/hbm_peak_bytes``): the allocator's live
    and peak bytes on the most-loaded device, logged beside the phase's
    span durations; empty on the CPU."""
    agg = snapshot()
    out: Dict[str, float] = {}
    if "bytes_in_use" in agg:
        out[f"{prefix}hbm_live_bytes"] = float(agg["bytes_in_use"])
    if "peak_bytes_in_use" in agg:
        out[f"{prefix}hbm_peak_bytes"] = float(agg["peak_bytes_in_use"])
    return out
