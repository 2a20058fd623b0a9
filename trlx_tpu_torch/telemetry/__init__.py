"""Run telemetry (counterpart of :mod:`trlx_tpu.telemetry`): run-health
monitoring (:mod:`~trlx_tpu_torch.telemetry.health`), the crash-forensics
flight recorder (:mod:`~trlx_tpu_torch.telemetry.flight_recorder`) and the
card's allocator gauges (:mod:`~trlx_tpu_torch.telemetry.device_metrics`).
The tracer, the metrics registry, the run ledger, attribution and the
trace and request reports are ROADMAP item 19.
"""
