"""Fault tolerance (counterpart of :mod:`trlx_tpu.resilience`):

- :mod:`~trlx_tpu_torch.resilience.chaos`: deterministic fault injection
  at named host-side sites;
- :mod:`~trlx_tpu_torch.utils.retry`: the transient-or-permanent error
  taxonomy and bounded-backoff retry around checkpoint I/O, rollout-log
  writes and server admission;
- :mod:`~trlx_tpu_torch.resilience.preemption`: SIGTERM/SIGINT become a
  drain at the next phase boundary (an emergency checkpoint, the flight
  dump and exit code 75);
- :mod:`~trlx_tpu_torch.resilience.supervisor`: ``train.resilience``'s
  bounded auto-resume from the latest good checkpoint (import it by its
  module path; it imports the checkpoint module, which imports
  :mod:`.chaos`).
"""

from trlx_tpu_torch.resilience import chaos  # noqa: F401
from trlx_tpu_torch.resilience.preemption import (  # noqa: F401
    PREEMPTION_EXIT_CODE,
    PreemptionDrain,
    PreemptionGuard,
    clear_request,
    drain_requested,
    install_guard,
    uninstall_guard,
)
