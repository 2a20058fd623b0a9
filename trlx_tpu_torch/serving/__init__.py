"""Multi-tenant serving tier (counterpart of :mod:`trlx_tpu.serving`).

- :mod:`trlx_tpu_torch.serving.scheduler` — typed :class:`Request`s into
  per-tenant queues with token-bucket quotas, priority admission with
  aging, deadline/SLO-class ordering;
- :mod:`trlx_tpu_torch.serving.prefix_cache` — host-side radix trie +
  refcounted shared-block pool: requests with a common prompt prefix map
  their leading KV blocks onto the same published pool blocks;
- :mod:`trlx_tpu_torch.serving.spec_drafter` — the host-side draft
  proposers of speculative decoding;
- :mod:`trlx_tpu_torch.serving.streaming` — per-request bounded token
  queues fed by the engine's per-decode-step tap.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from trlx_tpu_torch.serving.scheduler import (  # noqa: F401
    DEFAULT_SLO_CLASSES,
    QoSScheduler,
    Request,
    SLOClass,
    TenantConfig,
    TokenBucket,
)
from trlx_tpu_torch.serving.prefix_cache import PrefixBlockPool  # noqa: F401
from trlx_tpu_torch.serving.spec_drafter import (  # noqa: F401
    NGramDrafter,
    TrieDrafter,
)
from trlx_tpu_torch.serving.streaming import (  # noqa: F401
    StreamRouter,
    TokenStream,
)


@dataclass(frozen=True)
class ServingConfig:
    """Parsed ``train.serving`` section.

    :param tenants: per-tenant quota/priority defaults, e.g.
        ``{"gold": {"priority": 10, "rate": 1e9, "burst": 1e9,
        "slo_class": "interactive"}}``. Unknown tenants are admitted
        under :data:`DEFAULT_TENANT` semantics (priority 0, unmetered).
    :param slo_classes: per-class queue-wait budgets overriding
        :data:`~trlx_tpu_torch.serving.scheduler.DEFAULT_SLO_CLASSES`, e.g.
        ``{"interactive": {"queue_wait_budget_ms": 200}}``.
    :param prefix_cache_blocks: shared-prefix pool size in KV blocks;
        0 disables cross-request prefix sharing.
    :param stream_buffer: per-request streamed-token queue bound.
    :param aging_half_ms: queue wait that buys one effective-priority
        point (anti-starvation aging).
    """

    tenants: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    slo_classes: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    prefix_cache_blocks: int = 0
    stream_buffer: int = 1024
    aging_half_ms: float = 1000.0

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ServingConfig":
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"Unknown train.serving keys: {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        for name in ("prefix_cache_blocks", "stream_buffer"):
            if name in d and d[name] is not None:
                d[name] = int(d[name])
        return cls(**d)


__all__ = [
    "DEFAULT_SLO_CLASSES",
    "NGramDrafter",
    "PrefixBlockPool",
    "QoSScheduler",
    "Request",
    "SLOClass",
    "ServingConfig",
    "StreamRouter",
    "TenantConfig",
    "TokenBucket",
    "TokenStream",
    "TrieDrafter",
]
