"""QoS request scheduler: per-tenant queues, quotas, SLO-aware order.

The port's copy of :mod:`trlx_tpu.serving.scheduler` (host Python, copied
almost verbatim; the clock is the port's own ``utils.monotonic``).

The serving tier's admission brain (docs/serving.md). The continuous
engine exposes a pool of decode slots; every time slots vacate the
serving loop asks :meth:`QoSScheduler.next_batch` which queued requests
feed them. The decision combines, in order of force:

- **quota** — a per-tenant token bucket (``rate`` tokens/s refill,
  ``burst`` cap) charged at admission with the request's estimated
  token cost (prompt + generation budget). An exhausted tenant is
  *throttled, not starved*: its requests stay queued and the bucket
  refills with wall time, so they admit as soon as the quota allows.
  Aging never overrides quota (a noisy neighbor cannot age its way
  past its contract).
- **effective priority** — the request's static priority plus an aging
  term (``queue_wait / aging_half_ms`` points), so low-priority
  requests cannot starve behind a steady high-priority stream: wait
  long enough and any request outranks a fresh one.
- **SLO pressure** — the scheduler reads the per-tenant
  ``serve/queue_wait_ms[tenant=...]`` histograms (when it is given a
  metrics registry) and boosts tenants whose recent p95 approaches their SLO
  class's queue-wait budget — the feedback loop that turns the
  histograms into scheduling decisions.
- **deadline** — ties break earliest-deadline-first, then submission
  order (deterministic: equal inputs give an identical order, which
  the unit tests pin).

Host-only, stdlib; ``registry`` is any object with the metrics registry's
``histogram(name).summary()`` interface (None turns SLO pressure off).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from trlx_tpu_torch.utils import monotonic

#: the tenant unknown submitters land under: unmetered, priority 0
DEFAULT_TENANT = "default"


def tenant_metric_key(base: str, tenant: str) -> str:
    """Per-tenant histogram name: ``serve/queue_wait_ms[tenant=acme]``.
    One flat key per (metric, tenant) — the registry stays a plain
    namespace and ``--compare`` diffs tenants like any other series."""
    return f"{base}[tenant={tenant}]"


@dataclass(frozen=True)
class SLOClass:
    """A latency contract: requests of this class should spend at most
    ``queue_wait_budget_ms`` (p95) waiting for a slot. The `slo-breach`
    health detector trips when the measured ratio exceeds 1."""

    name: str
    queue_wait_budget_ms: float


DEFAULT_SLO_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", 200.0),
    "standard": SLOClass("standard", 2_000.0),
    "batch": SLOClass("batch", 30_000.0),
}


@dataclass
class TokenBucket:
    """Classic token bucket; time injected for determinism (tests drive
    a fake clock, production passes the shared telemetry clock)."""

    rate: float  # tokens per second
    burst: float  # bucket capacity
    level: float = field(default=-1.0)
    last_refill: float = field(default=-1.0)

    def __post_init__(self):
        if self.level < 0:
            self.level = self.burst

    def refill(self, now: float) -> None:
        if self.last_refill < 0:
            self.last_refill = now
            return
        dt = max(0.0, now - self.last_refill)
        self.level = min(self.burst, self.level + dt * self.rate)
        self.last_refill = now

    def try_charge(self, cost: float, now: float) -> bool:
        self.refill(now)
        if self.level + 1e-9 < cost:
            return False
        self.level -= cost
        return True

    def state_dict(self) -> Dict[str, float]:
        """Resume-carried quota state. Only ``level`` travels: the
        refill anchor is a *monotonic* timestamp that does not survive
        a process restart, so restoring it raw would either grant a
        huge spurious refill (new clock ahead) or freeze refills (new
        clock behind). Dropping it back to the -1 sentinel makes the
        first post-restore ``refill`` re-anchor without adding credit —
        the drained-tenant throttle the level encodes carries across
        the kill, which is the part that feeds the admission schedule."""
        return {"level": float(self.level)}

    def load_state_dict(self, state: Dict[str, float]) -> None:
        self.level = min(float(state["level"]), self.burst)
        self.last_refill = -1.0


@dataclass(frozen=True)
class TenantConfig:
    """Per-tenant admission contract (``train.serving.tenants.<name>``)."""

    name: str
    priority: int = 0
    rate: float = math.inf  # quota refill, tokens/second
    burst: float = math.inf  # quota burst capacity, tokens
    slo_class: str = "standard"

    @classmethod
    def from_dict(cls, name: str, d: Dict[str, Any]) -> "TenantConfig":
        known = {"priority", "rate", "burst", "slo_class"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"Unknown serving.tenants[{name!r}] keys: "
                f"{sorted(unknown)} (known: {sorted(known)})"
            )
        cfg = cls(name=name, **d)
        if cfg.rate <= 0 and not math.isinf(cfg.burst):
            raise ValueError(
                f"serving.tenants[{name!r}]: rate={cfg.rate} with a "
                f"finite burst={cfg.burst} — a drained bucket would "
                "never refill, so the tenant would hang forever instead "
                "of throttling; use rate > 0 (or leave both unset for "
                "an unmetered tenant)"
            )
        return cfg


@dataclass
class Request:
    """One typed serving request. ``cost`` (estimated tokens: real
    prompt length + generation budget) is what the tenant's bucket is
    charged; ``deadline`` is absolute on the scheduler's clock."""

    request_id: int
    tenant: str
    prompt_ids: Any  # [Q] int32 left-padded host array
    prompt_mask: Any  # [Q] int32
    priority: int = 0
    slo_class: str = "standard"
    max_tokens: int = 0
    deadline: Optional[float] = None
    stream: bool = False
    cost: float = 0.0
    submitted_at: float = 0.0
    seq: int = 0  # global submission order (final tie-break)
    # distributed-tracing marks (telemetry/request_trace.py): the
    # trace_id minted at InferenceServer.submit, the first time the
    # request was skipped because its tenant's quota was exhausted
    # (the quota-hold stage starts here), and the pick time (scheduler
    # → engine handoff). Host floats on the shared telemetry clock.
    trace_id: str = ""
    quota_blocked_at: Optional[float] = None
    picked_at: float = 0.0


class QoSScheduler:
    """Per-tenant queues + the admission policy described in the module
    docstring. Single-threaded like the engine's host loop."""

    def __init__(
        self,
        tenants: Optional[Dict[str, TenantConfig]] = None,
        slo_classes: Optional[Dict[str, SLOClass]] = None,
        aging_half_ms: float = 1000.0,
        clock: Callable[[], float] = monotonic,
        registry=None,
    ):
        self.tenants: Dict[str, TenantConfig] = dict(tenants or {})
        self.slo_classes = dict(DEFAULT_SLO_CLASSES)
        self.slo_classes.update(slo_classes or {})
        self.aging_half_ms = float(aging_half_ms)
        self.clock = clock
        self.registry = registry
        self._queues: Dict[str, List[Request]] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        # plain int (not itertools.count) so the submission-order
        # tie-break survives checkpoint/resume via state_dict()
        self._seq = 0
        self.admitted = 0
        self.throttled_rounds = 0  # quota skips (observability)

    # ------------------------------ intake ----------------------------- #

    def tenant_config(self, tenant: str) -> TenantConfig:
        cfg = self.tenants.get(tenant)
        if cfg is None:
            cfg = TenantConfig(name=tenant)
            self.tenants[tenant] = cfg
        return cfg

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        cfg = self.tenant_config(tenant)
        if math.isinf(cfg.rate) and math.isinf(cfg.burst):
            return None  # unmetered
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = TokenBucket(
                rate=cfg.rate, burst=cfg.burst
            )
        return bucket

    def validate(self, request: Request) -> None:
        """Raise if ``request`` could never be admitted — WITHOUT
        enqueueing, so a caller can pre-check a whole batch and refuse
        it atomically (a mid-batch refusal after enqueueing would
        orphan the earlier requests)."""
        cfg = self.tenant_config(request.tenant)  # registers unknown tenants
        if request.slo_class not in self.slo_classes:
            raise ValueError(
                f"unknown slo_class {request.slo_class!r} (known: "
                f"{sorted(self.slo_classes)})"
            )
        if request.cost > cfg.burst:
            # a cost the bucket can never hold would queue forever (the
            # level caps at burst) — refuse loudly instead of hanging
            # every flush()/stream() behind an unadmittable request
            raise ValueError(
                f"request cost {request.cost} exceeds tenant "
                f"{request.tenant!r} burst capacity {cfg.burst} — it "
                "could never be admitted; raise the tenant's burst or "
                "shrink the prompt/generation budget"
            )

    def submit(self, request: Request) -> Request:
        """Enqueue; fills scheduler-owned fields (seq, submitted_at,
        defaults inherited from the tenant's config)."""
        self.validate(request)
        request.seq = self._seq
        self._seq += 1
        if request.submitted_at <= 0:
            request.submitted_at = self.clock()
        self._queues.setdefault(request.tenant, []).append(request)
        return request

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def has_work(self) -> bool:
        return any(self._queues.values())

    # --------------------------- checkpointing -------------------------- #

    def state_dict(self) -> Dict[str, Any]:
        """Resume-carried scheduler state: per-tenant bucket levels (a
        drained tenant must stay throttled across the kill), the global
        submission sequence (the final deterministic tie-break — a
        reset would let post-resume requests reorder against any the
        caller re-submits), and the admission counters. Queues are NOT
        carried: the preemption contract drains in-flight requests at
        phase boundaries, so at any checkpointable point they are
        empty; dynamically registered default tenants re-register on
        first touch."""
        return {
            "seq": int(self._seq),
            "admitted": int(self.admitted),
            "throttled_rounds": int(self.throttled_rounds),
            "buckets": {
                tenant: bucket.state_dict()
                for tenant, bucket in sorted(self._buckets.items())
            },
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._seq = int(state["seq"])
        self.admitted = int(state["admitted"])
        self.throttled_rounds = int(state["throttled_rounds"])
        for tenant, bucket_state in state["buckets"].items():
            bucket = self._bucket(tenant)
            if bucket is not None:
                bucket.load_state_dict(bucket_state)

    # ------------------------------ policy ----------------------------- #

    def slo_pressure(self, tenant: str) -> float:
        """Measured queue-wait p95 over the tenant's SLO budget (0 when
        unmeasured) — the histogram-feedback term."""
        ratio = self.slo_ratio(tenant)
        return 0.0 if ratio is None else max(0.0, ratio)

    def slo_ratio(self, tenant: str) -> Optional[float]:
        """p95(serve/queue_wait_ms[tenant]) / class budget, or None
        while the tenant has no completed requests yet."""
        if self.registry is None:
            return None
        hist = self.registry.histogram(
            tenant_metric_key("serve/queue_wait_ms", tenant)
        )
        summary = getattr(hist, "summary", lambda: {"count": 0})()
        if not summary.get("count"):
            return None
        cfg = self.tenant_config(tenant)
        budget = self.slo_classes[cfg.slo_class].queue_wait_budget_ms
        return float(summary["p95"]) / max(budget, 1e-9)

    def effective_priority(
        self,
        request: Request,
        now: float,
        pressure: Optional[float] = None,
    ) -> float:
        """priority + aging + SLO pressure — the admission score.
        ``pressure`` lets :meth:`next_batch` hoist the per-tenant
        histogram read out of the per-request loop (it is constant per
        tenant within one call, and the registry p95 is not free)."""
        wait_ms = max(0.0, (now - request.submitted_at) * 1000.0)
        aging = wait_ms / max(self.aging_half_ms, 1e-9)
        if pressure is None:
            pressure = self.slo_pressure(request.tenant)
        return request.priority + aging + pressure

    def next_batch(
        self, k: int, now: Optional[float] = None
    ) -> List[Request]:
        """Up to ``k`` requests to admit now, best-first. Quota-blocked
        tenants are skipped this round (their requests stay queued);
        everything else orders by (effective priority desc, deadline
        asc, submission seq asc) — deterministically."""
        if k < 1 or not self.has_work():
            return []
        now = self.clock() if now is None else now
        scored = []
        for tenant, queue in self._queues.items():
            if not queue:
                continue
            pressure = self.slo_pressure(tenant)  # one p95 read/tenant
            for req in queue:
                score = self.effective_priority(req, now, pressure)
                deadline = (
                    req.deadline if req.deadline is not None else math.inf
                )
                heapq.heappush(
                    scored, (-score, deadline, req.seq, req)
                )
        picked: List[Request] = []
        blocked: set = set()
        while scored and len(picked) < k:
            _, _, _, req = heapq.heappop(scored)
            if req.tenant in blocked:
                continue
            bucket = self._bucket(req.tenant)
            if bucket is not None and not bucket.try_charge(
                req.cost, now
            ):
                # quota exhausted: the whole tenant waits for refill
                # (in-tenant order is preserved — charging a cheaper
                # later request first would reorder the tenant's FIFO)
                blocked.add(req.tenant)
                self.throttled_rounds += 1
                # quota-hold trace mark: every queued request of the
                # throttled tenant starts (or continues) its hold here
                for held in self._queues[req.tenant]:
                    if held.quota_blocked_at is None:
                        held.quota_blocked_at = now
                continue
            self._queues[req.tenant].remove(req)
            req.picked_at = now
            picked.append(req)
            self.admitted += 1
        return picked

    # --------------------------- observability ------------------------- #

    def queue_depths(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if q}

    def slo_ratio_rows(self) -> Dict[str, float]:
        """``serve/slo_queue_wait_ratio[tenant=...]`` rows for every
        tenant with measurements — the `slo-breach` detector's feed
        (a ratio > 1 means the tenant's measured queue-wait p95 blew
        its SLO class budget)."""
        out: Dict[str, float] = {}
        for tenant in sorted(self.tenants):
            ratio = self.slo_ratio(tenant)
            if ratio is not None:
                out[
                    tenant_metric_key("serve/slo_queue_wait_ratio", tenant)
                ] = ratio
        return out


def build_scheduler(
    serving_config,
    registry=None,
    clock: Callable[[], float] = monotonic,
) -> QoSScheduler:
    """Scheduler from a :class:`trlx_tpu_torch.serving.ServingConfig`."""
    tenants = {
        name: TenantConfig.from_dict(name, dict(spec))
        for name, spec in (serving_config.tenants or {}).items()
    }
    slo_classes = {
        name: SLOClass(
            name,
            float(
                dict(spec).get(
                    "queue_wait_budget_ms",
                    DEFAULT_SLO_CLASSES.get(
                        name, SLOClass(name, 2_000.0)
                    ).queue_wait_budget_ms,
                )
            ),
        )
        for name, spec in (serving_config.slo_classes or {}).items()
    }
    return QoSScheduler(
        tenants=tenants,
        slo_classes=slo_classes,
        aging_half_ms=serving_config.aging_half_ms,
        clock=clock,
        registry=registry,
    )
