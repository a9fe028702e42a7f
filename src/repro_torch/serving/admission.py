"""Overload protection for the RRTO edge: SLO classes, admission control,
and the graceful-degradation ladder (``repro.serving.admission``).

Open-loop clients do not throttle when the server saturates (a camera keeps
producing frames), so beyond the capacity knee every queue grows without
bound and every tenant's latency collapses together.  This module is the
layer that stops it:

* :class:`SLOClass` — a tenant's service contract: per-request deadline
  budget, priority (EDF tie-break), and a weight that sets its fair share of
  admission capacity under overload.

* :class:`AdmissionController` — queue-limit + token-bucket admission on the
  simulated clock.  The global bucket models server capacity; per-tenant
  buckets (rate proportional to SLO weight) realize deficit-round-robin
  weighted sharing, so one chatty tenant cannot starve the rest; a bounded
  wait queue (mirrored onto :class:`~repro_torch.core.netsim.ServerIngress`)
  keeps the admitted backlog, and therefore admitted latency, finite.
  Tenants may *borrow* unused capacity while the queue is shallow, so the
  weighted shares only bind under real congestion (work-conserving DRR).

* **The degradation ladder** — when admission fails, correctness is never
  the currency; time and device energy are.  Three tiers, picked by what the
  session can afford:

  1. a *split* session degrades toward a more device-heavy cut via
     :meth:`~repro_torch.partition.adaptive.AdaptiveReplanner.degrade`
     (outputs stay bitwise because split execution is);
  2. a *stateless* session falls back to the eager device path, bitwise the
     replay, but only when its deadline budget still covers the device-class
     latency;
  3. anything else is **shed** with a typed :class:`AdmissionRejectedError`
     carrying a client-visible ``retry_after_s`` derived from the queue
     depth and the server's backlog.

Every consumer guards on ``admission is not None``, so a stack without a
controller, and a stack with an inert one (huge limits), is bitwise the
stack without this layer.  Counters are plain attributes under the
reference's names; the reference's tracer and metrics registry hooks are
not ported.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs import MetricsRegistry, RegistryBackedStats, Tracer

# decision actions, in ladder order
ADMIT = "admit"
DEGRADE_SPLIT = "degrade_split"
DEGRADE_DEVICE = "degrade_device"
SHED = "shed"


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One tenant's service contract.

    ``deadline_s`` is the per-request latency budget (arrival to completion);
    ``priority`` breaks EDF ties in batch-round formation (higher first);
    ``weight`` sets the tenant's deficit-round-robin share of admission
    capacity and batch-round slots under overload."""

    name: str = "default"
    deadline_s: float = 0.25
    priority: int = 0
    weight: float = 1.0

    def deadline_for(self, arrival_t: float) -> float:
        return arrival_t + self.deadline_s


# presets mirroring the usual three-tier MEC service split
GOLD = SLOClass("gold", deadline_s=0.05, priority=2, weight=4.0)
SILVER = SLOClass("silver", deadline_s=0.15, priority=1, weight=2.0)
BRONZE = SLOClass("bronze", deadline_s=0.50, priority=0, weight=1.0)


class AdmissionRejectedError(RuntimeError):
    """A request was shed by admission control.

    Client-visible backpressure: ``retry_after_s`` is derived from the queue
    depth and server backlog at rejection time, so a well-behaved client
    backs off as long as the overload is expected to last."""

    def __init__(
        self,
        client_id: str,
        tenant: str,
        retry_after_s: float,
        queue_depth: int,
        reason: str,
    ):
        super().__init__(
            f"request from {client_id!r} (tenant {tenant!r}) shed by "
            f"admission control ({reason}; queue depth {queue_depth}); "
            f"retry after {retry_after_s:.4f}s"
        )
        self.client_id = client_id
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)
        self.queue_depth = int(queue_depth)
        self.reason = reason


@dataclasses.dataclass
class AdmissionDecision:
    """One admission verdict: the ladder tier plus the backpressure data a
    shed response must carry."""

    action: str
    retry_after_s: float = 0.0
    queue_depth: int = 0
    reason: str = ""


class TokenBucket:
    """Simulated-clock token bucket: the level is a pure function of the last
    refill time, so no background process ticks it."""

    def __init__(self, rate_hz: float, burst: float):
        if rate_hz <= 0:
            raise ValueError(f"token rate must be positive, got {rate_hz}")
        self.rate_hz = float(rate_hz)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last_t = 0.0

    def _refill(self, t: float) -> None:
        if t > self._last_t:
            self.tokens = min(self.burst, self.tokens + (t - self._last_t) * self.rate_hz)
            self._last_t = t

    def available(self, t: float, n: float = 1.0) -> bool:
        self._refill(t)
        return self.tokens >= n

    def consume(self, t: float, n: float = 1.0) -> None:
        self._refill(t)
        self.tokens -= n


class AdmissionStats(RegistryBackedStats):
    """Admission counters, under the reference's names; registry-backed, so
    one snapshot reports the overload posture beside the batcher, cache and
    hedge counters."""

    _fields = (
        ("requests", 0),
        ("admitted", 0),
        ("borrowed", 0),           # admits on spare capacity beyond the share
        ("degraded_split", 0),     # ladder tier 1: device-heavy re-plan
        ("degraded_device", 0),    # ladder tier 2: eager device fallback
        ("shed", 0),               # ladder tier 3: typed rejection
        ("queue_rejects", 0),      # admission failures due to the queue bound
        ("bucket_rejects", 0),     # admission failures due to token buckets
        ("deadline_hits", 0),
        ("deadline_misses", 0),
    )


class AdmissionController:
    """Queue-limit + token-bucket admission with weighted tenant shares.

    One controller guards one edge box.  ``rate_hz`` is the modeled service
    capacity in requests/s (the global bucket); each tenant's bucket refills
    at ``rate_hz * weight / total_weight``, the token-bucket form of
    deficit-round-robin sharing: under saturation every tenant's admitted
    share converges to its weight fraction.  While the wait queue is
    shallower than ``borrow_depth`` a tenant whose own bucket ran dry may
    borrow global spare capacity, so light load admits everything.

    The wait queue is the set of admitted-but-uncompleted requests, a heap
    of completion times: the depth at ``t`` is the backlog on the simulated
    timeline.  :meth:`bind` mirrors the depth onto the edge's
    :class:`~repro_torch.core.netsim.ServerIngress`, where ``metrics`` makes
    it a ``queue_depth`` gauge.  With a ``tracer`` every decision is an
    ``admission`` instant on the ``admission`` track."""

    def __init__(
        self,
        *,
        queue_limit: int = 64,
        rate_hz: float = 2000.0,
        burst: Optional[float] = None,
        borrow_depth: Optional[int] = None,
        classes: Optional[Dict[str, SLOClass]] = None,
        default_class: Optional[SLOClass] = None,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.queue_limit = int(queue_limit)
        self.rate_hz = float(rate_hz)
        self.burst = float(burst) if burst is not None else float(queue_limit)
        self.borrow_depth = (
            int(borrow_depth) if borrow_depth is not None else max(1, self.queue_limit // 2)
        )
        self.default_class = default_class or SLOClass()
        self.classes: Dict[str, SLOClass] = dict(classes or {})
        self.tracer = tracer
        self.metrics = metrics
        self.stats = AdmissionStats(registry=metrics)
        self.bucket = TokenBucket(self.rate_hz, self.burst)
        self._tenant_buckets: Dict[str, TokenBucket] = {}
        self._tenants: Dict[str, str] = {}       # client_id -> tenant
        # admitted-but-uncompleted requests, as a heap of completion times
        self._done_heap: List[float] = []
        # per-tenant admitted counts (fairness accounting)
        self.admitted_by_tenant: Dict[str, int] = {}
        # bindings to the edge box (set by RRTOEdgeServer)
        self.server: Optional[Any] = None
        self.ingress: Optional[Any] = None

    # -- wiring ----------------------------------------------------------
    def bind(self, *, server: Any = None, ingress: Any = None) -> None:
        """Attach the edge box's shared resources: the server supplies the
        busy-frontier backlog for retry-after estimates; the ingress mirrors
        the wait-queue depth as an observable gauge."""
        if server is not None:
            self.server = server
        if ingress is not None:
            self.ingress = ingress
            if self.metrics is not None and ingress.depth_gauge is None:
                ingress.depth_gauge = self.metrics.gauge("queue_depth")

    def register(self, client_id: str, tenant: str = "default",
                 slo: Optional[SLOClass] = None) -> None:
        """Declare one client's tenant (and optionally its SLO class).  The
        per-tenant bucket rates depend on the registered weight total, so a
        new class invalidates the lazily built buckets."""
        self._tenants[client_id] = tenant
        if slo is not None and self.classes.get(tenant) != slo:
            self.classes[tenant] = slo
            self._tenant_buckets.clear()

    def tenant_of(self, client_id: str) -> str:
        return self._tenants.get(client_id, "default")

    def slo(self, tenant: str) -> SLOClass:
        return self.classes.get(tenant, self.default_class)

    def deadline_for(self, client_id: str, arrival_t: float) -> float:
        return self.slo(self.tenant_of(client_id)).deadline_for(arrival_t)

    def _tenant_bucket(self, tenant: str) -> TokenBucket:
        tb = self._tenant_buckets.get(tenant)
        if tb is None:
            total_w = sum(self.slo(name).weight for name in self.classes) or self.slo(tenant).weight
            share = self.slo(tenant).weight / max(total_w, 1e-12)
            tb = TokenBucket(max(self.rate_hz * share, 1e-9), max(self.burst * share, 1.0))
            self._tenant_buckets[tenant] = tb
        return tb

    # -- the wait queue --------------------------------------------------
    def queue_depth(self, t: float) -> int:
        """Admitted requests still uncompleted at ``t``.  Completed entries
        drain lazily; the depth is mirrored onto the bound ingress."""
        while self._done_heap and self._done_heap[0] <= t:
            heapq.heappop(self._done_heap)
        depth = len(self._done_heap)
        if self.ingress is not None:
            self.ingress.set_queue_depth(depth, t)
        return depth

    def retry_after(self, t: float, depth: int) -> float:
        """How long a shed client should back off: the time the queue needs
        to drain below the limit at the modeled service rate, plus whatever
        the GPU busy frontier already owes."""
        excess = max(1, depth - self.queue_limit + 1)
        wait = excess / self.rate_hz
        if self.server is not None:
            wait += max(0.0, self.server.busy_until - t)
        return wait

    # -- the decision ----------------------------------------------------
    def decide(
        self,
        client_id: str,
        t: float,
        *,
        can_degrade_split: bool = False,
        can_degrade_device: bool = False,
        degraded_latency_s: Optional[float] = None,
    ) -> AdmissionDecision:
        """Admit, degrade, or shed one request arriving at ``t``.

        ``can_degrade_split`` / ``can_degrade_device`` describe what the
        session has to offer the ladder; ``degraded_latency_s`` is the
        device-fallback latency estimate: tier 2 only fires when the
        tenant's deadline budget still covers it (a degraded response that
        would miss its SLO anyway is shed instead, with retry-after)."""
        tenant = self.tenant_of(client_id)
        self.stats.requests += 1
        depth = self.queue_depth(t)
        reason = None
        if depth >= self.queue_limit:
            reason = "queue full"
            self.stats.queue_rejects += 1
        else:
            tb = self._tenant_bucket(tenant)
            if tb.available(t):
                if self.bucket.available(t):
                    tb.consume(t)
                    self.bucket.consume(t)
                else:
                    reason = "capacity exhausted"
                    self.stats.bucket_rejects += 1
            elif depth <= self.borrow_depth and self.bucket.available(t):
                # spare capacity, shallow queue: work-conserving borrow
                self.bucket.consume(t)
                self.stats.borrowed += 1
            else:
                reason = "tenant share exhausted"
                self.stats.bucket_rejects += 1
        if reason is None:
            self.stats.admitted += 1
            self.admitted_by_tenant[tenant] = self.admitted_by_tenant.get(tenant, 0) + 1
            self._trace(ADMIT, client_id, tenant, t, depth)
            return AdmissionDecision(ADMIT, queue_depth=depth)

        # admission failed: walk the ladder
        if can_degrade_split:
            self.stats.degraded_split += 1
            self._trace(DEGRADE_SPLIT, client_id, tenant, t, depth)
            return AdmissionDecision(DEGRADE_SPLIT, queue_depth=depth, reason=reason)
        budget = self.slo(tenant).deadline_s
        if can_degrade_device and (degraded_latency_s is None or degraded_latency_s <= budget):
            self.stats.degraded_device += 1
            self._trace(DEGRADE_DEVICE, client_id, tenant, t, depth)
            return AdmissionDecision(DEGRADE_DEVICE, queue_depth=depth, reason=reason)
        self.stats.shed += 1
        retry = self.retry_after(t, depth)
        self._trace(SHED, client_id, tenant, t, depth, retry_after=retry)
        return AdmissionDecision(SHED, retry_after_s=retry, queue_depth=depth, reason=reason)

    def note_admitted(self, t: float, done_at: float) -> None:
        """Record one admitted request's completion time on the wait queue
        (called after execution: the heap answers depth queries at later
        arrival times, which is when the backlog matters)."""
        heapq.heappush(self._done_heap, float(done_at))
        self.queue_depth(t)     # refresh the mirrored depth

    def note_completion(self, arrival_t: float, done_t: float,
                        deadline_t: Optional[float]) -> None:
        """Score one served request against its deadline."""
        if deadline_t is None:
            return
        if done_t <= deadline_t:
            self.stats.deadline_hits += 1
        else:
            self.stats.deadline_misses += 1

    def shed_error(self, client_id: str, decision: AdmissionDecision) -> AdmissionRejectedError:
        return AdmissionRejectedError(
            client_id, self.tenant_of(client_id), decision.retry_after_s,
            decision.queue_depth, decision.reason or "overload",
        )

    # -- accounting ------------------------------------------------------
    def admitted_shares(self) -> Dict[str, float]:
        """Each tenant's fraction of admitted requests (the DRR fairness
        check)."""
        total = sum(self.admitted_by_tenant.values())
        if total == 0:
            return {}
        return {tenant: n / total for tenant, n in self.admitted_by_tenant.items()}

    def weight_share(self, tenant: str) -> float:
        total_w = sum(self.slo(name).weight for name in self.classes)
        if total_w <= 0:
            return 1.0
        return self.slo(tenant).weight / total_w

    def _trace(self, action: str, client_id: str, tenant: str, t: float, depth: int,
               **extra: Any) -> None:
        if self.tracer is not None:
            self.tracer.instant("admission", "admission", t, action=action, client=client_id,
                                tenant=tenant, depth=depth, **extra)


def drr_select(
    members: List[Any],
    capacity: int,
    tenant_of: Callable[[Any], str],
    weight_of: Callable[[str], float],
    deficits: Dict[str, float],
) -> List[Any]:
    """Deficit-round-robin slot selection over an EDF-ordered member list.

    ``members`` is any sequence whose elements map to a tenant via
    ``tenant_of``; at most ``capacity`` of them are selected, visiting
    tenants round-robin and crediting each visit with a quantum proportional
    to ``weight_of(tenant)``.  ``deficits`` persists across rounds (the
    classic DRR deficit counter), so a tenant short-changed this round is
    made whole in the next.  Within a tenant, members keep their EDF order.
    """
    if capacity >= len(members):
        return list(members)
    queues: Dict[str, List[Any]] = {}
    order: List[str] = []
    for m in members:
        tenant = tenant_of(m)
        if tenant not in queues:
            queues[tenant] = []
            order.append(tenant)
        queues[tenant].append(m)
    min_w = min(max(weight_of(t), 1e-12) for t in order)
    selected: List[Any] = []
    while len(selected) < capacity and any(queues[t] for t in order):
        # accrue first, spend after: every backlogged tenant banks its
        # quantum (normalized so the lightest tenant earns one slot a visit)
        # before any slot is handed out, then the largest deficit spends
        # first, so a short-changed tenant's carried deficit outbids the
        # tenant that filled the previous round
        for tenant in order:
            if queues[tenant]:
                deficits[tenant] = deficits.get(tenant, 0.0) + max(weight_of(tenant), 1e-12) / min_w
        for tenant in sorted(order, key=lambda name: -deficits.get(name, 0.0)):
            while deficits.get(tenant, 0.0) >= 1.0 and queues[tenant] and len(selected) < capacity:
                selected.append(queues[tenant].pop(0))
                deficits[tenant] -= 1.0
    # an empty queue forfeits its accumulated deficit (credit only accrues
    # while backlogged)
    for tenant in order:
        if not queues[tenant]:
            deficits[tenant] = 0.0
    return selected
