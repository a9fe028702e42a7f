"""Adaptive re-planning: track the live bandwidth and swap split plans when
the modeled optimum moves (``repro.partition.adaptive``).

A mobile client's link is nonstationary (the outdoor trace drops to near
zero under obstruction), so a plan chosen at 90 Mbps is wrong at 5 Mbps —
but re-planning on every sample would thrash between plans whose modeled
costs differ by noise, and every swap builds a new segment program on the
server.  The re-planner therefore:

* EMA-smooths observed bandwidth samples (``bandwidth_ema``);
* rate-limits planning itself (``min_replan_interval_s`` of simulated time);
* applies switching hysteresis: the candidate must beat the *current*
  plan's modeled cost at the smoothed bandwidth by at least ``hysteresis``
  (relative) before it is adopted.

It sees bandwidth samples and returns plans; the replay engine owns plan
installation.  A graph built with ``carried_pairs`` constrains
``plan_partition`` to carried-feasible cuts, so every plan this class
returns keeps the loop-carried state server-resident.

A declared link outage (:meth:`AdaptiveReplanner.declare_outage`) bypasses
the damping: the session re-plans at once at the outage floor, which lands
every segment on the device.  An overloaded server
(:meth:`AdaptiveReplanner.degrade`, the admission ladder's first tier) plans
at the same floor but leaves the bandwidth estimate alone.

With a tracer every decision is an instant on ``trace_track``
(``outage_replan``, ``overload_degrade``, ``replan``, ``replan_rejected``),
beside the planner's ``plan_explain``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.costmodel import DeviceSpec
from repro_torch.core.energy import PowerModel
from repro_torch.core.netsim import OUTAGE_FLOOR_BYTES_PER_S
from repro_torch.obs import MetricsRegistry, RegistryBackedStats, Tracer
from repro_torch.partition.planner import (
    EvaluatedPlan,
    PartitionConfig,
    evaluate_plan,
    plan_cost,
    plan_partition,
)
from repro_torch.partition.segments import SegmentGraph, SplitPlan


class ReplannerStats(RegistryBackedStats):
    """Re-planning counters, under the reference's names; registry-backed."""

    _fields = (
        ("observations", 0),
        ("plans_considered", 0),
        ("replans", 0),               # adopted swaps
        ("rejected_by_hysteresis", 0),
        ("outage_replans", 0),        # declared-outage immediate swaps
        ("overload_degrades", 0),     # admission-driven device-heavy swaps
    )


class AdaptiveReplanner:
    """Owns the current :class:`SplitPlan` for one client session."""

    def __init__(
        self,
        graph: SegmentGraph,
        device: DeviceSpec,
        server: DeviceSpec,
        *,
        rtt_s: float = 1.0e-4,
        power: Optional[PowerModel] = None,
        config: Optional[PartitionConfig] = None,
        input_wire_divisor: float = 1.0,
        tracer: Optional[Tracer] = None,
        trace_track: str = "planner",
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.graph = graph
        self.device = device
        self.server = server
        self.rtt_s = rtt_s
        self.power = power or PowerModel()
        self.config = config or PartitionConfig()
        self.input_wire_divisor = input_wire_divisor
        self.tracer = tracer
        self.trace_track = trace_track
        self.stats = ReplannerStats(registry=metrics)
        self.ema_bandwidth: Optional[float] = None
        self._last_plan_t: Optional[float] = None
        self.current: Optional[EvaluatedPlan] = None
        self._outage_plan = False

    def _plan_at(self, bandwidth: float, now: float = 0.0) -> EvaluatedPlan:
        self.stats.plans_considered += 1
        ev = plan_partition(
            self.graph, self.device, self.server, bandwidth,
            rtt_s=self.rtt_s, power=self.power, config=self.config,
            input_wire_divisor=self.input_wire_divisor,
            tracer=self.tracer, trace_track=self.trace_track, now=now,
        )
        # a stateful graph never yields a cut that would strand the carried
        # state on the device side
        assert self.graph.plan_carried_feasible(ev.plan), ev.plan.signature()
        return ev

    def initial_plan(self, bandwidth: float, now: float = 0.0) -> SplitPlan:
        self.ema_bandwidth = bandwidth
        self._last_plan_t = now
        self.current = self._plan_at(bandwidth, now)
        return self.current.plan

    def declare_outage(self, now: float) -> Optional[SplitPlan]:
        """The link is down: re-plan at once at the outage-floor bandwidth,
        with no EMA smoothing, rate limit or hysteresis (staying on a
        wire-crossing plan stalls every inference on a dead link).  The EMA
        collapses to the floor too, so once the link heals :meth:`observe`'s
        damped path re-offloads as fresh samples pull the estimate back up.
        Returns the outage plan, or None when it is already installed."""
        self.ema_bandwidth = OUTAGE_FLOOR_BYTES_PER_S
        self._last_plan_t = now
        if self._outage_plan:
            return None
        self._outage_plan = True
        self.stats.outage_replans += 1
        candidate = self._plan_at(OUTAGE_FLOOR_BYTES_PER_S, now)
        if self.tracer is not None:
            self.tracer.instant(self.trace_track, "outage_replan", now,
                                adopted=candidate.plan.signature())
        same = self.current is not None and (
            candidate.plan.signature() == self.current.plan.signature()
        )
        self.current = candidate
        return None if same else candidate.plan

    def degrade(self, now: float) -> Optional[SplitPlan]:
        """The *server* is overloaded: shift work onto the device by planning
        as if the wire were at the outage floor (every segment the planner
        can move lands device-side).  Unlike :meth:`declare_outage` the link
        is healthy, so the EMA is left alone: the next :meth:`observe`
        sample re-plans back toward offloading once the pressure clears.
        ``_last_plan_t`` is stamped, so ``min_replan_interval_s`` rate-limits
        the restore.  Returns the device-heavy plan, or None when the
        session already runs it."""
        self._last_plan_t = now
        candidate = self._plan_at(OUTAGE_FLOOR_BYTES_PER_S, now)
        if self.current is not None and (
            candidate.plan.signature() == self.current.plan.signature()
        ):
            return None
        self.stats.overload_degrades += 1
        if self.tracer is not None:
            self.tracer.instant(self.trace_track, "overload_degrade", now,
                                adopted=candidate.plan.signature())
        self.current = candidate
        return candidate.plan

    def observe(self, bandwidth: float, now: float) -> Optional[SplitPlan]:
        """Feed one bandwidth sample; returns a new plan iff the session
        should swap (hysteresis and rate limit already applied)."""
        if bandwidth > OUTAGE_FLOOR_BYTES_PER_S:
            # a real sample: the link is back, outage declarations re-arm
            self._outage_plan = False
        if self.current is None:
            return self.initial_plan(bandwidth, now)
        self.stats.observations += 1
        alpha = self.config.bandwidth_ema
        self.ema_bandwidth = (
            bandwidth
            if self.ema_bandwidth is None
            else alpha * bandwidth + (1 - alpha) * self.ema_bandwidth
        )
        if not self.config.adaptive:
            return None
        if (
            self._last_plan_t is not None
            and now - self._last_plan_t < self.config.min_replan_interval_s
        ):
            return None
        self._last_plan_t = now

        candidate = self._plan_at(self.ema_bandwidth, now)
        if candidate.plan.signature() == self.current.plan.signature():
            self.current = candidate     # refresh the modeled cost at this bw
            return None
        # hysteresis compares both plans at the *same* operating point
        incumbent = evaluate_plan(
            self.graph, self.current.plan, self.device, self.server, self.ema_bandwidth,
            rtt_s=self.rtt_s, power=self.power, input_wire_divisor=self.input_wire_divisor,
        )
        objective = self.config.objective
        cand_cost = plan_cost(candidate, objective)
        inc_cost = plan_cost(incumbent, objective)
        if cand_cost < inc_cost * (1.0 - self.config.hysteresis):
            self.current = candidate
            self.stats.replans += 1
            if self.tracer is not None:
                self.tracer.instant(self.trace_track, "replan", now,
                                    adopted=candidate.plan.signature(), cost=cand_cost,
                                    incumbent_cost=inc_cost, bandwidth=self.ema_bandwidth)
            return candidate.plan
        self.stats.rejected_by_hysteresis += 1
        if self.tracer is not None:
            self.tracer.instant(self.trace_track, "replan_rejected", now,
                                candidate=candidate.plan.signature(), cost=cand_cost,
                                incumbent_cost=inc_cost, bandwidth=self.ema_bandwidth)
        self.current = incumbent
        return None
