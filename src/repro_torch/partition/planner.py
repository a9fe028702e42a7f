"""Split-plan search: choose the device/server segmentation of a recorded IOS
that minimizes modeled end-to-end latency (or energy, or the pipelined
period) at a bandwidth operating point (``repro.partition.planner``).

Binary offloading picks between two endpoints: run everything on the
device, or ship everything to the server.  The recorded IOS makes *partial*
offloading plannable: the sequence is straight-line, every operator has an
analytic cost, and every cut's wire volume is known from the dependency
closure.  The planner combines:

1. a two-state dynamic program over the op stream (state = current
   placement; a switch at boundary ``b`` pays the live-tensor transfer
   crossing ``b``) — O(n), finds multi-segment shapes;
2. a single-cut sweep in both orientations (device prefix / server suffix
   and the reverse) via prefix sums;
3. the trivial endpoints (full device, full server).

Every candidate is then *exactly* re-evaluated with the shared
:func:`~repro_torch.partition.segments.compute_schedule` timing model (which
the replay engine also executes), and the best plan wins.  Because the
endpoints are always candidates, the chosen plan's modeled cost is never
worse than binary offloading at the planned operating point.  A stateful
graph enumerates its carried-feasible cuts instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.costmodel import DeviceSpec
from repro_torch.core.energy import PowerModel
from repro_torch.partition.segments import (
    PLACE_DEVICE,
    PLACE_SERVER,
    SERVER_FUSION_FACTOR,
    SERVER_KERNELS_PER_FUSION,
    ConstantLink,
    Schedule,
    SegmentGraph,
    SplitPlan,
    compute_schedule,
)


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Knobs for the split planner and its adaptive re-planner.

    ``objective="throughput"`` optimizes the steady-state pipelined
    per-inference interval (the pipeline period, ``repro_torch.partition.pipeline``)
    instead of one-shot latency.  ``pipelined=True`` additionally makes a
    replay-locked session install a
    :class:`~repro_torch.core.engine.PipelinedSegmentedReplay` stream
    executor beside the sequential split path."""

    objective: str = "latency"          # "latency" | "energy" | "throughput"
    adaptive: bool = True
    hysteresis: float = 0.15            # relative gain required to swap plans
    min_replan_interval_s: float = 0.25
    bandwidth_ema: float = 0.3          # EMA weight of a fresh bandwidth sample
    single_cut_candidates: int = 3      # sweep survivors per orientation
    pipelined: bool = False             # build the stream executor on install

    def __post_init__(self):
        if self.objective not in ("latency", "energy", "throughput"):
            raise ValueError(f"unknown objective {self.objective!r}")


@dataclasses.dataclass
class EvaluatedPlan:
    plan: SplitPlan
    schedule: Schedule
    seconds: float
    joules: float
    # lazy thunk for the steady-state pipelined per-inference interval: only
    # a throughput planner (or a caller) pays the extra stage-chain walk
    _period_fn: Optional[Callable[[], float]] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _period: Optional[float] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def period_seconds(self) -> float:
        """Steady-state pipelined per-inference interval, computed on first
        access."""
        if self._period is None:
            self._period = self._period_fn() if self._period_fn else 0.0
        return self._period


def plan_cost(ev: EvaluatedPlan, objective: str) -> float:
    """The scalar a planner/replanner compares plans by, per objective."""
    if objective == "latency":
        return ev.seconds
    if objective == "energy":
        return ev.joules
    if objective == "throughput":
        return ev.period_seconds
    raise ValueError(f"unknown objective {objective!r}")


def evaluate_plan(
    graph: SegmentGraph,
    plan: SplitPlan,
    device: DeviceSpec,
    server: DeviceSpec,
    bandwidth_bytes_per_s: float,
    *,
    rtt_s: float = 1.0e-4,
    power: Optional[PowerModel] = None,
    input_wire_divisor: float = 1.0,
) -> EvaluatedPlan:
    """Exact modeled cost of one plan at a constant-bandwidth operating
    point: the one-shot cost and (lazily) the pipeline period."""
    from repro_torch.partition.pipeline import pipeline_schedule

    link = ConstantLink(bandwidth_bytes_per_s, rtt_s, input_wire_divisor=input_wire_divisor)
    sched = compute_schedule(graph, plan, device, server, link)

    def period() -> float:
        return pipeline_schedule(
            graph, plan, device, server, link, input_wire_divisor=input_wire_divisor
        ).period_seconds

    return EvaluatedPlan(
        plan=plan,
        schedule=sched,
        seconds=sched.total_seconds,
        joules=sched.joules(power or PowerModel()),
        _period_fn=period,
    )


def _wire_live_bytes(graph: SegmentGraph, divisor: float) -> List[float]:
    """Boundary-crossing bytes with inference inputs at wire size."""
    live = graph.live_bytes()
    if divisor == 1.0:
        return live
    for tid in graph.input_tids:
        t = graph.tensors[tid]
        if not t.consumers:
            continue
        saved = t.nbytes - t.nbytes / divisor
        for b in range(t.producer + 1, max(t.consumers) + 1):
            live[b] -= saved
    return live


def _server_op_seconds(server: DeviceSpec, op) -> float:
    """One op's share of the fused server program."""
    eff = server.peak_flops * server.efficiency
    return (
        max(op.flops / eff, op.mem_bytes * SERVER_FUSION_FACTOR / server.mem_bw)
        + server.kernel_launch_s / SERVER_KERNELS_PER_FUSION
    )


def _dp_placements(
    graph: SegmentGraph,
    device: DeviceSpec,
    server: DeviceSpec,
    bandwidth: float,
    rtt_s: float,
    power: PowerModel,
    objective: str,
    wire_live: List[float],
) -> List[str]:
    """Two-state DP over ops; switch cost = live-set transfer at the boundary.
    Latency costs are per-op roofline times; energy weights device compute
    at inference power, transfers at comm power and server compute at
    standby power (the device idles while the server runs)."""
    n = graph.n_ops
    bw = max(bandwidth, 1e-9)
    inf_w = power.power("inference")
    comm_w = power.power("comm")
    stby_w = power.power("standby")

    def dev_cost(k: int) -> float:
        op = graph.ops[k]
        t = device.op_time(op.flops, op.mem_bytes) + device.kernel_launch_s
        return t if objective == "latency" else t * inf_w

    def srv_cost(k: int) -> float:
        t = _server_op_seconds(server, graph.ops[k])
        return t if objective == "latency" else t * stby_w

    def switch_cost(b: int) -> float:
        t = rtt_s + wire_live[b] / bw
        return t if objective == "latency" else t * comm_w

    # cost[p] for the prefix ending at op k placed at p; entry to the server
    # pays the boundary-0 live set (the inference inputs)
    cost = {PLACE_DEVICE: dev_cost(0), PLACE_SERVER: switch_cost(0) + srv_cost(0)}
    back: List[dict] = [{PLACE_DEVICE: None, PLACE_SERVER: None}]
    for k in range(1, n):
        nxt, bk = {}, {}
        for p, op_c in ((PLACE_DEVICE, dev_cost(k)), (PLACE_SERVER, srv_cost(k))):
            q = PLACE_SERVER if p == PLACE_DEVICE else PLACE_DEVICE
            stay = cost[p]
            move = cost[q] + switch_cost(k)
            if stay <= move:
                nxt[p], bk[p] = stay + op_c, p
            else:
                nxt[p], bk[p] = move + op_c, q
        cost = nxt
        back.append(bk)
    # exit: server-resident outputs must come down
    out_bytes = sum(graph.tensors[t].nbytes for t in graph.output_tids)
    exit_t = rtt_s + out_bytes / bw
    cost[PLACE_SERVER] += exit_t if objective == "latency" else exit_t * comm_w

    p = min(cost, key=cost.get)
    placements = [p]
    for k in range(n - 1, 0, -1):
        p = back[k][p]
        placements.append(p)
    placements.reverse()
    return placements


def _single_cut_boundaries(
    graph: SegmentGraph,
    device: DeviceSpec,
    server: DeviceSpec,
    bandwidth: float,
    rtt_s: float,
    wire_live: List[float],
    top_k: int,
) -> List[Tuple[str, int]]:
    """O(n) sweep of both single-cut orientations; returns the best
    boundaries as (orientation, boundary) for exact re-evaluation."""
    n = graph.n_ops
    bw = max(bandwidth, 1e-9)
    dev_prefix = [0.0]
    srv_prefix = [0.0]
    for op in graph.ops:
        dev_prefix.append(
            dev_prefix[-1] + device.op_time(op.flops, op.mem_bytes) + device.kernel_launch_s
        )
        srv_prefix.append(srv_prefix[-1] + _server_op_seconds(server, op))
    out_bytes = sum(graph.tensors[t].nbytes for t in graph.output_tids)

    scored: List[Tuple[float, str, int]] = []
    for b in range(1, n):
        cut = rtt_s + wire_live[b] / bw
        # device prefix, server suffix (+ output downlink)
        dp = dev_prefix[b] + cut + (srv_prefix[n] - srv_prefix[b]) + rtt_s + out_bytes / bw
        scored.append((dp, "DS", b))
        # server prefix (inputs up first), device suffix (outputs local)
        sp = rtt_s + wire_live[0] / bw + srv_prefix[b] + cut + (dev_prefix[n] - dev_prefix[b])
        scored.append((sp, "SD", b))
    scored.sort(key=lambda x: x[0])
    picked: List[Tuple[str, int]] = []
    for _, orient, b in scored:
        if (orient, b) not in picked:
            picked.append((orient, b))
        if len(picked) >= 2 * top_k:
            break
    return picked


# exact-evaluation budget for carried-feasible boundaries: a stateless
# prologue longer than this is evenly subsampled (extremes always kept)
MAX_CARRIED_CUTS = 48


def _carried_candidates(graph: SegmentGraph) -> List[SplitPlan]:
    """Candidate plans for a *stateful* graph: full-server (always feasible)
    and the device-prefix / server-suffix plans whose boundary lies inside
    the stateless prologue.  Full-device is never feasible: the state is
    server-resident by construction."""
    n = graph.n_ops
    candidates = [SplitPlan.full_server(n)]
    bmax = min(graph.carried_cut_limit(), n - 1)   # b == n would be full-device
    boundaries = list(range(1, bmax + 1))
    if len(boundaries) > MAX_CARRIED_CUTS:
        step = (len(boundaries) + MAX_CARRIED_CUTS - 1) // MAX_CARRIED_CUTS
        boundaries = sorted(set(boundaries[::step]) | {1, bmax})
    for b in boundaries:
        candidates.append(
            SplitPlan.from_placements([PLACE_DEVICE] * b + [PLACE_SERVER] * (n - b))
        )
    return candidates


def plan_partition(
    graph: SegmentGraph,
    device: DeviceSpec,
    server: DeviceSpec,
    bandwidth_bytes_per_s: float,
    *,
    rtt_s: float = 1.0e-4,
    power: Optional[PowerModel] = None,
    config: Optional[PartitionConfig] = None,
    input_wire_divisor: float = 1.0,
    tracer: Optional[Any] = None,
    trace_track: str = "planner",
    now: float = 0.0,
    verify: bool = False,
) -> EvaluatedPlan:
    """Pick the best split of ``graph`` at the given operating point.

    For a stateless graph the candidates always include both
    binary-offloading endpoints, so the result is never worse than
    full-offload or device-only under the shared model.  For a stateful
    graph only carried-feasible cuts are enumerated, and full-server is the
    guaranteed fallback.  With a ``tracer`` the whole per-candidate cost
    table and the chosen signature ride on one ``plan_explain`` instant on
    ``trace_track`` at simulated time ``now``.

    ``verify=True`` runs the static plan verifier
    (:func:`repro_torch.analysis.plancheck.verify_plan`) over the winning
    plan before returning it and raises ``ReplaySoundnessError`` on any
    ERROR diagnostic, so a planner regression can never hand the engine an
    unexecutable cut."""
    config = config or PartitionConfig()
    power = power or PowerModel()
    n = graph.n_ops

    if graph.is_stateful:
        candidates = _carried_candidates(graph)
    else:
        wire_live = _wire_live_bytes(graph, input_wire_divisor)
        candidates = [SplitPlan.full_server(n), SplitPlan.full_device(n)]
        # the DP generates candidate *shapes*; throughput shares latency's
        # costs (a per-op period is not decomposable) — the exact
        # re-evaluation below scores every candidate under the true objective
        dp_objective = "latency" if config.objective == "throughput" else config.objective
        candidates.append(SplitPlan.from_placements(_dp_placements(
            graph, device, server, bandwidth_bytes_per_s, rtt_s, power, dp_objective,
            wire_live,
        )))
        for orient, b in _single_cut_boundaries(
            graph, device, server, bandwidth_bytes_per_s, rtt_s, wire_live,
            config.single_cut_candidates,
        ):
            first, second = (
                (PLACE_DEVICE, PLACE_SERVER) if orient == "DS" else (PLACE_SERVER, PLACE_DEVICE)
            )
            candidates.append(SplitPlan.from_placements([first] * b + [second] * (n - b)))

    best: Optional[EvaluatedPlan] = None
    seen: set = set()
    explain: List[Dict[str, Any]] = []
    for plan in candidates:
        sig = plan.signature()
        if sig in seen:
            continue
        seen.add(sig)
        ev = evaluate_plan(
            graph, plan, device, server, bandwidth_bytes_per_s,
            rtt_s=rtt_s, power=power, input_wire_divisor=input_wire_divisor,
        )
        if tracer is not None:
            # "why this cut": every candidate's cost rides on the trace; the
            # period is computed only when the objective prices it (the
            # pipeline-period evaluation is lazy)
            row = {"plan": sig, "seconds": ev.seconds, "joules": ev.joules,
                   "cost": plan_cost(ev, config.objective)}
            if config.objective == "throughput":
                row["period_s"] = ev.period_seconds
            explain.append(row)
        if best is None or plan_cost(ev, config.objective) < plan_cost(best, config.objective):
            best = ev
    assert best is not None
    if tracer is not None:
        tracer.instant(trace_track, "plan_explain", now, objective=config.objective,
                       bandwidth_bytes_per_s=bandwidth_bytes_per_s,
                       chosen=best.plan.signature(), candidates=explain)
    best.plan = dataclasses.replace(
        best.plan,
        objective=config.objective,
        planned_bandwidth=bandwidth_bytes_per_s,
        modeled_seconds=best.seconds,
        modeled_joules=best.joules,
    )
    if verify:
        from repro_torch.analysis.plancheck import verify_plan
        from repro_torch.analysis.verify import raise_on_errors

        raise_on_errors(verify_plan(graph, best.plan))
    return best
