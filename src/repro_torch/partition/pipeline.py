"""Pipelined split replay — steady-state scheduling of *consecutive*
inferences over a device/server split plan (``repro.partition.pipeline``).

The sequential split path (``compute_schedule`` +
``RRTOClient._run_split_replay``) finishes one inference before the next
begins, so the steady-state interval is the *sum* of the stage times.  A
sustained stream (camera frames, sensor ticks) admits the pipeline
transform: while the server executes inference *i*'s server segments, the
device computes inference *i+1*'s device segments and streams its
cut-crossing tensors, and the steady-state interval collapses to the *max*
of the per-resource busy times.

* :func:`stage_chain` linearizes one inference of a :class:`SplitPlan` into
  resource-tagged stages (device compute, link transfer, server compute)
  with the transfer semantics of
  :func:`~repro_torch.partition.segments.compute_schedule`;
* :func:`pipeline_schedule` — the analytic steady state at a constant-link
  operating point: fill latency (sum) and period (max), the quantity the
  planner's ``objective="throughput"`` minimizes;
* :func:`simulate_pipeline` — a discrete-event execution of an arrival
  process over :class:`~repro_torch.core.netsim.CapacityResource`\\ s, with
  in-order completion; under overload the queue grows without bound, which
  is an observable, not a modeling error.

The executable half is :class:`repro_torch.core.engine.PipelinedSegmentedReplay`;
both halves share the stage chain.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.costmodel import DeviceSpec
from repro_torch.core.netsim import CapacityResource, EventTimeline
from repro_torch.partition.segments import (
    PLACE_SERVER,
    SegmentGraph,
    SplitPlan,
    device_op_time,
    placement_state,
)

RES_DEVICE = "device"
RES_SERVER = "server"
RES_LINK = "link"


@dataclasses.dataclass(frozen=True)
class Stage:
    """One resource occupancy in the per-inference chain.  Compute stages
    carry ``seconds``; link stages carry ``nbytes`` and are timed against the
    live link when the chain is scheduled."""

    resource: str
    seconds: float = 0.0
    nbytes: float = 0.0
    label: str = ""


def stage_chain(
    graph: SegmentGraph,
    plan: SplitPlan,
    device: DeviceSpec,
    server: DeviceSpec,
    *,
    input_wire_divisor: float = 1.0,
) -> List[Stage]:
    """Linearize one inference of ``plan`` into resource-tagged stages.

    Transfer semantics mirror :func:`compute_schedule`: a tensor crosses the
    wire the first time the other endpoint needs it, both keep their copy,
    resident tensors live on both ends, loop-carried tensors are
    server-pinned.  The chain serializes each inference's own stages (the
    sequential path's intra-inference uplink overlap is given up for the
    overlap across inferences)."""
    if plan.n_ops != graph.n_ops:
        raise ValueError(f"plan covers {plan.n_ops} ops, graph has {graph.n_ops}")
    tensors = graph.tensors
    at_device, at_server, wire_bytes = placement_state(graph, input_wire_divisor)

    chain: List[Stage] = []
    for seg in plan.segments:
        here = at_server if seg.placement == PLACE_SERVER else at_device
        missing = [tid for tid in graph.segment_inputs(seg) if tid not in here]
        if missing:
            chain.append(Stage(
                RES_LINK,
                nbytes=sum(wire_bytes(t) for t in missing),
                label=f"{'up' if seg.placement == PLACE_SERVER else 'down'}@{seg.start}",
            ))
            here.update(missing)
        if seg.placement == PLACE_SERVER:
            chain.append(Stage(
                RES_SERVER,
                seconds=graph.server_seconds(server, seg.start, seg.end),
                label=f"S{seg.start}:{seg.end}",
            ))
        else:
            chain.append(Stage(
                RES_DEVICE,
                seconds=sum(device_op_time(device, graph.ops[k]) for k in range(seg.start, seg.end)),
                label=f"D{seg.start}:{seg.end}",
            ))
        here.update(graph.segment_outputs(seg))
    # the app's outputs must end on the device — except carried state, which
    # stays server-resident (its D2H is a local handle)
    carried_out = set(graph.carried_out_tids)
    down = sum(
        float(tensors[t].nbytes)
        for t in graph.output_tids
        if t not in at_device and t not in carried_out
    )
    if down > 0:
        chain.append(Stage(RES_LINK, nbytes=down, label="down@out"))
    return chain


@dataclasses.dataclass
class PipelineSchedule:
    """Analytic steady state of a stage chain at one link operating point."""

    latency_seconds: float       # one-shot (fill) latency of one inference
    period_seconds: float        # steady-state per-inference interval
    device_seconds: float        # per-inference device busy time
    server_seconds: float        # per-inference server busy time
    link_seconds: float          # per-inference link busy time (half-duplex)
    crossings: int               # link stages per inference
    comm_bytes: float

    @property
    def bottleneck(self) -> str:
        busy = {
            RES_DEVICE: self.device_seconds,
            RES_SERVER: self.server_seconds,
            RES_LINK: self.link_seconds,
        }
        return max(busy, key=busy.get)

    @property
    def overlap_ratio(self) -> float:
        """period / latency — 1.0 means no overlap is possible, lower is
        better."""
        return self.period_seconds / self.latency_seconds if self.latency_seconds > 0 else 1.0


def pipeline_schedule(
    graph: SegmentGraph,
    plan: SplitPlan,
    device: DeviceSpec,
    server: DeviceSpec,
    link,
    *,
    input_wire_divisor: float = 1.0,
    t0: float = 0.0,
) -> PipelineSchedule:
    """Steady-state pipeline timing of ``plan`` against ``link``: the period
    is the largest per-resource busy time, the fill latency the chain sum.
    Link stages include the per-crossing RTT."""
    chain = stage_chain(graph, plan, device, server, input_wire_divisor=input_wire_divisor)
    busy: Dict[str, float] = {RES_DEVICE: 0.0, RES_SERVER: 0.0, RES_LINK: 0.0}
    latency = 0.0
    crossings = 0
    comm_bytes = 0.0
    for stage in chain:
        if stage.resource == RES_LINK:
            dt = link.transfer_seconds(stage.nbytes, t0 + latency) + link.rtt(t0 + latency)
            crossings += 1
            comm_bytes += stage.nbytes
        else:
            dt = stage.seconds
        busy[stage.resource] += dt
        latency += dt
    return PipelineSchedule(
        latency_seconds=latency,
        period_seconds=max(busy.values()),
        device_seconds=busy[RES_DEVICE],
        server_seconds=busy[RES_SERVER],
        link_seconds=busy[RES_LINK],
        crossings=crossings,
        comm_bytes=comm_bytes,
    )


class SharedGPUResource:
    """Adapter putting an ``OffloadServer``'s shared kernel queue behind the
    :class:`CapacityResource` protocol: pipelined server segments contend
    with every co-tenant replay for the same GPU."""

    def __init__(self, server):
        self.server = server

    def earliest(self, t: float) -> float:
        return max(t, self.server.busy_until)

    def reserve(self, start: float, duration: float):
        end = self.server.occupy(duration, start)
        return end - duration, end


@dataclasses.dataclass
class SimulatedInference:
    """One inference's trajectory through the simulated pipeline."""

    index: int
    arrival: float
    start: float = 0.0           # first stage begins (queue exit)
    done: float = 0.0            # in-order completion
    queue_depth: int = 0         # submissions in flight at arrival

    @property
    def latency(self) -> float:
        return self.done - self.arrival

    @property
    def queue_wait(self) -> float:
        return self.start - self.arrival


@dataclasses.dataclass
class PipelineSimulation:
    inferences: List[SimulatedInference]
    device: CapacityResource
    server: Any                  # CapacityResource or a shared-GPU adapter
    link: CapacityResource

    def steady_period(self, tail: Optional[int] = None, trim: int = 3) -> float:
        """Mean inter-completion interval over a steady window: past the
        fill ramp (second half by default), stopping ``trim`` completions
        before the end (the final in-flight inferences drain in a burst)."""
        done = [s.done for s in self.inferences]
        if len(done) < 2:
            return 0.0
        hi = max(1, len(done) - 1 - max(0, trim))
        k = tail if tail is not None else len(done) // 2
        lo = max(0, hi - max(1, k))
        if hi <= lo:
            lo, hi = 0, len(done) - 1
        return (done[hi] - done[lo]) / (hi - lo)

    @property
    def max_queue_depth(self) -> int:
        return max((s.queue_depth for s in self.inferences), default=0)


def simulate_pipeline(
    chain: Sequence[Stage],
    link,
    arrivals: Sequence[float],
    *,
    device: Optional[CapacityResource] = None,
    server=None,
    link_resource: Optional[CapacityResource] = None,
    closed_loop: bool = False,
    timeline: Optional[EventTimeline] = None,
) -> PipelineSimulation:
    """Event-driven execution of ``arrivals`` through ``chain``.

    Each stage reserves its resource only at the instant its predecessor
    completes; the :class:`EventTimeline` fires those instants in global
    order, so reservations serialize in true ready-time order across
    in-flight inferences — while inference *i* holds the server, inference
    *i+1*'s device stage and uplink claim their idle resources.  Resources
    may be passed in (shared across simulations; the server slot takes any
    object with ``earliest``/``reserve``) or are created fresh.
    ``closed_loop=True`` makes each arrival also wait for the previous
    completion (the sequential reference)."""
    dev = device if device is not None else CapacityResource(RES_DEVICE)
    srv = server if server is not None else CapacityResource(RES_SERVER)
    lnk = link_resource if link_resource is not None else CapacityResource(RES_LINK)
    res = {RES_DEVICE: dev, RES_SERVER: srv, RES_LINK: lnk}
    tl = timeline if timeline is not None else EventTimeline()

    n = len(arrivals)
    infs = [SimulatedInference(index=i, arrival=float(a)) for i, a in enumerate(arrivals)]
    last_done = [0.0 if not infs else min(s.arrival for s in infs)]

    def advance(i: int, k: int, t_ready: float) -> None:
        if k == len(chain):
            done = max(t_ready, last_done[0])   # in-order delivery
            last_done[0] = done
            infs[i].done = done
            if closed_loop and i + 1 < n:
                nxt = max(infs[i + 1].arrival, done)
                tl.at(nxt, lambda: advance(i + 1, 0, nxt))
            return
        stage = chain[k]
        r = res[stage.resource]
        begin = r.earliest(t_ready)
        if stage.resource == RES_LINK:
            dur = link.transfer_seconds(stage.nbytes, begin) + link.rtt(begin)
        else:
            dur = stage.seconds
        r.reserve(begin, dur)
        end = begin + dur
        if k == 0:
            infs[i].start = begin
        tl.at(end, lambda: advance(i, k + 1, end))

    if closed_loop:
        if n:
            tl.at(infs[0].arrival, lambda: advance(0, 0, infs[0].arrival))
    else:
        for s in infs:
            tl.at(s.arrival, lambda i=s.index, a=s.arrival: advance(i, 0, a))
    tl.run()

    for s in infs:   # queue depth at arrival: earlier submissions in flight
        s.queue_depth = sum(1 for p in infs[: s.index] if p.done > s.arrival)
    return PipelineSimulation(inferences=infs, device=dev, server=srv, link=lnk)
