"""Segment model of a recorded IOS — the substrate of the split planner
(``repro.partition.segments``).

A recorded inference operator sequence is a straight-line program: H2D input
uploads, a stream of aten calls, D2H output downloads.  For partial
offloading we need to know, for every possible cut, *what would cross the
wire*: the versioned tensors produced on one side of the cut and consumed on
the other.  :class:`SegmentGraph` extracts that structure from the recorded
:class:`~repro_torch.core.intercept.InterceptedCall` list:

* every recorded call (kernel or DtoD copy) becomes an :class:`OpInfo` with
  its analytic cost (FLOPs / bytes from the record) and the tensor versions
  it reads and writes;
* every buffer *version* becomes a :class:`TensorInfo` with its producer op,
  consumer ops and wire size — addresses are reused by the caching
  allocator, so liveness must be per version, not per address;
* parameters (buffers read but never written inside the sequence) are
  resident on both endpoints — the model lives on the device and was
  uploaded to the server during the model-load phase — so they never cross a
  cut.  So are tensors computed only from parameters and constants
  (``TensorInfo.derived``): the port's traced graph slices every layer's
  weights out of the stacked parameters with one ``select`` per leaf, where
  the reference's ``lax.scan`` consumes the stack whole; such a view is
  parameter-like, and each segment that reads it computes it itself instead
  of receiving it over the wire.

:class:`SplitPlan` is the planner's output: a contiguous segmentation of the
op stream with a device/server placement per segment.  :func:`compute_schedule`
is the *shared* timing model — the planner evaluates candidate plans with it
and the replay engine executes the chosen plan by it, so the modeled optimum
and the simulated execution can never disagree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.costmodel import DeviceSpec, aval_nbytes
from repro_torch.core.records import FUNC_D2H, FUNC_H2D

PLACE_DEVICE = "device"
PLACE_SERVER = "server"

# producer sentinels for TensorInfo
PRODUCER_INPUT = -1   # replay input (H2D upload of the app's inference input)
PRODUCER_PARAM = -2   # parameter: resident on both endpoints
PRODUCER_CARRIED = -3  # loop-carried state: pinned server-resident (the
#                        stateful step keeps it on the server, so it never
#                        crosses a cut)

# the replayed server program is costed as fused (simulated-clock constants,
# as in the reference); device segments dispatch eagerly like the device-only
# baseline.  Mirrors core/engine.py REPLAY_* constants.
SERVER_FUSION_FACTOR = 0.6
SERVER_KERNELS_PER_FUSION = 6


@dataclasses.dataclass(frozen=True)
class OpInfo:
    """One kernel (or DtoD copy) of the IOS call stream, with the tensor
    versions it reads (one per tensor operand, in operand order) and
    writes."""

    index: int
    flops: float
    mem_bytes: float
    in_tids: Tuple[int, ...] = ()
    out_tids: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """One buffer *version* flowing through the IOS."""

    tid: int
    addr: int
    nbytes: int
    producer: int                  # op index, or one of the PRODUCER_* sentinels
    consumers: Tuple[int, ...]     # op indices; len(ops) marks D2H consumption
    derived: bool = False          # computed only from parameters and constants

    @property
    def is_param(self) -> bool:
        return self.producer == PRODUCER_PARAM

    @property
    def is_carried(self) -> bool:
        return self.producer == PRODUCER_CARRIED

    @property
    def resident(self) -> bool:
        """On both endpoints without a transfer: a parameter, or a tensor
        each side computes from parameters itself."""
        return self.is_param or self.derived


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous run of ops [start, end) with one placement."""

    start: int
    end: int
    placement: str

    def __post_init__(self):
        if self.placement not in (PLACE_DEVICE, PLACE_SERVER):
            raise ValueError(f"bad placement {self.placement!r}")
        if not 0 <= self.start < self.end:
            raise ValueError(f"bad segment bounds [{self.start}, {self.end})")

    @property
    def n_ops(self) -> int:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """A device/server segmentation of the IOS call stream.

    ``signature()`` is the plan's identity for cache keying: two plans with
    the same cuts and placements are the same program regardless of the
    bandwidth they were planned at."""

    segments: Tuple[Segment, ...]
    objective: str = "latency"
    planned_bandwidth: float = 0.0     # bytes/s the planner assumed
    modeled_seconds: float = 0.0
    modeled_joules: float = 0.0

    def __post_init__(self):
        if not self.segments:
            raise ValueError("a plan needs at least one segment")
        pos = 0
        for i, seg in enumerate(self.segments):
            if seg.start != pos:
                raise ValueError(f"segment {i} starts at {seg.start}, not {pos}")
            if i > 0 and seg.placement == self.segments[i - 1].placement:
                raise ValueError("adjacent segments share a placement")
            pos = seg.end

    @property
    def n_ops(self) -> int:
        return self.segments[-1].end

    @property
    def n_device_ops(self) -> int:
        return sum(s.n_ops for s in self.segments if s.placement == PLACE_DEVICE)

    @property
    def is_full_server(self) -> bool:
        return self.n_device_ops == 0

    @property
    def is_full_device(self) -> bool:
        return self.n_device_ops == self.n_ops

    def placement_of(self, op_index: int) -> str:
        for seg in self.segments:
            if seg.start <= op_index < seg.end:
                return seg.placement
        raise IndexError(op_index)

    def signature(self) -> str:
        return "|".join(
            f"{'D' if s.placement == PLACE_DEVICE else 'S'}{s.start}:{s.end}"
            for s in self.segments
        )

    @staticmethod
    def full_server(n_ops: int) -> "SplitPlan":
        return SplitPlan(segments=(Segment(0, n_ops, PLACE_SERVER),))

    @staticmethod
    def full_device(n_ops: int) -> "SplitPlan":
        return SplitPlan(segments=(Segment(0, n_ops, PLACE_DEVICE),))

    @staticmethod
    def parse_signature(sig: str) -> "SplitPlan":
        """Inverse of :meth:`signature` (``"D0:5|S5:20"``).  Raises
        ``ValueError`` on anything that is not the signature of a valid plan
        (contiguous segments starting at 0, alternating placements)."""
        segs: List[Segment] = []
        for part in sig.split("|"):
            if len(part) < 4 or part[0] not in "DS" or ":" not in part:
                raise ValueError(f"malformed plan signature part {part!r}")
            placement = PLACE_DEVICE if part[0] == "D" else PLACE_SERVER
            lo, _, hi = part[1:].partition(":")
            try:
                start, end = int(lo), int(hi)
            except ValueError:
                raise ValueError(f"malformed plan signature part {part!r}") from None
            segs.append(Segment(start, end, placement))
        return SplitPlan(segments=tuple(segs))

    @staticmethod
    def from_placements(placements: Sequence[str]) -> "SplitPlan":
        """Collapse a per-op placement list into contiguous segments."""
        if not placements:
            raise ValueError("empty placement list")
        segs: List[Segment] = []
        start = 0
        for i in range(1, len(placements) + 1):
            if i == len(placements) or placements[i] != placements[start]:
                segs.append(Segment(start, i, placements[start]))
                start = i
        return SplitPlan(segments=tuple(segs))


def tensor_versions(
    calls, carried_input_ordinals: Sequence[int] = ()
) -> Tuple[List[OpInfo], List[TensorInfo], List[int], List[int]]:
    """Walk the recorded calls and build the versioned dataflow.

    Returns ``(ops, tensors, input_tids, output_tids)`` where ``input_tids``
    are the replay inputs in H2D order and ``output_tids`` the replay outputs
    in D2H order.  The walk mirrors
    :func:`repro_torch.core.engine.replay_address_plan`: it is a pure
    function of the calls, so the same walk over an isomorphic sequence
    recorded by another client yields structurally identical ops and tensors
    in the identical order (what lets one plan's segment programs be
    rebound).

    ``carried_input_ordinals`` marks H2D ordinals that are loop-carried
    server-resident state: their tensors are tagged ``PRODUCER_CARRIED`` so
    the cut-crossing accounting never bills them on the wire.  An op whose
    tensor operands are all parameters or derived (or which has none) writes
    derived tensors."""
    ops: List[OpInfo] = []
    tensors: List[TensorInfo] = []
    consumers: Dict[int, List[int]] = {}
    current: Dict[int, int] = {}       # addr -> live tid
    input_tids: List[int] = []
    output_tids: List[int] = []
    carried_set = set(carried_input_ordinals)

    def new_tensor(addr: int, nbytes: int, producer: int, derived: bool = False) -> int:
        tid = len(tensors)
        tensors.append(TensorInfo(tid, addr, int(nbytes), producer, (), derived))
        consumers[tid] = []
        current[addr] = tid
        return tid

    for c in calls:
        rec = c.record
        if rec.func == FUNC_H2D:
            addr, nbytes = c.out_addrs[0], rec.args_sig[1]
            producer = PRODUCER_CARRIED if len(input_tids) in carried_set else PRODUCER_INPUT
            input_tids.append(new_tensor(addr, nbytes, producer))
        elif rec.func == FUNC_D2H:
            addr = c.in_operands[0][1]
            tid = current.get(addr)
            if tid is None:  # an output read straight from a parameter buffer
                tid = new_tensor(addr, rec.args_sig[1], PRODUCER_PARAM)
            output_tids.append(tid)
        elif c.op is not None:
            k = len(ops)
            in_tids = []
            for _, v in c.in_operands:
                tid = current.get(v)
                if tid is None:
                    tid = new_tensor(v, 0, PRODUCER_PARAM)
                consumers[tid].append(k)
                in_tids.append(tid)
            derived = all(tensors[t].resident for t in in_tids)
            out_tids = tuple(
                new_tensor(addr, aval_nbytes(aval), k, derived)
                for addr, aval in zip(c.out_addrs, c.out_avals)
            )
            ops.append(OpInfo(k, rec.flops, rec.mem_bytes, tuple(in_tids), out_tids))

    n = len(ops)
    out_set = set(output_tids)
    fixed = [
        dataclasses.replace(
            t, consumers=tuple(consumers[t.tid]) + ((n,) if t.tid in out_set else ())
        )
        for t in tensors
    ]
    return ops, fixed, input_tids, output_tids


class SegmentGraph:
    """The planner's view of one recorded IOS.

    ``carried_pairs`` (the ``(h2d_ordinal, d2h_ordinal)`` loop-carried pairs
    of :func:`repro_torch.core.opseq.detect_loop_carried`) makes the graph
    *stateful*: the carried uploads are tagged ``PRODUCER_CARRIED``
    (server-pinned, never on the wire) and the paired downloads are tracked
    as ``carried_out_tids`` — the tensors the stateful step produces on the
    server, which therefore never downlink either.  A stateful graph also
    constrains cut *feasibility*: every op touching carried state must land
    in the trailing server segment (:meth:`carried_cut_limit`,
    :meth:`plan_carried_feasible`), because a device placement of a carried
    consumer would have to download the server-resident state every round."""

    def __init__(
        self,
        calls,
        carried_input_ordinals: Sequence[int] = (),
        carried_pairs: Sequence[Tuple[int, int]] = (),
    ):
        self.carried_pairs = tuple((int(i), int(j)) for i, j in carried_pairs)
        if self.carried_pairs and not carried_input_ordinals:
            carried_input_ordinals = [i for i, _ in self.carried_pairs]
        self.ops, self.tensors, self.input_tids, self.output_tids = tensor_versions(
            calls, carried_input_ordinals
        )
        self.carried_tids = frozenset(t.tid for t in self.tensors if t.is_carried)
        # pair-ordered carried endpoints: the h2d-side tids (state as the app
        # uploads it) and the d2h-side tids (state as the step produces it)
        self.carried_in_tids = tuple(self.input_tids[i] for i, _ in self.carried_pairs)
        self.carried_out_tids = tuple(self.output_tids[j] for _, j in self.carried_pairs)
        self.n_ops = len(self.ops)
        if self.n_ops == 0:
            raise ValueError("IOS contains no kernel operators")
        # per-op read sets (tids), resident tensors excluded — they cross no
        # cut; first-read order, no duplicates
        self.reads: List[Tuple[int, ...]] = [
            tuple(dict.fromkeys(t for t in op.in_tids if not self.tensors[t].resident))
            for op in self.ops
        ]
        self.writes: List[Tuple[int, ...]] = [op.out_tids for op in self.ops]
        self._seg_inputs: Dict[Tuple[int, int], List[int]] = {}
        self._seg_outputs: Dict[Tuple[int, int], List[int]] = {}

    # ------------------------------------------------------------------
    @property
    def is_stateful(self) -> bool:
        return bool(self.carried_tids)

    def carried_cut_limit(self) -> Optional[int]:
        """The largest boundary ``b`` such that a device-prefix [0, b) /
        server-suffix [b, n) cut keeps every carried-touching op server-side:
        the index of the first op that consumes carried state or produces the
        updated state.  ``None`` for a stateless graph; ``0`` when the very
        first op touches carried state (no feasible device prefix)."""
        if not self.carried_tids:
            return None
        touching: List[int] = []
        for tid in self.carried_tids:
            touching.extend(k for k in self.tensors[tid].consumers if k < self.n_ops)
        for tid in self.carried_out_tids:
            p = self.tensors[tid].producer
            if p >= 0:
                touching.append(p)
        return min(touching, default=0)

    def plan_carried_feasible(self, plan: SplitPlan) -> bool:
        """A stateful graph admits a plan iff its trailing segment is
        server-placed and starts at or before the first carried-touching op,
        so the whole carried region lives inside one stateful server suffix.
        Stateless graphs admit any plan."""
        limit = self.carried_cut_limit()
        if limit is None:
            return True
        last = plan.segments[-1]
        return last.placement == PLACE_SERVER and last.start <= limit

    def live_bytes(self) -> List[float]:
        """``live[b]`` = bytes of non-resident tensors crossing boundary
        ``b`` (between op ``b-1`` and op ``b``), for ``b`` in ``0..n_ops``:
        the transfer volume a placement switch at ``b`` would ship.
        Loop-carried tensors are excluded like parameters."""
        n = self.n_ops
        diff = [0.0] * (n + 2)
        for t in self.tensors:
            if t.resident or t.is_carried or not t.consumers:
                continue
            lo = t.producer + 1          # first boundary the tensor is live at
            hi = max(t.consumers)        # last boundary (inclusive)
            if hi < lo:
                continue
            diff[lo] += t.nbytes
            diff[hi + 1] -= t.nbytes
        out, acc = [], 0.0
        for b in range(n + 1):
            acc += diff[b]
            out.append(acc)
        return out

    def segment_cost(self, start: int, end: int) -> Tuple[float, float]:
        flops = sum(self.ops[k].flops for k in range(start, end))
        mem = sum(self.ops[k].mem_bytes for k in range(start, end))
        return flops, mem

    def segment_inputs(self, seg: Segment) -> List[int]:
        """Non-resident tids read by ``seg`` but produced outside it."""
        key = (seg.start, seg.end)
        got = self._seg_inputs.get(key)
        if got is None:
            seen: Dict[int, None] = {}
            for k in range(seg.start, seg.end):
                for tid in self.reads[k]:
                    if not seg.start <= self.tensors[tid].producer < seg.end:
                        seen.setdefault(tid)
            got = self._seg_inputs[key] = list(seen)
        return got

    def segment_outputs(self, seg: Segment) -> List[int]:
        """Non-resident tids produced by ``seg`` and consumed after it (or
        downloaded)."""
        key = (seg.start, seg.end)
        got = self._seg_outputs.get(key)
        if got is None:
            got = self._seg_outputs[key] = [
                tid
                for k in range(seg.start, seg.end)
                for tid in self.writes[k]
                if not self.tensors[tid].derived
                and any(c >= seg.end for c in self.tensors[tid].consumers)
            ]
        return got

    def derived_prologue(self, tids: Sequence[int], start: int, end: int) -> List[int]:
        """The ops (in stream order) that compute the derived tensors among
        ``tids`` whose producers lie outside ``[start, end)``, with every
        derived tensor they read in turn: what a segment re-runs to have the
        parameter-like values it reads, instead of receiving them."""
        need: Set[int] = set()
        stack = [t for t in tids if self.tensors[t].derived
                 and not start <= self.tensors[t].producer < end]
        while stack:
            k = self.tensors[stack.pop()].producer
            if k in need:
                continue
            need.add(k)
            stack.extend(t for t in self.ops[k].in_tids if self.tensors[t].derived)
        return sorted(need)

    def device_seconds(self, device: DeviceSpec, start: int, end: int) -> float:
        """Eager per-op dispatch on the mobile device (device-only model)."""
        flops, mem = self.segment_cost(start, end)
        return device.sequence_time(flops, mem, num_kernels=end - start, fusion_factor=1.0)

    def server_seconds(self, server: DeviceSpec, start: int, end: int) -> float:
        """Fused one-shot execution on the GPU server (replay model)."""
        flops, mem = self.segment_cost(start, end)
        n_k = max(1, (end - start) // SERVER_KERNELS_PER_FUSION)
        return server.sequence_time(
            flops, mem, num_kernels=n_k, fusion_factor=SERVER_FUSION_FACTOR
        )


# ---------------------------------------------------------------------------
# the shared timing model
# ---------------------------------------------------------------------------

def device_op_time(device: DeviceSpec, op: OpInfo) -> float:
    """Eager per-op device dispatch cost — the one timing rule both the
    sequential device walk (``compute_schedule``) and the pipeline stage
    chain (``partition/pipeline.py``) price device segments by."""
    return device.op_time(op.flops, op.mem_bytes) + device.kernel_launch_s


def placement_state(graph: SegmentGraph, input_wire_divisor: float = 1.0):
    """Initial tensor placement and wire-size rule shared by every scheduler
    that walks a plan over the graph (``compute_schedule`` here,
    ``stage_chain`` in ``partition/pipeline.py``): resident tensors live on
    both endpoints, inference inputs start on the device and travel
    wire-divided (compressed camera frames), loop-carried tensors are
    server-pinned.  Returns ``(at_device, at_server, wire_bytes)``."""
    tensors = graph.tensors
    carried = graph.carried_tids
    input_set = set(graph.input_tids) - set(carried)

    def wire_bytes(tid: int) -> float:
        nb = float(tensors[tid].nbytes)
        return nb / input_wire_divisor if tid in input_set else nb

    resident = {t.tid for t in tensors if t.resident}
    return resident | input_set, resident | set(carried), wire_bytes


@dataclasses.dataclass(frozen=True)
class ConstantLink:
    """Planning-time link model: a single bandwidth/RTT operating point."""

    bandwidth_bytes_per_s: float
    rtt_s: float = 1.0e-4
    input_wire_divisor: float = 1.0

    def transfer_seconds(self, nbytes: float, t: float) -> float:
        if nbytes <= 0:
            return 0.0
        return nbytes / max(self.bandwidth_bytes_per_s, 1e-9)

    def rtt(self, t: float) -> float:
        return self.rtt_s


class NetworkLink:
    """Adapter putting a live :class:`~repro_torch.core.netsim.NetworkModel`
    behind the planner's link protocol (the engine executes a plan against
    the traced bandwidth; transfers accumulate real ingress bytes)."""

    def __init__(self, network, input_wire_divisor: float = 1.0):
        self.network = network
        self.input_wire_divisor = input_wire_divisor

    def transfer_seconds(self, nbytes: float, t: float) -> float:
        return self.network.transfer_time(nbytes, t)

    def rtt(self, t: float) -> float:
        return self.network._rtt_at(t)


@dataclasses.dataclass
class Schedule:
    """Modeled timeline of one split-replay inference (relative to its start).

    ``body_seconds`` ends when every segment (and every mid-plan boundary
    transfer) has completed; downloading server-resident outputs to the app
    happens at the D2H records and is accounted separately so the engine can
    charge it where the RPC actually occurs."""

    body_seconds: float = 0.0
    device_seconds: float = 0.0      # device busy computing (STATE_INFERENCE)
    server_seconds: float = 0.0      # server busy computing (occupies the GPU)
    comm_seconds: float = 0.0        # boundary transfers inside the body
    comm_bytes: float = 0.0
    crossings: int = 0               # boundary transfer bursts
    output_local: List[bool] = dataclasses.field(default_factory=list)
    output_downlink_bytes: float = 0.0
    output_downlink_seconds: float = 0.0
    server_busy: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    # transfer time hidden under device compute (pipelined uplink)
    overlap_seconds: float = 0.0

    @property
    def radio_only_seconds(self) -> float:
        """Transfer time the device spends *only* transmitting.  Overlapped
        transmission is billed at inference draw, which keeps the phase
        integral exactly equal to the wall time."""
        return max(0.0, self.comm_seconds - self.overlap_seconds)

    @property
    def wait_seconds(self) -> float:
        """Device idle time inside the body (waiting on server segments)."""
        return max(0.0, self.body_seconds - self.device_seconds - self.radio_only_seconds)

    @property
    def total_seconds(self) -> float:
        return self.body_seconds + self.output_downlink_seconds

    def joules(self, power) -> float:
        from repro_torch.core.energy import STATE_COMM, STATE_INFERENCE, STATE_STANDBY

        return (
            power.power(STATE_INFERENCE) * self.device_seconds
            + power.power(STATE_COMM) * (self.radio_only_seconds + self.output_downlink_seconds)
            + power.power(STATE_STANDBY) * self.wait_seconds
        )


def compute_schedule(
    graph: SegmentGraph,
    plan: SplitPlan,
    device: DeviceSpec,
    server: DeviceSpec,
    link,
    *,
    t0: float = 0.0,
    include_output_downlink: bool = True,
) -> Schedule:
    """Walk a plan over the segment graph and produce its modeled timeline.

    Transfer semantics: a tensor crosses the wire the first time the *other*
    endpoint needs it, and both endpoints keep their copy afterwards.  Uplink
    is pipelined — a boundary tensor starts transmitting the moment its
    producing op completes, overlapping the device's compute of the rest of
    its segment — while a server->device boundary blocks on the download.
    ``link`` times are queried at absolute time ``t0 + elapsed`` so traced
    bandwidth models see the right trace position."""
    if plan.n_ops != graph.n_ops:
        raise ValueError(f"plan covers {plan.n_ops} ops, graph has {graph.n_ops}")
    sched = Schedule(output_local=[])
    tensors = graph.tensors
    at_device, at_server, wire_bytes = placement_state(
        graph, getattr(link, "input_wire_divisor", 1.0)
    )
    ready: Dict[int, float] = {}

    t = 0.0            # frontier of the executing side
    link_free = 0.0    # the (half-duplex) radio link's busy frontier

    def ship(tids: List[int], dest: set, start_floor: float) -> float:
        """Serialize ``tids`` on the link; returns the last arrival time.
        Transfer time spent before ``start_floor`` (the executing side's
        frontier at the boundary) overlapped the producing side's compute."""
        nonlocal link_free
        if not tids:
            return start_floor
        sched.crossings += 1
        done = start_floor
        for tid in sorted(tids, key=lambda i: ready.get(i, 0.0)):
            begin = max(link_free, ready.get(tid, 0.0))
            dt = link.transfer_seconds(wire_bytes(tid), t0 + begin)
            link_free = begin + dt
            sched.comm_seconds += dt
            sched.comm_bytes += wire_bytes(tid)
            sched.overlap_seconds += max(0.0, min(link_free, start_floor) - begin)
            dest.add(tid)
            done = link_free
        return done + link.rtt(t0 + done)

    for seg in plan.segments:
        needed = graph.segment_inputs(seg)
        if seg.placement == PLACE_SERVER:
            missing = [tid for tid in needed if tid not in at_server]
            arrive = ship(missing, at_server, t)
            start = max(t, arrive)
            exec_s = graph.server_seconds(server, seg.start, seg.end)
            sched.server_seconds += exec_s
            sched.server_busy.append((t0 + start, exec_s))
            t = start + exec_s
            for tid in graph.segment_outputs(seg):
                at_server.add(tid)
                ready[tid] = t
        else:
            missing = [tid for tid in needed if tid not in at_device]
            if missing:
                # the device blocks until its operands land
                t = max(t, ship(missing, at_device, t))
            # eager per-op dispatch; per-tensor completion lets a later
            # uplink overlap the rest of this segment's compute
            for k in range(seg.start, seg.end):
                dt = device_op_time(device, graph.ops[k])
                t += dt
                sched.device_seconds += dt
                for tid in graph.writes[k]:
                    at_device.add(tid)
                    ready[tid] = t

    sched.body_seconds = max(t, link_free)

    # the app's D2H downloads: outputs still server-only must come down.  The
    # replay engine pays these at the D2H records (its live link accumulates
    # the real ingress bytes there), so it asks for the locality flags only.
    # Carried outputs never downlink: the client answers their D2H with a
    # stable local handle.
    carried_out = set(graph.carried_out_tids)
    down = 0.0
    for tid in graph.output_tids:
        if tid in carried_out:
            sched.output_local.append(True)
            continue
        local = tid in at_device
        sched.output_local.append(local)
        if not local and include_output_downlink:
            nb = float(tensors[tid].nbytes)
            sched.output_downlink_bytes += nb
            down += link.transfer_seconds(nb, t0 + sched.body_seconds + down)
    if sched.output_downlink_bytes > 0:
        down += link.rtt(t0 + sched.body_seconds)
    sched.output_downlink_seconds = down
    return sched
