"""MEC network simulation — trace-driven wireless bandwidth + RTT model.

The link part of ``repro.core.netsim``: the paper's measured
environments (Fig. 3), indoor lab (93 Mbps mean, mild fluctuation) and outdoor
garden (73 Mbps mean, heavy fluctuation with occasional near-zero drops from
obstruction), as deterministic (seeded) 0.1 s-interval traces over 5 minutes,
and the shared edge-server ingress that co-tenant clients contend for; and
the discrete-event timeline that pipelined and open-loop serving run on
(client clock skew, arrival processes, capacity resources, the event
scheduler); and the fault model of the fault-tolerance layer (outage
windows, per-RPC loss, bandwidth collapses, replica crashes) with the client's
retry discipline, and the site backhaul a replicated fleet shares.

The link is simulated; every latency/energy number derived from it is a model
output, not a measurement.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

MBPS = 1e6 / 8.0  # bytes/s per Mbps

TRACE_INTERVAL_S = 0.1
TRACE_DURATION_S = 300.0

# the wire during a declared outage or a total collapse: not zero (a transfer
# that slips past the client-side outage guard must stall long but finitely,
# not hang the simulation), but slow enough that no planner ever chooses it
OUTAGE_FLOOR_BYTES_PER_S = 1e4


def _splitmix64(x: int) -> int:
    """One splitmix64 round — a stateless 64-bit mixer, so fault draws are a
    pure function of (seed, draw index) and never depend on an RNG's state."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def client_stream_seed(seed: int, client_id: str) -> int:
    """Deterministic per-client RNG seed: splitmix64 over (seed, client_id)
    bytes, so each client owns an independent stream and adding or removing a
    client never perturbs another client's arrival sequence."""
    x = _splitmix64(int(seed) & 0xFFFFFFFFFFFFFFFF)
    for b in client_id.encode("utf-8"):
        x = _splitmix64(x ^ b)
    return x


class RpcTimeoutError(RuntimeError):
    """Every retry attempt of one RPC was lost — the link is effectively
    down and the caller should declare an outage instead of retrying on."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Client-side RPC retry discipline: timeout, exponential backoff with
    deterministic jitter, bounded attempts.  Jitter comes from the fault
    injector's stateless hash, so a retried run is exactly reproducible."""

    base_timeout_s: float = 0.02
    backoff: float = 2.0
    max_backoff_s: float = 0.5
    jitter: float = 0.25          # fraction of the timeout, in [0, jitter)
    max_attempts: int = 8

    def timeout_s(self, attempt: int, unit: float) -> float:
        """Timeout for retry number ``attempt`` (0-based); ``unit`` in [0,1)
        supplies the deterministic jitter draw."""
        t = min(self.base_timeout_s * self.backoff ** attempt, self.max_backoff_s)
        return t * (1.0 + self.jitter * unit)


class FaultInjector:
    """Deterministic, seeded fault model for the simulated wire and fleet.

    Four fault dimensions, all optional and all off by default:

    * **outage windows** — ``(start_s, end_s)`` intervals during which the
      link is down: ``bandwidth_factor`` collapses to 0 and clients that
      consult :meth:`in_outage` fall back to device-local execution;
    * **per-RPC loss** — each transmitted message is lost with probability
      ``rpc_loss_prob``; a lost message costs the client a timeout and a
      retry.  Draws are a pure function of (seed, draw index): splitmix64
      over Python integers, no numpy or torch RNG state;
    * **bandwidth collapses** — ``(start_s, end_s, factor)`` episodes that
      multiply the link bandwidth (0.05 = a 20x collapse), driving the
      adaptive re-planner without taking the link fully down;
    * **replica crashes** — ``{replica_name: t}`` crash times the fleet
      polls through :meth:`due_crashes`; a crash destroys the replica's
      device memory (carried state included), unlike a mere ``failed`` mark.

    Every consumer guards on ``fault is not None``, so a run without an
    injector, and a run with a default injector (which perturbs nothing),
    take the same values, clock and counters as before the fault layer.
    """

    def __init__(
        self,
        *,
        seed: int = 0,
        outages: Sequence[Tuple[float, float]] = (),
        rpc_loss_prob: float = 0.0,
        collapses: Sequence[Tuple[float, float, float]] = (),
        crashes: Optional[dict] = None,
    ):
        if not 0.0 <= rpc_loss_prob <= 1.0:
            raise ValueError(f"rpc_loss_prob must be in [0,1], got {rpc_loss_prob}")
        self.seed = int(seed)
        self.outages = tuple((float(a), float(b)) for a, b in sorted(outages))
        for a, b in self.outages:
            if b <= a:
                raise ValueError(f"empty outage window ({a}, {b})")
        self.rpc_loss_prob = float(rpc_loss_prob)
        self.collapses = tuple((float(a), float(b), float(f)) for a, b, f in sorted(collapses))
        for a, b, f in self.collapses:
            if b <= a or not 0.0 < f <= 1.0:
                raise ValueError(f"bad collapse episode ({a}, {b}, {f})")
        self.crashes = dict(crashes or {})
        self.crashed: set = set()
        # draws taken and messages dropped so far
        self.draws = 0
        self.dropped = 0

    # -- outage windows -------------------------------------------------
    def in_outage(self, t: float) -> bool:
        return any(a <= t < b for a, b in self.outages)

    def outage_until(self, t: float) -> float:
        """End of the outage window containing ``t`` (``t`` itself when the
        link is up)."""
        for a, b in self.outages:
            if a <= t < b:
                return b
        return t

    # -- bandwidth ------------------------------------------------------
    def bandwidth_factor(self, t: float) -> float:
        """Multiplier on the trace bandwidth at ``t``: 0 during an outage,
        the episode factor during a collapse, 1 otherwise."""
        if self.in_outage(t):
            return 0.0
        factor = 1.0
        for a, b, f in self.collapses:
            if a <= t < b:
                factor = min(factor, f)
        return factor

    # -- per-RPC loss ---------------------------------------------------
    def _unit(self, n: int, salt: int) -> float:
        return _splitmix64(self.seed * 0x10001 + n * 2 + salt) / 2.0 ** 64

    def jitter_unit(self) -> float:
        """One deterministic uniform draw in [0,1) for backoff jitter."""
        self.draws += 1
        return self._unit(self.draws, salt=1)

    def rpc_fate(self) -> str:
        """Fate of one transmitted message: ``"ok"``, ``"lost_request"`` or
        ``"lost_response"``.  Consumes one draw; request and response loss
        are equally likely.  The distinction matters only for
        non-idempotent work: a lost *response* means the server executed."""
        self.draws += 1
        if self._unit(self.draws, salt=0) >= self.rpc_loss_prob:
            return "ok"
        self.dropped += 1
        return "lost_request" if self._unit(self.draws, salt=2) < 0.5 else "lost_response"

    # -- replica crashes ------------------------------------------------
    def due_crashes(self, t: float) -> List[str]:
        """Replica names whose crash time has arrived and not yet fired;
        the caller (the fleet) acts on each exactly once."""
        due = [name for name, tc in sorted(self.crashes.items())
               if tc <= t and name not in self.crashed]
        self.crashed.update(due)
        return due

    @classmethod
    def chaos_schedule(
        cls,
        seed: int,
        *,
        duration_s: float,
        n_outages: int = 1,
        mean_outage_s: float = 0.5,
        rpc_loss_prob: float = 0.05,
        n_collapses: int = 0,
        collapse_factor: float = 0.05,
        crashes: Optional[dict] = None,
    ) -> "FaultInjector":
        """A seeded fault schedule over ``[0, duration_s]``: outage windows
        and collapse episodes placed deterministically from the seed (evenly
        spread phases, hashed offsets)."""
        outages = []
        for i in range(n_outages):
            u = _splitmix64(seed * 7919 + i) / 2.0 ** 64
            start = duration_s * (i + 0.25 + 0.5 * u) / max(1, n_outages)
            outages.append((start, start + mean_outage_s))
        collapses = []
        for i in range(n_collapses):
            u = _splitmix64(seed * 104729 + i) / 2.0 ** 64
            start = duration_s * (i + 0.1 + 0.4 * u) / max(1, n_collapses)
            collapses.append((start, start + 2.0 * mean_outage_s, collapse_factor))
        return cls(seed=seed, outages=outages, rpc_loss_prob=rpc_loss_prob,
                   collapses=collapses, crashes=crashes)


def synth_bandwidth_trace(
    mean_mbps: float,
    std_mbps: float,
    drop_prob: float,
    seed: int,
    duration_s: float = TRACE_DURATION_S,
    interval_s: float = TRACE_INTERVAL_S,
) -> np.ndarray:
    """Deterministic synthetic bandwidth trace (bytes/s), AR(1)-smoothed with
    occasional near-zero obstruction drops (outdoor behaviour in Fig. 3)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / interval_s)
    noise = rng.normal(0.0, std_mbps, size=n)
    ar = np.empty(n)
    acc = 0.0
    for i in range(n):  # AR(1) for temporal correlation
        acc = 0.85 * acc + 0.15 * noise[i]
        ar[i] = acc
    bw = mean_mbps + ar * 3.0
    drops = rng.random(n) < drop_prob
    bw[drops] *= rng.random(int(drops.sum())) * 0.1
    bw = np.clip(bw, 0.5, None)
    return bw * MBPS


@dataclasses.dataclass
class SharedBackhaul:
    """The site uplink every edge node of one site hangs off.

    A replicated fleet terminates each client radio at one of several edge
    boxes, but the boxes share one site uplink; once enough nodes serve at
    once, the backhaul, not any one node's NIC, is the bottleneck.  The same
    fair-share model as :class:`ServerIngress`, one level up: each of
    ``active_nodes`` nodes gets ``capacity_bytes_per_s / active_nodes``."""

    capacity_bytes_per_s: float = 10e9 / 8.0    # 10-gigabit site uplink
    active_nodes: int = 1
    bytes_total: float = 0.0

    def share(self) -> float:
        return self.capacity_bytes_per_s / max(1, self.active_nodes)


@dataclasses.dataclass
class ServerIngress:
    """Shared edge-server ingress capacity (AP backhaul / server NIC).

    In a multi-tenant deployment every client's wireless link terminates at
    the same server; once enough clients transfer concurrently, the shared
    ingress — not the per-client radio — becomes the bottleneck.  The model
    is a fair-share pipe: each of ``active_clients`` concurrently-served
    links gets ``capacity_bytes_per_s / active_clients``, and a client's
    effective bandwidth is the min of its own link and that share.  The
    multi-tenant harness updates ``active_clients`` as sessions join/leave.

    ``backhaul`` chains this node's ingress behind a site-level
    :class:`SharedBackhaul` (multi-node fleets, :func:`multi_node_ingress`):
    the share is then also capped by the backhaul's per-node share.  With a
    ``fault`` injector, collapse and outage episodes squeeze the shared pipe
    too (a site-level event hits every client behind it)."""

    capacity_bytes_per_s: float = 1e9 / 8.0     # gigabit backhaul
    active_clients: int = 1
    # aggregate traffic through the shared link, BOTH directions (every
    # transfer_time call on an attached client link accumulates here)
    bytes_total: float = 0.0
    backhaul: Optional[SharedBackhaul] = None
    # observability: with a Tracer attached, each billed transfer samples
    # the cumulative ingress byte counter on ``track`` (at the simulated
    # time the caller passes; transfer_time does)
    tracer: Optional[Any] = None
    track: str = "ingress"
    fault: Optional[FaultInjector] = None
    # overload protection: a bound AdmissionController mirrors its wait-queue
    # depth here, so queueing at the edge box is observable at the ingress
    queue_depth: int = 0
    depth_gauge: Optional[Any] = None

    def set_queue_depth(self, depth: int, t: Optional[float] = None) -> None:
        """Record the admitted-but-uncompleted backlog behind this ingress
        (the gauge, and a trace counter sampled on the simulated clock)."""
        self.queue_depth = int(depth)
        if self.depth_gauge is not None:
            self.depth_gauge.set(self.queue_depth)
        if self.tracer is not None and t is not None:
            self.tracer.counter(self.track, "queue_depth", t, float(self.queue_depth))

    def share(self, t: Optional[float] = None) -> float:
        share = self.capacity_bytes_per_s / max(1, self.active_clients)
        if self.backhaul is not None:
            share = min(share, self.backhaul.share())
        if self.fault is not None and t is not None:
            factor = self.fault.bandwidth_factor(t)
            if factor < 1.0:
                share = max(share * factor, OUTAGE_FLOOR_BYTES_PER_S)
        return share

    def account(self, nbytes: float, t: Optional[float] = None) -> None:
        """Bill a transfer through this node (and the site backhaul)."""
        self.bytes_total += nbytes
        if self.backhaul is not None:
            self.backhaul.bytes_total += nbytes
        if self.tracer is not None and t is not None:
            self.tracer.counter(self.track, "ingress_bytes", t, self.bytes_total)


def multi_node_ingress(
    n_nodes: int,
    node_capacity_bytes_per_s: float = 1e9 / 8.0,
    backhaul_bytes_per_s: float = 10e9 / 8.0,
) -> List[ServerIngress]:
    """Per-node ingress pipes for an ``n_nodes`` edge fleet behind one shared
    site backhaul: each node fair-shares its own NIC among its clients AND
    the site uplink among the nodes."""
    if n_nodes < 1:
        raise ValueError(f"need at least one node, got {n_nodes}")
    backhaul = SharedBackhaul(capacity_bytes_per_s=backhaul_bytes_per_s, active_nodes=n_nodes)
    return [ServerIngress(capacity_bytes_per_s=node_capacity_bytes_per_s, backhaul=backhaul)
            for _ in range(n_nodes)]


@dataclasses.dataclass
class NetworkModel:
    """RPC/link timing: per-call latency = RTT + payload/bw(t) + resp/bw(t).

    ``base_rtt_s`` is the *effective* per-RPC round trip calibrated to the
    paper's measured Cricket/RRTO latency ratio (small RPCs are pipelined by
    the TCP stack, so the effective cost sits well under a raw Wi-Fi ping)."""

    name: str
    trace_bytes_per_s: np.ndarray
    base_rtt_s: float = 1.0e-4
    rtt_jitter_s: float = 5e-5
    per_rpc_cpu_s: float = 30e-6      # serialization / libtirpc stack cost
    interval_s: float = TRACE_INTERVAL_S
    ingress: Optional[ServerIngress] = None
    # outage windows and collapse episodes scale the trace bandwidth; None
    # (the default) leaves every timing unchanged
    fault: Optional[FaultInjector] = None

    def bandwidth_at(self, t: float) -> float:
        idx = int(t / self.interval_s) % len(self.trace_bytes_per_s)
        bw = float(self.trace_bytes_per_s[idx])
        if self.fault is not None:
            factor = self.fault.bandwidth_factor(t)
            if factor < 1.0:
                bw = max(bw * factor, OUTAGE_FLOOR_BYTES_PER_S)
        return bw

    def _rtt_at(self, t: float) -> float:
        # deterministic jitter keyed to the trace position
        idx = int(t / self.interval_s) % len(self.trace_bytes_per_s)
        frac = (idx * 2654435761 % 1000) / 1000.0
        return self.base_rtt_s + self.rtt_jitter_s * frac

    def transfer_time(self, nbytes: float, t: float) -> float:
        """Pure payload serialization over the link at time t."""
        if nbytes <= 0:
            return 0.0
        bw = self.bandwidth_at(t)
        if self.ingress is not None:
            bw = min(bw, self.ingress.share(t))
            self.ingress.account(nbytes, t)
        # a zero-bandwidth interval (obstructed radio, saturated ingress)
        # stalls the transfer for a long-but-finite interval instead of
        # dividing by zero
        return nbytes / max(bw, 1e-6)

    def rpc_time(self, payload_bytes: float, response_bytes: float, t: float) -> float:
        """Blocking RPC: request out, response back, plus stack overheads."""
        return (
            self._rtt_at(t)
            + self.transfer_time(payload_bytes, t)
            + self.transfer_time(response_bytes, t)
            + self.per_rpc_cpu_s
        )


def indoor_network(seed: int = 0) -> NetworkModel:
    """Lab environment: 93 Mbps mean (paper Fig. 3 indoor)."""
    return NetworkModel(
        name="indoor",
        trace_bytes_per_s=synth_bandwidth_trace(93.0, 4.0, 0.001, seed=seed),
    )


def outdoor_network(seed: int = 1) -> NetworkModel:
    """Campus garden: 73 Mbps mean, heavy fluctuation + drops (Fig. 3 outdoor)."""
    return NetworkModel(
        name="outdoor",
        trace_bytes_per_s=synth_bandwidth_trace(73.0, 9.0, 0.02, seed=seed),
        base_rtt_s=1.8e-4,
        rtt_jitter_s=1.0e-4,
    )


# ---------------------------------------------------------------------------
# discrete-event timeline — the substrate of pipelined / open-loop serving
# ---------------------------------------------------------------------------
#
# The cooperative round driver (serving/multitenant.py) advances one shared
# clock lockstep, which cannot express two things a sustained stream is made
# of: clients whose clocks disagree, and work that arrives whether or not the
# previous inference finished.  The pieces below model exactly that.


@dataclasses.dataclass
class ClientClock:
    """One client's local clock, related to global (server) time by a fixed
    offset plus a linear drift: ``global = offset + local * (1 + drift)``.
    Per-client timestamps must be mapped onto the global timeline before they
    can be compared or scheduled."""

    offset_s: float = 0.0
    drift: float = 0.0       # fractional rate error (50e-6 = 50 ppm fast)

    def to_global(self, local_t: float) -> float:
        return self.offset_s + local_t * (1.0 + self.drift)

    def to_local(self, global_t: float) -> float:
        return (global_t - self.offset_s) / (1.0 + self.drift)


def poisson_arrivals(
    rate_hz: float, n: int, seed: int = 0, start: float = 0.0
) -> List[float]:
    """Open-loop Poisson arrival process: ``n`` arrival times (seconds) with
    exponential inter-arrival gaps at ``rate_hz``.  The source does not wait
    for completions, so an overloaded pipeline accumulates queue."""
    if rate_hz <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate_hz}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=n)
    return list(start + np.cumsum(gaps))


def periodic_arrivals(
    period_s: float, n: int, start: float = 0.0, jitter_s: float = 0.0,
    seed: int = 0,
) -> List[float]:
    """Fixed-rate arrival process (frame clock) with optional uniform jitter."""
    if period_s <= 0:
        raise ValueError(f"period must be positive, got {period_s}")
    ts = start + period_s * (1.0 + np.arange(n))
    if jitter_s > 0.0:
        rng = np.random.default_rng(seed)
        ts = ts + rng.uniform(0.0, jitter_s, size=n)
    return list(np.maximum.accumulate(ts))  # jitter never reorders arrivals


@dataclasses.dataclass
class CapacityResource:
    """A serially shared unit resource (client SoC, half-duplex radio, server
    GPU) on the discrete-event timeline.  Reservations serialize on a busy
    frontier (``free_at``) and every busy interval is recorded, the same
    semantics as ``OffloadServer.busy_until``.  ``record_intervals=False``
    keeps only the running total (``busy_total``), for session-lifetime
    resources driven by an unbounded stream.  With a ``tracer`` every
    reservation emits an ``occupy`` span on ``track`` (the resource's name by
    default), so an analytic schedule renders like an executed timeline."""

    name: str
    free_at: float = 0.0
    record_intervals: bool = True
    busy: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    busy_total: float = 0.0
    tracer: Optional[Any] = None
    track: Optional[str] = None

    def earliest(self, t: float) -> float:
        """Earliest instant a reservation requested at ``t`` can begin."""
        return max(t, self.free_at)

    def reserve(self, start: float, duration: float) -> Tuple[float, float]:
        """Reserve ``duration`` seconds no earlier than ``start``; returns the
        actual ``(begin, end)`` interval."""
        if duration < 0:
            raise ValueError(f"negative reservation: {duration}")
        begin = self.earliest(start)
        end = begin + duration
        if duration > 0:
            self.busy_total += duration
            if self.record_intervals:
                self.busy.append((begin, end))
            if self.tracer is not None:
                self.tracer.span(self.track or self.name, "occupy", begin, end)
        self.free_at = end
        return begin, end

    def busy_seconds(self, t0: float = 0.0, t1: Optional[float] = None) -> float:
        """Total reserved time intersected with ``[t0, t1]``.  A totals-only
        resource answers only the whole-lifetime query."""
        if not self.record_intervals:
            if t0 == 0.0 and t1 is None:
                return self.busy_total
            raise ValueError(f"{self.name}: windowed busy_seconds needs record_intervals=True")
        hi = t1 if t1 is not None else self.free_at
        return sum(max(0.0, min(e, hi) - max(b, t0)) for b, e in self.busy)

    def utilization(self, t0: float = 0.0, t1: Optional[float] = None) -> float:
        hi = t1 if t1 is not None else self.free_at
        span = hi - t0
        return self.busy_seconds(t0, t1) / span if span > 0 else 0.0


class EventTimeline:
    """A minimal discrete-event scheduler: ``at(t, fn)`` enqueues, ``run()``
    fires callbacks in global-time order (FIFO among ties).  Handlers may
    schedule further events; ``now`` is the time of the firing event."""

    def __init__(self):
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.fired = 0

    def at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (float(t), next(self._seq), fn))

    def __len__(self) -> int:
        return len(self._heap)

    def run(self, until: Optional[float] = None) -> float:
        """Fire events until the queue drains (or past ``until``); returns
        the time of the last fired event."""
        while self._heap:
            t, _, fn = self._heap[0]
            if until is not None and t > until:
                break
            heapq.heappop(self._heap)
            if t < self.now:
                raise RuntimeError(f"event at {t} scheduled before current time {self.now}")
            self.now = t
            self.fired += 1
            fn()
        return self.now


def get_network(name: str, seed: Optional[int] = None) -> NetworkModel:
    if name == "indoor":
        return indoor_network(seed if seed is not None else 0)
    if name == "outdoor":
        return outdoor_network(seed if seed is not None else 1)
    raise ValueError(f"unknown network environment: {name}")
