"""MEC network simulation — trace-driven wireless bandwidth + RTT model.

The link part of ``repro.core.netsim``: the paper's measured
environments (Fig. 3), indoor lab (93 Mbps mean, mild fluctuation) and outdoor
garden (73 Mbps mean, heavy fluctuation with occasional near-zero drops from
obstruction), as deterministic (seeded) 0.1 s-interval traces over 5 minutes,
and the shared edge-server ingress that co-tenant clients contend for; and
the discrete-event timeline that pipelined and open-loop serving run on
(client clock skew, arrival processes, capacity resources, the event
scheduler).

The link is simulated; every latency/energy number derived from it is a model
output, not a measurement.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, List, Optional, Tuple

import numpy as np

MBPS = 1e6 / 8.0  # bytes/s per Mbps

TRACE_INTERVAL_S = 0.1
TRACE_DURATION_S = 300.0


def _splitmix64(x: int) -> int:
    """One splitmix64 round — a stateless 64-bit mixer."""
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
class ServerIngress:
    """Shared edge-server ingress capacity (AP backhaul / server NIC).

    In a multi-tenant deployment every client's wireless link terminates at
    the same server; once enough clients transfer concurrently, the shared
    ingress — not the per-client radio — becomes the bottleneck.  The model
    is a fair-share pipe: each of ``active_clients`` concurrently-served
    links gets ``capacity_bytes_per_s / active_clients``, and a client's
    effective bandwidth is the min of its own link and that share.  The
    multi-tenant harness updates ``active_clients`` as sessions join/leave."""

    capacity_bytes_per_s: float = 1e9 / 8.0     # gigabit backhaul
    active_clients: int = 1
    # aggregate traffic through the shared link, BOTH directions (every
    # transfer_time call on an attached client link accumulates here)
    bytes_total: float = 0.0

    def share(self) -> float:
        return self.capacity_bytes_per_s / max(1, self.active_clients)

    def account(self, nbytes: float) -> None:
        self.bytes_total += nbytes


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

    def bandwidth_at(self, t: float) -> float:
        idx = int(t / self.interval_s) % len(self.trace_bytes_per_s)
        return float(self.trace_bytes_per_s[idx])

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
            bw = min(bw, self.ingress.share())
            self.ingress.account(nbytes)
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
    resources driven by an unbounded stream."""

    name: str
    free_at: float = 0.0
    record_intervals: bool = True
    busy: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    busy_total: float = 0.0

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
