"""MEC network simulation — trace-driven wireless bandwidth + RTT model.

The link subset of ``repro.core.netsim``: the paper's measured
environments (Fig. 3), indoor lab (93 Mbps mean, mild fluctuation) and outdoor
garden (73 Mbps mean, heavy fluctuation with occasional near-zero drops from
obstruction), as deterministic (seeded) 0.1 s-interval traces over 5 minutes,
and the shared edge-server ingress that co-tenant clients contend for.

The link is simulated; every latency/energy number derived from it is a model
output, not a measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


def get_network(name: str, seed: Optional[int] = None) -> NetworkModel:
    if name == "indoor":
        return indoor_network(seed if seed is not None else 0)
    if name == "outdoor":
        return outdoor_network(seed if seed is not None else 1)
    raise ValueError(f"unknown network environment: {name}")
