"""Straggler mitigation for the serving path: deadline-based hedged dispatch
(``repro.distributed.straggler``).

At scale, tail latency is dominated by slow replicas (network hiccups,
preemptions).  The router sends each request to a primary replica; if no
completion arrives within ``hedge_multiplier`` times the observed median
latency, it re-sends the request to a second replica and takes the first
completion (Dean and Barroso, "The Tail at Scale"), on a simulated clock, so
runs are deterministic.

The router is backend-agnostic: a *completion source* maps ``(replica,
request index)`` to the completion latency (or None for a failure).  The
default source calls :meth:`ReplicaModel.latency`, a standalone latency
simulation; the fleet (``repro_torch.serving.fleet``) plugs in real replay
on live edge replicas, so the same deadline arithmetic drives both.

For the training path, ``SkipAndRescale`` is the drop-straggler policy: a
step proceeds when at least a quorum of workers contributed, and the
gradients are rescaled by the participation count.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.obs import MetricsRegistry, RegistryBackedStats

# the deadline tracks the *recent* latency distribution, so the observation
# buffer is bounded: an unbounded history leaks over a long-lived stream and
# freezes the deadline on stale samples
OBSERVATION_WINDOW = 256


class NoHealthyReplicaError(RuntimeError):
    """Every candidate replica is marked failed — nothing can serve."""


class AllReplicasFailedError(NoHealthyReplicaError):
    """A dispatched request produced no completion: the primary failed and
    every hedge candidate failed too."""


@dataclasses.dataclass
class ReplicaModel:
    """Latency model of one serving replica (simulated)."""

    name: str
    base_latency_s: float
    jitter: Callable[[int], float]        # request index -> extra latency
    failed: bool = False

    def latency(self, req_idx: int) -> Optional[float]:
        if self.failed:
            return None
        return self.base_latency_s + max(0.0, self.jitter(req_idx))


class HedgeStats(RegistryBackedStats):
    """Hedged-dispatch counters and the latency of every request, under the
    reference's names; registry-backed.  ``latencies`` aliases the
    registry's ``latency_s`` histogram values, so ``.append`` and slicing
    keep working while the distribution shows in a snapshot."""

    _fields = (
        ("requests", 0),
        ("hedged", 0),
        ("primary_wins", 0),
        ("hedge_wins", 0),
        ("failures_recovered", 0),
        ("total_latency_s", 0.0),
    )

    @property
    def latencies(self) -> List[float]:
        return self.registry.histogram("latency_s").values

    @property
    def p99(self) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

    @property
    def mean(self) -> float:
        return self.total_latency_s / max(1, self.requests)

    def as_dict(self) -> Dict[str, Any]:
        d = super().as_dict()
        d["latency_p99_s"] = self.p99
        d["latency_mean_s"] = self.mean
        return d


class HedgedRouter:
    """Dispatch with a speculative re-send after an adaptive deadline.

    ``replicas`` need ``name`` and ``failed`` attributes; with the default
    completion source they also need ``latency(req_idx)`` (the
    :class:`ReplicaModel` protocol).  ``completion_source(replica, req_idx)``
    returns the completion latency in seconds, or None when the replica
    fails to complete the request.

    ``health(index)`` is a soft health signal (the fleet's circuit
    breakers): an unhealthy replica is routed *around*, not treated as
    failed.  If every candidate is unhealthy, a second pass ignores the
    signal, so saturation never escalates to :class:`NoHealthyReplicaError`.
    None routes as a router without breakers does.  ``metrics`` is the
    registry scope of its :class:`HedgeStats`."""

    def __init__(
        self,
        replicas: List[Any],
        hedge_multiplier: float = 2.0,
        min_observations: int = 8,
        window: int = OBSERVATION_WINDOW,
        completion_source: Optional[Callable[[Any, int], Optional[float]]] = None,
        metrics: Optional[MetricsRegistry] = None,
        health: Optional[Callable[[int], bool]] = None,
    ):
        if window < 1:
            raise ValueError(f"observation window must be >= 1, got {window}")
        self.replicas = replicas
        self.hedge_multiplier = hedge_multiplier
        self.min_observations = min_observations
        self.completion_source = completion_source
        self._observed: Deque[float] = deque(maxlen=window)
        self.stats = HedgeStats(registry=metrics)
        self._rr = 0
        self.health = health

    @property
    def observed_count(self) -> int:
        """Completions inside the deadline-estimation window."""
        return len(self._observed)

    @property
    def observed_median(self) -> Optional[float]:
        """Median completion latency in the window (None before any)."""
        if not self._observed:
            return None
        xs = sorted(self._observed)
        return xs[len(xs) // 2]

    def _complete(self, replica: Any, req_idx: int) -> Optional[float]:
        if self.completion_source is not None:
            return self.completion_source(replica, req_idx)
        return replica.latency(req_idx)

    def _deadline(self) -> float:
        if len(self._observed) < self.min_observations:
            return float("inf") if not self._observed else (
                self.hedge_multiplier * max(self._observed)
            )
        return self.hedge_multiplier * self.observed_median

    def _healthy(self, idx: int) -> bool:
        return self.health is None or self.health(idx)

    def _pick(self, exclude: int) -> int:
        # the first pass honours the soft health signal; the fallback pass
        # takes any replica not failed (a saturated box beats no box)
        for honor_health in (True, False) if self.health is not None else (True,):
            rr = self._rr
            for _ in range(len(self.replicas)):
                rr = (rr + 1) % len(self.replicas)
                if rr == exclude or self.replicas[rr].failed:
                    continue
                if honor_health and not self._healthy(rr):
                    continue
                self._rr = rr
                return rr
        raise NoHealthyReplicaError("no healthy replica available")

    def _settle(self, t: float, primary_won: bool) -> None:
        self._observed.append(t)
        if primary_won:
            self.stats.primary_wins += 1
        else:
            self.stats.hedge_wins += 1
        self.stats.total_latency_s += t
        self.stats.latencies.append(t)

    def dispatch(
        self,
        req_idx: int,
        *,
        primary: Optional[int] = None,
        completion: Optional[Callable[[Any, int], Optional[float]]] = None,
        speculative: bool = True,
    ) -> Tuple[float, str]:
        """Returns (completion latency, winner name).

        ``primary`` overrides round-robin primary selection (the fleet places
        by affinity); ``completion`` overrides the completion source for this
        request.  ``speculative=False`` hedges only on an outright primary
        *failure*, never on a slow completion: the mode for non-idempotent
        requests (a stateful replay step advances server-resident state, so
        it must not run twice)."""
        complete = completion or self._complete
        primary_idx = self._pick(exclude=-1) if primary is None else int(primary)
        primary_rep = self.replicas[primary_idx]
        t_primary = complete(primary_rep, req_idx)
        deadline = self._deadline()
        self.stats.requests += 1

        if not (t_primary is None or (speculative and t_primary > deadline)):
            self._settle(t_primary, primary_won=True)
            return t_primary, primary_rep.name
        try:
            backup_idx = self._pick(exclude=primary_idx)
        except NoHealthyReplicaError:
            if t_primary is None:
                raise AllReplicasFailedError(
                    f"request {req_idx}: primary {primary_rep.name!r} failed "
                    "and no healthy hedge candidate remains"
                ) from None
            # nowhere to hedge: the slow primary completion stands
            self._settle(t_primary, primary_won=True)
            return t_primary, primary_rep.name

        self.stats.hedged += 1
        tried = {primary_idx, backup_idx}
        backup = self.replicas[backup_idx]
        t_backup = complete(backup, req_idx)
        while t_primary is None and t_backup is None:
            # the primary failed outright and so did the backup pick: walk
            # every remaining healthy replica before giving up (failure
            # recovery, not speculation: the success path runs no extra);
            # healthy candidates first, saturated ones as a last resort
            remaining = sorted(
                (i for i, r in enumerate(self.replicas) if i not in tried and not r.failed),
                key=lambda i: not self._healthy(i),
            )
            if not remaining:
                raise AllReplicasFailedError(
                    f"request {req_idx}: primary {primary_rep.name!r} and "
                    "every healthy hedge candidate failed to complete"
                )
            backup_idx = remaining[0]
            tried.add(backup_idx)
            backup = self.replicas[backup_idx]
            t_backup = complete(backup, req_idx)
        candidates = []
        if t_primary is not None:
            candidates.append((t_primary, primary_rep.name))
        if t_backup is not None:
            candidates.append((deadline + t_backup, backup.name))
        if t_primary is None:
            self.stats.failures_recovered += 1
        t, winner = min(candidates)
        self._settle(t, primary_won=winner != backup.name)
        return t, winner


@dataclasses.dataclass
class SkipAndRescale:
    """Training-side straggler policy: proceed at quorum, rescale gradients."""

    world: int
    quorum_fraction: float = 0.9

    def step(self, arrived: List[bool]) -> Tuple[bool, float]:
        """(proceed?, gradient rescale factor = world/participants)."""
        n = sum(arrived)
        if n < self.quorum_fraction * self.world:
            return False, 1.0
        return True, self.world / max(n, 1)
