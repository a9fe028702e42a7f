"""Fleet-scale replicated serving: N edge replicas behind a hedged router
(``repro.serving.fleet``).

A deployed MEC site runs several edge boxes, and what users feel there is
tail latency and replica failure.  This module composes the single-box
pieces into a replicated fleet:

* **Placement** — :meth:`EdgeFleet.connect` places each client by affinity
  (a replica already serving this model or fingerprint keeps collecting its
  co-tenants, so the shared cache and batched replay pay off) with least
  load as the tie-break.
* **Hedged dispatch** — every request goes through a
  :class:`~repro_torch.distributed.straggler.HedgedRouter` whose completion
  source runs the real replay on the chosen replica: if the primary's
  latency exceeds the adaptive deadline, or the primary is failed, the
  request goes to a backup and the first completion wins.  Open-loop
  request streams ride the :class:`~repro_torch.core.netsim.EventTimeline`
  (:meth:`EdgeFleet.serve`).
* **Cache replication** — validated IOS fingerprints travel between replicas
  through :meth:`~repro_torch.serving.replay_cache.ReplayCache.save` /
  ``load``: a hedge landing on a cold replica adopts the fingerprint after a
  single recorded inference.
* **Carried-state migration** — a stateful session's server-resident state
  (the KV cache) moves between replicas mid-stream: the source exports it
  (host copies), the device-memory namespace transfers over the site
  backhaul, the destination rebinds the replay program from the client's
  recorded calls and imports the state, and the stream continues bitwise.
* **Crash recovery** — with ``checkpoint_dir``, stateful sessions checkpoint
  every ``checkpoint_every`` steps (:mod:`repro_torch.serving.recovery`); a
  crashed replica's session restores on a peer from the checkpoint files and
  the client's step log alone.
* **Overload** — with ``circuit_breaker=True`` each replica has a
  :class:`CircuitBreaker` fed by every dispatch outcome, and the router
  routes around an open one; ``admission_factory`` gives each replica its
  own :class:`~repro_torch.serving.admission.AdmissionController`.
* **Observability** — ``EdgeFleet.metrics`` is one root
  :class:`~repro_torch.obs.MetricsRegistry` (scopes ``r<i>``, ``hedge`` and
  ``fleet``), so ``fleet.metrics.snapshot()`` reads the whole fleet; with a
  ``tracer`` each hedge attempt is a ``hedge_dispatch`` span on
  ``<replica>/hedge`` (the loser annotated ``cancelled=True`` once the race
  resolves) and placement, migration, crashes and checkpoints are events on
  the ``fleet`` track.

Every replica's server computes on one ``device``: on one card the replicas
share it, and a migration moves the env by reference (its bytes are still
billed to the backhaul), as the reference does in one process.

Hedging needs idempotence.  Stateless inference is idempotent; a stateful
replay step advances server-resident state and is not, so stateful clients
hedge only on an outright primary failure (where the step never ran), and
the re-dispatch first moves the session to the backup.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.engine import SimClock
from repro_torch.core.netsim import EventTimeline, FaultInjector, SharedBackhaul, multi_node_ingress
from repro_torch.core.offload import InferenceResult, OffloadableModel, OffloadSession
from repro_torch.device import resolve_device
from repro_torch.distributed.straggler import HedgedRouter, NoHealthyReplicaError
from repro_torch.obs import MetricsRegistry, RegistryBackedStats, Tracer
from repro_torch.serving.multitenant import RRTOEdgeServer
from repro_torch.serving.recovery import SessionCheckpointer


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class FleetReplica:
    """One edge box: a multi-tenant edge server plus the health and
    latency-injection knobs of the fault tests.  ``slowdown`` adds injected
    completion latency (request index -> extra seconds) on top of the
    inference wall time; ``failed=True`` makes the box stop completing
    requests (dispatches see None and hedge away)."""

    name: str
    edge: RRTOEdgeServer
    failed: bool = False
    slowdown: Callable[[int], float] = lambda i: 0.0

    @property
    def load(self) -> int:
        return len(self.edge.sessions)


class CircuitBreaker:
    """Per-replica saturation breaker (closed / open / half-open).

    A replica that keeps failing, or completing far beyond the fleet's
    observed baseline, is *saturated*: hedging into it only deepens its
    queue.  The breaker counts consecutive bad outcomes (a failure, or a
    latency above ``latency_multiplier`` times the router's observed
    median); at ``failure_threshold`` it opens for ``cooldown_s`` of
    simulated time, the router's health hook routes around it, and after the
    cooldown one probe request (half-open) decides: good closes the breaker,
    bad re-opens it.  It is a soft signal: the router falls back to an
    open-breaker replica when nothing else is healthy."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, *, failure_threshold: int = 3, cooldown_s: float = 0.25,
                 latency_multiplier: float = 4.0):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.latency_multiplier = float(latency_multiplier)
        self.state = self.CLOSED
        self.consecutive_bad = 0
        self.open_until = 0.0
        self.opens = 0

    def allow(self, t: float) -> bool:
        """May this replica take a request at ``t``?  An elapsed cooldown
        moves open -> half-open and admits the probe."""
        if self.state == self.OPEN:
            if t >= self.open_until:
                self.state = self.HALF_OPEN
                return True
            return False
        return True

    def record(self, t: float, *, failed: bool, latency_s: Optional[float] = None,
               baseline_s: Optional[float] = None) -> None:
        """Score one completed (or failed) dispatch on this replica."""
        bad = failed or (
            latency_s is not None and baseline_s is not None and baseline_s > 0.0
            and latency_s > self.latency_multiplier * baseline_s
        )
        if bad:
            self.consecutive_bad += 1
            if self.state == self.HALF_OPEN or self.consecutive_bad >= self.failure_threshold:
                self.state = self.OPEN
                self.open_until = t + self.cooldown_s
                self.opens += 1
                self.consecutive_bad = 0
        else:
            self.consecutive_bad = 0
            self.state = self.CLOSED


class FleetStats(RegistryBackedStats):
    """Fleet-wide counters, under the reference's names; registry-backed."""

    _fields = (
        ("placements", 0),
        ("affinity_hits", 0),
        ("migrations", 0),
        ("migration_bytes", 0.0),
        ("cache_syncs", 0),
        ("replicated_fingerprints", 0),
        ("backup_sessions", 0),
        ("crashes", 0),
        ("crash_restores", 0),
        ("checkpoints", 0),
        ("checkpoint_bytes", 0.0),
        ("steps_replayed", 0),
    )


@dataclasses.dataclass
class FleetResult:
    """One completed request of an open-loop fleet stream."""

    client_id: str
    outputs: List[Any]
    arrival_t: float
    done_at: float
    winner: str               # replica that served the winning completion

    @property
    def latency_seconds(self) -> float:
        return self.done_at - self.arrival_t


class FleetClient:
    """One mobile client served by the fleet.

    A stateless client may hold a primary session plus backup sessions
    created on demand (hedge targets); a stateful client holds exactly one
    session, which *migrates* between replicas instead of forking: the
    carried state has a single home."""

    def __init__(
        self,
        fleet: "EdgeFleet",
        model: OffloadableModel,
        client_id: str,
        session: OffloadSession,
        primary: str,
        *,
        min_repeats: int = 3,
        stateful: bool = False,
    ):
        self.fleet = fleet
        self.model = model
        self.client_id = client_id
        self.min_repeats = min_repeats
        self.stateful = stateful
        self.sessions: Dict[str, OffloadSession] = {primary: session}
        self.primary = primary
        self._req_idx = 0

    @property
    def session(self) -> OffloadSession:
        """The session on the client's current primary replica."""
        return self.sessions[self.primary]

    def infer(self, *inputs, deadline_s: Optional[float] = None) -> InferenceResult:
        """Hedged inference; returns the winning replica's result."""
        return self.dispatch(*inputs, deadline_s=deadline_s)[0]

    def dispatch(self, *inputs, deadline_s: Optional[float] = None
                 ) -> Tuple[InferenceResult, float, str]:
        """One hedged request through the fleet router; returns ``(winning
        result, completion latency, winner replica name)``.  The completion
        source runs the real replay on the chosen replica and reports its
        ``wall_seconds`` plus the replica's injected slowdown; a failed
        replica reports no completion and the router re-dispatches.  Every
        outcome feeds the replica's circuit breaker, and a stateless client
        whose primary's breaker is open starts elsewhere.  ``deadline_s``
        goes to the session's admission controller.  May raise
        :class:`~repro_torch.distributed.straggler.AllReplicasFailedError`,
        or :class:`~repro_torch.serving.admission.AdmissionRejectedError`
        when the replica's controller sheds the request."""
        fleet = self.fleet
        fleet.apply_due_faults()
        tracer = fleet.tracer
        req = self._req_idx
        self._req_idx += 1
        results: Dict[str, InferenceResult] = {}
        # replica name -> its hedge_dispatch span, kept until the race
        # resolves so the loser can be annotated
        hedge_spans: Dict[str, int] = {}
        primary_at_dispatch = self.primary

        def complete(replica: FleetReplica, idx: int) -> Optional[float]:
            t0 = fleet.clock.t
            res = self._execute_on(replica, inputs, deadline_s)
            breaker = fleet.breakers.get(replica.name) if fleet.breakers is not None else None
            if res is None:
                if breaker is not None:
                    breaker.record(fleet.clock.t, failed=True)
                if tracer is not None:
                    tracer.instant(f"{replica.name}/hedge", "hedge_failed", t0,
                                   client=self.client_id, req=req)
                return None
            results[replica.name] = res
            lat = res.wall_seconds + max(0.0, replica.slowdown(idx))
            if breaker is not None:
                breaker.record(fleet.clock.t, failed=False, latency_s=lat,
                               baseline_s=fleet.router.observed_median)
            if tracer is not None:
                hedge_spans[replica.name] = tracer.span(
                    f"{replica.name}/hedge", "hedge_dispatch", t0, t0 + lat,
                    client=self.client_id, req=req,
                    role="primary" if replica.name == primary_at_dispatch else "backup",
                )
            return lat

        primary_idx = fleet.replica_index(self.primary)
        if (fleet.breakers is not None and not self.stateful
                and not fleet.breakers[self.primary].allow(fleet.clock.t)):
            # the primary's breaker is open: route around the saturated box
            # before dispatching into it (a stateful session stays home: its
            # carried state has a single home)
            try:
                primary_idx = fleet.router._pick(exclude=primary_idx)
            except NoHealthyReplicaError:
                pass  # nothing better: the saturated primary still serves
        # a live stateful session's step is not idempotent: hedge it on
        # failure only
        latency, winner = fleet.router.dispatch(
            req,
            primary=primary_idx,
            completion=complete,
            speculative=not (self.stateful and self.session.client.stateful_replay),
        )
        if tracer is not None:
            for name, sid in hedge_spans.items():
                tracer.annotate(sid, winner=name == winner, cancelled=name != winner)
        if winner != self.primary and fleet.replica(self.primary).failed:
            # the primary is dead: re-home this client on the winner (a
            # stateful client already moved inside the completion source)
            self.primary = winner
        self._note_lock()
        if self.stateful and fleet.checkpointer is not None:
            fleet._maybe_checkpoint(self)
        return results[winner], latency, winner

    def _execute_on(self, replica: FleetReplica, inputs: Sequence[Any],
                    deadline_s: Optional[float] = None) -> Optional[InferenceResult]:
        if replica.failed:
            return None
        sess = self.sessions.get(replica.name)
        if sess is None:
            if self.stateful:
                # failure re-dispatch of a stateful session: move it, carried
                # state and all, then run the step exactly once.  A merely
                # failed source still exports its live state (migration); a
                # crashed one lost it, so the session restores from the last
                # checkpoint instead
                src = self.fleet.locate(self.client_id)
                if self.fleet.is_crashed(src.name):
                    self.fleet.recover(self.client_id, replica.name)
                else:
                    self.fleet.migrate(self.client_id, replica.name)
                sess = self.sessions[replica.name]
            else:
                sess = self.fleet._backup_session(self, replica)
        return sess.infer(*inputs, deadline_s=deadline_s)

    def _note_lock(self) -> None:
        """Record fingerprint affinity once this client's IOS locks, so later
        placements of the same sequence co-locate with it, and publish the
        fingerprint to every replica at once."""
        cl = self.session.client
        if cl.ios_fp is not None and cl.ios_fp not in self.fleet._affinity:
            self.fleet._affinity[cl.ios_fp] = self.primary
            self.fleet.replicate_caches()


class EdgeFleet:
    """N replicated edge servers behind a hedged, affinity-placing router.

    All replicas share one :class:`~repro_torch.core.engine.SimClock`
    (sessions migrate between them without time jumps), compute on one
    ``device``, and hang their per-node ingress off one site
    :class:`~repro_torch.core.netsim.SharedBackhaul`.  ``circuit_breaker``
    gives each replica a :class:`CircuitBreaker` with its defaults behind
    the router's health hook; ``admission_factory(replica name)`` builds
    each replica's admission controller.  ``metrics`` is the root registry
    (a fresh one by default) under which each replica reports as ``r<i>``,
    the router as ``hedge`` and the fleet as ``fleet``; ``tracer`` reaches
    every replica, the router's completions and the fleet's events."""

    def __init__(
        self,
        n_replicas: int = 2,
        *,
        hedging: bool = True,
        min_observations: int = 8,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        fault: Optional[FaultInjector] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 4,
        circuit_breaker: bool = False,
        admission_factory: Optional[Callable[[str], Any]] = None,
        device: Any = "cuda",
    ):
        if n_replicas < 1:
            raise ValueError(f"need at least one replica, got {n_replicas}")
        dev = resolve_device(device)
        self.clock = SimClock()
        self.timeline = EventTimeline()
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        ingresses = multi_node_ingress(n_replicas)
        self.backhaul: SharedBackhaul = ingresses[0].backhaul
        self.replicas: List[FleetReplica] = [
            FleetReplica(
                name=f"r{i}",
                edge=RRTOEdgeServer(
                    ingress=ingresses[i], clock=self.clock, name=f"r{i}", tracer=tracer,
                    metrics=self.metrics.scope(f"r{i}"), fault=fault,
                    # one controller per box: each guards its own queue
                    admission=admission_factory(f"r{i}") if admission_factory is not None else None,
                    device=dev,
                ),
            )
            for i in range(n_replicas)
        ]
        self.hedging = hedging
        # per-replica breakers, the router's soft health signal; None routes
        # as a fleet without breakers does
        self.breakers: Optional[Dict[str, CircuitBreaker]] = (
            {rep.name: CircuitBreaker() for rep in self.replicas}
            if circuit_breaker else None
        )
        self.router = HedgedRouter(
            self.replicas,
            # an infinite multiplier never trips the speculative deadline, so
            # a no-hedge fleet still recovers from outright failures
            hedge_multiplier=2.0 if hedging else float("inf"),
            min_observations=min_observations,
            metrics=self.metrics.scope("hedge"),
            health=(
                (lambda i: self.breakers[self.replicas[i].name].allow(self.clock.t))
                if circuit_breaker else None
            ),
        )
        self.clients: Dict[str, FleetClient] = {}
        self._affinity: Dict[str, str] = {}   # model name / IOS fp -> replica
        self.stats = FleetStats(registry=self.metrics.scope("fleet"))
        self.fault = fault
        self.checkpointer = (
            SessionCheckpointer(checkpoint_dir, every=checkpoint_every)
            if checkpoint_dir is not None else None
        )
        self._crashed: set = set()

    # -- replica lookup -------------------------------------------------
    def replica(self, name: str) -> FleetReplica:
        return self.replicas[self.replica_index(name)]

    def replica_index(self, name: str) -> int:
        for i, rep in enumerate(self.replicas):
            if rep.name == name:
                return i
        raise KeyError(f"unknown replica {name!r}")

    def locate(self, client_id: str) -> FleetReplica:
        """The replica currently hosting ``client_id``'s session."""
        for rep in self.replicas:
            if client_id in rep.edge.sessions:
                return rep
        raise KeyError(f"client {client_id!r} not connected to any replica")

    def _target(self, src: FleetReplica, to: Optional[str], what: str, client_id: str) -> FleetReplica:
        """The named replica, or the least-loaded healthy peer of ``src``."""
        if to is not None:
            return self.replica(to)
        candidates = [r for r in self.replicas if r.name != src.name and not r.failed]
        if not candidates:
            raise NoHealthyReplicaError(f"no healthy {what} target for {client_id!r}")
        return min(candidates, key=lambda r: r.load)

    # -- placement ------------------------------------------------------
    def place(self, model: OffloadableModel, fingerprint: Optional[str] = None) -> FleetReplica:
        """Pick a replica for a new client: affinity first (a replica already
        serving this model, or a reconnecting client's IOS fingerprint),
        least load as the tie-break."""
        healthy = [r for r in self.replicas if not r.failed]
        if not healthy:
            raise NoHealthyReplicaError("every fleet replica is failed")
        self.stats.placements += 1
        for key in (fingerprint, model.name):
            if key is None:
                continue
            owner = self._affinity.get(key)
            if owner is not None and not self.replica(owner).failed:
                self.stats.affinity_hits += 1
                if self.tracer is not None:
                    self.tracer.instant("fleet", "place", self.clock.t, model=model.name,
                                        replica=owner, affinity=True)
                return self.replica(owner)
        rep = min(healthy, key=lambda r: r.load)
        self._affinity.setdefault(model.name, rep.name)
        if self.tracer is not None:
            self.tracer.instant("fleet", "place", self.clock.t, model=model.name,
                                replica=rep.name, affinity=False)
        return rep

    def connect(
        self,
        model: OffloadableModel,
        *,
        client_id: Optional[str] = None,
        min_repeats: int = 3,
        stateful: bool = False,
        fingerprint: Optional[str] = None,
        **session_kwargs: Any,
    ) -> FleetClient:
        """Place and attach one client; ``stateful=True`` declares that the
        model carries loop state (a KV cache), so the fleet never forks its
        session: hedging is failure-only and moves the session."""
        cid = (client_id if client_id is not None
               else f"u{sum(len(r.edge.sessions) for r in self.replicas)}")
        if cid in self.clients:
            raise ValueError(f"client id {cid!r} already connected")
        rep = self.place(model, fingerprint)
        sess = rep.edge.connect(model, client_id=cid, min_repeats=min_repeats, **session_kwargs)
        client = FleetClient(self, model, cid, sess, rep.name, min_repeats=min_repeats,
                             stateful=stateful)
        if stateful and self.checkpointer is not None:
            self.checkpointer.attach(sess.client)
        self.clients[cid] = client
        return client

    def _backup_session(self, client: FleetClient, replica: FleetReplica) -> OffloadSession:
        """A hedge-target session on a replica the client has never used.
        The fingerprint reaches the cold replica through the cache tier
        first, so the backup adopts the IOS after one recorded inference."""
        self.replicate_caches()
        sess = replica.edge.connect(client.model, client_id=client.client_id,
                                    min_repeats=client.min_repeats)
        client.sessions[replica.name] = sess
        self.stats.backup_sessions += 1
        return sess

    # -- cache replication ----------------------------------------------
    def replicate_caches(self) -> int:
        """Push every replica's validated fingerprints to every other replica
        through the cache's persistence layer (each publishes its metadata
        file to the shared tier, every peer merges the others').  A failed
        replica's file still replicates: that is how its fingerprints survive
        the box.  Returns the number of fingerprints known fleet-wide."""
        self.stats.cache_syncs += 1
        with tempfile.TemporaryDirectory() as tier:
            paths = {}
            for rep in self.replicas:
                paths[rep.name] = os.path.join(tier, f"{rep.name}.json")
                rep.edge.save_cache(paths[rep.name])
            for rep in self.replicas:
                for other, path in paths.items():
                    if other != rep.name:
                        rep.edge.load_cache(path)
        known = set()
        for rep in self.replicas:
            known.update(rep.edge.cache.fingerprints)
            known.update(rep.edge.cache.persisted_fingerprints)
        self.stats.replicated_fingerprints = len(known)
        return len(known)

    def _rebind(self, dst: FleetReplica, client_id: str, cl) -> None:
        """Rebuild the client's replay binding(s) on ``dst`` from its recorded
        calls (the replicated fingerprint is known there); seeding reads the
        env already installed."""
        dst.edge.server.prepare_replay(cl._ios_calls, client_id=client_id,
                                       fingerprint=cl.ios_fp, carried_pairs=cl.ios.carried_pairs)
        if cl.split_plan is not None:
            dst.edge.server.prepare_split(cl._ios_calls, cl.split_plan, client_id=client_id,
                                          fingerprint=cl.ios_fp,
                                          carried_pairs=cl.ios.carried_pairs)

    def _rehome(self, client_id: str, src: FleetReplica, dst: FleetReplica, sess) -> None:
        client = self.clients.get(client_id)
        if client is not None:
            client.sessions.pop(src.name, None)
            client.sessions[dst.name] = sess
            client.primary = dst.name
        cl = sess.client
        if cl.ios_fp is not None:
            self._affinity[cl.ios_fp] = dst.name

    # -- carried-state migration ----------------------------------------
    def migrate(self, client_id: str, to: Optional[str] = None) -> str:
        """Move one client's session, with its live carried state, to another
        replica mid-stream; returns the destination's name.

        (1) The fingerprint travels through the cache tier, (2) the live
        carried state is exported (host copies), (3) the device-memory
        namespace moves over the site backhaul (by reference: the replicas
        share the device), (4) the destination rebinds the replay program
        from the client's recorded calls and imports the state, (5) the
        session re-associates with the destination.  The continuation is
        bitwise that of a session that never moved.  The source's memory is
        read even when it is marked failed: the modelled deployment
        checkpoints carried state to the shared tier, and the in-process
        context stands in for that checkpoint."""
        src = self.locate(client_id)
        dst = self._target(src, to, "migration", client_id)
        if dst.name == src.name:
            return src.name
        mig_span = (
            self.tracer.begin("fleet", "migrate", self.clock.t, client=client_id,
                              src=src.name, dst=dst.name)
            if self.tracer is not None else None
        )
        sess = src.edge.sessions[client_id]
        cl = sess.client
        self.replicate_caches()
        state = src.edge.server.export_carried_state(client_id)
        src_ctx = src.edge.server.contexts.get(client_id)
        src.edge.disconnect(client_id)
        dst.edge.adopt_session(sess)
        moved = 0.0
        if src_ctx is not None:
            dst.edge.server.context(client_id).env.update(src_ctx.env)
            moved = float(sum(_nbytes(v) for v in src_ctx.env.values()))
            self.stats.migration_bytes += moved
            # replica-to-replica traffic rides the site backhaul, not a radio
            self.backhaul.bytes_total += moved
            if self.tracer is not None:
                self.tracer.instant("fleet", "state_transfer", self.clock.t, client=client_id,
                                    bytes=moved)
        if cl.ios is not None:
            self._rebind(dst, client_id, cl)
            if state is not None:
                dst.edge.server.import_carried_state(client_id, state)
        src.edge.server.contexts.pop(client_id, None)
        self._rehome(client_id, src, dst, sess)
        self.stats.migrations += 1
        if mig_span is not None:
            self.tracer.annotate(mig_span, bytes=moved)
            self.tracer.end(mig_span, self.clock.t)
        return dst.name

    # -- crash recovery --------------------------------------------------
    def apply_due_faults(self) -> None:
        """Fire the scheduled replica crashes whose time has come (consulted
        at every dispatch, so a crash lands between steps, as a dead box is
        noticed at the next request)."""
        if self.fault is None:
            return
        for name in self.fault.due_crashes(self.clock.t):
            if any(r.name == name for r in self.replicas):
                self.crash(name)

    def crash(self, name: str) -> None:
        """Kill a replica: unlike a soft failure (``failed=True``, memory
        intact, migration still possible), a crash wipes the box's contexts
        and its dedup table, so every carried state on it is gone, to be
        recovered only from checkpoints."""
        rep = self.replica(name)
        rep.failed = True
        rep.edge.server.contexts.clear()
        rep.edge.server.dedup.clear()
        self._crashed.add(name)
        self.stats.crashes += 1
        if self.tracer is not None:
            self.tracer.instant("fleet", "crash", self.clock.t, replica=name)

    def is_crashed(self, name: str) -> bool:
        return name in self._crashed

    def _maybe_checkpoint(self, client: FleetClient) -> None:
        """Publish a due checkpoint of one stateful client; the write travels
        to the shared tier over the site backhaul."""
        rep = self.replica(client.primary)
        nbytes = self.checkpointer.maybe_checkpoint(client.client_id, rep.edge.server,
                                                    client.session.client)
        if nbytes > 0.0:
            self.stats.checkpoints += 1
            self.stats.checkpoint_bytes += nbytes
            self.backhaul.bytes_total += nbytes
            if self.tracer is not None:
                self.tracer.instant("fleet", "checkpoint", self.clock.t, client=client.client_id,
                                    bytes=nbytes, seq=client.session.client.step_seq)

    def recover(self, client_id: str, to: Optional[str] = None) -> str:
        """Restore a stateful session whose home replica *crashed* onto a
        healthy peer; returns the destination's name.

        (1) The newest complete checkpoint is read from the shared tier;
        (2) the session re-associates with the destination, and the
        checkpointed device-memory namespace and carried state are placed on
        the destination's device under a rebuilt replay binding; (3) the
        client re-drives the logged steps the checkpoint misses, the same
        wire inputs through the same program, so the recovered stream is
        token for token a crash-free run's.  Nothing is read from the crashed
        box: the restored tensors come from the checkpoint files alone."""
        if self.checkpointer is None:
            raise RuntimeError("crash recovery requires an EdgeFleet checkpoint_dir")
        src = self.locate(client_id)
        dst = self._target(src, to, "recovery", client_id)
        sess = src.edge.sessions[client_id]
        cl = sess.client
        if cl.split_plan is not None:
            raise NotImplementedError(
                "crash recovery replays through the whole-program binding; "
                "split-plan sessions are not supported yet"
            )
        ckpt = self.checkpointer.load_latest(client_id)
        if ckpt is None:
            raise RuntimeError(
                f"no checkpoint for {client_id!r}: its carried state died with "
                f"{src.name!r} before the first checkpoint boundary"
            )
        span = (
            self.tracer.begin("fleet", "crash_restore", self.clock.t, client=client_id,
                              src=src.name, dst=dst.name, seq=ckpt.seq)
            if self.tracer is not None else None
        )
        self.replicate_caches()
        src.edge.disconnect(client_id)
        dst.edge.adopt_session(sess)
        server = dst.edge.server
        server.context(client_id).env.update(
            {addr: v.to(server.device) for addr, v in ckpt.env.items()}
        )
        self.backhaul.bytes_total += ckpt.nbytes
        if cl.ios is not None:
            self._rebind(dst, client_id, cl)
            if ckpt.carried:
                server.import_carried_state(client_id, ckpt.carried)
        # re-drive the logged steps the checkpoint predates: the client
        # resends each step's logged wire inputs and the restored binding
        # advances the carried state as the dead box did
        replayed = 0
        for entry in list(cl.step_log or ()):
            if entry.seq < ckpt.seq or entry.seq >= cl.step_seq:
                continue
            payload = float(sum(_nbytes(a) for a in entry.wire_inputs)) / cl.input_wire_divisor
            cl._rpc(payload, 32)
            _, done_at = server.run_replay(entry.wire_inputs, self.clock.t, client_id,
                                           fresh_carried=entry.fresh_carried)
            cl._wait_until(done_at)
            replayed += 1
        self.stats.steps_replayed += replayed
        self.stats.crash_restores += 1
        cl.stats.crash_restores += 1
        self._rehome(client_id, src, dst, sess)
        if span is not None:
            self.tracer.annotate(span, bytes=ckpt.nbytes, steps_replayed=replayed)
            self.tracer.end(span, self.clock.t)
        return dst.name

    # -- open-loop serving on the event timeline -------------------------
    def serve(
        self,
        requests: Sequence[Tuple[float, str, Tuple[Any, ...]]],
        until: Optional[float] = None,
    ) -> List[FleetResult]:
        """Drive an open-loop request stream on the event timeline: each
        ``(arrival_t, client_id, inputs)`` dispatches at its absolute arrival,
        and a completion event fires at ``arrival + hedged latency``."""
        results: List[Optional[FleetResult]] = [None] * len(requests)

        def fire(k: int, cid: str, inputs: Tuple[Any, ...]) -> None:
            arrival = self.timeline.now
            res, latency, winner = self.clients[cid].dispatch(*inputs)

            def complete() -> None:
                results[k] = FleetResult(client_id=cid, outputs=res.outputs, arrival_t=arrival,
                                         done_at=arrival + latency, winner=winner)

            self.timeline.at(arrival + latency, complete)

        for k, (t, cid, inputs) in enumerate(requests):
            self.timeline.at(float(t), lambda k=k, cid=cid, inputs=inputs: fire(k, cid, inputs))
        self.timeline.run(until)
        return [r for r in results if r is not None]

    def summary(self) -> Dict[str, Any]:
        return dict(
            replicas=len(self.replicas),
            clients=len(self.clients),
            hedging=self.hedging,
            fleet=self.stats.as_dict(),
            router=self.router.stats.as_dict(),
            breakers=(
                {name: dict(state=b.state, opens=b.opens) for name, b in self.breakers.items()}
                if self.breakers is not None else None
            ),
            backhaul_bytes=self.backhaul.bytes_total,
            events_fired=self.timeline.fired,
            per_replica={rep.name: rep.edge.summary() for rep in self.replicas},
        )
