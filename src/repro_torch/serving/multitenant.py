"""Multi-tenant RRTO edge server — N concurrent clients over one GPU server.

Single-tenant RRTO (``core/offload.py``) gives one mobile client a private
simulated server.  An edge deployment is the opposite shape: one GPU box,
many clients, most of them running the *same* model.  This module composes
the shared pieces:

* :class:`RRTOEdgeServer` — the shared state: one
  :class:`~repro_torch.core.engine.OffloadServer` (kernel queue + GPU
  occupancy, one device-memory namespace per client), one
  :class:`~repro_torch.serving.replay_cache.ReplayCache` (fingerprint ->
  replay program), one :class:`~repro_torch.core.netsim.ServerIngress`
  (clients contend for server ingress bandwidth), one :class:`ReplayBatcher`
  and a shared :class:`~repro_torch.core.engine.SimClock`.  Per-client state
  (mode, log, energy meter) lives in each
  :class:`~repro_torch.core.offload.OffloadSession`.

* :class:`ReplayBatcher` — cross-client batched replay.  Replay submissions
  for the same IOS fingerprint in one round execute as one batched call on
  the shared GPU: the first submission flushes the round's preloaded group,
  pays the window wait plus one sub-linear batched execution
  (``ReplayProgram.batched_compute_seconds``), and every member completes at
  the group's finish time.  When the members share parameter *values* (one
  app binary on every device), the group executes as **one
  ``torch.func.vmap``-batched call** — a
  :class:`~repro_torch.core.engine.BatchedReplayProgram` cached per
  (fingerprint, padded width) in the shared cache — whose outputs are
  bitwise the per-client loop's; members with distinct parameters run the
  per-client loop under the same modeled batch timing.  Widths pad to the
  next power of two (padded lanes replay lane 0 and are discarded, and only
  the real lanes are billed), so a fingerprint needs O(log N) batched
  programs.  Split-mode clients (a ``partition`` config) batch their
  *server segments* instead: co-tenants whose plans share a (fingerprint,
  segment bounds) pair occupy the GPU once for the group
  (:meth:`ReplayBatcher.submit_segment`, wired as
  ``RRTOClient.split_submit``).  That is scheduling only: each client's
  segment walk computes its own values, and a split session never goes
  through the vmapped program.

Simulation contract: sessions share one clock, so ``run_round`` drives them
cooperatively — recording-phase clients serialize their RPC storms through
the shared server, and replay-phase clients batch.  Because a member's
outputs must be available inside its own ``infer()`` call, the harness
*preloads* each round's replay inputs into the batcher; the first submitter
executes the whole group, and later members collect their outputs.  A
member whose submission differs from its preload replays solo.

Overload protection (``RRTOEdgeServer(admission=...)``, an
:class:`~repro_torch.serving.admission.AdmissionController`): every request
is admitted, degraded or shed before it runs, each round's members are
ordered earliest-deadline-first, and with ``ReplayBatcher.round_capacity``
the batch slots are shared deficit-round-robin across tenants.

Observability: ``RRTOEdgeServer.metrics`` is the root (or fleet-scoped)
:class:`~repro_torch.obs.MetricsRegistry` behind every counter on the box:
``cache.*``, ``batcher.*`` and ``client.<id>.*``.  With a ``tracer`` the
box's GPU queue, ingress, batch rounds and clients emit on tracks under its
name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.costmodel import GTX_2080TI, DeviceSpec
from repro_torch.core.engine import (
    BATCH_MARGINAL_COST,
    MODE_REPLAYING,
    BatchedReplayProgram,
    OffloadServer,
    RRTOClient,
    SimClock,
    host_copy,
)
from repro_torch.core.netsim import FaultInjector, ServerIngress, get_network
from repro_torch.core.offload import InferenceResult, OffloadableModel, OffloadSession
from repro_torch.core.opseq import bits_equal
from repro_torch.device import resolve_device
from repro_torch.obs import MetricsRegistry, RegistryBackedStats, Tracer
from repro_torch.partition.segments import PLACE_SERVER
from repro_torch.serving.admission import AdmissionController, drr_select
from repro_torch.serving.replay_cache import ReplayCache

Members = List[Tuple[RRTOClient, List[torch.Tensor]]]
SegKey = Tuple[str, int, int]    # (fingerprint, segment start, segment end)


def _inputs_digest(ts: Sequence[torch.Tensor]) -> Tuple:
    """Cheap structural signature (shape and dtype per tensor): the claim
    compares every submission with its preload, so a mixed-shape co-tenant
    is rejected before any value compare."""
    return tuple((tuple(t.shape), str(t.dtype)) for t in ts)


def _inputs_equal(
    a: Sequence[torch.Tensor],
    b: Sequence[torch.Tensor],
    digest: Optional[Tuple] = None,
) -> bool:
    """Bitwise equality with a structural short-circuit.  ``digest`` is the
    bound replay's cached wire-input signature: when given, both sides are
    checked against it instead of building two signatures per round."""
    if len(a) != len(b):
        return False
    if digest is not None:
        if len(a) != len(digest):
            return False
        for x, y, (shape, dtype) in zip(a, b, digest):
            if (tuple(x.shape) != shape or tuple(y.shape) != shape
                    or str(x.dtype) != dtype or str(y.dtype) != dtype):
                return False
    elif _inputs_digest(a) != _inputs_digest(b):
        return False
    return all(bits_equal(x, y) for x, y in zip(a, b))


def _padded_width(n: int) -> int:
    """A batch width rounded up to the next power of two (min 2): groups of
    width 2..N share O(log N) batched programs instead of one per width;
    padded lanes replay lane 0 and are discarded."""
    return max(2, 1 << (int(n) - 1).bit_length())


@dataclasses.dataclass
class _BatchGroup:
    done_at: float                   # batched execution completion time
    # client_id -> preloaded wire inputs.  Values execute lazily at submit
    # time, so a member that never submits (a DAM fallback mid-walk) leaves
    # no writes in its device-memory namespace
    pending: Dict[str, List[torch.Tensor]]
    # vmap results per member (None: the per-client loop); installed into a
    # member's namespace only at claim time, so an unclaimed member's env and
    # carried state stay untouched
    outs: Optional[Dict[str, List[torch.Tensor]]] = None
    carried: Optional[Dict[str, List[torch.Tensor]]] = None
    # the group's shared wire-input digest (one program for every member)
    digest: Optional[Tuple] = None

    def claim(self, client_id: str, inputs: Sequence[torch.Tensor]) -> bool:
        preloaded = self.pending.pop(client_id, None)
        return preloaded is not None and _inputs_equal(preloaded, inputs, digest=self.digest)


@dataclasses.dataclass
class _SegmentGroup:
    done_at: float                   # the batched occupancy's completion
    remaining: set                   # members that have not claimed yet
    width: int


class BatcherStats(RegistryBackedStats):
    """Batch-formation counters, registry-backed (one fleet snapshot reports
    every replica's batching).  ``batch_sizes`` aliases the ``batch_width``
    histogram's values, so width percentiles show in
    ``MetricsRegistry.snapshot()`` while ``.append`` keeps working."""

    _fields = (
        ("batches_executed", 0),
        ("batched_replays", 0),      # submissions served from a batch
        ("solo_replays", 0),         # submissions that fell back to solo
        ("vmap_batches", 0),         # groups executed as one vmap call
        ("vmap_compiles", 0),        # batched programs built (not cached)
        ("vmap_compiles_avoided", 0),  # widths served by a padded program
        ("vmap_padded_lanes", 0),    # masked lanes executed across batches
        ("digest_cache_hits", 0),
        ("seg_batches", 0),          # co-tenant server segments run as one occupancy
        ("seg_batched", 0),          # segment submissions served from such a group
        ("seg_solo", 0),             # segment submissions that ran alone
    )

    @property
    def batch_sizes(self) -> List[int]:
        return self.registry.histogram("batch_width").values


class ReplayBatcher:
    """Groups same-fingerprint replay submissions into batched executions.

    Its counters live in ``stats`` (a :class:`BatcherStats` in the
    ``metrics`` scope) and read and write as attributes of the batcher too:
    ``batches_executed``, ``batched_replays``, ``solo_replays``,
    ``vmap_batches`` (groups executed as one vmap call), ``seg_batches``
    (co-tenant server segments run as one occupancy), ``seg_batched`` and
    ``seg_solo`` (segment submissions served from such a group, or alone),
    ``vmap_compiles`` (batched programs built, not taken from the cache),
    ``vmap_compiles_avoided`` (widths served by a padded program built for
    another width), ``vmap_padded_lanes`` and ``digest_cache_hits``;
    ``batch_sizes`` lists every group's width.  With a ``tracer`` every
    formed group is a ``batch_round`` span on ``<track>/batcher``.

    ``admission`` (bound by :class:`RRTOEdgeServer`) supplies the SLO
    priority and weight behind EDF ordering and DRR slot selection;
    ``round_capacity`` caps the batch slots per fingerprint and round (only
    with a controller attached).  Without either, a round forms in
    submission order."""

    def __init__(
        self,
        server: OffloadServer,
        *,
        window_s: float = 2e-3,
        tracer: Optional[Tracer] = None,
        track: str = "edge",
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.server = server
        self.window_s = window_s
        self.tracer = tracer
        self.track = track
        # False forces the per-client loop even for shared-param groups, so
        # the vmap path can be diffed bitwise against it
        self.enable_vmap = True
        self._pending: Dict[str, Members] = {}
        self._groups: Dict[str, _BatchGroup] = {}
        self._seg_pending: Dict[SegKey, List[str]] = {}
        self._seg_groups: Dict[SegKey, _SegmentGroup] = {}
        # client id -> (bound replay, wire-input digest): the signature is a
        # program property, computed once per binding
        self._digest_cache: Dict[str, Tuple[Any, Tuple]] = {}
        # padded vmap keys -> raw widths they served
        self._vmap_widths_served: Dict[str, set] = {}
        # cache claims held for the current round
        self._round_claims: List[str] = []
        self.depth_gauge = metrics.gauge("pending_depth") if metrics is not None else None
        # the counter attributes (``batcher.vmap_batches`` and the rest)
        # delegate to this object: see the properties below the class
        self.stats = BatcherStats(registry=metrics)
        self.admission: Optional[AdmissionController] = None
        # max batch slots per round and fingerprint; None = unbounded.  The
        # DRR deficits persist across rounds, so a tenant short-changed in
        # one round is made whole in the next
        self.round_capacity: Optional[int] = None
        self._drr_deficits: Dict[str, float] = {}

    def begin_round(
        self,
        entries: Dict[str, Members],
        seg_entries: Optional[Dict[SegKey, List[str]]] = None,
    ) -> None:
        """Preload one driving round: for each fingerprint, the replay-phase
        clients that will submit this round and their wire inputs; for each
        (fingerprint, server segment), the split-mode clients whose plans run
        that segment on the GPU this round.  Each fingerprint's members are
        ordered by :meth:`_order_members`; a member it drops keeps no
        preload and replays solo."""
        self.end_round()
        self._pending = {fp: self._order_members(list(members)) for fp, members in entries.items()}
        self._groups = {}
        self._seg_pending = {k: list(v) for k, v in (seg_entries or {}).items()}
        self._seg_groups = {}
        cache = self.server.replay_cache
        if cache is not None:
            # pin the bases behind this round's segment groups for its
            # duration; end_round releases the claims
            for fp, _, _ in self._seg_pending:
                cache.claim(f"{fp}|seg")
                self._round_claims.append(f"{fp}|seg")

    def end_round(self) -> None:
        """Release the current round's cache claims: the bases behind its
        batched programs are fair eviction game again.  Idempotent."""
        cache = self.server.replay_cache
        if cache is not None:
            for key in self._round_claims:
                cache.release(key)
        self._round_claims = []

    def _order_members(self, members: Members) -> Members:
        """EDF-order one fingerprint's round members (deadline, then SLO
        priority, then arrival order), then DRR-select down to
        ``round_capacity`` slots across tenants.  With no controller and no
        deadline it returns the very list it was given."""
        adm = self.admission
        if adm is None and not any(cl.deadline_t is not None for cl, _ in members):
            return members
        if len(members) > 1:
            def edf_key(item):
                idx, (cl, _) = item
                deadline = cl.deadline_t if cl.deadline_t is not None else float("inf")
                prio = adm.slo(cl.tenant).priority if adm is not None else 0
                return (deadline, -prio, idx)

            members = [m for _, m in sorted(enumerate(members), key=edf_key)]
        if adm is not None and self.round_capacity is not None and len(members) > self.round_capacity:
            members = drr_select(
                members, self.round_capacity, lambda m: m[0].tenant,
                lambda tenant: adm.slo(tenant).weight, self._drr_deficits,
            )
        return members

    @property
    def pending_depth(self) -> int:
        """Preloaded-but-unclaimed submissions in the current round."""
        return (
            sum(len(m) for m in self._pending.values())
            + sum(len(g.pending) for g in self._groups.values())
            + sum(len(m) for m in self._seg_pending.values())
        )

    def sample_depth(self, now: Optional[float] = None) -> int:
        """Sample the pending-round depth onto the gauge (and, with an
        admission controller attached, onto the trace as a counter)."""
        depth = self.pending_depth
        if self.depth_gauge is not None:
            self.depth_gauge.set(depth)
        if self.tracer is not None and now is not None and self.admission is not None:
            self.tracer.counter(f"{self.track}/batcher", "pending_depth", now, float(depth))
        return depth

    def _wire_digest(self, client_id: str) -> Optional[Tuple]:
        """The cached wire-input digest of one client's bound replay
        (recomputed only when the binding changes)."""
        bound = self.server.context(client_id).replay
        if bound is None:
            return None
        ent = self._digest_cache.get(client_id)
        if ent is not None and ent[0] is bound:
            self.digest_cache_hits += 1
            return ent[1]
        avals = bound.program.wire_in_avals
        if any(a is None for a in avals):
            return None  # the recorded payload was trimmed: compare per round
        digest = tuple((tuple(shape), str(dtype)) for shape, dtype in avals)
        self._digest_cache[client_id] = (bound, digest)
        return digest

    def make_submit(self, client: RRTOClient):
        """A bound submit hook for ``RRTOClient.replay_submit``."""

        def submit(inputs: List[torch.Tensor], t: float, fresh_carried=None):
            return self.submit(client, inputs, t, fresh_carried=fresh_carried)

        return submit

    def make_split_submit(self, client: RRTOClient):
        """A bound server-segment hook for ``RRTOClient.split_submit``."""

        def submit(seg, solo_seconds: float, start: float) -> float:
            return self.submit_segment(client, seg, solo_seconds, start)

        return submit

    def submit_segment(self, client: RRTOClient, seg, solo_seconds: float, start: float) -> float:
        """One split-mode client's server segment reaching the GPU; returns
        its completion time.

        Co-tenants whose plans share this (fingerprint, segment bounds) key —
        even when their device-side cuts differ — run the segment as one
        batched GPU occupancy: the first submitter reserves the sub-linear
        batched slot for the whole preloaded group and every member completes
        at the group's finish.  The values stay per client (each client's
        segment walk already computed its own); the batch is a shared-GPU
        scheduling effect, modeled as ``batched_compute_seconds`` is."""
        cid = client.client_id
        key = (client.ios_fp, seg.start, seg.end) if client.ios_fp is not None else None
        group = self._seg_groups.get(key) if key is not None else None
        if group is None and key is not None:
            members = self._seg_pending.pop(key, None)
            if members and cid in members:
                width = len(members)
                compute = solo_seconds * (1.0 + BATCH_MARGINAL_COST * (width - 1))
                begin = start + (self.window_s if width > 1 else 0.0)
                group = _SegmentGroup(
                    done_at=self.server.occupy(compute, begin), remaining=set(members),
                    width=width,
                )
                self._seg_groups[key] = group
                if width > 1:
                    self.seg_batches += 1
                if self.tracer is not None:
                    self.tracer.span(f"{self.track}/batcher", "batch_round", begin, group.done_at,
                                     fp=client.ios_fp, width=width,
                                     segment=f"{seg.start}:{seg.end}")
        if group is not None and cid in group.remaining:
            group.remaining.discard(cid)
            if group.width > 1:
                self.seg_batched += 1
            else:
                self.seg_solo += 1
            return max(group.done_at, start)
        # not preloaded (or already claimed): a plain solo occupancy
        self.seg_solo += 1
        return self.server.occupy(solo_seconds, start)

    def submit(
        self,
        client: RRTOClient,
        inputs: List[torch.Tensor],
        t: float,
        *,
        fresh_carried: Optional[Dict[int, torch.Tensor]] = None,
    ) -> Tuple[List[torch.Tensor], float]:
        cid = client.client_id
        if fresh_carried:
            # the member overrides its server-resident state; the preloaded
            # batch ran without the override, so this round executes solo
            self.solo_replays += 1
            return self.server.run_replay(inputs, t, cid, fresh_carried=fresh_carried)
        fp = client.ios_fp
        group = self._groups.get(fp) if fp is not None else None
        if group is None:
            group = self._execute_group(fp, t)
        if group is None or not group.claim(cid, inputs):
            # nothing preloaded for this fingerprint, or the submission is not
            # what was preloaded: a plain solo replay
            self.solo_replays += 1
            return self.server.run_replay(inputs, t, cid)
        # Preloaded members are concurrent by construction; the serialized
        # shared-clock driving means a later member's submit time can already
        # exceed the group's finish, in which case its wait is zero.
        if group.outs is not None:
            outs = group.outs[cid]
            carried = group.carried.get(cid) if group.carried is not None else None
            self.server.adopt_replay_results(cid, inputs, outs, carried)
            outs = [host_copy(o) for o in outs]
        else:
            outs = self.server.replay_values(inputs, cid)
        self.batched_replays += 1
        return outs, max(group.done_at, t)

    # ------------------------------------------------------------------
    def _shared_params(self, members: Members) -> Optional[List[torch.Tensor]]:
        """The members' shared parameter tensors, or None when any differ:
        identity first (co-tenants of one app binary share the tensors),
        bitwise equality as the slow path."""
        first = self.server.context(members[0][0].client_id)
        params = [first.env[a] for a in first.replay.param_addrs]
        for cl, _ in members[1:]:
            ctx = self.server.context(cl.client_id)
            bound = ctx.replay
            if bound is None or bound.program is not first.replay.program:
                return None
            for mine, a in zip(params, bound.param_addrs):
                other = ctx.env[a]
                if mine is not other and not bits_equal(mine, other):
                    return None
        return params

    def _run_vmap_batch(
        self, fp: str, members: Members, params_flat: List[torch.Tensor]
    ) -> Optional[_BatchGroup]:
        """Execute the whole group as one vmap-batched call; returns each
        member's outputs (and carried state) keyed by client id."""
        program = self.server.context(members[0][0].client_id).replay.program
        if not members[0][1] and not program.is_stateful:
            return None  # no mapped axis to batch over
        width = len(members)
        # every bail-out comes BEFORE the padding and build counters: an
        # aborted batch falls back to the per-client loop, where no padded
        # lane executes and no width was served
        states: List[List[torch.Tensor]] = []
        if program.is_stateful:
            for cl, _ in members:
                st = self.server.context(cl.client_id).replay.carried_state
                if st is None:
                    return None
                states.append(st)
        padded = _padded_width(width)
        pad = padded - width
        key = f"{fp}#vmap{padded}"
        cache = self.server.replay_cache
        batched: Optional[BatchedReplayProgram] = cache.get(key) if cache is not None else None
        if cache is not None:
            # the round executes this derived entry now: its base must not be
            # evicted (purging the batched program with it) mid-round
            cache.claim(key)
            self._round_claims.append(key)
        built_now = batched is None or batched.base is not program
        if built_now:
            batched = program.build_batched(padded)
            self.vmap_compiles += 1
            if cache is not None:
                cache.put(key, batched)
        served = self._vmap_widths_served.setdefault(key, set())
        if not built_now and width not in served:
            # an exact-width scheme would have built a program for this width
            self.vmap_compiles_avoided += 1
        served.add(width)
        self.vmap_padded_lanes += pad
        dev = self.server.device
        stacked_inputs = [
            torch.stack([m[1][k] for m in members] + [members[0][1][k]] * pad).to(dev)
            for k in range(len(members[0][1]))
        ]
        ids = [cl.client_id for cl, _ in members]
        if program.is_stateful:
            stacked_state = [
                torch.stack([st[k] for st in states] + [states[0][k]] * pad)
                for k in range(len(states[0]))
            ]
            wire_outs, new_carried = batched.fn(params_flat, stacked_inputs, stacked_state)
            outs = {cid: [o[b] for o in wire_outs] for b, cid in enumerate(ids)}
            carried = {cid: [c[b] for c in new_carried] for b, cid in enumerate(ids)}
            return _BatchGroup(0.0, {}, outs=outs, carried=carried)
        raw = batched.fn(params_flat, stacked_inputs)
        outs = {cid: [o[b] for o in raw] for b, cid in enumerate(ids)}
        return _BatchGroup(0.0, {}, outs=outs)

    def _execute_group(self, fp: Optional[str], t: float) -> Optional[_BatchGroup]:
        members = self._pending.pop(fp, None) if fp is not None else None
        if not members:
            return None
        first = members[0][0]
        program = self.server.context(first.client_id).replay.program
        # the batch slot count is the admitted membership; a member that ends
        # up falling back mid-walk still occupied its scheduled slot
        batch = len(members)
        group: Optional[_BatchGroup] = None
        if batch > 1 and self.server.execute and self.enable_vmap:
            params_flat = self._shared_params(members)
            if params_flat is not None:
                group = self._run_vmap_batch(fp, members, params_flat)
                if group is not None:
                    self.vmap_batches += 1
        if group is None:
            group = _BatchGroup(done_at=0.0, pending={})
        compute = program.batched_compute_seconds(self.server.device_spec, batch)
        # a lone submitter flushes at once; a real group waits out the
        # batching window for its co-tenants before the one execution
        start = t + (self.window_s if batch > 1 else 0.0)
        group.done_at = self.server.occupy(compute, start)
        group.pending = {cl.client_id: wire for cl, wire in members}
        group.digest = self._wire_digest(first.client_id)
        self._groups[fp] = group
        self.batches_executed += 1
        self.batch_sizes.append(batch)
        if self.tracer is not None:
            self.tracer.span(f"{self.track}/batcher", "batch_round", start, group.done_at,
                             fp=fp, width=batch, vmap=group.outs is not None)
        return group


def _delegate_stat(name: str) -> property:
    return property(
        lambda self: getattr(self.stats, name),
        lambda self, v: setattr(self.stats, name, v),
    )


# the batcher's counter attributes read and write the registry-backed stats
for _stat_name, _ in BatcherStats._fields:
    setattr(ReplayBatcher, _stat_name, _delegate_stat(_stat_name))
ReplayBatcher.batch_sizes = property(lambda self: self.stats.batch_sizes)


class RRTOEdgeServer:
    """Shared edge-server state + the cooperative multi-client round loop.

    ``ingress`` is this box's shared pipe (one of
    :func:`~repro_torch.core.netsim.multi_node_ingress`'s in a fleet); with
    ``fault`` the injector reaches the ingress and every session on the box;
    with ``admission`` (an
    :class:`~repro_torch.serving.admission.AdmissionController`) the
    controller guards every session on the box and orders its rounds;
    ``name`` labels the box in a fleet and its tracks.  ``metrics`` is the
    registry every counter on the box lives in (a fresh root by default),
    with the scopes ``cache``, ``batcher`` and ``client.<id>``; ``tracer``
    reaches the server, the ingress, the batcher, every session and an
    admission controller that has none.  ``verify`` runs the replay
    soundness verifier in the server and, unless a ``connect`` says
    otherwise, in every session's client."""

    def __init__(
        self,
        *,
        server_device: DeviceSpec = GTX_2080TI,
        execute: bool = True,
        cache_capacity: int = 8,
        batch_window_s: float = 2e-3,
        environment: str = "indoor",
        ingress: Optional[ServerIngress] = None,
        clock: Optional[SimClock] = None,
        name: str = "edge",
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        fault: Optional[FaultInjector] = None,
        admission: Optional[AdmissionController] = None,
        device: Any = "cuda",
        verify: bool = False,
    ):
        self.clock = clock or SimClock()
        self.name = name
        self.tracer = tracer
        self.fault = fault
        self.verify = verify
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.cache = ReplayCache(cache_capacity, metrics=self.metrics.scope("cache"))
        self.server = OffloadServer(
            server_device, device=resolve_device(device), execute=execute,
            replay_cache=self.cache, name=name, tracer=tracer, verify=verify,
        )
        self.ingress = ingress or ServerIngress()
        if tracer is not None:
            self.ingress.tracer = tracer
            self.ingress.track = f"{name}/ingress"
        if fault is not None:
            self.ingress.fault = fault
        self.batcher = ReplayBatcher(self.server, window_s=batch_window_s, tracer=tracer,
                                     track=name, metrics=self.metrics.scope("batcher"))
        # None (the default) leaves every path bitwise what it is without an
        # admission layer
        self.admission = admission
        if admission is not None:
            admission.bind(server=self.server, ingress=self.ingress)
            if admission.tracer is None:
                admission.tracer = tracer
            self.batcher.admission = admission
        self.environment = environment
        self.sessions: Dict[str, OffloadSession] = {}
        # sessions moved onto / off this box
        self.sessions_adopted = 0
        self.sessions_migrated_out = 0

    def connect(
        self,
        model: OffloadableModel,
        *,
        client_id: Optional[str] = None,
        seed: Optional[int] = None,
        min_repeats: int = 3,
        environment: Optional[str] = None,
        tenant: str = "default",
        **session_kwargs: Any,
    ) -> OffloadSession:
        """Attach one mobile client running ``model`` to this edge server.

        Each client gets its own wireless link (seeded per client) tied to
        the shared server ingress, its own energy meter, and a server-side
        device-memory namespace keyed by ``client_id``.  ``environment``
        overrides the server default per client; ``tenant`` names the SLO
        class the client bills against on this box's admission controller."""
        cid = client_id if client_id is not None else f"c{len(self.sessions)}"
        if cid in self.sessions:
            raise ValueError(f"client id {cid!r} already connected")
        network = get_network(
            environment if environment is not None else self.environment,
            seed if seed is not None else len(self.sessions),
        )
        network.ingress = self.ingress
        if self.fault is not None:
            session_kwargs.setdefault("fault", self.fault)
        if self.admission is not None:
            session_kwargs.setdefault("admission", self.admission)
        session_kwargs.setdefault("tenant", tenant)
        session_kwargs.setdefault("verify", self.verify)
        sess = OffloadSession(
            model,
            "rrto",
            network=network,
            server=self.server,
            clock=self.clock,
            client_id=cid,
            min_repeats=min_repeats,
            tracer=self.tracer,
            trace_track=f"{self.name}/client/{cid}",
            metrics=self.metrics.scope(f"client.{cid}"),
            **session_kwargs,
        )
        sess.client.replay_submit = self.batcher.make_submit(sess.client)
        sess.client.split_submit = self.batcher.make_split_submit(sess.client)
        self.sessions[cid] = sess
        self.ingress.active_clients = len(self.sessions)
        return sess

    # ------------------------------------------------------------------
    def run_round(self, inputs_by_client: Dict[str, Tuple[Any, ...]]) -> Dict[str, InferenceResult]:
        """Drive one inference per listed client, batching replays.

        Replay-phase clients' wire inputs are preloaded into the batcher so
        same-fingerprint submissions execute as one batched call;
        recording-phase clients run their per-operator RPC storms serialized
        through the shared server and ingress.  Split-plan clients run their
        own segment walks, and their server segments batch by (fingerprint,
        segment bounds).  With an admission controller each member's
        deadline is stamped first, so the batcher's EDF order sees it."""
        self.ingress.active_clients = len(inputs_by_client)
        if self.admission is not None:
            for cid in inputs_by_client:
                self.sessions[cid].client.deadline_t = self.admission.deadline_for(
                    cid, self.clock.t
                )
        entries: Dict[str, Members] = {}
        seg_entries: Dict[SegKey, List[str]] = {}
        for cid, inputs in inputs_by_client.items():
            sess = self.sessions[cid]
            cl = sess.client
            if cl.mode != MODE_REPLAYING or cl.ios_fp is None:
                continue
            if cl.split_plan is None:
                entries.setdefault(cl.ios_fp, []).append((cl, sess.replay_wire_inputs(inputs)))
                continue
            for seg in cl.split_plan.segments:
                if seg.placement == PLACE_SERVER:
                    seg_entries.setdefault((cl.ios_fp, seg.start, seg.end), []).append(cid)
        self.batcher.begin_round(entries, seg_entries)
        self.batcher.sample_depth(self.clock.t)
        if self.admission is not None:
            # refresh the ingress's queue depth on the simulated clock
            self.admission.queue_depth(self.clock.t)
        try:
            return {
                cid: self.sessions[cid].infer(*inputs)
                for cid, inputs in inputs_by_client.items()
            }
        finally:
            # the round is over: its claims must not pin the bases through
            # every idle gap
            self.batcher.end_round()

    # ------------------------------------------------------------------
    def adopt_session(self, sess: OffloadSession) -> None:
        """Attach an existing session moved from another edge server.

        The client re-associates with this box (the server handle, the
        batcher's submit hook and the ingress move); client-side state
        (mode, locked IOS, recorded calls, energy meter) rides along.  The
        server-side context (device memory, bound replay, carried state) does
        NOT move here: a migration transfers it explicitly.  Both edges must
        share one ``SimClock``."""
        cid = sess.client_id
        if cid in self.sessions:
            raise ValueError(f"client id {cid!r} already connected")
        if sess.clock is not self.clock:
            raise ValueError("session migration requires edge servers sharing one SimClock")
        if sess.execute != self.server.execute:
            raise ValueError(
                f"session execute={sess.execute} conflicts with this "
                f"server's execute={self.server.execute}"
            )
        sess.server = self.server
        sess.client.server = self.server
        sess.network.ingress = self.ingress
        if self.fault is not None:
            sess.network.fault = self.fault
        sess.client.replay_submit = self.batcher.make_submit(sess.client)
        sess.client.split_submit = self.batcher.make_split_submit(sess.client)
        self.sessions[cid] = sess
        self.ingress.active_clients = len(self.sessions)
        self.sessions_adopted += 1

    def disconnect(self, client_id: str) -> OffloadSession:
        """Detach one client (the source half of a migration).  The
        server-side context stays in place for the state transfer."""
        sess = self.sessions.pop(client_id)
        self.ingress.active_clients = max(1, len(self.sessions))
        self.sessions_migrated_out += 1
        return sess

    # ------------------------------------------------------------------
    def save_cache(self, path: str) -> int:
        """Persist validated IOS fingerprints across server restarts."""
        return self.cache.save(path)

    def load_cache(self, path: str) -> int:
        """Adopt a previous incarnation's validated fingerprints: joining
        clients skip the ``min_repeats`` recording wait at once."""
        return self.cache.load(path)

    # ------------------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Replay programs actually built (cache misses), not bindings."""
        return self.server.compile_count

    def recording_rpc_total(self) -> int:
        """Total RPCs issued by clients while in the recording phase."""
        return sum(
            r.rpcs for sess in self.sessions.values() for r in sess.history
            if r.mode == "recording"
        )

    def summary(self) -> Dict[str, Any]:
        b = self.batcher
        return dict(
            clients=len(self.sessions),
            sessions_adopted=self.sessions_adopted,
            sessions_migrated_out=self.sessions_migrated_out,
            cache=self.cache.stats.as_dict(),
            cached_programs=len(self.cache),
            compiles=self.compile_count,
            batches=b.batches_executed,
            batched_replays=b.batched_replays,
            solo_replays=b.solo_replays,
            vmap_batches=b.vmap_batches,
            vmap_compiles=b.vmap_compiles,
            vmap_compiles_avoided=b.vmap_compiles_avoided,
            vmap_padded_lanes=b.vmap_padded_lanes,
            digest_cache_hits=b.digest_cache_hits,
            seg_batches=b.seg_batches,
            seg_batched=b.seg_batched,
            seg_solo=b.seg_solo,
            mean_batch=sum(b.batch_sizes) / len(b.batch_sizes) if b.batch_sizes else 0.0,
            link_bytes=self.ingress.bytes_total,  # both directions
            gpu_busy_seconds=self.server.busy_seconds,
            queue_depth=self.ingress.queue_depth,
            pending_depth=b.pending_depth,
            admission=self.admission.stats.as_dict() if self.admission is not None else None,
        )
