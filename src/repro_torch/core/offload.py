"""End-to-end offload sessions — the five systems the paper compares.

    device_only   run the model on the device (no offloading)
    nnto          native non-transparent offloading (model lives on the
                  server; app ships input, receives output — code modified)
    cricket       traditional transparent offloading: one RPC per call
    semi_rrto     cricket + client-side caching of device-query RPCs (Fig. 11)
    rrto          full record/replay with Operator Sequence Search

Every system runs the *same* model function; transparent systems execute it
through the graph interceptor (the app is unmodified — interception happens
below it), non-transparent systems call it directly and eagerly (the "code
modification").  Latency and energy come from the simulated clock, network
and power models; the *computed values* are real executions on ``device``
and must agree across systems.

With a :class:`~repro_torch.core.netsim.FaultInjector` a transparent session
also rides out link faults: lost messages are retried, and an inference that
starts inside a declared outage window waits it out (stateful replay), adopts
the all-device split plan (split replay), or runs on the device.

With an :class:`~repro_torch.serving.admission.AdmissionController` every
request of a transparent session is admitted, degraded or shed first (the
overload ladder): a split session re-cuts device-heavy, a stateless one runs
on the device when its deadline budget covers that, and anything else
raises :class:`~repro_torch.serving.admission.AdmissionRejectedError`.

With a :class:`~repro_torch.obs.Tracer` (``tracer=``) a transparent session
emits its client's spans on ``trace_track`` and the outage path's events
(``outage_declared``, ``outage_wait``, ``outage_fallback``, ``link_healed``)
there too, on the simulated clock; ``metrics=`` is the registry scope of the
client's counters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.costmodel import GTX_2080TI, JETSON_XAVIER_NX
from repro_torch.core.energy import (
    STATE_COMM,
    STATE_CONTROL,
    STATE_INFERENCE,
    STATE_STANDBY,
    EnergyMeter,
    PowerModel,
)
from repro_torch.core.engine import (
    DEFAULT_CLIENT,
    MODE_REPLAYING,
    REPLAY_FUSION_FACTOR,
    REPLAY_KERNELS_PER_FUSION,
    OffloadServer,
    RRTOClient,
    SimClock,
    host_copy,
)
from repro_torch.core.flatten import FlatGraph, graph_cost, trace_app
from repro_torch.core.intercept import FrameworkNoiseModel, GraphInterceptor
from repro_torch.core.netsim import FaultInjector, NetworkModel, RetryPolicy, get_network
from repro_torch.device import resolve_device, to_host
from repro_torch.obs import MetricsRegistry, Tracer

SYSTEMS = ("device_only", "nnto", "cricket", "semi_rrto", "rrto")

# client-side application logic per inference (pre/post-processing)
CLIENT_CONTROL_S = 0.5e-3


@dataclasses.dataclass
class OffloadableModel:
    """A model as the offloading layer sees it: an apply function, its
    parameters (a nested dict of tensors on the session's device), example
    inputs (host values: CPU tensors or numpy arrays), and an optional
    one-time setup graph (initialization inference variability, e.g. KAPAO's
    mesh-grid generation) whose outputs every later inference reads."""

    name: str
    apply: Callable[..., Sequence[torch.Tensor]]   # apply(params, [aux,] *inputs)
    params: Any
    example_inputs: Tuple[Any, ...]
    setup: Optional[Callable[..., Any]] = None      # setup(params, *inputs) -> aux
    # wire-format divisor for inference inputs (e.g. ~10x JPEG for camera
    # frames); parameters always travel raw
    input_wire_divisor: float = 1.0


@dataclasses.dataclass
class TracedModel:
    """A model traced the way a session runs it.  With a setup graph, the
    steady graph's invars are the setup outputs' leaves (``aux_leaves``,
    computed eagerly once from the example inputs) followed by the inputs;
    ``flat_apply(param_leaves, *aux_leaves, *inputs)`` runs it eagerly."""

    param_leaves: List[torch.Tensor]
    flat_apply: Callable[..., Sequence[torch.Tensor]]
    aux_leaves: List[torch.Tensor]
    setup_graph: Optional[FlatGraph]
    graph: FlatGraph

    @property
    def n_kernel_records(self) -> int:
        """Kernel launches one steady inference records (DtoD copies are
        not kernels)."""
        return sum(1 for n in self.graph.nodes if not n.is_d2d)


def trace_model(model: OffloadableModel, device: torch.device) -> TracedModel:
    """Trace ``model`` (fake tensors: shapes only) on ``device``."""
    leaves, spec = torch.utils._pytree.tree_flatten(model.params)
    example = [to_host(x).to(device) for x in model.example_inputs]

    def unflatten(ls):
        return torch.utils._pytree.tree_unflatten(list(ls), spec)

    if model.setup is None:
        aux_leaves, setup_graph = [], None

        def flat_apply(ls, *inputs):
            return model.apply(unflatten(ls), *inputs)
    else:
        def flat_setup(ls, *inputs):
            return torch.utils._pytree.tree_leaves(model.setup(unflatten(ls), *inputs))

        with torch.no_grad():
            aux_leaves, aux_spec = torch.utils._pytree.tree_flatten(
                model.setup(model.params, *example)
            )
        n_aux = len(aux_leaves)

        def flat_apply(ls, *args):
            aux = torch.utils._pytree.tree_unflatten(list(args[:n_aux]), aux_spec)
            return model.apply(unflatten(ls), aux, *args[n_aux:])

        setup_graph = trace_app(flat_setup, leaves, example)
    graph = trace_app(flat_apply, leaves, [*aux_leaves, *example])
    return TracedModel(leaves, flat_apply, aux_leaves, setup_graph, graph)


@dataclasses.dataclass
class InferenceResult:
    outputs: List[torch.Tensor]      # host (CPU) tensors
    wall_seconds: float
    joules: float
    rpcs: int
    network_bytes: float
    server_busy_seconds: float
    mode: str


@dataclasses.dataclass
class StreamResult:
    """One inference of an open-loop stream (see ``infer_stream``)."""

    outputs: List[torch.Tensor]
    arrival_t: float          # absolute simulated arrival time
    done_at: float            # absolute in-order completion time

    @property
    def latency_seconds(self) -> float:
        return self.done_at - self.arrival_t


class OffloadSession:
    """One application process using one offloading system.

    By default the session is single-tenant: it owns its clock and its
    server.  Pass a shared ``server`` (and usually a shared ``clock``) and a
    unique ``client_id`` to multiplex several sessions over one edge server:
    per-client state (mode, log, energy meter, device-memory namespace)
    stays separate while the kernel queue, replay cache and GPU occupancy
    are shared (see ``repro_torch.serving.multitenant``).  ``partition`` (a
    :class:`~repro_torch.partition.PartitionConfig`, rrto only) splits the
    replayed IOS between the device and the server.  ``fault`` and
    ``retry_policy`` (transparent systems only) inject link faults and set
    the client's retry discipline.  ``admission`` (an
    :class:`~repro_torch.serving.admission.AdmissionController`, transparent
    systems only) guards every request; ``tenant`` names the SLO class the
    client bills against.  ``tracer``, ``trace_track`` and ``metrics``
    (transparent systems only) are the client's observability hooks.
    ``verify`` (rrto) runs the replay soundness verifier before every
    program the session's client and its own server build."""

    def __init__(
        self,
        model: OffloadableModel,
        system: str,
        *,
        environment: str = "indoor",
        network: Optional[NetworkModel] = None,
        noise: Optional[FrameworkNoiseModel] = None,
        min_repeats: int = 3,
        seed: int = 0,
        execute: Optional[bool] = None,
        server: Optional[OffloadServer] = None,
        clock: Optional[SimClock] = None,
        client_id: str = DEFAULT_CLIENT,
        device: Any = "cuda",
        partition: Optional[Any] = None,
        tracer: Optional[Tracer] = None,
        trace_track: Optional[str] = None,
        metrics: Optional[MetricsRegistry] = None,
        fault: Optional[FaultInjector] = None,
        retry_policy: Optional[RetryPolicy] = None,
        admission: Optional[Any] = None,
        tenant: str = "default",
        verify: bool = False,
    ):
        """``execute=False`` makes an account-only session: the clock,
        network, energy and record streams run as usual, nothing is
        computed, and every output is zeros of its shape and dtype.  A
        shared ``server`` decides both ``execute`` and the device."""
        if system not in SYSTEMS:
            raise ValueError(f"unknown system {system!r}; pick from {SYSTEMS}")
        if server is not None:
            # the realism level is a server property; a conflicting per-client
            # request would silently produce placeholder outputs
            if execute is not None and execute != server.execute:
                raise ValueError(
                    f"execute={execute} conflicts with the shared server's "
                    f"execute={server.execute}"
                )
            execute = server.execute
            self.device = server.device
        else:
            self.device = resolve_device(device)
        self.model = model
        self.system = system
        self.execute = True if execute is None else execute
        self.client_id = client_id
        # the paper's testbed, simulated: Jetson Xavier NX client, GTX 2080 Ti
        # server, indoor or outdoor Wi-Fi trace, Tab. II power draw
        self.network = network or get_network(environment, seed)
        self.client_device = JETSON_XAVIER_NX
        self.server_device = GTX_2080TI
        self.clock = clock or SimClock()
        self.meter = EnergyMeter(PowerModel())
        self.server = server or OffloadServer(
            GTX_2080TI, device=self.device, execute=self.execute, verify=verify
        )
        self.history: List[InferenceResult] = []
        self.stage_marks: Dict[str, int] = {}
        self._loaded = False
        # overload protection; None = no admission layer, every path below is
        # bitwise what it is without one
        self.admission = admission
        self.tenant = tenant
        self._device_fallback_s: Optional[float] = None

        # ---- trace the model once (fake tensors: shapes only); the setup
        # outputs are computed eagerly here, once
        traced = trace_model(model, self.device)
        self._param_leaves = traced.param_leaves
        self._flat_apply = traced.flat_apply
        self._aux_leaves = traced.aux_leaves
        self._setup_graph = traced.setup_graph
        self._graph = traced.graph
        self._steady_flops, self._steady_bytes = graph_cost(self._graph)
        self._n_kernels = len(self._graph.nodes)

        if system in ("cricket", "semi_rrto", "rrto"):
            variant = "transparent" if system == "cricket" else system
            self.client = RRTOClient(
                self.server,
                self.network,
                self.clock,
                self.meter,
                variant=variant,
                min_repeats=min_repeats,
                client_id=client_id,
                client_device=self.client_device,
                partition=partition if system == "rrto" else None,
                input_wire_divisor=model.input_wire_divisor,
                tracer=tracer,
                trace_track=trace_track,
                metrics=metrics,
                fault=fault,
                retry_policy=retry_policy,
                verify=verify,
            )
            self.interceptor = GraphInterceptor(
                self.client,
                noise or FrameworkNoiseModel(),
                input_wire_divisor=model.input_wire_divisor,
            )
            self.client.tenant = tenant
            if admission is not None:
                admission.register(client_id, tenant)
            if fault is not None:
                self.network.fault = fault
        else:
            self.client = None
            self.interceptor = None
        self._const_addrs: Dict[int, int] = {}   # id(traced constant) -> addr
        # setup-output leaf index -> device address, after the first inference
        self._aux_addrs: Optional[Dict[int, int]] = None

    # ------------------------------------------------------------------
    def _logs_so_far(self) -> int:
        return len(self.client.logs) if self.client else 0

    def load(self) -> None:
        """Model-load phase: parameters travel to where they execute."""
        if self._loaded:
            return
        if self.system == "device_only":
            # local disk -> device memory; negligible for the comparison
            self.meter.add(STATE_CONTROL, 0.1)
            self.clock.advance(0.1)
        elif self.system == "nnto":
            # the server hosts the model; nothing crosses the radio
            self.meter.add(STATE_CONTROL, 0.05)
            self.clock.advance(0.05)
        else:
            # upload every traced constant of the setup and steady graphs
            # (the parameters and any tensor the app builds from Python
            # data), deduplicated by identity (a tied weight is one tensor)
            index: Dict[int, int] = {}
            leaves: List[torch.Tensor] = []
            for graph in (self._setup_graph, self._graph):
                for c in graph.consts if graph is not None else ():
                    if id(c) not in index:
                        index[id(c)] = len(leaves)
                        leaves.append(c)
            addrs = self.interceptor.upload_params(leaves)
            self._const_addrs = {k: addrs[i] for k, i in index.items()}
        self.stage_marks["after_load"] = self._logs_so_far()
        self._loaded = True

    def _param_addrs_for(self, graph: FlatGraph) -> List[int]:
        return [self._const_addrs[id(c)] for c in graph.consts]

    def _uploads(self, inputs: Sequence[Any]) -> List[torch.Tensor]:
        """The HtoD payloads one steady inference of ``inputs`` makes, in
        order: the steady graph's invars that are not resident (the setup
        outputs are)."""
        values = [*self._aux_leaves, *(to_host(x) for x in inputs)]
        resident = self._aux_addrs or {}
        return [v for i, v in enumerate(values) if i not in resident]

    def replay_wire_inputs(self, inputs: Sequence[Any]) -> List[torch.Tensor]:
        """The HtoD payloads one replay-phase inference of ``inputs`` ships,
        in wire order: :meth:`_uploads` without the loop-carried ones
        (server-resident state).  The multi-tenant batcher preloads a round
        with them before the clients submit."""
        carried = self.client.carried_input_ordinals if self.client else frozenset()
        return [v for i, v in enumerate(self._uploads(inputs)) if i not in carried]

    def _run_intercepted(self, inputs: Sequence[torch.Tensor]) -> List[Any]:
        if self._setup_graph is not None and self._aux_addrs is None:
            # initialization inference: the setup graph runs first and its
            # outputs stay on the device for every later inference
            aux_addrs = self.interceptor.run(
                self._setup_graph,
                self._param_addrs_for(self._setup_graph),
                inputs,
                resident_outputs=True,
            )
            self._aux_addrs = dict(enumerate(aux_addrs))
        return self.interceptor.run(
            self._graph,
            self._param_addrs_for(self._graph),
            [*self._aux_leaves, *inputs],
            resident_inputs=self._aux_addrs,
        )

    def device_fallback_seconds(self) -> float:
        """Latency of one eager device-local inference: the degradation
        ladder's tier-2 cost (it must fit the tenant's deadline budget for a
        degraded response to be worth returning)."""
        if self._device_fallback_s is None:
            self._device_fallback_s = self.client_device.sequence_time(
                self._steady_flops,
                self._steady_bytes,
                num_kernels=self._n_kernels,
                fusion_factor=1.0,  # eager per-op dispatch on the device
            )
        return self._device_fallback_s

    def _admission_decision(self, deadline_s: Optional[float]):
        """Consult the admission controller for one arriving request and take
        the ladder's decision half: raise on a shed, install the
        device-heavy plan on tier 1, and return the decision and the
        request's absolute deadline (None, None without a controller)."""
        adm, cl = self.admission, self.client
        if adm is None or cl is None:
            return None, None
        t = self.clock.t
        decision = adm.decide(
            self.client_id,
            t,
            can_degrade_split=cl.mode == MODE_REPLAYING and cl.replanner is not None,
            can_degrade_device=not cl.stateful_replay,
            degraded_latency_s=self.device_fallback_seconds(),
        )
        if decision.action == "shed":
            raise adm.shed_error(self.client_id, decision)
        budget = (
            deadline_s if deadline_s is not None
            else adm.slo(adm.tenant_of(self.client_id)).deadline_s
        )
        deadline_t = t + budget
        cl.deadline_t = deadline_t
        if decision.action == "degrade_split":
            plan = cl.replanner.degrade(t)
            if plan is not None:
                cl._install_plan(plan)
        return decision, deadline_t

    def infer(self, *inputs, deadline_s: Optional[float] = None) -> InferenceResult:
        """One inference.  Inputs are host values (CPU tensors or numpy); a
        CPU tensor is passed through as the same object, so a handle the
        session handed out keeps its identity on the way back in.
        ``deadline_s`` overrides the tenant's SLO budget for this request
        (with an admission controller only)."""
        if not self._loaded:
            self.load()
        t0, e0 = self.clock.t, self.meter.snapshot()
        busy0 = self.server.busy_seconds
        rpcs0 = self.client.stats.rpcs if self.client else 0
        bytes0 = self.client.stats.network_bytes if self.client else 0.0
        inputs = tuple(to_host(x) for x in inputs)

        if self.system == "device_only":
            outputs = self._device_only(inputs)
            mode = "local"
        elif self.system == "nnto":
            outputs = self._nnto(inputs)
            mode = "offloaded"
        else:
            self.meter.add(STATE_CONTROL, CLIENT_CONTROL_S)
            self.clock.advance(CLIENT_CONTROL_S)
            cl = self.client
            decision, deadline_t = self._admission_decision(deadline_s)
            arrival_t = self.clock.t
            if decision is not None and decision.action == "degrade_device":
                # the device path is eager, op by op: bitwise the replay
                mode = "degraded_device"
                outputs = self._device_only(inputs)
            elif cl.fault is not None and cl.fault.in_outage(self.clock.t):
                mode, outputs = self._infer_during_outage(inputs)
            else:
                if cl.outage_active:
                    cl.outage_active = False
                    if cl.tracer is not None:
                        cl.tracer.instant(cl.trace_track, "link_healed", self.clock.t)
                mode = cl.mode
                outputs = self._run_intercepted(inputs)
                if decision is not None and decision.action == "degrade_split":
                    mode = "degraded_split"
            if decision is not None:
                if decision.action == "admit":
                    self.admission.note_admitted(arrival_t, self.clock.t)
                self.admission.note_completion(arrival_t, self.clock.t, deadline_t)
                cl.deadline_t = None
        if len(self.history) == 0:
            self.stage_marks["after_first_inference"] = self._logs_so_far()

        res = InferenceResult(
            outputs=outputs,
            wall_seconds=self.clock.t - t0,
            joules=self.meter.since(e0).joules,
            rpcs=(self.client.stats.rpcs - rpcs0) if self.client else 0,
            network_bytes=(
                (self.client.stats.network_bytes - bytes0) if self.client else 0.0
            ),
            server_busy_seconds=self.server.busy_seconds - busy0,
            mode=mode,
        )
        self.history.append(res)
        return res

    def infer_stream(
        self,
        inputs_seq: Sequence[Tuple[Any, ...]],
        *,
        arrivals: Optional[Any] = None,
        deadlines: Optional[Any] = None,
    ) -> List[StreamResult]:
        """Open-loop streaming inference: submit every element of
        ``inputs_seq`` at its arrival offset (seconds from now; default 0, a
        saturated back-to-back stream) without waiting for earlier
        completions.

        On a replay-locked split session with
        ``PartitionConfig(pipelined=True)``, submissions double-buffer the
        device/server cut through the client's
        :class:`~repro_torch.core.engine.PipelinedSegmentedReplay`: the
        steady-state per-inference latency is bottleneck-bound instead of
        sum-bound, and results come in order, bitwise the sequential split
        replay's.  Any other state (recording, full-server plan, pipelining
        off) falls back to a closed-loop ``infer()`` per arrival, so a cold
        session can be streamed from the start and warms itself up.
        ``deadlines`` (any iterable of per-request budgets in seconds) go to
        each ``infer()``; on the pipelined path, which bypasses it, they are
        scored after the fact against the in-order completions."""
        if self.system != "rrto":
            raise ValueError("infer_stream requires an rrto session")
        if not self._loaded:
            self.load()
        inputs_seq = list(inputs_seq)
        n = len(inputs_seq)
        if n == 0:
            return []
        # any iterable of offsets (a poisson_arrivals list, a generator)
        offs = [0.0] * n if arrivals is None else [float(a) for a in arrivals]
        if len(offs) != n:
            raise ValueError(f"{n} inputs but {len(offs)} arrival offsets")
        for i, a in enumerate(offs):
            if a < 0:
                raise ValueError(
                    f"arrival offset at index {i} is negative ({a!r}); offsets are "
                    "seconds from now and must be >= 0"
                )
            if i > 0 and a < offs[i - 1]:
                raise ValueError(
                    f"arrival offsets must be non-decreasing: offset at index {i} "
                    f"({a!r}) precedes offset at index {i - 1} ({offs[i - 1]!r})"
                )
        deads = None
        if deadlines is not None:
            deads = [float(d) for d in deadlines]
            if len(deads) != n:
                raise ValueError(f"{n} inputs but {len(deads)} deadline budgets")
        base = self.clock.t
        cl = self.client
        # the executor is valid only while the session is replay-locked (a
        # DAM fallback reverts to recording and drops it)
        pipe = cl.pipelined_exec if cl.mode == MODE_REPLAYING else None
        if pipe is None:
            results = []
            for i, (off, ins) in enumerate(zip(offs, inputs_seq)):
                cl._wait_until(base + off)
                r = self.infer(*ins, deadline_s=None if deads is None else deads[i])
                results.append(StreamResult(r.outputs, base + off, self.clock.t))
            return results
        env = self.server.context(self.client_id).env
        dev0, link0 = pipe.busy_snapshot()
        bytes0, cross0 = pipe.comm_bytes, pipe.crossings
        outputs = []
        for off, ins in zip(offs, inputs_seq):
            wire, fresh = cl.extract_fresh_carried(self._uploads(ins))
            if fresh:
                # a fresh-state override ships once, as on the sequential
                # path (its bytes are not in the pipeline chain's steady state)
                cl._account_network(1, float(sum(a.numel() * a.element_size() for a in fresh.values())))
            wire_outs = pipe.submit(wire, env, base + off, fresh_carried=fresh)
            # carried ordinals answer with the stable handle, so the outputs
            # have the arity of a sequential infer()
            outputs.append(cl.expand_stream_outputs(wire_outs))
        dones = pipe.flush()
        results = [
            StreamResult(o, base + off, done) for o, off, done in zip(outputs, offs, dones)
        ]
        if deads is not None and self.admission is not None:
            # pipelined submissions bypass infer(): score the deadlines after
            # the fact against the in-order completion times
            for r, d in zip(results, deads):
                self.admission.note_completion(r.arrival_t, r.done_at, r.arrival_t + d)
        # completions are in order, so the last one closes the window
        wall = max(0.0, results[-1].done_at - base)
        dev1, link1 = pipe.busy_snapshot()
        dev_busy = dev1 - dev0
        # phase-integrated billing sums to the wall time: radio time that
        # overlaps device compute sits inside the inference draw
        comm = min(link1 - link0, max(0.0, wall - dev_busy))
        self.meter.add(STATE_INFERENCE, dev_busy)
        self.meter.add(STATE_COMM, comm)
        self.meter.add(STATE_STANDBY, max(0.0, wall - dev_busy - comm))
        self.clock.advance(wall)
        cl._account_network(pipe.crossings - cross0, pipe.comm_bytes - bytes0)
        return results

    # ------------------------------------------------------------------
    def _infer_during_outage(self, inputs) -> Tuple[str, List[torch.Tensor]]:
        """One inference with the link declared down.  Three escape hatches,
        picked by what the session has to lose:

        * stateful replay: the carried state lives on the server and cannot
          be recomputed locally, so the client sits out the window (standby)
          and resumes through the at-most-once protocol once the link heals;
        * split replay with a re-planner: adopt the outage plan (the
          bandwidth at the outage floor lands every segment on the device)
          and keep replaying through the split machinery;
        * anything else: run the whole model on the device, the same values
          at device-class latency.
        """
        cl = self.client
        if not cl.outage_active:
            # the probe that found the dead link: one timeout burned
            cl.outage_active = True
            dt = cl.retry_policy.base_timeout_s
            t0 = self.clock.t
            self.clock.advance(dt)
            self.meter.add(STATE_STANDBY, dt)
            if cl.tracer is not None:
                cl.tracer.instant(cl.trace_track, "outage_declared", t0)
        if cl.stateful_replay:
            end = cl.fault.outage_until(self.clock.t)
            cl.stats.outage_waits += 1
            if cl.tracer is not None:
                cl.tracer.span(cl.trace_track, "outage_wait", self.clock.t, end)
            cl._wait_until(end)
            return cl.mode, self._run_intercepted(inputs)
        if cl.mode == MODE_REPLAYING and cl.replanner is not None:
            cl.stats.outage_fallbacks += 1
            if cl.tracer is not None:
                cl.tracer.instant(cl.trace_track, "outage_fallback", self.clock.t, path="split")
            plan = cl.replanner.declare_outage(self.clock.t)
            if plan is not None:
                cl._install_plan(plan)
            return cl.mode, self._run_intercepted(inputs)
        cl.stats.outage_fallbacks += 1
        if cl.tracer is not None:
            cl.tracer.instant(cl.trace_track, "outage_fallback", self.clock.t, path="device")
        # the device path is already eager, op by op, so its values are
        # bitwise the replay's (the reference needs a separate eager path
        # because its device_only runs one jit)
        return "outage_fallback", self._device_only(inputs)

    def _direct(self, inputs) -> List[torch.Tensor]:
        """Eager execution of the app on the device: the same aten calls the
        interceptor records, one at a time (zeros of the outputs' avals in an
        account-only session)."""
        if not self.execute:
            return [torch.zeros(shape, dtype=dtype) for shape, dtype in
                    (v.aval for v in self._graph.outvars)]
        with torch.no_grad():
            outs = self._flat_apply(
                self._param_leaves,
                *self._aux_leaves,
                *[x.to(self.device) for x in inputs],
            )
        return [host_copy(o) for o in outs]

    def _device_only(self, inputs) -> List[torch.Tensor]:
        outs = self._direct(inputs)
        dt = self.device_fallback_seconds()
        self.clock.advance(dt)
        self.meter.add(STATE_INFERENCE, dt)
        return outs

    def _nnto(self, inputs) -> List[torch.Tensor]:
        outs = self._direct(inputs)
        in_bytes = float(
            sum(x.numel() * x.element_size() for x in inputs)
            / self.model.input_wire_divisor
        )
        out_bytes = float(sum(o.numel() * o.element_size() for o in outs))
        # app-level send -> server compute -> receive
        up = self.network._rtt_at(self.clock.t) + self.network.transfer_time(
            in_bytes, self.clock.t
        )
        self.clock.advance(up)
        self.meter.add(STATE_COMM, up)
        compute = self.server_device.sequence_time(
            self._steady_flops,
            self._steady_bytes,
            num_kernels=max(1, self._n_kernels // REPLAY_KERNELS_PER_FUSION),
            fusion_factor=REPLAY_FUSION_FACTOR,
        )
        self.server.busy_seconds += compute
        self.clock.advance(compute)
        self.meter.add(STATE_STANDBY, compute)
        down = self.network.transfer_time(out_bytes, self.clock.t)
        self.clock.advance(down)
        self.meter.add(STATE_COMM, down)
        self.meter.add(STATE_CONTROL, CLIENT_CONTROL_S)
        self.clock.advance(CLIENT_CONTROL_S)
        return outs
