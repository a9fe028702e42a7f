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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

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
    REPLAY_FUSION_FACTOR,
    REPLAY_KERNELS_PER_FUSION,
    OffloadServer,
    RRTOClient,
    SimClock,
    host_copy,
)
from repro_torch.core.flatten import graph_cost, trace_app
from repro_torch.core.intercept import FrameworkNoiseModel, GraphInterceptor
from repro_torch.core.netsim import get_network
from repro_torch.device import resolve_device, to_host

SYSTEMS = ("device_only", "nnto", "cricket", "semi_rrto", "rrto")

# client-side application logic per inference (pre/post-processing)
CLIENT_CONTROL_S = 0.5e-3


@dataclasses.dataclass
class OffloadableModel:
    """A model as the offloading layer sees it: an apply function, its
    parameters (a nested dict of tensors on the session's device) and
    example inputs (host values: CPU tensors or numpy arrays)."""

    name: str
    apply: Callable[..., Sequence[torch.Tensor]]   # apply(params, *inputs)
    params: Any
    example_inputs: Tuple[Any, ...]


@dataclasses.dataclass
class InferenceResult:
    outputs: List[torch.Tensor]      # host (CPU) tensors
    wall_seconds: float
    joules: float
    rpcs: int
    network_bytes: float
    server_busy_seconds: float
    mode: str


class OffloadSession:
    """One application process using one offloading system."""

    def __init__(
        self,
        model: OffloadableModel,
        system: str,
        *,
        environment: str = "indoor",
        min_repeats: int = 3,
        seed: int = 0,
        device: Any = "cuda",
    ):
        if system not in SYSTEMS:
            raise ValueError(f"unknown system {system!r}; pick from {SYSTEMS}")
        self.model = model
        self.system = system
        self.device = resolve_device(device)
        # the paper's testbed, simulated: Jetson Xavier NX client, GTX 2080 Ti
        # server, indoor or outdoor Wi-Fi trace, Tab. II power draw
        self.network = get_network(environment, seed)
        self.client_device = JETSON_XAVIER_NX
        self.server_device = GTX_2080TI
        self.clock = SimClock()
        self.meter = EnergyMeter(PowerModel())
        self.server = OffloadServer(GTX_2080TI, device=self.device)
        self.history: List[InferenceResult] = []
        self._loaded = False

        # ---- trace the model once (fake tensors: shapes only)
        self._param_leaves, self._param_spec = torch.utils._pytree.tree_flatten(
            model.params
        )
        spec = self._param_spec

        def flat_apply(leaves, *inputs):
            return model.apply(torch.utils._pytree.tree_unflatten(leaves, spec), *inputs)

        self._flat_apply = flat_apply
        example = [to_host(x).to(self.device) for x in model.example_inputs]
        self._graph = trace_app(flat_apply, self._param_leaves, example)
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
            )
            self.interceptor = GraphInterceptor(self.client, FrameworkNoiseModel())
        else:
            self.client = None
            self.interceptor = None
        self._param_addrs: List[int] = []

    # ------------------------------------------------------------------
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
            # upload every traced constant (the parameters and any tensor the
            # app builds from Python data), deduplicated by identity (a tied
            # weight is one tensor)
            unique: Dict[int, int] = {}
            leaves: List[torch.Tensor] = []
            for c in self._graph.consts:
                if id(c) not in unique:
                    unique[id(c)] = len(leaves)
                    leaves.append(c)
            addrs = self.interceptor.upload_params(leaves)
            self._param_addrs = [addrs[unique[id(c)]] for c in self._graph.consts]
        self._loaded = True

    def _run_intercepted(self, inputs: Sequence[torch.Tensor]) -> List[Any]:
        return self.interceptor.run(self._graph, self._param_addrs, inputs)

    def infer(self, *inputs) -> InferenceResult:
        """One inference.  Inputs are host values (CPU tensors or numpy); a
        CPU tensor is passed through as the same object, so a handle the
        session handed out keeps its identity on the way back in."""
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
            mode = self.client.mode
            outputs = self._run_intercepted(inputs)

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

    # ------------------------------------------------------------------
    def _direct(self, inputs) -> List[torch.Tensor]:
        """Eager execution of the app on the device: the same aten calls the
        interceptor records, one at a time."""
        with torch.no_grad():
            outs = self._flat_apply(
                self._param_leaves, *[x.to(self.device) for x in inputs]
            )
        return [host_copy(o) for o in outs]

    def _device_only(self, inputs) -> List[torch.Tensor]:
        outs = self._direct(inputs)
        dt = self.client_device.sequence_time(
            self._steady_flops,
            self._steady_bytes,
            num_kernels=self._n_kernels,
            fusion_factor=1.0,  # eager per-op dispatch on the device
        )
        self.clock.advance(dt)
        self.meter.add(STATE_INFERENCE, dt)
        return outs

    def _nnto(self, inputs) -> List[torch.Tensor]:
        outs = self._direct(inputs)
        in_bytes = float(sum(x.numel() * x.element_size() for x in inputs))
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
