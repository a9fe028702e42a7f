"""RRTO client/server engines — Alg. 3 (RRTO_on_Client) + Alg. 4
(RRTO_on_Server), driven by a simulated clock, network and energy meter.

The full-server part of ``repro.core.engine``.  The client is a call sink
for :class:`GraphInterceptor`.  In the recording phase it behaves
exactly like a traditional transparent offloader (one RPC per intercepted
call) while logging records and running the Operator Sequence Search after
every DtoH.  Once the inference operator sequence (IOS) is identified, it
switches to the replaying phase: intermediate operators are answered locally
from recorded results, only the HtoD input upload and the DtoH output
download cross the network, and the server re-executes the recorded aten
calls from their payloads (Alg. 4), not from the model.

Loop-carried tensors (a KV cache threaded through a decode app) are detected
across IOS repeats; the replay program then runs as a *stateful* step whose
carried state stays on the server and never crosses the network.

Deviation from the IOS (a Dynamic Activation Model changing its op stream) is
detected record-by-record; the client ships the locally-answered prefix to the
server for catch-up execution and falls back to the recording phase
(Sec. III-B1 fallback).

Multi-tenant: one :class:`OffloadServer` holds a :class:`ClientContext` per
client id (device-memory namespace + bound replay) and shares the simulated
GPU queue and an optional content-addressed replay cache across them; a
client whose single recorded inference matches a cached IOS adopts it (the
cache probe), and co-tenant replays of one program run as one
``torch.func.vmap``-batched call (:class:`BatchedReplayProgram`).

Fault tolerance: with a :class:`~repro_torch.core.netsim.FaultInjector` the
client pays a timeout and a retransmission for every lost message, and the
stateful replay step (non-idempotent: it advances the server-resident state)
rides a sequence-numbered at-most-once protocol, the server answering a
retried step from its dedup table (:meth:`OffloadServer.step_once`).  The
server exports and imports a client's carried state as host copies (a
replica-to-replica migration), and the client can keep a log of its recent
steps' wire inputs (:class:`StepLogEntry`) for crash recovery.

Observability: with a :class:`~repro_torch.obs.Tracer` the client emits its
RPCs, replay calls and downloads as spans on its track and the server its
GPU occupancy on ``<name>/gpu``, all on the simulated clock; every counter
of :class:`InferenceStats` lives in a :class:`~repro_torch.obs.MetricsRegistry`
scope.  Tracing off (``tracer=None``, the default) emits nothing.

Values on the server are tensors on its device; values on the client (the
application's uploads and downloads) are CPU tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.costmodel import JETSON_XAVIER_NX, DeviceSpec
from repro_torch.core.energy import (
    STATE_COMM,
    STATE_CONTROL,
    STATE_INFERENCE,
    STATE_STANDBY,
    EnergyMeter,
)
from repro_torch.core.flatten import fill_args, template_vars
from repro_torch.core.intercept import InterceptedCall
from repro_torch.core.netsim import FaultInjector, NetworkModel, RetryPolicy, RpcTimeoutError
from repro_torch.core.opseq import (
    candidate_sequences,
    detect_loop_carried,
    ios_fingerprint,
    operator_sequence_search,
)
from repro_torch.core.records import (
    CAT_D2H,
    CAT_H2D,
    FUNC_D2H,
    FUNC_H2D,
    InferenceSequence,
    OperatorRecord,
)
from repro_torch.obs import MetricsRegistry, RegistryBackedStats, Tracer

MODE_RECORDING = "recording"
MODE_REPLAYING = "replaying"

DEFAULT_CLIENT = "c0"

# fused-executable advantage of the replayed sequence over per-op dispatch
# (simulated-clock constants, as in the reference)
REPLAY_FUSION_FACTOR = 0.6
REPLAY_KERNELS_PER_FUSION = 6
# marginal cost of each extra client in a cross-client batched replay, as a
# fraction of the solo sequence time (sub-linear batching on the shared GPU)
BATCH_MARGINAL_COST = 0.25
PER_LOCAL_OP_S = 2e-7  # answering an intercepted call from the local cache
# live H2D/D2H payloads are kept on this many trailing recorded calls (the
# loop-carried detection needs ~3 repeats of the IOS); older payloads are
# dropped so a client whose search never succeeds does not pin every tensor
# it ever transferred
PAYLOAD_RETENTION_CALLS = 4096
# ...but the trailing transfer calls keep their payloads regardless of log
# depth: a framework-noise-heavy app emits thousands of records per
# inference, and a call-count horizon alone would cut the loop-carried
# detection window out from under the search
PAYLOAD_RETENTION_TRANSFERS = 64
# at-most-once dedup: replies cached per (client, sequence number).  A client
# retries one in-flight step at a time and moves on once it has the reply, so
# a small window is ample; the bound keeps a long decode stream from pinning
# every step's outputs on the server
DEDUP_WINDOW = 64


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A fresh CPU copy of a server tensor: what a DtoH hands the client."""
    return t.detach().to("cpu", copy=True)


def _is_handle(value: Any, handle: Optional[torch.Tensor]) -> bool:
    """Whether the app uploaded the placeholder handle it was given (or a
    view of it) rather than new data."""
    return handle is not None and (
        value is handle
        or (isinstance(value, torch.Tensor) and value._base is handle)
    )


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _avals_nbytes(avals) -> int:
    total = 0
    for shape, dtype in avals:
        n = dtype.itemsize
        for d in shape:
            n *= int(d)
        total += n
    return total


@dataclasses.dataclass
class StepLogEntry:
    """One completed stateful replay step, as crash recovery needs it: the
    wire inputs (and any fresh-state override), host copies, re-executed
    against a restored checkpoint reproduce the lost carried state token for
    token."""

    seq: int
    wire_inputs: List[torch.Tensor]
    fresh_carried: Optional[Dict[int, torch.Tensor]]


@contextlib.contextmanager
def no_vmap_fallback() -> Iterator[None]:
    """Make an operator without a batching rule raise under
    ``torch.func.vmap`` instead of warning and running once per lane (the
    fallback would turn one batched launch into N quiet ones)."""
    was = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(was)


class SimClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"time went backwards: {dt}")
        self.t += dt


# ---------------------------------------------------------------------------
# server (Alg. 4)
# ---------------------------------------------------------------------------

def replay_address_plan(calls: List[InterceptedCall]) -> dict:
    """Walk a recorded IOS and extract its address plan: which buffers are
    replay inputs (HtoD), outputs (DtoH) and resident parameters (read before
    any in-window write)."""
    h2d_addrs: List[int] = []
    d2h_addrs: List[int] = []
    kernel_calls: List[InterceptedCall] = []
    written: set = set()
    param_addrs: List[int] = []
    total_flops = 0.0
    total_bytes = 0.0
    for c in calls:
        rec = c.record
        if rec.func == FUNC_H2D:
            h2d_addrs.append(c.out_addrs[0])
            written.add(c.out_addrs[0])
        elif rec.func == FUNC_D2H:
            d2h_addrs.append(c.in_operands[0][1])
        elif c.op is not None:
            kernel_calls.append(c)
            for _, v in c.in_operands:
                if v not in written and v not in param_addrs:
                    param_addrs.append(v)
            written.update(c.out_addrs)
            total_flops += rec.flops
            total_bytes += rec.mem_bytes
    return dict(
        h2d_addrs=h2d_addrs,
        d2h_addrs=d2h_addrs,
        kernel_calls=kernel_calls,
        param_addrs=param_addrs,
        total_flops=total_flops,
        total_bytes=total_bytes,
    )


def execute_call(call: InterceptedCall, env: Dict[int, Any]) -> None:
    """Run one recorded kernel call against a device-memory namespace."""
    vals = [env[a] for _, a in call.in_operands]
    args, kwargs = fill_args((call.args, call.kwargs or {}), vals)
    out = call.op(*args, **kwargs)
    if isinstance(out, torch.Tensor):
        env[call.out_addrs[0]] = out
    else:
        env.update(zip(call.out_addrs, out))


class ReplayProgram:
    """One IOS replay program.

    The program is rebuilt purely from the recorded RPC payloads (aten op +
    arguments + operand addresses) — not from the original model definition —
    which is what makes this a *replayer*.  It takes ``(params_flat,
    inputs_flat)`` positionally, and a client supplies its parameter buffers
    through a :class:`BoundReplay`.

    With ``carried_pairs`` (loop-carried tensors detected across IOS
    repeats) the program is *stateful*: ``step_fn(params_flat, wire_inputs,
    carried_inputs)`` returns the wire outputs and the new carried state
    separately, so recurrent state (a KV cache) stays server-resident and
    never crosses the network — the per-round replay is the model's
    intrinsic step cost.  The step is out of place (the new state is a new
    tensor); updating donated buffers in place and capturing the step in a
    CUDA graph are later work.

    ``verify=True`` runs the replay soundness verifier over the calls and the
    carried pairs first and raises
    :class:`~repro_torch.analysis.ReplaySoundnessError` on any ERROR
    diagnostic, before anything is built."""

    def __init__(
        self,
        calls: List[InterceptedCall],
        *,
        carried_pairs: Tuple[Tuple[int, int], ...] = (),
        verify: bool = False,
    ):
        if verify:
            from repro_torch.analysis.verify import raise_on_errors, verify_calls

            raise_on_errors(verify_calls(calls, carried_pairs))
        plan = replay_address_plan(calls)
        kernel_calls = plan["kernel_calls"]

        self.carried_pairs = tuple(
            (int(i), int(j)) for i, j in carried_pairs
        )
        carried_in = {i for i, _ in self.carried_pairs}
        carried_out = {j for _, j in self.carried_pairs}
        # h2d/d2h ordinals that still travel over the wire, in wire order
        self.wire_in = [
            i for i in range(len(plan["h2d_addrs"])) if i not in carried_in
        ]
        self.wire_out = [
            j for j in range(len(plan["d2h_addrs"])) if j not in carried_out
        ]

        def run_kernels(env: Dict[int, Any]) -> None:
            for c in kernel_calls:
                execute_call(c, env)

        # the building client's own address plan, so its binding needn't
        # re-walk the calls it was just built from
        self.plan = plan
        self.fn, step = self.functions(run_kernels)
        self.step_fn = step if self.carried_pairs else None
        self.kernel_calls = kernel_calls
        self.d2h_avals = [
            c.out_avals[0] for c in calls if c.record.func == FUNC_D2H
        ]
        # H2D records carry no avals: an upload's structural signature comes
        # from the recorded live payload (None once it was trimmed)
        self.h2d_avals = [
            (tuple(c.h2d_value.shape), c.h2d_value.dtype)
            if isinstance(c.h2d_value, torch.Tensor) else None
            for c in calls if c.record.func == FUNC_H2D
        ]
        self.n_records = len(calls)
        self.n_kernels = len(kernel_calls)
        self.total_flops = plan["total_flops"]
        self.total_bytes = plan["total_bytes"]
        # size for byte-aware cache eviction: the tensors the program holds
        # itself (constants inside the recorded arguments) plus its output
        # staging buffers; there is no compiled code to count
        self.consts_nbytes = 0
        for c in kernel_calls:
            for leaf in torch.utils._pytree.tree_leaves((c.args, c.kwargs or {})):
                if isinstance(leaf, torch.Tensor):
                    self.consts_nbytes += _nbytes(leaf)
        self.staging_nbytes = _avals_nbytes(self.d2h_avals)
        self.nbytes_estimate = self.consts_nbytes + self.staging_nbytes

    def functions(self, run_kernels):
        """``(replay, step)`` around a kernel runner that executes the
        recorded kernel calls against an env: ``replay(params_flat,
        inputs_flat)`` -> every D2H value, and ``step(params_flat,
        wire_inputs, carried_inputs)`` -> (wire outputs, new carried
        state)."""
        param_addrs, h2d_addrs, d2h_addrs = (
            self.plan["param_addrs"], self.plan["h2d_addrs"], self.plan["d2h_addrs"]
        )

        def replay(params_flat, inputs_flat):
            env: Dict[int, Any] = dict(zip(param_addrs, params_flat))
            env.update(zip(h2d_addrs, inputs_flat))
            with torch.no_grad():
                run_kernels(env)
            return [env[a] for a in d2h_addrs]

        def step(params_flat, wire_inputs, carried_inputs):
            env: Dict[int, Any] = dict(zip(param_addrs, params_flat))
            for ordinal, v in zip(self.wire_in, wire_inputs):
                env[h2d_addrs[ordinal]] = v
            for (ordinal, _), v in zip(self.carried_pairs, carried_inputs):
                env[h2d_addrs[ordinal]] = v
            with torch.no_grad():
                run_kernels(env)
            return (
                [env[d2h_addrs[j]] for j in self.wire_out],
                [env[d2h_addrs[j]] for _, j in self.carried_pairs],
            )

        return replay, step

    @property
    def is_stateful(self) -> bool:
        return bool(self.carried_pairs)

    @property
    def wire_in_avals(self):
        """(shape, dtype) of each H2D payload that still crosses the wire,
        in wire order — the structural signature of one replay submission
        (the multi-tenant batcher caches its digest per bound replay)."""
        return [self.h2d_avals[i] for i in self.wire_in]

    def build_batched(self, width: int) -> "BatchedReplayProgram":
        """A ``torch.func.vmap``-batched program over ``width`` co-tenant
        replays of this one (shared parameter values)."""
        return BatchedReplayProgram(self, width)

    def compute_seconds(self, device: DeviceSpec) -> float:
        """Modeled one-shot execution time of the fused sequence."""
        return device.sequence_time(
            self.total_flops,
            self.total_bytes,
            num_kernels=max(1, self.n_kernels // REPLAY_KERNELS_PER_FUSION),
            fusion_factor=REPLAY_FUSION_FACTOR,
        )

    def batched_compute_seconds(self, device: DeviceSpec, batch: int) -> float:
        """Modeled time for one cross-client batched execution of ``batch``
        same-fingerprint replays (sub-linear in batch size)."""
        solo = self.compute_seconds(device)
        return solo * (1.0 + BATCH_MARGINAL_COST * (max(1, batch) - 1))


# Products whose batched form may sum in another order than the lane loop: a
# GEMM at M = lanes·m can take another kernel (tile, split) than at M = m, on
# the card's cuBLAS and the CPU's alike (chip_smoke.py phase 7 prints where).
# A batched program measures each such call before its first execution, on
# noise operands of its shapes (the vmapped call against the lane loop), and
# runs the ones that differ once per lane, in lane order, which keeps vmap ==
# loop bit for bit; the rest, the hand kernels and every other aten op batch.
LANE_PROBED_OPS = frozenset({
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.baddbmm.default,
    torch.ops.aten.convolution.default,
})
_LANE_CALLS: Dict[int, InterceptedCall] = {}
_lane_ids = itertools.count()


def _run_call(call: InterceptedCall, operands: List[torch.Tensor]) -> List[torch.Tensor]:
    args, kwargs = fill_args((call.args, call.kwargs or {}), operands)
    out = call.op(*args, **kwargs)
    return [out] if isinstance(out, torch.Tensor) else list(out)


def _per_lane(call, operands, dims, lanes: int) -> List[torch.Tensor]:
    outs = [_run_call(call, [t if d is None else t.select(d, i) for t, d in zip(operands, dims)])
            for i in range(lanes)]
    return [torch.stack(list(o)) for o in zip(*outs)]


def _probe_values(t: torch.Tensor) -> torch.Tensor:
    """Hash noise in [-0.5, 0.5) of ``t``'s shape, dtype and device."""
    i = torch.arange(t.numel(), dtype=torch.float64, device=t.device)
    return (torch.frac(torch.sin(i * 12.9898) * 43758.5453) - 0.5).to(t.dtype).reshape(t.shape)


def batches_bitwise(call: InterceptedCall, operands, dims, lanes: int) -> bool:
    """Whether ``call`` under vmap gives the lane loop's bits, measured on
    noise operands of the given ones' shapes, dtypes and devices (batched
    at ``dims``)."""
    probe = [_probe_values(t) if t.is_floating_point() else t for t in operands]
    with torch.no_grad():
        batched = torch.func.vmap(lambda *ops: tuple(_run_call(call, list(ops))),
                                  in_dims=tuple(dims))(*probe)
        return all(torch.equal(a, b) for a, b in zip(batched, _per_lane(call, probe, dims, lanes)))


@torch.library.custom_op("repro_torch::lane_call", mutates_args=())
def lane_call(call_id: int, operands: List[torch.Tensor]) -> List[torch.Tensor]:
    """Run the recorded call ``call_id`` on its operands (one lane)."""
    return _run_call(_LANE_CALLS[call_id], operands)


def _lane_call_vmap(info, in_dims, call_id, operands):
    """One lane at a time, in lane order: the same products, at the same M,
    as the loop of solo replays."""
    outs = _per_lane(_LANE_CALLS[call_id], operands, in_dims[1], info.batch_size)
    return outs, [0] * len(outs)


torch.library.register_vmap(lane_call, _lane_call_vmap)


class BatchedReplayProgram:
    """A ``torch.func.vmap``-batched cross-client replay program.

    One per (fingerprint, padded batch width), derived from the solo
    :class:`ReplayProgram` and cached in the replay cache under
    ``<fingerprint>#vmap<width>`` so co-tenant rounds of the same width
    reuse it.  Parameters are shared (``in_dims=None``); wire inputs — and,
    for a stateful program, the per-client carried states — are stacked on
    a new leading axis.  Each hand kernel's batching rule folds the lanes
    into its batch axis (one launch for the group); a call of
    :data:`LANE_PROBED_OPS` is measured before the first execution and runs
    per lane where batching would change its bits.  The result is
    bitwise the solo program run once per client.  There is nothing to
    compile: building it wraps the replay in ``vmap``."""

    def __init__(self, program: ReplayProgram, width: int):
        if width < 2:
            raise ValueError(f"batched replay needs width >= 2, got {width}")
        self.base = program
        self.width = int(width)
        self.stateful = program.is_stateful
        self.n_kernels = program.n_kernels
        # the constants are shared; each lane stages its own outputs
        self.nbytes_estimate = program.consts_nbytes + self.width * program.staging_nbytes
        # which operands of each call carry the lanes: the uploads (wire and
        # carried) do, the parameters do not, and an output does iff an input
        # of its call does (vmap's own rule)
        plan = program.plan
        lanes = set(plan["h2d_addrs"])
        self._dims: List[List[Optional[int]]] = []
        for c in program.kernel_calls:
            dims = [0 if a in lanes else None for _, a in c.in_operands]
            self._dims.append(dims)
            (lanes.update if any(d is not None for d in dims) else lanes.difference_update)(
                c.out_addrs)
        # kernel-call index -> lane_call id, filled by the probe
        self._lane_order: Optional[Dict[int, int]] = None
        self.n_probed = 0

        def run_kernels(env: Dict[int, Any]) -> None:
            for i, c in enumerate(program.kernel_calls):
                call_id = self._lane_order.get(i)
                if call_id is None:
                    execute_call(c, env)
                else:
                    env.update(zip(c.out_addrs, lane_call(call_id, [env[a] for _, a in c.in_operands])))

        replay, replay_step = program.functions(run_kernels)
        vmapped = torch.func.vmap(
            replay_step if self.stateful else replay,
            in_dims=(None, 0, 0) if self.stateful else (None, 0),
        )

        def fn(params_flat, *stacked):
            if self._lane_order is None:
                self._probe(next(t for ts in stacked for t in ts).device)
            return vmapped(params_flat, *stacked)

        self.fn = fn

    def _probe(self, device: torch.device) -> None:
        """Measure every call of :data:`LANE_PROBED_OPS` once per distinct
        (op, arguments, operand shapes, batched operands) and register the
        batch-variant ones to run per lane."""
        self._lane_order = {}
        verdicts: Dict[tuple, bool] = {}
        for i, (c, dims) in enumerate(zip(self.base.kernel_calls, self._dims)):
            if c.op not in LANE_PROBED_OPS or all(d is None for d in dims):
                continue
            avals = [v.aval for v in template_vars((c.args, c.kwargs or {}))]
            key = (c.record.args_sig[:2], tuple(avals), tuple(dims))
            if key not in verdicts:
                operands = [
                    torch.empty(shape if d is None else (self.width, *shape), dtype=dtype,
                                device=device)
                    for (shape, dtype), d in zip(avals, dims)
                ]
                verdicts[key] = batches_bitwise(c, operands, dims, self.width)
            if not verdicts[key]:
                call_id = next(_lane_ids)
                _LANE_CALLS[call_id] = c
                weakref.finalize(self, _LANE_CALLS.pop, call_id, None)
                self._lane_order[i] = call_id
        self.n_probed = len(verdicts)

    @property
    def lane_ordered(self) -> List[InterceptedCall]:
        """The calls measured to need lane order (they run once per lane)."""
        return [self.base.kernel_calls[i] for i in (self._lane_order or {})]


@dataclasses.dataclass
class BoundReplay:
    """A :class:`ReplayProgram` bound to one client's address space.

    For a stateful program the binding also owns this client's
    server-resident ``carried_state`` (device tensors advanced by each step;
    they never revisit the host)."""

    program: ReplayProgram
    param_addrs: List[int]
    h2d_addrs: List[int]
    d2h_addrs: List[int]
    carried_state: Optional[List[torch.Tensor]] = None
    # the state the last step started from: the input state of its round,
    # which a catch-up after a deviation later in that round re-runs from
    state_before_step: Optional[List[torch.Tensor]] = None

    @classmethod
    def from_plan(cls, program: ReplayProgram, plan: dict) -> "BoundReplay":
        return cls(
            program=program,
            param_addrs=plan["param_addrs"],
            h2d_addrs=plan["h2d_addrs"],
            d2h_addrs=plan["d2h_addrs"],
        )

    @classmethod
    def bind(cls, program: ReplayProgram, calls: List[InterceptedCall]) -> "BoundReplay":
        """Bind a shared program to another client's isomorphic calls: the
        same walk yields that client's addresses in the same order."""
        return cls.from_plan(program, replay_address_plan(calls))

    def seed_carried(self, env: Dict[int, Any]) -> None:
        """Adopt the carried state left in this client's device memory by its
        last recorded inference: the replay phase starts exactly where the
        recording phase stopped, with the state already server-resident."""
        if not self.program.carried_pairs:
            return
        vals = [
            env.get(self.d2h_addrs[j]) for _, j in self.program.carried_pairs
        ]
        if any(v is None for v in vals):
            return
        self.carried_state = list(vals)


class SegmentedReplayProgram:
    """Per-segment replay programs for one (IOS, split plan) pair.

    Where :class:`ReplayProgram` runs the whole call stream as one server
    program, this builds one program *per plan segment*, so device-resident
    segments run on the mobile client and server-resident segments on the
    GPU, with only the cut-crossing tensors on the wire.  Keyed by ``(IOS
    fingerprint, plan signature)`` and shareable across clients: a segment
    takes its parameters and boundary tensors positionally, in the tensor
    order both endpoints derive from their own recorded calls
    (:class:`~repro_torch.partition.segments.SegmentGraph`), and threads
    values by tensor version, not by address.  Each segment first re-runs the
    ops that compute the parameter-like tensors it reads from outside itself
    (``SegmentGraph.derived_prologue``).  A segment is an eager walk of its
    recorded calls under ``torch.no_grad()``, out of place, like
    :meth:`ReplayProgram.functions`.

    With ``carried_pairs`` the program is *stateful*: the plan must be
    carried-feasible (every op touching loop-carried state inside the
    trailing server segment), and that suffix runs as a **step**
    ``(params, boundary, carried) -> (outputs, new carried)`` exactly like
    ``ReplayProgram.step_fn``, so the state stays server-resident across the
    cut and never goes on the wire.  ``verify=True`` proves the calls, the
    carried pairs and the plan first, as :class:`ReplayProgram` does."""

    def __init__(
        self,
        calls: List[InterceptedCall],
        plan: Any,
        *,
        carried_pairs: Tuple[Tuple[int, int], ...] = (),
        verify: bool = False,
    ):
        from repro_torch.partition.segments import SegmentGraph

        if verify:
            from repro_torch.analysis.verify import raise_on_errors, verify_split_calls

            raise_on_errors(verify_split_calls(calls, plan, carried_pairs))
        self.carried_pairs = tuple((int(i), int(j)) for i, j in carried_pairs)
        graph = SegmentGraph(calls, carried_pairs=self.carried_pairs)
        if plan.n_ops != graph.n_ops:
            raise ValueError(f"plan covers {plan.n_ops} ops, IOS has {graph.n_ops}")
        if not graph.plan_carried_feasible(plan):
            raise ValueError(
                f"plan {plan.signature()} is not carried-feasible: a stateful IOS "
                "needs every carried-touching op in the trailing server segment"
            )
        self.plan = plan
        self.graph = graph            # the building client's binding
        self.kernel_calls = [c for c in calls if c.op is not None]
        self.d2h_avals = [c.out_avals[0] for c in calls if c.record.func == FUNC_D2H]
        carried_out = {j for _, j in self.carried_pairs}
        # d2h ordinals still on the wire, in wire order (as ReplayProgram)
        self.wire_out = [j for j in range(len(self.d2h_avals)) if j not in carried_out]
        carried_in_tids = set(graph.carried_in_tids)
        carried_out_tids = set(graph.carried_out_tids)
        self.segments: List[dict] = []
        for si, seg in enumerate(plan.segments):
            reads = [t for k in range(seg.start, seg.end) for t in graph.ops[k].in_tids]
            spec = self._spec(graph.derived_prologue(reads, seg.start, seg.end)
                              + list(range(seg.start, seg.end)))
            spec.update(
                segment=seg,
                in_tids=graph.segment_inputs(seg),
                out_tids=graph.segment_outputs(seg),
                # the trailing server segment of a stateful plan is the step:
                # carried inputs arrive as the state argument, carried
                # outputs return separately for the binding to keep
                stateful=bool(self.carried_pairs) and si == len(plan.segments) - 1,
            )
            if spec["stateful"]:
                spec["boundary_tids"] = [t for t in spec["in_tids"] if t not in carried_in_tids]
                spec["out_tids"] = [t for t in spec["out_tids"] if t not in carried_out_tids]
            self.segments.append(spec)
        # outputs computed from parameters alone come from no segment: each
        # endpoint holds them, and the walk computes them after the segments
        self.output_spec = self._spec(graph.derived_prologue(graph.output_tids, 0, 0))
        self.n_records = len(calls)
        self.n_kernels = len(self.kernel_calls)
        self.total_flops = sum(op.flops for op in graph.ops)
        self.total_bytes = sum(op.mem_bytes for op in graph.ops)
        self.consts_nbytes = sum(
            _nbytes(leaf)
            for c in self.kernel_calls
            for leaf in torch.utils._pytree.tree_leaves((c.args, c.kwargs or {}))
            if isinstance(leaf, torch.Tensor)
        )
        self.nbytes_estimate = self.consts_nbytes + _avals_nbytes(self.d2h_avals)

    def _spec(self, ops: List[int]) -> dict:
        """The op list of a walk and the parameters it reads, in first-read
        order."""
        tensors = self.graph.tensors
        params = dict.fromkeys(
            t for k in ops for t in self.graph.ops[k].in_tids if tensors[t].is_param
        )
        return dict(ops=ops, param_tids=list(params))

    @property
    def is_stateful(self) -> bool:
        return bool(self.carried_pairs)

    def run(self, spec: dict, params_flat, bound_vals: Dict[int, Any]) -> Dict[int, Any]:
        """Walk one segment's calls: ``params_flat`` in ``spec['param_tids']``
        order, ``bound_vals`` the tensor versions it receives (tid ->
        value).  Returns every tensor version the walk held."""
        ops = self.graph.ops
        vals: Dict[int, Any] = dict(zip(spec["param_tids"], params_flat))
        vals.update(bound_vals)
        with torch.no_grad():
            for k in spec["ops"]:
                op = ops[k]
                outs = _run_call(self.kernel_calls[k], [vals[t] for t in op.in_tids])
                vals.update(zip(op.out_tids, outs))
        return vals


@dataclasses.dataclass
class BoundSegmentedReplay:
    """A :class:`SegmentedReplayProgram` bound to one client's address
    space: the client's own :class:`SegmentGraph` supplies its parameter
    addresses; the tensor structure is shared.

    For a stateful program the binding also owns this client's
    server-resident ``carried_state``, advanced by the step suffix and never
    revisiting the host, and ``state_before_step``, as :class:`BoundReplay`
    keeps them."""

    program: SegmentedReplayProgram
    graph: Any
    carried_state: Optional[List[torch.Tensor]] = None
    state_before_step: Optional[List[torch.Tensor]] = None

    @classmethod
    def from_own(cls, program: SegmentedReplayProgram) -> "BoundSegmentedReplay":
        return cls(program=program, graph=program.graph)

    @classmethod
    def bind(cls, program: SegmentedReplayProgram, calls: List[InterceptedCall]
             ) -> "BoundSegmentedReplay":
        from repro_torch.partition.segments import SegmentGraph

        return cls(program=program, graph=SegmentGraph(calls, carried_pairs=program.carried_pairs))

    @property
    def plan(self):
        return self.program.plan

    def seed_carried(self, env: Dict[int, Any]) -> None:
        """Adopt the carried state this client's device memory holds (left by
        the last recorded round, or refreshed by the previously active
        stateful program): split replay starts where the previous phase
        stopped, with the state already server-resident."""
        if not self.program.carried_pairs:
            return
        vals = [env.get(self.graph.tensors[t].addr) for t in self.graph.carried_out_tids]
        if any(v is None for v in vals):
            return
        self.carried_state = list(vals)

    def _params(self, spec: dict, env: Dict[int, Any]) -> List[torch.Tensor]:
        return [env[self.graph.tensors[t].addr] for t in spec["param_tids"]]

    def _wire_in_tids(self) -> List[int]:
        carried = set(self.graph.carried_in_tids)
        return [t for t in self.graph.input_tids if t not in carried]

    def execute(
        self,
        inputs: List[torch.Tensor],
        env: Dict[int, Any],
        *,
        execute: bool = True,
        fresh_carried: Optional[Dict[int, torch.Tensor]] = None,
    ) -> List[torch.Tensor]:
        """Run every segment (no timing), threading the cut-crossing tensors;
        parameters come from ``env``, this client's server-side memory
        namespace (which mirrors its on-device weights).  Returns host copies
        of the outputs.

        For a stateless program ``inputs`` are all H2D uploads and every D2H
        output is returned.  For a stateful program ``inputs`` are the *wire*
        inputs and the wire outputs are returned; the carried state lives in
        the binding, is advanced by the step suffix, and ``fresh_carried``
        (pair index -> value) overwrites it first — the contract of
        ``OffloadServer.replay_values``.  The env is refreshed as a replay
        refreshes it, so a later catch-up or plan swap sees this round."""
        program, graph = self.program, self.graph
        if not execute:
            avals = program.d2h_avals
            if program.is_stateful:
                avals = [avals[j] for j in program.wire_out]
            return [torch.zeros(shape, dtype=dtype) for shape, dtype in avals]
        # the server's device: where this client's parameters live
        dev = next((env[graph.tensors[t].addr].device
                    for spec in program.segments for t in spec["param_tids"]), None)
        ins = [x.to(dev) if dev is not None else x for x in inputs]
        if program.is_stateful:
            if self.carried_state is None:
                raise RuntimeError("stateful split replay has no seeded carried state")
            if fresh_carried:
                for idx, v in fresh_carried.items():
                    self.carried_state[idx] = v.to(dev) if dev is not None else v
            self.state_before_step = list(self.carried_state)
            in_tids = self._wire_in_tids()
        else:
            in_tids = graph.input_tids
        val: Dict[int, Any] = dict(zip(in_tids, ins))
        for spec in program.segments:
            params = self._params(spec, env)
            if spec["stateful"]:
                bound_vals = {t: val[t] for t in spec["boundary_tids"]}
                bound_vals.update(zip(graph.carried_in_tids, self.carried_state))
                local = program.run(spec, params, bound_vals)
                self.carried_state = [local[t] for t in graph.carried_out_tids]
                # a wire D2H may read the same buffer as a carried download
                val.update(zip(graph.carried_out_tids, self.carried_state))
            else:
                local = program.run(spec, params, {t: val[t] for t in spec["in_tids"]})
            val.update((t, local[t]) for t in spec["out_tids"])
        out_tids = graph.output_tids
        if program.is_stateful:
            out_tids = [out_tids[j] for j in program.wire_out]
        missing = [t for t in out_tids if t not in val]
        if missing:
            # outputs read straight from a parameter buffer or computed from
            # parameters alone
            spec = program.output_spec
            local = program.run(spec, self._params(spec, env), {})
            for t in missing:
                val[t] = local[t] if t in local else env[graph.tensors[t].addr]
        outs = [val[t] for t in out_tids]
        env.update((graph.tensors[t].addr, v) for t, v in zip(in_tids, ins))
        env.update((graph.tensors[t].addr, v) for t, v in zip(out_tids, outs))
        for in_tid, out_tid, state in zip(
            graph.carried_in_tids, graph.carried_out_tids, self.carried_state or ()
        ):
            env[graph.tensors[in_tid].addr] = state
            env[graph.tensors[out_tid].addr] = state
        return [host_copy(o) for o in outs]


class PipelinedSegmentedReplay:
    """Streaming executor over a :class:`BoundSegmentedReplay`: double-buffers
    the device/server cut across *consecutive* inferences.

    While the server executes inference *i*'s server segments, the device
    computes inference *i+1*'s device segments and streams its cut-crossing
    tensors.  Timing comes from the event-driven scheduler
    (:func:`repro_torch.partition.pipeline.simulate_pipeline`): the device
    and the half-duplex radio are private capacity resources whose busy
    frontiers persist across flushes, and server segments occupy the
    *shared* GPU queue through ``OffloadServer.occupy``.  The steady-state
    per-inference latency is bottleneck-bound instead of sum-bound.

    Functional execution is the sequential path's walk
    (``BoundSegmentedReplay.execute``) in submission order, so pipelined
    outputs are bitwise the sequential split replay's.  ``submit()`` queues
    an arrival and returns its outputs at once; ``flush()`` schedules every
    queued arrival and returns the in-order completion times."""

    def __init__(
        self,
        bound: BoundSegmentedReplay,
        client_device: DeviceSpec,
        server: "OffloadServer",
        network: NetworkModel,
        *,
        input_wire_divisor: float = 1.0,
        t0: float = 0.0,
        tracer: Optional[Tracer] = None,
        trace_track: str = "stream",
    ):
        from repro_torch.core.netsim import CapacityResource
        from repro_torch.partition.pipeline import RES_LINK, RES_SERVER, stage_chain
        from repro_torch.partition.segments import NetworkLink

        self.bound = bound
        self.server = server
        self.network = network
        self.chain = stage_chain(
            bound.graph, bound.plan, client_device, server.device_spec,
            input_wire_divisor=input_wire_divisor,
        )
        # the live-trace link (ingress bytes accumulate); the chain already
        # carries wire-divided input bytes, so the adapter divides no more
        self._link_model = NetworkLink(network, 1.0)
        # session-lifetime resources on an unbounded stream: running totals
        self.device = CapacityResource("device", free_at=t0, record_intervals=False,
                                       tracer=tracer, track=f"{trace_track}/device")
        self.link = CapacityResource("link", free_at=t0, record_intervals=False,
                                     tracer=tracer, track=f"{trace_track}/radio")
        self._per_inference_server_s = sum(
            s.seconds for s in self.chain if s.resource == RES_SERVER
        )
        self._per_inference_crossings = sum(1 for s in self.chain if s.resource == RES_LINK)
        self._per_inference_bytes = sum(s.nbytes for s in self.chain if s.resource == RES_LINK)
        self.submitted = 0
        self._queued: List[float] = []
        self._last_done = t0
        self.crossings = 0
        self.comm_bytes = 0.0
        self.server_seconds = 0.0

    def submit(
        self,
        inputs: List[torch.Tensor],
        env: Dict[int, Any],
        t_arrival: float,
        fresh_carried: Optional[Dict[int, torch.Tensor]] = None,
    ) -> List[torch.Tensor]:
        """Queue one inference at ``t_arrival`` and return its outputs (the
        walk runs now, in submission order).  Arrivals must be nondecreasing
        within a flush window.  ``fresh_carried`` overwrites the stateful
        suffix's resident state before this submission runs."""
        if self._queued and t_arrival < self._queued[-1]:
            raise ValueError(
                f"arrival {t_arrival} precedes queued arrival {self._queued[-1]}"
            )
        outs = self.bound.execute(
            inputs, env, execute=self.server.execute, fresh_carried=fresh_carried
        )
        self._queued.append(float(t_arrival))
        self.submitted += 1
        self.crossings += self._per_inference_crossings
        self.comm_bytes += self._per_inference_bytes
        self.server_seconds += self._per_inference_server_s
        return outs

    def flush(self) -> List[float]:
        """Schedule every queued arrival over the persistent resources;
        returns in-order completion times (one per arrival)."""
        from repro_torch.partition.pipeline import SharedGPUResource, simulate_pipeline

        if not self._queued:
            return []
        sim = simulate_pipeline(
            self.chain, self._link_model, self._queued,
            device=self.device, server=SharedGPUResource(self.server), link_resource=self.link,
        )
        self._queued = []
        dones: List[float] = []
        for s in sim.inferences:
            self._last_done = max(self._last_done, s.done)
            dones.append(self._last_done)
        return dones

    def busy_snapshot(self) -> Tuple[float, float]:
        """(device busy, link busy) seconds so far — the stream driver diffs
        these around a window to bill energy phases."""
        return self.device.busy_total, self.link.busy_total


@dataclasses.dataclass
class ClientContext:
    """One client's server-side state: device memory namespace, bound
    replay and bound split replay.  The GPU occupancy and the replay cache
    stay on the :class:`OffloadServer`: they are shared across tenants."""

    env: Dict[int, Any] = dataclasses.field(default_factory=dict)
    replay: Optional[BoundReplay] = None
    split: Optional[BoundSegmentedReplay] = None


class OffloadServer:
    """GPU-server side: executes RPCs in recording mode, builds + replays the
    IOS in replaying mode.  ``device`` is where the server really computes;
    ``device_spec`` is the simulated server its clock accounts for.  With
    ``execute=False`` the server only accounts time and bytes: it computes
    nothing, and every download is zeros of its aval.

    Multi-tenant: each client id owns a :class:`ClientContext`; the kernel
    queue (``busy_until``), the accumulated compute (``busy_seconds``), the
    optional content-addressed ``replay_cache`` (fingerprint ->
    :class:`ReplayProgram`) and ``compile_count`` are shared.  With the
    default single client and no cache it behaves as a single-tenant
    server.  ``name`` labels its GPU track (``<name>/gpu``) when a
    ``tracer`` is attached.  ``verify=True`` runs the replay soundness
    verifier before every program it builds."""

    def __init__(
        self,
        device_spec: DeviceSpec,
        *,
        device: torch.device,
        execute: bool = True,
        replay_cache: Optional[Any] = None,
        name: str = "server",
        tracer: Optional[Tracer] = None,
        verify: bool = False,
    ):
        self.device_spec = device_spec
        self.device = device
        self.name = name
        self.tracer = tracer
        self.execute = execute
        self.verify = verify    # static soundness analysis before building
        self.contexts: Dict[str, ClientContext] = {}
        self.busy_until = 0.0          # async kernel-queue completion time
        self.busy_seconds = 0.0        # accumulated compute (GPU-util proxy)
        self.replay_cache = replay_cache
        self.compile_count = 0         # programs built (not cache hits)
        # at-most-once protocol: client id -> {sequence number: reply}
        self.dedup: Dict[str, Dict[int, Any]] = {}
        self.dedup_hits = 0

    def context(self, client_id: str = DEFAULT_CLIENT) -> ClientContext:
        ctx = self.contexts.get(client_id)
        if ctx is None:
            ctx = self.contexts[client_id] = ClientContext()
        return ctx

    def to_device(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device)

    # -- recording-phase execution (one call at a time) ---------------------
    def exec_call(
        self,
        call: InterceptedCall,
        arrival_t: float,
        client_id: str = DEFAULT_CLIENT,
    ) -> Any:
        env = self.context(client_id).env
        rec = call.record
        ret: Any = "cudaSuccess"
        if rec.func == FUNC_H2D:
            if self.execute:
                env[call.out_addrs[0]] = self.to_device(call.h2d_value)
        elif rec.func == FUNC_D2H:
            # DtoH must drain the kernel queue first
            self.busy_until = max(self.busy_until, arrival_t)
            if self.execute:
                ret = host_copy(env[call.in_operands[0][1]])
            else:
                shape, dtype = call.out_avals[0]
                ret = torch.zeros(shape, dtype=dtype)
        elif call.op is not None:
            # a kernel or a DtoD copy
            if self.execute:
                with torch.no_grad():
                    execute_call(call, env)
            op_t = self.device_spec.op_time(rec.flops, rec.mem_bytes)
            op_t += self.device_spec.kernel_launch_s
            self.busy_until = max(self.busy_until, arrival_t) + op_t
            self.busy_seconds += op_t
        return ret

    # -- replaying phase -----------------------------------------------------
    def prepare_replay(
        self,
        calls: List[InterceptedCall],
        client_id: str = DEFAULT_CLIENT,
        fingerprint: Optional[str] = None,
        carried_pairs: Tuple[Tuple[int, int], ...] = (),
    ) -> bool:
        """Install a replay program for ``client_id``.

        With a ``replay_cache`` attached and a fingerprint given, the program
        is looked up first: a hit binds the cached program to this client's
        address space without building it again.  ``carried_pairs`` is the
        recording client's loop-carried-tensor detection; a cache hit uses
        the cached program's pairs instead (an adopting client recorded a
        single round and could not detect them itself), and a fingerprint
        persisted by an earlier server recovers the pairs from the cache
        metadata, so the rebuilt program is stateful again.  Returns True
        iff the program came from the cache."""
        cache = self.replay_cache
        program: Optional[ReplayProgram] = None
        if cache is not None and fingerprint is not None:
            program = cache.get(fingerprint)
        from_cache = program is not None
        if program is None:
            pairs = tuple(carried_pairs)
            if not pairs and cache is not None and fingerprint is not None:
                # stale metadata builds the program stateless
                meta = cache.known_metadata(fingerprint)
                if meta and meta.get("carried_pairs") and \
                        not self._stale_metadata(fingerprint, meta, calls):
                    pairs = tuple((int(i), int(j)) for i, j in meta["carried_pairs"])
            program = ReplayProgram(calls, carried_pairs=pairs, verify=self.verify)
            self.compile_count += 1
            if cache is not None and fingerprint is not None:
                cache.put(fingerprint, program)
            # the fresh program was built from this client's calls: its plan
            # is this client's binding
            bound = BoundReplay.from_plan(program, program.plan)
        else:
            bound = BoundReplay.bind(program, calls)
        ctx = self.context(client_id)
        bound.seed_carried(ctx.env)
        ctx.replay = bound
        return from_cache

    def prepare_split(
        self,
        calls: List[InterceptedCall],
        plan: Any,
        client_id: str = DEFAULT_CLIENT,
        fingerprint: Optional[str] = None,
        carried_pairs: Tuple[Tuple[int, int], ...] = (),
    ) -> bool:
        """Install per-segment replay programs for ``client_id``.

        Segmented programs are cached under the composite key
        ``fingerprint|plan signature``: co-tenants on different networks plan
        different cuts of one shared IOS, and each cut is built once.
        ``carried_pairs`` makes the program stateful; a cache hit uses the
        cached program's pairs, and a key persisted by an earlier server (or
        its base fingerprint) recovers them from the cache metadata, so the
        rebuilt split is stateful again.  Returns True iff the program came
        from the cache."""
        cache = self.replay_cache
        key = f"{fingerprint}|{plan.signature()}" if fingerprint is not None else None
        program: Optional[SegmentedReplayProgram] = None
        if cache is not None and key is not None:
            program = cache.get(key)
        from_cache = program is not None
        if program is None:
            pairs = tuple(carried_pairs)
            if not pairs and cache is not None and key is not None:
                for k in (key, fingerprint):
                    meta = cache.known_metadata(k)
                    if meta and meta.get("carried_pairs") and \
                            not self._stale_metadata(k, meta, calls):
                        pairs = tuple((int(i), int(j)) for i, j in meta["carried_pairs"])
                        break
            program = SegmentedReplayProgram(calls, plan, carried_pairs=pairs,
                                             verify=self.verify)
            self.compile_count += 1
            if cache is not None and key is not None:
                cache.put(key, program)
            bound = BoundSegmentedReplay.from_own(program)
        else:
            bound = BoundSegmentedReplay.bind(program, calls)
        ctx = self.context(client_id)
        if self.execute:
            bound.seed_carried(ctx.env)
        ctx.split = bound
        return from_cache

    def _stale_metadata(
        self,
        key: str,
        meta: Dict[str, Any],
        calls: List[InterceptedCall],
    ) -> bool:
        """Cross-check persisted cache metadata against the calls about to
        be built under it.  A hand-edited or stale cache file would bind a
        stateful program to carried-pair ordinals that do not exist in this
        recording; instead the entry is evicted with a warning (RRTO306) and
        the program is built stateless."""
        import warnings

        from repro_torch.analysis.plancheck import verify_metadata_against_calls

        diags = verify_metadata_against_calls(key, meta, calls)
        if not diags:
            return False
        warnings.warn(
            f"{self.name}: evicting stale replay-cache metadata for {key!r}: "
            + "; ".join(f"{d.code}: {d.message}" for d in diags),
            stacklevel=3,
        )
        self.replay_cache.forget_known(key)
        return True

    def replay_values(
        self,
        inputs: List[torch.Tensor],
        client_id: str = DEFAULT_CLIENT,
        *,
        fresh_carried: Optional[Dict[int, torch.Tensor]] = None,
    ) -> List[torch.Tensor]:
        """Functionally execute the bound replay for one client (no timing).

        For a stateless program ``inputs`` are all H2D uploads and the full
        D2H output list is returned.  For a stateful program ``inputs`` are
        the *wire* inputs only; the carried state lives server-side in the
        binding, is advanced by the step, and only the wire outputs are
        returned.  ``fresh_carried`` (pair index -> value) overwrites the
        resident state first — the path a client takes when its application
        supplies genuinely new state instead of threading the resident
        handle."""
        ctx = self.context(client_id)
        bound = ctx.replay
        program = bound.program
        if not self.execute:
            avals = program.d2h_avals
            if program.is_stateful:
                avals = [avals[j] for j in program.wire_out]
            return [torch.zeros(shape, dtype=dtype) for shape, dtype in avals]
        params_flat = [ctx.env[a] for a in bound.param_addrs]
        ins = [self.to_device(x) for x in inputs]
        if program.is_stateful:
            if bound.carried_state is None:
                raise RuntimeError(
                    f"stateful replay for {client_id!r} has no seeded carried state"
                )
            if fresh_carried:
                for idx, v in fresh_carried.items():
                    bound.carried_state[idx] = self.to_device(v)
            bound.state_before_step = list(bound.carried_state)
            wire_outs, new_carried = program.step_fn(
                params_flat, ins, bound.carried_state
            )
            bound.carried_state = list(new_carried)
            self._refresh_env(ctx, bound, ins, wire_outs)
            return [host_copy(o) for o in wire_outs]
        outs = program.fn(params_flat, ins)
        # the server's memory now holds this inference's buffers, as it would
        # after running the calls one by one
        ctx.env.update(zip(bound.h2d_addrs, ins))
        ctx.env.update(zip(bound.d2h_addrs, outs))
        return [host_copy(o) for o in outs]

    @staticmethod
    def _refresh_env(
        ctx: ClientContext,
        bound: BoundReplay,
        wire_inputs: List[torch.Tensor],
        wire_outs: List[torch.Tensor],
    ) -> None:
        """Post-stateful-step env refresh: wire buffers get this round's
        values, carried buffers alias the live resident state — so a
        post-fallback recording-phase catch-up executes against the true
        current state, not the last recorded round's."""
        program = bound.program
        for ordinal, val in zip(program.wire_in, wire_inputs):
            ctx.env[bound.h2d_addrs[ordinal]] = val
        for ordinal, val in zip(program.wire_out, wire_outs):
            ctx.env[bound.d2h_addrs[ordinal]] = val
        for (i, j), state in zip(program.carried_pairs, bound.carried_state):
            ctx.env[bound.h2d_addrs[i]] = state
            ctx.env[bound.d2h_addrs[j]] = state

    def adopt_replay_results(
        self,
        client_id: str,
        inputs: List[torch.Tensor],
        outs: List[torch.Tensor],
        new_carried: Optional[List[torch.Tensor]] = None,
    ) -> None:
        """Install one member's slice of a cross-client *batched* execution
        as if it had executed solo: refresh its device-memory env and, for a
        stateful program, advance its resident carried state to the
        batch-computed value (keeping the state the round started from, as a
        solo step does).  Called at claim time only, so a member that never
        submits (a DAM fallback mid-walk) keeps its state untouched.
        ``outs`` are device tensors."""
        if not self.execute:
            return
        ctx = self.context(client_id)
        bound = ctx.replay
        ins = [self.to_device(x) for x in inputs]
        if bound.program.is_stateful:
            if new_carried is not None:
                bound.state_before_step = list(bound.carried_state)
                bound.carried_state = list(new_carried)
            self._refresh_env(ctx, bound, ins, list(outs))
            return
        ctx.env.update(zip(bound.h2d_addrs, ins))
        ctx.env.update(zip(bound.d2h_addrs, outs))

    # -- carried-state migration --------------------------------------------
    def export_carried_state(self, client_id: str = DEFAULT_CLIENT) -> Optional[List[torch.Tensor]]:
        """Host copies of one client's live server-resident carried state:
        the wire format of a replica-to-replica migration.  Copies, not
        views: the live tensors keep advancing after the snapshot.  The split
        binding takes precedence over the whole-program one (when a split
        plan is active it owns the live state).  None when the client has no
        stateful binding or no seeded state yet."""
        ctx = self.contexts.get(client_id)
        if ctx is None:
            return None
        bound = ctx.split or ctx.replay
        if bound is None or bound.carried_state is None:
            return None
        return [host_copy(v) for v in bound.carried_state]

    def import_carried_state(self, client_id: str, state: List[torch.Tensor]) -> None:
        """Install an exported carried-state snapshot into this client's
        bound replay, the receiving half of a migration: the binding's
        resident state is replaced by device copies and the env's carried
        buffers re-aliased to them, so the next stateful step (and any
        catch-up after a fallback) runs from exactly the migrated state."""
        ctx = self.context(client_id)
        bound = ctx.split or ctx.replay
        if bound is None or not bound.program.is_stateful:
            raise ValueError(
                f"client {client_id!r} has no stateful replay binding to import carried state into"
            )
        pairs = bound.program.carried_pairs
        if len(state) != len(pairs):
            raise ValueError(
                f"carried-state arity mismatch: {len(state)} tensors for {len(pairs)} carried pairs"
            )
        bound.carried_state = [v.to(self.device, copy=True) for v in state]
        if isinstance(bound, BoundSegmentedReplay):
            graph = bound.graph
            for in_tid, out_tid, val in zip(
                graph.carried_in_tids, graph.carried_out_tids, bound.carried_state
            ):
                ctx.env[graph.tensors[in_tid].addr] = val
                ctx.env[graph.tensors[out_tid].addr] = val
        else:
            for (i, j), val in zip(pairs, bound.carried_state):
                ctx.env[bound.h2d_addrs[i]] = val
                ctx.env[bound.d2h_addrs[j]] = val

    def step_once(self, client_id: str, seq: Optional[int], thunk) -> Tuple[Any, bool]:
        """Execute ``thunk`` at most once under ``(client_id, seq)``.

        The server half of the reliability protocol: a sequence number
        already in the dedup table means this request ran and its response
        was lost in flight, so the cached reply is returned and the thunk
        (which advances the carried state and so MUST NOT run twice) is not
        run again.  Returns ``(reply, was_cached)``.  A None sequence number
        bypasses dedup (the fault-free path)."""
        if seq is None:
            return thunk(), False
        table = self.dedup.setdefault(client_id, {})
        if seq in table:
            self.dedup_hits += 1
            return table[seq], True
        reply = thunk()
        table[seq] = reply
        while len(table) > DEDUP_WINDOW:
            del table[min(table)]
        return reply, False

    def occupy(self, compute_seconds: float, start_t: float) -> float:
        """Reserve the shared simulated GPU queue; returns the completion
        time."""
        begin = max(self.busy_until, start_t)
        self.busy_until = begin + compute_seconds
        self.busy_seconds += compute_seconds
        if self.tracer is not None and compute_seconds > 0.0:
            self.tracer.span(f"{self.name}/gpu", "gpu_exec", begin, self.busy_until)
        return self.busy_until

    def replay_compute_seconds(self, client_id: str = DEFAULT_CLIENT) -> float:
        return self.context(client_id).replay.program.compute_seconds(self.device_spec)

    def run_replay(
        self,
        inputs: List[torch.Tensor],
        start_t: float,
        client_id: str = DEFAULT_CLIENT,
        fresh_carried: Optional[Dict[int, torch.Tensor]] = None,
    ) -> Tuple[List[torch.Tensor], float]:
        """Execute the IOS solo; returns (outputs, completion time)."""
        outs = self.replay_values(inputs, client_id, fresh_carried=fresh_carried)
        return outs, self.occupy(self.replay_compute_seconds(client_id), start_t)


# ---------------------------------------------------------------------------
# client (Alg. 3)
# ---------------------------------------------------------------------------

class InferenceStats(RegistryBackedStats):
    """Per-client traffic counters, and the fault-tolerance counters (all 0
    without a :class:`~repro_torch.core.netsim.FaultInjector`), under the
    reference's names and in its order (``wall_seconds`` and ``joules`` stay
    0 there too: the session's results carry them).  Registry-backed: a
    fleet root's ``snapshot()`` reports every client's RPC count and wire
    bytes."""

    _fields = (
        ("rpcs", 0),
        ("network_bytes", 0.0),
        ("wall_seconds", 0.0),
        ("joules", 0.0),
        ("cache_adoptions", 0),
        ("retries", 0),               # lost-message timeouts paid
        ("dedup_replies", 0),         # retried steps answered from the dedup table
        ("outage_fallbacks", 0),      # inferences served device-locally
        ("outage_waits", 0),          # stateful inferences that sat out an outage
        ("crash_restores", 0),        # checkpoint-and-replay recoveries absorbed
    )


class RRTOClient:
    """Call sink implementing Alg. 3.  Modes:

    * ``transparent`` (Cricket) — always record-phase behaviour, no search;
    * ``semi_rrto`` — Cricket + client-side caching of device-query RPCs;
    * ``rrto`` — full record/replay with Operator Sequence Search.

    With ``partition`` (a :class:`~repro_torch.partition.PartitionConfig`)
    the locked IOS is split between the mobile device (``client_device``,
    simulated) and the server by an adaptive planner; inference inputs travel
    divided by ``input_wire_divisor`` when a cut ships them.

    With ``fault`` every lost message costs a timeout (``retry_policy``) and
    a retransmission, and the stateful step rides the at-most-once protocol.

    With ``tracer`` its RPCs, replay calls and downloads are spans on
    ``trace_track`` (``client/<client_id>`` by default); ``metrics`` is the
    registry scope its :class:`InferenceStats` counters live in.

    With ``verify`` the replay soundness verifier proves the locked IOS and
    its carried pairs before the server builds a program from them, and
    every split plan (and its derived cache key) before it is installed.
    """

    def __init__(
        self,
        server: OffloadServer,
        network: NetworkModel,
        clock: SimClock,
        meter: EnergyMeter,
        *,
        variant: str = "rrto",
        min_repeats: int = 3,
        client_id: str = DEFAULT_CLIENT,
        client_device: DeviceSpec = JETSON_XAVIER_NX,
        partition: Optional[Any] = None,
        input_wire_divisor: float = 1.0,
        tracer: Optional[Tracer] = None,
        trace_track: Optional[str] = None,
        metrics: Optional[MetricsRegistry] = None,
        fault: Optional[FaultInjector] = None,
        retry_policy: Optional[RetryPolicy] = None,
        verify: bool = False,
    ):
        if variant not in ("rrto", "semi_rrto", "transparent"):
            raise ValueError(variant)
        self.server = server
        # static soundness analysis of the locked IOS / each installed plan
        # before any program is built from them (fail-fast, off by default)
        self.verify = verify
        self.network = network
        self.clock = clock
        self.meter = meter
        self.variant = variant
        self.min_repeats = min_repeats
        self.client_id = client_id
        self.client_device = client_device
        self.input_wire_divisor = input_wire_divisor
        # multi-tenant hooks: the IOS fingerprint once identified (with a
        # replay cache on the server), whether the IOS was adopted from the
        # shared cache (skipping the min_repeats wait), and an optional
        # replay-execution backend (the edge server's cross-client batcher)
        self.ios_fp: Optional[str] = None
        self.cache_adopted = False
        self.replay_submit: Optional[Any] = None
        # split replay (None = classic full-server replay); co-tenant server
        # segments batch through ``split_submit`` when the edge server sets it
        self.partition = partition
        self.replanner: Optional[Any] = None
        self.split_plan: Optional[Any] = None
        self._split_output_local: List[bool] = []
        self.split_submit: Optional[Any] = None
        # the pipelined stream executor (partition.pipelined), rebuilt on
        # every plan install and read by OffloadSession.infer_stream; while
        # installed it holds a cache claim on its fp|plan key, so eviction
        # cannot purge the base program under a running stream
        self.pipelined_exec: Optional[PipelinedSegmentedReplay] = None
        self._stream_claim: Optional[str] = None

        self.mode = MODE_RECORDING
        self.logs: List[OperatorRecord] = []
        self.calls: List[InterceptedCall] = []
        self._payload_trimmed = 0   # calls below this index hold no payloads
        self._transfer_log: List[int] = []  # indices of recent h2d/d2h calls
        self.ios: Optional[InferenceSequence] = None
        self._ios_calls: List[InterceptedCall] = []
        self._replay_pos = 0
        self._replay_prefix: List[InterceptedCall] = []
        self._replay_inputs: List[torch.Tensor] = []
        self._replay_outputs: Optional[List[torch.Tensor]] = None
        self._replay_done_at = 0.0
        self._out_cursor = 0
        self._h2d_seen = 0
        self._inputs_uploaded = False
        # stateful replay: loop-carried tensors stay server-resident.  The
        # maps go from h2d/d2h ordinal to carried-pair index; the client hands
        # the application a stable placeholder (the state value at replay
        # entry) for each carried download and recognizes it by identity on
        # the way back in — a non-placeholder upload is genuinely new state
        # and is shipped to the server as an override.
        self._carried_in_map: Dict[int, int] = {}
        self._carried_out_map: Dict[int, int] = {}
        self._wire_out_index: Dict[int, int] = {}
        self._carried_placeholders: Dict[int, torch.Tensor] = {}
        self._fresh_carried: Dict[int, torch.Tensor] = {}
        self.fallbacks = 0
        self._query_cache: set = set()
        # observability: spans land on this client's track; None = tracing
        # off (every emission site guards on it)
        self.tracer = tracer
        self.trace_track = trace_track or f"client/{client_id}"
        self.stats = InferenceStats(registry=metrics)
        # fault tolerance: injected link faults and the retry discipline
        # (None = a perfect wire, every hook below passes through), the
        # per-stateful-step sequence number behind the server's dedup, and an
        # optional bounded log of completed steps (a deque of StepLogEntry,
        # attached by the recovery layer and replayed after a replica crash)
        self.fault = fault
        self.retry_policy = retry_policy or RetryPolicy()
        self.step_seq = 0
        self.step_log: Optional[Any] = None
        self.outage_active = False
        # overload protection: the tenant this client bills against and the
        # absolute simulated deadline of the request in flight (None = no
        # SLO; EDF round formation orders it last)
        self.tenant = "default"
        self.deadline_t: Optional[float] = None

    # -- helpers -------------------------------------------------------------
    @property
    def carried_input_ordinals(self) -> frozenset:
        """H2D ordinals (position among one round's uploads) answered locally
        because the tensor is loop-carried server-resident state."""
        return frozenset(self._carried_in_map)

    @property
    def stateful_replay(self) -> bool:
        return bool(self._carried_in_map)

    def expand_stream_outputs(self, wire_outs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The app-visible output list from a stream executor's wire outputs:
        carried D2H ordinals get the stable placeholder handle, wire ordinals
        their value — the arity and meaning of a sequential ``infer()``."""
        if not self._carried_out_map:
            return list(wire_outs)
        n_out = len(wire_outs) + len(self._carried_out_map)
        return [
            self._carried_placeholders.get(self._carried_out_map[c])
            if c in self._carried_out_map else wire_outs[self._wire_out_index[c]]
            for c in range(n_out)
        ]

    def extract_fresh_carried(
        self, uploads: List[torch.Tensor]
    ) -> Tuple[List[torch.Tensor], Optional[Dict[int, torch.Tensor]]]:
        """Split one arrival's uploads into (wire inputs, fresh-state
        overrides), as the sequential H2D walk does: a carried position
        holding the threaded handle costs nothing; any other value is new
        state that overwrites the resident state before the submission
        runs."""
        wire: List[torch.Tensor] = []
        fresh: Dict[int, torch.Tensor] = {}
        for ordinal, v in enumerate(uploads):
            idx = self._carried_in_map.get(ordinal)
            if idx is None:
                wire.append(v)
            elif not _is_handle(v, self._carried_placeholders.get(idx)):
                fresh[idx] = v
                # the handle the app threads from now on is a writable copy,
                # as on the sequential path
                self._carried_placeholders[idx] = v.clone()
        return wire, (fresh or None)

    def _account_network(self, rpcs: int, nbytes: float) -> None:
        self.stats.rpcs += rpcs
        self.stats.network_bytes += nbytes

    def _rpc(self, payload: float, response: float) -> None:
        if self.fault is not None:
            self._ride_out_losses(payload)
        t0 = self.clock.t
        dt = self.network.rpc_time(payload, response, t0)
        self.clock.advance(dt)
        self.meter.add(STATE_COMM, dt)
        self._account_network(1, payload + response)
        if self.tracer is not None:
            self.tracer.span(
                self.trace_track, "record_rpc" if self.mode == MODE_RECORDING else "rpc",
                t0, t0 + dt, payload=payload, response=response,
            )

    def _retry_timeout(self, attempt: int) -> None:
        """Pay one lost-message timeout: the client sat waiting for a reply
        that never came, then retransmits.  Billed as standby (the radio
        idles listening); exponential backoff with deterministic jitter."""
        dt = self.retry_policy.timeout_s(attempt, self.fault.jitter_unit())
        t0 = self.clock.t
        self.clock.advance(dt)
        self.meter.add(STATE_STANDBY, dt)
        self.stats.retries += 1
        if self.tracer is not None:
            self.tracer.instant(self.trace_track, "retry", t0, attempt=attempt, timeout=dt)

    def _ride_out_losses(self, payload: float) -> int:
        """The lost attempts before one delivered message: each costs a
        timeout and a retransmission of the payload.  Raises
        :class:`RpcTimeoutError` once the retry budget is spent.  For
        idempotent traffic only (recording-phase calls re-execute the same
        work; uploads rewrite the same buffers)."""
        attempts = 0
        while self.fault.rpc_fate() != "ok":
            if attempts >= self.retry_policy.max_attempts:
                raise RpcTimeoutError(
                    f"client {self.client_id!r}: RPC lost {attempts + 1} consecutive times"
                )
            self._retry_timeout(attempts)
            self._account_network(1, payload)   # the retransmission
            attempts += 1
        return attempts

    def _reliable_step(
        self,
        submit,
        inputs: List[torch.Tensor],
        fresh: Optional[Dict[int, torch.Tensor]],
    ) -> Tuple[List[torch.Tensor], float]:
        """One sequence-numbered stateful step under the at-most-once
        protocol.  The step advances the server-resident state, so a
        retransmission must never run it again: the server's dedup table
        (:meth:`OffloadServer.step_once`) runs the submission on first
        receipt and answers every retry of the same sequence number from the
        reply cache.  A lost *request* never reached the server (the retry
        runs fresh); a lost *response* means the step DID run, and the retry
        gets the cached reply."""
        seq = self.step_seq
        payload = float(sum(_nbytes(a) for a in inputs))
        attempts = 0
        while True:
            fate = self.fault.rpc_fate()
            if fate != "lost_request":
                reply, cached = self.server.step_once(
                    self.client_id, seq,
                    lambda: submit(inputs, self.clock.t, fresh_carried=fresh),
                )
                if cached:
                    self.stats.dedup_replies += 1
                if fate == "ok":
                    return reply
            # this attempt's reply never arrived: pay the timeout and resend
            if attempts >= self.retry_policy.max_attempts:
                raise RpcTimeoutError(
                    f"client {self.client_id!r}: stateful step {seq} lost "
                    f"{attempts + 1} consecutive times"
                )
            self._retry_timeout(attempts)
            self._account_network(1, payload)   # the retransmission
            attempts += 1

    def _note_step(
        self,
        wire_inputs: List[torch.Tensor],
        fresh: Optional[Dict[int, torch.Tensor]],
    ) -> None:
        """Advance the stateful-step sequence number and, when the recovery
        layer attached a step log, log the completed step for crash replay.
        Host copies, not references: the app may reuse its buffers between
        steps, and a replayed step must ship exactly what the original
        shipped."""
        if not self.stateful_replay:
            return
        if self.step_log is not None:
            self.step_log.append(StepLogEntry(
                seq=self.step_seq,
                wire_inputs=[host_copy(a) for a in wire_inputs],
                fresh_carried={k: host_copy(v) for k, v in fresh.items()} if fresh else None,
            ))
        self.step_seq += 1

    def _local(self, dt: float = PER_LOCAL_OP_S) -> None:
        self.clock.advance(dt)
        self.meter.add(STATE_CONTROL, dt)

    def _wait_until(self, t: float) -> None:
        if t > self.clock.t:
            dt = t - self.clock.t
            self.clock.advance(dt)
            self.meter.add(STATE_STANDBY, dt)

    # -- recording-phase handling --------------------------------------------
    def _record_call(self, call: InterceptedCall) -> Any:
        rec = call.record
        # semi-RRTO (Fig. 11) caches device-query RPCs; full RRTO stays
        # faithful to traditional transparent offloading while recording.
        cached_query = self.variant == "semi_rrto" and rec.category == "q"
        if cached_query and self._seen_query(rec):
            self._local()
            ret = "cached"
        else:
            self._rpc(rec.payload_bytes, rec.response_bytes)
            if rec.category == CAT_D2H:
                # drain the server kernel queue before download completes
                self._wait_until(self.server.busy_until)
            ret = self.server.exec_call(call, self.clock.t, self.client_id)
            if rec.category == CAT_D2H and isinstance(ret, torch.Tensor):
                # Alg. 3 logs the full (func, args, ret) triple; the download
                # payload feeds the loop-carried-tensor detection.  A copy,
                # not the tensor handed to the app: an app that mutates the
                # download in place before re-uploading it would otherwise
                # self-alias into a guaranteed (false) bitwise match.
                call.d2h_value = ret.clone()

        self.logs.append(rec)
        self.calls.append(call)
        if rec.func in (FUNC_H2D, FUNC_D2H):
            self._transfer_log.append(len(self.calls) - 1)
            if len(self._transfer_log) > PAYLOAD_RETENTION_TRANSFERS:
                old = self._transfer_log.pop(0)
                if old < self._payload_trimmed:
                    # it outlived the call-count horizon under protection;
                    # the protection window has slid past it now
                    self.calls[old].h2d_value = None
                    self.calls[old].d2h_value = None
        n = len(self.calls)
        if n - self._payload_trimmed > PAYLOAD_RETENTION_CALLS:
            protected = set(self._transfer_log)
            for i in range(self._payload_trimmed, n - PAYLOAD_RETENTION_CALLS):
                if i in protected:
                    continue
                self.calls[i].h2d_value = None
                self.calls[i].d2h_value = None
            self._payload_trimmed = n - PAYLOAD_RETENTION_CALLS

        if self.variant == "rrto":
            # run the search whenever a DtoH sync group closes: after the DtoH
            # itself and after each trailing synchronize (the paper overlaps
            # the search with the RPC wait, so per-op invocation is free)
            tail_is_boundary = rec.category == CAT_D2H or (
                rec.category == "s"
                and any(r.category == CAT_D2H for r in self.logs[-3:-1])
            )
            if tail_is_boundary:
                # The cache-adoption probe is an extra search, so it runs
                # only on the searches a sync triggers (they close the DtoH
                # sync group): a cached IOS ends at the group-closing sync, so
                # a window cut at the bare DtoH could never match it.
                self._try_identify_sequence(probe_cache=rec.category != CAT_D2H)
        return ret

    def _seen_query(self, rec: OperatorRecord) -> bool:
        key = rec.identity()
        if key in self._query_cache:
            return True
        self._query_cache.add(key)
        return False

    def _try_identify_sequence(self, probe_cache: bool = True) -> None:
        ios = operator_sequence_search(self.logs, self.min_repeats)
        fp: Optional[str] = None
        cache = self.server.replay_cache
        if ios is None and probe_cache and cache is not None and len(cache) > 0:
            # Shared-cache shortcut: a single boundary-aligned, dependency-
            # closed window is not yet *proof* of the IOS, but if its
            # fingerprint matches a sequence another client already validated
            # and the server already built, adopting it skips the remaining
            # recording iterations.  A one-repetition log of a multi-input app
            # admits several shifted windows, so every alignment is probed —
            # cache membership disambiguates.  A wrong adoption is caught by
            # the record-level comparison in the replay phase and falls back
            # (the same safety net as a DAM deviation).
            for candidate in candidate_sequences(self.logs, lengths=cache.ios_lengths()):
                cand_fp = ios_fingerprint(candidate.records)
                if cand_fp in cache:
                    ios, fp = candidate, cand_fp
                    self.cache_adopted = True
                    self.stats.cache_adoptions += 1
                    if self.tracer is not None:
                        self.tracer.instant(self.trace_track, "cache_adopt", self.clock.t,
                                            fp=cand_fp)
                    break
        if ios is None:
            return
        self.ios = ios
        self._ios_calls = list(
            self.calls[ios.start_index : ios.start_index + len(ios)]
        )
        if cache is not None and fp is None:
            fp = ios_fingerprint(ios.records)
        self.ios_fp = fp
        # loop-carried tensors across the recorded repeats (KV caches and
        # the like); a cache-adopting client recorded a single round, so
        # detection yields () and the cached program's pairs apply instead
        pairs = detect_loop_carried(self.calls, ios)
        ios.carried_pairs = pairs
        # recorded live payloads are only needed inside the detection horizon
        # (the last few repeats); for a stateful app every retained round
        # pins a full state tensor on the host, so drop the older ones
        horizon = ios.start_index - 2 * len(ios)
        for c in self.calls[: max(0, horizon)]:
            c.h2d_value = None
            c.d2h_value = None
        if self.verify:
            # fail fast on an unsound recording before the server builds
            # (and caches, and possibly shares) a program from it
            from repro_torch.analysis.verify import raise_on_errors, verify_calls

            raise_on_errors(verify_calls(self._ios_calls, pairs))
        self.server.prepare_replay(
            self._ios_calls,
            client_id=self.client_id,
            fingerprint=fp,
            carried_pairs=pairs,
        )
        program = self.server.context(self.client_id).replay.program
        self._configure_carried(program)
        if self.partition is not None:
            from repro_torch.partition.adaptive import AdaptiveReplanner
            from repro_torch.partition.segments import SegmentGraph

            # a stateful IOS partitions too: the graph built with the carried
            # pairs limits the planner to carried-feasible cuts, so the state
            # stays server-resident under any plan it returns
            self.replanner = AdaptiveReplanner(
                SegmentGraph(self._ios_calls, carried_pairs=program.carried_pairs),
                self.client_device,
                self.server.device_spec,
                rtt_s=self.network.base_rtt_s,
                power=self.meter.power_model,
                config=self.partition,
                input_wire_divisor=self.input_wire_divisor,
                tracer=self.tracer,
                trace_track=self.trace_track,
            )
            self._install_plan(self.replanner.initial_plan(
                self.network.bandwidth_at(self.clock.t), self.clock.t
            ))
        self.mode = MODE_REPLAYING
        self._replay_pos = 0
        if self.tracer is not None:
            self.tracer.instant(self.trace_track, "ios_locked", self.clock.t,
                                fp=self.ios_fp or "", adopted=self.cache_adopted)

    def _configure_carried(self, program: ReplayProgram) -> None:
        """Adopt a program's loop-carried spec: build the ordinal maps and
        seed the app-facing placeholders from the state the recording phase
        left behind."""
        self._carried_in_map = {
            i: idx for idx, (i, _) in enumerate(program.carried_pairs)
        }
        self._carried_out_map = {
            j: idx for idx, (_, j) in enumerate(program.carried_pairs)
        }
        self._wire_out_index = {
            j: w for w, j in enumerate(program.wire_out)
        }
        self._carried_placeholders = {}
        self._fresh_carried = {}
        if not program.carried_pairs:
            return
        if self.ios is not None and not self.ios.carried_pairs:
            self.ios.carried_pairs = program.carried_pairs
        ctx = self.server.context(self.client_id)
        bound, env = ctx.replay, ctx.env
        for idx, (_, j) in enumerate(program.carried_pairs):
            v = env.get(bound.d2h_addrs[j])
            if v is not None:
                # a writable host copy: after a DAM fallback the materializer
                # refreshes the app-held handle in place
                self._carried_placeholders[idx] = host_copy(v)

    def _claim_stream_key(self, key: Optional[str]) -> None:
        """Swap the stream executor's cache claim: release the previous one
        and claim ``key``, so the base program behind an installed
        :class:`PipelinedSegmentedReplay` stays pinned for exactly the
        executor's lifetime."""
        cache = self.server.replay_cache
        if cache is None:
            return
        if self._stream_claim is not None:
            cache.release(self._stream_claim)
            self._stream_claim = None
        if key is not None:
            cache.claim(key)
            self._stream_claim = key

    def _install_plan(self, plan: Any) -> None:
        """Adopt a split plan; a full-server plan reverts to classic replay.

        Carried state survives every swap: each stateful program refreshes
        the env's carried buffers after its step, and each install seeds the
        adopting binding from the env, so the live state moves between the
        whole-program and the segmented binding without visiting the host."""
        if plan.is_full_server:
            if self.split_plan is not None and self.stateful_replay and self.server.execute:
                # the split suffix held the live state; hand it back to the
                # whole-program binding before classic replay resumes
                ctx = self.server.context(self.client_id)
                ctx.replay.seed_carried(ctx.env)
            self.split_plan = None
            self.pipelined_exec = None
            self._claim_stream_key(None)
            return
        pairs = self.ios.carried_pairs if self.ios is not None else ()
        if self.verify:
            # prove the plan against the IOS segment graph (and its derived
            # cache key) before the server builds segment programs
            from repro_torch.analysis.plancheck import verify_cache_key, verify_plan
            from repro_torch.analysis.verify import raise_on_errors
            from repro_torch.partition.segments import SegmentGraph

            graph = SegmentGraph(self._ios_calls, carried_pairs=pairs)
            diags = verify_plan(graph, plan)
            if self.ios_fp is not None:
                diags.extend(verify_cache_key(f"{self.ios_fp}|{plan.signature()}",
                                              n_ops=graph.n_ops))
            raise_on_errors(diags)
        self.split_plan = plan
        self.server.prepare_split(
            self._ios_calls, plan, client_id=self.client_id, fingerprint=self.ios_fp,
            carried_pairs=pairs,
        )
        if self.partition is not None and self.partition.pipelined:
            self.pipelined_exec = PipelinedSegmentedReplay(
                self.server.context(self.client_id).split,
                self.client_device,
                self.server,
                self.network,
                input_wire_divisor=self.input_wire_divisor,
                t0=self.clock.t,
                tracer=self.tracer,
                trace_track=self.trace_track,
            )
            self._claim_stream_key(
                f"{self.ios_fp}|{plan.signature()}" if self.ios_fp is not None else None
            )
        else:
            self.pipelined_exec = None
            self._claim_stream_key(None)

    # -- replaying-phase handling ----------------------------------------------
    def _replay_call(self, call: InterceptedCall) -> Any:
        rec = call.record
        expected = self.ios.records[self._replay_pos]
        if rec != expected:
            return self._fallback(call)

        if self._replay_pos == 0:
            # STARTRRTO: new inference begins (Alg. 3 line 12)
            self._replay_prefix = []
            self._replay_inputs = []
            self._replay_outputs = None
            self._out_cursor = 0
            self._h2d_seen = 0
            self._split_output_local = []
            self._inputs_uploaded = False

        self._replay_pos = (self._replay_pos + 1) % len(self.ios)
        self._replay_prefix.append(call)

        if rec.category == CAT_H2D:
            ordinal = self._h2d_seen
            self._h2d_seen += 1
            if ordinal in self._carried_in_map:
                # loop-carried state: the server already holds it, in the
                # whole-program step or in the split plan's server suffix.
                # The app threading back the handle we gave it costs
                # nothing; any other value is new state and ships as override.
                idx = self._carried_in_map[ordinal]
                ph = self._carried_placeholders.get(idx)
                v = call.h2d_value
                if _is_handle(v, ph):
                    self._local()
                else:
                    self._rpc(rec.payload_bytes, 32)
                    self._fresh_carried[idx] = v
                    # the handle handed back at the paired D2H (and threaded
                    # by the app from then on) is a writable copy, so a DAM
                    # fallback can refresh it in place
                    self._carried_placeholders[idx] = v.clone()
            elif self.split_plan is not None:
                # split replay: wire inputs stay on the device until a
                # segment schedule needs them on the wire
                self._local()
                self._replay_inputs.append(call.h2d_value)
            else:
                # the only client->server RPC left: ship the raw input
                self._rpc(rec.payload_bytes, 32)
                self._inputs_uploaded = True
                self._replay_inputs.append(call.h2d_value)
            if self._h2d_seen == len(self.ios.h2d_positions) and self.split_plan is not None:
                self._run_split_replay()
            elif self._h2d_seen == len(self.ios.h2d_positions):
                fresh = self._fresh_carried or None
                self._fresh_carried = {}
                # the edge server's cross-client batcher when one is
                # installed (multi-tenant serving), a solo replay otherwise
                submit = self.replay_submit or (
                    lambda ins, t, fresh_carried=None: self.server.run_replay(
                        ins, t, self.client_id, fresh_carried=fresh_carried
                    )
                )
                t_sub = self.clock.t
                if self.fault is not None and self.stateful_replay:
                    # the stateful step is not idempotent: retries ride the
                    # sequence-numbered at-most-once protocol
                    outs, done_at = self._reliable_step(submit, self._replay_inputs, fresh)
                else:
                    outs, done_at = submit(self._replay_inputs, self.clock.t, fresh_carried=fresh)
                self._note_step(self._replay_inputs, fresh)
                self._replay_outputs = outs
                self._replay_done_at = done_at
                if self.tracer is not None:
                    self.tracer.span(self.trace_track, "replay_call", t_sub, max(done_at, t_sub),
                                     fp=self.ios_fp or "", batched=self.replay_submit is not None)
                # a full-server plan keeps watching the link, or a bandwidth
                # collapse could never swap it back to a split
                self._maybe_replan()
            return "cudaSuccess"

        if rec.category == CAT_D2H:
            cursor = self._out_cursor
            self._out_cursor += 1
            if cursor in self._carried_out_map:
                # carried state is answered locally with a stable handle —
                # the live buffers stay on the server, nothing crosses the
                # network and nothing is copied back to the host
                self._local()
                idx = self._carried_out_map[cursor]
                ph = self._carried_placeholders.get(idx)
                if ph is None:
                    shape, dtype = call.out_avals[0]
                    ph = torch.zeros(shape, dtype=dtype)
                    self._carried_placeholders[idx] = ph
                return ph
            # wait for the one-shot (or segmented) execution to finish
            self._wait_until(self._replay_done_at)
            if cursor < len(self._split_output_local) and self._split_output_local[cursor]:
                # produced by a device-resident segment: the download is a
                # local copy, no network round trip
                self._local()
                return self._replay_outputs[self._wire_out_index.get(cursor, cursor)]
            t0 = self.clock.t
            dt = (
                self.network._rtt_at(t0)
                + self.network.transfer_time(rec.response_bytes, t0)
            )
            self.clock.advance(dt)
            self.meter.add(STATE_COMM, dt)
            self._account_network(1, rec.payload_bytes + rec.response_bytes)
            if self.tracer is not None:
                self.tracer.span(self.trace_track, "replay_d2h", t0, t0 + dt,
                                 bytes=rec.response_bytes)
            return self._replay_outputs[self._wire_out_index.get(cursor, cursor)]

        # intermediate operator: answered from the recorded result, locally
        self._local()
        return expected.ret

    def _run_split_replay(self) -> None:
        """Execute the split plan: device segments run locally (device-class
        cost, inference-power accounting), server segments occupy the shared
        GPU, and boundary tensors ship with uplink overlapped against the
        device compute that follows their producers.  Then the adaptive
        re-planner observes the live bandwidth and may swap plans."""
        from repro_torch.partition.segments import PLACE_SERVER, NetworkLink, compute_schedule

        ctx = self.server.context(self.client_id)
        bound = ctx.split
        t0 = self.clock.t
        sched = compute_schedule(
            bound.graph, self.split_plan, self.client_device, self.server.device_spec,
            NetworkLink(self.network, self.input_wire_divisor), t0=t0,
            # the D2H records pay the real output downlink; modeling it here
            # would charge the shared ingress twice
            include_output_downlink=False,
        )
        fresh = self._fresh_carried or None
        self._fresh_carried = {}
        outs = bound.execute(
            self._replay_inputs, ctx.env, execute=self.server.execute, fresh_carried=fresh
        )
        self._note_step(self._replay_inputs, fresh)
        # server segments occupy the shared GPU — through the co-tenant
        # segment batcher when the edge server installed one
        server_segs = [s for s in self.split_plan.segments if s.placement == PLACE_SERVER]
        completions = []
        for seg, (start, dur) in zip(server_segs, sched.server_busy):
            completions.append(
                self.split_submit(seg, dur, start) if self.split_submit is not None
                else self.server.occupy(dur, start)
            )
            if self.tracer is not None:
                self.tracer.span(f"{self.server.name}/gpu", "segment_exec", start, start + dur,
                                 client=self.client_id, ops=f"{seg.start}:{seg.end}")
        # phase-integrated billing covers the body once: overlapped uplink is
        # inside the inference draw (Schedule.radio_only_seconds)
        self.meter.add(STATE_INFERENCE, sched.device_seconds)
        self.meter.add(STATE_COMM, sched.radio_only_seconds)
        self.meter.add(STATE_STANDBY, sched.wait_seconds)
        self.clock.advance(sched.body_seconds)
        if completions:
            # co-tenant contention extended our server segments: with the
            # segment batcher the wait is our own groups' completion, without
            # it the shared queue's frontier
            self._wait_until(
                max(completions) if self.split_submit is not None else self.server.busy_until
            )
        self._account_network(sched.crossings, sched.comm_bytes)
        if self.tracer is not None:
            self.tracer.span(self.trace_track, "cut_uplink", t0, t0 + sched.radio_only_seconds,
                             bytes=sched.comm_bytes, crossings=sched.crossings)
            self.tracer.span(self.trace_track, "device_exec", t0, t0 + sched.device_seconds,
                             plan=self.split_plan.signature())
        self._split_output_local = list(sched.output_local)
        self._replay_outputs = outs
        self._replay_done_at = self.clock.t
        self._maybe_replan()

    def _maybe_replan(self) -> None:
        """Feed the live bandwidth to the adaptive re-planner; an adopted
        swap takes effect from the next inference (this inference's D2H
        locality is pinned by ``_split_output_local``)."""
        if self.replanner is None:
            return
        new_plan = self.replanner.observe(
            self.network.bandwidth_at(self.clock.t), self.clock.t
        )
        if new_plan is not None:
            self._install_plan(new_plan)

    def _fallback(self, call: InterceptedCall) -> Any:
        """Sequence deviation (DAM): ship the locally-answered prefix to the
        server for catch-up, revert to recording, re-search later."""
        self.fallbacks += 1
        self.mode = MODE_RECORDING
        # download + refresh the app-held carried-state handle from the live
        # stateful program first, while the binding that holds the state
        # (split suffix or whole program) is installed; then drop the stream
        # executor: infer_stream runs closed-loop until a new lock
        if self._carried_in_map:
            self._materialize_carried_prefix()
        self.pipelined_exec = None
        self._claim_stream_key(None)
        # a deviation at the first record of an inference leaves no partial
        # round: the previous one was replayed in full
        done = self._replay_prefix if self._replay_pos else []
        # the catch-up re-runs the round from its start, so it re-applies the
        # round's uploads first: the replay's env refresh may have put an
        # output in a buffer that held an input at the start of the round.
        # Uploads the server already received are re-applied, not re-sent.
        on_server = (CAT_H2D, CAT_D2H) if self._inputs_uploaded else (CAT_D2H,)
        shipped = [c for c in done if c.record.category not in on_server]
        if shipped:
            self._rpc(sum(c.record.payload_bytes for c in shipped), 32)
        catch_up = [c for c in done if c.record.category != CAT_D2H]
        for c in catch_up:
            self.server.exec_call(c, self.clock.t, self.client_id)
        self.logs.extend(c.record for c in catch_up)
        self.calls.extend(catch_up)
        self._replay_prefix = []
        self._replay_pos = 0
        self._h2d_seen = 0
        return self._record_call(call)

    def _carried_state_source(self) -> Any:
        """The binding that advanced the carried state last: the split
        suffix's when a split plan is active, else the whole program's."""
        ctx = self.server.context(self.client_id)
        split = ctx.split
        if self.split_plan is not None and split is not None and split.carried_state is not None:
            return split
        return ctx.replay

    def _materialize_carried_prefix(self) -> None:
        """Before a catch-up after a mid-round deviation, turn the carried
        placeholder uploads in the prefix into the real server-resident
        values (the app only ever held handles).  The download is a real RPC
        — this is the price of deviating from a stateful IOS."""
        bound = self._carried_state_source()
        # mid-round after this round's step already ran, the round's input is
        # the state that step started from; otherwise the current state
        step_ran = 0 < self._replay_pos and self._h2d_seen == len(self.ios.h2d_positions)
        state = bound.state_before_step if step_ran else bound.carried_state
        if state is None:
            return
        ordinal = 0
        for c in self._replay_prefix:
            if c.record.category != CAT_H2D:
                continue
            idx = self._carried_in_map.get(ordinal)
            ordinal += 1
            if idx is None:
                continue
            ph = self._carried_placeholders.get(idx)
            if not _is_handle(c.h2d_value, ph):
                continue  # the app supplied real state itself
            arr = host_copy(state[idx])
            # state download for catch-up
            self._rpc(64, arr.numel() * arr.element_size() + 64)
            c.h2d_value = arr
            if ph.shape == arr.shape:
                # the app keeps threading its handle through the
                # post-fallback recording rounds — give it the truth
                ph.copy_(arr)
            self._carried_placeholders[idx] = arr

    # -- the sink ------------------------------------------------------------
    def __call__(self, call: InterceptedCall) -> Any:
        if self.variant != "rrto" or self.mode == MODE_RECORDING:
            return self._record_call(call)
        return self._replay_call(call)
