"""RRTO client/server engines — Alg. 3 (RRTO_on_Client) + Alg. 4
(RRTO_on_Server), driven by a simulated clock, network and energy meter.

The single-client, full-server part of ``repro.core.engine``.  The client is
a call sink for :class:`GraphInterceptor`.  In the recording phase it behaves
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

Values on the server are tensors on its device; values on the client (the
application's uploads and downloads) are CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.costmodel import DeviceSpec
from repro_torch.core.energy import (
    STATE_COMM,
    STATE_CONTROL,
    STATE_STANDBY,
    EnergyMeter,
)
from repro_torch.core.flatten import fill_args
from repro_torch.core.intercept import InterceptedCall
from repro_torch.core.netsim import NetworkModel
from repro_torch.core.opseq import detect_loop_carried, operator_sequence_search
from repro_torch.core.records import (
    CAT_D2H,
    CAT_H2D,
    FUNC_D2H,
    FUNC_H2D,
    InferenceSequence,
    OperatorRecord,
)

MODE_RECORDING = "recording"
MODE_REPLAYING = "replaying"

# fused-executable advantage of the replayed sequence over per-op dispatch
# (simulated-clock constants, as in the reference)
REPLAY_FUSION_FACTOR = 0.6
REPLAY_KERNELS_PER_FUSION = 6
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
    CUDA graph are later work."""

    def __init__(
        self,
        calls: List[InterceptedCall],
        *,
        carried_pairs: Tuple[Tuple[int, int], ...] = (),
    ):
        plan = replay_address_plan(calls)
        param_addrs = plan["param_addrs"]
        h2d_addrs = plan["h2d_addrs"]
        d2h_addrs = plan["d2h_addrs"]
        kernel_calls = plan["kernel_calls"]

        self.carried_pairs = tuple(
            (int(i), int(j)) for i, j in carried_pairs
        )
        carried_in = {i for i, _ in self.carried_pairs}
        carried_out = {j for _, j in self.carried_pairs}
        # h2d/d2h ordinals that still travel over the wire, in wire order
        self.wire_in = [
            i for i in range(len(h2d_addrs)) if i not in carried_in
        ]
        self.wire_out = [
            j for j in range(len(d2h_addrs)) if j not in carried_out
        ]

        def run_kernels(env: Dict[int, Any]) -> None:
            with torch.no_grad():
                for c in kernel_calls:
                    execute_call(c, env)

        def replay(params_flat, inputs_flat):
            env: Dict[int, Any] = dict(zip(param_addrs, params_flat))
            env.update(zip(h2d_addrs, inputs_flat))
            run_kernels(env)
            return [env[a] for a in d2h_addrs]

        def replay_step(params_flat, wire_inputs, carried_inputs):
            env: Dict[int, Any] = dict(zip(param_addrs, params_flat))
            for ordinal, v in zip(self.wire_in, wire_inputs):
                env[h2d_addrs[ordinal]] = v
            for (ordinal, _), v in zip(self.carried_pairs, carried_inputs):
                env[h2d_addrs[ordinal]] = v
            run_kernels(env)
            return (
                [env[d2h_addrs[j]] for j in self.wire_out],
                [env[d2h_addrs[j]] for _, j in self.carried_pairs],
            )

        self.fn = replay
        self.step_fn = replay_step if self.carried_pairs else None
        self.d2h_avals = [
            c.out_avals[0] for c in calls if c.record.func == FUNC_D2H
        ]
        self.n_kernels = len(kernel_calls)
        self.total_flops = plan["total_flops"]
        self.total_bytes = plan["total_bytes"]
        # the building client's own address plan, so its binding needn't
        # re-walk the calls it was just built from
        self.plan = plan

    @property
    def is_stateful(self) -> bool:
        return bool(self.carried_pairs)

    def compute_seconds(self, device: DeviceSpec) -> float:
        """Modeled one-shot execution time of the fused sequence."""
        return device.sequence_time(
            self.total_flops,
            self.total_bytes,
            num_kernels=max(1, self.n_kernels // REPLAY_KERNELS_PER_FUSION),
            fusion_factor=REPLAY_FUSION_FACTOR,
        )


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


@dataclasses.dataclass
class ClientContext:
    """The client's server-side state: device memory namespace + bound
    replay."""

    env: Dict[int, Any] = dataclasses.field(default_factory=dict)
    replay: Optional[BoundReplay] = None


class OffloadServer:
    """GPU-server side of one client: executes RPCs in recording mode, builds
    + replays the IOS in replaying mode.  ``device`` is where the server
    really computes; ``device_spec`` is the simulated server its clock
    accounts for.  With ``execute=False`` the server only accounts time and
    bytes: it computes nothing, and every download is zeros of its aval."""

    def __init__(
        self, device_spec: DeviceSpec, *, device: torch.device, execute: bool = True
    ):
        self.device_spec = device_spec
        self.device = device
        self.execute = execute
        self.ctx = ClientContext()
        self.busy_until = 0.0          # async kernel-queue completion time
        self.busy_seconds = 0.0        # accumulated compute (GPU-util proxy)

    def to_device(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device)

    # -- recording-phase execution (one call at a time) ---------------------
    def exec_call(self, call: InterceptedCall, arrival_t: float) -> Any:
        env = self.ctx.env
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
        carried_pairs: Tuple[Tuple[int, int], ...] = (),
    ) -> None:
        """Install a replay program; ``carried_pairs`` is the recording
        client's loop-carried-tensor detection."""
        program = ReplayProgram(calls, carried_pairs=carried_pairs)
        bound = BoundReplay.from_plan(program, program.plan)
        bound.seed_carried(self.ctx.env)
        self.ctx.replay = bound

    def replay_values(
        self,
        inputs: List[torch.Tensor],
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
        ctx = self.ctx
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
                raise RuntimeError("stateful replay has no seeded carried state")
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

    def occupy(self, compute_seconds: float, start_t: float) -> float:
        """Reserve the simulated GPU queue; returns the completion time."""
        begin = max(self.busy_until, start_t)
        self.busy_until = begin + compute_seconds
        self.busy_seconds += compute_seconds
        return self.busy_until

    def run_replay(
        self,
        inputs: List[torch.Tensor],
        start_t: float,
        fresh_carried: Optional[Dict[int, torch.Tensor]] = None,
    ) -> Tuple[List[torch.Tensor], float]:
        """Execute the IOS; returns (outputs, completion time)."""
        outs = self.replay_values(inputs, fresh_carried=fresh_carried)
        compute = self.ctx.replay.program.compute_seconds(self.device_spec)
        return outs, self.occupy(compute, start_t)


# ---------------------------------------------------------------------------
# client (Alg. 3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InferenceStats:
    """Per-client traffic counters."""

    rpcs: int = 0
    network_bytes: float = 0.0


class RRTOClient:
    """Call sink implementing Alg. 3.  Modes:

    * ``transparent`` (Cricket) — always record-phase behaviour, no search;
    * ``semi_rrto`` — Cricket + client-side caching of device-query RPCs;
    * ``rrto`` — full record/replay with Operator Sequence Search.
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
    ):
        if variant not in ("rrto", "semi_rrto", "transparent"):
            raise ValueError(variant)
        self.server = server
        self.network = network
        self.clock = clock
        self.meter = meter
        self.variant = variant
        self.min_repeats = min_repeats

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
        self.stats = InferenceStats()

    # -- helpers -------------------------------------------------------------
    @property
    def stateful_replay(self) -> bool:
        return bool(self._carried_in_map)

    def _account_network(self, rpcs: int, nbytes: float) -> None:
        self.stats.rpcs += rpcs
        self.stats.network_bytes += nbytes

    def _rpc(self, payload: float, response: float) -> None:
        dt = self.network.rpc_time(payload, response, self.clock.t)
        self.clock.advance(dt)
        self.meter.add(STATE_COMM, dt)
        self._account_network(1, payload + response)

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
            ret = self.server.exec_call(call, self.clock.t)
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
                self._try_identify_sequence()
        return ret

    def _seen_query(self, rec: OperatorRecord) -> bool:
        key = rec.identity()
        if key in self._query_cache:
            return True
        self._query_cache.add(key)
        return False

    def _try_identify_sequence(self) -> None:
        ios = operator_sequence_search(self.logs, self.min_repeats)
        if ios is None:
            return
        self.ios = ios
        self._ios_calls = list(
            self.calls[ios.start_index : ios.start_index + len(ios)]
        )
        # loop-carried tensors across the recorded repeats (KV caches and
        # the like)
        pairs = detect_loop_carried(self.calls, ios)
        ios.carried_pairs = pairs
        # recorded live payloads are only needed inside the detection horizon
        # (the last few repeats); for a stateful app every retained round
        # pins a full state tensor on the host, so drop the older ones
        horizon = ios.start_index - 2 * len(ios)
        for c in self.calls[: max(0, horizon)]:
            c.h2d_value = None
            c.d2h_value = None
        self.server.prepare_replay(self._ios_calls, carried_pairs=pairs)
        self._configure_carried(self.server.ctx.replay.program)
        self.mode = MODE_REPLAYING
        self._replay_pos = 0

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
        bound = self.server.ctx.replay
        env = self.server.ctx.env
        for idx, (_, j) in enumerate(program.carried_pairs):
            v = env.get(bound.d2h_addrs[j])
            if v is not None:
                # a writable host copy: after a DAM fallback the materializer
                # refreshes the app-held handle in place
                self._carried_placeholders[idx] = host_copy(v)

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
            self._inputs_uploaded = False

        self._replay_pos = (self._replay_pos + 1) % len(self.ios)
        self._replay_prefix.append(call)

        if rec.category == CAT_H2D:
            ordinal = self._h2d_seen
            self._h2d_seen += 1
            if ordinal in self._carried_in_map:
                # loop-carried state: the server already holds it.  The app
                # threading back the handle we gave it costs nothing; any
                # other value is genuinely new state and ships as override.
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
            else:
                # the only client->server RPC left: ship the raw input
                self._rpc(rec.payload_bytes, 32)
                self._inputs_uploaded = True
                self._replay_inputs.append(call.h2d_value)
            if self._h2d_seen == len(self.ios.h2d_positions):
                fresh = self._fresh_carried or None
                self._fresh_carried = {}
                outs, done_at = self.server.run_replay(
                    self._replay_inputs, self.clock.t, fresh_carried=fresh
                )
                self._replay_outputs = outs
                self._replay_done_at = done_at
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
            # wait for the one-shot execution to finish
            self._wait_until(self._replay_done_at)
            dt = (
                self.network._rtt_at(self.clock.t)
                + self.network.transfer_time(rec.response_bytes, self.clock.t)
            )
            self.clock.advance(dt)
            self.meter.add(STATE_COMM, dt)
            self._account_network(1, rec.payload_bytes + rec.response_bytes)
            return self._replay_outputs[self._wire_out_index.get(cursor, cursor)]

        # intermediate operator: answered from the recorded result, locally
        self._local()
        return expected.ret

    def _fallback(self, call: InterceptedCall) -> Any:
        """Sequence deviation (DAM): ship the locally-answered prefix to the
        server for catch-up, revert to recording, re-search later."""
        self.fallbacks += 1
        self.mode = MODE_RECORDING
        # download + refresh the app-held carried-state handle from the live
        # stateful program first
        if self._carried_in_map:
            self._materialize_carried_prefix()
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
            self.server.exec_call(c, self.clock.t)
        self.logs.extend(c.record for c in catch_up)
        self.calls.extend(catch_up)
        self._replay_prefix = []
        self._replay_pos = 0
        self._h2d_seen = 0
        return self._record_call(call)

    def _materialize_carried_prefix(self) -> None:
        """Before a catch-up after a mid-round deviation, turn the carried
        placeholder uploads in the prefix into the real server-resident
        values (the app only ever held handles).  The download is a real RPC
        — this is the price of deviating from a stateful IOS."""
        bound = self.server.ctx.replay
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
