"""System-layer interception — the analogue of the paper's LD_PRELOAD shim.

A :class:`GraphInterceptor` walks a traced app's :class:`FlatGraph` node by
node, the way the CUDA shim sees one ``cudaLaunchKernel`` per operator, and
emits :class:`InterceptedCall`s to a pluggable sink (the offload client,
Alg. 3).  It walks the graph exactly as the reference's
``JaxprInterceptor.run`` walks a jaxpr:

* **Deterministic buffer addresses.**  PyTorch's caching allocator hands the
  same addresses to the same allocation pattern in steady state — that is why
  record-level log comparison works at all.  :class:`BufferArena` reproduces
  this: exact-size LIFO free lists + refcount frees at each operand's last
  use.  Steady-state iterations emit byte-identical records (a record's
  signature is built from the op name, non-tensor arguments, addresses,
  shapes and dtypes — never from ``data_ptr`` or ``id``).

* **Framework noise.**  90.6 % of Cricket's RPCs are ``cudaGetDevice`` /
  ``cudaGetLastError`` (Tab. III).  :class:`FrameworkNoiseModel` replays that
  per-kernel query pattern with Bresenham-distributed extras.

* **Boundary markers.**  Inference inputs/outputs are emitted as
  ``cudaMemcpyHtoD`` / ``cudaMemcpyDtoH`` records, each followed by a
  ``cudaStreamSynchronize`` — the sync-grouped markers of observation ②.

* **Device-to-device copies.**  A clone of a contiguous tensor into the same
  layout is a ``cudaMemcpyDtoD`` record (KAPAO's 9 staging copies of
  Tab. III): no framework noise precedes it and it takes no kernel index,
  but the server still executes it.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.core.costmodel import Aval, aval_nbytes, node_bytes, node_flops
from repro_torch.core.flatten import FlatGraph, FlatNode, FlatVar
from repro_torch.core.records import (
    FUNC_D2D,
    FUNC_D2H,
    FUNC_GET_DEVICE,
    FUNC_GET_LAST_ERROR,
    FUNC_H2D,
    FUNC_MALLOC,
    FUNC_SYNC,
    OperatorRecord,
)

# ---------------------------------------------------------------------------
# deterministic caching allocator
# ---------------------------------------------------------------------------

_ALIGN = 256


class BufferArena:
    """Exact-size-class caching allocator with lowest-address reuse (CUDA
    caching-allocator behaviour: freed blocks are immediately reusable and the
    same allocation pattern yields the same addresses).  Min-address policy
    makes the steady state *stationary*: once an iteration starts from a given
    free set and triggers no new arena growth, every subsequent identical
    iteration allocates the identical address sequence."""

    def __init__(self, base: int = 0x7F0000000000):
        self._cursor = base
        self._free: Dict[int, List[int]] = {}   # size -> min-heap of addrs
        self._size_of: Dict[int, int] = {}

    def alloc(self, nbytes: int) -> int:
        nbytes = max(_ALIGN, (nbytes + _ALIGN - 1) // _ALIGN * _ALIGN)
        bucket = self._free.get(nbytes)
        if bucket:
            return heapq.heappop(bucket)
        addr = self._cursor
        self._cursor += nbytes
        self._size_of[addr] = nbytes
        return addr

    def free(self, addr: int) -> None:
        heapq.heappush(self._free.setdefault(self._size_of[addr], []), addr)


# ---------------------------------------------------------------------------
# framework noise
# ---------------------------------------------------------------------------

def _bresenham_count(index: int, rate: float) -> int:
    """Deterministic per-index integer counts averaging ``rate``."""
    return int((index + 1) * rate) - int(index * rate)


@dataclasses.dataclass(frozen=True)
class FrameworkNoiseModel:
    """Per-kernel query chatter of the ML framework (PyTorch defaults are
    calibrated to Tab. III loop-stage composition: 4735 cudaGetDevice and
    607 cudaGetLastError per 522 cudaLaunchKernel)."""

    get_device_rate: float = 4735.0 / 522.0
    get_last_error_rate: float = 607.0 / 522.0

    def queries_for(self, kernel_index: int) -> List[str]:
        out: List[str] = []
        out += [FUNC_GET_DEVICE] * _bresenham_count(kernel_index, self.get_device_rate)
        out += [FUNC_GET_LAST_ERROR] * _bresenham_count(
            kernel_index, self.get_last_error_rate
        )
        return out


NO_NOISE = FrameworkNoiseModel(get_device_rate=0.0, get_last_error_rate=0.0)


# ---------------------------------------------------------------------------
# intercepted calls
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InterceptedCall:
    """One call crossing the (virtual) CUDA-runtime boundary.

    ``record`` is what the RRTO recorder logs; the remaining fields are the
    server-side payload (the full arguments the server received over RPC)
    that the server replayer uses to re-execute the call (Alg. 4 line 10):
    the aten op, its argument template (a :class:`FlatVar` at each tensor
    position), and the device address of each tensor operand in template
    order."""

    record: OperatorRecord
    op: Optional[torch._ops.OpOverload] = None
    args: tuple = ()
    kwargs: Optional[dict] = None
    in_operands: Tuple[Tuple[str, int], ...] = ()     # ("a", addr) per tensor
    out_addrs: Tuple[int, ...] = ()
    out_avals: Tuple[Aval, ...] = ()
    h2d_value: Any = None            # live host payload of an HtoD transfer
    # live host payload of a DtoH transfer, filled in by the recording client
    # (the paper's Alg. 3 logs the full (func, args, ret) triple) — this is
    # what lets the loop-carried-tensor detection compare round k's downloads
    # against round k+1's uploads
    d2h_value: Any = None


CallSink = Callable[[InterceptedCall], Any]


def _freeze(x):
    """Hashable signature of a call's non-tensor arguments (a tensor slot
    signs as "T"; dtypes, devices and layouts by their names)."""
    if isinstance(x, FlatVar):
        return "T"
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(e) for e in x)
    if isinstance(x, dict):
        return tuple((k, _freeze(x[k])) for k in sorted(x))
    if isinstance(x, (bool, int, float, str, type(None))):
        return x
    return str(x)


def _host_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# the interceptor
# ---------------------------------------------------------------------------

class GraphInterceptor:
    """Executes an app one operator at a time through a call sink, emitting
    the record stream a transparent-offloading shim would observe."""

    def __init__(
        self,
        sink: CallSink,
        noise: Optional[FrameworkNoiseModel] = None,
        input_wire_divisor: float = 1.0,
    ):
        self.sink = sink
        self.noise = noise if noise is not None else FrameworkNoiseModel()
        self.arena = BufferArena()
        # wire-format divisor of inference inputs (a JPEG camera frame);
        # parameters always travel raw
        self.input_wire_divisor = input_wire_divisor
        self._sigs: Dict[FlatNode, tuple] = {}   # per-node static record parts

    # -- persistent (parameter) uploads ------------------------------------
    def upload_params(self, leaves: Sequence[torch.Tensor]) -> List[int]:
        """Model-load phase: malloc + HtoD for every parameter leaf."""
        addrs = []
        for leaf in leaves:
            nbytes = _host_nbytes(leaf)
            addr = self.arena.alloc(nbytes)
            self.sink(
                InterceptedCall(
                    OperatorRecord(
                        FUNC_MALLOC, (nbytes,), out_buffers=(), payload_bytes=64
                    )
                )
            )
            self.sink(
                InterceptedCall(
                    OperatorRecord(
                        FUNC_H2D,
                        (addr, nbytes),
                        in_buffers=(),
                        out_buffers=(addr,),
                        payload_bytes=nbytes + 64,
                    ),
                    out_addrs=(addr,),
                    h2d_value=leaf,
                )
            )
            addrs.append(addr)
        return addrs

    def _static_sig(self, node: FlatNode) -> tuple:
        """(func, name, frozen args, out avals, flops, bytes) of a node — the
        parts of its record that do not depend on addresses, computed once.
        A clone of a contiguous tensor into the same layout is a
        ``cudaMemcpyDtoD`` (:attr:`FlatNode.is_d2d`); every other node is a
        ``kernel:<op>``."""
        sig = self._sigs.get(node)
        if sig is None:
            ins = [v.aval for v in node.invars]
            outs = tuple(v.aval for v in node.outvars)
            sig = (
                FUNC_D2D if node.is_d2d else f"kernel:{node.name}",
                node.name,
                (_freeze(node.args), _freeze(node.kwargs)),
                outs,
                node_flops(node.name, ins, outs, node.is_view),
                node_bytes(ins, outs, node.is_view),
            )
            self._sigs[node] = sig
        return sig

    # -- one inference ------------------------------------------------------
    def run(
        self,
        graph: FlatGraph,
        param_addrs: Sequence[int],
        inputs: Sequence[torch.Tensor],
        *,
        resident_inputs: Optional[Dict[int, int]] = None,
        resident_outputs: bool = False,
    ) -> Any:
        """Walk the graph: HtoD the inputs, launch each node as a kernel RPC
        (preceded by framework noise) or a DtoD copy (no noise), DtoH every
        output.  Returns the values the application receives (whatever the
        sink returned for the DtoH calls).

        ``resident_inputs`` maps invar index -> device address for operands
        already resident on the server (the outputs of an initialization
        graph): no HtoD is emitted for them and they are never freed.
        ``resident_outputs=True`` is for such a graph: no DtoH is emitted,
        the output buffers stay allocated, and their addresses are returned
        in place of the results."""
        resident_inputs = resident_inputs or {}
        if len(param_addrs) != len(graph.constvars):
            raise ValueError(
                f"{len(param_addrs)} param addrs for {len(graph.constvars)} constvars"
            )

        kernel_index = 0  # per-inference: the framework's query chatter is a
        # deterministic function of the op position within the model
        addr_of: Dict[FlatVar, int] = dict(zip(graph.constvars, param_addrs))
        freed: Set[int] = set()
        persistent_addrs = set(param_addrs) | set(resident_inputs.values())

        def alloc(nbytes: int) -> int:
            addr = self.arena.alloc(nbytes)
            freed.discard(addr)  # re-allocated: eligible for freeing again
            return addr

        def maybe_free(addr: int) -> None:
            if addr not in freed and addr not in persistent_addrs:
                freed.add(addr)
                self.arena.free(addr)

        # last-use analysis for refcount frees
        last_use: Dict[FlatVar, int] = {}
        for i, node in enumerate(graph.nodes):
            for v in node.invars:
                last_use[v] = i
        outvar_set = set(graph.outvars)

        # ---- inference start: upload inputs (observation ② start marker)
        for idx, (var, value) in enumerate(zip(graph.invars, inputs)):
            if idx in resident_inputs:
                addr_of[var] = resident_inputs[idx]
                continue
            nbytes = _host_nbytes(value)
            addr = alloc(nbytes)
            addr_of[var] = addr
            wire = int(nbytes / self.input_wire_divisor)
            self.sink(
                InterceptedCall(
                    OperatorRecord(
                        FUNC_H2D,
                        (addr, nbytes),
                        in_buffers=(),
                        out_buffers=(addr,),
                        payload_bytes=wire + 64,
                    ),
                    out_addrs=(addr,),
                    h2d_value=value,
                )
            )
            self.sink(InterceptedCall(OperatorRecord(FUNC_SYNC, ())))

        # ---- the operator stream
        for i, node in enumerate(graph.nodes):
            func, name, arg_sig, out_avals, flops, mem_bytes = self._static_sig(node)
            in_addrs = tuple(addr_of[v] for v in node.invars)
            out_addrs = tuple(alloc(aval_nbytes(a)) for a in out_avals)
            for v, addr in zip(node.outvars, out_addrs):
                addr_of[v] = addr

            if func != FUNC_D2D:
                for q in self.noise.queries_for(kernel_index):
                    self.sink(InterceptedCall(OperatorRecord(q, ())))
                kernel_index += 1

            # a DtoD keeps its op and arguments: the server still executes it
            self.sink(
                InterceptedCall(
                    OperatorRecord(
                        func,
                        (name, arg_sig, in_addrs, out_addrs, out_avals),
                        in_buffers=in_addrs,
                        out_buffers=out_addrs,
                        payload_bytes=512,
                        flops=flops,
                        mem_bytes=mem_bytes,
                    ),
                    op=node.op,
                    args=node.args,
                    kwargs=node.kwargs,
                    in_operands=tuple(("a", a) for a in in_addrs),
                    out_addrs=out_addrs,
                    out_avals=out_avals,
                )
            )

            # refcount frees: operands at their last use, dead outputs now
            for v in node.invars:
                if last_use.get(v) == i and v not in outvar_set:
                    maybe_free(addr_of[v])
            for v in node.outvars:
                if v not in last_use and v not in outvar_set:
                    maybe_free(addr_of[v])

        # ---- inference end: download outputs (observation ② end marker)
        results: List[Any] = []
        for var in () if resident_outputs else graph.outvars:
            addr = addr_of[var]
            nbytes = aval_nbytes(var.aval)
            ret = self.sink(
                InterceptedCall(
                    OperatorRecord(
                        FUNC_D2H,
                        (addr, nbytes),
                        in_buffers=(addr,),
                        out_buffers=(),
                        payload_bytes=64,
                        response_bytes=nbytes + 64,
                    ),
                    in_operands=(("a", addr),),
                    out_avals=(var.aval,),
                )
            )
            self.sink(InterceptedCall(OperatorRecord(FUNC_SYNC, ())))
            results.append(ret)

        # free everything inference-local so the next run reuses addresses
        out_addrs = [addr_of[var] for var in graph.outvars]
        if not resident_outputs:
            for addr in out_addrs:
                maybe_free(addr)
        for var in graph.invars:
            maybe_free(addr_of[var])
        return out_addrs if resident_outputs else results
