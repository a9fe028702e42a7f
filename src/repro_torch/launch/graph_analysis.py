"""Cost and memory analysis of a traced aten graph (the counterpart of
``repro.launch.hlo_analysis``).

The reference parses a compiled HLO module and weights each computation by
its loop trip count, because a layer stack under ``lax.scan`` is one loop
body.  The port's step is traced with ``make_fx`` at the dispatcher, which
unrolls every layer, so each node runs once and no weighting is needed.
:func:`analyze_graph` walks the graph once and returns the reference's keys
where they have a meaning:

  * ``flops``, ``dot_flops``: ``core/costmodel.py::node_flops`` per node
    (exact for mm / bmm / addmm / convolution and the attention kernels,
    one flop an element otherwise), with :data:`KERNEL_FLOPS` for the
    custom ops that ``node_flops`` counts at one flop an element: each
    counts the products its function requires, as the reference's HLO
    counts its plain version;
  * ``hbm_bytes``: ``node_bytes`` (inputs read and outputs written once;
    views move nothing), ``transcendentals`` and ``n_nodes``;
  * ``launches``: the count of each ``repro_torch::*`` node, named as
    ``kernels/library.py::LAUNCHES`` names the kernels (one a wrapper call);
  * ``collective_bytes``, ``collective_bytes_by_kind``,
    ``collective_counts``: the output bytes of each traced collective.

:class:`StepMeter` counts the same totals (:class:`CostTotals`) op by op
as a step runs, which ``make_fx`` does not need (a step run on fake tensors
is metered about three times as fast as it is traced), and the liveness:
the peak of the bytes alive, the op where it occurs and the largest
buffers alive there.  The graph cannot say when a buffer dies: an eager
step holds many past their last use (autograd keeps a node's saved tensors
until its backward has run, and a Python variable, such as AdamW's
per-leaf temporaries or the list of every gradient, keeps its tensor until
it is rebound or the function returns), so a walk of the graph that frees
each buffer after its last reader reads up to 18% low on a training step.
The meter frees each buffer when the last tensor object on it dies, as the
card's caching allocator does.  Run inside ``make_fx``'s function
(:func:`metered`), it meters the trace in the same pass;
:func:`measure_step` runs a step under it without a trace.
"""
from __future__ import annotations

import contextlib
import math
import operator
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.costmodel import _TRANSCENDENTAL, node_bytes, node_flops

# repro_torch::<op> -> the kernel it launches (``kernels/library.py::KERNELS``)
KERNEL_OF = {
    "rmsnorm": "rmsnorm",
    "rmsnorm_backward": "rmsnorm_backward",
    "decode_attention": "decode_attention",
    "flash_attention": "flash_attention",
    "flash_attention_backward": "flash_attention_backward",
    "gated_scan": "ssm_scan",
    "gated_scan_backward": "ssm_scan_backward",
}

_DOT_OPS = {"mm", "bmm", "addmm", "baddbmm", "convolution", "decode_attention",
            "flash_attention"}

# traced collectives (torch.distributed's c10d and functional ops) by kind
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
}


def _scan_dims(x_shape, b_shape, chunk: int) -> Tuple[int, int, int, int, int, int, int]:
    b, s, h, p = x_shape
    n = b_shape[-1]
    q = min(chunk, s)
    return b, s, h, p, n, q, -(-s // q)


def scan_dot_flops(x_shape, b_shape, chunk: int, *, final_state: bool = True) -> float:
    """The products of the chunked scan (``repro/kernels/ssm_scan/ref.py``'s
    four einsums, 2 x output elements x contracted size each): the scores
    C B^T (Q x Q x N a chunk and head), the intra-chunk scores x (Q x Q x
    P), the chunk states B^T x and the carried states' contribution C h (Q
    x N x P each), over the chunks of the sequence.  At a single chunk the
    one chunk state is the final state, and the reference's XLA drops its
    product B^T x when nothing reads it: ``final_state`` False leaves it out
    (:func:`final_state_dots`; the C h product on a zero initial state it
    keeps)."""
    b, _, h, p, n, q, nc = _scan_dims(x_shape, b_shape, chunk)
    dots = 2.0 * b * nc * h * (q * q * n + q * q * p + 2 * q * n * p)
    return dots if final_state else dots - final_state_dots(x_shape, b_shape, chunk)


def final_state_dots(x_shape, b_shape, chunk: int) -> float:
    """B^T x of a single-chunk scan, the product only its final state needs
    (none beyond one chunk, where each chunk state feeds the next chunk)."""
    b, _, h, p, n, q, nc = _scan_dims(x_shape, b_shape, chunk)
    return 2.0 * b * h * q * n * p if nc == 1 else 0.0


def _scan_elementwise(x_shape, b_shape, chunk: int) -> float:
    # the (Q, Q) decay matrix of each chunk and head: difference, exp,
    # causal select and the two scalings of the scores
    b, _, h, _, _, q, nc = _scan_dims(x_shape, b_shape, chunk)
    return 5.0 * b * nc * h * q * q


def _flash_backward(args, outs) -> Tuple[float, float]:
    # (dout, q, k, v, out, causal, window, logit_cap, q_offset)
    (b, sq, hq, d), sk = args[1][0], args[2][0][1]
    # dS = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q (the forward's S = Q
    # K^T is recomputed by the kernel and counted with the forward)
    dots = 8.0 * b * hq * sq * sk * d
    return dots + 5.0 * b * hq * sq * sk, dots


def _rmsnorm_backward(args, outs) -> Tuple[float, float]:
    # (dy, x, scale, eps, offset): the plain backward's elementwise ops, its
    # two row means and dscale's column sum, 11 an element of x; no products
    return 11.0 * math.prod(args[1][0]), 0.0


def _gated_scan(args, outs) -> Tuple[float, float]:
    # (x, log_decay, in_scale, Bm, Cm, D, h0, chunk); the final state taken
    # as read (CostTotals defers that part until an op reads it)
    x, bm, chunk = args[0][0], args[3][0], args[7]
    dots = scan_dot_flops(x, bm, chunk)
    return dots + _scan_elementwise(x, bm, chunk), dots


def _gated_scan_backward(args, outs) -> Tuple[float, float]:
    # (dy, dh_final, x, log_decay, in_scale, Bm, Cm, D, h0, chunk): every
    # einsum of the forward has both operands on the gradient's path, so
    # the backward does two products of its size for each; at a single
    # chunk with no cotangent on the final state, none for B^T x
    x, bm, chunk = args[2][0], args[5][0], args[9]
    dots = 2.0 * scan_dot_flops(x, bm, chunk, final_state=args[1] is not None)
    return dots + 2.0 * _scan_elementwise(x, bm, chunk), dots


def _convolution_backward(args, outs) -> Tuple[float, float]:
    # (grad_output, input, weight, bias_sizes, stride, padding, dilation,
    # transposed, output_padding, groups, output_mask): the input's
    # gradient takes C_out / groups x the kernel's positions products an
    # input element, the weight's the batch x output positions an element
    (g_shape, _), (x_shape, _), (w_shape, _) = args[0], args[1], args[2]
    groups, mask = args[9], args[10]
    dots = 0.0
    if mask[0]:
        dots += 2.0 * math.prod(x_shape) * (w_shape[0] // groups) * math.prod(w_shape[2:])
    if mask[1]:
        dots += 2.0 * math.prod(w_shape) * math.prod(g_shape) / g_shape[1]
    return dots, dots


# op -> fn(its arguments, a tensor as its aval, output avals) -> (flops, dot
# flops): the four custom ops, and aten's convolution backward (which
# ``node_flops`` counts at one flop an element as well)
KERNEL_FLOPS: Dict[str, Callable[..., Tuple[float, float]]] = {
    "flash_attention_backward": _flash_backward,
    "rmsnorm_backward": _rmsnorm_backward,
    "gated_scan": _gated_scan,
    "gated_scan_backward": _gated_scan_backward,
    "convolution_backward": _convolution_backward,
}


def _tensors(val) -> List[torch.Tensor]:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (tuple, list)):
        return [t for v in val for t in _tensors(v)]
    return []


def _avals(vals) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    return [(tuple(t.shape), t.dtype) for t in vals]


def _op_parts(target) -> Tuple[str, str]:
    """(namespace, op name) of an aten / custom op overload."""
    name = getattr(target, "__name__", str(target))   # e.g. "mm.default"
    return getattr(target, "namespace", ""), name.split(".")[0]


def op_nodes(gm: torch.fx.GraphModule):
    """The graph's op nodes: every ``call_function`` but the tuple reads
    (``operator.getitem`` of a multi-output op)."""
    return [n for n in gm.graph.nodes
            if n.op == "call_function" and n.target is not operator.getitem]


class CostTotals:
    """:func:`analyze_graph`'s totals, added op by op: from a graph's nodes,
    or from the ops a dispatch mode sees as a step runs (``StepMeter``),
    which are the nodes ``make_fx`` would record, in the same order."""

    def __init__(self):
        self.flops = self.dot_flops = self.hbm = self.transc = 0.0
        self.n_ops = 0
        self.launches: Dict[str, int] = {}
        self.coll_bytes: Dict[str, float] = {}
        self.coll_counts: Dict[str, int] = {}
        # a single-chunk scan's final state (its storage) -> the products
        # that count once an op reads it (or the step returns it)
        self.pending: Dict[int, float] = {}
        self.in_backward = False   # set by the walker once the backward pass runs

    def read(self, keys) -> None:
        """The storages ``keys`` are read: their pending products count."""
        for key in keys:
            dots = self.pending.pop(key, 0.0)
            self.flops += dots
            self.dot_flops += dots

    def add(self, target, args, kwargs, outs: List[torch.Tensor]) -> None:
        """One op: ``target`` an aten or custom op overload, ``args`` and
        ``kwargs`` its arguments (tensors, real or fake, and constants),
        ``outs`` its output tensors."""
        self.n_ops += 1
        if self.pending:
            self.read([_storage_key(t) for t in _tensors(tree_leaves((args, kwargs)))])
        ns, base = _op_parts(target)
        if ns == "_c10d_functional" and base == "wait_tensor":
            return                       # the end of a functional collective
        if ns in ("c10d", "_c10d_functional") and base in _COLLECTIVE_KIND:
            kind = _COLLECTIVE_KIND[base]
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + sum(
                t.numel() * t.element_size() for t in outs)
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            return
        if ns == "repro_torch":
            kernel = KERNEL_OF[base]
            self.launches[kernel] = self.launches.get(kernel, 0) + 1
        ins = _tensors(tree_leaves((args, kwargs)))
        in_av, out_av = _avals(ins), _avals(outs)
        view = bool(getattr(target, "is_view", False))
        if base in KERNEL_FLOPS:
            avals = [(tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a for a in args]
            f, df = KERNEL_FLOPS[base](avals, out_av)
            if base == "gated_scan" and not self.in_backward:
                # a forward rematerialized in the backward keeps B^T x: the
                # reference's jax.checkpoint recomputes behind an
                # optimization barrier, which nothing is dropped across
                late = final_state_dots(avals[0][0], avals[3][0], args[7])
                if late:
                    self.pending[_storage_key(outs[1])] = late
                    f, df = f - late, df - late
        else:
            f = node_flops(f"{ns}.{base}.x", in_av, out_av, view)
            df = f if base in _DOT_OPS else 0.0
        self.flops += f
        self.dot_flops += df
        self.hbm += node_bytes(in_av, out_av, view)
        if base in _TRANSCENDENTAL:
            self.transc += sum(t.numel() for t in outs)

    def record(self) -> Dict[str, Any]:
        return {
            "flops": self.flops,
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm,
            "transcendentals": self.transc,
            "n_nodes": self.n_ops,
            "launches": dict(sorted(self.launches.items())),
            "collective_bytes": sum(self.coll_bytes.values()),
            "collective_bytes_by_kind": self.coll_bytes,
            "collective_counts": self.coll_counts,
        }


def _val(node: torch.fx.Node):
    return node.meta.get("val")


def analyze_graph(gm: torch.fx.GraphModule) -> Dict[str, Any]:
    totals = CostTotals()
    for node in op_nodes(gm):
        # the backward pass starts at the first op of a backward (a graph
        # records the ops in the order they ran)
        totals.in_backward |= _op_parts(node.target)[1].endswith("_backward")
        totals.add(node.target, torch.fx.node.map_arg(node.args, _val),
                   torch.fx.node.map_arg(node.kwargs, _val), _tensors(_val(node)))
    out = next(n for n in gm.graph.nodes if n.op == "output")
    totals.read([_storage_key(t) for t in
                 _tensors(tree_leaves(torch.fx.node.map_arg(out.args, _val)))])
    return totals.record()


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------

def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _storage_bytes(t: torch.Tensor) -> int:
    return int(t.untyped_storage().nbytes())


# the largest buffers a liveness record lists at its peak
TOP_BUFFERS = 10


def alias_bytes(gm: torch.fx.GraphModule) -> int:
    """Argument bytes the program updates in place: the storages of the
    placeholders that an in-place op (a schema that writes its input) or a
    ``copy_`` writes."""
    placeholder_keys = {}
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            for t in _tensors(n.meta.get("val")):
                placeholder_keys[_storage_key(t)] = _storage_bytes(t)
    written = set()
    for n in op_nodes(gm):
        schema = getattr(n.target, "_schema", None)
        if schema is None:
            continue
        for a, arg in zip(schema.arguments, n.args):
            if a.alias_info is not None and a.alias_info.is_write and isinstance(arg, torch.fx.Node):
                for t in _tensors(arg.meta.get("val")):
                    key = _storage_key(t)
                    if key in placeholder_keys:
                        written.add(key)
    return sum(placeholder_keys[k] for k in written)


def _writes(node: torch.fx.Node) -> bool:
    schema = getattr(node.target, "_schema", None)
    return schema is not None and any(
        a.alias_info is not None and a.alias_info.is_write for a in schema.arguments)


def needed_nodes(gm: torch.fx.GraphModule) -> set:
    """The nodes the program's result depends on: the output, every op that
    writes a tensor in place, and what they read, transitively (what
    survives dead-code elimination; a view nothing reads is dead)."""
    needed = set()
    for n in reversed(list(gm.graph.nodes)):
        if n.op == "output" or _writes(n) or any(u in needed for u in n.users):
            needed.add(n)
    return needed


_LIFT_AS = {torch.ops.aten.lift_fresh.default: torch.ops.aten.lift_fresh_copy.default}


class StepMeter(TorchDispatchMode):
    """What a step costs and holds, op by op as it runs (on fake tensors,
    or real ones): :class:`CostTotals` of every op, and the bytes of the
    storages alive, a storage born with the first op output on it and dead
    with the last tensor object that holds it (a view holds its base's)."""

    def __init__(self):
        super().__init__()
        self.cost = CostTotals()
        self.refs: Dict[int, int] = {}
        self.size: Dict[int, int] = {}
        # (storage, (bytes, op, shape, dtype)) at a birth, (storage, None) at
        # a death, in order: no tensor, which would hold its storage
        self.events: List[Tuple[int, Any]] = []
        self.live = self.peak = self.peak_at = 0
        self.peak_op = None

    def hold(self, t: torch.Tensor, maker: str) -> None:
        key = _storage_key(t)
        if key not in self.size:
            self.size[key] = _storage_bytes(t)
            self.refs[key] = 0
            self.events.append((key, (self.size[key], maker, list(t.shape),
                                      str(t.dtype).replace("torch.", ""))))
            self.live += self.size[key]
            if self.live > self.peak:
                self.peak, self.peak_op, self.peak_at = self.live, maker, len(self.events)
        self.refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        self.refs[key] -= 1
        if self.refs[key] == 0:
            self.live -= self.size.pop(key)
            del self.refs[key]
            self.events.append((key, None))
            self.cost.pending.pop(key, None)   # a final state no op read

    def peak_buffers(self) -> List[Dict[str, Any]]:
        """The ``TOP_BUFFERS`` largest buffers alive at the peak, replayed
        from the events up to it."""
        alive: Dict[int, Tuple[int, str, list, str]] = {}
        for key, born in self.events[:self.peak_at]:
            if born is None:
                del alive[key]
            else:
                alive[key] = born
        keys = sorted(alive, key=lambda k: -alive[k][0])[:TOP_BUFFERS]
        return [{"name": alive[k][1], "shape": alive[k][2], "dtype": alive[k][3],
                 "bytes": alive[k][0]} for k in keys]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:
            return out     # a query (a device, a value read out): no node in a trace
        # a trace records a constant's lift as a copy
        self.cost.in_backward = torch._C._current_graph_task_id() != -1
        self.cost.add(_LIFT_AS.get(func, func), args, kwargs, outs)
        for t in outs:
            self.hold(t, str(func))
        return out


@contextlib.contextmanager
def metered(args: tuple):
    """Within the block, a :class:`StepMeter` with ``args`` alive
    throughout; yields the record, filled when the block ends: ``cost``
    (:class:`CostTotals`) and ``liveness``, the peak of the bytes alive,
    the op whose output reached it, the argument bytes, the temp bytes
    above them and the ``TOP_BUFFERS`` largest buffers alive at the peak
    (the op that made each, shape, dtype, bytes).  Inside ``make_fx``'s
    function it sees the ops the trace records, on fake tensors that live
    as an eager step's do, so a trace is metered in the same pass.  A
    custom op is one op: what its kernel allocates inside is not seen."""
    meter = StepMeter()
    for t in _tensors(tree_leaves(args)):
        meter.hold(t, "argument")
    args_bytes = meter.live
    rec: Dict[str, Any] = {}
    with meter:
        yield rec
    meter.cost.read(list(meter.refs))   # the final states the step returns
    rec["cost"] = meter.cost.record()
    rec["liveness"] = dict(peak_bytes=meter.peak, peak_op=meter.peak_op,
                           argument_bytes=args_bytes, temp_bytes=meter.peak - args_bytes,
                           top_buffers=meter.peak_buffers())


def measure_step(fn: Callable, args: tuple) -> Dict[str, Any]:
    """:func:`metered` of ``fn(*args)`` run eagerly on ``args`` (fake
    tensors in their own fake mode, or real ones): buffers die when their
    last tensor object does, as the caching allocator frees them on the
    card."""
    leaves = _tensors(tree_leaves(args))
    # the step makes tensors of its own (positions, masks): fake ones in the
    # arguments' mode (real ones for real arguments)
    fake_mode = getattr(leaves[0], "fake_mode", None) or contextlib.nullcontext()
    with fake_mode, metered(args) as rec:
        out = fn(*args)    # held to the block's end: what the step returns counts as read
    del out
    return rec
