"""Trace an application to a flat aten operator stream.

The CUDA shim in the paper sees one ``cudaLaunchKernel`` per kernel.  The
reference gets its stream from ``jax.make_jaxpr`` and inlines call-like
equations (``repro/core/flatten.py``); here the stream is the aten graph
``make_fx`` traces at the dispatcher, which is already flat: one node per aten
op, and one per ``repro_torch::*`` custom op (a hand kernel is one operator,
as one ``pallas_call`` is one jaxpr equation).

The trace runs in fake-tensor mode: it computes nothing and launches no
kernel, and any read of a tensor's value in Python (``int(pos)``, ``.item()``,
a data-dependent branch) fails the trace instead of baking the value into the
graph.  Parameters are explicit placeholders; tensors the application
creates from Python data become ``get_attr`` constants, which join the
constvars so the session uploads them like parameters.
"""
from __future__ import annotations

import dataclasses
import itertools
import operator
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core.costmodel import Aval, node_bytes, node_flops

_counter = itertools.count()


class FlatVar:
    """A fresh SSA variable in the flattened program (identity-hashed).
    ``contiguous`` is the traced tensor's layout: the interceptor tells a
    device-to-device copy from a copy kernel by it."""

    __slots__ = ("aval", "contiguous", "uid")

    def __init__(self, aval: Aval, contiguous: bool):
        self.aval = aval
        self.contiguous = contiguous
        self.uid = next(_counter)

    def __repr__(self):
        return f"fv{self.uid}"


@dataclasses.dataclass(eq=False)   # identity-hashed, like FlatVar
class FlatNode:
    """One aten call.  ``args``/``kwargs`` hold the call's non-tensor
    arguments verbatim and a :class:`FlatVar` at every tensor position;
    ``invars`` lists those FlatVars in traversal order (see
    :func:`fill_args`)."""

    op: torch._ops.OpOverload
    args: tuple
    kwargs: dict
    invars: List[FlatVar]
    outvars: List[FlatVar]

    @property
    def name(self) -> str:
        return str(self.op)

    @property
    def is_view(self) -> bool:
        return bool(getattr(self.op, "is_view", False))

    @property
    def is_d2d(self) -> bool:
        """A clone of a contiguous tensor into the same layout: CUDA runs it
        as one ``cudaMemcpyAsync`` device to device.  Cloning a strided
        tensor (``.contiguous()``, a reshape of a permuted view) gathers
        through a copy kernel instead."""
        return (
            self.op is torch.ops.aten.clone.default
            and self.invars[0].contiguous
            and self.outvars[0].contiguous
        )


@dataclasses.dataclass
class FlatGraph:
    constvars: List[FlatVar]
    consts: List[torch.Tensor]
    invars: List[FlatVar]
    outvars: List[FlatVar]
    nodes: List[FlatNode]


def aval_of(t: torch.Tensor) -> Aval:
    return (tuple(int(s) for s in t.shape), t.dtype)


def _var(t: torch.Tensor) -> FlatVar:
    return FlatVar(aval_of(t), t.is_contiguous())


def _walk(x, fn):
    """Map ``fn`` over the leaves of nested tuples/lists/dicts, in order."""
    if isinstance(x, (list, tuple)):
        return type(x)(_walk(e, fn) for e in x)
    if isinstance(x, dict):
        return {k: _walk(v, fn) for k, v in x.items()}
    return fn(x)


def fill_args(template, values: Sequence[Any]):
    """Substitute ``values`` for the FlatVar slots of an argument template,
    in traversal order (the order ``FlatNode.invars`` lists them)."""
    it = iter(values)
    return _walk(template, lambda x: next(it) if isinstance(x, FlatVar) else x)


def template_vars(template) -> List[FlatVar]:
    """The FlatVar slots of an argument template, in traversal order."""
    found: List[FlatVar] = []
    _walk(template, lambda x: found.append(x) if isinstance(x, FlatVar) else None)
    return found


def trace_app(
    fn: Callable[..., Sequence[torch.Tensor]],
    param_leaves: Sequence[torch.Tensor],
    example_inputs: Sequence[torch.Tensor],
) -> FlatGraph:
    """Trace ``fn(param_leaves, *inputs) -> list of tensors`` to a FlatGraph
    whose first constvars are the parameter leaves, in order."""
    n_params = len(param_leaves)
    with torch.no_grad():
        gm = make_fx(
            lambda leaves, *inputs: list(fn(list(leaves), *inputs)),
            tracing_mode="fake",
        )(list(param_leaves), *example_inputs)

    env: Dict[torch.fx.Node, Any] = {}
    constvars: List[FlatVar] = []
    consts: List[torch.Tensor] = []
    invars: List[FlatVar] = []
    nodes: List[FlatNode] = []
    outvars: List[FlatVar] = []
    n_placeholders = 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            idx = n_placeholders
            n_placeholders += 1
            if idx < n_params:
                var = _var(param_leaves[idx])
                constvars.append(var)
                consts.append(param_leaves[idx])
            else:
                var = _var(example_inputs[idx - n_params])
                invars.append(var)
            env[node] = var
        elif node.op == "get_attr":
            value = getattr(gm, node.target)
            var = _var(value)
            constvars.append(var)
            consts.append(value)
            env[node] = var
        elif node.op == "call_function" and node.target is operator.getitem:
            seq, i = node.args
            env[node] = env[seq][i]
        elif node.op == "call_function":
            if not isinstance(node.target, torch._ops.OpOverload):
                raise TypeError(f"unsupported graph call {node.target!r}")
            ins: List[FlatVar] = []

            def read(x, ins=ins):
                if isinstance(x, torch.fx.Node):
                    ins.append(env[x])
                    return env[x]
                return x

            args = _walk(tuple(node.args), read)
            kwargs = _walk(dict(node.kwargs), read)
            val = node.meta["val"]
            if isinstance(val, torch.Tensor):
                outs = [_var(val)]
                env[node] = outs[0]
            elif isinstance(val, (list, tuple)) and all(
                isinstance(v, torch.Tensor) for v in val
            ):
                outs = [_var(v) for v in val]
                env[node] = outs
            else:
                raise TypeError(
                    f"{node.target} returns {type(val).__name__}, not tensors: a "
                    "traced app must keep its values on the device"
                )
            nodes.append(FlatNode(node.target, args, kwargs, ins, outs))
        elif node.op == "output":
            for x in torch.utils._pytree.tree_leaves(node.args[0]):
                if not isinstance(x, torch.fx.Node):
                    raise TypeError(f"app output {x!r} is not a tensor")
                outvars.append(env[x])
        else:
            raise TypeError(f"unsupported graph node {node.op}")
    return FlatGraph(constvars, consts, invars, outvars, nodes)


def graph_cost(graph: FlatGraph) -> Tuple[float, float]:
    """(flops, bytes) of one pass over the graph, from the cost model."""
    flops = bytes_ = 0.0
    for n in graph.nodes:
        ins = [v.aval for v in n.invars]
        outs = [v.aval for v in n.outvars]
        flops += node_flops(n.name, ins, outs, n.is_view)
        bytes_ += node_bytes(ins, outs, n.is_view)
    return flops, bytes_
