"""Logical -> physical sharding translation, and the mesh the sharded paths
run on (``repro.distributed.sharding`` over ``torch.distributed``).

Model code annotates parameters and activations with *logical* axes:
    "dp"  -- data parallel   (physical: ("data",) or ("pod", "data"))
    "tp"  -- tensor parallel (physical: ("model",))

``translate_spec`` rewrites a :class:`PartitionSpec` for a concrete mesh.

A :class:`Mesh` is axis names and sizes; built over an initialised process
group (``repro_torch.launch.mesh.make_live_mesh``) it also holds the
``DeviceMesh``, whose per-axis groups the collectives run on, and this rank's
coordinate on each axis (the reference's ``jax.lax.axis_index``).

Under a live mesh the port is SPMD, as inside the reference's ``shard_map``:
activations and caches are plain tensors holding this rank's block;
parameters are whole (plain tensors, the same on every rank) or DTensors,
and a layer takes its block of a parameter with :func:`local_block`.  So
the reference's ``maybe_shard`` (a layout constraint on a global
activation, for GSPMD) has no counterpart: a rank-local activation has
its layout already.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names.  A one-name tuple is kept as the bare name, so specs compare as
    the reference's do (``P(("a",)) == P("a")``, ``P(None) != P()``)."""

    def __new__(cls, *parts):
        return super().__new__(
            cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts)
        )

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def tree_map_specs(fn, tree):
    """``fn`` over every PartitionSpec leaf of a nested dict / tuple."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def _phys_axes(axis, mesh_axis_names) -> Any:
    if axis is None:
        return None
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    out = []
    for a in axes:
        if a == "dp":
            out.extend(n for n in ("pod", "data") if n in mesh_axis_names)
        elif a == "tp":
            if "model" in mesh_axis_names:
                out.append("model")
        elif a in mesh_axis_names:
            out.append(a)
    if not out:
        return None
    return out[0] if len(out) == 1 else tuple(out)


def translate_spec(spec: PartitionSpec, mesh_axis_names: Sequence[str]) -> PartitionSpec:
    return P(*(_phys_axes(a, mesh_axis_names) for a in spec))


def translate_tree(tree, mesh_axis_names: Sequence[str]):
    return tree_map_specs(lambda s: translate_spec(s, mesh_axis_names), tree)


def zero1_spec(spec: PartitionSpec, shape, dp_axis_size: int) -> PartitionSpec:
    """ZeRO-1-style optimizer-state spec: additionally shard the first
    dimension that is unsharded and divisible by the dp axis."""
    parts = list(spec)
    while len(parts) < len(shape):
        parts.append(None)
    for i, (axis, dim) in enumerate(zip(parts, shape)):
        if axis is None and dim % dp_axis_size == 0 and dim >= dp_axis_size:
            parts[i] = "dp"
            break
    return P(*parts)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; ``device_mesh`` is set on a live mesh (one
    built over a process group whose world size is the product of sizes)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device_mesh: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def live(self) -> bool:
        return self.device_mesh is not None

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    def _live(self):
        if not self.live:
            raise RuntimeError("a description mesh has no process group; build "
                               "one with repro_torch.launch.mesh.make_live_mesh")
        return self.device_mesh

    def group(self, axis: str):
        """The process group of ``axis``: the ranks that differ only there."""
        return self._live().get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
        return self._live().get_local_rank(axis)

    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(n for n in ("pod", "data") if n in self.axis_names)

    def dp_size(self) -> int:
        return math.prod(self.shape[n] for n in self.dp_axes())


_CURRENT: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None
)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the current mesh inside the ``with`` block."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``use_mesh``, or None outside one."""
    return _CURRENT.get()


def live_mesh() -> Optional[Mesh]:
    """The current mesh if it is live, else None."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.live else None


# ---------------------------------------------------------------------------
# layouts: DTensor placements and this rank's block
# ---------------------------------------------------------------------------

def _shard_axes(mesh: Mesh, spec: PartitionSpec) -> Dict[int, Tuple[str, ...]]:
    """Tensor dim -> the mesh axes it is split over, in split order."""
    out = {}
    for dim, entry in enumerate(translate_spec(spec, mesh.axis_names)):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [mesh.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: axes {axes} of dim {dim} are not in mesh order")
        out[dim] = axes
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A logical spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh axis: ``Shard(d)`` where tensor
        dim d is split over that axis, else ``Replicate()``.  A dim split
        over several axes is split over them in mesh order, as the
        reference's tuple of axes is."""
        from torch.distributed.tensor import Replicate, Shard

        by_axis = {a: d for d, axes in _shard_axes(self.mesh, self.spec).items() for a in axes}
        return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                     for a in self.mesh.axis_names)


def named_sharding(mesh: Mesh, spec: PartitionSpec) -> NamedSharding:
    return NamedSharding(mesh, translate_spec(spec, mesh.axis_names))


def named_sharding_tree(tree, mesh: Mesh):
    return tree_map_specs(lambda s: named_sharding(mesh, s), tree)


def block_of(x: torch.Tensor, mesh: Mesh, spec: PartitionSpec) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``, with no
    communication (every rank holds the same ``x``).  Each split dim must
    divide by its axes' sizes, as the reference's shardings require."""
    for dim, axes in _shard_axes(mesh, spec).items():
        n = math.prod(mesh.shape[a] for a in axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {axes}")
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + mesh.coordinate(a)
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """A DTensor of the whole tensor ``x`` (the same on every rank) laid out
    by ``sharding``: each rank keeps its block, with no communication."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    local = block_of(x, mesh, sharding.spec).contiguous()
    return DTensor.from_local(local, mesh._live(), sharding.placements, run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_block(x: torch.Tensor, mesh: Mesh, spec: PartitionSpec) -> torch.Tensor:
    """This rank's block of a parameter under ``spec`` (a ``shard_map``
    in_spec): a DTensor is redistributed to the layout first; a plain
    tensor is whole and is cut with :func:`block_of`."""
    if is_dtensor(x):
        sharding = named_sharding(mesh, spec)
        return x.redistribute(mesh._live(), sharding.placements).to_local()
    return block_of(x, mesh, spec)

