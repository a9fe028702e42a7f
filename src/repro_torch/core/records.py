"""Operator records — the unit of the RRTO log.

The paper's transparent-offloading client intercepts CUDA-runtime calls and logs
``(func, args, ret)`` triples (Alg. 3, line 8).  In the JAX adaptation one
*operator record* is emitted per JAX equation; in this PyTorch port, one per
node of the traced aten graph (plus the framework-noise calls, memory
transfers and syncs that bracket them).  Records must be:

  * hashable & comparable — FullCheck does record-level one-to-one comparison;
  * category-taggable — FastCheck runs over a compact category string;
  * address-carrying — the data-dependency check (observation ③) walks buffer ids.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

# ---------------------------------------------------------------------------
# Categories (the "compact string of operator categories" used by FastCheck).
# Single characters so a category trace is a plain python string and candidate
# repetition counting is a linear scan / str compare.
# ---------------------------------------------------------------------------
CAT_H2D = "H"       # cudaMemcpyHtoD analogue — inference input upload
CAT_D2H = "D"       # cudaMemcpyDtoH analogue — inference output download
CAT_D2D = "d"       # device-to-device copy
CAT_KERNEL = "K"    # cudaLaunchKernel analogue — one aten graph node
CAT_QUERY = "q"     # cudaGetDevice / cudaGetLastError analogue (framework noise)
CAT_SYNC = "s"      # cudaStreamSynchronize analogue
CAT_MALLOC = "m"    # cudaMalloc analogue (arena growth)
CAT_MISC = "x"

# func names for the non-kernel records (kernels use "kernel:<aten op>").
FUNC_H2D = "cudaMemcpyHtoD"
FUNC_D2H = "cudaMemcpyDtoH"
FUNC_D2D = "cudaMemcpyDtoD"
FUNC_SYNC = "cudaStreamSynchronize"
FUNC_MALLOC = "cudaMalloc"
FUNC_GET_DEVICE = "cudaGetDevice"
FUNC_GET_LAST_ERROR = "cudaGetLastError"
FUNC_STREAM_IS_CAPTURING = "cudaStreamIsCapturing"

_FUNC_TO_CAT = {
    FUNC_H2D: CAT_H2D,
    FUNC_D2H: CAT_D2H,
    FUNC_D2D: CAT_D2D,
    FUNC_SYNC: CAT_SYNC,
    FUNC_MALLOC: CAT_MALLOC,
    FUNC_GET_DEVICE: CAT_QUERY,
    FUNC_GET_LAST_ERROR: CAT_QUERY,
    FUNC_STREAM_IS_CAPTURING: CAT_QUERY,
}


def category_of(func: str) -> str:
    if func.startswith("kernel:"):
        return CAT_KERNEL
    return _FUNC_TO_CAT.get(func, CAT_MISC)


def kernel_primitive(func: str) -> "str | None":
    """The aten op behind a ``kernel:<op>`` func (``str(op)``, as
    :attr:`~repro_torch.core.flatten.FlatNode.name` names it, e.g.
    ``aten.mm.default``), else None: how the replay soundness verifier
    screens an IOS for replay-unsafe operators without re-parsing the
    func-name convention at every call site."""
    if func.startswith("kernel:"):
        return func[len("kernel:"):]
    return None


@dataclasses.dataclass(frozen=True)
class OperatorRecord:
    """One intercepted call.

    ``args_sig`` is a hashable signature of everything the server needs to
    replay the call *except* live data: primitive params, operand buffer
    addresses, shapes and dtypes.  Two records are "the same operator" for
    FullCheck iff (func, args_sig) match — mirroring the byte-identical RPC
    payloads produced by a steady-state caching allocator in the paper.
    ``ret`` is what the client replayer hands back to the caller without any
    network round-trip during the replay phase ("mainly cudaSuccess").
    """

    func: str
    args_sig: Tuple
    ret: Any = "cudaSuccess"
    in_buffers: Tuple[int, ...] = ()
    out_buffers: Tuple[int, ...] = ()
    payload_bytes: int = 64          # RPC request size over the wire
    response_bytes: int = 32         # RPC response size over the wire
    flops: float = 0.0               # server-side compute cost of the call
    mem_bytes: float = 0.0           # server-side HBM traffic of the call

    @property
    def category(self) -> str:
        return category_of(self.func)

    def identity(self) -> Tuple[str, Tuple]:
        return (self.func, self.args_sig)

    def structural_identity(self, canon: "Dict[int, int]") -> Tuple:
        """Address-free identity for cross-client IOS fingerprinting.

        ``identity()`` embeds concrete device addresses, which are only stable
        within one client's allocator.  Two clients running the same model
        produce isomorphic logs whose addresses differ but whose *allocation
        pattern* matches; replacing each address with its index in ``canon``
        (first-appearance order over the sequence, see
        :func:`canonical_address_map`) yields an identity that is equal across
        such clients and still distinguishes different operator graphs.
        """
        known = set(self.in_buffers) | set(self.out_buffers)

        def canonize(x):
            if isinstance(x, tuple):
                return tuple(canonize(e) for e in x)
            if isinstance(x, int) and not isinstance(x, bool) and x in known:
                return ("b", canon[x])
            return x

        return (
            self.func,
            canonize(self.args_sig),
            tuple(canon[a] for a in self.in_buffers),
            tuple(canon[a] for a in self.out_buffers),
        )

    def __eq__(self, other: object) -> bool:  # record-level comparison
        if not isinstance(other, OperatorRecord):
            return NotImplemented
        return self.identity() == other.identity()

    def __hash__(self) -> int:
        return hash(self.identity())


def category_trace(logs) -> str:
    """Linearize a log into the compact category string used by FastCheck."""
    return "".join(r.category for r in logs)


def canonical_address_map(records: Sequence[OperatorRecord]) -> Dict[int, int]:
    """Number every buffer address in ``records`` by first appearance.

    The resulting map is the canonical frame for
    :meth:`OperatorRecord.structural_identity`: isomorphic sequences recorded
    by different clients (different allocator bases, same allocation pattern)
    map onto identical index sequences.
    """
    canon: Dict[int, int] = {}
    for r in records:
        for addr in (*r.in_buffers, *r.out_buffers):
            if addr not in canon:
                canon[addr] = len(canon)
    return canon


@dataclasses.dataclass
class InferenceSequence:
    """The identified inference operator sequence (IOS)."""

    records: Tuple[OperatorRecord, ...]
    start_index: int                 # where in the search log it was found
    # indices *within the sequence* of the boundary markers:
    h2d_positions: Tuple[int, ...] = ()
    d2h_positions: Tuple[int, ...] = ()
    # loop-carried tensor pairs across consecutive repeats of the sequence:
    # (h2d_ordinal, d2h_ordinal) means the h2d_ordinal-th upload of round k+1
    # carries the same buffer the d2h_ordinal-th download of round k produced
    # (e.g. a KV-cache pytree threaded through an autoregressive decode app).
    # Detected post-search by :func:`repro_torch.core.opseq.detect_loop_carried`.
    carried_pairs: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        if not self.h2d_positions:
            self.h2d_positions = tuple(
                i for i, r in enumerate(self.records) if r.category == CAT_H2D
            )
        if not self.d2h_positions:
            self.d2h_positions = tuple(
                i for i, r in enumerate(self.records) if r.category == CAT_D2H
            )

    def __len__(self) -> int:
        return len(self.records)

    @property
    def num_rpcs_replayed(self) -> int:
        """RPCs still required per inference in the replay phase.

        Only the memory transfers between host and device survive (paper
        Tab. IV: 11 = HtoD + DtoH + syncs grouped with them).  Loop-carried
        tensors stay server-resident once the replay executable is stateful,
        so their uploads/downloads are answered locally and drop out."""
        return (
            len(self.h2d_positions)
            + len(self.d2h_positions)
            - 2 * len(self.carried_pairs)
        )
