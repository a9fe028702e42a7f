"""Per-IOS operator census — the verifier report's quantitative half.

The soundness passes say whether an IOS is safe to replay; the census says
what replaying it *costs*: an aten-op histogram over the kernel stream,
analytic FLOP/HBM totals from the records' cost model, and wire-transfer
volumes.  The reference also merges trip-count-weighted totals from the
lowered HLO (its ``lax.scan`` bodies run once per layer but appear once in
the jaxpr); the port's aten graph has no loops to weight — the trace
unrolls every layer, so each node is already one record — and the census
has no ``hlo`` key.  ``cudaMemcpyDtoD`` records (contiguous clones) are
neither kernels nor wire transfers and are not counted here; the segment
graph counts them as ops (``n_kernels`` + DtoD records = ``graph.n_ops``).
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, Sequence

from repro_torch.core.records import (
    CAT_D2H,
    CAT_H2D,
    CAT_KERNEL,
    OperatorRecord,
    kernel_primitive,
)


def op_census(records: Sequence[OperatorRecord]) -> Dict[str, Any]:
    """Summarize one recorded IOS window.  Pure function of the records;
    JSON-safe output."""
    prims: Counter = Counter()
    flops = 0.0
    mem_bytes = 0.0
    n_kernels = 0
    n_h2d = n_d2h = 0
    h2d_bytes = d2h_bytes = 0.0
    for rec in records:
        if rec.category == CAT_KERNEL:
            n_kernels += 1
            flops += float(rec.flops)
            mem_bytes += float(rec.mem_bytes)
            prim = kernel_primitive(rec.func)
            prims[prim if prim is not None else rec.func] += 1
        elif rec.category == CAT_H2D:
            n_h2d += 1
            h2d_bytes += float(rec.args_sig[1])
        elif rec.category == CAT_D2H:
            n_d2h += 1
            d2h_bytes += float(rec.args_sig[1])
    return {
        "n_records": len(records),
        "n_kernels": n_kernels,
        "n_h2d": n_h2d,
        "n_d2h": n_d2h,
        "h2d_bytes": h2d_bytes,
        "d2h_bytes": d2h_bytes,
        "flops": flops,
        "mem_bytes": mem_bytes,
        "op_histogram": dict(sorted(
            prims.items(), key=lambda kv: (-kv[1], kv[0])
        )),
    }
