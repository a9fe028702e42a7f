"""Pass 1 — IOS dataflow linter (``RRTO1xx``).

SSA-style versioned def-use over a recorded :class:`InferenceSequence`
window.  The replay engine treats any buffer a kernel reads without an
in-window producer as a *parameter* (resident on both endpoints, bound at
replay entry — see ``repro_torch.core.engine.replay_address_plan``).  That
convention is sound only if the window is dependency-closed (observation ③):
a cyclically-rotated or hand-corrupted window reads an intermediate whose
producing write sits *later* in the window, and replay would silently bind a
stale "parameter" where the model expected this round's intermediate.

The linter re-runs the search's closure check
(:func:`repro_torch.core.opseq.dataflow_violations`) in *replay semantics*
(``params_resident=True``: a never-written read is a resident parameter, no
preceding log required) and adds the transfer-liveness, retention-horizon and
determinism screens the one-bit search check never needed.  A
``cudaMemcpyDtoD`` record (a contiguous clone) is held to the closure like
any other record, as in the reference.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.analysis.diagnostics import ERROR, WARNING, Diagnostic
from repro_torch.core.opseq import dataflow_violations
from repro_torch.core.records import (
    CAT_D2H,
    CAT_H2D,
    CAT_KERNEL,
    OperatorRecord,
    kernel_primitive,
)

# the aten ops that draw random numbers: PyTorch tags each
# ``torch.Tag.nondeterministic_seeded``.  The replay re-executes them, so a
# draw inside the window is not the recorded value: it diverges from the
# recording (and from the device-only run).  The set is every aten overload
# that carries the tag, read from the build's own schemas, so an op the
# build lacks is simply absent and a new random op is picked up.  The tag
# also marks scaled-dot-product attention, which draws only for its dropout
# and draws nothing at ``dropout_p`` 0 (the only value inference passes):
# an overload with a ``dropout_p`` argument is left out.


def _seeded_overloads() -> frozenset:
    out = set()
    for schema in torch._C._jit_get_all_schemas():
        if not schema.name.startswith("aten::"):
            continue
        if any(arg.name == "dropout_p" for arg in schema.arguments):
            continue
        packet = getattr(torch.ops.aten, schema.name[len("aten::"):], None)
        op = getattr(packet, schema.overload_name or "default", None)
        if op is not None and torch.Tag.nondeterministic_seeded in op.tags:
            out.add(str(op))
    return frozenset(out)


# ``kernel_primitive`` names: ``aten.rand.default``, ``aten.bernoulli.p``, ...
NONDETERMINISTIC_PRIMS = _seeded_overloads()


def lint_ios(
    records: Sequence[OperatorRecord],
    *,
    min_repeats: int = 3,
) -> List[Diagnostic]:
    """Lint one IOS window.  ``min_repeats`` sizes the retention-horizon
    check: loop-carried detection compares payloads across up to
    ``max_transitions + 1`` recorded rounds, all of which must still hold
    payloads when the search locks."""
    diags: List[Diagnostic] = []
    records = list(records)

    # -- use-before-def (RRTO101) / undefined D2H (RRTO103) -----------------
    for k, addr in dataflow_violations(
        records, 0, len(records), params_resident=True
    ):
        rec = records[k]
        if rec.category == CAT_D2H:
            diags.append(
                Diagnostic(
                    "RRTO103",
                    ERROR,
                    f"D2H at window index {k} downloads buffer {addr:#x} "
                    "before its in-window producer runs",
                    where={"index": k, "buffer": addr},
                )
            )
        else:
            diags.append(
                Diagnostic(
                    "RRTO101",
                    ERROR,
                    f"{rec.func} at window index {k} reads buffer "
                    f"{addr:#x} whose only producer runs later in the "
                    "window (rotated or corrupted IOS)",
                    where={"index": k, "buffer": addr},
                )
            )

    # -- dead H2D transfers (RRTO102) ---------------------------------------
    # an upload whose buffer version is overwritten (or the window ends)
    # before any kernel/D2H reads it moves bytes the replay never uses
    live_upload: Dict[int, int] = {}       # addr -> index of unread upload
    for k, rec in enumerate(records):
        for b in rec.in_buffers:
            live_upload.pop(b, None)
        if rec.category == CAT_H2D:
            addr = rec.out_buffers[0] if rec.out_buffers else None
            if addr is not None:
                if addr in live_upload:
                    diags.append(_dead_h2d(live_upload[addr], addr))
                live_upload[addr] = k
        elif rec.category == CAT_KERNEL:
            for b in rec.out_buffers:
                if b in live_upload:
                    diags.append(_dead_h2d(live_upload[b], b))
                    del live_upload[b]
    for addr, k in sorted(live_upload.items(), key=lambda kv: kv[1]):
        diags.append(_dead_h2d(k, addr))

    # -- payload-retention horizon (RRTO104) --------------------------------
    from repro_torch.core.engine import (
        PAYLOAD_RETENTION_CALLS,
        PAYLOAD_RETENTION_TRANSFERS,
    )

    rounds_needed = min_repeats + 1   # detect_loop_carried's widest window
    n_transfers = sum(
        1 for r in records if r.category in (CAT_H2D, CAT_D2H)
    )
    if rounds_needed * len(records) > PAYLOAD_RETENTION_CALLS:
        diags.append(
            Diagnostic(
                "RRTO104",
                WARNING,
                f"{rounds_needed} rounds of this {len(records)}-record IOS "
                f"exceed the {PAYLOAD_RETENTION_CALLS}-call payload "
                "horizon; loop-carried detection may see trimmed payloads",
                where={"ios_len": len(records), "rounds": rounds_needed},
            )
        )
    elif rounds_needed * n_transfers > PAYLOAD_RETENTION_TRANSFERS:
        diags.append(
            Diagnostic(
                "RRTO104",
                WARNING,
                f"{rounds_needed} rounds of {n_transfers} transfers exceed "
                f"the {PAYLOAD_RETENTION_TRANSFERS}-transfer payload "
                "horizon; loop-carried detection may see trimmed payloads",
                where={"n_transfers": n_transfers, "rounds": rounds_needed},
            )
        )

    # -- replay-unsafe operators (RRTO105) ----------------------------------
    for k, rec in enumerate(records):
        prim = kernel_primitive(rec.func)
        if prim in NONDETERMINISTIC_PRIMS:
            diags.append(
                Diagnostic(
                    "RRTO105",
                    WARNING,
                    f"nondeterministic primitive {prim!r} at window index "
                    f"{k}: replay re-executes it, entropy minted inside "
                    "the window diverges from the recording",
                    where={"index": k, "primitive": prim},
                )
            )
    return diags


def _dead_h2d(index: int, addr: int) -> Diagnostic:
    return Diagnostic(
        "RRTO102",
        WARNING,
        f"H2D at window index {index} uploads buffer {addr:#x} that no "
        "kernel or download ever reads before it dies — wasted uplink "
        "bytes every replayed inference",
        where={"index": index, "buffer": addr},
    )
