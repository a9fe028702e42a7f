"""Pass 2 — donation/aliasing sanitizer (``RRTO2xx``).

Stateful replay hands the loop-carried buffers to the step program
(``ReplayProgram.step_fn`` and the split program's trailing server segment
alike): the step takes the carried state in and returns the advanced state,
which the server keeps in place of the old one.  That is the reference's
donation contract (``jax.jit(replay_step, donate_argnums=(2,))``): once the
step runs, the carried inputs are dead, and the counterpart of donating
them in place on the card is queued work.  A forged or corrupted
``carried_pairs`` spec breaks the contract in ways the engine surfaces only
as wrong outputs through a stale state, or a shape error deep in the step.

This pass proves the contract statically from the recorded calls and the
pair spec alone, using the same versioned dataflow the planner trusts
(:func:`repro_torch.partition.segments.tensor_versions`):

* ``RRTO202`` — the spec itself is malformed (ordinal out of range, a
  transfer ordinal claimed by two pairs);
* ``RRTO201`` — a donated carried input tensor id is *also* returned as a
  wire output: the host would read a buffer the donation just invalidated;
* ``RRTO203`` — the paired output's shape/dtype differs from the donated
  input buffer, so the state advance cannot reuse its memory;
* ``RRTO204`` — the paired output tensor was never produced by an in-window
  op: the "advanced state" the client threads forward is not advanced at
  all (a forged pair, or a download wired to the wrong ordinal).

Shapes and dtypes are compared as the port's avals (``(shape,
torch.dtype)``) against the host tensor's, never through numpy, which has
no bfloat16.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

from repro_torch.analysis.diagnostics import ERROR, Diagnostic
from repro_torch.core.records import FUNC_D2H, FUNC_H2D


def sanitize_donation(
    calls: Sequence[Any],
    carried_pairs: Sequence[Tuple[int, int]],
) -> List[Diagnostic]:
    """Check one ``(calls, carried_pairs)`` donation spec.  ``calls`` is the
    locked IOS window as :class:`~repro_torch.core.intercept.InterceptedCall`
    values (the verifier only touches ``record``, ``op``, ``in_operands``,
    ``out_addrs``, ``out_avals``, ``h2d_value``)."""
    pairs = [(int(i), int(j)) for i, j in carried_pairs]
    if not pairs:
        return []
    diags: List[Diagnostic] = []

    h2d = [c for c in calls if c.record.func == FUNC_H2D]
    d2h = [c for c in calls if c.record.func == FUNC_D2H]

    # -- RRTO202: spec well-formedness (gates the dataflow checks) ----------
    seen_in: set = set()
    seen_out: set = set()
    well_formed = True
    for i, j in pairs:
        for ordinal, n, kind, claimed in (
            (i, len(h2d), "H2D", seen_in),
            (j, len(d2h), "D2H", seen_out),
        ):
            if not 0 <= ordinal < n:
                diags.append(
                    Diagnostic(
                        "RRTO202",
                        ERROR,
                        f"carried pair ({i}, {j}): {kind} ordinal "
                        f"{ordinal} out of range for {n} transfers",
                        where={"pair": [i, j], "ordinal": ordinal},
                    )
                )
                well_formed = False
            elif ordinal in claimed:
                diags.append(
                    Diagnostic(
                        "RRTO202",
                        ERROR,
                        f"carried pair ({i}, {j}): {kind} ordinal "
                        f"{ordinal} claimed by two pairs — one donated "
                        "buffer cannot back two states",
                        where={"pair": [i, j], "ordinal": ordinal},
                    )
                )
                well_formed = False
            else:
                claimed.add(ordinal)
    if not well_formed:
        return diags

    from repro_torch.partition.segments import tensor_versions

    _, tensors, input_tids, output_tids = tensor_versions(
        calls, carried_input_ordinals=[i for i, _ in pairs]
    )
    carried_out_ordinals = {j for _, j in pairs}

    for i, j in pairs:
        in_tid = input_tids[i]
        out_tid = output_tids[j]

        # -- RRTO201: donated input handed back to the host -----------------
        for k, tid in enumerate(output_tids):
            if tid == in_tid and k not in carried_out_ordinals:
                diags.append(
                    Diagnostic(
                        "RRTO201",
                        ERROR,
                        f"carried pair ({i}, {j}): donated input tensor "
                        f"t{in_tid} is also wire output ordinal {k} — the "
                        "host would read a buffer the donation just "
                        "invalidated",
                        where={"pair": [i, j], "wire_out_ordinal": k,
                               "tid": in_tid},
                    )
                )

        # -- RRTO203: aval mismatch breaks in-place aliasing ----------------
        up, down = h2d[i], d2h[j]
        if up.h2d_value is not None and down.out_avals:
            in_shape, in_dtype = tuple(up.h2d_value.shape), up.h2d_value.dtype
            shape, dtype = down.out_avals[0]
            if in_shape != tuple(shape) or in_dtype != dtype:
                diags.append(
                    Diagnostic(
                        "RRTO203",
                        ERROR,
                        f"carried pair ({i}, {j}): donated buffer is "
                        f"{in_dtype}{list(in_shape)} but the paired output "
                        f"is {dtype}{list(shape)} — the state advance "
                        "cannot reuse the donated memory",
                        where={"pair": [i, j]},
                    )
                )

        # -- RRTO204: the "advanced" state was never produced ---------------
        if tensors[out_tid].producer < 0:
            diags.append(
                Diagnostic(
                    "RRTO204",
                    ERROR,
                    f"carried pair ({i}, {j}): paired D2H reads tensor "
                    f"t{out_tid} that no in-window op wrote — the carried "
                    "state never advances (forged pair or mis-wired "
                    "download)",
                    where={"pair": [i, j], "tid": out_tid},
                )
            )
    return diags
