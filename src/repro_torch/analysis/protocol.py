"""Pass 4 — retry/dedup protocol checker (``RRTO4xx``).

The stateful-step wire protocol must be *at-most-once*: the stateful step
program advances server-resident carried state, so a
retransmitted request that re-executes corrupts the state for every
subsequent round.  The implementation
(:meth:`repro_torch.core.engine.RRTOClient._reliable_step` client-side,
:meth:`repro_torch.core.engine.OffloadServer.step_once` server-side) relies on a
per-client dedup table keyed by sequence number with a bounded eviction
window.

This pass model-checks that machine *exhaustively*: it enumerates every
per-attempt fate sequence (``lost_request`` / ``lost_response`` /
delivered) for every step of a :class:`ProtocolSpec` and walks the exact
server table semantics (execute-on-miss, reply-cache-on-hit, evict
``min(table)`` past the window) through the cross product, flagging any
path on which a step executes twice (``RRTO401``/``RRTO403``), a client is
answered with another step's reply (``RRTO404``), or a delivered "success"
corresponds to no execution at all (``RRTO402``).

The default spec mirrors the engine's shipped constants
(:data:`repro_torch.core.engine.DEDUP_WINDOW`,
:class:`repro_torch.core.netsim.RetryPolicy`), so CI proves the deployed
configuration sound, and the mutation corpus proves the checker sharp by
feeding it specs with reused seqnos / zero-width windows.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.diagnostics import ERROR, Diagnostic

LOST_REQUEST = "lost_request"
LOST_RESPONSE = "lost_response"
OK = "ok"

# exhaustive enumeration is exponential in failures-per-step; beyond this
# many consecutive losses the table state repeats (same seq re-sent), so
# deeper prefixes add no new reachable states
MAX_MODELED_FAILURES = 3


@dataclasses.dataclass(frozen=True)
class ProtocolSpec:
    """One configuration of the at-most-once machine to model-check.

    ``seq_of_step`` maps step index -> wire sequence number (``None`` =
    the unsequenced bypass path); the default is the engine's monotone
    counter.  ``preseed`` injects pre-existing dedup-table entries (e.g.
    replies surviving a server restart with a wiped executor) to check the
    table contents are trustworthy, not just the live protocol."""

    steps: int = 3
    dedup_window: int = 64
    max_attempts: int = 8
    seq_of_step: Optional[Tuple[Optional[int], ...]] = None
    preseed: Tuple[Tuple[int, Any], ...] = ()

    def seqs(self) -> Tuple[Optional[int], ...]:
        if self.seq_of_step is not None:
            if len(self.seq_of_step) != self.steps:
                raise ValueError(
                    f"seq_of_step has {len(self.seq_of_step)} entries for "
                    f"{self.steps} steps"
                )
            return tuple(self.seq_of_step)
        return tuple(range(self.steps))


def _fate_sequences(max_failures: int):
    """Every way one step's retry loop can reach a delivered reply: 0..N
    losses (each independently a lost request or a lost response) followed
    by one ``ok`` delivery.  All-loss paths end in ``RpcTimeoutError`` on
    the client — an *outage*, which aborts the remaining steps and can
    therefore violate nothing downstream."""
    for n in range(max_failures + 1):
        for losses in itertools.product((LOST_REQUEST, LOST_RESPONSE), repeat=n):
            yield losses + (OK,)


def check_protocol(spec: ProtocolSpec) -> List[Diagnostic]:
    """Exhaustively walk ``spec``'s state machine; returns one diagnostic
    per distinct ``(code, step)`` with the first offending fate trace."""
    seqs = spec.seqs()
    max_failures = min(spec.max_attempts, MAX_MODELED_FAILURES)
    fate_menu = list(_fate_sequences(max_failures))
    found: Dict[Tuple[str, int], Diagnostic] = {}

    def emit(code: str, step: int, message: str, trace, **where: Any) -> None:
        key = (code, step)
        if key not in found:
            found[key] = Diagnostic(
                code,
                ERROR,
                message,
                where={"step": step, "seq": seqs[step],
                       "fates": ["/".join(f) for f in trace], **where},
            )

    def walk(step: int, table: Dict[int, Any], trace: List[Tuple[str, ...]]):
        if step == spec.steps:
            return
        seq = seqs[step]
        for fates in fate_menu:
            t2 = dict(table)
            execs = 0
            evicted_own = False
            delivered = None
            for fate in fates:
                if fate == LOST_REQUEST:
                    continue           # the server never saw this attempt
                # delivered to the server: step_once semantics, verbatim
                if seq is None:
                    reply = ("exec", step)
                    execs += 1
                elif seq in t2:
                    reply = t2[seq]    # dedup hit: cached reply, no thunk
                else:
                    reply = ("exec", step)
                    execs += 1
                    t2[seq] = reply
                    while len(t2) > spec.dedup_window:
                        victim = min(t2)
                        del t2[victim]
                        if victim == seq:
                            evicted_own = True
                if fate == OK:
                    delivered = reply
            step_trace = trace + [fates]

            if execs > 1:
                if seq is None:
                    emit(
                        "RRTO401", step,
                        f"step {step} has no sequence number: a lost "
                        f"response re-executes it ({execs}× on this path) "
                        "and the donated carried state advances twice",
                        step_trace, executions=execs,
                    )
                elif evicted_own:
                    emit(
                        "RRTO403", step,
                        f"dedup window {spec.dedup_window} evicts step "
                        f"{step}'s seq {seq} while its retry is still in "
                        f"flight — the retry re-executes ({execs}× on this "
                        "path)",
                        step_trace, executions=execs,
                        dedup_window=spec.dedup_window,
                    )
                else:
                    emit(
                        "RRTO401", step,
                        f"step {step} (seq {seq}) executes {execs}× on a "
                        "single fate path — at-most-once violated",
                        step_trace, executions=execs,
                    )

            assert delivered is not None   # every enumerated path ends OK
            kind, origin = delivered[0], delivered[1]
            if kind == "exec" and origin != step:
                emit(
                    "RRTO404", step,
                    f"step {step} reuses seq {seq}: the dedup table answers "
                    f"it with step {origin}'s cached reply — the step never "
                    "runs yet the client sees success",
                    step_trace, stale_step=origin,
                )
            elif kind != "exec":
                emit(
                    "RRTO402", step,
                    f"step {step} (seq {seq}) is acknowledged with a table "
                    f"entry {delivered!r} that no execution produced — the "
                    "client proceeds on a completion that never happened",
                    step_trace,
                )

            walk(step + 1, t2, step_trace)

    walk(0, {int(s): ("preseed", v) for s, v in spec.preseed}, [])
    return list(found.values())


def check_engine_protocol() -> List[Diagnostic]:
    """Model-check the protocol *as shipped*: the engine's dedup window and
    the default retry budget, monotone sequence numbers."""
    from repro_torch.core.engine import DEDUP_WINDOW
    from repro_torch.core.netsim import RetryPolicy

    spec = ProtocolSpec(
        dedup_window=DEDUP_WINDOW,
        max_attempts=RetryPolicy().max_attempts,
    )
    return check_protocol(spec)


def check_sequencing(seqs: Sequence[Optional[int]]) -> List[Diagnostic]:
    """Static screen over an observed/recorded per-step seqno assignment
    (e.g. a crash-recovery step log): stateful steps must carry distinct,
    monotonically increasing sequence numbers."""
    diags: List[Diagnostic] = []
    seen: Dict[int, int] = {}
    prev: Optional[int] = None
    for step, seq in enumerate(seqs):
        if seq is None:
            diags.append(
                Diagnostic(
                    "RRTO401",
                    ERROR,
                    f"step {step} carries no sequence number — its retries "
                    "bypass dedup and can re-execute",
                    where={"step": step},
                )
            )
            continue
        if seq in seen:
            diags.append(
                Diagnostic(
                    "RRTO404",
                    ERROR,
                    f"steps {seen[seq]} and {step} share seq {seq}: a retry "
                    f"of step {step} is answered with step {seen[seq]}'s "
                    "cached reply",
                    where={"step": step, "seq": seq,
                           "first_step": seen[seq]},
                )
            )
            continue
        if prev is not None and seq < prev:
            diags.append(
                Diagnostic(
                    "RRTO403",
                    ERROR,
                    f"step {step} regresses to seq {seq} after {prev}: the "
                    "dedup window evicts in seqno order, so a regressed "
                    "seqno may already be outside the window",
                    where={"step": step, "seq": seq, "prev": prev},
                )
            )
        seen[seq] = step
        prev = seq
    return diags
