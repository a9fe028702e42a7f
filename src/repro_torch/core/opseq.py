"""Operator Sequence Search — Alg. 1 (OperatorSequenceSearch) + Alg. 2
(FastCheck / FullCheck) from the RRTO paper, plus the data-dependency
validation of observation ③.

Three-level match strategy (Sec. III-B2):
  level 1 — candidate generation from memory-copy boundary markers (obs. ②):
            candidates end at the last DtoH sync-group in the log and start at
            an HtoD or immediately after a DtoH sync-group;
  level 2 — FastCheck: linear-time repetition counting over the compact
            category-tag string (obs. ①), pruning init-noise candidates;
  level 3 — FullCheck: cyclic-rotation realignment to HtoD/DtoH boundaries,
            data-dependency closure (obs. ③), then exact record-level
            repetition verification.

The search is hint-free: it sees nothing but the raw log.
"""
from __future__ import annotations

import hashlib
from typing import Iterator, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.core.records import (
    CAT_D2H,
    CAT_H2D,
    CAT_SYNC,
    FUNC_D2H,
    FUNC_H2D,
    InferenceSequence,
    OperatorRecord,
    canonical_address_map,
    category_trace,
)

DEFAULT_MIN_REPEATS = 3


def ios_fingerprint(records: Sequence[OperatorRecord]) -> str:
    """Content-address of an inference operator sequence.

    Structural hash over the category-tag string plus every record's
    address-canonicalized identity (primitive, params signature, shapes,
    dtypes, canonical buffer indices).  Two clients running the same model
    through their own interceptors/allocators produce the same fingerprint,
    which is what lets a multi-tenant edge server share one compiled replay
    executable — and the already-validated IOS itself — across them.
    """
    canon = canonical_address_map(records)
    payload = (
        category_trace(records),
        tuple(r.structural_identity(canon) for r in records),
    )
    return hashlib.sha256(repr(payload).encode()).hexdigest()


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two host tensors of the same shape and dtype.

    ``torch.equal`` compares values (``-0.0 == 0.0``, ``nan != nan``) and
    bf16 has no numpy dtype, so both payloads are compared as raw bytes: a
    loop-carried tensor is the *same bits* the application downloaded."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8),
    )


def detect_loop_carried(
    calls: Sequence,              # InterceptedCall list the IOS was found in
    ios: InferenceSequence,
    *,
    max_transitions: int = 2,
) -> Tuple[Tuple[int, int], ...]:
    """Detect loop-carried tensors across consecutive repeats of the IOS.

    A pair ``(h2d_ordinal, d2h_ordinal)`` means: the value the application
    uploads as its ``h2d_ordinal``-th input of round *k+1* is bitwise the
    value it downloaded as the ``d2h_ordinal``-th output of round *k* — the
    application is threading recurrent state (a KV cache, an RNN hidden
    state) through the offloading boundary.  Such state can stay resident on
    the server once the replay executable is compiled stateful (with the
    carried buffers donated), so it never crosses the network again and the
    per-round replay compute is the model's intrinsic step cost.

    Detection compares the recorded live payloads (``h2d_value`` uploads vs
    ``d2h_value`` downloads, both logged by the recording client per Alg. 3's
    ``(func, args, ret)`` triples) over up to ``max_transitions`` consecutive
    round boundaries ending at the identified sequence: a pair must hold at
    *every* available transition, which rejects coincidental one-off matches.
    Returns () when the log holds fewer than two full rounds (e.g. a
    cache-adopting client that recorded a single inference — it inherits the
    pairs from the cached program instead).
    """
    length = len(ios)
    start = ios.start_index
    transitions = min(max_transitions, start // length)

    def window(round_offset: int):
        lo = start - round_offset * length
        return calls[lo : lo + length]

    # only record-identical earlier windows are repeats of the IOS (a
    # cache-adopting client may have init noise right before its single
    # recorded round) — shrink the transition horizon to the verified repeats
    verified = 0
    for t in range(1, transitions + 1):
        if any(c.record != r for c, r in zip(window(t), ios.records)):
            break
        verified = t
    transitions = verified
    if transitions < 1:
        return ()

    def h2d_calls(win) -> List:
        return [c for c in win if c.record.func == FUNC_H2D]

    def d2h_calls(win) -> List:
        return [c for c in win if c.record.func == FUNC_D2H]

    pairs: List[Tuple[int, int]] = []
    claimed: Set[int] = set()
    cur_h2d = h2d_calls(window(0))
    for i, up in enumerate(cur_h2d):
        if up.h2d_value is None:
            continue
        for j, down in enumerate(d2h_calls(window(1))):
            if j in claimed or down.d2h_value is None:
                continue
            if not bits_equal(up.h2d_value, down.d2h_value):
                continue
            # confirm the pairing holds at every earlier transition too
            ok = True
            for t in range(1, transitions):
                u2 = h2d_calls(window(t))[i].h2d_value
                d2 = d2h_calls(window(t + 1))[j].d2h_value
                if u2 is None or d2 is None or not bits_equal(u2, d2):
                    ok = False
                    break
            if ok:
                pairs.append((i, j))
                claimed.add(j)
                break
    return tuple(pairs)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _sync_group_end(tags: str, idx: int) -> int:
    """A memory copy groups any immediately-following synchronization calls
    with it (paper: 'treating these copies as special memory transfer
    operations and grouping any following synchronization calls')."""
    j = idx
    n = len(tags)
    while j + 1 < n and tags[j + 1] == CAT_SYNC:
        j += 1
    return j


def _dataflow_violations(
    logs: Sequence[OperatorRecord], start: int, length: int, params_resident: bool
) -> Iterator[Tuple[int, int]]:
    end = start + length
    written_in_window: Set[int] = set()
    # buffers written anywhere in the window (any iteration-local intermediate
    # is written exactly once per iteration, hence inside any full window)
    window_writes: Set[int] = set()
    for r in logs[start:end]:
        window_writes.update(r.out_buffers)

    ever_written_before: Set[int] = set()
    if not params_resident:
        for r in logs[:start]:
            ever_written_before.update(r.out_buffers)

    for k, r in enumerate(logs[start:end]):
        for b in r.in_buffers:
            if b in written_in_window:
                continue  # (a) produced earlier within the window
            if b not in window_writes and (params_resident or b in ever_written_before):
                continue  # (b) parameter-like: read-only inside the window
            yield k, b
        written_in_window.update(r.out_buffers)


def dataflow_violations(
    logs: Sequence[OperatorRecord],
    start: int,
    length: int,
    *,
    params_resident: bool = False,
) -> List[Tuple[int, int]]:
    """Observation ③ as a *reporting* pass: every operand read inside the
    candidate window must come from (a) the raw input or a prior operator's
    output *within* the window, or (b) a parameter-like buffer — one that is
    never written inside the window (model weights, init-time cached
    constants).

    Returns every ``(window_index, buffer_address)`` read that satisfies
    neither — the use-before-def sites a cyclically-rotated window exhibits
    (it reads an intermediate near its start whose producing write sits
    *later* in the window).  The replay soundness verifier
    (``repro_torch.analysis``) reports these as ``RRTO101`` diagnostics; the
    Operator Sequence Search only needs the boolean
    (:func:`check_data_dependency`).

    ``params_resident=True`` lints a *standalone* window in replay
    semantics: a buffer never written inside the window is a resident
    parameter by the replay engine's convention, whether or not a preceding
    log region wrote it (the verifier sees only the locked IOS, not the
    recording noise before it)."""
    return list(_dataflow_violations(logs, start, length, params_resident))


def check_data_dependency(
    logs: Sequence[OperatorRecord], start: int, length: int
) -> bool:
    """Boolean form of :func:`dataflow_violations` (observation ③); stops
    at the first violation."""
    return next(_dataflow_violations(logs, start, length, False), None) is None


# ---------------------------------------------------------------------------
# Alg. 2 — FastCheck & FullCheck
# ---------------------------------------------------------------------------

def fast_check(tags: str, start: int, length: int, min_repeats: int) -> bool:
    """Count how many times the candidate's category string appears in
    consecutive earlier positions of the log (the previous inferences).
    Linear-time string compares on the compact tag string."""
    if length <= 0 or start + length > len(tags):
        return False
    candidate = tags[start : start + length]
    count, pos = 1, start
    while pos - length >= 0 and tags[pos - length : pos] == candidate:
        count += 1
        pos -= length
    return count >= min_repeats


def full_check(
    logs: Sequence[OperatorRecord],
    start: int,
    length: int,
    min_repeats: int,
    d2h_positions: Set[int],
    *,
    sync_group_ends: Optional[Set[int]] = None,
) -> bool:
    """Exhaustive verification of a realigned candidate:
       1. the window must terminate at a DtoH sync-group boundary;
       2. data-dependency closure (observation ③);
       3. exact record-level repetition across earlier log segments."""
    end = start + length - 1
    if end >= len(logs) or start < 0 or length <= 0:
        return False
    boundary_ok = end in d2h_positions or (
        sync_group_ends is not None and end in sync_group_ends
    )
    if not boundary_ok:
        return False
    if not check_data_dependency(logs, start, length):
        return False
    count, pos = 1, start
    while pos - length >= 0:
        if all(
            logs[start + t] == logs[pos - length + t] for t in range(length)
        ):
            count += 1
            pos -= length
        else:
            break
    return count >= min_repeats


# ---------------------------------------------------------------------------
# Alg. 1 — OperatorSequenceSearch
# ---------------------------------------------------------------------------

def operator_sequence_search(
    logs: Sequence[OperatorRecord],
    min_repeats: int = DEFAULT_MIN_REPEATS,
) -> Optional[InferenceSequence]:
    """Identify the per-inference operator sequence from a raw log, or return
    None when the log does not (yet) contain >= min_repeats full repetitions.
    """
    if not logs:
        return None
    tags = category_trace(logs)

    h2d_starts = [i for i, t in enumerate(tags) if t == CAT_H2D]
    d2h_marks = [i for i, t in enumerate(tags) if t == CAT_D2H]
    if not h2d_starts or not d2h_marks:
        return None
    d2h_set = set(d2h_marks)

    # the candidate end: the last DtoH in the log, extended over its sync group
    seq_end = _sync_group_end(tags, d2h_marks[-1])
    sync_group_ends = {_sync_group_end(tags, i) for i in d2h_marks}

    # candidate starts: every HtoD, and the position right after each DtoH
    # sync group (covers rotated phases, Fig. 5f)
    starts = sorted(
        set(h2d_starts)
        | {_sync_group_end(tags, i) + 1 for i in d2h_marks if _sync_group_end(tags, i) + 1 < len(tags)}
    )

    h2d_set = set(h2d_starts)
    # Iterate candidate starts from the LATEST (shortest candidate) first: a
    # candidate spanning k consecutive iterations is also periodic (the
    # merged-iterations failure of the naive approach, Fig. 5d), so the
    # minimal period — the latest start that survives both checks — is the
    # true inference sequence.
    for j in reversed(starts):
        length = seq_end - j + 1
        if length <= 0 or j > seq_end:
            continue
        # a sequence longer than 1/min_repeats of the log cannot repeat enough
        if length * min_repeats > len(logs):
            continue
        if not fast_check(tags, j, length, min_repeats):
            continue
        # realign a possibly-rotated candidate to a true HtoD start within one
        # period before j (Alg. 1 line 12); the data-dependency check inside
        # FullCheck rejects misaligned inner-HtoD starts.
        for k in sorted((k for k in h2d_set if j - length <= k <= j), reverse=True):
            if full_check(
                logs,
                k,
                length,
                min_repeats,
                d2h_set,
                sync_group_ends=sync_group_ends,
            ):
                return InferenceSequence(
                    records=tuple(logs[k : k + length]),
                    start_index=k,
                )
    return None


def candidate_sequences(
    logs: Sequence[OperatorRecord],
    max_candidates: int = 8,
    lengths: Optional[Set[int]] = None,
):
    """Yield boundary-aligned, dependency-closed candidate windows
    (shortest/latest first) *without* requiring repetition — the shared-cache
    adoption probe fingerprints each against the already-validated IOSes.

    A single-repetition log of a multi-input app admits several shifted
    windows that all pass the dependency closure (an input uploaded before
    the window start looks parameter-like), so the probe must consider every
    alignment, not just the first survivor — the cache membership test picks
    the right one, and a wrong adoption is still caught record-by-record in
    the replay phase.  ``lengths`` (when known) are the lengths of the IOSes
    the probe can match: a window of any other length has another category
    string, hence another fingerprint, and is skipped before its checks."""
    if not logs:
        return
    tags = category_trace(logs)
    h2d_starts = [i for i, t in enumerate(tags) if t == CAT_H2D]
    d2h_marks = [i for i, t in enumerate(tags) if t == CAT_D2H]
    if not h2d_starts or not d2h_marks:
        return
    d2h_set = set(d2h_marks)
    seq_end = _sync_group_end(tags, d2h_marks[-1])
    sync_group_ends = {_sync_group_end(tags, i) for i in d2h_marks}
    starts = sorted(
        set(h2d_starts)
        | {
            _sync_group_end(tags, i) + 1
            for i in d2h_marks
            if _sync_group_end(tags, i) + 1 < len(tags)
        }
    )
    h2d_set = set(h2d_starts)
    yielded = 0
    for j in reversed(starts):
        length = seq_end - j + 1
        if length <= 0 or j > seq_end or length > len(logs):
            continue
        if lengths is not None and length not in lengths:
            continue
        if not fast_check(tags, j, length, 1):
            continue
        for k in sorted(
            (k for k in h2d_set if j - length <= k <= j), reverse=True
        ):
            if full_check(
                logs, k, length, 1, d2h_set,
                sync_group_ends=sync_group_ends,
            ):
                yield InferenceSequence(
                    records=tuple(logs[k : k + length]), start_index=k
                )
                yielded += 1
                if yielded >= max_candidates:
                    return
                break  # next start: one alignment per candidate length
