"""Pass 3 — split-plan & cache-key verifier (``RRTO3xx``).

A :class:`~repro_torch.partition.segments.SplitPlan` is only executable
against the :class:`~repro_torch.partition.segments.SegmentGraph` it was
planned for: same op count, carried-feasible shape, and a dataflow in which
every cut-crossing tensor is producible before the segment that reads it.
The planner emits such plans by construction — but plans also arrive from
cache keys persisted across restarts and from forged or deserialized
signatures.  This pass proves the plan/graph contract once, statically,
instead of trusting the producer.

The port's graph counts a ``cudaMemcpyDtoD`` record (a contiguous clone) as
an op, as its segment programs run it, and its per-op read sets leave out
resident tensors: parameters and the tensors computed from parameters alone
(``TensorInfo.derived``, the per-layer weight ``select``s), which each
segment recomputes itself (``SegmentGraph.derived_prologue``) and which so
never cross a cut.

The second half validates *derived cache keys* against their base
fingerprint — ``fp|<plan signature>`` segmented entries and ``fp#vmap<w>``
batched entries — plus the persisted metadata
(:meth:`repro_torch.serving.replay_cache.ReplayCache.load` evicts entries
this pass rejects instead of binding a stale program to them).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.diagnostics import ERROR, Diagnostic
from repro_torch.partition.segments import (
    PLACE_DEVICE,
    SegmentGraph,
    SplitPlan,
)

_HEX_FP = re.compile(r"^[0-9a-f]{16,64}$")
_VMAP = re.compile(r"^vmap([0-9]+)$")


def verify_plan(
    graph: SegmentGraph, plan: SplitPlan
) -> List[Diagnostic]:
    """Check one plan against the segment graph it claims to cut."""
    sig = plan.signature()

    # -- RRTO301 gates everything: per-op reasoning is meaningless when the
    #    plan covers a different op stream
    if plan.n_ops != graph.n_ops:
        return [
            Diagnostic(
                "RRTO301",
                ERROR,
                f"plan {sig} covers {plan.n_ops} ops, the IOS has "
                f"{graph.n_ops}",
                where={"plan": sig, "plan_ops": plan.n_ops,
                       "graph_ops": graph.n_ops},
            )
        ]
    diags: List[Diagnostic] = []

    # -- RRTO303: cut-crossing completeness — every tensor a segment reads
    #    must exist by the time the segment runs (segments execute in order)
    for si, seg in enumerate(plan.segments):
        for tid in graph.segment_inputs(seg):
            producer = graph.tensors[tid].producer
            if producer >= seg.end:
                diags.append(
                    Diagnostic(
                        "RRTO303",
                        ERROR,
                        f"plan {sig}: segment {si} "
                        f"[{seg.start}, {seg.end}) reads tensor t{tid} "
                        f"produced by later op {producer} — no execution "
                        "order satisfies the cut",
                        where={"plan": sig, "segment": si, "tid": tid,
                               "producer": producer},
                    )
                )

    # -- RRTO302: carried feasibility (stateful graphs only)
    infeasible = False
    if graph.is_stateful and not graph.plan_carried_feasible(plan):
        infeasible = True
        limit = graph.carried_cut_limit()
        diags.append(
            Diagnostic(
                "RRTO302",
                ERROR,
                f"plan {sig} is not carried-feasible: the donated state "
                "needs every carried-touching op in one trailing server "
                f"segment (first carried touch at op {limit})",
                where={"plan": sig, "carried_cut_limit": limit},
            )
        )

    # -- RRTO304: placement-state consistency — carried tensors are pinned
    #    server-resident; a device segment consuming one would need the
    #    donated state shipped down, which the wire protocol never does.
    #    Subsumed by RRTO302 when that already fired, so gated on it.
    if not infeasible:
        for si, seg in enumerate(plan.segments):
            if seg.placement != PLACE_DEVICE:
                continue
            for k in range(seg.start, seg.end):
                for tid in graph.reads[k]:
                    if graph.tensors[tid].is_carried:
                        diags.append(
                            Diagnostic(
                                "RRTO304",
                                ERROR,
                                f"plan {sig}: device segment {si} op {k} "
                                f"consumes server-pinned carried tensor "
                                f"t{tid}",
                                where={"plan": sig, "segment": si,
                                       "op": k, "tid": tid},
                            )
                        )
    return diags


def verify_plan_for_calls(
    calls: Sequence[Any],
    plan: SplitPlan,
    carried_pairs: Sequence[Tuple[int, int]] = (),
) -> List[Diagnostic]:
    """Convenience wrapper: build the graph from the calls and verify."""
    graph = SegmentGraph(
        calls, carried_pairs=tuple((int(i), int(j)) for i, j in carried_pairs)
    )
    return verify_plan(graph, plan)


# ---------------------------------------------------------------------------
# derived cache keys + persisted metadata
# ---------------------------------------------------------------------------

def split_cache_key(key: str) -> Tuple[str, Optional[str], Optional[str]]:
    """``key -> (base_fingerprint, plan_signature | None, vmap_part | None)``
    following the engine's derivation rules (``fp|<plan>`` from
    ``prepare_split``, ``fp#vmap<w>`` from the vmap batcher)."""
    if "|" in key:
        base, _, plan_sig = key.partition("|")
        return base, plan_sig, None
    if "#" in key:
        base, _, vmap = key.partition("#")
        return base, None, vmap
    return key, None, None


def verify_cache_key(
    key: str,
    *,
    n_ops: Optional[int] = None,
) -> List[Diagnostic]:
    """Validate one cache key's derivation: the base must look like an IOS
    fingerprint, a ``|`` suffix must parse back to a structurally valid
    plan (covering ``n_ops`` ops when known), a ``#`` suffix must be a
    ``vmap<w>`` width ≥ 2 (the batcher never builds width-1 programs)."""
    base, plan_sig, vmap = split_cache_key(key)
    diags: List[Diagnostic] = []
    if not _HEX_FP.match(base):
        diags.append(
            Diagnostic(
                "RRTO305",
                ERROR,
                f"cache key {key!r}: base {base!r} is not an IOS "
                "fingerprint",
                where={"key": key},
            )
        )
    if plan_sig is not None:
        try:
            plan = SplitPlan.parse_signature(plan_sig)
        except ValueError as e:
            diags.append(
                Diagnostic(
                    "RRTO305",
                    ERROR,
                    f"cache key {key!r}: plan signature does not parse "
                    f"({e})",
                    where={"key": key},
                )
            )
        else:
            if n_ops is not None and plan.n_ops != n_ops:
                diags.append(
                    Diagnostic(
                        "RRTO305",
                        ERROR,
                        f"cache key {key!r}: plan covers {plan.n_ops} ops "
                        f"but the base fingerprint's IOS has {n_ops}",
                        where={"key": key, "plan_ops": plan.n_ops,
                               "n_ops": n_ops},
                    )
                )
    if vmap is not None:
        m = _VMAP.match(vmap)
        width = int(m.group(1)) if m else 0
        if width < 2:
            diags.append(
                Diagnostic(
                    "RRTO305",
                    ERROR,
                    f"cache key {key!r}: derived suffix {vmap!r} is not a "
                    "vmap batch width ≥ 2",
                    where={"key": key},
                )
            )
    return diags


def verify_persisted_entry(
    key: str, meta: Any
) -> List[Diagnostic]:
    """Validate one persisted ``fingerprint -> metadata`` cache entry
    (``ReplayCache.load`` checks every entry with it).

    The cache is agnostic to fingerprint *format* (tests and replicas may
    key by opaque strings), so this intentionally does not impose
    :func:`verify_cache_key`'s engine-derivation rules.  What it does
    prove: ``RRTO305`` for keys that are never legitimately persisted
    (derived ``#vmap`` programs); ``RRTO306`` for metadata whose shape
    or plan signature contradicts the key it is stored under — exactly the
    fields a restarted server would otherwise bind a stale stateful
    program from."""
    diags: List[Diagnostic] = []
    _, key_plan_sig, vmap = split_cache_key(key)
    if vmap is not None:
        diags.append(
            Diagnostic(
                "RRTO305",
                ERROR,
                f"cache key {key!r}: derived #vmap programs are "
                "rebuilt on demand and are never persisted",
                where={"key": key},
            )
        )
    if not isinstance(meta, dict):
        diags.append(
            Diagnostic(
                "RRTO306",
                ERROR,
                f"cache key {key!r}: metadata is {type(meta).__name__}, "
                "not a mapping",
                where={"key": key},
            )
        )
        return diags

    meta_sig = meta.get("plan")
    if meta_sig is not None and not isinstance(meta_sig, str):
        diags.append(
            Diagnostic(
                "RRTO306",
                ERROR,
                f"cache key {key!r}: metadata plan signature "
                f"{meta_sig!r} is not a string",
                where={"key": key},
            )
        )
        meta_sig = None
    if key_plan_sig is not None and meta_sig is not None \
            and meta_sig != key_plan_sig:
        diags.append(
            Diagnostic(
                "RRTO306",
                ERROR,
                f"cache key {key!r}: metadata plan {meta_sig!r} "
                f"contradicts the key's plan {key_plan_sig!r} — stale or "
                "corrupted persistence",
                where={"key": key, "meta_plan": meta_sig,
                       "key_plan": key_plan_sig},
            )
        )
    diags.extend(_check_carried_pairs_shape(key, meta.get("carried_pairs")))
    return diags


def verify_metadata_against_calls(
    key: str, meta: Dict[str, Any], calls: Sequence[Any]
) -> List[Diagnostic]:
    """Cross-check persisted metadata against the *recorded calls* about to
    be built under it — the last line of defense before
    ``prepare_replay``/``prepare_split`` binds a stale program: the
    carried-pair ordinals must exist among the calls' transfers."""
    from repro_torch.core.records import FUNC_D2H, FUNC_H2D

    diags = _check_carried_pairs_shape(key, meta.get("carried_pairs"))
    if diags:
        return diags
    pairs = meta.get("carried_pairs") or ()
    n_h2d = sum(1 for c in calls if c.record.func == FUNC_H2D)
    n_d2h = sum(1 for c in calls if c.record.func == FUNC_D2H)
    for i, j in pairs:
        if not (0 <= int(i) < n_h2d and 0 <= int(j) < n_d2h):
            diags.append(
                Diagnostic(
                    "RRTO306",
                    ERROR,
                    f"cache key {key!r}: persisted carried pair "
                    f"({i}, {j}) does not fit the recorded IOS "
                    f"({n_h2d} uploads, {n_d2h} downloads) — stale "
                    "metadata for a different recording",
                    where={"key": key, "pair": [int(i), int(j)],
                           "n_h2d": n_h2d, "n_d2h": n_d2h},
                )
            )
    return diags


def _check_carried_pairs_shape(key: str, pairs: Any) -> List[Diagnostic]:
    if pairs is None:
        return []
    bad = Diagnostic(
        "RRTO306",
        ERROR,
        f"cache key {key!r}: persisted carried_pairs {pairs!r} is not a "
        "list of (h2d_ordinal, d2h_ordinal) integer pairs",
        where={"key": key},
    )
    if not isinstance(pairs, (list, tuple)):
        return [bad]
    seen_i: set = set()
    seen_j: set = set()
    for p in pairs:
        if not isinstance(p, (list, tuple)) or len(p) != 2:
            return [bad]
        i, j = p
        if not isinstance(i, int) or not isinstance(j, int) \
                or i < 0 or j < 0 or i in seen_i or j in seen_j:
            return [bad]
        seen_i.add(i)
        seen_j.add(j)
    return []
