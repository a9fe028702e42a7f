"""Orchestrator: one entry point per verification subject.

``verify_calls`` / ``verify_split_calls`` are what the engine's fail-fast
hooks call (``ReplayProgram(..., verify=True)``,
``SegmentedReplayProgram(..., verify=True)``); ``verify_ios`` builds the
full :class:`~repro_torch.analysis.diagnostics.AnalysisReport` (soundness
passes + census) the CLI emits per model.  Keeping the composition here
means the passes stay independent — each imports only the IR it reads —
while every caller gets the same gating order.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

from repro_torch.analysis.census import op_census
from repro_torch.analysis.dataflow import lint_ios
from repro_torch.analysis.diagnostics import (
    AnalysisReport,
    Diagnostic,
    ReplaySoundnessError,
)
from repro_torch.analysis.donation import sanitize_donation
from repro_torch.analysis.plancheck import verify_plan_for_calls


def records_of(calls: Sequence[Any]) -> List[Any]:
    """Project intercepted calls down to their operator records."""
    return [c.record for c in calls]


def verify_calls(
    calls: Sequence[Any],
    carried_pairs: Sequence[Tuple[int, int]] = (),
    *,
    min_repeats: int = 3,
) -> List[Diagnostic]:
    """Soundness of one whole-program replay build: IOS dataflow +
    donation contract."""
    diags = lint_ios(records_of(calls), min_repeats=min_repeats)
    diags.extend(sanitize_donation(calls, carried_pairs))
    return diags


def verify_split_calls(
    calls: Sequence[Any],
    plan: Any,
    carried_pairs: Sequence[Tuple[int, int]] = (),
) -> List[Diagnostic]:
    """Soundness of one segmented replay build: everything
    :func:`verify_calls` proves, plus the plan/graph contract."""
    diags = verify_calls(calls, carried_pairs)
    diags.extend(verify_plan_for_calls(calls, plan, carried_pairs))
    return diags


def verify_ios(
    subject: str,
    calls: Sequence[Any],
    carried_pairs: Sequence[Tuple[int, int]] = (),
    *,
    plans: Sequence[Any] = (),
    min_repeats: int = 3,
) -> AnalysisReport:
    """Full report for one recorded IOS: soundness passes, every candidate
    plan, and the aten op census."""
    report = AnalysisReport(subject=subject)
    report.extend(verify_calls(calls, carried_pairs, min_repeats=min_repeats))
    for plan in plans:
        report.extend(verify_plan_for_calls(calls, plan, carried_pairs))
    report.census = op_census(records_of(calls))
    return report


def raise_on_errors(diags: Sequence[Diagnostic]) -> None:
    """Fail-fast helper for the ``verify=True`` hooks."""
    errors = [d for d in diags if d.severity == "error"]
    if errors:
        raise ReplaySoundnessError(errors)
