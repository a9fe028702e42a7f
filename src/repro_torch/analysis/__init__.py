"""Replay soundness verifier: static analysis over recorded IOSes, split
plans, persisted cache state and the at-most-once step protocol.

Four passes, stable diagnostic codes (see
:data:`repro_torch.analysis.diagnostics.CODES`):

* :mod:`repro_torch.analysis.dataflow` — IOS dataflow linter (``RRTO1xx``)
* :mod:`repro_torch.analysis.donation` — donation/aliasing sanitizer (``RRTO2xx``)
* :mod:`repro_torch.analysis.plancheck` — plan & cache-key verifier (``RRTO3xx``)
* :mod:`repro_torch.analysis.protocol` — retry/dedup model checker (``RRTO4xx``)

Run the sweep over every registry model with
``python -m repro_torch.analysis --all-registry`` (``--device cpu`` off the
card).  Fail-fast hooks live behind
the off-by-default ``verify=`` knob on
:class:`~repro_torch.core.engine.ReplayProgram`,
:class:`~repro_torch.core.engine.SegmentedReplayProgram`,
:class:`~repro_torch.core.engine.OffloadServer`,
:class:`~repro_torch.core.engine.RRTOClient`,
:class:`~repro_torch.core.offload.OffloadSession`,
:func:`~repro_torch.partition.planner.plan_partition` and
:class:`~repro_torch.serving.multitenant.RRTOEdgeServer`; the
:class:`~repro_torch.serving.replay_cache.ReplayCache` loader checks every
persisted entry.  The passes read records and launch nothing.
"""
from repro_torch.analysis.census import op_census
from repro_torch.analysis.dataflow import NONDETERMINISTIC_PRIMS, lint_ios
from repro_torch.analysis.diagnostics import (
    CODES,
    ERROR,
    INFO,
    WARNING,
    AnalysisReport,
    Diagnostic,
    ReplaySoundnessError,
)
from repro_torch.analysis.donation import sanitize_donation
from repro_torch.analysis.plancheck import (
    split_cache_key,
    verify_cache_key,
    verify_metadata_against_calls,
    verify_persisted_entry,
    verify_plan,
    verify_plan_for_calls,
)
from repro_torch.analysis.protocol import (
    ProtocolSpec,
    check_engine_protocol,
    check_protocol,
    check_sequencing,
)
from repro_torch.analysis.verify import (
    raise_on_errors,
    verify_calls,
    verify_ios,
    verify_split_calls,
)

__all__ = [
    "AnalysisReport",
    "CODES",
    "Diagnostic",
    "ERROR",
    "INFO",
    "NONDETERMINISTIC_PRIMS",
    "ProtocolSpec",
    "ReplaySoundnessError",
    "WARNING",
    "check_engine_protocol",
    "check_protocol",
    "check_sequencing",
    "lint_ios",
    "op_census",
    "raise_on_errors",
    "sanitize_donation",
    "split_cache_key",
    "verify_cache_key",
    "verify_calls",
    "verify_ios",
    "verify_metadata_against_calls",
    "verify_persisted_entry",
    "verify_plan",
    "verify_plan_for_calls",
    "verify_split_calls",
]
