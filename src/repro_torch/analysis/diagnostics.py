"""Typed diagnostics for the replay soundness verifier.

Every pass in ``repro_torch.analysis`` reports findings as :class:`Diagnostic`
values with *stable* codes — the code is the contract (tests, CI and the
mutation corpus key on it), the message is for humans.  Code ranges by pass:

* ``RRTO1xx`` — IOS dataflow linter (``repro_torch.analysis.dataflow``)
* ``RRTO2xx`` — donation/aliasing sanitizer (``repro_torch.analysis.donation``)
* ``RRTO3xx`` — split-plan & cache-key verifier (``repro_torch.analysis.plancheck``)
* ``RRTO4xx`` — retry/dedup protocol checker (``repro_torch.analysis.protocol``)

Severity semantics: an ``ERROR`` means the IOS/plan/protocol would be
*unsound* to replay (CI fails, fail-fast hooks raise); a ``WARNING`` means
replay is sound but an operational limit is near (e.g. payload-retention
horizon); ``INFO`` is advisory.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITIES = (ERROR, WARNING, INFO)

# stable code -> one-line meaning (the docs table is generated from this)
CODES: Dict[str, str] = {
    # -- dataflow (RRTO1xx) -------------------------------------------------
    "RRTO101": "use-before-def: operand read with no in-window producer "
               "and no parameter-like definition",
    "RRTO102": "dead H2D: uploaded buffer overwritten before any read",
    "RRTO103": "undefined D2H: download of a buffer no in-window op or "
               "upload produced",
    "RRTO104": "payload-retention horizon: IOS too long for the recorder's "
               "payload windows, loop-carried detection may be blinded",
    "RRTO105": "replay-unsafe operator: nondeterministic primitive recorded "
               "inside the IOS",
    # -- donation (RRTO2xx) -------------------------------------------------
    "RRTO201": "read-after-donate: donated carried input also returned as a "
               "wire output",
    "RRTO202": "malformed carried pair: transfer ordinal out of range or "
               "claimed twice",
    "RRTO203": "carried aval mismatch: carried output shape/dtype differs "
               "from the donated input buffer",
    "RRTO204": "carried output not produced: paired D2H reads a tensor no "
               "in-window op wrote",
    # -- plan / cache keys (RRTO3xx) ----------------------------------------
    "RRTO301": "plan/graph op-count mismatch",
    "RRTO302": "carried-infeasible plan: a carried-touching op sits outside "
               "the trailing server segment",
    "RRTO303": "cut-crossing incompleteness: a segment reads a tensor "
               "produced by a later segment",
    "RRTO304": "placement-state inconsistency: device segment consumes "
               "server-pinned carried state",
    "RRTO305": "derived cache key invalid: fp|plan signature or fp#vmap "
               "width does not parse against its base fingerprint",
    "RRTO306": "stale cache metadata: persisted carried_pairs/plan metadata "
               "contradicts the recorded IOS",
    # -- protocol (RRTO4xx) -------------------------------------------------
    "RRTO401": "at-most-once violation: a sequence number can execute twice",
    "RRTO402": "lost completion: a fate sequence ends with the step neither "
               "executed nor reported failed",
    "RRTO403": "dedup window unsound: an unacknowledged sequence number can "
               "be evicted while its retry is outstanding",
    "RRTO404": "sequence-number reuse: distinct steps share a seqno, a retry "
               "can be answered with a stale cached reply",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: stable ``code``, ``severity`` in {error, warning, info},
    human ``message``, and a JSON-safe ``where`` locating it (op index,
    transfer ordinal, cache key, fate trace — whatever the pass has)."""

    code: str
    severity: str
    message: str
    where: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if self.severity not in _SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def as_dict(self) -> Dict[str, Any]:
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "where": dict(self.where),
        }


class ReplaySoundnessError(ValueError):
    """Raised by the fail-fast ``verify=True`` hooks when a pass reports
    ERROR diagnostics; carries them for programmatic inspection."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = tuple(diagnostics)
        lines = [f"{d.code}: {d.message}" for d in self.diagnostics]
        super().__init__(
            "replay soundness verification failed:\n  " + "\n  ".join(lines)
        )


@dataclasses.dataclass
class AnalysisReport:
    """Machine-readable result of one verification subject (an IOS, a plan,
    a cache file, a protocol spec) or a whole CLI sweep."""

    subject: str
    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    census: Optional[Dict[str, Any]] = None

    def extend(self, diags: Sequence[Diagnostic]) -> "AnalysisReport":
        self.diagnostics.extend(diags)
        return self

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def raise_if_errors(self) -> None:
        if self.errors:
            raise ReplaySoundnessError(self.errors)

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "subject": self.subject,
            "ok": self.ok,
            "diagnostics": [d.as_dict() for d in self.diagnostics],
        }
        if self.census is not None:
            out["census"] = self.census
        return out

    def to_json(self, **kwargs: Any) -> str:
        return json.dumps(self.as_dict(), sort_keys=True, **kwargs)
