"""Sim-clock tracing: nested spans, instants and counter samples
(``repro.obs.trace``).

The :class:`Tracer` is a plain in-memory event sink on the *simulated*
timebase: every timestamp is a ``SimClock`` / ``EventTimeline`` time in
seconds, never wall time and never a CUDA event.  Callers hold
``tracer = None`` by default and guard every emission with
``if tracer is not None``, so a disabled tracer costs one attribute load and
a falsy branch per site (no kwargs dict, no object allocation).

Tracks
------
Events land on *tracks*, slash-separated strings such as ``"r0/client/u3"``
or ``"edge/gpu"``.  The Chrome trace exporter (:mod:`repro_torch.obs.export`)
maps the first path component to a Perfetto process and the full track to a
thread, so one fleet run renders as one timeline with a lane per client,
GPU queue, radio and router.

Nesting
-------
``begin``/``end`` keep a per-track stack: a span begun while another is open
on the same track records it as its parent.  ``span`` emits a complete
(begin+end) span in one call and also parents under the open span of its
track — the common shape here, because the simulators know an interval's
begin *and* end at the same program point.

Span args must be plain Python values (numbers, strings, lists and dicts of
them): the exporter writes them to JSON as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    """One interval on a track; ``t1 is None`` while it is still open."""

    id: int
    track: str
    name: str
    t0: float
    t1: Optional[float] = None
    parent: Optional[int] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def dur(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0


@dataclasses.dataclass
class Instant:
    """A zero-duration marker (cache adoption, a replan decision, ...)."""

    track: str
    name: str
    t: float
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CounterSample:
    """One (t, value) sample of a named counter series on a track."""

    track: str
    name: str
    t: float
    value: float


class Tracer:
    """In-memory span / instant / counter sink on the simulated clock.

    Spans are identified by the integer ``begin``/``span`` return;
    ``annotate`` patches args onto a span already emitted (the losing attempt
    of a hedge race is marked once the race resolves)."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.instants: List[Instant] = []
        self.counters: List[CounterSample] = []
        self._open: Dict[str, List[int]] = {}  # track -> open span-id stack
        self._next_id = 0

    # -- emission -----------------------------------------------------------
    def begin(self, track: str, name: str, t: float, **args: Any) -> int:
        """Open a span on ``track`` at time ``t``; returns its id."""
        stack = self._open.setdefault(track, [])
        sid = self._next_id
        self._next_id += 1
        parent = stack[-1] if stack else None
        self.spans.append(Span(sid, track, name, float(t), None, parent, args))
        stack.append(sid)
        return sid

    def end(self, span_id: int, t: float) -> None:
        """Close the span; pops it (and any unclosed children) off its
        track's stack."""
        sp = self.spans[span_id]
        sp.t1 = float(t)
        stack = self._open.get(sp.track, [])
        if span_id in stack:
            del stack[stack.index(span_id):]

    def span(self, track: str, name: str, t0: float, t1: float, **args: Any) -> int:
        """Emit a complete span (parented under the track's open span)."""
        stack = self._open.get(track)
        sid = self._next_id
        self._next_id += 1
        parent = stack[-1] if stack else None
        self.spans.append(Span(sid, track, name, float(t0), float(t1), parent, args))
        return sid

    def instant(self, track: str, name: str, t: float, **args: Any) -> None:
        self.instants.append(Instant(track, name, float(t), args))

    def counter(self, track: str, name: str, t: float, value: float) -> None:
        self.counters.append(CounterSample(track, name, float(t), float(value)))

    def annotate(self, span_id: int, **args: Any) -> None:
        """Merge args into a span already emitted (a verdict after the
        fact)."""
        self.spans[span_id].args.update(args)

    # -- introspection ------------------------------------------------------
    @property
    def n_events(self) -> int:
        return len(self.spans) + len(self.instants) + len(self.counters)

    def find(self, name: str) -> List[Span]:
        """Every span of the given name."""
        return [s for s in self.spans if s.name == name]

    def tracks(self) -> List[str]:
        """Every track that holds an event, in order of first use."""
        seen: Dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(s.track)
        for i in self.instants:
            seen.setdefault(i.track)
        for c in self.counters:
            seen.setdefault(c.track)
        return list(seen)
