"""Chrome trace-event (Perfetto) JSON export (``repro.obs.export``).

Maps a :class:`~repro_torch.obs.trace.Tracer`'s events onto the Trace Event
Format that ``ui.perfetto.dev`` and ``chrome://tracing`` load:

- the first ``/``-component of a track is the *process* (one Perfetto
  process group per replica, edge server or fleet), the full track string
  is the *thread* (one lane per client, GPU queue, radio, ...);
- spans become ``ph:"X"`` complete events, instants ``ph:"i"`` (thread
  scope ``s:"t"``), counter samples ``ph:"C"``;
- simulated seconds convert to microseconds, the format's unit.  Every
  timestamp is the simulated clock's, not the card's.

Standard library only: ``json.dump`` over plain dicts.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from repro_torch.obs.trace import Tracer


def _ids(track: str) -> Dict[str, str]:
    return {"pid": track.split("/", 1)[0], "tid": track}


def to_chrome_trace(tracer: Tracer) -> Dict[str, Any]:
    """The tracer's events as a Chrome trace-event JSON object."""
    events: List[Dict[str, Any]] = []
    # metadata: name the processes and threads so the tracks render labelled
    pids: Dict[str, None] = {}
    tracks: Dict[str, None] = {}
    for track in tracer.tracks():
        pids.setdefault(track.split("/", 1)[0])
        tracks.setdefault(track)
    for pid in pids:
        events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": pid,
                       "args": {"name": pid}})
    for track in tracks:
        events.append({"ph": "M", "name": "thread_name", **_ids(track), "args": {"name": track}})
    for sp in tracer.spans:
        t1 = sp.t1 if sp.t1 is not None else sp.t0
        events.append({
            "ph": "X", "name": sp.name, "cat": "sim", **_ids(sp.track),
            "ts": sp.t0 * 1e6, "dur": max(0.0, t1 - sp.t0) * 1e6, "args": sp.args,
        })
    for inst in tracer.instants:
        events.append({
            "ph": "i", "s": "t", "name": inst.name, "cat": "sim", **_ids(inst.track),
            "ts": inst.t * 1e6, "args": inst.args,
        })
    for cs in tracer.counters:
        events.append({
            "ph": "C", "name": cs.name, **_ids(cs.track), "ts": cs.t * 1e6,
            "args": {cs.name: cs.value},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer: Tracer, path: str) -> None:
    """Dump the trace to ``path`` as Perfetto-loadable JSON."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer), f, default=str)
