"""Exporters: RoundEvents as JSONL, the Timeline as a Chrome trace (port of
``repro.telemetry.export``).

Both formats are dependency-free:

* **events JSONL**: one JSON object per line, field names exactly the
  :class:`RoundEvent` schema.  :func:`read_events_jsonl` restores real
  ``RoundEvent`` objects and schema-validates the stream, so a
  round-tripped log is indistinguishable from the in-process one.  Every
  field the schema types as a tuple is re-tupled from its JSON list,
  ``corrupted`` and ``clipped`` included, so a Byzantine world's log
  round-trips too.
* **Chrome trace**: the ``{"traceEvents": [...]}`` JSON that
  ``chrome://tracing`` and https://ui.perfetto.dev load directly: one
  complete ("ph": "X") event per finished span, microsecond timestamps,
  span attrs in ``args``.
"""

from __future__ import annotations

import json
from typing import Iterable, List

from repro_torch.telemetry.events import ROUND_EVENT_FIELDS, RoundEvent, validate_events
from repro_torch.telemetry.spans import Timeline

# the fields JSON carries as lists and the schema types as tuples
_TUPLE_FIELDS = tuple(name for name, (types, _) in ROUND_EVENT_FIELDS.items()
                      if types == (tuple,))


def write_events_jsonl(events: Iterable[RoundEvent], path: str) -> int:
    """Write one event per line; returns the number written."""
    events = validate_events(events)
    with open(path, "w") as fh:
        for ev in events:
            fh.write(json.dumps(ev.__dict__, sort_keys=True) + "\n")
    return len(events)


def read_events_jsonl(path: str) -> List[RoundEvent]:
    """Read + schema-validate a JSONL event log back into RoundEvents."""
    events: List[RoundEvent] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            for key in _TUPLE_FIELDS:
                if row.get(key) is not None:
                    row[key] = tuple(row[key])
            events.append(RoundEvent(**row))
    return validate_events(events)


def timeline_chrome_trace(timeline: Timeline) -> dict:
    """The Timeline as a Chrome-trace/Perfetto JSON object (not yet
    serialized).  Unfinished spans are skipped, so a trace of a crashed
    run still loads."""
    trace_events = []
    for sp in timeline.spans:
        if sp.dur < 0:
            continue
        trace_events.append({
            "name": sp.name,
            "ph": "X",
            "ts": round(sp.t0 * 1e6, 3),      # microseconds
            "dur": round(sp.dur * 1e6, 3),
            "pid": 0,
            "tid": 0,
            "cat": "repro",
            "args": dict(sp.attrs),
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(timeline: Timeline, path: str) -> int:
    """Write ``trace.json``; returns the number of trace events."""
    doc = timeline_chrome_trace(timeline)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(doc["traceEvents"])
