"""repro_torch.telemetry — structured observability for both EnFed engines
(port of ``repro.telemetry``, less its profiler hooks).

* **Round events** (:mod:`repro_torch.telemetry.events`): one
  :class:`RoundEvent` schema materialized from EITHER engine's
  per-session history by a single adapter (:func:`session_events`), so
  the loop engine and the fleet emit the SAME normalized stream on the
  same world, checkable event for event (:func:`compare_event_streams`).
* **Timing spans** (:mod:`repro_torch.telemetry.spans`): a host-side
  :class:`Timeline` of nested :class:`Span` records around the engines'
  cost centers.  ``FleetResult.timeline`` / ``RunResult.timeline`` carry
  it; ``Timeline.totals()`` is the wall-clock breakdown.
* **Exporters** (:mod:`repro_torch.telemetry.export`): the event stream
  as JSONL and the Timeline as a Chrome-trace/Perfetto ``trace.json``.
* **The knob** (:class:`TraceConfig` on ``ExecutionSpec.trace``).

The reference's profiling hooks (``maybe_jax_profiler``,
``jit_hlo_stats``) are ``ROADMAP.md`` slice F, where ``torch.profiler``
takes the place of ``jax.profiler``.

House rule: **observation can never change the simulated outcome**.
Every instrument here is host-side (wall clocks, post-hoc history
adaptation, file exports), and a run with tracing on is bitwise identical
(params, masks, battery) to the same run with tracing off.
"""

from repro_torch.telemetry.config import TraceConfig
from repro_torch.telemetry.events import (EVENT_PHASES, ROUND_EVENT_FIELDS, RoundEvent,
                                          compare_event_streams, session_events,
                                          validate_events)
from repro_torch.telemetry.export import (read_events_jsonl, timeline_chrome_trace,
                                          write_chrome_trace, write_events_jsonl)
from repro_torch.telemetry.spans import Span, Timeline

__all__ = [
    "TraceConfig",
    "RoundEvent",
    "ROUND_EVENT_FIELDS",
    "EVENT_PHASES",
    "session_events",
    "validate_events",
    "compare_event_streams",
    "Span",
    "Timeline",
    "write_events_jsonl",
    "read_events_jsonl",
    "timeline_chrome_trace",
    "write_chrome_trace",
]
