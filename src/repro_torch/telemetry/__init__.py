"""repro_torch.telemetry — structured observability for both EnFed engines
(port of ``repro.telemetry``).

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

* **Profiling hooks** (:mod:`repro_torch.telemetry.profile`):
  ``torch.profiler`` around the fleet program (:func:`maybe_torch_profiler`,
  the reference's ``maybe_jax_profiler``) and the program-cost recorder
  (:func:`record_program_cost`, :func:`program_cost_stats`; the reference
  compiled its program for XLA's cost analysis in ``jit_hlo_stats``): the
  kernels' flops, bytes and launches over the run, charged at each op's
  dispatch (:mod:`repro_torch.launch.hlo_stats`).

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
from repro_torch.telemetry.profile import (ProgramCost, maybe_torch_profiler,
                                           program_cost_stats, record_program_cost)
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
    "maybe_torch_profiler",
    "record_program_cost",
    "program_cost_stats",
    "ProgramCost",
]
