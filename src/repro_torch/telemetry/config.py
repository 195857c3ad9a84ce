"""TraceConfig — the ``ExecutionSpec.trace`` knob (port of
``repro.telemetry.config``).

An execution knob in the strict ``repro_torch.api`` sense: it selects which
observability artifacts a run emits and must NEVER change the simulated
outcome: a traced run is bitwise the untraced one (params, masks,
battery), enforced by ``tests/test_torch_telemetry.py`` and phase [4f] of
``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """What to export/profile for one run.  All fields default off; a
    default ``TraceConfig()`` costs nothing beyond the always-on host-side
    Timeline.

    ``events_jsonl`` / ``chrome_trace`` are written by ``Experiment.run``
    after the run completes (host-side file I/O, outcome-neutral), on
    either engine.  ``jax_profiler_dir`` and ``hlo_stats`` keep the
    reference's names and instrument the fleet program: the first runs
    ``torch.profiler`` around it and writes its trace into the directory,
    the second records the kernels' work over it into
    ``FleetResult.hlo_stats`` (``repro_torch.telemetry.profile``).  The loop
    engine and the host-side baselines warn and ignore them, as in the
    reference.  With ``hlo_stats`` on, the flop counter runs Python on
    every torch op of the program, so the run's ``program`` span and
    ``RunResult.timings`` time the counted program, many times slower than
    the program: read the work counts from one run and the times from an
    untraced one.  The profiler writes its trace after the span closes.
    """

    events_jsonl: Optional[str] = None   # write the RoundEvent stream here
    chrome_trace: Optional[str] = None   # write the Timeline as trace.json
    jax_profiler_dir: Optional[str] = None  # torch.profiler trace of the program
    hlo_stats: bool = False              # the program's work and memory
