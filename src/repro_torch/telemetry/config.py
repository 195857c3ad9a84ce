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
    reference's names: the loop engine and the host-side baselines warn and
    ignore them, as in the reference, and the fleet engine refuses them
    until the profiler hooks are ported (``ROADMAP.md`` slice F, where
    ``torch.profiler`` takes the place of ``jax.profiler``).
    """

    events_jsonl: Optional[str] = None   # write the RoundEvent stream here
    chrome_trace: Optional[str] = None   # write the Timeline as trace.json
    jax_profiler_dir: Optional[str] = None  # profiler dump (slice F)
    hlo_stats: bool = False              # program cost summary (slice F)
