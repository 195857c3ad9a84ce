"""Unified result types: one schema for every method and engine (port of
``repro.api.result``).

:class:`RunResult` supersedes the ``SessionResult`` / ``FleetResult`` /
``BaselineResult`` split at the public surface: whatever ran — the loop
engine, the fleet, or a host-side baseline — the caller gets
per-requester :class:`repro_torch.core.rounds.SessionResult` views in
``sessions`` plus fleet-level aggregates, all costed by ONE shared
:class:`repro_torch.core.energy.CostModel`.  :class:`CompareResult` holds N
methods run on the same world+seed+cost model and emits the paper's
Table-style time/energy reduction rows.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence

from repro_torch.core.battery import BatteryState
from repro_torch.core.energy import CostModel, EnergyReport
from repro_torch.core.rounds import SessionResult
from repro_torch.telemetry.events import RoundEvent, session_events
from repro_torch.telemetry.spans import Timeline


@dataclasses.dataclass
class RunResult:
    """Outcome of one ``Experiment.run()`` in a method/engine-agnostic schema.

    Scalars (``accuracy``, ``rounds``, ``report`` ...) describe "the
    requesting device" — requester 0, the paper's measured device;
    ``sessions`` carries every requester's full view (history, energy
    report, battery, params).  ``simulated_s`` is the modeled eq. (4)
    training time, ``wall_s`` the host wall-clock of the run itself.
    """

    method: str
    engine: str
    accuracy: float
    rounds: int
    report: EnergyReport               # requester 0's eq. (4)-(7) roll-up
    # DEPRECATED view: requester 0's raw per-engine dict-of-lists —
    # attribute access warns (property attached below the class); new
    # code reads the normalized event stream (``trace``) or, for the raw
    # buffers, ``history_raw``
    history: Dict[str, list] = dataclasses.field(repr=False, compare=False)
    stop_reason: str
    sessions: List[SessionResult]
    cost_model: Optional[CostModel] = None
    params: object = None
    n_contributors: float = 0.0
    battery: Optional[BatteryState] = None
    total_energy_j: float = 0.0        # summed across all requesters
    wall_s: float = 0.0
    raw: object = None                 # underlying engine result, if any
    timeline: Optional[Timeline] = None  # host-side wall-clock spans
    hlo_stats: Optional[dict] = None     # fleet program work and memory
                                         # (TraceConfig.hlo_stats)

    @property
    def history_raw(self) -> Dict[str, list]:
        """Requester 0's raw per-engine dict-of-lists, without the
        deprecation warning — the internal surface."""
        return self.__dict__["_history_raw"]

    @property
    def simulated_s(self) -> float:
        """Modeled training time T_train (eq. 4) of the requesting device."""
        return float(self.report.t_train)

    @property
    def energy_j(self) -> float:
        """Modeled energy E_tot (eq. 5) of the requesting device."""
        return float(self.report.e_tot)

    @property
    def trace(self) -> List[RoundEvent]:
        """The run as one normalized RoundEvent stream — every session's
        rounds (requester-stamped) plus stop events, identical across
        engines on the same world (``repro_torch.telemetry.events``)."""
        events: List[RoundEvent] = []
        for i, s in enumerate(self.sessions):
            events.extend(session_events(s, requester=i))
        return events

    @property
    def corruption_summary(self) -> Optional[Dict[str, float]]:
        """Fleet-wide Byzantine roll-up from the normalized trace:
        total corrupted deliveries and robust-clipped links across every
        requester's executed rounds.  ``None`` on honest worlds (no
        ``MethodSpec.adversary`` — absence stays distinguishable from an
        observed 0, same rule as the RoundEvent fields)."""
        events = [e for e in self.trace if e.phase == "round"]
        if not any(e.corrupted is not None or e.clipped is not None
                   for e in events):
            return None
        corrupted = sum(len(e.corrupted or ()) for e in events)
        clipped = sum(len(e.clipped or ()) for e in events)
        rounds = len(events)
        return {"corrupted_links": float(corrupted),
                "clipped_links": float(clipped),
                "rounds": float(rounds),
                "corrupted_per_round": (corrupted / rounds if rounds
                                        else 0.0)}

    @property
    def timings(self) -> Dict[str, float]:
        """Summed seconds per span name (``Timeline.totals()``); empty
        when no timeline was recorded."""
        return self.timeline.totals() if self.timeline is not None else {}

    @classmethod
    def from_sessions(cls, method: str, engine: str,
                      sessions: Sequence[SessionResult],
                      cost_model: Optional[CostModel] = None,
                      total_energy_j: Optional[float] = None,
                      raw: object = None,
                      timeline: Optional[Timeline] = None,
                      hlo_stats: Optional[dict] = None) -> "RunResult":
        s0 = sessions[0]
        total = (float(total_energy_j) if total_energy_j is not None
                 else float(sum(s.report.e_tot for s in sessions)))
        return cls(method=method, engine=engine, accuracy=s0.accuracy,
                   rounds=s0.rounds, report=s0.report,
                   history=s0.history_raw,
                   stop_reason=s0.stop_reason, sessions=list(sessions),
                   cost_model=cost_model, params=s0.params,
                   n_contributors=float(s0.n_contributors),
                   battery=s0.battery, total_energy_j=total, raw=raw,
                   timeline=timeline, hlo_stats=hlo_stats)


def _run_history_get(self):
    warnings.warn(
        "RunResult.history is deprecated; use .trace (normalized "
        "RoundEvent stream) or .history_raw for the raw buffers",
        DeprecationWarning, stacklevel=2)
    return self.__dict__["_history_raw"]


def _run_history_set(self, value):
    # dataclass __init__ assigns through here — store raw, never warn
    self.__dict__["_history_raw"] = value


RunResult.history = property(_run_history_get, _run_history_set)


def reduction_row(method_res: RunResult, baseline_res: RunResult) -> dict:
    """The paper's Table-IV/V-style comparison row: how much training
    time and energy ``method`` saves over ``baseline`` on the same world
    (positive percentages = the method is cheaper)."""
    t_m, t_b = method_res.simulated_s, baseline_res.simulated_s
    e_m, e_b = method_res.energy_j, baseline_res.energy_j
    return {
        "method": method_res.method, "baseline": baseline_res.method,
        "t_method_s": round(t_m, 4), "t_baseline_s": round(t_b, 4),
        "time_reduction_pct": round(100.0 * (1.0 - t_m / t_b), 2) if t_b else None,
        "e_method_j": round(e_m, 4), "e_baseline_j": round(e_b, 4),
        "energy_reduction_pct": round(100.0 * (1.0 - e_m / e_b), 2) if e_b else None,
        "acc_method": round(method_res.accuracy, 4),
        "acc_baseline": round(baseline_res.accuracy, 4),
    }


@dataclasses.dataclass
class CompareResult:
    """N methods on one world+seed+cost model (``Experiment.compare``)."""

    results: Dict[str, RunResult]      # insertion-ordered by methods arg

    def __getitem__(self, name: str) -> RunResult:
        return self.results[name]

    def __iter__(self):
        return iter(self.results.values())

    def reduction(self, method: str = "enfed", baseline: str = "dfl") -> dict:
        return reduction_row(self.results[method], self.results[baseline])

    def reductions(self, method: str = "enfed") -> List[dict]:
        """``method`` vs every other method in the comparison."""
        return [reduction_row(self.results[method], r)
                for name, r in self.results.items() if name != method]

    def table(self) -> str:
        """Printable paper-style summary table."""
        lines = [f"{'method':<12} {'acc':>6} {'rounds':>6} "
                 f"{'T_train(s)':>11} {'E(J)':>10}"]
        for name, r in self.results.items():
            lines.append(f"{name:<12} {r.accuracy:6.3f} {r.rounds:6d} "
                         f"{r.simulated_s:11.2f} {r.energy_j:10.2f}")
        return "\n".join(lines)
