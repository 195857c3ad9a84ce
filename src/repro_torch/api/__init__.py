"""repro_torch.api — the one experiment API over worlds, methods, and
engines (port of ``repro.api``; a script written against ``repro.api``
runs here with only its imports changed, in every world the port runs).

Quickstart (the whole public surface in 10 lines)::

    from repro_torch.api import Experiment, WorldSpec, MethodSpec, ExecutionSpec

    world = WorldSpec.single(task, own_train, own_test, fleet, states)  # on cuda
    exp = Experiment(world,
                     method=MethodSpec(name="enfed", desired_accuracy=0.95,
                                       max_rounds=10, epochs=8),
                     execution=ExecutionSpec(engine="fleet"))
    result = exp.run()                        # -> RunResult (any method/engine)
    table = exp.compare(["enfed", "dfl", "cfl", "cloud"])
    print(table.table(), table.reduction("enfed", "dfl"))

The specs are orthogonal: :class:`WorldSpec` is the simulated world
(requesters, neighborhoods, contributor states, batteries, ONE shared
:class:`~repro_torch.core.energy.CostModel`, the device), :class:`MethodSpec`
picks a registered method ("enfed" | "dfl" | "cfl" | "cloud", all
consuming the same EnFedConfig-shaped knobs), and
:class:`ExecutionSpec` tunes how it executes (loop vs fleet engine, the
hand-written kernels or their plain twins via ``use_pallas``, early-exit
``round_chunk``, and the :class:`~repro_torch.telemetry.TraceConfig`
observability knob) without changing the simulated outcome.  Every run returns one
:class:`RunResult` — read ``result.trace`` for the normalized
round-event stream and ``result.timings`` for the wall-clock breakdown
(:mod:`repro_torch.telemetry`); ``Experiment.compare`` returns a
:class:`CompareResult` whose ``reduction()`` rows reproduce the paper's
EnFed-vs-baseline time and energy savings.  Extend with
:func:`register_method`.
"""

from repro_torch.api.experiment import DEFAULT_COMPARISON, Experiment
from repro_torch.api.methods import get_runner, method_names, register_method
from repro_torch.api.result import CompareResult, RunResult, reduction_row
from repro_torch.api.specs import ExecutionSpec, MethodSpec, WorldSpec
from repro_torch.telemetry import TraceConfig

__all__ = [
    "Experiment",
    "WorldSpec",
    "MethodSpec",
    "ExecutionSpec",
    "TraceConfig",
    "RunResult",
    "CompareResult",
    "DEFAULT_COMPARISON",
    "reduction_row",
    "register_method",
    "method_names",
    "get_runner",
]
