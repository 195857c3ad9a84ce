"""`Experiment` — the single public entrypoint over world x method x engine
(port of ``repro.api.experiment``).

``Experiment(world, method, execution).run()`` executes one method;
``Experiment.compare([...])`` runs N methods on the SAME world + seed +
cost model and returns the paper's Table-style comparison.  The engine
entry points (``EnFedSession.run``, ``run_fleet``, the baseline learners)
stay; this facade is where new call conventions stop accreting.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Sequence, Union

from repro_torch.api.methods import get_runner, method_names
from repro_torch.api.result import CompareResult, RunResult
from repro_torch.api.specs import ExecutionSpec, MethodSpec, WorldSpec
from repro_torch.telemetry.export import write_chrome_trace, write_events_jsonl

DEFAULT_COMPARISON = ("enfed", "dfl", "cfl", "cloud")


@dataclasses.dataclass
class Experiment:
    """One declarative experiment: a world, a method, an execution plan.

    ``method`` may be a registry name (``"enfed"``, ``"dfl"``, ``"cfl"``,
    ``"cloud"``) or a full :class:`MethodSpec`; ``execution`` tunes *how*
    (never *what*) is computed.
    """

    world: WorldSpec
    method: Union[str, MethodSpec] = "enfed"
    execution: ExecutionSpec = dataclasses.field(default_factory=ExecutionSpec)

    def run(self, method: Union[str, MethodSpec, None] = None, *,
            resume: Union[str, None] = None) -> RunResult:
        """Execute one method (default: ``self.method``) and return the
        unified :class:`RunResult`.  The world's mutable state is copied
        per run, so repeated calls are independent and identical.

        ``resume`` restores enfed round state from a checkpoint directory
        (shorthand for ``ExecutionSpec.resume_from``): a run killed
        mid-session and resumed computes the outcome the uninterrupted run
        would have."""
        spec = MethodSpec.coerce(method if method is not None else self.method,
                                 like=MethodSpec.coerce(self.method))
        runner = get_runner(spec.name)
        execution = (self.execution if resume is None else
                     dataclasses.replace(self.execution, resume_from=resume))
        t0 = time.perf_counter()
        result = runner(self.world, spec, execution)
        result.wall_s = time.perf_counter() - t0
        result.method = spec.key
        # observability exports happen HERE, after the outcome exists —
        # host-side file I/O only, so tracing can never perturb the run
        # (the telemetry house rule)
        tr = execution.trace
        if tr is not None:
            if tr.events_jsonl:
                write_events_jsonl(result.trace, tr.events_jsonl)
            if tr.chrome_trace and result.timeline is not None:
                write_chrome_trace(result.timeline, tr.chrome_trace)
        return result

    def compare(self, methods: Sequence[Union[str, MethodSpec]]
                = DEFAULT_COMPARISON) -> CompareResult:
        """Run every method on the same world+seed+cost model.

        Bare names inherit all protocol knobs from ``self.method``, so a
        comparison differs ONLY in the method axis — which is what makes
        ``CompareResult.reduction("enfed", "dfl")`` reproduce the
        paper's time/energy reduction claims.

        Caveat: only EnFed executes ``world.mobility`` — the host-side
        baselines train their full static client set every round, and
        WARN when a mobility world is dropped, since EnFed-under-churn
        vs static baselines is not a same-world comparison.
        """
        base = MethodSpec.coerce(self.method)
        results: Dict[str, RunResult] = {}
        for m in methods:
            spec = MethodSpec.coerce(m, like=base)
            if spec.key in results:
                raise ValueError(
                    f"duplicate method key {spec.key!r} in compare() "
                    "(set MethodSpec.label to disambiguate)")
            results[spec.key] = self.run(spec)
        return CompareResult(results=results)

    @staticmethod
    def available_methods() -> tuple:
        return method_names()
