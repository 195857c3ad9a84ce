"""The method registry: ``"enfed"``, ``"dfl"``, ``"cfl"``, ``"cloud"``
(port of ``repro.api.methods``).

Each registered runner maps ``(world, method, execution) -> RunResult``
under the shared contract that makes comparisons meaningful:

* it trains on the world's data/models as-is (``world.fresh_requesters``
  copies keep runs independent), on the world's device,
* every energy/time figure comes from the world's ONE
  :class:`repro_torch.core.energy.CostModel`, with ``model_bytes`` priced
  through the shared :func:`repro_torch.core.energy.update_wire_bytes`
  helper, so ``MethodSpec.compress`` lowers transmission energy
  consistently for enfed AND the dfl/cfl baselines (cloud ships raw data,
  not model updates, and is unaffected),
* the protocol knobs are read from the :class:`MethodSpec`'s
  EnFedConfig-shaped surface: the baselines have no private kwargs.

A knob a method cannot honor is never dropped silently: the baselines
warn when they ignore the world's mobility, the enfed-only protocol knobs
(cadence, adversary, robust, staleness decay, which are then stripped),
checkpointing, or the profiler fields of the trace.

New workloads plug in with :func:`register_method`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings
from typing import Callable, Dict, Tuple

from repro_torch.api.result import RunResult
from repro_torch.api.specs import ExecutionSpec, MethodSpec, WorldSpec
from repro_torch.core import federated, protocol
from repro_torch.core.energy import update_wire_bytes
from repro_torch.core.rounds import EnFedSession, SessionResult
from repro_torch.kernels.common import plain_twins
from repro_torch.telemetry.spans import Timeline
from repro_torch.utils.tree import tree_bytes, tree_size

MethodRunner = Callable[[WorldSpec, MethodSpec, ExecutionSpec], RunResult]

_REGISTRY: Dict[str, MethodRunner] = {}


def register_method(name: str):
    """Decorator: add a runner under ``name`` (e.g. a new baseline)."""

    def deco(fn: MethodRunner) -> MethodRunner:
        _REGISTRY[name] = fn
        return fn

    return deco


def method_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_runner(name: str) -> MethodRunner:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; registered: {sorted(_REGISTRY)}") from None


def _warn_if_mobility_ignored(world: WorldSpec, name: str) -> None:
    """The host-side baselines train their full static client set every
    round: dropping the world's mobility axis must never be silent."""
    if world.mobility is not None:
        warnings.warn(
            f"method {name!r} ignores world.mobility (no opportunistic-"
            "world execution: its full static client set trains every "
            "round); a compare() against EnFed-under-churn mixes a churn "
            "world with static baselines", stacklevel=3)


def _warn_if_cadence_ignored(method: MethodSpec, name: str) -> None:
    """The baselines have no per-device round clock: asking one to run an
    async-cadence world warns, and the knob is stripped before the run."""
    if method.cadence is not None:
        warnings.warn(
            f"method {name!r} ignores MethodSpec.cadence (async device "
            "round clocks are enfed-only: baselines sweep their full "
            "client set every round); comparing against EnFed-under-"
            "cadence mixes an async world with lockstep baselines",
            stacklevel=3)


def _strip_cadence(method: MethodSpec) -> MethodSpec:
    return (dataclasses.replace(method, cadence=None)
            if method.cadence is not None else method)


def _warn_if_adversary_ignored(method: MethodSpec, name: str) -> None:
    """Byzantine contributors, the robust statistic and staleness decay
    are enfed protocol knobs (Phase.DELIVER/AGGREGATE): a baseline asked
    to run a Byzantine world warns, and the knobs are stripped."""
    if (method.adversary is not None or method.robust != "none"
            or method.staleness_gamma != 1.0):
        warnings.warn(
            f"method {name!r} ignores MethodSpec.adversary/robust/"
            "staleness_gamma (Byzantine contributors and robust "
            "aggregation are enfed-only); comparing against "
            "EnFed-under-attack mixes an adversarial world with honest "
            "baselines", stacklevel=3)


def _strip_adversary(method: MethodSpec) -> MethodSpec:
    if (method.adversary is None and method.robust == "none"
            and method.staleness_gamma == 1.0):
        return method
    return dataclasses.replace(method, adversary=None, robust="none",
                               staleness_gamma=1.0)


def _warn_if_checkpoint_ignored(execution: ExecutionSpec, name: str) -> None:
    """Resumable round state is an enfed contract: a baseline asked to
    checkpoint warns instead of quietly doing nothing."""
    if execution.checkpoint_dir or execution.resume_from:
        warnings.warn(
            f"method {name!r} ignores ExecutionSpec checkpointing "
            "(checkpoint_dir/resume_from are enfed-only: baselines have "
            "no resumable round-state contract)", stacklevel=3)


def _warn_if_trace_fleet_only(execution: ExecutionSpec, name: str) -> None:
    """``TraceConfig.jax_profiler_dir`` / ``hlo_stats`` profile the fleet
    program; the loop engine and the host-side baselines have none, so
    they warn and ignore them, as in the reference.  The exports
    (events_jsonl, chrome_trace) work on every engine and stay silent."""
    tr = execution.trace
    if tr is not None and (tr.jax_profiler_dir or tr.hlo_stats):
        warnings.warn(
            f"{name} run ignores TraceConfig.jax_profiler_dir/hlo_stats "
            "(fleet-engine-only: they profile the fleet program); "
            "event/timeline exports still apply", stacklevel=3)


def _kernels(execution: ExecutionSpec):
    """The kernel selection of a host-side baseline's run: the plain twins
    under ``use_pallas=False``, as the engines select them."""
    return contextlib.nullcontext() if execution.use_pallas else plain_twins()


def _baseline_model_bytes(params, cfg) -> int:
    """One update's wire bytes for a loop cfl/dfl session: the same
    ``update_wire_bytes`` call the fleet baselines price their views with,
    so the two engines' event streams carry identical ``wire_bytes``."""
    return update_wire_bytes(tree_size(params), encrypt=False,
                             compress=getattr(cfg, "compress", None),
                             raw_bytes=tree_bytes(params))


def _baseline_session(res: "federated.BaselineResult", *, target: float,
                      n_contributors: float,
                      model_bytes: int = 0) -> SessionResult:
    """A BaselineResult in the per-requester SessionResult schema."""
    stopped = res.accuracy >= target
    stop = (protocol.STOP_ACCURACY if stopped else protocol.STOP_MAX_ROUNDS)
    return SessionResult(
        accuracy=res.accuracy, rounds=res.rounds,
        n_contributors=n_contributors, report=res.report, battery=None,
        history_raw=res.history, stop_reason=protocol.stop_reason_name(stop),
        params=res.params, model_bytes=model_bytes)


@register_method("enfed")
def run_enfed(world: WorldSpec, method: MethodSpec,
              execution: ExecutionSpec) -> RunResult:
    """EnFed Algorithm 1 on the engine the ExecutionSpec picks."""
    from repro_torch.core import fleet as fleet_mod

    dev = world.resolve_device()
    cfg = method.to_enfed_config(world)
    cost = world.cost_model
    reqs = world.fresh_requesters()
    tl = Timeline()
    if execution.engine == "fleet":
        fr = fleet_mod.run_fleet(
            world.task, reqs, cfg, cost_model=cost,
            use_pallas=execution.use_pallas, interpret=execution.interpret,
            round_chunk=execution.round_chunk,
            checkpoint_dir=execution.checkpoint_dir,
            checkpoint_every=execution.checkpoint_every,
            resume_from=execution.resume_from,
            timeline=tl, trace=execution.trace, device=dev)
        return RunResult.from_sessions(
            "enfed", "fleet", fr.sessions, cost_model=cost,
            total_energy_j=fr.total_energy_j, raw=fr,
            timeline=tl, hlo_stats=fr.hlo_stats)
    _warn_if_trace_fleet_only(execution, "loop-engine enfed")

    def _sub(root, i):
        # a multi-requester loop run checkpoints per session: requester i's
        # state lives under <root>/req<i> (a 1-requester world keeps the bare
        # directory, so loop and fleet runs can share paths)
        if not root or len(reqs) == 1:
            return root
        return os.path.join(root, f"req{i}")

    sessions = []
    for i, r in enumerate(reqs):
        # requester i walks as device mobility.requester_id + i, rolls its
        # link dice as faults.requester_id + i, ticks as
        # cadence.requester_id + i and draws its Byzantine weather as
        # adversary.requester_id + i, the fleet's lane conventions, so
        # ExecutionSpec.engine never changes which world a requester
        # experiences
        cfg_i = cfg
        for name in ("mobility", "faults", "cadence", "adversary"):
            world_cfg = getattr(cfg, name)
            if world_cfg is not None and i > 0:
                cfg_i = dataclasses.replace(cfg_i, **{name: dataclasses.replace(
                    world_cfg, requester_id=world_cfg.requester_id + i)})
        sessions.append(EnFedSession(
            world.task, r.own_train, r.own_test,
            r.neighborhood, r.contributor_states,
            cfg_i, cost_model=cost, battery=r.battery, device=dev).run(
                use_pallas=execution.use_pallas, interpret=execution.interpret,
                checkpoint_dir=_sub(execution.checkpoint_dir, i),
                checkpoint_every=execution.checkpoint_every,
                resume_from=_sub(execution.resume_from, i), timeline=tl))
    return RunResult.from_sessions("enfed", "loop", sessions, cost_model=cost,
                                   timeline=tl)


def _run_baseline_fleet(world: WorldSpec, method: MethodSpec,
                        execution: ExecutionSpec, name: str) -> RunResult:
    """dfl/cfl as protocol variants of the fleet engine
    (``run_fleet(method=...)``).  Baselines re-init node params and write
    nothing back, so the world's requesters are used read-only."""
    from repro_torch.core import fleet as fleet_mod

    cfg = method.to_enfed_config(world)
    cost = world.cost_model
    tl = Timeline()
    fr = fleet_mod.run_fleet(
        world.task, world.requesters, cfg, cost_model=cost,
        use_pallas=execution.use_pallas, interpret=execution.interpret,
        round_chunk=execution.round_chunk, method=name,
        dfl_topology=method.topology,
        timeline=tl, trace=execution.trace, device=world.resolve_device())
    return RunResult.from_sessions(name, "fleet", fr.sessions,
                                   cost_model=cost,
                                   total_energy_j=fr.total_energy_j, raw=fr,
                                   timeline=tl, hlo_stats=fr.hlo_stats)


def _baseline_method(world: WorldSpec, method: MethodSpec,
                     execution: ExecutionSpec, name: str) -> MethodSpec:
    """The never-silent warnings of a baseline, and its method with the
    enfed-only knobs stripped."""
    _warn_if_mobility_ignored(world, name)
    _warn_if_checkpoint_ignored(execution, name)
    _warn_if_cadence_ignored(method, name)
    method = _strip_cadence(method)
    _warn_if_adversary_ignored(method, name)
    return _strip_adversary(method)


def _run_loop_learner(world: WorldSpec, method: MethodSpec,
                      execution: ExecutionSpec, name: str, learner) -> RunResult:
    """A loop cfl/dfl learner per requesting device (client 0).  Baselines
    re-init their node params, so the world's contributor states are
    read-only here."""
    _warn_if_trace_fleet_only(execution, name)
    world.resolve_device()
    cfg = method.to_enfed_config(world)
    cost = world.cost_model
    sessions = []
    with _kernels(execution):
        for i, r in enumerate(world.requesters):
            data = world.client_data(i)
            res = learner(data, r.own_test, cost).run_config(cfg)
            sessions.append(_baseline_session(
                res, target=cfg.desired_accuracy, n_contributors=len(data) - 1,
                model_bytes=_baseline_model_bytes(res.params, cfg)))
    return RunResult.from_sessions(name, "loop", sessions, cost_model=cost,
                                   timeline=Timeline())


@register_method("cfl")
def run_cfl(world: WorldSpec, method: MethodSpec,
            execution: ExecutionSpec) -> RunResult:
    """Centralized FL baseline, per requesting device (client 0)."""
    method = _baseline_method(world, method, execution, "cfl")
    if execution.engine == "fleet":
        return _run_baseline_fleet(world, method, execution, "cfl")
    return _run_loop_learner(
        world, method, execution, "cfl",
        lambda data, test, cost: federated.CFLLearner(world.task, data, test,
                                                      cost_model=cost))


@register_method("dfl")
def run_dfl(world: WorldSpec, method: MethodSpec,
            execution: ExecutionSpec) -> RunResult:
    """Decentralized FL baseline over ``method.topology`` (mesh|ring)."""
    method = _baseline_method(world, method, execution, "dfl")
    if execution.engine == "fleet":
        return _run_baseline_fleet(world, method, execution, "dfl")
    return _run_loop_learner(
        world, method, execution, "dfl",
        lambda data, test, cost: federated.DFLLearner(world.task, data, test,
                                                      method.topology, cost_model=cost))


@register_method("cloud")
def run_cloud(world: WorldSpec, method: MethodSpec,
              execution: ExecutionSpec) -> RunResult:
    """The §IV-G no-FL baseline: ship raw data to the cloud, wait, get
    the result back.  Device-side cost via ``CostModel.cloud_session``."""
    method = _baseline_method(world, method, execution, "cloud")
    _warn_if_trace_fleet_only(execution, "cloud")
    world.resolve_device()
    cfg = method.to_enfed_config(world)
    cost = world.cost_model
    sessions = []
    with _kernels(execution):
        for i, r in enumerate(world.requesters):
            res = federated.cloud_only_config(world.task, world.pooled(i),
                                              r.own_test, cfg, cost_model=cost)
            # cloud ships raw data, not model updates: no per-round wire
            sessions.append(_baseline_session(
                res, target=cfg.desired_accuracy, n_contributors=0.0))
    return RunResult.from_sessions("cloud", "loop", sessions, cost_model=cost,
                                   timeline=Timeline())
