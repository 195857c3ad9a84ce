"""Declarative experiment specs — the orthogonal axes of one run (port of
``repro.api.specs``).

* :class:`WorldSpec` — the simulated world, shared verbatim across every
  method of a comparison (what makes the paper's Table-style reductions
  meaningful), and the device it runs on.
* :class:`MethodSpec` — a method name from the registry
  (``repro_torch.api.methods``) plus the protocol knobs, mapped 1:1 onto
  :class:`repro_torch.core.rounds.EnFedConfig` so the baselines consume the
  SAME configuration surface as EnFed.
* :class:`ExecutionSpec` — engine selection and engine tuning knobs;
  changing it never changes the simulated outcome, only how it is computed
  (``tests/test_torch_api.py``).

``WorldSpec.mobility`` is the opportunistic world
(:class:`~repro_torch.core.mobility.MobilityConfig`) and
``MethodSpec.faults`` the unreliable-link world
(:class:`~repro_torch.core.faults.FaultConfig`), which EnFed runs in both
engines (the cfl/dfl fleets price the faults' retries), as it runs
``MethodSpec.cadence``, the asynchronous-cadence world
(:class:`~repro_torch.core.cadence.CadenceConfig`; the baselines warn and
drop it).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.adversary import AdversaryConfig
from repro_torch.core.battery import BatteryState
from repro_torch.core.cadence import CadenceConfig
from repro_torch.core.energy import CostModel
from repro_torch.core.faults import FaultConfig
from repro_torch.core.fleet import RequesterSpec
from repro_torch.core.mobility import MobilityConfig
from repro_torch.core.rounds import EnFedConfig
from repro_torch.core.topology import AggregationStrategy
from repro_torch.kernels.common import check_interpret, resolve_device
from repro_torch.telemetry.config import TraceConfig


@dataclasses.dataclass
class WorldSpec:
    """The simulated world: who exists, what data/models/batteries they
    hold, what everything costs, and the device it runs on.

    ``requesters[0]`` is "the requesting device" of the paper's
    comparisons; baselines that model a single participating device
    (CFL/DFL/cloud) are evaluated from its perspective.  ``seed`` drives
    every derivation (schedules, keys) so two runs on one ``WorldSpec``
    see the identical world.  ``device`` is the GPU unless the caller
    names another (the task must run there); with none named and no GPU
    present every run raises.
    """

    task: object                          # SupervisedTask-like (init/fit/evaluate)
    requesters: List[RequesterSpec]
    cost_model: CostModel = dataclasses.field(default_factory=CostModel)
    mobility: Optional[MobilityConfig] = None   # opportunistic world (EnFed only)
    pooled_train: Optional[tuple] = None  # cloud baseline corpus (default: all shards)
    seed: int = 0
    device: Optional[object] = None

    @classmethod
    def single(cls, task, own_train, own_test, neighborhood,
               contributor_states: Dict[int, dict], *,
               battery: Optional[BatteryState] = None,
               cost_model: Optional[CostModel] = None,
               mobility: Optional[MobilityConfig] = None,
               pooled_train: Optional[tuple] = None,
               seed: int = 0, device=None) -> "WorldSpec":
        """The common one-requester world, from ``EnFedSession``-style args."""
        return cls(task=task,
                   requesters=[RequesterSpec(
                       own_train=own_train, own_test=own_test,
                       neighborhood=neighborhood,
                       contributor_states=contributor_states,
                       battery=battery)],
                   cost_model=cost_model or CostModel(),
                   mobility=mobility, pooled_train=pooled_train, seed=seed,
                   device=device)

    def resolve_device(self) -> torch.device:
        """The device every run of this world uses; the task must be there."""
        dev = resolve_device(self.device)
        if torch.device(self.task.device) != dev:
            raise ValueError(f"the task runs on {self.task.device}, the world on {dev}")
        return dev

    def fresh_requesters(self) -> List[RequesterSpec]:
        """Per-run copies of the mutable state, so every
        ``Experiment.run`` starts from the same world.  The engines mutate
        by REBINDING ``states[id]["params"]`` (refresh training) and
        replacing batteries — the param trees and data shards themselves
        are never written in place — so a two-level shallow copy of the
        state dicts isolates runs without copying the shards."""
        return [RequesterSpec(
            own_train=r.own_train, own_test=r.own_test,
            neighborhood=r.neighborhood,
            contributor_states={k: dict(v)
                                for k, v in r.contributor_states.items()},
            battery=copy.deepcopy(r.battery)) for r in self.requesters]

    def client_data(self, i: int = 0) -> List[tuple]:
        """The CFL/DFL client list seen from requester ``i``: its own
        shard first (client 0 = the requesting device), then each
        neighbor's shard in neighborhood order."""
        r = self.requesters[i]
        shards = [r.own_train]
        for dev in r.neighborhood:
            st = r.contributor_states.get(dev.device_id)
            if st is not None:
                shards.append(st["data"])
        return shards

    def pooled(self, i: int = 0) -> tuple:
        """The cloud-baseline corpus: ``pooled_train`` if given, else the
        concatenation of requester ``i``'s client shards."""
        if self.pooled_train is not None:
            return self.pooled_train
        shards = self.client_data(i)
        x = np.concatenate([np.asarray(s[0]) for s in shards])
        y = np.concatenate([np.asarray(s[1]) for s in shards])
        return x, y


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """Which method trains, and with which protocol knobs.

    The knobs are exactly :class:`EnFedConfig`'s fields (world-owned
    ``seed``/``mobility`` excluded) so every registered method consumes one
    configuration surface; ``topology`` only matters to ``"dfl"``.  Coerce
    a bare registry name with :meth:`coerce`.
    """

    name: str = "enfed"
    desired_accuracy: float = 0.95       # A_A
    max_rounds: int = 10                 # R_A
    epochs: int = 5                      # E
    batch_size: int = 32                 # B_A
    n_max: int = 5                       # N_max
    battery_threshold: float = 0.2       # B_min
    offered_incentive: float = 0.6
    encrypt: bool = True
    contributor_refresh_epochs: int = 1
    strategy: Optional[AggregationStrategy] = None
    topology: str = "mesh"               # dfl: "mesh" | "ring"
    # transported-update compression (None | "int8" | "auto"): a PROTOCOL
    # knob (wire bytes, eq. (4)-(7) energy, quantized params), priced for
    # every method through the same update_wire_bytes helper
    compress: Optional[str] = None
    # unreliable links (drops, retries, stale delivery): a protocol knob for
    # enfed, priced post hoc for the cfl/dfl fleets
    faults: Optional[FaultConfig] = None
    # asynchronous cadence (per-device round clocks): enfed-only, the
    # baselines warn and drop it
    cadence: Optional[CadenceConfig] = None
    # Byzantine contributors and the robust AGGREGATE statistic ("none" |
    # "clip" | "trimmed_mean" | "median"): enfed-only protocol knobs; the
    # baselines warn and drop them
    adversary: Optional[AdversaryConfig] = None
    robust: str = "none"
    staleness_gamma: float = 1.0         # a stale delivery weighs gamma
    label: Optional[str] = None          # display/compare key (default: name)

    @property
    def key(self) -> str:
        """The name this run is reported/keyed under in a comparison —
        lets e.g. ``dfl``-mesh and ``dfl``-ring coexist in one table."""
        return self.label or self.name

    @classmethod
    def coerce(cls, m: Union[str, "MethodSpec"],
               like: Optional["MethodSpec"] = None) -> "MethodSpec":
        """``"dfl"`` -> a MethodSpec inheriting every knob from ``like``
        (or the defaults); a MethodSpec passes through unchanged.  The
        ``label`` is NOT inherited: it names ``like``'s own run."""
        if isinstance(m, MethodSpec):
            return m
        base = like if like is not None else cls()
        return dataclasses.replace(base, name=str(m), label=None)

    def to_enfed_config(self, world: WorldSpec) -> EnFedConfig:
        """The method knobs + the world's seed/mobility as the config
        object both engines (and the baselines) execute."""
        return EnFedConfig(
            desired_accuracy=self.desired_accuracy,
            max_rounds=self.max_rounds,
            n_max=self.n_max,
            battery_threshold=self.battery_threshold,
            offered_incentive=self.offered_incentive,
            epochs=self.epochs,
            batch_size=self.batch_size,
            encrypt=self.encrypt,
            contributor_refresh_epochs=self.contributor_refresh_epochs,
            seed=world.seed,
            strategy=self.strategy,
            compress=self.compress,
            faults=self.faults,
            cadence=self.cadence,
            adversary=self.adversary,
            robust=self.robust,
            staleness_gamma=self.staleness_gamma,
            mobility=world.mobility)


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """How the run executes — never *what* it computes.

    ``engine="loop"`` is the readable session loop; ``"fleet"`` runs all
    requesters on one flat round state.  ``use_pallas=False`` is the
    caller's choice of the plain PyTorch twins instead of the hand-written
    kernels (the reference's name for the kernel path); ``interpret``
    (Pallas interpret mode) has no counterpart and accepts only None;
    ``round_chunk`` is the fleet's early-exit granularity.  ``enfed``,
    ``dfl`` and ``cfl`` honor the engine choice; ``cloud`` has no round
    structure and always records ``engine="loop"``.  Checkpointing
    (``checkpoint_dir``/``checkpoint_every``/``resume_from``) is
    enfed's resumable round state (every ``checkpoint_every`` rounds, 0 =
    the engine's default: every round on the loop, every ``round_chunk``
    on the fleet; ``resume_from`` continues from a directory's newest
    checkpoint with the bits of an uninterrupted run); the baselines warn
    and ignore it.  ``trace`` is a :class:`TraceConfig`.
    """

    engine: str = "loop"                 # "loop" | "fleet"
    use_pallas: bool = True
    interpret: Optional[bool] = None
    round_chunk: int = 4
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume_from: Optional[str] = None
    trace: Optional[object] = None

    def __post_init__(self):
        if self.engine not in ("loop", "fleet"):
            raise ValueError(f"unknown engine {self.engine!r} (loop|fleet)")
        check_interpret(self.interpret)
        if self.round_chunk < 1:
            raise ValueError(
                f"round_chunk must be >= 1 (got {self.round_chunk})")
        if self.checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0 (got {self.checkpoint_every})")
        if self.trace is not None and not isinstance(self.trace, TraceConfig):
            raise ValueError(
                f"trace must be a repro_torch.telemetry.TraceConfig "
                f"(got {type(self.trace).__name__})")
