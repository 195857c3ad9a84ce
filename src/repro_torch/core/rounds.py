"""EnFed Algorithm 1 — the requesting device's session loop (port of the
loop engine of ``repro.core.rounds``).

Handshake (contract selection + AES key exchange), then per round:
collect every contributor's update over AES-128-CTR, aggregate with
eq. 14, fit the requester's model with masked Adam over the counter-based
schedule, score it, and account for it (eqs. 4-7 and the battery); the
session stops on the desired accuracy, the battery threshold, or the
round budget.  The hot loops run through the port's kernel ops: the
cipher in ``core/crypto.py``, eq. 14 in ``core/aggregation.py``, the int8
wire in ``kernels/quantize`` and the LSTM cell in the classifier.

Under ``compress="int8"`` (or ``"auto"`` resolved to it) every transported
update is int8 codes plus one fp32 scale per 1024-element tile: the
contributors' states are packed at the handshake and after every refresh
(``_wire_pack``), the AES round trip runs over exactly those bytes, and
the refresh trains from the dequantized wire image (``_wire_image``), as
the fleet engine's int8 round state does.

Under ``adversary=AdversaryConfig(...)`` some delivered payloads are
corrupted (:mod:`repro_torch.core.adversary`): ``_collect_update`` applies
the attack to the outgoing wire image, before AES, keyed on the delivering
round.  Under ``robust != "none"`` AGGREGATE runs the robust statistic of
:mod:`repro_torch.kernels.robust.ops` over the (1, N, P) buffer instead of
eq. 14, records which contributors it clipped, and the report prices one
screening pass per executed round.

``run(engine="fleet")`` runs the session as a one-requester fleet
(:func:`repro_torch.core.fleet.run_fleet`).  This slice covers the static,
lockstep world: ``encrypt`` on or off, any ``strategy``, any ``compress``,
Byzantine contributors and the robust AGGREGATE.  Every other knob of
``EnFedConfig`` raises ``NotImplementedError`` naming the ``ROADMAP.md``
slice that ports it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import adversary as adversary_mod
from repro_torch.core import aggregation, crypto, protocol
from repro_torch.core.adversary import AdversaryConfig
from repro_torch.core.battery import BatteryState
from repro_torch.core.energy import CostModel, EnergyReport
from repro_torch.core.incentive import Contract, NeighborDevice, select_contributors
from repro_torch.core.topology import AggregationStrategy
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.quantize.ops import (compress_update, decompress_update,
                                              resolve_compress)
from repro_torch.kernels.robust.ops import ROBUST_METHODS, robust_aggregate
from repro_torch.utils.tree import (flatten_to_vector, tree_bytes, tree_size,
                                    unflatten_from_vector)


@dataclasses.dataclass
class EnFedConfig:
    desired_accuracy: float = 0.95   # A_A
    max_rounds: int = 10             # R_A  (paper sets 10)
    n_max: int = 5                   # N_max contributors (paper setup: 5 VMs)
    battery_threshold: float = 0.2   # B_min (paper: 20%)
    offered_incentive: float = 0.6
    epochs: int = 5                  # E  (local fit epochs per round)
    batch_size: int = 32             # B_A
    encrypt: bool = True
    contributor_refresh_epochs: int = 1  # contributors keep training between rounds
    seed: int = 0
    # which signed contributors feed eq. (14) each round (None = all)
    strategy: Optional[AggregationStrategy] = None
    compress: Optional[str] = None          # None | "int8" | "auto" wire format
    # mobility, faults, cadence and staleness_gamma < 1 belong to later
    # slices of the port; the engines raise NotImplementedError for them.
    mobility: Optional[object] = None       # opportunistic world: slice E
    faults: Optional[object] = None         # unreliable links: slice E
    cadence: Optional[object] = None        # asynchronous cadence: slice E
    adversary: Optional[AdversaryConfig] = None   # Byzantine contributors
    # robust AGGREGATE: "none" (eq. 14) | "clip" | "trimmed_mean" | "median"
    robust: str = "none"
    staleness_gamma: float = 1.0            # decayed weights: slice E

    def __post_init__(self):
        if self.compress not in (None, "int8", "auto"):
            raise ValueError(
                f"unknown compress mode {self.compress!r} (None|'int8'|'auto')")
        if self.robust not in ROBUST_METHODS:
            raise ValueError(
                f"robust must be one of {ROBUST_METHODS} (got {self.robust!r})")
        if not 0.0 <= self.staleness_gamma <= 1.0:
            raise ValueError(
                f"staleness_gamma must be within [0, 1] "
                f"(got {self.staleness_gamma})")


def _unported(cfg: EnFedConfig) -> Optional[str]:
    """The first knob of ``cfg`` this slice does not run, with its slice."""
    for name in ("mobility", "faults", "cadence"):
        if getattr(cfg, name) is not None:
            return f"{name} (world state, ROADMAP.md slice E)"
    if cfg.staleness_gamma < 1.0:
        return "staleness_gamma < 1 (decayed weights, ROADMAP.md slice E)"
    return None


@dataclasses.dataclass
class SessionResult:
    accuracy: float
    rounds: int
    n_contributors: int
    report: EnergyReport
    battery: BatteryState
    history_raw: Dict[str, List[float]] = dataclasses.field(repr=False,
                                                            compare=False)
    stop_reason: str
    params: object = None
    model_bytes: int = 0   # one update's wire bytes
    # wall seconds per protocol phase, each timed between device syncs
    phase_s: Dict[str, float] = dataclasses.field(default_factory=dict)


class EnFedSession:
    """One requesting device M building its model for application A.

    ``task`` provides ``fit``, ``evaluate`` and ``init`` (see
    :class:`repro_torch.core.federated.SupervisedTask`) on the session's
    ``device``, which is the GPU unless the caller names another; with no
    device named and no GPU present the session raises.
    ``contributor_states`` maps a device id to ``{"params", "data"}``.
    """

    def __init__(self, task, own_train, own_test, fleet: List[NeighborDevice],
                 contributor_states: Dict[int, dict],
                 cfg: Optional[EnFedConfig] = None,
                 cost_model: Optional[CostModel] = None,
                 battery: Optional[BatteryState] = None, *, device=None):
        self.device = resolve_device(device)
        if torch.device(task.device) != self.device:
            raise ValueError(f"the task runs on {task.device}, the session on "
                             f"{self.device}")
        self.task = task
        self.own_train = own_train
        self.own_test = own_test
        self.fleet = fleet
        self.contributor_states = contributor_states
        self.cfg = cfg if cfg is not None else EnFedConfig()
        self.cost = cost_model or CostModel()
        self.battery = battery or BatteryState()
        # "auto" resolves once, from the model size, as run_fleet resolves it
        self._compress = self.cfg.compress
        if self._compress == "auto" and contributor_states:
            template = next(iter(contributor_states.values()))["params"]
            self._compress = resolve_compress("auto", tree_size(template))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _clock(self, phase_s: Dict[str, float], phase: str):
        """Add the wall time of the block to ``phase_s[phase]``, with a
        device sync before each clock read."""
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        phase_s[phase] = phase_s.get(phase, 0.0) + time.perf_counter() - t0

    # -- protocol phases (protocol.Phase.HANDSHAKE) ---------------------------
    def handshake(self) -> List[Contract]:
        contracts = select_contributors(self.fleet, self.cfg.offered_incentive,
                                        self.cfg.n_max)
        rng = np.random.default_rng(self.cfg.seed)
        self.keys = {c.device_id: rng.integers(0, 256, 16).astype(np.uint8)
                     for c in contracts}
        self.nonces = {c.device_id: rng.integers(0, 256, 8).astype(np.uint8)
                       for c in contracts}
        self._wire = {}
        if self._compress == "int8":
            for c in contracts:
                self._wire_pack(c.device_id,
                                self.contributor_states[c.device_id]["params"])
        return contracts

    def _wire_pack(self, device_id: int, params):
        """Under int8 a contributor's transported state IS wire format:
        quantize ``params`` into the (q, scales) cache and return the
        dequantized image of that payload."""
        q, s, n = compress_update(flatten_to_vector(params)[0])
        self._wire[device_id] = (q, s, n)
        return unflatten_from_vector(decompress_update(q, s, n), params)

    def _wire_image(self, device_id: int, template):
        """The dequantized fp32 image of a cached wire payload: what the
        receiver (and the refresh trainer) sees."""
        q, s, n = self._wire[device_id]
        return unflatten_from_vector(decompress_update(q, s, n), template)

    def _collect_update(self, device_id: int, corrupt: bool = False, step: int = 0):
        """Phase.COLLECT: contributor -> (compress) -> (corrupt) ->
        (encrypt) -> wire -> (decrypt) -> (decompress).  Returns the
        received tree and its wire bytes.

        ``corrupt`` applies the adversary's attack to the outgoing payload,
        in wire format under int8 (codes and scales), keyed on the
        delivering round ``step``; the cipher then runs over the corrupted
        bytes.  The resident params and wire cache are never modified."""
        ac = self.cfg.adversary
        part = self.task.threefry_partitionable
        params = self.contributor_states[device_id]["params"]
        if self._compress == "int8":
            # the payload is the int8 codes followed by the little-endian
            # fp32 scales; CTR keeps the length, so the wire bytes are the
            # compressed count either way
            q, s, n = self._wire[device_id]
            if corrupt:
                q, s = adversary_mod.corrupt_wire(ac, q, s, True, step, ac.requester_id,
                                                  device_id, partitionable=part)
            if not self.cfg.encrypt:
                return (unflatten_from_vector(decompress_update(q, s, n), params),
                        int(q.shape[0]) + 4 * int(s.shape[0]))
            payload = torch.cat([q.view(torch.uint8), crypto.float_vector_to_bytes(s)])
            key, nonce = self.keys[device_id], self.nonces[device_id]
            cipher = crypto.encrypt_bytes(payload, key, nonce)
            plain = crypto.decrypt_bytes(cipher, key, nonce)
            nq = int(q.shape[0])
            qr = plain[:nq].view(torch.int8)
            sr = crypto.bytes_to_float_vector(plain[nq:])
            return (unflatten_from_vector(decompress_update(qr, sr, n), params),
                    int(cipher.shape[0]))
        if not self.cfg.encrypt and not corrupt:
            return params, tree_bytes(params)
        vec, _ = flatten_to_vector(params)
        if corrupt:
            vec = adversary_mod.corrupt_dense(ac, vec, True, step, ac.requester_id,
                                              device_id, partitionable=part)
        if not self.cfg.encrypt:
            return unflatten_from_vector(vec, params), tree_bytes(params)
        cipher = crypto.encrypt_update(vec, self.keys[device_id], self.nonces[device_id])
        plain = crypto.decrypt_update(cipher, self.keys[device_id], self.nonces[device_id])
        return unflatten_from_vector(plain, params), int(cipher.shape[0])

    def _robust_aggregate_full(self, updates, weights):
        """Phase.AGGREGATE under ``robust != "none"``: stack the delivered
        updates into a (1, N, P) buffer on the session's device and run the
        one :func:`repro_torch.kernels.robust.ops.robust_aggregate` the
        fleet also calls.  Returns the aggregated tree and the clipped
        mask (N,) as float32."""
        stacked = torch.stack([flatten_to_vector(u)[0] for u in updates])
        w = torch.from_numpy(np.ascontiguousarray(weights, np.float32)).to(stacked.device)
        agg, clipped = robust_aggregate(stacked[None], w[None], method=self.cfg.robust)
        return (unflatten_from_vector(agg[0], updates[0]),
                clipped[0].cpu().numpy().astype(np.float32))

    def _refresh_contributors(self, contracts: List[Contract]):
        """Phase.REFRESH: contributors keep improving between rounds.
        Under int8 a contributor trains from its wire image and its result
        is packed back into wire format."""
        if self.cfg.contributor_refresh_epochs <= 0:
            return
        compress = self._compress == "int8"
        for c in contracts:
            st = self.contributor_states[c.device_id]
            base = (self._wire_image(c.device_id, st["params"]) if compress
                    else st["params"])
            fitted, _ = self.task.fit(
                base, st["data"], self.cfg.contributor_refresh_epochs,
                self.cfg.batch_size, seed=self.cfg.seed + c.device_id)
            st["params"] = (self._wire_pack(c.device_id, fitted) if compress
                            else fitted)

    # -- Algorithm 1 ----------------------------------------------------------
    def run(self, engine: str = "loop", *, checkpoint_dir: Optional[str] = None,
            resume_from: Optional[str] = None) -> SessionResult:
        """Execute the session with the loop engine, or as a one-requester
        fleet (``engine="fleet"``)."""
        if engine == "fleet":
            from repro_torch.core import fleet as fleet_mod

            spec = fleet_mod.RequesterSpec(
                own_train=self.own_train, own_test=self.own_test,
                neighborhood=self.fleet,
                contributor_states=self.contributor_states,
                battery=self.battery)
            result = fleet_mod.run_fleet(self.task, [spec], self.cfg,
                                         cost_model=self.cost,
                                         checkpoint_dir=checkpoint_dir,
                                         resume_from=resume_from,
                                         device=self.device)
            self.battery = result.sessions[0].battery
            return result.sessions[0]
        if engine != "loop":
            raise ValueError(f"unknown engine {engine!r} (loop|fleet)")
        if checkpoint_dir is not None or resume_from is not None:
            raise NotImplementedError(
                "checkpoint/resume is ported with the fault world, ROADMAP.md slice E")
        unported = _unported(self.cfg)
        if unported is not None:
            raise NotImplementedError(f"{unported} is not ported yet")

        cfg = self.cfg
        phase_s: Dict[str, float] = {}
        with self._clock(phase_s, "handshake"):
            contracts = self.handshake()
        if not contracts:
            raise RuntimeError("no nearby device agreed to the incentive (N_d < 1)")
        n_c = len(contracts)
        round_w = protocol.round_weights(n_c, cfg.strategy)
        ids = np.array([c.device_id for c in contracts], np.int64)
        ac = cfg.adversary

        history = {"accuracy": [], "loss": [], "battery": [],
                   "round_executed": []}
        if ac is not None:
            history["corrupted_mask"] = []
        if cfg.robust != "none":
            history["clipped_mask"] = []
        params = None
        rounds = 0
        stop = protocol.STOP_MAX_ROUNDS
        model_bytes = 0

        for r in range(cfg.max_rounds):
            # Byzantine weather of this round: pure world state, keyed on
            # the delivering round (lockstep: the event step is r)
            cmask = (adversary_mod.corruption_mask(
                ac, r, ac.requester_id, ids,
                partitionable=self.task.threefry_partitionable).numpy()
                if ac is not None else np.zeros((n_c,), bool))
            with self._clock(phase_s, "collect"):
                updates = []
                for j, c in enumerate(contracts):
                    upd, nbytes = self._collect_update(c.device_id, corrupt=bool(cmask[j]),
                                                       step=r)
                    model_bytes = max(model_bytes, nbytes)
                    updates.append(upd)
            if ac is not None:
                history["corrupted_mask"].append(cmask.astype(np.float32))
            # Phase.AGGREGATE: eq. 14, or the robust statistic, in one
            # launch over the (1, N, P) buffer
            with self._clock(phase_s, "aggregate"):
                if cfg.robust != "none":
                    global_params, clipped = self._robust_aggregate_full(updates, round_w)
                    history["clipped_mask"].append(clipped)
                else:
                    global_params = aggregation.masked_fedavg(updates, round_w)
            with self._clock(phase_s, "fit"):
                params, losses = self.task.fit(global_params, self.own_train,
                                               cfg.epochs, cfg.batch_size,
                                               seed=cfg.seed + r)
            # Phase.SCORE
            with self._clock(phase_s, "score"):
                acc = float(self.task.evaluate(params, self.own_test))
            rounds = r + 1
            history["accuracy"].append(acc)
            history["loss"].append(float(losses[-1]))
            history["round_executed"].append(1.0)

            # Phase.ACCOUNT: battery bookkeeping for this round
            e_round = self.cost.round_energy(
                n_contrib=n_c, num_params=tree_size(params),
                model_bytes=model_bytes,
                num_samples=len(self.own_train[0]), epochs=cfg.epochs,
                n_devices=len(self.fleet), encrypt=cfg.encrypt)
            self.battery = self.battery.discharge(e_round,
                                                  avg_power_w=self.cost.device.p_train)
            history["battery"].append(self.battery.level)

            if acc >= cfg.desired_accuracy:
                stop = protocol.STOP_ACCURACY
                break
            if self.battery.below(cfg.battery_threshold):
                stop = protocol.STOP_BATTERY
                break
            with self._clock(phase_s, "refresh"):
                self._refresh_contributors(contracts)

        report = self.cost.session(
            rounds=rounds, n_contrib=n_c, num_params=tree_size(params),
            model_bytes=model_bytes, num_samples=len(self.own_train[0]),
            epochs=cfg.epochs, n_devices=len(self.fleet),
            measured_local_time=phase_s.get("fit", 0.0), encrypt=cfg.encrypt)
        if cfg.robust != "none" and rounds:
            # one screening pass over the N x P buffer per executed round,
            # priced post hoc (never drains the simulated battery)
            e_scr, t_scr = self.cost.screening_energy(n_contrib=n_c,
                                                      num_params=tree_size(params))
            report.times.t_agg += rounds * t_scr
            report.e_comp += rounds * e_scr
        return SessionResult(
            accuracy=history["accuracy"][-1], rounds=rounds, n_contributors=n_c,
            report=report, battery=self.battery, history_raw=history,
            stop_reason=protocol.stop_reason_name(stop), params=params,
            model_bytes=model_bytes, phase_s=phase_s)
