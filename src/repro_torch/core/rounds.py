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

Under ``mobility=MobilityConfig(...)`` the contract set is renegotiated
every round (:mod:`repro_torch.core.mobility`, ``_run_mobility``): the
handshake fixes the candidate pool and exchanges keys with all of it, the
requester owns its model from the start, and each round collects and
aggregates the current members only (a member-less round trains alone),
discharges the requester by the member count's entry of a per-count energy
table and the members' batteries by their transmit and refresh costs, and
refreshes the current members.

Under ``faults=FaultConfig(...)`` the links are unreliable
(:mod:`repro_torch.core.faults`): each round derives which attempting links
delivered, after how many attempts, and which delivered the round-(r-1)
image (``_snap_prev`` keeps it, in wire format under int8); only delivered
updates feed eq. 14, a round where every link failed trains the
requester's own params (which start as its init), the requester pays the
delivered count's entry of a per-count energy table plus one re-priced
receive window per drop or retry, and the retry windows are priced post
hoc into the report.  A streak-blocked link sits out (static world) or is
released at RENEGOTIATE (mobility), and under mobility each member pays
its transmit cost once per attempt.  ``staleness_gamma < 1`` weighs a
stale delivery ``gamma`` into eq. 14.

``run(engine="fleet")`` runs the session as a one-requester fleet
(:func:`repro_torch.core.fleet.run_fleet`), forwarding the execution knobs
(``use_pallas``, ``interpret``, ``round_chunk``, checkpointing,
``timeline``).  The loop engine records the reference's spans on
``timeline`` (``handshake``; ``transport`` around one round's collect;
``fit``; ``refresh``; ``checkpoint_save`` and ``checkpoint_restore``),
each closed after a device sync, and runs the plain PyTorch twins of every
kernel under ``use_pallas=False``.  ``checkpoint_dir`` saves the resumable
round state every ``checkpoint_every`` rounds (default: every round) in
the reference's layout (:mod:`repro_torch.checkpoint`; the int8 wire as
its codes and scales), and ``resume_from`` continues from the newest
checkpoint of a directory with the same bits as a run that was never
stopped.  The port runs every world of the reference: ``encrypt`` on or
off, any ``strategy``, any ``compress``, Byzantine contributors and the
robust AGGREGATE, unreliable links and staleness decay, in a static
neighbourhood or under mobility, in lockstep or on an asynchronous
cadence.

Under ``cadence=CadenceConfig(...)`` the session loops over global event
steps (:mod:`repro_torch.core.cadence`, ``_EventClock``): world state
(fault weather, streak blocks, the adversary, mobility) keys on the step
``t``, the requester's round clock ``r`` (its fit seed, its round budget)
advances only on its ticks, an idle step is counted and priced post hoc
through ``CostModel.idle_energy``, and a contributor refreshes only on its
own ticks, so a straggler's resident image is aggregated as-is (decayed by
``image_lag`` under ``staleness_gamma < 1``).  ``history_raw`` gains
``round_clock`` and ``idle_steps``.  ``cadence=None`` is one step per
round, ``t == r``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import adversary as adversary_mod
from repro_torch.core import aggregation, crypto, mobility, protocol, topology
from repro_torch.core import cadence as cadence_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core.adversary import AdversaryConfig
from repro_torch.core.battery import BatteryState
from repro_torch.core.cadence import CadenceConfig
from repro_torch.core.energy import CostModel, EnergyReport, update_wire_bytes
from repro_torch.core.faults import FaultConfig
from repro_torch.core.incentive import (Contract, NeighborDevice, candidate_pool,
                                        contracts_from_membership, select_contributors)
from repro_torch.core.mobility import MobilityConfig
from repro_torch.core.topology import AggregationStrategy
from repro_torch.kernels.common import check_interpret, plain_twins, resolve_device
from repro_torch.kernels.quantize.ops import (compress_update, decompress_update,
                                              resolve_compress)
from repro_torch.kernels.robust.ops import ROBUST_METHODS, robust_aggregate
from repro_torch.telemetry.spans import Timeline
from repro_torch.utils.tree import (flatten_to_vector, from_jax_params, tree_bytes,
                                    tree_size, unflatten_from_vector)


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
    # opportunistic world: the contract set is renegotiated every round
    mobility: Optional[MobilityConfig] = None
    # unreliable links: drops, bounded retries, stale delivery
    faults: Optional[FaultConfig] = None
    # asynchronous cadence: per-device round clocks on global event steps
    cadence: Optional[CadenceConfig] = None
    adversary: Optional[AdversaryConfig] = None   # Byzantine contributors
    # robust AGGREGATE: "none" (eq. 14) | "clip" | "trimmed_mean" | "median"
    robust: str = "none"
    # a stale delivery weighs gamma into eq. 14 (1.0: no decay)
    staleness_gamma: float = 1.0

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

    @property
    def trace(self):
        """The session as a normalized RoundEvent list (requester 0): the
        engine-independent view of ``history_raw``."""
        from repro_torch.telemetry.events import session_events

        return session_events(self)


# the loop engine's protocol phases that the timeline records, by span name
_PHASE_SPANS = {"handshake": "handshake", "collect": "transport", "fit": "fit",
                "refresh": "refresh"}


class _EventClock:
    """The loop engine's two clocks, the one gate of both its worlds: the
    global event step ``t`` the world keys on and the requester's round
    clock ``r`` that advances only on its ticks.  ``idle_run`` counts the
    idle steps since the last executed round.  Lockstep
    (``cadence=None``): one step per round, ``t == r``."""

    def __init__(self, cfg: EnFedConfig, partitionable: bool):
        self.cc = cfg.cadence
        self.max_rounds = cfg.max_rounds
        self.part = partitionable
        self.total = (cadence_mod.events_budget(self.cc, cfg.max_rounds)
                      if self.cc is not None else cfg.max_rounds)
        self.idle_run = 0

    def begin(self, history) -> None:
        if self.cc is not None:
            history.update(round_clock=[], idle_steps=[])

    def steps(self, t_start: int, r_start: int, level):
        """``(t, r)`` of every executed round from the restored clocks; a
        step where the requester (paced on ``level()``, its battery
        fraction, compared in fp32) does not tick is one idle step, and the
        steps end when the round budget is spent."""
        r = r_start
        for t in range(t_start, self.total):
            if self.cc is None:
                yield t, t
                continue
            if r >= self.max_rounds:
                return
            if not bool(cadence_mod.tick_mask(self.cc, t, self.cc.requester_id,
                                              level=np.float32(level()),
                                              partitionable=self.part)):
                self.idle_run += 1
                continue
            yield t, r
            r += 1

    def executed(self, history, t: int) -> None:
        """Record the executed round's step and the idle steps before it."""
        if self.cc is not None:
            history["round_clock"].append(t)
            history["idle_steps"].append(self.idle_run)
            self.idle_run = 0

    def contributor_ticks(self, t: int, ids) -> Optional[np.ndarray]:
        """Which contributors tick at ``t`` (and so refresh); None in
        lockstep, where every one does."""
        if self.cc is None:
            return None
        return cadence_mod.tick_mask(self.cc, t, np.asarray(ids, np.int64),
                                     partitionable=self.part).numpy()

    def lag(self, t: int, ids) -> np.ndarray:
        """Each contributor image's age at ``t`` in event steps (0 in
        lockstep), before a stale delivery's one more."""
        if self.cc is None:
            return np.zeros((len(ids),), np.int64)
        return cadence_mod.image_lag(self.cc, t, np.asarray(ids, np.int64),
                                     partitionable=self.part).numpy()

    def price(self, report: EnergyReport, cost: CostModel, history) -> None:
        """The session's idle steps, the trailing ones included, priced post
        hoc into ``t_com`` and ``e_comm``."""
        if self.cc is not None:
            report.add_idle(cost, int(sum(history["idle_steps"])) + self.idle_run,
                            self.cc.idle_step_s)


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
    def _clock(self, phase_s: Dict[str, float], phase: str, timeline: Timeline, **attrs):
        """Add the wall time of the block to ``phase_s[phase]``, with a
        device sync before each clock read; a phase the reference records
        is also a span of ``timeline``, opened and closed beside the
        clock reads."""
        self._sync()
        span = _PHASE_SPANS.get(phase)
        idx = timeline.begin(span, **attrs) if span is not None else None
        t0 = time.perf_counter()
        yield
        self._sync()
        phase_s[phase] = phase_s.get(phase, 0.0) + time.perf_counter() - t0
        if idx is not None:
            timeline.finish(idx)

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

    def _snap_prev(self, device_ids):
        """Phase.DELIVER bookkeeping under faults: keep this round's
        transported images, so a lagging link can deliver them next round.
        Taken before Phase.REFRESH rebinds the state; a reference suffices,
        since refresh and ``_wire_pack`` bind new tensors and never write
        into a snapshotted one (the fleet carries the same snapshot as a
        second wire-format buffer)."""
        if self._compress == "int8":
            self._prev_wire = {int(d): self._wire[int(d)] for d in device_ids}
        else:
            self._prev_params = {int(d): self.contributor_states[int(d)]["params"]
                                 for d in device_ids}

    def _collect_update(self, device_id: int, stale: bool = False, corrupt: bool = False,
                        step: int = 0):
        """Phase.COLLECT: contributor -> (compress) -> (corrupt) ->
        (encrypt) -> wire -> (decrypt) -> (decompress).  Returns the
        received tree and its wire bytes.

        ``stale`` sends the round-(r-1) image :meth:`_snap_prev` kept (the
        wire bytes, and so the pricing, are unchanged).  ``corrupt`` then
        applies the adversary's attack to the outgoing payload, in wire
        format under int8 (codes and scales), keyed on the delivering round
        ``step``: the stale image is chosen first, the corruption draw keys
        on the round that delivers it.  The cipher runs over the corrupted
        bytes.  The resident params and wire cache are never modified."""
        ac = self.cfg.adversary
        part = self.task.threefry_partitionable
        params = self.contributor_states[device_id]["params"]
        if stale and self._compress != "int8":
            params = self._prev_params[device_id]
        if self._compress == "int8":
            # the payload is the int8 codes followed by the little-endian
            # fp32 scales; CTR keeps the length, so the wire bytes are the
            # compressed count either way
            q, s, n = (self._prev_wire if stale else self._wire)[device_id]
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

    def _robust_aggregate_full(self, updates, lanes, w_full, template):
        """Phase.AGGREGATE under ``robust != "none"``: put the delivered
        updates at their ``lanes`` of the full-lane (1, N, P) buffer on the
        session's device (zero rows elsewhere, whose weight in ``w_full`` is
        0) and run the one
        :func:`repro_torch.kernels.robust.ops.robust_aggregate` the fleet
        also calls.  Returns the aggregated tree (shaped as ``template``)
        and the clipped mask over the full lane set as bool; an all-zero
        weight row aggregates to zeros, and the caller keeps its own
        params instead."""
        w = torch.from_numpy(np.ascontiguousarray(w_full, np.float32)).to(self.device)
        u = torch.zeros((1, w.shape[0], tree_size(template)), dtype=torch.float32,
                        device=self.device)
        for k, j in enumerate(lanes):
            u[0, int(j)] = flatten_to_vector(updates[k])[0]
        agg, clipped = robust_aggregate(u, w[None], method=self.cfg.robust)
        return unflatten_from_vector(agg[0], template), clipped[0].cpu().numpy()

    def _refresh_contributors(self, device_ids):
        """Phase.REFRESH: the contributors ``device_ids`` keep improving
        between rounds.  Under int8 a contributor trains from its wire image
        and its result is packed back into wire format."""
        if self.cfg.contributor_refresh_epochs <= 0:
            return
        compress = self._compress == "int8"
        for did in device_ids:
            st = self.contributor_states[did]
            base = self._wire_image(did, st["params"]) if compress else st["params"]
            fitted, _ = self.task.fit(
                base, st["data"], self.cfg.contributor_refresh_epochs,
                self.cfg.batch_size, seed=self.cfg.seed + did)
            st["params"] = self._wire_pack(did, fitted) if compress else fitted

    def _link_weather(self, r, ids):
        """Phase.DELIVER's world state at round ``r`` over the links
        ``ids``: ``(delivered, attempts, stale, blocked)`` as numpy."""
        fc, part = self.cfg.faults, self.task.threefry_partitionable
        ids_t = torch.as_tensor(ids, dtype=torch.int64)
        delivered, attempts, stale = faults_mod.link_outcomes(fc, r, fc.requester_id, ids_t,
                                                             partitionable=part)
        blocked = faults_mod.blocked_mask(fc, r, fc.requester_id, ids_t, partitionable=part)
        return delivered.numpy(), attempts.numpy(), stale.numpy(), blocked.numpy()

    def _faults_begin(self, history, ids, model_bytes):
        """Open the fault traces, snapshot round 0's stale images, and
        return one retry window's ``(e_rx, t_xfer)``."""
        history.update(drops=[], retries=[], stale=[], deliver_mask=[])
        self._snap_prev(ids)
        e_rx, _, t_xfer = self.cost.retry_energy(model_bytes=model_bytes,
                                                 encrypt=self.cfg.encrypt)
        return e_rx, t_xfer

    @staticmethod
    def _deliver(history, attempted, delivered, attempts, stale):
        """Phase.DELIVER's bookkeeping over the links ``attempted`` this
        round: appends the round's drop, retry and stale counts and its
        deliver mask to ``history``; returns the delivered mask (only an
        attempted link delivers) and the extra receive windows (drops plus
        retries)."""
        delivered = delivered & attempted
        drops = float(np.sum(attempted & ~delivered))
        retries = float(np.sum(np.where(attempted, attempts - 1, 0)))
        history["drops"].append(drops)
        history["retries"].append(retries)
        history["stale"].append(float(np.sum(delivered & stale)))
        history["deliver_mask"].append(delivered.astype(np.float32))
        return delivered, drops + retries

    # -- checkpointing (repro_torch.checkpoint) -------------------------------
    @staticmethod
    def _hist_pad(vals, n, width=None):
        """History lists as fixed-shape arrays, zero-padded to the round
        budget, so a mid-run checkpoint and the restore template agree."""
        if width is None:
            out = np.zeros((n,), np.float64)
            if vals:
                out[:len(vals)] = np.asarray(vals, np.float64)
        else:
            out = np.zeros((n, width), np.float32)
            if vals:
                out[:len(vals)] = np.stack([np.asarray(v, np.float32) for v in vals])
        return out

    def _state_payload(self, r_next, device_ids, params, history, rounds, fit_s,
                       retry_windows, model_bytes=0, util_rows=None, level=None,
                       t_next=0, idle_run=0):
        """The loop engine's resumable round state as one tree, under the
        reference's keys.  Wire-format state is saved as it is resident:
        under int8 the (codes, scales) cache and its stale snapshot, never
        a re-densified image."""
        cfg = self.cfg
        n_rounds = cfg.max_rounds
        ids = [int(d) for d in device_ids]
        pay = {
            "r": np.int64(r_next),
            "rounds": np.int64(rounds),
            "level": np.float64(self.battery.level),
            "fit_s": np.float64(fit_s),
            "retry_windows": np.float64(retry_windows),
            "model_bytes": np.int64(model_bytes),
            "params": params,
            "acc": self._hist_pad(history["accuracy"], n_rounds),
            "loss": self._hist_pad(history["loss"], n_rounds),
            "bat": self._hist_pad(history["battery"], n_rounds),
            "contrib": {str(d): self.contributor_states[d]["params"] for d in ids},
        }
        if self._compress == "int8":
            pay["wire"] = {str(d): {"q": self._wire[d][0], "s": self._wire[d][1]}
                           for d in ids}
        if cfg.faults is not None:
            pay["drops"] = self._hist_pad(history["drops"], n_rounds)
            pay["retries"] = self._hist_pad(history["retries"], n_rounds)
            pay["stale"] = self._hist_pad(history["stale"], n_rounds)
            pay["deliver"] = self._hist_pad(history["deliver_mask"], n_rounds, len(ids))
            if self._compress == "int8":
                pay["prev_wire"] = {str(d): {"q": self._prev_wire[d][0],
                                             "s": self._prev_wire[d][1]} for d in ids}
            else:
                pay["prev"] = {str(d): self._prev_params[d] for d in ids}
        if cfg.adversary is not None:   # the corruption trail
            pay["corrupt_h"] = self._hist_pad(history["corrupted_mask"], n_rounds, len(ids))
        if cfg.robust != "none":        # the clip trail
            pay["clip_h"] = self._hist_pad(history["clipped_mask"], n_rounds, len(ids))
        if util_rows is not None:       # the mobility world
            pay["clevel"] = level
            pay["members"] = self._hist_pad(history["members"], n_rounds)
            pay["member_h"] = self._hist_pad(history["member_mask"], n_rounds, len(ids))
            pay["util_h"] = self._hist_pad(util_rows, n_rounds, len(ids))
        if cfg.cadence is not None:     # the event clock
            pay["t"] = np.int64(t_next)
            pay["idle_run"] = np.int64(idle_run)
            pay["clock_h"] = self._hist_pad(history["round_clock"], n_rounds)
            pay["idle_h"] = self._hist_pad(history["idle_steps"], n_rounds)
        return pay

    def _on_device(self, tree):
        """A restored host tree (numpy leaves) as tensors on the session's
        device."""
        return from_jax_params(tree, self.device)

    def _restore_state(self, resume_from, template):
        """Restore a :meth:`_state_payload` checkpoint (dtype-strict) and
        rebind the session-held pieces: battery, contributor params, wire
        and stale caches.  Returns the payload (host numpy) for the caller
        to unpack its loop state from."""
        from repro_torch.checkpoint import restore_checkpoint

        pay, _ = restore_checkpoint(resume_from, template)
        self.battery = dataclasses.replace(self.battery, level=float(pay["level"]))
        for key, st in pay["contrib"].items():
            self.contributor_states[int(key)]["params"] = self._on_device(st)
        for name, cache in (("wire", "_wire"), ("prev_wire", "_prev_wire")):
            for key, w in pay.get(name, {}).items():
                did = int(key)
                n = tree_size(self.contributor_states[did]["params"])
                getattr(self, cache)[did] = (self._on_device(w["q"]),
                                             self._on_device(w["s"]), n)
        for key, st in pay.get("prev", {}).items():
            self._prev_params[int(key)] = self._on_device(st)
        return pay

    @staticmethod
    def _refill_history(history, pay, rounds):
        """The history lists of the ``rounds`` restored rounds."""
        history["accuracy"] = [float(v) for v in pay["acc"][:rounds]]
        history["loss"] = [float(v) for v in pay["loss"][:rounds]]
        history["battery"] = [float(v) for v in pay["bat"][:rounds]]
        # every round the loop engine recorded executed
        history["round_executed"] = [1.0] * rounds
        for key, name in (("corrupt_h", "corrupted_mask"), ("clip_h", "clipped_mask"),
                          ("deliver", "deliver_mask")):
            if key in pay:
                history[name] = [row.copy() for row in pay[key][:rounds]]
        for key in ("drops", "retries", "stale"):
            if key in pay:
                history[key] = [float(v) for v in pay[key][:rounds]]
        for key, name in (("clock_h", "round_clock"), ("idle_h", "idle_steps")):
            if key in pay:
                history[name] = [int(v) for v in pay[key][:rounds]]

    @staticmethod
    def _normalize_ckpt(checkpoint_dir, checkpoint_every):
        if checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got {checkpoint_every}")
        if checkpoint_dir is not None and checkpoint_every == 0:
            checkpoint_every = 1   # the loop engine saves every round by default
        return checkpoint_every

    def _resume(self, tl, resume_from, template, history, clock):
        """Restore a checkpoint against ``template`` (a :meth:`_state_payload`
        of the empty session): rebinds the session-held pieces, refills the
        history and the event clock.  Returns ``(pay, t_start, r_start,
        rounds, params, fit_s)``."""
        with tl.span("checkpoint_restore"):
            pay = self._restore_state(resume_from, template)
        r_start, rounds = int(pay["r"]), int(pay["rounds"])
        self._refill_history(history, pay, rounds)
        t_start = r_start
        if "t" in pay:
            t_start, clock.idle_run = int(pay["t"]), int(pay["idle_run"])
        return (pay, t_start, r_start, rounds, self._on_device(pay["params"]),
                float(pay["fit_s"]))

    def _save(self, tl, checkpoint_dir, r, payload):
        from repro_torch.checkpoint import save_checkpoint

        with tl.span("checkpoint_save", round=r):
            save_checkpoint(checkpoint_dir, r + 1, payload)

    # -- Algorithm 1 ----------------------------------------------------------
    def run(self, engine: str = "loop", *, use_pallas: bool = True,
            interpret: Optional[bool] = None, round_chunk: int = 4,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume_from: Optional[str] = None,
            timeline: Optional[Timeline] = None) -> SessionResult:
        """Execute the session with the loop engine, or as a one-requester
        fleet (``engine="fleet"``), forwarding the execution knobs to
        ``run_fleet``.  ``use_pallas=False`` runs the plain PyTorch twins of
        the kernels; ``interpret`` accepts only None; ``round_chunk`` is the
        fleet's early-exit granularity; ``checkpoint_dir`` saves the
        resumable round state every ``checkpoint_every`` rounds (loop
        default: every round; fleet default: every ``round_chunk``), and
        ``resume_from`` continues from a directory's newest checkpoint with
        the bits of an uninterrupted run; ``timeline`` records the spans.

        Note: prefer the :mod:`repro_torch.api` facade
        (``Experiment(world, method, execution).run()``)."""
        check_interpret(interpret)
        if engine == "fleet":
            from repro_torch.core import fleet as fleet_mod

            spec = fleet_mod.RequesterSpec(
                own_train=self.own_train, own_test=self.own_test,
                neighborhood=self.fleet,
                contributor_states=self.contributor_states,
                battery=self.battery)
            result = fleet_mod.run_fleet(self.task, [spec], self.cfg,
                                         cost_model=self.cost,
                                         use_pallas=use_pallas,
                                         interpret=interpret,
                                         round_chunk=round_chunk,
                                         checkpoint_dir=checkpoint_dir,
                                         checkpoint_every=checkpoint_every,
                                         resume_from=resume_from,
                                         timeline=timeline,
                                         device=self.device)
            self.battery = result.sessions[0].battery
            return result.sessions[0]
        if engine != "loop":
            raise ValueError(f"unknown engine {engine!r} (loop|fleet)")
        every = self._normalize_ckpt(checkpoint_dir, checkpoint_every)
        tl = timeline if timeline is not None else Timeline()
        ckpt = (checkpoint_dir, every, resume_from)
        with contextlib.nullcontext() if use_pallas else plain_twins():
            if self.cfg.mobility is not None:
                return self._run_mobility(tl, *ckpt)
            return self._run_loop(tl, *ckpt)

    def _run_loop(self, tl: Timeline, checkpoint_dir=None, checkpoint_every=0,
                  resume_from=None) -> SessionResult:
        """Algorithm 1 on the loop engine, its phases timed into ``tl``."""
        cfg = self.cfg
        fc = cfg.faults
        phase_s: Dict[str, float] = {}
        with self._clock(phase_s, "handshake", tl):
            contracts = self.handshake()
        if not contracts:
            raise RuntimeError("no nearby device agreed to the incentive (N_d < 1)")
        n_c = len(contracts)
        round_w = protocol.round_weights(n_c, cfg.strategy)
        ids = np.array([c.device_id for c in contracts], np.int64)
        ac = cfg.adversary
        gamma = float(cfg.staleness_gamma)

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
        retry_windows = 0.0
        e_rx_retry = t_retry = 0.0
        if fc is not None:
            # the requester owns its model from the start: a round where
            # every link failed trains it alone
            params = self.task.init(seed=cfg.seed)
            num_params = tree_size(params)
            model_bytes = update_wire_bytes(num_params, encrypt=cfg.encrypt,
                                            compress=self._compress,
                                            raw_bytes=tree_bytes(params))
            e_tab = np.array(self.cost.round_energy_table(
                max_contrib=n_c, num_params=num_params, model_bytes=model_bytes,
                num_samples=len(self.own_train[0]), epochs=cfg.epochs,
                n_devices=len(self.fleet), encrypt=cfg.encrypt), np.float64)
            # every drop or retry is one more receive window
            e_rx_retry, t_retry = self._faults_begin(history, ids, model_bytes)
        clock = _EventClock(cfg, self.task.threefry_partitionable)
        clock.begin(history)

        t_start = r_start = 0
        if resume_from is not None:
            template = params if params is not None else self.task.init(seed=cfg.seed)
            pay, t_start, r_start, rounds, params, phase_s["fit"] = self._resume(
                tl, resume_from, self._state_payload(0, ids, template, history, 0, 0.0, 0.0,
                                                     model_bytes=model_bytes),
                history, clock)
            retry_windows = float(pay["retry_windows"])
            model_bytes = int(pay["model_bytes"])

        for t, r in clock.steps(t_start, r_start, lambda: self.battery.level):
            ctick = clock.contributor_ticks(t, ids)
            # Byzantine weather of this step: pure world state, keyed on the
            # delivering event step
            cmask = (adversary_mod.corruption_mask(
                ac, t, ac.requester_id, ids,
                partitionable=self.task.threefry_partitionable).numpy()
                if ac is not None else np.zeros((n_c,), bool))
            stale = np.zeros((n_c,), bool)
            if fc is not None:
                # Phase.DELIVER: streak-blocked links sit the round out
                delivered, attempts, stale, blocked = self._link_weather(t, ids)
                delivered, extra = self._deliver(history, ~blocked, delivered, attempts, stale)
            else:
                delivered = np.ones((n_c,), bool)
            lanes = np.nonzero(delivered)[0]
            with self._clock(phase_s, "collect", tl, round=r):
                updates = []
                for j in lanes:
                    upd, nbytes = self._collect_update(int(ids[j]), stale=bool(stale[j]),
                                                       corrupt=bool(cmask[j]), step=t)
                    model_bytes = max(model_bytes, nbytes)
                    updates.append(upd)
            if ac is not None:
                history["corrupted_mask"].append((cmask & delivered).astype(np.float32))
            # an image's age in event steps, one more for a stale delivery:
            # it weighs gamma**lag into eq. 14
            w_eff = round_w
            if gamma < 1.0:
                w_eff = protocol.decayed_round_weights(
                    round_w, clock.lag(t, ids) + (delivered & stale), gamma).numpy()
            # Phase.AGGREGATE: eq. 14 over the delivered updates, or the
            # robust statistic over the full lane buffer, in one launch
            with self._clock(phase_s, "aggregate", tl):
                if cfg.robust != "none":
                    template = params if params is not None else updates[0]
                    global_params, clipped = self._robust_aggregate_full(
                        updates, lanes, w_eff * delivered.astype(np.float32), template)
                    history["clipped_mask"].append(clipped.astype(np.float32))
                    if not updates:
                        global_params = params     # every link failed this round
                elif updates:
                    global_params = aggregation.masked_fedavg(updates, w_eff[lanes])
                else:
                    global_params = params         # every link failed this round
            with self._clock(phase_s, "fit", tl, round=r):
                params, losses = self.task.fit(global_params, self.own_train,
                                               cfg.epochs, cfg.batch_size,
                                               seed=cfg.seed + r)
            # Phase.SCORE
            with self._clock(phase_s, "score", tl):
                acc = float(self.task.evaluate(params, self.own_test))
            rounds = r + 1
            history["accuracy"].append(acc)
            history["loss"].append(float(losses[-1]))
            history["round_executed"].append(1.0)
            clock.executed(history, t)

            # Phase.ACCOUNT: battery bookkeeping for this round; under faults
            # the delivered count's table entry plus one receive window per
            # drop or retry
            if fc is not None:
                retry_windows += extra
                e_round = float(e_tab[len(updates)]) + extra * e_rx_retry
            else:
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
            if fc is not None:
                self._snap_prev(ids)       # next round's stale images
            # Phase.REFRESH: under cadence only the contributors that tick
            # this step (a straggler's resident image stays as it is)
            with self._clock(phase_s, "refresh", tl, round=r):
                self._refresh_contributors([int(d) for j, d in enumerate(ids)
                                            if ctick is None or ctick[j]])
            if checkpoint_dir is not None and (r + 1) % checkpoint_every == 0:
                self._save(tl, checkpoint_dir, r, self._state_payload(
                    r + 1, ids, params, history, rounds, phase_s.get("fit", 0.0),
                    retry_windows, model_bytes=model_bytes, t_next=t + 1,
                    idle_run=clock.idle_run))

        report = self.cost.session(
            rounds=rounds, n_contrib=n_c, num_params=tree_size(params),
            model_bytes=model_bytes, num_samples=len(self.own_train[0]),
            epochs=cfg.epochs, n_devices=len(self.fleet),
            measured_local_time=phase_s.get("fit", 0.0), encrypt=cfg.encrypt)
        report.add_transfers(retry_windows, t_retry, e_rx_retry)
        if cfg.robust != "none" and rounds:
            # one screening pass over the N x P buffer per executed round,
            # priced post hoc (never drains the simulated battery)
            e_scr, t_scr = self.cost.screening_energy(n_contrib=n_c,
                                                      num_params=tree_size(params))
            report.times.t_agg += rounds * t_scr
            report.e_comp += rounds * e_scr
        clock.price(report, self.cost, history)
        return SessionResult(
            accuracy=history["accuracy"][-1], rounds=rounds, n_contributors=n_c,
            report=report, battery=self.battery, history_raw=history,
            stop_reason=protocol.stop_reason_name(stop), params=params,
            model_bytes=model_bytes, phase_s=phase_s)

    # -- Algorithm 1 in the opportunistic world (repro_torch.core.mobility) ---
    def _run_mobility(self, tl: Timeline, checkpoint_dir=None, checkpoint_every=0,
                      resume_from=None) -> SessionResult:
        """Algorithm 1 with Phase.RENEGOTIATE every round: contributors that
        walked out of radio range or reached the battery floor are released,
        in-range arrivals are signed, a higher-utility arrival displaces the
        weakest member.  The membership, weights and contributor batteries
        go through the functions the fleet engine calls
        (:mod:`repro_torch.core.mobility`,
        ``topology.dynamic_round_weights``), here on the host.  Under faults
        a streak-blocked link is released at RENEGOTIATE and only the
        delivered members feed eq. 14."""
        cfg = self.cfg
        mob, fc = cfg.mobility, cfg.faults
        part = self.task.threefry_partitionable
        phase_s: Dict[str, float] = {}
        # Phase.HANDSHAKE fixes the candidate pool and exchanges keys with
        # all of it: any candidate may be signed in a later round
        with self._clock(phase_s, "handshake", tl):
            cands = candidate_pool(self.fleet, cfg.offered_incentive)
            rng = np.random.default_rng(cfg.seed)
            self.keys = {d.device_id: rng.integers(0, 256, 16).astype(np.uint8)
                         for d in cands}
            self.nonces = {d.device_id: rng.integers(0, 256, 8).astype(np.uint8)
                           for d in cands}
            self._wire = {}
            if self._compress == "int8":
                for d in cands:
                    self._wire_pack(d.device_id, self.contributor_states[d.device_id]["params"])
        if not cands:
            raise RuntimeError("no nearby device agreed to the incentive (N_d < 1)")
        n_cand = len(cands)
        ids = torch.tensor([d.device_id for d in cands], dtype=torch.int64)
        base_util = mobility.static_utility_term(
            np.array([d.model_staleness for d in cands], np.float32),
            np.array([d.data_size for d in cands], np.float32),
            np.float32(max(d.data_size for d in cands)))
        level = torch.from_numpy(np.array([d.battery_level for d in cands], np.float32))
        cand_mask = torch.ones((n_cand,), dtype=torch.bool)

        # the requester owns its model from the start: a round may have no
        # member to take a first update from
        params = self.task.init(seed=cfg.seed)
        num_params = tree_size(params)
        model_bytes = update_wire_bytes(num_params, encrypt=cfg.encrypt,
                                        compress=self._compress,
                                        raw_bytes=tree_bytes(params))
        e_tab = np.array(self.cost.round_energy_table(
            max_contrib=n_cand, num_params=num_params, model_bytes=model_bytes,
            num_samples=len(self.own_train[0]), epochs=cfg.epochs,
            n_devices=len(self.fleet), encrypt=cfg.encrypt), np.float32)
        e_tx, e_ref = (torch.from_numpy(np.array(v, np.float32)) for v in zip(*(
            self.cost.contributor_round_energy(
                num_params=num_params, model_bytes=model_bytes,
                num_samples=len(self.contributor_states[d.device_id]["data"][0]),
                refresh_epochs=cfg.contributor_refresh_epochs, encrypt=cfg.encrypt)
            for d in cands)))

        ac = cfg.adversary
        gamma = float(cfg.staleness_gamma)
        history = {"accuracy": [], "loss": [], "battery": [], "round_executed": [],
                   "members": [], "member_mask": [], "contracts": []}
        if ac is not None:
            history["corrupted_mask"] = []
        if cfg.robust != "none":
            history["clipped_mask"] = []
        util_rows: List[np.ndarray] = []
        rounds = 0
        stop = protocol.STOP_MAX_ROUNDS
        retry_windows = 0.0
        e_rx_retry = t_retry = 0.0
        if fc is not None:
            e_rx_retry, t_retry = self._faults_begin(history, ids.tolist(), model_bytes)
        clock = _EventClock(cfg, part)
        clock.begin(history)

        t_start = r_start = 0
        if resume_from is not None:
            pay, t_start, r_start, rounds, params, phase_s["fit"] = self._resume(
                tl, resume_from, self._state_payload(0, ids.tolist(), params, history, 0, 0.0,
                                                     0.0, util_rows=util_rows, level=level),
                history, clock)
            retry_windows = float(pay["retry_windows"])
            level = torch.from_numpy(np.array(pay["clevel"], np.float32))
            history["members"] = [float(v) for v in pay["members"][:rounds]]
            history["member_mask"] = [row.copy() for row in pay["member_h"][:rounds]]
            util_rows = [row.copy() for row in pay["util_h"][:rounds]]
            # contracts are a function of (membership, utility)
            history["contracts"] = [contracts_from_membership(
                cands, pay["member_h"][rr] > 0, pay["util_h"][rr], cfg.offered_incentive)
                for rr in range(rounds)]

        for t, r in clock.steps(t_start, r_start, lambda: self.battery.level):
            ctick = clock.contributor_ticks(t, ids)
            # Phase.RENEGOTIATE on this event step: release, sign, undercut;
            # under faults a streak-blocked link loses eligibility too
            blocked = None
            if fc is not None:
                delivered, attempts, stale, blocked = self._link_weather(t, ids)
            member_t, rank, util = mobility.membership_step(
                mob, t, mob.requester_id, ids, cand_mask, base_util, level, cfg.n_max,
                blocked=blocked, partitionable=part)
            round_w = topology.dynamic_round_weights(member_t, rank, cfg.strategy).numpy()
            member = member_t.numpy()
            count = int(member.sum())
            util_rows.append(util.numpy())
            history["member_mask"].append(member.astype(np.float32))
            history["members"].append(float(count))
            history["contracts"].append(contracts_from_membership(
                cands, member, util, cfg.offered_incentive))
            # Byzantine weather of this round; a corrupted link counts only
            # when its update is aggregated
            cmask = (adversary_mod.corruption_mask(ac, t, ac.requester_id, ids,
                                                   partitionable=part).numpy()
                     if ac is not None else np.zeros((n_cand,), bool))
            # Phase.DELIVER: which members' updates arrive
            if fc is not None:
                agg_mask, extra = self._deliver(history, member, delivered, attempts, stale)
            else:
                agg_mask, stale = member, np.zeros((n_cand,), bool)
            if ac is not None:
                history["corrupted_mask"].append((cmask & agg_mask).astype(np.float32))
            w_eff = round_w
            if gamma < 1.0:
                w_eff = protocol.decayed_round_weights(
                    round_w, clock.lag(t, ids) + (agg_mask & stale), gamma).numpy()
            # Phase.COLLECT + Phase.AGGREGATE over the aggregated lanes, in
            # lane order (the fleet's full-lane masked reduction, bit for bit)
            lanes = np.nonzero(agg_mask)[0]
            updates = []
            if len(lanes):
                with self._clock(phase_s, "collect", tl, round=r):
                    updates = [self._collect_update(int(ids[j]), stale=bool(stale[j]),
                                                    corrupt=bool(cmask[j]), step=t)[0]
                               for j in lanes]
            with self._clock(phase_s, "aggregate", tl):
                if cfg.robust != "none":
                    global_params, clipped = self._robust_aggregate_full(
                        updates, lanes, w_eff * agg_mask.astype(np.float32), params)
                    history["clipped_mask"].append(clipped.astype(np.float32))
                    if not updates:
                        global_params = params      # alone this round
                elif updates:
                    global_params = aggregation.masked_fedavg(updates, w_eff[lanes])
                else:
                    global_params = params          # alone this round
            # Phase.FIT + Phase.SCORE
            with self._clock(phase_s, "fit", tl, round=r):
                params, losses = self.task.fit(global_params, self.own_train, cfg.epochs,
                                               cfg.batch_size, seed=cfg.seed + r)
            with self._clock(phase_s, "score", tl):
                acc = float(self.task.evaluate(params, self.own_test))
            rounds = r + 1
            history["accuracy"].append(acc)
            history["loss"].append(float(losses[-1]))
            history["round_executed"].append(1.0)
            clock.executed(history, t)

            # Phase.ACCOUNT: the requester pays the aggregated count's entry,
            # under faults plus one receive window per drop or retry
            e_r = float(e_tab[len(updates) if fc is not None else count])
            if fc is not None:
                retry_windows += extra
                e_r += extra * float(e_rx_retry)
            self.battery = self.battery.discharge(e_r, avg_power_w=self.cost.device.p_train)
            history["battery"].append(self.battery.level)
            if acc >= cfg.desired_accuracy:
                stop = protocol.STOP_ACCURACY
            elif self.battery.below(cfg.battery_threshold):
                stop = protocol.STOP_BATTERY
            # members paid their transmission (once per attempt under
            # faults); the refresh term only while the session goes on (the
            # last budget round still refreshes) and, under cadence, only
            # where the member ticks this step
            continuing = stop == protocol.STOP_MAX_ROUNDS
            refresh = member if ctick is None else member & ctick
            e_tx_round = (e_tx * torch.from_numpy(attempts).to(torch.float32)
                          if fc is not None else e_tx)
            level = mobility.contributor_discharge(
                level, member_t, e_tx_round, e_ref,
                continuing if ctick is None else continuing & torch.from_numpy(ctick),
                mob.contributor_capacity_j)
            if not continuing:
                break
            if fc is not None:
                self._snap_prev(ids.tolist())    # next round's stale images
            # Phase.REFRESH for the current members only (under cadence the
            # ticking ones)
            if cfg.contributor_refresh_epochs > 0:
                with self._clock(phase_s, "refresh", tl, round=r):
                    self._refresh_contributors([int(ids[j]) for j in np.nonzero(refresh)[0]])
            if checkpoint_dir is not None and (r + 1) % checkpoint_every == 0:
                self._save(tl, checkpoint_dir, r, self._state_payload(
                    r + 1, ids.tolist(), params, history, rounds, phase_s.get("fit", 0.0),
                    retry_windows, model_bytes=model_bytes, util_rows=util_rows,
                    level=level, t_next=t + 1, idle_run=clock.idle_run))

        mean_members = float(np.mean(history["members"])) if rounds else 0.0
        report = self.cost.session(
            rounds=rounds, n_contrib=mean_members, num_params=num_params,
            model_bytes=model_bytes, num_samples=len(self.own_train[0]),
            epochs=cfg.epochs, n_devices=len(self.fleet),
            measured_local_time=phase_s.get("fit", 0.0), encrypt=cfg.encrypt)
        report.add_transfers(retry_windows, t_retry, e_rx_retry)
        if cfg.robust != "none" and rounds:
            # one screening pass over the full candidate-lane buffer per
            # executed round, priced post hoc
            e_scr, t_scr = self.cost.screening_energy(n_contrib=n_cand,
                                                      num_params=num_params)
            report.times.t_agg += rounds * t_scr
            report.e_comp += rounds * e_scr
        clock.price(report, self.cost, history)
        return SessionResult(
            accuracy=history["accuracy"][-1], rounds=rounds, n_contributors=n_cand,
            report=report, battery=self.battery, history_raw=history,
            stop_reason=protocol.stop_reason_name(stop), params=params,
            model_bytes=model_bytes, phase_s=phase_s)
