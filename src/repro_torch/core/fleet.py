"""The EnFed fleet engine: R requester sessions advancing together on one
flat round state (port of ``repro.core.fleet.run_fleet`` in every world:
static or mobile neighbourhoods, honest, Byzantine or unreliable links, in
lockstep or on an asynchronous cadence).

Design, as in the reference:

* **Flat round state.**  Contributor params are raveled once at staging
  into an (R, N, P) fp32 buffer: R requesters, N = ``n_max`` contributor
  slots, P flat parameters.  Under ``compress="int8"`` it is carried as
  (R, N, Lp) int8 codes plus (R, N, Lp / 1024) fp32 scales, the wire
  format, and never persists at full precision.
* **One launch per phase for the whole fleet.**  AGGREGATE is one eq. 14
  launch over the buffer (``fedavg_flat_batched``, or the fused
  ``fedavg_flat_batched_q8`` on the int8 state).  FIT trains all R
  requesters as lanes of one model call: params carry a leading lane axis
  (views of an (R, P) buffer, :func:`repro_torch.utils.tree.tree_unravel`),
  the LSTM cell runs all lanes in one launch, and Adam updates the flat
  buffer with a per-lane step count.  SCORE and ACCOUNT are lane-wise
  tensor ops, the battery in fp32 as the reference's traced discharge.
* **Schedule.**  In a lockstep world every requester scores its samples
  with ``seed + r``, so one batched stable argsort plans all lanes
  (:func:`repro_torch.core.schedule.lane_plans`); the plan is built on the
  host, where it also tells which (lane, step) pairs carry weight.  The
  refresh plan (``seed + device_id``) is built once per run.
* **Deduplicated shards and refresh.**  Contributor shards are staged once
  per unique content (blake2b key) into a table plus gather indices.  In a
  static world every lane subscribed to the same (device, shard, params)
  follows the same refresh trajectory, so REFRESH trains V unique rows and
  scatters them to the lanes whose session goes on.  Under int8 the rows
  are trained from their dequantized image and requantized
  (``quantize_flat_batched``).
* **Early exit.**  The round loop runs in chunks of ``round_chunk`` rounds,
  as the reference's chunked ``while_loop``: the host reads "is any lane
  still active?" once per chunk, one small sync beside thousands of
  launches.  A round that runs inside a chunk after every lane has stopped
  changes no state (every write is masked by the lanes' activity) and
  records 0 in ``round_executed``, which the device keeps as ``any(active)``
  and the host reads at unpack, so every output is the same bits whatever
  the chunk.

* **Byzantine world.**  Under ``adversary=`` lane ``i`` draws its
  corruption weather as requester ``requester_id + i`` over its
  contributors' real device ids, and the round body corrupts a copy of
  the delivered buffer (codes and scales under int8, whose padding tail
  is then zeroed so noise codes there cannot reach the q8 norms); the
  carried state is never overwritten.  Under ``robust != "none"`` the
  robust statistic of :mod:`repro_torch.kernels.robust.ops` replaces
  eq. 14, on the fused int8 state or the fp32 one.

* **Opportunistic world.**  Under ``mobility=`` the N lanes of requester
  i hold its candidate pool and lane i walks as device
  ``requester_id + i``.  Each round renegotiates membership on the device
  (:func:`repro_torch.core.mobility.membership_step` on the round number,
  the candidates' batteries carried as an (R, N) tensor), and the member
  mask, through ``dynamic_round_weights``, is the weight row of the one
  eq. 14 launch; a lane with no member keeps its own params, which start
  as the requester's init.  The requester discharges by a per-count energy
  table gathered at the member count, the members by their transmit and
  refresh costs.  Membership gaps make lanes diverge, so REFRESH trains
  every one of the R·N lanes (no dedup) and a lane takes its result only
  where it is a member of a session that goes on; the lanes' plans depend
  only on (device seed, shard) and are built once.  ``history["member"]``
  traces the (max_rounds, R, N) membership.

* **Unreliable links.**  Under ``faults=`` lane ``i`` rolls its link
  dice as requester ``requester_id + i`` over its lanes' device ids; every
  round's (delivered, attempts, stale, blocked) outcomes are drawn on the
  device at staging, by :func:`repro_torch.core.faults.link_outcomes` and
  :func:`~repro_torch.core.faults.blocked_mask` over the rounds ``0 ... T-1``.  The delivered mask multiplies into eq. 14's weights
  (times ``gamma`` for a stale delivery under ``staleness_gamma < 1``), a
  stale link's row is taken from ``prev``, the previous round's state in
  its wire format, before any corruption, a lane where nothing was
  delivered keeps its own params (which start as the requester's init),
  and the requester pays the delivered count's entry of the per-count
  energy table plus one receive window per drop or retry.  Under mobility
  a streak-blocked link is released at RENEGOTIATE and members pay their
  transmit cost once per attempt.

* **Asynchronous cadence.**  Under ``cadence=`` the loop runs over global
  event steps (:func:`repro_torch.core.cadence.events_budget` of them):
  lane i ticks as requester ``requester_id + i`` (paced on its carried
  battery), contributors by their real device ids.  The host reads each
  step's (R,) tick mask once (one sync a step): a step where no lane
  ticks only counts the active lanes' idle steps on the device; otherwise
  the round body runs with the ticking lanes executing, each fitting from
  the plan of its own round clock (``seed + clock``, one plan per distinct
  clock, from a host mirror of the clocks) and writing its traces at the
  row of that clock.  Only executing lanes discharge, stop, re-snapshot
  ``prev`` and advance their clocks.  World state (fault weather, the
  adversary, mobility) keys on the step; fault weather, contributor ticks
  and image lags are staged over every step at once.  REFRESH takes the
  per-lane path, and a contributor refreshes only where it ticks, so a
  straggler's resident image is aggregated as-is (decayed by ``image_lag``
  under ``staleness_gamma < 1``).  Idle steps are priced post hoc through
  ``CostModel.idle_energy``.

* **Checkpoint/resume.**  The round state is one :class:`FleetCarry`.
  ``checkpoint_dir`` saves it as ``{"r0", "state"}`` after every
  ``checkpoint_every`` rounds (event steps under cadence; default and
  rounding: the chunk), through
  :mod:`repro_torch.checkpoint`; ``resume_from`` restores the newest one
  and the loop goes on from its chunk boundary, with the bits of a run
  that was never stopped.

* **Baselines.**  ``method="cfl"|"dfl"`` runs the paper's baselines on
  the same scaffolding (:func:`_run_fleet_baseline`): lane (i, j) is
  client j of requester i's roster (its own shard, then every neighbour
  with data), all R·N lanes fit in one lane-batched call per step, and
  AGGREGATE is one eq. 14 launch on the shard sizes (cfl) or one launch
  per row of the mixing matrix (dfl).  No refresh, no battery.

* **Timeline.**  ``stage`` (with ``quantize_pack`` nested under int8),
  ``program`` (the round loop), ``unpack`` (with ``dequant_unpack``
  nested) are spans of the run's :class:`~repro_torch.telemetry.Timeline`,
  each closed after one device sync, never inside the round loop.
  ``use_pallas=False`` runs the whole run under
  :func:`repro_torch.kernels.common.plain_twins`.

Encryption is priced in the cost domain only (the reference's fleet does
not run the cipher per round either); the loop engine holds the AES
transport.  The profiler fields of ``TraceConfig`` instrument the
``program`` span of every method: ``jax_profiler_dir`` runs
``torch.profiler`` around it (the checkpointed chunk loop included) and
writes its trace there once the span has closed, ``hlo_stats`` records
the kernels' work over it (``repro_torch.telemetry.profile``) into
``FleetResult.hlo_stats``, its flop counter slowing the span many times
over; both stay on the host and change no bit of the outcome (under a baseline
method, the enfed-only knobs raise ``ValueError`` as in the reference; faults there
are priced post hoc: each extra transmission of the cfl uplink or the dfl
gossip fan through ``CostModel.retry_energy``, counted in the session's
``history["fault_extra_tx"]``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import adversary as adversary_mod
from repro_torch.core import cadence as cadence_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import mobility, protocol, schedule, topology
from repro_torch.core.battery import BatteryState, discharge_level, load_efficiency
from repro_torch.core.energy import CostModel, update_wire_bytes
from repro_torch.core.incentive import NeighborDevice, candidate_pool, sign_contracts_fleet
from repro_torch.core.rounds import EnFedConfig, SessionResult
from repro_torch.kernels.common import check_interpret, plain_twins, resolve_device
from repro_torch.kernels.fedavg.ops import fedavg_flat_batched, fedavg_flat_batched_q8
from repro_torch.kernels.quantize.ops import (dequantize_flat_batched,
                                              quantize_flat_batched, resolve_compress)
from repro_torch.kernels.robust.ops import robust_aggregate, robust_aggregate_q8
from repro_torch.models.classifiers import masked_cross_entropy_loss
from repro_torch.optim import lane_adam_init, lane_adam_step
from repro_torch.telemetry.profile import (maybe_torch_profiler, program_cost_stats,
                                           record_program_cost)
from repro_torch.telemetry.spans import Timeline
from repro_torch.utils.tree import (flatten_to_vector, tree_bytes, tree_ravel,
                                    tree_size, tree_unravel)


@dataclasses.dataclass
class RequesterSpec:
    """One requesting device's inputs, mirroring ``EnFedSession``'s."""

    own_train: tuple                      # (x, y) numpy shard
    own_test: tuple
    neighborhood: Sequence[NeighborDevice]
    contributor_states: Dict[int, dict]   # device_id -> {params, data}
    battery: Optional[BatteryState] = None


@dataclasses.dataclass
class FleetResult:
    """Stacked outcome of one fleet run plus per-session views."""

    sessions: List[SessionResult]
    rounds: np.ndarray          # (R,) executed rounds per session
    stop_codes: np.ndarray      # (R,) protocol.STOP_* codes
    accuracy: np.ndarray        # (R,) final accuracy
    battery_level: np.ndarray   # (R,) final battery fraction
    total_energy_j: float       # summed eq. (5) energy across the fleet
    history: Dict[str, np.ndarray]  # (max_rounds, R) traces; "round_executed"
                                    # is (max_rounds,), 1 where a round ran
                                    # (under cadence (max_events,), 1 where
                                    # a lane ticked); "member" is
                                    # (max_rounds, R, N) under mobility
    staged_param_bytes: int = 0       # contributor round state as staged
                                      # (fp32 (R, N, P), or int8 + scales)
    device_round_state_bytes: int = 0  # that state as carried on the device
    timeline: Optional[Timeline] = None  # host-side wall-clock spans
    hlo_stats: Optional[dict] = None     # the program span's work and memory
                                         # (TraceConfig.hlo_stats only)

    @property
    def history_raw(self) -> Dict[str, np.ndarray]:
        return self.history


class FleetCarry(NamedTuple):
    """The enfed fleet's round state, by name: what one round reads and
    writes, and what a checkpoint saves (each field under its name, as the
    reference's ``FleetCarry``).  A field the run's world does not use is
    None (the reference carries a token buffer there).  Traces are
    (max_rounds, R) or (max_rounds, R, N); under cadence a lane's round r
    lands at row r, whatever the event step."""

    contrib: torch.Tensor                 # (R, N, P | Lp) round state (int8 codes
                                          # under the int8 wire)
    cscale: Optional[torch.Tensor]        # (R, N, Lp / 1024) its scales
    live: Optional[torch.Tensor]          # (V, P | Lp) deduplicated refresh rows
    live_s: Optional[torch.Tensor]        # (V, Lp / 1024) their scales
    last: torch.Tensor                    # (R, P) requester params
    level: torch.Tensor                   # (R,) requester battery fraction
    active: torch.Tensor                  # (R,) bool: the session goes on
    stop_code: torch.Tensor               # (R,) protocol.STOP_* codes
    rounds_done: torch.Tensor             # (R,) executed rounds per lane
    clevel: Optional[torch.Tensor]        # (R, N) contributor batteries (mobility)
    acc_h: torch.Tensor                   # accuracy trace
    loss_h: torch.Tensor                  # loss trace
    bat_h: torch.Tensor                   # battery trace
    exec_h: torch.Tensor                  # executed-lane trace
    body_h: torch.Tensor                  # (max_rounds,) a lane ran the round
                                          # ((max_events,) under cadence)
    member_h: Optional[torch.Tensor]      # membership trace (mobility)
    prev: Optional[torch.Tensor]          # (R, N, P | Lp) the round-(r-1) wire
                                          # image stale links deliver (faults)
    prev_s: Optional[torch.Tensor]        # its scales
    drop_h: Optional[torch.Tensor]        # fault drops per round
    retry_h: Optional[torch.Tensor]       # fault retries per round
    stale_h: Optional[torch.Tensor]       # stale deliveries per round
    deliver_h: Optional[torch.Tensor]     # deliver mask per round
    clock: Optional[torch.Tensor]         # (R,) int32 each lane's round clock (cadence)
    idle: Optional[torch.Tensor]          # (R,) int32 idle steps since its last round
    clock_h: Optional[torch.Tensor]       # int32 event step each round ran at
    idle_h: Optional[torch.Tensor]        # int32 idle steps before each round
    corrupt_h: Optional[torch.Tensor]     # corrupted-delivery mask (adversary)
    clip_h: Optional[torch.Tensor]        # norm-clipped mask (robust != "none")


def _put(buf: torch.Tensor, r: int, row) -> torch.Tensor:
    """Row ``r`` of a trace set to ``row``, cast to the trace's dtype."""
    buf[r] = row
    return buf


def _pad_stack(arrays, pad_len: int, dtype):
    """Ragged leading-axis arrays -> (R, pad_len, ...) zero-padded + mask."""
    out = np.zeros((len(arrays), pad_len) + arrays[0].shape[1:], dtype)
    mask = np.zeros((len(arrays), pad_len), np.float32)
    for i, a in enumerate(arrays):
        out[i, :len(a)] = a
        mask[i, :len(a)] = 1.0
    return out, mask


def _fit_lanes(task, spec, flat, get_batch, idx, w, live):
    """Masked Adam on every lane of a flat (L, P) buffer: the math of
    ``SupervisedTask.fit`` lane by lane.  ``idx``/``w`` are the
    (L, E, S, B) plan on the device, ``live`` its (L, E, S) host mask of
    steps whose weights sum above 0; a step no lane takes is skipped.
    Returns ``(flat, loss)``: the trained buffer and each lane's last-epoch
    loss, the mean over its valid steps (``fleet.py:374-375``)."""
    lanes, epochs, steps, _ = idx.shape
    state = lane_adam_init(flat)
    take_all = torch.from_numpy(live).to(flat.device)
    loss_sum = torch.zeros(lanes, dtype=torch.float32, device=flat.device)
    for e in range(epochs):
        for s in range(steps):
            if not live[:, e, s].any():
                continue
            xb, yb = get_batch(idx[:, e, s])
            p = flat.detach().requires_grad_(True)
            losses = masked_cross_entropy_loss(
                task.model.lane_logits(tree_unravel(spec, p), xb), yb, w[:, e, s])
            (grads,) = torch.autograd.grad(losses.sum(), p)
            take = take_all[:, e, s]
            with torch.no_grad():
                flat, state = lane_adam_step(flat, grads, state, take, task.lr)
                if e == epochs - 1:
                    loss_sum = loss_sum + torch.where(take, losses.detach(), 0.0)
    valid = np.maximum(live[:, -1, :].sum(axis=1), 1).astype(np.float32)
    return flat, loss_sum / torch.from_numpy(valid).to(flat.device)


def _eval_lanes(model, spec, flat, x, y, mask):
    """Per-lane accuracy over a zero-padded test stack: the masked mean of
    correct predictions, fp32."""
    with torch.no_grad():
        logits = model.lane_logits(tree_unravel(spec, flat), x)
        correct = (torch.argmax(logits, dim=-1) == y).to(torch.float32)
        return torch.sum(correct * mask, dim=-1) / torch.clamp_min(torch.sum(mask, dim=-1), 1.0)


def _chunked_rounds(max_rounds: int, chunk: int, any_active, r0: int = 0, on_chunk=None):
    """The round indices of the early-exit loop from round ``r0`` (0, or a
    restored chunk boundary), ``chunk`` rounds at a time while
    ``any_active()`` holds.  It is called on the host once per chunk, when
    the chunk before it has run (the loop's one sync a chunk);
    ``on_chunk(next_r0)`` runs after each chunk (the checkpoint point)."""
    for c0 in range(r0, max_rounds, chunk):
        if not any_active():
            return
        yield from range(c0, min(c0 + chunk, max_rounds))
        if on_chunk is not None:
            on_chunk(c0 + chunk)


def _sync(dev: torch.device) -> None:
    """Wait for the device, so the host clock read next (a span's end)
    covers its work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _ProgramHooks:
    """The ``program`` span of ``tl`` around a fleet's round loop, with the
    ``TraceConfig`` profiler fields: ``torch.profiler``
    (``jax_profiler_dir``) and the program-cost recorder (``hlo_stats``),
    with the peak allocation over the span on the card.  Both stay on the
    host; :meth:`stats` is None unless ``hlo_stats`` is on.  The span
    closes after a device sync, before the profiler writes its trace; the
    recorder's flop counter runs Python on every torch op inside it, so
    with ``hlo_stats`` on the span times the counted program, not the
    program."""

    def __init__(self, trace, dev: torch.device, tl: Timeline):
        self.dev, self.tl = dev, tl
        self.profile_dir = getattr(trace, "jax_profiler_dir", None) if trace else None
        self.want_cost = bool(trace is not None and getattr(trace, "hlo_stats", False))
        self._stack = contextlib.ExitStack()
        self._span = None
        self.rec = None
        self.peak = None

    def __enter__(self) -> "_ProgramHooks":
        if self.want_cost and self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self._span = self.tl.begin("program")
        self._stack.enter_context(maybe_torch_profiler(self.profile_dir, self.dev))
        if self.want_cost:
            self.rec = self._stack.enter_context(record_program_cost())
        return self

    def __exit__(self, *exc) -> bool:
        if exc[0] is None:
            _sync(self.dev)
            self.tl.finish(self._span)
        try:
            return self._stack.__exit__(*exc)
        finally:
            if self.want_cost and self.dev.type == "cuda":
                self.peak = torch.cuda.max_memory_allocated(self.dev)

    def stats(self, staged_bytes: int, carry: Dict[str, torch.Tensor]) -> Optional[dict]:
        """``hlo_stats`` of the span, ``carry`` the round state the loop
        passes on."""
        if self.rec is None:
            return None
        return program_cost_stats(self.rec, staged_bytes=staged_bytes,
                                  carry_bytes=tree_bytes(carry), device=self.dev,
                                  peak_bytes=self.peak)


@contextlib.contextmanager
def _span(tl: Timeline, dev: torch.device, name: str, **attrs):
    """One span of ``tl`` around device work, closed after a device sync."""
    idx = tl.begin(name, **attrs)
    yield
    _sync(dev)
    tl.finish(idx)


def _check_knobs(cfg, method, dfl_topology, round_chunk, checkpoint_dir,
                 checkpoint_every, resume_from) -> None:
    protocol.method_phases(method)         # validate the method's name
    if round_chunk < 1:
        raise ValueError(f"round_chunk must be >= 1 (got {round_chunk})")
    if checkpoint_every < 0:
        raise ValueError(f"checkpoint_every must be >= 0 (got {checkpoint_every})")
    baseline = method != "enfed"
    # the reference's refusals of enfed-only knobs under a baseline method
    if baseline and (checkpoint_dir or resume_from):
        raise ValueError(f"checkpointing is enfed-only (got method={method!r})")
    if baseline and cfg.cadence is not None:
        raise ValueError(
            f"cadence is enfed-only (got method={method!r}) — the "
            "baselines' loop oracles tick on one global round clock")
    if baseline and (cfg.adversary is not None or cfg.robust != "none"
                     or float(cfg.staleness_gamma) != 1.0):
        raise ValueError(
            f"adversary/robust/staleness_gamma are enfed-only (got "
            f"method={method!r}) — the baselines' loop oracles define "
            "their aggregation semantics without Phase.DELIVER")
    if baseline and dfl_topology not in ("mesh", "ring"):
        raise ValueError(f"unknown dfl topology {dfl_topology!r} (mesh|ring)")


def run_fleet(task, requesters: Sequence[RequesterSpec],
              cfg: Optional[EnFedConfig] = None,
              cost_model: Optional[CostModel] = None,
              use_pallas: bool = True,
              interpret: Optional[bool] = None,
              round_chunk: int = 4,
              method: str = "enfed",
              dfl_topology: str = "mesh",
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0,
              resume_from: Optional[str] = None,
              timeline: Optional[Timeline] = None,
              trace=None, *, device=None) -> FleetResult:
    """Run ``len(requesters)`` concurrent EnFed sessions on one flat round
    state, on ``device`` (the GPU unless the caller names another; the
    task must run there).  Each requester's ``contributor_states`` end up
    holding that session's final contributor params (the dequantized wire
    image under int8); requesters sharing one states dict see the last
    writer's lanes.

    ``method="cfl"|"dfl"`` runs the paper's baselines instead
    (:func:`_run_fleet_baseline`; ``dfl_topology`` "mesh" or "ring"): each
    requester's lanes are the loop learners' client list, and its
    ``SessionResult`` carries ``battery=None`` and a
    ``cfl_session``/``dfl_session`` report.

    ``use_pallas=False`` runs the plain PyTorch twins of every kernel (the
    caller's choice, never a fallback); ``interpret`` accepts only None;
    ``round_chunk`` is the early-exit granularity (the host reads the
    fleet's activity once per chunk); ``checkpoint_dir`` saves the round
    state every ``checkpoint_every`` rounds (default: every chunk; rounded
    up to a multiple of it) and ``resume_from`` continues from a
    directory's newest checkpoint (enfed only); ``timeline`` records the
    spans and ``trace`` may select exports, which ``Experiment.run``
    writes.

    Note: prefer the :mod:`repro_torch.api` facade
    (``ExecutionSpec(engine="fleet", ...)``)."""
    cfg = cfg if cfg is not None else EnFedConfig()
    cost = cost_model or CostModel()
    dev = resolve_device(device)
    if torch.device(task.device) != dev:
        raise ValueError(f"the task runs on {task.device}, the fleet on {dev}")
    check_interpret(interpret)
    _check_knobs(cfg, method, dfl_topology, round_chunk, checkpoint_dir, checkpoint_every,
                 resume_from)
    if len(requesters) == 0:
        raise ValueError("empty fleet")
    tl = timeline if timeline is not None else Timeline()
    with contextlib.nullcontext() if use_pallas else plain_twins():
        if method != "enfed":
            return _run_fleet_baseline(task, requesters, cfg, cost, method, dfl_topology,
                                       dev, round_chunk, tl, trace)
        return _run_fleet_enfed(task, requesters, cfg, cost, dev, round_chunk, tl,
                                checkpoint_dir, checkpoint_every, resume_from, trace)


def _run_fleet_enfed(task, requesters: Sequence[RequesterSpec], cfg: EnFedConfig,
                     cost: CostModel, dev: torch.device, round_chunk: int, tl: Timeline,
                     checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
                     resume_from: Optional[str] = None, trace=None) -> FleetResult:
    """Algorithm 1 for every requester on the flat round state."""
    R = len(requesters)
    mob, fc, cc = cfg.mobility, cfg.faults, cfg.cadence
    # the global event steps the loop runs over: one per round in lockstep
    T_ev = cadence_mod.events_budget(cc, cfg.max_rounds) if cc is not None else cfg.max_rounds
    stage = tl.begin("stage")
    # ---- Phase.HANDSHAKE (host) ---------------------------------------------
    # a static world signs ranked contracts once; under mobility the lanes
    # are each requester's candidate pool, in device order, and membership
    # is renegotiated on the device every round
    if mob is None:
        lane_devs, contract_mask = sign_contracts_fleet(
            [spec.neighborhood for spec in requesters], cfg.offered_incentive, cfg.n_max)
    else:
        lane_devs = [candidate_pool(spec.neighborhood, cfg.offered_incentive)
                     for spec in requesters]
    for i, cs in enumerate(lane_devs):
        if not cs:
            raise RuntimeError(
                f"requester {i}: no nearby device agreed to the incentive (N_d < 1)")
    N = contract_mask.shape[1] if mob is None else max(len(cs) for cs in lane_devs)
    # every lane's real device id, and which lanes hold one (padding: False):
    # the world draws of lane (i, j) key on that id, as requester i's do on
    # ``requester_id + i`` of each world
    lane_ids = np.zeros((R, N), np.int64)
    lane_real = np.zeros((R, N), bool)
    for i, cs in enumerate(lane_devs):
        lane_ids[i, :len(cs)] = [d.device_id for d in cs]
        lane_real[i, :len(cs)] = True
    if mob is None:
        round_w = np.zeros((R, N), np.float32)
        for i, cs in enumerate(lane_devs):
            round_w[i, :len(cs)] = protocol.round_weights(len(cs), cfg.strategy)
    else:
        base_util = np.zeros((R, N), np.float32)
        clevel0 = np.zeros((R, N), np.float32)
        for i, cs in enumerate(lane_devs):
            n_i = len(cs)
            clevel0[i, :n_i] = [d.battery_level for d in cs]
            base_util[i, :n_i] = mobility.static_utility_term(
                np.array([d.model_staleness for d in cs], np.float32),
                np.array([d.data_size for d in cs], np.float32),
                np.float32(max(d.data_size for d in cs))).numpy()
    ac, robust = cfg.adversary, cfg.robust

    # ---- contributor round state and deduplicated shards --------------------
    template = requesters[0].contributor_states[lane_devs[0][0].device_id]["params"]
    _, spec = tree_ravel(template)
    P = tree_size(template)
    contrib_np = np.zeros((R, N, P), np.float32)
    host_rows: dict = {}                 # id(params) -> host fp32 row
    shard_rows: dict = {}
    shard_x, shard_y = [], []
    cidx = np.zeros((R, N), np.int64)
    shard_len = np.zeros((R, N), np.int64)
    for i, (rspec, cs) in enumerate(zip(requesters, lane_devs)):
        for j, c in enumerate(cs):
            st = rspec.contributor_states[c.device_id]
            row = host_rows.get(id(st["params"]))
            if row is None:
                row = flatten_to_vector(st["params"])[0].detach().cpu().numpy()
                host_rows[id(st["params"])] = row
            contrib_np[i, j] = row
            xa = np.ascontiguousarray(st["data"][0], np.float32)
            ya = np.ascontiguousarray(st["data"][1], np.int64)
            # content identity (128-bit digests), so deep-copied states
            # still collapse to one staged shard per device
            key = (c.device_id, xa.shape,
                   hashlib.blake2b(xa.tobytes(), digest_size=16).digest(),
                   hashlib.blake2b(ya.tobytes(), digest_size=16).digest())
            u = shard_rows.setdefault(key, len(shard_x))
            if u == len(shard_x):
                shard_x.append(xa)
                shard_y.append(ya)
            cidx[i, j] = u
            shard_len[i, j] = len(shard_x[u])

    wire_compress = resolve_compress(cfg.compress, P)
    contrib = torch.from_numpy(contrib_np).to(dev)
    cscale = None
    if wire_compress == "int8":
        with _span(tl, dev, "quantize_pack", what="round_state"):
            q0, s0 = quantize_flat_batched(contrib.reshape(R * N, P))
        contrib = q0.reshape(R, N, -1)
        cscale = s0.reshape(R, N, -1)
        staged_param_bytes = (contrib.numel() * contrib.element_size()
                              + cscale.numel() * cscale.element_size())
    else:
        staged_param_bytes = contrib.numel() * contrib.element_size()

    # ---- requester data and schedule metadata -------------------------------
    own_x, _ = _pad_stack([np.asarray(s.own_train[0], np.float32) for s in requesters],
                          max(len(s.own_train[0]) for s in requesters), np.float32)
    own_y, _ = _pad_stack([np.asarray(s.own_train[1], np.int64) for s in requesters],
                          own_x.shape[1], np.int64)
    test_x, test_mask = _pad_stack([np.asarray(s.own_test[0], np.float32) for s in requesters],
                                   max(len(s.own_test[0]) for s in requesters), np.float32)
    test_y, _ = _pad_stack([np.asarray(s.own_test[1], np.int64) for s in requesters],
                           test_x.shape[1], np.int64)
    own_x, own_y, test_x, test_y, test_mask = (
        torch.from_numpy(a).to(dev) for a in (own_x, own_y, test_x, test_y, test_mask))
    n_own = np.array([len(s.own_train[0]) for s in requesters], np.int64)
    n_pad = own_x.shape[1]
    batch = cfg.batch_size
    steps_max = max(schedule.fit_steps(int(n), batch) for n in n_own)
    partitionable = task.threefry_partitionable
    lanes_r = torch.arange(R, device=dev)[:, None]

    # ---- Phase.REFRESH: the rows that train, their shards and plans ---------
    ref_epochs = max(cfg.contributor_refresh_epochs, 0)
    do_refresh = ref_epochs > 0
    # a static world trains one row per unique (device, shard, params); under
    # mobility or cadence the lanes diverge (membership gaps, contributor
    # ticks), so every lane trains its own row
    refresh_dedup = do_refresh and mob is None and cc is None
    live = live_s = None
    if do_refresh:
        cx_tab, _ = _pad_stack(shard_x, max(len(x) for x in shard_x), np.float32)
        cy_tab, _ = _pad_stack(shard_y, cx_tab.shape[1], np.int64)
        cx_tab, cy_tab = torch.from_numpy(cx_tab).to(dev), torch.from_numpy(cy_tab).to(dev)
        ref_steps = max(schedule.fit_steps(int(n), batch) for n in shard_len[shard_len > 0])
    if do_refresh and not refresh_dedup:
        # a lane's plan is a function of (device seed, shard size): one plan
        # per unique pair, gathered to the R·N lanes (padded lanes: n = 0,
        # no step carries weight)
        plan_of: dict = {}
        lane_plan = np.zeros((R, N), np.int64)
        for i, cs in enumerate(lane_devs):
            for j in range(N):
                key = ((cfg.seed + cs[j].device_id, int(shard_len[i, j])) if j < len(cs)
                       else (cfg.seed, 0))
                lane_plan[i, j] = plan_of.setdefault(key, len(plan_of))
        p_seed, p_n = zip(*plan_of)
        p_idx, p_w = schedule.lane_plans(torch.stack([
            schedule.epoch_scores(sd, ref_epochs, cx_tab.shape[1], partitionable=partitionable)
            for sd in p_seed]), p_n, batch, ref_steps)
        flat_plan = torch.from_numpy(lane_plan.reshape(R * N))
        ref_idx, ref_w = p_idx[flat_plan], p_w[flat_plan]
        ref_live = (ref_w.sum(-1) > 0).numpy()
        ref_idx, ref_w = ref_idx.to(dev), ref_w.to(dev)
        lane_rows = torch.from_numpy(cidx.reshape(R * N)).to(dev)[:, None]

        def refresh_batch(ib):
            return cx_tab[lane_rows, ib], cy_tab[lane_rows, ib]
    if refresh_dedup:
        ref_map: dict = {}
        ref_uidx = np.zeros((R, N), np.int64)
        lane_valid = np.zeros((R, N), bool)
        u_cidx, u_n, u_seed, rep = [], [], [], []
        for i, cs in enumerate(lane_devs):
            for j, c in enumerate(cs):
                key = (c.device_id, int(cidx[i, j]),
                       hashlib.blake2b(contrib_np[i, j].tobytes(), digest_size=16).digest())
                v = ref_map.setdefault(key, len(u_cidx))
                if v == len(u_cidx):
                    u_cidx.append(int(cidx[i, j]))
                    u_n.append(int(shard_len[i, j]))
                    u_seed.append(cfg.seed + c.device_id)
                    rep.append((i, j))
                ref_uidx[i, j] = v
                lane_valid[i, j] = True
        ref_scores = torch.stack([
            schedule.epoch_scores(sd, ref_epochs, cx_tab.shape[1], partitionable=partitionable)
            for sd in u_seed])
        ref_idx, ref_w = schedule.lane_plans(ref_scores, u_n, batch, ref_steps)
        ref_live = (ref_w.sum(-1) > 0).numpy()
        ref_idx, ref_w = ref_idx.to(dev), ref_w.to(dev)
        u_rows = torch.tensor(u_cidx, dtype=torch.int64, device=dev)[:, None]
        ref_uidx = torch.from_numpy(ref_uidx).to(dev)
        lane_valid = torch.from_numpy(lane_valid).to(dev)
        # the V rows as staged: (V, P) fp32, or (V, Lp) codes + scales
        rep_i, rep_j = (torch.tensor(a, dtype=torch.int64, device=dev) for a in zip(*rep))
        live = contrib[rep_i, rep_j]
        live_s = cscale[rep_i, rep_j] if cscale is not None else None

        def refresh_batch(ib):
            return cx_tab[u_rows, ib], cy_tab[u_rows, ib]

    # ---- Phase.ACCOUNT constants --------------------------------------------
    model_bytes = update_wire_bytes(P, encrypt=cfg.encrypt, compress=wire_compress,
                                    raw_bytes=tree_bytes(template))
    batteries = [s.battery or BatteryState() for s in requesters]

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    if mob is None and fc is None:
        e_round_t = f32([cost.round_energy(
            n_contrib=len(cs), num_params=P, model_bytes=model_bytes,
            num_samples=len(rspec.own_train[0]), epochs=cfg.epochs,
            n_devices=len(rspec.neighborhood), encrypt=cfg.encrypt)
            for rspec, cs in zip(requesters, lane_devs)])
    else:
        # the member (mobility) or delivered (faults) count changes each
        # round: a per-count table gathered at the count
        e_tab = f32([cost.round_energy_table(
            max_contrib=N, num_params=P, model_bytes=model_bytes,
            num_samples=len(rspec.own_train[0]), epochs=cfg.epochs,
            n_devices=len(rspec.neighborhood), encrypt=cfg.encrypt)
            for rspec in requesters])
    if mob is not None:
        # the members' own per-round costs (transmit, refresh)
        e_tx, e_ref = np.zeros((R, N), np.float32), np.zeros((R, N), np.float32)
        for i, cs in enumerate(lane_devs):
            for j in range(len(cs)):
                e_tx[i, j], e_ref[i, j] = cost.contributor_round_energy(
                    num_params=P, model_bytes=model_bytes, num_samples=int(shard_len[i, j]),
                    refresh_epochs=cfg.contributor_refresh_epochs, encrypt=cfg.encrypt)
        e_tx, e_ref, base_util = f32(e_tx), f32(e_ref), f32(base_util)
    lane_ids, lane_real = torch.from_numpy(lane_ids).to(dev), torch.from_numpy(lane_real).to(dev)
    lane_r = torch.arange(R, dtype=torch.int64, device=dev)
    if fc is not None:
        # Phase.DELIVER: every step's outcomes, from one batch of draws on
        # the device
        f_rounds, f_req = torch.arange(T_ev, device=dev), lane_r + fc.requester_id
        f_deliv, f_att, f_stale = faults_mod.link_outcomes(
            fc, f_rounds, f_req, lane_ids, partitionable=partitionable)
        f_blocked = faults_mod.blocked_mask(fc, f_rounds, f_req, lane_ids,
                                            partitionable=partitionable)
        e_rx_retry, _, t_retry = cost.retry_energy(model_bytes=model_bytes, encrypt=cfg.encrypt)
        e_retry = f32(e_rx_retry)
    if cc is not None:
        # lane i ticks as requester requester_id + i (paced on its battery,
        # so per step); the contributors' ticks and image lags are closed
        # forms of (step, device), staged over every step at once
        c_steps, c_req = torch.arange(T_ev, device=dev), lane_r + cc.requester_id
        c_tick = cadence_mod.tick_mask(cc, c_steps, lane_ids, partitionable=partitionable)
        if gamma_on := float(cfg.staleness_gamma) < 1.0:
            c_lag = cadence_mod.image_lag(cc, c_steps, lane_ids, partitionable=partitionable)
    capacity = f32([b.capacity_j for b in batteries])
    eff = f32([load_efficiency(cost.device.p_train, b.high_load_penalty,
                               b.high_load_threshold_w) for b in batteries])
    desired = f32(cfg.desired_accuracy)
    threshold = f32(cfg.battery_threshold)
    round_w_static = f32(round_w) if mob is None else None
    gamma = float(cfg.staleness_gamma)

    # ---- the round state ------------------------------------------------------
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def izeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    T = cfg.max_rounds
    carry = FleetCarry(
        contrib=contrib, cscale=cscale, live=live, live_s=live_s,
        # a mobility or fault world may aggregate nothing in a round: the
        # fallback chain bottoms out at the requester's own init
        last=(tree_ravel(task.init(seed=cfg.seed))[0].to(dev).expand(R, P).clone()
              if mob is not None or fc is not None else zeros(R, P)),
        level=f32([b.level for b in batteries]),
        active=torch.ones(R, dtype=torch.bool, device=dev),
        stop_code=torch.full((R,), protocol.STOP_MAX_ROUNDS, dtype=torch.int32, device=dev),
        rounds_done=torch.zeros(R, dtype=torch.int32, device=dev),
        clevel=f32(clevel0) if mob is not None else None,
        acc_h=zeros(T, R), loss_h=zeros(T, R), bat_h=zeros(T, R), exec_h=zeros(T, R),
        body_h=zeros(T_ev),
        member_h=zeros(T, R, N) if mob is not None else None,
        # the stale-delivery snapshot starts as the handshake staging (a
        # round-0 stale hit is a no-op)
        prev=contrib if fc is not None else None,
        prev_s=cscale if fc is not None else None,
        drop_h=zeros(T, R) if fc is not None else None,
        retry_h=zeros(T, R) if fc is not None else None,
        stale_h=zeros(T, R) if fc is not None else None,
        deliver_h=zeros(T, R, N) if fc is not None else None,
        clock=izeros(R) if cc is not None else None,
        idle=izeros(R) if cc is not None else None,
        clock_h=izeros(T, R) if cc is not None else None,
        idle_h=izeros(T, R) if cc is not None else None,
        corrupt_h=zeros(T, R, N) if ac is not None else None,
        clip_h=zeros(T, R, N) if robust != "none" else None)

    def fit_plan(clocks: np.ndarray):
        """The requesters' fit plan: each lane's scores on ``seed`` plus its
        round clock, one table per distinct clock, gathered to the lanes."""
        uniq, inv = np.unique(clocks, return_inverse=True)
        scores = torch.stack([schedule.epoch_scores(cfg.seed + int(k), cfg.epochs, n_pad,
                                                    partitionable=partitionable)
                              for k in uniq])[torch.from_numpy(inv.reshape(-1))]
        return schedule.lane_plans(scores, n_own, batch, steps_max)

    def round_body(c: FleetCarry, r: int, tick=None, clocks=None) -> FleetCarry:
        """One round of every requester at event step ``r``, on the device:
        the carry after it.  In lockstep the active lanes execute; under
        cadence the ticking ones (``tick``, already masked by activity),
        each at its own round clock (``clocks``, the host's mirror).  A
        lane that does not execute changes nothing but its idle count."""
        active, contrib, cscale = c.active, c.contrib, c.cscale
        ex = active if tick is None else tick
        ran = ex.any()
        if cc is None:
            def put(buf, row):
                return _put(buf, r, row)
        else:
            # each executing lane lands at its own round row (a stopped
            # lane's clock may sit at the budget: clamped, and masked out)
            rows = c.clock.clamp(max=T - 1).long()

            def put(buf, row):
                row = torch.as_tensor(row, device=dev).to(buf.dtype).expand(buf.shape[1:])
                keep = ex.reshape((R,) + (1,) * (buf.dim() - 2))
                buf[rows, lane_r] = torch.where(keep, row, buf[rows, lane_r])
                return buf

        upd = {"body_h": _put(c.body_h, r, ran.to(torch.float32))}
        blocked = f_blocked[r] if fc is not None else None
        ctick = c_tick[r] if cc is not None else None
        # Phase.RENEGOTIATE (mobility): release, sign and undercut on the
        # device (a streak-blocked link is released too); the member mask
        # is this round's weight row
        if mob is not None:
            member, rank, _ = mobility.membership_step(
                mob, r, lane_r + mob.requester_id, lane_ids, lane_real, base_util, c.clevel,
                cfg.n_max, blocked=blocked, partitionable=partitionable)
            round_w_t = topology.dynamic_round_weights(member, rank, cfg.strategy)
            count = member.sum(dim=1)
        else:
            round_w_t = round_w_static
        # Phase.DELIVER (faults): the attempting links that landed an update,
        # the attempts each burned, and those that delivered the round-(r-1)
        # image; the delivered mask multiplies into eq. 14's weights
        src, src_s = contrib, cscale
        if fc is not None:
            att_mask = member if mob is not None else lane_real & ~blocked
            delivered = f_deliv[r] & att_mask
            attempts = f_att[r]
            stale_hit = delivered & f_stale[r]
            count = delivered.sum(dim=1)
            round_w_t = round_w_t * delivered.to(torch.float32)
            drops_r = (att_mask & ~delivered).sum(dim=1).to(torch.float32)
            retries_r = torch.where(att_mask, attempts - 1, 0).sum(dim=1).to(torch.float32)
            stale_r = stale_hit.sum(dim=1).to(torch.float32)
            # stale links send the snapshot, before any corruption
            src = torch.where(stale_hit[..., None], c.prev, contrib)
            if cscale is not None:
                src_s = torch.where(stale_hit[..., None], c.prev_s, cscale)
        # Phase.COLLECT under an adversary: a corrupted copy of the delivered
        # buffer, keyed on the delivering step
        if ac is not None:
            areq_ids = lane_r + ac.requester_id
            cmask = adversary_mod.corruption_mask(ac, r, areq_ids, lane_ids,
                                                  partitionable=partitionable)
            if wire_compress == "int8":
                src, src_s = adversary_mod.corrupt_wire_batched(
                    ac, src, src_s, cmask, r, areq_ids, lane_ids,
                    partitionable=partitionable)
                # the padding tail is no part of the update: the loop engine
                # slices to P before any statistic, so noise codes there must
                # not reach the q8 norms (honest tails are zero codes already)
                if P < src.shape[-1]:
                    src = src * (torch.arange(src.shape[-1], device=dev) < P).to(src.dtype)
            else:
                src = adversary_mod.corrupt_dense_batched(
                    ac, src, cmask, r, areq_ids, lane_ids, partitionable=partitionable)
            counted = delivered if fc is not None else (member if mob is not None else lane_real)
            upd["corrupt_h"] = put(c.corrupt_h, cmask & counted & ex[:, None])
        if gamma < 1.0 and (fc is not None or cc is not None):
            # gamma**lag on each weight: the image's age in event steps
            # (cadence), one more for a stale delivery (the 0/1 masks before
            # it are exact, so the order is immaterial)
            lag = c_lag[r] if cc is not None else 0
            if fc is not None:
                lag = lag + stale_hit
            round_w_t = protocol.decayed_round_weights(round_w_t, lag, gamma)
        # Phase.AGGREGATE: eq. 14, or the robust statistic, in one launch
        # over the whole buffer
        if robust != "none":
            if wire_compress == "int8":
                glob, clipped = robust_aggregate_q8(src, src_s, round_w_t, method=robust)
                glob = glob[:, :P]
            else:
                glob, clipped = robust_aggregate(src, round_w_t, method=robust)
            upd["clip_h"] = put(c.clip_h, clipped & ex[:, None])
        elif wire_compress == "int8":
            glob = fedavg_flat_batched_q8(src, src_s, round_w_t)[:, :P]
        else:
            glob = fedavg_flat_batched(src, round_w_t)
        if mob is not None or fc is not None:
            # nothing fed eq. 14: the lane keeps training its own params
            glob = torch.where((count > 0)[:, None], glob, c.last)
        # Phase.FIT + Phase.SCORE, every requester as a lane
        # in lockstep every lane's clock is the round
        idx, w = fit_plan(np.full(R, r) if clocks is None else clocks)
        new_flat, last_loss = _fit_lanes(
            task, spec, glob, lambda ib: (own_x[lanes_r, ib], own_y[lanes_r, ib]),
            idx.to(dev), w.to(dev), (w.sum(-1) > 0).numpy())
        acc = _eval_lanes(task.model, spec, new_flat, test_x, test_y, test_mask)
        # Phase.ACCOUNT: fp32 battery discharge of the executing lanes; under
        # faults one more receive window per drop or retry
        e_round = (e_tab.gather(1, count[:, None])[:, 0]
                   if mob is not None or fc is not None else e_round_t)
        if fc is not None:
            e_round = e_round + (drops_r + retries_r) * e_retry
        level_new = discharge_level(c.level, e_round, capacity, eff)
        reached = acc >= desired
        low = level_new < threshold
        stop_code = torch.where(ex & reached, protocol.STOP_ACCURACY,
                                torch.where(ex & ~reached & low,
                                            protocol.STOP_BATTERY, c.stop_code))
        level = torch.where(ex, level_new, c.level)
        # the session survives the round; under cadence it goes on while its
        # clock is inside the budget (the last budget round still refreshes)
        cont = active & ~(ex & (reached | low))
        next_active = cont
        if cc is not None:
            clock = c.clock + ex.to(torch.int32)
            next_active = cont & (clock < T)
            upd.update(clock=clock, clock_h=put(c.clock_h, r), idle_h=put(c.idle_h, c.idle),
                       idle=torch.where(ex, 0, c.idle + (active & ~ex).to(torch.int32)))
        # a round no lane ran leaves its rows 0, as the reference's skipped body
        upd.update(
            stop_code=stop_code, level=level, active=next_active,
            rounds_done=c.rounds_done + ex.to(torch.int32),
            last=torch.where(ex[:, None], new_flat, c.last),
            acc_h=put(c.acc_h, torch.where(ran, acc, 0.0)),
            loss_h=put(c.loss_h, torch.where(ran, last_loss, 0.0)),
            bat_h=put(c.bat_h, torch.where(ran, level, 0.0)),
            exec_h=put(c.exec_h, ex))
        if fc is not None:
            upd.update(drop_h=put(c.drop_h, drops_r * ex),
                       retry_h=put(c.retry_h, retries_r * ex),
                       stale_h=put(c.stale_h, stale_r * ex),
                       deliver_h=put(c.deliver_h, delivered & ex[:, None]),
                       # the image next round's stale links deliver: this
                       # round's, before refresh rebinds the state (under
                       # cadence only where the lane executed)
                       prev=contrib if cc is None else torch.where(
                           ex[:, None, None], contrib, c.prev),
                       prev_s=cscale if cc is None or cscale is None else torch.where(
                           ex[:, None, None], cscale, c.prev_s))
        # members of executing lanes paid their transmission (once per
        # attempt under faults), and the refresh term where the session
        # goes on (under cadence: where the member ticks too)
        refresh_on = (cont & ex)[:, None]
        if cc is not None:
            refresh_on = refresh_on & ctick
        if mob is not None:
            e_tx_round = e_tx * attempts.to(torch.float32) if fc is not None else e_tx
            upd["clevel"] = mobility.contributor_discharge(
                c.clevel, member & ex[:, None], e_tx_round, e_ref, refresh_on,
                mob.contributor_capacity_j)
            upd["member_h"] = put(c.member_h, member & ex[:, None])
        # Phase.REFRESH per lane (mobility, cadence): every lane trains its
        # own row, the members (signed lanes) of sessions that go on take
        # the result, under cadence where they tick
        if do_refresh and not refresh_dedup:
            if cscale is not None:
                ref_src = dequantize_flat_batched(contrib.reshape(R * N, -1),
                                                  cscale.reshape(R * N, -1))[:, :P]
            else:
                ref_src = contrib.reshape(R * N, P)
            refreshed, _ = _fit_lanes(task, spec, ref_src, refresh_batch, ref_idx, ref_w,
                                      ref_live)
            take = (refresh_on & (member if mob is not None else lane_real))[..., None]
            if cscale is not None:
                q2, s2 = quantize_flat_batched(refreshed)
                upd["contrib"] = torch.where(take, q2.reshape(R, N, -1), contrib)
                upd["cscale"] = torch.where(take, s2.reshape(R, N, -1), cscale)
            else:
                upd["contrib"] = torch.where(take, refreshed.reshape(R, N, P), contrib)
        # Phase.REFRESH: the V unique rows train, lanes that go on take them
        if refresh_dedup:
            ref_src = (dequantize_flat_batched(c.live, c.live_s)[:, :P]
                       if c.live_s is not None else c.live)
            refreshed, _ = _fit_lanes(task, spec, ref_src, refresh_batch, ref_idx, ref_w,
                                      ref_live)
            take = (next_active[:, None] & lane_valid)[..., None]
            if c.live_s is not None:
                live, live_s = quantize_flat_batched(refreshed)
                upd.update(live=live, live_s=live_s,
                           contrib=torch.where(take, live[ref_uidx], contrib),
                           cscale=torch.where(take, live_s[ref_uidx], cscale))
            else:
                upd.update(live=refreshed,
                           contrib=torch.where(take, refreshed[ref_uidx], contrib))
        return c._replace(**upd)

    # host mirror of the lanes' round clocks (cadence): the fit plans
    clocks = np.zeros(R, np.int64)

    def event_step(c: FleetCarry, t: int) -> FleetCarry:
        """Global event step ``t`` under cadence: which lanes tick (the
        step's one host read); with none, only the active lanes' idle
        counts move, else the round body runs for the ticking lanes."""
        tick = cadence_mod.tick_mask(cc, t, c_req, level=c.level,
                                     partitionable=partitionable) & c.active
        tick_host = tick.cpu().numpy()
        if not tick_host.any():
            return c._replace(idle=c.idle + c.active.to(torch.int32))
        c = round_body(c, t, tick, clocks)
        clocks[:] += tick_host
        return c

    # ---- checkpoint/resume: the carry at chunk boundaries ---------------------
    every = checkpoint_every if checkpoint_every > 0 else round_chunk
    every = -(-every // round_chunk) * round_chunk        # a multiple of the chunk
    r0 = 0
    _sync(dev)
    tl.finish(stage)
    if resume_from:
        from repro_torch.checkpoint import restore_checkpoint

        with tl.span("checkpoint_restore"):
            pay, _ = restore_checkpoint(resume_from, {"r0": np.int64(0), "state": carry})
            r0 = int(pay["r0"])
            carry = FleetCarry(*(None if v is None else torch.from_numpy(v).to(dev)
                                 for v in pay["state"]))
        if cc is not None:
            clocks[:] = carry.clock.cpu().numpy()

    def saved(r_next: int) -> None:
        if checkpoint_dir and r_next % every == 0:
            from repro_torch.checkpoint import save_checkpoint

            with tl.span("checkpoint_save", r0=r_next):
                save_checkpoint(checkpoint_dir, r_next, {"r0": np.int64(r_next), "state": carry})

    # ---- the round loop (event steps under cadence) ---------------------------
    with _ProgramHooks(trace, dev, tl) as hooks:
        for r in _chunked_rounds(T_ev, round_chunk, lambda: bool(carry.active.any()),
                                 r0=r0, on_chunk=saved):
            carry = round_body(carry, r) if cc is None else event_step(carry, r)
    hlo = hooks.stats(staged_param_bytes,
                      {k: v for k, v in carry._asdict().items() if v is not None})

    # ---- unpack -------------------------------------------------------------
    unpack = tl.begin("unpack")
    rounds_np, codes_np, level_np = (t.cpu().numpy() for t in (carry.rounds_done,
                                                                  carry.stop_code, carry.level))
    idle_np = carry.idle.cpu().numpy() if cc is not None else None
    hist = {k: (None if v is None else v.cpu().numpy())
            for k, v in carry._asdict().items() if k.endswith("_h")}
    acc_h, loss_h, bat_h, exec_h, body_h = (hist[k] for k in ("acc_h", "loss_h", "bat_h",
                                                              "exec_h", "body_h"))
    if do_refresh:
        if carry.cscale is not None:
            with _span(tl, dev, "dequant_unpack"):
                final = dequantize_flat_batched(carry.contrib, carry.cscale)[..., :P]
        else:
            final = carry.contrib
        for i, (rspec, cs) in enumerate(zip(requesters, lane_devs)):
            for j, c in enumerate(cs):
                rspec.contributor_states[c.device_id]["params"] = tree_unravel(spec, final[i, j])

    sessions = []
    total_e = 0.0
    for i, (rspec, cs, b0) in enumerate(zip(requesters, lane_devs, batteries)):
        r_i = int(rounds_np[i])
        if mob is None:
            n_contrib_i = float(len(cs))
        else:
            # priced over the mean membership, in fp32 as the reference's fleet
            n_contrib_i = float(hist["member_h"][:r_i, i].sum(-1).mean()) if r_i else 0.0
        report = cost.session(
            rounds=r_i, n_contrib=n_contrib_i, num_params=P,
            model_bytes=model_bytes, num_samples=len(rspec.own_train[0]),
            epochs=cfg.epochs, n_devices=len(rspec.neighborhood), encrypt=cfg.encrypt)
        if fc is not None:
            # every drop or retry burned one more receive window, priced
            # post hoc from the traces
            extra_i = float(hist["drop_h"][:r_i, i].sum() + hist["retry_h"][:r_i, i].sum())
            report.add_transfers(extra_i, t_retry, e_rx_retry)
        if cc is not None:
            # the idle steps before each round and the trailing ones of a
            # lane that never finished, priced post hoc
            report.add_idle(cost, int(hist["idle_h"][:r_i, i].sum()) + int(idle_np[i]),
                            cc.idle_step_s)
        if robust != "none" and r_i:
            # one screening pass over the session's N x P buffer per executed
            # round, priced post hoc (never drains the simulated battery)
            e_scr, t_scr = cost.screening_energy(n_contrib=len(cs), num_params=P)
            report.times.t_agg += r_i * t_scr
            report.e_comp += r_i * e_scr
        total_e += report.e_tot
        history = {"accuracy": [float(a) for a in acc_h[:r_i, i]],
                   "loss": [float(v) for v in loss_h[:r_i, i]],
                   "battery": [float(v) for v in bat_h[:r_i, i]],
                   "round_executed": [float(v) for v in exec_h[:r_i, i]]}
        if mob is not None:
            history["member_mask"] = [hist["member_h"][t, i].copy() for t in range(r_i)]
            history["members"] = [float(hist["member_h"][t, i].sum()) for t in range(r_i)]
        if fc is not None:
            for name, key in (("drops", "drop_h"), ("retries", "retry_h"), ("stale", "stale_h")):
                history[name] = [float(v) for v in hist[key][:r_i, i]]
            history["deliver_mask"] = [hist["deliver_h"][t, i].copy() for t in range(r_i)]
        if cc is not None:
            history["round_clock"] = [int(v) for v in hist["clock_h"][:r_i, i]]
            history["idle_steps"] = [int(v) for v in hist["idle_h"][:r_i, i]]
        if ac is not None:
            history["corrupted_mask"] = [hist["corrupt_h"][t, i].copy() for t in range(r_i)]
        if robust != "none":
            history["clipped_mask"] = [hist["clip_h"][t, i].copy() for t in range(r_i)]
        sessions.append(SessionResult(
            accuracy=history["accuracy"][-1] if history["accuracy"] else 0.0,
            rounds=r_i, n_contributors=len(cs), report=report,
            battery=dataclasses.replace(b0, level=float(level_np[i])),
            history_raw=history, stop_reason=protocol.stop_reason_name(codes_np[i]),
            params=tree_unravel(spec, carry.last[i]), model_bytes=model_bytes))
    fleet_hist = {"accuracy": acc_h, "loss": loss_h, "battery": bat_h,
                  "executed": exec_h, "round_executed": body_h}
    for name, key in (("member", "member_h"), ("drops", "drop_h"), ("retries", "retry_h"),
                      ("stale", "stale_h"), ("deliver", "deliver_h"),
                      ("round_clock", "clock_h"), ("idle_steps", "idle_h"),
                      ("corrupted", "corrupt_h"), ("clipped", "clip_h")):
        if hist[key] is not None:
            fleet_hist[name] = hist[key]
    _sync(dev)
    tl.finish(unpack)
    return FleetResult(
        sessions=sessions, rounds=rounds_np, stop_codes=codes_np,
        accuracy=np.array([s.accuracy for s in sessions], np.float32),
        battery_level=level_np, total_energy_j=float(total_e),
        history=fleet_hist,
        staged_param_bytes=int(staged_param_bytes),
        device_round_state_bytes=int(staged_param_bytes), timeline=tl, hlo_stats=hlo)


def _baseline_fault_tx(fc, rounds: int, i: int, method: str, dfl_topology: str,
                       n_cli: int, partitionable: bool) -> float:
    """The extra transmissions (attempts beyond the delivered ones) of
    requester ``i``'s baseline links over ``rounds`` rounds: link 0, the
    server uplink, under cfl; links 1 ... fan under dfl (mesh: every peer,
    ring: two neighbours)."""
    if method == "cfl":
        link_ids = torch.zeros(1, dtype=torch.int64)
    else:
        fan = n_cli - 1 if dfl_topology == "mesh" else min(2, n_cli - 1)
        link_ids = torch.arange(1, fan + 1, dtype=torch.int64)
    delivered, attempts, _ = faults_mod.link_outcomes(
        fc, torch.arange(rounds), fc.requester_id + i, link_ids, partitionable=partitionable)
    return float(attempts.sum() - delivered.sum())


def _run_fleet_baseline(task, requesters: Sequence[RequesterSpec], cfg: EnFedConfig,
                        cost: CostModel, method: str, dfl_topology: str,
                        dev: torch.device, round_chunk: int, tl: Timeline,
                        trace=None) -> FleetResult:
    """The cfl/dfl protocol variants on the flat (R, N, P) round state.

    Requester i's roster is ``[own shard] + every neighbour with data``, in
    neighbourhood order: the loop learners' ``client_data``.  Shards are
    staged once per content (blake2b key) into a table plus (R, N) gather
    indices.  Per round every lane fits with seed ``seed + stride·r + j``
    (stride 31 cfl, 77 dfl) from the shared global (cfl) or its own params
    (dfl); cfl aggregates with one eq. 14 launch weighted by shard size
    (0 on padded lanes), dfl with N launches, one per row of each
    requester's mixing matrix (padded lanes mix with themselves).  The
    global (cfl) or node 0 (dfl) is scored on the requester's test stack;
    a session stops on accuracy or the round budget.  Sessions are priced
    with ``cfl_session``/``dfl_session`` and the modelled fit time; wire
    bytes follow ``cfg.compress``, though the state stays fp32.  The round
    loop reads the fleet's activity once per ``round_chunk`` rounds, and
    ``tl`` gets the enfed fleet's ``stage``, ``program`` and ``unpack``.
    """
    R = len(requesters)
    stage = tl.begin("stage")
    rosters = []
    for rspec in requesters:
        shards = [rspec.own_train]
        for nd in rspec.neighborhood:
            st = rspec.contributor_states.get(nd.device_id)
            if st is not None:
                shards.append(st["data"])
        rosters.append(shards)
    N = max(len(s) for s in rosters)

    # ---- deduplicated shard table + per-lane gather indices -----------------
    shard_rows: dict = {}
    shard_x, shard_y = [], []
    cidx = np.zeros((R, N), np.int64)
    cli_n = np.zeros((R, N), np.int64)
    for i, shards in enumerate(rosters):
        for j, (xs, ys) in enumerate(shards):
            xa = np.ascontiguousarray(xs, np.float32)
            ya = np.ascontiguousarray(ys, np.int64)
            key = (xa.shape, hashlib.blake2b(xa.tobytes(), digest_size=16).digest(),
                   hashlib.blake2b(ya.tobytes(), digest_size=16).digest())
            u = shard_rows.setdefault(key, len(shard_x))
            if u == len(shard_x):
                shard_x.append(xa)
                shard_y.append(ya)
            cidx[i, j] = u
            cli_n[i, j] = len(xa)
    cx_tab, _ = _pad_stack(shard_x, max(len(x) for x in shard_x), np.float32)
    cy_tab, _ = _pad_stack(shard_y, cx_tab.shape[1], np.int64)
    cx_tab, cy_tab = torch.from_numpy(cx_tab).to(dev), torch.from_numpy(cy_tab).to(dev)
    nc_pad = cx_tab.shape[1]
    lane_rows = torch.from_numpy(cidx.reshape(R * N)).to(dev)[:, None]

    # ---- node params: the flat (R, N, P) round state ------------------------
    template = task.init(cfg.seed)
    init_flat, spec = tree_ravel(template)
    P = int(init_flat.shape[-1])
    if method == "dfl":
        # DFLLearner: node j of every requester inits from seed + j
        node_inits = torch.stack([init_flat] + [tree_ravel(task.init(cfg.seed + j))[0]
                                                for j in range(1, N)])
        contrib = node_inits[None].expand(R, N, P).clone()
        last = contrib[:, 0].clone()
        strategy = topology.AggregationStrategy(
            kind="dfl_mesh" if dfl_topology == "mesh" else "dfl_ring")
        mix_w = np.zeros((R, N, N), np.float32)
        for i, shards in enumerate(rosters):
            n_i = len(shards)
            mix_w[i, :n_i, :n_i] = topology.group_mixing_matrix(n_i, strategy)
            for k in range(n_i, N):
                mix_w[i, k, k] = 1.0          # padded lanes mix with themselves
        # row k of every requester's matrix, each a contiguous (R, N) block
        mix_rows = [torch.from_numpy(np.ascontiguousarray(mix_w[:, k])).to(dev)
                    for k in range(N)]
    else:
        # CFL carries ONE global; the lanes hold each round's client fits
        last = init_flat.expand(R, P).clone()
        cli_w = torch.from_numpy(cli_n.astype(np.float32)).to(dev)

    # ---- requester test stacks + schedule bounds ----------------------------
    test_x, test_mask = _pad_stack([np.asarray(s.own_test[0], np.float32) for s in requesters],
                                   max(len(s.own_test[0]) for s in requesters), np.float32)
    test_y, _ = _pad_stack([np.asarray(s.own_test[1], np.int64) for s in requesters],
                           test_x.shape[1], np.int64)
    test_x, test_y, test_mask = (torch.from_numpy(a).to(dev)
                                 for a in (test_x, test_y, test_mask))
    batch = cfg.batch_size
    steps_max = max(schedule.fit_steps(int(n), batch) for n in cli_n[cli_n > 0])
    stride = 31 if method == "cfl" else 77
    lane_j = np.tile(np.arange(N), R)
    desired = torch.tensor(cfg.desired_accuracy, dtype=torch.float32, device=dev)

    def client_batch(ib):
        return cx_tab[lane_rows, ib], cy_tab[lane_rows, ib]

    # ---- the round loop -------------------------------------------------------
    active = torch.ones(R, dtype=torch.bool, device=dev)
    stop_code = torch.full((R,), protocol.STOP_MAX_ROUNDS, dtype=torch.int32, device=dev)
    rounds_done = torch.zeros(R, dtype=torch.int32, device=dev)
    acc_h, loss_h, exec_h = (
        torch.zeros((cfg.max_rounds, R), dtype=torch.float32, device=dev) for _ in range(3))
    body_h = torch.zeros((cfg.max_rounds,), dtype=torch.float32, device=dev)
    _sync(dev)
    tl.finish(stage)
    with _ProgramHooks(trace, dev, tl) as hooks:
        for r in _chunked_rounds(cfg.max_rounds, round_chunk, lambda: bool(active.any())):
            ran = active.any()
            body_h[r] = ran.to(torch.float32)
            # Phase.FIT at every client lane, client j seeded seed + stride*r + j;
            # padded lanes (n = 0) are zero-weight no-op steps
            scores = torch.stack([
                schedule.epoch_scores(cfg.seed + stride * r + j, cfg.epochs, nc_pad,
                                      partitionable=task.threefry_partitionable)
                for j in range(N)])
            idx, w = schedule.lane_plans(scores[lane_j], cli_n.reshape(R * N), batch, steps_max)
            src = (last[:, None].expand(R, N, P) if method == "cfl" else contrib).reshape(R * N, P)
            fitted, fit_loss = _fit_lanes(task, spec, src, client_batch, idx.to(dev), w.to(dev),
                                          (w.sum(-1) > 0).numpy())
            fitted = fitted.reshape(R, N, P)
            # Phase.COLLECT + Phase.AGGREGATE: the server's data-size-weighted
            # eq. 14 (one launch), or each node's mixing row (N launches; rows
            # sum to 1, so the normalized mean is the gossip mix)
            if method == "cfl":
                new_last = fedavg_flat_batched(fitted, cli_w)
            else:
                mixed = torch.stack([fedavg_flat_batched(fitted, row) for row in mix_rows], dim=1)
                contrib = torch.where(active[:, None, None], mixed, contrib)
                new_last = mixed[:, 0]
            # Phase.SCORE: the global (cfl) / node 0 (dfl) on the requester's test
            acc = _eval_lanes(task.model, spec, new_last, test_x, test_y, test_mask)
            # Phase.ACCOUNT without a battery: stop on accuracy or the budget
            reached = acc >= desired
            stop_code = torch.where(active & reached, protocol.STOP_ACCURACY, stop_code)
            rounds_done = rounds_done + active.to(torch.int32)
            last = torch.where(active[:, None], new_last, last)
            next_active = active & ~reached
            # a round no lane ran leaves its rows 0; the loss is the requester
            # lane's fit loss
            acc_h[r], loss_h[r] = (torch.where(ran, v, 0.0)
                                   for v in (acc, fit_loss.reshape(R, N)[:, 0]))
            exec_h[r] = active.to(torch.float32)
            active = next_active
    state = dict(last=last, active=active, stop_code=stop_code, rounds_done=rounds_done,
                 acc_h=acc_h, loss_h=loss_h, exec_h=exec_h, body_h=body_h)
    if method == "dfl":
        state["contrib"] = contrib
    hlo = hooks.stats(R * N * P * 4, state)

    # ---- per-session views, priced like the loop learners ------------------
    unpack = tl.begin("unpack")
    rounds_np = rounds_done.cpu().numpy()
    codes_np = stop_code.cpu().numpy()
    acc_h, loss_h, exec_h, body_h = (t.cpu().numpy() for t in (acc_h, loss_h, exec_h, body_h))
    model_bytes = update_wire_bytes(P, encrypt=False, compress=cfg.compress,
                                    raw_bytes=tree_bytes(template))
    sessions = []
    total_e = 0.0
    for i, rspec in enumerate(requesters):
        r_i = int(rounds_np[i])
        n_cli = len(rosters[i])
        accs = [float(a) for a in acc_h[:r_i, i]]
        if method == "cfl":
            report = cost.cfl_session(
                rounds=r_i, num_params=P, model_bytes=model_bytes,
                num_samples=len(rspec.own_train[0]), epochs=cfg.epochs)
            history = {"accuracy": accs, "loss": []}
        else:
            report = cost.dfl_session(
                rounds=r_i, n_peers=n_cli - 1, num_params=P, model_bytes=model_bytes,
                num_samples=len(rspec.own_train[0]), epochs=cfg.epochs,
                topology=dfl_topology)
            history = {"accuracy": accs}
        if cfg.faults is not None and r_i:
            # the baselines' convergence is their loop learners', so link
            # faults are priced in the cost domain only: the fault world of
            # requester requester_id + i over this method's links (the one
            # WAN uplink of cfl, the gossip fan of dfl), every extra
            # transmission re-priced through the one CostModel
            extra = _baseline_fault_tx(cfg.faults, r_i, i, method, dfl_topology, n_cli,
                                       task.threefry_partitionable)
            if method == "cfl":
                _, e_tx_r, t_xfer = cost.retry_energy(model_bytes=model_bytes, encrypt=False,
                                                      rate_bps=cost.link.wan_rate_bps)
            else:
                _, e_tx_r, t_xfer = cost.retry_energy(model_bytes=model_bytes, encrypt=True)
            report.add_transfers(extra, t_xfer, e_tx_r)
            history["fault_extra_tx"] = extra
        total_e += report.e_tot
        sessions.append(SessionResult(
            accuracy=accs[-1] if accs else 0.0, rounds=r_i, n_contributors=n_cli - 1,
            report=report, battery=None, history_raw=history,
            stop_reason=protocol.stop_reason_name(codes_np[i]),
            params=tree_unravel(spec, last[i]), model_bytes=model_bytes))
    staged_param_bytes = R * N * P * 4
    _sync(dev)
    tl.finish(unpack)
    return FleetResult(
        sessions=sessions, rounds=rounds_np, stop_codes=codes_np,
        accuracy=np.array([s.accuracy for s in sessions], np.float32),
        battery_level=np.ones((R,), np.float32), total_energy_j=float(total_e),
        # no battery drains: every executed round records the full level
        history={"accuracy": acc_h, "loss": loss_h,
                 "battery": np.repeat(body_h[:, None], R, axis=1),
                 "executed": exec_h, "round_executed": body_h},
        staged_param_bytes=staged_param_bytes,
        device_round_state_bytes=staged_param_bytes, timeline=tl, hlo_stats=hlo)
