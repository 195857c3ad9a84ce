"""The EnFed fleet engine: R requester sessions advancing together on one
flat round state (port of ``repro.core.fleet.run_fleet`` for
``method="enfed"`` in a static, lockstep world).

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
* **Early exit.**  Round r runs iff ``r < max_rounds`` and some lane is
  still active.  That flag is read on the host once per round, one small
  sync beside thousands of launches, which reproduces the reference's
  ``round_executed`` whatever its ``round_chunk``.

* **Byzantine world.**  Under ``adversary=`` lane ``i`` draws its
  corruption weather as requester ``requester_id + i`` over its
  contributors' real device ids, and the round body corrupts a copy of
  the delivered buffer (codes and scales under int8, whose padding tail
  is then zeroed so noise codes there cannot reach the q8 norms); the
  carried state is never overwritten.  Under ``robust != "none"`` the
  robust statistic of :mod:`repro_torch.kernels.robust.ops` replaces
  eq. 14, on the fused int8 state or the fp32 one.

Encryption is priced in the cost domain only (the reference's fleet does
not run the cipher per round either); the loop engine holds the AES
transport.  Mobility, faults, cadence, staleness decay, the dfl/cfl lanes,
checkpoints and tracing raise ``NotImplementedError`` naming their
``ROADMAP.md`` slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import adversary as adversary_mod
from repro_torch.core import protocol, schedule
from repro_torch.core.battery import BatteryState, discharge_level, load_efficiency
from repro_torch.core.energy import CostModel, update_wire_bytes
from repro_torch.core.incentive import NeighborDevice, sign_contracts_fleet
from repro_torch.core.rounds import EnFedConfig, SessionResult, _unported
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.fedavg.ops import fedavg_flat_batched, fedavg_flat_batched_q8
from repro_torch.kernels.quantize.ops import (dequantize_flat_batched,
                                              quantize_flat_batched, resolve_compress)
from repro_torch.kernels.robust.ops import robust_aggregate, robust_aggregate_q8
from repro_torch.models.classifiers import masked_cross_entropy_loss
from repro_torch.optim import lane_adam_init, lane_adam_step
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
    staged_param_bytes: int = 0       # contributor round state as staged
                                      # (fp32 (R, N, P), or int8 + scales)
    device_round_state_bytes: int = 0  # that state as carried on the device

    @property
    def history_raw(self) -> Dict[str, np.ndarray]:
        return self.history


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


def _check_ported(cfg, method, checkpoint_dir, checkpoint_every, resume_from,
                  timeline, trace) -> None:
    if method in ("dfl", "cfl"):
        raise NotImplementedError(
            f"method={method!r} (baseline lanes, ROADMAP.md slice C item 9) is not "
            "ported yet")
    if method != "enfed":
        raise ValueError(f"unknown method {method!r} (enfed|dfl|cfl)")
    if checkpoint_dir is not None or resume_from is not None or checkpoint_every:
        raise NotImplementedError(
            "checkpoint/resume is ported with the fault world, ROADMAP.md slice E")
    if timeline is not None or trace is not None:
        raise NotImplementedError(
            "timeline/trace exports are ROADMAP.md slice F (not ported yet)")
    unported = _unported(cfg)
    if unported is not None:
        raise NotImplementedError(f"{unported} is not ported yet")


def run_fleet(task, requesters: Sequence[RequesterSpec],
              cfg: Optional[EnFedConfig] = None,
              cost_model: Optional[CostModel] = None, *,
              method: str = "enfed",
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0,
              resume_from: Optional[str] = None,
              timeline=None, trace=None, device=None) -> FleetResult:
    """Run ``len(requesters)`` concurrent EnFed sessions on one flat round
    state, on ``device`` (the GPU unless the caller names another; the
    task must run there).  Each requester's ``contributor_states`` end up
    holding that session's final contributor params (the dequantized wire
    image under int8); requesters sharing one states dict see the last
    writer's lanes."""
    cfg = cfg if cfg is not None else EnFedConfig()
    cost = cost_model or CostModel()
    dev = resolve_device(device)
    if torch.device(task.device) != dev:
        raise ValueError(f"the task runs on {task.device}, the fleet on {dev}")
    _check_ported(cfg, method, checkpoint_dir, checkpoint_every, resume_from,
                  timeline, trace)
    R = len(requesters)
    if R == 0:
        raise ValueError("empty fleet")

    # ---- Phase.HANDSHAKE (host, static) -------------------------------------
    contracts, contract_mask = sign_contracts_fleet(
        [spec.neighborhood for spec in requesters], cfg.offered_incentive, cfg.n_max)
    for i, cs in enumerate(contracts):
        if not cs:
            raise RuntimeError(
                f"requester {i}: no nearby device agreed to the incentive (N_d < 1)")
    N = contract_mask.shape[1]
    round_w = np.zeros((R, N), np.float32)
    for i, cs in enumerate(contracts):
        round_w[i, :len(cs)] = protocol.round_weights(len(cs), cfg.strategy)
    ac, robust = cfg.adversary, cfg.robust
    if ac is not None:
        # lane i rolls its corruption dice as requester requester_id + i, over
        # its contributors' real device ids; asigned masks the padded lanes
        areq_ids = np.arange(R, dtype=np.int64) + ac.requester_id
        acand_ids = np.zeros((R, N), np.int64)
        asigned = np.zeros((R, N), bool)
        for i, cs in enumerate(contracts):
            acand_ids[i, :len(cs)] = [c.device_id for c in cs]
            asigned[i, :len(cs)] = True

    # ---- contributor round state and deduplicated shards --------------------
    template = requesters[0].contributor_states[contracts[0][0].device_id]["params"]
    _, spec = tree_ravel(template)
    P = tree_size(template)
    contrib_np = np.zeros((R, N, P), np.float32)
    host_rows: dict = {}                 # id(params) -> host fp32 row
    shard_rows: dict = {}
    shard_x, shard_y = [], []
    cidx = np.zeros((R, N), np.int64)
    shard_len = np.zeros((R, N), np.int64)
    for i, (rspec, cs) in enumerate(zip(requesters, contracts)):
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

    # ---- Phase.REFRESH: unique rows, their shards and their one plan --------
    ref_epochs = max(cfg.contributor_refresh_epochs, 0)
    do_refresh = ref_epochs > 0
    if do_refresh:
        cx_tab, _ = _pad_stack(shard_x, max(len(x) for x in shard_x), np.float32)
        cy_tab, _ = _pad_stack(shard_y, cx_tab.shape[1], np.int64)
        cx_tab, cy_tab = torch.from_numpy(cx_tab).to(dev), torch.from_numpy(cy_tab).to(dev)
        ref_steps = max(schedule.fit_steps(int(n), batch) for n in shard_len[shard_len > 0])
        ref_map: dict = {}
        ref_uidx = np.zeros((R, N), np.int64)
        lane_valid = np.zeros((R, N), bool)
        u_cidx, u_n, u_seed, rep = [], [], [], []
        for i, cs in enumerate(contracts):
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
    e_round = np.array([cost.round_energy(
        n_contrib=len(cs), num_params=P, model_bytes=model_bytes,
        num_samples=len(rspec.own_train[0]), epochs=cfg.epochs,
        n_devices=len(rspec.neighborhood), encrypt=cfg.encrypt)
        for rspec, cs in zip(requesters, contracts)], np.float32)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    e_round_t = f32(e_round)
    capacity = f32([b.capacity_j for b in batteries])
    eff = f32([load_efficiency(cost.device.p_train, b.high_load_penalty,
                               b.high_load_threshold_w) for b in batteries])
    desired = f32(cfg.desired_accuracy)
    threshold = f32(cfg.battery_threshold)
    round_w_t = f32(round_w)
    if ac is not None:
        areq_ids, acand_ids, asigned = (torch.from_numpy(a).to(dev)
                                        for a in (areq_ids, acand_ids, asigned))

    # ---- the round loop -------------------------------------------------------
    level = f32([b.level for b in batteries])
    last = torch.zeros((R, P), dtype=torch.float32, device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    stop_code = torch.full((R,), protocol.STOP_MAX_ROUNDS, dtype=torch.int32, device=dev)
    rounds_done = torch.zeros(R, dtype=torch.int32, device=dev)
    acc_h, loss_h, bat_h, exec_h = (
        torch.zeros((cfg.max_rounds, R), dtype=torch.float32, device=dev) for _ in range(4))
    # (max_rounds, R, N) corrupted-delivery and clipped traces
    corrupt_h, clip_h = (torch.zeros((cfg.max_rounds, R, N), dtype=torch.float32, device=dev)
                         for _ in range(2))
    body_h = np.zeros((cfg.max_rounds,), np.float32)
    any_active = True
    for r in range(cfg.max_rounds):
        if not any_active:
            break
        body_h[r] = 1.0
        # Phase.COLLECT: the delivered buffer is the round state, or under
        # an adversary a corrupted copy of it, keyed on the delivering round
        src, src_s = contrib, cscale
        if ac is not None:
            cmask = adversary_mod.corruption_mask(ac, r, areq_ids, acand_ids,
                                                  partitionable=partitionable)
            if wire_compress == "int8":
                src, src_s = adversary_mod.corrupt_wire_batched(
                    ac, src, src_s, cmask, r, areq_ids, acand_ids,
                    partitionable=partitionable)
                # the padding tail is no part of the update: the loop engine
                # slices to P before any statistic, so noise codes there must
                # not reach the q8 norms (honest tails are zero codes already)
                if P < src.shape[-1]:
                    src = src * (torch.arange(src.shape[-1], device=dev) < P).to(src.dtype)
            else:
                src = adversary_mod.corrupt_dense_batched(
                    ac, src, cmask, r, areq_ids, acand_ids, partitionable=partitionable)
            corrupt_h[r] = (cmask & asigned & active[:, None]).to(torch.float32)
        # Phase.AGGREGATE: eq. 14, or the robust statistic, in one launch
        # over the whole buffer
        if robust != "none":
            if wire_compress == "int8":
                glob, clipped = robust_aggregate_q8(src, src_s, round_w_t, method=robust)
                glob = glob[:, :P]
            else:
                glob, clipped = robust_aggregate(src, round_w_t, method=robust)
            clip_h[r] = (clipped & active[:, None]).to(torch.float32)
        elif wire_compress == "int8":
            glob = fedavg_flat_batched_q8(src, src_s, round_w_t)[:, :P]
        else:
            glob = fedavg_flat_batched(src, round_w_t)
        # Phase.FIT + Phase.SCORE, every requester as a lane
        scores = schedule.epoch_scores(cfg.seed + r, cfg.epochs, n_pad,
                                       partitionable=partitionable)
        idx, w = schedule.lane_plans(scores, n_own, batch, steps_max)
        new_flat, last_loss = _fit_lanes(
            task, spec, glob, lambda ib: (own_x[lanes_r, ib], own_y[lanes_r, ib]),
            idx.to(dev), w.to(dev), (w.sum(-1) > 0).numpy())
        acc = _eval_lanes(task.model, spec, new_flat, test_x, test_y, test_mask)
        # Phase.ACCOUNT: fp32 battery discharge of the executing lanes
        level_new = discharge_level(level, e_round_t, capacity, eff)
        reached = acc >= desired
        low = level_new < threshold
        stop_code = torch.where(active & reached, protocol.STOP_ACCURACY,
                                torch.where(active & ~reached & low,
                                            protocol.STOP_BATTERY, stop_code))
        level = torch.where(active, level_new, level)
        rounds_done = rounds_done + active.to(torch.int32)
        last = torch.where(active[:, None], new_flat, last)
        next_active = active & ~reached & ~low
        acc_h[r], loss_h[r], bat_h[r] = acc, last_loss, level
        exec_h[r] = active.to(torch.float32)
        any_active = bool(next_active.any())   # the round's one host sync
        # Phase.REFRESH: the V unique rows train, lanes that go on take them
        if do_refresh and any_active:
            src = dequantize_flat_batched(live, live_s)[:, :P] if live_s is not None else live
            refreshed, _ = _fit_lanes(task, spec, src, refresh_batch, ref_idx, ref_w, ref_live)
            take = (next_active[:, None] & lane_valid)[..., None]
            if live_s is not None:
                live, live_s = quantize_flat_batched(refreshed)
                contrib = torch.where(take, live[ref_uidx], contrib)
                cscale = torch.where(take, live_s[ref_uidx], cscale)
            else:
                live = refreshed
                contrib = torch.where(take, refreshed[ref_uidx], contrib)
        active = next_active

    # ---- unpack -------------------------------------------------------------
    rounds_np = rounds_done.cpu().numpy()
    codes_np = stop_code.cpu().numpy()
    level_np = level.cpu().numpy()
    acc_h, loss_h, bat_h, exec_h, corrupt_h, clip_h = (
        t.cpu().numpy() for t in (acc_h, loss_h, bat_h, exec_h, corrupt_h, clip_h))
    if do_refresh:
        final = (dequantize_flat_batched(contrib, cscale)[..., :P]
                 if cscale is not None else contrib)
        for i, (rspec, cs) in enumerate(zip(requesters, contracts)):
            for j, c in enumerate(cs):
                rspec.contributor_states[c.device_id]["params"] = tree_unravel(spec, final[i, j])

    sessions = []
    total_e = 0.0
    for i, (rspec, cs, b0) in enumerate(zip(requesters, contracts, batteries)):
        r_i = int(rounds_np[i])
        report = cost.session(
            rounds=r_i, n_contrib=float(len(cs)), num_params=P,
            model_bytes=model_bytes, num_samples=len(rspec.own_train[0]),
            epochs=cfg.epochs, n_devices=len(rspec.neighborhood), encrypt=cfg.encrypt)
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
        if ac is not None:
            history["corrupted_mask"] = [corrupt_h[t, i].copy() for t in range(r_i)]
        if robust != "none":
            history["clipped_mask"] = [clip_h[t, i].copy() for t in range(r_i)]
        sessions.append(SessionResult(
            accuracy=history["accuracy"][-1] if history["accuracy"] else 0.0,
            rounds=r_i, n_contributors=len(cs), report=report,
            battery=dataclasses.replace(b0, level=float(level_np[i])),
            history_raw=history, stop_reason=protocol.stop_reason_name(codes_np[i]),
            params=tree_unravel(spec, last[i]), model_bytes=model_bytes))
    fleet_hist = {"accuracy": acc_h, "loss": loss_h, "battery": bat_h,
                  "executed": exec_h, "round_executed": body_h}
    if ac is not None:
        fleet_hist["corrupted"] = corrupt_h
    if robust != "none":
        fleet_hist["clipped"] = clip_h
    return FleetResult(
        sessions=sessions, rounds=rounds_np, stop_codes=codes_np,
        accuracy=np.array([s.accuracy for s in sessions], np.float32),
        battery_level=level_np, total_energy_j=float(total_e),
        history=fleet_hist,
        staged_param_bytes=int(staged_param_bytes),
        device_round_state_bytes=int(staged_param_bytes))
