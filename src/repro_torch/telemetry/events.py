"""The normalized round-event stream: one schema, two engines (port of
``repro.telemetry.events``).

:func:`session_events` is the single history->event adapter.  It reads a
``SessionResult.history`` dict — whichever engine produced it — and
materializes a list of :class:`RoundEvent`, erasing the per-engine
buffer-layout differences at this boundary:

* membership / delivery masks become **index sets** (tuples of lane
  indices), so the loop engine's length-``n_contributors`` rows and the
  fleet engine's N-padded rows normalize to the same value;
* keys an engine or method legitimately lacks (no battery, no faults,
  dfl's accuracy-only history) become ``None`` / zero, identically for
  both engines;
* per-round wire bytes and energy are derived here, from
  ``SessionResult.model_bytes`` and the battery trajectory, rather than
  being one more ad-hoc history list each engine would have to keep in
  sync.

Because both engines run counter-based worlds (schedule, adversary),
their event streams on the same world are equal field for
field: exactly on the structural fields, to tolerance on the float
metrics (:func:`compare_event_streams`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Event phases.  "round" = one executed (or faulted-out) protocol round;
# "stop" = the session's terminal event carrying the stop reason.
EVENT_PHASES: Tuple[str, ...] = ("round", "stop")


@dataclasses.dataclass(frozen=True)
class RoundEvent:
    """One normalized observation of one session round (or its stop).

    Optional fields are ``None`` when the concept does not exist for the
    run (no battery model, static membership, perfect links) — never
    silently zeroed, so absence is distinguishable from an observed 0.
    """

    round: int                    # 0-based round index; stop events use
                                  # the total executed-round count
    requester: int                # lane index of the requesting device
    phase: str                    # "round" | "stop"
    executed: bool                # False for battery-faulted skip rounds
    members: Optional[int]        # contributor count this round (mobility)
    member_set: Optional[Tuple[int, ...]]   # member lane indices (mobility)
    delivered: Optional[Tuple[int, ...]]    # lanes whose update arrived
                                            # (faults; None = perfect links)
    drops: float                  # dropped links this round
    retries: float                # retransmissions this round
    stale: float                  # stale (round r-1) deliveries this round
    battery: Optional[float]      # requester battery fraction after round
    accuracy: float               # requester test accuracy after round
    loss: Optional[float]         # mean fit loss (None if untracked)
    wire_bytes: int               # update bytes received = model_bytes
                                  # x delivered contributor count
    energy_j: Optional[float]     # battery-derived joules spent this
                                  # round (None for round 0 / no battery)
    stop_reason: Optional[str]    # protocol stop reason (stop phase only)
    # async-cadence observability (the cadence world, ROADMAP.md slice E.3;
    # None = lockstep world).  Mapped HERE from the engines' round_clock/idle_steps
    # history buffers — the house rule stands: engines write history,
    # only this adapter emits events.
    clock: Optional[int] = None   # global event step this round ran at
    idle: Optional[float] = None  # idle event steps since the previous
                                  # executed round
    # Byzantine observability (repro_torch.core.adversary / kernels.robust;
    # None = honest world / fedavg aggregation).  Index sets like
    # member_set/delivered, mapped from the corrupted_mask/clipped_mask
    # history rows — same house rule, same padding erasure.
    corrupted: Optional[Tuple[int, ...]] = None  # lanes whose delivered
                                                 # image was corrupted
    clipped: Optional[Tuple[int, ...]] = None    # lanes the robust
                                                 # aggregator norm-clipped


# name -> (allowed value types, allows None).  bool before int: a bool IS
# an int to isinstance, so fields typed int here explicitly reject bools.
ROUND_EVENT_FIELDS: Dict[str, tuple] = {
    "round": ((int,), False),
    "requester": ((int,), False),
    "phase": ((str,), False),
    "executed": ((bool,), False),
    "members": ((int,), True),
    "member_set": ((tuple,), True),
    "delivered": ((tuple,), True),
    "drops": ((float,), False),
    "retries": ((float,), False),
    "stale": ((float,), False),
    "battery": ((float,), True),
    "accuracy": ((float,), False),
    "loss": ((float,), True),
    "wire_bytes": ((int,), False),
    "energy_j": ((float,), True),
    "stop_reason": ((str,), True),
    "clock": ((int,), True),
    "idle": ((float,), True),
    "corrupted": ((tuple,), True),
    "clipped": ((tuple,), True),
}

# Fields compared exactly across engines; the rest are float metrics
# compared to tolerance (see compare_event_streams).  Lane clocks are
# exact by construction (counter-based cadence), so any drift is a bug.
_EXACT_FIELDS = ("round", "requester", "phase", "executed", "members",
                 "member_set", "delivered", "drops", "retries", "stale",
                 "wire_bytes", "stop_reason", "clock", "corrupted",
                 "clipped")


def _mask_to_set(row) -> Tuple[int, ...]:
    """A 0/1 mask row of any length -> the tuple of set lane indices.
    Erases the loop-vs-fleet padding asymmetry."""
    return tuple(i for i, v in enumerate(row) if float(v) > 0.5)


def session_events(session, *, requester: int = 0) -> List[RoundEvent]:
    """Adapt one SessionResult's history (either engine) to RoundEvents.

    ``requester`` is the lane index stamped on every event (the session
    itself does not know its position in the fleet).
    """
    history = (session.history_raw if hasattr(session, "history_raw")
               else session.history) or {}
    acc = [float(a) for a in history.get("accuracy", [])]
    rounds = len(acc)
    loss = history.get("loss")
    bat = history.get("battery")
    executed = history.get("round_executed")
    members = history.get("members")
    member_mask = history.get("member_mask")
    deliver_mask = history.get("deliver_mask")
    drops = history.get("drops")
    retries = history.get("retries")
    stale = history.get("stale")
    clock_h = history.get("round_clock")
    idle_h = history.get("idle_steps")
    corrupted_mask = history.get("corrupted_mask")
    clipped_mask = history.get("clipped_mask")
    model_bytes = int(getattr(session, "model_bytes", 0) or 0)
    capacity = (float(session.battery.capacity_j)
                if getattr(session, "battery", None) is not None else None)

    events: List[RoundEvent] = []
    for r in range(rounds):
        member_set = (_mask_to_set(member_mask[r])
                      if member_mask is not None else None)
        if members is not None:
            n_members: Optional[int] = int(members[r])
        elif member_set is not None:
            n_members = len(member_set)
        else:
            n_members = None
        delivered = (_mask_to_set(deliver_mask[r])
                     if deliver_mask is not None else None)
        if delivered is not None:
            n_recv = len(delivered)
        elif n_members is not None:
            n_recv = n_members
        else:
            n_recv = int(getattr(session, "n_contributors", 0))
        level = float(bat[r]) if bat else None
        if bat and capacity is not None and r > 0:
            # round 0's predecessor level is not in the history, so the
            # first round's energy is unobservable here (None), not 0
            energy: Optional[float] = max(
                0.0, (float(bat[r - 1]) - float(bat[r])) * capacity)
        else:
            energy = None
        events.append(RoundEvent(
            round=r, requester=requester, phase="round",
            executed=bool(float(executed[r]) > 0.5) if executed is not None
            else True,
            members=n_members, member_set=member_set, delivered=delivered,
            drops=float(drops[r]) if drops is not None else 0.0,
            retries=float(retries[r]) if retries is not None else 0.0,
            stale=float(stale[r]) if stale is not None else 0.0,
            battery=level, accuracy=acc[r],
            loss=float(loss[r]) if loss else None,
            wire_bytes=model_bytes * n_recv, energy_j=energy,
            stop_reason=None,
            clock=int(clock_h[r]) if clock_h is not None else None,
            idle=float(idle_h[r]) if idle_h is not None else None,
            corrupted=(_mask_to_set(corrupted_mask[r])
                       if corrupted_mask is not None else None),
            clipped=(_mask_to_set(clipped_mask[r])
                     if clipped_mask is not None else None)))
    events.append(RoundEvent(
        round=rounds, requester=requester, phase="stop", executed=True,
        members=None, member_set=None, delivered=None,
        drops=0.0, retries=0.0, stale=0.0,
        battery=float(bat[-1]) if bat else None,
        accuracy=acc[-1] if acc else 0.0, loss=None,
        wire_bytes=0, energy_j=None,
        stop_reason=str(session.stop_reason)))
    return events


def validate_events(events: Iterable[RoundEvent]) -> List[RoundEvent]:
    """Schema-check an event stream; raises ValueError on the first
    violation, returns the (listed) stream otherwise."""
    events = list(events)
    last_round: Dict[int, int] = {}
    stopped: set = set()
    for k, ev in enumerate(events):
        if not isinstance(ev, RoundEvent):
            raise ValueError(f"event {k}: not a RoundEvent: {type(ev)!r}")
        for name, (types, noneable) in ROUND_EVENT_FIELDS.items():
            val = getattr(ev, name)
            if val is None:
                if not noneable:
                    raise ValueError(f"event {k}: field {name} is None")
                continue
            if types == (int,) and isinstance(val, bool):
                raise ValueError(f"event {k}: field {name} is bool, not int")
            if not isinstance(val, types):
                raise ValueError(
                    f"event {k}: field {name} has type {type(val).__name__}, "
                    f"expected {'/'.join(t.__name__ for t in types)}")
        if ev.phase not in EVENT_PHASES:
            raise ValueError(f"event {k}: unknown phase {ev.phase!r}")
        if ev.phase == "stop" and ev.stop_reason is None:
            raise ValueError(f"event {k}: stop event without stop_reason")
        if ev.phase == "round" and ev.stop_reason is not None:
            raise ValueError(f"event {k}: round event with stop_reason")
        if ev.requester in stopped:
            raise ValueError(
                f"event {k}: requester {ev.requester} already stopped")
        prev = last_round.get(ev.requester)
        if prev is not None and ev.round != prev + 1:
            raise ValueError(
                f"event {k}: requester {ev.requester} round {ev.round} "
                f"does not follow round {prev}")
        if prev is None and ev.round != 0 and ev.phase == "round":
            raise ValueError(
                f"event {k}: requester {ev.requester} starts at round "
                f"{ev.round}, expected 0")
        last_round[ev.requester] = ev.round
        if ev.phase == "stop":
            stopped.add(ev.requester)
    return events


def _close(a: Optional[float], b: Optional[float], atol: float) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= atol


def compare_event_streams(a: Sequence[RoundEvent], b: Sequence[RoundEvent],
                          *, atol: float = 1e-4,
                          energy_atol: float = 1.0) -> List[str]:
    """Cross-engine stream equality: exact on structural fields, within
    ``atol`` on accuracy/loss/battery and ``energy_atol`` on energy
    (battery levels agree to ~1e-5 across engines, which a 40 kJ
    capacity amplifies to ~1 J of per-round energy slack).  Returns a
    list of human-readable mismatches — empty means equal.
    """
    diffs: List[str] = []
    if len(a) != len(b):
        diffs.append(f"stream length {len(a)} vs {len(b)}")
    for k, (ea, eb) in enumerate(zip(a, b)):
        for name in _EXACT_FIELDS:
            va, vb = getattr(ea, name), getattr(eb, name)
            if va != vb:
                diffs.append(f"event {k}: {name} {va!r} != {vb!r}")
        for name in ("accuracy", "loss", "battery", "idle"):
            if not _close(getattr(ea, name), getattr(eb, name), atol):
                diffs.append(f"event {k}: {name} {getattr(ea, name)} !~ "
                             f"{getattr(eb, name)} (atol={atol})")
        if not _close(ea.energy_j, eb.energy_j, energy_atol):
            diffs.append(f"event {k}: energy_j {ea.energy_j} !~ "
                         f"{eb.energy_j} (atol={energy_atol})")
    return diffs
