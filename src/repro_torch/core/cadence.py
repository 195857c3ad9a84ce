"""Asynchronous-cadence world: per-device speed classes, duty cycles,
transient offline steps and battery-aware pacing, shared by both engines
(port of ``repro.core.cadence``).

A fleet of battery-limited phones does not tick on one round clock.
Whether a device *ticks* (advances its own round clock) at global event
step ``t`` is a closed-form function of ``(seed, step, device)``:
counter-based ``fold_in`` chains of :mod:`repro_torch.core.prng`, bit-exact
with the JAX package's ``jax.random`` draws, and exact integer compares.
The loop engine (on the host, step by step) and the fleet engine (on its
device) therefore derive the same ticks, and any step's tick set can be
queried without replaying the earlier ones.

A device's tick composes three gates:

* **Speed class**: each device hashes to a round *stride* in
  ``1 ... n_speed_classes`` and ticks only where ``(t + phase) % stride ==
  0``, with a hashed per-device phase.
* **Duty cycle**: with ``duty_cycle > 0`` the radio is awake ``duty_on``
  steps of every ``duty_cycle`` window (hashed per-device offset).
* **Transient offline**: each ``(step, device)`` draws an int32; the device
  is offline where it lands under the ``p_offline`` threshold (the fault
  world's drop arithmetic).

On top sits the one state-coupled rule, battery-aware pacing: below
``pace_battery_threshold`` a device's stride multiplies by ``pace_factor``.
The compare is fp32 on both operands.

Under cadence the engines loop over global event steps: world state
(mobility, fault weather, the adversary) keys on the step, each requester
carries its own round clock that advances on its ticks, an idle step is
priced through :meth:`repro_torch.core.energy.CostModel.idle_energy`, and
a contributor that does not tick skips its REFRESH, so its resident wire
image is aggregated as-is (the straggler path).  ``cadence=None`` keeps
the lockstep loop, one step per round.

Every function takes an int or a tensor of steps (which adds its shape in
front) and ids of any shape, on either device; ids fold in as their low 32
bits (the reference's int32 -> uint32 cast) and every draw takes the
threefry mode (``partitionable``) explicitly.  ``remainder`` keeps Python's
sign rule, as ``jnp.remainder`` does: :func:`image_lag` at ``t = 0``
computes ``(-1 + phase) % stride``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng

# Offline draws live in [0, _DRAW_MAX); a probability p maps to the
# threshold int(p * _DRAW_MAX), the arithmetic of repro_torch.core.faults.
_DRAW_MAX = 2**31 - 1

_SALT_SPEED = 0x5C    # per-device compute-speed class
_SALT_PHASE = 0xB1    # per-device stride phase offset
_SALT_DUTY = 0xD2     # per-device duty-window offset
_SALT_OFFLINE = 0x0F  # per-(step, device) transient availability


@dataclasses.dataclass(frozen=True)
class CadenceConfig:
    """Device-cadence world parameters for one simulated session.

    ``requester_id`` is the requesting device's id in the cadence
    hash-space; fleet lanes use ``requester_id + lane``.  The default
    offset keeps it clear of contributor ids and of the other worlds' id
    spaces.  Contributors tick by their real device ids: their cadence is
    a property of the device, not of a session observing it.
    """

    n_speed_classes: int = 1      # strides hash into 1..n_speed_classes
    duty_cycle: int = 0           # radio duty window length (0 = always on)
    duty_on: int = 1              # awake steps per duty window
    p_offline: float = 0.0        # per-step transient-offline probability
    pace_battery_threshold: float = 0.0   # below this battery fraction...
    pace_factor: int = 1          # ...the stride multiplies by this
    idle_step_s: float = 0.05     # wall seconds one idle event step costs
    max_events: int = 0           # global event-step budget (0 = derive
                                  # from max_rounds via events_budget)
    seed: int = 0                 # cadence hash seed
    requester_id: int = 1 << 22   # requester lane 0's id in cadence space

    def __post_init__(self):
        # fail at construction, not as a lane that never ticks deep
        # inside a run (the rule FaultConfig follows)
        if self.n_speed_classes < 1:
            raise ValueError(
                f"n_speed_classes must be >= 1 (got {self.n_speed_classes})")
        if self.duty_cycle < 0:
            raise ValueError(
                f"duty_cycle must be >= 0 (got {self.duty_cycle})")
        if self.duty_cycle > 0 and not 1 <= self.duty_on <= self.duty_cycle:
            raise ValueError(
                f"duty_on must be within [1, duty_cycle] "
                f"(got {self.duty_on} of {self.duty_cycle})")
        if not 0.0 <= self.p_offline < 1.0:
            raise ValueError(
                f"p_offline must be within [0, 1) (got {self.p_offline})")
        if not 0.0 <= self.pace_battery_threshold <= 1.0:
            raise ValueError(
                f"pace_battery_threshold must be within [0, 1] "
                f"(got {self.pace_battery_threshold})")
        if self.pace_factor < 1:
            raise ValueError(
                f"pace_factor must be >= 1 (got {self.pace_factor})")
        if self.idle_step_s < 0.0:
            raise ValueError(
                f"idle_step_s must be >= 0 (got {self.idle_step_s})")
        if self.max_events < 0:
            raise ValueError(
                f"max_events must be >= 0 (got {self.max_events})")


def _threshold(p: float) -> int:
    """The integer threshold a probability compiles to (float64 product)."""
    return int(min(max(float(p), 0.0), 1.0) * _DRAW_MAX)


def _ids(device_ids) -> torch.Tensor:
    return torch.as_tensor(device_ids, dtype=torch.int64)


def _steps(t, ids: torch.Tensor) -> torch.Tensor:
    """Steps as int64 on the ids' device, shaped to broadcast in front of
    them: ``t.shape + (1,) * ids.dim()``."""
    ts = torch.as_tensor(t, dtype=torch.int64, device=ids.device)
    return ts.reshape(ts.shape + (1,) * ids.dim())


def _device_draw(seed: int, salt: int, device_id, t, *, partitionable: bool):
    """Int32 draws (in int64) in [0, _DRAW_MAX) of the chain ``PRNGKey(seed)
    -> salt -> device -> step``; ``device_id`` and ``t`` (ints or int64
    tensors) broadcast against each other.  Per-device constants pass
    ``t=0``."""
    ids = torch.as_tensor(device_id, dtype=torch.int64)
    dev = ids.device
    key = prng.fold_in(prng.prng_key(seed, device=dev), salt)
    key = prng.fold_in(key, ids)
    key = prng.fold_in(key, torch.as_tensor(t, dtype=torch.int64, device=dev))
    return prng.randint(key, (), 0, _DRAW_MAX, partitionable=partitionable)


def speed_stride(cc: CadenceConfig, device_ids, *, partitionable: bool = True):
    """int64 base round stride per device, in ``1 ... n_speed_classes``,
    shaped as ``device_ids``: a property of the device, constant for the
    whole session."""
    draw = _device_draw(cc.seed, _SALT_SPEED, _ids(device_ids), 0,
                        partitionable=partitionable)
    return 1 + torch.remainder(draw, cc.n_speed_classes)


def effective_stride(cc: CadenceConfig, device_ids, level=None, *,
                     partitionable: bool = True):
    """Per-device stride after battery-aware pacing.  ``level`` (the battery
    fraction, shaped as ``device_ids``, or None) below
    ``pace_battery_threshold`` multiplies the stride by ``pace_factor``;
    the compare is fp32 on both operands."""
    stride = speed_stride(cc, device_ids, partitionable=partitionable)
    if level is None or cc.pace_factor <= 1 or cc.pace_battery_threshold <= 0:
        return stride
    lv = torch.as_tensor(level, dtype=torch.float32, device=stride.device)
    paced = lv < torch.tensor(cc.pace_battery_threshold, dtype=torch.float32,
                              device=stride.device)
    return torch.where(paced, stride * cc.pace_factor, stride)


def _phase(cc: CadenceConfig, ids: torch.Tensor, stride: torch.Tensor, partitionable: bool):
    draw = _device_draw(cc.seed, _SALT_PHASE, ids, 0, partitionable=partitionable)
    return torch.remainder(draw, stride)


def tick_mask(cc: CadenceConfig, t, device_ids, level=None, *,
              partitionable: bool = True) -> torch.Tensor:
    """Bool: which devices tick at global event step ``t``, the one
    derivation of both engines.  ``t`` an int, or a tensor of steps that
    adds its shape in front of ``device_ids``'; ``level`` optional battery
    fractions shaped as ``device_ids`` (enables pacing).  A ticking
    requester executes its next round; a non-ticking one idles, a
    non-ticking contributor skips its refresh."""
    ids = _ids(device_ids)
    ts = _steps(t, ids)
    stride = effective_stride(cc, ids, level, partitionable=partitionable)
    phase = _phase(cc, ids, stride, partitionable)
    on = torch.remainder(ts + phase, stride) == 0
    if cc.duty_cycle > 0:
        duty_phase = torch.remainder(
            _device_draw(cc.seed, _SALT_DUTY, ids, 0, partitionable=partitionable),
            cc.duty_cycle)
        on = on & (torch.remainder(ts + duty_phase, cc.duty_cycle) < cc.duty_on)
    if cc.p_offline > 0.0:
        off_draw = _device_draw(cc.seed, _SALT_OFFLINE, ids, ts, partitionable=partitionable)
        on = on & (off_draw >= _threshold(cc.p_offline))
    return on


def image_lag(cc: CadenceConfig, t, device_ids, *, partitionable: bool = True):
    """int64 event steps since each device's wire image was last refreshed,
    as an aggregate at step ``t`` sees it: ``(t - 1 + phase) % stride``
    from the unpaced base stride and phase (a stride-1 device always shows
    0).  Duty sleep, offline draws and pacing can delay a refresh past
    this bound; they deepen staleness without deepening the decay, the
    reference's documented approximation that keeps the weights
    state-free."""
    ids = _ids(device_ids)
    ts = _steps(t, ids)
    stride = speed_stride(cc, ids, partitionable=partitionable)
    return torch.remainder(ts - 1 + _phase(cc, ids, stride, partitionable), stride)


def events_budget(cc: CadenceConfig, max_rounds: int) -> int:
    """The global event-step budget a session loops over (host).

    ``max_events`` when set; otherwise enough for the slowest possible
    device (worst speed class, paced, worst duty window) to complete
    ``max_rounds`` rounds, with a 2x allowance for offline streaks.  A lane
    that exhausts the budget stops with fewer rounds (``max_rounds``)."""
    if cc.max_events > 0:
        return int(cc.max_events)
    stride_max = cc.n_speed_classes * max(cc.pace_factor, 1)
    duty_factor = (-(-cc.duty_cycle // cc.duty_on)
                   if cc.duty_cycle > 0 else 1)
    offline_factor = 2 if cc.p_offline > 0.0 else 1
    return int(max_rounds) * stride_max * duty_factor * offline_factor
