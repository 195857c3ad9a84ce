"""The port's asynchronous-cadence world functions against the JAX
package's (``repro.core.cadence``) on the CPU: ``CadenceConfig``'s
validation, every gate of a device's tick (stride, phase, duty window,
offline draw, battery pacing) and ``image_lag`` bit for bit under both
threefry modes over steps 0-40 and ids past 2**20, a batch of steps
against step-by-step draws, ``events_budget``, and
``CostModel.idle_energy`` to the float."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import cadence as jcad  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro_torch.core import cadence as tcad  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402

from _torch_ref import threefry  # noqa: E402

# every gate at once: three speed classes, a 4-step duty window, offline
# draws and pacing
WORLD = dict(n_speed_classes=3, duty_cycle=4, duty_on=2, p_offline=0.2,
             pace_battery_threshold=0.5, pace_factor=2, seed=11)
# contributor ids, requester lanes and ids past 2**20, as the engines hold them
IDS = np.array([0, 1, 2, 3, 4, 5, 1000, (1 << 20) + 3, (1 << 22), (1 << 22) + 63,
                2**31 - 1], np.int32)
STEPS = range(41)


def _both(**kw):
    return jcad.CadenceConfig(**kw), tcad.CadenceConfig(**kw)


def _per_step(fn):
    """The reference's ``fn(t)`` at every step of STEPS, stacked, in one
    batched evaluation (the reference holds its batched and per-step
    evaluations bitwise equal: ``tests/test_cadence.py``)."""
    return np.asarray(jax.vmap(fn)(jnp.arange(len(STEPS), dtype=jnp.int32)))


@pytest.mark.parametrize("kw", [
    dict(n_speed_classes=0), dict(duty_cycle=-1), dict(duty_cycle=4, duty_on=0),
    dict(duty_cycle=4, duty_on=5), dict(p_offline=1.0), dict(p_offline=-0.1),
    dict(pace_factor=0), dict(pace_battery_threshold=1.5), dict(pace_battery_threshold=-0.1),
    dict(idle_step_s=-0.1), dict(max_events=-1)])
def test_cadence_config_validation(kw):
    for cls in (jcad.CadenceConfig, tcad.CadenceConfig):
        with pytest.raises(ValueError):
            cls(**kw)


def test_cadence_config_defaults():
    jcc, tcc = _both()
    assert dataclasses.asdict(jcc) == dataclasses.asdict(tcc)
    hash(tcc)                                     # frozen, as the reference's


@pytest.mark.parametrize("p", [0.0, 0.15, 0.2, 1.0 / 3, 0.999999999])
def test_threshold_is_the_float64_product(p):
    assert tcad._threshold(p) == int(jcad._threshold(p))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("kw", [WORLD, dict(n_speed_classes=2, seed=0),
                                dict(n_speed_classes=2, duty_cycle=3, duty_on=2,
                                     p_offline=0.15, seed=3)])
def test_strides_ticks_and_lags_bit_exact(partitionable, kw):
    jcc, tcc = _both(**kw)
    ids = torch.from_numpy(IDS.astype(np.int64))
    with threefry(partitionable):
        want_stride = np.asarray(jcad.speed_stride(jcc, IDS))
        want_tick = _per_step(lambda t: jcad.tick_mask(jcc, t, IDS))
        want_lag = _per_step(lambda t: jcad.image_lag(jcc, t, IDS))
    assert np.array_equal(want_stride, tcad.speed_stride(tcc, ids,
                                                         partitionable=partitionable).numpy())
    for t in STEPS:
        got = tcad.tick_mask(tcc, t, ids, partitionable=partitionable)
        assert np.array_equal(want_tick[t], got.numpy()), t
        lag = tcad.image_lag(tcc, t, ids, partitionable=partitionable)
        assert np.array_equal(want_lag[t], lag.numpy()), t
    # a tensor of steps adds its shape in front, each row the step's own draw
    steps = torch.arange(len(STEPS))
    assert np.array_equal(want_tick, tcad.tick_mask(tcc, steps, ids,
                                                    partitionable=partitionable).numpy())
    assert np.array_equal(want_lag, tcad.image_lag(tcc, steps, ids,
                                                   partitionable=partitionable).numpy())
    # t = 0 lags by (-1 + phase) % stride: Python's sign rule
    assert (want_lag >= 0).all()
    assert want_tick.any() and (~want_tick).any()


@pytest.mark.parametrize("partitionable", [True, False])
def test_pacing_compares_fp32_levels(partitionable):
    """A level below the threshold multiplies the stride; the compare is
    fp32 on both sides, levels one ulp either side of it included."""
    jcc, tcc = _both(**WORLD)
    thr = np.float32(WORLD["pace_battery_threshold"])
    levels = np.array([0.1, np.nextafter(thr, np.float32(0)), thr,
                       np.nextafter(thr, np.float32(1)), 0.9] * 3,
                      np.float32)[:len(IDS)]
    ids = torch.from_numpy(IDS.astype(np.int64))
    with threefry(partitionable):
        want_stride = np.asarray(jcad.effective_stride(jcc, IDS, level=levels))
        want = _per_step(lambda t: jcad.tick_mask(jcc, t, IDS, level=levels))
    got_stride = tcad.effective_stride(tcc, ids, torch.from_numpy(levels),
                                       partitionable=partitionable)
    assert np.array_equal(want_stride, got_stride.numpy())
    assert (got_stride.numpy() != tcad.speed_stride(tcc, ids,
                                                    partitionable=partitionable).numpy()).any()
    for t in STEPS:
        got = tcad.tick_mask(tcc, t, ids, level=torch.from_numpy(levels),
                             partitionable=partitionable)
        assert np.array_equal(want[t], got.numpy()), t


@pytest.mark.parametrize("partitionable", [True, False])
def test_one_device_alone_is_its_column(partitionable):
    """A scalar id (the loop engine's requester) draws what its column of a
    batch draws, and the (R, N) ids of the fleet what their rows do."""
    _, tcc = _both(**WORLD)
    ids = torch.from_numpy(IDS.astype(np.int64))
    grid = ids[None].expand(3, -1)
    for t in (0, 7, 40):
        row = tcad.tick_mask(tcc, t, ids, partitionable=partitionable)
        for j, d in enumerate(IDS):
            assert bool(tcad.tick_mask(tcc, t, int(d), partitionable=partitionable)) == bool(row[j])
        assert np.array_equal(tcad.tick_mask(tcc, t, grid, partitionable=partitionable).numpy(),
                              np.stack([row.numpy()] * 3))


def test_stride_one_always_ticks():
    cc = tcad.CadenceConfig()
    ids = torch.arange(100)
    for t in range(5):
        assert tcad.tick_mask(cc, t, ids).all()
        assert not tcad.image_lag(cc, t, ids).any()


@pytest.mark.parametrize("kw,rounds", [
    ({}, 7), (dict(n_speed_classes=2, seed=3), 4),
    (dict(n_speed_classes=2, duty_cycle=4, duty_on=2, p_offline=0.1), 3),
    (dict(n_speed_classes=2, duty_cycle=3, duty_on=2, p_offline=0.15, pace_factor=2,
          pace_battery_threshold=0.5), 10),
    (dict(max_events=11, n_speed_classes=5), 3)])
def test_events_budget(kw, rounds):
    jcc, tcc = _both(**kw)
    assert tcad.events_budget(tcc, rounds) == jcad.events_budget(jcc, rounds)


@pytest.mark.parametrize("steps,step_s", [(0, 0.05), (1, 0.05), (37, 0.05), (5, 0.0),
                                          (123, 0.013)])
def test_idle_energy_equals_the_reference_to_the_float(steps, step_s):
    assert tenergy.CostModel().idle_energy(idle_steps=steps, idle_step_s=step_s) == \
        jenergy.CostModel().idle_energy(idle_steps=steps, idle_step_s=step_s)


def test_tick_mask_runs_on_int32_steps():
    """The fleet hands steps over as tensors of any integer dtype."""
    _, tcc = _both(**WORLD)
    ids = torch.from_numpy(IDS.astype(np.int64))
    with threefry(True):
        want = np.asarray(jcad.tick_mask(jcad.CadenceConfig(**WORLD), jnp.int32(9), IDS))
    got = tcad.tick_mask(tcc, torch.tensor(9, dtype=torch.int32), ids)
    assert np.array_equal(want, got.numpy())
