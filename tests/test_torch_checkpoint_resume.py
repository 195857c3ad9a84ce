"""Crash-resumable round state in both engines of the port: a run killed
at round k and resumed equals the uninterrupted run bit for bit (params,
battery, accuracy, the deliver, member, corrupted and clipped masks), on
the CPU, in the worlds of the reference's ``tests/test_checkpoint_resume.py``
and of its two adversary resume tests (``tests/test_adversary.py``), on
the reference's small problem (``tests/test_fleet_engine.py::_build``).
A run is killed by deleting every checkpoint past round k."""

import glob
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.api import ExecutionSpec, Experiment, MethodSpec, WorldSpec  # noqa: E402
from repro_torch.core.battery import BatteryState  # noqa: E402
from repro_torch.telemetry import compare_event_streams  # noqa: E402
from repro_torch.utils.tree import flatten_to_vector  # noqa: E402

from test_fleet_engine import BATCH  # noqa: E402
from test_torch_mobility_engines import _port_world  # noqa: E402

CPU = torch.device("cpu")
FC = tcore.FaultConfig(p_drop=0.6, p_stale=0.4, max_retries=1, release_after=2, seed=3)
MOB = tcore.MobilityConfig(arena_m=120.0, radio_range_m=60.0, leg_rounds=2, seed=5)
AC = tcore.AdversaryConfig(p_byzantine=0.5, attack="signflip", seed=7)


def _cfg(**kw):
    base = dict(desired_accuracy=0.99, max_rounds=6, epochs=1, batch_size=BATCH,
                encrypt=False, contributor_refresh_epochs=1)
    base.update(kw)
    return tcore.EnFedConfig(**base)


def _kill_after(ckpt_dir, keep_step):
    removed = 0
    for f in glob.glob(os.path.join(ckpt_dir, "step_*.npz")):
        if int(os.path.basename(f)[5:13]) > keep_step:
            os.remove(f)
            removed += 1
    assert removed > 0, "nothing to kill: checkpointing did not run"


def _assert_identical(full, res, *mask_keys):
    assert torch.equal(flatten_to_vector(full.params)[0], flatten_to_vector(res.params)[0]), \
        "resumed params differ from the uninterrupted run"
    assert (res.rounds, res.stop_reason) == (full.rounds, full.stop_reason)
    for key in ("battery", "accuracy", "loss"):
        assert res.history_raw[key] == full.history_raw[key], key
    for key in mask_keys:
        assert np.array_equal(np.stack(full.history_raw[key]), np.stack(res.history_raw[key])), key


def _loop(cfg, **run_kw):
    ttask, own_train, own_test, tfleet, states_fn = _port_world(True)
    return tcore.EnFedSession(ttask, own_train, own_test, tfleet, states_fn(), cfg,
                              battery=BatteryState(), device=CPU).run(**run_kw)


def _fleet(cfg, **kw):
    ttask, own_train, own_test, tfleet, states_fn = _port_world(True)
    spec = tcore.RequesterSpec(own_train, own_test, tfleet, states_fn(), BatteryState())
    return tcore.run_fleet(ttask, [spec], cfg, round_chunk=2, device=CPU, **kw)


@pytest.mark.parametrize("cfg_kw,keys", [
    (dict(), ()),
    (dict(faults=FC, compress="int8"), ("deliver_mask",)),
    (dict(faults=FC, mobility=MOB), ("deliver_mask", "member_mask")),
], ids=["static", "faults-int8", "mobility-faults"])
def test_loop_kill_and_resume_bit_identical(cfg_kw, keys, tmp_path):
    cfg = _cfg(**cfg_kw)
    full = _loop(cfg)
    d = str(tmp_path / "ck")
    _loop(cfg, checkpoint_dir=d)                  # default: every round
    assert len(os.listdir(d)) == full.rounds
    _kill_after(d, 3)
    res = _loop(cfg, resume_from=d)
    _assert_identical(full, res, *keys)
    assert res.report.times.t_com == full.report.times.t_com   # the retry windows carry over


def test_loop_resume_missing_dir_raises():
    with pytest.raises(FileNotFoundError):
        _loop(_cfg(), resume_from="/nonexistent/ckpts")


def test_loop_checkpoint_every_validation():
    with pytest.raises(ValueError):
        _loop(_cfg(), checkpoint_dir="ckpt", checkpoint_every=-1)


@pytest.mark.parametrize("cfg_kw,keys", [
    (dict(faults=FC, compress="int8"), ("deliver_mask",)),
    (dict(mobility=MOB, faults=FC), ("deliver_mask", "member_mask")),
], ids=["faults-int8", "mobility-faults"])
def test_fleet_kill_and_resume_bit_identical(cfg_kw, keys, tmp_path):
    cfg = _cfg(**cfg_kw)
    full = _fleet(cfg, checkpoint_dir=str(tmp_path / "full"), checkpoint_every=2)
    d = str(tmp_path / "kill")
    _fleet(cfg, checkpoint_dir=d, checkpoint_every=2)
    _kill_after(d, 2)
    res = _fleet(cfg, resume_from=d)
    _assert_identical(full.sessions[0], res.sessions[0], *keys)
    assert np.array_equal(full.battery_level, res.battery_level)
    for key, trace in full.history.items():
        assert np.array_equal(trace, res.history[key]), key


def test_fleet_checkpointing_matches_the_straight_run(tmp_path):
    """Checkpointing only adds host reads at chunk boundaries: the same
    round bodies, the same bits; ``checkpoint_every`` rounds up to the
    chunk."""
    cfg = _cfg(faults=FC)
    plain = _fleet(cfg)
    d = str(tmp_path / "ck")
    chunked = _fleet(cfg, checkpoint_dir=d, checkpoint_every=3)
    assert sorted(os.listdir(d)) == ["step_00000004.npz"]
    _assert_identical(plain.sessions[0], chunked.sessions[0], "deliver_mask")
    assert np.array_equal(plain.history["deliver"], chunked.history["deliver"])


def test_fleet_checkpoint_rejected_for_baselines():
    with pytest.raises(ValueError, match="enfed-only"):
        _fleet(_cfg(), method="dfl", checkpoint_dir="ckpt")


def test_experiment_resume_shorthand(tmp_path):
    """``Experiment.run(resume=...)`` gives the uninterrupted run through
    the facade."""
    ttask, own_train, own_test, tfleet, states_fn = _port_world(True)
    world = WorldSpec.single(ttask, own_train, own_test, tfleet, states_fn(), device="cpu")
    method = MethodSpec(desired_accuracy=0.99, max_rounds=6, epochs=1, batch_size=BATCH,
                        encrypt=False, contributor_refresh_epochs=1, faults=FC)
    full = Experiment(world, method).run()
    d = str(tmp_path / "api_ck")
    Experiment(world, method, ExecutionSpec(checkpoint_dir=d)).run()
    _kill_after(d, 3)
    res = Experiment(world, method).run(resume=d)
    _assert_identical(full.sessions[0], res.sessions[0], "deliver_mask")
    assert [s.name for s in res.timeline.spans].count("checkpoint_restore") == 1


def test_execution_spec_validation():
    with pytest.raises(ValueError):
        ExecutionSpec(checkpoint_every=-1)


def _adv_cfg():
    return _cfg(adversary=AC, robust="clip", staleness_gamma=0.8, faults=FC)


def test_loop_kill_and_resume_with_adversary(tmp_path):
    cfg = _adv_cfg()
    full = _loop(cfg)
    d = str(tmp_path / "ck")
    _loop(cfg, checkpoint_dir=d)
    _kill_after(d, 3)
    res = _loop(cfg, resume_from=d)
    _assert_identical(full, res, "corrupted_mask", "clipped_mask", "deliver_mask")


def test_fleet_kill_and_resume_with_adversary(tmp_path):
    cfg = _adv_cfg()
    full = _fleet(cfg, checkpoint_dir=str(tmp_path / "full"), checkpoint_every=2)
    d = str(tmp_path / "kill")
    _fleet(cfg, checkpoint_dir=d, checkpoint_every=2)
    _kill_after(d, 2)
    res = _fleet(cfg, resume_from=d)
    _assert_identical(full.sessions[0], res.sessions[0], "corrupted_mask", "clipped_mask")


def test_two_requester_loop_run_checkpoints_per_requester(tmp_path):
    """A 2-requester loop run keeps requester i's checkpoints under
    ``<dir>/req<i>``, rolls requester i's link dice as ``requester_id + i``
    and resumes each session from its own directory."""
    ttask, own_train, own_test, tfleet, states_fn = _port_world(True)
    world = WorldSpec(task=ttask, requesters=[
        tcore.RequesterSpec(own_train, own_test, tfleet, states_fn()) for _ in range(2)],
        device="cpu")
    method = MethodSpec(desired_accuracy=0.99, max_rounds=4, epochs=1, batch_size=BATCH,
                        encrypt=False, contributor_refresh_epochs=1, faults=FC)
    d = str(tmp_path / "ck")
    full = Experiment(world, method, ExecutionSpec(checkpoint_dir=d)).run()
    assert sorted(os.listdir(d)) == ["req0", "req1"]
    assert all(len(os.listdir(os.path.join(d, f"req{i}"))) == 4 for i in range(2))
    masks = [np.stack(s.history_raw["deliver_mask"]) for s in full.sessions]
    assert not np.array_equal(*masks), "the two requesters roll their own link dice"
    for i in range(2):
        _kill_after(os.path.join(d, f"req{i}"), 2)
    res = Experiment(world, method).run(resume=d)
    for a, b in zip(full.sessions, res.sessions):
        _assert_identical(a, b, "deliver_mask")
    assert compare_event_streams(full.trace, res.trace, atol=0, energy_atol=0) == []
