"""The port's checkpointer (``repro_torch.checkpoint``): the twins of the
reference's eight tests of ``tests/test_checkpoint.py`` (bit-exact round
trips across mixed dtypes, newest-step selection, fail-fast on structural
drift, atomic writes), the port's own trees (tensors and NamedTuples, the
fleet's carry), and the file layout against ``repro.checkpoint``: a tree
the reference saves restores in the port, key for key."""

import os
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint


def _state(seed=0, scale=1.0):
    """A nested tree shaped like real round state: int8 wire payload, fp32
    scales and params, float64 battery, int64 clock, bool masks."""
    rng = np.random.default_rng(seed)
    return {
        "wire": {"q": rng.integers(-128, 127, (3, 16), dtype=np.int8),
                 "s": (scale * rng.standard_normal((3, 2))).astype(np.float32)},
        "params": [rng.standard_normal((4, 5)).astype(np.float32),
                   rng.standard_normal((5,)).astype(np.float32)],
        "battery": np.float64(0.7313 * scale),
        "round": np.int64(3),
        "mask": np.array([True, False, True]),
    }


def test_roundtrip_bit_exact(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 7, state)
    out, step = restore_checkpoint(str(tmp_path), _state(seed=1))
    assert step == 7
    np.testing.assert_array_equal(out["wire"]["q"], state["wire"]["q"])
    np.testing.assert_array_equal(out["wire"]["s"], state["wire"]["s"])
    for a, b in zip(out["params"], state["params"]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert out["battery"] == state["battery"]
    assert out["round"] == state["round"]
    np.testing.assert_array_equal(out["mask"], state["mask"])


def test_latest_step_ordering(tmp_path):
    for step, scale in [(2, 0.5), (10, 2.0), (6, 1.5)]:
        save_checkpoint(str(tmp_path), step, _state(scale=scale))
    assert latest_step(str(tmp_path)) == 10
    out, step = restore_checkpoint(str(tmp_path), _state())
    assert step == 10
    # the newest payload, not just the newest step number
    np.testing.assert_array_equal(out["wire"]["s"], _state(scale=2.0)["wire"]["s"])
    out6, step6 = restore_checkpoint(str(tmp_path), _state(), step=6)
    assert step6 == 6
    np.testing.assert_array_equal(out6["wire"]["s"], _state(scale=1.5)["wire"]["s"])


def test_missing_dir_and_empty_dir(tmp_path):
    missing = str(tmp_path / "nope")
    assert latest_step(missing) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(missing, _state())
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(empty), _state())


def test_missing_key_raises(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 1, state)
    template = dict(state)
    template["extra"] = np.zeros(3, np.float32)   # not in the checkpoint
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), template)


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _state())
    template = _state()
    template["params"][0] = np.zeros((4, 6), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), template)


def test_dtype_mismatch_raises_not_downcasts(tmp_path):
    """An fp32 checkpoint never restores into an int8 template (or back):
    wire-format state restores as its resident dtype or not at all."""
    save_checkpoint(str(tmp_path), 1, _state())
    template = _state()
    template["wire"]["q"] = template["wire"]["q"].astype(np.float32)
    with pytest.raises(ValueError, match="dtype mismatch"):
        restore_checkpoint(str(tmp_path), template)
    template = _state()
    template["params"][0] = template["params"][0].astype(np.float16)
    with pytest.raises(ValueError, match="dtype mismatch"):
        restore_checkpoint(str(tmp_path), template)


def test_tmp_files_swept_and_never_listed(tmp_path):
    """A crash between the write and ``os.replace`` leaves
    step_N.npz.tmp.npz behind; latest_step neither counts it nor keeps it."""
    save_checkpoint(str(tmp_path), 3, _state())
    orphan = tmp_path / "step_00000099.npz.tmp.npz"
    orphan.write_bytes(b"torn write")
    assert latest_step(str(tmp_path)) == 3
    assert not orphan.exists()


def test_save_is_atomic_replace(tmp_path):
    """Saving a step again replaces the file whole and leaves no tmp file."""
    p1 = save_checkpoint(str(tmp_path), 5, _state(scale=1.0))
    p2 = save_checkpoint(str(tmp_path), 5, _state(scale=3.0))
    assert p1 == p2
    assert sorted(os.listdir(tmp_path)) == ["step_00000005.npz"]
    out, _ = restore_checkpoint(str(tmp_path), _state())
    np.testing.assert_array_equal(out["wire"]["s"], _state(scale=3.0)["wire"]["s"])


class _Carry(NamedTuple):
    contrib: torch.Tensor
    cscale: Optional[torch.Tensor]
    level: torch.Tensor


def test_tensors_and_named_tuples_round_trip_as_host_numpy(tmp_path):
    """The port's trees: tensors are saved as host numpy, a NamedTuple's
    fields under ``.name`` (the reference's key paths), None is an empty
    subtree, and an int8 tensor never restores into an fp32 template."""
    g = torch.Generator().manual_seed(0)
    carry = _Carry(torch.randint(-127, 128, (2, 3, 8), generator=g, dtype=torch.int8),
                   None, torch.rand(2, generator=g))
    save_checkpoint(str(tmp_path), 4, {"r0": np.int64(4), "state": carry})
    with np.load(tmp_path / "step_00000004.npz") as data:
        assert sorted(data.files) == ["r0", "state/.contrib", "state/.level"]
    out, _ = restore_checkpoint(str(tmp_path), {"r0": np.int64(0), "state": carry})
    assert isinstance(out["state"], _Carry) and out["state"].cscale is None
    assert isinstance(out["state"].contrib, np.ndarray)
    assert torch.equal(torch.from_numpy(out["state"].contrib), carry.contrib)
    assert torch.equal(torch.from_numpy(out["state"].level), carry.level)
    bad = carry._replace(contrib=carry.contrib.to(torch.float32))
    with pytest.raises(ValueError, match="dtype mismatch"):
        restore_checkpoint(str(tmp_path), {"r0": np.int64(0), "state": bad})


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    """The layout is the reference's: what ``repro.checkpoint`` writes, the
    port reads into the same tree, and the other way round."""
    jck = pytest.importorskip("repro.checkpoint")
    jck.save_checkpoint(str(tmp_path / "ref"), 2, _state(seed=4))
    out, _ = restore_checkpoint(str(tmp_path / "ref"), _state())
    np.testing.assert_array_equal(out["params"][1], _state(seed=4)["params"][1])
    save_checkpoint(str(tmp_path / "port"), 2, _state(seed=5))
    back, _ = jck.restore_checkpoint(str(tmp_path / "port"), _state())
    np.testing.assert_array_equal(np.asarray(back["wire"]["q"]), _state(seed=5)["wire"]["q"])
    # the cadence world's event clock, as the loop payload holds it (int64
    # step and idle run, float64 clock and idle traces) and as the fleet's
    # carry does (int32 lane clocks), reads both ways too
    for seed, (save, restore) in enumerate(((jck.save_checkpoint, restore_checkpoint),
                                            (save_checkpoint, jck.restore_checkpoint)), start=6):
        state = dict(_state(seed), **_cadence_fields(seed))
        save(str(tmp_path / f"cad{seed}"), 4, state)
        out, step = restore(str(tmp_path / f"cad{seed}"), dict(_state(), **_cadence_fields(0)))
        assert step == 4
        for key in ("t", "idle_run", "clock_h", "idle_h", "clock", "idle"):
            np.testing.assert_array_equal(np.asarray(out[key]), state[key])
            assert np.asarray(out[key]).dtype == state[key].dtype


def _cadence_fields(seed):
    rng = np.random.default_rng(seed)
    return {"t": np.int64(rng.integers(0, 80)), "idle_run": np.int64(rng.integers(0, 5)),
            "clock_h": rng.integers(0, 80, 10).astype(np.float64),
            "idle_h": rng.integers(0, 5, 10).astype(np.float64),
            "clock": rng.integers(0, 10, 4).astype(np.int32),
            "idle": rng.integers(0, 5, 4).astype(np.int32)}
