"""The paper's baselines in the port against the JAX package on the CPU:
the loop learners (``CFLLearner``, ``DFLLearner`` mesh and ring,
``cloud_only_config``) against the JAX learners, ``run_fleet(method="cfl"
|"dfl")`` against the JAX fleet (Pallas in interpret mode) and against the
port's own loop learners, on the HAR LSTM and the calories MLP; the
refusals of enfed-only knobs; and ``examples/torch_quickstart.py``.

Model init is the one draw the port does not reproduce (``ROADMAP.md``
"Randomness"), so the port's task here inits from the reference's
``task.init(seed)``, converted.  Each JAX configuration runs once per
module (results cached by case).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.models import (LSTMClassifier as JLSTM, LSTMClassifierConfig as JLSTMConfig,  # noqa: E402
                          MLPClassifier as JMLP, MLPClassifierConfig as JMLPConfig)
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.data import (CaloriesDatasetConfig, HARDatasetConfig,  # noqa: E402
                              dirichlet_partition, make_calories_tabular,
                              make_har_windows)
from repro_torch.kernels.fedavg.ops import fedavg_flat_batched  # noqa: E402
from repro_torch.models import (LSTMClassifier, LSTMClassifierConfig,  # noqa: E402
                                MLPClassifier, MLPClassifierConfig)
from repro_torch.kernels.quantize.ops import compressed_nbytes  # noqa: E402
from repro_torch.utils.tree import to_numpy, tree_leaves, tree_size  # noqa: E402

from _torch_ref import RefInitTask as _RefInitTask, threefry as _threefry  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# the reference's limits between its own two engines
# (tests/test_fleet_engine.py, baseline parity)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
ACC_TOL = dict(rtol=1e-5, atol=1e-6)
REPORT_FIELDS = ("t_dev", "t_hand", "t_key", "t_init", "t_com", "t_enc", "t_dec", "t_agg",
                 "t_loc")

_WORLDS = {}
_RUNS = {}


def _world(kind):
    """The JAX task, the requester's splits, three neighbours with data and
    the pooled set, built once per model."""
    if kind not in _WORLDS:
        if kind == "lstm":
            x, y, _ = make_har_windows(HARDatasetConfig(num_samples=240, seq_len=8))
            jtask = jcore.SupervisedTask(JLSTM(JLSTMConfig(input_dim=6, seq_len=8, hidden=16,
                                                           num_classes=6)), lr=3e-3)
        else:
            x, y = make_calories_tabular(CaloriesDatasetConfig(num_samples=360))
            jtask = jcore.SupervisedTask(JMLP(JMLPConfig(input_dim=8, hidden=(16, 8),
                                                         num_classes=5)), lr=3e-3)
        parts = dirichlet_partition(y, num_clients=4, alpha=1.0, seed=0)
        shards = [(x[p], y[p]) for p in parts]
        n = int(len(shards[0][0]) * 0.8)
        own_train = (shards[0][0][:n], shards[0][1][:n])
        own_test = (shards[0][0][n:], shards[0][1][n:])
        half = (own_train[0][:n // 2], own_train[1][:n // 2])
        _WORLDS[kind] = (jtask, shards, own_train, own_test, half, (x, y))
    return _WORLDS[kind]


def _port_task(kind, partitionable=True):
    jtask = _world(kind)[0]
    if kind == "lstm":
        model = LSTMClassifier(LSTMClassifierConfig(input_dim=6, seq_len=8, hidden=16),
                               device=CPU)
    else:
        model = MLPClassifier(MLPClassifierConfig(input_dim=8, hidden=(16, 8)), device=CPU)
    return _RefInitTask(model, jtask, partitionable)


def _fleet(mod):
    fleet = mod.make_fleet(3, seed=1, p_has_model=1.0)
    for d in fleet:
        d.reservation_price = 0.4
    return fleet


def _states(mod, kind):
    """Neighbour states: the baselines read only their data."""
    shards = _world(kind)[1]
    return {d.device_id: {"params": None, "data": shards[1 + i]}
            for i, d in enumerate(_fleet(mod))}


def _client_data(kind, own):
    shards = _world(kind)[1]
    return [own] + [shards[1 + i] for i in range(3)]


def _assert_trees_close(jtree, ttree, **tol):
    jl = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jtree))[0]
    tl = jax.tree_util.tree_flatten(to_numpy(ttree))[0]
    assert len(jl) == len(tl)
    for (path, j), t in zip(jl, tl):
        np.testing.assert_allclose(t, j, err_msg=jax.tree_util.keystr(path), **tol)


def _fields(report):
    return tuple(getattr(report.times, f) for f in REPORT_FIELDS) + (report.e_comp,
                                                                   report.e_comm)


# ---------------------------------------------------------------------------
# the loop learners against the JAX learners
# ---------------------------------------------------------------------------

LOOP_CASES = [(kind, method, part) for kind in ("lstm", "mlp")
              for method in ("cfl", "dfl-mesh", "dfl-ring", "cloud") for part in (True,)]
LOOP_CASES.append(("mlp", "cfl", False))


def _cfg(mod, **over):
    kw = dict(desired_accuracy=1.01, max_rounds=2, epochs=2, batch_size=16, seed=5)
    kw.update(over)
    return mod.EnFedConfig(**kw)


def _run_loop(mod, task, kind, method, cfg):
    _, _, own_train, own_test, _, pooled = _world(kind)
    data = _client_data(kind, own_train)
    if method == "cfl":
        return mod.CFLLearner(task, data, own_test).run_config(cfg)
    if method == "cloud":
        return mod.cloud_only_config(task, pooled, own_test, cfg)
    return mod.DFLLearner(task, data, own_test, method.split("-")[1]).run_config(cfg)


@pytest.mark.parametrize("kind,method,partitionable", LOOP_CASES)
def test_loop_learner_matches_jax_learner(kind, method, partitionable):
    jtask = _world(kind)[0]
    with _threefry(partitionable):
        want = _run_loop(jcore, jtask, kind, method, _cfg(jcore))
    got = _run_loop(tcore, _port_task(kind, partitionable), kind, method, _cfg(tcore))
    assert isinstance(got, tcore.BaselineResult)
    assert got.rounds == want.rounds
    assert set(got.history_raw) == set(want.history_raw)
    np.testing.assert_allclose(got.history_raw["accuracy"], want.history_raw["accuracy"],
                               **ACC_TOL)
    np.testing.assert_allclose(got.accuracy, want.accuracy, **ACC_TOL)
    _assert_trees_close(want.params, got.params, **PARAM_TOL)
    # the report, given the port's measured time, to the float
    t_loc = got.report.times.t_loc
    jcost = jcore.CostModel()
    n_params = sum(int(np.size(v)) for v in jax.tree_util.tree_leaves(want.params))
    if method == "cloud":
        x = _world(kind)[5][0]
        ref = jcost.cloud_session(data_bytes=int(np.asarray(x).nbytes), cloud_train_s=t_loc)
    else:
        common = dict(rounds=want.rounds, num_params=n_params, model_bytes=4 * n_params,
                      num_samples=len(_world(kind)[2][0]), epochs=2, measured_local_time=t_loc)
        ref = (jcost.cfl_session(**common) if method == "cfl" else
               jcost.dfl_session(**common, n_peers=3, topology=method.split("-")[1]))
    assert _fields(got.report) == _fields(ref)
    assert t_loc > 0.0


def test_cfl_prices_the_compressed_wire_and_trains_fp32():
    """``compress`` changes the priced bytes only: the params stay the fp32
    run's, bit for bit."""
    task = _port_task("mlp")
    cfg = _cfg(tcore, max_rounds=1)
    plain = _run_loop(tcore, task, "mlp", "cfl", cfg)
    int8 = _run_loop(tcore, task, "mlp", "cfl", dataclasses.replace(cfg, compress="int8"))
    for a, b in zip(tree_leaves(plain.params), tree_leaves(int8.params)):
        assert torch.equal(a, b)
    n_params = tree_size(plain.params)
    want = tcore.CostModel().cfl_session(
        rounds=1, num_params=n_params, model_bytes=compressed_nbytes(n_params),
        num_samples=len(_world("mlp")[2][0]), epochs=2,
        measured_local_time=int8.report.times.t_loc)
    assert _fields(int8.report) == _fields(want)
    assert int8.report.times.t_com != plain.report.times.t_com


@pytest.mark.parametrize("learner", ["cfl", "dfl"])
def test_deprecated_run_shims_warn_and_equal_run_config(learner):
    task = _port_task("mlp")
    _, _, own_train, own_test, _, _ = _world("mlp")
    data = _client_data("mlp", own_train)
    make = ((lambda: tcore.CFLLearner(task, data, own_test)) if learner == "cfl" else
            (lambda: tcore.DFLLearner(task, data, own_test, "ring")))
    with pytest.warns(DeprecationWarning, match="run_config"):
        old = make().run(target_accuracy=1.01, max_rounds=1, epochs=1, batch_size=16, seed=3)
    new = make().run_config(_cfg(tcore, max_rounds=1, epochs=1, seed=3))
    assert old.rounds == new.rounds and old.history == new.history
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(old.params)),
                    jax.tree_util.tree_leaves(to_numpy(new.params))):
        np.testing.assert_array_equal(a, b)
    acc, t_resp, params = tcore.cloud_only_baseline(task, own_train, own_test, epochs=1,
                                                    batch_size=16, seed=3)
    cfg_res = tcore.cloud_only_config(task, own_train, own_test,
                                      _cfg(tcore, max_rounds=1, epochs=1, seed=3))
    assert acc == cfg_res.accuracy and t_resp > 2 * tcore.CostModel().link.cloud_rtt_s


def test_dfl_learner_rejects_an_unknown_topology():
    _, _, own_train, own_test, _, _ = _world("mlp")
    with pytest.raises(ValueError, match="unknown dfl topology"):
        tcore.DFLLearner(_port_task("mlp"), [own_train], own_test, "torus")


# ---------------------------------------------------------------------------
# the fleet's baseline lanes against the JAX fleet and the port's learners
# ---------------------------------------------------------------------------

FLEET_CASES = {
    # name: (kind, method, topology, cfg overrides)
    "lstm-cfl": ("lstm", "cfl", "mesh", {}),
    "lstm-dfl-mesh": ("lstm", "dfl", "mesh", {}),
    "lstm-dfl-ring": ("lstm", "dfl", "ring", {}),
    "mlp-cfl": ("mlp", "cfl", "mesh", {}),
    "mlp-dfl-mesh": ("mlp", "dfl", "mesh", {}),
    "mlp-dfl-ring": ("mlp", "dfl", "ring", {}),
    # every lane reaches the target in round 1: the early exit
    "mlp-cfl-early": ("mlp", "cfl", "mesh", dict(desired_accuracy=0.0, max_rounds=3)),
}


def _specs(mod, kind):
    """Two requesters with distinct own shards (the full split and its
    first half) and the same three neighbours."""
    _, _, own_train, own_test, half, _ = _world(kind)
    return [mod.RequesterSpec(own, own_test, _fleet(mod), _states(mod, kind))
            for own in (own_train, half)]


def _run_fleet_case(name):
    if name not in _RUNS:
        kind, method, topo, over = FLEET_CASES[name]
        jtask = _world(kind)[0]
        cfg = dict(desired_accuracy=1.01, max_rounds=2, epochs=1, batch_size=16, seed=5)
        cfg.update(over)
        with _threefry(True):
            jres = jcore.run_fleet(jtask, _specs(jcore, kind), jcore.EnFedConfig(**cfg),
                                   method=method, dfl_topology=topo)
        tres = tcore.run_fleet(_port_task(kind), _specs(tcore, kind), tcore.EnFedConfig(**cfg),
                               method=method, dfl_topology=topo, device="cpu")
        _RUNS[name] = (jres, tres, tcore.EnFedConfig(**cfg))
    return _RUNS[name]


@pytest.mark.parametrize("name", list(FLEET_CASES))
def test_fleet_baseline_matches_jax_fleet(name):
    jres, tres, _ = _run_fleet_case(name)
    assert np.array_equal(tres.rounds, np.asarray(jres.rounds))
    assert np.array_equal(tres.stop_codes, np.asarray(jres.stop_codes))
    for key in ("round_executed", "executed", "battery"):
        assert np.array_equal(tres.history[key], np.asarray(jres.history[key])), key
    np.testing.assert_allclose(tres.history["accuracy"], np.asarray(jres.history["accuracy"]),
                               **ACC_TOL)
    np.testing.assert_allclose(tres.history["loss"], np.asarray(jres.history["loss"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tres.accuracy, np.asarray(jres.accuracy), **ACC_TOL)
    assert np.array_equal(tres.battery_level, np.asarray(jres.battery_level))
    assert tres.staged_param_bytes == jres.staged_param_bytes
    assert tres.device_round_state_bytes == jres.device_round_state_bytes
    assert tres.total_energy_j == jres.total_energy_j
    for js, ts in zip(jres.sessions, tres.sessions):
        assert (ts.rounds, ts.stop_reason, ts.n_contributors, ts.model_bytes) == \
            (js.rounds, js.stop_reason, js.n_contributors, js.model_bytes)
        assert ts.battery is None and js.battery is None
        assert set(ts.history_raw) == set(js.history_raw)
        np.testing.assert_allclose(ts.history_raw["accuracy"], js.history_raw["accuracy"],
                                   **ACC_TOL)
        assert _fields(ts.report) == _fields(js.report)
        _assert_trees_close(js.params, ts.params, **PARAM_TOL)


def test_fleet_early_exit_runs_one_round():
    _, tres, _ = _run_fleet_case("mlp-cfl-early")
    assert tres.history["round_executed"].tolist() == [1.0, 0.0, 0.0]
    assert [s.stop_reason for s in tres.sessions] == ["accuracy_reached"] * 2


@pytest.mark.parametrize("name", ["lstm-cfl", "lstm-dfl-mesh", "mlp-dfl-ring",
                                  "mlp-cfl-early"])
def test_fleet_baseline_lanes_match_the_ports_loop_learners(name):
    """Each of the two lanes against the port's loop learner run on that
    lane's own roster."""
    kind, method, topo, _ = FLEET_CASES[name]
    _, tres, cfg = _run_fleet_case(name)
    _, _, own_train, own_test, half, _ = _world(kind)
    task = _port_task(kind)
    for lane, own in enumerate((own_train, half)):
        data = _client_data(kind, own)
        loop = (tcore.CFLLearner(task, data, own_test) if method == "cfl" else
                tcore.DFLLearner(task, data, own_test, topo)).run_config(cfg)
        fl = tres.sessions[lane]
        assert fl.rounds == loop.rounds
        np.testing.assert_allclose(fl.history_raw["accuracy"], loop.history_raw["accuracy"],
                                   **ACC_TOL)
        for a, b in zip(tree_leaves(fl.params), tree_leaves(loop.params)):
            torch.testing.assert_close(a, b, **PARAM_TOL)


def test_fleet_dfl_mixing_in_n_launches_is_the_gossip_product():
    """N eq. 14 calls on the rows of each requester's mixing matrix (a
    3-client roster padded to 5 lanes mixes its padding with itself) equal
    ``apply_mixing``'s plain product."""
    g = torch.Generator().manual_seed(0)
    fitted = torch.randn((2, 5, 301), generator=g)
    for kind in ("dfl_mesh", "dfl_ring"):
        strat = topology.AggregationStrategy(kind=kind)
        mix_w = np.zeros((2, 5, 5), np.float32)
        for i, n_i in enumerate((5, 3)):
            mix_w[i, :n_i, :n_i] = topology.group_mixing_matrix(n_i, strat)
            for k in range(n_i, 5):
                mix_w[i, k, k] = 1.0
        got = torch.stack([fedavg_flat_batched(fitted, torch.from_numpy(
            np.ascontiguousarray(mix_w[:, k]))) for k in range(5)], dim=1)
        for i in range(2):
            want = topology.apply_mixing({"p": fitted[i]}, torch.from_numpy(mix_w[i]))["p"]
            torch.testing.assert_close(got[i], want, rtol=1e-6, atol=1e-6)
        assert torch.equal(got[1, 3:], fitted[1, 3:])


REFUSALS = [
    (dict(method="fedprox"), {}, "unknown fleet method"),
    (dict(method="dfl", dfl_topology="torus"), {}, "unknown dfl topology"),
    (dict(method="cfl"), dict(adversary="adv"), "enfed-only"),
    (dict(method="dfl"), dict(adversary="adv", robust="median"), "enfed-only"),
    (dict(method="dfl"), dict(robust="clip"), "enfed-only"),
    (dict(method="cfl"), dict(staleness_gamma=0.5), "enfed-only"),
    (dict(method="dfl", dfl_topology="ring"), dict(cadence="cadence"), "cadence is enfed-only"),
    (dict(method="cfl", checkpoint_dir="ckpt"), {}, "checkpointing is enfed-only"),
    (dict(method="dfl", resume_from="ckpt"), {}, "checkpointing is enfed-only"),
]


def _knob(mod, value):
    if value == "adv":
        return mod.AdversaryConfig(p_byzantine=0.5)
    if value == "cadence":
        return mod.CadenceConfig()
    return value


@pytest.mark.parametrize("kwargs,knobs,match", REFUSALS)
def test_fleet_baseline_refusals_match_the_reference(kwargs, knobs, match):
    """A baseline method refuses what only enfed runs, with the reference's
    ``ValueError``, before any staging."""
    for mod, task, extra in ((jcore, _world("mlp")[0], {}),
                             (tcore, _port_task("mlp"), dict(device="cpu"))):
        cfg = _cfg(mod, max_rounds=1, **{k: _knob(mod, v) for k, v in knobs.items()})
        with pytest.raises(ValueError, match=match):
            mod.run_fleet(task, _specs(mod, "mlp"), cfg, **kwargs, **extra)


def test_fleet_baseline_runs_on_the_gpu_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.run_fleet(_port_task("mlp"), _specs(tcore, "mlp"), _cfg(tcore), method="cfl")


# ---------------------------------------------------------------------------
# the quickstart twin
# ---------------------------------------------------------------------------


def _quickstart(*args):
    # one thread: the process runs beside the test workers' own
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
                           *args], capture_output=True, text=True, env=env, timeout=900,
                          cwd=ROOT)


def test_torch_quickstart_runs_on_the_cpu_when_asked():
    out = _quickstart("--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "device          : cpu" in out.stdout
    assert "accuracy_reached" in out.stdout


def test_torch_quickstart_wants_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    out = _quickstart()
    assert out.returncode != 0 and "no CUDA device" in out.stderr
