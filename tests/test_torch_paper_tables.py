"""The paper-table twins on the CPU: ``benchmarks/_torch_harness.py`` and
the four ``benchmarks/torch_*`` table scripts against the reference's
``benchmarks/_harness.py`` and its scripts, in all four (dataset, model)
worlds of the harness.

The scenario arrays must be the same bits.  Model init is the one draw the
port does not reproduce (``ROADMAP.md`` "Randomness"), so the port's
scenario inits from the reference's ``task.init(seed)``, converted.  Every
run is cut to 1 round of 1 epoch (``MAX_ROUNDS`` patched in both harness
modules, ``epochs=1``, ``pretrain_epochs=1``); rounds and stop reasons must
match exactly, accuracies and Fig 7's losses within 1e-5, every report
field that holds no measured wall to the float, and the walled ones after
repricing the reference's ``CostModel`` with the port's measured ``t_loc``.
Each run is made once per module and cached.
"""

import dataclasses
import importlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import repro.core as jcore  # noqa: E402
from benchmarks import _harness as jh  # noqa: E402
from benchmarks import _torch_harness as th  # noqa: E402
from repro_torch.core import federated as tfederated  # noqa: E402
from repro_torch.utils.tree import to_numpy, tree_size  # noqa: E402

from _torch_ref import RefInitTask, threefry  # noqa: E402

PARTITIONABLE = True
SCENARIOS = [("calories", "lstm"), ("calories", "mlp"), ("har", "lstm"), ("har", "mlp")]
# small sets: the holdout keeps its floor of 200 samples
NUM_SAMPLES = {"calories": 300, "har": 240}
CUT = dict(epochs=1)
ENFED_CUT = dict(epochs=1, pretrain_epochs=1)
RUNNERS = ("enfed", "cfl", "dfl-mesh", "dfl-ring", "cloud")
# the reference's limits between its own two engines
ACC_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
WALL_FREE = ("t_dev", "t_hand", "t_key", "t_init", "t_com", "t_enc", "t_dec", "t_agg")
SCRIPTS = ("table4_lstm", "table5_mlp", "table7_cloud", "figs_contributors")

_SCENARIOS = {}
_RUNS = {}
_CLOUD_REPORTS = {}


def _scenarios(dataset, kind):
    """The reference's and the port's scenario, the port's task initing
    from the reference's."""
    key = (dataset, kind)
    if key not in _SCENARIOS:
        with threefry(PARTITIONABLE):
            jsc = jh.build_scenario(dataset, kind, num_samples=NUM_SAMPLES[dataset])
        tsc = th.build_scenario(dataset, kind, num_samples=NUM_SAMPLES[dataset], device="cpu")
        tsc = dataclasses.replace(tsc, task=RefInitTask(tsc.task.model, jsc.task,
                                                        PARTITIONABLE))
        _SCENARIOS[key] = (jsc, tsc)
    return _SCENARIOS[key]


def _call(harness, runner, sc, n_contrib=5):
    if runner == "enfed":
        return harness.run_enfed(sc, n_contrib=n_contrib, **ENFED_CUT)
    if runner == "cfl":
        return harness.run_cfl(sc, **CUT)
    if runner == "cloud":
        return harness.run_cloud(sc, **CUT)
    return harness.run_dfl(sc, runner.split("-")[1], **CUT)


def _run(side, dataset, kind, runner, n_contrib=5):
    """One harness run at the cut depth, made once: ``side`` 0 is the
    reference, 1 the port.  The port's cloud run also keeps its report."""
    key = (side, dataset, kind, runner, n_contrib)
    if key not in _RUNS:
        harness = (jh, th)[side]
        sc = _scenarios(dataset, kind)[side]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(harness, "MAX_ROUNDS", 1)
            if side == 0:
                with threefry(PARTITIONABLE):
                    _RUNS[key] = _call(harness, runner, sc, n_contrib)
            else:
                seen = []
                config = tfederated.cloud_only_config
                mp.setattr(tfederated, "cloud_only_config",
                           lambda *a, **k: seen.append(config(*a, **k)) or seen[-1])
                _RUNS[key] = _call(harness, runner, sc, n_contrib)
                if runner == "cloud":
                    _CLOUD_REPORTS[key] = seen[0].report
    return _RUNS[key]


def _fields(report):
    t = report.times
    return tuple(getattr(t, f) for f in WALL_FREE) + (t.t_loc, report.e_comp, report.e_comm)


def _assert_params_close(jparams, tparams):
    jl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jparams))
    tl = jax.tree_util.tree_leaves(to_numpy(tparams))
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t, j, **PARAM_TOL)


# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dataset,kind", SCENARIOS)
def test_scenario_arrays_are_the_references_bits(dataset, kind):
    jsc, tsc = _scenarios(dataset, kind)
    assert tsc.name == jsc.name == f"{dataset}/{kind}"
    assert len(tsc.shards) == len(jsc.shards) == th.N_CLIENTS
    pairs = [*zip(jsc.shards, tsc.shards), (jsc.own_train, tsc.own_train),
             (jsc.own_test, tsc.own_test), (jsc.global_test, tsc.global_test),
             (jsc.pooled, tsc.pooled)]
    for want, got in pairs:
        for w, g in zip(want, got):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert type(tsc.task.model).__name__ == type(jsc.task.model).__name__
    assert tsc.task.lr == jsc.task.lr
    sizes = [int(np.size(v)) for v in jax.tree_util.tree_leaves(jsc.task.init(0))]
    assert tree_size(tsc.task.init(0)) == sum(sizes)


def test_scenario_parameter_counts_at_full_width():
    """The parameter counts the card's new shapes take (the calories LSTM,
    the HAR MLP) from the models' own shapes: 8 features repeated to T = 8,
    H = 64, 5 classes; 12 summary features, hidden (64, 32), 6 classes."""
    lstm = th.build_scenario("calories", "lstm", num_samples=300, device="cpu")
    mlp = th.build_scenario("har", "mlp", num_samples=240, device="cpu")
    assert lstm.pooled[0].shape[1:] == (8, 8)
    assert mlp.pooled[0].shape[1:] == (12,)
    assert tree_size(lstm.task.init(0)) == 8 * 256 + 64 * 256 + 256 + 64 * 5 + 5 == 19013
    assert tree_size(mlp.task.init(0)) == (12 * 64 + 64) + (64 * 32 + 32) + (32 * 6 + 6) \
        == 3110


def test_build_scenario_without_a_device_raises_on_a_host_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.build_scenario("calories", "mlp", num_samples=300)


def test_the_twin_keeps_the_references_constants():
    names = ("EPOCHS", "BATCH", "TARGET", "TARGET_DFL", "TARGET_CFL", "MAX_ROUNDS",
             "N_CLIENTS", "SEQ_LEN")
    assert {n: getattr(th, n) for n in names} == {n: getattr(jh, n) for n in names}
    assert [f.name for f in dataclasses.fields(th.Scenario)] == \
        [f.name for f in dataclasses.fields(jh.Scenario)]


# ---------------------------------------------------------------------------
# the harness's runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("runner", RUNNERS)
@pytest.mark.parametrize("dataset,kind", SCENARIOS)
def test_harness_run_matches_the_reference(dataset, kind, runner):
    want = _run(0, dataset, kind, runner)
    got = _run(1, dataset, kind, runner)
    jsc, tsc = _scenarios(dataset, kind)
    jcost = jcore.CostModel()
    n_params = tree_size(tsc.task.init(0))
    if runner == "cloud":
        j_acc, j_resp, j_params = want
        t_acc, t_resp, t_params = got
        np.testing.assert_allclose(t_acc, j_acc, **ACC_TOL)
        _assert_params_close(j_params, t_params)
        report = _CLOUD_REPORTS[(1, dataset, kind, runner, 5)]
        ref = jcost.cloud_session(data_bytes=int(np.asarray(jsc.pooled[0]).nbytes),
                                  cloud_train_s=report.times.t_loc)
        assert _fields(report) == _fields(ref)
        assert t_resp == report.t_train == ref.t_train
        assert report.times.t_loc > 0.0 and j_resp > 0.0
        return

    assert got.rounds == want.rounds == 1
    np.testing.assert_allclose(got.accuracy, want.accuracy, **ACC_TOL)
    np.testing.assert_allclose(got.history_raw["accuracy"], want.history_raw["accuracy"],
                               **ACC_TOL)
    _assert_params_close(want.params, got.params)
    t_loc = got.report.times.t_loc
    assert t_loc > 0.0
    common = dict(rounds=want.rounds, num_params=n_params, epochs=1,
                  num_samples=len(jsc.own_train[0]), measured_local_time=t_loc)
    if runner == "enfed":
        assert got.stop_reason == want.stop_reason
        assert got.n_contributors == want.n_contributors == 5
        assert got.model_bytes == want.model_bytes
        # Fig 7 reads the loss of each round
        assert len(got.history_raw["loss"]) == len(want.history_raw["loss"]) == got.rounds
        np.testing.assert_allclose(got.history_raw["loss"], want.history_raw["loss"],
                                   **LOSS_TOL)
        ref = jcost.session(n_contrib=5, model_bytes=want.model_bytes, n_devices=5,
                            encrypt=True, **common)
    elif runner == "cfl":
        ref = jcost.cfl_session(model_bytes=4 * n_params, **common)
    else:
        ref = jcost.dfl_session(model_bytes=4 * n_params, n_peers=th.N_CLIENTS - 1,
                                topology=runner.split("-")[1], **common)
    # the fields that hold no measured wall, as the reference's run gave
    # them; then every field, repriced with the port's measured t_loc
    wall_free = [getattr(want.report.times, f) for f in WALL_FREE] + [want.report.e_comm]
    assert [getattr(got.report.times, f) for f in WALL_FREE] + [got.report.e_comm] == wall_free
    assert _fields(got.report) == _fields(ref)


@pytest.mark.parametrize("n_contrib", [2, 3, 4])
@pytest.mark.parametrize("dataset", ["calories", "har"])
def test_enfed_at_each_contributor_count_matches_the_reference(dataset, n_contrib):
    """Figs 4-6: the LSTM's EnFed session with 2-4 contributors (eq. 14 at
    N = n_contrib)."""
    want = _run(0, dataset, "lstm", "enfed", n_contrib)
    got = _run(1, dataset, "lstm", "enfed", n_contrib)
    assert (got.rounds, got.stop_reason) == (want.rounds, want.stop_reason)
    assert got.n_contributors == want.n_contributors == n_contrib
    np.testing.assert_allclose(got.accuracy, want.accuracy, **ACC_TOL)
    np.testing.assert_allclose(got.history_raw["loss"], want.history_raw["loss"], **LOSS_TOL)
    _assert_params_close(want.params, got.params)


# ---------------------------------------------------------------------------
# the table scripts
# ---------------------------------------------------------------------------


def _runners(side):
    """The harness's four runners of ``side``, by name, each giving the
    cached cut-depth run of the scenario it is handed."""
    def run_enfed(sc, n_contrib=5):
        return _run(side, *sc.name.split("/"), "enfed", n_contrib)

    def run_cfl(sc):
        return _run(side, *sc.name.split("/"), "cfl")

    def run_dfl(sc, topology):
        return _run(side, *sc.name.split("/"), f"dfl-{topology}")

    def run_cloud(sc):
        return _run(side, *sc.name.split("/"), "cloud")

    return {f.__name__: f for f in (run_enfed, run_cfl, run_dfl, run_cloud)}


def _script_rows(side, script, monkeypatch):
    """``run()`` of one table script of ``side`` with its imported names
    patched: ``build_scenario`` to the cached small scenario, each ``run_*``
    to the cut-depth run."""
    mod = importlib.import_module(f"benchmarks.{('', 'torch_')[side]}{script}")
    monkeypatch.setattr(mod, "build_scenario",
                        lambda dataset, kind: _scenarios(dataset, kind)[side])
    for attr, fn in _runners(side).items():
        if hasattr(mod, attr):
            monkeypatch.setattr(mod, attr, fn)
    return mod.run(verbose=True)


@pytest.mark.parametrize("script", SCRIPTS)
def test_table_script_gives_the_references_rows(script, monkeypatch, capsys):
    want = _script_rows(0, script, monkeypatch)
    got = _script_rows(1, script, monkeypatch)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert len(got) == {"table4_lstm": 6, "table5_mlp": 6, "table7_cloud": 8,
                        "figs_contributors": 10}[script]
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
        # accuracy, or Fig 7's final loss
        np.testing.assert_allclose(g[1], w[1], **(LOSS_TOL if g[0].startswith("fig7")
                                                  else ACC_TOL))
        assert all(math.isfinite(float(v)) for v in g[1:])
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) >= 2 * {"table4_lstm": 2, "table5_mlp": 2, "table7_cloud": 4,
                                "figs_contributors": 10}[script]


# ---------------------------------------------------------------------------
# the entry point: each suite repeated, each row's spread
# ---------------------------------------------------------------------------

SUITE_ROWS = {"table4": 6, "table5": 6, "table7": 8, "figs": 10}


@pytest.mark.parametrize("suite", sorted(SUITE_ROWS))
def test_torch_run_prints_each_rows_spread_and_the_median_csv(suite, monkeypatch, capsys):
    """``benchmarks.torch_run`` over one suite, 2 repeats, on the cached
    cut-depth runs: every row with its median and min-max, the same
    accuracies and rounds in each repeat, and the CSV of the medians."""
    from benchmarks import torch_run

    module = importlib.import_module(torch_run.SUITES[suite][0])
    for attr in ("build_scenario", *torch_run.RUNNERS):
        if hasattr(module, attr):       # restored after the test
            monkeypatch.setattr(module, attr, getattr(module, attr))
    monkeypatch.setattr(th, "build_scenario",
                        lambda dataset, kind, device=None: _scenarios(dataset, kind)[1])
    for attr, fn in _runners(1).items():
        monkeypatch.setattr(th, attr, fn)
    monkeypatch.setattr(sys, "argv", ["torch_run", "--only", suite, "--device", "cpu",
                                      "--repeats", "2"])
    torch_run.main()
    out = capsys.readouterr().out
    assert f"{suite}: 2 repeats, median [min, max] per row" in out
    assert "accuracy and rounds identical in every repeat: yes" in out
    csv = out.split("name,us_per_call,derived\n")[1].strip().splitlines()
    assert len(csv) == SUITE_ROWS[suite]
    if suite in ("table4", "table5"):
        assert out.count("EnFed vs DFL") == out.count("EnFed vs CFL") == 4
    if suite == "table7":
        assert out.count("EnFed vs cloud") == 4
        enfed = _run(1, "har", "mlp", "enfed")
        cloud = _CLOUD_REPORTS[(1, "har", "mlp", "cloud", 5)]
        saving = 100 * (1 - enfed.report.t_train / cloud.t_train)
        assert csv[-2] == (f"table7/Dataset2/mlp/EnFed,{np.median([enfed.accuracy] * 2)},"
                           f"{np.median([saving] * 2)}")


def test_torch_run_refuses_the_suites_it_does_not_run(monkeypatch):
    from benchmarks import torch_run

    monkeypatch.setattr(sys, "argv", ["torch_run", "--only", "kernels"])
    with pytest.raises(SystemExit):
        torch_run.main()
