"""The ``repro_torch.api`` facade on the CPU: against the JAX package's
``repro.api`` on one world (event streams under the reference's own
``compare_event_streams`` at its default tolerances), against the port's
own engine entry points (bitwise), and the execution knobs it passes
(``use_pallas``, ``interpret``, ``round_chunk``).

The worlds are the reference's ``tests/test_api.py`` world (calories MLP,
600 samples, 3 contributors) and one small LSTM (H = 8, T = 8), built in
both packages from one numpy seed: the contributors are pretrained by the
JAX task and carried across, and the port's task inits from the
reference's ``task.init(seed)``, converted (model init is the one draw the
port does not reproduce, ``ROADMAP.md`` "Randomness").
"""

import copy
import dataclasses
import importlib.util
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.api as japi  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.telemetry as jtel  # noqa: E402
from repro.models import (LSTMClassifier as JLSTM, LSTMClassifierConfig as JLSTMConfig,  # noqa: E402
                          MLPClassifier as JMLP, MLPClassifierConfig as JMLPConfig)
import repro_torch.core as tcore  # noqa: E402
from repro_torch.api import (DEFAULT_COMPARISON, CompareResult, ExecutionSpec,  # noqa: E402
                             Experiment, MethodSpec, RunResult, TraceConfig, WorldSpec,
                             method_names)
from repro_torch.core.energy import CostModel, DeviceProfile  # noqa: E402
from repro_torch.data import (CaloriesDatasetConfig, HARDatasetConfig,  # noqa: E402
                              dirichlet_partition, make_calories_tabular,
                              make_har_windows)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.telemetry import compare_event_streams, validate_events  # noqa: E402
from repro_torch.models import (LSTMClassifier, LSTMClassifierConfig,  # noqa: E402
                                MLPClassifier, MLPClassifierConfig)
from repro_torch.utils.tree import from_jax_params, tree_leaves  # noqa: E402

from _torch_ref import RefInitTask as _RefInitTask  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's small ops on one thread: beside the suite's other
    workers, torch's intra-op threads oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
BATCH = 16
REPORT_FIELDS = ("t_dev", "t_hand", "t_key", "t_init", "t_com", "t_enc", "t_dec", "t_agg",
                 "t_loc")
# the reference's limits between its own two engines (tests/test_api.py)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
ACC_TOL = dict(rtol=1e-5, atol=1e-6)
# the reference's _METHOD of tests/test_api.py and tests/test_telemetry.py
_KNOBS = dict(desired_accuracy=0.99, max_rounds=2, epochs=1, batch_size=BATCH,
              encrypt=False, contributor_refresh_epochs=1)
_ADVERSARY = dict(p_byzantine=0.5, attack="noise", scale=10.0, seed=7)

_WORLDS = {}


def _build(kind):
    """Both packages' task, fleet and pretrained contributor states, and the
    requester's splits, built once per model."""
    if kind not in _WORLDS:
        if kind == "lstm":
            x, y, _ = make_har_windows(HARDatasetConfig(num_samples=240, seq_len=8))
            jtask = jcore.SupervisedTask(JLSTM(JLSTMConfig(input_dim=6, seq_len=8, hidden=8,
                                                           num_classes=6)), lr=3e-3)
            model = LSTMClassifier(LSTMClassifierConfig(input_dim=6, seq_len=8, hidden=8),
                                   device=CPU)
        else:
            x, y = make_calories_tabular(CaloriesDatasetConfig(num_samples=600))
            jtask = jcore.SupervisedTask(JMLP(JMLPConfig(8, (16,), 5)), lr=3e-3)
            model = MLPClassifier(MLPClassifierConfig(8, (16,), 5), device=CPU)
        parts = dirichlet_partition(y, num_clients=4, alpha=100.0, seed=0)
        shards = [(x[p], y[p]) for p in parts]
        own_x, own_y = shards[0]
        n = int(len(own_x) * 0.8)
        own_train, own_test = (own_x[:n], own_y[:n]), (own_x[n:], own_y[n:])
        jfleet = jcore.make_fleet(3, seed=1, p_has_model=1.0)
        tfleet = tcore.make_fleet(3, seed=1, p_has_model=1.0)
        jstates, tstates = {}, {}
        for i, (jd, td) in enumerate(zip(jfleet, tfleet)):
            jd.reservation_price = td.reservation_price = 0.4
            p, _ = jtask.fit(jtask.init(seed=10 + i), shards[i + 1], epochs=1,
                             batch_size=BATCH, seed=i)
            jstates[jd.device_id] = {"params": p, "data": shards[i + 1]}
            tstates[td.device_id] = {
                "params": from_jax_params(jax.tree_util.tree_map(np.asarray, p), CPU),
                "data": shards[i + 1]}
        _WORLDS[kind] = (jtask, _RefInitTask(model, jtask), own_train, own_test,
                         jfleet, tfleet, jstates, tstates)
    return _WORLDS[kind]


def _worlds(kind="mlp", n_requesters=1, **world_kw):
    """The reference's and the port's WorldSpec of one world, with fresh
    copies of the contributor states."""
    jtask, ttask, own_train, own_test, jfleet, tfleet, jstates, tstates = _build(kind)
    jw = japi.WorldSpec(task=jtask, requesters=[
        jcore.RequesterSpec(own_train, own_test, jfleet, copy.deepcopy(jstates))
        for _ in range(n_requesters)], **world_kw)
    tw = WorldSpec(task=ttask, requesters=[
        tcore.RequesterSpec(own_train, own_test, tfleet, copy.deepcopy(tstates))
        for _ in range(n_requesters)], device="cpu", **world_kw)
    return jw, tw


def _methods(**over):
    kw = dict(_KNOBS, **over)
    if "adversary" in kw:
        return (dataclasses.replace(japi.MethodSpec(**kw), adversary=jcore.AdversaryConfig(
                    **kw["adversary"])),
                dataclasses.replace(MethodSpec(**kw), adversary=tcore.AdversaryConfig(
                    **kw["adversary"])))
    return japi.MethodSpec(**kw), MethodSpec(**kw)


def _ref_events(res):
    """The port's events as the reference's RoundEvents, schema-checked by
    the reference's own validator."""
    return jtel.validate_events([jtel.RoundEvent(**ev.__dict__) for ev in res.trace])


def _assert_events_equal(ref, port):
    assert jtel.compare_event_streams(jtel.validate_events(ref.trace), _ref_events(port)) == []


def _fields(report):
    return tuple(getattr(report.times, f) for f in REPORT_FIELDS) + (report.e_comp,
                                                                   report.e_comm)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["loop", "fleet"])
@pytest.mark.parametrize("method", list(DEFAULT_COMPARISON))
def test_run_matches_reference(method, engine):
    jw, tw = _worlds()
    jm, tm = _methods()
    ref = japi.Experiment(jw, jm, japi.ExecutionSpec(engine=engine)).run(method)
    got = Experiment(tw, tm, ExecutionSpec(engine=engine)).run(method)
    assert (got.method, got.engine, got.rounds, got.stop_reason) == \
        (ref.method, ref.engine, ref.rounds, ref.stop_reason)
    _assert_events_equal(ref, got)
    if got.engine == "fleet":
        # modelled fit time: the report to the float (loop reports carry
        # measured fit walls)
        assert _fields(got.report) == _fields(ref.report)
        assert got.total_energy_j == pytest.approx(ref.total_energy_j, rel=1e-12)


@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_compare_matches_reference(engine):
    jw, tw = _worlds()
    jm, tm = _methods()
    ref = japi.Experiment(jw, jm, japi.ExecutionSpec(engine=engine)).compare(
        japi.DEFAULT_COMPARISON)
    got = Experiment(tw, tm, ExecutionSpec(engine=engine)).compare(DEFAULT_COMPARISON)
    assert list(got.results) == list(ref.results) == list(DEFAULT_COMPARISON)
    for name in DEFAULT_COMPARISON:
        _assert_events_equal(ref[name], got[name])
    assert [r["baseline"] for r in got.reductions("enfed")] == \
        [r["baseline"] for r in ref.reductions("enfed")]


@pytest.mark.parametrize("engine", ["loop", "fleet"])
@pytest.mark.parametrize("compress", [None, "int8"])
def test_byzantine_world_matches_reference(compress, engine):
    """Two requesters under attack with the clip defense: the corrupted and
    clipped sets exact, requester 1 drawing its weather as requester_id + 1
    on both engines."""
    jw, tw = _worlds(n_requesters=2)
    jm, tm = _methods(adversary=_ADVERSARY, robust="clip", compress=compress)
    ref = japi.Experiment(jw, jm, japi.ExecutionSpec(engine=engine)).run()
    got = Experiment(tw, tm, ExecutionSpec(engine=engine)).run()
    _assert_events_equal(ref, got)
    assert got.corruption_summary == ref.corruption_summary
    assert got.corruption_summary["corrupted_links"] > 0
    if engine == "fleet":
        assert _fields(got.report) == _fields(ref.report)


def test_lstm_world_matches_reference():
    """The small LSTM on the fleet, whose lanes run the sequence op."""
    jw, tw = _worlds("lstm")
    jm, tm = _methods(desired_accuracy=1.01)
    ref = japi.Experiment(jw, jm, japi.ExecutionSpec(engine="fleet")).run()
    got = Experiment(tw, tm, ExecutionSpec(engine="fleet")).run()
    _assert_events_equal(ref, got)


# ---------------------------------------------------------------------------
# the facade against the port's own entry points
# ---------------------------------------------------------------------------


def _legacy_cfg(method: MethodSpec) -> tcore.EnFedConfig:
    return tcore.EnFedConfig(
        desired_accuracy=method.desired_accuracy, max_rounds=method.max_rounds,
        n_max=method.n_max, battery_threshold=method.battery_threshold,
        offered_incentive=method.offered_incentive, epochs=method.epochs,
        batch_size=method.batch_size, encrypt=method.encrypt,
        contributor_refresh_epochs=method.contributor_refresh_epochs,
        seed=0, strategy=method.strategy)


def _assert_bitwise(a, b):
    """Two results of one simulation: params bit for bit, every history
    buffer equal, rounds and stop reason exact."""
    assert a.rounds == b.rounds and a.stop_reason == b.stop_reason
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    ha, hb = a.history_raw, b.history_raw
    assert set(ha) == set(hb)
    for k in ha:
        assert len(ha[k]) == len(hb[k]), k
        for ra, rb in zip(ha[k], hb[k]):
            np.testing.assert_array_equal(np.asarray(ra), np.asarray(rb), err_msg=k)


@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_facade_matches_legacy_static(engine):
    _, tw = _worlds()
    _, tm = _methods()
    res = Experiment(tw, tm, ExecutionSpec(engine=engine)).run()
    _, ttask, own_train, own_test, _, tfleet, _, tstates = _build("mlp")
    cfg = _legacy_cfg(tm)
    if engine == "loop":
        legacy = tcore.EnFedSession(ttask, own_train, own_test, tfleet,
                                    copy.deepcopy(tstates), cfg, device=CPU).run()
    else:
        legacy = tcore.run_fleet(ttask, [tcore.RequesterSpec(own_train, own_test, tfleet,
                                                             copy.deepcopy(tstates))],
                                 cfg, device=CPU).sessions[0]
    assert res.method == "enfed" and res.engine == engine
    assert res.report is res.sessions[0].report
    _assert_bitwise(res, legacy)


def test_facade_runs_are_independent():
    """run() copies the world's mutable state: two runs are identical, and
    the WorldSpec's contributor params are never trained in place."""
    _, world = _worlds()
    before = [t.clone() for t in tree_leaves(
        next(iter(world.requesters[0].contributor_states.values()))["params"])]
    exp = Experiment(world, _methods()[1], ExecutionSpec(engine="loop"))
    _assert_bitwise(exp.run(), exp.run())
    after = tree_leaves(next(iter(world.requesters[0].contributor_states.values()))["params"])
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_compare_all_methods_share_one_cost_model():
    _, world = _worlds()
    cmp = Experiment(world, _methods()[1]).compare(["enfed", "dfl", "cfl", "cloud"])
    assert isinstance(cmp, CompareResult)
    assert list(cmp.results) == ["enfed", "dfl", "cfl", "cloud"]
    for res in cmp:
        assert isinstance(res, RunResult)
        assert res.cost_model is world.cost_model
        assert res.sessions and res.report is res.sessions[0].report
        assert np.isfinite(res.energy_j) and res.energy_j > 0.0
        assert np.isfinite(res.simulated_s) and res.simulated_s > 0.0
    row = cmp.reduction("enfed", "dfl")
    for k in ("time_reduction_pct", "energy_reduction_pct", "t_method_s", "e_baseline_j"):
        assert np.isfinite(row[k])
    assert len(cmp.reductions("enfed")) == 3
    assert "enfed" in cmp.table() and "cloud" in cmp.table()


def test_compare_cost_model_actually_flows():
    """Scaling the device's power profile scales EVERY method's energy: no
    baseline costs through a private default CostModel."""
    d = DeviceProfile()
    dev10 = dataclasses.replace(d, p_tx=d.p_tx * 10, p_rx=d.p_rx * 10,
                                p_train=d.p_train * 10, p_agg=d.p_agg * 10,
                                p_crypto=d.p_crypto * 10, p_init=d.p_init * 10)
    w1 = _worlds()[1]
    w10 = dataclasses.replace(_worlds()[1], cost_model=CostModel(device=dev10))
    for m in DEFAULT_COMPARISON:
        e1 = Experiment(w1, _methods()[1]).run(m).energy_j
        e10 = Experiment(w10, _methods()[1]).run(m).energy_j
        assert e10 > 2.0 * e1, (m, e1, e10)


def test_dfl_topologies_coexist_via_labels():
    tm = _methods()[1]
    cmp = Experiment(_worlds()[1], tm).compare([
        dataclasses.replace(tm, name="dfl", topology="mesh", label="dfl-mesh"),
        dataclasses.replace(tm, name="dfl", topology="ring", label="dfl-ring")])
    assert list(cmp.results) == ["dfl-mesh", "dfl-ring"]
    # mesh exchanges with all 3 peers, ring with 2
    assert cmp["dfl-mesh"].report.times.t_com > cmp["dfl-ring"].report.times.t_com
    labeled = dataclasses.replace(tm, name="dfl", label="dfl-mesh")
    assert MethodSpec.coerce("enfed", like=labeled).key == "enfed"
    with pytest.raises(ValueError, match="duplicate method key"):
        Experiment(_worlds()[1], tm).compare(["dfl", "dfl"])


@pytest.mark.parametrize("engine", ["loop", "fleet"])
@pytest.mark.parametrize("knob,match", [
    (dict(world=dict(mobility=object())), "ignores world.mobility"),
    (dict(method=dict(cadence=tcore.CadenceConfig(n_speed_classes=2))),
     "ignores MethodSpec.cadence"),
    (dict(method=dict(adversary=tcore.AdversaryConfig(p_byzantine=0.5), robust="clip")),
     "ignores MethodSpec.adversary"),
    (dict(execution=dict(checkpoint_dir="ckpt")), "ignores ExecutionSpec checkpointing")])
def test_baselines_warn_and_strip_enfed_only_knobs(knob, match, engine):
    """A baseline asked for a knob it cannot honor warns (never silently)
    and runs the world without it: the same outcome as the plain run."""
    _, tw = _worlds()
    tm = _methods(max_rounds=1)[1]
    plain = Experiment(tw, tm, ExecutionSpec(engine=engine)).run("dfl")
    world = dataclasses.replace(tw, **knob.get("world", {}))
    method = dataclasses.replace(tm, **knob.get("method", {}))
    execution = ExecutionSpec(engine=engine, **knob.get("execution", {}))
    with pytest.warns(UserWarning, match=match):
        res = Experiment(world, method, execution).run("dfl")
    _assert_bitwise(plain, res)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        Experiment(tw, tm, ExecutionSpec(engine=engine)).run("dfl")


def test_baselines_honor_fleet_engine():
    """With ExecutionSpec(engine="fleet") the dfl/cfl rows come from the
    fleet engine, and match the loop rows on the same world + seed."""
    results = {e: Experiment(_worlds()[1], _methods()[1],
                             ExecutionSpec(engine=e)).compare(["dfl", "cfl"])
               for e in ("loop", "fleet")}
    for name in ("dfl", "cfl"):
        rl, rf = results["loop"][name], results["fleet"][name]
        assert rl.engine == "loop" and rf.engine == "fleet"
        assert isinstance(rf.raw, tcore.FleetResult)
        assert (rf.rounds, rf.stop_reason) == (rl.rounds, rl.stop_reason)
        assert rf.sessions[0].battery is None
        np.testing.assert_allclose(rf.history_raw["accuracy"], rl.history_raw["accuracy"],
                                   **ACC_TOL)
        for a, b in zip(tree_leaves(rf.params), tree_leaves(rl.params)):
            torch.testing.assert_close(a, b, **PARAM_TOL)
        assert np.isfinite(rf.energy_j) and rf.energy_j > 0.0


def test_unknown_method_and_engine_fail_fast():
    with pytest.raises(ValueError, match="unknown method"):
        Experiment(_worlds()[1], "sputnik").run()
    with pytest.raises(ValueError, match="unknown engine"):
        ExecutionSpec(engine="warp")
    assert set(method_names()) >= {"enfed", "dfl", "cfl", "cloud"}
    assert Experiment.available_methods() == method_names()


@pytest.mark.parametrize("kwargs,match", [
    (dict(interpret=True), "use_pallas=False"), (dict(interpret=False), "interpret"),
    (dict(round_chunk=0), "round_chunk"), (dict(checkpoint_every=-1), "checkpoint_every"),
    (dict(trace={"events_jsonl": "x.jsonl"}), "TraceConfig")])
def test_execution_spec_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        ExecutionSpec(**kwargs)


@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_engines_refuse_interpret(engine):
    _, ttask, own_train, own_test, _, tfleet, _, tstates = _build("mlp")
    session = tcore.EnFedSession(ttask, own_train, own_test, tfleet, copy.deepcopy(tstates),
                                 _legacy_cfg(_methods()[1]), device=CPU)
    with pytest.raises(ValueError, match="use_pallas=False"):
        session.run(engine=engine, interpret=True)


@pytest.mark.parametrize("knob,engine,match", [
    (dict(method=dict(cadence=tcore.CadenceConfig(n_speed_classes=2, duty_cycle=3, duty_on=2,
                                                  seed=3))), "fleet", "slice E"),
    (dict(execution=dict(trace=TraceConfig(hlo_stats=True))), "fleet", "slice F"),
    (dict(execution=dict(trace=TraceConfig(jax_profiler_dir="prof"))), "fleet", "slice F")])
def test_enfed_refuses_unported_knobs_naming_their_slice(knob, engine, match, tmp_path):
    """No knob is refused any more.  The profiler fields, which raised
    naming slice F before it, run: the traced run is the untraced one bit
    for bit, ``RunResult.hlo_stats`` carries the fleet's program cost, and
    the profiler writes its trace.  The cadence, which raised naming slice
    E before its slice, runs, its events carrying the lane's clock and idle
    steps."""
    _, tw = _worlds()
    world = dataclasses.replace(tw, **knob.get("world", {}))
    method = dataclasses.replace(_methods()[1], **knob.get("method", {}))
    exec_kw = dict(knob.get("execution", {}))
    if "trace" in exec_kw and exec_kw["trace"].jax_profiler_dir:
        exec_kw["trace"] = TraceConfig(jax_profiler_dir=str(tmp_path / "prof"))
    execution = ExecutionSpec(engine=engine, **exec_kw)
    if match == "slice E":
        res = Experiment(world, method, execution).run()
        rounds = [e for e in validate_events(res.trace) if e.phase == "round"]
        assert [e.clock for e in rounds] == res.history_raw["round_clock"]
        assert all(e.idle is not None for e in rounds) and np.isfinite(res.accuracy)
        return
    res = Experiment(world, method, execution).run()
    plain = Experiment(_worlds()[1], method, ExecutionSpec(engine=engine)).run()
    _assert_bitwise(res, plain)
    if execution.trace.hlo_stats:
        assert res.hlo_stats["per_kernel"]["fedavg"]["launches"] == res.rounds
        assert res.hlo_stats["flops"] > 0 and res.hlo_stats["bytes_accessed"] > 0
    else:
        assert res.hlo_stats is None
        assert list((tmp_path / "prof").glob("*.pt.trace.json"))


_FC = tcore.FaultConfig(p_drop=0.5, p_stale=0.4, max_retries=1, release_after=2, seed=3)


@pytest.mark.parametrize("knob,engine", [
    (dict(method=dict(faults=_FC)), "loop"),
    (dict(world=dict(mobility=tcore.MobilityConfig(seed=3)), method=dict(faults=_FC)), "loop"),
    (dict(method=dict(staleness_gamma=0.5)), "fleet"),
    (dict(execution=dict(checkpoint_dir="ckpt")), "loop"),
    (dict(execution=dict(resume_from="ckpt")), "fleet")])
def test_enfed_runs_the_knobs_of_the_fault_slice(knob, engine, tmp_path):
    """What the facade refused before the fault slice runs: faults (static
    and under mobility), the decay, a checkpointing run and a resumed one
    (through ``Experiment.run(resume=...)``, the straight run's events)."""
    _, tw = _worlds()
    world = dataclasses.replace(tw, **knob.get("world", {}))
    method = dataclasses.replace(_methods()[1], **knob.get("method", {}))
    ckpt = str(tmp_path / "ckpt")
    ex = {k: ckpt for k in knob.get("execution", {})}
    if "resume_from" in ex:
        straight = Experiment(world, method, ExecutionSpec(
            engine=engine, round_chunk=1, checkpoint_dir=ckpt)).run()
        os.remove(os.path.join(ckpt, f"step_{straight.rounds:08d}.npz"))
        res = Experiment(world, method, ExecutionSpec(engine=engine, round_chunk=1)).run(
            resume=ckpt)
        assert compare_event_streams(straight.trace, res.trace, atol=0, energy_atol=0) == []
        return
    res = Experiment(world, method, ExecutionSpec(engine=engine, **ex)).run()
    assert validate_events(res.trace) and np.isfinite(res.accuracy)
    if "checkpoint_dir" in ex:
        assert len(os.listdir(ckpt)) == res.rounds
    if "faults" in knob.get("method", {}):
        assert "deliver_mask" in res.history_raw


def test_experiment_without_device_raises_on_a_host_without_gpu(monkeypatch):
    _, tw = _worlds()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for method in DEFAULT_COMPARISON:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Experiment(dataclasses.replace(tw, device=None), _methods()[1]).run(method)


# ---------------------------------------------------------------------------
# engine-knob plumbing
# ---------------------------------------------------------------------------


def test_session_run_threads_engine_knobs_to_run_fleet(monkeypatch):
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.telemetry import Timeline

    seen = {}
    real = fleet_mod.run_fleet

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(fleet_mod, "run_fleet", spy)
    _, ttask, own_train, own_test, _, tfleet, _, tstates = _build("mlp")
    tl = Timeline()
    tcore.EnFedSession(ttask, own_train, own_test, tfleet, copy.deepcopy(tstates),
                       _legacy_cfg(_methods(max_rounds=1)[1]), device=CPU).run(
        engine="fleet", use_pallas=False, round_chunk=2, timeline=tl)
    assert seen["use_pallas"] is False and seen["round_chunk"] == 2
    assert seen["interpret"] is None and seen["timeline"] is tl
    assert {"stage", "program", "unpack"} <= set(tl.totals())


def test_execution_spec_threads_knobs_through_facade(monkeypatch):
    from repro_torch.core import fleet as fleet_mod

    seen = {}
    real = fleet_mod.run_fleet

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(fleet_mod, "run_fleet", spy)
    trace = TraceConfig()
    Experiment(_worlds()[1], _methods(max_rounds=1)[1],
               ExecutionSpec(engine="fleet", round_chunk=3, use_pallas=False,
                             trace=trace)).run()
    assert seen["round_chunk"] == 3 and seen["use_pallas"] is False
    assert seen["trace"] is trace and seen["device"] == CPU


@pytest.mark.parametrize("method", ["enfed", "cfl", "cloud"])
@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_use_pallas_false_selects_the_twins_for_the_whole_run(method, engine, monkeypatch):
    """``use_pallas=False`` holds the plain-twin selection for the whole
    run (a spy on the eq. 14 twin sees it at every call); the default
    holds none; the outcome is the same bits (on the CPU the twins run
    either way)."""
    from repro_torch.kernels.fedavg import ops as fedavg_ops

    seen = []
    real = fedavg_ops.fedavg_batched_ref

    def spy(*args):
        seen.append(common.plain_twins_selected())
        return real(*args)

    monkeypatch.setattr(fedavg_ops, "fedavg_batched_ref", spy)
    tm = _methods(max_rounds=1)[1]
    runs = {}
    for use_pallas in (True, False):
        seen.clear()
        runs[use_pallas] = Experiment(_worlds()[1], tm, ExecutionSpec(
            engine=engine, use_pallas=use_pallas)).run(method)
        assert seen == [not use_pallas] * len(seen)
        assert seen or method == "cloud"
    assert not common.plain_twins_selected()
    _assert_bitwise(runs[True], runs[False])


def _chunk_world(case):
    """A world whose lanes stop at different rounds: requester 0 on a
    battery just above the threshold (it stops on battery after round 1),
    requester 1 on a full one; or, with ``early``, every lane reaching a
    target of 0 in round 1 of 5."""
    _, tw = _worlds(n_requesters=2)
    if case == "early":
        return tw, dict(desired_accuracy=0.0, max_rounds=5)
    tw.requesters[0].battery = tcore.BatteryState(level=0.2 + 1e-6)
    return tw, dict(desired_accuracy=1.01, max_rounds=5)


@pytest.mark.parametrize("chunk", [2, 4, 5])
@pytest.mark.parametrize("case", [
    ("enfed", "mixed", {}), ("enfed", "early", {}),
    ("enfed", "mixed", dict(compress="int8", adversary=_ADVERSARY, robust="clip")),
    ("cfl", "early", {}), ("dfl", "early", {})], ids=lambda c: "-".join(map(str, c[:2])) + (
        "-byz8" if c[2] else ""))
def test_round_chunk_is_bitwise_invariant(case, chunk):
    """Outcome, round_executed and every history buffer are the same bits
    for round_chunk 1, 2, 4 and max_rounds, where lanes stop inside a chunk
    and where the whole fleet stops before max_rounds."""
    method, world_case, over = case
    tw, knobs = _chunk_world(world_case)
    tm = _methods(**knobs, **over)[1]
    base = Experiment(tw, tm, ExecutionSpec(engine="fleet", round_chunk=1)).run(method)
    got = Experiment(tw, tm, ExecutionSpec(engine="fleet", round_chunk=chunk)).run(method)
    if world_case == "early":
        assert base.raw.history["round_executed"].tolist() == [1.0, 0, 0, 0, 0]
    else:
        assert [s.rounds for s in base.sessions] == [1, 5]
    for a, b in zip(base.sessions, got.sessions):
        _assert_bitwise(a, b)
    assert set(base.raw.history) == set(got.raw.history)
    for k, v in base.raw.history.items():
        np.testing.assert_array_equal(v, got.raw.history[k], err_msg=k)


# ---------------------------------------------------------------------------
# the export surface
# ---------------------------------------------------------------------------


def test_core_reexports_facade_and_all():
    import repro_torch.api as api

    for name in ("Experiment", "WorldSpec", "MethodSpec", "ExecutionSpec",
                 "RunResult", "CompareResult", "register_method"):
        assert name in tcore.__all__
        assert getattr(tcore, name) is getattr(api, name)
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None
    assert set(api.__all__) == set(japi.__all__)
    import repro_torch.telemetry as tel

    # the profiler hooks under PyTorch names: the reference's jax.profiler
    # wrapper and its compile-for-cost-analysis hook
    renamed = {"maybe_jax_profiler": "maybe_torch_profiler",
               "jit_hlo_stats": "record_program_cost"}
    assert {renamed.get(n, n) for n in jtel.__all__} <= set(tel.__all__)
    assert set(tel.__all__) - {renamed.get(n, n) for n in jtel.__all__} == {
        "program_cost_stats", "ProgramCost"}


def test_deprecated_history_view_warns():
    res = Experiment(_worlds()[1], _methods(max_rounds=1)[1]).run("cloud")
    with pytest.warns(DeprecationWarning, match="history_raw"):
        hist = res.history
    assert hist is res.history_raw


# ---------------------------------------------------------------------------
# examples/torch_har_federated.py
# ---------------------------------------------------------------------------


def _example(*args):
    # one thread: the process runs beside the test workers' own
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_har_federated.py"), *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)


def _example_main():
    spec = importlib.util.spec_from_file_location(
        "torch_har_federated", ROOT / "examples" / "torch_har_federated.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_har_federated_twin_prints_the_compare_table():
    out = _example("--dataset", "calories", "--epochs", "1", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    head = next(i for i, line in enumerate(lines) if line.startswith("method"))
    rows = [line.split()[0] for line in lines[head + 1: head + 6]]
    assert rows == ["enfed", "cfl", "dfl-mesh", "dfl-ring", "cloud"]
    assert sum("EnFed vs" in line for line in lines) == 4


def test_har_federated_twin_wants_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example_main()(["--dataset", "calories", "--epochs", "1"])


@pytest.mark.parametrize("flag", ["--churn", "--faults", "--cadence"])
def test_har_federated_twin_refuses_unported_worlds(flag, capsys):
    """Every world flag runs its walkthrough (``--cadence`` exited non-zero
    before its slice), in process on the calories MLP: each round's
    contract set with its joins and leaves, its delivered set with the
    drop, retry and stale counts, or its clock, idle steps and
    stragglers."""
    argv = ["--dataset", "calories", flag, "--device", "cpu"]
    assert _example_main()(argv + ["--epochs", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    head = next(i for i, line in enumerate(lines) if line.startswith("round"))
    if flag == "--cadence":
        assert "clock" in lines[head] and "idle" in lines[head] and "stragglers" in lines[head]
        rows = lines[head + 1: head + 11]
        assert [int(r.split()[0]) for r in rows] == list(range(10))
        clocks = [int(r.split()[1]) for r in rows]
        assert clocks == sorted(set(clocks))
        assert any(int(r.split()[2]) > 0 for r in rows)   # the requester idled
        assert any("[]" not in r for r in rows)      # a straggler on some step
        summary = next(line for line in lines if line.startswith("cadence:"))
        assert summary.split()[1:5] == ["10", "rounds", "over", str(clocks[-1] + 1)]
        return
    if flag == "--faults":
        assert "delivered" in lines[head] and "stale" in lines[head]
        rows = lines[head + 1: head + 11]
        assert [int(r.split()[0]) for r in rows] == list(range(10))
        weather = next(line for line in lines if line.startswith("fault weather:"))
        assert int(weather.split()[2]) > 0          # drops happened
        return
    assert "contract set" in lines[head]
    rows = lines[head + 1: head + 11]
    assert [int(r.split()[0]) for r in rows] == list(range(10))
    notes = [r.split("]")[-1] for r in rows[1:]]       # after the set: acc, battery, +j -j
    assert any("+" in n or "-" in n for n in notes)
    assert any(line.startswith("churn:") and "joins" in line for line in lines)


@pytest.mark.parametrize("method", ["cfl", "dfl", "dfl-ring"])
def test_baselines_engines_agree_bit_for_bit_on_the_cpu(method):
    """On the CPU the loop learners and the fleet's baseline lanes compute
    the same bits, at a depth (3 rounds of 2 epochs) where the card's
    batched products, at another lane count in each engine, part them."""
    tm = _methods(max_rounds=3, epochs=2, desired_accuracy=1.01)[1]
    spec = (dataclasses.replace(tm, name="dfl", topology="ring", label="dfl-ring")
            if method == "dfl-ring" else method)
    loop, fleet = (Experiment(_worlds()[1], tm, ExecutionSpec(engine=e)).run(spec)
                   for e in ("loop", "fleet"))
    assert loop.rounds == fleet.rounds == 3
    for a, b in zip(tree_leaves(loop.params), tree_leaves(fleet.params)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert loop.history_raw["accuracy"] == fleet.history_raw["accuracy"]
