"""The port's fleet engine against the JAX fleet engine on the CPU
(``run_fleet`` with Pallas in interpret mode), against the port's own loop
engine, its refusal of the knobs it does not run yet, and the knobs of the
fault slice running (held to the reference in
``tests/test_torch_faults_engines.py``).

Each JAX configuration compiles and runs once per module (the results are
cached by case), so the file stays well inside the tier-1 wall.
"""

import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.models import (LSTMClassifier as JLSTM, LSTMClassifierConfig as JLSTMConfig,  # noqa: E402
                          MLPClassifier as JMLP, MLPClassifierConfig as JMLPConfig)
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.battery import BatteryState  # noqa: E402
from repro_torch.kernels.quantize.ops import resolve_compress  # noqa: E402
from repro_torch.data import (CaloriesDatasetConfig, HARDatasetConfig,  # noqa: E402
                              dirichlet_partition, make_calories_tabular,
                              make_har_windows)
from repro_torch.models import (LSTMClassifier, LSTMClassifierConfig,  # noqa: E402
                                MLPClassifier, MLPClassifierConfig)
from repro_torch.utils.tree import (from_jax_params, to_numpy, tree_leaves,  # noqa: E402
                                    tree_ravel)
from repro_torch.telemetry import Timeline, TraceConfig  # noqa: E402

CPU = torch.device("cpu")
# rounds of lane-batched Adam fits and refreshes: fp32 rounding in another order
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
# int8: the per-tile scale bound of tests/test_compress.py (a code may flip
# where fp32 rounding moves a value across a rounding boundary)
INT8_TOL = dict(rtol=0, atol=1e-2)
ACC_ATOL = 1e-6
# both engines discharge the battery in fp32
BATTERY_RTOL = 1e-6

_WORLDS = {}
_RUNS = {}


def _world(kind):
    """Shards, the JAX task and the contributors' initial params (JAX
    arrays), built once per model."""
    if kind not in _WORLDS:
        if kind == "lstm":
            x, y, _ = make_har_windows(HARDatasetConfig(num_samples=300, seq_len=8))
            jtask = jcore.SupervisedTask(JLSTM(JLSTMConfig(input_dim=6, seq_len=8, hidden=16,
                                                           num_classes=6)), lr=3e-3)
        else:
            x, y = make_calories_tabular(CaloriesDatasetConfig(num_samples=400))
            jtask = jcore.SupervisedTask(JMLP(JMLPConfig(input_dim=8, hidden=(16, 8),
                                                         num_classes=5)), lr=3e-3)
        parts = dirichlet_partition(y, num_clients=6, alpha=1.0, seed=0)
        shards = [(x[p], y[p]) for p in parts]
        init = [jtask.init(seed=10 + i) for i in range(3)]
        _WORLDS[kind] = (jtask, shards, init)
    return _WORLDS[kind]


def _port_task(kind, partitionable):
    if kind == "lstm":
        model = LSTMClassifier(LSTMClassifierConfig(input_dim=6, seq_len=8, hidden=16),
                               device=CPU)
    else:
        model = MLPClassifier(MLPClassifierConfig(input_dim=8, hidden=(16, 8)), device=CPU)
    return tcore.SupervisedTask(model, lr=3e-3, threefry_partitionable=partitionable)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _specs(mod, kind, levels, to_params):
    """Three requesters with distinct own shards (the third smaller than a
    batch) and the same three contributors, each with its own states."""
    _, shards, init = _world(kind)
    out = []
    for r in range(3):
        sx, sy = shards[r]
        n = 10 if r == 2 else int(len(sx) * 0.8)
        fleet = mod.make_fleet(3, seed=1, p_has_model=1.0)
        for d in fleet:
            d.reservation_price = 0.4
        states = {d.device_id: {"params": to_params(init[i]), "data": shards[3 + i]}
                  for i, d in enumerate(fleet)}
        battery = None if levels is None else mod.BatteryState(level=levels[r])
        out.append(mod.RequesterSpec((sx[:n], sy[:n]), (sx[n:], sy[n:]), fleet, states,
                                     battery))
    return out


CASES = {
    # name: (kind, partitionable, compress, strategy k, encrypt, overrides)
    "mlp-fp32": ("mlp", True, None, None, True, {}),
    "mlp-int8-enfed2": ("mlp", False, "int8", 2, False, {}),
    "mlp-auto": ("mlp", True, "auto", 2, True, {}),
    "mlp-early-exit": ("mlp", True, None, None, True,
                       dict(battery_threshold=0.99999, max_rounds=4,
                            levels=(1.0, 0.99999, 1.0))),
    "lstm-fp32-enfed2": ("lstm", True, None, 2, False, {}),
    "lstm-auto": ("lstm", True, "auto", None, True, {}),
}


def _run_case(name):
    """Both engines on one case, run once per module."""
    if name in _RUNS:
        return _RUNS[name]
    kind, part, compress, k, encrypt, over = CASES[name]
    over = dict(over)
    levels = over.pop("levels", None)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", part)
    try:
        jtask, _, _ = _world(kind)
        common = dict(desired_accuracy=1.01, max_rounds=3, n_max=3, epochs=2, batch_size=16,
                      encrypt=encrypt, compress=compress)
        common.update(over)
        jstrat = None if k is None else jtopology.AggregationStrategy(kind="enfed",
                                                                      neighborhood_size=k)
        tstrat = None if k is None else tcore.AggregationStrategy(kind="enfed",
                                                                  neighborhood_size=k)
        jspecs = _specs(jcore, kind, levels, lambda p: p)
        jres = jcore.run_fleet(jtask, jspecs, jcore.EnFedConfig(**common, strategy=jstrat))
        tspecs = _specs(tcore, kind, levels, lambda p: from_jax_params(_np_tree(p), CPU))
        tres = tcore.run_fleet(_port_task(kind, part), tspecs,
                               tcore.EnFedConfig(**common, strategy=tstrat), device="cpu")
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    _RUNS[name] = (jres, tres, jspecs, tspecs)
    return _RUNS[name]


def _assert_trees_close(jtree, ttree, **tol):
    jt, tt = _np_tree(jtree), to_numpy(ttree)
    assert set(jt) == set(tt)
    for k in jt:
        if isinstance(jt[k], dict):
            _assert_trees_close(jt[k], ttree[k], **tol)
        else:
            np.testing.assert_allclose(tt[k], jt[k], err_msg=k, **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_fleet_matches_jax_fleet(name):
    jres, tres, jspecs, tspecs = _run_case(name)
    kind, _, compress, _, _, _ = CASES[name]
    num_params = sum(int(np.size(v)) for v in jax.tree_util.tree_leaves(_world(kind)[2][0]))
    tol = INT8_TOL if resolve_compress(compress, num_params) == "int8" else PARAM_TOL
    # exact
    assert np.array_equal(tres.rounds, np.asarray(jres.rounds))
    assert np.array_equal(tres.stop_codes, np.asarray(jres.stop_codes))
    assert np.array_equal(tres.history["round_executed"],
                          np.asarray(jres.history["round_executed"]))
    assert np.array_equal(tres.history["executed"], np.asarray(jres.history["executed"]))
    assert tres.staged_param_bytes == jres.staged_param_bytes
    assert tres.device_round_state_bytes == jres.device_round_state_bytes
    for js, ts in zip(jres.sessions, tres.sessions):
        assert (ts.rounds, ts.stop_reason, ts.n_contributors, ts.model_bytes) == \
            (js.rounds, js.stop_reason, js.n_contributors, js.model_bytes)
        assert ts.history_raw["round_executed"] == js.history_raw["round_executed"]
        np.testing.assert_allclose(ts.history_raw["accuracy"], js.history_raw["accuracy"],
                                   atol=ACC_ATOL, rtol=0)
        np.testing.assert_allclose(ts.history_raw["battery"], js.history_raw["battery"],
                                   rtol=BATTERY_RTOL)
        assert ts.report.e_comm == js.report.e_comm
        _assert_trees_close(js.params, ts.params, **tol)
    np.testing.assert_allclose(tres.accuracy, np.asarray(jres.accuracy), atol=ACC_ATOL, rtol=0)
    np.testing.assert_allclose(tres.battery_level, np.asarray(jres.battery_level),
                               rtol=BATTERY_RTOL)
    np.testing.assert_allclose(tres.total_energy_j, jres.total_energy_j, rtol=1e-12)
    # write-back of the refreshed contributors
    for jsp, tsp in zip(jspecs, tspecs):
        for did, st in jsp.contributor_states.items():
            _assert_trees_close(st["params"], tsp.contributor_states[did]["params"], **tol)


def test_early_exit_runs_only_the_rounds_the_reference_runs():
    jres, tres, _, _ = _run_case("mlp-early-exit")
    assert tres.history["round_executed"].tolist() == [1.0, 1.0, 1.0, 0.0]
    assert tres.rounds.tolist() == [3, 1, 3]
    assert [s.stop_reason for s in tres.sessions] == ["battery_low"] * 3
    assert np.array_equal(tres.history["round_executed"],
                          np.asarray(jres.history["round_executed"]))


def test_int8_state_is_staged_in_wire_format():
    _, tres, _, _ = _run_case("lstm-auto")
    _, fres, _, _ = _run_case("lstm-fp32-enfed2")
    p = sum(v.numel() for v in tree_leaves(tres.sessions[0].params))
    lp = p + (-p) % 1024
    assert tres.staged_param_bytes == 3 * 3 * (lp + 4 * lp // 1024)
    assert fres.staged_param_bytes == 3 * 3 * 4 * p
    assert tres.sessions[0].model_bytes == lp + 4 * lp // 1024


# ---------------------------------------------------------------------------
# the port's fleet against the port's loop engine
# ---------------------------------------------------------------------------


def _one_lane_world(compress):
    _, shards, init = _world("mlp")
    task = _port_task("mlp", True)
    fleet = tcore.make_fleet(3, seed=1, p_has_model=1.0)
    for d in fleet:
        d.reservation_price = 0.4

    def states():
        return {d.device_id: {"params": from_jax_params(_np_tree(init[i]), CPU),
                              "data": shards[3 + i]} for i, d in enumerate(fleet)}
    sx, sy = shards[1]
    n = int(len(sx) * 0.8)
    cfg = tcore.EnFedConfig(desired_accuracy=1.01, max_rounds=3, n_max=3, epochs=2,
                            batch_size=16, compress=compress)
    return task, (sx[:n], sy[:n]), (sx[n:], sy[n:]), fleet, states, cfg


@pytest.mark.parametrize("compress", [None, "int8"])
def test_one_lane_fleet_matches_the_loop_engine(compress):
    task, train, test, fleet, states, cfg = _one_lane_world(compress)
    loop_states, fleet_states = states(), states()
    loop = tcore.EnFedSession(task, train, test, fleet, loop_states, cfg, device=CPU).run()
    session = tcore.EnFedSession(task, train, test, fleet, fleet_states, cfg, device=CPU)
    one = session.run(engine="fleet")
    tol = INT8_TOL if compress else PARAM_TOL
    assert (one.rounds, one.stop_reason, one.model_bytes, one.n_contributors) == \
        (loop.rounds, loop.stop_reason, loop.model_bytes, loop.n_contributors)
    assert one.history_raw["round_executed"] == loop.history_raw["round_executed"]
    np.testing.assert_allclose(one.history_raw["accuracy"], loop.history_raw["accuracy"],
                               atol=ACC_ATOL, rtol=0)
    np.testing.assert_allclose(one.history_raw["battery"], loop.history_raw["battery"],
                               rtol=BATTERY_RTOL)
    assert session.battery.level == one.battery.level
    for a, b in zip(tree_leaves(one.params), tree_leaves(loop.params)):
        torch.testing.assert_close(a, b, **tol)
    # the refreshed contributors written back equal the loop engine's
    for did in loop_states:
        for a, b in zip(tree_leaves(fleet_states[did]["params"]),
                        tree_leaves(loop_states[did]["params"])):
            torch.testing.assert_close(a, b, **tol)


def test_fleet_write_back_holds_refreshed_contributors():
    task, train, test, fleet, states, cfg = _one_lane_world(None)
    st = states()
    before = {d: [t.clone() for t in tree_leaves(v["params"])] for d, v in st.items()}
    tcore.run_fleet(task, [tcore.RequesterSpec(train, test, fleet, st)], cfg, device="cpu")
    for d, leaves in before.items():
        after = tree_leaves(st[d]["params"])
        assert any(not torch.equal(a, b) for a, b in zip(after, leaves))
    no_refresh = dataclasses.replace(cfg, contributor_refresh_epochs=0)
    st = states()
    ids = {d: id(v["params"]) for d, v in st.items()}
    tcore.run_fleet(task, [tcore.RequesterSpec(train, test, fleet, st)], no_refresh,
                    device="cpu")
    assert {d: id(v["params"]) for d, v in st.items()} == ids


_AC = tcore.AdversaryConfig(p_byzantine=0.5)
_MOB = tcore.MobilityConfig(radio_range_m=110.0, leg_rounds=2, seed=3)
_FC = tcore.FaultConfig(p_drop=0.5, p_stale=0.4, max_retries=1, release_after=2, seed=3)
_CC = tcore.CadenceConfig(n_speed_classes=2, duty_cycle=3, duty_on=2, p_offline=0.15, seed=3)


@pytest.mark.parametrize("knob,kwargs", [
    (dict(mobility=_MOB, cadence=_CC), {}), (dict(cadence=_CC), {}),
    (dict(adversary=_AC, robust="clip", cadence=_CC), {}),
    # under a baseline method: the profiler fields
    ({}, dict(method="dfl", trace=TraceConfig(hlo_stats=True))),
    ({}, dict(method="cfl", trace=TraceConfig(jax_profiler_dir="prof"))),
    ({}, dict(trace=TraceConfig(jax_profiler_dir="prof"))),
    ({}, dict(trace=TraceConfig(hlo_stats=True)))])
def test_unported_fleet_knobs_raise_naming_their_slice(knob, kwargs, tmp_path):
    """No knob is refused any more.  The profiler fields, which raised
    naming slice F before it, run: the traced run equals the untraced one
    bit for bit (params, traces, battery), ``hlo_stats`` holds the
    program's work and memory, and the profiler writes its trace.  The
    cadence cases run alone, under mobility and with the adversary (held to
    the reference in ``tests/test_torch_cadence_engines.py``)."""
    task, train, test, fleet, states, cfg = _one_lane_world(None)
    cfg = dataclasses.replace(cfg, **knob)
    trace = kwargs.get("trace")
    if trace is not None and trace.jax_profiler_dir:
        kwargs = dict(kwargs, trace=dataclasses.replace(
            trace, jax_profiler_dir=str(tmp_path / trace.jax_profiler_dir)))

    def run(**over):
        return tcore.run_fleet(task, [tcore.RequesterSpec(train, test, fleet, states())], cfg,
                               device="cpu", **dict(kwargs, **over))

    if "cadence" not in knob:
        res, plain = run(), run(trace=None)
        for a, b in zip(tree_leaves(res.sessions[0].params), tree_leaves(plain.sessions[0].params)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert set(res.history) == set(plain.history)
        for k in res.history:
            np.testing.assert_array_equal(res.history[k], plain.history[k])
        np.testing.assert_array_equal(res.battery_level, plain.battery_level)
        assert plain.hlo_stats is None
        if trace.hlo_stats:
            assert {"flops", "bytes_accessed", "transcendentals", "torch_matmul_flops",
                    "per_kernel", "memory"} <= set(res.hlo_stats)
            assert res.hlo_stats["per_kernel"]["fedavg"]["launches"] > 0
            assert res.hlo_stats["memory"]["staged_bytes"] == res.staged_param_bytes
        else:
            assert res.hlo_stats is None
            assert list((tmp_path / "prof").glob("*.pt.trace.json"))
        return
    res = run()
    s0 = res.sessions[0]
    assert s0.rounds == cfg.max_rounds and np.isfinite(res.accuracy).all()
    assert res.history["round_clock"].shape == (cfg.max_rounds, 1)
    assert res.history["round_executed"].shape == (
        tcore.cadence.events_budget(_CC, cfg.max_rounds),)
    assert s0.history_raw["round_clock"] == sorted(set(s0.history_raw["round_clock"]))
    assert ("member_mask" in s0.history_raw) == ("mobility" in knob)


@pytest.mark.parametrize("knob,kwargs", [
    (dict(faults=_FC), {}), (dict(staleness_gamma=0.5), {}),
    (dict(adversary=_AC, faults=_FC), {}),
    (dict(adversary=_AC, mobility=_MOB), dict(checkpoint_dir="ckpt")),
    # under a baseline method: the faults' retries are priced
    (dict(faults=_FC), dict(method="dfl")), (dict(faults=_FC), dict(method="cfl")),
    ({}, dict(checkpoint_dir="ckpt")), ({}, dict(resume_from="ckpt"))])
def test_fleet_knobs_of_the_fault_slice_run(knob, kwargs, tmp_path):
    """The knobs the fault slice ported run where the fleet refused them
    before: faults alone or with the adversary, the decay, a checkpointing
    run (one file per chunk), a resumed run (the bits of the straight
    run), and the baselines' fault pricing (``fault_extra_tx``)."""
    task, train, test, fleet, states, cfg = _one_lane_world(None)
    cfg = dataclasses.replace(cfg, **knob)

    def run(**kw):
        return tcore.run_fleet(task, [tcore.RequesterSpec(train, test, fleet, states())], cfg,
                               device="cpu", **kw)

    ckpt = str(tmp_path / "ckpt")
    if "resume_from" in kwargs:
        straight = run(round_chunk=1, checkpoint_dir=ckpt)
        for f in os.listdir(ckpt):
            if int(f[5:13]) > 1:
                os.remove(os.path.join(ckpt, f))
        res = run(round_chunk=1, resume_from=ckpt)
        assert torch.equal(tree_ravel(res.sessions[0].params)[0],
                           tree_ravel(straight.sessions[0].params)[0])
        assert res.battery_level.tolist() == straight.battery_level.tolist()
    else:
        res = run(**{k: ckpt if k == "checkpoint_dir" else v for k, v in kwargs.items()})
    s0 = res.sessions[0]
    assert s0.rounds == cfg.max_rounds and np.isfinite(res.accuracy).all()
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(s0.params))
    if "checkpoint_dir" in kwargs:
        assert os.listdir(ckpt) == ["step_00000004.npz"]     # one chunk of 4 rounds
    if kwargs.get("method") in ("cfl", "dfl"):
        assert s0.history_raw["fault_extra_tx"] > 0
    elif "faults" in knob:
        assert len(s0.history_raw["deliver_mask"]) == s0.rounds


@pytest.mark.parametrize("method", ["enfed", "cfl", "dfl"])
def test_fleet_accepts_a_timeline_and_records_its_spans(method):
    """``timeline`` and a TraceConfig of exports are accepted (the exports
    are written by ``Experiment.run``); the run records the stage, the round
    loop and the unpack, and its outcome is the untimed run's bits."""
    task, train, test, fleet, states, cfg = _one_lane_world(None)
    tl = Timeline()
    runs = [tcore.run_fleet(task, [tcore.RequesterSpec(train, test, fleet, states())], cfg,
                            method=method, device="cpu", **kw)
            for kw in ({}, dict(timeline=tl, trace=TraceConfig(events_jsonl="x.jsonl")))]
    assert runs[1].timeline is tl and runs[1].hlo_stats is None
    assert [sp.name for sp in tl.spans if sp.depth == 0] == ["stage", "program", "unpack"]
    assert all(sp.dur >= 0 for sp in tl.spans)
    for a, b in zip(tree_leaves(runs[0].sessions[0].params),
                    tree_leaves(runs[1].sessions[0].params)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("knob,match", [
    (dict(round_chunk=0), "round_chunk"), (dict(checkpoint_every=-1), "checkpoint_every"),
    (dict(interpret=True), "use_pallas=False")])
def test_fleet_validates_its_execution_knobs(knob, match):
    task, train, test, fleet, states, cfg = _one_lane_world(None)
    with pytest.raises(ValueError, match=match):
        tcore.run_fleet(task, [tcore.RequesterSpec(train, test, fleet, states())], cfg,
                        device="cpu", **knob)


def test_fleet_without_device_raises_on_a_host_without_gpu(monkeypatch):
    task, train, test, fleet, states, cfg = _one_lane_world(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.run_fleet(task, [tcore.RequesterSpec(train, test, fleet, states())], cfg)


def test_lane_plans_equal_per_lane_plans():
    from repro_torch.core import schedule

    scores = schedule.epoch_scores(7, 3, 50)
    n = [50, 33, 9]
    idx, w = schedule.lane_plans(scores, n, 16, 3)
    for i, ni in enumerate(n):
        ii, wi = schedule.plan_from_scores(scores, ni, 16, 3)
        assert torch.equal(idx[i], ii) and torch.equal(w[i], wi)
    per_lane = torch.stack([schedule.epoch_scores(s, 2, 40) for s in (1, 2)])
    idx, w = schedule.lane_plans(per_lane, [40, 20], 8, 5)
    for i, ni in enumerate([40, 20]):
        ii, wi = schedule.plan_from_scores(per_lane[i], ni, 8, 5)
        assert torch.equal(idx[i], ii) and torch.equal(w[i], wi)


def test_battery_discharge_on_lane_tensors_matches_floats():
    levels = torch.tensor([1.0, 0.5, 0.001], dtype=torch.float64)
    got = tcore.battery.discharge_level(levels, torch.tensor(100.0, dtype=torch.float64),
                                        40e3, 1.15)
    want = [tcore.battery.discharge_level(float(v), 100.0, 40e3, 1.15) for v in levels]
    assert got.tolist() == want
    assert BatteryState().discharge(100.0, 5.0).level == want[0]
