"""EnFedSession of the port against the JAX loop engine on the CPU, and the
copied protocol modules (incentive, energy, battery, topology) against
their originals."""

import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import battery as jbattery  # noqa: E402
from repro.core import crypto as jcrypto  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import incentive as jincentive  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.models import (LSTMClassifier as JLSTM, LSTMClassifierConfig as JLSTMConfig,  # noqa: E402
                          MLPClassifier as JMLP, MLPClassifierConfig as JMLPConfig)
from repro.utils.tree import flatten_to_vector as jflatten  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import battery, crypto, energy, incentive, protocol, topology  # noqa: E402
from repro_torch.data import (CaloriesDatasetConfig, HARDatasetConfig,  # noqa: E402
                              dirichlet_partition, make_calories_tabular,
                              make_har_windows)
from repro_torch.models import (LSTMClassifier, LSTMClassifierConfig,  # noqa: E402
                                MLPClassifier, MLPClassifierConfig)
from repro_torch.utils.tree import flatten_to_vector, from_jax_params, to_numpy  # noqa: E402

CPU = torch.device("cpu")
# two rounds of Adam fits and refreshes: fp32 rounding in another order
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
LOSS_RTOL = 1e-5
# the battery is host float arithmetic on identical inputs
BATTERY_RTOL = 1e-12
REPORT_FIELDS = ("t_dev", "t_hand", "t_key", "t_init", "t_com", "t_enc", "t_dec", "t_agg")

_WORLDS = {}


def _world(kind):
    """Data, the JAX task (jit caches shared across cases) and the
    contributors' initial params (JAX arrays), built once per model."""
    if kind not in _WORLDS:
        if kind == "lstm":
            x, y, _ = make_har_windows(HARDatasetConfig(num_samples=200, seq_len=8))
            jtask = jcore.SupervisedTask(JLSTM(JLSTMConfig(input_dim=6, seq_len=8, hidden=16,
                                                           num_classes=6)), lr=3e-3)
        else:
            x, y = make_calories_tabular(CaloriesDatasetConfig(num_samples=300))
            jtask = jcore.SupervisedTask(JMLP(JMLPConfig(input_dim=8, hidden=(16, 8),
                                                         num_classes=5)), lr=3e-3)
        parts = dirichlet_partition(y, num_clients=4, alpha=1.0, seed=0)
        shards = [(x[p], y[p]) for p in parts]
        n = int(len(shards[0][0]) * 0.8)
        own_train = (shards[0][0][:n], shards[0][1][:n])
        own_test = (shards[0][0][n:], shards[0][1][n:])
        init = [jtask.init(seed=10 + i) for i in range(3)]
        _WORLDS[kind] = (jtask, shards, own_train, own_test, init)
    return _WORLDS[kind]


def _port_task(kind, partitionable):
    if kind == "lstm":
        model = LSTMClassifier(LSTMClassifierConfig(input_dim=6, seq_len=8, hidden=16),
                               device=CPU)
    else:
        model = MLPClassifier(MLPClassifierConfig(input_dim=8, hidden=(16, 8)), device=CPU)
    return tcore.SupervisedTask(model, lr=3e-3, threefry_partitionable=partitionable)


def _fleets():
    jf = jcore.make_fleet(3, seed=1, p_has_model=1.0)
    tf = tcore.make_fleet(3, seed=1, p_has_model=1.0)
    for d in jf + tf:
        d.reservation_price = 0.4
    return jf, tf


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(jtree, ttree, **tol):
    jt, tt = _np_tree(jtree), to_numpy(ttree)
    for k in jt:
        if isinstance(jt[k], dict):
            _assert_trees_close(jt[k], ttree[k], **tol)
        else:
            np.testing.assert_allclose(tt[k], jt[k], err_msg=k, **tol)


SESSION_CASES = [
    # kind, partitionable, encrypt, strategy kind, desired accuracy
    ("lstm", True, True, None, 1.01),
    ("lstm", False, True, None, 1.01),
    ("lstm", True, False, "dfl_ring", 1.01),
    ("lstm", False, False, "dfl_ring", 1.01),
    ("mlp", True, True, None, 1.01),
    ("mlp", False, True, None, 1.01),
    ("mlp", True, False, "dfl_ring", 1.01),
    ("mlp", False, True, "enfed", 0.0),      # stops on accuracy in round 1
]


@pytest.mark.parametrize("kind,partitionable,encrypt,strategy,desired", SESSION_CASES)
def test_session_matches_jax_loop_engine(kind, partitionable, encrypt, strategy, desired):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        jtask, shards, own_train, own_test, init = _world(kind)
        jfleet, tfleet = _fleets()
        jstates = {d.device_id: {"params": init[i], "data": shards[i + 1]}
                   for i, d in enumerate(jfleet)}
        tstates = {d.device_id: {"params": from_jax_params(_np_tree(init[i]), CPU),
                                 "data": shards[i + 1]}
                   for i, d in enumerate(tfleet)}
        tinit = {k: v["params"] for k, v in tstates.items()}
        common = dict(desired_accuracy=desired, max_rounds=2, n_max=3, epochs=2,
                      batch_size=16, encrypt=encrypt)
        jcfg = jcore.EnFedConfig(**common, strategy=None if strategy is None else
                                 jtopology.AggregationStrategy(kind=strategy, neighborhood_size=2))
        tcfg = tcore.EnFedConfig(**common, strategy=None if strategy is None else
                                 tcore.AggregationStrategy(kind=strategy, neighborhood_size=2))
        js = jcore.EnFedSession(jtask, own_train, own_test, jfleet, jstates, jcfg)
        ts = tcore.EnFedSession(_port_task(kind, partitionable), own_train, own_test, tfleet,
                                tstates, tcfg, device=CPU)
        jr, tr = js.run(engine="loop"), ts.run()

        # exact
        assert (tr.rounds, tr.stop_reason, tr.n_contributors, tr.model_bytes) == \
            (jr.rounds, jr.stop_reason, jr.n_contributors, jr.model_bytes)
        assert tr.history_raw["round_executed"] == jr.history_raw["round_executed"]
        assert tr.history_raw["accuracy"] == pytest.approx(jr.history_raw["accuracy"], abs=1e-6)
        for f in REPORT_FIELDS:
            assert getattr(tr.report.times, f) == getattr(jr.report.times, f), f
        assert tr.report.e_comm == jr.report.e_comm
        # one update's ciphertext, byte for byte, under the session's keys
        did = jfleet[0].device_id
        assert np.array_equal(js.keys[did], ts.keys[did])
        assert np.array_equal(js.nonces[did], ts.nonces[did])
        jc = jcrypto.encrypt_update(jflatten(init[0])[0], js.keys[did], js.nonces[did])
        tc = crypto.encrypt_update(flatten_to_vector(tinit[did])[0], ts.keys[did], ts.nonces[did])
        assert np.array_equal(np.asarray(jc), tc.numpy())
        # allclose
        np.testing.assert_allclose(tr.history_raw["loss"], jr.history_raw["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(tr.history_raw["battery"], jr.history_raw["battery"],
                                   rtol=BATTERY_RTOL)
        np.testing.assert_allclose(tr.battery.level, jr.battery.level, rtol=BATTERY_RTOL)
        _assert_trees_close(jr.params, tr.params, **PARAM_TOL)
        for d in jfleet:
            _assert_trees_close(jstates[d.device_id]["params"],
                                tstates[d.device_id]["params"], **PARAM_TOL)
        assert set(tr.phase_s) >= {"collect", "aggregate", "fit", "score"}
    finally:
        jax.config.update("jax_threefry_partitionable", old)


INT8_CASES = [
    # kind, partitionable, encrypt, compress
    ("lstm", True, True, "int8"),
    ("lstm", False, False, "auto"),      # P = 1,574 resolves to int8
    ("mlp", True, False, "int8"),
    ("mlp", True, True, "int8"),
]
# the per-tile scale bound of tests/test_compress.py: a code may flip where
# fp32 rounding moves a refreshed value across a rounding boundary
INT8_PARAM_ATOL = 1e-2


@pytest.mark.parametrize("kind,partitionable,encrypt,compress", INT8_CASES)
def test_int8_session_matches_jax_loop_engine(kind, partitionable, encrypt, compress):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        jtask, shards, own_train, own_test, init = _world(kind)
        jfleet, tfleet = _fleets()

        def worlds():
            js = {d.device_id: {"params": init[i], "data": shards[i + 1]}
                  for i, d in enumerate(jfleet)}
            ts = {d.device_id: {"params": from_jax_params(_np_tree(init[i]), CPU),
                                "data": shards[i + 1]} for i, d in enumerate(tfleet)}
            return js, ts

        common = dict(desired_accuracy=1.01, max_rounds=2, n_max=3, epochs=2,
                      batch_size=16, encrypt=encrypt, compress=compress)
        jstates, tstates = worlds()
        js = jcore.EnFedSession(jtask, own_train, own_test, jfleet, jstates,
                                jcore.EnFedConfig(**common))
        ts = tcore.EnFedSession(_port_task(kind, partitionable), own_train, own_test, tfleet,
                                tstates, tcore.EnFedConfig(**common), device=CPU)
        jr, tr = js.run(engine="loop"), ts.run()
        assert ts._compress == js._compress == "int8"
        assert (tr.rounds, tr.stop_reason, tr.n_contributors, tr.model_bytes) == \
            (jr.rounds, jr.stop_reason, jr.n_contributors, jr.model_bytes)
        assert tr.history_raw["round_executed"] == jr.history_raw["round_executed"]
        assert tr.history_raw["accuracy"] == pytest.approx(jr.history_raw["accuracy"], abs=1e-6)
        np.testing.assert_allclose(tr.history_raw["battery"], jr.history_raw["battery"],
                                   rtol=BATTERY_RTOL)
        _assert_trees_close(jr.params, tr.params, rtol=0, atol=INT8_PARAM_ATOL)
        for d in jfleet:
            _assert_trees_close(jstates[d.device_id]["params"],
                                tstates[d.device_id]["params"], rtol=0, atol=INT8_PARAM_ATOL)
        # the staged wire payload and its AES ciphertext, byte for byte
        jstates, tstates = worlds()
        jh = jcore.EnFedSession(jtask, own_train, own_test, jfleet, jstates,
                                jcore.EnFedConfig(**common))
        th = tcore.EnFedSession(_port_task(kind, partitionable), own_train, own_test, tfleet,
                                tstates, tcore.EnFedConfig(**common), device=CPU)
        jh.handshake()
        th.handshake()
        for d in jfleet:
            did = d.device_id
            (jq, jsc, jn), (tq, tsc, tn) = jh._wire[did], th._wire[did]
            assert jn == tn
            assert np.array_equal(np.asarray(jq), tq.numpy())
            assert np.array_equal(np.asarray(jsc), tsc.numpy())
            jpay = np.concatenate([np.asarray(jq).view(np.uint8),
                                   np.asarray(jcrypto.float_vector_to_bytes(jsc))])
            tpay = torch.cat([tq.view(torch.uint8), crypto.float_vector_to_bytes(tsc)])
            jc = jcrypto.encrypt_bytes(jax.numpy.asarray(jpay), jh.keys[did], jh.nonces[did])
            tc = crypto.encrypt_bytes(tpay, th.keys[did], th.nonces[did])
            assert np.array_equal(np.asarray(jc), tc.numpy())
            upd, nbytes = th._collect_update(did)
            assert nbytes == tr.model_bytes
    finally:
        jax.config.update("jax_threefry_partitionable", old)


_AC = tcore.AdversaryConfig(p_byzantine=0.5)
_MOB = tcore.MobilityConfig(radio_range_m=110.0, leg_rounds=2, seed=3)
_FC = tcore.FaultConfig(p_drop=0.5, p_stale=0.4, max_retries=1, release_after=2, seed=3)
_CC = tcore.CadenceConfig(n_speed_classes=2, duty_cycle=3, duty_on=2, p_offline=0.15, seed=3)


def _mlp_session(cfg):
    _, shards, own_train, own_test, _ = _world("mlp")
    _, tfleet = _fleets()
    task = _port_task("mlp", True)
    states = {d.device_id: {"params": task.init(i), "data": shards[i + 1]}
              for i, d in enumerate(tfleet)}
    return tcore.EnFedSession(task, own_train, own_test, tfleet, states, cfg, device=CPU)


@pytest.mark.parametrize("knob", [
    dict(cadence=_CC), dict(adversary=_AC, robust="clip", cadence=_CC)])
def test_unported_knobs_raise_naming_their_slice(knob):
    """The knobs the session refused before the cadence slice, naming it,
    run now (held to the reference in ``tests/test_torch_cadence_engines.py``):
    the requester's round clock runs on event steps, idle steps priced."""
    cfg = tcore.EnFedConfig(max_rounds=2, epochs=1, desired_accuracy=1.01, **knob)
    res = _mlp_session(cfg).run()
    assert res.rounds == 2 and np.isfinite(res.history_raw["accuracy"]).all()
    clock = res.history_raw["round_clock"]
    assert len(clock) == 2 and clock[0] < clock[1]
    assert sum(res.history_raw["idle_steps"]) == clock[1] - 1
    assert ("clipped_mask" in res.history_raw) == ("robust" in knob)


@pytest.mark.parametrize("knob", [
    dict(mobility=_MOB, faults=_FC), dict(faults=_FC), dict(staleness_gamma=0.5),
    dict(adversary=_AC, faults=_FC),
    dict(adversary=_AC, robust="median", mobility=_MOB, staleness_gamma=0.5),
    dict(adversary=_AC, robust="trimmed_mean", staleness_gamma=0.5),
    dict(faults=_FC, compress="auto", staleness_gamma=0.5)])
def test_knobs_of_the_fault_slice_run(knob):
    """The knobs the session refused before the fault slice run (they are
    held to the reference in ``tests/test_torch_faults_engines.py``)."""
    cfg = tcore.EnFedConfig(max_rounds=2, epochs=1, desired_accuracy=1.01, **knob)
    res = _mlp_session(cfg).run()
    assert res.rounds == 2 and np.isfinite(res.history_raw["accuracy"]).all()
    assert ("deliver_mask" in res.history_raw) == ("faults" in knob)


@pytest.mark.parametrize("kwargs", [dict(engine="fleet", checkpoint_dir="ckpt"),
                                    dict(checkpoint_dir="ckpt"), dict(resume_from="ckpt")])
def test_fleet_engine_and_checkpoints_run(kwargs, tmp_path):
    """Checkpointing on either engine writes the round state (every round
    on the loop, every chunk on the fleet); a resumed loop session gives the
    straight session's bits."""
    cfg = tcore.EnFedConfig(max_rounds=2, epochs=1, desired_accuracy=1.01)
    ckpt = str(tmp_path / "ckpt")
    kw = {k: ckpt if k in ("checkpoint_dir", "resume_from") else v for k, v in kwargs.items()}
    if "resume_from" in kw:
        straight = _mlp_session(cfg).run(checkpoint_dir=ckpt)
        os.remove(os.path.join(ckpt, "step_00000002.npz"))
        res = _mlp_session(cfg).run(**kw)
        assert torch.equal(flatten_to_vector(res.params)[0],
                           flatten_to_vector(straight.params)[0])
        assert res.history_raw["battery"] == straight.history_raw["battery"]
        return
    res = _mlp_session(cfg).run(**kw)
    assert res.rounds == 2
    want = ["step_00000004.npz"] if kw.get("engine") == "fleet" else [
        "step_00000001.npz", "step_00000002.npz"]
    assert sorted(os.listdir(ckpt)) == want


def test_session_rejects_a_task_on_another_device():
    task = _port_task("mlp", True)
    with pytest.raises(ValueError, match="runs on"):
        tcore.EnFedSession(task, None, None, [], {}, device="meta")


# ---------------------------------------------------------------------------
# copied protocol modules
# ---------------------------------------------------------------------------


def test_fleet_and_contracts_match_reference():
    for seed in (0, 1, 7):
        jf = jcore.make_fleet(8, seed=seed)
        tf = tcore.make_fleet(8, seed=seed)
        assert [dataclasses.asdict(d) for d in jf] == [dataclasses.asdict(d) for d in tf]
        for inc, n_max in ((0.6, 5), (0.9, 3), (0.3, 8)):
            jc = jincentive.select_contributors(jf, inc, n_max)
            tc = incentive.select_contributors(tf, inc, n_max)
            assert [(c.device_id, c.incentive, c.utility) for c in jc] == \
                [(c.device_id, c.incentive, c.utility) for c in tc]


COST_ARGS = [
    dict(rounds=3, n_contrib=5, num_params=18566, model_bytes=74264, num_samples=177,
         epochs=8, n_devices=5, measured_local_time=1.25, encrypt=True),
    dict(rounds=1, n_contrib=2, num_params=229, model_bytes=916, num_samples=40,
         epochs=2, n_devices=3, encrypt=False),
    dict(rounds=10, n_contrib=0, num_params=1000, model_bytes=4000, num_samples=10,
         epochs=1, encrypt=True),
]


@pytest.mark.parametrize("args", COST_ARGS)
def test_cost_model_matches_reference_to_the_float(args):
    dev = dict(p_train=4.5, flops=6e9)
    jcm = jenergy.CostModel(jenergy.DeviceProfile(**dev))
    tcm = energy.CostModel(energy.DeviceProfile(**dev))
    jr, tr = jcm.session(**args), tcm.session(**args)
    assert dataclasses.asdict(jr.times) == dataclasses.asdict(tr.times)
    assert (jr.e_comp, jr.e_comm, jr.e_tot, jr.t_train) == \
        (tr.e_comp, tr.e_comm, tr.e_tot, tr.t_train)
    round_args = {k: v for k, v in args.items() if k not in ("rounds", "measured_local_time")}
    assert jcm.round_energy(**round_args) == tcm.round_energy(**round_args)


def test_wire_bytes_and_battery_match_reference():
    for n, enc, raw in ((18566, True, None), (229, False, 916), (10, False, None)):
        assert energy.update_wire_bytes(n, encrypt=enc, raw_bytes=raw) == \
            jenergy.update_wire_bytes(n, encrypt=enc, raw_bytes=raw)
    for n, mode in ((100, "int8"), (18566, "auto"), (229, "auto")):
        assert energy.update_wire_bytes(n, compress=mode) == \
            jenergy.update_wire_bytes(n, compress=mode)
    jb, tb = jbattery.BatteryState(), battery.BatteryState()
    for e, p in ((120.0, 5.0), (3.5, 1.0), (50000.0, 5.0)):
        jb, tb = jb.discharge(e, avg_power_w=p), tb.discharge(e, avg_power_w=p)
        assert (jb.level, jb.below(0.2), jb.percent) == (tb.level, tb.below(0.2), tb.percent)
    assert battery.discharge_level(0.01, 10.0, 100.0) == 0.0


@pytest.mark.parametrize("kind,k", [("cfl", 0), ("dfl_mesh", 0), ("dfl_ring", 0),
                                    ("enfed", 0), ("enfed", 2), ("none", 0)])
def test_round_weights_match_reference(kind, k):
    jstrat = jtopology.AggregationStrategy(kind=kind, neighborhood_size=k)
    tstrat = topology.AggregationStrategy(kind=kind, neighborhood_size=k)
    for n in range(0, 6):
        assert np.array_equal(protocol.round_weights(n, tstrat),
                              jcore.protocol.round_weights(n, jstrat))
    assert protocol.STOP_REASONS == jcore.protocol.STOP_REASONS
