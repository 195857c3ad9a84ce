"""``repro_torch.telemetry`` on the CPU, case by case the twin of
``tests/test_telemetry.py`` wherever the world is ported: observation never
changes the outcome (a traced run is bitwise the untraced one, on both
engines, in the static, mobility, fault, cadence and Byzantine worlds), the two engines' event
streams on one world are equal, the exporters round-trip schema-valid (a
Byzantine log included), the Timeline span stack behaves, and each engine
records its spans.  The cadence world's events carry the lanes' clocks
and idle steps, and the lockstep worlds leave them None.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.api import ExecutionSpec, Experiment, MethodSpec, WorldSpec
from repro_torch.core import (AdversaryConfig, CadenceConfig, FaultConfig, MobilityConfig,
                              SupervisedTask, make_fleet)
from repro_torch.data import CaloriesDatasetConfig, dirichlet_partition, make_calories_tabular
from repro_torch.models import MLPClassifier, MLPClassifierConfig
from repro_torch.telemetry import (EVENT_PHASES, RoundEvent, Timeline, TraceConfig,
                                   compare_event_streams, read_events_jsonl,
                                   timeline_chrome_trace, validate_events, write_chrome_trace,
                                   write_events_jsonl)
from repro_torch.utils.tree import tree_leaves

CPU = torch.device("cpu")
BATCH = 16

_METHOD = MethodSpec(desired_accuracy=0.99, max_rounds=2, epochs=1, batch_size=BATCH,
                     encrypt=False, contributor_refresh_epochs=1)
_ADVERSARY = AdversaryConfig(p_byzantine=0.5, attack="noise", scale=10.0, seed=7)
_MOB = MobilityConfig(radio_range_m=95.0, leg_rounds=1, seed=5)
_FAULTS = FaultConfig(p_drop=0.6, p_stale=0.4, max_retries=1, release_after=2, seed=3)
# the problem's task pins the threefry mode (partitionable=True), under
# which seed 3 puts the requester on stride 2 of 2 (the reference's seed 0
# does so under False): real idle steps between rounds
_CADENCE = CadenceConfig(n_speed_classes=2, seed=3)

# world name -> (mobility, method): the weather regimes the house rule is
# enforced on
_WORLDS = {
    "static": (None, _METHOD),
    "mobility": (_MOB, dataclasses.replace(_METHOD, desired_accuracy=0.999, max_rounds=4,
                                           n_max=2)),
    "faults": (None, dataclasses.replace(_METHOD, desired_accuracy=0.999, max_rounds=4,
                                         faults=_FAULTS)),
    "cadence": (None, dataclasses.replace(_METHOD, desired_accuracy=0.999, max_rounds=3,
                                          cadence=_CADENCE)),
    "byzantine": (None, dataclasses.replace(_METHOD, desired_accuracy=1.01, max_rounds=3,
                                            adversary=_ADVERSARY, robust="clip")),
    "byzantine-int8": (None, dataclasses.replace(_METHOD, desired_accuracy=1.01, max_rounds=3,
                                                 adversary=_ADVERSARY, robust="clip",
                                                 compress="int8", encrypt=True)),
}

LOOP_SPANS = {"handshake", "transport", "fit", "refresh"}
FLEET_SPANS = {"stage", "program", "unpack"}


@pytest.fixture(scope="module")
def problem():
    """The reference's test world (calories MLP, 600 samples, 3
    contributors pretrained one epoch), in the port on the CPU."""
    x, y = make_calories_tabular(CaloriesDatasetConfig(num_samples=600))
    task = SupervisedTask(MLPClassifier(MLPClassifierConfig(8, (16,), 5), device=CPU),
                          lr=3e-3, threefry_partitionable=True)
    parts = dirichlet_partition(y, num_clients=4, alpha=100.0, seed=0)
    shards = [(x[p], y[p]) for p in parts]
    own_x, own_y = shards[0]
    n = int(len(own_x) * 0.8)
    fleet = make_fleet(3, seed=1, p_has_model=1.0)
    states = {}
    for i, dev in enumerate(fleet):
        dev.reservation_price = 0.4
        p, _ = task.fit(task.init(seed=10 + i), shards[i + 1], epochs=1, batch_size=BATCH,
                        seed=i)
        states[dev.device_id] = {"params": p, "data": shards[i + 1]}
    return task, (own_x[:n], own_y[:n]), (own_x[n:], own_y[n:]), fleet, states


def _world(problem, mobility=None):
    task, own_train, own_test, fleet, states = problem
    return WorldSpec.single(task, own_train, own_test, fleet, copy.deepcopy(states),
                            mobility=mobility, device="cpu")


def _assert_outcome_bitwise(a, b):
    """Two RunResults computed the identical simulation: params, every
    history buffer (masks, battery), rounds, stop reason."""
    assert a.rounds == b.rounds
    assert a.stop_reason == b.stop_reason
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert set(a.history_raw) == set(b.history_raw)
    for k in a.history_raw:
        ha, hb = a.history_raw[k], b.history_raw[k]
        assert len(ha) == len(hb), f"history[{k!r}] length"
        for r, (ra, rb) in enumerate(zip(ha, hb)):
            np.testing.assert_array_equal(np.asarray(ra), np.asarray(rb),
                                          err_msg=f"history[{k!r}][{r}]")


# ---------------------------------------------------------------------------
# the house rule: tracing on == tracing off, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world_name", ["static", "byzantine-int8", "mobility", "faults",
                                        "cadence"])
@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_trace_on_is_bitwise_identical_to_trace_off(problem, engine, world_name, tmp_path):
    mob, method = _WORLDS[world_name]
    trace = TraceConfig(events_jsonl=str(tmp_path / "events.jsonl"),
                        chrome_trace=str(tmp_path / "trace.json"))
    if engine == "fleet":
        # the fleet also runs its profiler hooks: torch.profiler and the
        # program-cost recorder around the program span
        trace = dataclasses.replace(trace, jax_profiler_dir=str(tmp_path / "prof"),
                                    hlo_stats=True)
    off = Experiment(_world(problem, mob), method, ExecutionSpec(engine=engine)).run()
    on = Experiment(_world(problem, mob), method,
                    ExecutionSpec(engine=engine, trace=trace)).run()
    _assert_outcome_bitwise(off, on)
    assert (tmp_path / "events.jsonl").exists()
    assert (tmp_path / "trace.json").exists()
    assert on.timings
    assert off.hlo_stats is None
    if engine == "loop":
        assert on.hlo_stats is None
    else:
        assert list((tmp_path / "prof").glob("*.pt.trace.json"))
        assert on.hlo_stats["per_kernel"]
        assert on.hlo_stats["flops"] == sum(
            k["flops"] for k in on.hlo_stats["per_kernel"].values())


# ---------------------------------------------------------------------------
# cross-engine event-stream equality
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world_name", list(_WORLDS))
def test_event_streams_equal_across_engines(problem, world_name):
    mob, method = _WORLDS[world_name]
    loop = Experiment(_world(problem, mob), method, ExecutionSpec(engine="loop")).run()
    fl = Experiment(_world(problem, mob), method, ExecutionSpec(engine="fleet")).run()
    assert compare_event_streams(validate_events(loop.trace), validate_events(fl.trace)) == []


@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_mobility_world_events_carry_the_member_sets(problem, engine):
    """Each round's renegotiated contract set surfaces as ``members`` and
    ``member_set`` (lane indices), and its wire bytes count the members;
    the static world leaves both None."""
    mob, method = _WORLDS["mobility"]
    res = Experiment(_world(problem, mob), method, ExecutionSpec(engine=engine)).run()
    rounds = [e for e in res.trace if e.phase == "round"]
    masks = res.history_raw["member_mask"]
    assert [e.member_set for e in rounds] == [
        tuple(int(i) for i in np.nonzero(np.asarray(m) > 0.5)[0]) for m in masks]
    assert [e.members for e in rounds] == [len(e.member_set) for e in rounds]
    assert len({e.member_set for e in rounds}) > 1, "the world must renegotiate"
    mb = res.sessions[0].model_bytes
    assert all(e.wire_bytes == mb * e.members for e in rounds)
    static = Experiment(_world(problem), _METHOD, ExecutionSpec(engine=engine)).run()
    assert all(e.members is None and e.member_set is None for e in static.trace)


@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_fault_world_events_carry_the_weather(problem, engine):
    """The fault world's drops, retries, stale counts and delivered sets
    surface in the normalized stream, not just in raw history, and the wire
    bytes follow the delivered count; the perfect-link world leaves the
    delivered set None."""
    _, method = _WORLDS["faults"]
    res = Experiment(_world(problem), method, ExecutionSpec(engine=engine)).run()
    rounds = [e for e in res.trace if e.phase == "round"]
    assert sum(e.drops for e in rounds) > 0 and sum(e.retries for e in rounds) > 0
    assert [e.delivered for e in rounds] == [
        tuple(int(i) for i in np.nonzero(np.asarray(m) > 0.5)[0])
        for m in res.history_raw["deliver_mask"]]
    assert [e.stale for e in rounds] == res.history_raw["stale"]
    mb = res.sessions[0].model_bytes
    assert mb > 0 and all(e.wire_bytes == mb * len(e.delivered) for e in rounds)
    stops = [e for e in res.trace if e.phase == "stop"]
    assert len(stops) == 1 and stops[0].stop_reason == res.stop_reason
    perfect = Experiment(_world(problem), _METHOD, ExecutionSpec(engine=engine)).run()
    assert all(e.delivered is None for e in perfect.trace)


@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_byzantine_world_events_carry_the_sets(problem, engine):
    """The corrupted and clipped sets surface in the normalized stream, not
    just in raw history; the honest world leaves them None."""
    res = Experiment(_world(problem), _WORLDS["byzantine"][1],
                     ExecutionSpec(engine=engine)).run()
    rounds = [e for e in res.trace if e.phase == "round"]
    assert all(e.corrupted is not None and e.clipped is not None for e in rounds)
    assert sum(len(e.corrupted) for e in rounds) > 0
    assert [e.corrupted for e in rounds] == [
        tuple(int(i) for i in np.nonzero(np.asarray(m) > 0.5)[0])
        for m in res.history_raw["corrupted_mask"]]
    mb = res.sessions[0].model_bytes
    assert mb > 0 and all(e.wire_bytes == mb * res.sessions[0].n_contributors
                          for e in rounds)
    stops = [e for e in res.trace if e.phase == "stop"]
    assert len(stops) == 1 and stops[0].stop_reason == res.stop_reason
    assert res.corruption_summary["rounds"] == len(rounds)
    honest = Experiment(_world(problem), _METHOD, ExecutionSpec(engine=engine)).run()
    assert all(e.corrupted is None and e.clipped is None for e in honest.trace)
    assert honest.corruption_summary is None


@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_cadence_world_events_carry_lane_clocks(problem, engine):
    """The cadence world's observability rides the one adapter: each
    event's clock and idle fields are mapped from the engines'
    round_clock/idle_steps history, and a lockstep world leaves them None
    (absence, not zero)."""
    _, method = _WORLDS["cadence"]
    res = Experiment(_world(problem), method, ExecutionSpec(engine=engine)).run()
    rounds = [e for e in res.trace if e.phase == "round"]
    clock_h = res.sessions[0].history_raw["round_clock"]
    idle_h = res.sessions[0].history_raw["idle_steps"]
    assert [e.clock for e in rounds] == [int(c) for c in clock_h]
    assert [e.idle for e in rounds] == [float(i) for i in idle_h]
    assert all(isinstance(e.clock, int) for e in rounds)
    assert all(isinstance(e.idle, float) for e in rounds)
    # the requester on stride 2 of 2: its clock advances on the global
    # event counter, faster than the round index, with real idle gaps
    clocks = [e.clock for e in rounds]
    assert all(b > a for a, b in zip(clocks, clocks[1:]))
    assert rounds[-1].clock > rounds[-1].round
    assert sum(e.idle for e in rounds) > 0
    stop = [e for e in res.trace if e.phase == "stop"]
    assert len(stop) == 1 and stop[0].clock is None and stop[0].idle is None
    lock = Experiment(_world(problem), _METHOD, ExecutionSpec(engine=engine)).run()
    assert all(e.clock is None and e.idle is None for e in lock.trace)


@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_lockstep_world_events_leave_lane_clocks_none(problem, engine):
    """The lockstep world has no cadence concept: clock/idle stay None
    (absence, not zero), as the session's own trace view says too."""
    res = Experiment(_world(problem), _METHOD, ExecutionSpec(engine=engine)).run()
    assert all(e.clock is None and e.idle is None for e in res.trace)
    assert res.sessions[0].trace == res.trace


# ---------------------------------------------------------------------------
# exporters: JSONL round-trip, schema validation, Chrome trace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world_name", ["static", "byzantine"])
def test_events_jsonl_round_trips(problem, world_name, tmp_path):
    """A Byzantine log round-trips too: every field the schema types as a
    tuple (corrupted and clipped included) comes back a tuple."""
    mob, method = _WORLDS[world_name]
    res = Experiment(_world(problem, mob), method, ExecutionSpec(engine="loop")).run()
    path = str(tmp_path / "events.jsonl")
    n = write_events_jsonl(res.trace, path)
    back = read_events_jsonl(path)
    assert n == len(back) == len(res.trace)
    assert back == res.trace          # frozen dataclasses: field equality
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == n
    assert all(row["phase"] in EVENT_PHASES for row in rows)
    if world_name == "byzantine":
        assert any(isinstance(row["corrupted"], list) and row["corrupted"] for row in rows)
        assert all(isinstance(e.corrupted, tuple) for e in back if e.phase == "round")


def _event(**over):
    base = dict(round=0, requester=0, phase="round", executed=True,
                members=None, member_set=None, delivered=None,
                drops=0.0, retries=0.0, stale=0.0, battery=None,
                accuracy=0.5, loss=None, wire_bytes=0, energy_j=None,
                stop_reason=None)
    base.update(over)
    return RoundEvent(**base)


def test_byzantine_event_log_round_trips_every_tuple_field(tmp_path):
    events = [_event(corrupted=(1,), clipped=(0, 2), member_set=(0, 1, 2), delivered=(1,)),
              _event(round=1, phase="stop", stop_reason="max_rounds")]
    path = str(tmp_path / "events.jsonl")
    write_events_jsonl(events, path)
    assert read_events_jsonl(path) == events


def test_validate_events_rejects_schema_violations():
    ok = [_event(), _event(round=1),
          _event(round=2, phase="stop", stop_reason="accuracy_reached")]
    assert validate_events(ok) == ok
    with pytest.raises(ValueError, match="phase"):
        validate_events([_event(phase="negotiate")])
    with pytest.raises(ValueError, match="stop_reason"):
        validate_events([_event(phase="stop")])          # stop w/o reason
    with pytest.raises(ValueError, match="stop_reason"):
        validate_events([_event(stop_reason="oops")])    # reason on round
    with pytest.raises(ValueError, match="does not follow"):
        validate_events([_event(), _event(round=2)])     # round gap
    with pytest.raises(ValueError, match="already stopped"):
        validate_events([_event(phase="stop", stop_reason="x"), _event(round=1)])
    with pytest.raises(ValueError, match="bool"):
        validate_events([_event(wire_bytes=True)])       # bool is not int
    with pytest.raises(ValueError, match="accuracy"):
        validate_events([_event(accuracy=None)])         # non-noneable
    with pytest.raises(ValueError, match="corrupted has type list"):
        validate_events([_event(corrupted=[1])])         # tuple fields stay tuples


def test_compare_event_streams_reports_diffs():
    a = [_event(accuracy=0.5)]
    assert compare_event_streams(a, [_event(accuracy=0.5 + 1e-6)]) == []
    assert compare_event_streams(a, [_event(accuracy=0.9)])
    assert compare_event_streams(a, [_event(drops=1.0)])
    assert compare_event_streams(a, [_event(corrupted=(1,))])
    assert compare_event_streams(a, a + [_event(round=1)])


def test_chrome_trace_structure(tmp_path):
    tl = Timeline()
    with tl.span("stage", what="x"):
        with tl.span("quantize_pack"):
            pass
    with tl.span("program"):
        pass
    doc = timeline_chrome_trace(tl)
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    assert [e["name"] for e in evs] == ["stage", "quantize_pack", "program"]
    for e in evs:
        assert e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0
        assert e["cat"] == "repro"
    assert evs[0]["args"] == {"what": "x"}
    # nested span lies inside its parent on the µs timeline
    assert evs[1]["ts"] >= evs[0]["ts"]
    assert evs[1]["ts"] + evs[1]["dur"] <= evs[0]["ts"] + evs[0]["dur"]
    path = str(tmp_path / "trace.json")
    assert write_chrome_trace(tl, path) == 3
    with open(path) as f:
        assert json.load(f) == doc


# ---------------------------------------------------------------------------
# Timeline spans, and the spans each engine records
# ---------------------------------------------------------------------------


def test_timeline_nesting_and_totals():
    tl = Timeline()
    with tl.span("outer"):
        with tl.span("inner"):
            pass
        with tl.span("inner"):
            pass
    outer, i1, i2 = tl.spans
    assert (outer.depth, i1.depth, i2.depth) == (0, 1, 1)
    assert i1.parent == 0 and i2.parent == 0
    totals = tl.totals()
    assert totals["inner"] <= totals["outer"]
    assert tl.total("inner") == totals["inner"]
    assert tl.total("missing") == 0.0


def test_timeline_finish_is_strictly_lifo():
    tl = Timeline()
    a = tl.begin("a")
    tl.begin("b")
    with pytest.raises(RuntimeError, match="innermost"):
        tl.finish(a)


def test_open_span_excluded_from_totals_and_trace():
    tl = Timeline()
    tl.begin("open")
    assert tl.totals() == {}
    assert timeline_chrome_trace(tl)["traceEvents"] == []


@pytest.mark.parametrize("world_name", ["static", "byzantine-int8"])
@pytest.mark.parametrize("engine", ["loop", "fleet"])
def test_engines_record_their_spans(problem, engine, world_name, tmp_path):
    path = str(tmp_path / "trace.json")
    mob, method = _WORLDS[world_name]
    res = Experiment(_world(problem, mob), method,
                     ExecutionSpec(engine=engine, trace=TraceConfig(chrome_trace=path))).run()
    want = set(LOOP_SPANS if engine == "loop" else FLEET_SPANS)
    if engine == "fleet" and world_name == "byzantine-int8":
        want |= {"quantize_pack", "dequant_unpack"}
    assert want <= set(res.timings)
    assert all(v >= 0.0 for v in res.timings.values())
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert want <= names
    if engine == "loop":
        rounds = [sp.attrs["round"] for sp in res.timeline.spans if sp.name == "transport"]
        assert rounds == list(range(res.rounds))
    else:
        by_name = {sp.name: sp for sp in res.timeline.spans}
        assert by_name["program"].depth == 0
        if "quantize_pack" in want:
            assert res.timeline.spans[by_name["quantize_pack"].parent].name == "stage"
            assert res.timeline.spans[by_name["dequant_unpack"].parent].name == "unpack"


# ---------------------------------------------------------------------------
# the ExecutionSpec knob
# ---------------------------------------------------------------------------


def test_execution_spec_rejects_non_trace_config():
    with pytest.raises(ValueError, match="TraceConfig"):
        ExecutionSpec(trace={"events_jsonl": "x.jsonl"})


@pytest.mark.parametrize("method", ["enfed", "cfl", "cloud"])
@pytest.mark.parametrize("trace", [TraceConfig(hlo_stats=True),
                                   TraceConfig(jax_profiler_dir="prof")])
def test_loop_engine_warns_on_fleet_only_trace_knobs(problem, method, trace):
    with pytest.warns(UserWarning, match="hlo_stats"):
        res = Experiment(_world(problem), dataclasses.replace(_METHOD, max_rounds=1),
                         ExecutionSpec(engine="loop", trace=trace)).run(method)
    assert res.hlo_stats is None


# ---------------------------------------------------------------------------
# the profiler hooks: hlo_stats against the launch counters and a closed form
# ---------------------------------------------------------------------------

# the twin each op calls on the CPU, by module, and the kernel counter it
# stands for: on the CPU a twin call sits where the card launches the kernel
_TWIN_COUNTERS = [
    ("fedavg.ops", "fedavg_batched_ref", "fedavg.kernel", "launches"),
    ("fedavg.ops", "fedavg_batched_q8_ref", "fedavg.kernel", "q8_launches"),
    ("quantize.ops", "quantize_batched_ref", "quantize.kernel", "launches"),
    ("quantize.ops", "dequantize_batched_ref", "quantize.kernel", "dequantize_launches"),
    ("quantize.ops", "dequantize_ref", "quantize.kernel", "dequantize_launches"),
    ("aes_ctr.ops", "aes_ctr_ref", "aes_ctr.kernel", "launches"),
    ("lstm_cell.ops", "lstm_seq_ref", "lstm_cell.kernel", "launches"),
    ("lstm_cell.ops", "lstm_cell_ref", "lstm_cell.kernel", "launches"),
    ("lstm_cell.ops", "lstm_seq_backward_ref", "lstm_cell.kernel", "bwd_launches"),
]


@pytest.fixture
def counted_twins(monkeypatch):
    """Each twin call adds one to its kernel's ``launches`` counter, as the
    card's launch would."""
    import importlib

    import repro_torch.kernels as kernels

    def wrap(fn, mod, attr):
        def counted(*args, **kwargs):
            setattr(mod, attr, getattr(mod, attr) + 1)
            return fn(*args, **kwargs)
        return counted

    for ops_name, twin, kmod_name, attr in _TWIN_COUNTERS:
        ops = importlib.import_module(f"repro_torch.kernels.{ops_name}")
        kmod = importlib.import_module(f"repro_torch.kernels.{kmod_name}")
        monkeypatch.setattr(ops, twin, wrap(getattr(ops, twin), kmod, attr))
    kernels.reset_launch_counts()
    yield kernels
    kernels.reset_launch_counts()


def _fedavg(r, n, l):
    """Eq. 14 at (R, N, L): 2 R N L + R L flops; the updates, weights and
    means moved once, fp32."""
    return 2 * r * n * l + r * l, 4 * (r * n * l + r * n + r * l)


def _fedavg_q8(r, n, lp):
    """Eq. 14 over int8 codes: a dequantize multiply and a multiply-add per
    code, a division per mean; one byte a code, a scale a 1024-code tile."""
    return 3 * r * n * lp + r * lp, r * n * lp + 4 * (r * n * lp // 1024 + r * n + r * lp)


def _quantize(b, l, lp):
    """Six operations an element; the rows read, codes and scales written."""
    return 6 * b * l, 4 * b * l + b * lp + 4 * b * lp // 1024


def _dequantize(n):
    """One multiply a code; codes and scales read, fp32 written."""
    return n, n + 4 * n // 1024 + 4 * n


@pytest.mark.parametrize("method_name,compress", [("enfed", None), ("enfed", "int8"),
                                                  ("dfl", None), ("cfl", None)])
def test_hlo_stats_count_the_launches_and_a_closed_form(problem, counted_twins, method_name,
                                                        compress):
    """The program's per-kernel launches equal the kernels' launch counters
    over the run (on the CPU each twin call counts as its launch), and its
    flops and bytes equal the closed form of this world: the MLP of P = 8 *
    16 + 16 + 16 * 5 + 5 = 229 params, one requester with 3 contributors:
    under enfed eq. 14 over N = n_max = 5 lanes (2 of them zero-weight
    padding) once a round, and under int8 a round's refresh before it
    (dequantize of the 3 contributors' 1024-code rows, quantize of the 3
    refreshed rows); under the baselines the requester's lane and 3 client
    lanes, N = 4, one eq. 14 a round (cfl) or one per mixing row (dfl, 4 a
    round)."""
    P, LP = 229, 1024
    method = dataclasses.replace(_METHOD, compress=compress)
    trace = TraceConfig(hlo_stats=True)
    before = counted_twins.launch_counts()
    res = Experiment(_world(problem), method,
                     ExecutionSpec(engine="fleet", trace=trace)).run(method_name)
    moved = {k: v - before[k] for k, v in counted_twins.launch_counts().items()}
    stats, rounds = res.hlo_stats, res.rounds
    assert rounds >= 1
    # the program span holds every launch of this world but the int8
    # staging (one quantize of the 3 contributors) and its unpack (one
    # dequantize of their final rows), which lie outside it
    outside = {"quantize": 1, "dequantize": 1} if compress else {}
    assert {k: v["launches"] for k, v in stats["per_kernel"].items()} == {
        k: v - outside.get(k, 0) for k, v in moved.items() if v}
    assert method.n_max == 5
    if method_name == "enfed" and compress is None:
        terms = [_fedavg(1, 5, P)] * rounds
    elif method_name == "enfed":
        terms = [_dequantize(3 * LP), _quantize(3, P, LP), _fedavg_q8(1, 5, LP)] * rounds
    elif method_name == "cfl":
        terms = [_fedavg(1, 4, P)] * rounds
    else:
        terms = [_fedavg(1, 4, P)] * (4 * rounds)
    assert stats["flops"] == sum(f for f, _ in terms)
    assert stats["bytes_accessed"] == sum(b for _, b in terms)
    assert stats["transcendentals"] == 0
    assert stats["torch_matmul_flops"] > 0
    assert stats["memory"]["staged_bytes"] == res.raw.staged_param_bytes
    assert "peak_bytes" not in stats["memory"]


def test_profiler_writes_a_trace_of_the_program_on_the_cpu(problem, tmp_path):
    """``jax_profiler_dir`` writes a Chrome/TensorBoard trace of the fleet
    program, each kernel op in a ``repro_torch::<kernel>`` range."""
    trace = TraceConfig(jax_profiler_dir=str(tmp_path / "prof"))
    res = Experiment(_world(problem), _METHOD, ExecutionSpec(engine="fleet", trace=trace)).run()
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1 and res.hlo_stats is None
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "repro_torch::fedavg" in names
    assert sum(e.get("name") == "repro_torch::fedavg" for e in events) == res.rounds
