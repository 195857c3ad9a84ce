"""Full HAR comparison scenario on the PyTorch/CUDA port: EnFed vs CFL vs
DFL (mesh/ring) vs cloud-only, on both paper datasets (calories->MLP,
HARSense->LSTM), expressed entirely through the ``repro_torch.api`` facade.

The twin of ``examples/har_federated.py`` on ``repro_torch``: it runs on
the GPU, or on the host with ``--device cpu``.  One ``WorldSpec`` is built
once; ``Experiment.compare`` runs every method on that SAME world, seed and
cost model, which is what makes the printed reduction percentages
meaningful.

  PYTHONPATH=src python examples/torch_har_federated.py [--dataset har|calories]
                                                        [--engine loop|fleet]
                                                        [--churn] [--faults]
                                                        [--cadence] [--byzantine]
                                                        [--compress int8]
                                                        [--device cpu]
                                                        [-v | -q]

Output goes through stdlib ``logging`` ("repro_torch.example.har", stdout):
``-q`` keeps errors only, ``-v`` adds the per-run span timings
(``RunResult.timings``).

``--engine fleet`` runs each session on the fleet engine (all requesters on
one flat round state) instead of the session loop: same protocol, same
result.

``--churn`` turns on the opportunistic world
(``repro_torch.core.mobility``): the neighbours walk random-waypoint
trajectories, contracts are renegotiated every round as devices enter or
leave the 90 m radio range or reach their battery floor, and the
walkthrough prints each round's contract set with its joins (+) and
leaves (-).  A round with no member is survivable: the requester trains
alone on its own shard.

``--faults`` turns on the unreliable-link world
(``repro_torch.core.faults``): each link drops an attempt with
probability 0.4, retries once, and a delivered update is the previous
round's image with probability 0.3; a link that failed two rounds running
is released.  Undelivered links drop out of the aggregate, every retry is
priced through ``CostModel.retry_energy``, and the walkthrough prints each
round's delivered set with its drop, retry and stale counts.  It composes
with ``--churn`` and ``--byzantine``.

``--cadence`` turns on the asynchronous-cadence world
(``repro_torch.core.cadence``, two speed classes, seed 3): the lockstep
round barrier is gone, each device ticks on its own stride, and the
walkthrough prints each round's event step (clock), the idle steps before
it (priced through ``CostModel.idle_energy``) and its stragglers, the
contributors that do not tick on that step and whose resident wire images
are aggregated as they are.  It composes with ``--churn``, ``--faults`` and
``--byzantine``.

``--byzantine`` turns on the adversarial world: 30% of contributor links
deliver a corrupted wire image each round (a 25x scale attack), and the
session defends with ``robust="clip"``.  The walkthrough prints each
round's CORRUPTED and CLIPPED sets.  It composes with ``--churn`` and
``--faults``.  Every world is counter-based, so both engines print the
identical sets.

``--compress int8`` adds an ``enfed-int8`` row to the compare table (in a
walkthrough: the session runs on the int8 wire).
"""

import argparse
import dataclasses
import logging
import sys


import numpy as np

from repro_torch.api import ExecutionSpec, Experiment, MethodSpec, WorldSpec
from repro_torch.core import (AdversaryConfig, CadenceConfig, FaultConfig, MobilityConfig,
                              SupervisedTask, make_fleet)
from repro_torch.core.cadence import tick_mask
from repro_torch.core.mobility import membership_events
from repro_torch.data import (CaloriesDatasetConfig, HARDatasetConfig, dirichlet_partition,
                              make_calories_tabular, make_har_windows)
from repro_torch.models import (LSTMClassifier, LSTMClassifierConfig, MLPClassifier,
                                MLPClassifierConfig)

log = logging.getLogger("repro_torch.example.har")


def _setup_logging(verbosity: int) -> None:
    level = (logging.ERROR if verbosity < 0
             else logging.DEBUG if verbosity > 0 else logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("%(message)s"))
    log.handlers[:] = [handler]
    log.setLevel(level)
    log.propagate = False


def build(dataset: str, device):
    if dataset == "har":
        x, y, _ = make_har_windows(HARDatasetConfig(num_samples=3000, seq_len=32))
        task = SupervisedTask(LSTMClassifier(LSTMClassifierConfig(6, 32, 64, 6),
                                             device=device), lr=3e-3)
    else:
        x, y = make_calories_tabular(CaloriesDatasetConfig(num_samples=3000))
        task = SupervisedTask(MLPClassifier(MLPClassifierConfig(8, (64, 32), 5),
                                            device=device), lr=3e-3)
    parts = dirichlet_partition(y, num_clients=6, alpha=1.0, seed=0)
    shards = [(x[p], y[p]) for p in parts]
    own_x, own_y = shards[0]
    n = int(len(own_x) * 0.8)
    return task, shards, (own_x[:n], own_y[:n]), (own_x[n:], own_y[n:]), (x, y)


def make_world(task, shards, own_train, own_test, *, fit_epochs: int,
               pooled=None, mobility=None) -> WorldSpec:
    """One shared world on the task's device: a 5-device neighborhood whose
    contributors hold pre-trained models over their own shards."""
    fleet = make_fleet(5, seed=1, p_has_model=1.0)
    states = {}
    for i, dev in enumerate(fleet):
        dev.reservation_price = 0.4
        p = task.init(seed=10 + i)
        p, _ = task.fit(p, shards[i + 1], epochs=fit_epochs, batch_size=32, seed=i)
        states[dev.device_id] = {"params": p, "data": shards[i + 1]}
    return WorldSpec.single(task, own_train, own_test, fleet, states,
                            pooled_train=pooled, mobility=mobility, device=task.device)


def walkthrough(task, shards, own_train, own_test, args):
    """One requester trains for the whole round budget while its world
    misbehaves.  With ``--churn`` the session renegotiates every round:
    contributors that wandered out of the 90 m range (or drained to the
    battery floor) are released, devices that wandered in are signed, and
    a higher-utility arrival displaces the weakest member.  With
    ``--faults`` links drop, retry (each retry priced) and deliver the
    previous round's image; only delivered updates are aggregated.  With
    ``--cadence`` the round barrier is gone: the requester's round clock
    advances on its own ticks, and contributors that do not tick on its
    step are stragglers, aggregated from their resident images.  With
    ``--byzantine`` counter-based draws pick each round's corrupted links
    and the clip defense throttles outlier-norm contributions before the
    aggregate."""
    mob = (MobilityConfig(arena_m=200.0, radio_range_m=90.0, leg_rounds=2, seed=5)
           if args.churn else None)
    faults = (FaultConfig(p_drop=0.4, p_stale=0.3, max_retries=1, release_after=2, seed=7)
              if args.faults else None)
    # two speed classes: the requester and some neighbours tick on every
    # other step only.  Which seed does that depends on the threefry mode:
    # under the tasks' partitionable mode seed 3 puts the requester on
    # stride 2 (the reference's seed 0 does so only under the other mode)
    cadence = CadenceConfig(n_speed_classes=2, seed=3) if args.cadence else None
    adversary = (AdversaryConfig(p_byzantine=0.3, attack="scale", scale=25.0, seed=9)
                 if args.byzantine else None)
    world = make_world(task, shards, own_train, own_test, fit_epochs=1, mobility=mob)
    res = Experiment(
        world,
        method=MethodSpec(desired_accuracy=args.target, epochs=args.epochs,
                          max_rounds=10, n_max=3, contributor_refresh_epochs=1,
                          faults=faults, cadence=cadence, adversary=adversary,
                          robust="clip" if args.byzantine else "none", compress=args.compress),
        execution=ExecutionSpec(engine=args.engine)).run()
    label = "+".join(n for n, on in (("churn", args.churn), ("faults", args.faults),
                                     ("cadence", args.cadence),
                                     ("byzantine", args.byzantine)) if on)
    log.info(f"\n=== {label} walkthrough ({args.dataset}, engine={res.engine}) ===")
    device_ids = [d.device_id for d in world.requesters[0].neighborhood]
    head = f"{'round':>5}"
    if args.cadence:
        head += f" {'clock':>5} {'idle':>4}"
    if args.churn:
        head += f" {'members':>8} {'contract set':<18}"
    if args.faults:
        head += f" {'delivered':<12} {'drop':>4} {'rtry':>4} {'stale':>5}"
    if args.cadence:
        head += f" {'stragglers':<12}"
    if args.byzantine:
        head += f" {'corrupted':<12} {'clipped':<12}"
    log.info(head + f" {'acc':>6} {'battery':>8}")
    prev = None
    for ev in res.trace:
        if ev.phase != "round":
            continue
        line = f"{ev.round:>5}"
        if args.cadence:
            line += f" {ev.clock:>5} {int(ev.idle):>4}"
        if args.churn:
            line += f" {ev.members:>8} {str(list(ev.member_set)):<18}"
        if args.faults:
            line += (f" {str(list(ev.delivered)):<12} {int(ev.drops):>4} {int(ev.retries):>4}"
                     f" {int(ev.stale):>5}")
        if args.cadence:
            awake = tick_mask(cadence, ev.clock, device_ids,
                              partitionable=task.threefry_partitionable)
            lagging = [j for j, on in enumerate(awake.tolist()) if not on]
            line += f" {str(lagging):<12}"
        if args.byzantine:
            line += f" {str(list(ev.corrupted)):<12} {str(list(ev.clipped)):<12}"
        note = ""
        if prev is not None:
            bits = ([f"+{j}" for j in sorted(set(ev.member_set) - set(prev))]
                    + [f"-{j}" for j in sorted(set(prev) - set(ev.member_set))])
            note = "  " + " ".join(bits) if bits else ""
        log.info(line + f" {ev.accuracy:6.3f} {ev.battery:8.3f}{note}")
        prev = ev.member_set if args.churn else None
    if args.churn:
        joins, leaves = membership_events(np.asarray(res.history_raw["member_mask"]))
        log.info(f"churn: {joins} joins and {leaves} leaves over {res.rounds} rounds "
                 f"(contracts renegotiated every round; both engines print the identical "
                 f"sets)")
    if args.faults:
        h = res.history_raw
        log.info(f"fault weather: {int(np.sum(h['drops']))} drops, {int(np.sum(h['retries']))} "
                 f"retries, {int(np.sum(h['stale']))} stale deliveries (retry windows priced "
                 f"via CostModel.retry_energy; both engines print the identical sets)")
    if args.cadence:
        clocks = res.history_raw["round_clock"]
        idle = int(np.sum(res.history_raw["idle_steps"]))
        log.info(f"cadence: {res.rounds} rounds over {clocks[-1] + 1} global event steps, "
                 f"{idle} idle steps priced via CostModel.idle_energy; stragglers' resident "
                 f"wire images aggregated as-is (both engines print this identically)")
    if args.byzantine:
        summary = res.corruption_summary
        log.info(f"byzantine weather: {int(summary['corrupted_links'])} corrupted deliveries "
                 f"(counter-keyed 25x scale attack), {int(summary['clipped_links'])} clipped "
                 f"by the robust='clip' screen; both engines print the identical sets")
    log.info(f"requester finished: {res.rounds} rounds, stop={res.stop_reason}, "
             f"final acc {res.accuracy:.3f}")
    log.debug(f"timings: { {k: round(v, 4) for k, v in res.timings.items()} }")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=("har", "calories"), default="har")
    ap.add_argument("--target", type=float, default=0.95)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--engine", choices=("loop", "fleet"), default="loop",
                    help="EnFed execution engine (fleet = one flat round state)")
    ap.add_argument("--churn", action="store_true",
                    help="opportunistic-world walkthrough: neighbours enter and leave radio "
                         "range mid-session (repro_torch.core.mobility)")
    ap.add_argument("--cadence", action="store_true",
                    help="asynchronous-cadence walkthrough: per-round event step, idle "
                         "steps and stragglers (repro_torch.core.cadence); composes with "
                         "--churn, --faults and --byzantine")
    ap.add_argument("--faults", action="store_true",
                    help="unreliable-link walkthrough: per-round delivered sets and drop, "
                         "retry and stale counts (repro_torch.core.faults); composes with "
                         "--churn and --byzantine")
    ap.add_argument("--byzantine", action="store_true",
                    help="adversarial walkthrough: Byzantine links deliver 25x-scaled "
                         "wire images and the robust='clip' screen throttles them")
    ap.add_argument("--compress", choices=("int8",), default=None,
                    help="add an enfed-int8 row: same world with the transported "
                         "updates int8-compressed")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the GPU, which must exist)")
    vq = ap.add_mutually_exclusive_group()
    vq.add_argument("-v", "--verbose", action="store_true",
                    help="debug logging (adds the per-run span timings)")
    vq.add_argument("-q", "--quiet", action="store_true",
                    help="errors only; suppress the table/walkthrough output")
    args = ap.parse_args(argv)
    _setup_logging(1 if args.verbose else -1 if args.quiet else 0)

    task, shards, own_train, own_test, pooled = build(args.dataset, args.device)
    if args.churn or args.faults or args.cadence or args.byzantine:
        return walkthrough(task, shards, own_train, own_test, args)

    # one world, N methods: the facade guarantees every method sees the
    # same requesters, contributor states, seed, and cost model
    world = make_world(task, shards, own_train, own_test,
                       fit_epochs=args.epochs, pooled=pooled)
    exp = Experiment(
        world,
        method=MethodSpec(desired_accuracy=args.target, epochs=args.epochs,
                          max_rounds=10, batch_size=32),
        execution=ExecutionSpec(engine=args.engine))
    methods = ["enfed", "cfl",
               dataclasses.replace(exp.method, name="dfl", topology="mesh", label="dfl-mesh"),
               dataclasses.replace(exp.method, name="dfl", topology="ring", label="dfl-ring"),
               "cloud"]
    if args.compress:
        methods.insert(1, dataclasses.replace(exp.method, compress=args.compress,
                                              label="enfed-int8"))
    cmp = exp.compare(methods)

    log.info(f"\n=== {args.dataset} on {task.device} ===")
    log.info(cmp.table())
    for row in cmp.reductions("enfed"):
        log.info(f"EnFed vs {row['baseline']:<10}: "
                 f"{row['time_reduction_pct']:+.1f}% time, "
                 f"{row['energy_reduction_pct']:+.1f}% energy")
    if args.compress:
        fp32, q8 = cmp["enfed"].report, cmp["enfed-int8"].report
        log.info(f"int8 wire: t_com {fp32.times.t_com:.4f}s -> "
                 f"{q8.times.t_com:.4f}s, E_comm {fp32.e_comm:.3f}J -> "
                 f"{q8.e_comm:.3f}J on the same world")
    log.info("(cloud T_train is the §IV-G response time: upload + cloud "
             "training + round trip)")
    log.debug(f"enfed timings: "
              f"{ {k: round(v, 4) for k, v in cmp['enfed'].timings.items()} }")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
