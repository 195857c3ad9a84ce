"""Benchmark entrypoint of the port: the paper's tables and figures
(Tables IV, V and VII, Figs 4-7) run by repro_torch, each suite repeated.

  PYTHONPATH=src python -m benchmarks.torch_run [--only table4,...] \
      [--device cpu] [--repeats 3]

The twin of ``benchmarks/run.py`` for its four paper suites.  ``T_train``
holds the measured wall of the requester's fits, which moves between runs
on one card, so every suite runs ``--repeats`` times in one process.  For
each row it prints the median and the min-max of its columns, for each
table the median and min-max of EnFed's reductions against DFL, CFL and
cloud, and whether accuracy and rounds came out the same in every repeat.
It ends with ``name,us_per_call,derived`` CSV rows built from the medians.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import time

import numpy as np

SUITES = {
    # suite: (module, names of the row's two last columns)
    "table4": ("benchmarks.torch_table4_lstm", ("T_train s", "E_tot J")),
    "table5": ("benchmarks.torch_table5_mlp", ("T_train s", "E_tot J")),
    "table7": ("benchmarks.torch_table7_cloud", ("response s", "saving %")),
    "figs": ("benchmarks.torch_figs_contributors", ("T_train s", "E_tot J")),
}
RUNNERS = ("run_enfed", "run_cfl", "run_dfl", "run_cloud")


def _recorded(fn, log):
    """``fn`` that appends each call's (runner, rounds, accuracy) to ``log``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        res = fn(*args, **kwargs)
        if isinstance(res, tuple):       # run_cloud: (accuracy, response, params)
            log.append((fn.__name__, 1, float(res[0])))
        else:
            log.append((fn.__name__, int(res.rounds), float(res.accuracy)))
        return res
    return run


def _spread(values) -> str:
    v = np.asarray(values, np.float64)
    return f"{np.median(v):.6g} [{v.min():.6g}, {v.max():.6g}]"


def _reductions(rows, energy: bool):
    """EnFed's reduction (%) of each column against every other row of its
    group (the tag without its last part): {(group, baseline, column): %}."""
    groups = {}
    for row in rows:
        group, who = row[0].rsplit("/", 1)
        groups.setdefault(group, {})[who] = row
    out = {}
    for group, members in groups.items():
        enfed = members.get("EnFed")
        if enfed is None:
            continue
        for who, row in members.items():
            if who == "EnFed":
                continue
            out[(group, who, "time")] = 100.0 * (1.0 - enfed[2] / row[2])
            if energy:
                out[(group, who, "energy")] = 100.0 * (1.0 - enfed[3] / row[3])
    return out


def run_suite(name: str, device: str, repeats: int):
    """Runs one suite ``repeats`` times; prints its rows' spread.  Returns
    the rows of every repeat."""
    from benchmarks import _torch_harness as harness

    modname, columns = SUITES[name]
    mod = importlib.import_module(modname)
    mod.build_scenario = functools.partial(harness.build_scenario, device=device)
    logs, per_repeat = [], []
    for rep in range(repeats):
        log = []
        for runner in RUNNERS:
            if hasattr(mod, runner):
                setattr(mod, runner, _recorded(getattr(harness, runner), log))
        t0 = time.perf_counter()
        rows = mod.run(verbose=True)
        print(f"----- {name} repeat {rep + 1}/{repeats} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        logs.append(log)
        per_repeat.append(rows)

    tags = [r[0] for r in per_repeat[0]]
    if any([r[0] for r in rows] != tags for rows in per_repeat):
        raise RuntimeError(f"{name}: the repeats gave other rows")
    print(f"\n{name}: {repeats} repeats, median [min, max] per row")
    for i, tag in enumerate(tags):
        first = "loss" if tag.startswith("fig7") else "acc"
        vals = [[rows[i][k] for rows in per_repeat] for k in (1, 2, 3)]
        print(f"  {tag:34s} {first} {_spread(vals[0])} | {columns[0]} {_spread(vals[1])} | "
              f"{columns[1]} {_spread(vals[2])}")
    reds = [_reductions(rows, energy=columns[1] == "E_tot J") for rows in per_repeat]
    for key in reds[0]:
        group, who, col = key
        print(f"  EnFed vs {who:5s} {group:20s} {col:6s} reduction % "
              f"{_spread([r[key] for r in reds])}")
    same = all(log == logs[0] for log in logs)
    print(f"  accuracy and rounds identical in every repeat: {'yes' if same else 'no'}")
    if not same:
        for j, calls in enumerate(zip(*logs)):
            if len(set(calls)) > 1:
                print(f"    call {j} ({calls[0][0]}): (rounds, accuracy) "
                      + ", ".join(f"({c[1]}, {c[2]:.4f})" for c in calls))
    print("  rounds per call: " + ", ".join(f"{c[0][4:]} {c[1]}" for c in logs[0]))
    return per_repeat


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="comma list: " + ",".join(SUITES))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain twins)")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    only = args.only.split(",") if args.only else list(SUITES)
    unknown = set(only) - set(SUITES)
    if unknown:
        ap.error(f"unknown suites {sorted(unknown)} (choose from {','.join(SUITES)})")
    if args.repeats < 1:
        ap.error("--repeats must be at least 1")

    csv_rows = []
    for name in (s for s in SUITES if s in only):
        print(f"\n===== {name} =====", flush=True)
        t0 = time.time()
        per_repeat = run_suite(name, args.device, args.repeats)
        print(f"===== {name} done in {time.time() - t0:.1f}s =====", flush=True)
        for i, row in enumerate(per_repeat[0]):
            csv_rows.append((row[0], np.median([r[i][1] for r in per_repeat]),
                             np.median([r[i][-1] for r in per_repeat])))

    print("\nname,us_per_call,derived")
    for tag, val, extra in csv_rows:
        print(f"{tag},{val},{extra}")


if __name__ == "__main__":
    main()
