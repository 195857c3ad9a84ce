"""Time every kernel of the PyTorch/CUDA port on one NVIDIA GPU, as phase 5
of ``chip_smoke.py`` does, for the package in any source tree.

    python3 kernel_bench.py [--src DIR] [--label NAME] [--out FILE]
    python3 kernel_bench.py --lstm-plans
    python3 kernel_bench.py [--src DIR] [--label NAME] --lstm "L,B,F,H,T;..."

``--lstm-plans`` times instead the LSTM pair of this checkout at
``chip_smoke.LSTM_CLUSTER_SHAPES`` and the fit shape of
``chip_smoke.LSTM_GRID_SHAPES`` (one lane of H = 512) under every cluster
plan that fits (``kernels/lstm_cell/kernel.py::cluster_plans`` at each
cluster size, with batch-row groups 8, 4, 2 or 1), at one lane under every
grid plan with the largest batch tile (``grid_plans``: each count of rows
a thread and each K, so at H = 256 the grid against the cluster), and under the weights-through-L2
layout, each checked bit-equal to the planned launch; at H = 512 also
under each streaming mode and chunk width forced on the planned grid
(``stream_plan``); and at the streamed fit shape of
``chip_smoke.LSTM_STREAM_SHAPES`` (one lane of H = 1,100) under every
streamed grid plan with the largest tile (each R, K and kappa, at the
least streaming that fits) and each more streaming mode forced on the
planned one: what the rule of ``kernels/lstm_cell/kernel.py::plan`` is
read against.  ``--lstm`` times
only the LSTM pair (the forward saving its states, the backward; device ms
and host us a call) of the tree in ``DIR`` at the given shapes, through its
public wrappers, so that two versions compare in one run on one card.

``DIR`` (default: ``src`` of this checkout) is the directory that holds
``repro_torch``; its kernels are built from its own ``csrc`` into the
``build/`` beside it.  To compare two versions on one card, unpack the
other version's tree (``git archive``) into a git-ignored directory and
run both in one session, in turns: other, this, this, other.  The shapes
are the main paths' (the quickstart's HAR LSTM, the 64-requester fleet);
launch counts and errors against the twins are ``chip_smoke.py``'s work and
read 0 here.  Prints one line per kernel, for this checkout's tree the
breakdown of the launch path, and last a JSON object with every row, also
written to ``FILE`` when given.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import torch

import chip_smoke

ROOT = Path(__file__).resolve().parent
KEYS = ("name", "ms", "host_us", "device_us", "device_us_cold", "r1_us", "r1_us_cold",
        "floor_us", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--out", default=None)
    ap.add_argument("--lstm-plans", action="store_true")
    ap.add_argument("--lstm", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is available", file=sys.stderr)
        return 2
    if args.lstm_plans:
        sys.path.insert(0, str(ROOT / "src"))
        print(f"kernel_bench --lstm-plans: {chip_smoke.nvidia_smi_line()}")
        lstm_plans(torch.device("cuda"))
        return 0
    sys.path.insert(0, str(Path(args.src).resolve()))
    if args.lstm:
        lstm_shapes(torch.device("cuda"), args.label, args.lstm)
        return 0
    from repro_torch.core import SupervisedTask
    from repro_torch.kernels import _build
    from repro_torch.models import LSTMClassifier, LSTMClassifierConfig
    from repro_torch.utils.tree import tree_size

    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi_line()
    path, _ = _build.build()
    print(f"kernel_bench [{args.label}]: {smi}; kernels {path}")
    cfg = LSTMClassifierConfig(input_dim=6, seq_len=32, hidden=64, num_classes=6)
    n_params = tree_size(SupervisedTask(LSTMClassifier(cfg, device=dev)).init(0))
    zeros = collections.defaultdict(int)
    rows = chip_smoke.time_kernels(dev, zeros, collections.defaultdict(float), n_params,
                                   32, cfg.input_dim, cfg.hidden, cfg.seq_len, 5)
    if Path(args.src).resolve() == (ROOT / "src").resolve():
        chip_smoke.launch_path_breakdown(dev, n_params, 5)
    result = {"label": args.label, "card": smi,
              "rows": [{k: row.get(k) for k in KEYS} for row in rows]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


def lstm_shapes(dev, label: str, shapes: str) -> None:
    """The LSTM pair's ms (CUDA events, 30 calls after 3) at each shape
    "L,B,F,H,T" of ``shapes`` (";"-separated), on chip_smoke's inputs, and
    the host's microseconds to enqueue one call (``chip_smoke.host_us``,
    200 calls) where a call takes under 10 ms; at one lane also cuDNN's
    (``chip_smoke.time_cudnn_lstm``, 30 calls)."""
    from repro_torch.kernels.lstm_cell import kernel as lk

    smi = chip_smoke.nvidia_smi_line()
    for shape in shapes.split(";"):
        lanes, b, f, h, t = (int(v) for v in shape.split(","))
        g = torch.Generator().manual_seed(34)
        x, h0, c0, w, dh, dc = chip_smoke.lstm_views(g, dev, lanes, b, f, h, t)
        hs, cs = lk.lstm_seq_cuda(x, h0, c0, *w, save=True)
        parts = []
        for kind, run in (("forward", lambda: lk.lstm_seq_cuda(x, h0, c0, *w, save=True)),
                          ("backward", lambda: lk.lstm_seq_backward_cuda(x, hs, cs, *w, dh, dc))):
            ms = chip_smoke.cuda_ms(run, iters=30, warmup=3)
            host = (f"host {chip_smoke.host_us(run, calls=200, burst=20):.3f} us"
                    if ms < 10 else "host not measured")
            parts.append(f"{kind} {ms:.5f} ms ({host})")
        if lanes == 1:
            lib = chip_smoke.time_cudnn_lstm(x[0], h0[0], c0[0], *(p[0] for p in w), dh[0], dc[0],
                                             hs[0, -1], iters=30)
            parts.append(f"cuDNN forward {lib[0]:.5f}, backward {lib[1]:.5f} ms")
        print(f"  lstm [{label}] L,B,F,H,T={shape}: " + ", ".join(parts) + f" ({smi})")


def lstm_plans(dev) -> None:
    """The LSTM pair's ms (CUDA events, 10 calls after 2) at each wide
    shape under each plan that fits, the chosen plan marked."""
    from repro_torch.kernels.lstm_cell import kernel as lk

    g = torch.Generator().manual_seed(33)
    sms = lk.device_sms(dev)
    shapes = (chip_smoke.LSTM_CLUSTER_SHAPES + chip_smoke.LSTM_GRID_SHAPES[:1]
              + chip_smoke.LSTM_STREAM_SHAPES[:1])
    for name, lanes, b, f, h, t in shapes:
        x, h0, c0, w, dh, dc = chip_smoke.lstm_views(g, dev, lanes, b, f, h, t)
        hs, cs = lk.lstm_seq_cuda(x, h0, c0, *w, save=True)
        runs = {False: lambda p: lk.lstm_seq_cuda(x, h0, c0, *w, save=True, _plan=p),
                True: lambda p: lk.lstm_seq_backward_cuda(x, hs, cs, *w, dh, dc, _plan=p)}
        for backward, run in runs.items():
            chosen = lk.plan(b, f, h, backward, lanes=lanes, sms=sms)
            want = [o.view(torch.int32).clone() for o in run(chosen)]
            plans = [p for c in lk.CLUSTERS for p in lk.cluster_plans(b, f, h, c, backward)
                     if p.groups & (p.groups - 1) == 0]
            if lanes == 1:
                grid = list(lk.grid_plans(b, f, h, backward, sms))
                if chosen.mode:
                    grid = [p for p in grid if p.mode]
                else:
                    grid = [p for p in grid if not p.mode]
                tile = max(q.groups * q.rows for q in grid)
                plans += [p for p in grid if p.groups * p.rows == tile]
            if chosen.layout == "grid":
                # each streaming mode (and chunk width) forced on the chosen geometry
                levels = lk.STREAM_LEVELS[backward]
                for mode in levels[levels.index(chosen.mode) + 1 if chosen.mode else 0:]:
                    for kappa in lk.KAPPAS:
                        try:
                            plans.append(lk.stream_plan(chosen, f, h, backward, mode, kappa))
                        except ValueError:
                            pass
            plans.append(lk.plan(b, f, h, backward, lanes=lanes, _layout="l2"))
            parts = []
            for p in plans:
                got = run(p)
                torch.cuda.synchronize()
                if not all(torch.equal(a.view(torch.int32), c) for a, c in zip(got, want)):
                    raise SystemExit(f"lstm {name}: plan {p} differs from the chosen plan's bits")
                # the L2 layout past H = 1,000 takes ~0.1 s a call: a few calls
                slow = p.layout == "l2" and h > 1000
                ms = chip_smoke.cuda_ms(lambda: run(p), iters=3 if slow else 10,
                                        warmup=1 if slow else 2)
                what = ("L2" if p.layout == "l2" else
                        f"grid R={p.rows} K={p.blocks} x {p.span * p.groups} threads "
                        + (f"mode {p.mode} kappa {p.kappa}"
                           + (f" rho {p.rho}" if p.rho else "") + " " if p.mode else "")
                        + f"{p.smem:,} B"
                        if p.layout == "grid" else
                        f"C={p.cluster} tile {p.groups * lk.ROWS}"
                        + (" out" if p.mode & lk.DGATES_OUT else "") + f" {p.smem:,} B")
                parts.append(f"{what}{'*' if p == chosen else ''} {ms:.5f}")
            print(f"  lstm {'backward' if backward else 'forward'} {name} L,B,F,H,T={lanes},{b},"
                  f"{f},{h},{t} (ms; * the plan's, every plan bit-equal to it): "
                  + "; ".join(parts))


if __name__ == "__main__":
    sys.exit(main())
