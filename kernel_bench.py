"""Time every kernel of the PyTorch/CUDA port on one NVIDIA GPU, as phase 5
of ``chip_smoke.py`` does, for the package in any source tree.

    python3 kernel_bench.py [--src DIR] [--label NAME] [--out FILE]

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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
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


if __name__ == "__main__":
    sys.exit(main())
