"""Federate an architecture-zoo language model with EnFed on the PyTorch
port (twin of ``examples/federated_lm.py``).

End-to-end driver: picks an architecture from the registry (reduced
preset), simulates an opportunistic client fleet with incentives and
batteries, and trains with the EnFed neighborhood aggregation —
delegates to ``repro_torch.launch.train``, on the card unless ``--device``
names another device.

  PYTHONPATH=src python examples/torch_federated_lm.py --arch debug-dense --steps 30 \
      [--device cpu]
"""

import argparse

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="debug-dense")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--strategy", default="enfed")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    argv = ["--arch", args.arch, "--preset", "smoke",
            "--steps", str(args.steps), "--clients", str(args.clients),
            "--strategy", args.strategy, "--neighborhood", "2",
            "--log-every", "5"]
    if args.device:
        argv += ["--device", args.device]
    return train_mod.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
