"""Serve a small model with batched requests (prefill + decode loop) on the
PyTorch port (twin of ``examples/serve_batched.py``).

  PYTHONPATH=src python examples/torch_serve_batched.py --arch debug-moe [--device cpu]
(the smoke preset keeps it small; the card unless ``--device`` names another)
"""

import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="debug-moe")
    ap.add_argument("--mla-absorbed", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    argv = ["--arch", args.arch, "--preset", "smoke",
            "--batch", "2", "--prompt-len", "16", "--gen", "12"]
    if args.mla_absorbed:
        argv.append("--mla-absorbed")
    if args.device:
        argv += ["--device", args.device]
    return serve_mod.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
