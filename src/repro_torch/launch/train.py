"""End-to-end federated LM training driver (port of ``repro.launch.train``).

Trains a registry architecture (``--arch``) at its registered widths
(``--preset full``) or at ``--preset smoke`` scale, with the EnFed
aggregation strategy as a first-class flag.  Clients are simulated with
the client-stacked ``FederatedTrainer`` (exact per-client semantics); the
per-round participation mask comes from the incentive/contract layer, and
battery/energy accounting per the paper runs alongside.

  PYTHONPATH=src python -m repro_torch.launch.train --arch debug-dense \
      --preset smoke --steps 50 --strategy enfed --clients 8 --neighborhood 4 \
      [--device cpu]

It runs on the card unless ``--device`` names another device.  The token
stream, the contracts and the battery are the reference's (numpy, the same
seeds); the initial weights come from a CPU ``torch.Generator`` seeded with
``--seed``, so every device starts from the same weights, but not from the
reference's.  A resumed run numbers its steps from the checkpoint's step
while its token stream starts again at batch 0, as the reference's does.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.battery import BatteryState
from repro_torch.core.energy import CostModel
from repro_torch.core.federated import FederatedTrainer
from repro_torch.core.incentive import make_fleet, participation_mask, select_contributors
from repro_torch.core.topology import AggregationStrategy
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.steps import lm_loss
from repro_torch.models import Transformer
from repro_torch.optim import AdamState
from repro_torch.utils.tree import from_jax_params, tree_bytes, tree_size


@dataclasses.dataclass
class TrainRun:
    """What one call of :func:`train` did, step by step."""

    losses: List[float]                  # the clients' mean loss, per step
    masks: List[Optional[np.ndarray]]    # the participation mask (enfed), per step
    battery: List[float]                 # the battery level after each step
    start: int                           # the restored step (0 on a fresh run)
    params: dict                         # the stacked params after the last step
    opt_state: object                    # the stacked AdamState after the last step
    tokens_per_s: float                  # training tokens over the loop's wall


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(argv=None, params_one=None) -> TrainRun:
    """The driver's run; ``params_one`` (one client's params on the run's
    device) replaces the seeded init."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="debug-dense")
    ap.add_argument("--preset", choices=("full", "smoke"), default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8, help="global batch (tokens rows)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--strategy", default="enfed",
                    choices=("cfl", "enfed", "dfl_ring", "dfl_mesh", "none"))
    ap.add_argument("--neighborhood", type=int, default=2)
    ap.add_argument("--incentive", type=float, default=0.6)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.smoke()
    cfg = cfg.replace(dtype="float32")
    model = Transformer(cfg, device=dev)
    C = args.clients
    if args.batch % C:
        ap.error("global batch must divide across clients")

    strategy = AggregationStrategy(kind=args.strategy,
                                   neighborhood_size=args.neighborhood)
    trainer = FederatedTrainer(
        loss_fn=lambda p, b: lm_loss(model, p, b),
        num_clients=C, strategy=strategy, lr=args.lr,
        local_steps=args.local_steps)

    if params_one is None:
        params_one = model.init(torch.Generator().manual_seed(args.seed))
    n_params = tree_size(params_one)
    print(f"[train] {cfg.name} preset={args.preset} params={n_params/1e6:.1f}M "
          f"clients={C} strategy={args.strategy} device={dev}")
    stacked, opt_state = trainer.init(params_one)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        (params, opt), start = restore_checkpoint(args.ckpt_dir, (stacked, opt_state))
        stacked = from_jax_params(params, dev)
        opt_state = AdamState(*(from_jax_params(v, dev) for v in opt))
        print(f"[train] restored step {start} from {args.ckpt_dir}")

    # incentive fleet drives the per-round participation mask
    fleet = make_fleet(C, seed=args.seed + 1, p_has_model=1.0)
    cost = CostModel()
    battery = BatteryState()

    gen = synthetic_token_batches(cfg.vocab_size, args.batch * args.local_steps,
                                  args.seq, num_batches=args.steps,
                                  seed=args.seed + 2)
    history, masks, levels = [], [], []
    _sync(dev)
    t0 = time.perf_counter()
    for step, flat in enumerate(gen, start=start):
        batch = {
            k: torch.from_numpy(v.reshape(C, args.local_steps, args.batch // C, args.seq))
            .to(dev, torch.int64)
            for k, v in flat.items()
        }
        contracts = select_contributors(fleet, args.incentive, n_max=C)
        mask = participation_mask(C, contracts) if args.strategy == "enfed" else None
        stacked, opt_state, losses = trainer.round(stacked, opt_state, batch, mask)
        # energy bookkeeping for the (virtual) requesting client 0
        rep = cost.session(rounds=1, n_contrib=int(mask.sum()) if mask is not None else C,
                           num_params=n_params, model_bytes=tree_bytes(params_one),
                           num_samples=args.batch // C * args.seq, epochs=1)
        battery = battery.discharge(rep.e_tot, cost.device.p_train)
        loss = float(torch.mean(losses))
        history.append(loss)
        masks.append(mask)
        levels.append(battery.level)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"({dt:.1f}s, battery {battery.percent:.1f}%)", flush=True)
        if args.ckpt_dir and step > 0 and step % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step, (stacked, opt_state))
    _sync(dev)
    wall = time.perf_counter() - t0
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, start + args.steps, (stacked, opt_state))
    tokens = args.steps * args.batch * args.local_steps * args.seq
    return TrainRun(losses=history, masks=masks, battery=levels, start=start,
                    params=stacked, opt_state=opt_state,
                    tokens_per_s=tokens / max(wall, 1e-9))


def main(argv=None):
    run = train(argv)
    history = run.losses
    improved = history[-1] < history[0]
    print(f"[train] done: loss {history[0]:.4f} -> {history[-1]:.4f} "
          f"({'improved' if improved else 'NOT improved'}); "
          f"{run.tokens_per_s:.1f} training tokens/s")
    return 0 if improved else 1


if __name__ == "__main__":
    raise SystemExit(main())
