"""Batched serving driver: prefill a prompt batch, then decode tokens (port
of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch debug-dense \
      --preset smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

It runs on the card unless ``--device`` names another.  The prompts are
the reference's draw bit for bit (``fold_in(PRNGKey(seed), 1)`` then
``randint``, through ``repro_torch.core.prng``); the weights come from a
``torch.Generator`` seeded with ``--seed``, and the sampled tokens from one
seeded with ``--seed + 4``, so neither is the reference's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import prng
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import Transformer


def draw_prompts(seed: int, batch: int, prompt_len: int, vocab: int, *,
                 partitionable: bool = True, device=None) -> torch.Tensor:
    """The reference's prompts: ``jax.random.randint(fold_in(PRNGKey(seed),
    1), (batch, prompt_len), 0, vocab)`` as int64 on ``device``."""
    key = prng.fold_in(prng.prng_key(seed), 1)
    toks = prng.randint(key, (batch, prompt_len), 0, vocab, partitionable=partitionable)
    return toks.to(device=device, dtype=torch.int64)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="debug-dense")
    ap.add_argument("--preset", choices=("full", "smoke"), default="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--mla-absorbed", action="store_true")
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
    params = model.init(torch.Generator().manual_seed(args.seed))
    B = args.batch
    max_len = args.prompt_len + args.gen

    prompts = draw_prompts(args.seed, B, args.prompt_len, cfg.vocab_size, device=dev)
    noise = torch.Generator().manual_seed(args.seed + 2)
    memory = None
    if cfg.frontend == "audio":
        frames = torch.randn((B, 16, cfg.d_model), generator=noise).to(dev)
        memory = model.encode(params, frames)
    # a vision prefix enters the decode cache only through a prefill forward;
    # the sequential prefill below feeds tokens alone, as the reference's does

    serve_step = make_serve_step(model, mla_absorbed=args.mla_absorbed)

    # prefill via sequential decode into the cache (cache-building path),
    # which exercises the same serve_step the decode loop runs
    cache = model.init_cache(B, max_len)
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits = None
        for t in range(args.prompt_len):
            logits, cache = serve_step(params, cache, prompts[:, t:t + 1], t, memory)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        out_tokens = []
        sampler = torch.Generator(device=dev).manual_seed(args.seed + 4)
        t0 = time.perf_counter()
        for t in range(args.gen):
            probs = torch.softmax(logits[:, 0] / args.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=sampler)
            out_tokens.append(nxt)
            logits, cache = serve_step(params, cache, nxt, args.prompt_len + t, memory)
        _sync(dev)
        t_gen = time.perf_counter() - t0

    toks = torch.cat(out_tokens, dim=1).cpu().numpy()
    print(f"[serve] {cfg.name}: batch={B} prompt={args.prompt_len} gen={args.gen} "
          f"device={dev}")
    print(f"[serve] prefill {t_prefill:.2f}s ({B * args.prompt_len / max(t_prefill, 1e-9):.1f} "
          f"tok/s); decode {t_gen:.2f}s ({B * args.gen / max(t_gen, 1e-9):.1f} tok/s)")
    print(f"[serve] sample token ids: {toks[0][:12].tolist()}")
    assert toks.shape == (B, args.gen)
    assert np.isfinite(logits.cpu().numpy()).all()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
