"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the hand-written kernels from ``src/repro_torch/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch twin on the card, at the
   main path's shapes and at edge shapes (AES byte-exact, eq. 14 within
   1e-6 of the largest output, the LSTM cell within 1e-5);
4. the main path: Algorithm 1 as ``examples/quickstart.py`` runs it, at full
   width (3,000 HAR windows, T=32, F=6, H=64, 6 classes, 5 contributors
   pretrained for 6 epochs, 10 rounds of 8 epochs, AES transport) with
   every launch count set to 0 just before ``EnFedSession.run`` and read
   just after; then the same world over the whole round budget (timing
   only), and one round of it on the card and on the CPU, whose parameters
   must agree;
5. time each kernel with CUDA events at the main path's shapes, beside its
   plain twin, the closest PyTorch library call and its bound on the card;
6. trace one fit epoch: device-busy share and the kernels that take it;
7. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last
   line ``{"ok": true, "device": {...}}``.

It imports only ``repro_torch`` (no JAX) and needs one CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
AES_OPS_PER_BLOCK = 11 * 16 + 10 * 16 + 9 * 4 * 20 + 16   # xor, S-box, MixColumns, payload
FIT_EPOCHS, MAX_ROUNDS, PRETRAIN_EPOCHS = 8, 10, 6


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` between two CUDA events, after
    warm-up (host launch overhead included, as the path pays it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, kernel_name: str, iters: int = 50):
    """Mean device microseconds per launch of the CUDA kernel whose name
    contains ``kernel_name``, from ``torch.profiler``; None if the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel_name in e.key]
    total = sum(e.self_device_time_total for e in hits)
    return total / sum(e.count for e in hits) if total > 0 else None


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain twins
# ---------------------------------------------------------------------------


def check_fedavg(dev, main_shape):
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_ref

    g = torch.Generator().manual_seed(0)
    main_err = None
    cases = [("main", main_shape, None), ("ragged L", (2, 3, 1000 + 7), None),
             ("zero weight row", (3, 4, 2048 + 1), 1), ("N=1", (1, 1, 513), None),
             ("R=8", (8, 5, 4096), None)]
    for name, (r, n, l), zero_row in cases:
        u = torch.randn((r, n, l), generator=g).to(dev)
        w = torch.rand((r, n), generator=g).to(dev) + 0.1
        if zero_row is not None:
            w[zero_row] = 0.0
        got = fedavg_batched_cuda(u, w)
        torch.cuda.synchronize()
        want = fedavg_batched_ref(u, w)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= 1e-6 * max(scale, 1.0):
            fail(f"fedavg {name} {(r, n, l)}: max abs err {err} (scale {scale})")
        if zero_row is not None and bool(got[zero_row].ne(0).any()):
            fail("fedavg: an all-zero weight row must give zeros")
        print(f"  fedavg {name:16s} R,N,L={r},{n},{l}: max abs err {err:.3e}")
        if name == "main":
            main_err = err
    return main_err


def check_lstm(dev, fit_b, score_b, f, h):
    from repro_torch.kernels.lstm_cell.kernel import lstm_cell_cuda
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

    g = torch.Generator().manual_seed(1)
    main_err = None
    for name, (b, ff, hh) in [("main fit", (fit_b, f, h)), ("main score", (score_b, f, h)),
                              ("B,H not /32", (33, 5, 40)), ("B=1", (1, f, h)),
                              ("H=1", (7, 3, 1))]:
        args = [torch.randn(s, generator=g).to(dev) * sc for s, sc in [
            ((b, ff), 1.0), ((b, hh), 0.5), ((b, hh), 0.5), ((ff, 4 * hh), 0.4),
            ((hh, 4 * hh), 1.0 / math.sqrt(hh)), ((4 * hh,), 0.1)]]
        hk, ck = lstm_cell_cuda(*args)
        torch.cuda.synchronize()
        hr, cr = lstm_cell_ref(*args)
        err = max(float((hk - hr).abs().max()), float((ck - cr).abs().max()))
        if not err <= 1e-5:
            fail(f"lstm_cell {name} B,F,H={b},{ff},{hh}: max abs err {err}")
        print(f"  lstm_cell {name:13s} B,F,H={b},{ff},{hh}: max abs err {err:.3e}")
        if name == "main fit":
            main_err = err
    return main_err


def check_aes(dev, main_n):
    from repro_torch.core import crypto
    from repro_torch.kernels.aes_ctr.kernel import aes_ctr_cuda
    from repro_torch.kernels.aes_ctr.ref import aes_ctr_ref

    rng = np.random.default_rng(2)
    tables = torch.from_numpy(crypto.TABLES).to(dev)
    rk = torch.from_numpy(crypto.expand_key(rng.integers(0, 256, 16).astype(np.uint8))).to(dev)
    nonce = torch.from_numpy(rng.integers(0, 256, 8).astype(np.uint8)).to(dev)
    for name, n, offset in [("main", main_n, 0), ("n%16!=0", main_n + 5, 0),
                            ("n<16", 7, 0), ("n=16", 16, 0), ("unaligned", 1000 + 3, 1)]:
        buf = torch.from_numpy(rng.integers(0, 256, n + offset).astype(np.uint8)).to(dev)
        pay = buf[offset:]
        got = aes_ctr_cuda(pay, rk, nonce, tables)
        torch.cuda.synchronize()
        if not torch.equal(got, aes_ctr_ref(pay, rk, nonce, tables)):
            fail(f"aes_ctr {name} n={n}: ciphertext differs from the plain version")
        if not torch.equal(aes_ctr_cuda(got, rk, nonce, tables), pay):
            fail(f"aes_ctr {name} n={n}: decrypt(encrypt(x)) != x")
        print(f"  aes_ctr {name:10s} n={n}: byte-exact")
    return 0.0


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def quickstart_world(device):
    from repro_torch.core import SupervisedTask, make_fleet
    from repro_torch.data import HARDatasetConfig, dirichlet_partition, make_har_windows
    from repro_torch.models import LSTMClassifier, LSTMClassifierConfig

    x, y, _ = make_har_windows(HARDatasetConfig(num_samples=3000, seq_len=32))
    parts = dirichlet_partition(y, num_clients=6, alpha=1.0, seed=0)
    shards = [(x[p], y[p]) for p in parts]
    own_x, own_y = shards[0]
    n_train = int(len(own_x) * 0.8)
    own_train = (own_x[:n_train], own_y[:n_train])
    own_test = (own_x[n_train:], own_y[n_train:])
    task = SupervisedTask(LSTMClassifier(LSTMClassifierConfig(
        input_dim=6, seq_len=32, hidden=64, num_classes=6), device=device), lr=3e-3)
    fleet = make_fleet(5, seed=1, p_has_model=1.0)
    for dev in fleet:
        dev.reservation_price = 0.4       # all accept a 0.6 incentive
    return task, shards, own_train, own_test, fleet


def session_cfg(max_rounds):
    from repro_torch.core import EnFedConfig

    return EnFedConfig(desired_accuracy=0.95, max_rounds=max_rounds, n_max=5,
                       battery_threshold=0.2, offered_incentive=0.6,
                       epochs=FIT_EPOCHS, batch_size=32, encrypt=True)


def contributor_states(pretrained, shards, fleet, device):
    return {dev.device_id: {"params": {k: v.to(device).clone() for k, v in pretrained[i].items()},
                            "data": shards[i + 1]}
            for i, dev in enumerate(fleet)}


def run_main_path(device, world):
    from repro_torch import kernels
    from repro_torch.core import EnFedSession, SupervisedTask
    from repro_torch.core.protocol import STOP_REASONS
    from repro_torch.models import LSTMClassifier
    from repro_torch.utils.tree import tree_leaves

    task, shards, own_train, own_test, fleet = world
    t0 = time.perf_counter()
    pretrained = []
    for i in range(len(fleet)):
        params, _ = task.fit(task.init(seed=10 + i), shards[i + 1], epochs=PRETRAIN_EPOCHS,
                             batch_size=32, seed=i)
        pretrained.append(params)
    torch.cuda.synchronize()
    print(f"  pretrained 5 contributors x {PRETRAIN_EPOCHS} epochs in "
          f"{time.perf_counter() - t0:.2f} s")

    session = EnFedSession(task, own_train, own_test, fleet,
                           contributor_states(pretrained, shards, fleet, device),
                           session_cfg(MAX_ROUNDS), device=device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = session.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()

    if not all(counts[k] > 0 for k in ("fedavg", "lstm_cell", "aes_ctr")):
        fail(f"a kernel of the main path was never launched: {counts}")
    if not (math.isfinite(res.accuracy) and res.accuracy > 1.0 / 6):
        fail(f"accuracy {res.accuracy} is not finite and above chance")
    if res.stop_reason not in STOP_REASONS:
        fail(f"invalid stop reason {res.stop_reason!r}")
    if not all(bool(torch.isfinite(p).all()) for p in tree_leaves(res.params)):
        fail("non-finite parameters after the session")
    print(f"  accuracy {res.accuracy:.4f}, rounds {res.rounds}, stop {res.stop_reason}, "
          f"{res.n_contributors} contributors, {res.model_bytes} B per update")
    print(f"  session wall {wall:.2f} s; per phase (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.phase_s.items()))
    print(f"  launches in the session: {counts}")
    print(f"  eq.4 T_train {res.report.t_train:.3f} s, E_tot {res.report.e_tot:.3f} J, "
          f"battery {res.battery.percent:.2f} %")

    # the whole round budget (an accuracy no round reaches), refresh included
    full = EnFedSession(task, own_train, own_test, fleet,
                        contributor_states(pretrained, shards, fleet, device),
                        dataclasses.replace(session_cfg(MAX_ROUNDS), desired_accuracy=1.01),
                        device=device)
    t0 = time.perf_counter()
    fres = full.run()
    torch.cuda.synchronize()
    print(f"  full budget ({fres.rounds} rounds, stop {fres.stop_reason}): wall "
          f"{time.perf_counter() - t0:.2f} s, accuracy {fres.accuracy:.4f}; per phase (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in fres.phase_s.items()))

    # one round of the same world on the card and on the CPU
    cpu = torch.device("cpu")
    cpu_task = SupervisedTask(LSTMClassifier(task.model.cfg, device=cpu), lr=task.lr)
    card, host = (EnFedSession(tk, own_train, own_test, fleet,
                               contributor_states(pretrained, shards, fleet, d),
                               session_cfg(1), device=d).run()
                  for d, tk in ((device, task), (cpu, cpu_task)))
    diff = max(float((a.cpu() - b).abs().max()) for a, b in
               zip(tree_leaves(card.params), tree_leaves(host.params)))
    # fp32 sums in another order on the card than on the CPU, compounded
    # over 8 epochs of Adam (2.1e-7 observed on an H100): 500x headroom
    tol = 1e-4
    print(f"  one round card vs CPU: max abs param diff {diff:.3e} (tolerance {tol}), "
          f"loss {card.history_raw['loss'][-1]:.6f} vs {host.history_raw['loss'][-1]:.6f}")
    if not diff <= tol:
        fail(f"one round on the card and on the CPU differ by {diff}")
    return counts


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def time_kernels(dev, counts, errs, n_params, fit_b, score_b, f, h, n_contrib):
    from repro_torch.core import crypto
    from repro_torch.kernels.aes_ctr.kernel import aes_ctr_cuda
    from repro_torch.kernels.aes_ctr.ref import aes_ctr_ref
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_ref
    from repro_torch.kernels.lstm_cell.kernel import lstm_cell_cuda
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

    g = torch.Generator().manual_seed(3)
    rows = []

    # eq. 14 at (R, N, L) = (1, 5, P)
    r, n, l = 1, n_contrib, n_params
    u = torch.randn((r, n, l), generator=g).to(dev)
    w = torch.ones((r, n)).to(dev)
    ms = cuda_ms(lambda: fedavg_batched_cuda(u, w))
    plain = cuda_ms(lambda: fedavg_batched_ref(u, w))
    lib = cuda_ms(lambda: torch.einsum("rn,rnl->rl", w, u) / w.sum(dim=1, keepdim=True))
    b_ms, b_by = bound_ms(4 * (r * n * l + r * n + r * l), 2 * r * n * l + r * l)
    dev_us = device_us(lambda: fedavg_batched_cuda(u, w), "fedavg_kernel")
    rows.append(dict(name="fedavg", route="cuda", device_us=dev_us,
                     source="src/repro_torch/csrc/fedavg.cu",
                     replaces="src/repro/kernels/fedavg/kernel.py:157",
                     launches=counts["fedavg"], max_abs_err=errs["fedavg"], ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                     shape=f"R,N,L={r},{n},{l}"))

    # LSTM cell at the fit shape (B, F, H) = (32, 6, 64)
    b = fit_b
    x = torch.randn((b, f), generator=g).to(dev)
    hh = torch.randn((b, h), generator=g).to(dev) * 0.5
    cc = torch.randn((b, h), generator=g).to(dev) * 0.5
    wx = torch.randn((f, 4 * h), generator=g).to(dev) * 0.4
    wh = torch.randn((h, 4 * h), generator=g).to(dev) / math.sqrt(h)
    bb = torch.randn((4 * h,), generator=g).to(dev) * 0.1
    wx_t, wh_t, zero_b = wx.t().contiguous(), wh.t().contiguous(), torch.zeros_like(bb)
    ms = cuda_ms(lambda: lstm_cell_cuda(x, hh, cc, wx, wh, bb))
    plain = cuda_ms(lambda: lstm_cell_ref(x, hh, cc, wx, wh, bb))
    lib = cuda_ms(lambda: torch.lstm_cell(x, (hh, cc), wx_t, wh_t, bb, zero_b))
    nbytes = 4 * (b * f + 2 * b * h + f * 4 * h + h * 4 * h + 4 * h + 2 * b * h)
    ops = 2 * b * (f + h) * 4 * h + 2 * b * 4 * h + 10 * b * h
    b_ms, b_by = bound_ms(nbytes, ops)
    dev_us = device_us(lambda: lstm_cell_cuda(x, hh, cc, wx, wh, bb), "lstm_cell_kernel")
    rows.append(dict(name="lstm_cell", route="cuda", device_us=dev_us,
                     source="src/repro_torch/csrc/lstm_cell.cu",
                     replaces="src/repro/kernels/lstm_cell/kernel.py:66",
                     launches=counts["lstm_cell"], max_abs_err=errs["lstm_cell"], ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                     shape=f"B,F,H={b},{f},{h} (scoring uses B={score_b})"))

    # AES-CTR over one fp32 update
    nb = 4 * n_params
    rng = np.random.default_rng(4)
    pay = torch.from_numpy(rng.integers(0, 256, nb).astype(np.uint8)).to(dev)
    tables = torch.from_numpy(crypto.TABLES).to(dev)
    rk = torch.from_numpy(crypto.expand_key(rng.integers(0, 256, 16).astype(np.uint8))).to(dev)
    nonce = torch.from_numpy(rng.integers(0, 256, 8).astype(np.uint8)).to(dev)
    ms = cuda_ms(lambda: aes_ctr_cuda(pay, rk, nonce, tables))
    plain = cuda_ms(lambda: aes_ctr_ref(pay, rk, nonce, tables), iters=50, warmup=5)
    blocks = (nb + 15) // 16
    b_ms, b_by = bound_ms(2 * nb + 768 + 176 + 8, blocks * AES_OPS_PER_BLOCK)
    dev_us = device_us(lambda: aes_ctr_cuda(pay, rk, nonce, tables), "aes_ctr_kernel")
    rows.append(dict(name="aes_ctr", route="cuda", device_us=dev_us,
                     source="src/repro_torch/csrc/aes_ctr.cu",
                     replaces="src/repro/kernels/aes_ctr/kernel.py:70",
                     launches=counts["aes_ctr"], max_abs_err=errs["aes_ctr"], ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     shape=f"n={nb} B ({blocks} blocks)"))
    for row in rows:
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.5f}"
        dus = "not measured" if row["device_us"] is None else f"{row['device_us']:.3f}"
        print(f"  {row['name']:9s} {row['shape']}: kernel_ms {row['ms']:.5f}  device_us {dus}  "
              f"plain_ms {row['plain_ms']:.5f}  library_ms {lib}  "
              f"bound_ms {row['bound_ms']:.6f} ({row['bound_by']})  "
              f"launches/session {row['launches']}")
    return rows


# ---------------------------------------------------------------------------
# phase 6: where the time goes in fit
# ---------------------------------------------------------------------------


def fit_device_view(task, own_train):
    """One requester fit epoch at the main path's shapes, traced: wall time,
    device-busy time, and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    params = task.init(0)
    task.fit(params, own_train, 1, 32, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.fit(params, own_train, 1, 32, seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.fit(params, own_train, 1, 32, seed=1)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_s = sum(e.self_device_time_total for e in kern) * 1e-6
    steps = len(own_train[0]) // 32
    print(f"  one fit epoch ({steps} steps of B=32): wall {wall * 1e3:.2f} ms untraced, "
          f"{traced * 1e3:.2f} ms traced; device busy {busy_s * 1e3:.3f} ms "
          f"({100 * busy_s / traced:.1f} % of the traced wall, idle {100 - 100 * busy_s / traced:.1f} %)")
    if not kern:
        print("  device time: not measured (the profiler saw no kernels)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} launches  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets the TF32 policy)
    from repro_torch.kernels import _build
    from repro_torch.utils.tree import tree_size

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    path, log = _build.build(verbose=True)
    secs = time.perf_counter() - t0
    print(f"[2] kernels built in {secs:.2f} s -> {path.relative_to(ROOT)}")
    for line in log.splitlines():
        if "registers" in line or line.startswith("=="):
            print("    " + line.strip())

    # the main path's shapes, from the quickstart world itself
    world = quickstart_world(dev)
    task, _, own_train, own_test, _ = world
    cfg = task.model.cfg
    f, h, n_contrib = cfg.input_dim, cfg.hidden, 5
    n_params = tree_size(task.init(0))
    fit_b, score_b = min(32, len(own_train[0])), len(own_test[0])
    print("[3] kernels against their plain versions on the card")
    errs = {"fedavg": check_fedavg(dev, (1, n_contrib, n_params)),
            "lstm_cell": check_lstm(dev, fit_b, score_b, f, h),
            "aes_ctr": check_aes(dev, 4 * n_params)}

    print("[4] main path: the quickstart session at full width on the card")
    counts = run_main_path(dev, world)

    print("[5] kernel timings at the main path's shapes (CUDA events)")
    rows = time_kernels(dev, counts, errs, n_params, fit_b, score_b, f, h, n_contrib)

    print("[6] where the time goes in fit (torch.profiler)")
    fit_device_view(task, own_train)
    print(f"    total {time.perf_counter() - t_start:.1f} s")

    kernels = [{k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                     "max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")} for row in rows]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
