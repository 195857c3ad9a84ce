"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the hand-written kernels from ``src/repro_torch/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch twin on the card, at the
   main paths' shapes and at edge shapes (AES, quantize and dequantize
   bit-exact, eq. 14 dense and int8 within 1e-6 of the largest output, the
   LSTM cell within 1e-5, one lane and the fleet's fit, score and refresh
   lanes, with the weights as views of the fleet's flat buffers; the LSTM's
   whole-sequence forward within 1e-5 (every saved state) and its backward
   within 1e-4 of each output's largest value, at the loop's and the
   fleet's fit and scoring shapes; the robust
   trimmed mean and median within 1e-6 of the largest output, the squared
   norm within 1e-5 relative, each int8 robust kernel bit-equal to its
   dense kernel on the dequantized buffer);
4. the main paths, each with every launch count set to 0 just before it
   and read just after; on each, the sequence forward is launched once per
   forward pass of the LSTM and the backward once per training pass:
   - Algorithm 1 as ``examples/quickstart.py`` runs it, at full width
     (3,000 HAR windows, T=32, F=6, H=64, 6 classes, 5 contributors
     pretrained for 6 epochs, 10 rounds of 8 epochs, AES transport); then
     the same world over 10 rounds with refresh (timing only), and one
     round of it on the card and on the CPU, whose parameters must agree;
   - the same session with ``compress="int8"``;
   - the fleet engine: 64 requesters of the HAR LSTM at full width sharing
     those 5 contributors, with ``compress=None`` and ``"int8"``; then one
     fleet round of 4 requesters (8 fit epochs) on the card and on the CPU,
     whose parameters must agree within a limit that lies above the CPU's
     own spread under a one-ulp perturbation of the contributors and below
     the difference a 1e-4 relative fault makes;
   - the Byzantine world (20 % of the links send noise of scale 10): the
     quickstart session with ``robust="clip"``, fp32 and int8, 3 rounds;
     the 64-requester fleet for 3 rounds undefended and with each robust
     method, fp32 and int8; one 4-requester round under clip on the card
     and on the CPU, whose corrupted and clipped masks must be equal;
5. time each kernel with CUDA events at the main paths' shapes, beside its
   plain twin, the closest PyTorch library call and its bound on the card
   (the LSTM's two kernels per sequence at 1 and 64 lanes, beside cuDNN's
   ``torch.lstm``);
6. trace one fit epoch of the loop engine and one round of the 64-requester
   fleet: device-busy share, launches per Adam step and the kernels that
   take the device time;
7. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last
   line ``{"ok": true, "device": {...}}``.

It imports only ``repro_torch`` (no JAX) and needs one CUDA device.
"""

from __future__ import annotations

import dataclasses
import functools
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
TIMING_ROUNDS = 10             # depth of the loop engine's timing session
FLEET_R = 64                   # requesters of the fleet path
TILE = 1024                    # int8 wire tile
# one fp32 fleet round (8 epochs of Adam), card vs CPU: the CPU's own spread
# under a 1e-7 relative perturbation of the contributors stays below it, a
# 1e-4 relative fault lands above it (both measured in every run)
FLEET_ROUND_TOL = 2e-3
ULP_REL, FAULT_REL = 1e-7, 1e-4
# the Byzantine world of [4d]: 20 % of the links deliver noise of scale 10
ADVERSARY = dict(p_byzantine=0.2, attack="noise", scale=10.0, seed=7)
ADV_ROUNDS = 3


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


def check_fedavg(dev, main_shape, fleet_shape):
    """Eq. 14 at the loop's (1, N, P), at the fleet's (R, N, P) and at edge
    shapes; returns the max abs errors at the two main shapes."""
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_ref

    g = torch.Generator().manual_seed(0)
    errs = {}
    cases = [("main", main_shape, None), ("fleet", fleet_shape, None),
             ("ragged L", (2, 3, 1000 + 7), None),
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
        errs[name] = err
    return errs["main"], errs["fleet"]


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


def check_lane_lstm(dev, spec, n_params, fit_b, score_b, refresh_rows):
    """The cell with a lane axis at the fleet's shapes, as the fleet calls
    it: wx, wh and b are ``tree_unravel`` views of a flat (L, P) buffer (the
    fp32 aggregate, the trained params, the refresh rows) or of an
    (L, Lp)[:, :P] slice (the int8 aggregate and the dequantized refresh
    rows), so the lane stride is P or Lp.  Returns the largest error."""
    from repro_torch.kernels.lstm_cell.kernel import lstm_cell_cuda
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
    from repro_torch.utils.tree import tree_unravel

    g = torch.Generator().manual_seed(5)
    lp = n_params + (-n_params) % TILE
    worst = 0.0
    for name, lanes, b, padded in [("fit fp32", FLEET_R, fit_b, False),
                                   ("fit int8", FLEET_R, fit_b, True),
                                   ("score", FLEET_R, score_b, False),
                                   ("refresh fp32", refresh_rows, fit_b, False),
                                   ("refresh int8", refresh_rows, fit_b, True)]:
        buf = torch.randn((lanes, lp if padded else n_params), generator=g).to(dev) * 0.3
        p = tree_unravel(spec, buf[:, :n_params])
        wx, wh, bias = p["wx"], p["wh"], p["b"]
        f, h = wx.shape[1], wh.shape[1]
        x, h0, c0 = (torch.randn(sh, generator=g).to(dev) * sc for sh, sc in [
            ((lanes, b, f), 1.0), ((lanes, b, h), 0.5), ((lanes, b, h), 0.5)])
        hk, ck = lstm_cell_cuda(x, h0, c0, wx, wh, bias)
        torch.cuda.synchronize()
        hr, cr = lstm_cell_ref(x, h0, c0, wx, wh, bias)
        err = max(float((hk - hr).abs().max()), float((ck - cr).abs().max()))
        if not err <= 1e-5:
            fail(f"lstm_cell {name} L,B,F,H={lanes},{b},{f},{h}: max abs err {err}")
        print(f"  lstm_cell {name:13s} L,B,F,H={lanes},{b},{f},{h}, lane stride "
              f"{wx.stride(0)}: max abs err {err:.3e}")
        worst = max(worst, err)
    return worst


def check_lstm_seq(dev, spec, n_params, fit_b, score_b, fleet_score_b, seq_len):
    """The whole-sequence forward and backward kernels at (L, B) = (1, fit),
    (1, score), (64, fit) and (64, fleet score), T = ``seq_len``; at 64
    lanes the weights are ``tree_unravel`` views of a flat (L, P) buffer
    (fp32 fit) or of an (L, Lp)[:, :P] slice (int8).  The forward must
    agree with its twin within 1e-5 on h_T, c_T and every saved state; the
    backward (from the kernel's saved states) within 1e-4 of each twin
    output's largest value on dgates, dh0, dc0 and on the weight gradients
    the wrapper forms from dgates.  Returns the largest forward and backward
    abs errors."""
    from repro_torch.kernels.lstm_cell.kernel import lstm_seq_backward_cuda, lstm_seq_cuda
    from repro_torch.kernels.lstm_cell.ops import lstm_seq_backward
    from repro_torch.kernels.lstm_cell.ref import lstm_seq_backward_ref, lstm_seq_ref
    from repro_torch.utils.tree import tree_unravel

    g = torch.Generator().manual_seed(13)
    lp = n_params + (-n_params) % TILE
    fwd_worst = bwd_worst = 0.0
    for name, lanes, b, padded in [("loop fit", 1, fit_b, False),
                                   ("loop score", 1, score_b, False),
                                   ("fleet fit fp32", FLEET_R, fit_b, False),
                                   ("fleet fit int8", FLEET_R, fit_b, True),
                                   ("fleet score", FLEET_R, fleet_score_b, False)]:
        buf = torch.randn((lanes, lp if padded else n_params), generator=g).to(dev) * 0.3
        p = tree_unravel(spec, buf[:, :n_params])
        wx, wh, bias = p["wx"], p["wh"], p["b"]
        f, h = wx.shape[1], wh.shape[1]
        x = torch.randn((lanes, seq_len, b, f), generator=g).to(dev)
        h0, c0, dh, dc = (torch.randn((lanes, b, h), generator=g).to(dev) * 0.5
                          for _ in range(4))
        hs, cs = lstm_seq_cuda(x, h0, c0, wx, wh, bias, save=True)
        h_t, c_t = lstm_seq_cuda(x, h0, c0, wx, wh, bias)
        torch.cuda.synchronize()
        hr, cr = lstm_seq_ref(x, h0, c0, wx, wh, bias)
        ferr = max(float((hs - hr).abs().max()), float((cs - cr).abs().max()))
        if not ferr <= 1e-5:
            fail(f"lstm_seq forward {name} L,B,T={lanes},{b},{seq_len}: max abs err {ferr}")
        if not (torch.equal(h_t, hs[:, -1]) and torch.equal(c_t, cs[:, -1])
                and torch.equal(hs[:, 0], h0) and torch.equal(cs[:, 0], c0)):
            fail(f"lstm_seq forward {name}: final or initial states differ from the saved ones")
        dgates, dh0, dc0 = lstm_seq_backward_cuda(x, hs, cs, wx, wh, bias, dh, dc)
        full = lstm_seq_backward(x, hs, cs, wx, wh, bias, dh, dc, need_dx=False)
        torch.cuda.synchronize()
        want = lstm_seq_backward_ref(x, hs, cs, wx, wh, bias, dh, dc)
        parts = []
        for out, got, w in zip(("dgates", "dh0", "dc0", "dwx", "dwh", "db"),
                               (dgates, dh0, dc0) + tuple(full[4:]), want[:3] + want[4:]):
            err = float((got - w).abs().max())
            scale = float(w.abs().max())
            if not err <= 1e-4 * scale:
                fail(f"lstm_seq backward {name} {out}: max abs err {err} (largest {scale})")
            parts.append(f"{out} {err:.2e}/{scale:.2e}")
            bwd_worst = max(bwd_worst, err)
        fwd_worst = max(fwd_worst, ferr)
        print(f"  lstm_seq {name:14s} L,B,F,H,T={lanes},{b},{f},{h},{seq_len}, lane stride "
              f"{wx.stride(0)}: forward max abs err {ferr:.3e}; backward err/largest "
              + ", ".join(parts))
    return fwd_worst, bwd_worst


def check_quantize(dev, n_params, rows):
    """Codes and scales bit-equal to the twin: the 1-D update, the fleet's
    staging rows, an off-tile length, an all-zero tile, half-way codes."""
    from repro_torch.kernels.quantize.kernel import quantize_cuda
    from repro_torch.kernels.quantize.ref import quantize_batched_ref

    g = torch.Generator().manual_seed(6)
    half = torch.zeros(1, 2 * TILE)
    half[0, :6] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    zero_tile = torch.randn((3, 3 * TILE), generator=g)
    zero_tile[1, TILE:2 * TILE] = 0.0
    cases = [("main 1-D", torch.randn((n_params,), generator=g) * 0.3),
             (f"{rows} rows", torch.randn((rows, n_params), generator=g) * 0.3),
             ("off-tile", torch.randn((2, 1000 + 7), generator=g)),
             ("zero tile", zero_tile), ("half-way", half)]
    for name, x in cases:
        xd = x.to(dev)
        q, s = quantize_cuda(xd)
        torch.cuda.synchronize()
        qr, sr = quantize_batched_ref(xd)
        if not (torch.equal(q, qr) and torch.equal(s, sr)):
            fail(f"quantize {name} {tuple(x.shape)}: codes or scales differ from the twin")
        if name == "half-way" and q[0, :6].tolist() != [127, 0, 2, 2, 0, -2]:
            fail(f"quantize half-way: codes {q[0, :6].tolist()} are not round-half-even")
        print(f"  quantize {name:10s} {str(tuple(x.shape)):14s}: codes and scales bit-equal")
    return 0.0


def check_dequantize(dev, n_params):
    from repro_torch.kernels.quantize.kernel import dequantize_cuda
    from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_batched_ref

    g = torch.Generator().manual_seed(7)
    for n in (n_params, 1000 + 7, TILE):
        q, s = quantize_batched_ref(torch.randn((n,), generator=g).to(dev))
        got = dequantize_cuda(q, s, n)
        torch.cuda.synchronize()
        if not torch.equal(got, dequantize_ref(q, s, n)):
            fail(f"dequantize n={n}: differs from the twin")
        print(f"  dequantize n={n}: bit-equal")
    return 0.0


def check_fedavg_q8(dev, main_shape):
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_q8_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_q8_ref
    from repro_torch.kernels.quantize.ref import quantize_batched_ref

    g = torch.Generator().manual_seed(8)
    main_err = None
    for name, (r, n, lp), zero_row in [("main", main_shape, None),
                                       ("zero weight row", (3, 4, 2 * TILE), 1),
                                       ("N=1", (1, 1, TILE), None)]:
        q, s = quantize_batched_ref(torch.randn((r * n, lp), generator=g).to(dev) * 0.3)
        q, s = q.reshape(r, n, lp), s.reshape(r, n, -1)
        w = (torch.rand((r, n), generator=g) + 0.1).to(dev)
        if zero_row is not None:
            w[zero_row] = 0.0
        got = fedavg_batched_q8_cuda(q, s, w)
        torch.cuda.synchronize()
        want = fedavg_batched_q8_ref(q, s, w)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= 1e-6 * max(scale, 1.0):
            fail(f"fedavg_q8 {name} {(r, n, lp)}: max abs err {err} (scale {scale})")
        if zero_row is not None and bool(got[zero_row].ne(0).any()):
            fail("fedavg_q8: an all-zero weight row must give zeros")
        print(f"  fedavg_q8 {name:16s} R,N,Lp={r},{n},{lp}: max abs err {err:.3e}")
        if name == "main":
            main_err = err
    return main_err


def check_robust(dev, n_params, n_contrib):
    """The six robust kernels against their twins, at the fleet's (64, 5, P)
    fp32 and (64, 5, Lp) int8 state and at edge shapes (L off 256, N = 1, 2,
    3, 6 and 16, an all-zero weight row, an inactive lane, tied values and
    tied contributors, a noise-sized outlier).  Each q8 kernel must equal
    its dense kernel on the dequantized buffer bit for bit, and the q8
    squared norm over Lp the dense one over P.  Returns the max abs errors
    at the fleet's shapes."""
    from repro_torch.kernels.quantize.ref import dequantize_batched_ref, quantize_batched_ref
    from repro_torch.kernels.robust import kernel as rk
    from repro_torch.kernels.robust import ref as rr

    g = torch.Generator().manual_seed(11)
    errs = {}
    columns = (("trimmed_mean", rk.trimmed_mean_cuda, rk.trimmed_mean_q8_cuda,
                rr.trimmed_mean_batched_ref),
               ("median", rk.median_cuda, rk.median_q8_cuda, rr.median_batched_ref))
    cases = [("fleet", (FLEET_R, n_contrib, n_params)), ("L%256!=0", (3, 4, 1000 + 7)),
             ("N=1", (2, 1, 777)), ("N=2", (2, 2, 513)), ("N=3", (3, 3, 2048)),
             ("N=6", (4, 6, 1500)), ("N=16", (2, 16, 300))]
    for name, (r, n, l) in cases:
        x = torch.randn((r, n, l), generator=g) * 0.3
        x[0, 0] = torch.randn((l,), generator=g) * 10.0     # a noise-sized outlier
        x[:, :, :64] = torch.round(x[:, :, :64] * 2)         # tied values in a column
        if n > 2:
            x[r - 1, 1] = x[r - 1, 0]                        # tied contributors
        w = torch.rand((r, n), generator=g) + 0.1
        if n > 1:
            w[0, n - 1] = 0.0                                # an inactive lane
        if r > 1:
            w[1] = 0.0                                       # an all-zero weight row
        q, sc = quantize_batched_ref(x.reshape(r * n, l))
        xd, wd = x.to(dev), w.to(dev)
        qd, sd = q.reshape(r, n, -1).to(dev), sc.reshape(r, n, -1).to(dev)
        dq = dequantize_batched_ref(qd, sd).contiguous()
        line = []
        for kname, dense_k, q8_k, twin in columns:
            got = dense_k(xd, wd)
            got8 = q8_k(qd, sd, wd)
            torch.cuda.synchronize()
            want = twin(xd, wd)
            err = float((got - want).abs().max())
            err8 = float((got8 - twin(dq, wd)).abs().max())
            scale = max(float(want.abs().max()), 1.0)
            if not err <= 1e-6 * scale:
                fail(f"{kname} {name} {(r, n, l)}: max abs err {err} (scale {scale})")
            if r > 1 and bool(got[1].ne(0).any()):
                fail(f"{kname} {name}: an all-zero weight row must give zeros")
            if not torch.equal(got8, dense_k(dq, wd)):
                fail(f"{kname}_q8 {name}: not bit-equal to the dense kernel on the "
                     "dequantized buffer")
            line.append(f"{kname} {err:.3e} (q8 {err8:.3e}, bit-equal to dense)")
            if name == "fleet":
                errs[kname], errs[kname + "_q8"] = err, err8
        sq = rk.sqnorm_cuda(xd)
        sq8 = rk.sqnorm_q8_cuda(qd, sd)
        torch.cuda.synchronize()
        want = rr.sqnorm_batched_ref(xd)
        rel = float(((sq - want).abs() / want.clamp_min(1e-30)).max())
        if not rel <= 1e-5:
            fail(f"sqnorm {name} {(r, n, l)}: max rel err {rel}")
        if not torch.equal(sq8, rk.sqnorm_cuda(dq[..., :l].contiguous())):
            fail(f"sqnorm_q8 {name}: the sum over Lp is not bit-equal to the dense sum over P")
        err8 = float((sq8 - rr.sqnorm_batched_q8_ref(qd, sd)).abs().max())
        if name == "fleet":
            errs["sqnorm"], errs["sqnorm_q8"] = float((sq - want).abs().max()), err8
        print(f"  robust {name:8s} R,N,L={r},{n},{l}: " + "; ".join(line)
              + f"; sqnorm rel {rel:.3e} (q8 over Lp bit-equal to dense over P)")
    too_many = torch.zeros((1, rk.MAX_N + 1, 8), device=dev)
    try:
        rk.median_cuda(too_many, torch.ones((1, rk.MAX_N + 1), device=dev))
    except ValueError:
        pass
    else:
        fail(f"the robust column kernels accepted N = {rk.MAX_N + 1} > MAX_N")
    return errs


# ---------------------------------------------------------------------------
# phase 4: the main paths
# ---------------------------------------------------------------------------


class LSTMPasses:
    """Counts the forward passes of the world's LSTM (calls of its
    ``lane_logits``, through which every path reaches the cell) and, of
    those, the ones made with grad mode on, each of which a backward
    follows."""

    def __init__(self, model):
        self.inner = model.lane_logits
        self.total = self.training = 0
        model.lane_logits = self

    def __call__(self, params, x):
        self.total += 1
        self.training += int(torch.is_grad_enabled())
        return self.inner(params, x)


PASSES = None   # the LSTMPasses of the world's model, set in main()


def reset_counts() -> None:
    """Every launch count and pass count to 0, just before a path."""
    from repro_torch import kernels

    kernels.reset_launch_counts()
    PASSES.total = PASSES.training = 0


def read_counts() -> dict:
    """The launch counts just after a path.  The sequence forward must have
    been launched once per forward pass of the LSTM (not once per
    timestep) and the backward once per training pass."""
    from repro_torch import kernels

    counts = kernels.launch_counts()
    print(f"    LSTM passes {PASSES.total} ({PASSES.training} training): lstm_cell "
          f"{counts['lstm_cell']} launches, lstm_cell_bwd {counts['lstm_cell_bwd']}")
    if counts["lstm_cell"] != PASSES.total or counts["lstm_cell_bwd"] != PASSES.training:
        fail(f"the LSTM's kernels were not launched once per pass: {PASSES.total} forward "
             f"and {PASSES.training} training passes, launches {counts}")
    return counts


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
    from repro_torch.core import EnFedSession, SupervisedTask
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
    reset_counts()
    t0 = time.perf_counter()
    res = session.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    if not all(counts[k] > 0 for k in ("fedavg", "lstm_cell", "lstm_cell_bwd", "aes_ctr")):
        fail(f"a kernel of the main path was never launched: {counts}")
    check_session(res, "session")
    print(f"  accuracy {res.accuracy:.4f}, rounds {res.rounds}, stop {res.stop_reason}, "
          f"{res.n_contributors} contributors, {res.model_bytes} B per update")
    print(f"  session wall {wall:.2f} s; per phase (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.phase_s.items()))
    print(f"  launches in the session: {counts}")
    print(f"  eq.4 T_train {res.report.t_train:.3f} s, E_tot {res.report.e_tot:.3f} J, "
          f"battery {res.battery.percent:.2f} %")

    # TIMING_ROUNDS rounds at an accuracy no round reaches, refresh included
    full = EnFedSession(task, own_train, own_test, fleet,
                        contributor_states(pretrained, shards, fleet, device),
                        dataclasses.replace(session_cfg(TIMING_ROUNDS), desired_accuracy=1.01),
                        device=device)
    t0 = time.perf_counter()
    fres = full.run()
    torch.cuda.synchronize()
    print(f"  timing session ({fres.rounds} rounds, stop {fres.stop_reason}): wall "
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
    # over 8 epochs of Adam: the card forms each weight gradient as one
    # product over the T * B rows of a batch, the CPU as T per-step
    # products summed (2.066e-5 observed on an H100, 2.1e-7 while both
    # summed per step)
    tol = 1e-4
    print(f"  one round card vs CPU: max abs param diff {diff:.3e} (tolerance {tol}), "
          f"loss {card.history_raw['loss'][-1]:.6f} vs {host.history_raw['loss'][-1]:.6f}")
    if not diff <= tol:
        fail(f"one round on the card and on the CPU differ by {diff}")
    return counts, pretrained


def check_session(res, what):
    from repro_torch.core.protocol import STOP_REASONS
    from repro_torch.utils.tree import tree_leaves

    if not (math.isfinite(res.accuracy) and res.accuracy > 1.0 / 6):
        fail(f"{what}: accuracy {res.accuracy} is not finite and above chance")
    if res.stop_reason not in STOP_REASONS:
        fail(f"{what}: invalid stop reason {res.stop_reason!r}")
    if not all(bool(torch.isfinite(p).all()) for p in tree_leaves(res.params)):
        fail(f"{what}: non-finite parameters")


def run_loop_int8(device, world, pretrained):
    """The quickstart session with the int8 wire: AES over codes + scales."""
    from repro_torch.core import EnFedSession

    task, shards, own_train, own_test, fleet = world
    session = EnFedSession(task, own_train, own_test, fleet,
                           contributor_states(pretrained, shards, fleet, device),
                           dataclasses.replace(session_cfg(MAX_ROUNDS), compress="int8"),
                           device=device)
    reset_counts()
    t0 = time.perf_counter()
    res = session.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    need = ("quantize", "dequantize", "aes_ctr", "fedavg", "lstm_cell", "lstm_cell_bwd")
    if not all(counts[k] > 0 for k in need):
        fail(f"int8 session: a kernel of its path was never launched: {counts}")
    check_session(res, "int8 session")
    print(f"  int8 session: accuracy {res.accuracy:.4f}, rounds {res.rounds}, stop "
          f"{res.stop_reason}, {res.model_bytes} B per update, wall {wall:.2f} s")
    print(f"  launches in the int8 session: {counts}")
    return counts


@functools.lru_cache(maxsize=None)
def fleet_split():
    """Each requester's (train, test): one shard (80/20) of a HAR set of
    200 * (FLEET_R + 5) windows split over FLEET_R + 5 clients (Dirichlet
    alpha=1), for the first FLEET_R clients."""
    from repro_torch.data import HARDatasetConfig, dirichlet_partition, make_har_windows

    x, y, _ = make_har_windows(HARDatasetConfig(num_samples=200 * (FLEET_R + 5), seq_len=32))
    parts = dirichlet_partition(y, num_clients=FLEET_R + 5, alpha=1.0, seed=0)
    out = []
    for p in parts[:FLEET_R]:
        n = int(len(p) * 0.8)
        out.append(((x[p[:n]], y[p[:n]]), (x[p[n:]], y[p[n:]])))
    return out


def fleet_specs(device, world, pretrained, r_count):
    """``r_count`` requesters of :func:`fleet_split`, all sharing the
    quickstart's 5 pretrained contributors."""
    from repro_torch.core import RequesterSpec

    _, shards, _, _, fleet = world
    states = contributor_states(pretrained, shards, fleet, device)
    return [RequesterSpec(train, test, fleet, states) for train, test in fleet_split()[:r_count]]


def run_fleet_path(device, world, pretrained):
    """The fleet engine at R = 64, fp32 and int8 wire; then one round of 4
    requesters on the card and on the CPU (:func:`fleet_round_check`)."""
    from repro_torch.core import run_fleet
    from repro_torch.core.protocol import STOP_REASONS
    from repro_torch.utils.tree import tree_leaves

    task = world[0]
    all_counts = {}
    for compress, need in ((None, ("fedavg", "lstm_cell", "lstm_cell_bwd")),
                           ("int8", ("fedavg_q8", "quantize", "lstm_cell", "lstm_cell_bwd"))):
        specs = fleet_specs(device, world, pretrained, FLEET_R)
        cfg = dataclasses.replace(session_cfg(MAX_ROUNDS), compress=compress)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = run_fleet(task, specs, cfg, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        tag = f"fleet {compress or 'fp32'}"
        if not all(counts[k] > 0 for k in need):
            fail(f"{tag}: a kernel of its path was never launched: {counts}")
        if not (np.isfinite(res.accuracy).all() and res.accuracy.mean() > 1.0 / 6):
            fail(f"{tag}: accuracies {res.accuracy} are not finite and above chance")
        if not all(s.stop_reason in STOP_REASONS for s in res.sessions):
            fail(f"{tag}: invalid stop reasons")
        if not all(bool(torch.isfinite(p).all()) for s in res.sessions
                   for p in tree_leaves(s.params)):
            fail(f"{tag}: non-finite parameters")
        lane_rounds = int(res.rounds.sum())
        executed = int(res.history["round_executed"].sum())
        stops = {r: sum(s.stop_reason == r for s in res.sessions) for r in STOP_REASONS}
        print(f"  {tag} R={FLEET_R}: wall {wall:.2f} s, {executed} rounds executed, "
              f"{lane_rounds} lane-rounds, {lane_rounds / wall:.2f} lane-rounds/s; accuracy "
              f"mean {res.accuracy.mean():.4f} min {res.accuracy.min():.4f}; stops {stops}; "
              f"{res.sessions[0].model_bytes} B per update, round state "
              f"{res.device_round_state_bytes} B")
        print(f"  launches in the {tag} run: {counts}")
        all_counts[compress or "fp32"] = counts

    limits = fleet_round_check(device, world, pretrained)
    return all_counts, limits


def fleet_round_check(device, world, pretrained):
    """One fleet round of 4 requesters (8 fit epochs, refresh) on the card
    and on the CPU.  Over 8 epochs Adam amplifies rounding on the weights
    whose second moment is near zero, so the card's other summation order
    shows in the params.  The limit is set between two CPU-only readings
    taken here: the spread from a 1e-7 relative perturbation of the
    contributors' params (one ulp, 3 seeds), which must stay below it, and
    a 1e-4 relative fault of the same params, which must land above it.
    Under int8 the limit is the tile bound ``max(scale) / 2 + 1e-6``.
    Returns the limit of each wire."""
    from repro_torch.core import SupervisedTask, run_fleet
    from repro_torch.kernels.quantize.ref import quantize_batched_ref
    from repro_torch.models import LSTMClassifier
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_ravel

    task = world[0]
    cpu = torch.device("cpu")
    cpu_task = SupervisedTask(LSTMClassifier(task.model.cfg, device=cpu), lr=task.lr)
    host_pre = [tree_map(lambda t: t.cpu(), p) for p in pretrained]
    scales = quantize_batched_ref(torch.stack([tree_ravel(p)[0] for p in host_pre]))[1]

    def lanes(res):
        return torch.stack([tree_ravel(s.params)[0].cpu() for s in res.sessions])

    def perturbed(rel, seed):
        g = torch.Generator().manual_seed(seed)
        return [tree_map(lambda t: t * (1 + rel * torch.randn(t.shape, generator=g)), p)
                for p in host_pre]

    limits = {"fp32": FLEET_ROUND_TOL, "int8": float(scales.max()) / 2 + 1e-6}
    for compress, tol in ((None, limits["fp32"]), ("int8", limits["int8"])):
        tag = compress or "fp32"
        cfg = dataclasses.replace(session_cfg(1), compress=compress)

        def run(d, tk, pre):
            specs = fleet_specs(d, world, pre, 4)
            return run_fleet(tk, specs, cfg, device=d), specs

        (card, cspecs), (host, hspecs) = run(device, task, pretrained), run(cpu, cpu_task, host_pre)
        ref = lanes(host)
        per_lane = (lanes(card) - ref).abs().max(dim=1).values
        diff = float(per_lane.max())
        noise = max(float((lanes(run(cpu, cpu_task, perturbed(ULP_REL, sd))[0]) - ref).abs().max())
                    for sd in range(3))
        fault = float((lanes(run(cpu, cpu_task, perturbed(FAULT_REL, 0))[0]) - ref).abs().max())
        wdiff = max(float((a.cpu() - b).abs().max())
                    for did, st in cspecs[0].contributor_states.items()
                    for a, b in zip(tree_leaves(st["params"]),
                                    tree_leaves(hspecs[0].contributor_states[did]["params"])))
        print(f"  one fleet round R=4 {tag} card vs CPU: max abs param diff {diff:.3e} "
              f"(per lane {', '.join(f'{v:.3e}' for v in per_lane.tolist())}; limit {tol:.3e}); "
              f"CPU vs CPU: {ULP_REL:g} perturbation {noise:.3e}, {FAULT_REL:g} fault "
              f"{fault:.3e}; refreshed contributors {wdiff:.3e}; rounds "
              f"{card.rounds.tolist()} vs {host.rounds.tolist()}")
        if not noise < tol:
            fail(f"fleet round ({tag}): the CPU's own spread {noise} reaches the limit {tol}")
        if not fault > tol:
            fail(f"fleet round ({tag}): a {FAULT_REL:g} fault ({fault}) stays within the "
                 f"limit {tol}, which therefore checks nothing")
        if not diff <= tol:
            fail(f"one fleet round ({tag}) on the card and on the CPU differ by {diff}")
        if not np.array_equal(card.stop_codes, host.stop_codes):
            fail("one fleet round: stop codes differ between the card and the CPU")
    return limits


# ---------------------------------------------------------------------------
# phase 4d: the Byzantine world
# ---------------------------------------------------------------------------


def adversary_cfg(compress, robust, max_rounds=ADV_ROUNDS):
    """The quickstart config in the Byzantine world, with an accuracy no
    round reaches, so every run takes its whole round budget."""
    from repro_torch.core import AdversaryConfig

    return dataclasses.replace(session_cfg(max_rounds), desired_accuracy=1.01,
                               compress=compress, adversary=AdversaryConfig(**ADVERSARY),
                               robust=robust)


def run_loop_adversary(device, world, pretrained):
    """The quickstart session under the noise attack with ``robust="clip"``,
    fp32 and int8 wire: AES runs over the corrupted payloads, the squared
    norm and eq. 14 aggregate, the cell fits."""
    from repro_torch.core import EnFedSession

    task, shards, own_train, own_test, fleet = world
    out = {}
    for compress in (None, "int8"):
        tag = f"loop {compress or 'fp32'} clip"
        session = EnFedSession(task, own_train, own_test, fleet,
                               contributor_states(pretrained, shards, fleet, device),
                               adversary_cfg(compress, "clip"), device=device)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = session.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        need = ("sqnorm", "fedavg", "aes_ctr", "lstm_cell", "lstm_cell_bwd") + (
            ("quantize", "dequantize") if compress else ())
        if not all(counts[k] > 0 for k in need):
            fail(f"{tag}: a kernel of its path was never launched: {counts}")
        check_session(res, tag)
        corrupted = int(np.sum(res.history_raw["corrupted_mask"]))
        clipped = int(np.sum(res.history_raw["clipped_mask"]))
        if corrupted == 0 or clipped == 0:
            fail(f"{tag}: {corrupted} links corrupted, {clipped} clipped; both must fire")
        print(f"  {tag}: wall {wall:.2f} s, rounds {res.rounds}, {corrupted} corrupted and "
              f"{clipped} clipped links, accuracy {res.accuracy:.4f}, t_agg "
              f"{res.report.times.t_agg:.6f} s (screening priced)")
        print(f"  launches in the {tag} session: {counts}")
        out[tag] = counts
    return out


FLEET_ADVERSARY_RUNS = (
    (None, "none", ("fedavg",)), (None, "clip", ("sqnorm", "fedavg")),
    (None, "trimmed_mean", ("trimmed_mean",)), (None, "median", ("median",)),
    ("int8", "clip", ("sqnorm_q8", "fedavg_q8")), ("int8", "trimmed_mean", ("trimmed_mean_q8",)),
    ("int8", "median", ("median_q8",)))


def run_fleet_adversary(device, world, pretrained):
    """The 64-requester fleet in the Byzantine world, undefended and with
    each robust method, fp32 and int8.  Returns each run's launch counts."""
    from repro_torch.core import run_fleet
    from repro_torch.utils.tree import tree_leaves

    task = world[0]
    out = {}
    for compress, robust, need in FLEET_ADVERSARY_RUNS:
        tag = f"fleet {compress or 'fp32'} {robust}"
        specs = fleet_specs(device, world, pretrained, FLEET_R)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = run_fleet(task, specs, adversary_cfg(compress, robust), device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if not all(counts[k] > 0 for k in need + ("lstm_cell", "lstm_cell_bwd")):
            fail(f"{tag}: a kernel of its path was never launched: {counts}")
        if not np.isfinite(res.accuracy).all() or not all(
                bool(torch.isfinite(p).all()) for s in res.sessions for p in tree_leaves(s.params)):
            fail(f"{tag}: non-finite accuracy or parameters")
        corrupted = int(res.history["corrupted"].sum())
        clipped = int(res.history["clipped"].sum()) if robust != "none" else 0
        if corrupted == 0 or (robust == "clip" and clipped == 0):
            fail(f"{tag}: {corrupted} links corrupted, {clipped} clipped")
        lane_rounds = int(res.rounds.sum())
        executed = int(res.history["round_executed"].sum())
        print(f"  {tag:22s} R={FLEET_R}: wall {wall:.2f} s, {executed} rounds executed, "
              f"{lane_rounds / wall:.2f} lane-rounds/s; {corrupted} corrupted, {clipped} "
              f"clipped links; accuracy mean {res.accuracy.mean():.4f} min "
              f"{res.accuracy.min():.4f}")
        print(f"    launches: {counts}")
        out[tag] = counts
    return out


def fleet_adversary_round_check(device, world, pretrained, limits):
    """One round of 4 requesters under noise + clip on the card and on the
    CPU: the corrupted and clipped masks must be equal, the params within
    the limits :func:`fleet_round_check` derived."""
    from repro_torch.core import SupervisedTask, run_fleet
    from repro_torch.models import LSTMClassifier
    from repro_torch.utils.tree import tree_map, tree_ravel

    task = world[0]
    cpu = torch.device("cpu")
    cpu_task = SupervisedTask(LSTMClassifier(task.model.cfg, device=cpu), lr=task.lr)
    host_pre = [tree_map(lambda t: t.cpu(), p) for p in pretrained]
    for compress in (None, "int8"):
        tag = compress or "fp32"
        cfg = adversary_cfg(compress, "clip", max_rounds=1)
        card = run_fleet(task, fleet_specs(device, world, pretrained, 4), cfg, device=device)
        host = run_fleet(cpu_task, fleet_specs(cpu, world, host_pre, 4), cfg, device=cpu)
        diff = max(float((tree_ravel(a.params)[0].cpu() - tree_ravel(b.params)[0]).abs().max())
                   for a, b in zip(card.sessions, host.sessions))
        corrupted, clipped = card.history["corrupted"], card.history["clipped"]
        print(f"  one fleet round R=4 {tag} noise + clip, card vs CPU: {int(corrupted.sum())} "
              f"corrupted and {int(clipped.sum())} clipped links on both: masks "
              f"{'equal' if np.array_equal(corrupted, host.history['corrupted']) and np.array_equal(clipped, host.history['clipped']) else 'DIFFER'}; "
              f"max abs param diff {diff:.3e} (limit {limits[tag]:.3e})")
        if not (np.array_equal(corrupted, host.history["corrupted"])
                and np.array_equal(clipped, host.history["clipped"])):
            fail(f"fleet round under noise + clip ({tag}): masks differ between card and CPU")
        if corrupted.sum() == 0:
            fail(f"fleet round under noise + clip ({tag}): no link was corrupted")
        if not diff <= limits[tag]:
            fail(f"fleet round under noise + clip ({tag}): card and CPU differ by {diff}")


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def time_kernels(dev, counts, errs, n_params, fit_b, f, h, seq_len, n_contrib):
    rows = time_loop_kernels(dev, counts, errs, n_params, n_contrib)
    rows += time_lstm(dev, counts, errs, fit_b, f, h, seq_len)
    rows += time_int8_kernels(dev, counts, errs, n_params, n_contrib)
    rows += time_robust_kernels(dev, counts, errs, n_params, n_contrib)
    for row in rows:
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.5f}"
        dus = "not measured" if row["device_us"] is None else f"{row['device_us']:.3f}"
        print(f"  {row['name']:10s} {row['shape']}: kernel_ms {row['ms']:.5f}  device_us {dus}  "
              f"plain_ms {row['plain_ms']:.5f}  library_ms {lib}  "
              f"bound_ms {row['bound_ms']:.6f} ({row['bound_by']})  "
              f"launches on the main paths {row['launches']}")
    return rows


def time_int8_kernels(dev, counts, errs, n_params, n_contrib):
    """The int8 wire kernels at the fleet's shapes (R = 64, N = 5) and at
    one loop-engine update.  No single PyTorch call computes any of them:
    ``library_ms`` is null."""
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_q8_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_q8_ref
    from repro_torch.kernels.quantize.kernel import dequantize_cuda, quantize_cuda
    from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_batched_ref

    g = torch.Generator().manual_seed(9)
    rows = []
    lp = n_params + (-n_params) % TILE
    tiles = lp // TILE

    # fused dequant -> eq. 14 at the fleet's AGGREGATE, (R, N, Lp) = (64, 5, Lp)
    r, n = FLEET_R, n_contrib
    q, s = quantize_batched_ref(torch.randn((r * n, n_params), generator=g).to(dev) * 0.3)
    q, s = q.reshape(r, n, lp), s.reshape(r, n, tiles)
    w = torch.ones((r, n), device=dev)
    ms = cuda_ms(lambda: fedavg_batched_q8_cuda(q, s, w))
    plain = cuda_ms(lambda: fedavg_batched_q8_ref(q, s, w), iters=50, warmup=5)
    b_ms, b_by = bound_ms(r * n * lp + 4 * (r * n * tiles + r * n + r * lp),
                          3 * r * n * lp + r * lp)
    rows.append(dict(name="fedavg_q8", route="cuda", source="src/repro_torch/csrc/fedavg.cu",
                     replaces="src/repro/kernels/fedavg/kernel.py:83",
                     device_us=device_us(lambda: fedavg_batched_q8_cuda(q, s, w),
                                         "fedavg_q8_kernel"),
                     launches=counts["fedavg_q8"], max_abs_err=errs["fedavg_q8"], ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     shape=f"R,N,Lp={r},{n},{lp}"))

    # quantize at the fleet's staging: R * N rows of P, ragged to Lp
    x = torch.randn((r * n, n_params), generator=g).to(dev) * 0.3
    ms = cuda_ms(lambda: quantize_cuda(x))
    plain = cuda_ms(lambda: quantize_batched_ref(x), iters=50, warmup=5)
    b_ms, b_by = bound_ms(4 * r * n * n_params + r * n * lp + 4 * r * n * tiles,
                          6 * r * n * n_params)
    rows.append(dict(name="quantize_batched", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/kernel.py:89",
                     device_us=device_us(lambda: quantize_cuda(x), "quantize_kernel"),
                     launches=counts["quantize_batched"], max_abs_err=errs["quantize"], ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     shape=f"B,L={r * n},{n_params} -> Lp={lp}"))
    # the same kernel on one update (the loop engine's compress_update)
    v = x[0].contiguous()
    ms1 = cuda_ms(lambda: quantize_cuda(v))
    plain1 = cuda_ms(lambda: quantize_batched_ref(v), iters=50, warmup=5)
    b1, b1_by = bound_ms(4 * n_params + lp + 4 * tiles, 6 * n_params)
    rows.append(dict(name="quantize", route="cuda", source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/kernel.py:41",
                     device_us=device_us(lambda: quantize_cuda(v), "quantize_kernel"),
                     launches=counts["quantize"], max_abs_err=errs["quantize"], ms=ms1,
                     plain_ms=plain1, bound_ms=b1, bound_by=b1_by, library_ms=None,
                     shape=f"L={n_params} (one update) -> Lp={lp}"))

    # dequantize of one update (the loop engine's decompress_update)
    q1, s1 = quantize_batched_ref(v)
    ms = cuda_ms(lambda: dequantize_cuda(q1, s1, n_params))
    plain = cuda_ms(lambda: dequantize_ref(q1, s1, n_params), iters=50, warmup=5)
    b_ms, b_by = bound_ms(n_params + 4 * tiles + 4 * n_params, n_params)
    rows.append(dict(name="dequantize", route="cuda", source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/kernel.py:120",
                     device_us=device_us(lambda: dequantize_cuda(q1, s1, n_params),
                                         "dequantize_kernel"),
                     launches=counts["dequantize"], max_abs_err=errs["dequantize"], ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     shape=f"Lp={lp} -> L={n_params}"))
    return rows


def time_robust_kernels(dev, counts, errs, n_params, n_contrib):
    """The six robust kernels at the fleet's AGGREGATE, (R, N) = (64, 5):
    fp32 (R, N, P) and int8 (R, N, Lp), all contributors active.  The
    squared norm's yardstick is ``torch.linalg.vector_norm``, the dense
    median's ``torch.nanquantile`` over the active entries; no single
    PyTorch call computes the other three."""
    from repro_torch.kernels.quantize.ref import quantize_batched_ref
    from repro_torch.kernels.robust import kernel as rk
    from repro_torch.kernels.robust import ref as rr

    g = torch.Generator().manual_seed(12)
    r, n, l = FLEET_R, n_contrib, n_params
    lp = l + (-l) % TILE
    tiles = lp // TILE
    x = (torch.randn((r, n, l), generator=g) * 0.3).to(dev)
    w = torch.ones((r, n), device=dev)
    q, s = quantize_batched_ref(x.reshape(r * n, l))
    q, s = q.reshape(r, n, lp), s.reshape(r, n, tiles)
    src = "src/repro_torch/csrc/robust.cu"
    dense_bytes = 4 * (r * n * l + r * n + r * l)
    q8_bytes = r * n * lp + 4 * (r * n * tiles + r * n + r * lp)
    def median_library():
        """The midpoint median over the active contributors, inactive
        entries set to NaN by one ``torch.where`` (timed with it)."""
        u = torch.where(w[:, :, None] > 0, x, float("nan"))
        return torch.nanquantile(u, 0.5, dim=1, interpolation="midpoint")

    # compares and selects per column: the trimmed mean's two scans and
    # weighted sum, the median's n-phase network (n * n min/max) and the
    # dequantize multiply of the q8 forms
    specs = [
        ("trimmed_mean", "kernel.py:254", lambda: rk.trimmed_mean_cuda(x, w),
         lambda: rr.trimmed_mean_batched_ref(x, w), None, "trimmed_mean_kernel",
         dense_bytes, r * l * (5 * n + 1), f"R,N,L={r},{n},{l}"),
        ("trimmed_mean_q8", "kernel.py:261", lambda: rk.trimmed_mean_q8_cuda(q, s, w),
         lambda: rr.trimmed_mean_batched_q8_ref(q, s, w), None, "trimmed_mean_kernel",
         q8_bytes, r * lp * (6 * n + 1), f"R,N,Lp={r},{n},{lp}"),
        ("median", "kernel.py:269", lambda: rk.median_cuda(x, w),
         lambda: rr.median_batched_ref(x, w), median_library, "median_kernel",
         dense_bytes, r * l * (n * n + n + 2), f"R,N,L={r},{n},{l}"),
        ("median_q8", "kernel.py:276", lambda: rk.median_q8_cuda(q, s, w),
         lambda: rr.median_batched_q8_ref(q, s, w), None, "median_kernel",
         q8_bytes, r * lp * (n * n + 2 * n + 2), f"R,N,Lp={r},{n},{lp}"),
        ("sqnorm", "kernel.py:284", lambda: rk.sqnorm_cuda(x),
         lambda: rr.sqnorm_batched_ref(x), lambda: torch.linalg.vector_norm(x, dim=-1),
         "sqnorm_kernel", 4 * (r * n * l + r * n), 2 * r * n * l, f"R,N,L={r},{n},{l}"),
        ("sqnorm_q8", "kernel.py:310", lambda: rk.sqnorm_q8_cuda(q, s),
         lambda: rr.sqnorm_batched_q8_ref(q, s), None, "sqnorm_kernel",
         r * n * lp + 4 * (r * n * tiles + r * n), 3 * r * n * lp, f"R,N,Lp={r},{n},{lp}"),
    ]
    rows = []
    for name, line, kern, plain_fn, lib_fn, kname, nbytes, ops, shape in specs:
        b_ms, b_by = bound_ms(nbytes, ops)
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=f"src/repro/kernels/robust/{line}",
                         device_us=device_us(kern, kname), launches=counts[name],
                         max_abs_err=errs[name], ms=cuda_ms(kern),
                         plain_ms=cuda_ms(plain_fn, iters=50, warmup=5),
                         bound_ms=b_ms, bound_by=b_by,
                         library_ms=None if lib_fn is None else cuda_ms(lib_fn), shape=shape))
    return rows


def lstm_bounds(lanes, b, f, h, t):
    """((bytes, ops) of the forward, (bytes, ops) of the backward) for one
    sequence of T steps: each input read once, each output written once.
    The forward writes the T + 1 saved states (a training pass); the
    backward reads them and the final states' cotangents and writes dgates,
    dh0 and dc0.  Ops: the gate products (recomputed in the backward), the
    bias, the backward's dgates wh^T, and the elementwise cell."""
    g4 = 4 * h
    weights = f * g4 + h * g4 + g4
    states = 2 * (t + 1) * b * h
    gates = 2 * b * (f + h) * g4 + 2 * b * g4
    fwd = (4 * lanes * (t * b * f + 2 * b * h + weights + states),
           lanes * t * (gates + 10 * b * h))
    bwd = (4 * lanes * (t * b * f + states + weights + 2 * b * h + t * b * g4 + 2 * b * h),
           lanes * t * (gates + 2 * b * g4 * h + 40 * b * h))
    return fwd, bwd


def time_cudnn_lstm(x, h0, c0, wx, wh, b, dh, dc, h_last):
    """cuDNN's LSTM (``torch.nn.LSTM``, fp32 with TF32 off) over one lane's
    sequence x (T, B, F) with the same weights, as the yardstick of the
    two kernels: ms of its training forward, and of its backward through
    autograd (which forms the weight gradients too).  Also the largest
    difference of its h_T from the kernel's ``h_last``."""
    lstm = torch.nn.LSTM(wx.shape[0], wh.shape[0]).to(x.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.t())
        lstm.weight_hh_l0.copy_(wh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    state = (h0[None].contiguous(), c0[None].contiguous())
    fwd_ms = cuda_ms(lambda: lstm(x, state))
    _, (hn, cn) = lstm(x, state)
    params = list(lstm.parameters())
    bwd_ms = cuda_ms(lambda: torch.autograd.grad((hn, cn), params, (dh[None], dc[None]),
                                                 retain_graph=True))
    return fwd_ms, bwd_ms, float((hn[0].detach() - h_last).abs().max())


def time_lstm(dev, counts, errs, fit_b, f, h, seq_len):
    """The LSTM's two kernels per sequence (T = ``seq_len``, the fit batch)
    at one lane (the loop engine: the rows of the kernel table) and at the
    fleet's 64 lanes, beside their plain twins, cuDNN at one lane and
    their bounds; the backward also with the weight gradients the wrapper
    forms from dgates.  Then the one-step op (T = 1) at one lane, the
    measure of this row before the sequence kernels."""
    from repro_torch.kernels.lstm_cell.kernel import (lstm_cell_cuda, lstm_seq_backward_cuda,
                                                      lstm_seq_cuda)
    from repro_torch.kernels.lstm_cell.ops import lstm_seq_backward
    from repro_torch.kernels.lstm_cell.ref import (lstm_cell_ref, lstm_seq_backward_ref,
                                                   lstm_seq_ref)

    g = torch.Generator().manual_seed(10)
    src, t, b = "src/repro_torch/csrc/lstm_cell.cu", seq_len, fit_b
    rows = []
    for lanes in (1, FLEET_R):
        x = torch.randn((lanes, t, b, f), generator=g).to(dev)
        h0, c0, dh, dc = (torch.randn((lanes, b, h), generator=g).to(dev) * 0.5
                          for _ in range(4))
        w = ((torch.randn((lanes, f, 4 * h), generator=g) * 0.4).to(dev),
             (torch.randn((lanes, h, 4 * h), generator=g) / math.sqrt(h)).to(dev),
             (torch.randn((lanes, 4 * h), generator=g) * 0.1).to(dev))
        hs, cs = lstm_seq_cuda(x, h0, c0, *w, save=True)

        def fwd():
            return lstm_seq_cuda(x, h0, c0, *w, save=True)

        def bwd():
            return lstm_seq_backward_cuda(x, hs, cs, *w, dh, dc)

        (fb, fo), (bb, bo) = lstm_bounds(lanes, b, f, h, t)
        f_bound, f_by = bound_ms(fb, fo)
        b_bound, b_by = bound_ms(bb, bo)
        fwd_ms, bwd_ms = cuda_ms(fwd), cuda_ms(bwd)
        score_ms = cuda_ms(lambda: lstm_seq_cuda(x, h0, c0, *w))
        grads_ms = cuda_ms(lambda: lstm_seq_backward(x, hs, cs, *w, dh, dc, need_dx=False))
        fwd_plain = cuda_ms(lambda: lstm_seq_ref(x, h0, c0, *w), iters=20, warmup=3)
        bwd_plain = cuda_ms(lambda: lstm_seq_backward_ref(x, hs, cs, *w, dh, dc),
                            iters=20, warmup=3)
        fwd_us, bwd_us = device_us(fwd, "lstm_seq_fwd_kernel"), device_us(bwd, "lstm_seq_bwd_kernel")
        lib_fwd = lib_bwd = None
        if lanes == 1:
            lib_fwd, lib_bwd, lib_diff = time_cudnn_lstm(
                x[0], h0[0], c0[0], *(p[0] for p in w), dh[0], dc[0], hs[0, -1])
            print(f"  cuDNN LSTM at L,B,T=1,{b},{t}: forward {lib_fwd:.5f} ms, backward "
                  f"(autograd, weight gradients included) {lib_bwd:.5f} ms; its h_T differs "
                  f"from the kernel's by {lib_diff:.3e}")
        shape = f"L,B,F,H,T={lanes},{b},{f},{h},{t}"
        dus = [("not measured" if v is None else f"{v:.3f}") for v in (fwd_us, bwd_us)]
        print(f"  lstm_seq {shape}: forward kernel_ms {fwd_ms:.5f} (states saved; "
              f"{score_ms:.5f} without) device_us {dus[0]} plain_ms {fwd_plain:.5f} "
              f"bound_ms {f_bound:.6f} ({f_by}); backward kernel_ms {bwd_ms:.5f} device_us "
              f"{dus[1]} (with the weight-gradient products {grads_ms:.5f} ms) plain_ms "
              f"{bwd_plain:.5f} bound_ms {b_bound:.6f} ({b_by})")
        if lanes == 1:
            rows.append(dict(name="lstm_cell", route="cuda", device_us=fwd_us, source=src,
                             replaces="src/repro/kernels/lstm_cell/kernel.py:66",
                             launches=counts["lstm_cell"], max_abs_err=errs["lstm_cell"],
                             ms=fwd_ms, plain_ms=fwd_plain, bound_ms=f_bound, bound_by=f_by,
                             library_ms=lib_fwd, shape=f"{shape} (forward, states saved)"))
            rows.append(dict(name="lstm_cell_bwd", route="cuda", device_us=bwd_us, source=src,
                             replaces="src/repro/kernels/lstm_cell/kernel.py:66 (its VJP, "
                                      "by XLA autodiff in the reference)",
                             launches=counts["lstm_cell_bwd"],
                             max_abs_err=errs["lstm_cell_bwd"], ms=bwd_ms, plain_ms=bwd_plain,
                             bound_ms=b_bound, bound_by=b_by, library_ms=lib_bwd,
                             shape=f"{shape} (backward: dgates, dh0, dc0)"))

    # the one-step op, T = 1 of the forward kernel, at the fit shape
    x1, h1, c1 = x[0, 0], h0[0], c0[0]
    w1 = tuple(p[0] for p in w)
    wx_t, wh_t, zero_b = w1[0].t().contiguous(), w1[1].t().contiguous(), torch.zeros_like(w1[2])
    step_ms = cuda_ms(lambda: lstm_cell_cuda(x1, h1, c1, *w1))
    step_plain = cuda_ms(lambda: lstm_cell_ref(x1, h1, c1, *w1))
    step_lib = cuda_ms(lambda: torch.lstm_cell(x1, (h1, c1), wx_t, wh_t, w1[2], zero_b))
    step_us = device_us(lambda: lstm_cell_cuda(x1, h1, c1, *w1), "lstm_seq_fwd_kernel")
    print(f"  lstm_cell one step B,F,H={b},{f},{h}: kernel_ms {step_ms:.5f} device_us "
          f"{'not measured' if step_us is None else f'{step_us:.3f}'} plain_ms "
          f"{step_plain:.5f} library_ms {step_lib:.5f} (torch.lstm_cell)")
    return rows


def time_loop_kernels(dev, counts, errs, n_params, n_contrib):
    from repro_torch.core import crypto
    from repro_torch.kernels.aes_ctr.kernel import aes_ctr_cuda
    from repro_torch.kernels.aes_ctr.ref import aes_ctr_ref
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_ref

    g = torch.Generator().manual_seed(3)
    rows = []

    # eq. 14 at the loop's (R, N, L) = (1, 5, P) and the fleet's (64, 5, P)
    for name, r, replaces in (("fedavg", 1, "src/repro/kernels/fedavg/kernel.py:157"),
                              ("fedavg_batched", FLEET_R,
                               "src/repro/kernels/fedavg/kernel.py:122")):
        n, l = n_contrib, n_params
        u = torch.randn((r, n, l), generator=g).to(dev)
        w = torch.ones((r, n)).to(dev)
        ms = cuda_ms(lambda: fedavg_batched_cuda(u, w))
        plain = cuda_ms(lambda: fedavg_batched_ref(u, w))
        lib = cuda_ms(lambda: torch.einsum("rn,rnl->rl", w, u) / w.sum(dim=1, keepdim=True))
        b_ms, b_by = bound_ms(4 * (r * n * l + r * n + r * l), 2 * r * n * l + r * l)
        dev_us = device_us(lambda: fedavg_batched_cuda(u, w), "fedavg_kernel")
        rows.append(dict(name=name, route="cuda", device_us=dev_us,
                         source="src/repro_torch/csrc/fedavg.cu", replaces=replaces,
                         launches=counts[name], max_abs_err=errs[name], ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                         shape=f"R,N,L={r},{n},{l}"))

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
    return rows


# ---------------------------------------------------------------------------
# phase 6: where the time goes in fit
# ---------------------------------------------------------------------------


def traced_view(what, run, wall, top):
    """Runs ``run`` once under ``torch.profiler`` and prints, beside the
    untraced ``wall``, the device-busy time and share, the device
    operations (kernels and copies) per Adam step (the backward kernel is
    launched once per step) and the ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels

    steps0 = kernels.launch_counts()["lstm_cell_bwd"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    steps = kernels.launch_counts()["lstm_cell_bwd"] - steps0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_s = sum(e.self_device_time_total for e in kern) * 1e-6
    ops = sum(e.count for e in kern)
    print(f"  {what}: wall {wall * 1e3:.2f} ms untraced, {traced * 1e3:.2f} ms traced; device "
          f"busy {busy_s * 1e3:.3f} ms ({100 * busy_s / traced:.1f} % of the traced wall, "
          f"{100 * busy_s / wall:.1f} % of the untraced one); {ops} device operations over "
          f"{steps} Adam steps, {ops / max(steps, 1):.1f} per step")
    if not kern:
        print("  device time: not measured (the profiler saw no kernels)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} launches  {e.key[:90]}")


def fit_device_view(task, own_train):
    """One requester fit epoch at the main path's shapes, untraced and
    traced (:func:`traced_view`)."""
    params = task.init(0)
    task.fit(params, own_train, 1, 32, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.fit(params, own_train, 1, 32, seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traced_view(f"one fit epoch (B=32, {len(own_train[0])} windows)",
                lambda: task.fit(params, own_train, 1, 32, seed=1), wall, 8)


def fleet_device_view(device, world, pretrained):
    """One round of the 64-requester fleet (fp32), untraced and traced
    (:func:`traced_view`)."""
    from repro_torch.core import run_fleet

    task = world[0]
    cfg = dataclasses.replace(session_cfg(1), desired_accuracy=1.01)
    run_fleet(task, fleet_specs(device, world, pretrained, FLEET_R), cfg, device=device)
    torch.cuda.synchronize()
    specs = fleet_specs(device, world, pretrained, FLEET_R)
    t0 = time.perf_counter()
    run_fleet(task, specs, cfg, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    specs = fleet_specs(device, world, pretrained, FLEET_R)
    traced_view(f"one fleet round (R={FLEET_R}, {FIT_EPOCHS} epochs, refresh included)",
                lambda: run_fleet(task, specs, cfg, device=device), wall, 10)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets the TF32 policy)
    from repro_torch.kernels import _build
    from repro_torch.utils.tree import tree_ravel, tree_size

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
    global PASSES
    PASSES = LSTMPasses(task.model)
    cfg = task.model.cfg
    f, h, n_contrib = cfg.input_dim, cfg.hidden, 5
    n_params = tree_size(task.init(0))
    fit_b, score_b = min(32, len(own_train[0])), len(own_test[0])
    lp = n_params + (-n_params) % TILE
    print("[3] kernels against their plain versions on the card")
    errs = {}
    errs["fedavg"], errs["fedavg_batched"] = check_fedavg(
        dev, (1, n_contrib, n_params), (FLEET_R, n_contrib, n_params))
    errs.update(fedavg_q8=check_fedavg_q8(dev, (FLEET_R, n_contrib, lp)),
                quantize=check_quantize(dev, n_params, FLEET_R * n_contrib),
                dequantize=check_dequantize(dev, n_params),
                lstm_cell=check_lstm(dev, fit_b, score_b, f, h),
                aes_ctr=check_aes(dev, 4 * n_params))
    # the fleet's lanes: every requester's test set pads to the longest, and
    # REFRESH trains one row per contributor (all 64 requesters share the 5)
    fleet_score_b = max(len(test[0]) for _, test in fleet_split())
    spec = tree_ravel(task.init(0))[1]
    errs["lstm_cell"] = max(errs["lstm_cell"], check_lane_lstm(
        dev, spec, n_params, fit_b, fleet_score_b, n_contrib))
    seq_fwd, errs["lstm_cell_bwd"] = check_lstm_seq(dev, spec, n_params, fit_b, score_b,
                                                    fleet_score_b, cfg.seq_len)
    errs["lstm_cell"] = max(errs["lstm_cell"], seq_fwd)
    errs.update(check_robust(dev, n_params, n_contrib))

    print("[4] main paths at full width on the card")
    print(" [4a] the quickstart session (loop engine, fp32 wire)")
    loop_counts, pretrained = run_main_path(dev, world)
    print(" [4b] the quickstart session with the int8 wire")
    int8_counts = run_loop_int8(dev, world, pretrained)
    print(f" [4c] the fleet engine, {FLEET_R} requesters")
    fleet_counts, limits = run_fleet_path(dev, world, pretrained)
    print(f" [4d] the Byzantine world ({ADVERSARY}), {ADV_ROUNDS} rounds")
    adv_loop = run_loop_adversary(dev, world, pretrained)
    adv_fleet = run_fleet_adversary(dev, world, pretrained)
    fleet_adversary_round_check(dev, world, pretrained, limits)
    loop_paths = [loop_counts, int8_counts, *adv_loop.values()]
    fleet_paths = [fleet_counts["fp32"], fleet_counts["int8"], *adv_fleet.values()]
    counts = {k: sum(c[k] for c in loop_paths + fleet_paths) for k in loop_counts}
    # eq. 14 at R = 1 (row 1 of the kernel table) and quantize of one update
    # (row 6) run in the loop engine, at R = 64 (rows 2 and 7) in the fleet:
    # one wrapper each, counted per path
    for name, batched in (("fedavg", "fedavg_batched"), ("quantize", "quantize_batched")):
        counts[name] = sum(c[name] for c in loop_paths)
        counts[batched] = sum(c[name] for c in fleet_paths)
    print(f"  launches over the main paths: {counts}")
    print(f"    {time.perf_counter() - t_start:.1f} s so far")

    print("[5] kernel timings at the main paths' shapes (CUDA events)")
    rows = time_kernels(dev, counts, errs, n_params, fit_b, f, h, cfg.seq_len, n_contrib)
    print(f"    {time.perf_counter() - t_start:.1f} s so far")

    print("[6] where the time goes (torch.profiler)")
    fit_device_view(task, own_train)
    fleet_device_view(dev, world, pretrained)
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
