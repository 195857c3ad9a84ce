"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the hand-written kernels from ``src/repro_torch/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch twin on the card, at the
   main paths' shapes and at edge shapes (AES, quantize and dequantize
   bit-exact, quantize also on rows at every alignment; eq. 14 dense and
   int8 within 1e-6 of the largest output, dense at every N from 1 to 17
   and every L % 4 with the same bits on rows at every alignment, int8
   bit-equal to dense on the dequantized buffer at every N from 1 to 17;
   the LSTM cell within 1e-5,
   one lane and the fleet's fit, score and refresh lanes, with the weights
   as views of the fleet's flat buffers; the LSTM's whole-sequence forward
   within 1e-5 (every saved state) and its backward within 1e-4 of each
   output's largest value, at the loop's and the fleet's fit and scoring
   shapes; the robust trimmed mean and median
   within 1e-6 of the largest output at every N from 1 to 16, the squared
   norm within 1e-5 relative, each int8 robust kernel bit-equal to its
   dense kernel on the dequantized buffer; dequantize also bit-equal to
   one ``torch.mul``, its timing yardstick); and at the shapes the
   paper-table twins (``benchmarks/_torch_harness.py``) give them, taken
   from the harness's four scenarios: the LSTM pair at each batch an LSTM
   world fits and scores (the calories LSTM at F = 8, T = 8), eq. 14 at
   (1, N, P) for N = 2 ... 6 and AES over one update at each world's P;
   and at the mobility world's: eq. 14 dense and int8 at (64, 5, .) with
   0/1 member weights and member-less rows, dequantize over the fleet's
   320 refresh rows in one launch, the LSTM pair at those 320 lanes; and
   at the fault world's: eq. 14 dense and int8 at (64, 5, .) with weights
   in {0, gamma, 1} x 0/1 strategy weights and all-zero rows (zeros out),
   ``fedavg_q8`` on rows mixing this round's and the previous round's
   codes, and the loop's eq. 14 at (1, n, P) for n = 1 ... 5; and at the
   cadence world's: eq. 14 dense and int8 at (64, 5, .) and the loop's at
   (1, n, P) with weights 0/1 x gamma**lag for image lags 0-2;
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
     method, fp32 and int8, whose accuracies under the trimmed mean and the
     median must equal, to four digits, what the earlier column kernels
     gave; one 4-requester round under clip on the card and on the CPU,
     whose corrupted and clipped masks must be equal;
   - the paper's baselines, in the quickstart world (LSTM) and in Table V's
     calories world (9,000 samples over 6 Dirichlet clients, the MLP with
     hidden (64, 32); its EnFed session run as the quickstart's): the loop
     ``CFLLearner``, ``DFLLearner`` mesh and ring to the harness's targets
     on a holdout (10 rounds of 8 epochs at most) and ``cloud_only_config``,
     with EnFed's ``T_train`` and ``E_tot`` against each from one
     ``CostModel``; the fleet's ``method="cfl"`` and ``"dfl"`` (mesh, ring)
     at 64 requesters of 6 lanes for 3 rounds, eq. 14 launched once a round
     (cfl) or 6 times (dfl), with the peak device memory; one 4-requester
     round of cfl and of dfl on the card and on the CPU under the limit rule
     of the fleet round above (the nodes' inits perturbed); and
     ``examples/torch_quickstart.py`` as a process of its own, exit 0;
   - the ``repro_torch.api`` facade in the quickstart world (3 rounds of 2
     epochs): ``compare`` of enfed, dfl, cfl, cloud and dfl-ring on the
     loop engine and on the fleet, and an enfed run with the int8 wire and
     the clip defense in the Byzantine world on each, every run with its
     kernels' launches counted and its event log and Chrome trace written
     under ``build/4f`` and read back; enfed's loop and fleet event streams
     equal (fp32 and int8 + clip), the baselines' loop and fleet rounds and
     stops equal, and within the reference's cross-engine limits at its
     test's depth (2 rounds of 1 epoch), an enfed fleet run with
     ``use_pallas=False`` that launches no kernel and gives the same event
     stream, and an untraced enfed fleet run bit-equal to the traced one;
   - the paper-table twins at a cut depth (1 round of 1 epoch, contributors
     pretrained 1 epoch): the harness's EnFed, CFL, DFL mesh and ring and
     cloud runs in each of its four worlds (HAR and calories, LSTM and
     MLP), and EnFed with 2 contributors on the HAR LSTM, each run's
     outcome and launches checked (eq. 14 once a round at N = the
     contributors or the 6 CFL clients, AES twice per contributor a round,
     the LSTM pair in the LSTM worlds only);
   - the mobility world (``examples/har_federated.py``'s churn walkthrough:
     a 200 m arena, 90 m radio range, 2-round legs, seed 5, 3 contract
     slots, an accuracy no round reaches): the quickstart session fp32 with
     AES and int8 over 10 rounds, eq. 14 launched once per round with a
     member at (1, members, P) and AES twice per member a round; the
     64-requester fleet fp32 and int8 (requester i walking as device
     ``requester_id + i``), eq. 14 once a round at (64, 5, P), quantize and
     dequantize of the 320 refresh rows once a round; the loop session and
     the fleet's requester 0 with equal member masks, member counts, rounds
     and stops; [4d]'s noise attack with ``robust="clip"`` under churn for
     3 rounds on both engines, with equal corrupted masks; and one
     churning fleet round of 4 requesters on the card and on the CPU, with
     equal member masks and the params under the fleet round's limit rule;
   - the unreliable-link world (``examples/har_federated.py``'s fault
     walkthrough: drops at 0.4 an attempt, one retry, stale at 0.3, release
     after 2 failed rounds, seed 7; an accuracy no round reaches, 10 rounds
     of 8 epochs): the quickstart session fp32 with AES, int8, and fp32
     with ``staleness_gamma=0.5``, eq. 14 once per round with a delivery at
     (1, delivered, P) and AES twice per delivered update; the 64-requester
     fleet fp32 and int8 (requester i rolling as ``requester_id + i``), eq.
     14 once a round at (64, 5, .); faults with [4h]'s churn on the int8
     wire on both engines; [4d]'s noise + clip under faults for 3 rounds on
     both; the loop session and the fleet's requester 0 with equal deliver
     masks, drop, retry and stale counts, rounds and stops (and member and
     corrupted masks where they exist); both engines killed after round 4
     (checkpoints every 2 rounds, ``build/4i``) and resumed, bit-equal to
     the straight run; and one faulty fleet round of 4 requesters on the
     card and on the CPU, equal deliver masks, params within [4c]'s limit;
   - the asynchronous-cadence world (two speed classes, a radio awake 2
     steps of 3, 15 % offline steps, the seed chosen on the host so that
     requester 0 is on stride 2 and a contract can straggle, both checked
     on the run; an accuracy no round reaches, 10 rounds of 8 epochs): the
     quickstart session fp32 with AES, int8, and fp32 with
     ``staleness_gamma=0.5``, eq. 14 once per executed round at (1, 5, P)
     and AES twice per contract a round, stragglers included; the
     64-requester fleet fp32 and int8 (requester i ticking as
     ``requester_id + i``), eq. 14 once per event step where a lane ticks;
     at a cut depth (6 rounds of 1 epoch) cadence with [4h]'s churn and
     [4i]'s faults on the int8 wire, and battery pacing (stride x2 below a
     threshold the battery crosses in round 3), on both engines; the loop
     session and the fleet's requester 0 with equal round clocks, idle
     steps, rounds, stops and masks and ``t_com`` within 1e-9; both engines
     of the composed run killed after step 4 (``build/4j``) and resumed,
     bit-equal to the straight run; one cadence fleet step of 4 requesters
     on the card and on the CPU, equal tick, clock and idle traces, params
     within [4c]'s limit;
   - the profiler hooks: [4c]'s 64-requester fp32 fleet again under
     ``TraceConfig(jax_profiler_dir="build/4k", hlo_stats=True)``, bit-equal
     to [4c]'s untraced run, its ``hlo_stats`` launches per kernel equal to
     the launch counters, the ``torch.profiler`` trace naming every kernel
     launched; the host time per Adam step of one round under the profiler
     alone, split by what the host was doing (the hand-written kernels'
     wrappers, launches, allocation, copies, syncs, other ops, Python); and
     one fp32 round of 4 requesters whose ``hlo_stats`` work counts must be
     the same integers on the card and on the CPU;
   - the LM zoo's serving path: ``repro_torch.launch.serve`` for the
     ``debug-dense`` and ``debug-moe`` presets at their registered widths
     (batch 4, prompt 32, gen 16), with prefill and decode tokens/s; every
     variant of the CPU parity tests (each mixer, the special heads, the
     presets) forward and decode (a ``decode_step`` a token, the serving
     path) on the card against the CPU from the same weights within 1e-4,
     MoE routes equal at the forward and at every decode step, and decode
     against forward on the card within 2e-3 wherever the CPU tests hold
     that rule;
   - the LM zoo's training: ``repro_torch.launch.train.main`` for the
     ``debug-dense`` and ``debug-moe`` presets at their registered widths
     with the reference driver's defaults (4 clients, global batch 8, seq
     64, 1 local step, lr 3e-4, ``enfed`` over neighbourhoods of 2), 30
     steps with a checkpoint under ``build/4m``, which must exit 0 (the
     loss improved), with its training tokens/s; the same command again,
     which must restore that checkpoint bit for bit and go on from step 30;
     one ``FederatedTrainer`` round of every strategy (``enfed`` with a
     client left out) on the card and on the CPU from the same weights,
     losses within 1e-4, the MoE routes of the first forward equal, and the
     params' mean absolute gap under [4c]'s rule (``LM_ROUND_MEAN_TOL``); one step's
     loss and gradient with per-block remat on and off on the card, equal
     within 1e-6 (``LM_REMAT_TOL``), for both presets and ``debug-moe``
     through the sort dispatch; this path launches no hand-written kernel;
   - the mesh runtime: 8 ranks on the card (``repro_torch.launch.mesh.
     spawn``, gloo, every payload staged through host memory) as the
     reference's debug meshes, against the same 8 ranks on the CPU: the FL
     aggregation of every strategy (distinct updates per client, a mask
     with one zero, fp32 and int8 rings, ``pod_local``) within 1e-6 and its
     collective bytes equal to their closed form; one federated train step
     of every strategy and of ``none`` for ``debug-dense`` and ``debug-moe``
     on (2, 2, 2) (batch 8 x 16), losses within 1e-4 and params by [4m]'s
     mean-gap rule, the four strategies' losses within 1e-4 of each other;
     ``debug-moe``'s ``ep`` schedule against the token-local sort on every
     rank within 2e-5; each step's wall and one all-reduce of the
     ``debug-dense`` gradient on the card; one dry-run record
     (``repro_torch.launch.dryrun``) built with no jax; this path launches
     no hand-written kernel;
5. time each kernel with CUDA events at the main paths' shapes, beside its
   plain twin, the closest PyTorch library call and its bound on the card
   (the LSTM's two kernels per sequence at 1 and 64 lanes, beside cuDNN's
   ``torch.lstm``), with the host's enqueue time of each wrapper, each
   kernel's device time from the profiler, and for AES, eq. 14 and every
   kernel that moves 6 MB or more also with the L2 flushed between launches
   (the dense trimmed mean and median also at the loop engine's R = 1), and the
   floor of one launch (dequantize of one element); then the host time of
   each piece of one launch;
6. trace one fit epoch of the loop engine and one round of the 64-requester
   fleet: device-busy share, launches per Adam step and the kernels that
   take the device time; and one LM training round of [4m] for each preset
   with remat on and off: its wall, device-busy share, device operations
   and aten op events;
7. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last
   line ``{"ok": true, "device": {...}}``.

It imports only ``repro_torch`` (no JAX) and needs one CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
# shared memory serves 32 banks of one 32-bit word each per clock on every
# SM (CUDA C++ Programming Guide, "Shared Memory"): the rate of table lookups
SMEM_LOOKUPS_PER_CLOCK = 32
L2_FLUSH_BYTES = 128 * 2 ** 20   # written and read between launches of a cold timing (L2: 50 MB)
HOST_CALLS, HOST_BURST = 10_000, 200
FIT_EPOCHS, MAX_ROUNDS, PRETRAIN_EPOCHS = 8, 10, 6
TIMING_ROUNDS = 10             # depth of the loop engine's timing session
FLEET_R = 64                   # requesters of the fleet path
TILE = 1024                    # int8 wire tile
# one fp32 fleet round (8 epochs of Adam), card vs CPU: the CPU's own spread
# under a 1e-7 relative perturbation of the contributors stays below it, a
# 1e-4 relative fault lands above it (both measured in every run)
FLEET_ROUND_TOL = 2e-3
ULP_REL, FAULT_REL = 1e-7, 1e-4
# [4m], one FederatedTrainer round of the LM zoo card vs CPU from the same
# weights: losses within [4l]'s LM_CARD_TOL; params by the mean absolute
# difference over every element, under [4c]'s rule (the CPU's spread under a
# ULP_REL perturbation of the weights below the limit, a FAULT_REL fault
# above it, both measured in every run).  Adam's first step moves a weight
# whose gradient is near zero by up to lr either way, so a 1e-7
# perturbation's max gap comes near a fault's and those few weights carry
# the RMS; the mean gap grows with the perturbation (the run prints each)
LM_ROUND_MEAN_TOL = 2e-7
# [4m], remat on vs off on the card: one step's loss and gradient leaves
LM_REMAT_TOL = 1e-6
LM_TRAIN_STEPS = 30
# the Byzantine world of [4d]: 20 % of the links deliver noise of scale 10
ADVERSARY = dict(p_byzantine=0.2, attack="noise", scale=10.0, seed=7)
ADV_ROUNDS = 3
BASELINE_FLEET_ROUNDS = 3
BASELINE_LANES = 6             # the requester's shard and its 5 neighbours
# the MLP world's loop learners and EnFed session: no method reached its
# target within 10 rounds there (every run took all 10, ~50 s a learner),
# so they run the fleet's 3 rounds, all of them to the budget as at 10
MLP_ROUNDS = BASELINE_FLEET_ROUNDS
# one baseline fleet round (4 requesters x 6 lanes) card vs CPU, under [4c]'s
# rule (the ULP_REL spread below the limit, a FAULT_REL fault above it).
# From random inits, 8 epochs of Adam spread a 1e-7 perturbation of the inits
# to 2.2e-2 on the CPU (LSTM, cfl), half of what the 1e-4 fault gives
# (4.1e-2), so no limit separates them there; after one epoch the spread
# stays near 1e-5 and the fault near 1e-3 (LSTM), 1e-5 to 1e-4 and 6e-3 (MLP)
BASELINE_ROUND_EPOCHS = 1
BASELINE_ROUND_TOL = 3e-4
# the 64-requester Byzantine fleet's accuracy (mean, min) under the column
# statistics, as the one-column-a-thread kernels gave it on an H100 (NVIDIA
# H100 80GB HBM3, 700 W); kernels that compute the same bits give the same
# four digits
ROBUST_FLEET_ACCURACY = {
    "fp32 trimmed_mean": (0.6511, 0.1333), "int8 trimmed_mean": (0.6496, 0.0588),
    "fp32 median": (0.7676, 0.0556), "int8 median": (0.7658, 0.0556)}
# [4g]: the paper-table twins' cut, chip_smoke's own: 1 round (the harness's
# MAX_ROUNDS, 10, patched for the phase) of 1 epoch, contributors pretrained
# 1 epoch (6 in the harness)
TABLE_ROUNDS = 1
TABLE_CUT = dict(epochs=1)
# the harness's four worlds (dataset, model)
TABLE_WORLDS = (("har", "lstm"), ("har", "mlp"), ("calories", "lstm"), ("calories", "mlp"))


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


def sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi`` ``clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


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


def host_us(fn, calls: int = HOST_CALLS, burst: int = HOST_BURST) -> float:
    """Mean host microseconds to enqueue one call of ``fn``: ``perf_counter``
    around bursts of ``burst`` calls with no synchronise inside, ``calls``
    calls in all.  The device drains between bursts, off the clock, so a
    kernel that runs longer than its enqueue never fills the launch queue
    and stalls the host into measuring the device."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // burst):
        t0 = time.perf_counter()
        for _ in range(burst):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (calls // burst * burst) * 1e6


def kernel_name_of(key: str) -> str:
    """The kernel's own name in a profiler key, without its return type,
    namespaces, template arguments and parameters: ``void (anonymous
    namespace)::fedavg_q8_kernel<5>(signed char const*, ...)`` ->
    ``fedavg_q8_kernel``."""
    head = re.split(r"[<(]", key.replace("(anonymous namespace)::", ""), maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else ""


def device_us(fn, kernel_name, iters: int = 50, flush=None, tries: int = 3):
    """Mean device microseconds per launch of the CUDA kernel named
    ``kernel_name`` (:func:`kernel_name_of` of the profiler's key equal to
    it, so that ``quantize_kernel`` never counts ``dequantize_kernel``; a
    tuple names the kernel in each source tree that ``kernel_bench.py``
    may time), from ``torch.profiler``; None if the profiler saw no device
    time in ``tries`` windows.  With ``flush`` (a tensor
    larger than the L2) each launch follows a write of it and then a read,
    so the kernel reads its inputs cold, from HBM, and evicts clean lines
    (the read writes the dirty ones back first); both are other kernels and
    are not counted."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                    flush.sum()
                fn()
            torch.cuda.synchronize()
        names = (kernel_name,) if isinstance(kernel_name, str) else kernel_name
        hits = [e for e in prof.key_averages() if kernel_name_of(e.key) in names]
        total = sum(e.self_device_time_total for e in hits)
        if total > 0:
            return total / sum(e.count for e in hits)
    return None


def us_text(us) -> str:
    """A device time from :func:`device_us` as printed: 3 decimals, or "not
    measured" where the profiler saw none."""
    return "not measured" if us is None else f"{us:.3f}"


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """The least milliseconds of the work: bytes over the HBM rate or
    operations over ``ops_per_s`` (fp32 unless the caller names the rate
    of its operations), whichever is larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cost_bound(cost: dict, ops_per_s: float = FP32_OPS_PER_S):
    """:func:`bound_ms` of one op's cost (its ``ops.py`` cost function, the
    one ``hlo_stats`` sums): its bytes and its operations (``flops``)."""
    return bound_ms(cost["bytes_accessed"], cost["flops"], ops_per_s)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain twins
# ---------------------------------------------------------------------------


def check_fedavg(dev, main_shape, fleet_shape, mlp_params):
    """Eq. 14 at the loop's (1, N, P), at the fleet's (R, N, P) and at edge
    shapes, within 1e-6 of the largest output; at the baselines' shapes
    (:func:`check_fedavg_baselines`); then at every N from 1 to 17 (the
    kernel's 16 instantiations and its any-N form) at R = 1 and 3, every
    L % 4, and on buffers that start 1-3 floats past an allocation (rows at
    every alignment), which must give the same bits.  Returns the max abs
    errors at the two main shapes."""
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
    for n_params in (main_shape[2], mlp_params):
        check_fedavg_baselines(dev, n_params)
    worst = 0.0
    for n in range(1, 18):
        for r, l in ((1, main_shape[2]), (3, 4096 + n % 4)):
            u = torch.randn((r, n, l), generator=g).to(dev)
            w = (torch.rand((r, n), generator=g) + 0.1).to(dev)
            if r > 1:
                w[1] = 0.0
            got = fedavg_batched_cuda(u, w)
            want = fedavg_batched_ref(u, w)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not err <= 1e-6 * max(float(want.abs().max()), 1.0):
                fail(f"fedavg N={n} R,L={r},{l}: max abs err {err}")
            if r > 1 and bool(got[1].ne(0).any()):
                fail(f"fedavg N={n}: an all-zero weight row must give zeros")
            worst = max(worst, err)
            flat = torch.empty(u.numel() + 3, device=dev)
            for off in (1, 2, 3):
                uo = flat[off:off + u.numel()].view(u.shape)
                uo.copy_(u)
                if not torch.equal(fedavg_batched_cuda(uo, w).view(torch.int32),
                                   got.view(torch.int32)):
                    fail(f"fedavg N={n} R,L={r},{l}: a buffer {off} floats past an "
                         "allocation gives other bits")
    print(f"  fedavg N=1..17, R=1 and 3, every L % 4, a zero weight row: max abs err "
          f"{worst:.3e}; the same bits 1-3 floats past an allocation")
    return errs["main"], errs["fleet"]


def check_fedavg_baselines(dev, n_params):
    """Eq. 14 as the baselines launch it at parameter count ``n_params``,
    within 1e-6 of the largest output: the CFL loop's (1, 6, P) and the cfl
    fleet's (R, 6, P) weighted by shard sizes, the fleet's requesters with
    2-6 lanes (0 on padded lanes); and the dfl fleet's 6 launches a round,
    one per row k of each requester's mesh or ring mixing matrix
    (``mix_w[:, k]``; padded lanes mix with themselves)."""
    from repro_torch.core import topology
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_ref

    rng = np.random.default_rng(3)
    n = BASELINE_LANES
    rosters = rng.integers(2, n + 1, FLEET_R)
    rosters[0] = n
    sizes = rng.integers(150, 2600, (FLEET_R, n)).astype(np.float32)
    for i, n_i in enumerate(rosters):
        sizes[i, n_i:] = 0.0
    cases = [("cfl loop", sizes[:1]), ("cfl fleet", sizes)]
    for kind in ("dfl_mesh", "dfl_ring"):
        strategy = topology.AggregationStrategy(kind=kind)
        mix_w = np.zeros((FLEET_R, n, n), np.float32)
        for i, n_i in enumerate(rosters):
            mix_w[i, :n_i, :n_i] = topology.group_mixing_matrix(int(n_i), strategy)
            for k in range(n_i, n):
                mix_w[i, k, k] = 1.0
        cases += [(f"{kind} row {k}", np.ascontiguousarray(mix_w[:, k])) for k in range(n)]
    g = torch.Generator().manual_seed(4)
    u = torch.randn((FLEET_R, n, n_params), generator=g).to(dev)
    worst = {}
    for name, w in cases:
        r = w.shape[0]
        got = fedavg_batched_cuda(u[:r], torch.from_numpy(w).to(dev))
        torch.cuda.synchronize()
        want = fedavg_batched_ref(u[:r], torch.from_numpy(w).to(dev))
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= 1e-6 * max(scale, 1.0):
            fail(f"fedavg {name} R,N,L={r},{n},{n_params}: max abs err {err} (scale {scale})")
        key = name.split(" row")[0]
        worst[key] = max(worst.get(key, 0.0), err)
    print(f"  fedavg baselines at P={n_params} (R=1 and {FLEET_R} x {n} lanes, "
          f"{FLEET_R - int((rosters == n).sum())} requesters with padded lanes): max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" ({n} launches a topology)")


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


def check_aes(dev, main_n, int8_n, mlp_n, table_ns=()):
    """AES byte-exact with its twin, and decrypt(encrypt(x)) = x, at the
    main paths' payloads, edge sizes and ``table_ns``: one fp32 update of
    each paper-table world, ``{name: bytes}``."""
    from repro_torch.core import crypto
    from repro_torch.kernels.aes_ctr.kernel import aes_ctr_cuda
    from repro_torch.kernels.aes_ctr.ref import aes_ctr_ref

    rng = np.random.default_rng(2)
    tables = torch.from_numpy(crypto.TABLES).to(dev)
    rk = torch.from_numpy(crypto.expand_key(rng.integers(0, 256, 16).astype(np.uint8))).to(dev)
    nonce = torch.from_numpy(rng.integers(0, 256, 8).astype(np.uint8)).to(dev)
    for name, n, offset in [("main", main_n, 0), ("int8 wire", int8_n, 0), ("MLP", mlp_n, 0),
                            ("n%16!=0", main_n + 5, 0), ("n<16", 7, 0), ("n=16", 16, 0),
                            ("unaligned", 1000 + 3, 1),
                            *((name, n, 0) for name, n in dict(table_ns).items())]:
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
    (1, score), (64, fit), (64, fleet score) and the baselines' (384, fit)
    and (384, fleet score), T = ``seq_len``; past one lane the weights are
    ``tree_unravel`` views of a flat (L, P) buffer (fp32 fit), of an
    (L, Lp)[:, :P] slice (int8) or of an (L, 6P)[:, :P] slice (the dfl
    fleet scores node 0 of its (R, 6, P) state in place), each held to its
    twin by :func:`lstm_seq_case`.  Returns the largest forward and
    backward abs errors."""
    g = torch.Generator().manual_seed(13)
    lp = n_params + (-n_params) % TILE
    fwd_worst = bwd_worst = 0.0
    base_lanes = FLEET_R * BASELINE_LANES
    for name, lanes, b, width in [("loop fit", 1, fit_b, n_params),
                                  ("loop score", 1, score_b, n_params),
                                  ("fleet fit fp32", FLEET_R, fit_b, n_params),
                                  ("fleet fit int8", FLEET_R, fit_b, lp),
                                  ("fleet score", FLEET_R, fleet_score_b, n_params),
                                  ("baseline fit", base_lanes, fit_b, n_params),
                                  ("baseline score", base_lanes, fleet_score_b, n_params),
                                  ("dfl score", FLEET_R, fleet_score_b,
                                   BASELINE_LANES * n_params)]:
        ferr, berr = lstm_seq_case(dev, g, spec, n_params, name, lanes, b, width, seq_len)
        fwd_worst, bwd_worst = max(fwd_worst, ferr), max(bwd_worst, berr)
    return fwd_worst, bwd_worst


def lstm_seq_case(dev, g, spec, n_params, name, lanes, b, width, seq_len):
    """One (L, B, T) case of the LSTM pair, its weights views of a flat
    (L, ``width``)[:, :P] buffer: the forward within 1e-5 of its twin on
    h_T, c_T and every saved state; the backward (from the kernel's saved
    states) within 1e-4 of each twin output's largest value on dgates, dh0,
    dc0 and on the weight gradients the wrapper forms from dgates.  Returns
    the forward's and the backward's largest abs errors."""
    from repro_torch.kernels.lstm_cell.kernel import lstm_seq_backward_cuda, lstm_seq_cuda
    from repro_torch.kernels.lstm_cell.ops import lstm_seq_backward
    from repro_torch.kernels.lstm_cell.ref import lstm_seq_backward_ref, lstm_seq_ref
    from repro_torch.utils.tree import tree_unravel

    buf = torch.randn((lanes, width), generator=g).to(dev) * 0.3
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
    berr = 0.0
    for out, got, w in zip(("dgates", "dh0", "dc0", "dwx", "dwh", "db"),
                           (dgates, dh0, dc0) + tuple(full[4:]), want[:3] + want[4:]):
        err = float((got - w).abs().max())
        scale = float(w.abs().max())
        if not err <= 1e-4 * scale:
            fail(f"lstm_seq backward {name} {out}: max abs err {err} (largest {scale})")
        parts.append(f"{out} {err:.2e}/{scale:.2e}")
        berr = max(berr, err)
    print(f"  lstm_seq {name:14s} L,B,F,H,T={lanes},{b},{f},{h},{seq_len}, lane stride "
          f"{wx.stride(0)}: forward max abs err {ferr:.3e}; backward err/largest "
          + ", ".join(parts))
    return ferr, berr


def check_table_shapes(dev, scenarios):
    """The shapes the paper-table twins give the kernels, each read off the
    harness's scenarios (``{name: Scenario}``): the LSTM pair at one lane,
    the world's F, T and H, at the fit batch and at every batch the world
    scores (the requester's test split, the holdout); eq. 14 at (1, N, P)
    for N = 2 ... 6 at each world's P, weighted as EnFed (uniform) and the
    CFL server (shard sizes, N = 6) weigh it, within 1e-6 of the largest
    output (AES over each world's update: :func:`check_aes`).  Returns the
    largest errors of eq. 14 and of the LSTM pair."""
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_ref
    from repro_torch.models import LSTMClassifier
    from repro_torch.utils.tree import tree_ravel

    g = torch.Generator().manual_seed(21)
    worst = {"fedavg": 0.0, "lstm_cell": 0.0, "lstm_cell_bwd": 0.0}
    for name, sc in scenarios.items():
        flat, spec = tree_ravel(sc.task.init(0))
        p = int(flat.numel())
        sizes = [float(len(s[0])) for s in sc.shards]
        fed = 0.0
        for n in range(2, harness().N_CLIENTS + 1):
            u = torch.randn((1, n, p), generator=g).to(dev)
            for how, w in (("uniform", [1.0] * n), ("shard sizes", sizes[:n])):
                w_t = torch.tensor([w], device=dev)
                got = fedavg_batched_cuda(u, w_t)
                torch.cuda.synchronize()
                want = fedavg_batched_ref(u, w_t)
                err = float((got - want).abs().max())
                if not err <= 1e-6 * max(float(want.abs().max()), 1.0):
                    fail(f"fedavg {name} R,N,L=1,{n},{p} ({how}): max abs err {err}")
                fed = max(fed, err)
        print(f"  fedavg {name:13s} R=1, N=2..{harness().N_CLIENTS}, L={p} (uniform and "
              f"shard-size weights): max abs err {fed:.3e}")
        worst["fedavg"] = max(worst["fedavg"], fed)
        if isinstance(sc.task.model, LSTMClassifier):
            cfg = sc.task.model.cfg
            for what, b in (("fit", harness().BATCH), ("score test", len(sc.own_test[0])),
                            ("score holdout", len(sc.global_test[0]))):
                ferr, berr = lstm_seq_case(dev, g, spec, p, f"{name} {what}", 1, b, p,
                                           cfg.seq_len)
                worst["lstm_cell"] = max(worst["lstm_cell"], ferr)
                worst["lstm_cell_bwd"] = max(worst["lstm_cell_bwd"], berr)
    return worst


def near_tie_rows(seed, rows=16):
    """(rows, 1024) fp32 tiles, each at its own absmax from 1e-13 to 1e37:
    the absmax, every half-integer multiple of the tile's scale and both
    fp32 neighbours of each, then uniform values.  There x / s lies within a
    few ulps of a half-integer, where the kernel's reciprocal rule must hand
    over to the division: a margin 16x too small, or RN(1/s) 8 ulps off,
    gives other codes than the twin's division."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    out = np.empty((rows, TILE), f32)
    for i, absmax in enumerate((f32(10.0) ** rng.uniform(-13, 37, rows)).astype(f32)):
        s = f32(np.maximum(absmax, f32(1e-12)) * f32(1.0 / 127.0))
        near = ((np.arange(-127, 127) + 0.5) * np.float64(s)).astype(f32)
        ties = np.concatenate([near, np.nextafter(near, f32(np.inf)),
                               np.nextafter(near, f32(-np.inf))])
        fill = (rng.uniform(-1, 1, TILE - 1 - ties.size) * absmax).astype(f32)
        out[i] = np.concatenate([[absmax], ties, fill])
    return torch.from_numpy(out)


def check_quantize(dev, n_params, rows):
    """Codes and scales bit-equal to the twin: the 1-D update (1-D outputs
    that are no views), the fleet's staging rows, an off-tile length, an
    all-zero tile, half-way codes, near-ties (:func:`near_tie_rows`, as 16
    rows and as one 1-D row), every L % 4, L below one tile, and each of
    them on rows that start 4, 8 and 12 bytes past a 16-byte boundary (the
    kernel's scalar, float2 and float4 loads)."""
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
             ("zero tile", zero_tile), ("half-way", half),
             ("near-ties", near_tie_rows(0)), ("near-ties 1-D", near_tie_rows(1).reshape(-1)),
             ("L % 4 = 1", torch.randn((3, TILE + 1), generator=g)),
             ("L % 4 = 2", torch.randn((3, 2 * TILE + 2), generator=g)),
             ("L % 4 = 3", torch.randn((3, 3 * TILE + 3), generator=g)),
             ("L < 1024", torch.randn((5, 515), generator=g) * 1e-3)]
    for name, x in cases:
        xd = x.to(dev)
        q, s = quantize_cuda(xd)
        torch.cuda.synchronize()
        qr, sr = quantize_batched_ref(xd)
        if not (torch.equal(q, qr) and torch.equal(s, sr)):
            fail(f"quantize {name} {tuple(x.shape)}: codes or scales differ from the twin")
        if name == "half-way" and q[0, :6].tolist() != [127, 0, 2, 2, 0, -2]:
            fail(f"quantize half-way: codes {q[0, :6].tolist()} are not round-half-even")
        if x.dim() == 1 and not (q.dim() == s.dim() == 1 and q._base is None
                                 and s._base is None):
            fail("quantize of one row: the outputs must be 1-D tensors of their own")
        flat = torch.empty(x.numel() + 3, device=dev)
        for off in (1, 2, 3):
            xo = flat[off:off + x.numel()].view(x.shape)
            xo.copy_(xd)
            qo, so = quantize_cuda(xo)
            if not (torch.equal(qo, qr) and torch.equal(so, sr)):
                fail(f"quantize {name} {tuple(x.shape)} at {4 * off} bytes past a 16-byte "
                     "boundary: codes or scales differ from the twin")
        print(f"  quantize {name:10s} {str(tuple(x.shape)):14s}: codes and scales bit-equal"
              " (rows at every alignment)")
    return 0.0


def dequantize_library(q, s, n):
    """One PyTorch call that computes dequantize: int8 promotes to fp32
    exactly, each product rounds once, and the slice is a view."""
    return torch.mul(q.view(-1, TILE), s.view(-1, 1)).view(-1)[:n]


def check_dequantize(dev, n_params):
    """Bit-equal to the twin, and to :func:`dequantize_library` (the
    yardstick of its timing row)."""
    from repro_torch.kernels.quantize.kernel import dequantize_cuda
    from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_batched_ref

    g = torch.Generator().manual_seed(7)
    for n in (n_params, 1000 + 7, TILE, TILE + 1):
        q, s = quantize_batched_ref(torch.randn((n,), generator=g).to(dev))
        got = dequantize_cuda(q, s, n)
        torch.cuda.synchronize()
        if not torch.equal(got, dequantize_ref(q, s, n)):
            fail(f"dequantize n={n}: differs from the twin")
        if not torch.equal(got, dequantize_library(q, s, n)):
            fail(f"dequantize n={n}: differs from torch.mul of the tiles by their scales")
        print(f"  dequantize n={n}: bit-equal to the twin and to torch.mul")
    return 0.0


def check_fedavg_q8(dev, main_shape):
    """Eq. 14 on the int8 wire against the twin within 1e-6 of the largest
    output at the fleet's (R, N, Lp) and at edge shapes; then at every N
    from 1 to 17 (the kernel's 16 instantiations and its any-N form) bit
    for bit the dense kernel on the dequantized buffer, at Lp = 1024, 2048
    and 19,456, with an all-zero weight row and at R = 1; codes that start
    1-3 bytes past a word must be refused.  Returns the max abs error at
    the main shape."""
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda, fedavg_batched_q8_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_q8_ref
    from repro_torch.kernels.quantize.ref import dequantize_batched_ref, quantize_batched_ref

    g = torch.Generator().manual_seed(8)

    def wire(r, n, lp, zero_row):
        q, s = quantize_batched_ref(torch.randn((r * n, lp), generator=g).to(dev) * 0.3)
        w = (torch.rand((r, n), generator=g) + 0.1).to(dev)
        if zero_row is not None:
            w[zero_row] = 0.0
        return q.reshape(r, n, lp), s.reshape(r, n, -1), w

    main_err = None
    for name, (r, n, lp), zero_row in [("main", main_shape, None),
                                       ("zero weight row", (3, 4, 2 * TILE), 1),
                                       ("N=1", (1, 1, TILE), None)]:
        q, s, w = wire(r, n, lp, zero_row)
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
    for n in range(1, 18):
        for r, lp in ((3, TILE), (2, 2 * TILE), (1, 19 * TILE)):
            q, s, w = wire(r, n, lp, 1 if r > 1 else None)
            got = fedavg_batched_q8_cuda(q, s, w)
            dense = fedavg_batched_cuda(dequantize_batched_ref(q, s).contiguous(), w)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), dense.view(torch.int32)):
                fail(f"fedavg_q8 N={n} R,Lp={r},{lp}: not bit-equal to fedavg on the "
                     "dequantized buffer")
    print("  fedavg_q8 N=1..17, Lp=1024/2048/19456, a zero weight row, R=1: bit-equal to "
          "fedavg on the dequantized buffer")
    codes = torch.empty(q.numel() + 3, dtype=torch.int8, device=dev)
    for off in (1, 2, 3):
        try:
            fedavg_batched_q8_cuda(codes[off:off + q.numel()].view(q.shape), s, w)
        except ValueError:
            continue
        fail(f"fedavg_q8: codes {off} bytes past a word were not refused")
    print("  fedavg_q8 codes 1-3 bytes past a word: refused")
    return main_err


def check_robust(dev, n_params, n_contrib):
    """The six robust kernels against their twins, at the fleet's (64, 5, P)
    fp32 and (64, 5, Lp) int8 state and at edge shapes: every N from 1 to
    16 (each its own instantiation of the column kernels), L off 4 and off
    512, rows at 4-, 8- and 16-byte alignment, an all-zero weight row, one
    and two active contributors, an inactive lane, tied values and tied
    contributors, a noise-sized outlier.  Each q8 kernel must equal its
    dense kernel on the dequantized buffer bit for bit, and the q8 squared
    norm over Lp the dense one over P.  Returns the max abs errors at the
    fleet's shapes."""
    from repro_torch.kernels.quantize.ref import dequantize_batched_ref, quantize_batched_ref
    from repro_torch.kernels.robust import kernel as rk
    from repro_torch.kernels.robust import ref as rr

    g = torch.Generator().manual_seed(11)
    errs = {}
    columns = (("trimmed_mean", rk.trimmed_mean_cuda, rk.trimmed_mean_q8_cuda,
                rr.trimmed_mean_batched_ref),
               ("median", rk.median_cuda, rk.median_q8_cuda, rr.median_batched_ref))
    # every N from 1 to 16, at lengths that cover each L % 4 and rows that
    # start 4, 8 and 16 bytes aligned
    lengths = (777, 513, 2048, 1007, 1500, 300, 4099, 1030, 3, 2050, 1, 5121, 258, 19, 1025, 6)
    cases = [("fleet", (FLEET_R, n_contrib, n_params)), ("L%256!=0", (3, 4, 1000 + 7))]
    cases += [(f"N={n}", (5, n, lengths[n - 1])) for n in range(1, rk.MAX_N + 1)]
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
        if r > 3 and n > 2:
            w[2, 1:] = 0.0                                   # one active contributor
            w[3, 2:] = 0.0                                   # two active
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
            if not torch.equal(got8.view(torch.int32), dense_k(dq, wd).view(torch.int32)):
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
    """Counts the forward passes of one LSTM on the card (calls of its
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


PASSES = []     # the LSTMPasses of every LSTM the paths run on the card (watch)


def watch(model) -> None:
    """Counts ``model``'s passes, if it is an LSTM (an MLP launches no
    kernel of the pair)."""
    from repro_torch.models import LSTMClassifier

    if isinstance(model, LSTMClassifier):
        PASSES.append(LSTMPasses(model))


def reset_counts() -> None:
    """Every launch count and pass count to 0, just before a path."""
    from repro_torch import kernels

    kernels.reset_launch_counts()
    for passes in PASSES:
        passes.total = passes.training = 0


def read_counts() -> dict:
    """The launch counts just after a path.  The sequence forward must have
    been launched once per forward pass of an LSTM (not once per timestep)
    and the backward once per training pass."""
    from repro_torch import kernels

    counts = kernels.launch_counts()
    total = sum(p.total for p in PASSES)
    training = sum(p.training for p in PASSES)
    print(f"    LSTM passes {total} ({training} training): lstm_cell "
          f"{counts['lstm_cell']} launches, lstm_cell_bwd {counts['lstm_cell_bwd']}")
    if counts["lstm_cell"] != total or counts["lstm_cell_bwd"] != training:
        fail(f"the LSTM's kernels were not launched once per pass: {total} forward "
             f"and {training} training passes, launches {counts}")
    return counts


def harness():
    """``benchmarks/_torch_harness.py``, the paper tables' harness: the one
    definition of the worlds, targets and runs that [4e] and [4g] drive."""
    from benchmarks import _torch_harness

    return _torch_harness


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
    from repro_torch.utils.tree import tree_map

    return {dev.device_id: {"params": tree_map(lambda v: v.to(device).clone(), pretrained[i]),
                            "data": shards[i + 1]}
            for i, dev in enumerate(fleet)}


def run_main_path(device, world, cost):
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
                           session_cfg(MAX_ROUNDS), cost_model=cost, device=device)
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
    return counts, pretrained, res.report


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
    from repro_torch.data import HARDatasetConfig, make_har_windows

    x, y, _ = make_har_windows(HARDatasetConfig(num_samples=200 * (FLEET_R + 5), seq_len=32))
    return requester_split(x, y, FLEET_R)


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
        if compress is None:
            fp32 = {"result": res, "wall": wall}

    limits = fleet_round_check(device, world, pretrained)
    return all_counts, limits, fp32


def fleet_round_check(device, world, pretrained):
    """One fleet round of 4 requesters (8 fit epochs, refresh) on the card
    and on the CPU.  Over 8 epochs Adam amplifies rounding on the weights
    whose second moment is near zero, so the card's other summation order
    shows in the params.  The limit is set between two CPU-only readings
    taken here: the spread from a 1e-7 relative perturbation of the
    contributors' params (one ulp, 3 seeds), which must stay below it, and
    a 1e-4 relative fault of the same params, which must land above it.
    Under int8 the limit is the tile bound ``max(scale) / 2 + 1e-6``.
    Returns the limit of each wire, and under ``"fp32 lanes"`` the fp32
    round's params of each lane on the card and on the CPU ([4j]'s one
    cadence step must reproduce them)."""
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
        if compress is None:
            limits["fp32 lanes"] = {"card": lanes(card), "cpu": ref, "diff": per_lane}
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
        want = ROBUST_FLEET_ACCURACY.get(f"{compress or 'fp32'} {robust}")
        if want is not None:
            got = (f"{res.accuracy.mean():.4f}", f"{res.accuracy.min():.4f}")
            print(f"    accuracy mean / min {got[0]} / {got[1]}; the earlier kernels gave "
                  f"{want[0]:.4f} / {want[1]:.4f}")
            if got != (f"{want[0]:.4f}", f"{want[1]:.4f}"):
                fail(f"{tag}: accuracy {got} differs from the earlier kernels' {want}")
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
# phase 4e: the paper's baselines
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BaselineWorld:
    """One model's world as the paper's comparison drives it: 6 Dirichlet
    clients (the requester keeps shard 0, 80/20), 5 neighbours, a holdout of
    the whole set that the baselines score on, the pooled set of the cloud
    baseline, the requesters of the baseline fleet, and the round budget of
    its loop learners."""

    name: str
    task: object
    shards: list
    own_train: tuple
    own_test: tuple
    global_test: tuple
    pooled: tuple
    fleet: list
    split: list        # (train, test) of each requester of the fleet runs
    max_rounds: int


def requester_split(x, y, r_count):
    """Each of ``r_count`` requesters' (train, test): one shard (80/20) of
    ``x, y`` split over r_count + 5 Dirichlet (alpha=1) clients."""
    from repro_torch.data import dirichlet_partition

    parts = dirichlet_partition(y, num_clients=r_count + 5, alpha=1.0, seed=0)
    out = []
    for p in parts[:r_count]:
        n = int(len(p) * 0.8)
        out.append(((x[p[:n]], y[p[:n]]), (x[p[n:]], y[p[n:]])))
    return out


def har_baseline_world(world, sc):
    """The quickstart world (LSTM, H=64) with the holdout and pooled set of
    the harness's HAR/LSTM scenario ``sc``, whose shards and splits must be
    the quickstart's bits."""
    task, shards, own_train, own_test, fleet = world
    pairs = [*zip(shards, sc.shards), (own_train, sc.own_train), (own_test, sc.own_test)]
    if len(shards) != len(sc.shards) or not all(
            np.array_equal(a, b) for x, y in pairs for a, b in zip(x, y)):
        fail("the harness's HAR/LSTM scenario is not the quickstart world")
    return BaselineWorld("LSTM (HAR)", task, sc.shards, sc.own_train, sc.own_test,
                         sc.global_test, sc.pooled, fleet, fleet_split(), MAX_ROUNDS)


def calories_world(sc):
    """Table V's second configuration, the harness's calories/MLP scenario
    ``sc`` (9,000 tabular samples of 8 features and 5 classes over 6
    Dirichlet clients, the MLP with hidden=(64, 32)), with 5 neighbours;
    its fleet's requesters split a calories set of 200 * (FLEET_R + 5)
    samples; its loop runs MLP_ROUNDS."""
    from repro_torch.core import make_fleet
    from repro_torch.data import CaloriesDatasetConfig, make_calories_tabular

    fleet = make_fleet(5, seed=1, p_has_model=1.0)
    for dev in fleet:
        dev.reservation_price = 0.4
    fx, fy = make_calories_tabular(CaloriesDatasetConfig(num_samples=200 * (FLEET_R + 5)))
    return BaselineWorld("MLP (calories)", sc.task, sc.shards, sc.own_train, sc.own_test,
                         sc.global_test, sc.pooled, fleet, requester_split(fx, fy, FLEET_R),
                         MLP_ROUNDS)


def counted(what, run, need=()):
    """Runs one path between a reset and a read of the launch counts;
    fails if a kernel in ``need`` was never launched.  Returns
    ``(result, counts, wall)``."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if not all(counts[k] > 0 for k in need):
        fail(f"{what}: a kernel of its path was never launched: {counts}")
    return res, counts, wall


def lstm_need(bw):
    """The LSTM pair, on the paths of the LSTM world."""
    from repro_torch.models import LSTMClassifier

    return ("lstm_cell", "lstm_cell_bwd") if isinstance(bw.task.model, LSTMClassifier) else ()


def enfed_mlp_report(device, bw, cost):
    """The EnFed side of the MLP world: the quickstart session's protocol
    (5 contributors pretrained 6 epochs, AES, rounds of 8 epochs) on the
    calories MLP, at the world's round budget."""
    from repro_torch.core import EnFedSession

    pretrained = [bw.task.fit(bw.task.init(seed=10 + i), bw.shards[i + 1],
                              epochs=PRETRAIN_EPOCHS, batch_size=32, seed=i)[0]
                  for i in range(len(bw.fleet))]
    session = EnFedSession(bw.task, bw.own_train, bw.own_test, bw.fleet,
                           contributor_states(pretrained, bw.shards, bw.fleet, device),
                           session_cfg(bw.max_rounds), cost_model=cost, device=device)
    res, counts, wall = counted("EnFed MLP session", session.run, ("fedavg", "aes_ctr"))
    check_session(res, "EnFed MLP session")
    print(f"  EnFed session: accuracy {res.accuracy:.4f}, rounds {res.rounds}, stop "
          f"{res.stop_reason}, wall {wall:.2f} s; launches {counts}")
    return res.report, counts


def run_loop_baselines(device, bw, cost):
    """The loop learners at full width: CFL and DFL mesh and ring to the
    harness's targets on the holdout (the world's round budget of 8 epochs
    each), and the cloud-only baseline on the pooled set.  Returns each run's report and
    launch counts."""
    from repro_torch.core import CFLLearner, DFLLearner, EnFedConfig, cloud_only_config
    from repro_torch.utils.tree import tree_leaves

    data = [bw.own_train] + bw.shards[1:]
    base = dict(max_rounds=bw.max_rounds, epochs=FIT_EPOCHS, batch_size=32, seed=0)
    runs = {
        "CFL": (lambda: CFLLearner(bw.task, data, bw.global_test, cost).run_config(
            EnFedConfig(desired_accuracy=harness().TARGET_CFL, **base)), ("fedavg",)),
        "DFL mesh": (lambda: DFLLearner(bw.task, data, bw.global_test, "mesh", cost).run_config(
            EnFedConfig(desired_accuracy=harness().TARGET_DFL, **base)), ()),
        "DFL ring": (lambda: DFLLearner(bw.task, data, bw.global_test, "ring", cost).run_config(
            EnFedConfig(desired_accuracy=harness().TARGET_DFL, **base)), ()),
        "cloud": (lambda: cloud_only_config(bw.task, bw.pooled, bw.own_test,
                                            EnFedConfig(desired_accuracy=0.0, **base), cost), ()),
    }
    out = {}
    for tag, (run, need) in runs.items():
        res, counts, wall = counted(f"{bw.name} {tag}", run, need + lstm_need(bw))
        if tag == "CFL" and counts["fedavg"] != res.rounds:
            fail(f"CFL: {counts['fedavg']} eq. 14 launches over {res.rounds} rounds (one a round)")
        n_classes = bw.task.model.cfg.num_classes
        if not (math.isfinite(res.accuracy) and res.accuracy > 1.0 / n_classes):
            fail(f"{bw.name} {tag}: accuracy {res.accuracy} is not finite and above chance")
        if not all(bool(torch.isfinite(p).all()) for p in tree_leaves(res.params)):
            fail(f"{bw.name} {tag}: non-finite parameters")
        print(f"  loop {tag}: accuracy {res.accuracy:.4f}, rounds {res.rounds}, wall {wall:.2f} s; "
              f"eq.4 T_train {res.report.t_train:.4f} s, E_tot {res.report.e_tot:.4f} J; "
              f"launches {counts}")
        out[tag] = (res.report, counts)
    return out


def print_reductions(name, enfed, loop):
    """EnFed against DFL mesh and ring (and CFL, cloud): T_train and E_tot
    from the one CostModel, with EnFed's reduction in %."""
    print(f"  {name}: EnFed T_train {enfed.t_train:.4f} s, E_tot {enfed.e_tot:.4f} J")
    for tag, (rep, _) in loop.items():
        dt = 100.0 * (1.0 - enfed.t_train / rep.t_train)
        de = 100.0 * (1.0 - enfed.e_tot / rep.e_tot)
        print(f"    vs {tag:8s}: T_train {rep.t_train:.4f} s, E_tot {rep.e_tot:.4f} J; "
              f"EnFed's reduction {dt:.1f} % of the time, {de:.1f} % of the energy")
        if not (math.isfinite(dt) and math.isfinite(de)):
            fail(f"{name}: the reduction against {tag} is not finite")


def baseline_specs(device, bw, r_count):
    """``r_count`` requesters of the world's split, all with the world's 5
    neighbours (the baselines read their data only)."""
    from repro_torch.core import RequesterSpec

    states = {dev.device_id: {"params": None, "data": bw.shards[i + 1]}
              for i, dev in enumerate(bw.fleet)}
    return [RequesterSpec(train, test, bw.fleet, states) for train, test in bw.split[:r_count]]


BASELINE_METHODS = (("cfl", "mesh"), ("dfl", "mesh"), ("dfl", "ring"))


def run_fleet_baselines(device, bw):
    """``run_fleet(method="cfl"|"dfl")`` at R = 64 (6 lanes each: 384 fit
    lanes) for 3 rounds of 8 epochs.  Eq. 14 must run once a round (cfl) or
    once per mixing row, 6 a round (dfl).  Returns each run's counts."""
    from repro_torch.core import EnFedConfig, run_fleet
    from repro_torch.utils.tree import tree_leaves

    cfg = EnFedConfig(desired_accuracy=1.01, max_rounds=BASELINE_FLEET_ROUNDS,
                      epochs=FIT_EPOCHS, batch_size=32)
    out = {}
    for method, topo in BASELINE_METHODS:
        tag = f"fleet {method}" + (f" {topo}" if method == "dfl" else "")
        specs = baseline_specs(device, bw, FLEET_R)
        torch.cuda.reset_peak_memory_stats()
        res, counts, wall = counted(
            f"{bw.name} {tag}", lambda: run_fleet(bw.task, specs, cfg, method=method,
                                                  dfl_topology=topo, device=device),
            ("fedavg",) + lstm_need(bw))
        peak = torch.cuda.max_memory_allocated()
        executed = int(res.history["round_executed"].sum())
        lanes = len(bw.fleet) + 1
        if lanes != BASELINE_LANES:
            fail(f"{tag}: {lanes} lanes a requester, phase [3] checked {BASELINE_LANES}")
        per_round = 1 if method == "cfl" else lanes
        if counts["fedavg"] != executed * per_round:
            fail(f"{tag}: {counts['fedavg']} eq. 14 launches over {executed} rounds "
                 f"({per_round} a round)")
        if executed != BASELINE_FLEET_ROUNDS or not (res.rounds == BASELINE_FLEET_ROUNDS).all():
            fail(f"{tag}: rounds {res.rounds.tolist()}, {executed} executed")
        chance = 1.0 / bw.task.model.cfg.num_classes
        if not (np.isfinite(res.accuracy).all() and res.accuracy.mean() > chance) or not all(
                bool(torch.isfinite(p).all()) for s in res.sessions for p in tree_leaves(s.params)):
            fail(f"{tag}: accuracy {res.accuracy} or parameters not finite and above chance")
        lane_rounds = int(res.rounds.sum())
        print(f"  {tag:14s} R={FLEET_R} x {lanes} lanes: wall {wall:.2f} s, {executed} rounds, "
              f"{lane_rounds / wall:.2f} lane-rounds/s; accuracy mean {res.accuracy.mean():.4f} "
              f"min {res.accuracy.min():.4f}; peak device memory {peak / 2**20:.1f} MiB; "
              f"launches {counts}")
        out[tag] = counts
    return out


def baseline_round_check(device, bw, tol):
    """One round (BASELINE_ROUND_EPOCHS) of 4 requesters per method, card vs
    CPU, under [4c]'s rule: the limit ``tol`` lies above the CPU's own
    spread when every node's init is perturbed by 1e-7 relative (3 seeds)
    and below the difference a 1e-4 relative fault of the inits makes."""
    from repro_torch.core import EnFedConfig, SupervisedTask, run_fleet
    from repro_torch.utils.tree import tree_map, tree_ravel

    cpu = torch.device("cpu")
    model_cls, model_cfg = type(bw.task.model), bw.task.model.cfg

    class PerturbedInit(SupervisedTask):
        """The CPU twin of the world's task, its inits times (1 + rel N(0, 1))."""

        def __init__(self, rel, seed):
            super().__init__(model_cls(model_cfg, device=cpu), lr=bw.task.lr)
            self.rel, self.pseed = rel, seed

        def init(self, seed=0):
            g = torch.Generator().manual_seed(1000 * self.pseed + seed)
            return tree_map(lambda t: t * (1 + self.rel * torch.randn(t.shape, generator=g)),
                            super().init(seed))

    def lanes(res):
        return torch.stack([tree_ravel(s.params)[0].cpu() for s in res.sessions])

    cfg = EnFedConfig(desired_accuracy=1.01, max_rounds=1, epochs=BASELINE_ROUND_EPOCHS,
                      batch_size=32)
    t0 = time.perf_counter()
    for method, topo in BASELINE_METHODS[:2]:
        tag = f"{method}" + (f" {topo}" if method == "dfl" else "")

        def run(d, task):
            return run_fleet(task, baseline_specs(d, bw, 4), cfg, method=method,
                             dfl_topology=topo, device=d)

        card, host = run(device, bw.task), run(cpu, PerturbedInit(0.0, 0))
        ref = lanes(host)
        per_lane = (lanes(card) - ref).abs().max(dim=1).values
        diff = float(per_lane.max())
        noise = max(float((lanes(run(cpu, PerturbedInit(ULP_REL, sd))) - ref).abs().max())
                    for sd in range(3))
        fault = float((lanes(run(cpu, PerturbedInit(FAULT_REL, 0))) - ref).abs().max())
        print(f"  one {tag} round R=4 card vs CPU: max abs param diff {diff:.3e} (per lane "
              f"{', '.join(f'{v:.3e}' for v in per_lane.tolist())}; limit {tol:.3e}); CPU vs "
              f"CPU: {ULP_REL:g} perturbation {noise:.3e}, {FAULT_REL:g} fault {fault:.3e}")
        if not noise < tol:
            fail(f"{bw.name} {tag} round: the CPU's own spread {noise} reaches the limit {tol}")
        if not fault > tol:
            fail(f"{bw.name} {tag} round: a {FAULT_REL:g} fault ({fault}) stays within the "
                 f"limit {tol}, which therefore checks nothing")
        if not diff <= tol:
            fail(f"{bw.name} {tag} round: the card and the CPU differ by {diff}")
        if not (np.array_equal(card.rounds, host.rounds)
                and np.array_equal(card.stop_codes, host.stop_codes)):
            fail(f"{bw.name} {tag} round: rounds or stop codes differ between card and CPU")
    print(f"  card vs CPU rounds: {time.perf_counter() - t0:.2f} s")


def time_dfl_mixing(dev, n_params, lanes):
    """The fleet dfl's AGGREGATE at its shape, (FLEET_R, lanes, P): one eq. 14
    launch per mixing row and the stack of the rows, as a round runs them,
    against one batched product of the same mixing (``torch.bmm``), warm
    and with the L2 flushed before each round; beside the bound of one pass
    (the buffer read once, the mixed buffer written once), which the N
    launches exceed by reading the buffer N times."""
    from repro_torch.core import topology
    from repro_torch.kernels.fedavg.ops import fedavg_flat_batched

    g = torch.Generator().manual_seed(0)
    u = torch.randn((FLEET_R, lanes, n_params), generator=g).to(dev)
    ring = topology.group_mixing_matrix(lanes, topology.AggregationStrategy(kind="dfl_ring"))
    mix = torch.from_numpy(ring).to(dev).expand(FLEET_R, lanes, lanes).contiguous()
    rows = [mix[:, k].contiguous() for k in range(lanes)]

    def n_launches():
        return torch.stack([fedavg_flat_batched(u, w) for w in rows], dim=1)

    def library():
        return torch.bmm(mix, u)

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def cold_ms(fn, iters=30):
        total = 0.0
        for _ in range(iters):
            flush.add_(1.0)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    err = float((n_launches() - library()).abs().max())
    warm = (cuda_ms(n_launches, iters=100), cuda_ms(library, iters=100))
    cold = (cold_ms(n_launches), cold_ms(library))
    bound = 2 * u.numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(f"  dfl mixing, R,N,P = {FLEET_R},{lanes},{n_params}: {lanes} eq. 14 launches + stack "
          f"{warm[0]:.5f} ms warm, {cold[0]:.5f} cold a round; one torch.bmm {warm[1]:.5f} / "
          f"{cold[1]:.5f}; bound of one pass {bound:.6f} ms (bytes); max abs diff {err:.2e}")
    if not err <= 1e-5:
        fail(f"dfl mixing: the {lanes} launches and torch.bmm differ by {err}")


def run_quickstart_twin():
    """``examples/torch_quickstart.py`` as a user runs it, on the card."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in out.stdout.splitlines():
        print("    " + line)
    if out.returncode != 0:
        fail(f"examples/torch_quickstart.py exited {out.returncode}: {out.stderr[-2000:]}")
    print(f"  examples/torch_quickstart.py: exit 0 in {wall:.2f} s (a process of its own)")


def run_baselines(device, world, scenarios, lstm_enfed, cost):
    """Phase [4e] in the LSTM world and the MLP world, both from the
    harness's ``scenarios``, EnFed's side of the LSTM world being the [4a]
    session's report.  Returns the loop paths' and the fleet paths' launch
    counts."""
    from repro_torch.utils.tree import tree_size

    loop_paths, fleet_paths = [], []
    for bw in (har_baseline_world(world, scenarios["har/lstm"]),
               calories_world(scenarios["calories/mlp"])):
        print(f"  {bw.name}: P = {tree_size(bw.task.init(0))}, clients "
              f"{[len(s[0]) for s in bw.shards]}, holdout {len(bw.global_test[0])}")
        if bw.task is world[0]:
            enfed = lstm_enfed
        else:
            enfed, counts = enfed_mlp_report(device, bw, cost)
            loop_paths.append(counts)
        loop = run_loop_baselines(device, bw, cost)
        loop_paths += [c for _, c in loop.values()]
        print_reductions(bw.name, enfed, loop)
        fleet_paths += run_fleet_baselines(device, bw).values()
        if bw.task is world[0]:
            time_dfl_mixing(device, tree_size(bw.task.init(0)), len(bw.fleet) + 1)
        baseline_round_check(device, bw, BASELINE_ROUND_TOL)
    run_quickstart_twin()
    return loop_paths, fleet_paths


# ---------------------------------------------------------------------------
# phase 4f: the facade
# ---------------------------------------------------------------------------

# the quickstart world's method, its depth cut: 3 rounds of 2 epochs (the
# quickstart runs 10 of 8)
FACADE_KNOBS = dict(desired_accuracy=0.95, max_rounds=3, epochs=2, batch_size=32, n_max=5,
                    encrypt=True)
FACADE_DIR = ROOT / "build" / "4f"
# the spans each engine's enfed run records (RunResult.timings)
ENGINE_SPANS = {"loop": {"handshake", "transport", "fit", "refresh"},
                "fleet": {"stage", "program", "unpack"}}
# the kernels each [4f] run must launch, by method key and engine (the
# kernel table's rows; the loop dfl mixes with a plain product)
FACADE_NEED = {
    ("enfed", "loop"): ("fedavg", "lstm_cell", "lstm_cell_bwd", "aes_ctr"),
    ("enfed", "fleet"): ("fedavg", "lstm_cell", "lstm_cell_bwd"),
    ("cfl", "loop"): ("fedavg", "lstm_cell", "lstm_cell_bwd"),
    ("cfl", "fleet"): ("fedavg", "lstm_cell", "lstm_cell_bwd"),
    ("dfl", "loop"): ("lstm_cell", "lstm_cell_bwd"),
    ("dfl", "fleet"): ("fedavg", "lstm_cell", "lstm_cell_bwd"),
    ("dfl-ring", "loop"): ("lstm_cell", "lstm_cell_bwd"),
    ("dfl-ring", "fleet"): ("fedavg", "lstm_cell", "lstm_cell_bwd"),
    ("cloud", "loop"): ("lstm_cell", "lstm_cell_bwd"),
    ("cloud", "fleet"): ("lstm_cell", "lstm_cell_bwd"),
    ("enfed-int8-clip", "loop"): ("quantize", "dequantize", "sqnorm", "fedavg", "aes_ctr",
                                  "lstm_cell", "lstm_cell_bwd"),
    ("enfed-int8-clip", "fleet"): ("fedavg_q8", "quantize", "sqnorm_q8", "lstm_cell",
                                   "lstm_cell_bwd"),
}


class FacadeRuns:
    """Counts each facade run's launches, through the public registry: every
    registered runner is re-registered wrapped between a reset and a read of
    the launch counts, so a ``compare`` gives one count per method.  A run
    whose log and Chrome trace the next run overwrites (one ``TraceConfig``
    for a whole ``compare``) has them checked when that next run starts."""

    def __init__(self, engine):
        self.engine = engine
        self.counts = {}
        self.pending = None       # (result, trace config) whose exports are on disk

    def __enter__(self):
        from repro_torch.api import get_runner, method_names, register_method

        self.originals = {n: get_runner(n) for n in method_names()}
        for name, runner in self.originals.items():
            register_method(name)(functools.partial(self._run, runner))
        return self

    def __exit__(self, *exc):
        from repro_torch.api import register_method

        for name, runner in self.originals.items():
            register_method(name)(runner)
        return False

    def _run(self, runner, world, method, execution):
        self.check_pending()
        torch.cuda.synchronize()
        reset_counts()
        res = runner(world, method, execution)
        torch.cuda.synchronize()
        counts = read_counts()
        need = FACADE_NEED[(method.key, self.engine)]
        if not all(counts[k] > 0 for k in need):
            fail(f"[4f] {method.key} ({self.engine}): a kernel of its path was never "
                 f"launched: {counts}")
        self.counts[method.key] = counts
        if execution.trace is not None:
            self.pending = (res, execution.trace)
        return res

    def check_pending(self):
        """The exports on disk are the pending run's: its event log reads
        back equal to its trace, its Chrome trace loads and holds its spans."""
        if self.pending is None:
            return
        from repro_torch.telemetry import read_events_jsonl

        res, tr = self.pending
        self.pending = None
        if read_events_jsonl(tr.events_jsonl) != res.trace:
            fail(f"[4f] {res.method} ({self.engine}): {tr.events_jsonl} does not read back "
                 f"equal to the run's trace")
        with open(tr.chrome_trace) as fh:
            names = {e["name"] for e in json.load(fh)["traceEvents"]}
        want = {sp.name for sp in res.timeline.spans}
        if res.method.startswith("enfed"):
            want |= ENGINE_SPANS[res.engine]
        if not want <= names:
            fail(f"[4f] {res.method} ({res.engine}): Chrome trace holds {sorted(names)}, "
                 f"not {sorted(want)}")


BASELINE_KEYS = ("dfl", "cfl", "dfl-ring")


def baseline_methods(method):
    """dfl (mesh), cfl and dfl-ring with ``method``'s knobs."""
    return ["dfl", "cfl",
            dataclasses.replace(method, name="dfl", topology="ring", label="dfl-ring")]


def facade_trace(tag):
    from repro_torch.telemetry import TraceConfig

    FACADE_DIR.mkdir(parents=True, exist_ok=True)
    return TraceConfig(events_jsonl=str(FACADE_DIR / f"{tag}.jsonl"),
                       chrome_trace=str(FACADE_DIR / f"{tag}.json"))


def check_timings(res, what):
    want = ENGINE_SPANS[res.engine]
    if not want <= set(res.timings):
        fail(f"[4f] {what}: timings {sorted(res.timings)} lack {sorted(want)}")


def outcome_bits_equal(a, b):
    """Params bit for bit and every history buffer equal."""
    from repro_torch.utils.tree import tree_leaves

    if a.rounds != b.rounds or a.stop_reason != b.stop_reason:
        return False
    if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(tree_leaves(a.params), tree_leaves(b.params))):
        return False
    ha, hb = a.history_raw, b.history_raw
    return set(ha) == set(hb) and all(
        len(ha[k]) == len(hb[k]) and all(np.array_equal(np.asarray(x), np.asarray(y))
                                         for x, y in zip(ha[k], hb[k])) for k in ha)


def fleet_bits_equal(a, b):
    """Two fleet runs equal in every lane: each session's params and
    history bit for bit, and the stacked battery, rounds, stops and
    traces."""
    return (np.array_equal(a.battery_level, b.battery_level)
            and np.array_equal(a.rounds, b.rounds)
            and np.array_equal(a.stop_codes, b.stop_codes)
            and set(a.history) == set(b.history)
            and all(np.array_equal(v, b.history[k]) for k, v in a.history.items())
            and len(a.sessions) == len(b.sessions)
            and all(outcome_bits_equal(x, y) for x, y in zip(a.sessions, b.sessions)))


def max_param_diff(a, b):
    from repro_torch.utils.tree import tree_leaves

    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a.params),
                                                         tree_leaves(b.params)))


def baselines_engine_parity(loop, fleet, name, gate):
    """Loop against fleet for a baseline: rounds and stop exact; with
    ``gate``, also the reference's numeric rule (tests/test_api.py, at its
    depth of 2 rounds of 1 epoch): accuracy within rtol 1e-5 / atol 1e-6,
    params within rtol 1e-4 / atol 1e-5."""
    from repro_torch.utils.tree import tree_leaves

    if (loop.rounds, loop.stop_reason) != (fleet.rounds, fleet.stop_reason):
        fail(f"[4f] {name}: loop {loop.rounds} rounds ({loop.stop_reason}), fleet "
             f"{fleet.rounds} ({fleet.stop_reason})")
    acc_l = np.asarray(loop.history_raw["accuracy"])
    acc_f = np.asarray(fleet.history_raw["accuracy"])
    diff = max_param_diff(fleet, loop)
    print(f"    {name} loop vs fleet ({loop.rounds} rounds{'' if gate else ', not gated'}): "
          f"accuracy loop {acc_l.tolist()} fleet {acc_f.tolist()}; max abs param diff "
          f"{diff:.3e}")
    if not gate:
        return
    if not np.allclose(acc_f, acc_l, rtol=1e-5, atol=1e-6):
        fail(f"[4f] {name}: accuracy loop {acc_l} fleet {acc_f}")
    if not all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
               for a, b in zip(tree_leaves(fleet.params), tree_leaves(loop.params))):
        fail(f"[4f] {name}: params loop vs fleet beyond rtol 1e-4 / atol 1e-5")


def run_facade(device, world, pretrained, cost):
    """Phase [4f]: the quickstart world through ``repro_torch.api`` on both
    engines.  Returns the loop runs' and the fleet runs' launch counts."""
    from repro_torch.api import ExecutionSpec, Experiment, MethodSpec, WorldSpec
    from repro_torch import kernels
    from repro_torch.core import AdversaryConfig
    from repro_torch.telemetry import compare_event_streams

    task, shards, own_train, own_test, fleet = world

    def world_spec():
        return WorldSpec.single(task, own_train, own_test, fleet,
                                contributor_states(pretrained, shards, fleet, device),
                                cost_model=cost, device=device)

    method = MethodSpec(**FACADE_KNOBS)
    methods = ["enfed", *baseline_methods(method)[:2], "cloud", baseline_methods(method)[2]]
    byz = dataclasses.replace(method, compress="int8", robust="clip",
                              adversary=AdversaryConfig(**ADVERSARY), label="enfed-int8-clip")
    cmp, byz_runs, counts = {}, {}, {}
    for engine in ("loop", "fleet"):
        with FacadeRuns(engine) as runs:
            exp = Experiment(world_spec(), method,
                             ExecutionSpec(engine=engine, trace=facade_trace(engine)))
            cmp[engine] = exp.compare(methods)
            runs.check_pending()
            byz_runs[engine] = Experiment(world_spec(), byz, ExecutionSpec(
                engine=engine, trace=facade_trace(f"{engine}-int8-clip"))).run()
            runs.check_pending()
        counts[engine] = runs.counts
        print(f"  [4f] engine={engine}")
        for line in cmp[engine].table().splitlines():
            print("    " + line)
        for row in cmp[engine].reductions("enfed"):
            print(f"    EnFed vs {row['baseline']:<9}: {row['time_reduction_pct']:+.2f}% time, "
                  f"{row['energy_reduction_pct']:+.2f}% energy")
        for name, res in list(cmp[engine].results.items()) + [("enfed-int8-clip",
                                                                byz_runs[engine])]:
            print(f"    {name:16s} wall {res.wall_s:.2f} s; timings (s) "
                  + ", ".join(f"{k} {v:.3f}" for k, v in res.timings.items()))
        check_timings(cmp[engine]["enfed"], f"enfed {engine}")
        check_timings(byz_runs[engine], f"enfed-int8-clip {engine}")
        summary = byz_runs[engine].corruption_summary
        print(f"    corruption_summary ({engine}): {summary}")
        if not summary or summary["corrupted_links"] == 0:
            fail(f"[4f] {engine}: no link was corrupted in the Byzantine run")
        for name, c in runs.counts.items():
            print(f"    launches {name} ({engine}): {({k: v for k, v in c.items() if v})}")

    # enfed loop against fleet on the card: the reference's cross-engine rule
    for what, a, b in (("fp32", cmp["loop"]["enfed"], cmp["fleet"]["enfed"]),
                       ("int8 + clip", byz_runs["loop"], byz_runs["fleet"])):
        diffs = compare_event_streams(a.trace, b.trace)
        if diffs:
            fail(f"[4f] enfed {what} loop vs fleet event streams differ: {diffs[:5]}")
        print(f"    enfed {what}: loop and fleet event streams equal "
              f"({len(a.trace)} events)")
    # the baselines train from random inits, where the engines' rounding
    # (batched products at L = 1 in the loop, at L = 6 in the fleet) grows
    # past the reference's limits by round 3 of 2 epochs on the card
    # (PERF.md §6): gated at the reference test's depth, 2 rounds of 1
    # epoch, and printed at [4f]'s
    for name in BASELINE_KEYS:
        baselines_engine_parity(cmp["loop"][name], cmp["fleet"][name], name, gate=False)
    shallow = dataclasses.replace(method, max_rounds=2, epochs=1)
    parity = {}
    for engine in ("loop", "fleet"):
        with FacadeRuns(engine) as runs:
            parity[engine] = Experiment(world_spec(), shallow, ExecutionSpec(
                engine=engine)).compare(baseline_methods(shallow))
        for name, c in runs.counts.items():
            counts[engine][f"{name} (2x1)"] = c
    for name in BASELINE_KEYS:
        baselines_engine_parity(parity["loop"][name], parity["fleet"][name], name, gate=True)

    # the plain twins by the caller's choice: no kernel launched, same stream
    traced = cmp["fleet"]["enfed"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    plain = Experiment(world_spec(), method, ExecutionSpec(engine="fleet",
                                                           use_pallas=False)).run()
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    if any(launched.values()):
        fail(f"[4f] use_pallas=False launched kernels: {launched}")
    diffs = compare_event_streams(traced.trace, plain.trace)
    if diffs:
        fail(f"[4f] use_pallas=False event stream differs from the kernels': {diffs[:5]}")
    print(f"    enfed fleet use_pallas=False: no kernel launched, wall {plain.wall_s:.2f} s "
          f"(kernels {traced.wall_s:.2f} s), event stream equal")

    # tracing changes nothing: the traced fleet run against an untraced one
    untraced = Experiment(world_spec(), method, ExecutionSpec(engine="fleet")).run()
    if not outcome_bits_equal(traced, untraced):
        fail("[4f] the traced and untraced enfed fleet runs differ")
    print("    enfed fleet traced vs untraced: params and history bit-equal")
    return ([*counts["loop"].values()], [*counts["fleet"].values()])


# ---------------------------------------------------------------------------
# phase 4g: the paper-table twins
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fedavg_shapes():
    """The (R, N, L) of every eq. 14 launch inside the block."""
    from repro_torch.kernels.fedavg import ops

    seen, launch = [], ops.fedavg_batched_cuda

    def logged(updates, weights):
        seen.append(tuple(updates.shape))
        return launch(updates, weights)

    ops.fedavg_batched_cuda = logged
    try:
        yield seen
    finally:
        ops.fedavg_batched_cuda = launch


def run_tables(device, scenarios):
    """Phase [4g]: the harness's runs in each of its four worlds at
    chip_smoke's cut (TABLE_ROUNDS rounds of TABLE_CUT, contributors
    pretrained 1 epoch), and EnFed with 2 contributors on the HAR LSTM.
    Each run's outcome must be finite (accuracy in [0, 1], a positive
    report, EnFed's loss per round for Fig 7), and its launches those of
    its path: eq. 14 once a round at (1, N, P), N the contributors (EnFed)
    or the 6 clients (CFL), none for DFL and cloud; AES twice per
    contributor a round (EnFed); the LSTM pair in the LSTM worlds only, once
    per pass; no other kernel.  Returns each run's launch counts."""
    from repro_torch.models import LSTMClassifier
    from repro_torch.utils.tree import tree_size

    h = harness()
    runs = []   # (world, what, run, eq. 14's N or None)
    for name, sc in scenarios.items():
        runs += [
            (name, "enfed", functools.partial(h.run_enfed, sc, pretrain_epochs=1, **TABLE_CUT),
             5),
            (name, "cfl", functools.partial(h.run_cfl, sc, **TABLE_CUT), h.N_CLIENTS),
            (name, "dfl mesh", functools.partial(h.run_dfl, sc, "mesh", **TABLE_CUT), None),
            (name, "dfl ring", functools.partial(h.run_dfl, sc, "ring", **TABLE_CUT), None),
            (name, "cloud", functools.partial(h.run_cloud, sc, **TABLE_CUT), None)]
    runs.append(("har/lstm", "enfed n_contrib=2", functools.partial(
        h.run_enfed, scenarios["har/lstm"], n_contrib=2, pretrain_epochs=1, **TABLE_CUT), 2))
    max_rounds, h.MAX_ROUNDS = h.MAX_ROUNDS, TABLE_ROUNDS
    out = []
    try:
        for name, what, run, n_eq14 in runs:
            sc = scenarios[name]
            with fedavg_shapes() as shapes:
                res, counts, wall = counted(f"[4g] {name} {what}", run)
            if isinstance(res, tuple):      # run_cloud: (accuracy, response, params)
                acc, rounds, t_train, e_tot = float(res[0]), 1, float(res[1]), None
            else:
                acc, rounds = float(res.accuracy), int(res.rounds)
                t_train, e_tot = float(res.report.t_train), float(res.report.e_tot)
            if not (math.isfinite(acc) and 0.0 <= acc <= 1.0):
                fail(f"[4g] {name} {what}: accuracy {acc}")
            if not all(math.isfinite(v) and v > 0.0 for v in (t_train, e_tot) if v is not None):
                fail(f"[4g] {name} {what}: report T_train {t_train}, E_tot {e_tot}")
            if not 1 <= rounds <= TABLE_ROUNDS:
                fail(f"[4g] {name} {what}: {rounds} rounds, the cut is {TABLE_ROUNDS}")
            if what.startswith("enfed"):
                loss = res.history_raw.get("loss")
                if loss is None or len(loss) != rounds or not all(map(math.isfinite, loss)):
                    fail(f"[4g] {name} {what}: Fig 7's loss per round is {loss}")
            p = tree_size(sc.task.init(0))
            want = {k: 0 for k in counts}
            if n_eq14 is not None:
                want["fedavg"] = rounds
            if what.startswith("enfed"):    # each update encrypted, then decrypted
                want["aes_ctr"] = 2 * n_eq14 * rounds
            lstm = isinstance(sc.task.model, LSTMClassifier)
            if lstm and not (counts["lstm_cell"] and counts["lstm_cell_bwd"]):
                fail(f"[4g] {name} {what}: the LSTM pair was not launched: {counts}")
            for k in ("lstm_cell", "lstm_cell_bwd"):
                want[k] = counts[k] if lstm else 0
            if counts != want or shapes != [(1, n_eq14, p)] * want["fedavg"]:
                fail(f"[4g] {name} {what}: launches {counts}, eq. 14 at {shapes}; expected "
                     f"{want}, eq. 14 at (1, {n_eq14}, {p}) once a round"
                     + (" and the LSTM pair" if lstm else ""))
            print(f"  {name:13s} {what:17s} acc {acc:.4f}, rounds {rounds}, T_train "
                  f"{t_train:.4f} s" + ("" if e_tot is None else f", E_tot {e_tot:.4f} J")
                  + f", wall {wall:.2f} s; launches {({k: v for k, v in counts.items() if v})}")
            out.append(counts)
    finally:
        h.MAX_ROUNDS = max_rounds
    return out


# ---------------------------------------------------------------------------
# phase 4h: the mobility world
# ---------------------------------------------------------------------------

# the churn world of examples/har_federated.py's walkthrough: the devices walk
# 2-round legs in a 200 m arena, a contract needs 90 m of radio range, 3
# slots; an accuracy no round reaches, so every run renegotiates each round
CHURN = dict(arena_m=200.0, radio_range_m=90.0, leg_rounds=2, seed=5)
CHURN_N_MAX = 3


def churn_cfg(compress=None, max_rounds=MAX_ROUNDS, **kw):
    from repro_torch.core import MobilityConfig

    return dataclasses.replace(session_cfg(max_rounds), desired_accuracy=1.01,
                               n_max=CHURN_N_MAX, contributor_refresh_epochs=1,
                               compress=compress, mobility=MobilityConfig(**CHURN), **kw)


def churn_line(masks):
    """Members per round and the joins and leaves of a (rounds, N) trace."""
    from repro_torch.core.mobility import membership_events

    masks = np.asarray(masks) > 0.5
    joins, leaves = membership_events(masks)
    return (f"members per round {masks.sum(axis=1).astype(int).tolist()}, "
            f"{joins} joins, {leaves} leaves")


def check_churn_shapes(dev, spec, n_params, fit_b, seq_len):
    """The shapes the mobility world gives the kernels that phase [3] does
    not already hold: eq. 14 dense and int8 at the fleet's (64, 5, P | Lp)
    with 0/1 member weights and member-less rows (which must give zeros),
    the batched dequantize over the fleet's 320 refresh rows (bit-equal to
    the twin), and the LSTM pair at the 320 refresh lanes (one per
    requester and candidate), fp32 and int8 lane strides.  Returns the
    largest errors by kernel."""
    from repro_torch import kernels
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda, fedavg_batched_q8_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_q8_ref, fedavg_batched_ref
    from repro_torch.kernels.quantize.ops import dequantize_flat_batched
    from repro_torch.kernels.quantize.ref import dequantize_batched_ref, quantize_batched_ref

    g = torch.Generator().manual_seed(22)
    lp = n_params + (-n_params) % TILE
    rows = FLEET_R * 5
    member = (torch.rand((FLEET_R, 5), generator=g) < 0.5).to(torch.float32)
    member[[3, 17, 40]] = 0.0                           # lanes with no member this round
    member[5] = 1.0
    w = member.to(dev)
    u = torch.randn((FLEET_R, 5, n_params), generator=g).to(dev)
    got = fedavg_batched_cuda(u, w)
    torch.cuda.synchronize()
    want = fedavg_batched_ref(u, w)
    err = float((got - want).abs().max())
    if not err <= 1e-6 * max(float(want.abs().max()), 1.0):
        fail(f"fedavg at the churning fleet's (64, 5, {n_params}): max abs err {err}")
    if bool(got[[3, 17, 40]].ne(0).any()):
        fail("fedavg: a member-less lane must aggregate to zeros")
    q, s = quantize_batched_ref(u.reshape(rows, n_params))
    got8 = fedavg_batched_q8_cuda(q.reshape(FLEET_R, 5, lp), s.reshape(FLEET_R, 5, -1), w)
    torch.cuda.synchronize()
    want8 = fedavg_batched_q8_ref(q.reshape(FLEET_R, 5, lp), s.reshape(FLEET_R, 5, -1), w)
    err8 = float((got8 - want8).abs().max())
    if not err8 <= 1e-6 * max(float(want8.abs().max()), 1.0) or bool(got8[[3, 17]].ne(0).any()):
        fail(f"fedavg_q8 at the churning fleet's (64, 5, {lp}): max abs err {err8}")
    print(f"  fedavg R,N,L={FLEET_R},5,{n_params} with member weights, 3 member-less lanes: "
          f"max abs err {err:.3e}; q8 at Lp={lp}: {err8:.3e}; member-less lanes give zeros")
    before = kernels.launch_counts()["dequantize"]
    dq = dequantize_flat_batched(q, s)
    torch.cuda.synchronize()
    if kernels.launch_counts()["dequantize"] != before + 1:
        fail("dequantize_flat_batched on the card did not launch the dequantize kernel once")
    if dq.shape != (rows, lp) or not torch.equal(dq, dequantize_batched_ref(q, s)):
        fail(f"dequantize at the fleet's refresh rows ({rows}, {lp}): differs from the twin")
    print(f"  dequantize ({rows}, {lp}), the churning fleet's refresh source: one launch, "
          "bit-equal to the twin")
    fwd = bwd = 0.0
    for name, width in (("churn refresh fp32", n_params), ("churn refresh int8", lp)):
        ferr, berr = lstm_seq_case(dev, g, spec, n_params, name, rows, fit_b, width, seq_len)
        fwd, bwd = max(fwd, ferr), max(bwd, berr)
    return {"fedavg_batched": err, "fedavg_q8": err8, "lstm_cell": fwd, "lstm_cell_bwd": bwd}


def churn_loop(device, world, pretrained, cfg, tag):
    """One loop session in the churn world, its launches counted and held to
    its path: eq. 14 once per round with a member, at (1, members, P); AES
    twice per member a round; the LSTM pair once per pass."""
    from repro_torch.core import EnFedSession
    from repro_torch.utils.tree import tree_size

    task, shards, own_train, own_test, fleet = world
    session = EnFedSession(task, own_train, own_test, fleet,
                           contributor_states(pretrained, shards, fleet, device), cfg,
                           device=device)
    with fedavg_shapes() as shapes:
        res, counts, wall = counted(f"[4h] {tag}", session.run,
                                    ("fedavg", "aes_ctr", "lstm_cell", "lstm_cell_bwd"))
    check_session(res, f"[4h] {tag}")
    members = [int(m) for m in res.history_raw["members"]]
    p = tree_size(res.params)
    if cfg.robust == "none":
        want_eq14 = [(1, m, p) for m in members if m]
        if shapes != want_eq14:
            fail(f"[4h] {tag}: eq. 14 at {shapes}, expected once per round with a member at "
                 f"{want_eq14}")
    if counts["aes_ctr"] != 2 * sum(members):
        fail(f"[4h] {tag}: {counts['aes_ctr']} AES launches for {sum(members)} member-rounds")
    if cfg.compress == "int8" and not (counts["quantize"] and counts["dequantize"]):
        fail(f"[4h] {tag}: the int8 wire's kernels were not launched: {counts}")
    print(f"  {tag}: wall {wall:.2f} s, rounds {res.rounds}, stop {res.stop_reason}, accuracy "
          f"{res.accuracy:.4f}; {churn_line(res.history_raw['member_mask'])}")
    print(f"    launches: {({k: v for k, v in counts.items() if v})}")
    return res, counts


def churn_fleet(device, world, pretrained, cfg, tag):
    """The 64-requester fleet in the churn world (requester i walks as
    ``requester_id + i``): eq. 14 once a round over (64, 5, .) whatever the
    members; under int8 one quantize and one dequantize of the 320 refresh
    rows a round (and one each at staging and unpack)."""
    from repro_torch.core import run_fleet
    from repro_torch.utils.tree import tree_leaves, tree_size

    task = world[0]
    specs = fleet_specs(device, world, pretrained, FLEET_R)
    with fedavg_shapes() as shapes:
        res, counts, wall = counted(f"[4h] {tag}", lambda: run_fleet(task, specs, cfg,
                                                                     device=device),
                                    ("lstm_cell", "lstm_cell_bwd"))
    if not np.isfinite(res.accuracy).all() or not all(
            bool(torch.isfinite(t).all()) for s in res.sessions for t in tree_leaves(s.params)):
        fail(f"[4h] {tag}: non-finite accuracy or parameters")
    ran = int(res.history["round_executed"].sum())
    p = tree_size(res.sessions[0].params)
    if cfg.robust == "none":
        eq14 = "fedavg_q8" if cfg.compress == "int8" else "fedavg"
        if counts[eq14] != ran or (eq14 == "fedavg" and shapes != [(FLEET_R, 5, p)] * ran):
            fail(f"[4h] {tag}: {counts[eq14]} launches of {eq14} (at {shapes[:1]}) for {ran} "
                 "rounds")
    if cfg.compress == "int8" and (counts["quantize"], counts["dequantize"]) != (ran + 1,
                                                                                 ran + 1):
        fail(f"[4h] {tag}: quantize {counts['quantize']}, dequantize {counts['dequantize']}; "
             f"expected one each a round and at staging and unpack ({ran + 1})")
    member = res.history["member"]
    zero = int((member.sum(axis=2) == 0)[res.history["executed"] > 0].sum())
    lane_rounds = int(res.rounds.sum())
    print(f"  {tag} R={FLEET_R}: wall {wall:.2f} s, {ran} rounds, {lane_rounds / wall:.2f} "
          f"lane-rounds/s, accuracy mean {res.accuracy.mean():.4f} min "
          f"{res.accuracy.min():.4f}; {int(member.sum())} member lane-rounds, {zero} "
          f"member-less; requester 0: {churn_line(member[:, 0])}")
    print(f"    launches: {({k: v for k, v in counts.items() if v})}")
    return res, counts


def churn_engines_agree(loop, fleet, tag, keys=("member_mask",)):
    """The loop session and requester 0 of the fleet walk the same world:
    equal masks, member counts, rounds and stops."""
    s0 = fleet.sessions[0]
    same = (loop.rounds == s0.rounds and loop.stop_reason == s0.stop_reason
            and loop.history_raw["members"] == s0.history_raw["members"]
            and all(np.array_equal(np.stack(loop.history_raw[k]), np.stack(s0.history_raw[k]))
                    for k in keys))
    print(f"  {tag}: loop vs fleet requester 0: {', '.join(keys)}, members, rounds "
          f"({loop.rounds}) and stops {'equal' if same else 'DIFFER'}")
    if not same:
        fail(f"[4h] {tag}: the loop session and the fleet's requester 0 disagree")


def churn_round_check(device, world, pretrained):
    """One churning fleet round of 4 requesters (8 fit epochs, refresh of
    the members) on the card and on the CPU: equal member masks, and the
    params under [4c]'s rule (the CPU's spread under a one-ulp perturbation
    of the contributors below the limit, a 1e-4 fault above it)."""
    from repro_torch.core import SupervisedTask, run_fleet
    from repro_torch.models import LSTMClassifier
    from repro_torch.utils.tree import tree_map, tree_ravel

    task = world[0]
    cpu = torch.device("cpu")
    cpu_task = SupervisedTask(LSTMClassifier(task.model.cfg, device=cpu), lr=task.lr)
    host_pre = [tree_map(lambda t: t.cpu(), p) for p in pretrained]
    cfg = churn_cfg(max_rounds=1)

    def lanes(res):
        return torch.stack([tree_ravel(s.params)[0].cpu() for s in res.sessions])

    def run(d, tk, pre):
        return run_fleet(tk, fleet_specs(d, world, pre, 4), cfg, device=d)

    def perturbed(rel, seed):
        gen = torch.Generator().manual_seed(seed)
        return [tree_map(lambda t: t * (1 + rel * torch.randn(t.shape, generator=gen)), p)
                for p in host_pre]

    card, host = run(device, task, pretrained), run(cpu, cpu_task, host_pre)
    ref = lanes(host)
    diff = float((lanes(card) - ref).abs().max())
    noise = max(float((lanes(run(cpu, cpu_task, perturbed(ULP_REL, sd))) - ref).abs().max())
                for sd in range(3))
    fault = float((lanes(run(cpu, cpu_task, perturbed(FAULT_REL, 0))) - ref).abs().max())
    same = np.array_equal(card.history["member"], host.history["member"])
    print(f"  one churning fleet round R=4 card vs CPU: members "
          f"{card.history['member'][0].sum(axis=1).astype(int).tolist()}, masks "
          f"{'equal' if same else 'DIFFER'}; max abs param diff {diff:.3e} (limit "
          f"{FLEET_ROUND_TOL:.3e}); CPU vs CPU: {ULP_REL:g} perturbation {noise:.3e}, "
          f"{FAULT_REL:g} fault {fault:.3e}")
    if not same:
        fail("[4h] one churning fleet round: member masks differ between the card and the CPU")
    if not noise < FLEET_ROUND_TOL:
        fail(f"[4h] churning fleet round: the CPU's own spread {noise} reaches the limit")
    if not fault > FLEET_ROUND_TOL:
        fail(f"[4h] churning fleet round: a {FAULT_REL:g} fault ({fault}) stays within the limit")
    if not diff <= FLEET_ROUND_TOL:
        fail(f"[4h] one churning fleet round on the card and on the CPU differ by {diff}")


def run_mobility(device, world, pretrained):
    """Phase [4h]: the quickstart world under churn.  The loop session fp32
    (AES) and int8, the 64-requester fleet fp32 and int8, one Byzantine run
    under churn (noise + clip, 3 rounds) on each engine, and one churning
    fleet round on the card and on the CPU.  Returns the loop runs' and the
    fleet runs' launch counts."""
    loop, loop_counts = churn_loop(device, world, pretrained, churn_cfg(), "loop fp32")
    masks = np.stack(loop.history_raw["member_mask"])
    if not (masks != masks[0]).any():
        fail("[4h] the loop session's membership never changed: the world does not churn")
    loop8, loop8_counts = churn_loop(device, world, pretrained, churn_cfg("int8"), "loop int8")
    fleet, fleet_counts = churn_fleet(device, world, pretrained, churn_cfg(), "fleet fp32")
    fleet8, fleet8_counts = churn_fleet(device, world, pretrained, churn_cfg("int8"),
                                        "fleet int8")
    churn_engines_agree(loop, fleet, "fp32")
    churn_engines_agree(loop8, fleet8, "int8")
    from repro_torch.core import AdversaryConfig

    byz = dict(max_rounds=ADV_ROUNDS, adversary=AdversaryConfig(**ADVERSARY), robust="clip")
    adv_loop, adv_loop_counts = churn_loop(device, world, pretrained, churn_cfg(**byz),
                                           "loop fp32 noise + clip")
    adv_fleet, adv_fleet_counts = churn_fleet(device, world, pretrained, churn_cfg(**byz),
                                              "fleet fp32 noise + clip")
    for what, counts in (("loop", adv_loop_counts), ("fleet", adv_fleet_counts)):
        if not (counts["sqnorm"] and counts["fedavg"]):
            fail(f"[4h] {what} noise + clip: the robust path was not launched: {counts}")
    corrupted = np.stack(adv_loop.history_raw["corrupted_mask"])
    clipped = np.stack(adv_loop.history_raw["clipped_mask"])
    fclipped = np.stack(adv_fleet.sessions[0].history_raw["clipped_mask"])
    print(f"  noise + clip under churn: loop {int(corrupted.sum())} corrupted, "
          f"{int(clipped.sum())} clipped member links; fleet {int(adv_fleet.history['corrupted'].sum())} "
          f"corrupted, {int(adv_fleet.history['clipped'].sum())} clipped over {FLEET_R} requesters; "
          f"requester 0's clipped masks {'equal' if np.array_equal(clipped, fclipped) else 'differ'} "
          "(they follow the params, not gated across engines)")
    if corrupted.sum() == 0 or adv_fleet.history["corrupted"].sum() == 0:
        fail("[4h] noise + clip under churn: no member link was corrupted")
    churn_engines_agree(adv_loop, adv_fleet, "noise + clip", keys=("member_mask",
                                                                  "corrupted_mask"))
    churn_round_check(device, world, pretrained)
    return ([loop_counts, loop8_counts, adv_loop_counts],
            [fleet_counts, fleet8_counts, adv_fleet_counts])


# ---------------------------------------------------------------------------
# phase 4i: the unreliable-link world
# ---------------------------------------------------------------------------

# examples/har_federated.py's fault walkthrough world
FAULTS = dict(p_drop=0.4, p_stale=0.3, max_retries=1, release_after=2, seed=7)
FAULT_GAMMA = 0.5            # the decay of [3]'s weights and of one loop session
FAULT_DIR = ROOT / "build" / "4i"


def check_fault_shapes(dev, n_params):
    """The shapes the fault world gives eq. 14 that phase [3] does not
    already hold: dense and int8 at the fleet's (64, 5, P | Lp) with weights
    in {0, gamma, 1} x 0/1 strategy weights (delivered links, a stale one at
    gamma**1) and all-zero rows (which must give zeros), ``fedavg_q8`` on a
    buffer whose rows mix this round's codes and the previous round's (the
    stale substitution), and the loop's (1, n, P) for n = 1 ... 5 with
    fractional weights.  Returns the largest errors by kernel."""
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda, fedavg_batched_q8_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_q8_ref, fedavg_batched_ref
    from repro_torch.kernels.quantize.ref import quantize_batched_ref

    g = torch.Generator().manual_seed(23)
    lp = n_params + (-n_params) % TILE
    shape = (FLEET_R, 5)
    delivered = torch.rand(shape, generator=g) < 0.6
    stale = delivered & (torch.rand(shape, generator=g) < 0.3)
    strategy = (torch.rand(shape, generator=g) < 0.8).to(torch.float32)
    w = strategy * delivered * torch.where(stale, FAULT_GAMMA, 1.0)
    w[[2, 30, 61]] = 0.0                                 # nothing delivered, or all weigh 0
    w_d, stale_d = w.to(dev), stale.to(dev)[..., None]

    def held(name, got, want, zero_rows=(2, 30, 61)):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= 1e-6 * max(float(want.abs().max()), 1.0):
            fail(f"{name}: max abs err {err} against the twin")
        if zero_rows and bool(got[list(zero_rows)].ne(0).any()):
            fail(f"{name}: an all-zero weight row must aggregate to zeros")
        return err

    u, prev = (torch.randn((*shape, n_params), generator=g).to(dev) for _ in range(2))
    src = torch.where(stale_d, prev, u)
    err = held("fedavg at the fault fleet's weights", fedavg_batched_cuda(src, w_d),
               fedavg_batched_ref(src, w_d))
    q, s = (t.to(dev) for t in quantize_batched_ref(u.cpu().reshape(-1, n_params)))
    pq, ps = (t.to(dev) for t in quantize_batched_ref(prev.cpu().reshape(-1, n_params)))
    q, s, pq, ps = (t.reshape(*shape, -1) for t in (q, s, pq, ps))
    src_q, src_s = torch.where(stale_d, pq, q), torch.where(stale_d, ps, s)
    err8 = held("fedavg_q8 on current and previous codes", fedavg_batched_q8_cuda(src_q, src_s, w_d),
                fedavg_batched_q8_ref(src_q, src_s, w_d))
    loop_err = 0.0
    for n in range(1, 6):
        wn = torch.tensor([[1.0, FAULT_GAMMA, 1.0, FAULT_GAMMA, 1.0][:n]], device=dev)
        loop_err = max(loop_err, held(f"fedavg at the loop's (1, {n}, {n_params})",
                                      fedavg_batched_cuda(src[:1, :n].contiguous(), wn),
                                      fedavg_batched_ref(src[:1, :n].contiguous(), wn), ()))
    print(f"  fedavg R,N,L={FLEET_R},5,{n_params} with weights in {{0, {FAULT_GAMMA}, 1}} x "
          f"strategy, stale rows from the previous buffer, 3 all-zero rows: max abs err "
          f"{err:.3e}; fedavg_q8 at Lp={lp}, current and previous codes: {err8:.3e}; zero rows "
          f"give zeros; the loop's (1, n, P), n = 1-5: {loop_err:.3e}")
    return {"fedavg": loop_err, "fedavg_batched": err, "fedavg_q8": err8}


def fault_cfg(compress=None, max_rounds=MAX_ROUNDS, churn=False, **kw):
    """The walkthrough's fault world on the quickstart session, at an
    accuracy no round reaches; ``churn`` adds [4h]'s mobility world."""
    from repro_torch.core import FaultConfig

    base = (churn_cfg(compress, max_rounds) if churn else dataclasses.replace(
        session_cfg(max_rounds), desired_accuracy=1.01, contributor_refresh_epochs=1,
        compress=compress))
    return dataclasses.replace(base, faults=FaultConfig(**FAULTS), **kw)


def world_line(res):
    """A session's world weather: its clock and idle steps (cadence), members
    per round (churn), deliveries per round and the totals (faults)."""
    h = res.history_raw
    parts = []
    if "round_clock" in h:
        parts.append(f"clock {h['round_clock']}, idle steps {h['idle_steps']}")
    if "members" in h:
        parts.append(f"members per round {[int(m) for m in h['members']]}")
    if "deliver_mask" in h:
        per_round = [int(np.asarray(m).sum()) for m in h["deliver_mask"]]
        parts.append(f"delivered per round {per_round}, {int(sum(h['drops']))} drops, "
                     f"{int(sum(h['retries']))} retries, {int(sum(h['stale']))} stale")
    return ", ".join(parts)


def aggregated_per_round(res, n_contrib=5):
    """The updates each executed round collected: the delivered ones under
    faults, the members under churn, else every contract."""
    h = res.history_raw
    for key in ("deliver_mask", "member_mask"):
        if key in h:
            return [int(np.asarray(m).sum()) for m in h[key]]
    return [n_contrib] * res.rounds


def world_loop(device, world, pretrained, cfg, tag, from_round=0, phase="[4i]", battery=None,
               **run_kw):
    """One loop session in a world of [4h]-[4j], its launches counted and held
    to its path: eq. 14 once per round with a collected update, at (1,
    collected, P); AES twice per collected update (encrypted), a straggler's
    included.  A resumed session runs from round ``from_round``."""
    from repro_torch.core import EnFedSession
    from repro_torch.utils.tree import tree_size

    task, shards, own_train, own_test, fleet = world
    session = EnFedSession(task, own_train, own_test, fleet,
                           contributor_states(pretrained, shards, fleet, device), cfg,
                           battery=battery, device=device)
    with fedavg_shapes() as shapes:
        res, counts, wall = counted(f"{phase} {tag}", lambda: session.run(**run_kw),
                                    ("lstm_cell", "lstm_cell_bwd"))
    check_session(res, f"{phase} {tag}")
    collected = aggregated_per_round(res)[from_round:]
    p = tree_size(res.params)
    if cfg.robust == "none" and shapes != [(1, d, p) for d in collected if d]:
        fail(f"{phase} {tag}: eq. 14 at {shapes}, expected once per round with a collected "
             f"update at (1, collected, {p}) for {collected}")
    if cfg.encrypt and counts["aes_ctr"] != 2 * sum(collected):
        fail(f"{phase} {tag}: {counts['aes_ctr']} AES launches for {sum(collected)} updates")
    if cfg.compress == "int8" and not (counts["quantize"] and counts["dequantize"]):
        fail(f"{phase} {tag}: the int8 wire's kernels were not launched: {counts}")
    print(f"  {tag}: wall {wall:.2f} s, rounds {res.rounds}, stop {res.stop_reason}, accuracy "
          f"{res.accuracy:.4f}; {world_line(res)}")
    print(f"    launches: {({k: v for k, v in counts.items() if v})}")
    return res, counts


def world_fleet(device, world, pretrained, cfg, tag, from_round=0, phase="[4i]", specs=None,
                **run_kw):
    """The 64-requester fleet in a world of [4i]-[4j] (requester i rolls its
    dice as ``requester_id + i``): eq. 14 (or ``fedavg_q8``) once a round
    (under cadence, once per event step where a lane ticks) over (64, 5, .).
    A resumed run runs from round (event step) ``from_round``."""
    from repro_torch.core import protocol, run_fleet
    from repro_torch.utils.tree import tree_leaves, tree_size

    task = world[0]
    specs = specs or fleet_specs(device, world, pretrained, FLEET_R)
    with fedavg_shapes() as shapes:
        res, counts, wall = counted(f"{phase} {tag}", lambda: run_fleet(task, specs, cfg,
                                                                        device=device, **run_kw),
                                    ("lstm_cell", "lstm_cell_bwd"))
    if not np.isfinite(res.accuracy).all() or not all(
            bool(torch.isfinite(t).all()) for s in res.sessions for t in tree_leaves(s.params)):
        fail(f"{phase} {tag}: non-finite accuracy or parameters")
    ran = int(res.history["round_executed"][from_round:].sum())
    p = tree_size(res.sessions[0].params)
    if cfg.robust == "none":
        eq14 = "fedavg_q8" if cfg.compress == "int8" else "fedavg"
        if counts[eq14] != ran or (eq14 == "fedavg" and shapes != [(FLEET_R, 5, p)] * ran):
            fail(f"{phase} {tag}: {counts[eq14]} launches of {eq14} (at {shapes[:1]}) for "
                 f"{ran} bodies")
    h = res.history
    lane_rounds = int(h["executed"].sum())
    weather = []
    if "idle_steps" in h:
        short = int(((res.rounds < cfg.max_rounds)
                     & (res.stop_codes == protocol.STOP_MAX_ROUNDS)).sum())
        weather.append(f"{int(h['idle_steps'].sum())} idle steps before rounds, {short} lanes "
                       "stopped short by the event budget")
        if not from_round:
            # every body trains all R lanes whichever tick: the share it keeps
            fits = ran * len(specs)
            weather.append(f"{lane_rounds} of the {fits} lane fits the bodies ran were kept "
                           f"({100 * lane_rounds / max(fits, 1):.1f} %)")
    if "member" in h:
        weather.append(f"{int(h['member'].sum())} member links")
    if "deliver" in h:
        deliver = h["deliver"]
        weather.append(f"{int(deliver.sum())} deliveries, {int(h['drops'].sum())} drops, "
                       f"{int(h['retries'].sum())} retries, {int(h['stale'].sum())} stale, "
                       f"{int((deliver.sum(axis=2) == 0)[h['executed'] > 0].sum())} lane-rounds "
                       "with nothing delivered")
    print(f"  {tag} R={len(specs)}: wall {wall:.2f} s, {ran} bodies, {lane_rounds} lane-rounds, "
          f"{lane_rounds / wall:.2f} lane-rounds/s, accuracy mean {res.accuracy.mean():.4f} "
          f"min {res.accuracy.min():.4f}; {'; '.join(weather)}")
    print(f"    launches: {({k: v for k, v in counts.items() if v})}")
    return res, counts


def faults_engines_agree(loop, fleet, tag, keys=("deliver_mask",)):
    """The loop session and requester 0 of the fleet roll the same dice:
    equal masks, drop, retry and stale counts, rounds and stops."""
    s0 = fleet.sessions[0]
    same = (loop.rounds == s0.rounds and loop.stop_reason == s0.stop_reason
            and all(loop.history_raw[k] == s0.history_raw[k]
                    for k in ("drops", "retries", "stale"))
            and all(np.array_equal(np.stack(loop.history_raw[k]), np.stack(s0.history_raw[k]))
                    for k in keys))
    print(f"  {tag}: loop vs fleet requester 0: {', '.join(keys)}, drops, retries, stale, "
          f"rounds ({loop.rounds}) and stops {'equal' if same else 'DIFFER'}")
    if not same:
        fail(f"[4i] {tag}: the loop session and the fleet's requester 0 disagree")


def kill_after(directory, keep_step):
    """A run killed after ``keep_step``: every checkpoint past it removed."""
    gone = [f for f in directory.glob("step_*.npz") if int(f.name[5:13]) > keep_step]
    for f in gone:
        f.unlink()
    if not gone:
        fail(f"nothing to kill in {directory}: checkpointing did not run")


def fault_resume(device, world, pretrained, straight_loop, straight_fleet):
    """Kill and resume on the card, in the churn + faults world on the int8
    wire (:func:`kill_and_resume`)."""
    kill_and_resume(device, world, pretrained, fault_cfg("int8", churn=True), "int8 churn + faults",
                    straight_loop, straight_fleet, FAULT_DIR, "[4i]")


def kill_and_resume(device, world, pretrained, cfg, what, straight_loop, straight_fleet,
                    directory, phase):
    """Kill and resume on the card: each engine saves every 2 rounds (the
    fleet in chunks of 2 rounds, event steps under cadence), every
    checkpoint past step 4 is deleted, and the resumed run must give the
    straight run's bits (params and every history buffer: battery, masks,
    counts, clocks; rounds, stops), in every lane of the fleet; the
    checkpointing runs themselves must too."""
    import shutil

    shutil.rmtree(directory, ignore_errors=True)
    for engine, straight, run in (
            ("loop", straight_loop, lambda start, **kw: world_loop(
                device, world, pretrained, cfg, f"loop {what}, {list(kw)[0]}",
                start, phase, **kw)[0]),
            ("fleet", straight_fleet, lambda start, **kw: world_fleet(
                device, world, pretrained, cfg, f"fleet {what}, {list(kw)[0]}",
                start, phase, round_chunk=2, **kw)[0])):
        d = directory / engine
        t0 = time.perf_counter()
        saved = run(0, checkpoint_dir=str(d), checkpoint_every=2)
        files = sorted(f.name for f in d.glob("step_*.npz"))
        kill_after(d, 4)
        resumed = run(4, resume_from=str(d))
        equal = fleet_bits_equal if engine == "fleet" else outcome_bits_equal
        verdict = {"checkpointing": equal(straight, saved), "resumed": equal(straight, resumed)}
        print(f"  kill and resume ({engine}): saved {files}, killed past step 4; the "
              f"checkpointing run {'=' if verdict['checkpointing'] else '!='} the straight run, "
              f"the resumed run {'=' if verdict['resumed'] else '!='} it, bit for bit "
              f"({time.perf_counter() - t0:.2f} s)")
        if not all(verdict.values()):
            fail(f"{phase} kill and resume ({engine}) differs from the straight run: {verdict}")
    shutil.rmtree(directory, ignore_errors=True)


def fault_round_check(device, world, pretrained, limits):
    """One faulty round of 4 requesters on the card and on the CPU: equal
    deliver masks and counts, the params within [4c]'s limit."""
    from repro_torch.core import SupervisedTask, run_fleet
    from repro_torch.models import LSTMClassifier
    from repro_torch.utils.tree import tree_map, tree_ravel

    task = world[0]
    cpu = torch.device("cpu")
    cpu_task = SupervisedTask(LSTMClassifier(task.model.cfg, device=cpu), lr=task.lr)
    host_pre = [tree_map(lambda t: t.cpu(), p) for p in pretrained]
    cfg = fault_cfg(max_rounds=1)
    card = run_fleet(task, fleet_specs(device, world, pretrained, 4), cfg, device=device)
    host = run_fleet(cpu_task, fleet_specs(cpu, world, host_pre, 4), cfg, device=cpu)
    diff = max(float((tree_ravel(a.params)[0].cpu() - tree_ravel(b.params)[0]).abs().max())
               for a, b in zip(card.sessions, host.sessions))
    same = all(np.array_equal(card.history[k], host.history[k])
               for k in ("deliver", "drops", "retries", "stale"))
    print(f"  one faulty fleet round R=4 card vs CPU: deliveries "
          f"{card.history['deliver'][0].sum(axis=1).astype(int).tolist()}, masks and counts "
          f"{'equal' if same else 'DIFFER'}; max abs param diff {diff:.3e} (limit "
          f"{limits['fp32']:.3e})")
    if not same:
        fail("[4i] one faulty fleet round: deliver masks differ between the card and the CPU")
    if not diff <= limits["fp32"]:
        fail(f"[4i] one faulty fleet round on the card and on the CPU differ by {diff}")


def run_faults(device, world, pretrained, limits):
    """Phase [4i]: the quickstart world with unreliable links.  The loop
    session fp32 (AES), int8 and fp32 with staleness decay, the 64-requester
    fleet fp32 and int8, faults with [4h]'s churn on both engines (int8),
    [4d]'s noise + clip under faults for 3 rounds on both, kill and resume
    of both engines, and one faulty fleet round on the card and on the CPU.
    Returns the loop runs' and the fleet runs' launch counts."""
    from repro_torch.core import AdversaryConfig

    loop, loop_counts = world_loop(device, world, pretrained, fault_cfg(), "loop fp32")
    if not (sum(loop.history_raw["drops"]) and sum(loop.history_raw["retries"])
            and sum(loop.history_raw["stale"])):
        fail("[4i] the loop session saw no drop, retry or stale delivery")
    loop8, loop8_counts = world_loop(device, world, pretrained, fault_cfg("int8"), "loop int8")
    decay, decay_counts = world_loop(device, world, pretrained,
                                     fault_cfg(staleness_gamma=FAULT_GAMMA),
                                     f"loop fp32 staleness_gamma={FAULT_GAMMA}")
    fleet, fleet_counts = world_fleet(device, world, pretrained, fault_cfg(), "fleet fp32")
    fleet8, fleet8_counts = world_fleet(device, world, pretrained, fault_cfg("int8"),
                                        "fleet int8")
    faults_engines_agree(loop, fleet, "fp32")
    faults_engines_agree(loop8, fleet8, "int8")
    churn_loop8, churn_loop_counts = world_loop(device, world, pretrained,
                                                fault_cfg("int8", churn=True),
                                                "loop int8 churn + faults")
    churn_fleet8, churn_fleet_counts = world_fleet(device, world, pretrained,
                                                   fault_cfg("int8", churn=True),
                                                   "fleet int8 churn + faults")
    faults_engines_agree(churn_loop8, churn_fleet8, "churn + faults",
                         keys=("deliver_mask", "member_mask"))
    byz = dict(max_rounds=ADV_ROUNDS, adversary=AdversaryConfig(**ADVERSARY), robust="clip")
    adv_loop, adv_loop_counts = world_loop(device, world, pretrained, fault_cfg(**byz),
                                           "loop fp32 noise + clip")
    adv_fleet, adv_fleet_counts = world_fleet(device, world, pretrained, fault_cfg(**byz),
                                              "fleet fp32 noise + clip")
    for what, counts in (("loop", adv_loop_counts), ("fleet", adv_fleet_counts)):
        if not (counts["sqnorm"] and counts["fedavg"]):
            fail(f"[4i] {what} noise + clip: the robust path was not launched: {counts}")
    faults_engines_agree(adv_loop, adv_fleet, "noise + clip",
                         keys=("deliver_mask", "corrupted_mask"))
    corrupted = np.stack(adv_loop.history_raw["corrupted_mask"])
    if corrupted.sum() == 0 or (corrupted > np.stack(adv_loop.history_raw["deliver_mask"])).any():
        fail("[4i] noise + clip under faults: no delivered link was corrupted, or an "
             "undelivered one was")
    fault_resume(device, world, pretrained, churn_loop8, churn_fleet8)
    fault_round_check(device, world, pretrained, limits)
    return ([loop_counts, loop8_counts, decay_counts, churn_loop_counts, adv_loop_counts],
            [fleet_counts, fleet8_counts, churn_fleet_counts, adv_fleet_counts])


# ---------------------------------------------------------------------------
# phase 4j: the asynchronous-cadence world
# ---------------------------------------------------------------------------

# two speed classes, a radio awake 2 steps of every 3, offline on 15 % of
# the steps; the seed is chosen on the host (cadence_world)
CADENCE = dict(n_speed_classes=2, duty_cycle=3, duty_on=2, p_offline=0.15)
CADENCE_GAMMA = 0.5          # the decay of [3]'s weights and of one loop session
CADENCE_DIR = ROOT / "build" / "4j"
# the depth of [4j]'s composed runs (churn + faults, pacing) and of their
# kill and resume, cut from the main runs' 10 rounds of 8 epochs (6 rounds:
# the loop's checkpoints every 2 rounds must reach past round 4; 2 epochs
# cost what 1 does, a body being refresh-bound)
CADENCE_CUT = dict(max_rounds=6, epochs=2)
PACE_FACTOR = 2
PACE_DRAIN = 0.04            # the battery fraction one round of the pacing run drains
PACE_CROSS = 3               # its requester crosses the threshold in this round

def check_cadence_shapes(dev, n_params):
    """The weights the cadence world gives eq. 14 that phase [3] does not
    already hold: dense and int8 at the fleet's (64, 5, P | Lp) and the
    loop's (1, n, P) for n = 1 ... 5, each weight a 0/1 strategy weight
    times ``gamma**lag`` for image lags in {0, 1, 2} (a straggler's
    resident image, one step more for a stale delivery), with a few rows of
    lanes that do not execute (zeros).  Returns the largest errors by
    kernel."""
    from repro_torch.core.protocol import decayed_round_weights
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda, fedavg_batched_q8_cuda
    from repro_torch.kernels.fedavg.ref import fedavg_batched_q8_ref, fedavg_batched_ref
    from repro_torch.kernels.quantize.ref import quantize_batched_ref

    g = torch.Generator().manual_seed(29)
    lp = n_params + (-n_params) % TILE
    shape = (FLEET_R, 5)
    strategy = (torch.rand(shape, generator=g) < 0.8).to(torch.float32)
    lag = torch.randint(0, 3, shape, generator=g)
    w = decayed_round_weights(strategy, lag, CADENCE_GAMMA)
    w[[5, 40]] = 0.0                                    # lanes that did not tick
    w_d = w.to(dev)

    def held(name, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= 1e-6 * max(float(want.abs().max()), 1.0):
            fail(f"{name}: max abs err {err} against the twin")
        return err

    u = torch.randn((*shape, n_params), generator=g).to(dev)
    err = held("fedavg at the cadence fleet's decayed weights", fedavg_batched_cuda(u, w_d),
               fedavg_batched_ref(u, w_d))
    q, s = (t.to(dev).reshape(*shape, -1)
            for t in quantize_batched_ref(u.cpu().reshape(-1, n_params)))
    err8 = held("fedavg_q8 at the cadence fleet's decayed weights",
                fedavg_batched_q8_cuda(q, s, w_d), fedavg_batched_q8_ref(q, s, w_d))
    loop_err = 0.0
    for n in range(1, 6):
        wn = decayed_round_weights(torch.ones(1, n), torch.arange(n)[None] % 3,
                                   CADENCE_GAMMA).to(dev)
        un = u[:1, :n].contiguous()
        loop_err = max(loop_err, held(f"fedavg at the loop's (1, {n}, {n_params})",
                                      fedavg_batched_cuda(un, wn), fedavg_batched_ref(un, wn)))
    print(f"  fedavg R,N,L={FLEET_R},5,{n_params} with weights strategy x gamma**lag, lag in "
          f"0-2, gamma {CADENCE_GAMMA}, 2 silent rows: max abs err {err:.3e}; fedavg_q8 at "
          f"Lp={lp}: {err8:.3e}; the loop's (1, n, P), n = 1-5: {loop_err:.3e}")
    return {"fedavg": loop_err, "fedavg_batched": err, "fedavg_q8": err8}


def cadence_world(task, fleet):
    """[4j]'s cadence: the first seed under the task's threefry mode that
    puts requester 0 on stride 2 (it idles between its rounds) and a
    contract on stride 2 (it can straggle).  The runs check both again."""
    from repro_torch.core import CadenceConfig
    from repro_torch.core.cadence import speed_stride

    part = task.threefry_partitionable
    ids = [d.device_id for d in fleet]
    for seed in range(256):
        cc = CadenceConfig(**CADENCE, seed=seed)
        if (int(speed_stride(cc, cc.requester_id, partitionable=part)) == 2
                and bool((speed_stride(cc, ids, partitionable=part) == 2).any())):
            strides = speed_stride(cc, ids, partitionable=part).tolist()
            print(f"  seed {seed} (threefry partitionable={part}): requester 0 on stride 2, "
                  f"the contracts on strides {strides}")
            return cc
    fail("[4j] no seed below 256 puts requester 0 and a contract on stride 2")


def requester_ticks(cc, part, rounds):
    """The steps requester 0 ticks on (unpaced) until its ``rounds``-th,
    on the host: [4j]'s event budgets end at these steps."""
    from repro_torch.core.cadence import events_budget, tick_mask

    steps = [t for t in range(events_budget(cc, rounds))
             if bool(tick_mask(cc, t, [cc.requester_id], partitionable=part)[0])][:rounds]
    if len(steps) < rounds:
        fail(f"[4j] requester 0 ticks {len(steps)} times in its budget, not {rounds}")
    return steps


def cadence_cfg(cc, compress=None, max_rounds=MAX_ROUNDS, churn=False, faults=False, **kw):
    """The quickstart session in [4j]'s cadence at an accuracy no round
    reaches; ``churn`` adds [4h]'s mobility world, ``faults`` [4i]'s links."""
    base = (fault_cfg(compress, max_rounds, churn=churn) if faults
            else churn_cfg(compress, max_rounds) if churn
            else dataclasses.replace(session_cfg(max_rounds), desired_accuracy=1.01,
                                     contributor_refresh_epochs=1, compress=compress))
    return dataclasses.replace(base, cadence=cc, **kw)


def stragglers(res, cc, fleet, part):
    """(executed round, contract) pairs whose contract did not tick on the
    round's step: its resident image was aggregated as it was."""
    from repro_torch.core.cadence import tick_mask

    ids = [d.device_id for d in fleet]
    return sum(int((~tick_mask(cc, t, ids, partitionable=part)).sum())
               for t in res.history_raw["round_clock"])


def cadence_engines_agree(loop, fleet, tag):
    """The loop session and requester 0 of the fleet keep one clock: equal
    round clocks, idle steps, rounds and stops, masks and fault counts
    where they exist, and the idle-priced ``t_com`` within 1e-9."""
    s0 = fleet.sessions[0]
    hl, hf = loop.history_raw, s0.history_raw
    keys = [k for k in ("member_mask", "deliver_mask", "corrupted_mask") if k in hl]
    same = (loop.rounds == s0.rounds and loop.stop_reason == s0.stop_reason
            and hl["round_clock"] == hf["round_clock"] and hl["idle_steps"] == hf["idle_steps"]
            and all(hl[k] == hf[k] for k in ("drops", "retries", "stale") if k in hl)
            and all(np.array_equal(np.stack(hl[k]), np.stack(hf[k])) for k in keys))
    dt = abs(loop.report.times.t_com - s0.report.times.t_com)
    print(f"  {tag}: loop vs fleet requester 0: round clocks {hl['round_clock']}, idle steps, "
          f"{', '.join(keys + ['rounds'])} ({loop.rounds}) and stops "
          f"{'equal' if same else 'DIFFER'}; t_com {loop.report.times.t_com:.6f} s, "
          f"difference {dt:.3e}")
    if not same or not dt <= 1e-9:
        fail(f"[4j] {tag}: the loop session and the fleet's requester 0 disagree")


def paced_skips(res, cc_paced, part):
    """Steps between two executed rounds where the unpaced clock would have
    ticked and the battery-paced one did not (the level after the round
    before, in fp32, as both engines compare it)."""
    from repro_torch.core.cadence import tick_mask

    base = dataclasses.replace(cc_paced, pace_factor=1)
    h = res.history_raw
    skips = 0
    for k in range(1, res.rounds):
        level = torch.tensor([h["battery"][k - 1]], dtype=torch.float32)
        for t in range(h["round_clock"][k - 1] + 1, h["round_clock"][k]):
            free = bool(tick_mask(base, t, [cc_paced.requester_id], partitionable=part)[0])
            paced = bool(tick_mask(cc_paced, t, [cc_paced.requester_id], level,
                                   partitionable=part)[0])
            skips += free and not paced
    return skips



def cadence_pacing(device, world, pretrained, cc):
    """Battery-aware pacing on both engines at [4j]'s cut depth: a battery
    of the capacity that drains PACE_DRAIN a round, and a threshold midway
    between the levels after rounds PACE_CROSS - 1 and PACE_CROSS (far from
    any level a round lands on, in fp32 or in float64), so requester 0's
    stride doubles mid-run.  The fleet's lane 0 is the loop's requester;
    its other lanes are [4c]'s, on batteries of that capacity."""
    from repro_torch.core import BatteryState, CostModel, RequesterSpec
    from repro_torch.utils.tree import tree_size

    task, shards, own_train, own_test, fleet = world
    cost = CostModel()
    p = tree_size(pretrained[0])
    e = cost.round_energy(n_contrib=len(fleet), num_params=p, model_bytes=4 * p,
                          num_samples=len(own_train[0]), epochs=CADENCE_CUT["epochs"],
                          n_devices=len(fleet), encrypt=True)
    probe = 1e6
    drop = 0.9 - BatteryState(capacity_j=probe, level=0.9).discharge(
        e, avg_power_w=cost.device.p_train).level
    cap = probe * drop / PACE_DRAIN
    levels = [0.9]
    b = BatteryState(capacity_j=cap, level=0.9)
    for _ in range(PACE_CROSS):
        b = b.discharge(e, avg_power_w=cost.device.p_train)
        levels.append(b.level)
    thr = (levels[-2] + levels[-1]) / 2
    pcc = dataclasses.replace(cc, pace_battery_threshold=thr, pace_factor=PACE_FACTOR)
    cfg = cadence_cfg(pcc, **CADENCE_CUT)
    print(f"  pacing: capacity {cap:.4f} J, {PACE_DRAIN} of it a round, threshold {thr:.6f} "
          f"(levels {[round(v, 6) for v in levels]}), factor {PACE_FACTOR}")
    loop, loop_counts = world_loop(device, world, pretrained, cfg, "loop fp32 pacing",
                                   phase="[4j]", battery=BatteryState(capacity_j=cap, level=0.9))
    states = contributor_states(pretrained, shards, fleet, device)
    specs = [RequesterSpec(own_train, own_test, fleet, states, BatteryState(capacity_j=cap,
                                                                            level=0.9))]
    specs += [RequesterSpec(train, test, fleet, states, BatteryState(capacity_j=cap, level=0.9))
              for train, test in fleet_split()[1:FLEET_R]]
    fl, fleet_counts = world_fleet(device, world, pretrained, cfg, "fleet fp32 pacing",
                                   phase="[4j]", specs=specs)
    cadence_engines_agree(loop, fl, "pacing")
    skips = paced_skips(loop, pcc, task.threefry_partitionable)
    crossed = sum(v < np.float32(thr) for v in loop.history_raw["battery"])
    print(f"  pacing: the battery under the threshold after {crossed} of {loop.rounds} rounds; "
          f"{skips} steps the unpaced clock would have ticked on were skipped")
    if not (crossed and skips):
        fail("[4j] pacing: the battery never crossed the threshold, or the paced clock "
             "skipped no tick")
    return loop_counts, fleet_counts


def cadence_step_check(device, world, pretrained, limits, cc):
    """One cadence fleet step of 4 requesters on the card and on the CPU:
    the first event step where a lane ticks (the budget ends there, so one
    round body runs), equal tick, clock and idle traces, the params within
    [4c]'s limit.  Each executing lane's params are, on each device, the
    bits of [4c]'s lockstep fp32 round (the same glob, plan and fit; a
    body trains every lane), so its card-vs-CPU difference is that
    round's, lane for lane: what the cadence machinery adds is held
    exactly, not within the limit."""
    from repro_torch.core import SupervisedTask, run_fleet
    from repro_torch.core.cadence import tick_mask
    from repro_torch.models import LSTMClassifier
    from repro_torch.utils.tree import tree_map, tree_ravel

    task = world[0]
    part = task.threefry_partitionable
    ids = [cc.requester_id + i for i in range(4)]
    t0 = next(t for t in range(64) if bool(tick_mask(cc, t, ids, partitionable=part).any()))
    cfg = cadence_cfg(dataclasses.replace(cc, max_events=t0 + 1), max_rounds=1)
    cpu = torch.device("cpu")
    cpu_task = SupervisedTask(LSTMClassifier(task.model.cfg, device=cpu), lr=task.lr)
    host_pre = [tree_map(lambda t: t.cpu(), p) for p in pretrained]
    card = run_fleet(task, fleet_specs(device, world, pretrained, 4), cfg, device=device)
    host = run_fleet(cpu_task, fleet_specs(cpu, world, host_pre, 4), cfg, device=cpu)
    card_l, host_l = (torch.stack([tree_ravel(s.params)[0].cpu() for s in res.sessions])
                      for res in (card, host))
    per_lane = (card_l - host_l).abs().max(dim=1).values
    diff = float(per_lane.max())
    same = (np.array_equal(card.rounds, host.rounds) and all(
        np.array_equal(card.history[k], host.history[k])
        for k in ("round_executed", "executed", "round_clock", "idle_steps")))
    lock = limits["fp32 lanes"]
    ran = np.flatnonzero(card.rounds).tolist()
    lockstep = all(torch.equal(card_l[i], lock["card"][i]) and torch.equal(host_l[i], lock["cpu"][i])
                   for i in ran)
    print(f"  one cadence fleet step R=4 card vs CPU: step {t0}, lanes executing "
          f"{card.rounds.tolist()}, tick, clock and idle traces {'equal' if same else 'DIFFER'}; "
          f"max abs param diff {diff:.3e} (per lane "
          f"{', '.join(f'{v:.3e}' for v in per_lane.tolist())}; limit {limits['fp32']:.3e}); "
          f"lanes {ran} {'are' if lockstep else 'are NOT'} [4c]'s lockstep round bit for bit on "
          f"each device (its per-lane diffs {', '.join(f'{v:.3e}' for v in lock['diff'].tolist())})")
    if not same or not ran:
        fail("[4j] one cadence fleet step: no lane ticked, or the traces differ between the "
             "card and the CPU")
    if not lockstep:
        fail("[4j] one cadence fleet step: an executing lane's params are not the bits of "
             "[4c]'s lockstep round on the same device")
    if not diff <= limits["fp32"]:
        fail(f"[4j] one cadence fleet step on the card and on the CPU differ by {diff}")


def run_cadence(device, world, pretrained, limits):
    """Phase [4j]: the quickstart world on [4j]'s cadence.  The loop session
    fp32 (AES), int8 and fp32 with image-lag decay, the 64-requester fleet
    fp32 and int8, the loop and the fleet's requester 0 on one clock; at
    the cut depth cadence + churn + faults on the int8 wire and battery
    pacing on both engines, and kill and resume of both; one step of 4
    requesters on the card and on the CPU.  Returns the loop runs' and the
    fleet runs' launch counts."""
    from repro_torch.core.cadence import events_budget

    task, _, _, _, fleet = world
    part = task.threefry_partitionable
    cc = cadence_world(task, fleet)
    # the main runs' budget ends on requester 0's last round (a fleet lane
    # on a slower clock stops short of it); the composed runs' (a budget of
    # one round more) one step past requester 0's CADENCE_CUT-th round, so
    # the budget ends the session on one trailing idle step to price
    cut = CADENCE_CUT["max_rounds"]
    ticks = requester_ticks(cc, part, max(MAX_ROUNDS, cut))
    full = dataclasses.replace(cc, max_events=ticks[MAX_ROUNDS - 1] + 1)
    short = dataclasses.replace(cc, max_events=ticks[cut - 1] + 2)
    print(f"  requester 0 ticks at steps {ticks}: event budget {full.max_events} (default "
          f"{events_budget(cc, MAX_ROUNDS)}), the composed runs' {short.max_events}")
    loop, loop_counts = world_loop(device, world, pretrained, cadence_cfg(full), "loop fp32",
                                   phase="[4j]")
    idle, straggled = sum(loop.history_raw["idle_steps"]), stragglers(loop, cc, fleet, part)
    print(f"  requester 0 idled {idle} steps before its rounds; {straggled} straggling "
          "(round, contract) pairs")
    if not (idle and straggled):
        fail("[4j] requester 0 never idled, or no contract straggled on an executed step")
    loop8, loop8_counts = world_loop(device, world, pretrained, cadence_cfg(full, "int8"),
                                     "loop int8", phase="[4j]")
    decay, decay_counts = world_loop(device, world, pretrained,
                                     cadence_cfg(full, staleness_gamma=CADENCE_GAMMA),
                                     f"loop fp32 staleness_gamma={CADENCE_GAMMA}", phase="[4j]")
    fleet_r, fleet_counts = world_fleet(device, world, pretrained, cadence_cfg(full),
                                        "fleet fp32", phase="[4j]")
    fleet8, fleet8_counts = world_fleet(device, world, pretrained, cadence_cfg(full, "int8"),
                                        "fleet int8", phase="[4j]")
    cadence_engines_agree(loop, fleet_r, "fp32")
    cadence_engines_agree(loop8, fleet8, "int8")
    composed = cadence_cfg(short, "int8", churn=True, faults=True,
                           **dict(CADENCE_CUT, max_rounds=cut + 1))
    what = "int8 churn + faults"
    c_loop, c_loop_counts = world_loop(device, world, pretrained, composed, f"loop {what}",
                                       phase="[4j]")
    c_fleet, c_fleet_counts = world_fleet(device, world, pretrained, composed, f"fleet {what}",
                                          phase="[4j]")
    cadence_engines_agree(c_loop, c_fleet, what)
    if c_loop.rounds != cut:
        fail(f"[4j] {what}: the event budget left requester 0 {c_loop.rounds} rounds, not "
             f"{cut} and a trailing idle step")
    pace_loop_counts, pace_fleet_counts = cadence_pacing(device, world, pretrained, cc)
    kill_and_resume(device, world, pretrained, composed, what, c_loop, c_fleet, CADENCE_DIR,
                    "[4j]")
    cadence_step_check(device, world, pretrained, limits, cc)
    return ([loop_counts, loop8_counts, decay_counts, c_loop_counts, pace_loop_counts],
            [fleet_counts, fleet8_counts, c_fleet_counts, pace_fleet_counts])


# ---------------------------------------------------------------------------
# phase 4k: the profiler hooks
# ---------------------------------------------------------------------------

PROFILE_DIR = ROOT / "build" / "4k"
# each launch counter's CUDA kernel, as the profiler names it
KERNEL_OF = {"fedavg": "fedavg_kernel", "fedavg_q8": "fedavg_kernel",
             "lstm_cell": "lstm_seq_fwd_kernel", "lstm_cell_bwd": "lstm_seq_bwd_kernel",
             "aes_ctr": "aes_ctr_kernel", "quantize": "quantize_kernel",
             "dequantize": "dequantize_kernel", "trimmed_mean": "trimmed_mean_kernel",
             "trimmed_mean_q8": "trimmed_mean_kernel", "median": "median_kernel",
             "median_q8": "median_kernel", "sqnorm": "sqnorm_kernel",
             "sqnorm_q8": "sqnorm_kernel"}
ALLOC_OPS = {"aten::empty", "aten::empty_strided", "aten::empty_like", "aten::new_empty",
             "aten::new_empty_strided", "aten::resize_"}
COPY_OPS = {"aten::copy_", "aten::_to_copy", "aten::to"}
SYNC_CALLS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"}
SYNC_OPS = {"aten::item", "aten::_local_scalar_dense"}
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"}


def self_times(events):
    """Each host event of the trace with its self time (its duration less
    its children's, on its thread) and whether it runs inside a
    ``repro_torch::`` range; each thread's covered time (the union of its
    top-level events); and the span from the first host event to the end of
    the last, in µs."""
    by_tid = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                                                   "cuda_driver"):
            by_tid.setdefault(e["tid"], []).append(e)
    rows, covered = [], {}
    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack, cover = [], 0.0
        for e in evs:
            end = e["ts"] + e["dur"]
            while stack and stack[-1][1] <= e["ts"]:
                stack.pop()
            if stack:
                stack[-1][2]["self"] -= e["dur"]
            else:
                cover += e["dur"]
            inside = any(s[2]["name"].startswith("repro_torch::") for s in stack)
            row = {"name": e["name"], "cat": e["cat"], "self": float(e["dur"]),
                   "inside": inside, "tid": tid}
            rows.append(row)
            stack.append((e["ts"], end, row))
        covered[tid] = cover
    host = [e for evs in by_tid.values() for e in evs]
    span = max(e["ts"] + e["dur"] for e in host) - min(e["ts"] for e in host)
    return rows, covered, span


def host_breakdown(events, steps):
    """Host µs per Adam step of the traced program, by what the host was
    doing (self times, every host thread; the autograd engine runs the
    card's backward on a thread of its own while the main thread waits),
    over the span of the trace's host events (the profiler's own start and
    stop outside it)."""
    rows, covered, wall_us = self_times(events)
    cats = dict.fromkeys(("hand-written kernel wrappers (checks, outputs, ctypes)",
                          "kernel launches, hand-written (runtime)",
                          "kernel launches, torch (runtime)", "allocation",
                          "host-device copies", "syncs", "other aten ops (dispatch)",
                          "autograd engine and other ranges"), 0.0)
    top = {}
    for r in rows:
        name, cat = r["name"], r["cat"]
        if cat == "user_annotation" and name.startswith("repro_torch::"):
            k = "hand-written kernel wrappers (checks, outputs, ctypes)"
        elif name in LAUNCH_CALLS:
            k = ("kernel launches, hand-written (runtime)" if r["inside"]
                 else "kernel launches, torch (runtime)")
        elif name in SYNC_CALLS or name in SYNC_OPS:
            k = "syncs"
        elif name.startswith("cudaMemcpy") or name in COPY_OPS:
            k = "host-device copies"
        elif name in ALLOC_OPS or name.startswith("cudaMalloc") or name.startswith("cudaFree"):
            k = "allocation"
        elif cat == "cpu_op" and name.startswith("aten::"):
            k = "other aten ops (dispatch)"
        else:
            k = "autograd engine and other ranges"
        cats[k] += max(r["self"], 0.0)
        if k in ("other aten ops (dispatch)", "autograd engine and other ranges"):
            top[name] = top.get(name, 0.0) + max(r["self"], 0.0)
    main_tid = max(covered, key=covered.get)
    others = sum(v for t, v in covered.items() if t != main_tid)
    cats["Python and waits (main thread in no recorded op, less the other threads')"] = max(
        wall_us - covered[main_tid] - others, 0.0)
    print(f"  host time per Adam step of the traced program ({steps} steps, traced wall "
          f"{wall_us / steps / 1e3:.3f} ms a step; self times, all host threads):")
    for k, v in cats.items():
        print(f"    {v / steps / 1e3:8.3f} ms  {k}")
    print("    the largest of the last two, by name: " + ", ".join(
        f"{n} {v / steps / 1e3:.3f}" for n, v in sorted(top.items(), key=lambda kv: -kv[1])[:12]))
    return cats


def trace_kernels(events):
    """Launches of each CUDA kernel in the trace, by its own name."""
    seen = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            name = kernel_name_of(e["name"])
            seen[name] = seen.get(name, 0) + 1
    return seen


def hlo_round_check(device, world, pretrained):
    """``hlo_stats`` of one fp32 round of 4 requesters on the card and on
    the CPU: the work counts must be the same integers (the cost is charged
    at each op's dispatch, from shapes); ``memory`` differs by device."""
    from repro_torch.core import SupervisedTask, run_fleet
    from repro_torch.models import LSTMClassifier
    from repro_torch.telemetry import TraceConfig
    from repro_torch.utils.tree import tree_map

    task, cpu = world[0], torch.device("cpu")
    cpu_task = SupervisedTask(LSTMClassifier(task.model.cfg, device=cpu), lr=task.lr)
    host_pre = [tree_map(lambda t: t.cpu(), p) for p in pretrained]
    cfg, trace = session_cfg(1), TraceConfig(hlo_stats=True)
    card = run_fleet(task, fleet_specs(device, world, pretrained, 4), cfg, device=device,
                     trace=trace).hlo_stats
    host = run_fleet(cpu_task, fleet_specs(cpu, world, host_pre, 4), cfg, device=cpu,
                     trace=trace).hlo_stats
    keys = ("flops", "bytes_accessed", "transcendentals", "torch_matmul_flops", "per_kernel")
    print(f"  one fp32 round R=4, hlo_stats on the card: "
          f"{json.dumps({k: card[k] for k in keys})}; memory {card['memory']}")
    for k in keys:
        if card[k] != host[k]:
            fail(f"[4k] hlo_stats[{k!r}] of one R = 4 round: card {card[k]} != CPU {host[k]}")
    print("  the same integers on the CPU (memory left out: "
          f"{host['memory']} there)")


def run_profiler_hooks(device, world, pretrained, untraced):
    """[4c]'s R = 64 fp32 fleet again under ``TraceConfig(jax_profiler_dir=
    "build/4k", hlo_stats=True)``: bit-equal to [4c]'s untraced run, its
    per-kernel launches equal to the launch counters, the trace naming
    every kernel launched; then the host time per Adam step of one round
    under the profiler alone, split by what the host did
    (:func:`host_breakdown`), and :func:`hlo_round_check`.  The traces are
    removed after they are read."""
    import shutil

    from repro_torch import kernels
    from repro_torch.core import run_fleet
    from repro_torch.telemetry import TraceConfig

    task = world[0]
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    trace = TraceConfig(jax_profiler_dir=str(PROFILE_DIR), hlo_stats=True)
    specs = fleet_specs(device, world, pretrained, FLEET_R)
    cfg = session_cfg(MAX_ROUNDS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = run_fleet(task, specs, cfg, device=device, trace=trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if not fleet_bits_equal(res, untraced["result"]):
        fail("[4k] the traced fleet run differs from [4c]'s untraced run")
    stats = res.hlo_stats
    launched = {k: v for k, v in counts.items() if v}
    per = {k: v["launches"] for k, v in stats["per_kernel"].items()}
    if per != launched:
        fail(f"[4k] hlo_stats launches {per} != the launch counters {launched}")
    program = res.timeline.totals()["program"]
    print(f"  traced fleet fp32 R={FLEET_R}: wall {wall:.2f} s (program {program:.2f} s; "
          f"[4c] untraced {untraced['wall']:.2f} s), bit-equal to [4c]'s run; launches "
          f"{launched} equal hlo_stats'")
    print(f"  hlo_stats: flops {stats['flops']}, bytes_accessed {stats['bytes_accessed']}, "
          f"transcendentals {stats['transcendentals']}, torch_matmul_flops "
          f"{stats['torch_matmul_flops']}, memory {stats['memory']}")
    for name, c in stats["per_kernel"].items():
        print(f"    {name:14s} {c}")
    files = list(PROFILE_DIR.glob("*.pt.trace.json"))
    if len(files) != 1:
        fail(f"[4k] expected one profiler trace under {PROFILE_DIR}, found {files}")
    size = files[0].stat().st_size
    t0 = time.perf_counter()
    events = json.loads(files[0].read_text())["traceEvents"]
    seen = trace_kernels(events)
    need = {}
    for k, v in launched.items():
        need[KERNEL_OF[k]] = need.get(KERNEL_OF[k], 0) + v
    print(f"  trace {files[0].name}: {size / 2 ** 20:.1f} MiB, {len(events)} events, read in "
          f"{time.perf_counter() - t0:.1f} s; hand-written kernels in it (trace / launches): "
          + ", ".join(f"{k} {seen.get(k, 0)} / {v}" for k, v in sorted(need.items())))
    missing = sorted(k for k in {"fedavg_kernel", "lstm_seq_fwd_kernel",
                                 "lstm_seq_bwd_kernel", *need} if not seen.get(k))
    if missing:
        fail(f"[4k] the profiler trace names no launch of {missing}")
    del events
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    # the host's time per Adam step, from one round of the same fleet under
    # the profiler alone (the cost recorder's flop counter would add its own
    # Python to every op)
    one = session_cfg(1)
    run_fleet(task, fleet_specs(device, world, pretrained, FLEET_R), one, device=device)
    torch.cuda.synchronize()
    before = kernels.launch_counts()["lstm_cell_bwd"]
    run_fleet(task, fleet_specs(device, world, pretrained, FLEET_R), one, device=device,
              trace=TraceConfig(jax_profiler_dir=str(PROFILE_DIR)))
    kernels_bwd = kernels.launch_counts()["lstm_cell_bwd"] - before
    events = json.loads(next(PROFILE_DIR.glob("*.pt.trace.json")).read_text())["traceEvents"]
    print(f"  one fp32 round R={FLEET_R} under the profiler alone:")
    host_breakdown(events, kernels_bwd)
    del events
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    hlo_round_check(device, world, pretrained)
    return counts


# ---------------------------------------------------------------------------
# phase 4l: the LM zoo's serving path on the card
# ---------------------------------------------------------------------------

# card vs CPU, the same forward on the same weights in fp32 with TF32 off:
# products summed in another order (the CPU parity tests hold the port to
# the reference at 2e-5)
LM_CARD_TOL = 1e-4
LM_DECODE_TOL = 2e-3          # decode against forward, the reference's own rule
LM_B, LM_S = 2, 12


def lm_variants():
    """The configurations of the CPU parity tests (``tests/test_models.py``'s
    variants, the special heads, the registered presets)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import MLAConfig, ModelConfig

    base = ModelConfig(name="t", family="dense", num_layers=3, d_model=64, num_heads=4,
                       num_kv_heads=2, d_ff=128, vocab_size=128)
    out = {
        "dense": base,
        "swa": base.replace(block_pattern=("swa",), sliding_window=8),
        "local": base.replace(block_pattern=("local",), local_window=4),
        "mla": base.replace(block_pattern=("mla",), mla=MLAConfig(64, 32, 16, 8, 16)),
        "rg_hybrid": base.replace(num_layers=5, block_pattern=("rglru", "rglru", "local"),
                                  local_window=8, rnn_width=64),
        "xlstm": base.replace(block_pattern=("mlstm", "mlstm", "slstm"), d_ff=0),
        "encoder": base.replace(family="audio", encoder_layers=2, frontend="audio"),
        "vision": base.replace(family="vlm", frontend="vision", num_prefix_tokens=3),
        "mtp": base.replace(mtp_depth=1),
        "tied": base.replace(tie_embeddings=True),
        "softcap": base.replace(logit_softcap=5.0),
    }
    out.update(ARCHS)
    return out


# the variants whose decode the CPU tests hold to their forward; every
# variant's decode is held to the CPU's decode from the same weights
LM_DECODE = ("dense", "swa", "local", "mla", "rg_hybrid", "xlstm", "encoder", "tied",
             "softcap", "debug-dense")


def lm_forward_and_decode(name, cfg, device):
    """One variant's forward and its decode loop (the serving path: a
    ``decode_step`` a token into the cache) on the card and on the CPU from
    the same weights and inputs, with the MoE routes of every forward and
    decode step on each: (forward card-vs-CPU diff, decode card-vs-CPU
    diff, decode-vs-forward diff on the card or None, route margin or
    None)."""
    from repro_torch.models import Transformer, moe
    from repro_torch.utils.tree import tree_map

    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(0)
    host_model, card_model = Transformer(cfg, device=cpu), Transformer(cfg, device=device)
    host_p = host_model.init(g)
    card_p = tree_map(lambda t: t.to(device), host_p)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (LM_B, LM_S), generator=g)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((LM_B, 5, cfg.d_model), generator=g)
    if cfg.num_prefix_tokens:
        batch["prefix_embeds"] = torch.randn((LM_B, cfg.num_prefix_tokens, cfg.d_model),
                                             generator=g)
    routes = {"cpu": [], "cuda": []}
    topk = moe._topk

    def recording(gates, k):
        out = topk(gates, k)
        routes[gates.device.type].append((gates.cpu(), out[1].cpu()))
        return out

    def forward_and_decode(model, params, b):
        logits = model.forward(params, b)["logits"]
        memory = model.encode(params, b["frames"]) if cfg.is_encoder_decoder else None
        cache, steps = model.init_cache(LM_B, LM_S), []
        for t in range(LM_S):
            lg, cache = model.decode_step(params, b["tokens"][:, t:t + 1], cache, t,
                                          memory=memory)
            steps.append(lg[:, 0])
        return logits, torch.stack(steps, 1)

    moe._topk = recording
    try:
        with torch.no_grad():
            host, host_dec = forward_and_decode(host_model, host_p, batch)
            logits, dec = forward_and_decode(card_model, card_p,
                                             {k: v.to(device) for k, v in batch.items()})
    finally:
        moe._topk = topk
    for what, got, want in (("logits", logits, host), ("decode logits", dec, host_dec)):
        if not bool(torch.isfinite(got).all()) or got.shape != want.shape:
            fail(f"[4l] {name}: {what} of shape {tuple(got.shape)} not finite or not the CPU's")
    if len(routes["cpu"]) != len(routes["cuda"]):
        fail(f"[4l] {name}: the MoE layers ran {len(routes['cuda'])} times on the card, "
             f"{len(routes['cpu'])} on the CPU")
    margin = None
    for (hg, hi), (_, ci) in zip(routes["cpu"], routes["cuda"]):
        if not torch.equal(hi, ci):
            fail(f"[4l] {name}: the card routes tokens to other experts than the CPU "
                 f"(forward or a decode step)")
        top = torch.sort(hg, dim=-1, descending=True).values
        k = cfg.moe.num_experts_per_tok
        gap = float((top[:, k - 1] - top[:, k]).min())
        margin = gap if margin is None else min(margin, gap)
    dec_diff = float((dec - logits).abs().max()) if name in LM_DECODE else None
    return (float((logits.cpu() - host).abs().max()), float((dec.cpu() - host_dec).abs().max()),
            dec_diff, margin)


def run_lm_zoo(device):
    """The LM zoo on the card: ``serve.main`` at the presets' registered
    widths (batch 4, prompt 32, gen 16; a first call warms up), then every
    CPU-test variant's forward and decode card vs CPU and decode vs forward."""
    import io

    from repro_torch.launch import serve

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        fail("[4l] TF32 products are on: the card would drift ~1e-3 from the CPU")
    for arch in ("debug-dense", "debug-moe"):
        argv = ["--arch", arch, "--preset", "full", "--batch", "4", "--prompt-len", "32",
                "--gen", "16"]
        with contextlib.redirect_stdout(io.StringIO()):
            serve.main(argv)                      # warm-up: cuBLAS handles, the allocator
        if serve.main(argv) != 0:
            fail(f"[4l] serve.main({argv}) failed")
    for name, cfg in lm_variants().items():
        diff, dec_cpu, dec, margin = lm_forward_and_decode(name, cfg, device)
        line = (f"  {name:12s} card vs CPU: forward {diff:.3e}, decode {dec_cpu:.3e} "
                f"(limit {LM_CARD_TOL:g})")
        if dec is not None:
            line += f"; decode vs forward on the card {dec:.3e} (limit {LM_DECODE_TOL:g})"
        if margin is not None:
            line += (f"; routes equal at the forward and every decode step, k-th gate above "
                     f"the next by >= {margin:.3e}")
        print(line)
        if not diff <= LM_CARD_TOL:
            fail(f"[4l] {name}: forward logits differ by {diff} between the card and the CPU")
        if not dec_cpu <= LM_CARD_TOL:
            fail(f"[4l] {name}: decode logits differ by {dec_cpu} between the card and the CPU")
        if dec is not None and not dec <= LM_DECODE_TOL:
            fail(f"[4l] {name}: decode differs from forward by {dec} on the card")


# ---------------------------------------------------------------------------
# phase 4m: the LM zoo's training on the card
# ---------------------------------------------------------------------------

LM_TRAIN_DIR = ROOT / "build" / "4m"
LM_CLIENTS, LM_BATCH, LM_SEQ, LM_LR = 4, 8, 64, 3e-4   # the reference driver's defaults
LM_TRAIN_ARGV = ["--preset", "full", "--steps", str(LM_TRAIN_STEPS), "--clients",
                 str(LM_CLIENTS), "--batch", str(LM_BATCH), "--seq", str(LM_SEQ),
                 "--local-steps", "1", "--lr", str(LM_LR), "--strategy", "enfed",
                 "--neighborhood", "2", "--log-every", "10"]
LM_ENFED_MASK = np.array([1.0, 1.0, 0.0, 1.0], np.float32)   # client 2 left out


def lm_train_presets():
    from repro_torch.configs import get_config

    return {name: get_config(name) for name in ("debug-dense", "debug-moe")}


def state_bits(tree) -> dict:
    """``{path: bytes}`` of every leaf of a training state (tensors or the
    host numpy a checkpoint restores), keyed as the checkpointer keys it."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths

    return {k: (v.dtype, v.shape, v.tobytes()) for k, v in _flatten_with_paths(tree).items()}


def lm_train_runs(arch):
    """``train.main`` for ``arch`` at its registered widths: a 2-step
    warm-up (no checkpoint), the 30-step run with its checkpoint under
    ``build/4m``, which must exit 0 (the loss improved), then the same
    command again, which must restore that checkpoint bit for bit and go
    on from its step.  Returns the 30-step run's tokens/s."""
    import io
    import shutil

    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train as train_mod

    ckpt = LM_TRAIN_DIR / arch
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", arch] + LM_TRAIN_ARGV + ["--ckpt-dir", str(ckpt)]
    runs, restored = [], []
    real_train, real_restore = train_mod.train, train_mod.restore_checkpoint

    def spy_train(argv=None, params_one=None):
        runs.append(real_train(argv, params_one))
        return runs[-1]

    def spy_restore(*args, **kw):
        restored.append(real_restore(*args, **kw))
        return restored[-1]

    train_mod.train, train_mod.restore_checkpoint = spy_train, spy_restore
    try:
        with contextlib.redirect_stdout(io.StringIO()):     # cuBLAS handles, the allocator
            train_mod.main(["--arch", arch] + LM_TRAIN_ARGV + ["--steps", "2"])
        rc = train_mod.main(argv)
        saved = state_bits((runs[-1].params, runs[-1].opt_state))
        rc_resumed = train_mod.main(argv)
    finally:
        train_mod.train, train_mod.restore_checkpoint = real_train, real_restore
    first, resumed = runs[1], runs[2]
    print(f"  {arch}: {LM_TRAIN_STEPS} steps exit {rc}, loss {first.losses[0]:.4f} -> "
          f"{first.losses[-1]:.4f}, {first.tokens_per_s:.1f} training tokens/s; battery "
          f"{100 * first.battery[-1]:.3f} %; resumed from step {resumed.start}: exit "
          f"{rc_resumed}, loss {resumed.losses[0]:.4f} -> {resumed.losses[-1]:.4f}, "
          f"{resumed.tokens_per_s:.1f} tokens/s")
    if rc != 0 or not first.losses[-1] < first.losses[0]:
        fail(f"[4m] {arch}: train.main exited {rc}: the loss did not improve in "
             f"{LM_TRAIN_STEPS} steps")
    if first.start != 0 or resumed.start != LM_TRAIN_STEPS or len(restored) != 1:
        fail(f"[4m] {arch}: the rerun did not restore step {LM_TRAIN_STEPS} "
             f"(starts {first.start}, {resumed.start}; {len(restored)} restores)")
    state, step = restored[0]
    if step != LM_TRAIN_STEPS or state_bits(state) != saved:
        fail(f"[4m] {arch}: the restored state is not the saved one bit for bit")
    if latest_step(str(ckpt)) != 2 * LM_TRAIN_STEPS:
        fail(f"[4m] {arch}: the resumed run wrote no checkpoint at step {2 * LM_TRAIN_STEPS}")
    if not all(math.isfinite(v) for v in first.losses + resumed.losses):
        fail(f"[4m] {arch}: a loss is not finite")
    shutil.rmtree(ckpt, ignore_errors=True)
    return first.tokens_per_s


def lm_round_check(device, name, cfg):
    """One ``FederatedTrainer`` round of every strategy (enfed with client
    2 left out) on the card and on the CPU from the same weights and the
    driver's first batch: losses within ``LM_CARD_TOL``, the MoE routes of
    the first forward equal, the params' mean absolute gap under [4c]'s
    rule (the CPU's spread under a ``ULP_REL`` perturbation of the weights
    below ``LM_ROUND_MEAN_TOL``, a ``FAULT_REL`` fault above it)."""
    from repro_torch.core import AggregationStrategy, FederatedTrainer
    from repro_torch.data import synthetic_token_batches
    from repro_torch.launch.steps import lm_loss
    from repro_torch.models import Transformer, moe
    from repro_torch.utils.tree import tree_leaves, tree_map

    cpu = torch.device("cpu")
    models = {"cpu": Transformer(cfg, device=cpu), "cuda": Transformer(cfg, device=device)}
    host_p = models["cpu"].init(torch.Generator().manual_seed(0))
    card_p = tree_map(lambda t: t.to(device), host_p)
    flat = next(synthetic_token_batches(cfg.vocab_size, LM_BATCH, LM_SEQ, 1, seed=2))
    batches = {k: torch.from_numpy(v.reshape(LM_CLIENTS, 1, LM_BATCH // LM_CLIENTS, LM_SEQ))
               .long() for k, v in flat.items()}
    routes = {"cpu": [], "cuda": []}
    topk = moe._topk

    def recording(gates, k):
        out = topk(gates, k)
        routes[gates.device.type].append(out[1].cpu())
        return out

    def one_round(params, strategy, mask):
        dev = tree_leaves(params)[0].device
        model = models[dev.type]
        tr = FederatedTrainer(lambda p, b: lm_loss(model, p, b), LM_CLIENTS, strategy,
                              lr=LM_LR)
        mixed, _, losses = tr.round(*tr.init(params), {k: v.to(dev) for k, v in batches.items()},
                                    mask)
        return torch.cat([x.reshape(-1) for x in tree_leaves(mixed)]).cpu(), losses.cpu()

    def perturbed(rel, seed):
        g = torch.Generator().manual_seed(seed)
        return tree_map(lambda t: t * (1 + rel * torch.randn(t.shape, generator=g)), host_p)

    def gap_of(a, b):
        return float((a - b).abs().mean())

    for kind in ("cfl", "enfed", "dfl_ring", "dfl_mesh", "none"):
        strategy = AggregationStrategy(kind=kind, neighborhood_size=2 if kind == "enfed" else 0)
        mask = LM_ENFED_MASK if kind == "enfed" else None
        routes["cpu"].clear()
        routes["cuda"].clear()
        moe._topk = recording
        try:
            card, card_loss = one_round(card_p, strategy, mask)
            host, host_loss = one_round(host_p, strategy, mask)
        finally:
            moe._topk = topk
        diff = gap_of(card, host)
        loss_gap = float((card_loss - host_loss).abs().max())
        noise = max(gap_of(one_round(perturbed(ULP_REL, sd), strategy, mask)[0], host)
                    for sd in range(3))
        fault = gap_of(one_round(perturbed(FAULT_REL, 0), strategy, mask)[0], host)
        gap = (card - host).abs()
        first = cfg.num_layers if cfg.moe is not None else 0
        line = (f"  {name} {kind:8s} card vs CPU: losses {loss_gap:.3e} (limit "
                f"{LM_CARD_TOL:g}); params mean gap {diff:.3e} (limit {LM_ROUND_MEAN_TOL:g}; "
                f"RMS {float(gap.pow(2).mean().sqrt()):.3e}, max {float(gap.max()):.3e}, "
                f"{int((gap > 1e-5).sum())} of {gap.numel()} beyond 1e-5); CPU vs CPU mean "
                f"gap: {ULP_REL:g} perturbation {noise:.3e}, {FAULT_REL:g} fault {fault:.3e}")
        if first:
            same = sum(torch.equal(a, b) for a, b in zip(routes["cpu"], routes["cuda"]))
            line += (f"; MoE routes equal in {same} of {len(routes['cpu'])} calls of the "
                     f"round (the first forward's {first} must be)")
        print(line)
        if not (bool(torch.isfinite(card).all()) and bool(torch.isfinite(card_loss).all())):
            fail(f"[4m] {name} {kind}: the card's round is not finite")
        if len(routes["cpu"]) != len(routes["cuda"]) or not all(
                torch.equal(a, b) for a, b in zip(routes["cpu"][:first], routes["cuda"][:first])):
            fail(f"[4m] {name} {kind}: the card routes the first forward's tokens to other "
                 f"experts than the CPU")
        if not loss_gap <= LM_CARD_TOL:
            fail(f"[4m] {name} {kind}: the losses differ by {loss_gap} between the card and "
                 f"the CPU")
        if not noise < LM_ROUND_MEAN_TOL:
            fail(f"[4m] {name} {kind}: the CPU's own spread {noise} reaches the limit "
                 f"{LM_ROUND_MEAN_TOL}")
        if not fault > LM_ROUND_MEAN_TOL:
            fail(f"[4m] {name} {kind}: a {FAULT_REL:g} fault ({fault}) stays within the "
                 f"limit {LM_ROUND_MEAN_TOL}, which therefore checks nothing")
        if not diff <= LM_ROUND_MEAN_TOL:
            fail(f"[4m] {name} {kind}: the round's params differ by {diff} on average "
                 f"between the card and the CPU")


def lm_remat_check(device, name, cfg):
    """One client's loss and gradient on the card with per-block remat on
    and off, from the same weights and batch: bit-equal, or within
    ``LM_REMAT_TOL``."""
    from repro_torch.data import synthetic_token_batches
    from repro_torch.launch.steps import lm_loss
    from repro_torch.models import Transformer
    from repro_torch.utils.tree import tree_leaves, value_and_grad

    on, off = Transformer(cfg, device=device), Transformer(cfg.replace(remat=False),
                                                           device=device)
    params = on.init(torch.Generator().manual_seed(0))
    flat = next(synthetic_token_batches(cfg.vocab_size, LM_BATCH // LM_CLIENTS, LM_SEQ, 1,
                                        seed=2))
    batch = {k: torch.from_numpy(v).long().to(device) for k, v in flat.items()}
    lo, go = value_and_grad(lambda p: lm_loss(on, p, batch), params)
    lf, gf = value_and_grad(lambda p: lm_loss(off, p, batch), params)
    pairs = [(lo, lf)] + list(zip(tree_leaves(go), tree_leaves(gf)))
    bits = all(torch.equal(a, b) for a, b in pairs)
    gap = max(float((a - b).abs().max()) for a, b in pairs)
    print(f"  {name} remat on vs off on the card: "
          + ("bit-equal" if bits else f"largest gap {gap:.3e} (limit {LM_REMAT_TOL:g})")
          + f" over the loss and {len(pairs) - 1} gradient leaves")
    if not gap <= LM_REMAT_TOL:
        fail(f"[4m] {name}: remat on and off differ by {gap} on the card")


def run_lm_training(device):
    """The LM zoo's training on the card: ``train.main`` and its resume at
    both presets' registered widths, one round of every strategy card vs
    CPU, and remat on vs off (the presets, and ``debug-moe`` through the
    sort dispatch).  The path is plain torch: it launches no hand-written
    kernel."""
    import dataclasses as dc

    from repro_torch.kernels import launch_counts

    reset_counts()
    rates = {arch: lm_train_runs(arch) for arch in lm_train_presets()}
    launched = {k: v for k, v in launch_counts().items() if v}
    print(f"  training tokens/s: {rates}; hand-written kernel launches: {launched or 'none'}")
    for name, cfg in lm_train_presets().items():
        lm_round_check(device, name, cfg)
    variants = dict(lm_train_presets())
    variants["debug-moe/sort"] = variants["debug-moe"].replace(
        moe=dc.replace(variants["debug-moe"].moe, dispatch="sort"))
    for name, cfg in variants.items():
        lm_remat_check(device, name, cfg)


# ---------------------------------------------------------------------------
# [4n]: the mesh runtime, 8 ranks on the one card
# ---------------------------------------------------------------------------

MESH_RANKS = 8
# card vs CPU, the same 8 ranks: aggregation sums (one int8 code apart would
# move a sum by a whole scale step, absmax / 127 of a hop's payload, above
# 1e-2 here, so sums this close have equal codes) and the ep schedule
# against the token-local sort on the same ranks
MESH_AGG_TOL = 1e-6
MESH_EP_TOL = 2e-5
MESH_BATCH, MESH_SEQ = 8, 16          # the reference test's batch
MESH_STEP_REPS = 5
MESH_KINDS = ("cfl", "enfed", "dfl_ring", "dfl_mesh")
MESH_MASK = np.array([1.0, 0.0, 1.0, 1.0], np.float32)   # client 1 left out


def mesh_agg_cases():
    """Every aggregation case of [4n]: (name, multi-pod, strategy kwargs)."""
    cases = []
    for multi in (False, True):
        combos = [("cfl", 0, None), ("dfl_mesh", 0, None), ("dfl_ring", 0, None),
                  ("dfl_ring", 0, "int8"), ("enfed", 0, None)]
        if not multi:  # the data axis of 4 holds neighbourhoods of 2
            combos += [("enfed", 2, None), ("enfed", 2, "int8")]
        for kind, k, compress in combos:
            for pod_local in ((False, True) if multi and kind == "enfed" else (False,)):
                name = (f"{'pod2' if multi else 'pod1'} {kind} k={k} {compress or 'fp32'}"
                        f"{' pod_local' if pod_local else ''}")
                cases.append((name, multi, dict(kind=kind, neighborhood_size=k,
                                                compress=compress, pod_local=pod_local)))
    return cases


def mesh_closed_form(kind, k, compress, pod_local, multi, leaves):
    """The collective bytes per device of one aggregation: all-reduce of
    each leaf and the mask total, all-gathers of n x the leaf, one permute
    of each leaf (int8: codes and a scale) and of the total per ring hop."""
    W = sum(x.nbytes for x in leaves)
    n_data, C = (2, 4) if multi else (4, 4)
    ar = 4 + W
    if kind == "cfl":
        return ar
    if kind == "dfl_mesh":
        return n_data * W + (C * W if multi else 0) + 4
    hop = sum(x.size + 4 for x in leaves) if compress == "int8" else W
    if kind == "dfl_ring":
        return (n_data - 1) * (hop + 4) + (ar if multi else 0)
    kk = k or n_data
    ring = ar if kk >= n_data else (kk - 1) * (hop + 4)
    return ring + (ar if multi and not pod_local else 0)


def mesh_rank(rank, world, device, data):
    """One rank of [4n]: :func:`mesh_work` on ``device`` (timed), then on
    the CPU with the same groups; the seconds each took."""
    entered = time.time()
    from repro_torch.launch import mesh as tmesh

    t0 = time.perf_counter()
    meshes = {m: tmesh.make_debug_mesh(multi_pod=m) for m in (False, True)}
    t1 = time.perf_counter()
    card = mesh_work(rank, meshes, device, data, True)
    t2 = time.perf_counter()
    host = mesh_work(rank, meshes, "cpu", data, False)
    return dict(card=card, host=host,
                secs=dict(meshes=t1 - t0, card=t2 - t1, host=time.perf_counter() - t2),
                entered=entered, left=time.time())


def mesh_work(rank, meshes, device, data, timed):
    """Aggregation, one federated train step of every strategy for both
    presets, the MoE's ep schedule against the token-local sort, and
    (``timed``) step and all-reduce walls, on ``device``."""
    import dataclasses as dc

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.topology import (AggregationStrategy, aggregate_updates,
                                           gather_clients)
    from repro_torch.launch import mesh as tmesh, steps
    from repro_torch.launch.hlo_stats import collective_bytes
    from repro_torch.models import Transformer, moe
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.utils.tree import from_jax_params, tree_leaves

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    kernels.reset_launch_counts()
    out = {"agg": {}, "train": {}, "walls": {}}
    for name, multi, kw in mesh_agg_cases():
        mesh = meshes[multi]
        caxes = ("pod", "data") if multi else ("data",)
        c = coll.axis_index(mesh, caxes)
        u = {k: torch.from_numpy(v[c]).to(dev) for k, v in data["updates"].items()}
        with coll.record_collectives() as rec:
            blk = aggregate_updates(u, mesh, AggregationStrategy(client_axes=caxes, **kw),
                                    torch.from_numpy(MESH_MASK).to(dev))
        full = gather_clients(blk, mesh, caxes)
        out["agg"][name] = ({k: v.cpu().numpy() for k, v in full.items()},
                            collective_bytes(rec)["total_collective_bytes"])

    mesh = meshes[True]
    batch = {k: torch.from_numpy(v).long().to(dev) for k, v in data["batch"].items()}
    mask = torch.ones(4, dtype=torch.float32, device=dev)
    for arch, host_params in data["params"].items():
        cfg = get_config(arch)
        model = Transformer(cfg, device=dev)
        params = from_jax_params(host_params, dev)
        caxes = tmesh.client_axes_for(cfg, mesh)
        C = steps.num_clients(mesh, caxes)
        for kind in MESH_KINDS + ("none",):
            strat = AggregationStrategy(kind=kind, client_axes=caxes, neighborhood_size=2)
            step, opt = steps.make_federated_train_step(model, mesh, strat, lr=LM_LR)
            if kind == "none":
                args = (params, opt.init(params), batch, mask)
            else:
                args = (steps.client_block(steps.stack_for_clients(params, C), mesh, caxes),
                        steps.client_block(steps.stack_for_clients(opt.init(params), C),
                                           mesh, caxes), batch, mask)
            p2, _, loss = step(*args)
            if kind != "none":
                p2 = gather_clients(p2, mesh, caxes)
            flat = torch.cat([x.reshape(-1) for x in tree_leaves(p2)]).cpu()
            out["train"][(arch, kind)] = (float(loss), flat.numpy() if rank == 0 else None)
            if timed:
                sync()
                t0 = time.perf_counter()
                for _ in range(MESH_STEP_REPS):
                    step(*args)
                sync()
                out["walls"][(arch, kind)] = (time.perf_counter() - t0) / MESH_STEP_REPS * 1e3
        if timed and arch == "debug-dense":
            grad = torch.randn(sum(x.numel() for x in tree_leaves(params)),
                               generator=torch.Generator().manual_seed(rank)).to(dev)
            coll.all_reduce(grad, mesh, caxes)
            sync()
            t0 = time.perf_counter()
            for _ in range(MESH_STEP_REPS):
                coll.all_reduce(grad, mesh, caxes)
            sync()
            out["walls"][("debug-dense", "all-reduce of the gradient")] = (
                (time.perf_counter() - t0) / MESH_STEP_REPS * 1e3)

    cfg = get_config("debug-moe")
    x = torch.from_numpy(data["x"]).to(dev)
    with use_mesh(mesh), torch.no_grad():
        ys = {}
        for dispatch in ("ep", "sort"):
            c = cfg.replace(moe=dc.replace(cfg.moe, dispatch=dispatch))
            moe_params = from_jax_params(data["params"]["debug-moe"]["scan"]["p0_attn"]["ffn"],
                                         dev)
            moe_params = {k: v[0] for k, v in moe_params.items()}
            ys[dispatch] = moe.moe_apply(moe_params, x, c)
    out["ep_gap"] = float((ys["ep"][0] - ys["sort"][0]).abs().max())
    out["ep_aux_gap"] = float((ys["ep"][1] - ys["sort"][1]).abs())
    out["launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
    return out


def run_mesh(device):
    """[4n]: 8 ranks on ``device`` as ``make_debug_mesh(multi_pod=True)``
    (and the (4, 2) mesh for the aggregation), over gloo, against the same
    8 ranks on the CPU; then one dry-run record built here."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import Transformer
    from repro_torch.utils.tree import to_numpy

    rng = np.random.default_rng(27)
    data = dict(
        updates={"w": (rng.standard_normal((4, 6, 5)) * rng.uniform(0.1, 10, (4, 1, 1)))
                 .astype(np.float32), "b": rng.standard_normal((4, 7)).astype(np.float32)},
        params={arch: to_numpy(Transformer(get_config(arch), device="cpu")
                               .init(torch.Generator().manual_seed(0)))
                for arch in ("debug-dense", "debug-moe")},
        x=rng.standard_normal((MESH_BATCH, MESH_SEQ, 128)).astype(np.float32))
    toks = rng.integers(0, 512, (MESH_BATCH, MESH_SEQ + 1))
    data["batch"] = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    t0, t_abs = time.perf_counter(), time.time()
    ranks = spawn(mesh_rank, MESH_RANKS, str(device), data)
    card, host = [r["card"] for r in ranks], [r["host"] for r in ranks]
    secs = ranks[0]["secs"]
    print(f"  8 ranks in {time.perf_counter() - t0:.1f} s: the last started work "
          f"{max(r['entered'] for r in ranks) - t_abs:.1f} s in; rank 0 built its meshes in "
          f"{secs['meshes']:.1f} s, ran on {device} in {secs['card']:.1f} s and on the CPU "
          f"in {secs['host']:.1f} s; the last rank returned "
          f"{max(r['left'] for r in ranks) - t_abs:.1f} s in (gloo; each payload staged "
          f"through host memory)")
    launched = {k: v for r in card for k, v in r["launches"].items()}
    print(f"  hand-written kernel launches on the ranks: {launched or 'none'}")

    leaves = [v[0] for v in data["updates"].values()]
    print("  aggregation, card vs CPU (mask [1, 0, 1, 1], distinct updates per client):")
    for name, multi, kw in mesh_agg_cases():
        got, nbytes = card[0]["agg"][name]
        want, _ = host[0]["agg"][name]
        gap = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        closed = mesh_closed_form(kw["kind"], kw["neighborhood_size"], kw["compress"],
                                  kw["pod_local"], multi, leaves)
        print(f"    {name:30s} max gap {gap:.3e} (limit {MESH_AGG_TOL:g}); collective bytes "
              f"{nbytes:.0f}, closed form {closed}")
        if not all(np.isfinite(v).all() for v in got.values()) or not gap <= MESH_AGG_TOL:
            fail(f"[4n] aggregation {name}: the card's result is {gap} from the CPU's")
        if nbytes != closed:
            fail(f"[4n] aggregation {name}: {nbytes} collective bytes, closed form {closed}")
    for arch in ("debug-dense", "debug-moe"):
        losses = {}
        for kind in MESH_KINDS + ("none",):
            (loss, flat), (host_loss, host_flat) = (card[0]["train"][(arch, kind)],
                                                    host[0]["train"][(arch, kind)])
            losses[kind] = loss
            mean_gap = float(np.abs(flat - host_flat).mean())
            wall = card[0]["walls"][(arch, kind)]
            print(f"  {arch} {kind:8s} step: loss {loss:.6f}, card vs CPU loss "
                  f"{abs(loss - host_loss):.3e} (limit {LM_CARD_TOL:g}), params mean gap "
                  f"{mean_gap:.3e} (limit {LM_ROUND_MEAN_TOL:g}), max "
                  f"{float(np.abs(flat - host_flat).max()):.3e}; wall {wall:.2f} ms "
                  f"(rank 0, mean of {MESH_STEP_REPS})")
            if not (np.isfinite(loss) and np.isfinite(flat).all()):
                fail(f"[4n] {arch} {kind}: the card's step is not finite")
            if not abs(loss - host_loss) <= LM_CARD_TOL:
                fail(f"[4n] {arch} {kind}: the loss differs by {abs(loss - host_loss)} "
                     f"between the card and the CPU")
            if not mean_gap <= LM_ROUND_MEAN_TOL:
                fail(f"[4n] {arch} {kind}: the params differ by {mean_gap} on average "
                     f"between the card and the CPU")
        spread = max(losses[k] for k in MESH_KINDS) - min(losses[k] for k in MESH_KINDS)
        print(f"  {arch}: the four strategies' losses agree within {spread:.3e} (limit 1e-4)")
        if not spread < 1e-4:
            fail(f"[4n] {arch}: the strategies' losses spread {spread}")
    ar = card[0]["walls"][("debug-dense", "all-reduce of the gradient")]
    print(f"  one all-reduce of the debug-dense gradient over (pod, data): {ar:.2f} ms "
          f"(rank 0, mean of {MESH_STEP_REPS}; staged through host memory)")
    ep = max(r["ep_gap"] for r in card)
    ep_aux = max(r["ep_aux_gap"] for r in card)
    print(f"  debug-moe ep schedule vs token-local sort on the card, every rank: y max gap "
          f"{ep:.3e}, aux {ep_aux:.3e} (limit {MESH_EP_TOL:g})")
    if not (ep <= MESH_EP_TOL and ep_aux <= MESH_EP_TOL):
        fail(f"[4n] the ep schedule differs from the token-local sort by {ep} (aux {ep_aux})")
    rec = dryrun.run_one("debug-dense", "train_4k", False, "cfl")
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"  dry-run record (debug-dense, train_4k, pod1, cfl; no jax on this machine): "
          f"status {rec['status']}, {rec['num_clients']} clients on {rec['n_devices']} ranks, "
          f"flops {rec['flops']:.4e}, bytes_accessed {rec['bytes_accessed']:.4e} (unfused "
          f"upper bound), collective bytes {rec['total_collective_bytes']:.0f}, argument "
          f"bytes {rec['argument_size_in_bytes']:.0f}")
    if rec["status"] != "ok" or "jax" in sys.modules:
        fail("[4n] the dry run failed or loaded jax")


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def time_kernels(dev, counts, errs, n_params, fit_b, f, h, seq_len, n_contrib):
    """Every row of the kernel table: ``ms`` (CUDA events over back-to-back
    wrapper calls on L2-warm inputs), ``host_us`` (the wrapper's enqueue,
    :func:`host_us`), device µs warm and, for AES, eq. 14 and every kernel
    that moves 6 MB or more at its shape, after an L2 flush, the plain twin's and
    the library call's ms and the bound."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rows = time_loop_kernels(dev, counts, errs, n_params, n_contrib, flush)
    rows += time_lstm(dev, counts, errs, fit_b, f, h, seq_len)
    rows += time_int8_kernels(dev, counts, errs, n_params, n_contrib, flush)
    rows += time_robust_kernels(dev, counts, errs, n_params, n_contrib, flush)
    del flush
    for row in rows:
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.5f}"
        cold = f" cold {us_text(row['device_us_cold'])}" if "device_us_cold" in row else ""
        print(f"  {row['name']:10s} {row['shape']}: kernel_ms {row['ms']:.5f}  host_us "
              f"{row['host_us']:.3f}  device_us {us_text(row['device_us'])}{cold}"
              f"{row.get('device_note', '')}  plain_ms {row['plain_ms']:.5f}  "
              f"library_ms {lib}{row.get('library_note', '')}  "
              f"bound_ms {row['bound_ms']:.6f} ({row['bound_by']}{row.get('bound_note', '')})  "
              f"launches on the main paths {row['launches']}")
    return rows


def launch_path_breakdown(dev, n_params, n_contrib):
    """Host µs of each piece of one wrapper call, on the squared norm at
    the fleet's shape (64, 5, P), each piece alone in a loop of
    :func:`host_us`: the checks, the output, the stream handle and the C
    call, in the form the launchers use and in the public-API form beside
    it; then the wrapper whole, and the library calls it is held against."""
    from repro_torch.kernels.common import check_args, current_stream
    from repro_torch.kernels.robust import kernel as rk

    x = torch.randn((FLEET_R, n_contrib, n_params), device=dev)
    w = torch.ones((FLEET_R, n_contrib), device=dev)
    r, n, l = x.shape
    idx = x.get_device()
    out = x.new_empty((r, n))
    f32 = torch.float32

    def device_object_check(name, t, dtype, shape, device):
        """One argument checked through ``torch.device`` objects."""
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(name)
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != tuple(shape)):
            raise ValueError(name)
        if not t.is_contiguous():
            raise ValueError(name)

    rk.sqnorm_cuda(x)                                 # resolves the C function
    c_fn = rk._sqnorm.fn
    args = (x.data_ptr(), out.data_ptr(), r * n, l, current_stream(idx))
    pieces = [
        ("check_args, 1 argument", lambda: check_args(("updates", x, f32, None))),
        ("check_args, 2 arguments", lambda: check_args(("updates", x, f32, None),
                                                       ("weights", w, f32, (r, n)))),
        ("check through torch.device, 1 argument",
         lambda: device_object_check("updates", x, f32, None, x.device)),
        ("x.new_empty((R, N))", lambda: x.new_empty((r, n))),
        ("torch.empty((R, N), dtype, device=x.device)",
         lambda: torch.empty((r, n), dtype=f32, device=x.device)),
        ("current_stream(index) (raw handle)", lambda: current_stream(idx)),
        ("torch.cuda.current_stream(index).cuda_stream",
         lambda: torch.cuda.current_stream(idx).cuda_stream),
        ("3 data_ptr() calls", lambda: (x.data_ptr(), out.data_ptr(), w.data_ptr())),
        ("ctypes call itself (launch included)", lambda: c_fn(*args)),
        ("CFunction call (ctypes + error check)", lambda: rk._sqnorm(*args)),
        ("sqnorm_cuda, whole wrapper", lambda: rk.sqnorm_cuda(x)),
        ("torch.linalg.vecdot(x, x, dim=-1)", lambda: torch.linalg.vecdot(x, x, dim=-1)),
        ("torch.linalg.vector_norm(x, dim=-1)", lambda: torch.linalg.vector_norm(x, dim=-1)),
    ]
    print(f"  launch path of sqnorm_cuda at R,N,L={r},{n},{l}, host us per call "
          f"({HOST_CALLS} calls, bursts of {HOST_BURST}):")
    for what, fn in pieces:
        print(f"    {host_us(fn):8.3f}  {what}")


def time_int8_kernels(dev, counts, errs, n_params, n_contrib, flush):
    """The int8 wire kernels at the fleet's shapes (R = 64, N = 5), also
    cold (``flush`` written between launches), and at one loop-engine
    update, and the launch floor: the device time of dequantize at n = 1,
    one block of one live thread.  Dequantize's yardstick is
    :func:`dequantize_library`, one ``torch.mul`` (bit-equal to the kernel,
    phase 3); no single PyTorch call computes the other three, whose
    ``library_ms`` is null."""
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_q8_cuda
    from repro_torch.kernels.fedavg.ops import fedavg_q8_cost
    from repro_torch.kernels.fedavg.ref import fedavg_batched_q8_ref
    from repro_torch.kernels.quantize.kernel import dequantize_cuda, quantize_cuda
    from repro_torch.kernels.quantize.ops import dequantize_cost, quantize_cost
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
    # fedavg_kernel<N, LoadQ8>: the dense body with the int8 loader;
    # fedavg_q8_kernel in trees where the int8 form had a body of its own
    names = ("fedavg_kernel", "fedavg_q8_kernel")
    ms = cuda_ms(lambda: fedavg_batched_q8_cuda(q, s, w))
    plain = cuda_ms(lambda: fedavg_batched_q8_ref(q, s, w), iters=50, warmup=5)
    b_ms, b_by = cost_bound(fedavg_q8_cost(r, n, lp))
    rows.append(dict(name="fedavg_q8", route="cuda", source="src/repro_torch/csrc/fedavg.cu",
                     replaces="src/repro/kernels/fedavg/kernel.py:83",
                     device_us=device_us(lambda: fedavg_batched_q8_cuda(q, s, w), names),
                     device_us_cold=device_us(lambda: fedavg_batched_q8_cuda(q, s, w), names,
                                              flush=flush),
                     host_us=host_us(lambda: fedavg_batched_q8_cuda(q, s, w)),
                     launches=counts["fedavg_q8"], max_abs_err=errs["fedavg_q8"], ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     shape=f"R,N,Lp={r},{n},{lp}"))

    # quantize at the fleet's staging: R * N rows of P, ragged to Lp
    x = torch.randn((r * n, n_params), generator=g).to(dev) * 0.3
    ms = cuda_ms(lambda: quantize_cuda(x))
    plain = cuda_ms(lambda: quantize_batched_ref(x), iters=50, warmup=5)
    b_ms, b_by = cost_bound(quantize_cost(r * n, n_params))
    rows.append(dict(name="quantize_batched", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/kernel.py:89",
                     device_us=device_us(lambda: quantize_cuda(x), "quantize_kernel"),
                     device_us_cold=device_us(lambda: quantize_cuda(x), "quantize_kernel",
                                              flush=flush),
                     host_us=host_us(lambda: quantize_cuda(x)),
                     launches=counts["quantize_batched"], max_abs_err=errs["quantize"], ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     shape=f"B,L={r * n},{n_params} -> Lp={lp}"))
    # the same kernel on one update (the loop engine's compress_update)
    v = x[0].contiguous()
    ms1 = cuda_ms(lambda: quantize_cuda(v))
    plain1 = cuda_ms(lambda: quantize_batched_ref(v), iters=50, warmup=5)
    b1, b1_by = cost_bound(quantize_cost(1, n_params))
    rows.append(dict(name="quantize", route="cuda", source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/kernel.py:41",
                     device_us=device_us(lambda: quantize_cuda(v), "quantize_kernel"),
                     host_us=host_us(lambda: quantize_cuda(v)),
                     launches=counts["quantize"], max_abs_err=errs["quantize"], ms=ms1,
                     plain_ms=plain1, bound_ms=b1, bound_by=b1_by, library_ms=None,
                     shape=f"L={n_params} (one update) -> Lp={lp}"))

    # dequantize of one update (the loop engine's decompress_update)
    q1, s1 = quantize_batched_ref(v)
    ms = cuda_ms(lambda: dequantize_cuda(q1, s1, n_params))
    plain = cuda_ms(lambda: dequantize_ref(q1, s1, n_params), iters=50, warmup=5)
    b_ms, b_by = cost_bound(dequantize_cost(n_params, tiles))
    # the launch floor: dequantize at n = 1, one block of one live thread,
    # through the same ctypes path
    q0, s0 = q1[:TILE].contiguous(), s1[:1].contiguous()
    floor = device_us(lambda: dequantize_cuda(q0, s0, 1), "dequantize_kernel")
    rows.append(dict(name="dequantize", route="cuda", source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/kernel.py:120",
                     floor_us=floor,
                     device_note=f"; launch floor (n = 1, one live thread) {us_text(floor)}",
                     device_us=device_us(lambda: dequantize_cuda(q1, s1, n_params),
                                         "dequantize_kernel"),
                     host_us=host_us(lambda: dequantize_cuda(q1, s1, n_params)),
                     launches=counts["dequantize"], max_abs_err=errs["dequantize"], ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=cuda_ms(lambda: dequantize_library(q1, s1, n_params)),
                     library_note=" (torch.mul of the tiles by their scales)",
                     shape=f"Lp={lp} -> L={n_params}"))
    return rows


def time_robust_kernels(dev, counts, errs, n_params, n_contrib, flush):
    """The six robust kernels at the fleet's AGGREGATE, (R, N) = (64, 5):
    fp32 (R, N, P) and int8 (R, N, Lp), all contributors active.  The
    squared norm's yardstick is ``torch.linalg.vecdot(x, x)``, the same
    function (``vector_norm``, its square root, is printed beside it), the
    dense median's ``torch.nanquantile`` over the active entries; no single
    PyTorch call computes the other three.  Every row is also timed cold
    (``flush`` written between launches): the fleet reads its (R, N, P)
    buffer from HBM.  The two dense column kernels are also timed at the
    loop engine's (1, N, P), warm and cold (``r1_us``, ``r1_us_cold``)."""
    from repro_torch.kernels.quantize.ref import quantize_batched_ref
    from repro_torch.kernels.robust import kernel as rk
    from repro_torch.kernels.robust import ops as ro
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

    def median_library():
        """The midpoint median over the active contributors, inactive
        entries set to NaN by one ``torch.where`` (timed with it)."""
        u = torch.where(w[:, :, None] > 0, x, float("nan"))
        return torch.nanquantile(u, 0.5, dim=1, interpolation="midpoint")

    # the bounds read the ops' cost functions (kernels/robust/ops.py)
    specs = [
        ("trimmed_mean", "kernel.py:254", lambda: rk.trimmed_mean_cuda(x, w),
         lambda: rr.trimmed_mean_batched_ref(x, w), None, "trimmed_mean_kernel",
         ro.trimmed_mean_cost(r, n, l), f"R,N,L={r},{n},{l}"),
        ("trimmed_mean_q8", "kernel.py:261", lambda: rk.trimmed_mean_q8_cuda(q, s, w),
         lambda: rr.trimmed_mean_batched_q8_ref(q, s, w), None, "trimmed_mean_kernel",
         ro.trimmed_mean_q8_cost(r, n, lp), f"R,N,Lp={r},{n},{lp}"),
        ("median", "kernel.py:269", lambda: rk.median_cuda(x, w),
         lambda: rr.median_batched_ref(x, w), median_library, "median_kernel",
         ro.median_cost(r, n, l), f"R,N,L={r},{n},{l}"),
        ("median_q8", "kernel.py:276", lambda: rk.median_q8_cuda(q, s, w),
         lambda: rr.median_batched_q8_ref(q, s, w), None, "median_kernel",
         ro.median_q8_cost(r, n, lp), f"R,N,Lp={r},{n},{lp}"),
        ("sqnorm", "kernel.py:284", lambda: rk.sqnorm_cuda(x),
         lambda: rr.sqnorm_batched_ref(x), lambda: torch.linalg.vecdot(x, x, dim=-1),
         "sqnorm_kernel", ro.sqnorm_cost(r, n, l), f"R,N,L={r},{n},{l}"),
        ("sqnorm_q8", "kernel.py:310", lambda: rk.sqnorm_q8_cuda(q, s),
         lambda: rr.sqnorm_batched_q8_ref(q, s), None, "sqnorm_kernel",
         ro.sqnorm_q8_cost(r, n, lp), f"R,N,Lp={r},{n},{lp}"),
    ]
    rows = []
    for name, line, kern, plain_fn, lib_fn, kname, cost, shape in specs:
        b_ms, b_by = cost_bound(cost)
        row = dict(name=name, route="cuda", source=src,
                   replaces=f"src/repro/kernels/robust/{line}",
                   device_us=device_us(kern, kname), host_us=host_us(kern),
                   launches=counts[name], max_abs_err=errs[name], ms=cuda_ms(kern),
                   plain_ms=cuda_ms(plain_fn, iters=50, warmup=5),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=None if lib_fn is None else cuda_ms(lib_fn), shape=shape)
        row["device_us_cold"] = device_us(kern, kname, flush=flush)
        if name in ("trimmed_mean", "median"):
            one = getattr(rk, name + "_cuda")
            x1, w1 = x[:1].contiguous(), w[:1].contiguous()
            row["r1_us"] = device_us(lambda: one(x1, w1), kname)
            row["r1_us_cold"] = device_us(lambda: one(x1, w1), kname, flush=flush)
            row["device_note"] = (f"; at R,N,L=1,{n},{l} {us_text(row['r1_us'])}, cold "
                                  f"{us_text(row['r1_us_cold'])}")
        if name == "sqnorm":
            row["library_note"] = (" (linalg.vecdot; linalg.vector_norm "
                                   f"{cuda_ms(lambda: torch.linalg.vector_norm(x, dim=-1)):.5f})")
        rows.append(row)
    return rows


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
    from repro_torch.kernels.lstm_cell.ops import (lstm_seq_backward, lstm_seq_backward_cost,
                                                   lstm_seq_cost)
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

        f_bound, f_by = cost_bound(lstm_seq_cost(lanes, b, f, h, t, save=True))
        b_bound, b_by = cost_bound(lstm_seq_backward_cost(lanes, b, f, h, t))
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
                             host_us=host_us(fwd),
                             replaces="src/repro/kernels/lstm_cell/kernel.py:66",
                             launches=counts["lstm_cell"], max_abs_err=errs["lstm_cell"],
                             ms=fwd_ms, plain_ms=fwd_plain, bound_ms=f_bound, bound_by=f_by,
                             library_ms=lib_fwd, shape=f"{shape} (forward, states saved)"))
            rows.append(dict(name="lstm_cell_bwd", route="cuda", device_us=bwd_us, source=src,
                             host_us=host_us(bwd),
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


def time_loop_kernels(dev, counts, errs, n_params, n_contrib, flush):
    """Eq. 14 at the loop's and the fleet's shapes, warm and cold (``flush``
    written between launches), and AES-CTR over one fp32 update,
    warm and cold (the path encrypts each update once).  AES's bound is the
    larger of its bytes over HBM and its table lookups over the card's
    shared-memory rate."""
    from repro_torch.core import crypto
    from repro_torch.kernels.aes_ctr.kernel import aes_ctr_cuda
    from repro_torch.kernels.aes_ctr.ops import AES_LOOKUPS_PER_BLOCK, aes_ctr_cost
    from repro_torch.kernels.aes_ctr.ref import aes_ctr_ref
    from repro_torch.kernels.fedavg.kernel import fedavg_batched_cuda
    from repro_torch.kernels.fedavg.ops import fedavg_cost
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
        b_ms, b_by = cost_bound(fedavg_cost(r, n, l))
        dev_us = device_us(lambda: fedavg_batched_cuda(u, w), "fedavg_kernel")
        cold = device_us(lambda: fedavg_batched_cuda(u, w), "fedavg_kernel", flush=flush)
        rows.append(dict(name=name, route="cuda", device_us=dev_us, device_us_cold=cold,
                         host_us=host_us(lambda: fedavg_batched_cuda(u, w)),
                         source="src/repro_torch/csrc/fedavg.cu", replaces=replaces,
                         launches=counts[name], max_abs_err=errs[name], ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                         library_note=" (einsum + div)", shape=f"R,N,L={r},{n},{l}"))

    # AES-CTR over one fp32 update
    nb = 4 * n_params
    rng = np.random.default_rng(4)
    pay = torch.from_numpy(rng.integers(0, 256, nb).astype(np.uint8)).to(dev)
    tables = torch.from_numpy(crypto.TABLES).to(dev)
    rk = torch.from_numpy(crypto.expand_key(rng.integers(0, 256, 16).astype(np.uint8))).to(dev)
    nonce = torch.from_numpy(rng.integers(0, 256, 8).astype(np.uint8)).to(dev)

    def aes():
        return aes_ctr_cuda(pay, rk, nonce, tables)

    ms = cuda_ms(aes)
    plain = cuda_ms(lambda: aes_ctr_ref(pay, rk, nonce, tables), iters=50, warmup=5)
    blocks = (nb + 15) // 16
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b_ms, b_by = cost_bound(aes_ctr_cost(nb), SMEM_LOOKUPS_PER_CLOCK * sms * clock)
    rows.append(dict(name="aes_ctr", route="cuda", device_us=device_us(aes, "aes_ctr_kernel"),
                     device_us_cold=device_us(aes, "aes_ctr_kernel", flush=flush),
                     host_us=host_us(aes), source="src/repro_torch/csrc/aes_ctr.cu",
                     replaces="src/repro/kernels/aes_ctr/kernel.py:70",
                     launches=counts["aes_ctr"], max_abs_err=errs["aes_ctr"], ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     bound_note=(f"; {AES_LOOKUPS_PER_BLOCK} shared-memory lookups a block at "
                                 f"{SMEM_LOOKUPS_PER_CLOCK} a clock on {sms} SMs at "
                                 f"{clock / 1e6:.0f} MHz"),
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


def lm_round_view(device, rounds=5):
    """One ``FederatedTrainer`` round of [4m] (4 clients, the driver's
    first batch, enfed with client 2 left out) for each preset with remat on
    and off: its untraced wall (the mean of ``rounds``, after 2 warm-up
    rounds), and under ``torch.profiler`` the device-busy time, the device
    operations (kernels and copies) and the aten op events of one round."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import AggregationStrategy, FederatedTrainer
    from repro_torch.data import synthetic_token_batches
    from repro_torch.launch.steps import lm_loss
    from repro_torch.models import Transformer

    for name, base in lm_train_presets().items():
        flat = next(synthetic_token_batches(base.vocab_size, LM_BATCH, LM_SEQ, 1, seed=2))
        batches = {k: torch.from_numpy(v.reshape(LM_CLIENTS, 1, LM_BATCH // LM_CLIENTS, LM_SEQ))
                   .long().to(device) for k, v in flat.items()}
        for remat in (True, False):
            model = Transformer(base.replace(remat=remat), device=device)
            tr = FederatedTrainer(lambda p, b: lm_loss(model, p, b), LM_CLIENTS,
                                  AggregationStrategy(kind="enfed", neighborhood_size=2), lr=LM_LR)
            state = tr.init(model.init(torch.Generator().manual_seed(0)))
            for _ in range(2):
                state = tr.round(*state, batches, LM_ENFED_MASK)[:2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(rounds):
                state = tr.round(*state, batches, LM_ENFED_MASK)[:2]
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / rounds
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tr.round(*state, batches, LM_ENFED_MASK)
                torch.cuda.synchronize()
            events = prof.key_averages()
            kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0]
            busy = sum(e.self_device_time_total for e in kern) * 1e-3
            aten = sum(e.count for e in events if e.key.startswith("aten::"))
            print(f"  one LM training round, {name}, remat {'on' if remat else 'off'}: "
                  f"wall {wall * 1e3:.2f} ms untraced ({LM_BATCH * LM_SEQ / wall:.1f} "
                  f"tokens/s); device busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f} % "
                  f"of the untraced wall); {sum(e.count for e in kern)} device operations, "
                  f"{aten} aten op events")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))       # benchmarks/: the paper tables' harness
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
    watch(task.model)
    # the harness's four worlds (benchmarks/_torch_harness.py), on the card
    scenarios = {f"{ds}/{kind}": harness().build_scenario(ds, kind, device=dev)
                 for ds, kind in TABLE_WORLDS}
    for sc in scenarios.values():
        watch(sc.task.model)
    cfg = task.model.cfg
    f, h, n_contrib = cfg.input_dim, cfg.hidden, 5
    n_params = tree_size(task.init(0))
    fit_b, score_b = min(32, len(own_train[0])), len(own_test[0])
    lp = n_params + (-n_params) % TILE
    print("[3] kernels against their plain versions on the card")
    # the calories/MLP world of [4e]: its eq. 14 and AES shapes are checked here
    mlp_params = tree_size(scenarios["calories/mlp"].task.init(0))
    errs = {}
    errs["fedavg"], errs["fedavg_batched"] = check_fedavg(
        dev, (1, n_contrib, n_params), (FLEET_R, n_contrib, n_params), mlp_params)
    errs.update(fedavg_q8=check_fedavg_q8(dev, (FLEET_R, n_contrib, lp)),
                quantize=check_quantize(dev, n_params, FLEET_R * n_contrib),
                dequantize=check_dequantize(dev, n_params),
                lstm_cell=check_lstm(dev, fit_b, score_b, f, h),
                aes_ctr=check_aes(dev, 4 * n_params, lp + 4 * (lp // TILE), 4 * mlp_params,
                                  {name: 4 * tree_size(sc.task.init(0))
                                   for name, sc in scenarios.items()}))
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
    print("  the paper-table twins' shapes (benchmarks/_torch_harness.py)")
    table = check_table_shapes(dev, scenarios)
    for k in ("lstm_cell", "lstm_cell_bwd"):
        errs[k] = max(errs[k], table[k])
    print("  the mobility world's shapes (member weights, 320 refresh rows)")
    for k, v in check_churn_shapes(dev, spec, n_params, fit_b, cfg.seq_len).items():
        errs[k] = max(errs[k], v)
    print("  the fault world's shapes (decayed and zero weights, stale rows)")
    for k, v in check_fault_shapes(dev, n_params).items():
        errs[k] = max(errs[k], v)
    print("  the cadence world's shapes (weights decayed by image lag)")
    for k, v in check_cadence_shapes(dev, n_params).items():
        errs[k] = max(errs[k], v)

    from repro_torch.core import CostModel

    cost = CostModel()        # the one cost model of every report compared in [4e]
    print("[4] main paths at full width on the card")
    print(" [4a] the quickstart session (loop engine, fp32 wire)")
    loop_counts, pretrained, enfed_report = run_main_path(dev, world, cost)
    print(" [4b] the quickstart session with the int8 wire")
    int8_counts = run_loop_int8(dev, world, pretrained)
    print(f" [4c] the fleet engine, {FLEET_R} requesters")
    fleet_counts, limits, fleet_fp32 = run_fleet_path(dev, world, pretrained)
    print(f" [4d] the Byzantine world ({ADVERSARY}), {ADV_ROUNDS} rounds")
    adv_loop = run_loop_adversary(dev, world, pretrained)
    adv_fleet = run_fleet_adversary(dev, world, pretrained)
    fleet_adversary_round_check(dev, world, pretrained, limits)
    print(f"    {time.perf_counter() - t_start:.1f} s so far")
    print(" [4e] the paper's baselines (CFL, DFL mesh and ring, cloud-only), LSTM and MLP")
    t_base = time.perf_counter()
    base_loop, base_fleet = run_baselines(dev, world, scenarios, enfed_report, cost)
    print(f"  [4e] wall {time.perf_counter() - t_base:.1f} s")
    print(" [4f] the repro_torch.api facade (both engines, every method), "
          f"{FACADE_KNOBS['max_rounds']} rounds of {FACADE_KNOBS['epochs']} epochs")
    t_facade = time.perf_counter()
    facade_loop, facade_fleet = run_facade(dev, world, pretrained, cost)
    print(f"  [4f] wall {time.perf_counter() - t_facade:.1f} s")
    print(" [4g] the paper-table twins (benchmarks/_torch_harness.py), "
          f"{TABLE_ROUNDS} round of {TABLE_CUT['epochs']} epoch")
    t_tables = time.perf_counter()
    table_loop = run_tables(dev, scenarios)
    print(f"  [4g] wall {time.perf_counter() - t_tables:.1f} s")
    print(f" [4h] the mobility world ({CHURN}, n_max={CHURN_N_MAX}), both engines")
    t_mob = time.perf_counter()
    mob_loop, mob_fleet = run_mobility(dev, world, pretrained)
    print(f"  [4h] wall {time.perf_counter() - t_mob:.1f} s")
    print(f" [4i] the unreliable-link world ({FAULTS}), both engines")
    t_flt = time.perf_counter()
    flt_loop, flt_fleet = run_faults(dev, world, pretrained, limits)
    print(f"  [4i] wall {time.perf_counter() - t_flt:.1f} s")
    print(f" [4j] the asynchronous-cadence world ({CADENCE}), both engines")
    t_cad = time.perf_counter()
    cad_loop, cad_fleet = run_cadence(dev, world, pretrained, limits)
    print(f"  [4j] wall {time.perf_counter() - t_cad:.1f} s")
    print(f" [4k] the profiler hooks: [4c]'s fp32 fleet under TraceConfig(jax_profiler_dir="
          f"{PROFILE_DIR.relative_to(ROOT)}, hlo_stats=True)")
    t_prof = time.perf_counter()
    prof_counts = run_profiler_hooks(dev, world, pretrained, fleet_fp32)
    print(f"  [4k] wall {time.perf_counter() - t_prof:.1f} s")
    print(" [4l] the LM zoo's serving path (repro_torch.launch.serve, every CPU-test variant)")
    t_lm = time.perf_counter()
    run_lm_zoo(dev)
    print(f"  [4l] wall {time.perf_counter() - t_lm:.1f} s")
    print(f" [4m] the LM zoo's training (repro_torch.launch.train, {LM_TRAIN_STEPS} steps and "
          "a resume; one round of every strategy card vs CPU; remat on vs off)")
    t_train = time.perf_counter()
    run_lm_training(dev)
    print(f"  [4m] wall {time.perf_counter() - t_train:.1f} s")
    print(f" [4n] the mesh runtime: {MESH_RANKS} ranks on the card as make_debug_mesh("
          "multi_pod=True), over gloo, against the same ranks on the CPU")
    t_mesh = time.perf_counter()
    run_mesh(dev)
    print(f"  [4n] wall {time.perf_counter() - t_mesh:.1f} s")
    loop_paths = [loop_counts, int8_counts, *adv_loop.values(), *base_loop, *facade_loop,
                  *table_loop, *mob_loop, *flt_loop, *cad_loop]
    fleet_paths = [fleet_counts["fp32"], fleet_counts["int8"], *adv_fleet.values(), *base_fleet,
                   *facade_fleet, *mob_fleet, *flt_fleet, *cad_fleet, prof_counts]
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
    launch_path_breakdown(dev, n_params, n_contrib)
    print(f"    {time.perf_counter() - t_start:.1f} s so far")

    print("[6] where the time goes (torch.profiler)")
    fit_device_view(task, own_train)
    fleet_device_view(dev, world, pretrained)
    lm_round_view(dev)
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
