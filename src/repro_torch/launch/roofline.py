"""Roofline analysis of the dry run's records (port of
``benchmarks/roofline.py``; it lives in the package because the port's
benchmark scripts come later).

Per (arch x shape x mesh), against the NVIDIA H100 SXM's datasheet peaks
(the card the port runs on: NVIDIA H100 80GB HBM3, power limit 700.00 W):
  compute term    = flops/device           / 67e12  FLOP/s  (fp32: the port
                                                      runs with TF32 off)
  memory term     = bytes_accessed/device  / 3.35e12 B/s   (HBM3)
  collective term = collective_bytes/device x algo-factor / 450e9 B/s
                                                      (NVLink 4, per direction)
plus the dominant bottleneck, MODEL_FLOPS = 6·N·D (train) / 2·N_active·D
(inference), and the MODEL_FLOPS / flops utilization ratio.

The dry run's ``bytes_accessed`` is an unfused upper bound (every aten
op's inputs and outputs), so the memory term is one too.  Its flops are
rank 0's: of its blocks (train and prefill, split over ``model`` where the
layers allow it, a leaf gathered whole where they do not) or of the whole
params (decode), so the utilization ratio reads against that.

Collective algo factor: all-reduce counts 2x its payload (ring
reduce-scatter + all-gather); the others count 1x.
"""

from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import INPUT_SHAPES, get_config

PEAK_FLOPS = 67e12       # fp32 FLOP/s, H100 SXM datasheet
HBM_BW = 3.35e12         # B/s, H100 SXM HBM3 datasheet
NVLINK_BW = 450e9        # B/s per direction, NVLink 4 (H100 SXM datasheet)
DEVICE = "NVIDIA H100 80GB HBM3, 700.00 W"

RESULTS_DIR = os.environ.get("DRYRUN_DIR", "results/dryrun")


def params_count(cfg) -> int:
    """Analytic parameter count from the config."""
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    dh = cfg.resolved_head_dim
    total = V * D * (1 if cfg.tie_embeddings else 2)
    for i in range(L):
        bt = cfg.block_type(i)
        if bt in ("attn", "swa", "local"):
            total += D * dh * (cfg.num_heads + 2 * cfg.num_kv_heads) + cfg.num_heads * dh * D
        elif bt == "mla":
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            total += (D * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk
                      + D * m.kv_lora_rank + D * m.qk_rope_head_dim
                      + m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                      + cfg.num_heads * m.v_head_dim * D)
        elif bt == "rglru":
            W = cfg.rnn_width or D
            total += 2 * D * W + 2 * W * W + W * D + cfg.conv_width * W
        elif bt in ("mlstm", "slstm"):
            di = int(D * cfg.mlstm_proj_factor)
            if bt == "mlstm":
                total += D * 2 * di + 3 * di * di + di * D
            else:
                total += D * di + 4 * di * di + di * D
        if cfg.moe is not None:
            dff = cfg.moe.d_ff_expert or cfg.d_ff
            total += cfg.moe.num_experts * 3 * D * dff + D * cfg.moe.num_experts
            total += cfg.moe.num_shared_experts * 3 * D * dff
        elif cfg.d_ff > 0:
            total += 3 * D * cfg.d_ff
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (D * dh * (cfg.num_heads + 2 * cfg.num_kv_heads)
                                       + cfg.num_heads * dh * D + 3 * D * cfg.d_ff)
        total += L * (D * dh * (cfg.num_heads + 2 * cfg.num_kv_heads))  # cross-attn
    return int(total)


def active_params_count(cfg) -> int:
    if cfg.moe is None:
        return params_count(cfg)
    full = params_count(cfg)
    dff = cfg.moe.d_ff_expert or cfg.d_ff
    all_experts = cfg.num_layers * cfg.moe.num_experts * 3 * cfg.d_model * dff
    active = cfg.num_layers * cfg.moe.num_experts_per_tok * 3 * cfg.d_model * dff
    return int(full - all_experts + active)


def model_flops(cfg, shape_name: str, n_devices: int) -> float:
    """Per-device useful model FLOPs for the step."""
    shp = INPUT_SHAPES[shape_name]
    B, S = shp["global_batch"], shp["seq_len"]
    n_active = active_params_count(cfg)
    if shp["kind"] == "train":
        tokens = B * S
        return 6.0 * n_active * tokens / n_devices
    if shp["kind"] == "prefill":
        tokens = B * S
        return 2.0 * n_active * tokens / n_devices
    # decode: one token per sequence
    return 2.0 * n_active * B / n_devices


def scan_correction(cfg) -> float:
    """1: the reference multiplies XLA's flops by the layer count over the
    layers its cost analysis counts once per ``lax.scan`` body; the port's
    counter runs every layer, so its counts need no correction."""
    return 1.0


def analyze(rec: dict) -> dict:
    cfg = get_config(rec["arch"])
    n_dev = rec.get("n_devices", 256)
    corr = scan_correction(cfg)
    flops = rec.get("flops", 0.0) * corr
    t_compute = flops / PEAK_FLOPS
    t_memory = rec.get("bytes_accessed", 0.0) * corr / HBM_BW
    ar = rec.get("all-reduce_bytes", 0.0)
    coll = rec.get("total_collective_bytes", 0.0)
    t_coll = (coll + ar) / NVLINK_BW  # all-reduce counted twice (ring algo)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, rec["shape"], n_dev)
    has_time_scan = any(t in ("mlstm", "slstm") for t in cfg.block_pattern)
    return {
        **{f"t_{k}_s": v for k, v in terms.items()},
        "bottleneck": bottleneck,
        "scan_corr": corr,
        "model_flops_per_dev": mf,
        "useful_flops_ratio": (mf / flops) if flops else 0.0,
        "step_time_lb_s": max(terms.values()),
        "time_scan_undercount": has_time_scan,
    }


def load_records(pattern: str = "*.json", results_dir: str = None):
    recs = []
    for f in sorted(glob.glob(os.path.join(results_dir or RESULTS_DIR, pattern))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("status") == "ok":
            r["file"] = os.path.basename(f)
            recs.append(r)
    return recs


def run(verbose: bool = True, results_dir: str = None):
    rows = []
    recs = load_records(results_dir=results_dir)
    if verbose:
        print(f"roofline against {DEVICE} datasheet peaks")
        print(f"{'arch':<24}{'shape':<13}{'mesh':<6}{'strat':<9}"
              f"{'compute_s':>10}{'memory_s':>10}{'coll_s':>9} {'bound':<11}{'useful%':>8}")
    for r in recs:
        a = analyze(r)
        mesh = "pod2" if r["multi_pod"] else "pod1"
        tag = f"roofline/{r['arch']}/{r['shape']}/{mesh}/{r.get('strategy', 'cfl')}"
        if r.get("mla_absorbed"):
            tag += "/absorbed"
        rows.append((tag, a["step_time_lb_s"],
                     f"{a['bottleneck']},useful={100 * a['useful_flops_ratio']:.0f}%"))
        if verbose:
            print(f"{r['arch']:<24}{r['shape']:<13}{mesh:<6}{r.get('strategy', 'cfl'):<9}"
                  f"{a['t_compute_s']:>10.4f}{a['t_memory_s']:>10.4f}{a['t_collective_s']:>9.4f}"
                  f" {a['bottleneck']:<11}{100 * a['useful_flops_ratio']:>7.1f}%")
    return rows


if __name__ == "__main__":
    run()
