"""Paper Table VII + Figs 8-9: EnFed vs cloud-only (no FL).

Prediction accuracy comparison plus response time: the paper reports
EnFed's response ~89-95% faster than shipping raw data to the cloud.

The twin of ``benchmarks/table7_cloud.py``, run by repro_torch.
"""

from __future__ import annotations

from benchmarks._torch_harness import build_scenario, run_cloud, run_enfed


def run(verbose: bool = True):
    rows = []
    for ds_id, dataset in (("Dataset1", "calories"), ("Dataset2", "har")):
        for model_kind in ("lstm", "mlp"):
            sc = build_scenario(dataset, model_kind)
            enfed = run_enfed(sc)
            cloud_acc, cloud_resp, _ = run_cloud(sc)
            # EnFed response time = session training time (model is local;
            # inference is on-device and ~free vs the WAN round trip)
            saving = 100 * (1 - enfed.report.t_train / cloud_resp)
            rows += [
                (f"table7/{ds_id}/{model_kind}/EnFed", enfed.accuracy,
                 enfed.report.t_train, saving),
                (f"table7/{ds_id}/{model_kind}/cloud", float(cloud_acc),
                 cloud_resp, 0.0),
            ]
            if verbose:
                print(f"[table7/{ds_id}/{model_kind}] EnFed acc={enfed.accuracy:.3f} "
                      f"resp={enfed.report.t_train:.2f}s | cloud acc={cloud_acc:.3f} "
                      f"resp={cloud_resp:.2f}s | EnFed {saving:.0f}% faster")
    return rows


if __name__ == "__main__":
    run()
