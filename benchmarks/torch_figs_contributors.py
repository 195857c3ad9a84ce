"""Paper Figs 4-7: accuracy / training time / energy vs number of
contributors (2..5), plus the local-model loss trajectory.

The twin of ``benchmarks/figs_contributors.py``, run by repro_torch.
"""

from __future__ import annotations

from benchmarks._torch_harness import build_scenario, run_enfed


def run(verbose: bool = True):
    rows = []
    for ds_id, dataset in (("Dataset1", "calories"), ("Dataset2", "har")):
        sc = build_scenario(dataset, "lstm")
        for n_c in (2, 3, 4, 5):
            res = run_enfed(sc, n_contrib=n_c)
            rows.append((f"figs4-6/{ds_id}/contrib{n_c}", res.accuracy,
                         res.report.t_train, res.report.e_tot))
            if verbose:
                print(f"[figs4-6/{ds_id}] N_c={n_c}: acc={res.accuracy:.3f} "
                      f"T={res.report.t_train:.2f}s E={res.report.e_tot:.1f}J "
                      f"rounds={res.rounds}")
        # Fig 7: loss trajectory with 5 contributors
        res = run_enfed(sc, n_contrib=5)
        losses = ", ".join(f"{l:.3f}" for l in res.history_raw["loss"])
        if verbose:
            print(f"[fig7/{ds_id}] local-model loss per round: [{losses}]")
        rows.append((f"fig7/{ds_id}/final_loss", res.history_raw["loss"][-1],
                     res.report.t_train, res.report.e_tot))
    return rows


if __name__ == "__main__":
    run()
