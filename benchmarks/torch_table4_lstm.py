"""Paper Table IV: EnFed vs DFL vs CFL — LSTM, both datasets.

Reports accuracy, training time (eq. 4), and requester energy (eqs. 5-7)
and the relative reductions the paper claims (EnFed ~59%/19% lower
time&energy than DFL on datasets 1/2; ~85%/27% lower than CFL).

The twin of ``benchmarks/table4_lstm.py``, run by repro_torch.
"""

from __future__ import annotations

from benchmarks._torch_harness import build_scenario, run_cfl, run_dfl, run_enfed


def run(verbose: bool = True):
    rows = []
    for ds_id, dataset in (("Dataset1", "calories"), ("Dataset2", "har")):
        sc = build_scenario(dataset, "lstm")
        enfed = run_enfed(sc)
        cfl = run_cfl(sc)
        dfl_m = run_dfl(sc, "mesh")
        dfl_r = run_dfl(sc, "ring")
        dfl_t = (dfl_m.report.t_train + dfl_r.report.t_train) / 2
        dfl_e = (dfl_m.report.e_tot + dfl_r.report.e_tot) / 2
        dfl_acc = (dfl_m.accuracy + dfl_r.accuracy) / 2
        rows += [
            (f"table4/{ds_id}/EnFed", enfed.accuracy, enfed.report.t_train, enfed.report.e_tot),
            (f"table4/{ds_id}/DFL", dfl_acc, dfl_t, dfl_e),
            (f"table4/{ds_id}/CFL", cfl.accuracy, cfl.report.t_train, cfl.report.e_tot),
        ]
        if verbose:
            rt_d = 100 * (1 - enfed.report.t_train / dfl_t)
            re_d = 100 * (1 - enfed.report.e_tot / dfl_e)
            rt_c = 100 * (1 - enfed.report.t_train / cfl.report.t_train)
            re_c = 100 * (1 - enfed.report.e_tot / cfl.report.e_tot)
            print(f"[table4/{ds_id}] EnFed acc={enfed.accuracy:.3f} "
                  f"T={enfed.report.t_train:.2f}s E={enfed.report.e_tot:.1f}J | "
                  f"vs DFL: -{rt_d:.0f}% time, -{re_d:.0f}% energy | "
                  f"vs CFL: -{rt_c:.0f}% time, -{re_c:.0f}% energy")
    return rows


if __name__ == "__main__":
    run()
