"""Figure 7: energy threshold τ vs model quality — the SVT-regularization
curve (quality peaks below τ=1, degrades when τ is too aggressive).  Port
of ``benchmarks/fig7_tau_vs_quality.py``; the same rows, τ ``"auto"``
included; ``run`` passes its keywords to :func:`bench_fed`.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig7_tau_vs_quality [--device cpu]
"""
from __future__ import annotations

from repro_torch.benchmarks.common import FAST, bench_fed, emit, main_device

TAUS = (0.6, 0.8, 0.9, 0.99, "auto")


def run(**bench):
    rows = []
    accs = {}
    for tau in TAUS:
        # "auto" = beyond-paper knee-point rank selection (paper §5 future
        # work (i)) — no tunable threshold at all
        hist, _ = bench_fed("florist", tau=tau,
                            rounds=3 if FAST else 8, **bench)
        accs[tau] = hist[-1].eval_acc
        rows.append({"name": f"fig7/tau={tau}",
                     "us_per_call": f"{hist[-1].eval_loss:.4f}",
                     "derived": f"acc={hist[-1].eval_acc:.3f};"
                               f"rank={hist[-1].global_rank_total}"})
    best = max(accs, key=accs.get)
    rows.append({"name": "fig7/best_tau", "us_per_call": "",
                 "derived": f"{best}"})
    return rows


if __name__ == "__main__":
    emit(run(device=main_device()))
