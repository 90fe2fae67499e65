"""Figure 5: total global-adapter rank (across layers) vs threshold τ —
lower τ → aggressive rank compression → higher download efficiency.  Port
of ``benchmarks/fig5_rank_vs_tau.py``; the same rows (homogeneous rank 8,
two rounds a τ); ``run`` passes its keywords to :func:`bench_fed`.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig5_rank_vs_tau [--device cpu]
"""
from __future__ import annotations

from repro_torch.benchmarks.common import bench_fed, emit, main_device

TAUS = (0.7, 0.8, 0.9, 0.95, 0.99)


def run(**bench):
    rows = []
    prev = None
    monotone = True
    for tau in TAUS:
        hist, tr = bench_fed("florist", tau=tau, rounds=2, **bench)
        total = hist[-1].global_rank_total
        if prev is not None and total + 1e-9 < prev:
            monotone = False
        rows.append({"name": f"fig5/tau={tau}", "us_per_call": "",
                     "derived": f"total_rank={total};eff={1.0/max(total,1):.2e}"})
        prev = total
    rows.append({"name": "fig5/monotone_nondecreasing", "us_per_call": "",
                 "derived": str(monotone)})
    return rows


if __name__ == "__main__":
    emit(run(device=main_device()))
