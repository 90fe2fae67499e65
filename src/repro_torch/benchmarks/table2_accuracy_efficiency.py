"""Table 2 analogue: accuracy vs communication efficiency for all five
methods, homogeneous and heterogeneous client ranks, on the synthetic
federated instruction task (the offline stand-in for MMLU×{Dolly,Alpaca,
Wizard}).  Port of ``benchmarks/table2_accuracy_efficiency.py``; the same
rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_accuracy_efficiency [--device cpu]

Claim validated: FLoRIST matches-or-beats baseline accuracy at the best
communication efficiency (lowest download rank).  ``run`` takes the arms
(``False``: homogeneous rank 8, ``True``: the heterogeneous rank mix,
FedIT and FFA zero-padded) and passes its other keywords to
:func:`~repro_torch.benchmarks.common.bench_fed`.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import bench_fed, emit, main_device

METHODS = ("florist", "fedit", "ffa", "flora", "flexlora")
ARMS = (False, True)


def run(arms=ARMS, **bench):
    rows = []
    for heter in arms:
        tag = "heter" if heter else "homo"
        results = {}
        for method in METHODS:
            hist, tr = bench_fed(method, heterogeneous=heter, **bench)
            eff = 1.0 / max(1.0, hist[-1].download_rank)
            results[method] = (hist[-1].eval_acc, eff, hist[-1].eval_loss)
            rows.append({
                "name": f"table2/{tag}/{method}",
                "us_per_call": f"{hist[-1].eval_loss:.4f}",
                "derived": f"acc={hist[-1].eval_acc:.3f};eff={eff:.2e};"
                           f"down_rank={hist[-1].download_rank:.0f}",
            })
        # paper claim: florist most download-efficient
        effs = {m: r[1] for m, r in results.items()}
        best = max(effs, key=effs.get)
        rows.append({"name": f"table2/{tag}/most_efficient",
                     "us_per_call": "",
                     "derived": f"{best};florist_wins={best == 'florist'}"})
    return rows


if __name__ == "__main__":
    emit(run(device=main_device()))
