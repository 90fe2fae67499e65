"""Figure 6: layer-wise optimal rank per projection (q_proj vs v_proj) in a
heterogeneous round — intrinsic dimensionality varies across depth and
across projections.  Port of ``benchmarks/fig6_layerwise_rank.py``; the
same rows.  It makes the same :func:`bench_fed` call as Table 2's
heterogeneous FLoRIST row at ``rounds=2``; ``run`` passes its keywords on.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig6_layerwise_rank [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import bench_fed, emit, main_device


def run(**bench):
    hist, tr = bench_fed("florist", heterogeneous=True, tau=0.9, rounds=2,
                         **bench)
    agg = tr.global_state
    rows = []
    per_proj = {}
    for path, ranks in agg.ranks.items():
        proj = path[-1]
        per_proj[proj] = ranks
        rows.append({"name": f"fig6/{proj}", "us_per_call": "",
                     "derived": "ranks=" + "|".join(map(str, ranks))})
    if "wq" in per_proj and "wv" in per_proj:
        rows.append({
            "name": "fig6/summary", "us_per_call": "",
            "derived": (f"mean_q={np.mean(per_proj['wq']):.1f};"
                        f"mean_v={np.mean(per_proj['wv']):.1f};"
                        f"varies_across_layers="
                        f"{len(set(per_proj['wq'])) > 1 or len(set(per_proj['wv'])) > 1}"),
        })
    return rows


if __name__ == "__main__":
    emit(run(device=main_device()))
