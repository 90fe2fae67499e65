"""Figure 2 analogue: singular-value spectrum of the aggregated update in a
heterogeneous round — demonstrates the low intrinsic dimensionality that
motivates thresholding (most energy within the first ~6-10 components even
when Σ r_k is large).  Port of ``benchmarks/fig2_spectrum.py``; the same
rows, with the port's own ``energy_rank``; ``run`` passes its keywords to
:func:`bench_fed`.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig2_spectrum [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import bench_fed, emit, main_device
from repro_torch.core.svd import energy_rank


def run(**bench):
    hist, tr = bench_fed("florist", heterogeneous=True, tau=1.0, rounds=1,
                         **bench)
    rows = []
    agg = tr.global_state
    eff_ranks = []
    stack_ranks = []
    for path, spectra in agg.spectra.items():
        for l, s in enumerate(spectra):
            p90 = energy_rank(torch.as_tensor(s), 0.90)
            p99 = energy_rank(torch.as_tensor(s), 0.99)
            eff_ranks.append(p90)
            stack_ranks.append(len(s))
            if l < 2:
                rows.append({
                    "name": f"fig2/{'/'.join(map(str, path))}/layer{l}",
                    "us_per_call": "",
                    "derived": f"p90={p90};p99={p99};stack_rank={len(s)};"
                               f"sigma1={s[0]:.3f};sigma_last={s[-1]:.2e}",
                })
    rows.append({
        "name": "fig2/summary", "us_per_call": "",
        "derived": (f"mean_p90={np.mean(eff_ranks):.1f};"
                    f"mean_stack_rank={np.mean(stack_ranks):.0f};"
                    f"compression={np.mean(stack_ranks)/max(np.mean(eff_ranks),1):.1f}x"),
    })
    return rows


if __name__ == "__main__":
    emit(run(device=main_device()))
