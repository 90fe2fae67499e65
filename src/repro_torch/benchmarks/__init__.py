"""Counterparts of the reference's paper-table and figure benchmarks
(``benchmarks/table2_accuracy_efficiency.py`` … ``fig7_tau_vs_quality.py``,
``agg_bench.py``, ``run.py``), run as ``python -m
repro_torch.benchmarks.<name>``; their shared settings are in
:mod:`repro_torch.benchmarks.common`."""
from typing import Dict, List


def emit(rows: List[Dict]) -> None:
    """Print rows as the reference's benchmarks do: name,us_per_call,derived."""
    for r in rows:
        print(f"{r['name']},{r.get('us_per_call', '')},{r.get('derived', '')}")
