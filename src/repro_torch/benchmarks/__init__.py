"""Counterparts of the reference's paper-table benchmarks
(``benchmarks/table3_comm_cost.py``, ``benchmarks/table4_server_flops.py``),
run as ``python -m repro_torch.benchmarks.<name>``."""
from typing import Dict, List


def emit(rows: List[Dict]) -> None:
    """Print rows as the reference's benchmarks do: name,us_per_call,derived."""
    for r in rows:
        print(f"{r['name']},{r.get('us_per_call', '')},{r.get('derived', '')}")
