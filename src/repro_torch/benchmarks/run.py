"""Benchmark harness: one module per paper table/figure.  Prints
``name,us_per_call,derived`` CSV.  Port of the reference's
``benchmarks/run.py``: the same modules in the same order.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--only table3,fig5] [--fast] [--device cpu]

``kernels`` is :mod:`repro_torch.benchmarks.kernel_bench` (the kernels
through ``ops`` beside their plain versions, the dense / streamed / kernel
decode routes, and the serve step's live-memory check).  An unknown
``--only`` tag raises ``ValueError``.  The reference's closing roofline
table, read from its XLA dry-run records, has no counterpart (``ROADMAP.md``
Queue 1 item 10).
``agg_bench`` stays a script of its own, as in the reference.  Every
module runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import time
import traceback

MODULES = [
    ("table3", "repro_torch.benchmarks.table3_comm_cost"),
    ("table4", "repro_torch.benchmarks.table4_server_flops"),
    ("fig2", "repro_torch.benchmarks.fig2_spectrum"),
    ("fig5", "repro_torch.benchmarks.fig5_rank_vs_tau"),
    ("fig6", "repro_torch.benchmarks.fig6_layerwise_rank"),
    ("kernels", "repro_torch.benchmarks.kernel_bench"),
    ("table2", "repro_torch.benchmarks.table2_accuracy_efficiency"),
    ("fig7", "repro_torch.benchmarks.fig7_tau_vs_quality"),
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    if args.fast:
        os.environ["BENCH_FAST"] = "1"
    only = set(args.only.split(",")) if args.only else None
    unknown = sorted((only or set()) - {tag for tag, _ in MODULES})
    if unknown:
        raise ValueError(f"unknown --only {unknown}; the modules are "
                         f"{[tag for tag, _ in MODULES]}")

    print("name,us_per_call,derived")
    failures = []
    for tag, modname in MODULES:
        if only and tag not in only:
            continue
        t0 = time.time()
        try:
            mod = importlib.import_module(modname)
            rows = mod.run(device=args.device)
            for r in rows:
                print(f"{r['name']},{r.get('us_per_call', '')},{r.get('derived', '')}")
            print(f"#{tag} done in {time.time()-t0:.1f}s", file=sys.stderr)
        except Exception:
            failures.append(tag)
            traceback.print_exc()
    if failures:
        print(f"FAILED benchmarks: {failures}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
