"""Per-round aggregation wall-clock: the per-layer loop against the
batched server pipeline, on both thin-SVD routes (``svd``: LAPACK on the
CPU, cuSOLVER on the card; ``gram``: the ``adapter_gram`` kernel on the
card).  Port of the reference's ``benchmarks/agg_bench.py``: the same data
(``make_clients`` from numpy ``default_rng(0)``), flags and report keys.

The loop pipeline runs one ``florist_core_stacked`` per (leaf, layer) with
a host sync each; the batched pipeline makes one call per bucket of
equal-shaped leaves and copies spectra and ranks to the host once.

Config: 3 leaves × L layers, heterogeneous client ranks (4/8/16).  Runs on
``cuda`` unless ``--device cpu``; prints the report (the reference's keys)
as its last line and writes it where ``--json`` says::

    PYTHONPATH=src python -m repro_torch.benchmarks.agg_bench --smoke --json agg.json [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from repro_torch.core.aggregators import make_aggregator
from repro_torch.device import DeviceLike, resolve_device

HETERO_RANKS = (4, 8, 16)
LEAVES = 3
TAU = 0.9
ROUTES = [(p, s) for p in ("loop", "batched") for s in ("svd", "gram")]


def make_clients(rng, *, layers: int, leaves: int, m: int, n: int):
    trees, weights = [], []
    for r in HETERO_RANKS:
        t = {}
        for i in range(leaves):
            t[f"leaf{i}"] = {
                "A": np.asarray(rng.normal(size=(layers, r, n)), np.float32),
                "B": np.asarray(rng.normal(size=(layers, m, r)), np.float32),
                "scale": np.ones((layers,), np.float32),
            }
        trees.append(t)
    weights = list(rng.dirichlet([1.0] * len(HETERO_RANKS)))
    return trees, weights


def arriving(trees, device: torch.device):
    """The trees as the server takes them off the wire: A and B numpy,
    ``scale`` a tensor on the server's device (it never travels)."""
    return [{name: {"A": leaf["A"], "B": leaf["B"],
                    "scale": torch.as_tensor(leaf["scale"], device=device)}
             for name, leaf in t.items()} for t in trees]


def time_round(agg, trees, weights, *, warmup: int, iters: int) -> float:
    """Median wall-clock (ms) of one full streaming round (add_client ×K +
    finalize, synchronized with the card at the end)."""

    def once():
        agg.begin_round()
        for t, w in zip(trees, weights):
            agg.add_client(t, w)
        res = agg.finalize()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return res

    for _ in range(warmup):
        once()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        once()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(statistics.median(ts))


def run(*, layers: int = 8, smoke: bool = False, iters: int = 0,
        device: DeviceLike = None, log=print) -> dict:
    """Time a round on each (pipeline, svd_method) route; the report."""
    dev = resolve_device(device)
    m, n = (64, 48) if smoke else (256, 192)
    iters = iters or (3 if smoke else 5)
    rng = np.random.default_rng(0)
    trees, weights = make_clients(rng, layers=layers, leaves=LEAVES, m=m, n=n)
    trees = arriving(trees, dev)

    results = []
    for pipeline, svd_method in ROUTES:
        agg = make_aggregator("florist", tau=TAU, svd_method=svd_method,
                              pipeline=pipeline)
        ms = time_round(agg, trees, weights, warmup=1, iters=iters)
        results.append({"pipeline": pipeline, "svd_method": svd_method,
                        "ms_per_round": round(ms, 3)})
        log(f"{pipeline:8s} {svd_method:5s} {ms:9.2f} ms/round")

    def best(pipeline):
        return min(r["ms_per_round"] for r in results
                   if r["pipeline"] == pipeline)

    speedup = best("loop") / best("batched")
    log(f"speedup (batched vs loop, best route): {speedup:.2f}x")
    return {
        "config": {"layers": layers, "leaves": LEAVES, "m": m, "n": n,
                   "client_ranks": list(HETERO_RANKS), "tau": TAU,
                   "iters": iters, "smoke": bool(smoke),
                   "backend": dev.type},
        "results": results,
        "speedup_batched_vs_loop": round(speedup, 2),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small config + few iters (CI)")
    ap.add_argument("--json", default="", help="write results to this path")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--iters", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    report = run(layers=args.layers or 8, smoke=args.smoke, iters=args.iters,
                 device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
