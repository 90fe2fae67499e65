"""Table 3: per-round communication cost (MB, FP16) on TinyLlama geometry
(22 layers, q/v projections, rank 16, 10 sampled clients) — exact analytic
parameter counts, plus the Full-FT reference.  Port of
``benchmarks/table3_comm_cost.py``; the same rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.table3_comm_cost [--device cpu]

The paper's claims it shows: download(FLoRIST) ≪ download(FLoRA) (paper:
~70×) and ≪ Full FT (paper: ~400×); upload equal for all two-adapter
methods.  Each analytic figure is held to the bytes the ``bf16`` codec
(the paper's 2-byte accounting) serializes for the same trees: the
``wire_matches_analytic`` flag must be True for every method.  The
aggregators run on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks import emit
from repro_torch.configs import get_config
from repro_torch.core import costs as C
from repro_torch.core.aggregators import leaf_dims, make_aggregator
from repro_torch.device import DeviceLike, resolve_device

L, D, R, K = 22, 2048, 16, 10       # TinyLlama: layers, d_model, rank, clients


def _client_tree(r: int, device: torch.device):
    def leaf():
        return {"A": torch.zeros(L, r, D, device=device),
                "B": torch.zeros(L, D, r, device=device),
                "scale": torch.ones(L, device=device)}
    return {"blocks": {0: {"attn": {"wq": leaf(), "wv": leaf()}}}}


def run(florist_p: int = 7, device: DeviceLike = None):
    """florist_p: the per-layer kept rank (the paper's τ=0.9 implies ~7 on
    average on TinyLlama-Wizard: 5.15 MB / (2 proj · 22 L · 2·2048 · 2 B))."""
    dev = resolve_device(device)
    cfg = get_config("tinyllama-1.1b")
    full_ft_mb = C.mb(cfg.param_count())
    trees = [_client_tree(R, dev) for _ in range(K)]
    w = [1.0 / K] * K
    dims = leaf_dims(trees[0])

    rows = [{"name": "table3/full_ft", "us_per_call": "",
             "derived": f"upload_mb={full_ft_mb:.2f};download_mb={full_ft_mb:.2f}"}]
    out = {}
    for method, cfg_kw in [("fedit", {}), ("flora", {}),
                           ("flexlora", {}),
                           ("ffa", dict(A_init=trees[0])),
                           ("florist", dict(tau=1.0, max_rank=florist_p))]:
        # streaming server lifecycle: one client in memory at a time
        strat = make_aggregator(method, **cfg_kw)
        strat.begin_round(dims)
        for tree, wk in zip(trees, w):
            strat.add_client(tree, wk, rank=R)
        agg = strat.finalize()
        up = C.mb(strat.round_upload_params) / K               # per client
        down = C.mb(strat.download_params(agg, dims, 1, [R] * K))
        # measured wire bytes (bf16 = 2 B/param) against the analytic FP16
        # accounting of the same trees; flexlora's per-client wire sum
        # equals its analytic K-tree total
        wire_up = C.wire_mb(C.wire_upload_bytes(method, trees)) / K
        wire_down = C.wire_mb(C.wire_download_bytes(method, agg, 1))
        wire_ok = (abs(wire_up - up) < 1e-9 and abs(wire_down - down) < 1e-9)
        if not wire_ok:
            raise AssertionError((method, wire_up, up, wire_down, down))
        out[method] = down
        rows.append({"name": f"table3/{method}", "us_per_call": "",
                     "derived": (f"upload_mb={up:.2f};download_mb={down:.2f};"
                                 f"wire_matches_analytic={wire_ok}")})
    rows.append({
        "name": "table3/ratios", "us_per_call": "",
        "derived": (f"flora_over_florist={out['flora']/out['florist']:.1f}x;"
                    f"fullft_over_florist={full_ft_mb/out['florist']:.1f}x"),
    })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    emit(run(device=ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
