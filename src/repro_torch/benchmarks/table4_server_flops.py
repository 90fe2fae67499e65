"""Table 4: server-side computational cost per aggregation method at
TinyLlama shapes (m = n = 2048, K = 10 clients, rank 16 → stacked r = 160).
Port of ``benchmarks/table4_server_flops.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.table4_server_flops [--device cpu]

Two parts:
  * the analytic FLOPs of each method's finalize (mult-add = 2 FLOPs), the
    reference's rows (22 layers × q/v, FLoRIST keeping rank 7 a layer);
  * in place of XLA's ``cost_analysis``, the elapsed time between two CUDA
    events around each call (median of ``REPS``) of FLoRIST's core
    (stacked thin SVDs + the r×r core SVD) and of FlexLoRA's dense ΔW plus
    its SVD, for one 2048×2048 layer, with that layer's analytic FLOPs
    beside each.  The calls' own host syncs and host-side solver work fall
    between the events, so this is elapsed time, not device busy time.  On
    the CPU the times are "not measured": they come from the card only.

The paper's claim is FLoRIST ≪ FlexLoRA in server cost (7.5×; 466.95M vs
3516.01M FLOPs); these rows print the ratios and claim nothing.
"""
from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from repro_torch.benchmarks import emit
from repro_torch.core.costs import server_flops
from repro_torch.core.svd import florist_core_padded, thin_svd
from repro_torch.device import DeviceLike, resolve_device

M = N = 2048
K, R = 10, 16
REPS = 5


def florist(bs: torch.Tensor, as_: torch.Tensor):
    """FLoRIST's core on one layer's stacks (τ 0.9, LAPACK/cuSOLVER route)."""
    return florist_core_padded(bs, as_, tau=0.9)


def flexlora(bs: torch.Tensor, as_: torch.Tensor):
    """FlexLoRA on one layer: form the dense ΔW, full SVD, cut at R."""
    u, s, vt = thin_svd(bs @ as_, "svd")
    return u[:, :R] * s[:R], vt[:R]


def elapsed_ms(fn, *args) -> list:
    """Elapsed time of each of ``REPS`` calls after one warm-up, between two
    CUDA events around each call (the calls' own host syncs fall inside)."""
    fn(*args)
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in times]


def run(device: DeviceLike = None):
    dev = resolve_device(device)
    r = K * R
    rng = np.random.default_rng(0)
    B_stack = torch.as_tensor(rng.normal(size=(M, r)), dtype=torch.float32,
                              device=dev)
    A_stack = torch.as_tensor(rng.normal(size=(r, N)), dtype=torch.float32,
                              device=dev)
    p = int(florist(B_stack, A_stack)[3])
    layer = {("layer",): (1, N, M)}
    rows = []
    measured = {}
    for name, fn, ranks in (("florist", florist, {("layer",): [p]}),
                            ("flexlora", flexlora, None)):
        flops = server_flops(name, layer, [R] * K, ranks)
        if dev.type == "cuda":
            ms = elapsed_ms(fn, B_stack, A_stack)
            measured[name] = statistics.median(ms)
            rows.append({"name": f"table4/{name}_measured",
                         "us_per_call": f"{measured[name] * 1e3:.0f}",
                         "derived": (f"elapsed_ms_median={measured[name]};"
                                     f"elapsed_ms={'/'.join(f'{t:.3f}' for t in ms)};"
                                     f"flops_analytic={flops:.3e}")})
        else:
            rows.append({"name": f"table4/{name}_measured",
                         "us_per_call": "not measured",
                         "derived": f"flops_analytic={flops:.3e}"})
    ratio = server_flops("flexlora", layer, [R] * K) / server_flops(
        "florist", layer, [R] * K, {("layer",): [p]})
    rows.append({"name": "table4/speedup",
                 "us_per_call": (f"{measured['flexlora'] / measured['florist']:.2f}"
                                 if measured else "not measured"),
                 "derived": f"flops_ratio_flex_over_florist={ratio:.2f};"
                            f"florist_kept_rank={p}"})

    # analytic table (full model: 2 projections x 22 layers)
    dims = {("blocks", 0, "attn", "wq"): (22, N, M),
            ("blocks", 0, "attn", "wv"): (22, N, M)}
    kept = {k: [7] * 22 for k in dims}
    for method in ("fedit", "ffa", "flora", "flexlora", "florist"):
        f = server_flops(method, dims, [R] * K, kept)
        rows.append({"name": f"table4/analytic/{method}", "us_per_call": "",
                     "derived": f"flops={f:.3e}"})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    dev = resolve_device(ap.parse_args(argv).device)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}")
    emit(run(device=dev))


if __name__ == "__main__":
    main()
