#!/usr/bin/env python3
"""How far the card's SVD routes for FLoRIST and FlexLoRA are from an fp64
SVD, at TinyLlama-1.1B's leaf shapes, beside LAPACK on the CPU.

    python3 scripts/svd_accuracy.py [--device cuda] [--layers 22] [--parts 1,2,3]
                                    [--methods florist,flexlora]
                                    [--solve default:float64,gesvd:float32]
                                    [--variants default,gesvdj,gesvd,gesvda,"gesvd fp64","gesvdj fp64"]

Data: ``chip_smoke.parity_trees`` (4 clients of rank 16; wq 2048 -> 2048,
wv 2048 -> 256; 22 layers), both kinds: "known" (ΔW's spectrum 2048 ·
0.85^i, every cut on a 15% gap) and "gaussian" (i.i.d. standard normal
factors, cuts inside clusters).  The exact answer is
``chip_smoke.exact_svd``: ΔW's fp64 SVD through QR of the stacks.  All
float32 products with TF32 off.

Part 1, the finalizes: FLoRIST (τ 0.9, the ``svd`` and the ``gram``
route) and FlexLoRA on the device (a second, warm call timed) and on the
CPU, under each ``--solve`` setting of ``repro_torch.core.svd``'s
``CUDA_SVD_DRIVER`` ("default": PyTorch's) and ``CUDA_SOLVE_DTYPE``.  For each, the largest
distance of a product B·A (FlexLoRA's four per-client trees too) from the
fp64 product cut at the same rank, over max |ΔW|; the largest distance of
a spectrum from the fp64 one, over σ_1; and the card's distance from the
CPU's product.

Part 3 (printed before part 2), the Gram route's ``eigh``: each stack's
fp32 Gram (``ops.adapter_gram``) through batched ``eigh``, ``eigh`` a layer
at a time, ``svd`` (gesvd) of the Gram, batched ``eigh`` of the Gram cast
to fp64 (cast back) and ``eigh`` on the CPU, against
fp64 ``eigh`` of the same Gram: eigenvalues and |G V − V Λ| over λ_max.

Part 2, the dense SVD under FlexLoRA: ``torch.linalg.svd`` of each leaf's
fp32 ΔW stack (22, m, n) on the device with ``driver`` None (PyTorch's
default), "gesvdj", "gesvd" and "gesvda", and "gesvd" and "gesvdj" on the
stack cast to fp64 (the factors cast back to fp32): the elapsed time of one call on
the whole stack (after a warm-up call on one layer; ``synchronize`` on
both sides), the spectrum's distance from fp64 over σ_1, the products'
distance at full rank and cut at 16 over max |ΔW|, and whether the
default's bits equal each driver's (which driver the default is).

Prints the card's name and power limit first and a JSON line per case;
writes ``chiprun_out/svd_accuracy.json``.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.core import svd  # noqa: E402
from repro_torch.device import parity_mode  # noqa: E402

LEAVES = ("wq", "wv")
#: part 2's variants: (name, driver, dtype of the solve)
VARIANTS = (("default", None, torch.float32), ("gesvdj", "gesvdj", torch.float32),
            ("gesvd", "gesvd", torch.float32), ("gesvda", "gesvda", torch.float32),
            ("gesvd fp64", "gesvd", torch.float64),
            ("gesvdj fp64", "gesvdj", torch.float64))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def cut(layer_svd, p):
    u, s, v = layer_svd
    return (u[:, :p] * s[:p]) @ v[:, :p].T


def part1(kind, data, exact, dev, methods, solve):
    rows = []
    for label, method, kw in chip_smoke.PARITY_CASES:
        if method not in methods:
            continue
        got = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            res, secs = chip_smoke.parity_finalize(torch, method, kw, data, d)
            if side == "card":          # again, warm
                res, secs = chip_smoke.parity_finalize(torch, method, kw, data, d)
            err = chip_smoke.fp64_distance(torch, res, exact, method == "flexlora")
            sp_err = 0.0
            for p, sps in res.spectra.items():
                for l, sp in enumerate(sps):
                    s64 = exact[p[-1]][l][1]
                    sp = np.asarray(sp, np.float64)
                    full = np.zeros(max(len(sp), len(s64)))
                    full[:len(s64)] = s64
                    sp_err = max(sp_err, float(np.abs(sp - full[:len(sp)]).max()
                                               / s64[0]))
            got[side] = ([{k: v.cpu() for k, v in t.items()}
                          for t in chip_smoke.tree_products(torch, res)], res.ranks)
            rows.append({"data": kind, "case": label, "side": side, "solve": solve,
                         "ranks_equal_to_card": None if side == "card"
                         else res.ranks == got["card"][1],
                         "max_prod_err_vs_fp64_over_max_dw": err,
                         "max_spectrum_err_vs_fp64_over_s1": sp_err,
                         "secs": secs})
            del res
        between = 0.0
        for tc, tp in zip(got["card"][0], got["cpu"][0]):
            for k in tp:
                between = max(between, float((tc[k] - tp[k]).abs().max()
                                             / max(1.0, float(tp[k].abs().max()))))
        rows.append({"data": kind, "case": label, "side": "card vs cpu", "solve": solve,
                     "max_prod_diff_over_max1_dw": between})
        for r in rows[-3:]:
            print(json.dumps(r), flush=True)
    return rows


def part3(kind, data, dev):
    """The Gram route's eigh on this data's stacks: each layer's fp32 Gram
    (``ops.adapter_gram`` on the device) through batched ``eigh``, ``eigh``
    a layer at a time, ``svd`` (gesvd) of the Gram, batched ``eigh`` in
    fp64, and ``eigh`` on the CPU, against fp64 ``eigh`` of the same fp32
    Gram: eigenvalues and the residual |G V − V Λ| over λ_max."""
    from repro_torch.kernels import ops
    clients, w, _, _ = data
    rows = []
    for n in LEAVES:
        leaves = [c["blocks"][0]["attn"][n] for c in clients]
        stacks = {"B": np.concatenate([lf["B"] for lf in leaves], 2),
                  "A": np.concatenate([wk * lf["A"] for wk, lf in zip(w, leaves)],
                                      1).transpose(0, 2, 1)}
        for which, x in stacks.items():
            g = ops.adapter_gram(torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                                 device=dev))
            g64 = g.double().cpu()
            lam64 = torch.linalg.eigvalsh(g64)
            scale = lam64[:, -1:].abs()
            routes = {"eigh batched": lambda: torch.linalg.eigh(g),
                      "eigh a layer at a time": lambda: tuple(
                          torch.stack(t) for t in zip(*(torch.linalg.eigh(gl) for gl in g))),
                      "svd gesvd": lambda: (lambda u, s, vt: (s.flip(-1), u.flip(-1)))(
                          *torch.linalg.svd(g, driver="gesvd" if g.is_cuda else None)),
                      "eigh fp64": lambda: tuple(
                          t.float() for t in torch.linalg.eigh(g.double())),
                      "eigh cpu": lambda: torch.linalg.eigh(g.cpu())}
            for route, fn in routes.items():
                fn()
                sync(dev)
                t0 = time.perf_counter()
                lam, v = fn()
                sync(dev)
                secs = time.perf_counter() - t0
                lam, v = lam.double().cpu(), v.double().cpu()
                res = (g64 @ v - v * lam[:, None, :]).abs().amax((-2, -1))
                row = {"data": kind, "leaf": n, "stack": which,
                       "gram": list(g.shape), "route": route, "secs": secs,
                       "max_eig_err_over_lmax": float(((lam - lam64).abs()
                                                       / scale).max()),
                       "max_residual_over_lmax": float((res / scale[:, 0]).max())}
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def part2(kind, data, exact, dev, L, names):
    clients, w, _, _ = data
    rows = []
    for n in LEAVES:
        dw = sum(float(wk) * torch.matmul(torch.as_tensor(c["blocks"][0]["attn"][n]["B"], device=dev),
                                   torch.as_tensor(c["blocks"][0]["attn"][n]["A"], device=dev))
                 for wk, c in zip(w, clients))
        dw64 = [cut(exact[n][l], len(exact[n][l][1])) for l in range(L)]
        default = None
        for name, drv, dtype in VARIANTS:
            if name not in names:
                continue
            row = {"data": kind, "leaf": n, "shape": list(dw.shape),
                   "driver": name}
            try:
                torch.linalg.svd(dw[:1].to(dtype), full_matrices=False, driver=drv)
                sync(dev)
                t0 = time.perf_counter()
                u, s, vt = (t.float() for t in torch.linalg.svd(
                    dw.to(dtype), full_matrices=False, driver=drv))
                sync(dev)
                row["secs"] = time.perf_counter() - t0
            except RuntimeError as e:
                row["error"] = str(e).splitlines()[0]
                rows.append(row)
                print(json.dumps(row), flush=True)
                continue
            if name == "default":
                default = (u, s, vt)
            elif default is not None:
                row["default_bits_equal"] = all(torch.equal(a, b) for a, b
                                                in zip(default, (u, s, vt)))
            u64, s64, vt64 = u.double().cpu(), s.double().cpu(), vt.double().cpu()
            sp, full, cut16 = 0.0, 0.0, 0.0
            for l in range(L):
                ex = exact[n][l]
                ref = np.zeros(s64.shape[1])
                ref[:len(ex[1])] = ex[1]
                sp = max(sp, float(np.abs(s64[l].numpy() - ref).max() / ex[1][0]))
                big = float(np.abs(dw64[l]).max())
                full = max(full, float(np.abs(((u64[l] * s64[l]) @ vt64[l]).numpy()
                                              - dw64[l]).max()) / big)
                k = chip_smoke.TINY_RANK
                cut16 = max(cut16, float(np.abs(((u64[l, :, :k] * s64[l, :k])
                                                 @ vt64[l, :k]).numpy()
                                                - cut(ex, k)).max()) / big)
            row.update({"max_spectrum_err_vs_fp64_over_s1": sp,
                        "max_full_rank_prod_err_over_max_dw": full,
                        "max_cut16_prod_err_over_max_dw": cut16})
            rows.append(row)
            print(json.dumps(row), flush=True)
            del u, s, vt, u64, s64, vt64
        del dw, default
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="hold only the first N layers (default: all 22)")
    ap.add_argument("--methods", default="florist,flexlora",
                    help="part 1's methods (default: florist,flexlora)")
    ap.add_argument("--solve", default=None,
                    help="part 1's settings of the card's solves, as "
                         "driver:dtype pairs (default: the port's own)")
    ap.add_argument("--parts", default="1,2,3",
                    help="which parts to run (default: 1,2,3)")
    ap.add_argument("--variants", default=",".join(v[0] for v in VARIANTS),
                    help="part 2's variants (default: all)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if dev.type == "cuda" else "cpu"
    print(smi)
    print(parity_mode())
    chip_smoke.DEVICE = str(dev)
    out = {"card": smi, "part1": [], "part2": [], "part3": []}
    for kind in ("known", "gaussian"):
        data = chip_smoke.parity_trees(kind)
        if args.layers:
            clients, w, a_init, levels = data
            trim = lambda t: {"blocks": {0: {"attn": {          # noqa: E731
                n: {k: v[:args.layers] for k, v in lf.items()}
                for n, lf in t["blocks"][0]["attn"].items()}}}}
            data = ([trim(c) for c in clients], w, trim(a_init), levels)
        L = len(data[0][0]["blocks"][0]["attn"]["wq"]["B"])
        exact = {n: [chip_smoke.exact_svd(data[0], data[1], n, l) for l in range(L)]
                 for n in LEAVES}
        parts = args.parts.split(",")
        if "1" in parts:
            for solve in (args.solve or f"{svd.CUDA_SVD_DRIVER or 'default'}:"
                          f"{str(svd.CUDA_SOLVE_DTYPE)[6:]}").split(","):
                drv, dtype = solve.split(":")
                svd.CUDA_SVD_DRIVER = None if drv == "default" else drv
                svd.CUDA_SOLVE_DTYPE = getattr(torch, dtype)
                out["part1"] += part1(kind, data, exact, dev,
                                      args.methods.split(","), solve)
        if "3" in parts:
            out["part3"] += part3(kind, data, dev)
        if "2" in parts:
            out["part2"] += part2(kind, data, exact, dev, L,
                                  args.variants.split(","))
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "svd_accuracy.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
