#!/usr/bin/env python3
"""Where ``adapter_gram``'s CUDA kernel spends its time, on the card.

    python3 scripts/gram_cutouts.py

The source is compiled as it is and with parts cut out by text at fixed
anchors (the script exits naming an anchor that moved): the stage copies
(``issue``), the products (the diagonal and off-diagonal mma loops), the
warps' reduction into shared memory, the cluster's exchange and the
output stores (``write_out``), and all of these at once (what is left:
launch, prologue, ring waits and the cluster barriers).  Then the whole
build and each cut-out one at each cluster size 1 to 8 (K split
into as many slices a block; the whole build and the one without products
also warm), beside the clusters the card holds at once
(``adapter_gram_max_clusters``).  Each build is
launched through ``ctypes`` with ``adapter_gram.plan``'s layout at the main
shapes of ``chip_smoke.py``'s ``adapter_gram`` cases and timed with
``chip_smoke.gpu_ms`` (L2 flushed), in turns, twice.  A cut-out build
computes nothing useful; only the whole one is checked, against
``ref.adapter_gram_ref``.

Prints the card's name and power limit first; writes
``chiprun_out/gram_cutouts.json``.  Needs a CUDA card and ``nvcc``.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "adapter_gram.cu"

ANCHORS = {
    "copies": ["    issue<T, ROWL, R, VEC4>(buf, xg, K, r, k, ti * T, wi, tid);\n"],
    "products": ["      diag_dispatch<NB, 0, ROWL, R>(group, buf, acc, kw, off);\n",
                 "          mma_block(acc[j], fa, load_frag<T, ROWL, R>(buf + SF, j, 8 * t, off));\n"],
    "warp reduction": ["        diag_store_dispatch<NB, 0>(group, red, acc, lane, w > 0);\n",
                       "    diag_store_dispatch<NB, 0>(group, smem + kw * Red<T>::floats, acc, lane, false);\n"],
    "exchange and stores": [
        "  write_out<T>(out + (long)g * r * r, red, red + Red<T>::floats, r, ti, tj, nclu, q, tid);\n"],
}
SHAPES = ((32, 2048, 64, "col"), (32, 512, 64, "col"), (32, 2048, 128, "col"),
          (32, 512, 128, "col"), (32, 2048, 16, "col"), (32, 2048, 64, "row"))


def variants():
    src = SRC.read_text()
    for lines in ANCHORS.values():
        for ln in lines:
            if src.count(ln) != 1:
                sys.exit(f"anchor not found once in {SRC.name}: {ln.strip()}")
    out = {"whole": src}
    for name, lines in ANCHORS.items():
        v = src
        for ln in lines:
            v = v.replace(ln, "{}\n")
        out[f"without {name}"] = v
    v = src
    for lines in ANCHORS.values():
        for ln in lines:
            v = v.replace(ln, "{}\n")
    out["without all four"] = v
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import adapter_gram as ag
    from repro_torch.kernels import build, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi)
    bdir = ROOT / "build" / "gram_cutouts"
    bdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants().items():
        tag = name.replace(" ", "_")
        cu, so = bdir / f"{tag}.cu", bdir / f"lib{tag}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.adapter_gram_launch.argtypes = build.ARGTYPES["adapter_gram_launch"]
        lib.adapter_gram_launch.restype = ctypes.c_int
        libs[name] = lib
        if name == "whole":
            print("\n".join(ln for ln in log.splitlines()
                            if "Compiling entry" in ln or "Used" in ln))
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = []
    for G, K, r, layout in SHAPES:
        shape = (G, K, r) if layout == "col" else (G, r, K)
        x = torch.randn(*shape, generator=gen, device="cuda") * 0.05
        p = ag.plan(G, K, r, layout)
        out = torch.empty((G, r, r), device="cuda")

        def run(lib, x=x, p=p, out=out):
            err = lib.adapter_gram_launch(
                x.data_ptr(), out.data_ptr(), G, K, r, ag.LAYOUTS.index(layout), p.tile,
                p.cluster, p.per, p.smem, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        run(libs["whole"])
        want = ref.adapter_gram_ref(x if layout == "col" else x.mT)
        err = (out - want).abs().max().item() / want.abs().max().item()
        if err > 1e-4:
            sys.exit(f"whole build wrong at {shape}: {err}")
        times = {n: [] for n in libs}
        for _ in range(2):
            for n, lib in libs.items():
                times[n].append(cs.gpu_ms(torch, lambda lib=lib: run(lib)))
        rec = {"shape": f"G={G} K={K} r={r} ({layout})", "ms": times}
        res.append(rec)
        print(rec["shape"] + "  " + "; ".join(
            f"{n} {min(t) * 1e3:.1f}/{max(t) * 1e3:.1f} us" for n, t in times.items()))
    fn = libs["whole"].adapter_gram_max_clusters
    fn.argtypes = [ctypes.c_int] * 8
    fn.restype = ctypes.c_int
    sweep = []
    for G, K, r, layout in SHAPES:
        shape = (G, K, r) if layout == "col" else (G, r, K)
        x = torch.randn(*shape, generator=gen, device="cuda") * 0.05
        out = torch.empty((G, r, r), device="cuda")
        p = ag.plan(G, K, r, layout)
        slices = -(-K // p.rows)
        for S in range(1, 9):
            per = -(-slices // S)
            args = (G, K, r, ag.LAYOUTS.index(layout), p.tile, S, per, p.smem)
            ms = {}
            for n, lib in libs.items():
                def run(x=x, out=out, args=args, lib=lib):
                    err = lib.adapter_gram_launch(x.data_ptr(), out.data_ptr(), *args,
                                                  torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: {err}")
                ms[n] = cs.gpu_ms(torch, run)
                if n in ("whole", "without products"):
                    ms[n + " (warm)"] = cs.gpu_ms(torch, run, cold=False)
            rec = {"shape": f"G={G} K={K} r={r} ({layout})", "cluster": S, "per": per,
                   "blocks": G * p.tiles * S, "max_active_clusters": fn(*args), "ms": ms}
            sweep.append(rec)
            print(f"  {rec['shape']} cluster {S} ({rec['blocks']} blocks, card holds "
                  f"{rec['max_active_clusters']} clusters): " + "; ".join(
                      f"{n} {t * 1e3:.1f}" for n, t in ms.items()) + " us")
    floor = cs.gpu_ms(torch, lambda: torch.cuda._sleep(0))
    print(f"empty kernel {floor * 1e3:.2f} us")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gram_cutouts.json").write_text(json.dumps(
        {"card": smi, "empty_kernel_ms": floor, "cases": res, "cluster_sweep": sweep},
        indent=1))


if __name__ == "__main__":
    main()
