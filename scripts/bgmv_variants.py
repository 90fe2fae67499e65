#!/usr/bin/env python3
"""Three questions about ``bgmv``'s CUDA kernel, timed on the card.

    python3 scripts/bgmv_variants.py [--parent DIR]

(a) Shrink bodies: at C 4, 8 and 16 with bf16 x on bf16 pages the kernel can
shrink on ``mma.sync`` (route ``"mma"``) or on the CUDA cores (``"fma"``).
Both are launched with their own ``bgmv.plan`` layout at the MLA and Llama
paths' shapes (rows on ranks 0/3/8/16 as in ``chip_smoke.py``, and ranks
30/32/64), checked against ``ref.bgmv_ref`` and timed with
``chip_smoke.gpu_ms`` cold (L2 flushed) and warm, in turns, twice.

(b) Base-only traffic: the engines' profile windows serve only base-id
rows, so every launch takes the kernel's rank-0 exit.  One engine step's
``bgmv`` launches (Llama: 16 layers x wq/wk/wv/wo; MLA: 3 layers x
wq_a/wq_b/wkv_a/wo; RWKV6: 24 layers x 5 targets of fp32 x on bf16 pages),
each after the base product it rides on, run ten times under
``torch.profiler``; the device time a launch is read from the profile.
Variants: the kernel as built; the same launch with no dynamic shared
memory (valid only for rank-0 rows); the source compiled with the cluster
attribute left out of the launch (valid only for rank-0 rows); the source
with the page ids read after the rank-0 exit; and, with
``--parent DIR`` (an unpacked earlier checkout), that checkout's
``bgmv.cu`` through its own C interface.  In turns, twice.

(c) Live rows at C 1: the kernel as built against the build with the page
ids read after the rank-0 exit (what moving the read costs a row that has
an adapter), cold and warm, in turns, twice.

Prints the card's name and power limit first; writes
``chiprun_out/bgmv_variants.json``.  Needs a CUDA card and ``nvcc``.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "bgmv.cu"
CLUSTER_LINE = "  cfg.numAttrs = 1;\n  err = cudaLaunchKernelEx(&cfg, kern, a);\n"
PREFETCH = "  const int pg = tid < a.Pmax ? table[tid] : 0;  // in flight beside the rank\n"
EXIT = "    return;\n  }\n  cluster_arrive_relaxed();"
PARENT_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
               + [ctypes.c_void_p])


def compile_libs(build, parent):
    """{name: CDLL}: the source with its cluster attribute left out, the
    source with the page ids read after the rank-0 exit instead of beside
    the rank, and the parent's source if given, built in parallel."""
    from repro_torch.kernels import build as kbuild
    out = ROOT / "build" / "bgmv_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    if not src.count(CLUSTER_LINE) == src.count(PREFETCH) == src.count(EXIT) == 1:
        sys.exit(f"anchor not found once in {SRC.name}")
    nocl = out / "bgmv_nocluster.cu"
    nocl.write_text(src.replace(CLUSTER_LINE, CLUSTER_LINE.replace(
        "numAttrs = 1", "numAttrs = 0")))
    late = out / "bgmv_late_pages.cu"
    late.write_text(src.replace(PREFETCH, "").replace(EXIT, EXIT.replace(
        "  }\n", "  }\n" + PREFETCH.split("  //")[0] + "\n")))
    jobs = {"no cluster": nocl, "page ids after the rank": late}
    if parent:
        jobs["parent"] = Path(parent) / "src/repro_torch/kernels/csrc/bgmv.cu"
    procs = {n: (out / f"lib{n.replace(' ', '_')}.so",
                 subprocess.Popen([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o",
                                   str(out / f"lib{n.replace(' ', '_')}.so"),
                                   str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for n, s in jobs.items()}
    libs = {"as built": build.load("bgmv")}
    for n, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"nvcc failed for {n}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.bgmv_launch.argtypes = (PARENT_ARGS if n == "parent"
                                    else build.ARGTYPES["bgmv_launch"])
        lib.bgmv_launch.restype = ctypes.c_int
        libs[n] = lib
    return libs


def inputs(torch, gen, dt, pdt, C, din, dout, ranks, Pmax):
    dev = gen.device
    rank = torch.tensor(ranks, dtype=torch.int32, device=dev)
    P = 32 if Pmax == 4 else 96
    table = torch.randperm(P, generator=gen, device=dev)[:5 * Pmax]
    table = table.reshape(5, Pmax).to(torch.int32)
    scale = torch.tensor([0.0, 2.0, 2.0, 2.0, 0.0], device=dev)
    x = torch.randn(8, C, din, generator=gen, device=dev).to(dt)
    a = (torch.randn(P, 4, din, generator=gen, device=dev) * 0.05).to(pdt)
    b = (torch.randn(P, dout, 4, generator=gen, device=dev) * 0.05).to(pdt)
    return x, a, b, table, rank, scale


def launcher(torch, lib, name, p, args, ids, smem=None):
    """A call of variant ``name`` on ``args``; returns its output tensor."""
    from repro_torch.kernels.bgmv import _CODES
    x, a, b, table, rank, scale = args
    B, C, din = x.shape
    dout, Pmax = b.shape[1], table.shape[1]
    y = torch.empty((B, C, dout), dtype=torch.float32, device=x.device)
    head = (x.data_ptr(), _CODES[x.dtype], a.data_ptr(), b.data_ptr(),
            _CODES[a.dtype], table.data_ptr(), rank.data_ptr(),
            scale.data_ptr(), ids.data_ptr(), y.data_ptr(), B, C, din, dout, 4,
            Pmax)

    def call(keep=args):              # the tensors stay alive with the call
        st = torch.cuda.current_stream().cuda_stream
        if name == "parent":
            err = lib.bgmv_launch(*head, st)
        else:
            err = lib.bgmv_launch(*head, int(p.route == "mma"), p.tile_n, p.kc,
                                  p.nchunk, p.c_pad, p.r_pad, p.clusters,
                                  p.smem if smem is None else smem, st)
        if err:
            sys.exit(f"bgmv variant {name}: launch error {err}")
        return y
    return call


def forced_plan(bg, how, *shape):
    """``bg.plan`` with its route fixed to ``how``."""
    orig = bg.route
    bg.route = lambda *a: how
    try:
        return bg.plan.__wrapped__(*shape)
    finally:
        bg.route = orig


def shrink_bodies(torch, libs, report):
    import chip_smoke
    from repro_torch.kernels import bgmv as bg, ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.tensor([0, 1, 2, 3, 1, 2, 3, 0], dtype=torch.int32, device="cuda")
    bf = torch.bfloat16
    cases = [(C, din, dout, (0, 3, 8, 16, 0), 4) for C in (4, 8, 16)
             for din, dout in ((2048, 2048), (2048, 512), (1536, 24576),
                               (7168, 576), (16384, 7168))]
    cases += [(16, din, dout, (0, 30, 32, 64, 0), 16)
              for din, dout in ((2048, 2048), (16384, 7168))]
    made = []
    for C, din, dout, ranks, Pmax in cases:
        args = inputs(torch, gen, bf, bf, C, din, dout, ranks, Pmax)
        want = ref.bgmv_ref(*args, ids)
        label = (f"bf16 C={C} {din}->{dout} ranks "
                 f"{'/'.join(map(str, ranks[1:4]))}")
        calls = {}
        for how in ("mma", "fma"):
            p = forced_plan(bg, how, C, din, dout, 4, Pmax, bf, bf)
            call = launcher(torch, libs["as built"], "as built", p, args, ids)
            err = float((call() - want).abs().max())
            lim = 2e-3 * float(want.abs().max())
            if not err <= lim:
                sys.exit(f"bgmv route {how} [{label}]: error {err:.3e} > {lim:.3e}")
            calls[how] = call
        made.append((label, calls))
    rec = report["shrink_bodies_us"] = {}
    for _ in range(2):
        for label, calls in made:
            for how, call in calls.items():
                r = rec.setdefault(label, {}).setdefault(how, {"cold": [], "warm": []})
                r["cold"].append(chip_smoke.gpu_ms(torch, call) * 1e3)
                r["warm"].append(chip_smoke.gpu_ms(torch, call, cold=False) * 1e3)
    print("(a) shrink bodies, bf16 x on bf16 pages, B 8, us (median of "
          f"{chip_smoke.REPS}; two turns):")
    for label, r in rec.items():
        print(f"  {label:40s} " + "; ".join(
            f"{how} cold {' / '.join(f'{x:.2f}' for x in v['cold'])}, warm "
            f"{' / '.join(f'{x:.2f}' for x in v['warm'])}" for how, v in r.items()))


def live_rows(torch, libs, report):
    """Every build that computes live rows, at C 1 on rows of ranks
    0/3/8/16 (Llama's and MLA's widest shapes), cold and warm."""
    import chip_smoke
    from repro_torch.kernels import bgmv as bg, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.tensor([0, 1, 2, 3, 1, 2, 3, 0], dtype=torch.int32, device="cuda")
    bf = torch.bfloat16
    rec = report["live_rows_c1_us"] = {}
    made = []
    for din, dout in ((2048, 2048), (16384, 7168)):
        args = inputs(torch, gen, bf, bf, 1, din, dout, (0, 3, 8, 16, 0), 4)
        want = ref.bgmv_ref(*args, ids)
        p = bg.plan(1, din, dout, 4, 4, bf, bf)
        for name in ("as built", "page ids after the rank"):
            call = launcher(torch, libs[name], name, p, args, ids)
            if not float((call() - want).abs().max()) <= 2e-3 * float(want.abs().max()):
                sys.exit(f"bgmv {name} at {din}->{dout}: wrong result")
            made.append((f"bf16 C=1 {din}->{dout}", name, call))
    for _ in range(2):
        for label, name, call in made:
            r = rec.setdefault(label, {}).setdefault(name, {"cold": [], "warm": []})
            r["cold"].append(chip_smoke.gpu_ms(torch, call) * 1e3)
            r["warm"].append(chip_smoke.gpu_ms(torch, call, cold=False) * 1e3)
    print("(c) live rows at C 1, us (two turns):")
    for label, r in rec.items():
        print(f"  {label:28s} " + "; ".join(
            f"{n} cold {' / '.join(f'{x:.2f}' for x in v['cold'])}, warm "
            f"{' / '.join(f'{x:.2f}' for x in v['warm'])}" for n, v in r.items()))


STEPS = {   # path: (layers, [(din, dout)] a layer, x dtype, page dtype)
    "llama": (16, [(2048, 2048), (2048, 512), (2048, 512), (2048, 2048)],
              "bfloat16", "bfloat16"),
    "mla": (3, [(7168, 1536), (1536, 24576), (7168, 576), (16384, 7168)],
            "bfloat16", "bfloat16"),
    "rwkv6": (24, [(2048, 2048)] * 5, "float32", "bfloat16"),
}


def base_only(torch, libs, report):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import bgmv as bg
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids = torch.zeros(8, dtype=torch.int32, device="cuda")      # base id: rank 0
    rec = report["base_only_us_a_launch"] = {}
    for path, (L, shapes, xd, pd) in STEPS.items():
        xd, pd = getattr(torch, xd), getattr(torch, pd)
        layer = []
        for din, dout in shapes:
            args = inputs(torch, gen, xd, pd, 1, din, dout, (0, 3, 8, 16, 0), 4)
            w = (torch.randn(din, dout, generator=gen, device="cuda") * 0.02).to(pd)
            p = bg.plan(1, din, dout, 4, 4, xd, pd)
            layer.append((args, w, p))
        variants = {}
        for name in libs:
            variants[name] = [(a, w, launcher(torch, libs[name], name, p, a, ids))
                              for a, w, p in layer]
        variants["as built, no shared memory"] = [
            (a, w, launcher(torch, libs["as built"], "as built", p, a, ids, smem=0))
            for a, w, p in layer]
        for name, calls in variants.items():
            for _, _, call in calls:
                if call().abs().max() != 0:
                    sys.exit(f"bgmv variant {name}: a rank-0 row is not zero")

        def step(calls):
            for _ in range(L):
                for a, w, call in calls:
                    _ = a[0][:, 0].to(w.dtype) @ w            # the base product
                    call()
        for _turn in range(2):
            for name, calls in variants.items():
                step(calls)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        step(calls)
                    torch.cuda.synchronize()
                dev_us, n = 0.0, 0
                for e in prof.key_averages():
                    if e.device_type == DeviceType.CUDA and "bgmv_kernel" in e.key:
                        dev_us += e.self_device_time_total
                        n += e.count
                want = 10 * L * len(shapes)
                if n != want:
                    sys.exit(f"{path} {name}: profiled {n} bgmv launches, "
                             f"expected {want}")
                rec.setdefault(path, {}).setdefault(name, []).append(dev_us / n)
    print("(b) base-only engine steps, device time a bgmv launch (us, "
          "torch.profiler, 10 steps; two turns):")
    for path, r in rec.items():
        print(f"  {path:6s} " + "; ".join(
            f"{n} {' / '.join(f'{x:.3f}' for x in v)}" for n, v in r.items()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked earlier checkout whose "
                    "bgmv.cu (the C interface without the layout arguments) is timed beside this one")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times kernels on a GPU")
    from repro_torch.kernels import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    report = {"card": card}
    libs = compile_libs(build, opts.parent)
    shrink_bodies(torch, libs, report)
    base_only(torch, libs, report)
    live_rows(torch, libs, report)
    report["medians"] = {
        "shrink_bodies_us": {k: {h: {t: statistics.median(x) for t, x in v.items()}
                                 for h, v in r.items()}
                             for k, r in report["shrink_bodies_us"].items()},
        "base_only_us_a_launch": {k: {n: statistics.median(x) for n, x in r.items()}
                                  for k, r in report["base_only_us_a_launch"].items()},
        "live_rows_c1_us": {k: {n: {t: statistics.median(x) for t, x in v.items()}
                                for n, v in r.items()}
                            for k, r in report["live_rows_c1_us"].items()}}
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "bgmv_variants.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
