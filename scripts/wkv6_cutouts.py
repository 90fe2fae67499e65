#!/usr/bin/env python3
"""Where ``wkv6``'s time goes on the card: the kernel with parts cut out.

    python3 scripts/wkv6_cutouts.py

Compiles ``src/repro_torch/kernels/csrc/wkv6.cu`` once as it is and once
per variant with one or more of its parts removed by ``#ifndef`` guards
inserted at fixed anchors (the variants compute wrong values: only their
times mean anything), and times each at RWKV6-1.6B's prefill shape (bf16
r/k/v, B 8, S 1024, 32 heads of 64) with ``chip_smoke.gpu_ms`` (median of
50, L2 flushed), in turns, twice.  Then it times ``mma.sync`` m16n8k8 TF32
alone (independent chains, 1-16 warps an SM), the rate the consumers'
products run at.  Prints the card's name and power limit first; writes
``chiprun_out/wkv6_cutouts.json``.  Needs a CUDA card and ``nvcc``.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "wkv6.cu"

# (first line, last line, macro): the lines from the first through the last
# are compiled only without the macro
PARTS = [
    ("  float bonus[2];", "  part[kC - 1] = 0.f;\n", "NO_DIAG"),
    ("#pragma unroll\n  for (int e = 0; e < 2; ++e)\n#pragma unroll\n    for (int m = kCG",
     "      split_store(part[a], &P.ph[t][s], &P.pl[t][s]);\n    }\n  }\n", "NO_DIAG"),
    ("  const int ch = tid % HD;", "    ds[t] = sm.d[t][ch];\n  }\n", "NO_SCAN"),
    ("  float run = 1.f;\n  if (prefix) {", "      run *= ds[s];\n    }\n  }\n", "NO_SCAN"),
    ("      stage<HD, T, kExactV>(sm, c % kR, pb, pt);", "pt);", "NO_STAGE"),
    ("#pragma unroll\n  for (int j = 0; j < kNT; ++j) {\n    // accumulator columns",
     "                      bits(b.w));\n    }\n  }\n", "NO_YPROD"),
    ("#pragma unroll\n  for (int j = 0; j < kNT; ++j) {\n    const float2 dd",
     "h0, h1, l0, l1);\n    }\n  }\n", "NO_UPDATE"),
    ("      products<HD, T, kExactV>(sm, pb, st, y, base, stride_t, c * kC, S, tid & 31,",
     "tid >> 5);", "NO_PRODUCTS"),
]
VARIANTS = [(), ("NO_PRODUCTS",), ("NO_DIAG",), ("NO_SCAN",), ("NO_STAGE",),
            ("NO_YPROD",), ("NO_UPDATE",), ("NO_DIAG", "NO_SCAN", "NO_STAGE"),
            ("NO_PRODUCTS", "NO_DIAG", "NO_SCAN", "NO_STAGE")]

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  uint32_t b0 = 0x3f800000u, b1 = 0x3f800000u;
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int q = 0; q < 8; ++q)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[q][0]), "+f"(d[q][1]), "+f"(d[q][2]), "+f"(d[q][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int q = 0; q < 8; ++q) s += d[q][0] + d[q][1] + d[q][2] + d[q][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int blocks, int threads, int iters) {
  mma_loop<<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def cut_source() -> str:
    src = SRC.read_text()
    for first, last, macro in PARTS:
        if src.count(first) != 1:
            sys.exit(f"anchor not found once in {SRC.name}: {first!r}")
        i = src.index(first)
        j = src.index(last, i) + len(last)
        src = src[:i] + f"#ifndef {macro}\n" + src[i:j] + "\n#endif\n" + src[j:]
    return src


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times kernels on a GPU")
    import chip_smoke
    from repro_torch.kernels import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    out_dir = ROOT / "build" / "wkv6_cutouts"
    out_dir.mkdir(parents=True, exist_ok=True)
    cut = out_dir / "wkv6_cut.cu"
    cut.write_text(cut_source())
    bench = out_dir / "mma_bench.cu"
    bench.write_text(MMA_BENCH)
    procs = {}
    for var in VARIANTS:
        name = "+".join(var) or "whole"
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *(f"-D{m}" for m in var), "-o",
             str(so), str(cut)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    bench_so = out_dir / "libmma_bench.so"
    bp = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(bench_so),
                           str(bench)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    libs, report = {}, {"card": card, "variants": {}, "mma_sync_tf32": {}}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.wkv6_launch.argtypes = build.ARGTYPES["wkv6_launch"]
        lib.wkv6_launch.restype = ctypes.c_int
        libs[name] = lib
        report["variants"][name] = {
            "registers": [int(x) for x in re.findall(r"Used (\d+) registers", log)],
            "us": []}
    if bp.wait():
        sys.exit("nvcc failed for the mma benchmark:\n" + bp.stdout.read())

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    B, S, H, hd = 8, 1024, 32, 64
    r, k, v = (torch.randn(B, S, H, hd, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    w = -torch.exp(torch.randn(B, S, H, hd, generator=gen, device=dev) - 3)
    u = torch.randn(H, hd, generator=gen, device=dev) * 0.5
    y = torch.empty(B, S, H, hd, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        err = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), 1,
                              w.data_ptr(), u.data_ptr(), y.data_ptr(), B, S, H,
                              hd, stream)
        if err:
            sys.exit(f"launch failed: {err}")

    print(f"wkv6 at bf16 r/k/v, B={B} S={S} H={H} hd={hd}, parts cut out "
          "(median of 50, L2 flushed; two turns):")
    for _ in range(2):
        for name, lib in libs.items():
            us = chip_smoke.gpu_ms(torch, lambda: call(lib)) * 1e3
            report["variants"][name]["us"].append(us)
    for name, rec in report["variants"].items():
        print(f"  {name:42s} {' / '.join(f'{x:.1f}' for x in rec['us'])} us "
              f"(registers of the four builds: {rec['registers']})")

    bl = ctypes.CDLL(str(bench_so))
    bl.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 16 * 32, device=dev)
    print("mma.sync m16n8k8 TF32, 8 independent chains a warp:")
    for warps in (1, 2, 4, 8, 16):
        iters = 2000
        bl.run(buf.data_ptr(), sms, 32 * warps, 10)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        bl.run(buf.data_ptr(), sms, 32 * warps, iters)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        tflops = sms * warps * iters * 8 * 2048 / ms / 1e9
        report["mma_sync_tf32"][warps] = tflops
        print(f"  {warps:2d} warps an SM: {tflops:.1f} TFLOP/s")
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "wkv6_cutouts.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
