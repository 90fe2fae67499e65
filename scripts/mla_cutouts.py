#!/usr/bin/env python3
"""Where ``mla_ring_decode``'s route-"wgmma" time goes on the card: the
kernel with parts cut out.

    python3 scripts/mla_cutouts.py

Compiles ``src/repro_torch/kernels/csrc/mla_ring_decode.cu`` once as it is
and once per variant with one or more parts of its route-"wgmma" kernel
removed by ``#ifndef`` guards inserted at fixed anchors (the variants
compute wrong values: only their times mean anything), and times each
through ``ops.mla_ring_decode`` at the MLA path's shapes (bf16 cache, B 8,
H 128, kvr 512, rope 64, ring 1024: a full ring at C 1 and 16, the
engine's ring of 32-288 resident slots and a fresh one of 17-38 at C 1)
with ``chip_smoke.gpu_ms``
(median of 50, L2 flushed), in turns, twice.  Prints the card's name and
power limit first; writes ``chiprun_out/mla_cutouts.json``.  Needs a CUDA
card and ``nvcc``.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "mla_ring_decode.cu"

# (first line, last line, macro): the lines from the first through the last
# are compiled only without the macro
PARTS = [
    ("      float4* raw4 = reinterpret_cast<float4*>(gbase);\n",
     "        *reinterpret_cast<uint2*>(gbase + kPanels * kQPanel + off) = make_uint2(l0, l1);\n"
     "      }\n",
     "NO_Q"),
    ("      if (tid == 0) {\n        mbar_expect_tx(qbar, kQBytes);",
     "      mbar_wait(qbar, 0);\n", "NO_QLOAD"),
    ("      float4 v[kPer];\n",
     "        *reinterpret_cast<uint2*>(gbase + kPanels * kQPanel + off) = make_uint2(l0, l1);\n"
     "      }\n", "NO_QSPLIT"),
    ("#pragma unroll\n      for (int qp = 0; qp < kQParts; ++qp)",
     "qp | k);\n        }\n", "NO_S"),
    ("      if (wg == 1)\n#pragma unroll\n        for (int e = 0; e < 4; ++e)\n"
     "          xs[e * 128 + wt]",
     "          sacc[4 * e + 3] = o.w;\n        }\n", "NO_EXCHANGE"),
    ("#pragma unroll\n      for (int kt = 0; kt < kWBK / 16; ++kt)",
     "          wgmma_rs_n64(oacc[p], ph_[kt], dv);\n        }\n", "NO_PV"),
    ("  // ---- merge of the cluster's splits",
     "  cluster_sync_all();                              // no block leaves while read\n",
     "NO_MERGE"),
]
# (line, macro, replacement): the line is replaced under the macro
SUBS = [("  const int ntiles = i1 - i0;\n", "NO_TILES", "  const int ntiles = 0;\n")]
VARIANTS = [(), ("NO_Q",), ("NO_QLOAD",), ("NO_QSPLIT",), ("NO_S",),
            ("NO_EXCHANGE",), ("NO_PV",),
            ("NO_MERGE",), ("NO_S", "NO_EXCHANGE", "NO_PV"), ("NO_TILES",),
            ("NO_TILES", "NO_Q", "NO_MERGE")]


def cut_source() -> str:
    src = SRC.read_text()
    for first, last, macro in PARTS:
        if src.count(first) != 1:
            sys.exit(f"anchor not found once in {SRC.name}: {first!r}")
        i = src.index(first)
        j = src.index(last, i) + len(last)
        src = src[:i] + f"#ifndef {macro}\n" + src[i:j] + "#endif\n" + src[j:]
    for line, macro, repl in SUBS:
        if src.count(line) != 1:
            sys.exit(f"anchor not found once in {SRC.name}: {line!r}")
        src = src.replace(line, f"#ifdef {macro}\n{repl}#else\n{line}#endif\n")
    return src


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times kernels on a GPU")
    import chip_smoke
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import mla_ring_decode as mla
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    out_dir = ROOT / "build" / "mla_cutouts"
    out_dir.mkdir(parents=True, exist_ok=True)
    cut = out_dir / "mla_cut.cu"
    cut.write_text(cut_source())
    procs = {}
    for var in VARIANTS:
        name = "+".join(var) or "whole"
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *(f"-D{m}" for m in var), "-o",
             str(so), str(cut)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, report = {}, {"card": card, "variants": {}}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for sym, argtypes in build.ARGTYPES.items():
            if sym.startswith("mla_ring_decode_"):
                getattr(lib, sym).argtypes = argtypes
                getattr(lib, sym).restype = ctypes.c_int
        libs[name] = lib
        report["variants"][name] = {
            "registers": [int(x) for x in re.findall(r"Used (\d+) registers", log)],
            "us": {}}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    B, cap, H, kvr, rope = 8, 1024, 128, 512, 64
    cases = {}
    for label, pos_l, C in (
            ("full ring, C=1", [1500, 1024, 300, 16, 0, 700, 2100, 64], 1),
            ("engine ring, C=1", [288, 32, 100, 200, 0, 150, 64, 250], 1),
            ("fresh ring, C=1", [17, 20, 25, 30, 0, 38, 24, 33], 1),
            ("full ring, C=16", [1500, 1024, 300, 16, 0, 700, 2100, 64], 16)):
        pos = torch.tensor(pos_l, device=dev, dtype=torch.int32)
        n = torch.minimum(pos, torch.tensor([C, C, C, C, 0, min(5, C), 1, C],
                                            device=dev)).to(torch.int32)
        q = torch.randn(B, C, H, kvr + rope, generator=gen, device=dev)
        ckv = torch.randn(B, cap, kvr, generator=gen, device=dev).to(torch.bfloat16)
        kr = torch.randn(B, cap, rope, generator=gen, device=dev).to(torch.bfloat16)
        cases[label] = (q, ckv, kr, pos, pos.clamp(max=cap), n)
    nsplit = {k: mla.splits(B, v[0].shape[1], H, cap, dev, "wgmma")[0]
              for k, v in cases.items()}
    print("mla_ring_decode route wgmma, B=8 H=128 kvr=512 rope=64 cap=1024, "
          f"splits {nsplit}; parts cut out (median of 50, L2 flushed; two turns):")
    for _ in range(2):
        for name, lib in libs.items():
            build._LIBS["mla_ring_decode"] = lib
            for label, args in cases.items():
                us = chip_smoke.gpu_ms(torch, lambda: ops.mla_ring_decode(
                    *args, scale=0.072, window=0)) * 1e3
                report["variants"][name]["us"].setdefault(label, []).append(us)
    for name, rec in report["variants"].items():
        print(f"  {name:28s} " + "; ".join(
            f"{k} {' / '.join(f'{x:.1f}' for x in v)}" for k, v in rec["us"].items())
            + f" us (registers {rec['registers'][-1:]})")
    report["splits"] = nsplit
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "mla_cutouts.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
