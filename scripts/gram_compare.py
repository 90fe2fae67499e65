#!/usr/bin/env python3
"""``adapter_gram`` as built against an earlier checkout's, on the card.

    python3 scripts/gram_compare.py [--parent DIR]

Every case of ``chip_smoke.py``'s ``adapter_gram`` table (the Gram SVD
route's B stacks, fp32 (G, m, r); the A stacks, whose kernel input is the
transposed view of a stored (G, r, n) tensor; the delta route's r 512) and
a few ragged edges (r 5 and 12, rows that are not 16-byte multiples, K
under one slice, r > 128 with off-diagonal tiles) go through
``ops.adapter_gram`` as built: held to ``ref.adapter_gram_ref`` within
1e-4 of max |xᵀx|, run twice for equal bits, and timed with
``chip_smoke.gpu_ms`` cold (L2 flushed) and warm.  With ``--parent DIR`` (an
unpacked earlier checkout) that checkout's ``adapter_gram.cu`` is built and
launched as its own wrapper did: a contiguous copy of the input first (an
A stack's view is not contiguous), its panel split, its partials buffer.
Cases are timed in turns: parent, as built, as built, parent.  Beside them
``torch.bmm`` of the same function.

Prints the card's name and power limit first; writes
``chiprun_out/gram_compare.json``.  Needs a CUDA card and ``nvcc``.
"""
import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (label, G, K, r, layout, timed): "col" stacks are (G, K, r); "row" ones
# are stored (G, r, K) and passed as their transposed view
CASES = (
    ("B stack", 32, 2048, 64, "col", True),
    ("B stack", 32, 2048, 16, "col", True),
    ("B stack", 32, 2048, 128, "col", True),
    ("B stack", 32, 512, 16, "col", True),
    ("B stack", 32, 512, 64, "col", True),
    ("B stack", 32, 512, 128, "col", True),
    ("B stack", 32, 2000, 60, "col", True),
    ("A stack", 32, 2048, 64, "row", True),
    ("A stack", 32, 2048, 128, "row", True),
    ("delta", 4, 2048, 512, "col", True),
    ("edge", 3, 70, 5, "col", False),
    ("edge", 2, 1001, 12, "row", False),
    ("edge", 2, 100, 40, "col", False),
    ("edge", 1, 8, 200, "col", False),
    ("edge", 2, 300, 130, "row", False),
    ("edge", 5, 257, 96, "col", False),
)


def parent_launcher(parent: Path, torch):
    """A callable x -> xᵀx through the parent's kernel and wrapper logic."""
    from repro_torch.kernels import build as kbuild
    out = ROOT / "build" / "gram_compare"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libadapter_gram_parent.so"
    src = parent / "src/repro_torch/kernels/csrc/adapter_gram.cu"
    proc = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed for the parent's adapter_gram.cu:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.adapter_gram_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, I, I, P]
    fn.restype = I
    spec = importlib.util.spec_from_file_location(
        "parent_adapter_gram", parent / "src/repro_torch/kernels/adapter_gram.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def run(x):
        x3 = x.float().contiguous()
        G, m, r = x3.shape
        rows, n = mod.panels(G, m, r)
        o = torch.empty((G, r, r), dtype=torch.float32, device=x.device)
        part = (torch.empty((G, n, r, r), dtype=torch.float32, device=x.device)
                if n > 1 else None)
        err = fn(x3.data_ptr(), o.data_ptr(), None if part is None else part.data_ptr(),
                 G, m, r, rows, n, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent launch failed: {err}")
        return o
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import adapter_gram as ag
    from repro_torch.kernels import build, ops, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi)
    log = build.build_all(("adapter_gram",)).get("adapter_gram", "")
    print("\n".join(ln for ln in log.splitlines() if "Used" in ln or "spill" in ln))
    parent = parent_launcher(args.parent, torch) if args.parent else None
    for tile, layout, strips in ((32, "col", 1), (64, "col", 1), (128, "col", 1),
                                 (128, "col", 2), (32, "row", 1), (64, "row", 1),
                                 (128, "row", 1), (128, "row", 2)):
        got, want = ag.compiled_smem_bytes(tile, layout, strips), ag.smem_bytes(
            tile, layout, strips)
        if got != want:
            sys.exit(f"smem_bytes({tile}, {layout}, {strips}) {want} != built {got}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, bad = [], []
    for label, G, K, r, layout, timed in CASES:
        if layout == "col":
            x = torch.randn(G, K, r, generator=gen, device="cuda") * 0.05
            stored, lib = x, lambda: torch.bmm(x.mT, x)
        else:
            stored = torch.randn(G, r, K, generator=gen, device="cuda") * 0.05
            x = stored.mT
            lib = lambda: torch.bmm(stored, stored.mT)  # noqa: E731
        p = ag.plan(G, K, r, layout)
        want = ref.adapter_gram_ref(x)
        got = ops.adapter_gram(x)
        again = ops.adapter_gram(x)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        same = bool(torch.equal(got, again))
        sym = bool(torch.equal(got, got.mT))
        rec = {"case": f"{label}, G={G} K={K} r={r} ({layout})", "plan": p._asdict(),
               "max_abs_err": err, "limit": 1e-4 * scale, "same_bits": same,
               "symmetric": sym}
        if parent is not None:
            pe = (parent(x) - want).abs().max().item()
            rec["parent_max_abs_err"] = pe
        if err > 1e-4 * scale or not same:
            bad.append(rec["case"])
        if timed:
            t = {"parent": [], "new": [], "new_warm": []}
            for turn in ("parent", "new", "new", "parent") if parent else ("new", "new"):
                if turn == "parent":
                    t["parent"].append(cs.gpu_ms(torch, lambda: parent(x)))
                else:
                    t["new"].append(cs.gpu_ms(torch, lambda: ops.adapter_gram(x)))
                    t["new_warm"].append(cs.gpu_ms(torch, lambda: ops.adapter_gram(x),
                                                   cold=False))
            rec.update({k: v for k, v in t.items() if v})
            rec["bmm_ms"] = cs.gpu_ms(torch, lib)
            rec["plain_ms"] = cs.gpu_ms(torch, lambda: ref.adapter_gram_ref(x))
            nbytes = 4 * (G * K * r + G * r * r)
            rec["bound_bytes_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
            rec["bound_fp32_ms"] = G * K * r * (r + 1) / cs.PEAK_OPS["float32"] * 1e3
            rec["bound_3xtf32_ms"] = (3 * 2 * G * K * r * r / cs.PEAK_OPS["tf32"] * 1e3)
        rows.append(rec)
        print(json.dumps({k: (round(v, 6) if isinstance(v, float) else
                              [round(a, 6) for a in v] if isinstance(v, list) else v)
                          for k, v in rec.items() if k != "plan"})
              + f"  tile {p.tile} cluster {p.cluster} per {p.per}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gram_compare.json").write_text(json.dumps({"card": smi, "cases": rows},
                                                      indent=1))
    if bad:
        sys.exit(f"mismatch or unequal bits: {bad}")
    print("gram_compare ok")


if __name__ == "__main__":
    main()
