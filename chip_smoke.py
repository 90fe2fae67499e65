#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no exception is caught):

1. Print the card's name and power limit; build the five CUDA kernels from
   the sources in the checkout, one ``nvcc`` each, all at once (set-up
   time).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with the tolerance stated beside each comparison;
   ``ring_decode`` also on a one-tile ring (no split, no merge) and at head
   dims 16, 32 and 128; ``lora_matmul``, ``flash_attention`` and
   ``adapter_gram`` at the federated round's shapes, ragged edges included.
3. Each kernel's time (median of 50 launches, CUDA events, L2 flushed
   before each), its bound, its plain version's time and a one-call
   PyTorch yardstick where one exists.
4. The slice end to end: full-width Llama-3.2-1B (random seeded weights,
   bf16) serving 16 requests over three adapters of ranks 4/8/16 and the
   base model, with a mid-flight swap, through ``decode_impl="kernel"``;
   the kernels' launch counts must equal 16 x (and 16 x 4 x) engine steps.
5. The engine on the card, kernels against plain versions, at full width in
   fp32 with TF32 off: first prefill step's logits within tolerance, and
   the greedy-token agreement over 16 steps.
6. The federated slice end to end: two FLoRIST rounds of full-width
   Llama-3.2-1B (random seeded weights, bf16; 8 clients of ranks 4/8/16/32,
   4 sampled a round, 4 local steps of 4 × 512 tokens, the Gram SVD route)
   through ``FederatedTrainer``; eval loss, kept ranks, wire bytes, round
   and finalize times, train-step times and tokens/s per round; launch
   counts held to what the code implies; a profiled window of train steps.
7. The federated path on the card in fp32 with TF32 off, at full width and
   4 layers: two train steps on the kernel route against the plain route
   (loss, adapters, ``scale``), and one FLoRIST finalize on the Gram route
   against the LAPACK route (ranks, spectra, ``B_g A_g``).

It fails without a CUDA device, and in a directory that lacks the port's
sources.  Details go to ``chiprun_out/chip_smoke.json``.
"""
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
REPS = 50
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({ROOT}/src)")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)                       # card name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"phase 1 build (set-up): {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(logs)) or 'cached'})")
    for name, log in sorted(logs.items()):
        regs = [int(w.split()[-1]) for w in re.findall(r"Used \d+", log)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill", log))
        print(f"  ptxas[{name}]: {len(regs)} kernels, at most {max(regs)} "
              f"registers per thread, {spills} bytes spilled")

    report = {"card": smi}
    report["kernel_cases"] = kernel_cases(torch) + train_kernel_cases(torch)
    report["e2e"], counts = end_to_end(torch)
    report["parity"] = engine_parity(torch)
    report["federated"], fed_counts = federated_round(torch)
    report["fed_parity"] = federated_parity(torch)
    counts.update(fed_counts)

    kernels = []
    for name, case in (("ring_decode", "bf16 cache, C=1, B=8 H=32 K=8 hd=64 cap=1024"),
                       ("bgmv", "bf16, C=1, B=8 din=2048 dout=2048 pr=4 Pmax=4"),
                       ("lora_matmul", LORA_MAIN),
                       ("flash_attention", FLASH_MAIN),
                       ("adapter_gram", GRAM_MAIN)):
        rec = next(r for r in report["kernel_cases"]
                   if r["name"] == name and r["case"] == case)
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "case")}
            | {"launches": counts[name]}
            | ({"library": rec["library"]} if "library" in rec else {}))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    report["script_s"] = time.perf_counter() - t0
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"whole script from the build on: {report['script_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# -- phases 2 and 3: kernels against their plain versions, and their times ----

def gpu_ms(torch, fn) -> float:
    """Median device time of ``fn`` over REPS launches.  Before each launch
    the 50 MB L2 is flushed (the decode path reads each layer's cache and
    adapter pages once per step, cold) and the stream is held busy with a
    sleep, so the host's enqueue cost falls inside the sleep and the event
    pair encloses only the device work."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in times)


def check(name, got, want, valid, tol):
    """max |got - want| over ``valid`` rows must be <= tol * max(1, |want|)."""
    g, w = got[valid].float(), want[valid].float()
    err = (g - w).abs().max().item()
    scale = max(1.0, w.abs().max().item())
    ok = err <= tol * scale
    print(f"  {name}: max_abs_err {err:.3e} (limit {tol * scale:.3e}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


def check_rows(name, got, want, tol):
    """Each row (the last axis) on its own scale: max |got - want| over the
    row must be <= tol * max |want| over the row.  Returns max |got - want|
    over all rows."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    rel = (d.amax(-1) / w.abs().amax(-1).clamp_min(1e-30)).max().item()
    err, mean = d.max().item(), d.mean().item()
    ok = rel <= tol
    print(f"  {name}: max_abs_err {err:.3e}, mean_abs_err {mean:.3e}; worst "
          f"row max |Δ| / row max |plain| {rel:.3e} (limit {tol:.1e}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


def kernel_cases(torch):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ring_decode import splits
    from repro_torch.models.attention_core import ring_attend_mask
    from repro_torch.serve.kvcache import quant
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    records = []
    print("phase 2/3: kernels against plain versions; times (ms, median of "
          f"{REPS}, L2 flushed) beside bounds at 3.35 TB/s")

    # ring_decode: main-path shapes (hd 64, cap 1024); rows cover a wrapped
    # ring, a full ring, partial rings, a fresh prefill, an inactive row
    # (n = 0, never written), ragged n and a wrap at pos > 2 cap.  Then a
    # ring of one tile (cap 64: one split, normalised in-block, no merge)
    # and the other head dims the kernel is built for.
    B, H, K = 8, 32, 8
    positions = {1024: [1500, 1024, 300, 16, 0, 700, 2100, 64],
                 64: [100, 64, 30, 16, 0, 70, 200, 48]}
    tol = {"float32": 1e-4, "bfloat16": 2e-3, "int8": 1e-4}
    # fp32: sum order across up to 1024 keys; bf16: both sides compute in
    # fp32 from the same stored bf16 values, margin for exp/sum order;
    # int8: both dequantize per token in fp32
    for kv_name, C, window, hd, cap in (
            ("bfloat16", 1, 0, 64, 1024), ("bfloat16", 16, 0, 64, 1024),
            ("bfloat16", 1, 256, 64, 1024), ("bfloat16", 16, 256, 64, 1024),
            ("float32", 1, 0, 64, 1024), ("float32", 16, 0, 64, 1024),
            ("int8", 1, 0, 64, 1024), ("int8", 16, 0, 64, 1024),
            ("bfloat16", 1, 0, 64, 64), ("bfloat16", 16, 0, 64, 64),
            ("int8", 16, 32, 64, 64),
            ("bfloat16", 1, 0, 128, 1024), ("bfloat16", 16, 0, 128, 1024),
            ("float32", 16, 0, 128, 1024), ("int8", 1, 0, 128, 1024),
            ("bfloat16", 16, 0, 16, 1024), ("bfloat16", 16, 0, 32, 1024)):
        nsplit = splits(B, C, H, K, cap, dev)[0]
        if (nsplit == 1) != (cap == 64):
            fail(f"ring_decode: cap {cap}, C={C} runs {nsplit} splits; the "
                 "checks expect one split exactly where cap = 64")
        pos = torch.tensor(positions[cap], device=dev)
        length = torch.clamp(pos, max=cap)
        n = torch.minimum(pos, torch.tensor([C, C, C, C, 0, min(5, C), 1, C],
                                            device=dev)).to(torch.int32)
        kf = torch.randn(B, cap, K, hd, generator=gen, device=dev)
        vf = torch.randn(B, cap, K, hd, generator=gen, device=dev)
        qdt = torch.float32 if kv_name == "float32" else torch.bfloat16
        q = torch.randn(B, C, H, hd, generator=gen, device=dev).to(qdt)
        ks = vs = None
        if kv_name == "int8":
            (k, ks), (v, vs) = quant(kf), quant(vf)
        else:
            k, v = kf.to(getattr(torch, kv_name)), vf.to(getattr(torch, kv_name))
        p32, l32 = pos.to(torch.int32), length.to(torch.int32)
        args = (q, k, v, p32, l32, n)
        kw = dict(window=window, k_scale=ks, v_scale=vs)
        got = ops.ring_decode(*args, **kw)
        want = ref.ring_decode_ref(*args, **kw)
        torch.cuda.synchronize()
        valid = torch.arange(C, device=dev)[None, :] < n[:, None]
        case = (f"{'bf16' if kv_name == 'bfloat16' else kv_name} cache, C={C}"
                f"{f', window={window}' if window else ''}, "
                f"B={B} H={H} K={K} hd={hd} cap={cap}")
        err = check(f"ring_decode[{case}; {nsplit} splits]", got, want, valid,
                    tol[kv_name])
        ms = gpu_ms(torch, lambda: ops.ring_decode(*args, **kw))
        plain = gpu_ms(torch, lambda: ref.ring_decode_ref(*args, **kw))
        lib = None
        if kv_name != "int8":
            # yardstick: one SDPA call on the same values, pre-transposed to
            # (B, K, cap, hd) and with the ring mask prebuilt (not timed)
            qpos = (pos - n)[:, None] + torch.arange(C, device=dev)[None, :]
            mask = ring_attend_mask(p32, l32, cap, qpos, window)[:, None]
            qt, kt, vt = (x.transpose(1, 2).contiguous().to(qdt)
                          for x in (q, k, v))
            lib = gpu_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        resident = int(length.sum())
        kv_b = 1 if kv_name == "int8" else k.element_size()
        nbytes = (q.numel() * q.element_size() + resident * K * hd * 2 * kv_b
                  + (resident * K * 2 * 4 if kv_name == "int8" else 0)
                  + B * C * H * hd * 4 + 3 * B * 4)
        ops_n = 4 * resident * C * (H // K) * K * hd
        records.append(_record(
            "ring_decode", case, "src/repro_torch/kernels/csrc/ring_decode.cu",
            "src/repro/kernels/ring_decode.py:115", err, ms, plain, lib,
            nbytes, ops_n, kv_name))

    # bgmv: main-path projections (wq/wo 2048->2048, wk/wv 2048->512);
    # rows on adapters of ranks 0 (base), 3, 8, 16
    P, pr, Pmax, din = 32, 4, 4, 2048
    rank = torch.tensor([0, 3, 8, 16, 0], dtype=torch.int32, device=dev)
    table = torch.randperm(P, generator=gen, device=dev)[:20].reshape(5, 4)
    table = table.to(torch.int32)
    scale = torch.tensor([0.0, 2.0, 2.0, 2.0, 0.0], device=dev)
    ids = torch.tensor([0, 1, 2, 3, 1, 2, 3, 0], dtype=torch.int32, device=dev)
    for dt_name, C, dout in (("bfloat16", 1, 2048), ("bfloat16", 1, 512),
                             ("bfloat16", 16, 2048), ("bfloat16", 16, 512),
                             ("float32", 1, 2048), ("float32", 16, 512)):
        dt = getattr(torch, dt_name)
        x = torch.randn(8, C, din, generator=gen, device=dev).to(dt)
        a = (torch.randn(P, pr, din, generator=gen, device=dev) * 0.05).to(dt)
        b = (torch.randn(P, dout, pr, generator=gen, device=dev) * 0.05).to(dt)
        args = (x, a, b, table, rank, scale, ids)
        got = ops.bgmv(*args)
        want = ref.bgmv_ref(*args)
        torch.cuda.synchronize()
        base = rank[ids.long()] == 0
        if (got[base] != 0).any():
            fail("bgmv: a rank-0 row is not an exact zero")
        case = (f"{'bf16' if dt_name == 'bfloat16' else dt_name}, C={C}, B=8 "
                f"din={din} dout={dout} pr={pr} Pmax={Pmax}")
        err = check(f"bgmv[{case}]", got, want,
                    torch.ones(8, dtype=torch.bool, device=dev),
                    1e-4 if dt_name == "float32" else 2e-3)
        ms = gpu_ms(torch, lambda: ops.bgmv(*args))
        plain = gpu_ms(torch, lambda: ref.bgmv_ref(*args))
        eb = x.element_size()
        distinct = sorted(set(ids.tolist()))
        r_rows = [int(rank[i]) for i in ids.tolist()]
        nbytes = (x.numel() * eb + sum(int(rank[i]) for i in distinct)
                  * (din + dout) * eb + 8 * C * dout * 4)
        ops_n = 2 * C * sum(r_rows) * (din + dout)
        records.append(_record(
            "bgmv", case, "src/repro_torch/kernels/csrc/bgmv.cu",
            "src/repro/kernels/bgmv.py:55", err, ms, plain, None, nbytes,
            ops_n, dt_name))
    return records


def _record(name, case, source, replaces, err, ms, plain, lib, nbytes, ops_n,
            dtype, library=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_n / PEAK_OPS[dtype] * 1e3
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "case": case, "max_abs_err": err, "ms": ms,
           "plain_ms": plain, "library_ms": lib,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops_n}
    if library is not None:
        rec["library"] = library
    print(f"  {name}[{case}]: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"library {'-' if lib is None else f'{lib:.4f} ms'}, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
          f"{nbytes / 1e6:.2f} MB, {ops_n / 1e9:.3f} GFLOP)")
    return rec


# -- phases 2 and 3 for the federated round's kernels ------------------------

LORA_MAIN = "bf16, M=2048 din=2048 dout=2048 r=16"
FLASH_MAIN = "bf16, causal, B=4 S=512 H=32 K=8 hd=64"
GRAM_MAIN = "fp32, G=32 m=2048 r=64"


def _causal_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible: the work this run needs."""
    total = 0
    for s in range(S):
        hi = min(T, s + 1) if causal else T
        lo = max(0, s - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def train_kernel_cases(torch):
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    records = []
    print("phase 2/3: the federated round's kernels against plain versions; "
          "times beside bounds")
    dname = {torch.bfloat16: "bf16", torch.float32: "fp32"}

    # lora_matmul: the train step's projections (M = 4 x 512 tokens; wq/wo
    # 2048 -> 2048, wk/wv 2048 -> 512) at the round's client ranks, and one
    # ragged M / dout / rank.  bf16: both sides round z and s·B at the same
    # points; the plain version rounds x W and the delta to bf16 before
    # adding, the kernel once at the end, so they differ by up to 2 bf16
    # ulps of the output (an ulp is up to 2^-7 of |y|): limit 2e-2 of
    # max |y|.  fp32 (TF32 off): sum order over din = 2048: limit 1e-4.
    for dt, M, dout, r in ((torch.bfloat16, 2048, 2048, 16),
                           (torch.bfloat16, 2048, 512, 16),
                           (torch.bfloat16, 2048, 2048, 4),
                           (torch.bfloat16, 2048, 2048, 32),
                           (torch.bfloat16, 2048, 512, 32),
                           (torch.bfloat16, 1999, 1000, 7),
                           (torch.float32, 2048, 2048, 16),
                           (torch.float32, 2048, 512, 32),
                           (torch.float32, 1999, 1000, 7)):
        din = 2048
        x = torch.randn(M, din, generator=gen, device=dev).to(dt)
        w = (torch.randn(din, dout, generator=gen, device=dev) / din ** 0.5).to(dt)
        a = torch.randn(r, din, generator=gen, device=dev) * 0.02
        b = torch.randn(dout, r, generator=gen, device=dev) * 0.05
        scale = torch.tensor(16.0 / r, device=dev)
        a_c, b_s = ops.lora_operands(x, w, a, b, scale)
        got = ops.lora_matmul(x, w, a, b, scale)
        want = ref.lora_matmul_ref(x, w, a_c, b_s, 1.0)
        torch.cuda.synchronize()
        case = f"{dname[dt]}, M={M} din={din} dout={dout} r={r}"
        err = check(f"lora_matmul[{case}]", got, want,
                    torch.ones(M, dtype=torch.bool, device=dev),
                    2e-2 if dt == torch.bfloat16 else 1e-4)
        ms = gpu_ms(torch, lambda: ops.lora_matmul(x, w, a, b, scale))
        plain = gpu_ms(torch, lambda: ref.lora_matmul_ref(x, w, a_c, b_s, 1.0))
        lib = gpu_ms(torch, lambda: torch.matmul(x, w))
        eb = x.element_size()
        nbytes = eb * (M * din + din * dout + r * din + dout * r + M * dout)
        ops_n = 2 * M * din * dout + 2 * M * r * (din + dout)
        records.append(_record(
            "lora_matmul", case, "src/repro_torch/kernels/csrc/lora_matmul.cu",
            "src/repro/kernels/lora_matmul.py:31", err, ms, plain, lib, nbytes,
            ops_n, str(dt).split(".")[-1],
            library="torch.matmul(x, W): base product only"))

    # flash_attention: the train step's attention (B 4, S 512, 32 heads over
    # 8 KV heads, hd 64), a window, a ragged S and hd 128.  Each query row
    # is held to its own magnitude: a row that averages hundreds of values
    # is ~20x smaller than the first rows, so one limit over the whole
    # output would let an error in the long rows through.  bf16: the kernel
    # rounds its output to bf16 (up to 2^-8 of an entry) and P to bf16
    # before P·V (as the TPU kernel does); the plain version stays fp32:
    # limit 1e-2 of the row's max |plain| (6.5e-3 measured at most).  fp32:
    # sum order and exp rounding: limit 1e-5 of it (2.3e-6 measured).
    for dt, B, S, H, K, hd, window in (
            (torch.bfloat16, 4, 512, 32, 8, 64, 0),
            (torch.bfloat16, 4, 512, 32, 8, 64, 128),
            (torch.bfloat16, 4, 500, 32, 8, 64, 0),
            (torch.bfloat16, 4, 512, 16, 4, 128, 0),
            (torch.float32, 4, 512, 32, 8, 64, 0),
            (torch.float32, 2, 300, 16, 4, 128, 100),
            (torch.float32, 1, 77, 4, 1, 16, 0)):
        q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(B, S, K, hd, generator=gen, device=dev).to(dt)
        v = torch.randn(B, S, K, hd, generator=gen, device=dev).to(dt)
        got = ops.flash_attention(q, k, v, True, window)
        want = ref.flash_attention_ref(q, k, v, True, window)
        torch.cuda.synchronize()
        case = (f"{dname[dt]}, causal{f', window={window}' if window else ''}, "
                f"B={B} S={S} H={H} K={K} hd={hd}")
        err = check_rows(f"flash_attention[{case}]", got, want,
                         1e-2 if dt == torch.bfloat16 else 1e-5)
        ms = gpu_ms(torch, lambda: ops.flash_attention(q, k, v, True, window))
        plain = gpu_ms(torch, lambda: ref.flash_attention_ref(q, k, v, True,
                                                              window))
        lib = None
        if not window:      # one SDPA call, on pre-transposed inputs
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = gpu_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        eb = q.element_size()
        nbytes = eb * (2 * q.numel() + k.numel() + v.numel())
        ops_n = 4 * B * H * hd * _causal_pairs(S, S, True, window)
        records.append(_record(
            "flash_attention", case,
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:70", err, ms, plain, lib,
            nbytes, ops_n, str(dt).split(".")[-1],
            library=None if window else
            "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"))

    # adapter_gram: the Gram SVD route's stacks, a bucket of 2 leaves x 16
    # layers, m = 2048 (wq/wo, and every A stack) or 512 (wk/wv B stacks),
    # r = Σ r_k up to 128, and a tail m.  fp32 FMAs on both sides (TF32
    # off), sums in another order over m rows: limit 1e-4 of max |xᵀx|.
    # xᵀx is symmetric, so the function needs only its r(r+1)/2 distinct
    # entries, m multiply-adds each: G·m·r·(r+1) operations for the bound.
    for G, m, r in ((32, 2048, 64), (32, 2048, 16), (32, 2048, 128),
                    (32, 512, 16), (32, 512, 64), (32, 512, 128),
                    (32, 2000, 60)):
        x = torch.randn(G, m, r, generator=gen, device=dev) * 0.05
        got = ops.adapter_gram(x)
        want = ref.adapter_gram_ref(x)
        torch.cuda.synchronize()
        case = f"fp32, G={G} m={m} r={r}"
        err = check(f"adapter_gram[{case}]", got, want,
                    torch.ones(G, dtype=torch.bool, device=dev), 1e-4)
        ms = gpu_ms(torch, lambda: ops.adapter_gram(x))
        plain = gpu_ms(torch, lambda: ref.adapter_gram_ref(x))
        lib = gpu_ms(torch, lambda: torch.bmm(x.mT, x))
        nbytes = 4 * (G * m * r + G * r * r)
        records.append(_record(
            "adapter_gram", case, "src/repro_torch/kernels/csrc/adapter_gram.cu",
            "src/repro/kernels/adapter_gram.py:41", err, ms, plain, lib, nbytes,
            G * m * r * (r + 1), "float32", library="torch.bmm(x.mT, x)"))
    return records


# -- phase 4: the slice end to end ------------------------------------------

def end_to_end(torch):
    from repro_torch.configs.llama3p2_1b import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import MAX_TOKENS, N_REQUESTS, serve
    print(f"phase 4: {CONFIG.name} at full width ({CONFIG.num_layers} L, "
          f"d {CONFIG.d_model}, {CONFIG.num_heads} H / {CONFIG.num_kv_heads} KV, "
          f"hd {CONFIG.head_dim}, d_ff {CONFIG.d_ff}, vocab {CONFIG.vocab_size}, "
          f"{CONFIG.dtype}), random seeded weights, decode_impl=kernel")
    ops.reset_launch_counts()
    out = serve("llama3p2_1b", device="cuda", log=lambda s: print("  " + s))
    counts = ops.launch_counts()
    stats = out["stats"]
    steps = out["engine"].steps_run
    L = CONFIG.num_layers
    print(f"  kernels: {json.dumps(counts)} over {steps} engine steps "
          f"(expected ring_decode {L * steps}, bgmv {L * 4 * steps})")
    if counts["ring_decode"] != L * steps or counts["bgmv"] != L * 4 * steps:
        fail("launch counts do not match the engine steps")
    res = out["results"]
    if (len(res) != N_REQUESTS
            or any(len(t) != MAX_TOKENS for t in res.values())):
        fail(f"expected {N_REQUESTS} requests x {MAX_TOKENS} tokens, got "
             f"{ {u: len(t) for u, t in res.items()} }")
    if stats["decode_tokens"] + stats["prefill_step_tokens"] != stats["generated_tokens"]:
        fail(f"the step log accounts for {stats['decode_tokens']} + "
             f"{stats['prefill_step_tokens']} tokens, the requests hold "
             f"{stats['generated_tokens']}")
    if any(not 0 <= x < CONFIG.vocab_size for t in res.values() for x in t):
        fail("a generated token is outside the vocabulary")
    ids = sorted(set(out["served_by"].values()))
    old, new = out["swap"]
    if len(ids) < 4 or new not in ids or old not in ids or 0 not in ids:
        fail(f"traffic did not cover base, old and new adapter ids: {ids}")
    print(f"  served {len(res)} requests on adapter ids {ids}; "
          f"swap {old} -> {new}")
    print(f"  prefill {stats['prefill_tok_s']:.1f} prompt tok/s over "
          f"{stats['prefill_steps']} steps (median "
          f"{stats['prefill_step_ms_median']:.3f} ms; they also emitted "
          f"{stats['prefill_step_tokens']} tokens); decode "
          f"{stats['decode_tok_s']:.1f} tok/s ({stats['decode_tokens']} tokens "
          f"over {stats['decode_steps']} steps, median "
          f"{stats['decode_step_ms_median']:.3f} ms); end to end "
          f"{stats['e2e_tok_s']:.1f} generated tok/s over a wall of "
          f"{stats['wall_s']:.2f} s")
    window = profile_decode(torch, out["engine"])
    del out
    torch.cuda.empty_cache()
    return dict(stats, launches=counts, profiled_decode=window), counts


def profile_decode(torch, eng, steps: int = 10):
    """Where a decode step's time goes: ``steps`` width-1 engine steps of a
    fresh full batch, once under ``torch.profiler`` (device time by kernel)
    and once without it (wall time per step)."""
    from repro_torch.serve.engine import SamplingParams

    for i in range(eng.B):
        eng.submit(list(range(1 + i, 17 + i)),
                   SamplingParams(max_tokens=2 * steps + 4))
    eng.run_steps(2)                       # admission and the prefill step
    torch.cuda.synchronize()
    out = profile_window(torch, eng.run_steps, steps,
                         f"decode step, {steps} steps x {eng.B} rows")
    eng.run()
    return out


def profile_window(torch, run, steps: int, label: str):
    """``run(steps)`` once under ``torch.profiler`` (device time by kernel,
    host time by operator) and once without it (wall time per step); the
    idle share is 1 - device busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_kernel, by_op = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:          # kernels and copies
            by_kernel[e.key] = e.self_device_time_total / 1e3 / steps
        elif e.self_cpu_time_total > 0:                # host operators
            by_op[e.key] = e.self_cpu_time_total / 1e3 / steps
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    print(f"  {label}: wall {wall_ms:.3f} ms per step (no profiler); device "
          f"busy {busy:.3f} ms per step (profiler): idle share "
          f"{1 - busy / wall_ms:.3f}")
    for name, ms in top:
        print(f"    device {ms:8.4f} ms/step  {name[:80]}")
    for name, ms in top_host:
        print(f"    host   {ms:8.4f} ms/step  {name[:80]} (under the profiler)")
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
            "idle_share": 1 - busy / wall_ms,
            "top_kernels_ms_per_step": dict(top),
            "top_host_ops_ms_per_step_profiled": dict(top_host)}


# -- phase 5: the engine, kernels against plain versions --------------------

def engine_parity(torch):
    import numpy as np
    from repro_torch.configs.llama3p2_1b import CONFIG
    from repro_torch.device import parity_mode
    from repro_torch.launch.serve import TARGETS, make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    from repro_torch.serve.adapters import AdapterRegistry, attach
    from repro_torch.serve.engine import SamplingParams, ServeEngine
    print("phase 5: engine on the card, kernels vs plain versions, "
          "full width in fp32; " + parity_mode())
    cfg = CONFIG.replace(dtype="float32")
    dev = torch.device(DEVICE)
    params = T.init(cfg, 1, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    reg = AdapterRegistry(init_lora(params, TARGETS, 4, 8.0, gen), page_rank=4,
                          max_rank=16, device=dev)
    aid = [0] + [reg.register(f"r{r}", make_adapter(params, r, gen,
                                                     torch.float32))
                 for r in (4, 8, 16)]
    rng = np.random.default_rng(3)
    B, C = 8, 16
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, C)), device=dev)
    n = torch.tensor([16, 16, 9, 16, 3, 16, 16, 1], dtype=torch.int32, device=dev)
    ids = torch.tensor([aid[i % 4] for i in range(B)], dtype=torch.int32,
                       device=dev)
    lg = {}
    for impl, lora in (("kernel", "kernel"), ("dense", "plain")):
        cache = T.init_cache(cfg, B, 1024, torch.float32, prefill_chunk=C,
                             device=dev)
        lg[impl], _ = T.decode(cfg, params, cache, {"tokens": toks},
                               attach(reg.device_state, ids, impl=lora),
                               n_tokens=n, decode_impl=impl)
    valid = torch.arange(C, device=dev)[None, :] < n[:, None]
    # fp32 on both sides, TF32 off; sums in another order in attention and
    # the LoRA delta, carried through 16 layers into logits of size ~1
    err = check("first prefill step logits", lg["kernel"], lg["dense"], valid,
                1e-3)

    outs = {}
    for impl in ("kernel", "dense"):
        eng = ServeEngine(cfg, params, registry=reg, batch_slots=B,
                          capacity=1024, prefill_chunk=C, decode_impl=impl,
                          device=dev)
        prng = np.random.default_rng(4)
        uids = [eng.submit(prng.integers(1, cfg.vocab_size,
                                         int(prng.integers(32, 65))).tolist(),
                           SamplingParams(max_tokens=16), adapter_id=aid[i % 4])
                for i in range(B)]
        res = eng.run()
        outs[impl] = [res[u] for u in uids]
    pairs = [(a, b) for ra, rb in zip(outs["kernel"], outs["dense"])
             for a, b in zip(ra, rb)]
    agree = sum(a == b for a, b in pairs) / max(1, len(pairs))
    print(f"  greedy-token agreement over 16 steps x {B} requests: "
          f"{agree:.4f} ({sum(a == b for a, b in pairs)}/{len(pairs)})")
    return {"logits_max_abs_err": err, "greedy_agreement": agree}


# -- phase 6: the federated slice end to end ---------------------------------

FED_ROUNDS = 2
FED_SEQ = 512
FED_BATCH = 4


def federated_round(torch):
    import numpy as np
    from repro_torch.common.config import FedConfig, LoRAConfig, OptimConfig
    from repro_torch.configs.llama3p2_1b import CONFIG
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.core.runtime import SequentialRunner
    from repro_torch.core.runtime.runners import to_device
    from repro_torch.data.synthetic import make_eval_data
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import adamw_init
    cfg = CONFIG
    L = cfg.num_layers
    print(f"phase 6: {FED_ROUNDS} FLoRIST rounds of {cfg.name} at full width "
          f"({L} L, d {cfg.d_model}, {cfg.num_heads} H / {cfg.num_kv_heads} KV, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}; random seeded weights), 8 "
          f"clients of ranks 4/8/16/32, 4 a round, 4 local steps of "
          f"{FED_BATCH} x {FED_SEQ} tokens, Gram SVD route")
    fed = FedConfig(num_clients=8, clients_per_round=4, heterogeneous=True,
                    rank_distribution=((4, 2), (8, 2), (16, 2), (32, 2)),
                    tau=0.9, method="florist")
    lora = LoRAConfig(rank=16, alpha=16.0, targets=("wq", "wk", "wv", "wo"))
    runner = SequentialRunner(record_steps=True)
    t0 = time.perf_counter()
    tr = FederatedTrainer(cfg, fed, lora, OptimConfig(lr=3e-4),
                          eval_data=make_eval_data(num_samples=16,
                                                   seq_len=FED_SEQ,
                                                   vocab=cfg.vocab_size),
                          batch_size=FED_BATCH, local_steps=4, seq_len=FED_SEQ,
                          svd_method="gram", runner=runner, device=DEVICE)
    torch.cuda.synchronize()
    print(f"  set-up (weights, data, trainer): {time.perf_counter() - t0:.1f} s")
    rounds = []
    ops.reset_launch_counts()
    for rnd in range(FED_ROUNDS):
        before, n_log = ops.launch_counts(), len(runner.step_log())
        rec = tr.run_round(rnd)
        after = ops.launch_counts()
        step_ms = [e["ms"] for e in runner.step_log()[n_log:]]
        steps = len(step_ms)
        buckets = len({(n, m) for _, n, m in tr.aggregator.dims.values()})
        want = {"lora_matmul": L * len(lora.targets) * steps,
                "flash_attention": L * (steps + 1),          # + one eval step
                "adapter_gram": 2 * buckets}                 # B and A stacks
        got = {k: after[k] - before[k] for k in want}
        ranks = tr.global_state.ranks
        r_sum = sum(tr.aggregator.client_ranks)
        tok_s = steps * FED_BATCH * FED_SEQ / (sum(step_ms) / 1e3)
        print(f"  round {rnd}: eval loss {rec.eval_loss:.4f} acc "
              f"{rec.eval_acc:.4f}; clients of ranks "
              f"{tr.aggregator.client_ranks} (Σ {r_sum}); upload "
              f"{rec.upload_bytes} B, download {rec.download_bytes} B; wall "
              f"{rec.wall_secs:.2f} s, finalize {rec.finalize_secs * 1e3:.1f} "
              f"ms; {steps} train steps, median {statistics.median(step_ms):.2f}"
              f" ms (CUDA events), {tok_s:.0f} train tok/s")
        for path, ps in ranks.items():
            print(f"    kept ranks {'/'.join(map(str, path))}: {ps}")
        print(f"    launches {json.dumps(got)}; expected {json.dumps(want)}")
        if got != want:
            fail(f"round {rnd}: launch counts {got} != {want}")
        if not np.isfinite(rec.eval_loss):
            fail(f"round {rnd}: eval loss {rec.eval_loss} is not finite")
        if any(not 1 <= p <= r_sum for ps in ranks.values() for p in ps):
            fail(f"round {rnd}: a kept rank is outside [1, {r_sum}]")
        rounds.append({"record": dataclasses.asdict(rec),
                       "ranks": {"/".join(map(str, k)): v
                                 for k, v in ranks.items()},
                       "client_ranks": list(tr.aggregator.client_ranks),
                       "train_step_ms": step_ms,
                       "train_step_ms_median": statistics.median(step_ms),
                       "train_tok_s": tok_s, "launches": got})
    counts = {k: v for k, v in ops.launch_counts().items()
              if k in ("lora_matmul", "flash_attention", "adapter_gram")}

    # a window of train steps of one rank-16 client, profiled
    step = tr._train_step()
    data = tr.clients[0]
    batch = {"tokens": torch.as_tensor(data.tokens[:FED_BATCH], device=DEVICE).long(),
             "loss_mask": torch.as_tensor(data.loss_mask[:FED_BATCH], device=DEVICE)}
    state = {"a": to_device(tr._client_init(0, 16), tr.device)}
    state["opt"] = adamw_init(state["a"])

    def run(n):
        for _ in range(n):
            state["a"], state["opt"], _ = step(tr.params, state["a"],
                                               state["opt"], batch)

    run(1)
    window = profile_window(torch, run, 3,
                            f"train step, {FED_BATCH} x {FED_SEQ} tokens, r=16")
    del tr, state
    torch.cuda.empty_cache()
    return {"rounds": rounds, "launches": counts,
            "profiled_train_step": window}, counts


# -- phase 7: the federated path, kernels against plain routes, fp32 ---------

def federated_parity(torch):
    import numpy as np
    from repro_torch.common.config import OptimConfig
    from repro_torch.configs.llama3p2_1b import CONFIG
    from repro_torch.core.aggregators import FloristAggregator
    from repro_torch.data.synthetic import make_federated_data
    from repro_torch.device import parity_mode
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.peft.lora import init_lora
    from repro_torch.train.step import make_train_step
    cfg = CONFIG.replace(dtype="float32", num_layers=4)
    L = cfg.num_layers
    print(f"phase 7: federated path on the card, kernel routes vs plain routes, "
          f"full width in fp32, depth cut to {L} layers; " + parity_mode())
    dev = torch.device(DEVICE)
    params = T.init(cfg, 3, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    ad = init_lora(params, ("wq", "wk", "wv", "wo"), 16, 16.0, gen)
    for leaf in ad["blocks"][0]["attn"].values():   # B ≠ 0: dscale ≠ 0 at once
        leaf["B"] = torch.randn(leaf["B"].shape, generator=gen, device=dev) * 0.01
    data = make_federated_data(num_clients=1, seq_len=FED_SEQ,
                               vocab=cfg.vocab_size, seed=5)[0]
    batches = [{"tokens": torch.as_tensor(data.tokens[i:i + 2], device=dev).long(),
                "loss_mask": torch.as_tensor(data.loss_mask[i:i + 2], device=dev)}
               for i in (0, 2)]
    lr = 3e-4
    out = {}
    for use_kernels in (True, False):
        step = make_train_step(cfg, OptimConfig(lr=lr), loss_chunk=64,
                               use_kernels=use_kernels)
        a, opt, losses = ad, adamw_init(ad), []
        for b in batches:
            a, opt, m = step(params, a, opt, b)
            losses.append(float(m["loss"]))
        out[use_kernels] = (losses, a)
    res = {"losses_kernel": out[True][0], "losses_plain": out[False][0]}
    # the losses: fp32 on both routes, sums in another order through 4
    # layers and a 128k-vocabulary logsumexp: limit 1e-5 relative
    for i, (lk, lp) in enumerate(zip(out[True][0], out[False][0])):
        ok = abs(lk - lp) <= 1e-5 * max(1.0, abs(lp))
        print(f"  train step {i + 1} loss: kernel {lk:.7f}, plain {lp:.7f} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("phase 7: train-step losses of the two routes differ")
    # the adapters after 2 steps.  Adam divides by |g|: an entry whose
    # gradient is within fp noise of zero can step by up to lr one way on
    # one route and the other way on the other, so A and B are held to a
    # mean |Δ| ≤ 1e-3·lr (a wrong gradient would move most entries by ~lr)
    # and a share of entries with |Δ| > 0.1·lr of at most 1e-5 (4 of 0.85 M
    # entries, 4.7e-6, measured; no bound on max |Δ| can fail: an Adam step
    # moves an entry by at most ~lr).
    # scale's gradient sums over every token and is never near zero: max
    # |Δ| ≤ 1e-6.
    ka = tree_leaves(out[True][1])
    pa = tree_leaves(out[False][1])
    keys = [k for _, leaf in sorted(ad["blocks"][0]["attn"].items())
            for k in sorted(leaf)]
    d_ab = torch.cat([(x - y).abs().flatten() for x, y, k in zip(ka, pa, keys)
                      if k != "scale"])
    d_s = torch.cat([(x - y).abs().flatten() for x, y, k in zip(ka, pa, keys)
                     if k == "scale"])
    mean_ab, max_ab, max_s = float(d_ab.mean()), float(d_ab.max()), float(d_s.max())
    n_far = int((d_ab > 0.1 * lr).sum())
    far = n_far / d_ab.numel()
    res.update(adapters_mean_abs_diff=mean_ab, adapters_max_abs_diff=max_ab,
               adapters_share_above_0p1_lr=far, scale_max_abs_diff=max_s)
    print(f"  adapters after 2 steps: mean |Δ| {mean_ab:.3e} (limit "
          f"{1e-3 * lr:.1e}); |Δ| > 0.1·lr on {n_far} of {d_ab.numel()} entries"
          f" ({far:.2e}, limit 1e-5); max |Δ| {max_ab:.3e}; scale max |Δ| "
          f"{max_s:.3e} (limit 1e-6)")
    if mean_ab > 1e-3 * lr or far > 1e-5 or max_s > 1e-6:
        fail("phase 7: the adapters of the two routes differ")

    # one finalize on the Gram route (adapter_gram) against the LAPACK route
    clients, ranks = [], (4, 8, 16, 32)
    for r in ranks:
        tree = {"blocks": {0: {"attn": {}}}}
        for name, wt in sorted(params["blocks"][0]["attn"].items()):
            if name not in ("wq", "wk", "wv", "wo"):
                continue
            _, din, dout = wt.shape
            tree["blocks"][0]["attn"][name] = {
                "A": torch.randn(L, r, din, generator=gen, device=dev) * 0.02,
                "B": torch.randn(L, dout, r, generator=gen, device=dev) * 0.01,
                "scale": torch.full((L,), 16.0 / r, device=dev)}
        clients.append(tree)
    w = np.random.default_rng(7).dirichlet(np.ones(len(ranks)))
    agg = {m: FloristAggregator(tau=0.9, svd_method=m).aggregate(clients, w)
           for m in ("gram", "svd")}
    worst_s = worst_p = 0.0
    for path, ps in agg["svd"].ranks.items():
        if agg["gram"].ranks[path] != ps:
            fail(f"phase 7: kept ranks of {path} differ: "
                 f"{agg['gram'].ranks[path]} vs {ps}")
        for sg, sv in zip(agg["gram"].spectra[path], agg["svd"].spectra[path]):
            # the Gram route resolves σ down to σ_max·√(r·eps) only
            big = sv > 2 * sv[0] * np.sqrt(len(sv) * np.finfo(np.float32).eps)
            worst_s = max(worst_s, float(np.abs(sg - sv)[big].max() / sv[0]))
        gl = agg["gram"].global_adapters
        sl = agg["svd"].global_adapters
        for k in path:
            gl, sl = gl[k], sl[k]
        pg = torch.einsum("lmr,lrn->lmn", gl["B"], gl["A"])
        pv = torch.einsum("lmr,lrn->lmn", sl["B"], sl["A"])
        worst_p = max(worst_p, float((pg - pv).abs().max() / pv.abs().max()))
    # fp32: the Gram route squares the condition number; above its
    # resolution limit spectra and products agree to 1e-4 of their largest
    print(f"  finalize gram vs svd: ranks equal on {len(agg['svd'].ranks)} "
          f"leaves x {L} layers; spectra max rel err {worst_s:.2e}, B_g A_g "
          f"max rel err {worst_p:.2e} (limit 1e-4)")
    if worst_s > 1e-4 or worst_p > 1e-4:
        fail("phase 7: the Gram route disagrees with the LAPACK route")
    res.update(spectra_max_rel_err=worst_s, products_max_rel_err=worst_p,
               kept_ranks={"/".join(map(str, k)): v
                           for k, v in agg["svd"].ranks.items()})
    return res


if __name__ == "__main__":
    main()
