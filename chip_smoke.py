#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no exception is caught):

1. Print the card's name and power limit; build the seven CUDA kernels
   from the sources in the checkout, one ``nvcc`` each, all at once (set-up
   time).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with the tolerance stated beside each comparison;
   ``ring_decode`` also on rings of one and four tiles (one split, no
   merge), at head dims 16, 32 and 128, with n_tokens ragged across rows
   at C 16, and at the edges of each of its four routes (8, 12, 16, 20 and
   64 query rows a KV head); ``mla_ring_decode`` at DeepSeek-V3's latent
   widths (bf16 at C 1 and 16, a window, int8 with per-half scales, fp32);
   ``bgmv`` at the Llama and the MLA projections; ``lora_matmul``,
   ``flash_attention`` and ``adapter_gram`` at the federated round's
   shapes, ragged edges included (``adapter_gram`` also on A stacks read
   where they lie, at the delta route's r 512, twice for equal bits;
   ``flash_attention`` in bf16 also at hd
   16 and 32, T > S, group sizes 1, 2, 3 and 8, windows shorter than a
   tile and longer than S, non-causal); ``wkv6`` at RWKV6-1.6B's prefill
   shape (bf16 and fp32), at strong decay (w = -exp(N(1, 1))) and on a
   ragged sequence, its launch arithmetic held to the built kernel's.  The
   widths the padded tiles opened: ``flash_attention`` and ``ring_decode``
   at head dims 56 and 96 (ring with bf16, fp32 and int8 caches),
   ``mla_ring_decode`` at latent 32 + 16, ``wkv6`` at head dim 32;
   ``lora_matmul`` also at ranks 64 and 128 and on its WMMA route (dout
   1003).  Then the two SMOKE
   configs those widths belong to, end to end through the kernels with
   their launch counts: one ``make_prefill_step(rwkv6_1p6b.SMOKE,
   use_kernels=True)`` call in fp32 (held to the plain route) and in bf16,
   and the ``deepseek_smoke`` engine serving phase 4's traffic, held to its
   plain route as phase 5 does.
3. Each kernel's time (median of 50 launches, CUDA events, L2 flushed
   before each), its bound, its plain version's time and a one-call
   PyTorch yardstick where one exists; ``ring_decode``'s device time by
   kernel at its two main cases (``torch.profiler``: the splits merge in
   the same launch, so one kernel); for ``lora_matmul``, which no one call
   computes, the base product alone (``torch.matmul``) and, at its two
   main shapes, the unfused ``torch.addmm(x W, x Aᵀ, (s·B)ᵀ)``.
4. The serving slice end to end: full-width Llama-3.2-1B (random seeded
   weights, bf16) serving 16 requests over three adapters of ranks 4/8/16
   and the base model, with a mid-flight swap, through
   ``decode_impl="kernel"``; the kernels' launch counts must equal 16 x
   (and 16 x 4 x) engine steps; profiled windows of decode steps, one
   with every row on the base id and one with the rows on the live
   adapters (phases 8 and 11 as well).
5. The engine on the card, kernels against plain versions, at full width in
   fp32 with TF32 off: first prefill step's logits within tolerance, and
   the greedy-token agreement over 16 steps.
6. The federated slice end to end: two FLoRIST rounds of full-width
   Llama-3.2-1B (random seeded weights, bf16; 8 clients of ranks 4/8/16/32,
   4 sampled a round, 4 local steps of 4 × 512 tokens, the Gram SVD route)
   through ``FederatedTrainer``; eval loss, kept ranks, wire bytes, round
   and finalize times, train-step times and tokens/s per round; launch
   counts held to what the code implies; a profiled window of train steps
   and one of FLoRIST finalizes (no copy before an A stack's
   ``adapter_gram``).
7. The federated path on the card in fp32 with TF32 off, at full width and
   4 layers: two train steps on the kernel route against the plain route
   (loss, adapters, ``scale``), and one FLoRIST finalize on the Gram route
   against the LAPACK route (ranks, spectra, ``B_g A_g``).
8. The MLA serving slice end to end: DeepSeek-V3 at published widths, cut
   to its three dense MLA layers (random seeded weights, bf16), phase 4's
   traffic with adapters on the five MLA targets; ``mla_ring_decode`` must
   run 3 times and ``bgmv`` 12 times (4 targets x 3 layers; ``wkv_b`` is
   folded into the absorbed weights) per engine step; 16 of 16 requests
   with 32 tokens; rates and a profiled window of decode steps.
9. Phase 5 on phase 8's model in fp32 (TF32 off), once with a bf16 and once
   with an int8 latent cache: first-step logits within 5e-3 of max(1,
   |logit|) and the greedy tokens of the kernel and plain engines equal.
10. The RWKV6 prefill end to end: RWKV6-1.6B at published widths (random
    seeded weights, bf16, one rank-16 adapter on its five targets) through
    ``make_prefill_step(use_kernels=True)`` on 8 x 1024 tokens, three
    calls after a warm-up; ``wkv6`` must run 24 and ``lora_matmul`` 120
    times a call; tokens/s and a profiled window.
11. RWKV6 serving end to end: phase 4's traffic on RWKV6-1.6B, one token
    per engine step; ``bgmv`` must run 120 times per engine step (5 targets
    x 24 layers) and ``wkv6`` never; 16 of 16 requests with 32 tokens.
12. RWKV6 in fp32 (TF32 off) at full width: (a) the prefill step's kernel
    route against its plain route, (b) phase 5 on this model, (c) the
    kernel prefill's last logits against ``decode`` fed the same prompt one
    token at a time (registry adapter, ``bgmv``).
13. The paper's five methods (FLoRIST, FedIT, FFA-LoRA, FLoRA, FlexLoRA),
    two rounds each, through ``FederatedTrainer`` on TinyLlama-1.1B at
    published widths and full depth (random seeded weights, bf16, built
    once for the five trainers): LoRA r 16 on ``wq``/``wv``, 8
    Dirichlet(0.5) clients, 4 a round, 4 local steps of 4 × 512 tokens,
    the ``bf16`` wire, FLoRIST on the Gram route.  Launch counts (22 · 2 ·
    steps ``lora_matmul``, 22 · (steps + 1) ``flash_attention``, 2 ·
    buckets ``adapter_gram`` for FLoRIST and none for the others), wire
    bytes equal to 2 × the analytic counts, each method's kept ranks,
    FFA's frozen A bit for bit, FLoRA's merge and re-init, finite losses;
    (b) every finalize in fp32 on the card against the CPU (products
    within 1e-4 · max(1, |ΔW|)); the Table 4 counterpart's device times.
    Phase 2 holds ``lora_matmul`` (2048 → 256) and ``flash_attention``
    (32 H / 4 KV) at this path's shapes.

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
PEAK_OPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "int8": 1979e12}
REPS = 50
DEVICE = "cuda"
# the CUDA kernels of src/repro_torch/kernels/csrc, by function name
PORT_KERNELS = (r"\b(ring_decode_kernel|mla_ring_decode_(kernel|wgmma)|mla_merge_splits|"
                r"bgmv_kernel|"
                r"lora_matmul_(wgmma|wmma|f32)|flash_(bf16|f32)|gram_mma|wkv6_kernel)\b")


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
    ptxas = {}
    for name, log in sorted(logs.items()):
        regs = [int(w.split()[-1]) for w in re.findall(r"Used \d+", log)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill", log))
        ptxas[name] = {"kernels": len(regs), "max_registers": max(regs),
                       "spill_bytes": spills}
        print(f"  ptxas[{name}]: {len(regs)} kernels, at most {max(regs)} "
              f"registers per thread, {spills} bytes spilled")

    report = {"card": smi, "ptxas": ptxas, "gpu_ms_floor": gpu_floor(torch)}
    report["kernel_cases"] = (kernel_cases(torch) + bgmv_kernel_cases(torch)
                              + mla_kernel_cases(torch)
                              + train_kernel_cases(torch)
                              + wkv6_kernel_cases(torch))
    report["smoke_widths"] = smoke_widths(torch)
    report["e2e"], counts = end_to_end(torch)
    report["parity"] = engine_parity(torch)
    report["federated"], fed_counts = federated_round(torch)
    report["fed_parity"] = federated_parity(torch)
    counts.update(fed_counts)
    report["mla_e2e"], mla_counts = end_to_end(torch, "8", "deepseek_v3_dense3")
    # fp32, TF32 off; the routes sum in another order, so layer 1's output
    # differs by ~1e-7 of itself, and that flips the rounding of a few
    # latent elements that layers 2 and 3 write to a bf16 or int8 cache (a
    # flip moves an element by one bf16 ulp, 2^-8 of it, or one int8 step,
    # 1/127 of its half-row's absmax).  At reduced width on the CPU this
    # moves logits of max ~4.5 by 5.5e-4 (bf16) and 2.3e-3 (int8), against
    # 4.9e-6 with an fp32 cache (at full width on an H100: 1.9e-3 and
    # 1.6e-3 to 5.6e-3, logits of max ~5.2); a wrong mask, scale or row
    # moves them by O(0.1-1).  Limit 5e-3 of max(1, |logit|).
    report["mla_parity"] = engine_parity(
        torch, "9", "deepseek_v3_dense3", ("bfloat16", "int8"), 5e-3,
        require_equal=True)
    counts["mla_ring_decode"] = mla_counts["mla_ring_decode"]
    report["rwkv_prefill"], rwkv_counts = rwkv_prefill(torch)
    counts["wkv6"] = rwkv_counts["wkv6"]
    report["rwkv_e2e"], rwkv_serve_counts = end_to_end(torch, "11", "rwkv6_1p6b")
    report["rwkv_parity"] = rwkv_parity(torch)
    report["tinyllama"], tiny_counts = tinyllama_methods(torch)

    def case_rec(name, case):
        return next(r for r in report["kernel_cases"]
                    if r["name"] == name and r["case"] == case)

    def other_path(key, name, case):
        """The case at another path's shape, beside that path's launches."""
        rec = case_rec(name, case)
        return {f"{key}_case": case, f"{key}_max_abs_err": rec["max_abs_err"],
                f"{key}_ms": rec["ms"], f"{key}_bound_ms": rec["bound_ms"]} | {
                    f"{key}_{k}": rec[k] for k in LORA_EXTRA if k in rec}

    kernels = []
    for name, case in (("ring_decode", RING_MAIN),
                       ("mla_ring_decode", MLA_MAIN),
                       ("bgmv", BGMV_MAIN),
                       ("lora_matmul", LORA_MAIN),
                       ("flash_attention", FLASH_MAIN),
                       ("adapter_gram", GRAM_MAIN),
                       ("wkv6", WKV6_MAIN)):
        rec = case_rec(name, case)
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "case")}
            | {"launches": counts[name]}
            | ({"library": rec["library"]} if "library" in rec else {})
            | {k: rec[k] for k in LORA_EXTRA if k in rec}
            | ({"launches_mla_path": mla_counts["bgmv"],
                "launches_rwkv_path": rwkv_serve_counts["bgmv"]}
               | other_path("rwkv_path", "bgmv", BGMV_RWKV)
               if name == "bgmv" else {})
            | ({"launches_rwkv_prefill": rwkv_counts["lora_matmul"]}
               | other_path("rwkv_prefill", "lora_matmul", LORA_RWKV)
               if name == "lora_matmul" else {})
            | (other_path("a_stack", "adapter_gram", GRAM_A)
               if name == "adapter_gram" else {})
            | ({"launches_tinyllama_path": tiny_counts[name]}
               if name in tiny_counts else {})
            | (other_path("tinyllama_path", name, LORA_TINY)
               if name == "lora_matmul" else {})
            | (other_path("tinyllama_path", name, FLASH_TINY)
               if name == "flash_attention" else {}))
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

def gpu_ms(torch, fn, cold: bool = True) -> float:
    """Median device time of ``fn`` over REPS launches.  Before each launch
    the 50 MB L2 is flushed (the decode path reads each layer's cache and
    adapter pages once per step, cold; ``cold=False`` skips the flush, for
    the warm time) and the stream is held busy with a sleep, so the host's
    enqueue cost falls inside the sleep and the event pair encloses only
    the device work."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        if cold:
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


def gpu_floor(torch) -> dict:
    """The floor under :func:`gpu_ms`: an empty kernel (``torch.cuda._sleep``
    of 0 cycles) timed the same way, cold and warm.  A bound of 0.1–3 µs is
    read against this, the least one launch costs."""
    floor = {"ms": gpu_ms(torch, lambda: torch.cuda._sleep(0)),
             "warm_ms": gpu_ms(torch, lambda: torch.cuda._sleep(0), cold=False)}
    print(f"  gpu_ms floor (empty kernel): {floor['ms']:.4f} ms cold, "
          f"{floor['warm_ms']:.4f} ms warm")
    return floor


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


def check_rows(name, got, want, tol, floor: float = 1e-30):
    """Each row (the last axis) on its own scale: max |got - want| over the
    row must be <= tol * max(floor, max |want| over the row).  Returns max
    |got - want| over all rows."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    rel = (d.amax(-1) / w.abs().amax(-1).clamp_min(floor)).max().item()
    err, mean = d.max().item(), d.mean().item()
    ok = rel <= tol
    scale = "row max |plain|" if floor < 1 else f"max({floor:g}, row max |plain|)"
    print(f"  {name}: max_abs_err {err:.3e}, mean_abs_err {mean:.3e}; worst "
          f"row max |Δ| / {scale} {rel:.3e} (limit {tol:.1e}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


def kernel_cases(torch):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ring_decode import (MIN_TILES, TILE, plan, route,
                                                 split_tiles)
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
    # and the other head dims the kernel is built for.  Then the redesign's
    # edges: n_tokens ragged across all rows at C 16; 8 and 12 rows (route
    # "narrow": a partial 16-row tile), 16 at g 1 (a full one), 20 (route
    # "tensor": two 16-row tiles, the second partial), 64 at g 8; a ring of
    # 4 tiles (one split of exactly MIN_TILES); a cap that is not a tile
    # multiple, wrapped; fp32 at 12 rows (route "rows" with a partial
    # group); int8 at C 16 with ragged n.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    positions = {1024: [1500, 1024, 300, 16, 0, 700, 2100, 64],
                 1000: [1500, 1000, 300, 16, 0, 700, 2100, 64],
                 256: [300, 256, 100, 16, 0, 200, 600, 64],
                 64: [100, 64, 30, 16, 0, 70, 200, 48]}
    ragged_pos = [1030, 2047, 9, 3, 600, 0, 64, 1100]
    ragged_n = [16, 9, 3, 1, 16, 0, 12, 7]
    tol = {"float32": 1e-4, "bfloat16": 2e-3, "int8": 1e-4}
    # fp32: sum order across up to 1024 keys; bf16: both sides compute in
    # fp32 from the same stored bf16 values (the tensor-core route's bf16
    # products are exact in fp32 and P enters P·V as a bf16 hi + lo pair,
    # ≈ 2^-16 of P), margin for exp/sum order; int8: both dequantize per
    # token in fp32
    for kv_name, C, window, hd, cap, H, K, ragged in (
            ("bfloat16", 1, 0, 64, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 64, 1024, 32, 8, False),
            ("bfloat16", 1, 256, 64, 1024, 32, 8, False),
            ("bfloat16", 16, 256, 64, 1024, 32, 8, False),
            ("float32", 1, 0, 64, 1024, 32, 8, False),
            ("float32", 16, 0, 64, 1024, 32, 8, False),
            ("int8", 1, 0, 64, 1024, 32, 8, False),
            ("int8", 16, 0, 64, 1024, 32, 8, False),
            ("bfloat16", 1, 0, 64, 64, 32, 8, False),
            ("bfloat16", 16, 0, 64, 64, 32, 8, False),
            ("int8", 16, 32, 64, 64, 32, 8, False),
            ("bfloat16", 1, 0, 128, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 128, 1024, 32, 8, False),
            ("float32", 16, 0, 128, 1024, 32, 8, False),
            ("int8", 1, 0, 128, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 16, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 32, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 64, 1024, 32, 8, True),
            ("bfloat16", 16, 100, 64, 1000, 32, 8, True),
            ("bfloat16", 2, 0, 64, 1024, 32, 8, False),
            ("bfloat16", 3, 0, 64, 1000, 32, 8, False),
            ("bfloat16", 5, 0, 64, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 64, 1024, 8, 8, False),
            ("bfloat16", 8, 0, 64, 1024, 32, 4, False),
            ("bfloat16", 16, 0, 64, 256, 32, 8, False),
            ("int8", 1, 0, 32, 1000, 32, 8, False),
            ("float32", 3, 0, 16, 256, 32, 8, True),
            ("int8", 16, 0, 64, 1024, 32, 8, True),
            # head dims the padded tiles opened: 56 (qwen2-0.5B's SMOKE
            # config, 7 query heads a KV head here) and 96 (Phi-3-vision, no
            # grouping), on every route and cache dtype; int8 rows of 56
            # bytes travel as 8-byte copies
            ("bfloat16", 1, 0, 56, 1024, 28, 4, False),
            ("bfloat16", 16, 0, 56, 1024, 28, 4, False),
            ("bfloat16", 1, 0, 96, 1024, 32, 32, False),
            ("bfloat16", 16, 0, 96, 1024, 32, 32, False),
            ("float32", 16, 0, 56, 1024, 28, 4, False),
            ("float32", 1, 0, 96, 1024, 32, 32, False),
            ("int8", 1, 0, 56, 1024, 28, 4, False),
            ("int8", 16, 0, 56, 1000, 28, 4, True),
            ("int8", 16, 0, 96, 1024, 32, 32, False)):
        B = 8
        how = route(torch.float32 if kv_name == "float32" else torch.bfloat16,
                    getattr(torch, kv_name), H // K * C)
        nsplit = plan(B, C, H, K, cap, sms, how)[1]
        if (nsplit == 1) != (cap < 2 * MIN_TILES * TILE):
            fail(f"ring_decode: cap {cap}, C={C} plans {nsplit} splits; a "
                 f"split walks at least MIN_TILES = {MIN_TILES} resident "
                 f"tiles of {TILE} slots, so exactly the rings of fewer than "
                 f"{2 * MIN_TILES} tiles (cap < {2 * MIN_TILES * TILE}) plan "
                 "one split here")
        pos = torch.tensor(ragged_pos if ragged else positions[cap], device=dev)
        length = torch.clamp(pos, max=cap)
        want_n = ragged_n if ragged else [C, C, C, C, 0, min(5, C), 1, C]
        n = torch.minimum(pos, torch.tensor(want_n, device=dev).clamp(max=C)
                          ).to(torch.int32)
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
                f"{f', window={window}' if window else ''}"
                f"{', ragged n' if ragged else ''}, "
                f"B={B} H={H} K={K} hd={hd} cap={cap}")
        per_row = [len([t for t in range(nsplit) if split_tiles(
            int(pos[b]), int(length[b]), cap, nsplit, t)]) if int(n[b]) > 0 else 0
            for b in range(B)]
        err = check(f"ring_decode[{case}; route {how}, grid splits "
                    f"{nsplit}, per row {per_row}]", got,
                    want, valid, tol[kv_name])
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
        if case in (RING_MAIN, RING_PREFILL):
            records[-1]["device_split"] = ring_split(
                torch, lambda: ops.ring_decode(*args, **kw))

    return records


BGMV_MAIN = "bf16, C=1, B=8 din=2048 dout=2048 pr=4 Pmax=4"


def bgmv_kernel_cases(torch):
    """``bgmv`` at the serving paths' shapes: the Llama path's projections
    (wq/wo 2048->2048, wk/wv 2048->512), the MLA path's (wq_b 1536->24576,
    wkv_a 7168->576, not a multiple of 64 columns a block, wo
    16384->7168) and the RWKV6 path's fp32 x on bf16 pages; rows on
    adapters of ranks 0 (base), 3, 8, 16.  Then ranks 30, 32 and 64 over
    pages of 4 (up to 16 pages, several groups of 4 ranks and 8-wide
    n-tiles, a partial last page) at C = 16 beside the base id.  Each case
    is timed cold (L2 flushed) and warm."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bgmv import plan
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    records = []
    print("phase 2/3: bgmv against its plain version; times cold and warm "
          "beside bounds")
    pr = 4
    ids = torch.tensor([0, 1, 2, 3, 1, 2, 3, 0], dtype=torch.int32, device=dev)
    cases = [(dt, C, din, dout, (0, 3, 8, 16, 0), 4) for dt, C, din, dout in (
        ("bfloat16", 1, 2048, 2048), ("bfloat16", 1, 2048, 512),
        ("bfloat16", 16, 2048, 2048), ("bfloat16", 16, 2048, 512),
        ("float32", 1, 2048, 2048), ("float32", 16, 2048, 512),
        ("bfloat16", 1, 1536, 24576), ("bfloat16", 16, 1536, 24576),
        ("bfloat16", 1, 7168, 576), ("bfloat16", 16, 7168, 576),
        ("bfloat16", 1, 16384, 7168), ("bfloat16", 16, 16384, 7168),
        ("float32", 16, 7168, 576), ("float32/bfloat16", 1, 2048, 2048))]
    cases += [(dt, 16, din, dout, (0, 30, 32, 64, 0), 16) for dt, din, dout in (
        ("bfloat16", 2048, 2048), ("bfloat16", 16384, 7168),
        ("float32/bfloat16", 2048, 2048))]
    for dt_name, C, din, dout, ranks, Pmax in cases:
        # "x/pages": an RWKV6 bf16 decode feeds r/k/v/g's fp32 inputs
        dt_name, _, page_name = dt_name.partition("/")
        dt, pdt = getattr(torch, dt_name), getattr(torch, page_name or dt_name)
        rank = torch.tensor(ranks, dtype=torch.int32, device=dev)
        P = 32 if Pmax == 4 else 96           # pool pages; 5 table rows of Pmax
        table = torch.randperm(P, generator=gen, device=dev)[:5 * Pmax]
        table = table.reshape(5, Pmax).to(torch.int32)
        scale = torch.tensor([0.0, 2.0, 2.0, 2.0, 0.0], device=dev)
        x = torch.randn(8, C, din, generator=gen, device=dev).to(dt)
        a = (torch.randn(P, pr, din, generator=gen, device=dev) * 0.05).to(pdt)
        b = (torch.randn(P, dout, pr, generator=gen, device=dev) * 0.05).to(pdt)
        args = (x, a, b, table, rank, scale, ids)
        got = ops.bgmv(*args)
        want = ref.bgmv_ref(*args)
        torch.cuda.synchronize()
        base = rank[ids.long()] == 0
        if (got[base] != 0).any():
            fail("bgmv: a rank-0 row is not an exact zero")
        short = {"bfloat16": "bf16", "float32": "fp32"}
        case = (f"{short[dt_name]} x, {short[page_name]} pages"
                if page_name else
                f"{'bf16' if dt_name == 'bfloat16' else dt_name}")
        case += f", C={C}, B=8 din={din} dout={dout} pr={pr} Pmax={Pmax}"
        if Pmax != 4:
            case += f", ranks {'/'.join(str(r) for r in ranks[1:4])}"
        p = plan(C, din, dout, pr, Pmax, dt, pdt)
        err = check(f"bgmv[{case}; route {p.route}, tile {p.tile_n}, "
                    f"{p.clusters} cluster(s) a row, {p.nchunk} chunks of "
                    f"{p.kc}]", got, want,
                    torch.ones(8, dtype=torch.bool, device=dev),
                    1e-4 if dt_name == "float32" else 2e-3)
        ms = gpu_ms(torch, lambda: ops.bgmv(*args))
        warm = gpu_ms(torch, lambda: ops.bgmv(*args), cold=False)
        plain = gpu_ms(torch, lambda: ref.bgmv_ref(*args))
        distinct = sorted(set(ids.tolist()))
        r_rows = [int(rank[i]) for i in ids.tolist()]
        nbytes = (x.numel() * x.element_size() + sum(int(rank[i]) for i in distinct)
                  * (din + dout) * a.element_size() + 8 * C * dout * 4)
        ops_n = 2 * C * sum(r_rows) * (din + dout)
        records.append(_record(
            "bgmv", case, "src/repro_torch/kernels/csrc/bgmv.cu",
            "src/repro/kernels/bgmv.py:55", err, ms, plain, None, nbytes,
            ops_n, dt_name, warm=warm))
    return records


RING_MAIN = "bf16 cache, C=1, B=8 H=32 K=8 hd=64 cap=1024"
RING_PREFILL = "bf16 cache, C=16, B=8 H=32 K=8 hd=64 cap=1024"


def ring_split(torch, fn, reps: int = 20) -> dict:
    """Device time per call by kernel name (``torch.profiler``, L2 flushed
    before each call): the attention kernel and any second launch it
    makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    split = {e.key: e.self_device_time_total / reps
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "elementwise" not in e.key}
    for name, us in split.items():
        print(f"    device split: {us:.2f} us per call  {name[:90]}")
    return split


BGMV_RWKV = "fp32 x, bf16 pages, C=1, B=8 din=2048 dout=2048 pr=4 Pmax=4"
MLA_MAIN = "bf16 cache, C=1, B=8 H=128 kvr=512 rope=64 cap=1024"


def mla_kernel_cases(torch):
    """``mla_ring_decode`` at the MLA path's shapes (B 8, H 128, kvr 512,
    rope 64, ring 1024): bf16 at C 1 and 16, a window of 128, int8 with
    per-half scales, fp32; then at the SMOKE config's widths (32 + 16);
    then bf16 at C 1 and 16 on a ring that holds as many slots as the
    engine's do (32–288 resident of 1024).  Each case is timed cold (L2
    flushed) and warm."""
    import math
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mla_ring_decode import route, splits
    from repro_torch.models.attention_core import ring_attend_mask
    from repro_torch.serve.kvcache import quant
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    records = []
    print("phase 2/3: mla_ring_decode against its plain version; times "
          "beside bounds")
    B, cap = 8, 1024
    # rows: wrapped twice, full, partial, a fresh prefill, never written
    # (n = 0), ragged n, wrapped with n = 1, one tile
    # Each query row is held to its own magnitude (a row averaging
    # hundreds of slots is several times smaller than one averaging a few).
    # Both sides compute in fp32 from the same stored values (bf16 and int8
    # dequantized per half in fp32; fp32 products on both sides, TF32 off
    # by default); they differ only in summation order over up to 1024
    # slots and in exp rounding: limit 1e-4 of the row's max |plain|.
    # (kvr, rope, nope, H): DeepSeek-V3's widths, then its SMOKE config's
    # latent widths, 32 + 16 (padded to 32 + 32 in the kernel), at 16 heads
    main = [(512, 64, 128, 128) + c for c in (
        ("bfloat16", 1, 0), ("bfloat16", 16, 0), ("bfloat16", 1, 128),
        ("bfloat16", 16, 128), ("int8", 1, 0), ("int8", 16, 0),
        ("float32", 1, 0), ("float32", 16, 0))]
    smoke = [(32, 16, 32, 16) + c for c in (
        ("bfloat16", 1, 0), ("bfloat16", 16, 0), ("int8", 1, 0),
        ("int8", 16, 0), ("float32", 16, 0))]
    # the engine's rings: phase 8's prompts of 16-256 tokens plus 32 new
    engine = [(512, 64, 128, 128, "bfloat16", c, 0, "engine") for c in (1, 16)]
    engine_pos = torch.tensor([288, 32, 100, 200, 0, 150, 64, 250], device=dev)
    for kvr, rope, nope, H, kv_name, C, window, *ring in main + smoke + engine:
        pos = engine_pos if ring else torch.tensor(
            [1500, 1024, 300, 16, 0, 700, 2100, 64], device=dev)
        length = torch.clamp(pos, max=cap)
        scale = 1.0 / math.sqrt(nope + rope)     # DeepSeek-V3: 1/√(nope+rope)
        n = torch.minimum(pos, torch.tensor([C, C, C, C, 0, min(5, C), 1, C],
                                            device=dev)).to(torch.int32)
        q = torch.randn(B, C, H, kvr + rope, generator=gen, device=dev)
        ckv_f = torch.randn(B, cap, kvr, generator=gen, device=dev)
        kr_f = torch.randn(B, cap, rope, generator=gen, device=dev)
        cs = rs = None
        if kv_name == "int8":
            (ckv, cs), (kr, rs) = quant(ckv_f), quant(kr_f)
        else:
            ckv, kr = (t.to(getattr(torch, kv_name)) for t in (ckv_f, kr_f))
        p32, l32 = pos.to(torch.int32), length.to(torch.int32)
        args = (q, ckv, kr, p32, l32, n)
        kw = dict(scale=scale, window=window, c_kv_scale=cs, k_rope_scale=rs)
        got = ops.mla_ring_decode(*args, **kw)
        want = ref.mla_ring_decode_ref(*args[:6], scale, window, cs, rs)
        torch.cuda.synchronize()
        valid = torch.arange(C, device=dev)[None, :] < n[:, None]
        name = {"bfloat16": "bf16"}.get(kv_name, kv_name)
        case = (f"{name} cache, C={C}{f', window={window}' if window else ''}, "
                f"B={B} H={H} kvr={kvr} rope={rope} cap={cap}"
                f"{', engine ring (32-288 resident)' if ring else ''}")
        how = route(ckv.dtype, kvr, rope)
        nsplit = splits(B, C, H, cap, dev, how)[0]
        err = check_rows(f"mla_ring_decode[{case}; route {how}, {nsplit} "
                         "splits]", got[valid], want[valid], 1e-4)
        ms = gpu_ms(torch, lambda: ops.mla_ring_decode(*args, **kw))
        warm = gpu_ms(torch, lambda: ops.mla_ring_decode(*args, **kw),
                      cold=False)
        plain = gpu_ms(torch, lambda: ref.mla_ring_decode_ref(
            *args[:6], scale, window, cs, rs))
        qpos = (pos - n)[:, None] + torch.arange(C, device=dev)[None, :]
        mask = ring_attend_mask(p32, l32, cap, qpos, window)      # (B,C,cap)
        lib = None
        if kv_name != "int8":
            # yardstick: one SDPA call, MQA over the latent (K = 1 broadcast
            # to the H heads, value = the first kvr key columns), on
            # pre-arranged inputs and the prebuilt ring mask (not timed)
            dt = ckv.dtype
            qt = q.transpose(1, 2).contiguous().to(dt)            # (B,H,C,576)
            kt = torch.cat([ckv, kr], -1)[:, None]                # (B,1,cap,576)
            vt = ckv[:, None]                                     # (B,1,cap,512)
            mt = mask[:, None]
            lib = gpu_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mt, scale=scale, enable_gqa=True))
        resident = int(length.sum())
        eb = ckv.element_size()
        nbytes = (q.numel() * 4 + resident * (kvr + rope) * eb
                  + (resident * 2 * 4 if kv_name == "int8" else 0)
                  + B * C * H * kvr * 4 + 3 * B * 4)
        pairs = int((mask & valid[:, :, None]).sum())   # visible (query, slot)
        ops_n = 2 * H * pairs * ((kvr + rope) + kvr)
        records.append(_record(
            "mla_ring_decode", case,
            "src/repro_torch/kernels/csrc/mla_ring_decode.cu",
            "src/repro/kernels/mla_ring_decode.py:67", err, ms, plain, lib,
            nbytes, ops_n, kv_name,
            library=None if lib is None else
            "scaled_dot_product_attention(attn_mask=ring mask, "
            "enable_gqa=True), K = 1", warm=warm))
        records[-1]["kernel_route"] = how
    return records


def _record(name, case, source, replaces, err, ms, plain, lib, nbytes, ops_n,
            dtype, library=None, warm=None):
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
    if warm is not None:
        rec["warm_ms"] = warm
    print(f"  {name}[{case}]: kernel {ms:.4f} ms"
          f"{'' if warm is None else f' (warm {warm:.4f})'}, plain {plain:.4f} ms, "
          f"library {'-' if lib is None else f'{lib:.4f} ms'}, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
          f"{nbytes / 1e6:.2f} MB, {ops_n / 1e9:.3f} GFLOP)")
    return rec


# -- phases 2 and 3 for the federated round's kernels ------------------------

LORA_MAIN = "bf16, M=2048 din=2048 dout=2048 r=16"
# lora_matmul's record beside the contract's keys: the route that ran, its
# tile width, and the yardsticks (no one PyTorch call computes the function)
LORA_EXTRA = ("kernel_route", "tile_n", "grid", "base_matmul_ms", "unfused_ms")
LORA_RWKV = "bf16, M=8192 din=2048 dout=2048 r=16"
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
    from repro_torch.kernels.lora_matmul import TILE_M
    from repro_torch.kernels.lora_matmul import plan as lora_plan
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    records = []
    print("phase 2/3: the federated round's kernels against plain versions; "
          "times beside bounds")
    dname = {torch.bfloat16: "bf16", torch.float32: "fp32"}

    # lora_matmul: the train step's projections (M = 4 x 512 tokens; wq/wo
    # 2048 -> 2048, wk/wv 2048 -> 512; TinyLlama's wv 2048 -> 256, two
    # column tiles on the persistent grid) at the round's client ranks, the
    # RWKV6 prefill's (M = 8 x 1024 tokens, 2048 -> 2048, r 16), and one
    # ragged M / dout / rank; then ranks 64 and 128 (the wgmma route's
    # widest z and its narrower tiles) and a dout that is not a multiple
    # of 8 (the wmma route).  bf16: both sides round z and s·B at the same
    # points; the plain version rounds x W and the delta to bf16 before
    # adding, the kernel once at the end, so they differ by up to 2 bf16
    # ulps of the output (an ulp is up to 2^-7 of |y|): limit 2e-2 of
    # max |y|.  fp32 (TF32 off): sum order over din = 2048: limit 1e-4.
    # No one PyTorch call computes this function: beside the kernel stand
    # the base product alone (torch.matmul) and the unfused composition
    # torch.addmm(x W, x Aᵀ, (s·B)ᵀ) at the two main shapes.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dt, M, dout, r in ((torch.bfloat16, 2048, 2048, 16),
                           (torch.bfloat16, 8192, 2048, 16),
                           (torch.bfloat16, 2048, 512, 16),
                           (torch.bfloat16, 2048, 256, 16),
                           (torch.bfloat16, 2048, 2048, 4),
                           (torch.bfloat16, 2048, 2048, 32),
                           (torch.bfloat16, 2048, 512, 32),
                           (torch.bfloat16, 1999, 1000, 7),
                           (torch.float32, 2048, 2048, 16),
                           (torch.float32, 2048, 512, 32),
                           (torch.float32, 1999, 1000, 7),
                           (torch.bfloat16, 2048, 2048, 64),
                           (torch.bfloat16, 2048, 2048, 128),
                           (torch.bfloat16, 2048, 1003, 5)):
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
        p = lora_plan(M, din, dout, r, dt, sms)
        how = p["route"] + (f" {TILE_M}x{p['bn']} tiles, grid {p['grid']}"
                            if p["bn"] else "")
        err = check(f"lora_matmul[{case}; route {how}]", got, want,
                    torch.ones(M, dtype=torch.bool, device=dev),
                    2e-2 if dt == torch.bfloat16 else 1e-4)
        ms = gpu_ms(torch, lambda: ops.lora_matmul(x, w, a, b, scale))
        plain = gpu_ms(torch, lambda: ref.lora_matmul_ref(x, w, a_c, b_s, 1.0))
        base = gpu_ms(torch, lambda: torch.matmul(x, w))
        eb = x.element_size()
        nbytes = eb * (M * din + din * dout + r * din + dout * r + M * dout)
        ops_n = 2 * M * din * dout + 2 * M * r * (din + dout)
        records.append(_record(
            "lora_matmul", case, "src/repro_torch/kernels/csrc/lora_matmul.cu",
            "src/repro/kernels/lora_matmul.py:31", err, ms, plain, None, nbytes,
            ops_n, str(dt).split(".")[-1]))
        records[-1].update(kernel_route=p["route"], tile_n=p["bn"],
                           grid=p["grid"], base_matmul_ms=base)
        if case in (LORA_MAIN, LORA_RWKV):
            bt = b_s.t()
            records[-1]["unfused_ms"] = gpu_ms(
                torch, lambda: torch.addmm(x @ w, x @ a_c.t(), bt))
        print(f"    base product torch.matmul(x, W) {base:.4f} ms"
              + (f", unfused addmm(x W, x Aᵀ, (s·B)ᵀ) "
                 f"{records[-1]['unfused_ms']:.4f} ms"
                 if "unfused_ms" in records[-1] else ""))

    # flash_attention: the train step's attention (B 4, S 512, 32 heads over
    # 8 KV heads, hd 64; TinyLlama's 32 over 4, 8 query heads a KV head),
    # a window, a ragged S and hd 128.  Then the bf16
    # kernel's edges: hd 16 and 32 (their own swizzle widths), T > S
    # (causal), S not a multiple of 64 or of the block's 128 rows, windows
    # shorter than a key tile and longer than S, group sizes 1, 2 and 8
    # (rows s·g + j split across blocks), non-causal.  Each query row
    # is held to its own magnitude: a row that averages hundreds of values
    # is ~20x smaller than the first rows, so one limit over the whole
    # output would let an error in the long rows through.  bf16: the kernel
    # rounds its output to bf16 (up to 2^-8 of an entry) and P to bf16
    # before P·V (as the TPU kernel does); the plain version stays fp32:
    # limit 1e-2 of the row's max |plain| (6.7e-3 measured at most).  fp32:
    # sum order and exp rounding: limit 1e-5 of it (2.3e-6 measured).
    for dt, B, S, T, H, K, hd, causal, window in (
            (torch.bfloat16, 4, 512, 512, 32, 8, 64, True, 0),
            (torch.bfloat16, 4, 512, 512, 32, 4, 64, True, 0),
            (torch.bfloat16, 4, 512, 512, 32, 8, 64, True, 128),
            (torch.bfloat16, 4, 500, 500, 32, 8, 64, True, 0),
            (torch.bfloat16, 4, 512, 512, 16, 4, 128, True, 0),
            (torch.bfloat16, 2, 300, 300, 8, 8, 16, True, 0),
            (torch.bfloat16, 2, 300, 300, 16, 8, 32, True, 50),
            (torch.bfloat16, 2, 200, 333, 16, 2, 64, True, 0),
            (torch.bfloat16, 2, 77, 77, 8, 1, 64, False, 0),
            (torch.bfloat16, 1, 130, 130, 24, 8, 64, True, 20),
            (torch.bfloat16, 1, 64, 64, 8, 1, 128, True, 1000),
            (torch.float32, 4, 512, 512, 32, 8, 64, True, 0),
            (torch.float32, 2, 300, 300, 16, 4, 128, True, 100),
            (torch.float32, 1, 77, 77, 4, 1, 16, True, 0),
            # head dims the padded tiles opened (same limits): 56 in 64-wide
            # tiles (g 7, ragged S), 96 in 128-wide ones (Phi-3-vision's 32
            # heads, no grouping), and hd 8 and 24
            (torch.bfloat16, 4, 500, 500, 28, 4, 56, True, 0),
            (torch.bfloat16, 4, 512, 512, 32, 32, 96, True, 0),
            (torch.bfloat16, 2, 300, 300, 32, 32, 96, True, 64),
            (torch.bfloat16, 1, 130, 200, 8, 2, 8, False, 0),
            (torch.bfloat16, 1, 130, 130, 8, 2, 24, True, 0),
            (torch.float32, 2, 300, 300, 28, 4, 56, True, 64),
            (torch.float32, 2, 300, 300, 32, 32, 96, True, 0)):
        q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(B, T, K, hd, generator=gen, device=dev).to(dt)
        v = torch.randn(B, T, K, hd, generator=gen, device=dev).to(dt)
        got = ops.flash_attention(q, k, v, causal, window)
        want = ref.flash_attention_ref(q, k, v, causal, window)
        torch.cuda.synchronize()
        case = (f"{dname[dt]}, {'causal' if causal else 'full'}"
                f"{f', window={window}' if window else ''}, "
                f"B={B} S={S}{f' T={T}' if T != S else ''} H={H} K={K} hd={hd}")
        err = check_rows(f"flash_attention[{case}]", got, want,
                         1e-2 if dt == torch.bfloat16 else 1e-5)
        ms = gpu_ms(torch, lambda: ops.flash_attention(q, k, v, causal, window))
        plain = gpu_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal,
                                                              window))
        lib = None
        if not window:      # one SDPA call, on pre-transposed inputs
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = gpu_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
        eb = q.element_size()
        nbytes = eb * (2 * q.numel() + k.numel() + v.numel())
        ops_n = 4 * B * H * hd * _causal_pairs(S, T, causal, window)
        records.append(_record(
            "flash_attention", case,
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:70", err, ms, plain, lib,
            nbytes, ops_n, str(dt).split(".")[-1],
            library=None if window else
            f"scaled_dot_product_attention(is_causal={causal}, enable_gqa=True)"))

    records += gram_kernel_cases(torch)
    return records


GRAM_A = "fp32, A stack (G, r, n) read as its transposed view, G=32 r=64 n=2048"


def gram_kernel_cases(torch):
    """``adapter_gram`` through ``ops.adapter_gram``: the Gram SVD route's B
    stacks (a bucket of 2 leaves x 16 layers, m = 2048 for wq/wo and 512
    for wk/wv, r = Σ r_k up to 128, a tail m), its A stacks (stored (G, r,
    n), passed as the transposed view that ``gram_svd`` takes: the kernel
    reads them in place), the delta route's large r, and ragged edges (r 5
    and 12, rows that are not 16-byte multiples, K under one slice, r > 128
    with off-diagonal tiles).  The kernel runs 3xTF32 on the tensor cores
    (lo·lo dropped, ~2^-20 of each product), the plain version fp32 FMAs
    (TF32 off), sums in another order over m rows: limit 1e-4 of max
    |xᵀx|.  Two calls on the same input must give the same bits (no
    atomics; fixed summing order), and the result must be exactly
    symmetric.  xᵀx needs only its r(r+1)/2 distinct entries, m
    multiply-adds each: G·m·r·(r+1) operations; ``bound_ms`` holds them to
    the fp32 rate of the CUDA cores (the function's type), and
    ``bound_3xtf32_ms`` to the tensor cores' TF32 rate for the three
    products the kernel does instead.  Beside the kernel: warm (no L2
    flush) time, ``torch.bmm``, reading x once (``x.sum()``), and for the A
    stacks the old path, a contiguous copy of the view and then the kernel.
    The plan's shared memory is held to the built kernel's, and its
    cluster to the clusters the card holds at once."""
    from repro_torch.kernels import adapter_gram as ag
    from repro_torch.kernels import ops, ref
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    records = []
    for tile, layout, strips in ((32, "col", 1), (64, "col", 1), (128, "col", 1),
                                 (128, "col", 2), (32, "row", 1), (64, "row", 1),
                                 (128, "row", 1), (128, "row", 2)):
        want = ag.smem_bytes(tile, layout, strips)
        got = ag.compiled_smem_bytes(tile, layout, strips)
        if got != want:
            fail(f"adapter_gram.smem_bytes({tile}, {layout}, {strips}) = {want}, "
                 f"the built kernel's is {got}")
    held = build_fn("adapter_gram", "adapter_gram_max_clusters", 8)
    for G, m, r, layout, timed in ((32, 2048, 64, "col", True), (32, 2048, 16, "col", True),
                                   (32, 2048, 128, "col", True), (32, 512, 16, "col", True),
                                   (32, 512, 64, "col", True), (32, 512, 128, "col", True),
                                   (32, 2000, 60, "col", True), (32, 2048, 64, "row", True),
                                   (32, 2048, 128, "row", True), (4, 2048, 512, "col", True),
                                   (3, 70, 5, "col", False), (2, 1001, 12, "row", False),
                                   (2, 100, 40, "col", False), (1, 8, 200, "col", False),
                                   (2, 300, 130, "row", False), (5, 257, 96, "col", False)):
        if layout == "col":
            x = torch.randn(G, m, r, generator=gen, device=dev) * 0.05
            stored, lib = x, (lambda x=x: torch.bmm(x.mT, x))
            case = f"fp32, G={G} m={m} r={r}"
        else:
            stored = torch.randn(G, r, m, generator=gen, device=dev) * 0.05
            x = stored.mT
            lib = (lambda a=stored: torch.bmm(a, a.mT))
            case = (f"fp32, A stack (G, r, n) read as its transposed view, "
                    f"G={G} r={r} n={m}")
        p = ag.plan(G, m, r, layout)
        got = ops.adapter_gram(x)
        again = ops.adapter_gram(x)
        want = ref.adapter_gram_ref(x)
        torch.cuda.synchronize()
        err = check(f"adapter_gram[{case}; tile {p.tile}, cluster {p.cluster}, "
                    f"{p.per} x {p.rows} rows a block]", got, want,
                    torch.ones(G, dtype=torch.bool, device=dev), 1e-4)
        if not torch.equal(got, again):
            fail(f"adapter_gram[{case}]: two calls on the same input differ")
        if not torch.equal(got, got.mT):
            fail(f"adapter_gram[{case}]: the result is not exactly symmetric")
        n_held = held(G, m, r, ag.LAYOUTS.index(layout), p.tile, p.cluster, p.per,
                      p.smem)
        if p.cluster > 1 and G * p.tiles > n_held:
            fail(f"adapter_gram[{case}]: {G * p.tiles} clusters of {p.cluster}, "
                 f"the card holds {n_held} at once")
        if not timed:
            continue
        ms = gpu_ms(torch, lambda: ops.adapter_gram(x))
        warm = gpu_ms(torch, lambda: ops.adapter_gram(x), cold=False)
        plain = gpu_ms(torch, lambda: ref.adapter_gram_ref(x))
        nbytes = 4 * (G * m * r + G * r * r)
        ops_n = G * m * r * (r + 1)
        rec = _record("adapter_gram", case, "src/repro_torch/kernels/csrc/adapter_gram.cu",
                      "src/repro/kernels/adapter_gram.py:41", err, ms, plain,
                      gpu_ms(torch, lib), nbytes, ops_n, "float32",
                      library="torch.bmm(x.mT, x)" if layout == "col"
                      else "torch.bmm(a, a.mT) on the stored a", warm=warm)
        rec.update(kernel_route=p.route, tile=p.tile, cluster=p.cluster,
                   rows_per_block=p.rows_per_block, clusters_held=n_held,
                   same_bits=True, read_once_ms=gpu_ms(torch, lambda: stored.sum()),
                   bound_3xtf32_ms=max(nbytes / HBM_BYTES_PER_S,
                                       3 * ops_n / PEAK_OPS["tf32"]) * 1e3)
        line = (f"    3xTF32 bound {rec['bound_3xtf32_ms']:.4f} ms; reading x once "
                f"(x.sum()) {rec['read_once_ms']:.4f} ms")
        if layout == "row":
            rec["copy_then_kernel_ms"] = gpu_ms(
                torch, lambda: ag.adapter_gram_cuda(x.contiguous(), "col"))
            line += (f"; the old path, a contiguous copy then the kernel, "
                     f"{rec['copy_then_kernel_ms']:.4f} ms")
        print(line)
        records.append(rec)
    return records


def build_fn(name: str, symbol: str, n_int: int):
    """A plain C function of a built kernel library taking ``n_int`` ints
    and returning an int."""
    import ctypes
    from repro_torch.kernels import build
    fn = getattr(build.load(name), symbol)
    fn.argtypes = [ctypes.c_int] * n_int
    fn.restype = ctypes.c_int
    return fn


# -- phases 2 and 3 for the RWKV6 prefill's kernel ----------------------------

WKV6_MAIN = "bf16 r/k/v, B=8 S=1024 H=32 hd=64"


def wkv6_kernel_cases(torch):
    """``wkv6`` at RWKV6-1.6B's prefill shape (B 8, S 1024, 32 heads of 64)
    with bf16 and fp32 r/k/v, and a ragged S of 200 (one partial chunk);
    then head dim 32 (the SMOKE config's; 64 heads of a 2048-wide model);
    then the main shape at strong decay.  First the launch arithmetic of
    ``kernels/wkv6.py`` against the built kernel's shared-memory structs."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wk
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    records = []
    print("phase 2/3: wkv6 against its plain version; times beside bounds")
    for hd in wk.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            built = wk.compiled_smem_bytes(hd, dt)
            planned = wk.smem_bytes(hd, torch.tensor([], dtype=dt).element_size())
            if built != planned:
                fail(f"wkv6: the plan's shared memory at hd {hd} {dt} is "
                     f"{planned} bytes, the built kernel's {built}")
    main_plan = wk.plan(8, 1024, 32, 64, torch.bfloat16,
                        torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"  plan at the main shape: {main_plan}")
    # The kernel sums in another order than the plain scan and forms its
    # products on the tensor cores in 3xTF32 (~2^-20 of each product's
    # size; plain TF32 would leave ~2^-11), over a state that carries ~30
    # tokens (decays e^{-e^{N(-3, 1)}}) or ~2 (e^{-e^{N(1, 1)}}, where
    # running products of the decays underflow as the true ones do): each
    # (b, h) row within 1e-4 of max(1, its max |plain|).
    for dt, B, S, H, hd, mu in ((torch.bfloat16, 8, 1024, 32, 64, -3),
                                (torch.float32, 8, 1024, 32, 64, -3),
                                (torch.bfloat16, 8, 200, 32, 64, -3),
                                (torch.bfloat16, 8, 1024, 64, 32, -3),
                                (torch.float32, 8, 200, 64, 32, -3),
                                (torch.bfloat16, 8, 1024, 32, 64, 1)):
        r, k, v = (torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
                   for _ in range(3))
        w = -torch.exp(torch.randn(B, S, H, hd, generator=gen, device=dev) + mu)
        u = torch.randn(H, hd, generator=gen, device=dev) * 0.5
        got = ops.wkv6(r, k, v, w, u)
        want = ref.wkv6_ref(r, k, v, w, u)
        torch.cuda.synchronize()
        case = (f"{'bf16' if dt == torch.bfloat16 else 'fp32'} r/k/v, "
                f"B={B} S={S} H={H} hd={hd}"
                + (", strong decay w=-exp(N(1,1))" if mu == 1 else ""))
        err = check_rows(f"wkv6[{case}]", *(
            t.permute(0, 2, 1, 3).reshape(B * H, S * hd) for t in (got, want)),
            1e-4, floor=1.0)
        if not bool(torch.isfinite(got).all()):
            fail(f"wkv6[{case}]: non-finite output")
        ms = gpu_ms(torch, lambda: ops.wkv6(r, k, v, w, u))
        plain = gpu_ms(torch, lambda: ref.wkv6_ref(r, k, v, w, u))
        n = B * S * H * hd
        nbytes = 3 * n * r.element_size() + 4 * n + 4 * H * hd + 4 * n
        # the chunked form's tensor-core products, per token and head: r̃·S
        # and the update Σ k̃ vᵀ (2hd² each), P·V over a chunk (2·C·hd)
        ops_n = (4 * hd * hd + 2 * wk.CHUNK * hd) * B * S * H
        rec = _record(
            "wkv6", case, "src/repro_torch/kernels/csrc/wkv6.cu",
            "src/repro/kernels/wkv6.py:47", err, ms, plain, None, nbytes,
            ops_n, "tf32")
        # the sequential form's bound (5·hd² + 5·hd fp32 operations a token
        # and head on the CUDA cores), the old design's, for the record
        rec["sequential_bound_ms"] = max(
            nbytes / HBM_BYTES_PER_S, (5 * hd * hd + 5 * hd) * B * S * H
            / PEAK_OPS["float32"]) * 1e3
        print(f"    sequential form's bound {rec['sequential_bound_ms']:.4f} ms")
        if case == WKV6_MAIN:
            rec["plan"] = dataclasses.asdict(main_plan)
        records.append(rec)
    return records


# -- phase 2, end to end: the SMOKE configs' widths through the kernels -----

SMOKE_PREFILL = (4, 256)          # batch and tokens of the RWKV6 SMOKE call


def smoke_widths(torch):
    """The two SMOKE configs whose widths only the repaired kernels take,
    driven end to end on the card through the kernel routes, with their
    launch counts: one ``make_prefill_step(rwkv6_1p6b.SMOKE,
    use_kernels=True)`` call (head dim 32: ``wkv6``, ``lora_matmul``) held
    to the plain route, and its bf16 twin; then the ``deepseek_smoke``
    engine (latent 32 + 16: ``mla_ring_decode``) serving phase 4's traffic
    through ``decode_impl="kernel"``, and phase 5's check on it."""
    from repro_torch.configs import lora_targets
    from repro_torch.configs.rwkv6_1p6b import SMOKE
    from repro_torch.device import parity_mode
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_prefill_step
    dev = torch.device(DEVICE)
    B, S = SMOKE_PREFILL
    L, targets = SMOKE.num_layers, lora_targets(SMOKE)
    print(f"phase 2: {SMOKE.name} ({L} L, d {SMOKE.d_model}, "
          f"{SMOKE.num_rwkv_heads} heads of {SMOKE.rwkv_head_dim}) prefill of "
          f"{B} x {S} tokens, kernel route vs plain route; " + parity_mode())
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = SMOKE.replace(dtype=dt)
        params = T.init(cfg, 0, dev)
        gen = torch.Generator(device=dev).manual_seed(8)
        ad = make_adapter(params, targets, 16, gen, T.torch_dtype(dt))
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
        ops.reset_launch_counts()
        got = make_prefill_step(cfg, use_kernels=True)(params, ad, {"tokens": toks})
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want_counts = dict.fromkeys(counts, 0) | {"wkv6": L,
                                                  "lora_matmul": L * len(targets)}
        print(f"  {dt}: kernels {json.dumps(counts)} (expected "
              f"{json.dumps(want_counts)})")
        if counts != want_counts:
            fail(f"phase 2: {cfg.name} ({dt}) did not run its kernels")
        if got.shape != (B, cfg.vocab_size) or not bool(torch.isfinite(got).all()):
            fail(f"phase 2: {cfg.name} ({dt}) logits of shape "
                 f"{tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        rec = {"launches": counts}
        if dt == "float32":
            # phase 12 (a)'s limit: fp32 on both routes (TF32 off), wkv6's
            # FMAs and the sums in another order (8.5e-5 at full width)
            want = make_prefill_step(cfg, use_kernels=False)(params, ad,
                                                             {"tokens": toks})
            rec["logits_max_abs_err"] = check(
                f"{cfg.name} fp32 prefill logits, kernel vs plain route", got,
                want, torch.ones(B, dtype=torch.bool, device=dev), 2e-4)
        out[f"rwkv_smoke_{dt}"] = rec
        del params, ad
    out["deepseek_smoke_e2e"], _ = end_to_end(torch, "2", "deepseek_smoke",
                                              "its SMOKE widths")
    # fp32 cache: the routes differ by sum order only (4.9e-6 at reduced
    # width on the CPU, phase 9's note), so phase 5's limit holds
    out["deepseek_smoke_parity"] = engine_parity(
        torch, "2", "deepseek_smoke", ("float32",), 1e-3, require_equal=True)
    torch.cuda.empty_cache()
    return out


# -- phase 4: the slice end to end ------------------------------------------

def end_to_end(torch, phase: str = "4", config: str = "llama3p2_1b",
               widths: str = "published widths"):
    """Serve ``launch.serve``'s traffic on ``config`` through the kernels;
    the attention kernel (``ring_decode``, or ``mla_ring_decode`` for MLA;
    none for RWKV6) must run once per layer per engine step, ``bgmv`` once
    per layer per bgmv-routed target (every LoRA target but MLA's ``wkv_b``,
    which is folded into the absorbed weights instead)."""
    from repro_torch.configs import lora_targets
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import CONFIGS, MAX_TOKENS, N_REQUESTS, serve
    cfg = CONFIGS[config][0]
    depth = f"{cfg.num_layers} L"
    if cfg.use_mla:
        attn = "mla_ring_decode"
        shape = (f"{cfg.num_heads} H, q_lora {cfg.q_lora_rank}, kv_lora "
                 f"{cfg.kv_lora_rank}, qk nope/rope {cfg.qk_nope_head_dim}/"
                 f"{cfg.qk_rope_head_dim}, v {cfg.v_head_dim}")
        depth = f"depth cut to its {cfg.num_layers} dense MLA layers"
    elif cfg.family == "ssm":
        attn = None
        shape = (f"{cfg.num_rwkv_heads} heads of {cfg.rwkv_head_dim}, decay "
                 f"LoRA {cfg.rwkv_decay_lora}; one token per engine step")
    else:
        attn = "ring_decode"
        shape = (f"{cfg.num_heads} H / {cfg.num_kv_heads} KV, hd "
                 f"{cfg.head_dim}")
    print(f"phase {phase}: {cfg.name} at {widths} ({depth}, d "
          f"{cfg.d_model}, {shape}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}), random seeded weights, decode_impl=kernel")
    ops.reset_launch_counts()
    out = serve(config, device=DEVICE, log=lambda s: print("  " + s))
    counts = ops.launch_counts()
    stats = out["stats"]
    steps = out["engine"].steps_run
    L = cfg.num_layers
    want = dict.fromkeys(counts, 0)
    want["bgmv"] = L * (len(lora_targets(cfg)) - cfg.use_mla) * steps
    if attn:
        want[attn] = L * steps * (mla_launches_a_call(out["engine"])
                                  if cfg.use_mla else 1)
    print(f"  kernels: {json.dumps(counts)} over {steps} engine steps "
          f"(expected {json.dumps(want)})")
    if counts != want:
        fail(f"phase {phase}: launch counts do not match the engine steps")
    res = out["results"]
    if (len(res) != N_REQUESTS
            or any(len(t) != MAX_TOKENS for t in res.values())):
        fail(f"expected {N_REQUESTS} requests x {MAX_TOKENS} tokens, got "
             f"{ {u: len(t) for u, t in res.items()} }")
    if stats["decode_tokens"] + stats["prefill_step_tokens"] != stats["generated_tokens"]:
        fail(f"the step log accounts for {stats['decode_tokens']} + "
             f"{stats['prefill_step_tokens']} tokens, the requests hold "
             f"{stats['generated_tokens']}")
    if any(not 0 <= x < cfg.vocab_size for t in res.values() for x in t):
        fail("a generated token is outside the vocabulary")
    ids = sorted(set(out["served_by"].values()))
    old, new = out["swap"]
    if len(ids) < 4 or new not in ids or old not in ids or 0 not in ids:
        fail(f"traffic did not cover base, old and new adapter ids: {ids}")
    print(f"  served {len(res)} of {N_REQUESTS} requests, {MAX_TOKENS} tokens "
          f"each, on adapter ids {ids}; swap {old} -> {new}")
    pre = (f"prefill {stats['prefill_tok_s']:.1f} prompt tok/s over "
           f"{stats['prefill_steps']} steps (median "
           f"{stats['prefill_step_ms_median']:.3f} ms; they also emitted "
           f"{stats['prefill_step_tokens']} tokens)" if stats["prefill_steps"]
           else "every step one token wide (prompts consumed one token a step)")
    print(f"  {pre}; decode {stats['decode_tok_s']:.1f} tok/s ({stats['decode_tokens']} tokens "
          f"over {stats['decode_steps']} steps, median "
          f"{stats['decode_step_ms_median']:.3f} ms); end to end "
          f"{stats['e2e_tok_s']:.1f} generated tok/s over a wall of "
          f"{stats['wall_s']:.2f} s; prompt and generated tokens over the "
          f"steps' time {stats['step_tok_s']:.1f} tok/s")
    window = profile_decode(torch, out["engine"])
    live = [i for i in ids if i and out["engine"].registry.is_live(i)]
    window_live = profile_decode(torch, out["engine"], adapter_ids=live)
    del out
    torch.cuda.empty_cache()
    return dict(stats, launches=counts, profiled_decode=window,
                profiled_decode_adapters=window_live), counts


def mla_launches_a_call(eng) -> int:
    """Kernels one ``mla_ring_decode`` call of ``eng``'s steps launches
    (``mla_ring_decode.launches``): route ``"mma"`` (the SMOKE widths) adds
    its merge kernel where it splits the ring, at width 1 and at the
    prefill chunk alike on the engines here."""
    from repro_torch.kernels import mla_ring_decode as mla
    ckv = next(c["c_kv"] for c in eng.cache if "c_kv" in c)
    _, B, cap, kvr = ckv.shape
    how = mla.route(ckv.dtype, kvr, eng.cfg.qk_rope_head_dim)
    per = {mla.launches(how, mla.splits(B, C, eng.cfg.num_heads, cap,
                                        ckv.device, how)[0])
           for C in {1, eng.chunk}}
    if len(per) != 1:
        fail(f"mla_ring_decode launches a call differ by step width: {per}")
    return per.pop()


def profile_decode(torch, eng, steps: int = 10, adapter_ids=(0,)):
    """Where a decode step's time goes: ``steps`` width-1 engine steps of a
    fresh full batch, once under ``torch.profiler`` (device time by kernel)
    and once without it (wall time per step).  The batch's rows cycle over
    ``adapter_ids``: by default all on the base id, so every ``bgmv``
    launch takes its rank-0 exit; the engine's live adapters make its rows
    do the shrink and expand."""
    from repro_torch.serve.engine import SamplingParams

    for i in range(eng.B):
        eng.submit(list(range(1 + i, 17 + i)),
                   SamplingParams(max_tokens=2 * steps + 4),
                   adapter_id=adapter_ids[i % len(adapter_ids)])
    eng.run_steps(2)                       # admission and the prefill step
    torch.cuda.synchronize()
    rows = ("base id" if tuple(adapter_ids) == (0,) else
            f"adapter ids {'/'.join(map(str, adapter_ids))}")
    out = profile_window(torch, eng.run_steps, steps,
                         f"decode step, {steps} steps x {eng.B} rows on {rows}")
    eng.run()
    return out


def profile_window(torch, run, steps: int, label: str, before: str = ""):
    """``run(steps)`` once under ``torch.profiler`` (device time by kernel,
    host time by operator) and once without it (wall time per step); the
    idle share is 1 - device busy / wall.  With ``before`` (a regex of
    kernel names), also (the device kernel that ran just before, the
    kernel) for each launch of a matching kernel, in order."""
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
    preceded = []
    if before:
        kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        preceded = [(kern[i - 1].name if i else "", e.name)
                    for i, e in enumerate(kern) if re.search(before, e.name)]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    # the port's own kernels, whether or not they are among the top ones
    port = {k: ms for k, ms in by_kernel.items() if re.search(PORT_KERNELS, k)}
    print(f"  {label}: wall {wall_ms:.3f} ms per step (no profiler); device "
          f"busy {busy:.3f} ms per step (profiler): idle share "
          f"{1 - busy / wall_ms:.3f}")
    for name, ms in top:
        print(f"    device {ms:8.4f} ms/step  {name[:80]}")
    for name, ms in sorted(port.items(), key=lambda kv: -kv[1]):
        print(f"    port kernel {ms:8.4f} ms/step  {name[:80]}")
    for name, ms in top_host:
        print(f"    host   {ms:8.4f} ms/step  {name[:80]} (under the profiler)")
    out = {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
           "idle_share": 1 - busy / wall_ms,
           "top_kernels_ms_per_step": dict(top),
           "port_kernels_ms_per_step": port,
           "top_host_ops_ms_per_step_profiled": dict(top_host)}
    if before:
        out["kernel_before_each"] = preceded
    return out


# -- phase 5: the engine, kernels against plain versions --------------------

def engine_parity(torch, phase: str = "5", config: str = "llama3p2_1b",
                  kv_dtypes=("float32",), logit_tol: float = 1e-3,
                  require_equal: bool = False):
    """The engine at full width in fp32 (TF32 off), kernel routes against
    plain routes, once per cache dtype in ``kv_dtypes``: the first prefill
    step's logits (a 16-token chunk; for RWKV6, whose recurrence takes no
    chunks, the logits after 8 one-token steps: at the init's zero bonus u
    the first token's time mix is exactly zero and never reaches the
    adapters) within ``logit_tol`` of max(1, |logit|), then the greedy
    tokens of 8 requests over 16 steps (required equal with
    ``require_equal``)."""
    import numpy as np
    from repro_torch.configs import lora_targets
    from repro_torch.device import parity_mode
    from repro_torch.launch.serve import CONFIGS, make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    from repro_torch.serve.adapters import AdapterRegistry, attach
    from repro_torch.serve.engine import SamplingParams, ServeEngine
    print(f"phase {phase}: engine on the card, kernels vs plain versions, "
          f"{CONFIGS[config][0].name} at full width in fp32; " + parity_mode())
    cfg = CONFIGS[config][0].replace(dtype="float32")
    dev = torch.device(DEVICE)
    params = T.init(cfg, 1, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    targets = lora_targets(cfg)
    reg = AdapterRegistry(init_lora(params, targets, 4, 8.0, gen), page_rank=4,
                          max_rank=16, device=dev)
    aid = [0] + [reg.register(f"r{r}", make_adapter(params, targets, r, gen,
                                                     torch.float32))
                 for r in (4, 8, 16)]
    rng = np.random.default_rng(3)
    B = 8
    C, steps = (1, 8) if cfg.family == "ssm" else (16, 1)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, C * steps)),
                           device=dev)
    n = torch.tensor([16, 16, 9, 16, 3, 16, 16, 1] if C == 16
                     else [1, 1, 1, 1, 0, 1, 1, 1], dtype=torch.int32, device=dev)
    ids = torch.tensor([aid[i % 4] for i in range(B)], dtype=torch.int32,
                       device=dev)
    valid = torch.arange(C, device=dev)[None, :] < n[:, None]
    results = {}
    for kv_name in kv_dtypes:
        kv = getattr(torch, kv_name)
        lg = {}
        for impl, lora in (("kernel", "kernel"), ("dense", "plain")):
            cache = T.init_cache(cfg, B, 1024, kv, prefill_chunk=C, device=dev)
            for i in range(steps):
                lg[impl], cache = T.decode(
                    cfg, params, cache, {"tokens": toks[:, i * C:(i + 1) * C]},
                    attach(reg.device_state, ids, impl=lora), n_tokens=n,
                    decode_impl=impl)
        what = ("first prefill step logits" if steps == 1
                else f"logits after {steps} one-token steps")
        err = check(f"{kv_name} cache: {what}", lg["kernel"], lg["dense"],
                    valid, logit_tol)
        del lg
        outs = {}
        for impl in ("kernel", "dense"):
            eng = ServeEngine(cfg, params, registry=reg, batch_slots=B,
                              capacity=1024, kv_dtype=kv, prefill_chunk=C,
                              decode_impl=impl, device=dev)
            prng = np.random.default_rng(4)
            uids = [eng.submit(prng.integers(1, cfg.vocab_size,
                                             int(prng.integers(32, 65))).tolist(),
                               SamplingParams(max_tokens=16),
                               adapter_id=aid[i % 4])
                    for i in range(B)]
            res = eng.run()
            outs[impl] = [res[u] for u in uids]
            del eng
        pairs = [(a, b) for ra, rb in zip(outs["kernel"], outs["dense"])
                 for a, b in zip(ra, rb)]
        agree = sum(a == b for a, b in pairs) / max(1, len(pairs))
        print(f"  {kv_name} cache: greedy-token agreement over 16 steps x {B} "
              f"requests: {agree:.4f} ({sum(a == b for a, b in pairs)}/"
              f"{len(pairs)})")
        if require_equal and (agree != 1.0 or len(pairs) != 16 * B):
            fail(f"phase {phase}: the kernel and plain engines' greedy tokens "
                 f"differ ({kv_name} cache)")
        results[kv_name] = {"logits_max_abs_err": err, "greedy_agreement": agree}
    del params, reg
    torch.cuda.empty_cache()
    return results if len(results) > 1 else results[kv_dtypes[0]]


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
    finalize = profile_finalize(torch, tr.aggregator, buckets)
    del tr, state
    torch.cuda.empty_cache()
    return {"rounds": rounds, "launches": counts, "profiled_train_step": window,
            "profiled_finalize": finalize}, counts


def profile_finalize(torch, agg, buckets: int, n: int = 3):
    """The last round's FLoRIST finalize again, ``n`` times, profiled: the
    aggregator keeps its stacks until the next ``begin_round``, so each call
    runs the Gram route on the round's real shapes (16 layers, wq wk wv wo
    in two buckets, Σ r_k of the round's clients).  Prints wall, device busy
    and idle share, the top device and host operations, ``adapter_gram``'s
    device time a finalize, and the kernels before its launches: an A
    stack's launch must follow no copy (its transposed view is read where
    it lies)."""
    from repro_torch.kernels import ops

    def run(k):
        for _ in range(k):
            agg.finalize()
    run(1)
    torch.cuda.synchronize()
    before = ops.launch_counts()["adapter_gram"]
    out = profile_window(torch, run, n,
                         f"FLoRIST finalize (Gram route, {buckets} buckets, "
                         f"clients of ranks {agg.client_ranks}), per finalize",
                         before=r"\bgram_mma\b")
    launched = ops.launch_counts()["adapter_gram"] - before
    if launched != 2 * n * 2 * buckets:          # the profiled run and the timed one
        fail(f"finalize window: {launched} adapter_gram launches, expected "
             f"{4 * n * buckets}")
    # the profiler names the build: gram_mma<NB, ROWL, ...>, ROWL true for
    # an A stack read where it lies (the row layout)
    prev = out.pop("kernel_before_each")
    a_prev = [p for p, k in prev if re.search(r"gram_mma<\d+, true", k)]
    out["kernel_before_a_stack"] = sorted(set(a_prev))
    out["kernel_before_b_stack"] = sorted({p for p, k in prev
                                           if re.search(r"gram_mma<\d+, false", k)})
    print("    kernel before each A stack's adapter_gram: "
          + "; ".join(p[:70] for p in out["kernel_before_a_stack"]))
    print("    kernel before each B stack's adapter_gram: "
          + "; ".join(p[:70] for p in out["kernel_before_b_stack"]))
    if not a_prev:
        fail("finalize window: the profile shows no A stack's adapter_gram launch")
    if any(re.search("copy", p, re.I) for p in a_prev):
        fail("finalize window: a copy kernel runs in front of an A stack's "
             "adapter_gram launch")
    out["adapter_gram_ms_per_finalize"] = sum(
        ms for k, ms in out["port_kernels_ms_per_step"].items() if "gram_mma" in k)
    print(f"    adapter_gram device time {out['adapter_gram_ms_per_finalize']:.4f} ms "
          f"a finalize")
    return out


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



# -- phase 10: the RWKV6 prefill end to end ----------------------------------

PREFILL_BATCH, PREFILL_SEQ, PREFILL_CALLS = 8, 1024, 3


def rwkv_prefill(torch):
    """``make_prefill_step(use_kernels=True)`` on RWKV6-1.6B at published
    widths: per call ``wkv6`` once per layer and ``lora_matmul`` once per
    layer and target; tokens/s, and a profiled window of calls."""
    from repro_torch.configs import lora_targets
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import CONFIGS, make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_prefill_step
    cfg = CONFIGS["rwkv6_1p6b"][0]
    L, targets = cfg.num_layers, lora_targets(cfg)
    print(f"phase 10: {cfg.name} prefill at published widths ({L} L, d "
          f"{cfg.d_model}, {cfg.num_rwkv_heads} heads of {cfg.rwkv_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}), random "
          f"seeded weights, one rank-16 adapter on {' '.join(targets)}, "
          f"make_prefill_step(use_kernels=True) on {PREFILL_BATCH} x "
          f"{PREFILL_SEQ} tokens")
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    params = T.init(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    ad = make_adapter(params, targets, 16, gen, T.torch_dtype(cfg.dtype))
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ),
                         generator=gen, device=dev)
    step = make_prefill_step(cfg, use_kernels=True)
    first = step(params, ad, {"tokens": toks})                  # warm-up
    torch.cuda.synchronize()
    print(f"  set-up and warm-up call: {time.perf_counter() - t0:.1f} s")
    ops.reset_launch_counts()
    call_ms = []
    for _ in range(PREFILL_CALLS):
        t1 = time.perf_counter()
        lg = step(params, ad, {"tokens": toks})
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t1) * 1e3)
    counts = ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(wkv6=PREFILL_CALLS * L,
                lora_matmul=PREFILL_CALLS * L * len(targets))
    print(f"  kernels: {json.dumps(counts)} over {PREFILL_CALLS} calls "
          f"(expected {json.dumps(want)})")
    if counts != want:
        fail("phase 10: launch counts do not match the prefill calls")
    if lg.shape != (PREFILL_BATCH, cfg.vocab_size) or not bool(
            torch.isfinite(lg).all()):
        fail(f"phase 10: logits of shape {tuple(lg.shape)}, finite "
             f"{bool(torch.isfinite(lg).all())}")
    drift = float((lg.float() - first.float()).abs().max())
    if drift > 1e-2 * max(1.0, float(first.float().abs().max())):
        fail(f"phase 10: a repeated call moved the logits by {drift:.3e}")
    med = statistics.median(call_ms)
    tok_s = PREFILL_BATCH * PREFILL_SEQ / (med / 1e3)
    print(f"  prefill call median {med:.2f} ms (host clock, synchronised; "
          f"{', '.join(f'{m:.2f}' for m in call_ms)}): {tok_s:.0f} prompt "
          f"tok/s; repeated-call logits drift {drift:.3e}")

    def run(n):
        for _ in range(n):
            step(params, ad, {"tokens": toks})

    window = profile_window(torch, run, 2, f"prefill call, {PREFILL_BATCH} x "
                            f"{PREFILL_SEQ} tokens")
    wkv6_ms = sum(ms for name, ms in window["port_kernels_ms_per_step"].items()
                  if "wkv6_kernel" in name)
    print(f"  wkv6 device time per call: {wkv6_ms:.3f} ms for {L} launches "
          "(the sequential kernel's 6.6 ms: PERF.md)")
    del params, ad, first, lg
    torch.cuda.empty_cache()
    return {"call_ms": call_ms, "call_ms_median": med, "prefill_tok_s": tok_s,
            "launches": counts, "repeat_drift": drift,
            "wkv6_ms_per_call": wkv6_ms, "profiled_prefill": window}, counts


# -- phase 12: RWKV6 in fp32, kernel routes against plain routes --------------

def _double(tree):
    """A parameter or adapter tree with its floating leaves in fp64."""
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_double(v) for v in tree)
    return tree.double() if tree.is_floating_point() else tree


def rwkv_parity(torch):
    from repro_torch.configs import lora_targets
    from repro_torch.device import parity_mode
    from repro_torch.launch.serve import CONFIGS, make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.serve.adapters import AdapterRegistry, attach
    from repro_torch.train.step import make_prefill_step
    cfg = CONFIGS["rwkv6_1p6b"][0].replace(dtype="float32")
    print(f"phase 12: {cfg.name} at full width in fp32, kernel routes vs "
          "plain routes; " + parity_mode())
    dev = torch.device(DEVICE)
    # The reference's init, the bonus u at zero (phases 2/3 check the u term
    # with u ~ N(0, 0.25)).  A bonus u ~ N(0, 0.25) in all 24 layers makes
    # this random model so ill-conditioned that both fp32 routes land as far
    # from an fp64 evaluation as from each other; (a) prints each route's
    # distance to fp64 at this init.
    params = T.init(cfg, 1, dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    targets = lora_targets(cfg)
    ad = make_adapter(params, targets, 16, gen, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen, device=dev)
    res = {}
    # (a) fp32 on both routes; they differ in sum order (the wkv6 kernel's
    # FMAs and its y = r·S + v·Σ r u k against the loop's einsums;
    # lora_matmul's against two matmuls) through 24 layers: limit 1e-3 of
    # max(1, |logit|)
    lk = make_prefill_step(cfg, use_kernels=True)(params, ad, {"tokens": toks})
    lp = make_prefill_step(cfg, use_kernels=False)(params, ad, {"tokens": toks})
    res["prefill_logits_max_abs_err"] = check(
        "(a) prefill step, kernel vs plain route, 4 x 512 tokens: last logits",
        lk, lp, torch.ones(4, dtype=torch.bool, device=dev), 1e-3)
    f64, a64 = _double(params), _double(ad)
    l64 = make_prefill_step(cfg, use_kernels=False)(f64, a64, {"tokens": toks})
    top = float(l64.abs().max())
    res["kernel_vs_fp64_rel"] = float((lk.double() - l64).abs().max()) / top
    res["plain_vs_fp64_rel"] = float((lp.double() - l64).abs().max()) / top
    print(f"      distance to the plain route in fp64, as a share of max |logit|:"
          f" kernel route {res['kernel_vs_fp64_rel']:.3e}, plain route "
          f"{res['plain_vs_fp64_rel']:.3e}")
    del lk, lp, f64, a64, l64
    # (c) the kernel prefill against decode fed the same prompt one token
    # at a time through the registry (bgmv): the reference's own bound for
    # decode against forward, 2e-4 of max |logit| (tests/test_models.py)
    n_dec = 256
    pre = make_prefill_step(cfg, use_kernels=True)(params, ad,
                                                   {"tokens": toks[:, :n_dec]})
    reg = AdapterRegistry(ad, page_rank=4, max_rank=16, num_pages=8,
                          max_adapters=2, device=dev)
    ids = torch.full((4,), reg.register("r16", ad), dtype=torch.int32, device=dev)
    state = attach(reg.device_state, ids, impl="kernel")
    cache = T.init_cache(cfg, 4, n_dec, device=dev)
    t0 = time.perf_counter()
    for t in range(n_dec):
        lg, cache = T.decode(cfg, params, cache, {"tokens": toks[:, t:t + 1]},
                             state, decode_impl="kernel")
    torch.cuda.synchronize()
    rel = float((lg[:, 0] - pre).abs().max()) / float(pre.abs().max())
    ok = rel <= 2e-4
    print(f"  (c) kernel prefill vs {n_dec} one-token decode steps "
          f"({time.perf_counter() - t0:.1f} s): last logits max |Δ| / max "
          f"|logit| {rel:.3e} (limit 2e-4) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("phase 12: decode disagrees with the kernel prefill")
    res["decode_vs_prefill_rel_err"] = rel
    del params, ad, reg, state, cache, pre, lg
    torch.cuda.empty_cache()
    # (b) phase 5 on this model: bgmv against its plain version in the
    # engine (the recurrence is the same on both routes)
    res["engine"] = engine_parity(torch, "12 (b)", "rwkv6_1p6b",
                                  require_equal=True)
    return res


# -- phase 13: the paper's five methods on TinyLlama-1.1B ---------------------

TINY_TARGETS = ("wq", "wv")          # the paper's setting and Table 3's
TINY_RANK = 16
TINY_ROUNDS = 2
LORA_TINY = "bf16, M=2048 din=2048 dout=256 r=16"
FLASH_TINY = "bf16, causal, B=4 S=512 H=32 K=4 hd=64"
SIGMA_0, RHO = 2048.0, 0.85          # phase 13 (b)'s known spectrum of ΔW


def tinyllama_methods(torch):
    """Two rounds of each of the paper's five methods (FLoRIST, FedIT,
    FFA-LoRA, FLoRA, FlexLoRA) through ``FederatedTrainer`` on
    TinyLlama-1.1B at published widths and full depth (random seeded
    weights, bf16, built once and shared by the five trainers), LoRA on
    ``wq`` and ``wv``, 8 Dirichlet(0.5) clients of rank 16, 4 a round, 4
    local steps of 4 x 512 tokens, the ``bf16`` wire, FLoRIST on the Gram
    route.  Per method and round: eval loss and accuracy, kept ranks, wire
    bytes beside 2 x the analytic counts (must be equal), round wall,
    finalize, median train step, the host spans of the rest of the round
    (downlink: ``server_to_clients``, its encode, count and decode; the
    clients' ``client_init``; ``merge_lora``; the eval step; each between
    two ``synchronize`` calls), launches (must match the code).  Then
    FFA's global A against the frozen init (bit for bit), FLoRA's merged
    base and re-init, (b) every finalize on the card against the CPU in
    fp32, and the Table 4 counterpart."""
    import collections

    import repro_torch.core.federated as fed_mod
    from repro_torch.common.config import LoRAConfig
    from repro_torch.configs.tinyllama_1p1b import CONFIG
    from repro_torch.data.synthetic import make_eval_data, make_federated_data
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfg = CONFIG
    L = cfg.num_layers
    t_phase = time.perf_counter()
    print(f"phase 13: the paper's five methods, {TINY_ROUNDS} rounds each, on "
          f"{cfg.name} at published widths ({L} L, d {cfg.d_model}, "
          f"{cfg.num_heads} H / {cfg.num_kv_heads} KV, hd {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; random seeded "
          f"weights), LoRA r {TINY_RANK} on {'/'.join(TINY_TARGETS)}, 8 "
          f"Dirichlet(0.5) clients, 4 a round, 4 local steps of {FED_BATCH} x "
          f"{FED_SEQ} tokens, bf16 wire, FLoRIST on the Gram route")
    t0 = time.perf_counter()
    params = T.init(cfg, 0, DEVICE)
    clients = make_federated_data(num_clients=8, seq_len=FED_SEQ,
                                  vocab=cfg.vocab_size, alpha=0.5, seed=0)
    ev = make_eval_data(num_samples=16, seq_len=FED_SEQ, vocab=cfg.vocab_size)
    torch.cuda.synchronize()
    print(f"  set-up (weights and data, once for the five): "
          f"{time.perf_counter() - t0:.1f} s")
    lora = LoRAConfig(rank=TINY_RANK, alpha=float(TINY_RANK), targets=TINY_TARGETS)
    spans = collections.Counter()                # host secs a round, by span

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spans[name] += time.perf_counter() - t
            return out
        return call

    merge_lora = fed_mod.merge_lora
    fed_mod.merge_lora = timed("merge", merge_lora)
    try:
        methods = tiny_rounds(torch, cfg, params, clients, ev, lora, spans, timed)
    finally:
        fed_mod.merge_lora = merge_lora
    counts = {k: v for k, v in ops.launch_counts().items()
              if k in ("lora_matmul", "flash_attention", "adapter_gram")}
    print(f"  launches over the five methods: {json.dumps(counts)}")
    del params
    torch.cuda.empty_cache()
    parity = methods_parity(torch)
    table4 = table4_counterpart(torch)
    secs = time.perf_counter() - t_phase
    print(f"  phase 13: {secs:.1f} s")
    return {"methods": methods, "launches": counts, "parity": parity,
            "table4": table4, "phase_s": secs}, counts


def tiny_rounds(torch, cfg, params, clients, ev, lora, spans, timed):
    """Phase 13's rounds: ``TINY_ROUNDS`` of each method in ``METHODS``,
    checked as :func:`tinyllama_methods` says; ``spans`` collects the
    host spans that ``timed`` wraps."""
    import numpy as np
    from repro_torch.common.config import FedConfig, OptimConfig
    from repro_torch.core.aggregators import METHODS, adapter_leaf_paths, get_path
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.core.runtime import SequentialRunner
    from repro_torch.kernels import ops
    from repro_torch.peft.lora import match_rank
    L = cfg.num_layers
    methods = {}
    ops.reset_launch_counts()
    for method in METHODS:
        fed = FedConfig(num_clients=8, clients_per_round=4,
                        homogeneous_rank=TINY_RANK, dirichlet_alpha=0.5,
                        tau=0.9, method=method, seed=0)
        runner = SequentialRunner(record_steps=True)
        tr = FederatedTrainer(cfg, fed, lora, OptimConfig(lr=3e-4),
                              clients=clients, eval_data=ev,
                              batch_size=FED_BATCH, local_steps=4,
                              seq_len=FED_SEQ, svd_method="gram", runner=runner,
                              transport="bf16", params=params, device=DEVICE)
        tr.transport.server_to_clients = timed("downlink",
                                               tr.transport.server_to_clients)
        tr.aggregator.client_init = timed("client_init", tr.aggregator.client_init)
        tr._eval = timed("eval", tr._eval)
        rounds = []
        for rnd in range(TINY_ROUNDS):
            before, n_log = ops.launch_counts(), len(runner.step_log())
            spans.clear()
            rec = tr.run_round(rnd)
            spent = dict(spans)
            after = ops.launch_counts()
            step_ms = [e["ms"] for e in runner.step_log()[n_log:]]
            steps = len(step_ms)
            dims = tr.aggregator.dims
            buckets = len({(n, m) for _, n, m in dims.values()})
            want = {"lora_matmul": L * len(TINY_TARGETS) * steps,
                    "flash_attention": L * (steps + 1),          # + one eval step
                    "adapter_gram": 2 * buckets if method == "florist" else 0}
            got = {k: after[k] - before[k] for k in want}
            ranks = tr.global_state.ranks
            r_sum = sum(tr.aggregator.client_ranks)
            print(f"  {method} round {rnd}: eval loss {rec.eval_loss:.4f} acc "
                  f"{rec.eval_acc:.4f}; upload {rec.upload_bytes} B (2 x "
                  f"{rec.upload_params} params), download {rec.download_bytes} B "
                  f"(2 x {rec.download_params}); wall {rec.wall_secs:.2f} s, "
                  f"finalize {rec.finalize_secs * 1e3:.1f} ms; {steps} train "
                  f"steps, median {statistics.median(step_ms):.2f} ms (CUDA events)")
            print(f"    host spans: " + ", ".join(
                f"{k} {spent.get(k, 0.0):.3f} s" for k in
                ("downlink", "client_init", "merge", "eval"))
                + f"; train steps {sum(step_ms) / 1e3:.3f} s (CUDA events)")
            for path, ps in ranks.items():
                print(f"    kept ranks {'/'.join(map(str, path))}: "
                      f"{ps if len(set(ps)) > 1 else f'{ps[0]} x {len(ps)}'}")
            print(f"    launches {json.dumps(got)}; expected {json.dumps(want)}")
            if got != want:
                fail(f"phase 13 {method} round {rnd}: launch counts {got} != {want}")
            if (rec.upload_bytes != 2 * rec.upload_params
                    or rec.download_bytes != 2 * rec.download_params):
                fail(f"phase 13 {method} round {rnd}: wire bytes differ from "
                     "the analytic 2-byte counts")
            if not np.isfinite(rec.eval_loss):
                fail(f"phase 13 {method} round {rnd}: eval loss {rec.eval_loss}")
            for path, ps in ranks.items():
                _, n, m = dims[path]
                ok = {"fedit": all(p == TINY_RANK for p in ps),
                      "ffa": all(p == TINY_RANK for p in ps),
                      "flora": all(p == r_sum for p in ps),
                      "flexlora": all(p == min(TINY_RANK, n, m) for p in ps),
                      "florist": all(1 <= p <= r_sum for p in ps)}[method]
                if len(ps) != L or not ok:
                    fail(f"phase 13 {method} round {rnd}: kept ranks of {path} "
                         f"are {ps}")
            if method == "flora" and rnd == 0:
                # the stack was merged into the base; clients start over at B = 0
                moved = [not torch.equal(get_path(tr.params, ("blocks", 0, "attn", t)),
                                         get_path(params, ("blocks", 0, "attn", t)))
                         for t in TINY_TARGETS]
                init = tr.aggregator.client_init(tr.global_state, TINY_RANK,
                                                 tr.A_init_full)
                a0 = match_rank(tr.A_init_full, TINY_RANK)
                fresh = all(not torch.as_tensor(get_path(init, p)["B"]).any()
                            and torch.equal(get_path(init, p)["A"],
                                            get_path(a0, p)["A"])
                            for p in adapter_leaf_paths(init))
                print(f"    base weights moved by the merge: {moved}; clients "
                      f"start round 1 at B = 0 and the shared A: {fresh}")
                if not all(moved) or not fresh:
                    fail("phase 13 flora: the merge or the re-init did not happen")
            rounds.append({"record": dataclasses.asdict(rec),
                           "ranks": {"/".join(map(str, k)): v for k, v in ranks.items()},
                           "train_step_ms": step_ms,
                           "train_step_ms_median": statistics.median(step_ms),
                           "spans_s": spent,
                           "launches": got})
        if method == "ffa":
            g = tr.global_state.global_adapters
            same = all(torch.equal(torch.as_tensor(get_path(g, p)["A"]),
                                   get_path(tr.A_init_full, p)["A"])
                       for p in adapter_leaf_paths(g))
            print(f"    global A after round {TINY_ROUNDS - 1} equals the frozen "
                  f"init bit for bit: {same}")
            if not same:
                fail("phase 13 ffa: the global A moved off the frozen init")
        methods[method] = rounds
        del tr
        torch.cuda.empty_cache()
    return methods


def parity_trees(kind):
    """Phase 13 (b)'s client trees at TinyLlama's leaf shapes (wq 2048 ->
    2048, wv 2048 -> 256; 4 clients of rank 16, numpy fp32, from seed 13):
    ``(clients, w, a_init, levels)``, with w the clients' weights and
    a_init an FFA A init.

    ``"known"``: each layer's clients hold disjoint columns of one
    orthonormal pair, B at ``levels`` and A divided by w_k, so ΔW = Σ w_k
    B_k A_k has the known spectrum SIGMA_0 · RHO^i, i < 64.
    ``"gaussian"``: i.i.d. standard normal B_k and A_k (``levels`` None),
    whose clustered spectra put the cuts inside clusters."""
    import numpy as np
    from repro_torch.configs.tinyllama_1p1b import CONFIG
    L, d, K, R = CONFIG.num_layers, CONFIG.d_model, 4, TINY_RANK
    shapes = {"wq": (d, CONFIG.num_heads * CONFIG.head_dim),
              "wv": (d, CONFIG.num_kv_heads * CONFIG.head_dim)}  # (n_in, m_out)
    rng = np.random.default_rng(13)
    w = rng.dirichlet(np.ones(K))
    ones = np.ones(L, np.float32)
    if kind == "known":
        levels = SIGMA_0 * RHO ** np.arange(K * R)
        bases = {name: [(np.linalg.qr(rng.normal(size=(m, K * R)))[0],
                         np.linalg.qr(rng.normal(size=(n, K * R)))[0])
                        for _ in range(L)] for name, (n, m) in shapes.items()}
        # client k: columns k, k + K, ... of each layer's bases
        clients = [{"blocks": {0: {"attn": {name: {
            "B": np.stack([qb[:, k::K] * levels[k::K] for qb, _ in bases[name]]
                          ).astype(np.float32),
            "A": np.stack([qa[:, k::K].T / w[k] for _, qa in bases[name]]
                          ).astype(np.float32),
            "scale": ones} for name in shapes}}}} for k in range(K)]
    elif kind == "gaussian":
        levels = None
        clients = [{"blocks": {0: {"attn": {name: {
            "B": rng.normal(size=(L, m, R)).astype(np.float32),
            "A": rng.normal(size=(L, R, n)).astype(np.float32),
            "scale": ones} for name, (n, m) in shapes.items()}}}}
            for _ in range(K)]
    else:
        raise ValueError(kind)
    a_init = {"blocks": {0: {"attn": {name: {
        "A": rng.normal(size=(L, R, n)).astype(np.float32)}
        for name, (n, m) in shapes.items()}}}}
    return clients, w, a_init, levels


def exact_svd(clients, w, name, layer):
    """The fp64 SVD of ΔW = Σ w_k B_k A_k of one leaf's layer, exact through
    QR of the stacks: ``(u (m, Σr), s (Σr,), v (n, Σr))``; rank-p cut
    ``(u[:, :p] * s[:p]) @ v[:, :p].T``."""
    import numpy as np
    leaves = [c["blocks"][0]["attn"][name] for c in clients]
    bs = np.concatenate([lf["B"][layer].astype(np.float64) for lf in leaves], 1)
    as_ = np.concatenate([wk * lf["A"][layer].astype(np.float64)
                          for wk, lf in zip(w, leaves)], 0)
    qb, rb = np.linalg.qr(bs)
    qa, ra = np.linalg.qr(as_.T)
    u, s, vt = np.linalg.svd(rb @ ra.T)
    return qb @ u, s, qa @ vt.T


PARITY_CASES = (("florist (svd)", "florist", {"svd_method": "svd"}),
                ("florist (gram)", "florist", {"svd_method": "gram"}),
                ("fedit", "fedit", {}), ("ffa", "ffa", {}),
                ("flora", "flora", {}), ("flexlora", "flexlora", {}))


def parity_finalize(torch, method, kw, data, dev):
    """One aggregator's finalize on ``data`` (:func:`parity_trees`) on
    ``dev``: A and B as numpy off the wire, scale a tensor, FFA handed the
    A init.  Returns (AggResult, seconds to a synchronized finish)."""
    from repro_torch.core.aggregators import make_aggregator
    clients, w, a_init, _ = data
    kw = dict(kw)
    if method == "ffa":
        kw["A_init"] = {"blocks": {0: {"attn": {
            n: {"A": torch.as_tensor(leaf["A"], device=dev)}
            for n, leaf in a_init["blocks"][0]["attn"].items()}}}}
    arriving = [{"blocks": {0: {"attn": {n: {
        "A": leaf["A"], "B": leaf["B"],
        "scale": torch.as_tensor(leaf["scale"], device=dev)}
        for n, leaf in c["blocks"][0]["attn"].items()}}}} for c in clients]
    t0 = time.perf_counter()
    res = make_aggregator(method, **kw).aggregate(arriving, w)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def tree_products(torch, res, dtype=None):
    """The products B·A of ``res``'s global tree and of its per-client
    trees, in ``dtype`` (fp32 by default) on the trees' device:
    ``[{leaf path: (L, m, n)}]``."""
    from repro_torch.core.aggregators import adapter_leaf_paths, get_path
    dtype = dtype or torch.float32
    trees = [res.global_adapters] + list(res.per_client or [])
    return [{p: torch.matmul(torch.as_tensor(get_path(t, p)["B"]).to(dtype),
                             torch.as_tensor(get_path(t, p)["A"]).to(dtype))
             for p in adapter_leaf_paths(t)} for t in trees]


def fp64_distance(torch, res, exact, full_global):
    """max over ``res``'s trees, leaves and layers of |B·A − ΔW's fp64 SVD
    cut at the tree's rank| / max |ΔW|, in fp64 on the trees' device: the
    global tree at its kept ranks (at full rank where ``full_global``:
    FlexLoRA's global tree is the full SVD), per-client trees at
    ``TINY_RANK``.  ``exact``: leaf name -> [:func:`exact_svd`] by layer."""
    worst = 0.0
    for i, tree in enumerate(tree_products(torch, res, torch.float64)):
        for path, prod in tree.items():
            for l, factors in enumerate(exact[path[-1]]):
                u, s, v = (torch.as_tensor(f, device=prod.device) for f in factors)
                p = (len(s) if full_global else res.ranks[path][l]) if i == 0 \
                    else TINY_RANK
                p = min(p, len(s))
                dw = (u * s) @ v.T
                want = (u[:, :p] * s[:p]) @ v[:, :p].T
                worst = max(worst, float((prod[l] - want).abs().max()
                                         / dw.abs().max()))
    return worst


def methods_parity(torch):
    """(b): each of the five finalizes (FLoRIST on both SVD routes), fed the
    same numpy client trees at TinyLlama's leaf shapes (4 clients of rank
    16; wq 2048 -> 2048, wv 2048 -> 256), in fp32 (TF32 off) on the card
    (cuSOLVER, ``adapter_gram``) and on the CPU (LAPACK, the plain Gram
    product).

    First on :func:`parity_trees` "known": ΔW = Σ w_k B_k A_k has the known
    spectrum SIGMA_0 · RHO^i, i < 64, which decays as trained adapters' do,
    and every cut (FLoRIST's τ 0.9, FlexLoRA's rank 16) sits on a 15% gap.
    Kept ranks must be equal (FLoRIST's the known energy rank), the
    products B·A of the global trees and of FlexLoRA's per-client trees
    within 1e-4 · max(1, |ΔW|) (ΔW the CPU's product: fp32 sums in another
    order, and the Gram route squares the condition number), and both
    sides' spectra within 1e-4 of σ_1 of the known one above the Gram
    route's resolution.  Then :func:`gaussian_parity`."""
    import numpy as np
    from repro_torch.configs.tinyllama_1p1b import CONFIG
    from repro_torch.device import parity_mode
    K, R = 4, TINY_RANK
    print(f"phase 13 (b): every finalize on the card against the CPU, fp32, "
          f"{K} clients of rank {R} at {CONFIG.name}'s leaf shapes, ΔW's spectrum "
          f"{SIGMA_0:g} x {RHO}^i; " + parity_mode())
    data = parity_trees("known")
    levels = data[3]
    energy = np.cumsum(levels ** 2) / np.sum(levels ** 2)
    p_known = int(np.searchsorted(energy.astype(np.float32), np.float32(0.9)) + 1)

    def spectrum_err(res):
        """max over leaves and layers of |σ_i - known_i| / σ_1, for the σ
        above the Gram route's resolution σ_1·√(Σr·eps)."""
        worst = 0.0
        for sps in res.spectra.values():
            for sp in sps:
                sp = np.asarray(sp)[:K * R]
                big = levels > 2 * levels[0] * np.sqrt(K * R * np.finfo(np.float32).eps)
                worst = max(worst, float(np.abs(sp - levels)[big].max() / levels[0]))
        return worst

    out = {"known_florist_rank": p_known}
    for label, method, kw in PARITY_CASES:
        gpu, t_gpu = parity_finalize(torch, method, kw, data, DEVICE)
        cpu, t_cpu = parity_finalize(torch, method, kw, data, "cpu")
        if gpu.ranks != cpu.ranks:
            fail(f"phase 13 (b) {label}: kept ranks differ between the card "
                 f"and the CPU: {gpu.ranks} vs {cpu.ranks}")
        if method == "florist" and any(p != p_known for ps in cpu.ranks.values()
                                       for p in ps):
            fail(f"phase 13 (b) {label}: kept ranks {cpu.ranks}, the known "
                 f"energy rank is {p_known}")
        worst, worst_rel = 0.0, 0.0
        for pg, pc in zip(tree_products(torch, gpu), tree_products(torch, cpu)):
            for p in pc:
                dw = pc[p]
                err = float((pg[p].cpu() - dw).abs().max())
                lim = 1e-4 * max(1.0, float(dw.abs().max()))
                worst = max(worst, err / lim)
                worst_rel = max(worst_rel, err / float(dw.abs().max()))
        sp_err = ((spectrum_err(gpu), spectrum_err(cpu)) if gpu.spectra else None)
        n_trees = 1 + len(gpu.per_client or [])
        ok = worst <= 1.0 and (sp_err is None or max(sp_err) <= 1e-4)
        print(f"  {label}: {n_trees} tree{'s' if n_trees > 1 else ''}, ranks "
              f"equal{f' ({p_known} a layer, as known)' if method == 'florist' else ''}; "
              f"max |Δ(B·A)| {worst * 1e-4:.2e} of max(1, |ΔW|) (limit 1e-4; "
              f"{worst_rel:.2e} of max |ΔW|)"
              + (f"; spectra off the known by {sp_err[0]:.2e} (card) and "
                 f"{sp_err[1]:.2e} (CPU) of σ_1 (limit 1e-4)" if sp_err else "")
              + f"; finalize {t_gpu:.2f} s on the card (first call), {t_cpu:.2f} s "
              f"on the CPU {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"phase 13 (b) {label}: the card's finalize disagrees with the CPU's")
        out[label] = {"err_over_limit": worst, "rel_err": worst_rel,
                      "spectrum_err": sp_err, "card_s": t_gpu, "cpu_s": t_cpu}
        del gpu, cpu
        torch.cuda.empty_cache()
    out["gaussian"] = gaussian_parity(torch)
    return out


def gaussian_parity(torch):
    """(b) on :func:`parity_trees` "gaussian": i.i.d. Gaussian factors give
    clustered spectra, so FLoRIST's τ cut and FlexLoRA's rank-16 cut fall
    inside clusters, where a truncated product moves by the route's fp32
    error over a small gap and the card and the CPU need not agree to
    1e-4.  So each side is held to ΔW's fp64 SVD (:func:`exact_svd`) cut at
    the same ranks: the kept ranks must be equal and the card no further
    from fp64 than twice the CPU (LAPACK, the reference's route)."""
    data = parity_trees("gaussian")
    exact = {n: [exact_svd(data[0], data[1], n, l)
                 for l in range(len(data[0][0]["blocks"][0]["attn"][n]["B"]))]
             for n in ("wq", "wv")}
    print("phase 13 (b): the same on i.i.d. Gaussian client trees (cuts inside "
          "spectral clusters), each side held to ΔW's fp64 SVD at the same ranks")
    out = {}
    for label, method, kw in PARITY_CASES:
        if method not in ("florist", "flexlora"):
            continue                    # no truncation: equal sums above
        gpu, t_gpu = parity_finalize(torch, method, kw, data, DEVICE)
        cpu, t_cpu = parity_finalize(torch, method, kw, data, "cpu")
        full = method == "flexlora"
        err = (fp64_distance(torch, gpu, exact, full),
               fp64_distance(torch, cpu, exact, full))
        ok = gpu.ranks == cpu.ranks and err[0] <= 2 * err[1]
        print(f"  {label}: ranks {'equal' if gpu.ranks == cpu.ranks else 'DIFFER'}; "
              f"max |B·A − fp64| {err[0]:.2e} (card) and {err[1]:.2e} (CPU) of "
              f"max |ΔW| (card limit 2 x the CPU's); finalize {t_gpu:.2f} s on the "
              f"card, {t_cpu:.2f} s on the CPU {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"phase 13 (b) {label}: on Gaussian trees the card is further "
                 "from the fp64 SVD than twice the CPU, or its ranks differ")
        out[label] = {"fp64_err_card": err[0], "fp64_err_cpu": err[1],
                      "card_s": t_gpu, "cpu_s": t_cpu}
        del gpu, cpu
        torch.cuda.empty_cache()
    return out


def table4_counterpart(torch):
    """``repro_torch.benchmarks.table4_server_flops`` on the card: the
    elapsed time (between two CUDA events, host syncs inside) of FLoRIST's
    core and of FlexLoRA's dense ΔW plus SVD on one 2048 x 2048 layer (K 10,
    R 16), analytic FLOPs beside; the ratio, claiming nothing."""
    from repro_torch.benchmarks import table4_server_flops as t4
    print("phase 13: Table 4 counterpart (elapsed time between CUDA events; "
          "analytic FLOPs)")
    rows = t4.run(device=DEVICE)
    for r in rows:
        print(f"  {r['name']},{r['us_per_call']},{r['derived']}")
    return rows


if __name__ == "__main__":
    main()
