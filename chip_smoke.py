#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no exception is caught):

1. Print the card's name and power limit; build both CUDA kernels from the
   sources in the checkout (set-up time).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with the tolerance stated beside each comparison;
   ``ring_decode`` also on a one-tile ring (no split, no merge) and at head
   dims 16, 32 and 128.
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

It fails without a CUDA device, and in a directory that lacks the port's
sources.  Details go to ``chiprun_out/chip_smoke.json``.
"""
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
    report["kernel_cases"] = kernel_cases(torch)
    report["e2e"], counts = end_to_end(torch)
    report["parity"] = engine_parity(torch)

    kernels = []
    for name, case in (("ring_decode", "bf16 cache, C=1, B=8 H=32 K=8 hd=64 cap=1024"),
                       ("bgmv", "bf16, C=1, B=8 din=2048 dout=2048 pr=4 Pmax=4")):
        rec = next(r for r in report["kernel_cases"]
                   if r["name"] == name and r["case"] == case)
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "case")}
            | {"launches": counts[name]})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
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
            dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_n / PEAK_OPS[dtype] * 1e3
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "case": case, "max_abs_err": err, "ms": ms,
           "plain_ms": plain, "library_ms": lib,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops_n}
    print(f"  {name}[{case}]: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"library {'-' if lib is None else f'{lib:.4f} ms'}, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
          f"{nbytes / 1e6:.2f} MB, {ops_n / 1e9:.3f} GFLOP)")
    return rec


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import SamplingParams

    def wave():
        for i in range(eng.B):
            eng.submit(list(range(1 + i, 17 + i)),
                       SamplingParams(max_tokens=2 * steps + 4))
        eng.run_steps(2)                   # admission and the prefill step
        torch.cuda.synchronize()

    wave()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run_steps(steps)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_steps(steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    eng.run()
    by_kernel, by_op = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:          # kernels and copies
            by_kernel[e.key] = e.self_device_time_total / 1e3 / steps
        elif e.self_cpu_time_total > 0:                # host operators
            by_op[e.key] = e.self_cpu_time_total / 1e3 / steps
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    print(f"  decode step, {steps} steps x {eng.B} rows: wall {wall_ms:.3f} ms "
          f"per step (no profiler); device busy {busy:.3f} ms per step "
          f"(profiler): idle share {1 - busy / wall_ms:.3f}")
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
    dev = torch.device("cuda")
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


if __name__ == "__main__":
    main()
