"""Kernel micro-benchmarks (port of the reference's
``benchmarks/kernel_bench.py``).

Rows: ``lora_matmul``, ``flash_attention``, ``wkv6`` and ``adapter_gram``
at the reference's shapes (fp32).  On the card each row times the kernel
through :mod:`repro_torch.kernels.ops` (``us_per_call``) beside its plain
version (:mod:`repro_torch.kernels.ref`), and ``derived`` gives the flops,
the bytes each input read once and each output written once, and the
H100's bound for them (the larger of bytes at 3.35 TB/s and flops at the
67 TFLOP/s fp32 peak of the SXM part's data sheet).  On the CPU ``ops``
takes the plain version, so a row times that and its kernel time reads
``not measured``.

The decode section compares the decode attention routes over a wrapped
ring cache (fp32 and int8): ``dense`` (the plain version, full
(B,H,C,cap) scores and the (B,C,cap) mask; int8 dequantized whole),
``streamed`` (:func:`~repro_torch.models.attention_core.ring_flash_decode`,
online softmax over kv blocks) and, on the card, ``kernel``
(``ops.ring_decode``), with each route's analytic bytes a step.

The live-memory check runs one serve step of ``DEC_MODEL`` per route under
a ``TorchDispatchMode`` that records the shape and dtype of every tensor an
operation returns: the streamed step must create no fp32 (B,H,C,cap) or
(B,K,g,C,cap) scores and no bool (B,C,cap) mask, and the dense step must
create them; on the card the streamed step's peak allocation
(``max_memory_allocated``) must not exceed the dense step's.  A violation
raises.  The reference reads the same facts from the compiled HLO.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench [--json PATH] \\
        [--cap 2048] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.benchmarks.common import timeit
from repro_torch.common.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as T
from repro_torch.models.attention_core import ring_flash_decode
from repro_torch.serve.kvcache import quant
from repro_torch.train.step import make_serve_step

DEC_MODEL = ModelConfig(name="kernelbench-tiny", family="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                        d_ff=128, vocab_size=256, dtype="float32")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # ... float32 outside the tensor cores


def time_us(fn: Callable, *args, dev: torch.device, iters: int = 20) -> float:
    """Mean µs a call: on the card CUDA events around ``iters`` calls after
    a warm-up; on the CPU the host clock's median of 3 (``timeit``)."""
    if dev.type != "cuda":
        return timeit(fn, *args)
    for _ in range(3):
        fn(*args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def bound_us(flops: float, nbytes: float) -> float:
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e6


def _row(name: str, dev, kernel: Callable, plain: Callable, args,
         flops: float, nbytes: float) -> Dict:
    plain_us = time_us(plain, *args, dev=dev)
    kern_us = time_us(kernel, *args, dev=dev) if dev.type == "cuda" else None
    b = bound_us(flops, nbytes)
    shown = kern_us if kern_us is not None else plain_us
    derived = (f"flops={flops:.3e};bytes={nbytes:.3e};h100_bound_us={b:.2f};"
               f"plain_us={plain_us:.1f};kernel_us="
               + (f"{kern_us:.1f}" if kern_us is not None else "not measured")
               + f";device={dev.type}")
    return {"name": f"kernel/{name}", "us_per_call": f"{shown:.1f}",
            "derived": derived}


def run(device: DeviceLike = None) -> List[Dict]:
    """The four rows at the reference's shapes, fp32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def t(shape, s=1.0):
        return torch.as_tensor(rng.normal(size=shape) * s, dtype=torch.float32,
                               device=dev)

    rows = []
    # fused LoRA matmul: M=2048, d=2048, r=16
    M, D, O, R = 2048, 2048, 2048, 16
    x, w, a, b = t((M, D)), t((D, O), 0.02), t((R, D), 0.02), t((O, R), 0.02)
    s = torch.tensor(0.5, device=dev)
    with torch.no_grad():
        rows.append(_row("lora_matmul", dev, ops.lora_matmul,
                         lambda *ar: ref.lora_matmul_ref(*ar[:4], 0.5),
                         (x, w, a, b, s), 2 * M * D * O + 2 * M * R * (D + O),
                         4 * (M * D + D * O + R * D + O * R + M * O)))
        # flash attention: B=1, S=1024, H=8, K=2, hd=64, causal (both
        # sides' default): the two products over the S(S+1)/2 live pairs
        q, k, v = t((1, 1024, 8, 64)), t((1, 1024, 2, 64)), t((1, 1024, 2, 64))
        rows.append(_row("flash_attention", dev, ops.flash_attention,
                         ref.flash_attention_ref, (q, k, v),
                         2 * 2 * (1024 * 1025 // 2) * 8 * 64,
                         4 * (2 * 1024 * 8 * 64 + 2 * 1024 * 2 * 64)))
        # wkv6: B=1, S=512, H=8, hd=64
        r_ = t((1, 512, 8, 64))
        w_ = -torch.exp(t((1, 512, 8, 64)))
        u = t((8, 64))
        rows.append(_row("wkv6", dev, ops.wkv6, ref.wkv6_ref, (r_, r_, r_, w_, u),
                         4 * 512 * 8 * 64 * 64, 4 * (5 * 512 * 8 * 64 + 8 * 64)))
        # adapter gram: m=8192, r=160
        xg = t((8192, 160))
        rows.append(_row("adapter_gram", dev, ops.adapter_gram,
                         ref.adapter_gram_ref, (xg,), 2 * 8192 * 160 * 160,
                         4 * (8192 * 160 + 160 * 160)))
    return rows


def decode_bytes(B, C, H, K, hd, cap, block, int8: bool):
    """Analytic bytes a step of one decode attention layer moves.

    Every route streams the raw cache once (once per kv head) and writes
    the (B,C,H,hd) fp32 output.  The dense route also round-trips the
    (B,H,C,cap) fp32 scores (written by the scores product, read and
    written by the mask and the softmax, read by the value product),
    writes the (B,C,cap) bool ring mask and, with an int8 cache, a bf16
    copy of the cache.  The streamed route's scores and mask are (C, block)
    tiles a block; the kernel's stay on chip."""
    elt = 1 if int8 else 4
    cache = 2 * B * cap * K * hd * elt + (2 * B * cap * K * 4 if int8 else 0)
    out = B * C * H * hd * 4
    common = cache + out
    scores = B * H * C * cap * 4
    mask = B * C * cap
    dense = common + 4 * scores + mask + (2 * B * cap * K * hd * 2 if int8 else 0)
    return {"dense": dense, "streamed": common, "kernel": common,
            "live_score_tile": {"dense": scores,
                                "streamed": B * H * C * block * 4,
                                "kernel": 0}}


def bench_decode(rng, B=8, C=8, H=8, K=2, hd=64, cap=2048, block=128,
                 device: DeviceLike = None) -> Dict:
    """Time the dense, streamed and (on the card) kernel decode routes over
    a wrapped ring cache, fp32 and int8, with their analytic bytes."""
    dev = resolve_device(device)

    def t(shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev)

    q, k, v = t((B, C, H, hd)), t((B, cap, K, hd)), t((B, cap, K, hd))
    pos = torch.full((B,), cap + 37, dtype=torch.int32, device=dev)   # wrapped
    length = torch.full((B,), cap, dtype=torch.int32, device=dev)
    n = torch.full((B,), C, dtype=torch.int32, device=dev)
    kq, ks = quant(k)
    vq, vs = quant(v)
    routes = {
        "dense": ref.ring_decode_ref,
        "streamed": lambda *a, **kw: ring_flash_decode(*a, block=block, **kw),
    }
    if dev.type == "cuda":
        routes["kernel"] = ops.ring_decode
    out = {"shape": {"B": B, "C": C, "H": H, "K": K, "hd": hd, "cap": cap,
                     "block": block}, "device": dev.type}
    with torch.no_grad():
        for prec in ("fp32", "int8"):
            int8 = prec == "int8"
            args = (q, kq, vq, pos, length, n) if int8 else (q, k, v, pos, length, n)
            kw = dict(k_scale=ks, v_scale=vs) if int8 else {}
            bts = decode_bytes(B, C, H, K, hd, cap, block, int8)
            for impl, fn in routes.items():
                us = time_us(lambda *a: fn(*a, **kw), *args, dev=dev)
                out[f"{impl}_{prec}"] = {
                    "us_per_call": round(us, 1),
                    "analytic_hbm_bytes": bts[impl],
                    "live_score_bytes": bts["live_score_tile"][impl]}
    for p in ("fp32", "int8"):
        out[f"speedup_streamed_vs_dense_{p}"] = round(
            out[f"dense_{p}"]["us_per_call"]
            / out[f"streamed_{p}"]["us_per_call"], 2)
        out[f"hbm_bytes_ratio_{p}"] = round(
            out[f"dense_{p}"]["analytic_hbm_bytes"]
            / out[f"streamed_{p}"]["analytic_hbm_bytes"], 2)
        if "kernel" in routes:
            out[f"speedup_kernel_vs_streamed_{p}"] = round(
                out[f"streamed_{p}"]["us_per_call"]
                / out[f"kernel_{p}"]["us_per_call"], 2)
    return out


class OutputShapes(TorchDispatchMode):
    """Records ``(shape, dtype)`` of every tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.add((tuple(t.shape), t.dtype))
        return out


def serve_step_live_memory_check(B=4, C=8, cap=256,
                                 device: DeviceLike = None) -> Dict:
    """One serve step of ``DEC_MODEL`` per route: the streamed step creates
    neither the (B,H,C,cap) / (B,K,g,C,cap) fp32 scores nor the (B,C,cap)
    bool mask, the dense step creates them, and on the card the streamed
    step's peak allocation is no larger than the dense step's.  Raises on
    a violation."""
    dev = resolve_device(device)
    cfg = DEC_MODEL
    H, K = cfg.num_heads, cfg.num_kv_heads
    checked = {f"f32[{B},{H},{C},{cap}]": ((B, H, C, cap), torch.float32),
               f"f32[{B},{K},{H // K},{C},{cap}]": ((B, K, H // K, C, cap),
                                                    torch.float32),
               f"pred[{B},{C},{cap}]": ((B, C, cap), torch.bool)}
    params = T.init(cfg, 0, dev)
    batch = {"tokens": torch.zeros((B, C), dtype=torch.long, device=dev),
             "n_tokens": torch.full((B,), C, dtype=torch.int32, device=dev)}
    report = {"shape": {"B": B, "C": C, "cap": cap, "H": H, "K": K},
              "checked_buffers": list(checked), "device": dev.type}
    for impl in ("dense", "streamed"):
        step = make_serve_step(cfg, impl)
        step(params, None, T.init_cache(cfg, B, cap, torch.float32,
                                        prefill_chunk=C, device=dev), batch)
        cache = T.init_cache(cfg, B, cap, torch.float32, prefill_chunk=C,
                             device=dev)
        peak: Optional[int] = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        with OutputShapes() as rec:
            step(params, None, cache, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - base
        report[impl] = {"materialized_buffers": [n for n, key in checked.items()
                                                 if key in rec.seen],
                        "peak_bytes": peak}
    if not report["dense"]["materialized_buffers"]:
        raise AssertionError("sanity: the dense step should create the "
                             "score and mask buffers")
    if report["streamed"]["materialized_buffers"]:
        raise AssertionError(f"the streamed serve step creates "
                             f"{report['streamed']['materialized_buffers']}")
    dp, sp = report["dense"]["peak_bytes"], report["streamed"]["peak_bytes"]
    if dp is not None and sp > dp:
        raise AssertionError(f"streamed peak {sp} bytes > dense peak {dp}")
    return report


def report(device: DeviceLike = None, cap: int = 2048,
           log: Callable = print) -> Dict:
    """The rows, the decode section and the live-memory check, as the
    reference's ``main`` prints and writes them."""
    dev = resolve_device(device)
    rows = run(dev)
    for r in rows:
        log(f"{r['name']},{r.get('us_per_call', '')},{r.get('derived', '')}")
    decode = bench_decode(np.random.default_rng(0), cap=cap, device=dev)
    for p in ("fp32", "int8"):
        kern = (f", kernel {decode[f'kernel_{p}']['us_per_call']}us"
                if f"kernel_{p}" in decode else "")
        log(f"decode[{p}]: dense {decode[f'dense_{p}']['us_per_call']}us vs "
            f"streamed {decode[f'streamed_{p}']['us_per_call']}us"
            f"{kern} ({decode[f'speedup_streamed_vs_dense_{p}']}x, analytic "
            f"HBM {decode[f'hbm_bytes_ratio_{p}']}x less)")
    live = serve_step_live_memory_check(device=dev)
    log(f"serve-step live-memory check: dense creates "
        f"{live['dense']['materialized_buffers']}, streamed none (peak "
        f"{live['dense']['peak_bytes']} -> {live['streamed']['peak_bytes']} "
        "bytes)")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"backend": name, "kernels": rows, "decode": decode,
            "serve_step_live_memory": live}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="", help="write results to this path")
    ap.add_argument("--cap", type=int, default=2048,
                    help="ring capacity for the decode timing arms")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    rep = report(args.device, args.cap)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
