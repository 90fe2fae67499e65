"""Batched serving of a fine-tuned (base + global LoRA) model: chunked
prefill through the cached sequence path, then greedy batched decode.  Port
of the reference's ``examples/serve_batch.py``.

The KV cache carries **per-slot** positions, so prefill feeds whole prompt
chunks (``--prefill-chunk`` tokens a call) instead of one token a step.

  PYTHONPATH=src python -m repro_torch.examples.serve_batch \
      [--arch qwen2-0.5b] [--batch 4] [--prompt-len 16] [--gen 24] \
      [--window 0] [--prefill-chunk 8] [--int8-cache] \
      [--decode-impl dense|streamed|kernel] [--device cpu]

The model is the architecture's SMOKE config with random weights (seeded).
Runs on ``cuda`` unless ``--device cpu`` is given; on the CPU
``--decode-impl kernel`` takes ``ring_decode``'s plain version.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config, lora_targets
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.peft.lora import init_lora
from repro_torch.train.step import make_serve_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window size (0 = full attention)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens fed a prefill call")
    ap.add_argument("--int8-cache", action="store_true")
    ap.add_argument("--decode-impl", default="dense",
                    choices=["dense", "streamed", "kernel"],
                    help="attention interior: dense oracle, streamed "
                         "ring-flash-decode, or the ring_decode kernel")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    if args.window:
        cfg = cfg.replace(sliding_window=args.window)
    params = T.init(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    adapters = init_lora(params, lora_targets(cfg), 8, 16.0, gen, sigma=0.05)

    B = args.batch
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(4, cfg.vocab_size,
                                           (B, args.prompt_len)), device=dev)

    serve = make_serve_step(cfg, decode_impl=args.decode_impl)
    kv_dtype = torch.int8 if args.int8_cache else T.torch_dtype(cfg.dtype)
    C = max(1, min(args.prefill_chunk, args.prompt_len))
    cache = T.init_cache(cfg, B, capacity=args.prompt_len + args.gen,
                         kv_dtype=kv_dtype, prefill_chunk=C, device=dev)
    print(f"== serving {cfg.name}: batch={B}, prompt={args.prompt_len}, "
          f"gen={args.gen}, window={args.window or 'full'}, "
          f"cache={kv_dtype}, prefill_chunk={C}, "
          f"decode_impl={args.decode_impl}, device={dev} ==")
    # chunked prefill: whole prompt chunks through the cached sequence path
    t0 = time.time()
    n_calls = 0
    for t in range(0, args.prompt_len, C):
        chunk = prompts[:, t: t + C]
        n = torch.full((B,), chunk.shape[1], dtype=torch.int32, device=dev)
        logits, cache = serve(params, adapters, cache,
                              {"tokens": chunk, "n_tokens": n})
        n_calls += 1
    print(f"prefill: {args.prompt_len} tokens in {n_calls} calls, "
          f"{time.time()-t0:.2f}s")

    generated = []
    tok = logits.argmax(-1)[:, None]
    t0 = time.time()
    for _ in range(args.gen):
        generated.append(tok)
        logits, cache = serve(params, adapters, cache, {"tokens": tok})
        tok = logits.argmax(-1)[:, None]
    gen_toks = torch.cat(generated, dim=1).cpu()
    dt = time.time() - t0
    print(f"decode: {args.gen} steps × batch {B} in {dt:.2f}s "
          f"({B*args.gen/dt:.1f} tok/s on {dev})")
    for b in range(min(B, 2)):
        print(f"  seq{b}: {gen_toks[b].tolist()}")
    return gen_toks


if __name__ == "__main__":
    main()
