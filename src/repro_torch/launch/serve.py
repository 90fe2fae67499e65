"""Serve several FLoRIST global adapters of different ranks from one engine.

The port's counterpart of ``examples/serve_federated.py`` without the
training half: one :class:`~repro_torch.serve.engine.ServeEngine` mounted on
an :class:`~repro_torch.serve.adapters.AdapterRegistry` holding adapters of
ranks 4, 8 and 16 (random, seeded) on the family's LoRA targets
(``lora_targets``: ``wq wk wv wo``, MLA's ``wq_a wq_b wkv_a wkv_b wo``, or
RWKV6's ``wr wk wv wg wo``)
serves a wave of requests on mixed adapter ids, the base id 0 included,
through ``decode_impl="kernel"``.  Part-way through, one adapter name is
``swap``-ped to a new version: rows admitted on the old id finish on it, new
requests go to the new id.  Weights are random (seeded) at the
configuration's published widths; DeepSeek-V3 is cut to its three dense MLA
layers (``configs.deepseek_v3_671b.DENSE3``); RWKV6-1.6B runs whole, one
token per engine step (its recurrent state takes no chunks).

    python -m repro_torch.launch.serve                  # Llama-3.2-1B, cuda
    python -m repro_torch.launch.serve --config deepseek_v3_dense3
    python -m repro_torch.launch.serve --config rwkv6_1p6b
    python -m repro_torch.launch.serve --config smoke --device cpu
    python -m repro_torch.launch.serve --config deepseek_smoke --device cpu
    python -m repro_torch.launch.serve --config rwkv_smoke --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import (deepseek_v3_671b, llama3p2_1b, lora_targets,
                                 rwkv6_1p6b)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.peft.lora import init_lora
from repro_torch.serve.adapters import AdapterRegistry, adapter_leaves
from repro_torch.serve.engine import SamplingParams, ServeEngine

SEED = 0
SLOTS = 8
N_REQUESTS = 16
MAX_TOKENS = 32
RANKS = (4, 8, 16)
SWAP_AFTER_STEPS = 6
# config name -> (model, ring capacity, prefill chunk, prompt length range)
CONFIGS = {
    "llama3p2_1b": (llama3p2_1b.CONFIG, 1024, 16, (32, 256)),
    "deepseek_v3_dense3": (deepseek_v3_671b.DENSE3, 1024, 16, (32, 256)),
    "rwkv6_1p6b": (rwkv6_1p6b.CONFIG, 1024, 16, (32, 256)),
    "smoke": (llama3p2_1b.SMOKE, 64, 4, (4, 24)),
    "deepseek_smoke": (deepseek_v3_671b.SMOKE.replace(first_dense_layers=3),
                       64, 4, (4, 24)),
    "rwkv_smoke": (rwkv6_1p6b.SMOKE, 64, 4, (4, 24)),
}


def make_adapter(params: Dict, targets: Sequence[str], rank: int,
                 gen: torch.Generator, dtype: torch.dtype) -> Dict:
    """A rank-``rank`` adapter on ``targets`` with non-zero B on every leaf
    (a trained adapter changes the outputs; ``init_lora``'s zero B would
    not)."""
    ad = init_lora(params, targets, rank, 2.0 * rank, gen, dtype=dtype)
    for _, leaf in adapter_leaves(ad):
        b = torch.randn(leaf["B"].shape, generator=gen, device=gen.device)
        leaf["B"] = (b * 0.02).to(dtype)
    return ad


def serve(config: str = "llama3p2_1b", *, device: DeviceLike = None,
          log: Callable = print) -> Dict[str, Any]:
    """Build the model (random weights from ``SEED``) and the registry,
    serve ``N_REQUESTS`` requests with a mid-flight swap, and return the
    results with the engine and the step statistics.

    Token rates: ``decode_tok_s`` counts the tokens emitted by width-1
    steps over those steps' time; ``prefill_tok_s`` the prompt tokens over
    the time of the wider (prefill) steps, which also emit tokens for the
    rows already decoding; ``e2e_tok_s`` every generated token over the
    whole window's host time; ``step_tok_s`` the prompt and generated tokens
    over the steps' time.  An RWKV6 engine steps one
    token at a time, so all its steps are width-1 steps and its prompts are
    consumed there."""
    cfg, capacity, prefill_chunk, prompt_lens = CONFIGS[config]
    dev = resolve_device(device)
    dtype = T.torch_dtype(cfg.dtype)
    params = T.init(cfg, SEED, dev)
    targets = lora_targets(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    template = init_lora(params, targets, 4, 8.0, gen, dtype=dtype)
    registry = AdapterRegistry(template, page_rank=4, max_rank=max(RANKS),
                               num_pages=64, max_adapters=8, device=dev)
    ids = {f"r{r}": registry.register(
        f"r{r}", make_adapter(params, targets, r, gen, dtype)) for r in RANKS}
    eng = ServeEngine(cfg, params, registry=registry, batch_slots=SLOTS,
                      capacity=capacity, prefill_chunk=prefill_chunk,
                      max_tokens_cap=MAX_TOKENS, decode_impl="kernel",
                      seed=SEED, device=dev, record_steps=True)

    rng = np.random.default_rng(SEED)
    cycle = [0] + list(ids.values())
    n_late = N_REQUESTS // 4                       # submitted after the swap
    served_by: Dict[int, int] = {}
    prompt_tokens = 0

    def submit(i: int, aid: int) -> None:
        nonlocal prompt_tokens
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        prompt_tokens += plen
        sp = SamplingParams(max_tokens=MAX_TOKENS,
                            temperature=0.8 if i == 1 else 0.0,
                            top_k=50 if i == 1 else 0,
                            top_p=0.9 if i == 1 else 1.0)
        uid = eng.submit(rng.integers(1, cfg.vocab_size, plen).tolist(), sp,
                         adapter_id=aid)
        served_by[uid] = aid

    t0 = time.perf_counter()
    for i in range(N_REQUESTS - n_late):
        submit(i, cycle[i % len(cycle)])
    results = eng.run_steps(SWAP_AFTER_STEPS)
    swap_name = f"r{RANKS[len(RANKS) // 2]}"
    old_id = ids[swap_name]
    new_id = registry.swap(swap_name, make_adapter(
        params, targets, RANKS[len(RANKS) // 2], gen, dtype))
    in_flight = sorted({served_by[s.uid] for s in eng.slots if s is not None})
    log(f"swap {swap_name}: id {old_id} -> {new_id} after "
        f"{eng.steps_run} steps; ids in flight {in_flight}")
    for i in range(N_REQUESTS - n_late, N_REQUESTS):
        submit(i, new_id)
    results.update(eng.run(max_steps=100_000))
    steps = eng.step_log()                         # synchronises the card
    wall = time.perf_counter() - t0

    pre = [s for s in steps if s["width"] > 1]
    dec = [s for s in steps if s["width"] == 1]
    pre_s = sum(s["ms"] for s in pre) / 1e3
    dec_s = sum(s["ms"] for s in dec) / 1e3
    dec_tokens = sum(s["emitted"] for s in dec)
    generated = sum(len(v) for v in results.values())
    stats = {
        "steps": eng.steps_run, "prefill_steps": len(pre),
        "decode_steps": len(dec), "prompt_tokens": prompt_tokens,
        "generated_tokens": generated, "decode_tokens": dec_tokens,
        "prefill_step_tokens": sum(s["emitted"] for s in pre),
        "wall_s": wall,
        "prefill_tok_s": prompt_tokens / pre_s if pre else 0.0,
        "decode_tok_s": dec_tokens / dec_s if dec else 0.0,
        "e2e_tok_s": generated / wall,
        "step_tok_s": ((prompt_tokens + generated) / (pre_s + dec_s)
                       if steps else 0.0),
        "prefill_step_ms_median": (float(np.median([s["ms"] for s in pre]))
                                   if pre else 0.0),
        "decode_step_ms_median": (float(np.median([s["ms"] for s in dec]))
                                  if dec else 0.0),
    }
    return {"engine": eng, "registry": registry, "results": results,
            "served_by": served_by, "swap": (old_id, new_id), "stats": stats}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="llama3p2_1b", choices=sorted(CONFIGS))
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    out = serve(args.config, device=args.device)
    for uid in sorted(out["results"]):
        toks = out["results"][uid]
        print(f"req {uid} [adapter id {out['served_by'][uid]}]: "
              f"{len(toks)} tokens {toks[:8]}")
    print(out["stats"])


if __name__ == "__main__":
    main()
