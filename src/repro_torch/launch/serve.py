"""Serve several FLoRIST global adapters of different ranks from one engine.

The deploy half of ``examples/serve_federated.py`` at published widths
(:mod:`repro_torch.examples.serve_federated` ports the whole round →
publish → serve loop on a tiny model): one
:class:`~repro_torch.serve.engine.ServeEngine` mounted on
an :class:`~repro_torch.serve.adapters.AdapterRegistry` holding adapters of
ranks 4, 8 and 16 (random, seeded) on the family's LoRA targets
(``lora_targets``: ``wq wk wv wo``, MLA's ``wq_a wq_b wkv_a wkv_b wo``,
RWKV6's ``wr wk wv wg wo``, or the hybrid's ``wq wk wv wo in_proj
out_proj``)
serves a wave of requests on mixed adapter ids, the base id 0 included,
through ``decode_impl="kernel"``.  Part-way through, one adapter name is
``swap``-ped to a new version: rows admitted on the old id finish on it, new
requests go to the new id.  Weights are random (seeded) at the
configuration's published widths; DeepSeek-V3 is cut to its three dense MLA
layers (``configs.deepseek_v3_671b.DENSE3``) or to those and its first MoE
layer (``deepseek_v3_l4``, 28.1 GB in bf16); granite-moe-1b-a400m runs
whole (32 experts top-8 a layer); RWKV6-1.6B runs whole, one
token per engine step (its recurrent state takes no chunks).  Qwen2-0.5B
and Qwen3-4B run whole; Qwen2.5-14B is cut to 8 of its 48 layers
(``qwen2p5_14b_l8``) and Qwen1.5-32B to 4 of its 64 (``qwen1p5_32b_l4``).
phi-3-vision-4.2b and musicgen-medium run whole on token prompts (the
engine serves tokens, as the reference's does: musicgen's are codebook
tokens); zamba2-1.2b runs whole, one token per engine step (its Mamba2
states take no chunks; the shared block's six rings decode through
``ring_decode``).

    python -m repro_torch.launch.serve                  # Llama-3.2-1B, cuda
    python -m repro_torch.launch.serve --config deepseek_v3_dense3
    python -m repro_torch.launch.serve --config rwkv6_1p6b
    python -m repro_torch.launch.serve --config qwen3_4b
    python -m repro_torch.launch.serve --config granite_moe_1b_a400m
    python -m repro_torch.launch.serve --config deepseek_v3_l4
    python -m repro_torch.launch.serve --config smoke --device cpu
    python -m repro_torch.launch.serve --config deepseek_smoke --device cpu
    python -m repro_torch.launch.serve --config rwkv_smoke --device cpu
    python -m repro_torch.launch.serve --config granite_smoke --device cpu
    python -m repro_torch.launch.serve --config deepseek_moe_smoke --device cpu
    python -m repro_torch.launch.serve --config zamba2_1p2b
    python -m repro_torch.launch.serve --config zamba2_smoke --device cpu
    python -m repro_torch.launch.serve --config phi3_vision_smoke --device cpu
    python -m repro_torch.launch.serve --config musicgen_smoke --device cpu
    python -m repro_torch.launch.serve --config granite_smoke --device cpu \
        --mesh 2 --backend gloo

``--mesh N`` serves tensor-parallel on a serve mesh of N ranks
(``ServeEngine(mesh=make_serve_mesh(N))``, any config): N local ranks are
spawned (``--backend gloo`` by default: every rank on one card, or on the
CPU with ``--device cpu``; ``nccl`` where each rank has a card), or the
ranks of ``torchrun`` are used.  Every rank builds the same model from
``SEED`` and serves the same requests; a MoE model's ranks draw only their
own experts (``T.init(..., experts=)``); rank 0 prints.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import (deepseek_v3_671b, granite_moe_1b_a400m,
                                 llama3p2_1b, lora_targets, musicgen_medium,
                                 phi3_vision_4p2b, qwen1p5_32b, qwen2_0p5b,
                                 qwen2p5_14b, qwen3_4b, rwkv6_1p6b,
                                 zamba2_1p2b)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.peft.lora import init_lora
from repro_torch.serve.adapters import AdapterRegistry, adapter_leaves
from repro_torch.serve.engine import SamplingParams, ServeEngine, rank_experts

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
    "qwen2_0p5b": (qwen2_0p5b.CONFIG, 1024, 16, (32, 256)),
    "qwen3_4b": (qwen3_4b.CONFIG, 1024, 16, (32, 256)),
    "qwen2p5_14b_l8": (qwen2p5_14b.CONFIG.replace(num_layers=8), 1024, 16,
                       (32, 256)),
    "qwen1p5_32b_l4": (qwen1p5_32b.CONFIG.replace(num_layers=4), 1024, 16,
                       (32, 256)),
    "granite_moe_1b_a400m": (granite_moe_1b_a400m.CONFIG, 1024, 16, (32, 256)),
    "deepseek_v3_l4": (deepseek_v3_671b.L4, 1024, 16, (32, 256)),
    "phi3_vision_4p2b": (phi3_vision_4p2b.CONFIG, 1024, 16, (32, 256)),
    "musicgen_medium": (musicgen_medium.CONFIG, 1024, 16, (32, 256)),
    "zamba2_1p2b": (zamba2_1p2b.CONFIG, 1024, 16, (32, 256)),
    "smoke": (llama3p2_1b.SMOKE, 64, 4, (4, 24)),
    "deepseek_smoke": (deepseek_v3_671b.SMOKE.replace(first_dense_layers=3),
                       64, 4, (4, 24)),
    "rwkv_smoke": (rwkv6_1p6b.SMOKE, 64, 4, (4, 24)),
    "granite_smoke": (granite_moe_1b_a400m.SMOKE, 64, 4, (4, 24)),
    "deepseek_moe_smoke": (deepseek_v3_671b.SMOKE, 64, 4, (4, 24)),
    "phi3_vision_smoke": (phi3_vision_4p2b.SMOKE, 64, 4, (4, 24)),
    "musicgen_smoke": (musicgen_medium.SMOKE, 64, 4, (4, 24)),
    "zamba2_smoke": (zamba2_1p2b.SMOKE, 64, 4, (4, 24)),
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


def build(config: str = "llama3p2_1b", *, device: DeviceLike = None,
          mesh: Any = None) -> Dict[str, Any]:
    """The model (random weights from ``SEED``), the registry with
    adapters of ``RANKS`` and the engine of ``config``; with ``mesh`` (a
    serve mesh of :mod:`repro_torch.topology`) the engine is this rank's
    of a tensor-parallel server, every rank building the same model (a MoE
    model's experts only this rank's: ``rank_experts``)."""
    cfg, capacity, prefill_chunk, prompt_lens = CONFIGS[config]
    dev = resolve_device(device)
    dtype = T.torch_dtype(cfg.dtype)
    params = T.init(cfg, SEED, dev, experts=rank_experts(cfg, mesh))
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
                      seed=SEED, device=dev, record_steps=True, mesh=mesh)
    return {"cfg": cfg, "params": params, "registry": registry, "ids": ids,
            "engine": eng, "gen": gen, "targets": targets, "dtype": dtype,
            "prompt_lens": prompt_lens}


def traffic(setup: Dict[str, Any], log: Callable = print) -> Dict[str, Any]:
    """Serve ``N_REQUESTS`` requests on ``setup`` (from :func:`build`) with a
    mid-flight swap of ``r8``, and return the results and the statistics of
    this call's steps.  Calling it again on the same setup serves the same
    prompts again (and swaps again).

    Token rates: ``decode_tok_s`` counts the tokens emitted by width-1
    steps over those steps' time; ``prefill_tok_s`` the prompt tokens over
    the time of the wider (prefill) steps, which also emit tokens for the
    rows already decoding; ``e2e_tok_s`` every generated token over the
    whole window's host time; ``step_tok_s`` the prompt and generated tokens
    over the steps' time.  A burst's width-1 steps each carry the burst's
    time split evenly (``step_log``).  An RWKV6 engine steps one token at a
    time, so all its steps are width-1 steps and its prompts are consumed
    there."""
    cfg, eng, registry = setup["cfg"], setup["engine"], setup["registry"]
    ids, gen, prompt_lens = setup["ids"], setup["gen"], setup["prompt_lens"]
    params, targets, dtype = setup["params"], setup["targets"], setup["dtype"]
    rng = np.random.default_rng(SEED)
    cycle = [0] + list(ids.values())
    n_late = N_REQUESTS // 4                       # submitted after the swap
    served_by: Dict[int, int] = {}
    prompt_tokens = 0
    logged = len(eng.step_log())

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

    steps0 = eng.steps_run
    t0 = time.perf_counter()
    for i in range(N_REQUESTS - n_late):
        submit(i, cycle[i % len(cycle)])
    results = eng.run_steps(SWAP_AFTER_STEPS)
    swap_name = f"r{RANKS[len(RANKS) // 2]}"
    old_id = ids[swap_name]
    new_id = ids[swap_name] = registry.swap(swap_name, make_adapter(
        params, targets, RANKS[len(RANKS) // 2], gen, dtype))
    in_flight = sorted({served_by[s.uid] for s in eng.slots if s is not None})
    log(f"swap {swap_name}: id {old_id} -> {new_id} after "
        f"{eng.steps_run - steps0} steps; ids in flight {in_flight}")
    for i in range(N_REQUESTS - n_late, N_REQUESTS):
        submit(i, new_id)
    results.update(eng.run(max_steps=100_000))
    steps = eng.step_log()[logged:]                # synchronises the card
    wall = time.perf_counter() - t0

    pre = [s for s in steps if s["width"] > 1]
    dec = [s for s in steps if s["width"] == 1]
    pre_s = sum(s["ms"] for s in pre) / 1e3
    dec_s = sum(s["ms"] for s in dec) / 1e3
    dec_tokens = sum(s["emitted"] for s in dec)
    generated = sum(len(v) for v in results.values())
    stats = {
        "steps": eng.steps_run - steps0, "prefill_steps": len(pre),
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


def serve(config: str = "llama3p2_1b", *, device: DeviceLike = None,
          log: Callable = print) -> Dict[str, Any]:
    """:func:`build` then :func:`traffic` once: the results with the engine
    and the step statistics."""
    return traffic(build(config, device=device), log)


def _serve_rank(config: str, device: Optional[str], mesh_n: int) -> Dict:
    """One rank's (or the one process's) build and traffic; rank 0 prints.
    Returns what crosses processes: the results and the collectives."""
    from repro_torch.topology import make_serve_mesh, rank0_print
    mesh = make_serve_mesh(mesh_n, device=device) if mesh_n else None
    if mesh is not None:
        rank0_print(f"serve mesh {mesh.shape}: backend "
                    f"{mesh.backend or 'none (one rank)'}")
    out = traffic(build(config, device=mesh.device if mesh else device,
                        mesh=mesh), rank0_print)
    tp = out["engine"].tp
    for uid in sorted(out["results"]):
        toks = out["results"][uid]
        rank0_print(f"req {uid} [adapter id {out['served_by'][uid]}]: "
                    f"{len(toks)} tokens {toks[:8]}")
    rank0_print(out["stats"])
    if tp is not None:
        rank0_print(f"rank 0: {tp.all_reduces} all_reduces ({tp.reduce_s:.3f}"
                    f" s), {tp.all_to_alls} all_to_alls ({tp.a2a_s:.3f} s) "
                    f"over {out['engine'].steps_run} steps")
    return {"results": out["results"], "served_by": out["served_by"],
            "stats": out["stats"]}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="llama3p2_1b", choices=sorted(CONFIGS))
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--mesh", type=int, default=0,
                    help="model-parallel ranks of the serve mesh (0 = no "
                         "mesh, one device)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="torch.distributed backend of a spawned mesh")
    args = ap.parse_args(argv)
    from repro_torch.topology import run_world
    ranks = run_world(_serve_rank, args.mesh, args.backend, args.device,
                      args=(args.config, args.device, args.mesh))
    out = ranks[min(ranks)]
    if len(ranks) > 1 and any(r["results"] != out["results"]
                              for r in ranks.values()):
        raise RuntimeError("the ranks of the serve mesh emitted different "
                           "tokens")
    return out


if __name__ == "__main__":
    main()
