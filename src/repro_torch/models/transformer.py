"""Model assembly for the dense family (port of the dense path of
``repro.models.transformer``).

Parameters keep the reference's layout: ``params["blocks"]`` is a tuple of
segments, each a dict of stacked ``(L, ...)`` leaves under the reference's
keys, so converting a reference tree is a copy without renames.  A Python
loop over the stacked layers replaces ``lax.scan``.

Public API:
    layer_plan(cfg)                                 -> [(kind, count)]
    init(cfg, seed, device=None)                    -> params
    embed_inputs(cfg, params, batch)                -> (B, S, d)
    logits(cfg, params, hidden)                     -> (B, S, V)
    init_cache(cfg, batch, capacity, ..., device)   -> cache tuple
    decode(cfg, params, cache, batch, ...)          -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as Lyr
from repro_torch.peft.lora import PagedLoRA
from repro_torch.serve import kvcache as Kv

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    if cfg.family != "dense" or cfg.num_experts or cfg.use_mla:
        raise NotImplementedError(
            f"the port serves the dense family so far, not {cfg.family!r}"
            f"{' with MLA' if cfg.use_mla else ''}"
            f"{' with experts' if cfg.num_experts else ''}")
    return [("dense", cfg.num_layers)]


def init(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator``, with the
    reference's distributions: embedding N(0, 0.02²), projections
    N(0, 1/fan_in), norms one."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, V = cfg.d_model, cfg.vocab_size
    params: Params = {
        "embed": (torch.randn((V, d), generator=gen, device=dev) * 0.02).to(dtype),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = Lyr.dense_init(gen, (d, V), d, dtype)
    blocks = []
    for _, L in layer_plan(cfg):
        blocks.append({
            "ln1": torch.ones((L, d), dtype=dtype, device=dev),
            "attn": Lyr.init_attention(cfg, gen, L, dtype),
            "ln2": torch.ones((L, d), dtype=dtype, device=dev),
            "mlp": Lyr.init_mlp(cfg, gen, L, dtype),
        })
    params["blocks"] = tuple(blocks)
    return params


def embed_inputs(cfg: ModelConfig, params: Params, batch: Dict) -> torch.Tensor:
    return params["embed"][batch["tokens"]]


def logits(cfg: ModelConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return hidden @ head


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               kv_dtype: Optional[torch.dtype] = None, prefill_chunk: int = 1,
               device: DeviceLike = None) -> Tuple:
    """Cache tuple mirroring the segment plan: per segment a dict of
    stacked ``(L, B, cap, K, hd)`` rings and ``(L, B)`` positions.  Sliding
    windows keep ``prefill_chunk - 1`` spare slots, as in the reference."""
    dev = resolve_device(device)
    kv_dtype = kv_dtype or torch_dtype(cfg.dtype)
    if cfg.sliding_window:
        capacity = min(capacity, cfg.sliding_window + max(prefill_chunk, 1) - 1)
    caches = []
    for _, L in layer_plan(cfg):
        one = Kv.attn_cache(cfg, batch, capacity, kv_dtype, dev)
        caches.append({k: torch.zeros((L,) + v.shape, dtype=v.dtype, device=dev)
                       for k, v in one.items()})
    return tuple(caches)


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked parameter or adapter tree."""
    if isinstance(tree, PagedLoRA):
        return tree.layer(i)
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        return tree[i]
    return tree


def _block_decode(cfg: ModelConfig, p: Params, x, cache, a: Dict,
                  n_tokens=None, decode_impl: str = "dense"):
    a = a or {}
    h, cache = Lyr.attention_decode(cfg, p["attn"],
                                    Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps),
                                    cache, a.get("attn"), n_tokens=n_tokens,
                                    decode_impl=decode_impl)
    x = x + h
    h = Lyr.mlp_fwd(p["mlp"], Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps),
                    a.get("mlp"))
    return x + h, cache


def decode(cfg: ModelConfig, params: Params, cache: Tuple, batch: Dict,
           adapters: Optional[Dict] = None,
           n_tokens: Optional[torch.Tensor] = None,
           decode_impl: str = "dense") -> Tuple[torch.Tensor, Tuple]:
    """One decode step over a token chunk ``batch["tokens"]: (B, C)``.

    ``n_tokens: (B,)`` gives the real tokens per row (None = all C; rows
    with 0 leave their cache untouched).  ``decode_impl`` picks the
    attention interior (``"dense"`` or ``"kernel"``).  The ring buffers are
    written in place; the returned cache holds the same buffers and the
    advanced positions.  Returns (logits (B,C,V), cache)."""
    x = embed_inputs(cfg, params, batch)
    a_blocks = (adapters or {}).get("blocks", ())
    new_caches = []
    for seg_i, (_, count) in enumerate(layer_plan(cfg)):
        seg_p = params["blocks"][seg_i]
        seg_a = a_blocks[seg_i] if seg_i < len(a_blocks) and a_blocks[seg_i] else {}
        seg_c = cache[seg_i]
        pos, length = [], []
        for i in range(count):
            c_l = {k: v[i] for k, v in seg_c.items()}
            x, c_l = _block_decode(cfg, _layer(seg_p, i), x, c_l,
                                   _layer(seg_a, i), n_tokens, decode_impl)
            pos.append(c_l["pos"])
            length.append(c_l["length"])
        new_caches.append(dict(seg_c, pos=torch.stack(pos),
                               length=torch.stack(length)))
    x = Lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits(cfg, params, x), tuple(new_caches)
