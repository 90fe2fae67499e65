"""Model assembly for the dense, MLA and RWKV6 families (port of the
dense, MLA and RWKV paths of ``repro.models.transformer``).

Parameters keep the reference's layout: ``params["blocks"]`` is a tuple of
segments, each a dict of stacked ``(L, ...)`` leaves under the reference's
keys, so converting a reference tree is a copy without renames.  A Python
loop over the stacked layers replaces ``lax.scan``.

DeepSeek-V3's plan is ``[("mla_dense", k), ("mla_moe", L - k)]``.  The port
has no MoE module yet: a MoE segment with layers raises, and the empty one
of a config cut to its dense layers (``L == k``) is kept with zero-size
``(0, ...)`` leaves, so the trees keep the reference's structure.  MLA runs
only on the cached decode path so far; ``forward`` raises for it.  RWKV6
(``family="ssm"``) is one ``("rwkv", L)`` segment: ``forward`` runs the
whole sequence (the ``wkv6`` kernel with ``use_kernels``), ``decode`` steps
the recurrent state one token at a time.

Public API:
    layer_plan(cfg)                                 -> [(kind, count)]
    init(cfg, seed, device=None)                    -> params
    embed_inputs(cfg, params, batch)                -> (B, S, d)
    forward(cfg, params, batch, adapters, ...)      -> (hidden, aux)  [train / prefill]
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
from repro_torch.models import rwkv as Rwkv
from repro_torch.peft.lora import PagedLoRA
from repro_torch.serve import kvcache as Kv

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """The reference's segment plan.  Families the port lacks (hybrid,
    VLM, audio) and MoE segments with layers raise ``NotImplementedError``."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return [("rwkv", L)]
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet: the port serves "
            "dense models, DeepSeek-V3's dense MLA layers and RWKV6")
    if cfg.num_experts:
        kind = "mla_moe" if cfg.use_mla else "moe"
        dense_kind = "mla_dense" if cfg.use_mla else "dense"
        plan = ([(dense_kind, cfg.first_dense_layers),
                 (kind, L - cfg.first_dense_layers)]
                if cfg.first_dense_layers else [(kind, L)])
    else:
        plan = [("mla_dense" if cfg.use_mla else "dense", L)]
    for kind, count in plan:
        if kind.endswith("moe") and count:
            raise NotImplementedError(
                f"{cfg.name}: {count} {kind!r} layers; MoE (models/moe.py) is "
                "not ported yet: cut the config to its dense layers "
                "(num_layers = first_dense_layers)")
    return plan


def _empty_moe(cfg: ModelConfig, dtype: torch.dtype, dev) -> Params:
    """Zero-size ``(0, ...)`` leaves with the shapes and dtypes of the
    reference's ``init_moe``: the parameters of an empty MoE segment."""
    d, E = cfg.d_model, cfg.num_experts
    e_ff = cfg.moe_d_ff or cfg.d_ff

    def z(*shape, dt=dtype):
        return torch.zeros((0,) + shape, dtype=dt, device=dev)

    p = {"router": z(d, E, dt=torch.float32), "w_gate": z(E, d, e_ff),
         "w_up": z(E, d, e_ff), "w_down": z(E, e_ff, d)}
    if cfg.num_shared_experts:
        sff = e_ff * cfg.num_shared_experts
        p["shared"] = {"w_gate": z(d, sff), "w_up": z(d, sff),
                       "w_down": z(sff, d)}
    return p


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
    for kind, L in layer_plan(cfg):
        if kind == "rwkv":
            blocks.append({"ln1": torch.ones((L, d), dtype=dtype, device=dev),
                           "ln2": torch.ones((L, d), dtype=dtype, device=dev),
                           "mix": Rwkv.init_rwkv6(cfg, gen, L, dtype)})
            continue
        attn_init = Lyr.init_mla if kind.startswith("mla") else Lyr.init_attention
        blk = {"ln1": torch.ones((L, d), dtype=dtype, device=dev),
               "attn": attn_init(cfg, gen, L, dtype),
               "ln2": torch.ones((L, d), dtype=dtype, device=dev)}
        if kind.endswith("moe"):             # empty: layer_plan raised otherwise
            blk["moe"] = _empty_moe(cfg, dtype, dev)
        else:
            blk["mlp"] = Lyr.init_mlp(cfg, gen, L, dtype)
        blocks.append(blk)
    params["blocks"] = tuple(blocks)
    return params


def embed_inputs(cfg: ModelConfig, params: Params, batch: Dict) -> torch.Tensor:
    return params["embed"][batch["tokens"]]


def logits(cfg: ModelConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return hidden @ head


def _block_fwd(cfg: ModelConfig, kind: str, p: Params, x, a: Dict,
               use_kernels: bool):
    """One dense or RWKV6 layer over a full sequence."""
    a = a or {}
    if kind == "rwkv":
        h, _ = Rwkv.time_mix(cfg, p["mix"], Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps),
                             a.get("mix"), use_kernel=use_kernels)
        x = x + h
        h, _ = Rwkv.channel_mix(cfg, p["mix"],
                                Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps),
                                a.get("mix"), use_kernel=use_kernels)
        return x + h
    h = Lyr.attention_fwd(cfg, p["attn"], Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps),
                          a.get("attn"), use_kernel=use_kernels)
    x = x + h
    h = Lyr.mlp_fwd(p["mlp"], Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps),
                    a.get("mlp"), use_kernel=use_kernels)
    return x + h


def forward(cfg: ModelConfig, params: Params, batch: Dict,
            adapters: Optional[Dict] = None,
            use_kernels: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over ``batch["tokens"]: (B, S)``.  Returns
    (final hidden (B,S,d), aux loss), aux being zero for the dense and RWKV6
    families.  ``use_kernels`` routes attention, the WKV recurrence and the
    LoRA projections through the ``flash_attention``, ``wkv6`` and
    ``lora_matmul`` kernels.  The reference's ``remat`` has no counterpart:
    autograd keeps the activations."""
    if cfg.use_mla:
        raise NotImplementedError(
            "the full-sequence MLA forward (mla_fwd / mla_absorbed) is not "
            "ported yet: MLA runs on the cached decode path (decode); its "
            "training path is a later slice")
    x = embed_inputs(cfg, params, batch)
    a_blocks = (adapters or {}).get("blocks", ())
    for seg_i, (kind, count) in enumerate(layer_plan(cfg)):
        seg_p = params["blocks"][seg_i]
        seg_a = a_blocks[seg_i] if seg_i < len(a_blocks) and a_blocks[seg_i] else {}
        for i in range(count):
            x = _block_fwd(cfg, kind, _layer(seg_p, i), x, _layer(seg_a, i),
                           use_kernels)
    x = Lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               kv_dtype: Optional[torch.dtype] = None, prefill_chunk: int = 1,
               device: DeviceLike = None) -> Tuple:
    """Cache tuple mirroring the segment plan: per segment a dict of
    stacked rings (``(L, B, cap, K, hd)`` k/v, or MLA's ``(L, B, cap, kvr)``
    latent and ``(L, B, cap, rope)`` key) and ``(L, B)`` positions, or
    RWKV6's stacked recurrent state (``(L, B, d)`` ``tm_x``/``cm_x`` and
    ``(L, B, H, hd, hd)`` ``wkv``, fp32; no capacity).  Sliding windows keep
    ``prefill_chunk - 1`` spare slots, as in the reference."""
    dev = resolve_device(device)
    kv_dtype = kv_dtype or torch_dtype(cfg.dtype)
    if cfg.sliding_window:
        capacity = min(capacity, cfg.sliding_window + max(prefill_chunk, 1) - 1)
    caches = []
    for kind, L in layer_plan(cfg):
        if kind == "rwkv":
            one = Rwkv.rwkv6_init_state(cfg, batch, dev)
        else:
            make = Kv.mla_cache if kind.startswith("mla") else Kv.attn_cache
            one = make(cfg, batch, capacity, kv_dtype, dev)
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


def _mask_state_rows(new: Dict, old: Dict, n_tokens) -> Dict:
    """Keep the old recurrent state for rows with ``n_tokens == 0`` (the
    n_tokens contract: masked rows leave their cache untouched)."""
    if n_tokens is None:
        return new
    keep = n_tokens > 0
    return {k: torch.where(keep.view((-1,) + (1,) * (t.dim() - 1)),
                           t.to(old[k].dtype), old[k])
            for k, t in new.items()}


def _block_decode(cfg: ModelConfig, kind: str, p: Params, x, cache, a: Dict,
                  n_tokens=None, decode_impl: str = "dense"):
    """One dense, MLA-dense or RWKV6 layer, one token chunk.  An RWKV6
    layer takes one token (C = 1) and writes its new state into the
    cache's buffers in place."""
    a = a or {}
    if kind == "rwkv":
        if x.shape[1] != 1:
            raise ValueError("RWKV decode is a single-token recurrence: "
                             f"got a chunk of {x.shape[1]} tokens")
        h, st = Rwkv.time_mix(cfg, p["mix"], Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps),
                              a.get("mix"), state=cache)
        x = x + h
        h, st2 = Rwkv.channel_mix(cfg, p["mix"],
                                  Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps),
                                  a.get("mix"), state=cache)
        for k, t in _mask_state_rows({**st, **st2}, cache, n_tokens).items():
            cache[k].copy_(t)
        return x + h, cache
    dec_fn = Lyr.mla_decode if kind.startswith("mla") else Lyr.attention_decode
    h, cache = dec_fn(cfg, p["attn"], Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps),
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
    attention interior (``"dense"`` or ``"kernel"``; the RWKV6 recurrence
    is the same on both).  The ring buffers and recurrent states are
    written in place; the returned cache holds the same buffers and the
    advanced positions.  RWKV6 takes C = 1.  Returns (logits (B,C,V),
    cache)."""
    x = embed_inputs(cfg, params, batch)
    a_blocks = (adapters or {}).get("blocks", ())
    new_caches = []
    for seg_i, (kind, count) in enumerate(layer_plan(cfg)):
        seg_c = cache[seg_i]
        if not count:                     # an empty MoE segment
            new_caches.append(seg_c)
            continue
        seg_p = params["blocks"][seg_i]
        seg_a = a_blocks[seg_i] if seg_i < len(a_blocks) and a_blocks[seg_i] else {}
        pos, length = [], []
        for i in range(count):
            c_l = {k: v[i] for k, v in seg_c.items()}
            x, c_l = _block_decode(cfg, kind, _layer(seg_p, i), x, c_l,
                                   _layer(seg_a, i), n_tokens, decode_impl)
            if "pos" in c_l:
                pos.append(c_l["pos"])
                length.append(c_l["length"])
        new_caches.append(dict(seg_c, pos=torch.stack(pos),
                               length=torch.stack(length)) if pos else seg_c)
    x = Lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits(cfg, params, x), tuple(new_caches)
