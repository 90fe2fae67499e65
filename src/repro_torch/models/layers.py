"""Dense transformer layers (port of the dense subset of
``repro.models.layers``): RMSNorm, RoPE, GQA attention with the cached
decode path, SwiGLU MLP.  Plain functions on tensors over parameter dicts
that keep the reference's layout and keys.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.attention_core import ring_attend_mask
from repro_torch.peft.lora import lora_proj
from repro_torch.serve.kvcache import cache_kv, cache_update

Params = Dict[str, Any]
DECODE_IMPLS = ("dense", "kernel")


def dense_init(generator: torch.Generator, shape, in_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 1/in_dim) weights, as the reference's ``dense_init``."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """cos/sin tables (..., hd/2) for integer positions (...)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, hd/2).  Rotates the two HALVES
    of the head dim against each other (``x1 = x[..., :hd/2]``,
    ``x2 = x[..., hd/2:]``), as the reference's code does — not interleaved
    pairs."""
    dt = x.dtype
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def init_attention(cfg: ModelConfig, generator: torch.Generator, L: int,
                   dtype: torch.dtype) -> Params:
    """Stacked ``(L, ...)`` attention weights of ``L`` layers."""
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = generator.device
    p = {
        "wq": dense_init(generator, (L, d, H * hd), d, dtype),
        "wk": dense_init(generator, (L, d, K * hd), d, dtype),
        "wv": dense_init(generator, (L, d, K * hd), d, dtype),
        "wo": dense_init(generator, (L, H * hd, d), H * hd, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((L, width), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((L, hd), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((L, hd), dtype=dtype, device=dev)
    return p


def _qkv(cfg: ModelConfig, p: Params, x, adapters, positions):
    """Project x (B,S,d) to roped q (B,S,H,hd) and k, v (B,S,K,hd)."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a = adapters or {}
    q = lora_proj(x, p["wq"], a.get("wq"))
    k = lora_proj(x, p["wk"], a.get("wk"))
    v = lora_proj(x, p["wv"], a.get("wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attention_decode(cfg: ModelConfig, p: Params, x, cache: Dict,
                     adapters=None, n_tokens=None, decode_impl: str = "dense"):
    """Chunked cached decode with per-slot positions.

    x: (B,C,d); cache: {"k", "v": (B,cap,K,hd), "pos", "length": (B,)};
    ``n_tokens: (B,)`` real tokens per row (rows with 0 leave their cache
    untouched).  ``decode_impl``: ``"dense"`` (full (B,H,C,cap) scores and
    the dense ring mask; int8 caches dequantized to bf16) or ``"kernel"``
    (:func:`repro_torch.kernels.ops.ring_decode`; int8 dequantized per tile
    in fp32).  Both agree on valid query positions ``t < n_tokens[b]``.
    Returns (out (B,C,d), new_cache); the cache's ring buffers are written
    in place.
    """
    if decode_impl == "streamed":
        raise NotImplementedError(
            "decode_impl='streamed' is not ported yet; use 'dense' or 'kernel'")
    if decode_impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode_impl {decode_impl!r}")
    B, C, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qpos = cache["pos"].long()[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k, v = _qkv(cfg, p, x, adapters, qpos)
    cache = cache_update(cfg, cache, k, v, n_tokens)
    if decode_impl == "dense":
        kc, vc = cache_kv(cfg, cache)
        T = kc.shape[1]
        g = H // K
        qf = q.float().reshape(B, C, K, g, hd)
        s = torch.einsum("bskgh,btkh->bkgst", qf, kc.float()).reshape(B, H, C, T)
        s = s * (1.0 / math.sqrt(hd))
        mask = ring_attend_mask(cache["pos"], cache["length"], T, qpos,
                                cfg.sliding_window)
        s = torch.where(mask[:, None], s, torch.full_like(s, -1e30))
        w = torch.softmax(s, dim=-1).reshape(B, K, g, C, T)
        o = torch.einsum("bkgst,btkh->bskgh", w, vc.float())
    else:
        n = (torch.full((B,), C, dtype=torch.int32, device=x.device)
             if n_tokens is None else n_tokens.to(torch.int32))
        int8 = cache["k"].dtype == torch.int8
        o = kops.ring_decode(q, cache["k"], cache["v"], cache["pos"],
                             cache["length"], n, window=cfg.sliding_window,
                             k_scale=cache["k_scale"] if int8 else None,
                             v_scale=cache["v_scale"] if int8 else None)
    o = o.reshape(B, C, H * hd).to(x.dtype)
    a = adapters or {}
    return lora_proj(o, p["wo"], a.get("wo")), cache


def init_mlp(cfg: ModelConfig, generator: torch.Generator, L: int,
             dtype: torch.dtype) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(generator, (L, d, ff), d, dtype),
        "w_up": dense_init(generator, (L, d, ff), d, dtype),
        "w_down": dense_init(generator, (L, ff, d), ff, dtype),
    }


def mlp_fwd(p: Params, x, adapters=None):
    """SwiGLU with the SiLU taken in fp32."""
    a = adapters or {}
    g = lora_proj(x, p["w_gate"], a.get("w_gate"))
    u = lora_proj(x, p["w_up"], a.get("w_up"))
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return lora_proj(h, p["w_down"], a.get("w_down"))
