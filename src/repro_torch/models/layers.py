"""Transformer layers (port of the dense and MLA subset of
``repro.models.layers``): RMSNorm, RoPE, GQA attention over full sequences
(train / eval) and the cached decode path, DeepSeek-V3's multi-head latent
attention (MLA) on the cached decode path, SwiGLU MLP.  Plain functions on
tensors over parameter dicts that keep the reference's layout and keys.

``use_kernel`` routes the LoRA projections through the fused
``lora_matmul`` kernel and full-sequence attention through the
``flash_attention`` kernel (:mod:`repro_torch.kernels.ops`); the reference
selects the same routes with ``use_kernels`` and ``lora.USE_KERNEL``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.attention_core import flash_torch, ring_attend_mask
from repro_torch.peft.lora import PagedLoRA, lora_proj, paged_delta_weight
from repro_torch.serve.kvcache import (cache_kv, cache_update, dequant,
                                       mla_cache_update)

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


def _qkv(cfg: ModelConfig, p: Params, x, adapters, positions,
         use_kernel: bool = False):
    """Project x (B,S,d) to roped q (B,S,H,hd) and k, v (B,S,K,hd)."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a = adapters or {}
    q = lora_proj(x, p["wq"], a.get("wq"), use_kernel)
    k = lora_proj(x, p["wk"], a.get("wk"), use_kernel)
    v = lora_proj(x, p["wv"], a.get("wv"), use_kernel)
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


def causal_mask(S: int, T: int, window: int = 0, device=None) -> torch.Tensor:
    """(S,T) mask, True = attend: query i attends key j iff ``j <= i`` and
    (no window or ``j > i - window``)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > (qpos - window)
    return m


def attention_fwd(cfg: ModelConfig, p: Params, x, adapters=None,
                  positions=None, use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence causal attention (train / eval).  x: (B,S,d).

    Three routes, as in the reference: the ``flash_attention`` kernel
    (``use_kernel``; any S), chunked ``flash_torch`` when
    ``S % min(S, 512) == 0``, and dense einsum attention otherwise.
    """
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(cfg, p, x, adapters, positions, use_kernel)
    if use_kernel:
        o = kops.flash_attention(q, k, v, causal=True,
                                 window=cfg.sliding_window)
    elif S % min(S, 512) == 0:
        o = flash_torch(q, k, v, causal=True, window=cfg.sliding_window,
                        q_chunk=512, kv_chunk=1024)
    else:
        g = H // K
        qf = q.float().reshape(B, S, K, g, hd)
        s = torch.einsum("bskgh,btkh->bkgst", qf, k.float()).reshape(B, H, S, S)
        s = s * (1.0 / math.sqrt(hd))
        mask = causal_mask(S, S, cfg.sliding_window, x.device)
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
        w = torch.softmax(s, dim=-1).reshape(B, K, g, S, S)
        o = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    o = o.reshape(B, S, H * hd).to(x.dtype)
    a = adapters or {}
    return lora_proj(o, p["wo"], a.get("wo"), use_kernel)


def _check_decode_impl(decode_impl: str) -> None:
    if decode_impl == "streamed":
        raise NotImplementedError(
            "decode_impl='streamed' is not ported yet; use 'dense' or 'kernel'")
    if decode_impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode_impl {decode_impl!r}")


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
    _check_decode_impl(decode_impl)
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


# -- MLA: multi-head latent attention (DeepSeek-V3) ---------------------------

def init_mla(cfg: ModelConfig, generator: torch.Generator, L: int,
             dtype: torch.dtype) -> Params:
    """Stacked ``(L, ...)`` MLA weights of ``L`` layers: the low-rank query
    path (``wq_a``, ``q_a_norm``, ``wq_b``), the joint latent projection
    ``wkv_a`` (latent plus the shared RoPE key), its norm, the latent
    up-projection ``wkv_b`` (per-head key-nope and value) and ``wo``."""
    d = cfg.d_model
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    H = cfg.num_heads
    dev = generator.device
    return {
        "wq_a": dense_init(generator, (L, d, qr), d, dtype),
        "q_a_norm": torch.ones((L, qr), dtype=dtype, device=dev),
        "wq_b": dense_init(generator, (L, qr, H * (nope + rope)), qr, dtype),
        "wkv_a": dense_init(generator, (L, d, kvr + rope), d, dtype),
        "kv_a_norm": torch.ones((L, kvr), dtype=dtype, device=dev),
        "wkv_b": dense_init(generator, (L, kvr, H * (nope + vd)), kvr, dtype),
        "wo": dense_init(generator, (L, H * vd, d), H * vd, dtype),
    }


def _mla_qkv(cfg: ModelConfig, p: Params, x, adapters, positions):
    """x (B,S,d) -> q_nope (B,S,H,nope), roped q_rope (B,S,H,rope), the
    normed latent c_kv (B,S,kvr) and the roped shared key k_rope (B,S,rope)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    a = adapters or {}
    q = lora_proj(x, p["wq_a"], a.get("wq_a"))
    q = rmsnorm(q, p["q_a_norm"], cfg.norm_eps)
    q = lora_proj(q, p["wq_b"], a.get("wq_b")).reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    kv = lora_proj(x, p["wkv_a"], a.get("wkv_a"))
    c_kv, k_rope = kv[..., :cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    cos, sin = rope_freqs(rope, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[..., None, :], cos, sin)       # (B,S,1,rope)
    c_kv = rmsnorm(c_kv, p["kv_a_norm"], cfg.norm_eps)
    return q_nope, q_rope, c_kv, k_rope[..., 0, :]


def mla_decode(cfg: ModelConfig, p: Params, x, cache: Dict, adapters=None,
               n_tokens=None, decode_impl: str = "dense"):
    """MLA chunked decode in the *absorbed* formulation: attention runs
    against the compressed latent cache and the per-head K/V expansion is
    never materialised.  Scores ``q_latᵀ c_kv + q_ropeᵀ k_rope`` with
    ``q_lat = q_nope · W_k``; values: the latent, then the per-head
    V-projection after the softmax.

    x: (B,C,d) with per-slot cache positions; cache: the latent ring of
    :func:`repro_torch.serve.kvcache.mla_cache`; ``n_tokens: (B,)`` masks
    padded rows as in :func:`attention_decode`.  A paged ``wkv_b`` adapter
    folds each row's own delta into the absorbed weights
    (:func:`paged_delta_weight`); a classic one folds into the shared weight.
    ``decode_impl``: ``"dense"`` (full scores and the dense ring mask; int8
    dequantized whole in fp32) or ``"kernel"``
    (:func:`repro_torch.kernels.ops.mla_ring_decode`; int8 halves dequantized
    per tile).  Both agree on valid query positions ``t < n_tokens[b]``.
    Returns (out (B,C,d), new_cache); the ring buffers are written in place.
    """
    _check_decode_impl(decode_impl)
    B, C, _ = x.shape
    H = cfg.num_heads
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    qpos = cache["pos"].long()[:, None] + torch.arange(C, device=x.device)[None, :]
    q_nope, q_rope, c_kv_t, k_rope_t = _mla_qkv(cfg, p, x, adapters, qpos)
    cache = mla_cache_update(cache, c_kv_t, k_rope_t, n_tokens)

    a = adapters or {}
    w_kvb = p["wkv_b"]
    a_kvb = a.get("wkv_b")
    if isinstance(a_kvb, PagedLoRA):
        # multi-tenant: every batch row folds ITS OWN adapter's delta into
        # the absorbed weight, so the latent projections become per-row
        w = (w_kvb.float()[None] + paged_delta_weight(a_kvb)
             ).reshape(B, kvr, H, nope + vd)
        w_k, w_v = w[..., :nope], w[..., nope:]
        q_lat = torch.einsum("bshn,bkhn->bshk", q_nope.float(), w_k)
        v_ein = "bshk,bkhv->bshv"
    else:
        if a_kvb is not None:     # fold the LoRA delta into the absorbed weight
            w_kvb = w_kvb + ((a_kvb["B"] @ a_kvb["A"]).t()
                             * a_kvb["scale"]).to(w_kvb.dtype)
        w = w_kvb.reshape(kvr, H, nope + vd).float()
        w_k, w_v = w[..., :nope], w[..., nope:]
        q_lat = torch.einsum("bshn,khn->bshk", q_nope.float(), w_k)
        v_ein = "bshk,khv->bshv"
    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_head_dim)
    int8 = cache["c_kv"].dtype == torch.int8
    if decode_impl == "dense":
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        if int8:
            c_kv = dequant(c_kv, cache["c_kv_scale"])
            k_rope = dequant(k_rope, cache["k_rope_scale"])
        c_kv, k_rope = c_kv.float(), k_rope.float()
        s = (torch.einsum("bshk,btk->bhst", q_lat, c_kv)
             + torch.einsum("bshr,btr->bhst", q_rope.float(), k_rope)) * scale
        mask = ring_attend_mask(cache["pos"], cache["length"], s.shape[-1],
                                qpos, cfg.sliding_window)       # (B,C,T)
        s = torch.where(mask[:, None], s, torch.full_like(s, -1e30))
        out_lat = torch.einsum("bhst,btk->bshk", torch.softmax(s, dim=-1), c_kv)
    else:
        n = (torch.full((B,), C, dtype=torch.int32, device=x.device)
             if n_tokens is None else n_tokens.to(torch.int32))
        q_eff = torch.cat([q_lat, q_rope.float()], dim=-1)   # (B,C,H,kvr+rope)
        out_lat = kops.mla_ring_decode(
            q_eff, cache["c_kv"], cache["k_rope"], cache["pos"],
            cache["length"], n, scale=scale, window=cfg.sliding_window,
            c_kv_scale=cache["c_kv_scale"] if int8 else None,
            k_rope_scale=cache["k_rope_scale"] if int8 else None)
    o = torch.einsum(v_ein, out_lat, w_v).reshape(B, C, H * vd).to(x.dtype)
    return lora_proj(o, p["wo"], a.get("wo")), cache


def init_mlp(cfg: ModelConfig, generator: torch.Generator, L: int,
             dtype: torch.dtype) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(generator, (L, d, ff), d, dtype),
        "w_up": dense_init(generator, (L, d, ff), d, dtype),
        "w_down": dense_init(generator, (L, ff, d), ff, dtype),
    }


def mlp_fwd(p: Params, x, adapters=None, use_kernel: bool = False):
    """SwiGLU with the SiLU taken in fp32."""
    a = adapters or {}
    g = lora_proj(x, p["w_gate"], a.get("w_gate"), use_kernel)
    u = lora_proj(x, p["w_up"], a.get("w_up"), use_kernel)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return lora_proj(h, p["w_down"], a.get("w_down"), use_kernel)
