"""Transformer layers (port of the dense and MLA subset of
``repro.models.layers``): RMSNorm, RoPE, GQA attention over full sequences
(train / eval) and the cached decode path, DeepSeek-V3's multi-head latent
attention (MLA) over full sequences and on the cached decode path, SwiGLU
MLP.  Plain functions on
tensors over parameter dicts that keep the reference's layout and keys.

``use_kernel`` routes the LoRA projections through the fused
``lora_matmul`` kernel and full-sequence attention through the
``flash_attention`` kernel (:mod:`repro_torch.kernels.ops`); the reference
selects the same routes with ``use_kernels`` and ``lora.USE_KERNEL``.

The decode path takes ``tp``, a serve mesh's ``model`` axis
(:class:`repro_torch.topology.serve.ModelParallel`), for head-parallel
tensor parallelism: ``cfg`` then holds the rank's head counts and the
parameters are the rank's Megatron shards (``wq wk wv w_gate w_up wq_b
wkv_b`` column-parallel, ``wo w_down`` row-parallel).  Attention runs on
the rank's KV heads and their query groups against its cache shard (MLA:
its query heads against the replicated latent ring), and each
row-parallel projection ends in one ``all_reduce`` of its partial output,
the partial LoRA delta included (the delta is linear, so its scale is
applied once).  MLA's ``wq_a`` and ``wkv_a`` are column-parallel under the
rules but a norm needs their outputs whole, so those are gathered after
the projection, as GSPMD does in the reference.

The full-sequence path (``attention_fwd``, ``mla_fwd``, ``mlp_fwd``) takes
``tp``, a train mesh (:class:`repro_torch.topology.train.TrainParallel`),
where the reference runs under ``jit`` with the Megatron specs: ``cfg``
keeps the whole model's counts and the parameters are the rank's shards
by ``params_pspecs`` (``wq wk wv w_gate w_up wq_a wq_b wkv_a wkv_b``
column-parallel, ``wo w_down`` row-parallel, ZeRO-3's other dim over
``data`` gathered at use).  A column-parallel projection takes its input
through ``copy`` and a row-parallel one ends in ``reduce``; the replicated
adapters are cut to the weight's shard (:func:`lora_proj_shard`) and the
replicated biases to the rank's columns.  Attention dispatches as the
reference's ``dispatch_flash`` does (head-, sequence- or batch-parallel),
with ``qk_norm`` and RoPE applied once the heads are whole; MLA gathers
``wq_a`` / ``wkv_a``'s outputs for their norms (one ``all_gather``) and
runs ``mla_absorbed``'s sequence-parallel branch with ``wkv_b`` gathered
whole and its LoRA folded.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.attention_core import (dispatch_flash, flash_torch,
                                              mla_absorbed,
                                              mla_ring_flash_decode,
                                              ring_attend_mask,
                                              ring_flash_decode)
from repro_torch.peft.lora import (COL, ROW, PagedLoRA, lora_proj,
                                   lora_proj_shard, paged_delta_weight,
                                   shard_adapter)
from repro_torch.topology.train import TrainParallel
from repro_torch.serve.kvcache import (cache_kv, cache_update, dequant,
                                       mla_cache_update)

Params = Dict[str, Any]
DECODE_IMPLS = ("dense", "streamed", "kernel")


def _row_out(tp, y: torch.Tensor) -> torch.Tensor:
    """A row-parallel projection's output: the partial sums reduced."""
    return y if tp is None else tp.reduce(y)


def _train(tp) -> bool:
    return isinstance(tp, TrainParallel)


def _col_in(tp, x: torch.Tensor) -> torch.Tensor:
    """A column-parallel projection's replicated input under a train mesh
    (``copy``: its gradient's parts summed in the backward)."""
    return tp.copy(x) if _train(tp) else x


def _proj(x, w, adapter, use_kernel: bool, tp, kind: str,
          segments=None) -> torch.Tensor:
    """``lora_proj``, on the rank's shard under a train mesh (``segments``:
    a fused dim's cut, :func:`lora_proj_shard`)."""
    if _train(tp):
        return lora_proj_shard(x, w, adapter, use_kernel, tp, kind, segments)
    return lora_proj(x, w, adapter, use_kernel)


def dense_init(generator: torch.Generator, shape, in_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 1/in_dim) weights, as the reference's ``dense_init``."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


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


def _kept(keep):
    """``keep(name, leaf)``, applied to each weight as it is drawn (a
    rank's shard of it), or the identity."""
    return keep or (lambda name, t: t)


def init_attention(cfg: ModelConfig, generator: torch.Generator, L: int,
                   dtype: torch.dtype, keep=None) -> Params:
    """Stacked ``(L, ...)`` attention weights of ``L`` layers (each
    projection through ``keep`` as soon as it is drawn)."""
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = generator.device
    k = _kept(keep)
    p = {
        "wq": k("wq", dense_init(generator, (L, d, H * hd), d, dtype)),
        "wk": k("wk", dense_init(generator, (L, d, K * hd), d, dtype)),
        "wv": k("wv", dense_init(generator, (L, d, K * hd), d, dtype)),
        "wo": k("wo", dense_init(generator, (L, H * hd, d), H * hd, dtype)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((L, width), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((L, hd), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((L, hd), dtype=dtype, device=dev)
    return p


def _qkv_cols(cfg: ModelConfig, p: Params, x, adapters, use_kernel: bool,
              tp) -> tuple:
    """Project x (B,S,d) to q, k, v columns, biases added (the rank's
    columns under ``tp``, the replicated biases cut to them)."""
    a = adapters or {}
    xi = _col_in(tp, x)
    q = _proj(xi, p["wq"], a.get("wq"), use_kernel, tp, COL)
    k = _proj(xi, p["wk"], a.get("wk"), use_kernel, tp, COL)
    v = _proj(xi, p["wv"], a.get("wv"), use_kernel, tp, COL)
    if cfg.qkv_bias:
        cut = (lambda b: b) if tp is None else tp.local
        q, k, v = q + cut(p["bq"]), k + cut(p["bk"]), v + cut(p["bv"])
    return q, k, v


def _heads(cfg: ModelConfig, p: Params, q, k, v, rope_q, rope_k) -> tuple:
    """Columns of whole heads to roped (B,S,H',hd) q and k and (B,S,K',hd)
    v: ``qk_norm`` per head, RoPE by the (cos, sin) tables of q's and k's
    positions."""
    hd = cfg.head_dim
    q = q.reshape(*q.shape[:2], -1, hd)
    k = k.reshape(*k.shape[:2], -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return (apply_rope(q, *rope_q), apply_rope(k, *rope_k),
            v.reshape(*v.shape[:2], -1, hd))


def causal_mask(S: int, T: int, window: int = 0, device=None) -> torch.Tensor:
    """(S,T) mask, True = attend: query i attends key j iff ``j <= i`` and
    (no window or ``j > i - window``)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > (qpos - window)
    return m


def _dense_attend(qh, kh, vh, window: int) -> torch.Tensor:
    """Dense causal attention of (B,S,H,hd) q over (B,S,K,hd) k/v, fp32."""
    B, S, H, hd = qh.shape
    K = kh.shape[2]
    g = H // K
    qf = qh.float().reshape(B, S, K, g, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qf, kh.float()).reshape(B, H, S, S)
    s = s * (1.0 / math.sqrt(hd))
    mask = causal_mask(S, S, window, qh.device)
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1).reshape(B, K, g, S, S)
    return torch.einsum("bkgst,btkh->bskgh", w, vh.float()).reshape(B, S, H, hd)


def attention_fwd(cfg: ModelConfig, p: Params, x, adapters=None,
                  positions=None, use_kernel: bool = False,
                  tp=None) -> torch.Tensor:
    """Full-sequence causal attention (train / eval).  x: (B,S,d).

    Three routes, as in the reference: the ``flash_attention`` kernel
    (``use_kernel``; any S), chunked ``flash_torch`` when
    ``S % min(S, 512) == 0`` (through :func:`dispatch_flash`, which under
    a train mesh ``tp`` picks the head-, sequence- or batch-parallel
    branch), and dense einsum attention otherwise.  Under ``tp`` the kernel
    and dense routes run on the rank's heads when the axis divides the KV
    heads and on q/k/v gathered whole otherwise, as GSPMD runs the
    reference's (no dispatch there).
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    a = adapters or {}
    q, k, v = _qkv_cols(cfg, p, x, adapters, use_kernel, tp)
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)

    def heads(qc, kc, vc, rows):
        return _heads(cfg, p, qc, kc, vc, (cos[rows], sin[rows]), (cos, sin))

    window = cfg.sliding_window
    if use_kernel:
        def attend(qh, kh, vh, q_offset, qc):
            return kops.flash_attention(qh, kh, vh, causal=True, window=window)
    elif S % min(S, 512) == 0:
        attend = None
    else:
        def attend(qh, kh, vh, q_offset, qc):
            return _dense_attend(qh, kh, vh, window)
    o = dispatch_flash(q, k, v, heads, kv_heads=cfg.num_kv_heads,
                       tp=tp if _train(tp) else None, attend=attend,
                       sequence=attend is None, causal=True, window=window,
                       q_chunk=512, kv_chunk=1024).to(x.dtype)
    return _row_out(tp, _proj(o, p["wo"], a.get("wo"), use_kernel, tp, ROW))


def check_decode_impl(decode_impl: str) -> None:
    if decode_impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode_impl {decode_impl!r}")


def attention_decode(cfg: ModelConfig, p: Params, x, cache: Dict,
                     adapters=None, n_tokens=None, decode_impl: str = "dense",
                     tp=None):
    """Chunked cached decode with per-slot positions.

    x: (B,C,d); cache: {"k", "v": (B,cap,K,hd), "pos", "length": (B,)};
    ``n_tokens: (B,)`` real tokens per row (rows with 0 leave their cache
    untouched).  ``decode_impl``: ``"dense"`` (full (B,H,C,cap) scores and
    the dense ring mask; int8 caches dequantized to bf16), ``"streamed"``
    (:func:`~repro_torch.models.attention_core.ring_flash_decode`: an online
    softmax over kv blocks, int8 dequantized per block in fp32) or
    ``"kernel"`` (:func:`repro_torch.kernels.ops.ring_decode`; int8
    dequantized per tile in fp32).  All agree on valid query positions
    ``t < n_tokens[b]``.
    Returns (out (B,C,d), new_cache); the cache's ring buffers are written
    in place.
    """
    check_decode_impl(decode_impl)
    B, C, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qpos = cache["pos"].long()[:, None] + torch.arange(C, device=x.device)[None, :]
    rope = rope_freqs(cfg.head_dim, cfg.rope_theta, qpos)
    q, k, v = _heads(cfg, p, *_qkv_cols(cfg, p, x, adapters, False, tp), rope,
                     rope)
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
        fn = kops.ring_decode if decode_impl == "kernel" else ring_flash_decode
        o = fn(q, cache["k"], cache["v"], cache["pos"], cache["length"], n,
               window=cfg.sliding_window,
               k_scale=cache["k_scale"] if int8 else None,
               v_scale=cache["v_scale"] if int8 else None)
    o = o.reshape(B, C, H * hd).to(x.dtype)
    a = adapters or {}
    return _row_out(tp, lora_proj(o, p["wo"], a.get("wo"))), cache


# -- MLA: multi-head latent attention (DeepSeek-V3) ---------------------------

def init_mla(cfg: ModelConfig, generator: torch.Generator, L: int,
             dtype: torch.dtype, keep=None) -> Params:
    """Stacked ``(L, ...)`` MLA weights of ``L`` layers: the low-rank query
    path (``wq_a``, ``q_a_norm``, ``wq_b``), the joint latent projection
    ``wkv_a`` (latent plus the shared RoPE key), its norm, the latent
    up-projection ``wkv_b`` (per-head key-nope and value) and ``wo``."""
    d = cfg.d_model
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    H = cfg.num_heads
    dev = generator.device
    k = _kept(keep)
    return {
        "wq_a": k("wq_a", dense_init(generator, (L, d, qr), d, dtype)),
        "q_a_norm": torch.ones((L, qr), dtype=dtype, device=dev),
        "wq_b": k("wq_b", dense_init(generator, (L, qr, H * (nope + rope)),
                                     qr, dtype)),
        "wkv_a": k("wkv_a", dense_init(generator, (L, d, kvr + rope), d,
                                       dtype)),
        "kv_a_norm": torch.ones((L, kvr), dtype=dtype, device=dev),
        "wkv_b": k("wkv_b", dense_init(generator, (L, kvr, H * (nope + vd)),
                                       kvr, dtype)),
        "wo": k("wo", dense_init(generator, (L, H * vd, d), H * vd, dtype)),
    }


def _mla_qkv(cfg: ModelConfig, p: Params, x, adapters, positions,
             use_kernel: bool = False, tp=None):
    """x (B,S,d) -> q_nope (B,S,H,nope), roped q_rope (B,S,H,rope), the
    normed latent c_kv (B,S,kvr) and the roped shared key k_rope (B,S,rope)
    (the rank's heads under ``tp``; ``wq_a`` / ``wkv_a``'s outputs gathered
    whole for their norms, in one collective under a train mesh)."""
    B, S, _ = x.shape
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    a = adapters or {}
    xi = _col_in(tp, x)
    q = _proj(xi, p["wq_a"], a.get("wq_a"), use_kernel, tp, COL)
    kv = _proj(xi, p["wkv_a"], a.get("wkv_a"), use_kernel, tp, COL)
    if _train(tp):
        q, kv = tp.gather_packed([q, kv])
    elif tp is not None:
        q, kv = tp.gather(q), tp.gather(kv)
    q = rmsnorm(q, p["q_a_norm"], cfg.norm_eps)
    q = _proj(q, p["wq_b"], a.get("wq_b"), use_kernel, tp, COL).reshape(
        B, S, -1, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    c_kv, k_rope = kv[..., :cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    cos, sin = rope_freqs(rope, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[..., None, :], cos, sin)       # (B,S,1,rope)
    c_kv = rmsnorm(c_kv, p["kv_a_norm"], cfg.norm_eps)
    return q_nope, q_rope, c_kv, k_rope[..., 0, :]


def fold_lora(w: torch.Tensor, adapter: Dict) -> torch.Tensor:
    """``w + scale · (B A)ᵀ`` in ``w``'s dtype: a classic leaf's delta
    folded into the weight (kvr, out), or a cohort leaf's (A (C, r, kvr), B
    (C, out, r), scale (C,)) into one weight a client, (C, kvr, out)."""
    A, Bm, s = adapter["A"], adapter["B"], adapter["scale"]
    if A.dim() == 2:
        return w + ((Bm @ A).t() * s).to(w.dtype)
    delta = (Bm @ A).mT * s.reshape(-1, 1, 1)
    return w[None] + delta.to(w.dtype)


def _mla_expand_kv(cfg: ModelConfig, p: Params, c_kv, adapters,
                   use_kernel: bool = False, tp=None):
    """The latent c_kv (B,T,kvr) expanded to per-head k_nope (B,T,H,nope)
    and v (B,T,H,vd) through ``wkv_b`` (the rank's heads under ``tp``)."""
    B, T, _ = c_kv.shape
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    a = adapters or {}
    kv = _proj(c_kv, p["wkv_b"], a.get("wkv_b"), use_kernel, tp,
               COL).reshape(B, T, -1, nope + vd)
    return kv[..., :nope], kv[..., nope:]


def _absorbed_weight(p: Params, a_kvb, tp, sequence: bool) -> torch.Tensor:
    """``wkv_b`` with its LoRA folded, for the absorbed route: whole on
    every rank for the sequence-parallel branch (gathered over ``model``:
    the base is frozen), else the rank's heads' columns with the adapter's
    B cut to them (ZeRO-3's ``data`` cut gathered first)."""
    if not _train(tp):
        return p["wkv_b"] if a_kvb is None else fold_lora(p["wkv_b"], a_kvb)
    with tp.full_weight(p["wkv_b"], 0) as w:
        if sequence:
            w = tp.all_gather(w, "model", w.dim() - 1)
        else:
            a_kvb = shard_adapter(a_kvb, tp, COL, w.shape[-1])
        return w if a_kvb is None else fold_lora(w, a_kvb)


def mla_fwd(cfg: ModelConfig, p: Params, x, adapters=None, positions=None,
            use_kernel: bool = False, tp=None) -> torch.Tensor:
    """MLA over a full sequence (train / prefill), x (B,S,d), the
    reference's two routes: when ``S % min(S, 512) == 0`` the absorbed
    route (:func:`~repro_torch.models.attention_core.mla_absorbed`: MQA of
    the absorbed queries against the latent stream, the per-head K/V never
    made; a ``wkv_b`` adapter is folded into the weight, per client for a
    cohort), otherwise the expanded route (``wkv_b`` expands the latent
    to per-head keys and values, dense causal attention).  A
    :class:`PagedLoRA` adapter raises on the absorbed route: paged adapters
    run on the decode path.  ``use_kernel`` sends ``wq_a``, ``wq_b``,
    ``wkv_a``, ``wo`` (and the expanded route's ``wkv_b``) through
    ``lora_matmul``; the attention itself is plain on both routes, as in
    the reference.  Under a train mesh ``tp`` the absorbed route is
    sequence-parallel where the ``model`` axis divides S and
    head-parallel (the rank's heads, no collective) otherwise; the
    expanded route is head-parallel."""
    B, S, _ = x.shape
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)
    a = adapters or {}
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, adapters, positions,
                                            use_kernel, tp)
    H = q_nope.shape[2]
    if S % min(S, 512) == 0:
        a_kvb = a.get("wkv_b")
        if isinstance(a_kvb, PagedLoRA):
            raise NotImplementedError(
                "paged multi-tenant adapters only run through the decode "
                "path (mla_decode); mla_fwd is the training/full-seq path")
        sequence = _train(tp) and tp.size > 1 and S % tp.size == 0
        w_kvb = _absorbed_weight(p, a_kvb, tp, sequence)
        o = mla_absorbed(q_nope, q_rope, c_kv.float(), k_rope.float(), w_kvb,
                         num_heads=H * (tp.size if sequence else 1),
                         nope_dim=nope, v_dim=vd, causal=True,
                         window=cfg.sliding_window,
                         tp=tp if sequence else None)
    else:
        k_nope, v = _mla_expand_kv(cfg, p, c_kv, adapters, use_kernel, tp)
        scale = 1.0 / math.sqrt(nope + cfg.qk_rope_head_dim)
        s = (torch.einsum("bshc,bthc->bhst", q_nope.float(), k_nope.float())
             + torch.einsum("bshc,btc->bhst", q_rope.float(), k_rope.float()))
        s = s * scale
        mask = causal_mask(S, S, cfg.sliding_window, x.device)
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
        o = torch.einsum("bhst,bthv->bshv", torch.softmax(s, dim=-1), v.float())
    o = o.reshape(B, S, H * vd).to(x.dtype)
    return _row_out(tp, _proj(o, p["wo"], a.get("wo"), use_kernel, tp, ROW))


def mla_decode(cfg: ModelConfig, p: Params, x, cache: Dict, adapters=None,
               n_tokens=None, decode_impl: str = "dense", tp=None):
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
    dequantized whole in fp32), ``"streamed"``
    (:func:`~repro_torch.models.attention_core.mla_ring_flash_decode`; int8
    halves dequantized per block) or ``"kernel"``
    (:func:`repro_torch.kernels.ops.mla_ring_decode`; int8 halves dequantized
    per tile).  All agree on valid query positions ``t < n_tokens[b]``.
    Returns (out (B,C,d), new_cache); the ring buffers are written in place.
    """
    check_decode_impl(decode_impl)
    B, C, _ = x.shape
    H = cfg.num_heads
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    qpos = cache["pos"].long()[:, None] + torch.arange(C, device=x.device)[None, :]
    q_nope, q_rope, c_kv_t, k_rope_t = _mla_qkv(cfg, p, x, adapters, qpos,
                                                tp=tp)
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
            w_kvb = fold_lora(w_kvb, a_kvb)
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
        fn = (kops.mla_ring_decode if decode_impl == "kernel"
              else mla_ring_flash_decode)
        out_lat = fn(
            q_eff, cache["c_kv"], cache["k_rope"], cache["pos"],
            cache["length"], n, scale=scale, window=cfg.sliding_window,
            c_kv_scale=cache["c_kv_scale"] if int8 else None,
            k_rope_scale=cache["k_rope_scale"] if int8 else None)
    o = torch.einsum(v_ein, out_lat, w_v).reshape(B, C, H * vd).to(x.dtype)
    return _row_out(tp, lora_proj(o, p["wo"], a.get("wo"))), cache


def init_mlp(cfg: ModelConfig, generator: torch.Generator, L: int,
             dtype: torch.dtype, d_ff: int = 0, keep=None) -> Params:
    """Stacked SwiGLU weights of ``L`` layers, ``d_ff`` wide (default the
    config's; a MoE's shared expert passes its own)."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    k = _kept(keep)
    return {
        "w_gate": k("w_gate", dense_init(generator, (L, d, ff), d, dtype)),
        "w_up": k("w_up", dense_init(generator, (L, d, ff), d, dtype)),
        "w_down": k("w_down", dense_init(generator, (L, ff, d), ff, dtype)),
    }


def mlp_fwd(p: Params, x, adapters=None, use_kernel: bool = False, tp=None):
    """SwiGLU with the SiLU taken in fp32 (``w_down``'s partial outputs
    reduced under ``tp``; a train mesh's ``w_gate`` / ``w_up`` take x
    through ``copy``)."""
    a = adapters or {}
    xi = _col_in(tp, x)
    g = _proj(xi, p["w_gate"], a.get("w_gate"), use_kernel, tp, COL)
    u = _proj(xi, p["w_up"], a.get("w_up"), use_kernel, tp, COL)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return _row_out(tp, _proj(h, p["w_down"], a.get("w_down"), use_kernel,
                              tp, ROW))
