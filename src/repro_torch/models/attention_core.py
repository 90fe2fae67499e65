"""Attention cores (port of ``repro.models.attention_core``): ring-buffer
masks for decode attention, the streamed decode route
(``ring_flash_decode``, ``mla_ring_flash_decode``: an online softmax over
kv blocks of the ring, the reference's XLA flash-decoding), and
``flash_torch``, the chunked online-softmax attention of full sequences
(``flash_jax``), ``dispatch_flash``, its head-, sequence- and
batch-parallel branches under a train mesh, and ``mla_absorbed``, MLA's
full-sequence attention in the absorbed form, with its sequence-parallel
branch.

Slot ``s`` of a row's ring holds absolute position
``p_abs = last - (last - s) mod cap`` with ``last = pos - 1``.  The modulo is
a floor modulo: ``last - s`` is negative for slots never written
(``pos = 0``) and for slots ahead of the write head, and ``torch.remainder``
(like ``jnp.mod``) returns a value in ``[0, cap)`` for those, where
``torch.fmod`` and C's ``%`` would not.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def ring_slot_positions(pos: torch.Tensor, length: torch.Tensor, cap: int):
    """pos/length: (B,) ring state AFTER the current write.  Returns
    (p_abs, resident), both (B, cap)."""
    s = torch.arange(cap, device=pos.device)[None, :]
    last = pos[:, None].long() - 1
    p_abs = last - torch.remainder(last - s, cap)
    resident = p_abs >= (pos - length).long()[:, None]
    return p_abs, resident


def ring_attend_mask(pos: torch.Tensor, length: torch.Tensor, cap: int,
                     qpos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """(B, C, cap) bool: row ``b``'s query ``t`` (absolute position
    ``qpos[b, t]``) attends slot ``s`` iff the slot is resident, causally
    visible and inside the sliding window when one is set."""
    p_abs, resident = ring_slot_positions(pos, length, cap)
    q = qpos.long()[:, :, None]
    m = resident[:, None, :] & (p_abs[:, None, :] <= q)
    if window:
        m &= p_abs[:, None, :] > (q - window)
    return m


def ring_block_mask(pos: torch.Tensor, length: torch.Tensor,
                    n_tokens: torch.Tensor, cap: int, start: int, bk: int,
                    C: int, window: int = 0) -> torch.Tensor:
    """(B, C, bk) mask for the slots ``[start, start + bk)`` — the per-tile
    form the CUDA kernel computes; slots ``>= cap`` are masked out, and query
    positions are ``qpos = pos - n_tokens + t``."""
    dev = pos.device
    s = start + torch.arange(bk, device=dev)[None, :]
    last = pos.long()[:, None] - 1
    p_abs = last - torch.remainder(last - s, cap)
    resident = (p_abs >= (pos - length).long()[:, None]) & (s < cap)
    qpos = ((pos - n_tokens).long()[:, None]
            + torch.arange(C, device=dev)[None, :])
    m = resident[:, None, :] & (p_abs[:, None, :] <= qpos[:, :, None])
    if window:
        m &= p_abs[:, None, :] > (qpos[:, :, None] - window)
    return m


def _streamed_ring_attend(qf: torch.Tensor, kv_block, pos, length, n_tokens,
                          cap: int, bk: int, nb: int, dv: int, window: int,
                          scale: float) -> torch.Tensor:
    """Online softmax over the ring cache's kv blocks.

    qf: (B,C,K,g,dq) fp32; ``kv_block(start) -> (k (B,bk,K,dq), v
    (B,bk,K,dv))`` fp32 (an int8 cache is dequantized per block inside the
    callback, never whole).  Live scores are O(B·H·C·bk), never O(cap).
    Returns (B,C,H,dv) fp32."""
    B, C, K, g, _ = qf.shape
    dev = qf.device
    m_run = torch.full((B, K, g, C), NEG_INF, device=dev)
    l_run = torch.zeros((B, K, g, C), device=dev)
    acc = torch.zeros((B, K, g, C, dv), device=dev)
    for ib in range(nb):
        start = ib * bk
        kb, vb = kv_block(start)
        s = torch.einsum("bckgd,bxkd->bkgcx", qf, kb) * scale    # (B,K,g,C,bk)
        msk = ring_block_mask(pos, length, n_tokens, cap, start, bk, C,
                              window)                            # (B,C,bk)
        s = torch.where(msk[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgcx,bxkd->bkgcd", p, vb)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]        # (B,K,g,C,dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, K * g, dv)


def _block_slice(x: torch.Tensor, start: int, bk: int) -> torch.Tensor:
    return x[:, start:start + bk]


def _pad_cap(arrs, cap: int, bk: int):
    """Pad the slot axis (axis 1) of every tensor to a ``bk`` multiple,
    keeping its dtype (an int8 cache stays int8); padded slots are masked
    by ``s < cap`` in :func:`ring_block_mask`."""
    pad = (-cap) % bk
    if pad == 0:
        return arrs
    return [None if a is None else
            torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
            for a in arrs]


def _n_or_full(n_tokens, B: int, C: int, device) -> torch.Tensor:
    if n_tokens is None:
        return torch.full((B,), C, dtype=torch.int32, device=device)
    return n_tokens.to(torch.int32)


def ring_flash_decode(q, k, v, pos, length, n_tokens=None, *, window: int = 0,
                      scale=None, block: int = 128, k_scale=None,
                      v_scale=None) -> torch.Tensor:
    """Streamed flash-decoding over a GQA ring cache (the reference's
    ``ring_flash_decode``, plain PyTorch as it is plain XLA there).

    q: (B,C,H,hd); k/v: (B,cap,K,hd) raw cache storage, int8 with per-token
    (B,cap,K,1) scales dequantized per block; pos/length: (B,) ring state
    AFTER the chunk write; ``n_tokens: (B,)`` real query tokens (None = C).
    The residency, causal and window mask is formed per kv block of
    ``bk = min(block, cap)`` slots, so neither a (B,C,cap) mask, a
    (B,H,C,cap) score tensor nor a full-precision cache copy is live.
    Returns (B,C,H,hd) fp32."""
    B, C, H, dq = q.shape
    cap, K = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = H // K
    if scale is None:
        scale = 1.0 / math.sqrt(dq)
    n = _n_or_full(n_tokens, B, C, q.device)
    bk = min(block, cap)
    nb = -(-cap // bk)
    k, v, k_scale, v_scale = _pad_cap([k, v, k_scale, v_scale], cap, bk)
    qf = q.float().reshape(B, C, K, g, dq)

    def kv_block(start):
        kb = _block_slice(k, start, bk).float()
        vb = _block_slice(v, start, bk).float()
        if k_scale is not None:
            kb = kb * _block_slice(k_scale, start, bk)
            vb = vb * _block_slice(v_scale, start, bk)
        return kb, vb

    return _streamed_ring_attend(qf, kv_block, pos, length, n, cap, bk, nb,
                                 dv, window, scale)


def mla_ring_flash_decode(q_eff, c_kv, k_rope, pos, length, n_tokens=None, *,
                          scale: float, window: int = 0, block: int = 128,
                          c_kv_scale=None, k_rope_scale=None) -> torch.Tensor:
    """Streamed absorbed-MLA decode over the latent ring cache: MQA of the
    absorbed queries q_eff (B,C,H,kvr+rope) against ``[c_kv | k_rope]``
    with the latent ``c_kv`` (kvr wide) as the values.  c_kv: (B,cap,kvr),
    k_rope: (B,cap,rope) raw storage, int8 with (B,cap,1) per-half scales
    dequantized per block.  ``scale`` is the un-absorbed 1/√(nope+rope).
    Returns out_lat (B,C,H,kvr) fp32; the caller applies the absorbed
    V-projection."""
    B, C, H, dq = q_eff.shape
    cap, kvr = c_kv.shape[1], c_kv.shape[2]
    n = _n_or_full(n_tokens, B, C, q_eff.device)
    bk = min(block, cap)
    nb = -(-cap // bk)
    c_kv, k_rope, c_kv_scale, k_rope_scale = _pad_cap(
        [c_kv, k_rope, c_kv_scale, k_rope_scale], cap, bk)
    qf = q_eff.float().reshape(B, C, 1, H, dq)                # MQA: K 1, g H

    def kv_block(start):
        ckv = _block_slice(c_kv, start, bk).float()
        kr = _block_slice(k_rope, start, bk).float()
        if c_kv_scale is not None:
            ckv = ckv * _block_slice(c_kv_scale, start, bk)
            kr = kr * _block_slice(k_rope_scale, start, bk)
        kb = torch.cat([ckv, kr], dim=-1)[:, :, None, :]
        return kb, ckv[:, :, None, :]

    return _streamed_ring_attend(qf, kv_block, pos, length, n, cap, bk, nb,
                                 kvr, window, scale)


def _chunk_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                window: int) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > (qpos[:, None] - window)
    return m


def flash_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: int = 0,
                scale: Optional[float] = None, q_chunk: int = 512,
                kv_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """q: (B,S,H,dq), k: (B,T,K,dq), v: (B,T,K,dv) -> (B,S,H,dv) fp32.

    Chunked online softmax over (q chunk, kv chunk) tiles, live scores
    O(B·H·bq·bk), the port of ``flash_jax`` (a Python loop replaces the two
    scans).  Differentiable by autograd; it is the port's non-kernel
    training attention and what the ``flash_attention`` kernel's backward
    recomputes through.  Scores are scaled by ``scale``, by default 1/√dq.
    ``q_offset`` is the position of q's row 0 (a sequence-parallel rank's
    rows); the causal and window masks are in whole-sequence positions.
    """
    B, S, H, dq = q.shape
    T, K = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = H // K
    if scale is None:
        scale = 1.0 / math.sqrt(dq)
    bq, bk = min(q_chunk, S), min(kv_chunk, T)
    if S % bq or T % bk:
        raise ValueError(f"chunks ({bq}, {bk}) must divide (S, T) = ({S}, {T})")
    nq, nk = S // bq, T // bk
    dev = q.device
    qf = q.float().reshape(B, nq, bq, K, g, dq)
    kf = k.float().reshape(B, nk, bk, K, dq)
    vf = v.float().reshape(B, nk, bk, K, dv)
    outs = []
    for iq in range(nq):
        q_blk = qf[:, iq]
        qpos = q_offset + iq * bq + torch.arange(bq, device=dev)
        m_run = torch.full((B, K, g, bq), NEG_INF, device=dev)
        l_run = torch.zeros((B, K, g, bq), device=dev)
        acc = torch.zeros((B, K, g, bq, dv), device=dev)
        for ik in range(nk):
            s = torch.einsum("bqkgd,bxkd->bkgqx", q_blk, kf[:, ik]) * scale
            kpos = ik * bk + torch.arange(bk, device=dev)
            msk = _chunk_mask(qpos, kpos, causal, window)
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqx,bxkd->bkgqd",
                                                        p, vf[:, ik])
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]  # (B,K,g,bq,dv)
        outs.append(out.permute(0, 3, 1, 2, 4))                # (B,bq,K,g,dv)
    return torch.stack(outs, dim=1).reshape(B, S, H, dv)


def flash_branch(tp, kv_heads: int, S: int, sequence: bool = True) -> str:
    """The reference's ``dispatch_flash`` tests under a train mesh's
    ``model`` axis (``tp``): ``"heads"`` with no axis or when it divides
    the KV heads, else ``"sequence"`` when it divides S (and ``sequence``
    allows it), else the ``"batch"`` fallback, replicated over ``model``.
    The reference also falls back when the data axes do not divide the
    global batch, a condition of ``shard_map``'s block specs; a rank here
    holds its own rows, so the port has no such test."""
    if tp is None or tp.size == 1 or kv_heads % tp.size == 0:
        return "heads"
    if sequence and S % tp.size == 0:
        return "sequence"
    return "batch"


def dispatch_flash(q, k, v, heads, *, kv_heads: int, tp=None, attend=None,
                   sequence: bool = True, causal: bool = True,
                   window: int = 0, scale: Optional[float] = None,
                   q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Mesh-aware attention (the reference's ``dispatch_flash``) on the
    rank's column slices of the projections: q (B,S,cq), k (B,S,ck), v
    (B,S,cv), whole heads when ``kv_heads`` divides the ``model`` axis,
    else cut anywhere (Qwen2-0.5B's 128-wide ``wk`` is half a KV head a
    rank at model 4).  ``heads(q, k, v, rows)`` makes (B,s,H',hd) heads of
    whole columns (bias added already; reshape, ``qk_norm``, RoPE at the
    positions ``rows``, a slice of the sequence).  Branches
    (:func:`flash_branch`):

    * ``"heads"``: no mesh, or head parallelism on the rank's heads; no
      collective;
    * ``"sequence"``: q exchanged from column slices to the rank's S/M
      query rows with every column (``all_to_all``), K/V gathered whole
      (one ``all_gather``, a reduce-scatter backward), each rank's rows at
      ``q_offset = index · S/M`` against the whole K/V, the output
      exchanged back to column slices for the row-parallel ``wo``;
    * ``"batch"``: q, k, v gathered whole (one ``all_gather``), attention
      on every rank, the rank's output columns kept.

    ``attend(q, k, v, q_offset, q_chunk)`` is the attention itself
    (default :func:`flash_torch`; the kernel route passes the
    ``flash_attention`` kernel with ``sequence=False``: in the reference
    the kernel runs on q/k/v gathered whole, not through this dispatch).
    Returns (B, S, c_out) in q's dtype, the rank's columns of the heads'
    outputs."""
    if attend is None:
        def attend(qh, kh, vh, q_offset, qc):
            return flash_torch(qh, kh, vh, causal=causal, window=window,
                               scale=scale, q_chunk=qc, kv_chunk=kv_chunk,
                               q_offset=q_offset)
    B, S = q.shape[:2]
    branch = flash_branch(tp, kv_heads, S, sequence)
    if branch == "heads":
        o = attend(*heads(q, k, v, slice(0, S)), 0, q_chunk)
        return o.reshape(B, S, -1).to(q.dtype)
    if branch == "sequence":
        ls = S // tp.size
        off = tp.index * ls
        qs = tp.exchange(q, split_dim=1, concat_dim=2)      # (B, S/M, cq·M)
        kw, vw = tp.gather_packed([k, v])
        o = attend(*heads(qs, kw, vw, slice(off, off + ls)), off,
                   min(q_chunk, ls))
        return tp.exchange(o.reshape(B, ls, -1).to(q.dtype), split_dim=2,
                           concat_dim=1)
    qw, kw, vw = tp.gather_packed([q, k, v])
    o = attend(*heads(qw, kw, vw, slice(0, S)), 0, q_chunk)
    return tp.local(o.reshape(B, S, -1).to(q.dtype))


def mla_absorbed(q_nope, q_rope, c_kv, k_rope, w_kvb, *, num_heads: int,
                 nope_dim: int, v_dim: int, causal: bool = True,
                 window: int = 0, q_chunk: int = 512,
                 kv_chunk: int = 1024, tp=None,
                 q_offset: int = 0) -> torch.Tensor:
    """Absorbed-MLA attention over a full sequence (the reference's
    single-device ``mla_absorbed``).

    q_nope (B,S,H,nope), q_rope (B,S,H,rope), c_kv (B,T,kvr), k_rope
    (B,T,rope); ``w_kvb`` (kvr, H·(nope+v_dim)) is the latent
    up-projection, its key part absorbed into the queries and its value
    part applied after the attention, or a cohort's (C, kvr, ...) with one
    weight a client (client c's rows at [c·B/C, (c+1)·B/C)).  One "kv head"
    (MQA): keys ``[c_kv | k_rope]``, queries ``[q_nope·W_k | q_rope]``,
    values the latent, through :func:`flash_torch` at the un-absorbed
    scale 1/√(nope + rope).  Returns (B,S,H,v_dim) fp32.

    Under a train mesh's ``model`` axis (``tp``) that divides S, the
    reference's sequence-parallel branch: q_nope / q_rope arrive as the
    rank's heads (column-parallel ``wq_b``) and are exchanged to the
    rank's S/M query rows with every head (one ``all_to_all``), the latent
    stream and ``w_kvb`` (gathered whole by the caller, its LoRA folded)
    are whole on every rank, the rows attend at ``q_offset = index ·
    S/M``, and the output goes back to the rank's heads (an
    ``all_to_all``) for the row-parallel ``wo``.  Otherwise the heads
    given are the rank's and ``w_kvb`` holds their columns."""
    if tp is not None and tp.size > 1 and q_nope.shape[1] % tp.size == 0:
        B, S = q_nope.shape[:2]
        ls = S // tp.size
        nope = q_nope.shape[-1]
        q = tp.exchange(torch.cat([q_nope, q_rope], dim=-1), split_dim=1,
                        concat_dim=2)                       # (B, S/M, H, ·)
        o = mla_absorbed(q[..., :nope], q[..., nope:], c_kv, k_rope, w_kvb,
                         num_heads=num_heads, nope_dim=nope_dim, v_dim=v_dim,
                         causal=causal, window=window,
                         q_chunk=min(q_chunk, ls), kv_chunk=kv_chunk,
                         q_offset=tp.index * ls)
        return tp.exchange(o, split_dim=2, concat_dim=1)
    B, S, H, _ = q_nope.shape
    kvr = c_kv.shape[-1]
    scale = 1.0 / math.sqrt(nope_dim + q_rope.shape[-1])
    G = w_kvb.shape[0] if w_kvb.dim() == 3 else 1
    w = w_kvb.reshape(G, kvr, H, nope_dim + v_dim).float()
    w_k, w_v = w[..., :nope_dim], w[..., nope_dim:]
    qn = q_nope.float().reshape(G, B // G, S, H, nope_dim)
    q_lat = torch.einsum("gbshn,gkhn->gbshk", qn, w_k).reshape(B, S, H, kvr)
    q_eff = torch.cat([q_lat, q_rope.float()], dim=-1)
    k_eff = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :].float()
    v_eff = c_kv[:, :, None, :].float()
    out_lat = flash_torch(q_eff, k_eff, v_eff, causal=causal, window=window,
                          scale=scale, q_chunk=q_chunk, kv_chunk=kv_chunk,
                          q_offset=q_offset)
    out_lat = out_lat.reshape(G, B // G, S, H, kvr)
    return torch.einsum("gbshk,gkhv->gbshv", out_lat, w_v).reshape(
        B, S, H, v_dim)
