"""Attention cores (port of ``repro.models.attention_core``): ring-buffer
masks for decode attention, and ``flash_torch``, the chunked online-softmax
attention of full sequences (``flash_jax``).

Slot ``s`` of a row's ring holds absolute position
``p_abs = last - (last - s) mod cap`` with ``last = pos - 1``.  The modulo is
a floor modulo: ``last - s`` is negative for slots never written
(``pos = 0``) and for slots ahead of the write head, and ``torch.remainder``
(like ``jnp.mod``) returns a value in ``[0, cap)`` for those, where
``torch.fmod`` and C's ``%`` would not.
"""
from __future__ import annotations

import math

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
                causal: bool = True, window: int = 0, q_chunk: int = 512,
                kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B,S,H,dq), k: (B,T,K,dq), v: (B,T,K,dv) -> (B,S,H,dv) fp32.

    Chunked online softmax over (q chunk, kv chunk) tiles, live scores
    O(B·H·bq·bk), the port of ``flash_jax`` (a Python loop replaces the two
    scans).  Differentiable by autograd; it is the port's non-kernel
    training attention and what the ``flash_attention`` kernel's backward
    recomputes through.  Scores are scaled by 1/√dq.
    """
    B, S, H, dq = q.shape
    T, K = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = H // K
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
        qpos = iq * bq + torch.arange(bq, device=dev)
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
