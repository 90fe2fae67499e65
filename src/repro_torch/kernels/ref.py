"""Plain PyTorch versions of the port's kernels.

The CPU path of every wrapper in :mod:`repro_torch.kernels.ops` and the
reference each CUDA kernel is held against on the card.  Both compute in
float32 from the stored values, whatever their type.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.attention_core import ring_attend_mask


def ring_decode_ref(q, k, v, pos, length, n_tokens, window: int = 0,
                    k_scale=None, v_scale=None):
    """Dense decode attention over a GQA ring cache (``repro.kernels.ref.
    ring_decode_ref``).

    q: (B,C,H,hd); k/v: (B,cap,K,hd) raw cache storage (int8 with
    (B,cap,K,1) per-token scales, dequantized WHOLE in fp32);
    pos/length/n_tokens: (B,) ring state AFTER the chunk write.  Returns
    (B,C,H,hd) fp32.
    """
    B, C, H, hd = q.shape
    cap, K = k.shape[1], k.shape[2]
    g = H // K
    kf = k.float()
    vf = v.float()
    if k_scale is not None:
        kf = kf * k_scale
        vf = vf * v_scale
    qf = q.float().reshape(B, C, K, g, hd)
    s = torch.einsum("bckgh,btkh->bkgct", qf, kf) / math.sqrt(hd)
    qpos = ((pos - n_tokens).long()[:, None]
            + torch.arange(C, device=q.device)[None, :])
    mask = ring_attend_mask(pos, length, cap, qpos, window)      # (B,C,cap)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgct,btkh->bckgh", p, vf)
    return o.reshape(B, C, H, hd)


def bgmv_ref(x, a_pages, b_pages, table, rank, scale, ids):
    """Per-row paged LoRA delta ``y_b = scale_b · (x_b A_bᵀ) B_bᵀ`` (the
    ``_paged_gather`` + einsum twin of ``repro.peft.lora``), in fp32.

    x: (B,C,din); a_pages: (P,pr,din); b_pages: (P,dout,pr); table:
    (maxA,Pmax); rank/scale: (maxA,); ids: (B,).  Lanes ``>= rank`` are
    zeroed, so an id of rank 0 gives an exact zero.  Returns (B,C,dout) fp32.
    """
    ids = ids.long()
    pt = table.long()[ids]                                   # (B, Pmax)
    Bn, Pmax = pt.shape
    _, pr, din = a_pages.shape
    dout = b_pages.shape[1]
    R = Pmax * pr
    Ag = a_pages[pt].reshape(Bn, R, din).float()
    Bg = b_pages[pt].permute(0, 2, 1, 3).reshape(Bn, dout, R).float()
    z = torch.einsum("bcd,brd->bcr", x.float(), Ag)
    lane = torch.arange(R, device=x.device)[None, None, :]
    z = torch.where(lane < rank.long()[ids][:, None, None], z,
                    torch.zeros((), dtype=z.dtype, device=z.device))
    y = torch.einsum("bcr,bor->bco", z, Bg)
    return y * scale.float()[ids][:, None, None]


def lora_matmul_ref(x, w, a, b, scale):
    """``y = x @ w + scale * (x @ aᵀ) @ bᵀ`` (``repro.kernels.ref.
    lora_matmul_ref``).  x: (M, din), w: (din, dout), a: (r, din),
    b: (dout, r); products in x's dtype."""
    y = x @ w
    z = x @ a.t().to(x.dtype)
    return y + (z @ b.t().to(x.dtype)) * scale


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """Dense grouped-query attention with an fp32 softmax
    (``repro.kernels.ref.flash_attention_ref``).  q: (B,S,H,hd), k/v:
    (B,T,K,hd); the window applies independently of causal.  Returns
    (B,S,H,hd) fp32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    qf = q.float().reshape(B, S, K, g, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) * (1.0 / math.sqrt(hd))
    if causal or window:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        m = torch.ones((S, T), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos <= qpos
        if window:
            m &= kpos > (qpos - window)
        s = torch.where(m, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return o.reshape(B, S, H, hd)


def adapter_gram_ref(x):
    """Gram matrix ``xᵀx`` in fp32 (``repro.kernels.ref.adapter_gram_ref``).
    x: (m, r) or, batched, (G, m, r)."""
    xf = x.float()
    return xf.mT @ xf
