"""Public kernel wrappers, with the signatures of ``repro.kernels.ops``.

A CUDA tensor launches the hand-written kernel (or the launch raises); a
CPU tensor takes the plain PyTorch version in :mod:`repro_torch.kernels.ref`.
There is no fallback from one to the other.  Each wrapper counts its kernel
launches in a plain integer attribute (``ring_decode.launches``,
``bgmv.launches``), so a run can show that its path went through the
kernels.  ``ops.ring_decode`` drops the reference's ``bk`` argument: the
TPU kernel's key block is a tuning knob of that kernel, and the CUDA
kernel's tile is fixed in its source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bgmv import bgmv_cuda
from repro_torch.kernels.ring_decode import ring_decode_cuda


def ring_decode(q, k, v, pos, length, n_tokens=None, window: int = 0,
                k_scale=None, v_scale=None):
    """Flash-decoding over a GQA ring cache.

    q: (B,C,H,hd); k/v: (B,cap,K,hd) raw cache storage (int8 with per-token
    (B,cap,K,1) scales dequantized in-kernel); pos/length/n_tokens: (B,)
    ring state AFTER the chunk write.  Returns (B,C,H,hd) fp32, defined on
    valid query positions ``t < n_tokens[b]``.
    """
    B, C = q.shape[:2]
    if n_tokens is None:
        n_tokens = torch.full((B,), C, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return ref.ring_decode_ref(q, k, v, pos, length, n_tokens,
                                   window=window, k_scale=k_scale,
                                   v_scale=v_scale)
    out = ring_decode_cuda(q, k, v, pos, length, n_tokens, window,
                           k_scale=k_scale, v_scale=v_scale)
    ring_decode.launches += 1
    return out


ring_decode.launches = 0


def bgmv(x, a_pages, b_pages, table, rank, scale, ids):
    """Batched-gather multi-tenant LoRA delta: per row
    ``y_b = scale_b · B_b(A_b x_b)`` at the row's own rank.

    x: (B,C,din); a_pages: (P,pr,din); b_pages: (P,dout,pr); table:
    (maxA,Pmax); rank/scale: (maxA,); ids: (B,) (0 = base, exact zero).
    Returns (B,C,dout) fp32.  Inference only.
    """
    if x.device.type == "cpu":
        return ref.bgmv_ref(x, a_pages, b_pages, table, rank, scale, ids)
    out = bgmv_cuda(x, a_pages, b_pages, table, rank, scale, ids)
    bgmv.launches += 1
    return out


bgmv.launches = 0

WRAPPERS = {"ring_decode": ring_decode, "bgmv": bgmv}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
