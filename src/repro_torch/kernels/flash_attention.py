"""Launch of the causal / windowed GQA flash-attention CUDA kernel
(``csrc/flash_attention.cu``), the Hopper counterpart of
``repro.kernels.flash_attention.flash_attention_kernel``.

q, k and v are read in their (B, S|T, heads, hd) layouts; the kernel masks
the ragged last query and key tiles itself, so neither transposed nor
padded copies are made.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def flash_attention_cuda(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,K,hd) on one CUDA device; returns
    (B,S,H,hd) in q's dtype."""
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           f"shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    _check(k.shape[0] == B and k.shape[3] == hd and H % K == 0,
           f"q{tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    _check(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    _check(q.dtype in _CODES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}")
    dev = q.device
    _check(dev.type == "cuda" and k.device == dev and v.device == dev,
           "every tensor must be on the same CUDA device")
    _check(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)),
           "tensors must be contiguous and 16-byte aligned")
    _check(window >= 0, f"window {window}")
    o = torch.empty_like(q)
    err = build.load("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _CODES[q.dtype],
        B, S, T, H, K, hd, int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: error {err}")
    return o
