"""Launch of the fused LoRA projection CUDA kernel (``csrc/lora_matmul.cu``),
the Hopper counterpart of ``repro.kernels.lora_matmul.lora_matmul_kernel``.

The wrapper hands the kernel x, W, A and the pre-scaled s·B in one dtype;
the kernel masks ragged M, dout, din and rank itself, so no padded copies
are made (the reference pads on the host).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_RANK = 128
_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lora_matmul kernel: {msg}")


def lora_matmul_cuda(x, w, a, b_scaled) -> torch.Tensor:
    """x (M, din), w (din, dout), a (r, din), b_scaled (dout, r), one dtype,
    on one CUDA device; returns ``x w + bf16(x aᵀ) b_scaledᵀ`` (M, dout)."""
    _check(x.dim() == 2 and w.dim() == 2 and a.dim() == 2 and b_scaled.dim() == 2,
           f"shapes x{tuple(x.shape)} w{tuple(w.shape)} a{tuple(a.shape)} "
           f"b{tuple(b_scaled.shape)}")
    M, din = x.shape
    dout = w.shape[1]
    r = a.shape[0]
    _check(w.shape[0] == din and a.shape[1] == din
           and b_scaled.shape == (dout, r),
           f"x{tuple(x.shape)} w{tuple(w.shape)} a{tuple(a.shape)} "
           f"b{tuple(b_scaled.shape)} do not match")
    _check(1 <= r <= MAX_RANK, f"rank {r} not in [1, {MAX_RANK}]")
    _check(x.dtype in _CODES and all(t.dtype == x.dtype for t in (w, a, b_scaled)),
           f"dtypes x {x.dtype}, w {w.dtype}, a {a.dtype}, b {b_scaled.dtype}")
    dev = x.device
    _check(dev.type == "cuda" and all(t.device == dev for t in (w, a, b_scaled)),
           "every tensor must be on the same CUDA device")
    _check(all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, w, a, b_scaled)),
           "tensors must be contiguous and 16-byte aligned")
    y = torch.empty((M, dout), dtype=x.dtype, device=dev)
    err = build.load("lora_matmul").lora_matmul_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b_scaled.data_ptr(),
        y.data_ptr(), _CODES[x.dtype], M, din, dout, r,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lora_matmul kernel launch failed: error {err}")
    return y
