"""Launch of the batched-gather LoRA delta CUDA kernel (``csrc/bgmv.cu``),
the Hopper counterpart of ``repro.kernels.bgmv.bgmv_kernel``.

The kernel reads each row's adapter id, its page-table row, rank and scale
itself, so one call is one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"bgmv kernel: {msg}")


def bgmv_cuda(x, a_pages, b_pages, table, rank, scale, ids) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (B,C,dout) fp32."""
    _check(x.dim() == 3 and a_pages.dim() == 3 and b_pages.dim() == 3,
           f"shapes x{tuple(x.shape)} a{tuple(a_pages.shape)} "
           f"b{tuple(b_pages.shape)}")
    B, C, din = x.shape
    P, pr, din_a = a_pages.shape
    dout = b_pages.shape[1]
    _check(din_a == din and b_pages.shape[0] == P and b_pages.shape[2] == pr,
           f"pages a{tuple(a_pages.shape)} b{tuple(b_pages.shape)} do not "
           f"match x{tuple(x.shape)}")
    _check(table.dim() == 2 and rank.shape == scale.shape == (table.shape[0],)
           and ids.shape == (B,), "table/rank/scale/ids shapes")
    _check(x.dtype in _CODES and a_pages.dtype in _CODES
           and b_pages.dtype == a_pages.dtype,
           f"dtypes x {x.dtype}, pages {a_pages.dtype}/{b_pages.dtype}")
    dev = x.device
    _check(dev.type == "cuda" and all(
        t.device == dev for t in (a_pages, b_pages, table, rank, scale, ids)),
        "every tensor must be on the same CUDA device")
    x, a_pages, b_pages = (t.contiguous() for t in (x, a_pages, b_pages))
    _check(din % 8 == 0 and x.data_ptr() % 16 == 0
           and a_pages.data_ptr() % 16 == 0,
           f"din {din} must be a multiple of 8 and x/a_pages 16-byte aligned")
    table, rank, ids = (t.to(torch.int32).contiguous()
                        for t in (table, rank, ids))
    scale = scale.to(torch.float32).contiguous()
    Pmax = table.shape[1]
    y = torch.empty((B, C, dout), dtype=torch.float32, device=dev)
    err = build.load("bgmv").bgmv_launch(
        x.data_ptr(), _CODES[x.dtype], a_pages.data_ptr(), b_pages.data_ptr(),
        _CODES[a_pages.dtype], table.data_ptr(), rank.data_ptr(),
        scale.data_ptr(), ids.data_ptr(), y.data_ptr(),
        B, C, din, dout, pr, Pmax, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bgmv kernel launch failed: error {err}")
    return y
