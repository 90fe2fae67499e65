"""Launch of the RWKV6 WKV recurrence CUDA kernel (``csrc/wkv6.cu``), the
Hopper counterpart of ``repro.kernels.wkv6.wkv6_kernel``.

One block per (batch row, head) walks the whole sequence, so one call is
one launch.  The kernel is built for head dims 32 (RWKV6's SMOKE config)
and 64 (the published one): hd threads a block, each holding 8 rows of the
state over hd/8 columns.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64)
_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wkv6 kernel: {msg}")


def check_head_dim(hd: int) -> None:
    """Raises ``ValueError`` naming ``HEAD_DIMS`` for a head dim outside it."""
    _check(hd in HEAD_DIMS, f"head dim {hd}; the kernel takes {HEAD_DIMS}")


def wkv6_cuda(r, k, v, w, u) -> torch.Tensor:
    """r, k, v (B,S,H,hd) of one dtype (fp32 or bf16), w (B,S,H,hd) fp32,
    u (H,hd) fp32, all contiguous on one CUDA device, hd in ``HEAD_DIMS``.
    Returns y (B,S,H,hd) fp32."""
    _check(r.dim() == 4 and r.shape == k.shape == v.shape == w.shape,
           f"shapes r{tuple(r.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
           f"w{tuple(w.shape)}")
    B, S, H, hd = r.shape
    check_head_dim(hd)
    _check(u.shape == (H, hd), f"u {tuple(u.shape)} for {H} heads of {hd}")
    _check(r.dtype in _CODES and k.dtype == v.dtype == r.dtype,
           f"dtypes r/k/v {r.dtype}/{k.dtype}/{v.dtype}")
    _check(w.dtype == torch.float32 and u.dtype == torch.float32,
           f"w and u must be float32, got {w.dtype} and {u.dtype}")
    dev = r.device
    _check(dev.type == "cuda" and all(t.device == dev for t in (k, v, w, u)),
           "every tensor must be on the same CUDA device")
    _check(all(t.is_contiguous() for t in (r, k, v, w, u)),
           "tensors must be contiguous")
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    err = build.load("wkv6").wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), _CODES[r.dtype], w.data_ptr(),
        u.data_ptr(), y.data_ptr(), B, S, H, hd,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: error {err}")
    return y
