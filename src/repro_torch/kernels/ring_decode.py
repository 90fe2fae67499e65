"""Launch of the ring flash-decoding CUDA kernel (``csrc/ring_decode.cu``),
the Hopper counterpart of ``repro.kernels.ring_decode.ring_decode_kernel``.

The cache is passed in its ``(B, cap, K, hd)`` layout with its strides; the
kernel masks the ragged last key tile itself, so neither a transposed nor a
padded copy of the cache is made.  The wrapper splits the ring's key tiles
across blocks and allocates the fp32 partials the merge step reads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
TILE = 64                 # key slots per tile (kBK in the source)
ROWS_PER_BLOCK = 64       # query rows per block (kRowsMax in the source)
BLOCKS_PER_SM = 4
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ring_decode kernel: {msg}")


def ring_decode_cuda(q, k, v, pos, length, n_tokens, window: int,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (B,C,H,hd) fp32."""
    B, C, H, hd = q.shape
    cap, K = k.shape[1], k.shape[2]
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           f"shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    _check(k.shape[0] == B and k.shape[3] == hd and H % K == 0,
           f"q{tuple(q.shape)} does not match cache {tuple(k.shape)}")
    _check(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    _check(q.dtype in _Q_CODES, f"query dtype {q.dtype}")
    _check(k.dtype in _KV_CODES and v.dtype == k.dtype,
           f"cache dtypes {k.dtype}/{v.dtype}")
    _check(window >= 0, f"window {window} < 0")
    _check(q.stride(-1) == 1 and k.stride(-1) == 1 and k.stride() == v.stride(),
           "q/k/v need a contiguous last axis and k, v equal strides")
    es = k.element_size()
    _check(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
           and all(st * es % 16 == 0 for st in k.stride()[:3])
           and hd * es % 16 == 0,
           "cache rows must start on 16-byte boundaries")
    int8 = k.dtype == torch.int8
    _check(int8 == (k_scale is not None) == (v_scale is not None),
           "int8 caches need k_scale and v_scale, float caches none")
    if int8:
        _check(k_scale.shape == (B, cap, K, 1) and k_scale.dtype == torch.float32
               and k_scale.stride() == v_scale.stride()
               and v_scale.shape == k_scale.shape
               and v_scale.dtype == torch.float32,
               "scales must be fp32 (B,cap,K,1) with equal strides")
    dev = q.device
    tensors = [k, v, pos, length, n_tokens] + ([k_scale, v_scale] if int8 else [])
    _check(dev.type == "cuda" and all(t.device == dev for t in tensors),
           "every tensor must be on the same CUDA device")
    pos, length, n_tokens = (t.to(torch.int32).contiguous()
                             for t in (pos, length, n_tokens))
    out = torch.empty((B, C, H, hd), dtype=torch.float32, device=dev)
    nsplit, per = splits(B, C, H, K, cap, dev)
    part_o = part_ml = None
    if nsplit > 1:
        part_o = torch.empty((nsplit, B, C, H, hd), dtype=torch.float32, device=dev)
        part_ml = torch.empty((nsplit, B, C, H, 2), dtype=torch.float32, device=dev)
    sc = k_scale.stride()[:3] if int8 else (0, 0, 0)
    err = build.load("ring_decode").ring_decode_launch(
        q.data_ptr(), _Q_CODES[q.dtype], *q.stride()[:3],
        k.data_ptr(), v.data_ptr(), _KV_CODES[k.dtype], *k.stride()[:3],
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, *sc,
        pos.data_ptr(), length.data_ptr(), n_tokens.data_ptr(), out.data_ptr(),
        part_o.data_ptr() if nsplit > 1 else None,
        part_ml.data_ptr() if nsplit > 1 else None,
        B, C, H, K, hd, cap, int(window), nsplit, per,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_decode kernel launch failed: error {err}")
    return out


def splits(B: int, C: int, H: int, K: int, cap: int, dev: torch.device):
    """(nsplit, tiles per split) for these shapes: split the ring's key
    tiles across blocks until there are about ``BLOCKS_PER_SM`` blocks per
    SM.  With ``nsplit == 1`` the kernel normalises in-block and no merge
    runs."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = B * K * -(-(H // K * C) // ROWS_PER_BLOCK)
    tiles = -(-cap // TILE)
    want = max(1, min(tiles, -(-BLOCKS_PER_SM * sms // blocks)))
    per = -(-tiles // want)
    return -(-tiles // per), per
