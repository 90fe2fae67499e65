"""Launch of the causal / windowed GQA flash-attention CUDA kernel
(``csrc/flash_attention.cu``), the Hopper counterpart of
``repro.kernels.flash_attention.flash_attention_kernel``.

q, k and v are read in their (B, S|T, heads, hd) layouts; the kernel masks
the ragged last query and key tiles itself, so neither transposed nor
padded copies are made.  Every head dim that is a multiple of 8 from 8 to
128 runs in the next tile width of ``TILE_WIDTHS`` (:func:`padded_hd`):
the kernel zero-fills the columns past hd in its tiles.  The bf16 kernel's
launch geometry is mirrored here in plain functions (:func:`bf16_smem_bytes`,
:func:`bf16_blocks`) so that the CPU tests can check it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

TILE_WIDTHS = (16, 32, 64, 128)          # the widths the kernels are built for
HEAD_DIMS = tuple(range(8, 129, 8))      # the head dims they take
HEAD_DIMS_TAKEN = "every head dim that is a multiple of 8 from 8 to 128"
_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel's constants (kBR, kBN, kStages in the source)
ROWS_PER_BLOCK = 64       # (query, head) rows s·g + j of one KV group
KEYS_PER_TILE = 64
STAGES = 2
SMEM_LIMIT = 232_448      # dynamic shared memory a block may use on sm_90


def padded_hd(hd: int) -> int:
    """The tile width head dim ``hd`` runs in: the next of ``TILE_WIDTHS``.
    Raises ``ValueError`` for a head dim outside ``HEAD_DIMS``: a multiple
    of 8 keeps every row a multiple of 16 bytes, as TMA's strides and the
    kernels' 16-byte chunks need."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}; the attention kernels take "
                         f"{HEAD_DIMS_TAKEN}")
    return next(w for w in TILE_WIDTHS if w >= hd)


def bf16_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the bf16 kernel: the block's Q rows, a ring
    of K and V tiles (both in the padded width), the ring's mbarriers and
    1 KB of alignment slack."""
    w = padded_hd(hd)
    return (ROWS_PER_BLOCK * w * 2 + 2 * STAGES * KEYS_PER_TILE * w * 2
            + 3 * STAGES * 8 + 1024)


def bf16_blocks(B: int, S: int, T: int, H: int, K: int, causal: bool,
                window: int):
    """The bf16 kernel's grid, block by block in launch order: (b, KV head,
    first row s·g + j, first key, number of key tiles).  Causal grids walk
    the query tiles from the end, so the blocks with the most key tiles
    start first."""
    g = H // K
    n_mt = -(-S * g // ROWS_PER_BLOCK)
    out = []
    for idx in range(n_mt * B * K):
        bk, mi = idx % (B * K), idx // (B * K)
        mt = n_mt - 1 - mi if causal else mi
        m0 = mt * ROWS_PER_BLOCK
        s_lo, s_hi = m0 // g, min(S - 1, (m0 + ROWS_PER_BLOCK - 1) // g)
        t_end = min(T, s_hi + 1) if causal else T
        t_begin = (max(0, s_lo - window + 1) // KEYS_PER_TILE * KEYS_PER_TILE
                   if window else 0)
        n_tiles = -(-(t_end - t_begin) // KEYS_PER_TILE) if t_end > t_begin else 0
        out.append((bk // K, bk % K, m0, t_begin, n_tiles))
    return out


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
    _check(hd in HEAD_DIMS, f"head dim {hd}; the kernel takes {HEAD_DIMS_TAKEN}")
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
