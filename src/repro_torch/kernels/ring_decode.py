"""Launch of the ring flash-decoding CUDA kernel (``csrc/ring_decode.cu``),
the Hopper counterpart of ``repro.kernels.ring_decode.ring_decode_kernel``.

The cache is passed in its ``(B, cap, K, hd)`` layout with its strides; the
kernel masks the ragged last key tile itself, so neither a transposed nor a
padded copy of the cache is made.  The wrapper sizes the grid (:func:`plan`)
and allocates the fp32 partials and the cached merge counters; the kernel
splits each row's resident tiles (:func:`split_tiles` mirrors its
arithmetic) and its last split merges them in the same launch.  Every head
dim that is a multiple of 8 from 8 to 128 runs in the next tile width of
16, 32, 64 and 128 (:func:`padded_hd`), with the columns past hd
zero-filled in the kernel's tiles; an int8 cache whose rows are not a
multiple of 16 bytes travels as 8-byte copies (:func:`copy_bytes`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (HEAD_DIMS, HEAD_DIMS_TAKEN,
                                                  padded_hd)

TILE = 64                 # key slots per tile (kBK in the source)
GROUP_ROWS = {"keys": 8, "narrow": 16, "rows": 32, "tensor": 64}   # query rows a block
MIN_TILES = 4             # resident tiles a split walks at least
BLOCKS_PER_SM = 4
RING_BUDGET = 112 * 1024  # shared bytes the ring of tiles may take
ROWS_RING_BUDGET = 72 * 1024   # ... on route "rows" (arithmetic-bound)
SMEM_LIMIT = 232_448      # dynamic shared memory a block may use on sm_90
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_TICKETS: dict = {}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ring_decode kernel: {msg}")


def route(q_dtype, kv_dtype, rows: int) -> str:
    """How the kernel computes the ``rows`` = g·C query rows of a KV head.
    bf16 queries and cache take the tensor cores (mma.sync): ``"narrow"``
    up to 16 rows (each warp on 8 keys of a tile), ``"tensor"`` above
    (each warp on 16 rows and 32 keys).  Other dtypes take the CUDA cores:
    ``"keys"`` up to 8 rows (each warp on 8 keys), ``"rows"`` above (each
    warp on 4 rows).  A block takes ``GROUP_ROWS[route]`` rows."""
    if q_dtype == kv_dtype == torch.bfloat16:
        return "narrow" if rows <= GROUP_ROWS["narrow"] else "tensor"
    return "keys" if rows <= GROUP_ROWS["keys"] else "rows"


def plan(B: int, C: int, H: int, K: int, cap: int, sms: int, route_: str):
    """(row groups, nsplit): the grid is (B·K, nsplit, row groups) of
    ``GROUP_ROWS[route_]`` query rows; ``nsplit`` is the most splits any
    (b, kv head, group) may run: enough blocks for about ``BLOCKS_PER_SM``
    per SM, but never more than the full ring's tiles allow at
    ``MIN_TILES`` a split.  A one-tile ring runs one split."""
    groups = -(-(H // K * C) // GROUP_ROWS[route_])
    tiles = -(-cap // TILE)
    want = -(-BLOCKS_PER_SM * sms // (B * K * groups))
    return groups, max(1, min(tiles // MIN_TILES, want))


def resident_tiles(pos: int, length: int, cap: int):
    """The tiles holding a row's resident slots, in the kernel's order (the
    ring interval of ``length`` slots from ``(pos - length) mod cap``, then
    its wrapped part), each once."""
    if length <= 0:
        return []
    start = (pos - length) % cap
    a0, a1 = start // TILE, (min(start + length, cap) - 1) // TILE
    nb = min((start + length - cap - 1) // TILE + 1, a0) if start + length > cap else 0
    return list(range(a0, a1 + 1)) + list(range(nb))


def split_tiles(pos: int, length: int, cap: int, nsplit: int, split: int):
    """The tiles block ``split`` of a row walks: the row runs ``max(1,
    min(nsplit, resident // MIN_TILES))`` splits over its resident tiles in
    contiguous shares; a split past that count walks none."""
    tiles = resident_tiles(pos, length, cap)
    ne = max(1, min(nsplit, len(tiles) // MIN_TILES))
    if split >= ne:
        return []
    return tiles[split * len(tiles) // ne:(split + 1) * len(tiles) // ne]


def copy_bytes(hd: int, element_size: int) -> int:
    """The bytes one ``cp.async`` of a cache row moves: 16, or 8 for an int8
    cache whose rows (hd bytes) are not a multiple of 16."""
    return 16 if hd * element_size % 16 == 0 else 8


def smem_bytes(hd: int, kv_dtype, route_: str) -> int:
    """Dynamic shared memory of one block: a ring of 2–4 stages of K and V
    tiles in their storage dtype and padded width, rows padded by 16 bytes
    (int8 with its scales), reused after the last tile for the warps'
    partial states; the CUDA-core routes' fp32 queries (and route
    ``"rows"``' probabilities); a flag."""
    hd = padded_hd(hd)
    es = torch.empty((), dtype=kv_dtype).element_size()
    stage = 2 * TILE * (hd * es + 16) + (2 * TILE * 4 if es == 1 else 0)
    budget = ROWS_RING_BUDGET if route_ == "rows" else RING_BUDGET
    stages = min(4, max(2, budget // stage))
    comb = 8 * 16 * (hd + 4) * 4
    q_rows = GROUP_ROWS[route_] if route_ in ("keys", "rows") else 0
    pbuf = GROUP_ROWS["rows"] * TILE * 4 if route_ == "rows" else 0
    return max(stages * stage, comb) + q_rows * hd * 4 + pbuf + 16


def _tickets(dev: torch.device, need: int) -> torch.Tensor:
    """The merge counters of one device: zeros, allocated once and grown as
    needed; each launch leaves them zero (the merging block resets its
    own).  Launches that share them must run in stream order."""
    t = _TICKETS.get(dev)
    if t is None or t.numel() < need:
        t = torch.zeros(max(need, 1024), dtype=torch.int32, device=dev)
        _TICKETS[dev] = t
    return t


def ring_decode_cuda(q, k, v, pos, length, n_tokens, window: int,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (B,C,H,hd) fp32."""
    B, C, H, hd = q.shape
    cap, K = k.shape[1], k.shape[2]
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           f"shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    _check(k.shape[0] == B and k.shape[3] == hd and H % K == 0,
           f"q{tuple(q.shape)} does not match cache {tuple(k.shape)}")
    _check(hd in HEAD_DIMS, f"head dim {hd}; the kernel takes {HEAD_DIMS_TAKEN}")
    _check(q.dtype in _Q_CODES, f"query dtype {q.dtype}")
    _check(k.dtype in _KV_CODES and v.dtype == k.dtype,
           f"cache dtypes {k.dtype}/{v.dtype}")
    _check(window >= 0, f"window {window} < 0")
    _check(q.stride(-1) == 1 and k.stride(-1) == 1 and k.stride() == v.stride(),
           "q/k/v need a contiguous last axis and k, v equal strides")
    es = k.element_size()
    unit = copy_bytes(hd, es)
    _check(k.data_ptr() % unit == 0 and v.data_ptr() % unit == 0
           and all(st * es % unit == 0 for st in k.stride()[:3]),
           f"cache rows must start on {unit}-byte boundaries")
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups, nsplit = plan(B, C, H, K, cap, sms,
                          route(q.dtype, k.dtype, H // K * C))
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
        _tickets(dev, B * K * groups).data_ptr(),
        B, C, H, K, hd, cap, int(window), nsplit,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_decode kernel launch failed: error {err}")
    return out
