"""Launch of the MLA latent flash-decoding CUDA kernel
(``csrc/mla_ring_decode.cu``), the Hopper counterpart of
``repro.kernels.mla_ring_decode.mla_ring_decode_kernel``.

The latent cache is passed in its ``(B, cap, kvr)`` / ``(B, cap, rope)``
layout with its strides; the kernel masks the ragged last slot tile itself,
so no padded copy of the cache is made.  The wrapper splits the ring's slot
tiles across blocks and allocates the fp32 partials the merge step reads.
The kernel takes every latent width that is a multiple of 16 up to 512 with
every RoPE width that is a multiple of 16 up to 64, each run in the first
of ``PADDED_WIDTHS`` that holds it (:func:`padded_widths`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# the (latent, rope) widths the kernel is built for: its 576-wide key is
# split over 8 warps in 8-column steps, so the sum is a multiple of 64
PADDED_WIDTHS = ((32, 32), (64, 64), (128, 64), (256, 64), (512, 64))
WIDTHS_TAKEN = ("a latent width that is a multiple of 16 up to 512 and a "
                "RoPE width that is a multiple of 16 up to 64")
TILE = 32                 # latent slots per tile (kBK in the source)
ROWS_PER_BLOCK = 32       # query rows (t, h) per block (kRows in the source)
BLOCKS_PER_SM = 2
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mla_ring_decode kernel: {msg}")


def padded_widths(kvr: int, rope: int):
    """The (latent, rope) widths the kernel runs ``(kvr, rope)`` in: the
    first of ``PADDED_WIDTHS`` that holds both (DeepSeek-V3's 512 + 64 as
    they are; its SMOKE config's 32 + 16 in 32 + 32).  Raises
    ``ValueError`` outside ``WIDTHS_TAKEN``."""
    _check(kvr % 16 == 0 and 16 <= kvr <= 512 and rope % 16 == 0
           and 16 <= rope <= 64,
           f"latent widths ({kvr}, {rope}); the kernel takes {WIDTHS_TAKEN}")
    return next(p for p in PADDED_WIDTHS if p[0] >= kvr and p[1] >= rope)


def mla_ring_decode_cuda(q_eff, c_kv, k_rope, pos, length, n_tokens,
                         scale: float, window: int, c_kv_scale=None,
                         k_rope_scale=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (B,C,H,kvr) fp32."""
    _check(q_eff.dim() == 4 and c_kv.dim() == 3 and k_rope.dim() == 3,
           f"shapes q{tuple(q_eff.shape)} c_kv{tuple(c_kv.shape)} "
           f"k_rope{tuple(k_rope.shape)}")
    B, C, H, dq = q_eff.shape
    cap, kvr = c_kv.shape[1:]
    rope = k_rope.shape[2]
    _check(c_kv.shape[0] == B and k_rope.shape[:2] == (B, cap)
           and dq == kvr + rope,
           f"q{tuple(q_eff.shape)} does not match the latent cache "
           f"c_kv{tuple(c_kv.shape)} k_rope{tuple(k_rope.shape)}")
    padded_widths(kvr, rope)
    _check(q_eff.dtype == torch.float32, f"query dtype {q_eff.dtype}")
    _check(c_kv.dtype in _KV_CODES and k_rope.dtype == c_kv.dtype,
           f"cache dtypes {c_kv.dtype}/{k_rope.dtype}")
    _check(window >= 0, f"window {window} < 0")
    _check(q_eff.stride(-1) == 1 and c_kv.stride(-1) == 1
           and k_rope.stride(-1) == 1, "q/c_kv/k_rope need a contiguous last axis")
    es = c_kv.element_size()
    _check(all(t.data_ptr() % 16 == 0 for t in (c_kv, k_rope))
           and all(st * es % 16 == 0
                   for st in c_kv.stride()[:2] + k_rope.stride()[:2]),
           "cache rows must start on 16-byte boundaries")
    int8 = c_kv.dtype == torch.int8
    _check(int8 == (c_kv_scale is not None) == (k_rope_scale is not None),
           "int8 caches need c_kv_scale and k_rope_scale, float caches none")
    if int8:
        _check(c_kv_scale.shape == k_rope_scale.shape == (B, cap, 1)
               and c_kv_scale.dtype == k_rope_scale.dtype == torch.float32
               and c_kv_scale.stride() == k_rope_scale.stride(),
               "scales must be fp32 (B,cap,1) with equal strides")
    dev = q_eff.device
    tensors = [c_kv, k_rope, pos, length, n_tokens] + (
        [c_kv_scale, k_rope_scale] if int8 else [])
    _check(dev.type == "cuda" and all(t.device == dev for t in tensors),
           "every tensor must be on the same CUDA device")
    q_eff = q_eff.contiguous()            # query rows are read as float4
    pos, length, n_tokens = (t.to(torch.int32).contiguous()
                             for t in (pos, length, n_tokens))
    out = torch.empty((B, C, H, kvr), dtype=torch.float32, device=dev)
    nsplit, per = splits(B, C, H, cap, dev)
    part_o = part_ml = None
    if nsplit > 1:
        part_o = torch.empty((nsplit, B, C, H, kvr), dtype=torch.float32,
                             device=dev)
        part_ml = torch.empty((nsplit, B, C, H, 2), dtype=torch.float32,
                              device=dev)
    sc = c_kv_scale.stride()[:2] if int8 else (0, 0)
    err = build.load("mla_ring_decode").mla_ring_decode_launch(
        q_eff.data_ptr(), *q_eff.stride()[:3],
        c_kv.data_ptr(), *c_kv.stride()[:2],
        k_rope.data_ptr(), *k_rope.stride()[:2], _KV_CODES[c_kv.dtype],
        c_kv_scale.data_ptr() if int8 else None,
        k_rope_scale.data_ptr() if int8 else None, *sc,
        pos.data_ptr(), length.data_ptr(), n_tokens.data_ptr(), out.data_ptr(),
        part_o.data_ptr() if nsplit > 1 else None,
        part_ml.data_ptr() if nsplit > 1 else None,
        B, C, H, kvr, rope, cap, int(window), nsplit, per, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_ring_decode kernel launch failed: error {err}")
    return out


def splits(B: int, C: int, H: int, cap: int, dev: torch.device):
    """(nsplit, tiles per split) for these shapes: split the ring's slot
    tiles across blocks until there are about ``BLOCKS_PER_SM`` blocks per
    SM (the kernel runs one block per SM at a time).  With ``nsplit == 1``
    the kernel normalises in-block and no merge runs."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = B * -(-(C * H) // ROWS_PER_BLOCK)
    tiles = -(-cap // TILE)
    want = max(1, min(tiles, -(-BLOCKS_PER_SM * sms // blocks)))
    per = -(-tiles // want)
    return -(-tiles // per), per
