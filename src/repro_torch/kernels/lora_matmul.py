"""Launch of the fused LoRA projection CUDA kernel (``csrc/lora_matmul.cu``),
the Hopper counterpart of ``repro.kernels.lora_matmul.lora_matmul_kernel``.

The wrapper hands the kernel x, W, A and the pre-scaled s·B in one dtype;
the kernel masks ragged M, dout, din and rank itself, so no padded copies
are made (the reference pads on the host).  A client axis (x (C, M, din),
A (C, r, din), s·B (C, dout, r), W shared) runs a whole cohort in one
launch, the counterpart of the reference's ``jax.vmap`` of the kernel.  :func:`plan` picks the route
and, on the ``"wgmma"`` route, the output tile's width and the persistent
grid; the plain functions below mirror the source's arithmetic so that the
CPU tests can check it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_RANK = 128
RANK_PADS = (16, 32, 64, 128)   # ranks are padded to the next of these
TILE_M = 128                    # rows of an output tile (kTM in the source)
TILE_K = 64                     # din per pipeline stage (kTK)
TILE_NS = (256, 128, 64)        # output tile widths, widest first
GROUP_M = 8                     # tile rows per raster group (kGroupM)
MAX_STAGES = 4
SMEM_LIMIT = 232_448            # dynamic shared memory a block may use on sm_90
WAVE_FILL = 0.85                # the share of SMs a tile width must keep busy
_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lora_matmul kernel: {msg}")


def rank_pad(r: int) -> int:
    """The rank the kernel computes rank ``r`` in (the rest zero-filled)."""
    _check(1 <= r <= MAX_RANK, f"rank {r} not in [1, {MAX_RANK}]")
    return next(p for p in RANK_PADS if p >= r)


def route(din: int, dout: int, dtype) -> str:
    """``"wgmma"`` for bf16 whose din and dout are multiples of 8 (TMA's
    strides are multiples of 16 bytes); ``"wmma"`` for other bf16 shapes;
    ``"fp32"`` for float32 (CUDA cores, the parity checks' route)."""
    if dtype == torch.float32:
        return "fp32"
    return "wgmma" if din % 8 == 0 and dout % 8 == 0 else "wmma"


def _fixed_bytes(bn: int, rp: int) -> int:
    """Shared memory beside the ring: the tile's s·B rows, the output's
    staging panels (two warpgroups × 64 rows × min(bn, 128) columns), the
    mbarriers and 1 KB of alignment slack."""
    return 2 * bn * rp + 2 * 64 * min(bn, 128) * 2 + 2 * MAX_STAGES * 8 + 1024


def stages(bn: int, rp: int) -> int:
    """Pipeline stages of the wgmma route: as many as fit beside the fixed
    buffers, at most four."""
    stage = 2 * (TILE_M * TILE_K + TILE_K * bn + rp * TILE_K)
    return min(MAX_STAGES, (SMEM_LIMIT - _fixed_bytes(bn, rp)) // stage)


def smem_bytes(bn: int, rp: int) -> int:
    """Dynamic shared memory of one wgmma block: the ring of x, W and A
    stages and the fixed buffers."""
    stage = 2 * (TILE_M * TILE_K + TILE_K * bn + rp * TILE_K)
    return stages(bn, rp) * stage + _fixed_bytes(bn, rp)


def tile_widths(rp: int):
    """The output tile widths a padded rank allows.  A consumer thread holds
    bn/2 + rp/2 fp32 accumulators within the 168 registers a thread of 384
    has: at 256 columns that spills from rank 32 on (216 bytes, and 58 µs
    against 40 at 128 columns, M 2048; H100 80GB HBM3, 700 W), so only
    ranks up to 16 take 256 columns."""
    return TILE_NS if rp <= 16 else TILE_NS[1:]


def tile_n(M: int, dout: int, rp: int, sms: int, clients: int = 1) -> int:
    """The output tile width for this shape: the widest whose tiles (over
    all ``clients``) keep at least ``WAVE_FILL`` of the SMs busy over whole
    waves (tiles / (waves × SMs)), else the one that keeps the most busy.
    At rank 16, M 2048 × 2048 takes 256 (128 tiles, one wave), M 8192 ×
    2048 256 (512 tiles, 3.9 waves), M 2048 × 512 64 (128 tiles); four
    clients of M 2048 × 256 take 128 (128 tiles)."""
    best, best_fill = None, -1.0
    tm = -(-M // TILE_M)
    for bn in tile_widths(rp):
        tiles = clients * tm * -(-dout // bn)
        fill = tiles / (-(-tiles // sms) * sms)
        if fill >= WAVE_FILL:
            return bn
        if fill > best_fill:
            best, best_fill = bn, fill
    return best


def plan(M: int, din: int, dout: int, r: int, dtype, sms: int,
         clients: int = 1) -> dict:
    """The launch: route, and for ``"wgmma"`` the tile width ``bn``, the
    number of output tiles of all ``clients`` (M rows each) and the
    persistent grid (one block per SM, at most one per tile)."""
    rp = rank_pad(r)
    how = route(din, dout, dtype)
    if how != "wgmma":
        return {"route": how, "bn": 0, "grid": 0}
    bn = tile_n(M, dout, rp, sms, clients)
    tiles = clients * -(-M // TILE_M) * -(-dout // bn)
    return {"route": how, "bn": bn, "grid": min(tiles, sms), "tiles": tiles,
            "stages": stages(bn, rp)}


def tile_origin(t: int, tm: int, tn: int, bn: int):
    """(first row, first column) of output tile ``t`` in the grouped raster
    the kernel walks: ``GROUP_M`` tile rows at a time, column by column."""
    per_group = GROUP_M * tn
    first = t // per_group * GROUP_M
    rows = min(tm - first, GROUP_M)
    i = t % per_group
    return (first + i % rows) * TILE_M, (i // rows) * bn


def tile_of(t: int, tm: int, tn: int, bn: int):
    """(client, first row, first column) of tile ``t`` of a cohort: the
    tiles walk client-major, each client's in its own grouped raster, so
    no tile holds rows of two clients."""
    c, i = divmod(t, tm * tn)
    return (c,) + tile_origin(i, tm, tn, bn)


def cohort_schedule(clients: int, M: int, dout: int, bn: int, grid: int):
    """The (client, row, column) tiles each block of the persistent grid
    computes, in order: block ``g`` takes tiles ``g, g + grid, ...`` of all
    ``clients`` × the per-client tiles."""
    tm, tn = -(-M // TILE_M), -(-dout // bn)
    return [[tile_of(t, tm, tn, bn) for t in range(g, clients * tm * tn, grid)]
            for g in range(grid)]


def schedule(M: int, dout: int, bn: int, grid: int):
    """One client's :func:`cohort_schedule`, as (row, column) origins."""
    return [[(m, n) for _, m, n in share]
            for share in cohort_schedule(1, M, dout, bn, grid)]


def lora_matmul_cuda(x, w, a, b_scaled) -> torch.Tensor:
    """x (M, din), w (din, dout), a (r, din), b_scaled (dout, r), one dtype,
    on one CUDA device; returns ``x w + bf16(x aᵀ) b_scaledᵀ`` (M, dout).
    With a leading client axis on x, a and b_scaled ((C, M, din), (C, r,
    din), (C, dout, r); w shared) returns (C, M, dout) from one launch."""
    nd = x.dim()
    _check(nd in (2, 3) and w.dim() == 2 and a.dim() == nd
           and b_scaled.dim() == nd,
           f"shapes x{tuple(x.shape)} w{tuple(w.shape)} a{tuple(a.shape)} "
           f"b{tuple(b_scaled.shape)}")
    C = x.shape[0] if nd == 3 else 1
    M, din = x.shape[-2:]
    dout = w.shape[1]
    r = a.shape[-2]
    lead = (C,) if nd == 3 else ()
    _check(w.shape[0] == din and tuple(a.shape) == lead + (r, din)
           and tuple(b_scaled.shape) == lead + (dout, r) and C <= 65535,
           f"x{tuple(x.shape)} w{tuple(w.shape)} a{tuple(a.shape)} "
           f"b{tuple(b_scaled.shape)} do not match")
    rank_pad(r)
    _check(x.dtype in _CODES and all(t.dtype == x.dtype for t in (w, a, b_scaled)),
           f"dtypes x {x.dtype}, w {w.dtype}, a {a.dtype}, b {b_scaled.dtype}")
    dev = x.device
    _check(dev.type == "cuda" and all(t.device == dev for t in (w, a, b_scaled)),
           "every tensor must be on the same CUDA device")
    _check(all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, w, a, b_scaled)),
           "tensors must be contiguous and 16-byte aligned")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = plan(M, din, dout, r, x.dtype, sms, C)
    y = torch.empty(lead + (M, dout), dtype=x.dtype, device=dev)
    err = build.load("lora_matmul").lora_matmul_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b_scaled.data_ptr(),
        y.data_ptr(), _CODES[x.dtype], C, M, din, dout, r, p["bn"], p["grid"],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lora_matmul kernel launch failed: error {err}")
    return y
