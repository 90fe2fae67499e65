"""Launch of the batched-gather LoRA delta CUDA kernel (``csrc/bgmv.cu``),
the Hopper counterpart of ``repro.kernels.bgmv.bgmv_kernel``.

The kernel reads each row's adapter id, its page-table row, rank and scale
itself, so one call is one launch.  :func:`plan` is the launch arithmetic
the source repeats: clusters of ``CLUSTER`` blocks share a row's z, each
block shrinks its chunks of din (:func:`din_chunks`) and expands its own
tile of output columns (:func:`column_tile`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_CODES = {torch.float32: 0, torch.bfloat16: 1}
CLUSTER = 8                # blocks that share a row's z (kCluster in the source)
TILE_MAX = 1024            # output columns a block expands at most
B_TILE_BUDGET = 64 * 1024  # shared bytes of a block's B tile
STAGE_BUDGET = 96 * 1024   # shared bytes of one din stage at most
BLOCK_BUDGET = 200 * 1024  # shared bytes the two stages and the rest may take
PAD = 16                   # bytes after each staged row (kPad)
SMEM_LIMIT = 232_448       # dynamic shared memory a block may use on sm_90


class Plan(NamedTuple):
    route: str       # "mma" (bf16 x on bf16 pages, C >= 8) or "fma"
    tile_n: int      # output columns a block expands
    clusters: int    # clusters a row runs; the grid is (CLUSTER·clusters, B)
    kc: int          # din elements a chunk
    nchunk: int      # chunks of din; block q of a cluster takes q, q + 8, ...
    c_pad: int       # rows of z: C padded to 16
    r_pad: int       # ranks of z: Pmax·pr padded to 8
    x_rows: int      # staged x rows: c_pad on route "mma", else C
    smem: int        # dynamic shared bytes of a block


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"bgmv kernel: {msg}")


MMA_MIN_ROWS = 8           # query rows from which bf16 shrinks on mma.sync


def route(x_dtype, p_dtype, C: int) -> str:
    """``"mma"``: bf16 x on bf16 pages with at least ``MMA_MIN_ROWS`` query
    rows shrinks on the bf16 tensor cores (its products are exact in fp32);
    ``"fma"``: every other case shrinks on the CUDA cores in fp32.  On the
    H100 the CUDA cores ran faster below 8 rows (a 16-row mma tile is
    mostly padding), the two bodies were within 5% of each other at 8 rows
    but for din ≥ 7168 (mma 11–13% faster), and mma ran up to 1.7× faster
    at 16 rows (``scripts/bgmv_variants.py``)."""
    if x_dtype == p_dtype == torch.bfloat16 and C >= MMA_MIN_ROWS:
        return "mma"
    return "fma"


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=512)
def plan(C: int, din: int, dout: int, pr: int, Pmax: int, x_dtype,
         p_dtype) -> Plan:
    """The launch layout for these shapes and dtypes.  Output tiles are
    multiples of 64 columns of at most ``TILE_MAX``, with the B tile (all
    ``Pmax·pr`` ranks of the tile's columns) within ``B_TILE_BUDGET``; a row
    runs as few clusters as cover dout at that width, its columns spread
    evenly over them.  din is cut into chunks of a multiple of 64 elements,
    as few a block as keep a stage (x rows and A rows) within
    ``STAGE_BUDGET`` and the block within ``BLOCK_BUDGET``, spread evenly
    over the cluster: at the main paths' shapes a block takes one or two
    chunks, so all its loads are in flight at once.  Raises
    ``ValueError`` when the layout does not fit a block's shared memory."""
    how = route(x_dtype, p_dtype, C)
    xe = torch.empty((), dtype=x_dtype).element_size()
    pe = torch.empty((), dtype=p_dtype).element_size()
    R = Pmax * pr
    c_pad, r_pad = _up(C, 16), _up(R, 8)
    x_rows = c_pad if how == "mma" else C
    tile_cap = max(64, min(TILE_MAX, B_TILE_BUDGET // (R * pe) // 64 * 64))
    clusters = -(-dout // (CLUSTER * tile_cap))
    tile_n = _up(-(-dout // (CLUSTER * clusters)), 64)
    rest = tile_n * R * pe + (CLUSTER + 1) * c_pad * r_pad * 4 + _up(4 * Pmax, 16)
    budget = min(STAGE_BUDGET, (BLOCK_BUDGET - rest) // 2)
    kc_cap = max(64, (budget - PAD * (x_rows + r_pad))
                 // (x_rows * xe + r_pad * pe) // 64 * 64)
    per_block = -(-din // CLUSTER)
    k = -(-per_block // kc_cap)
    kc = _up(-(-din // (CLUSTER * k)), 64)
    nchunk = -(-din // kc)
    stage = x_rows * (kc * xe + PAD) + r_pad * (kc * pe + PAD)
    smem = rest + 2 * stage
    _check(smem <= SMEM_LIMIT,
           f"C {C}, din {din}, rank {R} need {smem} bytes of shared memory "
           f"a block, over the {SMEM_LIMIT} a block may use")
    return Plan(how, tile_n, clusters, kc, nchunk, c_pad, r_pad, x_rows, smem)


def din_chunks(p: Plan, din: int, q: int):
    """The ``(d0, d1)`` ranges of din that block ``q`` of a cluster
    shrinks: chunks ``q, q + CLUSTER, ...``."""
    return [(j * p.kc, min(din, (j + 1) * p.kc))
            for j in range(q, p.nchunk, CLUSTER)]


def column_tile(p: Plan, dout: int, block: int):
    """The ``[col0, col1)`` output columns block ``block`` (grid x index)
    expands; empty past dout."""
    col0 = block * p.tile_n
    return col0, max(col0, min(dout, col0 + p.tile_n))


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
    _check(din % 8 == 0 and dout * pr % 8 == 0
           and all(t.data_ptr() % 16 == 0 for t in (x, a_pages, b_pages)),
           f"din {din} and dout·pr {dout * pr} must be multiples of 8 and "
           "x/a_pages/b_pages 16-byte aligned")
    table, rank, ids = (t.to(torch.int32).contiguous()
                        for t in (table, rank, ids))
    scale = scale.to(torch.float32).contiguous()
    Pmax = table.shape[1]
    p = plan(C, din, dout, pr, Pmax, x.dtype, a_pages.dtype)
    y = torch.empty((B, C, dout), dtype=torch.float32, device=dev)
    err = build.load("bgmv").bgmv_launch(
        x.data_ptr(), _CODES[x.dtype], a_pages.data_ptr(), b_pages.data_ptr(),
        _CODES[a_pages.dtype], table.data_ptr(), rank.data_ptr(),
        scale.data_ptr(), ids.data_ptr(), y.data_ptr(),
        B, C, din, dout, pr, Pmax, int(p.route == "mma"), p.tile_n, p.kc,
        p.nchunk, p.c_pad, p.r_pad, p.clusters, p.smem,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bgmv kernel launch failed: error {err}")
    return y
