"""Launch of the batched Gram CUDA kernel (``csrc/adapter_gram.cu``), the
Hopper counterpart of ``repro.kernels.adapter_gram.adapter_gram_kernel``.

One call is one launch.  The kernel takes a stack in either of two
layouts: ``"col"``, x (G, K, r) row-major, giving xᵀx, and ``"row"``, the
stored (G, r, K) tensor of a wide stack, giving x xᵀ, so a transposed view
is read where it lies.  :func:`plan` is the launch arithmetic the source
repeats: output tiles of 32, 64 or 128 columns (only ti ≤ tj), K cut into
slices of 64 rows (128 with tiles of 32 columns), split across the
``cluster`` blocks of a thread-block cluster (of any size up to 8), whose
tiles are summed in rank order in distributed shared memory.
:func:`gram_3xtf32_plain` is the kernel's arithmetic in plain PyTorch, for
the tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

WARPS = 16                 # warps a block (kWarps in the source); one block an SM
MAX_CLUSTER = 8            # blocks of a cluster at most (portable size)
# Clusters of 1..8 blocks the H100 (80GB HBM3, 132 SMs) holds at once at
# one block an SM (cudaOccupancyMaxActiveClusters, scripts/gram_cutouts.py):
# its SMs sit in GPCs of uneven size, so clusters of 4 use only 120 of them
CLUSTERS_HELD = (132, 66, 39, 30, 22, 17, 15, 15)
SMEM_LIMIT = 232_448       # dynamic shared memory a block may use on sm_90
LAYOUTS = ("col", "row")
STAGES = {32: 4, 64: 8, 128: 3}   # cp.async ring depth by tile (Cfg in the source)


class Plan(NamedTuple):
    route: str        # "mma": 3xTF32 on mma.sync m16n8k8
    tile: int         # output tile edge: 32, 64 or 128 columns
    strips: int       # ceil(r / tile)
    tiles: int        # tiles with ti <= tj: strips (strips + 1) / 2
    cluster: int      # blocks that split K and sum their tiles (S)
    rows: int         # rows of K a slice (a stage of the ring)
    per: int          # K slices a block
    rows_per_block: int
    stages: int       # cp.async ring depth
    smem: int         # dynamic shared bytes of a block
    grid: tuple       # (cluster · tiles, G)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"adapter_gram kernel: {msg}")


def tile_for(r: int) -> int:
    """One diagonal tile of 32 or 64 columns up to r 64, else tiles of 128."""
    return 32 if r <= 32 else 64 if r <= 64 else 128


def slice_rows(tile: int) -> int:
    """Rows of K a stage holds: 64, or 128 with tiles of 32 columns (whose
    16 warps on K need 16 k-steps a stage)."""
    return 128 if tile == 32 else 64


def smem_bytes(tile: int, layout: str, strips: int) -> int:
    """Shared memory of a block (``adapter_gram_smem_bytes`` in the
    source): the ring of ``STAGES[tile]`` stages of one strip (diagonal
    tiles only) or two, each strip ``rows`` rows of ``tile`` columns padded by 8
    floats (col) or ``tile`` rows of ``rows`` padded by 4 (row); the
    reduction tile (tile × (tile + 4) floats) and the exchange's sums (up to
    tile × (tile + 1)) are aliased onto the ring; with tiles of up to 64
    columns the warps' partial tiles (one a warp on K) sit before red."""
    stages = STAGES[tile]
    rows = slice_rows(tile)
    strip = rows * (tile + 8) if layout == "col" else tile * (rows + 4)
    tiles = 2 * WARPS * 16 // tile + 1 if tile <= 64 else 1   # partials, then red
    return 4 * max(stages * strips * strip, tiles * tile * (tile + 4) + tile * (tile + 1))


@functools.lru_cache(maxsize=512)
def plan(G: int, m: int, r: int, layout: str = "col") -> Plan:
    """The launch for G stacks of K = m rows and r columns in ``layout``.
    The cluster is the largest size up to 8 whose G · tiles clusters the
    card holds at once (``CLUSTERS_HELD``: one wave) and whose blocks all
    get K slices; block q of a cluster sums slices [q · per, (q + 1) · per).
    At the round's shapes (G · tiles = 32) that is 3: 96 SMs busy.  Raises
    ``ValueError`` only for shapes the kernel cannot run."""
    _check(layout in LAYOUTS, f"layout {layout!r}; the kernel takes {LAYOUTS}")
    _check(G >= 1 and m >= 1 and r >= 1, f"empty stack (G {G}, K {m}, r {r})")
    _check(G <= 65535, f"G {G} stacks; a launch takes at most 65535")
    tile = tile_for(r)
    strips = -(-r // tile)
    tiles = strips * (strips + 1) // 2
    rows = slice_rows(tile)
    slices = -(-m // rows)
    cluster = 1
    for s in range(2, min(MAX_CLUSTER, slices) + 1):
        if G * tiles <= CLUSTERS_HELD[s - 1] and (s - 1) * -(-slices // s) < slices:
            cluster = s
    per = -(-slices // cluster)
    smem = smem_bytes(tile, layout, 2 if strips > 1 else 1)
    return Plan("mma", tile, strips, tiles, cluster, rows, per, per * rows,
                STAGES[tile], smem, (cluster * tiles, G))


def tile_coords(p: Plan, t: int):
    """(ti, tj) of tile ``t`` of a plan: rows of the upper triangle in
    order, as the source walks them."""
    ti, tj = 0, t
    while tj >= p.strips - ti:
        tj -= p.strips - ti
        ti += 1
    return ti, ti + tj


def block_rows(p: Plan, m: int, q: int):
    """``[k0, k1)``: the rows of K block ``q`` of a cluster sums (empty
    past the last slice)."""
    k0 = min(m, q * p.rows_per_block)
    return k0, min(m, k0 + p.rows_per_block)


def operand(x: torch.Tensor):
    """(stored tensor, layout) for a (G, K, r) stack: x itself when it is
    contiguous ("col"); the stored (G, r, K) tensor when x is its
    transposed view ("row", no copy); else a contiguous copy ("col")."""
    if x.is_contiguous():
        return x, "col"
    if x.mT.is_contiguous():
        return x.mT, "row"
    return x.contiguous(), "col"


def compiled_smem_bytes(tile: int, layout: str, strips: int) -> int:
    """The built kernel's own shared-memory size (needs the CUDA build),
    against which :func:`smem_bytes` is checked on the card."""
    fn = build.load("adapter_gram").adapter_gram_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_long
    return int(fn(tile, LAYOUTS.index(layout), strips))


def adapter_gram_cuda(x: torch.Tensor, layout: str = "col") -> torch.Tensor:
    """x fp32 on a CUDA device, contiguous: (G, K, r) for ``"col"``
    (returns xᵀx) or (G, r, K) for ``"row"`` (returns x xᵀ); (G, r, r)
    fp32, in one launch."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"adapter_gram kernel: expected a 3-d float32 stack, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("adapter_gram kernel: x must be a contiguous CUDA tensor")
    G = x.shape[0]
    K, r = (x.shape[1], x.shape[2]) if layout == "col" else (x.shape[2], x.shape[1])
    p = plan(G, K, r, layout)
    out = torch.empty((G, r, r), dtype=torch.float32, device=x.device)
    err = build.load("adapter_gram").adapter_gram_launch(
        x.data_ptr(), out.data_ptr(), G, K, r, LAYOUTS.index(layout), p.tile,
        p.cluster, p.per, p.smem, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adapter_gram kernel launch failed: error {err}")
    return out


def _split(v: torch.Tensor):
    """x = hi + lo as the kernel splits it: hi = x read as tf32 (the top 19
    bits), lo = x − hi exact in fp32, read as tf32 in turn."""
    def tf32(t):
        return (t.view(torch.int32) & -8192).view(torch.float32)   # 0xffffe000
    hi = tf32(v)
    return hi, tf32(v - hi)


def gram_3xtf32_plain(x: torch.Tensor, layout: str = "col") -> torch.Tensor:
    """The kernel's arithmetic in plain fp32 PyTorch, for the tests: every
    product hi·hi + hi·lo + lo·hi of the 3xTF32 split (lo·lo dropped); per
    block, its warps' partial sums over their k-steps added in warp order;
    the cluster's block tiles added in rank order; the upper triangle
    mirrored.  x and the result as :func:`adapter_gram_cuda`."""
    X = x.float() if layout == "col" else x.float().mT          # (G, K, r)
    G, K, r = X.shape
    p = plan(G, K, r, layout)
    kw = 2 * WARPS * 16 // p.tile          # warps of a diagonal tile on K
    hi, lo = _split(X)

    def prod(rows):                                           # one slab's terms
        h, l = hi[:, rows], lo[:, rows]
        return h.mT @ l + l.mT @ h + h.mT @ h

    out = torch.zeros((G, r, r), dtype=torch.float32, device=X.device)
    for q in range(p.cluster):
        k0, k1 = block_rows(p, K, q)
        tile = torch.zeros_like(out)
        for w in range(kw):                                   # warp order
            steps = [k for k in range(k0, k1, 8) if (k // 8) % kw == w]
            rows = [k + i for k in steps for i in range(8) if k + i < K]
            if rows:
                tile = tile + prod(rows)
        out = out + tile                                      # rank order
    up = torch.triu(out)
    return up + torch.triu(out, 1).mT
