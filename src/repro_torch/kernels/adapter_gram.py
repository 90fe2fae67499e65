"""Launch of the batched Gram CUDA kernel (``csrc/adapter_gram.cu``), the
Hopper counterpart of ``repro.kernels.adapter_gram.adapter_gram_kernel``.

m is split into panels so that enough blocks fill the card; the wrapper
picks the panel height and allocates the fp32 partials the kernel's
second, fixed-order summing step reads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

TILE = 64                 # output tile edge (kTile in the source)
ROWS = 32                 # rows per staged slice (kRows)
TARGET_BLOCKS = 2 * 132   # two blocks for each of the H100's SMs


def panels(G: int, m: int, r: int):
    """(panel_rows, n_panels): panels of a multiple of 32 rows, at least
    enough of them for TARGET_BLOCKS blocks of 64 × 64 output tiles (or
    one panel per 32 rows when m is too short for that)."""
    tiles = (-(-r // TILE)) ** 2
    slices = -(-m // ROWS)
    want = max(1, min(slices, -(-TARGET_BLOCKS // (G * tiles))))
    panel_rows = (slices // want) * ROWS
    return panel_rows, -(-m // panel_rows)


def adapter_gram_cuda(x) -> torch.Tensor:
    """x (G, m, r) fp32 on a CUDA device; returns xᵀx per batch entry,
    (G, r, r) fp32, in one call."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"adapter_gram kernel: expected (G, m, r) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("adapter_gram kernel: x must be a contiguous CUDA tensor")
    G, m, r = x.shape
    panel_rows, n_panels = panels(G, m, r)
    out = torch.empty((G, r, r), dtype=torch.float32, device=x.device)
    part = (torch.empty((G, n_panels, r, r), dtype=torch.float32, device=x.device)
            if n_panels > 1 else None)
    err = build.load("adapter_gram").adapter_gram_launch(
        x.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
        G, m, r, panel_rows, n_panels, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adapter_gram kernel launch failed: error {err}")
    return out
