"""Ring-buffer masks for decode attention (port of the ring helpers of
``repro.models.attention_core``).

Slot ``s`` of a row's ring holds absolute position
``p_abs = last - (last - s) mod cap`` with ``last = pos - 1``.  The modulo is
a floor modulo: ``last - s`` is negative for slots never written
(``pos = 0``) and for slots ahead of the write head, and ``torch.remainder``
(like ``jnp.mod``) returns a value in ``[0, cap)`` for those, where
``torch.fmod`` and C's ``%`` would not.
"""
from __future__ import annotations

import torch


def ring_slot_positions(pos: torch.Tensor, length: torch.Tensor, cap: int):
    """pos/length: (B,) ring state AFTER the current write.  Returns
    (p_abs, resident), both (B, cap)."""
    s = torch.arange(cap, device=pos.device)[None, :]
    last = pos[:, None].long() - 1
    p_abs = last - torch.remainder(last - s, cap)
    resident = p_abs >= (pos - length).long()[:, None]
    return p_abs, resident


def ring_attend_mask(pos: torch.Tensor, length: torch.Tensor, cap: int,
                     qpos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """(B, C, cap) bool: row ``b``'s query ``t`` (absolute position
    ``qpos[b, t]``) attends slot ``s`` iff the slot is resident, causally
    visible and inside the sliding window when one is set."""
    p_abs, resident = ring_slot_positions(pos, length, cap)
    q = qpos.long()[:, :, None]
    m = resident[:, None, :] & (p_abs[:, None, :] <= q)
    if window:
        m &= p_abs[:, None, :] > (q - window)
    return m


def ring_block_mask(pos: torch.Tensor, length: torch.Tensor,
                    n_tokens: torch.Tensor, cap: int, start: int, bk: int,
                    C: int, window: int = 0) -> torch.Tensor:
    """(B, C, bk) mask for the slots ``[start, start + bk)`` — the per-tile
    form the CUDA kernel computes; slots ``>= cap`` are masked out, and query
    positions are ``qpos = pos - n_tokens + t``."""
    dev = pos.device
    s = start + torch.arange(bk, device=dev)[None, :]
    last = pos.long()[:, None] - 1
    p_abs = last - torch.remainder(last - s, cap)
    resident = (p_abs >= (pos - length).long()[:, None]) & (s < cap)
    qpos = ((pos - n_tokens).long()[:, None]
            + torch.arange(C, device=dev)[None, :])
    m = resident[:, None, :] & (p_abs[:, None, :] <= qpos[:, :, None])
    if window:
        m &= p_abs[:, None, :] > (qpos[:, :, None] - window)
    return m
