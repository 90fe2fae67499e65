"""Carry state across from numpy trees (for example a reference model's
``jax.device_get`` output) into the port's tensors.

The port keeps the reference's tree layout — the same keys, the ``blocks``
tuple, stacked ``(L, ...)`` leaves, per-layer adapter ``scale`` — so every
conversion here is a copy without renames.  bfloat16 arrays (numpy's
``ml_dtypes.bfloat16``) are carried bit for bit.  A MoE segment's leaves
cross the same way: the fp32 router ``(L, d, E)``, the stacked experts
``(L, E, d, e_ff)`` / ``(L, E, e_ff, d)`` in the model dtype and
DeepSeek-V3's shared expert; so do the zero-size ``(0, ...)`` leaves of a
MoE segment with no layers (DeepSeek-V3 cut to its dense layers), so the
port's tree keeps the reference's structure.
Mixed dtypes cross as they are: RWKV6's fp32 ``w0`` and ``u`` beside its
bf16 weights, its ``(5, d)`` and ``(5, dl, d)`` mixing leaves included;
so do the Mamba2 segments' fp32 ``A_log``, ``D`` and ``dt_bias`` beside
their bf16 ``in_proj``, ``conv_w``, ``conv_b``, ``norm`` and ``out_proj``.
The Zamba2 hybrid's ``shared_blk`` crosses unstacked (one attention and
MLP block, 2-D weights; its adapters 2-D leaves with a scalar ``scale``),
and a front end's ``frontend_proj`` (frontend_dim, d) as any weight.

A reference ``FederatedTrainer``'s state crosses the same way: its
``params`` through :func:`params_from_numpy` and its shared ``A_init_full``
(an adapter tree) through :func:`adapters_from_numpy`, assigned to the
port trainer's attributes of the same names before its first round.  A
reference ``Trainer``'s ``params`` cross the same way, and its ``adapters``
and ``opt_state`` (AdamW's ``mu``/``nu`` trees and its ``step``) through
:func:`adapters_from_numpy`, assigned to the port ``Trainer``'s attributes
of the same names before its first step.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.adapters import AdapterRegistry


def tensor_from_numpy(arr: Any, device: DeviceLike = None) -> torch.Tensor:
    dev = resolve_device(device)
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _tree(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Dict:
    """A reference ``T.init`` tree (numpy leaves) as the port's params."""
    return _tree(tree, resolve_device(device))


def adapters_from_numpy(tree: Any, device: DeviceLike = None) -> Dict:
    """A reference adapter tree (``init_lora`` / ``global_adapters``, numpy
    leaves) as the port's adapter tree."""
    return _tree(tree, resolve_device(device))


def registry_state_from_numpy(registry: AdapterRegistry,
                              state: Dict[str, Any]) -> None:
    """Overwrite ``registry``'s pools, page table and rank table with a
    reference registry's ``device_state`` (numpy leaves), so the port's
    registry mirrors it exactly.  The shapes must match (same template and
    registry sizes); the host bookkeeping (names, free pages) stays the
    caller's: mirror the same register/swap/evict calls."""
    dev = registry.device
    ours = registry.device_state

    def copy(dst: Any, src: Any) -> None:
        if isinstance(dst, dict):
            if set(dst) != set(src):
                raise ValueError(f"tree keys differ: {sorted(dst)} vs "
                                 f"{sorted(src)}")
            for k in dst:
                copy(dst[k], src[k])
            return
        t = tensor_from_numpy(src, dev)
        if t.shape != dst.shape:
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(dst.shape)}")
        dst.copy_(t)

    copy(ours, state)
