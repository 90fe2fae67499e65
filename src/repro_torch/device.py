"""Device resolution and the float32 parity mode.

Every entry point of the port takes an optional ``device``.  ``None`` means
``cuda``; a machine without CUDA then raises instead of running on the CPU,
so a measurement can never come from the wrong device by accident.  The
CPU runs only when the caller asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def parity_mode() -> str:
    """Turn TF32 off for float32 matmuls and convolutions.

    Hopper may run float32 products in TF32 (about three decimal digits);
    parity against a float32 reference needs full float32.  Returns a line
    stating the setting, for the caller to print beside its results.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ("parity mode: torch.backends.cuda.matmul.allow_tf32=False, "
            "torch.backends.cudnn.allow_tf32=False (full float32 products)")
