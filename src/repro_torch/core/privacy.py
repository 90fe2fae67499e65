"""Differential privacy for client updates (port of
``repro.core.privacy``).

The standard client-level mechanisms:

  1. clip each client's adapter update (the delta from the round's init,
     flattened over the whole tree) to L2 norm ≤ C;
  2. **local** (DP on the wire, the runtime's route): add Gaussian noise
     N(0, σ²C²) to each clipped update before it leaves the client — the
     transport's DP stage (:mod:`repro_torch.core.runtime.transport`), so
     the server and the wire only see privatized bytes;
  3. **central**: add N(0, σ²C²/K) to the aggregated update server-side
     (sensitivity C/K under mean aggregation).

Noise comes from an explicit ``torch.Generator`` on the update's device,
seeded by :func:`noise_seed` from ``(dp_seed, round, client)``; leaves draw
from it one after another in sorted-key order.  This stream is torch's
(Philox on CUDA, MT19937 on the CPU), **not** ``jax.random``'s: the port's
noise has the reference's distribution and keying, not its values.
Scalars and per-layer vectors (``scale``) are never noised.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import tree_leaves, tree_map


def noise_seed(dp_seed: int, rnd: int, client_id: int) -> int:
    """The 64-bit generator seed of one upload's noise: a numpy
    ``SeedSequence`` over ``(dp_seed, round, client)``, so no two uploads
    of a run share a stream."""
    return int(np.random.SeedSequence(
        [int(dp_seed), int(rnd), int(client_id)]).generate_state(1, np.uint64)[0])


def noise_generator(dp_seed: int, rnd: int, client_id: int,
                    device: Any) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(
        noise_seed(dp_seed, rnd, client_id))


def global_l2(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def tree_sub(a: Any, b: Any) -> Any:
    return tree_map(lambda x, y: x.float() - y.float(), a, b)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(lambda x, y: (x.float() + y.float()).to(x.dtype), a, b)


def clip_update(update: Any, clip_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale the whole update tree so its global L2 ≤ clip_norm."""
    n = global_l2(update)
    scale = torch.clamp(clip_norm / torch.clamp(n, min=1e-12), max=1.0)
    return tree_map(lambda l: (l * scale).to(l.dtype), update), n


def clip_client_adapters(adapters: Any, init_adapters: Any,
                         clip_norm: float) -> Any:
    """Clip the *delta* from the round's starting adapters, re-anchor."""
    clipped, _ = clip_update(tree_sub(adapters, init_adapters), clip_norm)
    return tree_add(init_adapters, clipped)


def _noised(tree: Any, std: float, generator: torch.Generator) -> Any:
    """Leaves of ≥ 2 dims plus ``std`` · N(0, 1), drawn in sorted-key order
    (scalars and ``scale`` vectors pass through)."""
    if isinstance(tree, dict):
        return {k: _noised(tree[k], std, generator) for k in sorted(tree)}
    if tree.dim() < 2:
        return tree
    z = torch.randn(tree.shape, generator=generator, device=tree.device,
                    dtype=torch.float32)
    return (tree + std * z).to(tree.dtype)


def add_gaussian_noise(tree: Any, sigma: float, clip_norm: float,
                       num_clients: int, generator: torch.Generator) -> Any:
    """Server-side Gaussian mechanism: noise std = σ·C / K per coordinate
    (client-level DP with sensitivity C/K under mean aggregation)."""
    return _noised(tree, sigma * clip_norm / max(num_clients, 1), generator)


def local_gaussian_noise(tree: Any, sigma: float, clip_norm: float,
                         generator: torch.Generator) -> Any:
    """Client-side (local) Gaussian mechanism: noise std = σ·C per
    coordinate, applied to one clipped update before upload."""
    return _noised(tree, sigma * clip_norm, generator)


def noise_multiplier_for_epsilon(epsilon: float, delta: float = 1e-5) -> float:
    """Classical Gaussian-mechanism calibration for one release:
    σ ≥ sqrt(2 ln(1.25/δ)) / ε (composition is left to an accountant)."""
    return math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon
