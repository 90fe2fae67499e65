"""Layer-sharded server aggregation (port of ``repro.core.distributed``).

The FLoRIST server pipeline is embarrassingly parallel over layers.  Here
the layer axis is split over a mesh's ``model`` axis: each rank runs the
padded FLoRIST core (:func:`repro_torch.core.svd.florist_core_batched`; on
the Gram route that is ``adapter_gram`` on its slice) on its own layers,
and one ``all_gather`` returns every layer's ``(B_g, A_g, spectra,
ranks)`` to every rank.  The layer axis is padded to a multiple of the
axis size; a padded layer's B stack gets the reference's ``1e-6`` bump so
no rank factors an all-zero matrix.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.aggregators.base import AggResult, register_aggregator
from repro_torch.core.aggregators.florist import FloristAggregator
from repro_torch.core.svd import (florist_core_batched,
                                  florist_core_delta_batched)

EYE_BUMP = 1e-6


def pad_layers(x: torch.Tensor, mult: int) -> Tuple[torch.Tensor, int]:
    """``x`` with its leading (layer) axis zero-padded to a multiple of
    ``mult``, and the original length."""
    L = x.shape[0]
    pad = (-L) % mult
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x, L


def _local_layers(mesh, x: torch.Tensor) -> torch.Tensor:
    n = mesh.axis_size("model")
    k = x.shape[0] // n
    i = mesh.axis_index("model")
    return x[i * k: (i + 1) * k]


def make_sharded_florist(mesh, tau, svd_method: str = "gram",
                         max_rank: int = 0):
    """``fn(B_stacks (L, m, r), A_stacks (L, r, n)) -> (B_g, A_g, spectra,
    ranks)`` with the layers split over ``mesh``'s ``model`` axis (padded
    to a multiple of it internally).  ``tau`` / ``max_rank`` as the host
    pipeline's (``tau="auto"`` and the cap included)."""
    n_shard = mesh.axis_size("model")

    def run(B_stacks, A_stacks):
        Bp, L = pad_layers(B_stacks, n_shard)
        Ap, _ = pad_layers(A_stacks, n_shard)
        Bp[L:] += EYE_BUMP                  # the padded layers only (or none)
        out = florist_core_batched(_local_layers(mesh, Bp),
                                   _local_layers(mesh, Ap), tau, svd_method,
                                   max_rank)
        return tuple(o[:L] for o in mesh.all_gather_packed(out, "model"))

    return run


def make_sharded_florist_delta(mesh, tau, svd_method: str = "gram",
                               max_rank: int = 0):
    """Layer-sharded delta-mode finalize: ``fn(M (L, m, n)) -> (B_g, A_g,
    spectra, ranks)``, the streaming server's dense intermediate."""
    n_shard = mesh.axis_size("model")

    def run(M):
        Mp, L = pad_layers(M, n_shard)
        Mp[L:] += EYE_BUMP
        out = florist_core_delta_batched(_local_layers(mesh, Mp), tau,
                                         svd_method, max_rank)
        return tuple(o[:L] for o in mesh.all_gather_packed(out, "model"))

    return run


@register_aggregator("florist_sharded")
class ShardedFloristAggregator(FloristAggregator):
    """FLoRIST with the finalize mapped onto a mesh's ``model`` axis.

    Streaming accumulation (``add_client``) is the ``florist`` strategy's,
    and runs identically on every rank of an SPMD trainer; ``finalize``
    runs the layer-sharded pipeline on each leaf instead of the bucketed
    batched call.  ``mesh=None`` takes every rank of the world as the
    ``model`` axis (a one-rank mesh without a process group), built at the
    first finalize on the device of the stacks."""

    def __init__(self, tau=0.9, svd_method: str = "gram", mesh=None,
                 max_rank: int = 0, stream: str = "auto",
                 flush_every: int = 64):
        self.mesh = mesh
        self._fn_cache: Dict = {}
        super().__init__(tau=tau, svd_method=svd_method, max_rank=max_rank,
                         stream=stream, flush_every=flush_every)

    def _mesh(self, device: torch.device):
        if self.mesh is None:
            from repro_torch.topology import make_serve_mesh
            self.mesh = make_serve_mesh(0, device=device)
        return self.mesh

    def _finalize(self) -> AggResult:
        inter = self._settle()
        if not self._fn_cache and inter:
            first = next(iter(inter.values()))[1]
            mesh = self._mesh(first.device)
            self._fn_cache["fn"] = make_sharded_florist(
                mesh, tau=self.tau, svd_method=self.svd_method,
                max_rank=self.max_rank)
            self._fn_cache["delta"] = make_sharded_florist_delta(
                mesh, tau=self.tau, svd_method=self.svd_method,
                max_rank=self.max_rank)
        device: Dict[Tuple, Tuple] = {}
        for path, v in inter.items():
            if v[0] == "stack":
                device[path] = self._fn_cache["fn"](v[1], v[2])
            else:
                device[path] = self._fn_cache["delta"](v[1])
        return self._materialize(device)

