"""Federated-side partition specs (port of ``repro.topology.fed``):
client-parallel cohort layouts.

The sharded cohort runner stacks equal-(rank, steps) clients along a
leading client axis (adapters ``(C, L, r, d)``, optimizer state, batch
schedules ``(C, steps, B, T)``).  On a fed mesh ``(data=N, model=1)`` that
axis shards over ``data``: each rank trains ``C/N`` clients and the only
collective is the gather of the cohort's results.  Base params replicate.
Every rule degrades to replicated where the client axis does not divide
``data`` (the runner pads cohorts to a multiple of it).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.common.config import ModelConfig
from repro_torch.topology.mesh import data_axes
from repro_torch.topology.partitioning import _fits, params_pspecs, tree_map


def _client_axis(mesh):
    dax = data_axes(mesh)
    return dax if len(dax) > 1 else dax[0]


def fed_client_pspecs(mesh, tree: Optional[Any] = None) -> Any:
    """Specs for a client-stacked tree (leading axis = cohort clients).
    With ``tree=None``: the single prefix spec ``(data,)``."""
    ax = _client_axis(mesh)
    if tree is None:
        return (ax,)

    def fix(leaf):
        if leaf.ndim == 0 or not _fits(mesh, leaf.shape[0], ax):
            return (None,) * leaf.ndim
        return (ax,) + (None,) * (leaf.ndim - 1)

    return tree_map(fix, tree)


def fed_pspecs(mesh, cfg: Optional[ModelConfig] = None,
               params: Optional[Any] = None, cohort: Optional[Any] = None,
               batch: Optional[Any] = None) -> Dict[str, Any]:
    """The spec bundle of one sharded cohort step: ``params`` replicated
    (prefix ``()``) unless a tree and config are given (then the training
    rules on the mesh's ``model`` axis, 1 on fed meshes); ``cohort`` and
    ``batch`` client axis over ``data``."""
    pspec = (params_pspecs(mesh, cfg, params)
             if cfg is not None and params is not None else ())
    return {
        "params": pspec,
        "cohort": fed_client_pspecs(mesh, cohort),
        "batch": fed_client_pspecs(mesh, batch),
    }
