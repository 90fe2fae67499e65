"""Shared topology layer (port of ``repro.topology``): meshes on
``torch.distributed`` and the partition rules.

* :mod:`repro_torch.topology.mesh`: :class:`Mesh`, the production / host /
  serve / fed mesh builders, axis helpers, :func:`spawn` (a local world
  of ranks) and :func:`run_world` (a launcher's spawn-or-run);
* :mod:`repro_torch.topology.partitioning`: the training-side spec rules,
  ``CACHE_LEAF_RANKS``, and :func:`shard` / :func:`gather` (a rank's slices
  of a tree, and back);
* :mod:`repro_torch.topology.serve`: head-sharded ring caches, per-slot
  state and the paged adapter pools;
* :mod:`repro_torch.topology.fed`: client-parallel cohort layouts.

``repro_torch.launch.mesh`` and ``repro_torch.launch.sharding`` remain as
deprecated re-export shims.
"""
from repro_torch.topology.fed import fed_client_pspecs, fed_pspecs
from repro_torch.topology.mesh import (Mesh, abstract_mesh, axis_size,
                                       data_axes, make_fed_mesh,
                                       make_host_mesh, make_production_mesh,
                                       make_serve_mesh, rank0_print,
                                       run_world, spawn, under_torchrun,
                                       world)
from repro_torch.topology.partitioning import (CACHE_LEAF_RANKS,
                                               ZERO3_THRESHOLD, batch_pspecs,
                                               cache_pspecs, gather,
                                               param_pspec, params_pspecs,
                                               replicated_pspecs, shard)
from repro_torch.topology.serve import (serve_adapter_pspecs,
                                        serve_cache_pspecs, serve_pspecs,
                                        serve_state_pspecs)

__all__ = [
    "CACHE_LEAF_RANKS", "ZERO3_THRESHOLD", "Mesh", "abstract_mesh",
    "axis_size", "batch_pspecs", "cache_pspecs", "data_axes",
    "fed_client_pspecs", "fed_pspecs", "gather", "make_fed_mesh",
    "make_host_mesh", "make_production_mesh", "make_serve_mesh",
    "param_pspec", "params_pspecs", "replicated_pspecs",
    "serve_adapter_pspecs", "serve_cache_pspecs", "serve_pspecs",
    "serve_state_pspecs", "shard", "spawn", "run_world", "rank0_print",
    "under_torchrun", "world",
]
