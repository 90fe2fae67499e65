"""DEPRECATED re-export shim: partition rules live in
:mod:`repro_torch.topology.partitioning` (serving-side specs in
:mod:`repro_torch.topology.serve`).  Import from :mod:`repro_torch.topology`;
importing this module warns."""
import warnings

from repro_torch.topology.partitioning import (  # noqa: F401
    _COL_MODEL,
    _ROW_MODEL,
    CACHE_LEAF_RANKS,
    ZERO3_THRESHOLD,
    _fits,
    _sanitize,
    batch_pspecs,
    cache_pspecs,
    gather,
    param_pspec,
    params_pspecs,
    replicated_pspecs,
    shard,
)

warnings.warn(
    "repro_torch.launch.sharding is a deprecated shim; import from "
    "repro_torch.topology", DeprecationWarning, stacklevel=2)

__all__ = ["CACHE_LEAF_RANKS", "ZERO3_THRESHOLD", "batch_pspecs",
           "cache_pspecs", "gather", "param_pspec", "params_pspecs",
           "replicated_pspecs", "shard"]
