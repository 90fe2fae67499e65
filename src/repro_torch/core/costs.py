"""Communication cost accounting (port of the parts of
``repro.core.costs`` the round and the quickstart use).

Parameter counts are exact (from the adapter trees and the recorded
per-layer ranks); MB figures use FP16 as in the paper (§F.2: cost(MB) =
params × 2 / 1024²).  The per-method formulas live on the registered
aggregator classes; these functions keep the ``f(method, ...)`` call shape.
"""
from __future__ import annotations

from typing import Dict, Sequence

from repro_torch.core.aggregators import AggResult, get_aggregator_class

BYTES_FP16 = 2

SVD_CONST = 4  # FLOPs ≈ SVD_CONST · m · n · min(m,n) for dense SVD


def _cost_model(method: str):
    """An instance of ``method``'s class for its state-free cost methods,
    built without running its constructor."""
    cls = get_aggregator_class(method)
    return cls.__new__(cls)


def upload_params(method: str, client_trees: Sequence[Dict]) -> int:
    """Total parameters uploaded by the sampled clients this round."""
    return _cost_model(method).upload_params(client_trees)


def download_params(method: str, agg: AggResult, dims: Dict,
                    num_clients: int, client_ranks: Sequence[int]) -> int:
    """Total parameters sent server -> clients this round."""
    return _cost_model(method).download_params(agg, dims, num_clients,
                                               client_ranks)


def mb(params: int) -> float:
    return params * BYTES_FP16 / (1024 ** 2)


def wire_mb(num_bytes: int) -> float:
    """MB of a measured serialized payload."""
    return num_bytes / (1024 ** 2)
