"""Legacy one-shot aggregation entry point (port of
``repro.core.aggregation``, a compatibility shim).

Each method is a registered :class:`~repro_torch.core.aggregators.
Aggregator` with a streaming ``begin_round`` / ``add_client`` /
``finalize`` lifecycle; ``aggregate(method, clients, weights, **kw)`` builds
the strategy and streams the in-memory client list through it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.core.aggregators import (AggResult, METHODS, accepted_config,
                                          adapter_leaf_paths, get_path,
                                          make_aggregator, set_path)

__all__ = ["AggResult", "METHODS", "adapter_leaf_paths", "aggregate",
           "get_path", "set_path"]


def aggregate(method: str, clients: Sequence[Dict], weights: Sequence[float],
              *, tau: float = 0.9, A_init: Optional[Dict] = None,
              client_ranks: Optional[Sequence[int]] = None,
              zero_padding: bool = False, svd_method: str = "svd",
              max_rank: int = 0) -> AggResult:
    """One-shot aggregation: each method picks the knobs it understands
    from the shared keyword union (τ, the frozen FFA init, ...)."""
    cfg = accepted_config(method, dict(
        tau=tau, A_init=A_init, zero_padding=zero_padding,
        svd_method=svd_method, max_rank=max_rank))
    agg = make_aggregator(method, **cfg)
    return agg.aggregate(clients, weights, client_ranks=client_ranks)
