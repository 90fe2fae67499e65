"""Communication / computation cost accounting (port of
``repro.core.costs``; paper Tables 3–6).

Parameter counts are exact (from the adapter trees and the recorded
per-layer ranks); MB figures use FP16 as in the paper (§F.2: cost(MB) =
params × 2 / 1024²).  ``efficiency`` is the paper's proxy 1 / total
download rank.  Server FLOPs are analytic (mult-add = 2 FLOPs).  The
per-method formulas live on the registered aggregator classes; these
functions keep the ``f(method, ...)`` call shape.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.core.aggregators import AggResult, get_aggregator_class

BYTES_FP16 = 2

SVD_CONST = 4  # FLOPs ≈ SVD_CONST · m · n · min(m,n) for dense SVD


def _cost_model(method: str):
    """An instance of ``method``'s class for its state-free cost methods,
    built without running its constructor."""
    cls = get_aggregator_class(method)
    return cls.__new__(cls)


# ---------------------------------------------------------------------------
# communication
# ---------------------------------------------------------------------------

def upload_params(method: str, client_trees: Sequence[Dict]) -> int:
    """Total parameters uploaded by the sampled clients this round."""
    return _cost_model(method).upload_params(client_trees)


def download_params(method: str, agg: AggResult, dims: Dict,
                    num_clients: int, client_ranks: Sequence[int]) -> int:
    """Total parameters sent server -> clients this round."""
    return _cost_model(method).download_params(agg, dims, num_clients,
                                               client_ranks)


def total_download_rank(agg: AggResult, half_for_ffa: bool = True) -> float:
    """The paper's efficiency denominator: Σ over layers of the broadcast
    rank, weighted by the method's ``download_rank_factor`` (FFA counts
    rank/2 — only one of the two matrices travels)."""
    factor = get_aggregator_class(agg.method).download_rank_factor \
        if half_for_ffa else 1.0
    return float(agg.total_download_rank()) * factor


def efficiency(agg: AggResult, client_ranks: Sequence[int] = (),
               dims: Dict = None) -> float:
    """1 / total_download_rank (paper §4, 'communication efficiency'); the
    denominator is the per-client downloaded rank summed over all LoRA'd
    matrices (FedIT on TinyLlama: 22 layers × 2 proj × rank 16 = 704).
    FlexLoRA sends each client its own rank-r_k adapters → mean over
    clients."""
    return _cost_model(agg.method).efficiency(agg, client_ranks, dims)


def mb(params: int) -> float:
    return params * BYTES_FP16 / (1024 ** 2)


def wire_mb(num_bytes: int) -> float:
    """MB of a measured serialized payload."""
    return num_bytes / (1024 ** 2)


def wire_upload_bytes(method: str, client_trees: Sequence[Dict],
                      codec: str = "bf16") -> int:
    """Measured serialized uplink bytes of the sampled client trees — with
    the ``bf16`` codec exactly ``BYTES_FP16 × upload_params``."""
    from repro_torch.core.runtime.transport import AdapterPayload, make_codec
    model, c = _cost_model(method), make_codec(codec)
    return sum(AdapterPayload.pack(t, c, model.wire_arrays).num_bytes
               for t in client_trees)


def wire_download_bytes(method: str, agg: AggResult, num_clients: int,
                        codec: str = "bf16") -> int:
    """Measured serialized downlink bytes of one round's result (per-layer
    ranks honoured: zero padding is never serialized)."""
    from repro_torch.core.runtime.transport import Transport, make_codec
    _, nbytes = Transport(make_codec(codec)).server_to_clients(
        agg, _cost_model(method), num_clients)
    return nbytes


def full_ft_params(model_param_count: int, num_clients: int) -> int:
    return model_param_count * num_clients


# ---------------------------------------------------------------------------
# server FLOPs (analytic; Table 4 / Table 5)
# ---------------------------------------------------------------------------

def server_flops(method: str, dims: Dict, client_ranks: Sequence[int],
                 agg_ranks: Dict[Tuple, List[int]] = None) -> int:
    """Analytic per-round server cost. mult-add = 2 FLOPs."""
    return _cost_model(method).server_flops(dims, client_ranks, agg_ranks)
