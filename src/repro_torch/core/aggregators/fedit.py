"""FedIT (port of ``repro.core.aggregators.fedit``): FedAvg of the A's and
the B's separately — mathematically inexact (cross terms).  Heterogeneous
ranks require HetLoRA zero-padding."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.aggregators.base import (AggResult, Aggregator,
                                               adapter_leaf_paths, fold_scale,
                                               get_path, leaf_rank,
                                               register_aggregator, set_path)


def pad_rank(A: torch.Tensor, B: torch.Tensor, R: int):
    """Zero-pad an (A, B) pair from its own rank up to R (no-op if equal):
    A's rank rows (axis -2) and B's rank columns (axis -1)."""
    r = A.shape[-2]
    if r < R:
        A, B = F.pad(A, (0, 0, 0, R - r)), F.pad(B, (0, R - r))
    return A, B


@register_aggregator("fedit")
class FedItAggregator(Aggregator):
    """Streaming FedAvg: one running weighted sum of (A, B) per leaf, grown
    to the largest rank seen so far — O(1) memory in the client count."""

    def __init__(self, zero_padding: bool = False):
        self.zero_padding = zero_padding
        super().__init__()

    def _reset(self) -> None:
        super()._reset()
        self._seen_ranks = set()

    def _accumulate(self, update: Dict, weight: float, rank: int) -> None:
        self._seen_ranks.add(leaf_rank(update))
        if len(self._seen_ranks) > 1 and not self.zero_padding:
            raise ValueError(
                "FedIT requires homogeneous ranks (or zero_padding=True)")
        for path in adapter_leaf_paths(update):
            Bk, Ak = fold_scale(get_path(update, path))
            acc = self._state.get(path)
            if acc is None:
                self._state[path] = {"A": weight * Ak, "B": weight * Bk}
                continue
            R = max(acc["A"].shape[-2], Ak.shape[-2])
            acc["A"], acc["B"] = pad_rank(acc["A"], acc["B"], R)
            Ak, Bk = pad_rank(Ak, Bk, R)
            acc["A"] = acc["A"] + weight * Ak
            acc["B"] = acc["B"] + weight * Bk

    def _finalize(self) -> AggResult:
        out: Dict = {}
        rank_rec: Dict[Tuple, List[int]] = {}
        for path, acc in self._state.items():
            A_avg, B_avg = acc["A"], acc["B"]
            set_path(out, path, {"A": A_avg, "B": B_avg,
                                 "scale": self._ref_scales[path]})
            L = A_avg.shape[0] if A_avg.dim() == 3 else 1
            rank_rec[path] = [A_avg.shape[-2]] * L
        return AggResult(self.name, out, None, rank_rec, {})

    def server_flops(self, dims, client_ranks, agg_ranks=None) -> int:
        K, R = len(client_ranks), max(client_ranks)
        return sum(L * 2 * K * R * (m + n) for (L, n, m) in dims.values())
