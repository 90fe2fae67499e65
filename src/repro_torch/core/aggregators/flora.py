"""FLoRA (port of ``repro.core.aggregators.flora``): stack everything,
broadcast the stack (rank = Σ r_k); clients merge it into the frozen base
and re-init their local adapters."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.aggregators.base import (AggResult, Aggregator,
                                               adapter_leaf_paths, fold_scale,
                                               fresh_client_adapters,
                                               get_path, register_aggregator,
                                               set_path)


@register_aggregator("flora")
class FloraAggregator(Aggregator):
    """Streaming stacker: per-leaf lists of (scale-folded B, weighted A)
    blocks in arrival order, concatenated once at finalize — O(Σ r_k) per
    leaf, the size of the broadcast stack itself."""

    def _accumulate(self, update: Dict, weight: float, rank: int) -> None:
        for path in adapter_leaf_paths(update):
            Bk, Ak = fold_scale(get_path(update, path))
            acc = self._state.setdefault(path, {"A": [], "B": []})
            acc["B"].append(Bk)
            acc["A"].append(weight * Ak)

    def _finalize(self) -> AggResult:
        out: Dict = {}
        rank_rec: Dict[Tuple, List[int]] = {}
        for path, acc in self._state.items():
            B_stack = torch.cat(acc["B"], dim=-1)
            A_stack = torch.cat(acc["A"], dim=-2)
            set_path(out, path, {"A": A_stack, "B": B_stack,
                                 "scale": self._ref_scales[path]})
            L = A_stack.shape[0] if A_stack.dim() == 3 else 1
            rank_rec[path] = [A_stack.shape[-2]] * L
        return AggResult(self.name, out, None, rank_rec, {},
                         merge_into_base=True)

    def client_init(self, global_state: Optional[AggResult], rank: int,
                    a_init_full: Dict) -> Dict:
        # the stack was merged into the base; adapters restart every round
        return fresh_client_adapters(a_init_full, rank)

    def server_flops(self, dims, client_ranks, agg_ranks=None) -> int:
        return 0                          # pure concatenation
