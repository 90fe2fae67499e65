"""FFA-LoRA (port of ``repro.core.aggregators.ffa``): A frozen at the
shared init, only B trained, uploaded and averaged."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.aggregators.base import (AggResult, Aggregator,
                                               adapter_leaf_paths, fold_scale,
                                               get_path, numel,
                                               register_aggregator, set_path)


@register_aggregator("ffa")
class FfaAggregator(Aggregator):
    """Streaming B-average: one running weighted B sum per leaf (A never
    travels — the server re-reads it from the frozen shared init)."""

    trains_b_only = True
    needs_a_init = True
    # only one of the two matrices is broadcast -> rank counts half in the
    # paper's efficiency denominator
    download_rank_factor = 0.5

    def __init__(self, A_init: Optional[Dict] = None,
                 zero_padding: bool = False):
        self.A_init = A_init
        self.zero_padding = zero_padding
        super().__init__()

    _STATE_FIELDS = ("_seen_ranks",)

    def _reset(self) -> None:
        super()._reset()
        self._seen_ranks: Dict[Tuple, set] = {}

    def wire_arrays(self, leaf: Dict):
        return {"B": leaf["B"]}          # A frozen, never on the wire

    def client_upload_params(self, leaf: Dict) -> int:
        return numel(leaf["B"])          # A frozen, never sent

    def _accumulate(self, update: Dict, weight: float, rank: int) -> None:
        for path in adapter_leaf_paths(update):
            Bk, _ = fold_scale(get_path(update, path))
            seen = self._seen_ranks.setdefault(path, set())
            seen.add(Bk.shape[-1])
            if len(seen) > 1 and not self.zero_padding:
                raise ValueError(
                    "FFA-LoRA requires homogeneous ranks (or zero_padding=True)")
            acc = self._state.get(path)
            if acc is None:
                self._state[path] = weight * Bk
                continue
            R = max(acc.shape[-1], Bk.shape[-1])
            acc = F.pad(acc, (0, R - acc.shape[-1]))
            Bk = F.pad(Bk, (0, R - Bk.shape[-1]))
            self._state[path] = acc + weight * Bk

    def _finalize(self) -> AggResult:
        if self.A_init is None:
            raise ValueError("ffa aggregator needs A_init (the frozen shared "
                             "init) to rebuild global adapters")
        out: Dict = {}
        rank_rec: Dict[Tuple, List[int]] = {}
        for path, B_avg in self._state.items():
            R = B_avg.shape[-1]
            A = torch.as_tensor(get_path(self.A_init, path)["A"],
                                device=B_avg.device)
            r0 = A.shape[-2]
            if r0 < R:
                A = F.pad(A, (0, 0, 0, R - r0))
            elif r0 > R:
                A = A[..., :R, :]
            set_path(out, path, {"A": A, "B": B_avg,
                                 "scale": self._ref_scales[path]})
            L = B_avg.shape[0] if B_avg.dim() == 3 else 1
            # only B travels; the efficiency counts R/2 per layer
            # (download_rank_factor above)
            rank_rec[path] = [R] * L
        return AggResult(self.name, out, None, rank_rec, {})

    # -- client-init: A stays at the frozen init ----------------------------
    def client_init(self, global_state: Optional[AggResult], rank: int,
                    a_init_full: Dict) -> Dict:
        from repro_torch.peft.lora import match_rank

        g = super().client_init(global_state, rank, a_init_full)
        if global_state is None:
            return g
        a_init = match_rank(a_init_full, rank)
        for path in adapter_leaf_paths(g):      # match_rank built new dicts
            get_path(g, path)["A"] = get_path(a_init, path)["A"]
        return g

    # -- cost model ----------------------------------------------------------
    def download_params(self, agg: AggResult, dims: Dict, num_clients: int,
                        client_ranks) -> int:
        total = 0
        for path, (L, n, m) in dims.items():
            for r_l in agg.ranks[path]:
                total += num_clients * r_l * m        # only B broadcast
        return total

    def server_flops(self, dims, client_ranks, agg_ranks=None) -> int:
        K, R = len(client_ranks), max(client_ranks)
        return sum(L * 2 * K * R * m for (L, n, m) in dims.values())
