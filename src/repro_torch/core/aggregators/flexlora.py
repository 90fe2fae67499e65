"""FlexLoRA (port of ``repro.core.aggregators.flexlora``): form the dense
ΔW = Σ w_k B_k A_k per layer, full SVD, then cut per-client adapters at
each client's own rank."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.aggregators.base import (AggResult, Aggregator,
                                               adapter_leaf_paths, fold_scale,
                                               get_path, register_aggregator,
                                               set_path)
from repro_torch.core.svd import thin_svd_batched


@register_aggregator("flexlora")
class FlexLoRAAggregator(Aggregator):
    """Streaming dense accumulation: one running fp32 ΔW sum per leaf, held
    as a single (L, m, n) tensor — O(L·m·n) per leaf, O(1) in the client
    count.  Finalize runs one batched SVD over all layers of a leaf and one
    device→host copy of all the spectra; the per-client cuts stay on the
    device."""

    def _accumulate(self, update: Dict, weight: float, rank: int) -> None:
        for path in adapter_leaf_paths(update):
            Bk, Ak = fold_scale(get_path(update, path))
            stacked = Ak.dim() == 3
            if not stacked:
                Bk, Ak = Bk[None], Ak[None]
            term = weight * torch.matmul(Bk.float(), Ak.float())
            acc = self._state.setdefault(path, {"stacked": stacked,
                                                "dw": None})
            acc["dw"] = term if acc["dw"] is None else acc["dw"] + term

    def _finalize(self) -> AggResult:
        per_client: List[Dict] = [{} for _ in range(self.num_clients)]
        glob: Dict = {}
        rank_rec: Dict[Tuple, List[int]] = {}
        spectra: Dict[Tuple, List[np.ndarray]] = {}
        Rmax = max(self.client_ranks)
        # all L layer SVDs of a leaf in one call: u (L,m,k), s (L,k), vt (L,k,n)
        device = {path: thin_svd_batched(acc["dw"], "svd")
                  for path, acc in self._state.items()}
        paths = list(device)
        host = torch.cat([device[p].s.flatten() for p in paths]).cpu().numpy()
        off = 0
        for path in paths:
            ub, sp, vt = device[path]
            L, r_full = sp.shape
            sp_host = host[off: off + L * r_full].reshape(L, r_full)
            off += L * r_full
            stacked = self._state[path]["stacked"]
            spectra[path] = [np.asarray(s) for s in sp_host]
            rank_rec[path] = [min(Rmax, r_full)] * L
            # global (exact) adapters at full rank — the server's eval
            Bg, Ag = ub * sp[:, None, :], vt
            if not stacked:
                Bg, Ag = Bg[0], Ag[0]
            ref = self._ref_scales[path]
            set_path(glob, path, {"A": Ag, "B": Bg, "scale": ref})
            # per-client cuts, zero-padded up to a rank above min(m, n)
            for ci, rk in enumerate(self.client_ranks):
                rr = min(rk, r_full)
                Bc = F.pad(ub[:, :, :rr] * sp[:, None, :rr], (0, rk - rr))
                Ac = F.pad(vt[:, :rr, :], (0, 0, 0, rk - rr))
                if not stacked:
                    Bc, Ac = Bc[0], Ac[0]
                set_path(per_client[ci], path,
                         {"A": Ac, "B": Bc, "scale": ref})
        return AggResult(self.name, glob, per_client, rank_rec, spectra)

    # -- cost model ----------------------------------------------------------
    def download_params(self, agg: AggResult, dims: Dict, num_clients: int,
                        client_ranks) -> int:
        # each client gets its own rank-r_k adapters
        total = 0
        for rk in client_ranks:
            for path, (L, n, m) in dims.items():
                total += L * rk * (n + m)
        return total

    def server_flops(self, dims, client_ranks, agg_ranks=None) -> int:
        from repro_torch.core.costs import SVD_CONST

        r = sum(client_ranks)                       # stacked rank
        total = 0
        for path, (L, n, m) in dims.items():
            p = min(m, n)
            total += L * (2 * m * n * r               # form ΔW
                          + SVD_CONST * m * n * p     # dense SVD
                          + 2 * (m * p * p + p * p * n))  # partition/rescale
        return total

    def efficiency(self, agg: AggResult, client_ranks=(), dims=None) -> float:
        # each client downloads its own rank-r_k adapters -> mean over clients
        L_total = sum(L for (L, _, _) in dims.values()) if dims else 1
        return 1.0 / max(1.0, L_total * float(np.mean(client_ranks)))
