"""FLoRIST (Algorithm 1, server block; port of
``repro.core.aggregators.florist``): stacked thin SVDs + an r×r core SVD +
per-layer energy thresholding — the singular values of ΔW without ever
forming ΔW."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.aggregators.base import (AggResult, Aggregator,
                                               adapter_leaf_paths,
                                               bucket_by_shape, fold_scale,
                                               get_path, register_aggregator,
                                               set_path)
from repro_torch.core.svd import (florist_core_batched,
                                  florist_core_delta_batched,
                                  florist_core_stacked)


@register_aggregator("florist")
class FloristAggregator(Aggregator):
    """Streaming stacker + thresholded core SVD at finalize.

    ``add_client`` appends each client's scale-folded B blocks and weighted
    A blocks to a per-leaf pending list and, every ``flush_every`` arrivals,
    compacts it on the device:

    * **stacked mode**: one (L, m, Σr) / (L, Σr, n) pair, the intermediate
      the paper's pipeline thin-SVDs at finalize;
    * **delta mode** (``stream="delta"``, or ``"auto"`` once Σ r_k would
      exceed ``min(m, n)``): a running dense update ``M += B_pend A_pend``,
      whose thin SVD finalize takes directly (the same SVD, up to fp).

    ``finalize`` buckets leaves with equal intermediate shapes and runs each
    bucket through one batched core call (the reference's vmapped call); the
    spectra and per-layer ranks come to the host in one transfer, where the
    zero-padded factors are cut to each leaf's largest kept rank.

    ``pipeline="loop"`` is the reference's per-(leaf, layer) oracle: one
    :func:`~repro_torch.core.svd.florist_core_stacked` and one host sync a
    layer, for equivalence tests; it forces the stacked stream.
    """

    def __init__(self, tau=0.9, svd_method: str = "svd", max_rank: int = 0,
                 pipeline: str = "batched", stream: str = "auto",
                 flush_every: int = 64):
        if pipeline not in ("batched", "loop"):
            raise ValueError(pipeline)
        if stream not in ("auto", "stacked", "delta"):
            raise ValueError(stream)
        self.tau = tau
        self.svd_method = svd_method
        self.max_rank = max_rank
        self.pipeline = pipeline
        # the loop oracle iterates the stacked lists directly
        self.stream = "stacked" if pipeline == "loop" else stream
        self.flush_every = max(1, int(flush_every))
        self.peak_pending_blocks = 0
        super().__init__()

    # -- streaming accumulation ----------------------------------------------

    def _accumulate(self, update: Dict, weight: float, rank: int) -> None:
        for path in adapter_leaf_paths(update):
            Bk, Ak = fold_scale(get_path(update, path))
            acc = self._state.setdefault(
                path, {"stacked": Ak.dim() == 3, "A": [], "B": [], "M": None})
            acc["B"].append(Bk)
            acc["A"].append(weight * Ak)
            self.peak_pending_blocks = max(self.peak_pending_blocks,
                                           len(acc["B"]))
            if len(acc["B"]) >= self.flush_every:
                self._compact(acc)

    def _delta_mode(self, acc: Dict) -> bool:
        if acc["M"] is not None or self.stream == "delta":
            return True
        if self.stream != "auto" or not acc["B"]:
            return False
        width = sum(b.shape[-1] for b in acc["B"])
        m, n = acc["B"][0].shape[-2], acc["A"][0].shape[-1]
        return width > min(m, n)

    def _compact(self, acc: Dict) -> None:
        """Fold the pending blocks into the compact intermediate."""
        if not acc["B"]:
            return
        B = acc["B"][0] if len(acc["B"]) == 1 else torch.cat(acc["B"], dim=-1)
        A = acc["A"][0] if len(acc["A"]) == 1 else torch.cat(acc["A"], dim=-2)
        if self._delta_mode(acc):
            d = B @ A
            acc["M"] = d if acc["M"] is None else acc["M"] + d
            acc["B"], acc["A"] = [], []
        else:
            acc["B"], acc["A"] = [B], [A]

    def _settle(self) -> Dict[Tuple, Tuple]:
        """Compact every leaf; return ``("stack", B (L,m,Σr), A (L,Σr,n))``
        or ``("delta", M (L,m,n))`` per leaf (un-stacked leaves get a
        singleton layer axis)."""
        inter: Dict[Tuple, Tuple] = {}
        for path, acc in self._state.items():
            self._compact(acc)
            if acc["M"] is not None:
                M = acc["M"] if acc["stacked"] else acc["M"][None]
                inter[path] = ("delta", M)
            else:
                B, A = acc["B"][0], acc["A"][0]
                if not acc["stacked"]:
                    B, A = B[None], A[None]
                inter[path] = ("stack", B, A)
        return inter

    # -- finalize -------------------------------------------------------------

    def _materialize(self, device: Dict[Tuple, Tuple]) -> AggResult:
        """One device→host transfer for all spectra and ranks, then cut the
        zero-padded global factors to each leaf's largest kept rank."""
        out: Dict = {}
        rank_rec: Dict[Tuple, List[int]] = {}
        spectra: Dict[Tuple, List[np.ndarray]] = {}
        paths = list(device)
        host = torch.cat([torch.cat([device[p][2].float(),
                                     device[p][3].float()[:, None]], dim=1)
                          .flatten() for p in paths]).cpu().numpy() \
            if paths else np.zeros(0, np.float32)
        off = 0
        for path in paths:
            Bg, Ag, sp, pr = device[path]
            L, r = sp.shape
            blk = host[off: off + L * (r + 1)].reshape(L, r + 1)
            off += L * (r + 1)
            ps = [int(x) for x in blk[:, r]]
            p_max = max(ps)
            Bg, Ag = Bg[:, :, :p_max], Ag[:, :p_max, :]
            if not self._state[path]["stacked"]:
                Bg, Ag = Bg[0], Ag[0]
            set_path(out, path, {"A": Ag, "B": Bg,
                                 "scale": self._ref_scales[path]})
            rank_rec[path] = ps
            spectra[path] = [np.asarray(s) for s in blk[:, :r]]
        return AggResult(self.name, out, None, rank_rec, spectra)

    def _finalize(self) -> AggResult:
        if self.pipeline == "loop":
            return self._finalize_loop()
        inter = self._settle()
        stacks = {p: v[1:] for p, v in inter.items() if v[0] == "stack"}
        deltas = {p: v[1:] for p, v in inter.items() if v[0] == "delta"}
        device: Dict[Tuple, Tuple] = {}
        for paths in bucket_by_shape(stacks):
            Bb = torch.cat([stacks[p][0] for p in paths], dim=0)
            Ab = torch.cat([stacks[p][1] for p in paths], dim=0)
            Bg, Ag, sp, pr = florist_core_batched(
                Bb, Ab, self.tau, self.svd_method, self.max_rank)
            L = stacks[paths[0]][0].shape[0]
            for i, path in enumerate(paths):
                sl = slice(i * L, (i + 1) * L)
                device[path] = (Bg[sl], Ag[sl], sp[sl], pr[sl])
        for paths in bucket_by_shape(deltas):
            Mb = torch.cat([deltas[p][0] for p in paths], dim=0)
            Bg, Ag, sp, pr = florist_core_delta_batched(
                Mb, self.tau, self.svd_method, self.max_rank)
            L = deltas[paths[0]][0].shape[0]
            for i, path in enumerate(paths):
                sl = slice(i * L, (i + 1) * L)
                device[path] = (Bg[sl], Ag[sl], sp[sl], pr[sl])
        return self._materialize(device)

    def _finalize_loop(self) -> AggResult:
        """The per-(leaf, layer) loop: one core call and one host sync a
        layer; ragged ranks zero-padded to the leaf's largest."""
        out: Dict = {}
        rank_rec: Dict[Tuple, List[int]] = {}
        spectra: Dict[Tuple, List[np.ndarray]] = {}
        for path, acc in self._state.items():
            stacked = acc["stacked"]
            B_stack = torch.cat(acc["B"], dim=-1)          # (L, m, Σr)
            A_stack = torch.cat(acc["A"], dim=-2)          # (L, Σr, n)
            layers = zip(B_stack, A_stack) if stacked else [(B_stack, A_stack)]
            res = [florist_core_stacked(b, a, self.tau, self.svd_method,
                                        self.max_rank) for b, a in layers]
            ps = [o.p for o in res]
            p_max = max(ps)
            if stacked:
                Bg = torch.stack([F.pad(o.B_g, (0, p_max - o.p)) for o in res])
                Ag = torch.stack([F.pad(o.A_g, (0, 0, 0, p_max - o.p))
                                  for o in res])
            else:
                Bg, Ag = res[0].B_g, res[0].A_g
            set_path(out, path, {"A": Ag, "B": Bg,
                                 "scale": self._ref_scales[path]})
            rank_rec[path] = ps
            spectra[path] = [o.spectrum.cpu().numpy() for o in res]
        return AggResult(self.name, out, None, rank_rec, spectra)

    def server_flops(self, dims, client_ranks, agg_ranks=None) -> int:
        from repro_torch.core.costs import SVD_CONST

        r = sum(client_ranks)                        # stacked rank
        total = 0
        for path, (L, n, m) in dims.items():
            for l in range(L):
                total += SVD_CONST * (m * r * r + n * r * r)  # thin SVDs
                total += 2 * r ** 3                            # Q = V_Bᵀ U_A
                total += 2 * r * r                             # P diag scaling
                total += SVD_CONST * r ** 3                    # SVD(P)
                p_l = agg_ranks[path][l] if agg_ranks else r
                total += 2 * (m * r * p_l + p_l * r * n)       # build B_g, A_g
        return total
