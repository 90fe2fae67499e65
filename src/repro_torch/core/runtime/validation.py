"""Server-side update validation gate (port of
``repro.core.runtime.validation``).

The gate sits in front of every irreversible ``Aggregator.add_client``
fold and screens each arriving update:

* **finiteness** — A, B and the scale header must be free of NaN/Inf;
* **structure** — leaf paths, layer counts and (n_in, m_out) dims match
  the round's reference dims, and the A/B rank dims agree with each other
  and with the client's task rank;
* **at-most-once** — a duplicate delivery of the same task folds once.

``off`` folds every submit; ``screen`` (default) checks, then folds at
once; ``full`` checks and holds every update until :meth:`finish`, which
computes a robust z-score of each update's delta L2 norm against the
round's init (median/MAD across the round, with a floor relative to the
median so a tight honest cluster — every client clipped to one DP bound —
never self-rejects), quarantines the outliers, renormalizes the surviving
weights to the round's total mass (only when something was quarantined)
and folds the survivors in arrival order.  :meth:`ValidationGate.finish`
enforces the round quorum.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.aggregators.base import (adapter_leaf_paths, get_path,
                                               leaf_dims)

#: robust-σ consistency constant: σ ≈ 1.4826 · MAD for a normal sample
_MAD_SIGMA = 1.4826
#: MAD floor relative to the median norm
_REL_FLOOR = 0.05


@dataclasses.dataclass
class GateStats:
    """One round's validation outcome."""
    submitted: int = 0
    accepted: int = 0
    rejected_nonfinite: int = 0
    rejected_shape: int = 0
    rejected_duplicate: int = 0
    quarantined: int = 0
    quorum_met: bool = True

    @property
    def rejected(self) -> int:
        return (self.rejected_nonfinite + self.rejected_shape
                + self.rejected_duplicate)


@dataclasses.dataclass
class _Held:
    """One buffered submission awaiting the full-mode round verdict."""
    update: Dict
    weight: float
    rank: Optional[int]
    norm: float


def _finite(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all())
    return bool(np.all(np.isfinite(np.asarray(x))))


class ValidationGate:
    """Validates client updates before they reach ``add_client``:
    ``begin_round(aggregator)`` → ``submit(...)`` per update → ``finish()``."""

    def __init__(self, mode: str = "screen", mad_threshold: float = 6.0,
                 min_clients: int = 1, min_mad_samples: int = 4):
        if mode not in ("off", "screen", "full"):
            raise ValueError(f"unknown validation mode {mode!r} "
                             f"(valid: off, screen, full)")
        self.mode = mode
        self.mad_threshold = float(mad_threshold)
        self.min_clients = int(min_clients)
        self.min_mad_samples = int(min_mad_samples)
        self._agg = None
        self._dims: Optional[Dict] = None
        self._seen: Dict[int, Any] = {}
        self._held: List[_Held] = []
        self.stats = GateStats()

    def begin_round(self, aggregator, dims: Optional[Dict] = None) -> None:
        self._agg = aggregator
        self._dims = dims
        self._seen = {}
        self._held = []
        self.stats = GateStats()

    def submit(self, task: Any, update: Dict, weight: float,
               rank: Optional[int] = None,
               init_adapters: Optional[Dict] = None) -> bool:
        """Screen one update; fold it (``screen``/``off``) or hold it for
        the round verdict (``full``, which judges its delta from
        ``init_adapters``).  Returns False iff it was rejected outright."""
        self.stats.submitted += 1
        if self.mode == "off":
            self._agg.add_client(update, weight, rank=rank)
            self.stats.accepted += 1
            return True
        if task is not None:
            if id(task) in self._seen:
                self.stats.rejected_duplicate += 1
                return False
            # holding the task pins its id for the round
            self._seen[id(task)] = task
        if not self._check_structure(update, rank):
            self.stats.rejected_shape += 1
            return False
        if not self._check_finite(update):
            self.stats.rejected_nonfinite += 1
            return False
        if self.mode == "screen":
            self._agg.add_client(update, weight, rank=rank)
            self.stats.accepted += 1
            return True
        self._held.append(_Held(update, float(weight), rank,
                                _delta_norm(update, init_adapters)))
        return True

    def finish(self) -> GateStats:
        """Close the round: the full-mode quarantine and fold, then the
        quorum verdict."""
        if self.mode == "full" and self._held:
            self._fold_held()
        self.stats.quorum_met = self.stats.accepted >= self.min_clients
        return self.stats

    def _fold_held(self) -> None:
        held = self._held
        reject: set = set()
        if len(held) >= self.min_mad_samples:
            norms = np.array([h.norm for h in held], np.float64)
            med = float(np.median(norms))
            mad = float(np.median(np.abs(norms - med)))
            denom = max(_MAD_SIGMA * mad, _REL_FLOOR * abs(med), 1e-12)
            for i, n in enumerate(norms):
                if abs(float(n) - med) / denom > self.mad_threshold:
                    reject.add(i)
        accepted = [h for i, h in enumerate(held) if i not in reject]
        self.stats.quarantined = len(reject)
        factor = 1.0
        if reject and accepted:
            w_all = sum(h.weight for h in held)
            w_acc = sum(h.weight for h in accepted)
            if w_acc > 0:
                factor = w_all / w_acc
        for h in accepted:
            self._agg.add_client(h.update, h.weight * factor, rank=h.rank)
            self.stats.accepted += 1
        self._held = []

    def _check_structure(self, update: Dict, rank: Optional[int]) -> bool:
        try:
            dims = leaf_dims(update)
        except (KeyError, AttributeError, IndexError):
            return False
        if self._dims is None:
            self._dims = dims
        elif dims != self._dims:
            return False
        for path in adapter_leaf_paths(update):
            leaf = get_path(update, path)
            r_a, r_b = leaf["A"].shape[-2], leaf["B"].shape[-1]
            if r_a != r_b or (rank is not None and r_a != rank):
                return False
        return True

    def _check_finite(self, update: Dict) -> bool:
        for path in adapter_leaf_paths(update):
            leaf = get_path(update, path)
            for name in ("A", "B", "scale"):
                if name in leaf and not _finite(leaf[name]):
                    return False
        return True


def _f64(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def _delta_norm(update: Dict, init: Optional[Dict]) -> float:
    """Global L2 norm, in float64, of the update's A/B delta from the round
    init (of the raw tensors when no init is known): the statistic the
    full-mode quarantine judges."""
    total = 0.0
    for path in adapter_leaf_paths(update):
        leaf = get_path(update, path)
        ref = get_path(init, path) if init is not None else None
        for name in ("A", "B"):
            arr = _f64(leaf[name])
            if ref is not None:
                arr = arr - _f64(ref[name])
            total += float(np.sum(arr * arr))
    return math.sqrt(total)


def make_validator(spec: Any = "screen", **cfg) -> ValidationGate:
    """A gate from an instance (returned as is) or a mode name."""
    if isinstance(spec, ValidationGate):
        return spec
    return ValidationGate(mode=spec or "off", **cfg)
