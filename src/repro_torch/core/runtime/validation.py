"""Server-side update validation gate (port of
``repro.core.runtime.validation``, modes ``off`` and ``screen``).

The gate sits in front of every irreversible ``Aggregator.add_client``
fold and screens each arriving update:

* **finiteness** — A, B and the scale header must be free of NaN/Inf;
* **structure** — leaf paths, layer counts and (n_in, m_out) dims match
  the round's reference dims, and the A/B rank dims agree with each other
  and with the client's task rank;
* **at-most-once** — a duplicate delivery of the same task folds once.

``off`` folds every submit; ``screen`` (default) checks, then folds at
once.  The buffered ``full`` mode (median/MAD quarantine) waits for a
later slice.  :meth:`ValidationGate.finish` enforces the round quorum.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.aggregators.base import (adapter_leaf_paths, get_path,
                                               leaf_dims)


@dataclasses.dataclass
class GateStats:
    """One round's validation outcome."""
    submitted: int = 0
    accepted: int = 0
    rejected_nonfinite: int = 0
    rejected_shape: int = 0
    rejected_duplicate: int = 0
    quorum_met: bool = True

    @property
    def rejected(self) -> int:
        return (self.rejected_nonfinite + self.rejected_shape
                + self.rejected_duplicate)


def _finite(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all())
    return bool(np.all(np.isfinite(np.asarray(x))))


class ValidationGate:
    """Validates client updates before they reach ``add_client``:
    ``begin_round(aggregator)`` → ``submit(...)`` per update → ``finish()``."""

    def __init__(self, mode: str = "screen", min_clients: int = 1):
        if mode == "full":
            raise NotImplementedError(
                "validation mode 'full' is not ported yet (later "
                "runtime-breadth slice of the port)")
        if mode not in ("off", "screen"):
            raise ValueError(f"unknown validation mode {mode!r} "
                             f"(valid: off, screen)")
        self.mode = mode
        self.min_clients = int(min_clients)
        self._agg = None
        self._dims: Optional[Dict] = None
        self._seen: Dict[int, Any] = {}
        self.stats = GateStats()

    def begin_round(self, aggregator, dims: Optional[Dict] = None) -> None:
        self._agg = aggregator
        self._dims = dims
        self._seen = {}
        self.stats = GateStats()

    def submit(self, task: Any, update: Dict, weight: float,
               rank: Optional[int] = None) -> bool:
        """Screen one update and fold it.  Returns False iff it was
        rejected."""
        self.stats.submitted += 1
        if self.mode == "screen":
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
        self._agg.add_client(update, weight, rank=rank)
        self.stats.accepted += 1
        return True

    def finish(self) -> GateStats:
        """Close the round with the quorum verdict."""
        self.stats.quorum_met = self.stats.accepted >= self.min_clients
        return self.stats

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


def make_validator(spec: Any = "screen", **cfg) -> ValidationGate:
    """A gate from an instance (returned as is) or a mode name."""
    if isinstance(spec, ValidationGate):
        return spec
    return ValidationGate(mode=spec or "off", **cfg)
