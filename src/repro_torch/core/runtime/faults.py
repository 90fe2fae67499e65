"""Deterministic fault injection for the federated runtime (port of
``repro.core.runtime.faults``).

A :class:`FaultPlan` is a pure function of ``(fault_seed, round,
client_id)``: every query re-derives a numpy generator from the seed, a
stream tag and the key, so two processes holding the same plan agree on
which client fails, how, and at which retry attempt.  The decisions are
numpy draws in the reference's order, so they equal the reference's
exactly.

Fault kinds (one at most per ``(round, client)``; rates are cumulative and
sum to ≤ 1): ``drop`` (the upload never arrives), ``duplicate`` (delivered
twice), ``corrupt`` (the first ``n_bad`` upload attempts arrive with a
flipped bit; the transport's checksums catch it and retry), ``nan`` (random
A/B entries set to NaN/±Inf), ``scale`` (the update delta scaled by
``scale_factor``) and ``slow`` (``slow_secs`` on the simulated clock).

Server crashes are scheduled as ``crashes=((round, point), ...)`` with
``point`` one of :data:`CRASH_POINTS`; the trainer raises
:class:`ServerCrash` at the matching hook.  Time never comes from the host:
retries, backoff and slow clients advance a :class:`SimClock`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

#: stream tags: independent rng streams per decision family
_FAULT_TAG = 0x5F4A
_POISON_TAG = 0x901
_CORRUPT_TAG = 0xB17F

#: trainer hooks where an injected server crash can fire
CRASH_POINTS = ("begin", "mid_round", "pre_finalize", "post_round")


class ServerCrash(RuntimeError):
    """Injected server failure — simulates SIGKILL at a round stage."""

    def __init__(self, rnd: int, point: str):
        self.round, self.point = rnd, point
        super().__init__(f"injected server crash at round {rnd} ({point!r})")


class SimClock:
    """Simulated wall clock: backoff delays and slow clients advance it
    deterministically, so fault timelines reproduce across machines."""

    def __init__(self) -> None:
        self.now = 0.0

    def advance(self, secs: float) -> None:
        self.now += float(secs)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One client's fault assignment for a round (``kind=None``: healthy)."""
    kind: Optional[str] = None
    #: corrupt: number of leading upload attempts that arrive bit-flipped
    n_bad: int = 0
    #: slow: simulated straggler latency in seconds
    delay: float = 0.0


NO_FAULT = Fault()


class FaultPlan:
    """Deterministic per-(round, client) fault assignment.

    Every query re-derives its rng from ``(seed, tag, round, client_id)``
    so the plan carries no mutable state: ``client_fault(r, k)`` returns
    the same :class:`Fault` no matter when, where, or how often it is
    asked — the property the resume tests and the benchmarks rely on.
    """

    def __init__(self, seed: int = 0, drop: float = 0.0,
                 duplicate: float = 0.0, corrupt: float = 0.0,
                 nan: float = 0.0, scale: float = 0.0, slow: float = 0.0,
                 scale_factor: float = 100.0, slow_secs: float = 1.0,
                 max_bad_attempts: int = 6,
                 crashes: Tuple[Tuple[int, str], ...] = ()):
        rates = dict(drop=drop, duplicate=duplicate, corrupt=corrupt,
                     nan=nan, scale=scale, slow=slow)
        for k, v in rates.items():
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault rate {k}={v} outside [0, 1]")
        if sum(rates.values()) > 1.0 + 1e-9:
            raise ValueError(f"fault rates sum to {sum(rates.values())} > 1")
        for rnd, point in crashes:
            if point not in CRASH_POINTS:
                raise ValueError(f"unknown crash point {point!r} "
                                 f"(valid: {CRASH_POINTS})")
        self.seed = int(seed)
        self.rates = rates
        self.scale_factor = float(scale_factor)
        self.slow_secs = float(slow_secs)
        self.max_bad_attempts = int(max_bad_attempts)
        self.crashes = tuple((int(r), str(p)) for r, p in crashes)
        self.clock = SimClock()

    # -- pure per-(round, client) draws --------------------------------------

    def _rng(self, tag: int, *key: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, tag, *[int(k) for k in key]])

    def client_fault(self, rnd: int, client_id: int) -> Fault:
        """The (at most one) fault assigned to this client this round."""
        rng = self._rng(_FAULT_TAG, rnd, client_id)
        u = float(rng.random())
        for kind, p in self.rates.items():
            if u < p:
                if kind == "corrupt":
                    return Fault("corrupt", n_bad=int(
                        rng.integers(1, self.max_bad_attempts + 1)))
                if kind == "slow":
                    return Fault("slow", delay=self.slow_secs
                                 * float(rng.uniform(0.5, 1.5)))
                return Fault(kind)
            u -= p
        return NO_FAULT

    def poison(self, adapters: Dict, init_adapters: Optional[Dict],
               rnd: int, client_id: int) -> Dict:
        """Apply this client's poison fault to its trained adapters.

        ``nan``: a handful of random A/B entries become NaN / ±Inf.
        ``scale``: the update delta (vs the round's init) is scaled by
        ``scale_factor`` — finite, but a gross norm outlier.
        Healthy clients pass through untouched.  Leaves are visited in
        sorted-key order (the reference's pytree order), so the draws land
        on the same entries; poisoned A/B leaves come back as fp32 numpy.
        """
        fault = self.client_fault(rnd, client_id)
        if fault.kind not in ("nan", "scale"):
            return adapters
        rng = self._rng(_POISON_TAG, rnd, client_id)

        def poison_leaf(name, leaf):
            if name not in ("A", "B") or getattr(leaf, "ndim", 0) < 2:
                return leaf
            arr = _np32(leaf).copy()
            if fault.kind == "nan":
                flat = arr.reshape(-1)
                idx = rng.integers(0, flat.size, size=min(4, flat.size))
                flat[idx] = rng.choice([np.nan, np.inf, -np.inf], size=idx.size)
                return arr
            return arr * self.scale_factor   # scale: blow up A and B alike

        def walk(node, init):
            out = {}
            for k in sorted(node):
                v = node[k]
                i = init.get(k) if isinstance(init, dict) else None
                if isinstance(v, dict):
                    out[k] = walk(v, i)
                    continue
                p = poison_leaf(k, v)
                if (fault.kind == "scale" and i is not None
                        and getattr(p, "ndim", 0) >= 2):
                    # re-anchor so the *delta* (not the absolute tree) is
                    # factor ×: poisoned = init + factor · (trained − init)
                    p = p - (self.scale_factor - 1.0) * _np32(i)
                out[k] = p
            return out

        return walk(adapters, init_adapters)

    # -- transport-level corruption ------------------------------------------

    def is_corrupt(self, rnd: int, client_id: int, attempt: int) -> bool:
        """Does this client's upload attempt arrive bit-flipped?"""
        fault = self.client_fault(rnd, client_id)
        return fault.kind == "corrupt" and attempt < fault.n_bad

    def corrupt_payload(self, payload, rnd: int, client_id: int,
                        attempt: int):
        """Flip one bit in one encoded block (checksum left stale, so the
        receiver's verification catches it).  Returns a new payload; the
        input is not mutated."""
        import dataclasses as dc

        rng = self._rng(_CORRUPT_TAG, rnd, client_id, attempt)
        blocks = {}
        flat = [(path, name, i, enc)
                for path, by_name in payload.blocks.items()
                for name, encs in by_name.items()
                for i, enc in enumerate(encs)]
        victim = int(rng.integers(len(flat)))
        for j, (path, name, i, enc) in enumerate(flat):
            if j == victim and len(enc.data):
                data = bytearray(enc.data)
                bit = int(rng.integers(len(data) * 8))
                data[bit // 8] ^= 1 << (bit % 8)
                enc = dc.replace(enc, data=bytes(data))
            blocks.setdefault(path, {}).setdefault(name, []).append(enc)
        return dc.replace(payload, blocks=blocks)

    # -- server crash schedule ------------------------------------------------

    def should_crash(self, rnd: int, point: str) -> bool:
        return (rnd, point) in self.crashes

    def without_crashes(self) -> "FaultPlan":
        """The same client-fault plan with the crash schedule cleared —
        what a *resumed* server process observes (the injected crash
        already happened; the client population faults are unchanged)."""
        clone = FaultPlan(seed=self.seed, scale_factor=self.scale_factor,
                          slow_secs=self.slow_secs,
                          max_bad_attempts=self.max_bad_attempts,
                          **self.rates)
        return clone


def _np32(x) -> np.ndarray:
    """A leaf (tensor on any device, or numpy) as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)
