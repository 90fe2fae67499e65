"""Round schedulers and rank policies (port of
``repro.core.runtime.schedulers``): who participates in a federated round,
and how.

A :class:`RoundScheduler` turns "round ``rnd`` is starting" into a
:class:`RoundPlan`: the :class:`ClientTask` s that deliver an update this
round, each with its local step budget, normalized aggregation weight and,
for buffered/async semantics, the staleness and the adapter snapshot the
client was dispatched with.  The scheduler reads the trainer as its round
context (``rng``, ``fed``, ``clients``, ``client_ranks``, ``local_steps``,
``_client_init``).  Every draw is numpy (the trainer's
``np.random.default_rng(fed.seed)`` or a generator keyed on ``(seed,
round)``), so the plans equal the reference's exactly.

Registered schedulers: ``sync`` (sample K, wait for all), ``partial``
(dropouts and stragglers), ``async`` (a buffered pool of in-flight clients
dispatched with snapshots, staleness-discounted weights) and ``sampled``
(a participation fraction of the whole population keyed on ``(seed,
round)`` only).  Rank policies (:class:`RankPolicy`): ``static`` keeps the
configured ranks, ``resource`` scales them by budget tier with a warmup
ramp, snapped down to powers of two so cohorts stay batchable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np


@dataclasses.dataclass
class ClientTask:
    """One client's assignment for a round."""
    client_id: int
    rank: int
    steps: int                      # local fine-tuning step budget
    weight: float                   # normalized aggregation weight
    staleness: int = 0              # rounds between dispatch and arrival
    init_adapters: Optional[Dict] = None   # dispatch-time snapshot (async)


@dataclasses.dataclass
class RoundPlan:
    round: int
    tasks: List[ClientTask]
    #: server→client model dispatches this round (``None``: one per task).
    #: ``async`` sets it to the number of *new* dispatches — clients already
    #: in flight received their snapshot in an earlier round's downlink.
    downloads: Optional[int] = None


class RoundScheduler:
    """Participation policy.  Subclasses implement :meth:`plan`."""

    name: str = "?"

    def plan(self, rnd: int, ctx) -> RoundPlan:
        raise NotImplementedError

    # -- checkpoint hooks ---------------------------------------------------
    # Most schedulers are pure functions of (seed, round) and carry no
    # cross-round state; ``async`` overrides these to serialize its
    # in-flight pool so a resumed run replays identically.
    def state_dict(self) -> Dict:
        return {}

    def load_state_dict(self, state: Dict, device: Any = "cpu") -> None:
        return


_REGISTRY: Dict[str, Type[RoundScheduler]] = {}


def register_scheduler(name: str):
    def deco(cls: Type[RoundScheduler]) -> Type[RoundScheduler]:
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def make_scheduler(spec: Any, **cfg) -> RoundScheduler:
    if isinstance(spec, RoundScheduler):
        return spec
    try:
        return _REGISTRY[spec](**cfg)
    except KeyError:
        raise ValueError(f"unknown scheduler {spec!r} "
                         f"(registered: {sorted(_REGISTRY)})") from None


def available_schedulers() -> List[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# implementations
# ---------------------------------------------------------------------------


@register_scheduler("sync")
class SyncScheduler(RoundScheduler):
    """Sample K, wait for all K — the legacy semantics, bit-for-bit (same
    rng call, same weight arithmetic)."""

    def plan(self, rnd: int, ctx) -> RoundPlan:
        fed = ctx.fed
        sampled = list(ctx.rng.choice(fed.num_clients, fed.clients_per_round,
                                      replace=False))
        n_total = sum(ctx.clients[k].num_samples for k in sampled)
        tasks = [ClientTask(int(k), ctx.client_ranks[k], ctx.local_steps,
                            ctx.clients[k].num_samples / n_total)
                 for k in sampled]
        return RoundPlan(rnd, tasks)


@register_scheduler("partial")
class PartialScheduler(RoundScheduler):
    """Dropouts + stragglers over the sync sample.

    Each sampled client independently drops out with ``drop_rate``;
    surviving clients become stragglers with ``straggler_rate`` and then
    finish only a uniform fraction of the step budget (≥ ``min_steps``).
    The per-round decisions come from a rng derived from ``(seed, rnd)``,
    so a fixed federated seed gives an identical dropout pattern.
    """

    def __init__(self, drop_rate: float = 0.25, straggler_rate: float = 0.25,
                 min_steps: int = 1):
        self.drop_rate = drop_rate
        self.straggler_rate = straggler_rate
        self.min_steps = min_steps

    def plan(self, rnd: int, ctx) -> RoundPlan:
        fed = ctx.fed
        sampled = list(ctx.rng.choice(fed.num_clients, fed.clients_per_round,
                                      replace=False))
        prng = np.random.default_rng([fed.seed, 104729, rnd])
        survivors: List[Tuple[int, int]] = []
        for k in sampled:
            if prng.random() < self.drop_rate:
                continue
            steps = ctx.local_steps
            if prng.random() < self.straggler_rate:
                steps = max(self.min_steps,
                            int(round(ctx.local_steps * prng.uniform(0.25, 1.0))))
            survivors.append((int(k), steps))
        if not survivors:            # never an empty round
            survivors = [(int(sampled[0]), ctx.local_steps)]
        n_total = sum(ctx.clients[k].num_samples for k, _ in survivors)
        tasks = [ClientTask(k, ctx.client_ranks[k], steps,
                            ctx.clients[k].num_samples / n_total)
                 for k, steps in survivors]
        return RoundPlan(rnd, tasks)


@register_scheduler("async")
class AsyncScheduler(RoundScheduler):
    """Buffered asynchronous aggregation with staleness discounting.

    A pool of ``buffer_size`` (default: ``clients_per_round``) clients is
    kept in flight; each is dispatched with a snapshot of the global
    adapters *at dispatch time* and a completion delay of 1..``max_delay``
    rounds.  Arrivals whose delay has elapsed deliver this round, weighted
    ``n_k · (1 + staleness)^(-staleness_power)`` and renormalized; the pool
    is refilled at the start of every round with the then-current state.
    If nothing is due (e.g. round 0), the soonest cohort arrives early so
    every round aggregates at least one update.
    """

    def __init__(self, max_delay: int = 3, staleness_power: float = 0.5,
                 buffer_size: int = 0):
        self.max_delay = max(1, int(max_delay))
        self.staleness_power = staleness_power
        self.buffer_size = buffer_size
        self._in_flight: List[Dict] = []

    def _dispatch(self, rnd: int, ctx) -> None:
        k = int(ctx.rng.integers(ctx.fed.num_clients))
        delay = int(ctx.rng.integers(1, self.max_delay + 1))
        self._in_flight.append({
            "client_id": k,
            "dispatched": rnd,
            "completes": rnd + delay,
            "init": ctx._client_init(k),
        })

    def plan(self, rnd: int, ctx) -> RoundPlan:
        cap = self.buffer_size or ctx.fed.clients_per_round
        dispatched = 0
        while len(self._in_flight) < cap:
            self._dispatch(rnd, ctx)
            dispatched += 1
        due = [f for f in self._in_flight if f["completes"] <= rnd]
        if not due:
            soonest = min(f["completes"] for f in self._in_flight)
            due = [f for f in self._in_flight if f["completes"] == soonest]
        # remove by identity: entries hold adapter trees, so equality
        # comparison (list.remove) would raise on array truthiness
        self._in_flight = [f for f in self._in_flight
                           if not any(f is d for d in due)]
        raw, tasks = [], []
        for f in due:
            stale = max(0, rnd - f["dispatched"])
            n_k = ctx.clients[f["client_id"]].num_samples
            raw.append(n_k * (1.0 + stale) ** (-self.staleness_power))
            tasks.append(ClientTask(f["client_id"],
                                    ctx.client_ranks[f["client_id"]],
                                    ctx.local_steps, 0.0, staleness=stale,
                                    init_adapters=f["init"]))
        total = sum(raw)
        for t, w in zip(tasks, raw):
            t.weight = w / total
        # downlink happened at dispatch time (the snapshot), not arrival
        return RoundPlan(rnd, tasks, downloads=dispatched)

    def state_dict(self) -> Dict:
        from repro_torch.checkpoint.io import to_host
        return {"in_flight": [dict(f, init=to_host(f["init"]))
                              for f in self._in_flight]}

    def load_state_dict(self, state: Dict, device: Any = "cpu") -> None:
        from repro_torch.checkpoint.io import to_device
        self._in_flight = [dict(f, init=to_device(f["init"], device))
                           for f in state.get("in_flight", [])]


@register_scheduler("sampled")
class SampledScheduler(RoundScheduler):
    """Per-round participation fraction over the full population.

    Draws ``max(min_clients, fraction · num_clients)`` participants from a
    rng keyed on ``(seed, rnd)`` *only* — unlike ``sync``, whose draw
    consumes the trainer's shared ``ctx.rng`` stream, the participant set
    is a pure function of (federated seed, round): two runs with the same
    seed pick identical sets even if other components consumed randomness
    in between.  ``drop_rate``/``straggler_rate`` compose the ``partial``
    semantics on top of the sample (a sampled client may still drop out or
    finish a cut step budget); weights renormalize over survivors.
    """

    def __init__(self, fraction: float = 0.1, min_clients: int = 1,
                 drop_rate: float = 0.0, straggler_rate: float = 0.0,
                 min_steps: int = 1):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.fraction = fraction
        self.min_clients = min_clients
        self.drop_rate = drop_rate
        self.straggler_rate = straggler_rate
        self.min_steps = min_steps

    def plan(self, rnd: int, ctx) -> RoundPlan:
        fed = ctx.fed
        srng = np.random.default_rng([fed.seed, 7919, rnd])
        k = min(fed.num_clients,
                max(self.min_clients,
                    int(round(self.fraction * fed.num_clients))))
        sampled = sorted(int(c) for c in
                         srng.choice(fed.num_clients, k, replace=False))
        survivors: List[Tuple[int, int]] = []
        for c in sampled:
            if self.drop_rate and srng.random() < self.drop_rate:
                continue
            steps = ctx.local_steps
            if self.straggler_rate and srng.random() < self.straggler_rate:
                steps = max(self.min_steps,
                            int(round(ctx.local_steps
                                      * srng.uniform(0.25, 1.0))))
            survivors.append((c, steps))
        if not survivors:            # never an empty round
            survivors = [(sampled[0], ctx.local_steps)]
        n_total = sum(ctx.clients[c].num_samples for c, _ in survivors)
        tasks = [ClientTask(c, ctx.client_ranks[c], steps,
                            ctx.clients[c].num_samples / n_total)
                 for c, steps in survivors]
        return RoundPlan(rnd, tasks)


# ---------------------------------------------------------------------------
# rank policies (AFLoRA-style resource-aware rank assignment)
# ---------------------------------------------------------------------------


class RankPolicy:
    """Post-plan hook adapting each task's LoRA rank to client resources.

    ``assign(rnd, plan, ctx)`` mutates ``task.rank`` in place (never above
    the client's configured rank — the shared A init only has that many
    rows).  Runs after the scheduler builds the plan and before the runner
    trains it, so policies see exactly the participating tasks.
    """

    name: str = "?"

    def assign(self, rnd: int, plan: RoundPlan, ctx) -> None:
        raise NotImplementedError


_RANK_POLICIES: Dict[str, Type[RankPolicy]] = {}


def register_rank_policy(name: str):
    def deco(cls: Type[RankPolicy]) -> Type[RankPolicy]:
        _RANK_POLICIES[name] = cls
        cls.name = name
        return cls
    return deco


def make_rank_policy(spec: Any, **cfg) -> RankPolicy:
    if isinstance(spec, RankPolicy):
        return spec
    try:
        return _RANK_POLICIES[spec](**cfg)
    except KeyError:
        raise ValueError(f"unknown rank policy {spec!r} "
                         f"(registered: {sorted(_RANK_POLICIES)})") from None


def available_rank_policies() -> List[str]:
    return sorted(_RANK_POLICIES)


@register_rank_policy("static")
class StaticRankPolicy(RankPolicy):
    """Keep the scheduler-assigned (config-profile) ranks untouched."""

    def assign(self, rnd: int, plan: RoundPlan, ctx) -> None:
        return


@register_rank_policy("resource")
class ResourceRankPolicy(RankPolicy):
    """AFLoRA-style resource-aware ranks (arXiv:2505.24773).

    Each client declares a compute budget in (0, 1] — by default a cyclic
    tier profile ``budgets[client_id % len(budgets)]``, or an explicit
    ``profile`` list.  A task's rank is its configured cap scaled by the
    budget and a linear ``warmup`` ramp (AFLoRA grows ranks as training
    stabilizes), snapped DOWN to a power of two so equal-rank cohorts stay
    batchable (at most O(log r) distinct compiled shapes per round).
    """

    def __init__(self, budgets: Tuple[float, ...] = (0.25, 0.5, 0.75, 1.0),
                 warmup: int = 0, profile: Optional[List[float]] = None):
        self.budgets = tuple(budgets)
        self.warmup = int(warmup)
        self.profile = profile

    def assign(self, rnd: int, plan: RoundPlan, ctx) -> None:
        ramp = min(1.0, (rnd + 1) / self.warmup) if self.warmup else 1.0
        for task in plan.tasks:
            cap = ctx.client_ranks[task.client_id]
            if self.profile is not None:
                budget = self.profile[task.client_id % len(self.profile)]
            else:
                budget = self.budgets[task.client_id % len(self.budgets)]
            r = max(1, int(cap * budget * ramp))
            task.rank = min(cap, 1 << (r.bit_length() - 1))   # pow2 floor
