"""Round schedulers and rank policies (port of
``repro.core.runtime.schedulers``): who participates in a federated round.

A :class:`RoundScheduler` turns "round ``rnd`` is starting" into a
:class:`RoundPlan` of :class:`ClientTask` s (local step budget, normalized
aggregation weight).  It reads the trainer as its round context: ``rng``,
``fed``, ``clients``, ``client_ranks``, ``local_steps``.  The ``sync``
scheduler and the ``static`` rank policy are ported; ``partial``,
``async``, ``sampled`` and the ``resource`` policy wait for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Type


@dataclasses.dataclass
class ClientTask:
    """One client's assignment for a round."""
    client_id: int
    rank: int
    steps: int                      # local fine-tuning step budget
    weight: float                   # normalized aggregation weight


@dataclasses.dataclass
class RoundPlan:
    round: int
    tasks: List[ClientTask]


class RoundScheduler:
    """Participation policy.  Subclasses implement :meth:`plan`."""

    name: str = "?"

    def plan(self, rnd: int, ctx) -> RoundPlan:
        raise NotImplementedError


class SyncScheduler(RoundScheduler):
    """Sample K clients, wait for all K; weights by sample counts (the same
    numpy rng call and weight arithmetic as the reference)."""

    name = "sync"

    def plan(self, rnd: int, ctx) -> RoundPlan:
        fed = ctx.fed
        sampled = list(ctx.rng.choice(fed.num_clients, fed.clients_per_round,
                                      replace=False))
        n_total = sum(ctx.clients[k].num_samples for k in sampled)
        tasks = [ClientTask(int(k), ctx.client_ranks[k], ctx.local_steps,
                            ctx.clients[k].num_samples / n_total)
                 for k in sampled]
        return RoundPlan(rnd, tasks)


class RankPolicy:
    """Post-plan hook that may adapt each task's LoRA rank."""

    name: str = "?"

    def assign(self, rnd: int, plan: RoundPlan, ctx) -> None:
        raise NotImplementedError


class StaticRankPolicy(RankPolicy):
    """Keep the configured (heterogeneous) ranks untouched."""

    name = "static"

    def assign(self, rnd: int, plan: RoundPlan, ctx) -> None:
        return


_SCHEDULERS: Dict[str, Type[RoundScheduler]] = {"sync": SyncScheduler}
_RANK_POLICIES: Dict[str, Type[RankPolicy]] = {"static": StaticRankPolicy}


def _make(kind: str, registry: Dict, not_ported, spec: Any, base: type):
    if isinstance(spec, base):
        return spec
    if spec in not_ported:
        raise NotImplementedError(
            f"{kind} {spec!r} is not ported yet (later runtime-breadth slice "
            "of the port)")
    try:
        return registry[spec]()
    except KeyError:
        raise ValueError(f"unknown {kind} {spec!r} "
                         f"(registered: {sorted(registry)})") from None


def make_scheduler(spec: Any) -> RoundScheduler:
    return _make("scheduler", _SCHEDULERS, ("partial", "async", "sampled"),
                 spec, RoundScheduler)


def make_rank_policy(spec: Any) -> RankPolicy:
    return _make("rank policy", _RANK_POLICIES, ("resource",), spec,
                 RankPolicy)


def available_schedulers() -> List[str]:
    return sorted(_SCHEDULERS)
