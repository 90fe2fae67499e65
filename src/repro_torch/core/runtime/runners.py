"""Client runners (port of ``repro.core.runtime.runners``, the
``sequential`` runner): who executes a round's local fine-tuning.

A :class:`ClientRunner` trains every task of a :class:`RoundPlan` against
the round context ``ctx`` (the trainer: frozen ``params``, ``clients``,
``batch_size``, ``device``, ``_client_init``, ``_train_step``) and calls
``deliver(task, trained_adapters, init_adapters)`` once per client.  The
``cohort`` and ``sharded_cohort`` runners wait for a later slice.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.optim.adamw import adamw_init


class ClientRunner:
    """Local-training executor.  Subclasses implement :meth:`run`."""

    name: str = "?"

    def run(self, ctx, plan, deliver: Callable) -> None:
        raise NotImplementedError


def _init_getter(ctx):
    """Per-plan client-init resolver: ``Aggregator.client_init`` depends
    only on the task's rank, so equal-rank tasks share one tree."""
    cache: Dict[int, Dict] = {}

    def get(task) -> Dict:
        if task.rank not in cache:
            cache[task.rank] = ctx._client_init(task.client_id, task.rank)
        return cache[task.rank]

    return get


def _batch_schedule(ctx, rnd: int, task) -> List[Dict[str, np.ndarray]]:
    """The exact batch sequence of the reference's loop for this task (rng
    ``default_rng(1000·rnd + client_id)``, epoch re-permutation)."""
    data = ctx.clients[task.client_id]
    bs = min(ctx.batch_size, data.num_samples)
    brng = np.random.default_rng(1000 * rnd + task.client_id)
    batches: List[Dict[str, np.ndarray]] = []
    while len(batches) < task.steps:
        for batch in data.batches(bs, brng):
            batches.append(batch)
            if len(batches) >= task.steps:
                break
    return batches


def to_device(tree: Any, device: torch.device) -> Any:
    """A nested dict of tensors / numpy arrays as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, device=device)


class SequentialRunner(ClientRunner):
    """One train-step call per (client, batch), clients one after another.

    With ``record_steps`` every step's time is kept in :meth:`step_log`
    (CUDA events on the card, the host clock on the CPU) with its round
    and client, for the caller to read after the round."""

    name = "sequential"

    def __init__(self, record_steps: bool = False):
        self.record_steps = record_steps
        self._log: List[Dict[str, Any]] = []

    def _timer(self, device: torch.device):
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def run(self, ctx, plan, deliver: Callable) -> None:
        step = ctx._train_step()
        task_init = _init_getter(ctx)
        dev = ctx.device
        for task in plan.tasks:
            init_adapters = task_init(task)
            adapters = to_device(init_adapters, dev)
            opt_state = adamw_init(adapters)
            for i, batch in enumerate(_batch_schedule(ctx, plan.round, task)):
                tb = {"tokens": torch.as_tensor(batch["tokens"], device=dev).long(),
                      "loss_mask": torch.as_tensor(batch["loss_mask"], device=dev)}
                t0 = self._timer(dev) if self.record_steps else None
                adapters, opt_state, _ = step(ctx.params, adapters, opt_state, tb)
                if self.record_steps:
                    self._log.append({"round": plan.round, "client": task.client_id,
                                      "step": i, "start": t0,
                                      "end": self._timer(dev)})
            deliver(task, adapters, init_adapters)

    def step_log(self) -> List[Dict[str, Any]]:
        """Recorded steps as ``{"round", "client", "step", "ms"}`` (waits
        for the device)."""
        if self._log and not isinstance(self._log[0]["start"], float):
            torch.cuda.synchronize()
        return [{"round": e["round"], "client": e["client"], "step": e["step"],
                 "ms": (e["start"].elapsed_time(e["end"])
                        if not isinstance(e["start"], float)
                        else (e["end"] - e["start"]) * 1e3)}
                for e in self._log]


_RUNNERS = {"sequential": SequentialRunner}


def make_runner(spec: Any) -> ClientRunner:
    if isinstance(spec, ClientRunner):
        return spec
    if spec in ("cohort", "sharded_cohort"):
        raise NotImplementedError(
            f"runner {spec!r} is not ported yet (later runtime-breadth slice "
            "of the port); use 'sequential'")
    try:
        return _RUNNERS[spec]()
    except KeyError:
        raise ValueError(f"unknown runner {spec!r} "
                         f"(registered: {sorted(_RUNNERS)})") from None


def available_runners() -> List[str]:
    return sorted(_RUNNERS)
