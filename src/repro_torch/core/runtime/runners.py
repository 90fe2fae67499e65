"""Client runners (port of ``repro.core.runtime.runners``): who executes a
round's local fine-tuning, and how.

A :class:`ClientRunner` trains every task of a :class:`RoundPlan` against
the round context ``ctx`` (the trainer: frozen ``params``, ``clients``,
``batch_size``, ``device``, ``_client_init``, ``_train_step``,
``_cohort_step``) and calls ``deliver(task, trained_adapters,
init_adapters)`` once per client, in plan order.  Both runners deliver
one form (:func:`_unstack`): A and B as float32 numpy off one
device→host copy per block (a cohort, or one client), every other leaf
(``scale``) a view on the device, so the server folds on the device.

* ``sequential`` — one client at a time (batch rng ``default_rng(1000·rnd
  + client_id)``, the reference's step order);
* ``cohort`` — tasks are grouped into equal-(rank, steps) cohorts; their
  init adapters and pre-drawn batch schedules are stacked along a client
  axis, and each cohort trains through one cohort step a local step
  (:func:`repro_torch.train.step.make_cohort_train_step`: every projection
  of the whole cohort in one ``lora_matmul`` launch, attention at batch
  C·B).  Ragged batch sizes are zero-masked rows and the client axis is
  padded to a power of two with replicas that are never delivered, so the
  cohort trains each client as the sequential loop does, up to
  batched-matmul reassociation; in a MoE model a ragged client's padded
  rows take expert capacity and enter its aux, as in the reference
  (:func:`_stack_cohort`).

* ``sharded_cohort`` — the cohort runner with the client axis over a fed
  mesh's ``data`` axis (:class:`ShardedCohortRunner`): every rank of an
  SPMD world trains its share of each block of clients and one
  ``all_gather`` hands every rank the whole block.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.aggregators.base import (adapter_leaf_paths, get_path,
                                               set_path)
from repro_torch.optim.adamw import adamw_init, tree_leaves, tree_map


class ClientRunner:
    """Local-training executor.  Subclasses implement :meth:`run`.

    With ``record_steps`` every train-step call's time is kept in
    :meth:`step_log` (CUDA events on the card, the host clock on the CPU)
    with its round and client(s), for the caller to read after the round."""

    name: str = "?"

    def __init__(self, record_steps: bool = False):
        self.record_steps = record_steps
        self._log: List[Dict[str, Any]] = []

    def run(self, ctx, plan, deliver: Callable) -> None:
        raise NotImplementedError

    def _timer(self, device: torch.device):
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def step_log(self) -> List[Dict[str, Any]]:
        """Recorded steps as ``{"round", "client", "clients", "step",
        "ms"}`` (waits for the device); ``clients`` lists a cohort step's
        clients, ``client`` is the first of them."""
        if self._log and not isinstance(self._log[0]["start"], float):
            torch.cuda.synchronize()
        return [{"round": e["round"], "client": e["clients"][0],
                 "clients": e["clients"], "step": e["step"],
                 "ms": (e["start"].elapsed_time(e["end"])
                        if not isinstance(e["start"], float)
                        else (e["end"] - e["start"]) * 1e3)}
                for e in self._log]


def _init_getter(ctx):
    """Per-plan client-init resolver: a task resumes from its dispatch-time
    snapshot (async) or the aggregator's client-init for the current global
    state.  ``Aggregator.client_init`` depends only on the task's rank, so
    equal-rank tasks share one tree."""
    cache: Dict[int, Dict] = {}

    def get(task) -> Dict:
        if task.init_adapters is not None:
            return task.init_adapters
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
    """One train-step call per (client, batch), clients one after another."""

    name = "sequential"

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
                    self._log.append({"round": plan.round,
                                      "clients": [task.client_id], "step": i,
                                      "start": t0, "end": self._timer(dev)})
            deliver(task, _unstack(tree_map(lambda t: t[None], adapters), 1)[0],
                    init_adapters)


def _group_cohorts(plan) -> Dict[Tuple[int, int], List]:
    """Tasks bucketed by (rank, steps), in plan order: each bucket trains
    as one cohort."""
    cohorts: Dict[Tuple[int, int], List] = {}
    for task in plan.tasks:
        cohorts.setdefault((task.rank, task.steps), []).append(task)
    return cohorts


def _stack_cohort(ctx, rnd: int, tasks: List, task_init, pad_c: int):
    """Host-side prep for one cohort: replay the sequential batch draws,
    zero-pad ragged batch sizes (padded rows carry ``loss_mask = 0``),
    stack the inits and batches along a client axis, and pad the client
    axis to ``pad_c`` with replicas of the first client on zero masks,
    which train only their own copies and are never delivered.

    Padded rows add nothing to the CE or the token count, and in a dense,
    MLA or RWKV6 model nothing to any gradient.  In a MoE model they are
    not inert, as in the reference (whose ``vmap`` of one client's step
    pads the same way): they are routed with the client's real rows, take
    expert capacity (so they can push a real token past ``C``) and enter
    the client's load-balancing aux.  With no row padded the cohort equals
    the sequential runner.

    Returns ``(stacked adapters on the device, {"tokens", "loss_mask"} of
    shape (pad_c, steps, batch, seq), inits)``, ``inits`` the unpadded
    per-task init trees (the DP stage and the gate need them)."""
    steps = tasks[0].steps
    scheds = [_batch_schedule(ctx, rnd, t) for t in tasks]
    seq_len = scheds[0][0]["tokens"].shape[1]
    bs = ctx.batch_size                  # fixed batch axis: a stable shape
    toks = np.zeros((pad_c, steps, bs, seq_len), np.int64)
    mask = np.zeros((pad_c, steps, bs, seq_len), np.float32)
    for ci, sched in enumerate(scheds):
        for si, b in enumerate(sched):
            toks[ci, si, : b["tokens"].shape[0]] = b["tokens"]
            mask[ci, si, : b["tokens"].shape[0]] = b["loss_mask"]
    inits = [task_init(t) for t in tasks]
    dev = ctx.device
    padded = [to_device(t, dev) for t in inits]
    padded += [padded[0]] * (pad_c - len(tasks))
    stacked = tree_map(lambda *xs: torch.stack(xs), *padded)
    return stacked, {"tokens": toks, "loss_mask": mask}, inits


def _unstack(stacked: Dict, n: int) -> List[Dict]:
    """The first ``n`` clients' trees of a stacked tree, in the form both
    runners deliver.  The wire arrays (A and B) come to the host as float32
    numpy views of ONE device→host copy of all of them; the other leaves
    (``scale``, which never travels) stay on the device as views, so the
    server folds on the device."""
    paths = []

    def walk(node, path):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k], path + (k,))
            else:
                paths.append(path + (k,))

    walk(stacked, ())

    def get(path):
        node = stacked
        for k in path:
            node = node[k]
        return node

    wire = [p for p in paths if p[-1] in ("A", "B")]
    pad_c = get(paths[0]).shape[0]
    flat = torch.cat([get(p).detach().reshape(pad_c, -1).float() for p in wire],
                     dim=1).cpu().numpy()
    out = []
    for ci in range(n):
        tree: Dict = {}
        off = 0
        for p in paths:
            leaf = get(p)
            if p in wire:
                size = int(np.prod(leaf.shape[1:]))
                val = flat[ci, off: off + size].reshape(tuple(leaf.shape[1:]))
                off += size
            else:
                val = leaf[ci].detach()
            node = tree
            for k in p[:-1]:
                node = node.setdefault(k, {})
            node[p[-1]] = val
        out.append(tree)
    return out


class CohortRunner(ClientRunner):
    """Equal-(rank, steps) cohorts, each trained through one cohort step a
    local step (one ``lora_matmul`` launch a projection for the whole
    cohort).  The client axis is padded to the next power of two, so
    schedulers with varying arrival counts hit O(log K) shapes.  Each
    cohort is staged, trained and its A and B copied to the host (one
    copy) before the next; results are delivered in plan order, so the aggregator's stack
    columns are in the sequential runner's order.  ``peak_live_clients``
    records the largest padded cohort held at once."""

    name = "cohort"

    def __init__(self, record_steps: bool = False):
        super().__init__(record_steps)
        self.peak_live_clients = 0

    @staticmethod
    def _pad(k_c: int) -> int:
        return 1 << (k_c - 1).bit_length()       # next power of two

    def _train(self, ctx, step, rnd: int, stacked: Dict, batch: Dict,
               clients: List[int]) -> Dict:
        """The local steps of one stacked cohort (``batch`` its
        ``(C, steps, batch, seq)`` arrays): one cohort-step call a step;
        returns the trained tree."""
        dev = ctx.device
        toks = torch.as_tensor(batch["tokens"], device=dev)
        mask = torch.as_tensor(batch["loss_mask"], device=dev)
        opt_state = adamw_init(stacked)
        for i in range(toks.shape[1]):
            t0 = self._timer(dev) if self.record_steps else None
            stacked, opt_state, _ = step(
                ctx.params, stacked, opt_state,
                {"tokens": toks[:, i], "loss_mask": mask[:, i]})
            if self.record_steps:
                self._log.append({"round": rnd, "clients": clients, "step": i,
                                  "start": t0, "end": self._timer(dev)})
        return stacked

    def run(self, ctx, plan, deliver: Callable) -> None:
        step = ctx._cohort_step()
        task_init = _init_getter(ctx)
        order = {id(t): i for i, t in enumerate(plan.tasks)}
        buffered: Dict[int, Tuple] = {}
        for tasks in _group_cohorts(plan).values():
            pad_c = self._pad(len(tasks))
            stacked, batch, inits = _stack_cohort(ctx, plan.round, tasks,
                                                  task_init, pad_c)
            self.peak_live_clients = max(self.peak_live_clients, pad_c)
            stacked = self._train(ctx, step, plan.round, stacked, batch,
                                  [t.client_id for t in tasks])
            for task, adapters, init in zip(
                    tasks, _unstack(stacked, len(tasks)), inits):
                buffered[order[id(task)]] = (task, adapters, init)
        for i in sorted(buffered):
            deliver(*buffered[i])


def _gather_clients(mesh, stacked: Dict) -> Dict:
    """Every rank's client slice of a stacked tree, concatenated along the
    client axis in rank order on every rank, through one packed
    ``all_gather`` over ``data``."""
    paths = [p + (k,) for p in adapter_leaf_paths(stacked)
             for k in get_path(stacked, p)]
    out: Dict = {}
    for p, t in zip(paths, mesh.all_gather_packed(
            [get_path(stacked, p) for p in paths], "data")):
        set_path(out, p, t)
    return out


class ShardedCohortRunner(CohortRunner):
    """Cohort training with the client axis sharded over a fed mesh's
    ``data`` axis (``N`` ranks of an SPMD world, every rank running the same
    trainer with the same seed).

    Each (rank, steps) cohort is cut into blocks of at most ``block``
    clients; a block's client axis is padded to a power of two and then to
    a multiple of ``N`` (replicas of its first client, never delivered).
    Each rank stages the whole block's batches (the same draws everywhere),
    trains its ``pad_c / N`` clients through the cohort step (one
    ``lora_matmul`` launch a projection for all of them, attention at the
    rank's batch) and one ``all_gather`` of the trained trees gives every
    rank the block.  Blocks *stream*: each is delivered (cohort-grouped
    order) before the next is staged, so a 1024-client round never holds
    more than ``block`` trained trees; ``peak_live_clients`` records the
    largest padded block.  ``mesh=None`` builds ``make_fed_mesh()`` over
    the world at the first round (one rank without a process group)."""

    name = "sharded_cohort"

    def __init__(self, mesh=None, block: int = 256, record_steps: bool = False):
        super().__init__(record_steps)
        self.mesh = mesh
        self.block = int(block)

    def _mesh(self, device: torch.device):
        if self.mesh is None:
            from repro_torch.topology import make_fed_mesh
            self.mesh = make_fed_mesh(device=device)
        return self.mesh

    def _pad_block(self, k_c: int, data: int) -> int:
        return -(-self._pad(k_c) // data) * data

    def run(self, ctx, plan, deliver: Callable) -> None:
        step = ctx._cohort_step()
        task_init = _init_getter(ctx)
        mesh = self._mesh(ctx.device)
        n, r = mesh.axis_size("data"), mesh.axis_index("data")
        for tasks in _group_cohorts(plan).values():
            for b0 in range(0, len(tasks), self.block):
                block = tasks[b0: b0 + self.block]
                pad_c = self._pad_block(len(block), n)
                stacked, batch, inits = _stack_cohort(ctx, plan.round, block,
                                                      task_init, pad_c)
                self.peak_live_clients = max(self.peak_live_clients, pad_c)
                k = pad_c // n
                mine = slice(r * k, (r + 1) * k)
                local = tree_map(lambda t: t[mine].contiguous(), stacked)
                del stacked
                local = self._train(
                    ctx, step, plan.round, local,
                    {key: v[mine] for key, v in batch.items()},
                    [t.client_id for t in block[mine]] or [block[0].client_id])
                trained = _gather_clients(mesh, local)
                for task, adapters, init in zip(
                        block, _unstack(trained, len(block)), inits):
                    deliver(task, adapters, init)


_RUNNERS = {"sequential": SequentialRunner, "cohort": CohortRunner,
            "sharded_cohort": ShardedCohortRunner}


def make_runner(spec: Any) -> ClientRunner:
    if isinstance(spec, ClientRunner):
        return spec
    try:
        return _RUNNERS[spec]()
    except KeyError:
        raise ValueError(f"unknown runner {spec!r} "
                         f"(registered: {sorted(_RUNNERS)})") from None


def available_runners() -> List[str]:
    return sorted(_RUNNERS)
