"""Mesh construction on ``torch.distributed`` (port of
``repro.topology.mesh``).

A :class:`Mesh` lays the ranks of the default process group out row-major
over named axes, ``("data", "model")`` (``("pod", "data", "model")`` for
the multi-pod production layout), as ``jax.make_mesh`` lays out devices.
Each rank knows its coordinates, one sub-group per axis of size > 1 (the
whole world's group where the axis spans it) and its device:
``cuda:(rank % device_count)``, or the CPU when asked.

* Serving: ``(data=1, model=N)``: every rank goes to tensor parallelism.
* Federated simulation: ``(data=N, model=1)``: the cohort's client axis.

With no process group initialised the world is this process alone: the
mesh builders return one-rank meshes whose collectives are identities, so
a sharded path in one process behaves as the reference does on one device.

The backend is the caller's choice (:func:`spawn`, or ``torchrun``):
``gloo`` on the CPU, ``gloo`` with every rank on one card (the collectives
then go through the host: a CUDA tensor is staged through a CPU copy), or
``nccl`` where each rank has its own card.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Ranks of the default process group over named axes.

    ``shape`` maps axis name to size (in axis order, the name→size mapping
    the reference's ``Mesh.shape`` is); ``coords`` this rank's index on
    each axis; ``device`` this rank's device.  ``all_reduce``,
    ``all_gather`` and ``all_to_all`` run over one axis's group, or over
    a tuple of axes (the world's group when they are every axis of size
    > 1), and are identities where the size is 1.  A mesh built with
    ``abstract=True`` (:func:`abstract_mesh`) has no groups: the partition
    rules read only its ``shape``."""

    def __init__(self, shape: Dict[str, int], *, rank: int = 0,
                 device: Optional[torch.device] = None,
                 abstract: bool = False):
        self.shape = {k: int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values()))) if self.shape else 1
        self.rank = rank
        idx = np.unravel_index(rank, tuple(self.shape.values())) \
            if self.shape else ()
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self.device = device or torch.device("cpu")
        self.abstract = abstract
        self.backend: Optional[str] = None
        self._groups: Dict[str, Any] = {}
        if abstract or self.size == 1:
            return
        self.backend = dist.get_backend()
        sizes = tuple(self.shape.values())
        grid = np.arange(self.size).reshape(sizes)
        for ax_i, ax in enumerate(self.axis_names):
            if self.shape[ax] == 1:
                continue
            # every rank creates every group of this axis, in one order
            lines = np.moveaxis(grid, ax_i, -1).reshape(-1, sizes[ax_i])
            for line in lines:
                ranks = [int(r) for r in line]
                group = (dist.group.WORLD if len(ranks) == self.size
                         else dist.new_group(ranks))
                if rank in ranks:
                    self._groups[ax] = group

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")

    def axis_size(self, name) -> int:
        """The size of axis ``name``, or of a tuple of axes (their
        product)."""
        if isinstance(name, tuple):
            return int(np.prod([self.shape.get(a, 1) for a in name]))
        return self.shape.get(name, 1)

    def axis_index(self, name) -> int:
        """This rank's index on ``name``, or on a tuple of axes (row-major
        over them: data-major for ``("data", "model")``, as the
        reference's ``all_to_all`` over that tuple orders its blocks)."""
        if isinstance(name, tuple):
            idx = 0
            for a in name:
                idx = idx * self.shape.get(a, 1) + self.coords.get(a, 0)
            return idx
        return self.coords.get(name, 0)

    def live_axes(self, axis) -> Tuple[str, ...]:
        """The axes of size > 1 among ``axis`` (a name or a tuple)."""
        names = axis if isinstance(axis, tuple) else (axis,)
        return tuple(a for a in names if self.shape.get(a, 1) > 1)

    def _group(self, axis):
        """The process group of ``axis``: one axis's sub-group, or for a
        tuple of axes the one axis of size > 1 among them, or the world's
        group when they hold every axis of size > 1 (a mesh spans the
        world, so the world's ranks are in the tuple's row-major order)."""
        live = self.live_axes(axis)
        if len(live) == 1:
            return self._groups[live[0]]
        if set(live) != set(self.live_axes(self.axis_names)):
            raise ValueError(f"a collective over {axis} on a mesh of "
                             f"{self.shape}: only one axis or all of them")
        return dist.group.WORLD

    # -- collectives over one axis -------------------------------------------
    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective runs on: gloo moves CUDA tensors through
        the host anyway, so they go to a pinned CPU copy here (a new
        tensor; page-locked, so both copies run at the link's rate and the
        copy back to the card does not hold the host)."""
        if not (self.backend == "gloo" and t.is_cuda):
            return t
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)

    @staticmethod
    def _like(src: torch.Tensor) -> torch.Tensor:
        """A receive buffer like ``src`` (pinned where ``src`` is)."""
        return torch.empty(src.shape, dtype=src.dtype,
                           pin_memory=src.is_pinned())

    @staticmethod
    def _back(t: torch.Tensor, device: torch.device) -> torch.Tensor:
        return t.to(device, non_blocking=True)

    def all_reduce(self, t: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """The sum of ``t`` over ``axis`` (a new tensor; ``t`` is kept)."""
        if self.axis_size(axis) == 1:
            return t
        buf = self._stage(t)
        if buf is t:
            buf = t.clone()
        dist.all_reduce(buf, group=self._group(axis))
        return self._back(buf, t.device)

    def all_reduce_all(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over every axis (the whole world: a mesh spans
        it) in one ``all_reduce`` (a new tensor; ``t`` is kept)."""
        if self.size == 1:
            return t
        buf = self._stage(t)
        if buf is t:
            buf = t.clone()
        dist.all_reduce(buf)
        return self._back(buf, t.device)

    def all_gather(self, t: torch.Tensor, axis: str = "model",
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` on ``axis``, concatenated along ``dim`` in
        axis-index order (on ``t``'s device)."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        src = self._stage(t.contiguous())
        parts = [self._like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._group(axis))
        return torch.cat([self._back(p, t.device) for p in parts], dim=dim)

    def all_to_all(self, t: torch.Tensor, axis: str = "model",
                   split_dim: int = 0, concat_dim: int = 0) -> torch.Tensor:
        """The tiled all-to-all of ``jax.lax.all_to_all(..., tiled=True)``:
        ``t`` is cut into ``n`` equal blocks along ``split_dim``, block j
        goes to the rank of index j on ``axis``, and the blocks this rank
        receives are concatenated along ``concat_dim`` in axis-index order.
        ``axis`` may be a tuple of axes (``("data", "model")``: n their
        product, index j row-major over them, through the world's group).
        One ``all_to_all_single`` (through a pinned CPU copy under gloo);
        the received blocks are written into the result one at a time, so
        the card holds one block beside it, not a second whole copy."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        src = t.movedim(split_dim, 0)
        src = src.reshape((n, src.shape[0] // n) + tuple(src.shape[1:]))
        src = self._stage(src.contiguous())
        out = self._like(src)
        dist.all_to_all_single(out, src, group=self._group(axis))
        del src
        shape = list(t.shape)
        shape[split_dim] //= n
        w = shape[concat_dim]
        shape[concat_dim] *= n
        res = t.new_empty(shape)
        for j in range(n):
            res.narrow(concat_dim, j * w, w).copy_(
                self._back(out[j], t.device).movedim(0, split_dim))
        return res

    def all_gather_packed(self, ts: Sequence[torch.Tensor],
                          axis: str = "model") -> Tuple[torch.Tensor, ...]:
        """Every rank's ``ts`` concatenated along their leading axis (one
        length on a rank, the same on every rank) in axis-index order,
        through ONE ``all_gather``: the tensors go packed into one ``(k,
        F)`` buffer of their widest dtype, at least float32, so bf16, fp32
        and integer counts below 2**24 come back unchanged."""
        if self.axis_size(axis) == 1:
            return tuple(ts)
        dt = torch.float32
        for t in ts:
            dt = torch.promote_types(dt, t.dtype)
        k = ts[0].shape[0]
        flat = torch.cat([t.detach().reshape(k, -1).to(dt) for t in ts], dim=1)
        allf = self.all_gather(flat, axis, dim=0)           # (n·k, F)
        out, off = [], 0
        for t in ts:
            w = int(np.prod(t.shape[1:]))
            out.append(allf[:, off: off + w]
                       .reshape((allf.shape[0],) + tuple(t.shape[1:]))
                       .to(t.dtype))
            off += w
        return tuple(out)


def abstract_mesh(shape: Dict[str, int]) -> Mesh:
    """A device-free mesh of ``shape`` for the partition rules (the
    reference validates them on ``jax.sharding.AbstractMesh``)."""
    return Mesh(shape, abstract=True)


def _rank_device(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank, _ = world()
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _make(shape: Dict[str, int], what: str, device: DeviceLike) -> Mesh:
    n = int(np.prod(list(shape.values())))
    rank, size = world()
    if n > size:
        raise ValueError(f"requested {what}={n} but only {size} devices")
    if n not in (1, size):
        raise ValueError(f"a mesh of {n} ranks in a world of {size}: a mesh "
                         "spans the whole process group (or one rank)")
    return Mesh(shape, rank=rank if n > 1 else 0, device=_rank_device(device))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The reference's production layout, (data=16, model=16) or (pod=2,
    data=16, model=16): the world must hold that many ranks."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return _make(shape, "devices", device)


def make_host_mesh(model: int = 1, device: DeviceLike = None) -> Mesh:
    """(data=world/model, model) over every rank of the world."""
    _, size = world()
    if size % model:
        raise ValueError(f"model={model} does not divide {size} devices")
    return _make({"data": size // model, "model": model}, "model", device)


def make_serve_mesh(model: int = 0, *, device: DeviceLike = None) -> Mesh:
    """Serving mesh (data=1, model=N); ``model=0`` takes every rank."""
    _, size = world()
    n = model or size
    return _make({"data": 1, "model": n}, "model", device)


def make_fed_mesh(data: int = 0, *, device: DeviceLike = None) -> Mesh:
    """Federated simulation mesh (data=N, model=1); ``data=0`` takes every
    rank.  ``model`` is kept (size 1) so the fed specs and the training
    specs share one axis vocabulary."""
    _, size = world()
    n = data or size
    return _make({"data": n, "model": 1}, "data", device)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes carrying the batch dimension."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, name: str) -> int:
    """Axis size by name (1 for absent axes), read from ``mesh.shape``."""
    return dict(mesh.shape).get(name, 1)


# -- launching a world -------------------------------------------------------

def under_torchrun() -> bool:
    """Whether this process is a rank that ``torchrun`` started."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _child(rank: int, fn: Callable, world_size: int, backend: str,
           device: str, store: str, out_dir: str, timeout_s: float,
           threads: int, args: Sequence) -> None:
    if device.startswith("cuda"):
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
        torch.save(_to_cpu(result), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str = "gloo",
          device: str = "cpu", args: Sequence = (), timeout_s: float = 300.0,
          threads: int = 1) -> Dict[int, Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks of a fresh process group
    and return ``{rank: result}`` (tensors moved to the CPU).

    Ranks are ``torch.multiprocessing`` processes of the spawn start
    method, meeting through a ``file://`` store in a temporary directory
    (no port, no network); every collective times out after ``timeout_s``.
    A rank that raises fails the call (the others are stopped): nothing is
    swallowed.  ``device="cuda"`` pins rank r to ``cuda:(r % count)``;
    CPU ranks run ``threads`` intra-op threads each.  Under ``torchrun``
    the environment's rendezvous is used instead and only this rank's
    result comes back, as ``{this rank: result}``: a caller that starts
    worlds of its own sizes (a bench's axis) refuses to run there."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r} (gloo or nccl)")
    if under_torchrun():
        if not dist.is_initialized():
            dist.init_process_group(
                backend, init_method="env://",
                timeout=datetime.timedelta(seconds=timeout_s))
        if dist.get_world_size() != world_size:
            raise ValueError(f"torchrun started {dist.get_world_size()} "
                             f"ranks, {world_size} asked for")
        if device.startswith("cuda"):
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        return {dist.get_rank(): fn(*args)}
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    try:
        store = os.path.join(tmp, "store")
        mp.start_processes(_child, nprocs=world_size, join=True,
                           start_method="spawn",
                           args=(fn, world_size, backend, device, store, tmp,
                                 timeout_s, threads, tuple(args)))
        return {r: torch.load(os.path.join(tmp, f"rank{r}.pt"),
                              weights_only=False) for r in range(world_size)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_world(fn: Callable, world_size: int, backend: str = "gloo",
              device: Optional[str] = None, args: Sequence = (),
              timeout_s: float = 300.0) -> Dict[int, Any]:
    """Run a launcher's body ``fn(*args)`` on an SPMD world of
    ``world_size`` ranks and return ``{rank: result}`` of the ranks this
    process saw.  Under ``torchrun`` ``fn`` runs on this rank of the
    environment's world (which must hold ``world_size`` ranks); in a
    process that is already a rank of such a world, or with one rank
    asked for, it runs here; otherwise ``world_size`` ranks are spawned
    here (``device`` the launcher's ``--device``: ``"cpu"``, else every
    rank on a card) and every rank's result comes back."""
    in_group = dist.is_available() and dist.is_initialized()
    if under_torchrun() or (world_size > 1 and not in_group):
        return spawn(fn, world_size, backend,
                     "cpu" if device == "cpu" else "cuda", args=args,
                     timeout_s=timeout_s)
    rank, size = world()
    if world_size > 1 and size != world_size:
        raise ValueError(f"a world of {world_size} ranks asked for inside a "
                         f"world of {size}")
    return {rank: fn(*args)}


def rank0_print(*a, **kw) -> None:
    """``print`` on rank 0 of the world (or in a lone process); nothing on
    the other ranks."""
    if world()[0] == 0:
        print(*a, **kw)
