"""Multi-tenant adapter serving: registry over paged device pools (port of
``repro.serve.adapters``).

Adapters live on the device in fixed-shape paged pools: per LoRA-bearing
leaf one ``([L,] P, page_rank, din)`` A-pool and one
``([L,] P, dout, page_rank)`` B-pool.  An adapter of rank ``r`` occupies
``ceil(r / page_rank)`` pages through an indirection table, so registering,
evicting or swapping an adapter of any rank never changes a shape and never
touches pages held by other adapters: rows in flight (which pin their
adapter *id*) are never perturbed.  Pools and tables are written in place.

Adapter id 0 is reserved for the base model: its rank stays 0, so every
lane of its delta is masked to an exact zero.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.peft.lora import PAGED_IMPLS, PagedLoRA


def _is_adapter_leaf(node: Any) -> bool:
    return isinstance(node, dict) and "A" in node and "B" in node


def _map_adapter_leaves(fn: Callable, node: Any) -> Any:
    """Map ``fn`` over every ``{"A", "B", ...}`` leaf-dict, keeping the
    containers around them."""
    if _is_adapter_leaf(node):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_adapter_leaves(fn, v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_map_adapter_leaves(fn, v) for v in node)
    return node


def adapter_leaves(node: Any, path=()):
    """Yield (path, leaf_dict) for every ``{"A", "B", ...}`` leaf of an
    adapter tree, dict keys sorted."""
    if _is_adapter_leaf(node):
        yield path, node
        return
    if isinstance(node, dict):
        for k in sorted(node):
            yield from adapter_leaves(node[k], path + (k,))
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            yield from adapter_leaves(v, path + (i,))


def attach(device_state: Dict[str, Any], ids: torch.Tensor,
           impl: str = "kernel") -> Any:
    """The adapter tree a decode step consumes: every pool leaf becomes a
    :class:`PagedLoRA` over the pools, the shared table/rank and the
    per-slot ``ids: (B,)``.  Stacked pools keep their layer axis; the
    model's layer loop slices them (:meth:`PagedLoRA.layer`)."""
    if impl not in PAGED_IMPLS:
        raise ValueError(f"unknown paged-LoRA impl {impl!r}")
    table, rank = device_state["table"], device_state["rank"]
    ids = ids.to(torch.int32)

    def mk(leaf):
        return PagedLoRA(leaf["A"], leaf["B"], leaf["scale"], table, rank, ids,
                         impl=impl)

    return _map_adapter_leaves(mk, device_state["pools"])


class AdapterRegistry:
    """Registry of live adapters over fixed-shape paged device pools.

    ``template`` is any adapter tree with the structure to serve; only its
    leaf shapes (and A's dtype, the pools' dtype) matter.

    page_rank:    ranks per page.
    num_pages:    pool capacity in pages (shared by all adapters).
    max_adapters: id-table capacity, including the reserved base id 0.
    max_rank:     largest registrable rank; fixes the table width
                  ``Pmax = ceil(max_rank / page_rank)``.
    """

    def __init__(self, template: Any, *, page_rank: int = 4,
                 num_pages: int = 64, max_adapters: int = 16,
                 max_rank: int = 32, device: DeviceLike = None):
        if page_rank < 1 or num_pages < 1 or max_adapters < 2:
            raise ValueError("page_rank/num_pages >= 1 and max_adapters >= 2"
                             " required")
        self.device = resolve_device(device)
        self.page_rank = page_rank
        self.num_pages = num_pages
        self.max_adapters = max_adapters
        self.max_rank = max_rank
        self.pages_max = max(1, math.ceil(max_rank / page_rank))
        dev = self.device

        def mk_pool(leaf):
            a, b = leaf["A"], leaf["B"]
            lead = tuple(a.shape[:-2])               # (L,) when stacked
            din, dout = a.shape[-1], b.shape[-2]
            return {
                "A": torch.zeros(lead + (num_pages, page_rank, din),
                                 dtype=a.dtype, device=dev),
                "B": torch.zeros(lead + (num_pages, dout, page_rank),
                                 dtype=b.dtype, device=dev),
                "scale": torch.zeros(lead + (max_adapters,),
                                     dtype=torch.float32, device=dev),
            }

        self._pools = _map_adapter_leaves(mk_pool, template)
        self._leaf_paths = [p for p, _ in adapter_leaves(template)]
        if not self._leaf_paths:
            raise ValueError("template adapter tree has no {'A','B'} leaves")
        self._table = torch.zeros((max_adapters, self.pages_max),
                                  dtype=torch.int32, device=dev)
        self._rank = torch.zeros((max_adapters,), dtype=torch.int32, device=dev)
        self._free_pages: List[int] = list(range(num_pages))
        self._free_ids: List[int] = list(range(1, max_adapters))
        self._meta: Dict[int, Dict[str, Any]] = {}
        self._names: Dict[str, int] = {}
        self._versions: Dict[str, List[int]] = {}

    @property
    def device_state(self) -> Dict[str, Any]:
        """What a serve step takes as its ``adapters``: fixed structure and
        shapes across any register/evict/swap churn."""
        return {"pools": self._pools, "table": self._table, "rank": self._rank}

    @property
    def num_free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def live_ids(self) -> List[int]:
        return sorted(self._meta)

    def resolve(self, name: str) -> int:
        return self._names[name]

    def is_live(self, adapter_id: int) -> bool:
        return adapter_id == 0 or adapter_id in self._meta

    def metadata(self, adapter_id: int) -> Dict[str, Any]:
        return dict(self._meta[adapter_id])

    def register(self, name: str, adapters: Any) -> int:
        """Copy ``adapters`` into free pages and return its adapter id."""
        if name in self._names:
            raise ValueError(f"adapter name {name!r} is already registered; "
                             "use swap() to publish a new version")
        return self._install(name, adapters)

    def swap(self, name: str, adapters: Any) -> int:
        """Atomic version bump: the new version lands in fresh pages under a
        NEW id, then the name is repointed.  The old id keeps serving rows
        already in flight until it is evicted."""
        if name not in self._names:
            raise KeyError(f"cannot swap unknown adapter name {name!r}")
        old = self._names[name]
        new = self._install(name, adapters)
        self._meta[old]["retired"] = True
        return new

    def evict(self, ref: Union[str, int]) -> None:
        """Free an adapter's pages and id (a name evicts every live version
        of it).  The freed rank entry is zeroed on the device, so a stale id
        degrades to the base model deterministically."""
        if isinstance(ref, str):
            if ref not in self._versions:
                raise KeyError(f"unknown adapter name {ref!r}")
            for aid in [i for i in self._versions[ref] if i in self._meta]:
                self._evict_id(aid)
            return
        self._evict_id(ref)

    def _evict_id(self, aid: int) -> None:
        if aid not in self._meta:
            raise KeyError(f"unknown or already-evicted adapter id {aid}")
        meta = self._meta.pop(aid)
        self._free_pages.extend(meta["pages"])
        self._free_pages.sort()
        self._free_ids.append(aid)
        self._free_ids.sort()
        self._rank[aid] = 0
        name = meta["name"]
        if self._names.get(name) == aid:
            del self._names[name]
        vs = self._versions.get(name)
        if vs is not None:
            vs[:] = [i for i in vs if i != aid]
            if not vs:
                del self._versions[name]

    def _adapter_rank(self, adapters: Any) -> int:
        paths, ranks = [], []
        for path, leaf in adapter_leaves(adapters):
            paths.append(path)
            ranks.append(int(leaf["A"].shape[-2]))
        if paths != self._leaf_paths:
            raise ValueError("adapter tree structure does not match the "
                             f"registry template: got leaves {paths}, "
                             f"expected {self._leaf_paths}")
        return max(ranks)

    def _install(self, name: str, adapters: Any) -> int:
        r = self._adapter_rank(adapters)
        if r < 1:
            raise ValueError("cannot register a rank-0 adapter")
        if r > self.max_rank:
            raise ValueError(f"adapter rank {r} exceeds the registry "
                             f"max_rank {self.max_rank}")
        n_pg = math.ceil(r / self.page_rank)
        if len(self._free_pages) < n_pg:
            raise RuntimeError(f"out of adapter pages: need {n_pg}, "
                               f"{len(self._free_pages)} free "
                               f"(evict something or grow num_pages)")
        if not self._free_ids:
            raise RuntimeError("out of adapter ids (grow max_adapters)")
        pages = self._free_pages[:n_pg]          # smallest-first: determinism
        del self._free_pages[:n_pg]
        aid = self._free_ids.pop(0)
        pr = self.page_rank
        rp = n_pg * pr                           # rank padded to whole pages
        pg = torch.as_tensor(pages, dtype=torch.long, device=self.device)

        leaves = dict(adapter_leaves(adapters))
        for path, pool in adapter_leaves(self._pools):
            leaf = leaves[path]
            a = torch.as_tensor(leaf["A"], device=self.device)
            b = torch.as_tensor(leaf["B"], device=self.device)
            scale = torch.as_tensor(leaf["scale"], dtype=torch.float32,
                                    device=self.device)
            lead = tuple(a.shape[:-2])
            rl, din = a.shape[-2:]
            dout = b.shape[-2]
            ap = torch.zeros(lead + (rp, din), dtype=pool["A"].dtype,
                             device=self.device)
            ap[..., :rl, :] = a
            bp = torch.zeros(lead + (dout, rp), dtype=pool["B"].dtype,
                             device=self.device)
            bp[..., :rl] = b
            ap = ap.reshape(lead + (n_pg, pr, din))
            bp = bp.reshape(lead + (dout, n_pg, pr)).movedim(-2, -3)
            if lead:                             # stacked: pages on axis 1
                pool["A"][:, pg] = ap
                pool["B"][:, pg] = bp
                pool["scale"][:, aid] = scale.expand(lead)
            else:
                pool["A"][pg] = ap
                pool["B"][pg] = bp
                pool["scale"][aid] = scale.reshape(())
        row = torch.zeros((self.pages_max,), dtype=torch.int32,
                          device=self.device)
        row[:n_pg] = pg.to(torch.int32)
        self._table[aid] = row
        self._rank[aid] = r

        version = len(self._versions.get(name, [])) + 1
        self._meta[aid] = {"name": name, "rank": r, "pages": pages,
                           "version": version, "retired": False}
        self._names[name] = aid
        self._versions.setdefault(name, []).append(aid)
        return aid
