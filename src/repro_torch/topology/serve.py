"""Serving-side partition specs (port of ``repro.topology.serve``): the
decode loop's tensor layouts under Megatron-style tensor parallelism.

Decode is latency-bound, so serving shards the *head* axis, not the cache
sequence: attention needs no collective on its shard and the only
communication is the all-reduce at each row-parallel output projection
(``wo`` / ``w_down``):

* GQA ring caches ``(B, cap, K, hd)``: KV-head axis ``K`` → ``model``
  (query heads follow their group);
* MLA compressed latents ``(B, cap, kvr)``: replicated; the absorbed
  decode's query heads carry the parallelism;
* SSM / RWKV recurrent state: head/state axis → ``model``;
* per-slot engine state (``(B,)``-leading leaves): batch → ``data``;
* paged adapter pools follow the base weight's layout: column-parallel
  targets shard the B pool's ``dout``, row-parallel targets the A pool's
  ``din``; tables and ranks replicated.  (The reference keeps the pools
  replicated on its Pallas route, ``lora_impl="kernel"``, where GSPMD
  cannot see into the kernel; the port's ``bgmv`` runs on each rank's
  shard, so the rule takes no ``lora_impl``.)

Every rule degrades to ``None`` where an axis does not divide.
"""
from __future__ import annotations

import time
from typing import Any, Dict

from repro_torch.common.config import ModelConfig
from repro_torch.topology.mesh import data_axes
from repro_torch.topology.partitioning import (CACHE_LEAF_RANKS, _COL_MODEL,
                                               _ROW_MODEL, _fits,
                                               map_with_path, params_pspecs,
                                               tree_map)

_HEADED_CACHE = ("k", "v", "k_scale", "v_scale")
_STATE_CACHE = ("ssm", "wkv")


def _batch_axis(mesh, dim: int):
    dax = data_axes(mesh)
    if _fits(mesh, dim, dax):
        return dax if len(dax) > 1 else dax[0]
    if _fits(mesh, dim, dax[-1]):
        return dax[-1]
    return None


def serve_cache_pspecs(mesh, cfg: ModelConfig, cache: Any) -> Any:
    """Head-sharded ring-cache specs (see the module docstring)."""

    def fix(path, leaf):
        last = path[-1]
        nd = leaf.ndim
        base = CACHE_LEAF_RANKS.get(last, nd)
        lead = max(0, nd - base)
        spec = [None] * nd
        if last in ("pos", "length") or nd == lead:
            return tuple(spec)
        spec[lead] = _batch_axis(mesh, leaf.shape[lead])
        if last in _HEADED_CACHE and nd > lead + 2:
            if _fits(mesh, leaf.shape[lead + 2], "model"):
                spec[lead + 2] = "model"
        elif last in _STATE_CACHE and nd > lead + 1:
            if _fits(mesh, leaf.shape[lead + 1], "model"):
                spec[lead + 1] = "model"
        return tuple(spec)

    return map_with_path(fix, cache)


def serve_state_pspecs(mesh, state: Any) -> Any:
    """Per-slot engine state: every ``(B, ...)`` leaf shards batch → data."""

    def fix(leaf):
        if leaf.ndim == 0:
            return ()
        spec = [None] * leaf.ndim
        spec[0] = _batch_axis(mesh, leaf.shape[0])
        return tuple(spec)

    return tree_map(fix, state)


def _pool_leaf_spec(mesh, keys, leaf) -> tuple:
    """Spec for one array inside a paged-pool / classic adapter leaf-dict.

    ``keys`` ends with (..., target_name, {"A"|"B"|"scale"}).  Layouts: pool
    A ``(L?, P, pr, din)`` / B ``(L?, P, dout, pr)``; classic A ``(L?, r,
    din)`` / B ``(L?, dout, r)``."""
    part = keys[-1]
    target = keys[-2] if len(keys) >= 2 else None
    nd = leaf.ndim
    spec = [None] * nd
    if part == "A" and target in _ROW_MODEL and nd >= 2:
        if _fits(mesh, leaf.shape[-1], "model"):
            spec[-1] = "model"                  # din follows row-parallel in
    elif part == "B" and target in _COL_MODEL and nd >= 2:
        if _fits(mesh, leaf.shape[-2], "model"):
            spec[-2] = "model"                  # dout follows col-parallel out
    return tuple(spec)


def serve_adapter_pspecs(mesh, adapters: Any) -> Any:
    """Specs for the engine's ``adapters``: a registry device-state dict, a
    classic single-tenant adapter tree, or ``None``."""
    if adapters is None:
        return None
    from repro_torch.serve.adapters import is_device_state

    if is_device_state(adapters):
        def fix(path, leaf):
            if path[0] != "pools":
                return (None,) * leaf.ndim      # table / rank: replicated
            return _pool_leaf_spec(mesh, path, leaf)
        return map_with_path(fix, adapters)
    return map_with_path(lambda path, leaf: _pool_leaf_spec(mesh, path, leaf),
                         adapters)


def serve_pspecs(mesh, cfg: ModelConfig, params: Any, cache: Any, state: Any,
                 adapters: Any = None) -> Dict[str, Any]:
    """The spec bundle of one engine: params by the training Megatron rules
    (:func:`params_pspecs`), cache / state / adapters by the serving rules
    above."""
    return {
        "params": params_pspecs(mesh, cfg, params),
        "cache": serve_cache_pspecs(mesh, cfg, cache),
        "state": serve_state_pspecs(mesh, state),
        "adapters": serve_adapter_pspecs(mesh, adapters),
    }


class ModelParallel:
    """A serve mesh's ``model`` axis as the decode layers use it (the
    port's counterpart of GSPMD's collectives around Megatron layers and of
    the reference's expert-parallel ``shard_map``): ``reduce`` sums a
    row-parallel projection's partial output (one ``all_reduce``, in fp32),
    ``gather`` makes a column-parallel output whole along its last dim
    (``all_gather``; ``join`` is the same, and ``copy`` an identity: the
    train mesh's ops, which decode calls without a gradient),
    ``all_to_all`` exchanges a MoE layer's capacity slots with the
    experts' owners, ``local`` cuts a replicated vector (a bias, a
    norm's weight, a per-head constant) to this rank's share of one dim.
    ``all_reduces`` / ``reduce_s`` and ``all_to_alls`` / ``a2a_s`` count
    the reductions and the exchanges and their host time."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = mesh.axis_size("model")
        self.index = mesh.axis_index("model")
        self.all_reduces = 0
        self.reduce_s = 0.0
        self.all_to_alls = 0
        self.a2a_s = 0.0

    def reduce(self, y: "torch.Tensor") -> "torch.Tensor":
        t0 = time.perf_counter()
        out = self.mesh.all_reduce(y.float(), "model").to(y.dtype)
        self.reduce_s += time.perf_counter() - t0
        self.all_reduces += 1
        return out

    def gather(self, y: "torch.Tensor") -> "torch.Tensor":
        return self.mesh.all_gather(y.contiguous(), "model", dim=-1)

    join = gather

    @staticmethod
    def copy(x: "torch.Tensor") -> "torch.Tensor":
        """The train mesh's ``copy`` at decode: an identity (no gradient)."""
        return x

    def all_to_all(self, t: "torch.Tensor", split_dim: int,
                   concat_dim: int) -> "torch.Tensor":
        t0 = time.perf_counter()
        out = self.mesh.all_to_all(t, "model", split_dim, concat_dim)
        self.a2a_s += time.perf_counter() - t0
        self.all_to_alls += 1
        return out

    def local(self, b: "torch.Tensor", dim: int = -1) -> "torch.Tensor":
        n = b.shape[dim] // self.size
        return b.narrow(dim, self.index * n, n)
