"""Aggregator strategy interface + registry (port of
``repro.core.aggregators.base``).

An :class:`Aggregator` owns what the server knows about one aggregation
method: the streaming lifecycle ``begin_round(dims)`` → ``add_client(update,
weight)`` per arriving client → ``finalize()``; the client-init semantics
``client_init(global_state, rank, a_init)``; and the cost model
(``upload_params`` / ``download_params`` / ``server_flops`` /
``efficiency``).  Strategies register with :func:`register_aggregator`.

A client update is an adapter tree whose LoRA leaves are ``{"A": (L, r_k,
n), "B": (L, m, r_k), "scale": (L,)}`` (or un-stacked 2-D).  Leaves arrive
as numpy arrays off the wire (``scale`` stays a tensor: it never travels)
and are moved to ``scale``'s device on arrival.  Client ``scale`` is folded
into ``B`` so methods compare the same effective updates
``ΔW_k = scale_k · B_k A_k``; all global adapters carry scale 1.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

# ---------------------------------------------------------------------------
# adapter-tree plumbing (shared by all methods and by costs.py)
# ---------------------------------------------------------------------------


def adapter_leaf_paths(tree: Dict) -> List[Tuple]:
    """Paths of LoRA leaves (subdicts holding A/B/scale), in insertion
    order."""
    out = []

    def walk(node, path):
        if isinstance(node, dict) and "A" in node and "B" in node:
            out.append(path)
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))

    walk(tree, ())
    return out


def get_path(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return node


def set_path(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def numel(x: Any) -> int:
    """Element count of a tensor or a numpy array."""
    return int(np.prod(x.shape))


def fold_scale(leaf: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (B', A) with scale folded into B, as tensors on ``scale``'s
    device.  Handles stacked + flat leaves."""
    s = torch.as_tensor(leaf["scale"])
    A = torch.as_tensor(leaf["A"], device=s.device)
    B = torch.as_tensor(leaf["B"], device=s.device)
    if B.dim() == 3:
        sl = s[:, None, None] if s.dim() == 1 else s
        return B * sl, A
    return B * s, A


def ones_scale(ref_scale):
    return torch.ones_like(torch.as_tensor(ref_scale))


def default_wire_arrays(leaf: Dict) -> Dict[str, Any]:
    """The default wire set of one LoRA leaf: A and B travel, ``scale``
    stays home."""
    return {"A": leaf["A"], "B": leaf["B"]}


def bucket_by_shape(stacks: Dict[Tuple, Sequence[Any]]) -> List[List[Tuple]]:
    """Group leaf paths whose stacked blocks share shapes, in insertion
    order: equal-shaped leaves go through the batched pipelines together."""
    buckets: Dict[Tuple, List[Tuple]] = {}
    for path, arrs in stacks.items():
        buckets.setdefault(tuple(tuple(a.shape) for a in arrs), []).append(path)
    return list(buckets.values())


def leaf_dims(client_tree: Dict) -> Dict[Tuple, Tuple[int, int, int]]:
    """{leaf path: (L, n_in, m_out)} from one client's adapter tree.
    Note: A: (L, r, n_in), B: (L, m_out, r)."""
    dims = {}
    for path in adapter_leaf_paths(client_tree):
        leaf = get_path(client_tree, path)
        A, B = leaf["A"], leaf["B"]
        if A.ndim == 3:
            dims[path] = (int(A.shape[0]), int(A.shape[2]), int(B.shape[1]))
        else:
            dims[path] = (1, int(A.shape[1]), int(B.shape[0]))
    return dims


def leaf_rank(tree: Dict) -> int:
    """Local LoRA rank of an adapter tree (from its first leaf)."""
    return int(get_path(tree, adapter_leaf_paths(tree)[0])["A"].shape[-2])


def fresh_client_adapters(a_init_full: Dict, rank: int) -> Dict:
    """Round-1 / re-init client state: A = shared init cut to ``rank``,
    B = 0 (training starts at the base model)."""
    from repro_torch.peft.lora import match_rank

    def mk(node):
        if isinstance(node, dict):
            return {k: (torch.zeros_like(torch.as_tensor(v)) if k == "B"
                        else mk(v)) for k, v in node.items()}
        return node

    return mk(match_rank(a_init_full, rank))


# ---------------------------------------------------------------------------
# result container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AggResult:
    method: str
    global_adapters: Dict                    # unified tree
    ranks: Dict[Tuple, List[int]]            # leaf path -> per-layer rank
    spectra: Dict[Tuple, List[np.ndarray]]   # leaf path -> per-layer σ

    def total_download_rank(self) -> int:
        return int(sum(sum(v) for v in self.ranks.values()))


# ---------------------------------------------------------------------------
# the strategy interface
# ---------------------------------------------------------------------------


class Aggregator:
    """Base class for server-side aggregation strategies.

    Subclasses implement ``_accumulate(update, weight, rank)`` and
    ``_finalize() -> AggResult`` plus whichever cost-model / client-init
    methods deviate from the defaults below.  Constructor kwargs are the
    method's configuration; per-round state lives between ``begin_round``
    and ``finalize``.
    """

    name: str = "?"
    #: FFA-style methods train only B locally (A frozen).
    trains_b_only: bool = False
    #: weight of the broadcast rank in the paper's efficiency denominator
    download_rank_factor: float = 1.0

    def __init__(self):
        self._reset()

    # -- streaming lifecycle -------------------------------------------------
    def _reset(self) -> None:
        self.dims: Optional[Dict[Tuple, Tuple[int, int, int]]] = None
        self.num_clients: int = 0
        self.client_ranks: List[int] = []
        self.round_upload_params: int = 0
        self._ref_scales: Dict[Tuple, torch.Tensor] = {}
        self._state: Dict[Tuple, Any] = {}

    def begin_round(self, dims: Optional[Dict] = None) -> None:
        """Reset per-round accumulators.  ``dims`` (as from
        :func:`leaf_dims`) is captured from the first update otherwise."""
        self._reset()
        self.dims = dims

    def add_client(self, update: Dict, weight: float,
                   rank: Optional[int] = None) -> None:
        """Fold one arriving client update (weight ``n_k / N``) into the
        running accumulators; the caller may drop ``update`` afterwards."""
        if self.dims is None:
            self.dims = leaf_dims(update)
        if rank is None:
            rank = leaf_rank(update)
        for path in adapter_leaf_paths(update):
            leaf = get_path(update, path)
            if path not in self._ref_scales:
                self._ref_scales[path] = ones_scale(leaf["scale"])
            self.round_upload_params += self.client_upload_params(leaf)
        self._accumulate(update, float(weight), int(rank))
        self.num_clients += 1
        self.client_ranks.append(int(rank))

    def finalize(self) -> AggResult:
        if self.num_clients == 0:
            raise ValueError(f"{self.name}: finalize() before any add_client()")
        return self._finalize()

    # -- subclass hooks ------------------------------------------------------
    def _accumulate(self, update: Dict, weight: float, rank: int) -> None:
        raise NotImplementedError

    def _finalize(self) -> AggResult:
        raise NotImplementedError

    def aggregate(self, clients: Sequence[Dict], weights: Sequence[float],
                  client_ranks: Optional[Sequence[int]] = None) -> AggResult:
        """Run the full streaming lifecycle over an in-memory client list."""
        self.begin_round()
        for i, (c, w) in enumerate(zip(clients, weights)):
            self.add_client(c, w,
                            None if client_ranks is None else client_ranks[i])
        return self.finalize()

    # -- client-init semantics ----------------------------------------------
    def client_init(self, global_state: Optional[AggResult], rank: int,
                    a_init_full: Dict) -> Dict:
        """Adapters a rank-``rank`` client resumes from this round: the
        global adapters truncated or zero-padded to the rank (Alg. 1);
        round 1: B = 0, A = the shared init."""
        from repro_torch.peft.lora import match_rank

        if global_state is None:
            return fresh_client_adapters(a_init_full, rank)
        return match_rank(global_state.global_adapters, rank)

    # -- wire semantics ------------------------------------------------------
    def wire_arrays(self, leaf: Dict) -> Dict[str, Any]:
        """The tensors of one LoRA leaf that travel on the wire."""
        return default_wire_arrays(leaf)

    # -- cost model ----------------------------------------------------------
    # Cost methods must not depend on constructor config or per-round state:
    # costs.py calls them on an uninitialised instance.
    def client_upload_params(self, leaf: Dict) -> int:
        """Parameters one client sends for one LoRA leaf (default: A + B)."""
        return numel(leaf["A"]) + numel(leaf["B"])

    def upload_params(self, client_trees: Sequence[Dict]) -> int:
        total = 0
        for tree in client_trees:
            for path in adapter_leaf_paths(tree):
                total += self.client_upload_params(get_path(tree, path))
        return total

    def download_params(self, agg: AggResult, dims: Dict, num_clients: int,
                        client_ranks: Sequence[int]) -> int:
        """Total parameters sent server → clients this round (default:
        broadcast the rank-p_l global adapters to every client)."""
        total = 0
        for path, (L, n, m) in dims.items():
            for r_l in agg.ranks[path]:
                total += num_clients * r_l * (n + m)
        return total

    def server_flops(self, dims: Dict, client_ranks: Sequence[int],
                     agg_ranks: Optional[Dict[Tuple, List[int]]] = None) -> int:
        raise NotImplementedError

    def efficiency(self, agg: AggResult, client_ranks: Sequence[int] = (),
                   dims: Optional[Dict] = None) -> float:
        """1 / downloaded rank (paper §4, 'communication efficiency')."""
        tr = agg.total_download_rank() * self.download_rank_factor
        return 1.0 / max(1.0, tr)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[Aggregator]] = {}

#: methods of the reference that this port does not carry yet
NOT_PORTED = ("fedit", "ffa", "flora", "flexlora", "florist_sharded")


def register_aggregator(name: str):
    """Class decorator: make ``name`` constructible via
    :func:`make_aggregator`."""

    def deco(cls: Type[Aggregator]) -> Type[Aggregator]:
        if not (isinstance(cls, type) and issubclass(cls, Aggregator)):
            raise TypeError(f"{cls!r} must subclass Aggregator")
        _REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


def get_aggregator_class(name: str) -> Type[Aggregator]:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"aggregation method {name!r} is not ported yet (later "
                "runtime-breadth slice of the port)") from None
        raise ValueError(
            f"unknown aggregation method {name!r} "
            f"(registered: {sorted(_REGISTRY)})") from None


def make_aggregator(name: str, **cfg) -> Aggregator:
    """Instantiate a registered aggregation strategy by name."""
    return get_aggregator_class(name)(**cfg)


def available_aggregators() -> List[str]:
    return sorted(_REGISTRY)


def accepted_config(name: str, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Subset of ``cfg`` accepted by ``name``'s constructor."""
    cls = get_aggregator_class(name)
    sig = inspect.signature(cls.__init__)
    if any(p.kind is inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        return dict(cfg)
    return {k: v for k, v in cfg.items() if k in sig.parameters}
