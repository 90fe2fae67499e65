"""LoRA adapters (port of the serving half of ``repro.peft.lora``).

A target weight ``W: (in, out)`` used as ``y = x @ W`` carries an adapter
``{"A": (r, in), "B": (out, r), "scale"}``:

    y = x @ W + scale * (x @ Aᵀ) @ Bᵀ .

Stacked layers (leading ``L`` axis) carry adapters with the same leading
axis.  Multi-tenant serving replaces the leaf with a :class:`PagedLoRA`:
paged pools plus per-row adapter ids, so one decode step applies every
batch row's own adapter at its own rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

PAGED_IMPLS = ("plain", "kernel")


@dataclasses.dataclass
class PagedLoRA:
    """One LoRA-bearing leaf of a multi-tenant paged adapter store.

    ==========  ==========================  ==================================
    field       shape                       meaning
    ==========  ==========================  ==================================
    a_pages     ([L,] P, page_rank, din)    paged A rows
    b_pages     ([L,] P, dout, page_rank)   paged B columns
    scale       ([L,] maxA)                 per-adapter alpha/r
    table       (maxA, Pmax)                page indirection per adapter
    rank        (maxA,)                     effective rank (0 = base/masked)
    ids         (B,)                        per-batch-row adapter id
    ==========  ==========================  ==================================

    Stacked leaves keep ``table``/``rank``/``ids`` unstacked (they are the
    same for every layer); :meth:`layer` takes one layer's slice.  ``impl``
    is ``"kernel"`` (:func:`repro_torch.kernels.ops.bgmv`: the CUDA kernel
    on the card, its plain version on the CPU) or ``"plain"`` (the plain
    version on any device).
    """

    a_pages: torch.Tensor
    b_pages: torch.Tensor
    scale: torch.Tensor
    table: torch.Tensor
    rank: torch.Tensor
    ids: torch.Tensor
    impl: str = "kernel"

    def layer(self, i: int) -> "PagedLoRA":
        if self.a_pages.dim() != 4:
            return self
        return dataclasses.replace(self, a_pages=self.a_pages[i],
                                   b_pages=self.b_pages[i],
                                   scale=self.scale[i])


def paged_lora_delta(x: torch.Tensor, ad: PagedLoRA) -> torch.Tensor:
    """Per-row LoRA delta ``Δy_b = scale_b · (x_b A_bᵀ) B_bᵀ`` for x
    (B, C, din), in x's dtype (fp32 accumulation)."""
    if x.dim() != 3:
        raise ValueError("paged multi-tenant adapters are a decode-path "
                         f"feature: expected x of rank 3 (B, C, din), got "
                         f"shape {tuple(x.shape)}")
    fn = kops.bgmv if ad.impl == "kernel" else kref.bgmv_ref
    return fn(x, ad.a_pages, ad.b_pages, ad.table, ad.rank, ad.scale,
              ad.ids).to(x.dtype)


def lora_proj(x: torch.Tensor, w: torch.Tensor,
              adapter: Optional[Any] = None) -> torch.Tensor:
    """y = x @ w (+ LoRA delta).  ``adapter`` is None (base model: no
    adapter math at all), a classic ``{"A", "B", "scale"}`` leaf, or a
    :class:`PagedLoRA` leaf."""
    if adapter is None:
        return x @ w
    if isinstance(adapter, PagedLoRA):
        return x @ w + paged_lora_delta(x, adapter)
    z = x @ adapter["A"].t().to(x.dtype)
    return x @ w + (z @ adapter["B"].t().to(x.dtype)) * adapter["scale"].to(x.dtype)


def target_leaves(params: Any, targets: Sequence[str]
                  ) -> List[Tuple[Tuple, torch.Tensor]]:
    """All (path, leaf) pairs whose last key is in ``targets`` and that are
    2-D weights (or 3-D with a leading layer axis), in the order of the
    reference's pytree flattening (dict keys sorted)."""
    out: List[Tuple[Tuple, torch.Tensor]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        elif (isinstance(node, torch.Tensor) and path and path[-1] in targets
              and node.dim() in (2, 3)):
            out.append((path, node))

    walk(params, ())
    return out


def _set_path(tree: Dict, keys: Tuple, value: Any) -> None:
    """Set ``value`` at ``keys``, creating dicts on the way.  As in the
    reference, the ``blocks`` tuple of the params becomes a dict keyed by
    segment index in the adapter tree."""
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def init_lora(params: Any, targets: Sequence[str], rank: int, alpha: float,
              generator: torch.Generator, dtype: torch.dtype = torch.float32,
              sigma: float = 0.02) -> Dict:
    """Adapter tree mirroring ``params`` at the target leaves (registry
    templates).  ``A`` is Gaussian (sigma), ``B`` zero, ``scale = alpha/r``
    (per layer for stacked leaves).  Tensors are made on the generator's
    device."""
    tree: Dict = {}
    dev = generator.device
    for keys, leaf in target_leaves(params, targets):
        if leaf.dim() == 3:
            L, din, dout = leaf.shape
            a = torch.randn((L, rank, din), generator=generator, device=dev)
            b = torch.zeros((L, dout, rank), device=dev)
            scale = torch.full((L,), alpha / rank, dtype=torch.float32,
                               device=dev)
        else:
            din, dout = leaf.shape
            a = torch.randn((rank, din), generator=generator, device=dev)
            b = torch.zeros((dout, rank), device=dev)
            scale = torch.tensor(alpha / rank, dtype=torch.float32, device=dev)
        _set_path(tree, keys, {"A": (a * sigma).to(dtype), "B": b.to(dtype),
                               "scale": scale})
    return tree
