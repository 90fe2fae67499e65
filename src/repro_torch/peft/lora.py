"""LoRA adapters (port of ``repro.peft.lora``).

A target weight ``W: (in, out)`` used as ``y = x @ W`` carries an adapter
``{"A": (r, in), "B": (out, r), "scale"}``:

    y = x @ W + scale * (x @ Aᵀ) @ Bᵀ .

Stacked layers (leading ``L`` axis) carry adapters with the same leading
axis.  Multi-tenant serving replaces the leaf with a :class:`PagedLoRA`:
paged pools plus per-row adapter ids, so one decode step applies every
batch row's own adapter at its own rank.

Adapter trees hold tensors, or numpy arrays where a tree comes off the
federated wire (:mod:`repro_torch.core.runtime.transport`); ``match_rank``
keeps numpy leaves on the host, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
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


def paged_delta_weight(ad: PagedLoRA) -> torch.Tensor:
    """Per-row dense ``ΔW_b = scale_b · (B_b A_b)ᵀ``: (B, din, dout) fp32.

    The paged counterpart of folding a LoRA delta into a base weight, used
    by the MLA absorbed decode, where the ``wkv_b`` adapter must merge into
    the absorbed projection per batch row.  Gathers each row's pages
    (lanes at or above the row's rank zeroed) and materialises per-row
    weights (B · din · dout), as the reference does: the dense fallback,
    not a fast path."""
    pt = ad.table.long()[ad.ids.long()]                      # (B, Pmax)
    Bn, Pmax = pt.shape
    _, pr, din = ad.a_pages.shape
    dout = ad.b_pages.shape[1]
    R = Pmax * pr
    Ag = ad.a_pages[pt].reshape(Bn, R, din).float()
    Bg = ad.b_pages[pt].permute(0, 2, 1, 3).reshape(Bn, dout, R).float()
    lane = torch.arange(R, device=Ag.device)[None, :, None]
    Ag = torch.where(lane < ad.rank.long()[ad.ids.long()][:, None, None], Ag,
                     torch.zeros((), dtype=Ag.dtype, device=Ag.device))
    delta = torch.einsum("bor,brd->bdo", Bg, Ag)
    return delta * ad.scale.float()[ad.ids.long()][:, None, None]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with jnp's promotion: mixed dtypes (an fp32 activation
    against bf16 weights) compute in the wider one, as the reference's
    products do."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def lora_proj(x: torch.Tensor, w: torch.Tensor,
              adapter: Optional[Any] = None,
              use_kernel: bool = False) -> torch.Tensor:
    """y = x @ w (+ LoRA delta).  ``adapter`` is None (base model: no
    adapter math at all), a classic ``{"A", "B", "scale"}`` leaf, or a
    :class:`PagedLoRA` leaf.  ``use_kernel`` sends a classic leaf with a
    3-D ``x`` through the fused ``lora_matmul`` (differentiable in x, A, B
    and scale), as the reference's ``lora.USE_KERNEL`` does."""
    if adapter is None:
        return matmul(x, w)
    if isinstance(adapter, PagedLoRA):
        return matmul(x, w) + paged_lora_delta(x, adapter)
    if use_kernel and x.dim() == 3:
        return kops.lora_matmul(x, w, adapter["A"], adapter["B"],
                                adapter["scale"])
    z = x @ adapter["A"].t().to(x.dtype)
    return matmul(x, w) + ((z @ adapter["B"].t().to(x.dtype))
                           * adapter["scale"].to(x.dtype))


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


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def adapter_num_params(adapters: Any) -> int:
    """Number of A and B parameters in an adapter tree."""
    n = 0

    def walk(node):
        nonlocal n
        if isinstance(node, dict):
            for k, v in node.items():
                if k in ("A", "B") and _is_array(v):
                    n += int(np.prod(v.shape))
                else:
                    walk(v)

    walk(adapters)
    return n


def merge_lora(params: Any, adapters: Dict) -> Any:
    """Params with ``ΔW = scale·(BA)ᵀ`` folded into the target weights (in
    fp32, cast back to the weight's dtype).  Returns a new tree; untouched
    leaves are shared, not copied."""

    def merge(p, a):
        if isinstance(p, dict):
            return {k: merge(v, a.get(k) if isinstance(a, dict) else None)
                    for k, v in p.items()}
        if isinstance(p, (tuple, list)):
            return type(p)(merge(v, a.get(i) if isinstance(a, dict) else None)
                           for i, v in enumerate(p))
        if not (isinstance(a, dict) and "A" in a and "B" in a):
            return p
        dev = p.device
        A, B, s = (torch.as_tensor(a[n], device=dev).float()
                   for n in ("A", "B", "scale"))
        if p.dim() == 3:
            sl = s[:, None, None] if s.dim() == 1 else s
            delta = torch.einsum("lor,lri->lio", B, A) * sl
        else:
            delta = (B @ A).t() * s
        return (p.float() + delta).to(p.dtype)

    return merge(params, adapters)


def match_rank(adapters: Dict, rank: int) -> Dict:
    """Algorithm 1 client-side rank matching: truncate (p > r_k) or zero-pad
    (p < r_k) the global adapters to the client's local rank.  numpy leaves
    (a decoded wire payload) stay numpy on the host; tensor leaves stay
    tensors on their device.  ``scale`` passes through unchanged."""

    def pad(leaf, axis: int, extra: int):
        if isinstance(leaf, np.ndarray):
            widths = [(0, 0)] * leaf.ndim
            widths[axis] = (0, extra)
            return np.pad(leaf, widths)
        shape = list(leaf.shape)
        shape[axis] = extra
        return torch.cat([leaf, leaf.new_zeros(shape)], dim=axis)

    def fix(key, leaf):
        if key == "A":                        # (..., p, in)
            p = leaf.shape[-2]
            if p > rank:
                return leaf[..., :rank, :]
            return leaf if p == rank else pad(leaf, leaf.ndim - 2, rank - p)
        if key == "B":                        # (..., out, p)
            p = leaf.shape[-1]
            if p > rank:
                return leaf[..., :rank]
            return leaf if p == rank else pad(leaf, leaf.ndim - 1, rank - p)
        return leaf

    def walk(node):
        if isinstance(node, dict):
            return {k: (fix(k, v) if _is_array(v) else walk(v))
                    for k, v in node.items()}
        return node

    return walk(adapters)
