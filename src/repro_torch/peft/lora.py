"""LoRA adapters (port of ``repro.peft.lora``).

A target weight ``W: (in, out)`` used as ``y = x @ W`` carries an adapter
``{"A": (r, in), "B": (out, r), "scale"}``:

    y = x @ W + scale * (x @ Aᵀ) @ Bᵀ .

Stacked layers (leading ``L`` axis) carry adapters with the same leading
axis.  Multi-tenant serving replaces the leaf with a :class:`PagedLoRA`:
paged pools plus per-row adapter ids, so one decode step applies every
batch row's own adapter at its own rank.

Under tensor parallelism (a serve mesh's ``model`` axis) the paged pools
are the rank's shards (:meth:`repro_torch.serve.adapters.AdapterRegistry.
place`) and ``lora_proj`` needs no change: on a column-parallel target
``bgmv`` writes the rank's ``dout`` slice beside the base product's; on a
row-parallel target it returns the rank's partial ``s·B(A_local x_local)``,
which is added to the base partial before the projection's single
``all_reduce`` (:mod:`repro_torch.models.layers`, RWKV6's ``wo`` and
``wcv``, Mamba2's ``out_proj``): the delta is linear, so the sum is the
whole delta and the scale is applied once.  Mamba2's ``in_proj`` B pool is
cut segment by segment as its weight is (the rank's heads' columns of z,
x and dt, B and C whole), so ``bgmv`` writes the rank's fused columns in
the order the base product has them; on a train mesh its replicated
adapter's B is cut by the same segments (:func:`shard_adapter`).

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


def lora_delta(x: torch.Tensor, adapter: Dict) -> torch.Tensor:
    """The plain LoRA delta ``scale · (x Aᵀ) Bᵀ`` of a classic leaf (A (r,
    din), B (dout, r)), or per client of a cohort leaf (A (C, r, din), B
    (C, dout, r), scale (C,)) with x (C·B, ..., din) holding client c's
    rows at [c·B, (c+1)·B).  A classic leaf is a cohort of one."""
    A, B, s = adapter["A"], adapter["B"], adapter["scale"]
    if A.dim() == 2:
        A, B = A[None], B[None]
    C = A.shape[0]
    xc = x.reshape(C, -1, x.shape[-1])
    z = xc @ A.mT.to(x.dtype)
    d = (z @ B.mT.to(x.dtype)) * s.reshape(C, 1, 1).to(x.dtype)
    return d.reshape(*x.shape[:-1], B.shape[-2])


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
    adapter math at all), a classic ``{"A", "B", "scale"}`` leaf, a cohort
    leaf (A (C, r, din), B (C, dout, r), scale (C,): one adapter per
    client, x (C·B, S, din) with client c's rows at [c·B, (c+1)·B)), or a
    :class:`PagedLoRA` leaf.  ``use_kernel`` sends a classic or cohort
    leaf with a 3-D ``x`` through the fused ``lora_matmul`` (one launch for
    a whole cohort; differentiable in x, A, B and scale), as the
    reference's ``lora.USE_KERNEL`` does."""
    if adapter is None:
        return matmul(x, w)
    if isinstance(adapter, PagedLoRA):
        return matmul(x, w) + paged_lora_delta(x, adapter)
    if use_kernel and x.dim() == 3:
        return kops.lora_matmul(x, w, adapter["A"], adapter["B"],
                                adapter["scale"])
    return matmul(x, w) + lora_delta(x, adapter)


# a weight's parallel kind: its columns (out) or its rows (in) cut over model
COL, ROW = "col", "row"


def shard_adapter(adapter: Optional[Dict], tp, kind: str, width: int,
                  segments=None) -> Optional[Dict]:
    """A replicated classic adapter cut to its weight's ``model`` shard,
    ``width`` wide on the cut dim: B's rows under a column-parallel weight,
    A's columns under a row-parallel one (a plain ``narrow``: each rank's
    gradient is its part of the whole, :mod:`repro_torch.topology.train`).
    ``segments`` (a :class:`repro_torch.topology.partitioning.Segments`,
    column-parallel only) cuts B's rows segment by segment as the fused
    weight is cut: Mamba2's ``in_proj``, whose B and C rows every rank
    keeps, so each rank's gradient of them is a part too.  The scale is
    kept: a row-parallel partial delta is summed with the base's partial
    product, so it is applied once."""
    if adapter is None or tp is None or tp.size == 1:
        return adapter
    key, dim = ("B", -2) if kind == COL else ("A", -1)
    whole = adapter[key].shape[dim]
    want = segments.local_width(tp.mesh) if segments is not None else (
        whole // tp.size if whole % tp.size == 0 else -1)
    if width != want or (segments is not None and sum(segments.widths) != whole):
        raise ValueError(
            f"a {kind}-parallel weight {width} wide on a model axis of "
            f"{tp.size} under an adapter {whole} wide: the training path "
            "takes weights the rules cut over model")
    if segments is not None:
        return dict(adapter, B=torch.cat(
            [adapter["B"].narrow(-2, o, n) for o, n, _ in
             segments.pieces(tp.mesh)], dim=-2))
    return dict(adapter, **{key: tp.local(adapter[key], dim)})


def lora_proj_shard(x: torch.Tensor, w: torch.Tensor,
                    adapter: Optional[Dict], use_kernel: bool, tp,
                    kind: str, segments=None) -> torch.Tensor:
    """``lora_proj`` on the rank's shard of a Megatron weight under a train
    mesh (``tp`` a :class:`repro_torch.topology.train.TrainParallel`):
    column-parallel (``kind`` COL, w (din, dout/M), the rank's output
    columns; ``segments``: a fused dim cut segment by segment, as
    :func:`shard_adapter` takes it) or row-parallel (ROW, w (din/M,
    dout), x the rank's input columns, a partial output the caller
    reduces).  Under ZeRO-3 the weight's other dim is gathered over
    ``data`` first, and only its shard is kept for the backward
    (:meth:`TrainParallel.full_weight`)."""
    with tp.full_weight(w, 0 if kind == COL else -1) as wf:
        width = wf.shape[-1] if kind == COL else wf.shape[-2]
        return lora_proj(x, wf, shard_adapter(adapter, tp, kind, width,
                                              segments), use_kernel)


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
