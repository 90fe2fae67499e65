"""Partition rules (port of ``repro.topology.partitioning``): spec trees for
params, batches and KV caches, per architecture and mesh.

A spec is a tuple with one entry per dim: an axis name, a tuple of axis
names, or ``None`` (replicated), in the place the reference's
``PartitionSpec`` holds it.  The rules are the reference's, verbatim:

* every 2-D+ weight shards its "wide" dim over ``model`` (tensor / expert
  parallel); archs above ``ZERO3_THRESHOLD`` params also shard the other
  dim over ``data``;
* leading layer axes are never sharded;
* batches shard over (``pod``,) ``data``;
* KV caches: batch → data, cache sequence → model (the serving decode loop
  uses the head-sharded layout of :mod:`repro_torch.topology.serve`);
* norms, biases and scalars are replicated.

A spec is applied only where every named axis divides its dim; otherwise
the axis drops to replicated.  :func:`shard` cuts a tree to this rank's
slices by a spec tree, :func:`gather` (``all_gather``) puts them back.  A
spec entry may also be a :class:`Segments`: a fused dim cut segment by
segment (the rules never make one; a caller that knows a fused layout, the
serving engine's Mamba2 placement, puts it in).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.topology.mesh import axis_size, data_axes

ZERO3_THRESHOLD = 8e9      # params; above this, weights also shard over data

# last-path-key -> (row_axis, col_axis) template for 2-D weights
_COL_MODEL = ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "wr", "wg",
              "wck", "wcr", "wq_a", "wq_b", "wkv_a", "wkv_b", "dd_w1", "wd1")
_ROW_MODEL = ("wo", "w_down", "out_proj", "wcv")

# un-stacked rank of every known cache/state leaf: the batch axis of a leaf
# sits at ``ndim - rank`` (leaves may carry leading layer-stack axes)
CACHE_LEAF_RANKS = {
    "k": 4, "v": 4, "k_scale": 4, "v_scale": 4,
    "c_kv": 3, "k_rope": 3, "c_kv_scale": 3, "k_rope_scale": 3,
    "conv": 3, "ssm": 4, "wkv": 4, "tm_x": 2, "cm_x": 2,
    "pos": 1, "length": 1,
}


def _is_leaf(x: Any) -> bool:
    return hasattr(x, "shape") and hasattr(x, "ndim")


def map_with_path(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over every array leaf of nested dicts, tuples and
    lists (``None`` kept); ``path`` holds dict keys and sequence indices,
    as the reference's ``tree_map_with_path`` keys do."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return tree


def tree_map(fn: Callable, tree: Any) -> Any:
    return map_with_path(lambda _, leaf: fn(leaf), tree)


def _fits(mesh, dim: int, axis) -> bool:
    if axis is None:
        return True
    if isinstance(axis, tuple):
        sz = 1
        for a in axis:
            sz *= axis_size(mesh, a)
    else:
        sz = axis_size(mesh, axis)
    return dim % sz == 0


def _sanitize(mesh, spec: Tuple, shape: Tuple[int, ...]) -> Tuple:
    return tuple(axis if _fits(mesh, dim, axis) else None
                 for axis, dim in zip(spec, shape))


def param_pspec(mesh, cfg: ModelConfig, path_keys: Tuple, leaf,
                zero3: bool) -> Tuple:
    last = path_keys[-1]
    shape = tuple(leaf.shape)
    nd = leaf.ndim
    dax = data_axes(mesh)

    def build(core_spec):
        """Prepend None for any leading stack axes beyond the core rank."""
        lead = nd - len(core_spec)
        return _sanitize(mesh, (None,) * lead + tuple(core_spec), shape)

    if last == "embed":
        return _sanitize(mesh, ("model", None), shape)
    if last == "lm_head":
        return _sanitize(mesh, (None, "model"), shape)
    if last == "frontend_proj":
        return _sanitize(mesh, (None, "model"), shape)
    if last == "router":
        return build((None, None))

    # MoE experts: (E, d, ff) / (E, ff, d), maybe stacked (L, E, ...)
    if (last in ("w_gate", "w_up", "w_down") and nd >= 3
            and "moe" in path_keys and "shared" not in path_keys):
        E = shape[-3]
        full = axis_size(mesh, "model") * axis_size(mesh, "data")
        if E % full == 0 and full > 1:
            return build((("data", "model"), None, None))
        return build(("model", None, None))

    if last in _COL_MODEL and nd >= 2:
        return build((dax[-1] if zero3 else None, "model"))
    if last in _ROW_MODEL and nd >= 2:
        return build(("model", dax[-1] if zero3 else None))
    if last == "conv_w":
        return build((None, "model"))
    if last == "conv_b":
        return build(("model",))
    return (None,) * nd


def params_pspecs(mesh, cfg: ModelConfig, params: Any) -> Any:
    zero3 = cfg.param_count() > ZERO3_THRESHOLD
    return map_with_path(
        lambda path, leaf: param_pspec(mesh, cfg, path, leaf, zero3), params)


def replicated_pspecs(tree: Any) -> Any:
    return tree_map(lambda l: (None,) * l.ndim, tree)


def batch_pspecs(mesh, cfg: ModelConfig, batch: Any) -> Any:
    dax = data_axes(mesh)

    def fix(leaf):
        if leaf.ndim == 0:
            return ()
        spec = [None] * leaf.ndim
        if _fits(mesh, leaf.shape[0], dax):
            spec[0] = dax if len(dax) > 1 else dax[0]
        elif _fits(mesh, leaf.shape[0], dax[-1]):
            spec[0] = dax[-1]
        return tuple(spec)

    return tree_map(fix, batch)


def cache_pspecs(mesh, cfg: ModelConfig, cache: Any) -> Any:
    """KV caches: batch -> data axes; cache-sequence dim -> model; SSM /
    RWKV states: batch -> data, state dims -> model when divisible."""
    dax = data_axes(mesh)

    def fix(path, leaf):
        last = path[-1]
        nd = leaf.ndim
        base = CACHE_LEAF_RANKS.get(last, nd)
        lead = max(0, nd - base)
        spec = [None] * nd
        if last in ("pos", "length") or nd == lead:
            return tuple(spec)
        b = leaf.shape[lead]
        if _fits(mesh, b, dax):
            spec[lead] = dax if len(dax) > 1 else dax[0]
        elif _fits(mesh, b, dax[-1]):
            spec[lead] = dax[-1]
        if last in ("k", "v", "k_scale", "v_scale", "c_kv", "k_rope",
                    "c_kv_scale", "k_rope_scale") and nd > lead + 1:
            if _fits(mesh, leaf.shape[lead + 1], "model"):
                spec[lead + 1] = "model"
        if last in ("ssm", "wkv") and nd > lead + 1:
            if _fits(mesh, leaf.shape[lead + 1], "model"):
                spec[lead + 1] = "model"
        return tuple(spec)

    return map_with_path(fix, cache)


# -- applying specs ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segments:
    """A spec entry for a dim that fuses segments of ``widths``: each
    segment whose ``cut`` is true is cut contiguously over ``axis`` (this
    rank keeps its share of it), the others stay whole, and the rank's
    pieces keep the segments' order."""
    axis: str
    widths: Tuple[int, ...]
    cut: Tuple[bool, ...]

    def pieces(self, mesh, local: bool = False):
        """(offset, width) of this rank's piece of each segment in the
        whole dim (``local``: in the rank's dim), and the segment's cut."""
        n, idx = mesh.axis_size(self.axis), mesh.axis_index(self.axis)
        off = 0
        for w, c in zip(self.widths, self.cut):
            if c and w % n:
                raise ValueError(f"axis {self.axis!r} of size {n} does not "
                                 f"divide a segment of {w}")
            piece = w // n if c else w
            yield (off if local or not c else off + idx * piece), piece, c
            off += piece if local else w

    def local_width(self, mesh) -> int:
        return sum(w for _, w, _ in self.pieces(mesh, local=True))


def mamba_segments(cfg: ModelConfig, axis: str = "model"):
    """Mamba2's fused dims as :class:`Segments` over ``axis``: ``in_proj``'s
    output ``z | x | B | C | dt`` (the rank's heads' columns of z, x and
    dt; B and C whole: ``n_groups`` = 1, every head reads them) and the
    conv's channels ``x | B | C``."""
    din, st, H = cfg.d_inner, cfg.ssm_state, cfg.num_ssm_heads
    return (Segments(axis, (din, din, 2 * st, H), (True, True, False, True)),
            Segments(axis, (din, 2 * st), (True, False)))


def fused_pspec(cfg: ModelConfig, mesh, path: Tuple, spec: Tuple) -> Tuple:
    """``spec`` (a leaf's rule) with a hybrid's Mamba2 ``in_proj``,
    ``conv_w`` and ``conv_b`` cut segment by segment on a ``model`` axis of
    more than one rank (:func:`mamba_segments`): a contiguous cut of the
    fused dim would hand a rank other heads' channels (the reference's
    GSPMD re-lays it out; the port's layers read the rank's segments).
    The serving engine and the train mesh place them alike."""
    if cfg.family != "hybrid" or mesh.axis_size("model") == 1:
        return spec
    if path[-2:] == ("mixer", "in_proj"):
        return tuple(spec[:-1]) + (mamba_segments(cfg)[0],)
    if path[-2:] in (("mixer", "conv_w"), ("mixer", "conv_b")):
        return tuple(spec[:-1]) + (mamba_segments(cfg)[1],)
    return spec


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _zip_specs(fn: Callable, tree: Any, specs: Any) -> Any:
    if _is_leaf(tree):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_specs(fn, v, s) for v, s in zip(tree, specs))
    return tree


def local_numel(shape, spec: Tuple, mesh) -> int:
    """The elements of this rank's slice of a leaf of ``shape`` under
    ``spec`` (what :func:`shard_leaf` keeps), from the shape alone."""
    total = 1
    for dim, entry in zip(shape, spec):
        if isinstance(entry, Segments):
            dim = entry.local_width(mesh)
        else:
            for a in _axes(entry):
                dim //= mesh.axis_size(a)
        total *= dim
    for dim in tuple(shape)[len(spec):]:
        total *= dim
    return total


def shard_leaf(t: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec`` (a contiguous copy on the
    mesh's device where a dim is cut; ``t`` itself where none is)."""
    out = t
    for d, entry in enumerate(spec):
        if isinstance(entry, Segments):
            out = torch.cat([out.narrow(d, o, w)
                             for o, w, _ in entry.pieces(mesh)], dim=d)
            continue
        n, idx = 1, 0
        for a in _axes(entry):                 # row-major over the axes
            n *= mesh.axis_size(a)
            idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
        if n == 1:
            continue
        if out.shape[d] % n:
            raise ValueError(f"axis {entry!r} of size {n} does not divide "
                             f"dim {d} of shape {tuple(t.shape)}")
        size = out.shape[d] // n
        out = out.narrow(d, idx * size, size)
    if out is t:
        return t
    return out.clone(memory_format=torch.contiguous_format)


def local_bytes(tree: Any, specs: Any, mesh) -> int:
    """The bytes of this rank's slices of every leaf of ``tree`` under
    ``specs``, from the shapes alone."""
    sizes = []
    _zip_specs(lambda t, s: sizes.append(local_numel(t.shape, s, mesh)
                                         * t.element_size()), tree, specs)
    return sum(sizes)


def shard(tree: Any, specs: Any, mesh) -> Any:
    """This rank's slices of every leaf of ``tree`` (the port's
    ``to_shardings`` + ``device_put``)."""
    return _zip_specs(lambda t, s: shard_leaf(t, s, mesh), tree, specs)


def gather_leaf(t: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's slice (``all_gather``, the
    innermost axis of a tuple entry first)."""
    for d, entry in enumerate(spec):
        if isinstance(entry, Segments):
            t = torch.cat([mesh.all_gather(t.narrow(d, o, w).contiguous(),
                                           entry.axis, dim=d) if c
                           else t.narrow(d, o, w)
                           for o, w, c in entry.pieces(mesh, local=True)],
                          dim=d)
            continue
        for a in reversed(_axes(entry)):
            t = mesh.all_gather(t, a, dim=d)
    return t


def gather(tree: Any, specs: Any, mesh) -> Any:
    """The inverse of :func:`shard`."""
    return _zip_specs(lambda t, s: gather_leaf(t, s, mesh), tree, specs)
