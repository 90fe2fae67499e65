"""Training-side tensor and data parallelism (the port's counterpart of the
collectives GSPMD derives, and transposes, when the reference's
``make_train_step`` / ``make_prefill_step`` run under ``jax.jit`` with the
Megatron specs of :mod:`repro_torch.topology.partitioning`, as
``launch/dryrun.py``'s train and prefill builds place them).

Every cross-rank op of the training path is a ``torch.autograd.Function``
whose backward is the transposed collective:

==========  =====================  =================================
op          forward                backward
==========  =====================  =================================
copy        identity               ``all_reduce``
reduce      ``all_reduce``         identity
gather      ``all_gather``         reduce-scatter
split       this rank's slice      ``all_gather``
exchange    ``all_to_all``         the inverse ``all_to_all``
==========  =====================  =================================

Each works over ``model`` or ``data`` through :class:`Mesh` (gloo stages a
CUDA tensor through a CPU copy) and is an identity on an axis of size 1.

The conventions that make the gradients add up.  The residual stream is
replicated over ``model`` and every rank holds its whole gradient.  A
column-parallel projection takes its input through ``copy`` (each rank's
columns give a part of the input's gradient; the backward sums them) and a
row-parallel one ends in ``reduce``.  A tensor that ``gather`` makes whole
feeds work that differs per rank (the rank's columns of the next
projection, the rank's query rows), so each rank's gradient of it is a part
and the backward sums the parts and keeps the rank's slice.  A whole
tensor that goes back to the rank's columns through a plain ``narrow``
(:meth:`TrainParallel.local`) passes back only the rank's part, for the
same reason.  Adapters are replicated (``build_dryrun`` replicates them and
their optimizer state) and are cut to the weight's shard by a plain
``narrow``, so each rank's adapter gradient is its part of the whole:
the train step sums the parts over ``model`` and ``data`` in one packed
``all_reduce`` and every rank then applies the same AdamW update.

ZeRO-3 (``ZERO3_THRESHOLD``): the frozen base weights' other dim is cut over
``data``.  :meth:`TrainParallel.full_weight` gathers a weight right before
its projection and, through ``saved_tensors_hooks``, keeps only the shard
for the backward, which gathers it again.

``counts`` and ``host_s`` hold, per ``"axis:collective"``, the collectives
the path ran and their host time (forward and backward alike).
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Sequence, Tuple

import torch



class TrainParallel:
    """A train mesh ``(data, model)`` as the training layers use it.

    ``size`` / ``index`` are the ``model`` axis's, ``data`` / ``data_index``
    the ``data`` axis's; ``zero3`` says the base weights' other dim is cut
    over ``data`` (the rules' ZeRO-3, above ``ZERO3_THRESHOLD``)."""

    def __init__(self, mesh, zero3: bool = False):
        if "pod" in mesh.axis_names:
            raise ValueError("the training path takes a (data, model) mesh, "
                             f"not {mesh.shape}")
        self.mesh = mesh
        self.size = mesh.axis_size("model")
        self.index = mesh.axis_index("model")
        self.data = mesh.axis_size("data")
        self.data_index = mesh.axis_index("data")
        self.zero3 = bool(zero3) and self.data > 1
        self.counts: collections.Counter = collections.Counter()
        self.host_s: collections.Counter = collections.Counter()

    def reset_counts(self) -> None:
        self.counts.clear()
        self.host_s.clear()

    # -- collectives, counted ------------------------------------------------
    def _timed(self, key: str, fn):
        t0 = time.perf_counter()
        out = fn()
        self.host_s[key] += time.perf_counter() - t0
        self.counts[key] += 1
        return out

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over ``axis`` in fp32, in ``t``'s dtype (no autograd)."""
        if self.mesh.axis_size(axis) == 1:
            return t
        return self._timed(f"{axis}:all_reduce", lambda: self.mesh.all_reduce(
            t.float(), axis).to(t.dtype))

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``dim`` (no autograd)."""
        if self.mesh.axis_size(axis) == 1:
            return t
        return self._timed(f"{axis}:all_gather", lambda: self.mesh.all_gather(
            t.contiguous(), axis, dim=dim))

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """The sum over ``axis`` and this rank's slice of ``dim`` (an
        ``all_reduce`` and a slice: gloo has no reduce-scatter)."""
        n = self.mesh.axis_size(axis)
        if n == 1:
            return t

        def run():
            s = self.mesh.all_reduce(t.float(), axis).to(t.dtype)
            w = t.shape[dim] // n
            return s.narrow(dim, self.mesh.axis_index(axis) * w, w).contiguous()
        return self._timed(f"{axis}:reduce_scatter", run)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        if self.mesh.axis_size(axis) == 1:
            return t
        return self._timed(f"{axis}:all_to_all", lambda: self.mesh.all_to_all(
            t, axis, split_dim % t.dim(), concat_dim % t.dim()))

    def sum_grads(self, grads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """The adapter gradients summed over every axis of the mesh: one
        ``all_reduce`` of all of them packed into one fp32 buffer."""
        if self.mesh.size == 1 or not grads:
            return tuple(grads)

        flat = self._timed("world:all_reduce", lambda: self.mesh.all_reduce_all(
            torch.cat([g.float().reshape(-1) for g in grads])))
        out, off = [], 0
        for g in grads:
            out.append(flat[off: off + g.numel()].reshape(g.shape).to(g.dtype))
            off += g.numel()
        return tuple(out)

    # -- the autograd ops ----------------------------------------------------
    def copy(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        if self.mesh.axis_size(axis) == 1:
            return x
        return _Copy.apply(x, self, axis)

    def reduce(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        if self.mesh.axis_size(axis) == 1:
            return x
        return _Reduce.apply(x, self, axis)

    def gather(self, x: torch.Tensor, dim: int = -1,
               axis: str = "model") -> torch.Tensor:
        if self.mesh.axis_size(axis) == 1:
            return x
        return _Gather.apply(x, self, axis, dim % x.dim())

    def split(self, x: torch.Tensor, dim: int = -1,
              axis: str = "model") -> torch.Tensor:
        if self.mesh.axis_size(axis) == 1:
            return x
        return _Split.apply(x, self, axis, dim % x.dim())

    def exchange(self, x: torch.Tensor, split_dim: int, concat_dim: int,
                 axis: str = "model") -> torch.Tensor:
        if self.mesh.axis_size(axis) == 1:
            return x
        return _Exchange.apply(x, self, axis, split_dim % x.dim(),
                               concat_dim % x.dim())

    def gather_packed(self, ts: Sequence[torch.Tensor], axis: str = "model"
                      ) -> Tuple[torch.Tensor, ...]:
        """``gather`` of several (..., w_i) tensors along their last dim
        through ONE collective (concatenated, gathered, cut apart)."""
        n = self.mesh.axis_size(axis)
        if n == 1:
            return tuple(ts)
        widths = [t.shape[-1] for t in ts]
        whole = self.gather(torch.cat(ts, dim=-1), -1, axis)
        parts = whole.reshape(*whole.shape[:-1], n, sum(widths))
        out, off = [], 0
        for w in widths:
            out.append(parts[..., off: off + w].reshape(*whole.shape[:-1], n * w))
            off += w
        return tuple(out)

    def local(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's ``model`` slice of ``dim`` by a plain ``narrow`` (a
        replicated bias, adapter factor or whole activation; the backward
        passes back this rank's part only)."""
        if self.size == 1:
            return t
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)

    # -- ZeRO-3 --------------------------------------------------------------
    @contextlib.contextmanager
    def full_weight(self, w: torch.Tensor, dim: int):
        """``w`` gathered over ``data`` along ``dim`` for one projection
        (the base is frozen: no gradient).  Inside the block every tensor
        autograd saves that views the gathered weight is saved as the shard
        and gathered again when the backward reads it."""
        if not self.zero3:
            yield w
            return
        shard = w.detach()
        whole = self.all_gather(shard, "data", dim % w.dim())
        ptr = whole.untyped_storage().data_ptr()

        def pack(t):
            if t.untyped_storage().data_ptr() != ptr:
                return t
            return (_ZeroShard, shard, dim % w.dim(), tuple(t.shape),
                    t.stride(), t.storage_offset(), t.dtype)

        def unpack(obj):
            if not (isinstance(obj, tuple) and obj and obj[0] is _ZeroShard):
                return obj
            _, sh, d, shape, stride, offset, dtype = obj
            again = self.all_gather(sh, "data", d)
            return again.as_strided(shape, stride, offset).to(dtype)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield whole


class _ZeroShard:
    """Marker of a ZeRO-3 weight saved as its shard."""


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, axis):
        ctx.tp, ctx.axis = tp, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g, ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, axis):
        return tp.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, axis, dim):
        ctx.tp, ctx.axis, ctx.dim = tp, axis, dim
        return tp.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.reduce_scatter(g, ctx.axis, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, axis, dim):
        ctx.tp, ctx.axis, ctx.dim = tp, axis, dim
        n = tp.mesh.axis_size(axis)
        w = x.shape[dim] // n
        return x.narrow(dim, tp.mesh.axis_index(axis) * w, w).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather(g, ctx.axis, ctx.dim), None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, axis, split_dim, concat_dim):
        ctx.tp, ctx.axis = tp, axis
        ctx.split_dim, ctx.concat_dim = split_dim, concat_dim
        return tp.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.tp.all_to_all(g.contiguous(), ctx.axis, ctx.concat_dim,
                                  ctx.split_dim), None, None, None, None)


# -- placement: what build_dryrun's in_shardings do ---------------------------

def zero3_on(cfg) -> bool:
    """The rules' ZeRO-3 test (the threshold read when called)."""
    from repro_torch.topology import partitioning
    return cfg.param_count() > partitioning.ZERO3_THRESHOLD


def train_parallel(cfg, mesh) -> TrainParallel:
    """The train mesh ``mesh`` as the layers of ``cfg`` use it."""
    return TrainParallel(mesh, zero3=zero3_on(cfg))


def shard_params(cfg, params, mesh):
    """This rank's slices of a whole param tree (the reference's, carried
    by :mod:`repro_torch.convert`, or the port's init) by
    ``params_pspecs``.  Adapters and optimizer state stay replicated, as
    ``build_dryrun`` places them."""
    from repro_torch.topology.partitioning import params_pspecs, shard
    return shard(params, params_pspecs(mesh, cfg, params), mesh)


def init_keep(cfg, mesh):
    """``keep(path, leaf)`` for ``T.init(..., keep=)``: each weight cut to
    this rank's slice by the rules as soon as it is drawn, so a rank never
    holds the whole model and its shards equal the whole init's slices."""
    from repro_torch.topology.partitioning import param_pspec, shard_leaf
    zero3 = zero3_on(cfg)
    return lambda path, t: shard_leaf(t, param_pspec(mesh, cfg, path, t,
                                                     zero3), mesh)


def shard_batch(cfg, batch, mesh, grad_accum: int = 1):
    """This rank's rows of a whole batch (a dict of tensors) by
    ``batch_pspecs``.  With
    ``grad_accum`` = k the batch is cut microbatch by microbatch (the
    reference's ``reshape(k, B/k, ...)``: microbatch i is global rows
    [i·B/k, (i+1)·B/k), whose ``data`` slices the ranks hold), so the
    rank's rows are its slice of each microbatch in order."""
    from repro_torch.topology.partitioning import batch_pspecs, shard
    if grad_accum == 1:
        return shard(batch, batch_pspecs(mesh, cfg, batch), mesh)
    micro = {k: t.reshape(grad_accum, t.shape[0] // grad_accum, *t.shape[1:])
             for k, t in batch.items()}
    specs = batch_pspecs(mesh, cfg, {k: t[0] for k, t in micro.items()})
    local = shard(micro, {k: (None,) + s for k, s in specs.items()}, mesh)
    return {k: t.reshape(-1, *t.shape[2:]) for k, t in local.items()}


def step_collectives(cfg, model: int, data: int, S: int, *,
                     loss_chunk: int = 512, use_kernels: bool = False,
                     kind: str = "train", grad_accum: int = 1) -> dict:
    """The collectives one train / eval / prefill step of a dense GQA or
    dense MLA model runs on a ``(data, model)`` mesh, as the design makes
    them (``TrainParallel.counts``' keys), with adapters on the attention
    targets (``lora_targets``) and S tokens a row:

    * a layer's ``reduce`` after each row-parallel projection (2), and in
      the backward a ``copy``'s ``all_reduce`` before each column-parallel
      group (2, less the first layer's attention, whose input, the frozen
      embedding, takes no gradient);
    * the attention branch's: sequence-parallel GQA one packed K/V
      ``all_gather`` (a reduce-scatter backward) and two exchanges each
      way; the batch fallback (and the kernel route where the axis does
      not divide the KV heads) one packed q/k/v ``all_gather``; MLA one
      packed ``wq_a`` / ``wkv_a`` ``all_gather``, and on its
      sequence-parallel route ``wkv_b``'s gather and two exchanges each
      way;
    * where the axis cuts the vocab: the embedding's ``reduce``, and a
      loss chunk's ``all_gather`` (max, argmax) and ``all_reduce`` (sum of
      exponentials, target logit) with the hidden states' ``copy``; or the
      prefill's logits gathered;
    * over ``data``: the loss's sums (the prefill's rows gathered), and
      under ZeRO-3 (GQA) each of a layer's 7 weights gathered for the
      forward and again for the backward where autograd kept it (not the
      first layer's q/k/v on the plain route: their input takes no
      gradient);
    * per microbatch, and once a train step the packed gradient sum."""
    train, L = kind == "train", cfg.num_layers
    c = collections.Counter()
    if model > 1:
        vocab = cfg.vocab_size % model == 0
        c["model:all_reduce"] = 2 * L + (2 * L - 1 if train else 0) + vocab
        a2a = 0
        if cfg.use_mla:
            seq = S % min(S, 512) == 0 and S % model == 0
            c["model:all_gather"] += L * (2 if seq else 1)
            c["model:reduce_scatter"] += L * train
            a2a = 2 * L * seq
        else:
            K = cfg.num_kv_heads
            if K % model == 0:
                branch = "heads"
            elif use_kernels or S % min(S, 512) or S % model:
                branch = "batch"
            else:
                branch = "sequence"
            if branch != "heads":
                c["model:all_gather"] += L
                c["model:reduce_scatter"] += L * train
            a2a = 2 * L * (branch == "sequence")
        c["model:all_to_all"] = a2a * (2 if train else 1)
        if vocab and kind == "prefill":
            c["model:all_gather"] += 1
        elif vocab:
            Sm = S - 1
            chunks = Sm // min(loss_chunk, Sm) + bool(Sm % min(loss_chunk, Sm))
            c["model:all_gather"] += chunks
            c["model:all_reduce"] += chunks + train
    if data > 1:
        c["data:all_gather" if kind == "prefill" else "data:all_reduce"] += 1
        if zero3_on(cfg):
            c["data:all_gather"] += 7 * L + (
                (7 * L - (0 if use_kernels else 3)) if train else 0)
    c = {k: v * (grad_accum if train else 1) for k, v in c.items() if v}
    if train and model * data > 1:
        c["world:all_reduce"] = 1
    return c
