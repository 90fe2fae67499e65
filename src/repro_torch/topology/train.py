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
join        ``all_gather``         this rank's slice
split       this rank's slice      ``all_gather``
exchange    ``all_to_all``         the inverse ``all_to_all``
==========  =====================  =================================

Each works over ``model``, ``data`` or the tuple ``("data", "model")``
(the world's group, data-major) through :class:`Mesh` (gloo stages a CUDA
tensor through a CPU copy) and is an identity where the size is 1.

The conventions that make the gradients add up.  The residual stream is
replicated over ``model`` and every rank holds its whole gradient.  A
column-parallel projection takes its input through ``copy`` (each rank's
columns give a part of the input's gradient; the backward sums them) and a
row-parallel one ends in ``reduce``.  A tensor that ``gather`` makes whole
feeds work that differs per rank (the rank's columns of the next
projection, the rank's query rows), so each rank's gradient of it is a part
and the backward sums the parts and keeps the rank's slice; one that
``join`` makes whole feeds replicated work (RWKV6's ``wcr`` gate, a MoE
slab rejoining the residual stream), whose gradient every rank holds
whole, so the backward only keeps the rank's slice.  A whole
tensor that goes back to the rank's columns through a plain ``narrow``
(:meth:`TrainParallel.local`) passes back only the rank's part, for the
same reason.  A whole value that every rank computes alike from a
``copy``'s output (a MoE fallback's aux) would have its gradient counted
once a rank: it is scaled by 1 / ranks (:func:`once`).  Adapters are
replicated (``build_dryrun`` replicates them and
their optimizer state) and are cut to the weight's shard by a plain
``narrow``, so each rank's adapter gradient is its part of the whole:
the train step sums the parts over ``model`` and ``data`` in one packed
``all_reduce`` and every rank then applies the same AdamW update.

ZeRO-3 (``ZERO3_THRESHOLD``): the frozen base weights' other dim is cut over
``data``.  :meth:`TrainParallel.full_weight` gathers a weight right before
its projection and, through ``saved_tensors_hooks``, keeps only the shard
for the backward, which gathers it again.

``counts`` and ``host_s`` hold, per ``"axis:collective"``, the collectives
the path ran and their host time (forward and backward alike); a tuple
of axes is keyed by its axes of size > 1 joined by ``+``
(``"data+model:all_to_all"``), the packed gradient sum by ``world``.

Placement: :func:`train_pspecs` are the rules' ``params_pspecs`` with
Mamba2's fused ``in_proj`` / ``conv_w`` / ``conv_b`` cut segment by
segment (:func:`repro_torch.topology.partitioning.fused_pspec`, the
serving engine's placement), and :func:`train_experts` the experts a rank
holds under the rules' expert axes.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Optional, Sequence, Tuple

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
    def _key(self, axis) -> str:
        return "+".join(self.mesh.live_axes(axis))

    def _timed(self, key: str, fn):
        t0 = time.perf_counter()
        out = fn()
        self.host_s[key] += time.perf_counter() - t0
        self.counts[key] += 1
        return out

    def all_reduce(self, t: torch.Tensor, axis) -> torch.Tensor:
        """The sum over ``axis`` in fp32, in ``t``'s dtype (no autograd)."""
        if self.mesh.axis_size(axis) == 1:
            return t
        return self._timed(f"{self._key(axis)}:all_reduce",
                           lambda: self.mesh.all_reduce(t.float(), axis)
                           .to(t.dtype))

    def all_gather(self, t: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``dim`` (no autograd)."""
        if self.mesh.axis_size(axis) == 1:
            return t
        return self._timed(f"{self._key(axis)}:all_gather",
                           lambda: self.mesh.all_gather(t.contiguous(), axis,
                                                        dim=dim))

    def reduce_scatter(self, t: torch.Tensor, axis, dim: int
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
        return self._timed(f"{self._key(axis)}:reduce_scatter", run)

    def all_to_all(self, t: torch.Tensor, axis, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        if self.mesh.axis_size(axis) == 1:
            return t
        return self._timed(f"{self._key(axis)}:all_to_all",
                           lambda: self.mesh.all_to_all(
                               t, axis, split_dim % t.dim(),
                               concat_dim % t.dim()))

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

    def join(self, x: torch.Tensor, dim: int = -1,
             axis: str = "model") -> torch.Tensor:
        """``gather`` for a tensor whose gradient every rank holds whole
        (it feeds replicated work): the backward keeps the rank's slice,
        with no collective."""
        if self.mesh.axis_size(axis) == 1:
            return x
        return _Join.apply(x, self, axis, dim % x.dim())

    def split(self, x: torch.Tensor, dim: int = -1,
              axis: str = "model") -> torch.Tensor:
        if self.mesh.axis_size(axis) == 1:
            return x
        return _Split.apply(x, self, axis, dim % x.dim())

    def exchange(self, x: torch.Tensor, split_dim: int, concat_dim: int,
                 axis="model") -> torch.Tensor:
        """The tiled ``all_to_all`` over ``axis`` (a name or a tuple of
        axes: a MoE layer's expert axes); the backward is the inverse
        exchange over the same axes."""
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


def once(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` as it is, its gradient divided by ``n``: a whole value that
    ``n`` ranks compute alike from a ``copy``'s output, whose gradient the
    ``copy`` (and the packed gradient sum) would otherwise count ``n``
    times."""
    return t if n == 1 else _Once.apply(t, n)


class _Once(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


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


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, x.shape[dim]
        ctx.index = tp.mesh.axis_index(axis)
        return tp.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width),
                None, None, None)


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


def train_pspecs(mesh, cfg, params):
    """The specs a train mesh places ``params`` by: ``params_pspecs`` with
    Mamba2's fused leaves cut segment by segment
    (:func:`repro_torch.topology.partitioning.fused_pspec`)."""
    from repro_torch.topology.partitioning import (fused_pspec, map_with_path,
                                                   params_pspecs)
    specs = params_pspecs(mesh, cfg, params)

    def at(path):
        node = specs
        for k in path:
            node = node[k]
        return node
    return map_with_path(lambda path, _: fused_pspec(cfg, mesh, path, at(path)),
                         params)


def shard_params(cfg, params, mesh):
    """This rank's slices of a whole param tree (the reference's, carried
    by :mod:`repro_torch.convert`, or the port's init) by
    :func:`train_pspecs`.  Adapters and optimizer state stay replicated,
    as ``build_dryrun`` places them."""
    from repro_torch.topology.partitioning import shard
    return shard(params, train_pspecs(mesh, cfg, params), mesh)


def expert_axes(cfg, mesh) -> Tuple[str, ...]:
    """The axes the rules cut a MoE layer's expert stacks over:
    ``("data", "model")`` where E divides their product (> 1), else
    ``("model",)`` where E divides it, else none (replicated)."""
    E = cfg.num_experts
    m, d = mesh.axis_size("model"), mesh.axis_size("data")
    if not E:
        return ()
    if m * d > 1 and E % (m * d) == 0:
        return ("data", "model")
    if m > 1 and E % m == 0:
        return ("model",)
    return ()


def train_experts(cfg, mesh) -> Optional[Tuple[int, int]]:
    """The experts ``[e0, e1)`` this rank holds under the rules
    (``T.init``'s ``experts``), or None where it holds every one."""
    axes = expert_axes(cfg, mesh)
    if not axes:
        return None
    n, r = mesh.axis_size(axes), mesh.axis_index(axes)
    E = cfg.num_experts
    return r * E // n, (r + 1) * E // n


def init_keep(cfg, mesh):
    """``keep(path, leaf)`` for ``T.init(..., keep=)``: each weight cut to
    this rank's slice by :func:`train_pspecs`' rule as soon as it is
    drawn, so a rank never holds the whole model and its shards equal the
    whole init's slices (pass ``experts=train_experts(cfg, mesh)`` too, so
    a rank draws only its experts' stacks whole)."""
    from repro_torch.topology.partitioning import (fused_pspec, param_pspec,
                                                   shard_leaf)
    zero3 = zero3_on(cfg)
    return lambda path, t: shard_leaf(t, fused_pspec(
        cfg, mesh, path, param_pspec(mesh, cfg, path, t, zero3)), mesh)


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
                     kind: str = "train", grad_accum: int = 1,
                     patches: int = 0) -> dict:
    """The collectives one train / eval / prefill step of ``cfg`` runs on a
    ``(data, model)`` mesh, as the design makes them (``TrainParallel.
    counts``' keys), with adapters on ``lora_targets`` and S tokens a row
    (a vision batch's text tokens after ``patches`` patch embeddings; an
    audio batch's frames).  Layer by layer over the plan, where the axis
    is > 1, in the forward and (a train step) the backward:

    * attention (GQA, MLA, the hybrid's shared block): ``reduce`` after
      ``wo``, and a ``copy``'s ``all_reduce`` before q/k/v (not in the
      first layer, whose input, the frozen embedding or front end, takes
      no gradient); the branch's: sequence-parallel GQA one packed K/V
      ``all_gather`` (a reduce-scatter backward) and two exchanges each
      way; the batch fallback (and the kernel route where the axis does
      not divide the KV heads) one packed q/k/v ``all_gather``; MLA one
      packed ``wq_a`` / ``wkv_a`` ``all_gather``, and on its
      sequence-parallel route ``wkv_b``'s gather and two exchanges each
      way; an MLP (and DeepSeek-V3's shared expert) a ``reduce`` and a
      ``copy``;
    * a MoE layer on ``_moe_fwd_sharded``'s route (S divisible by the
      axis, the experts cut): the ``copy``, two exchanges each way over
      the expert axes, the slab's ``join`` and aux's ``reduce`` over both
      axes; on the mesh-less route: the ``copy``, the rows gathered over
      ``data`` (a reduce-scatter backward) and one ``reduce`` of the
      partial rows (over both axes and a ``split`` over ``data``, where
      the experts are cut over both; over ``model`` otherwise);
    * RWKV6: a time mix's ``copy``, ``dd_w1`` / ``wd1``'s gathers (their
      reduce-scatters not in the first layer) and ``wo``'s ``reduce``; a
      channel mix's ``copy``, ``wcr``'s ``join`` and ``wcv``'s ``reduce``;
    * Mamba2: the ``copy`` before ``in_proj`` (not in the first layer),
      the norm's sum of squares (``reduce`` then ``copy``) and
      ``out_proj``'s ``reduce``;
    * the front end's product gathered where the axis cuts
      ``frontend_proj``; where it cuts the vocab: the embedding's
      ``reduce`` (a batch with tokens), and a loss chunk's ``all_gather``
      (max, argmax) and ``all_reduce`` (sum of exponentials, target
      logit) with the hidden states' ``copy``; or the prefill's logits
      gathered;
    * over ``data``: the loss's sums (the prefill's rows gathered), and
      under ZeRO-3 (dense GQA only) each of a layer's 7 weights gathered
      for the forward and again for the backward where autograd kept it
      (not the first layer's q/k/v on the plain route: their input takes
      no gradient);
    * per microbatch, and once a train step the packed gradient sum."""
    from repro_torch.models.transformer import layer_plan
    from repro_torch.topology.mesh import abstract_mesh
    train, L = kind == "train", cfg.num_layers
    mesh = abstract_mesh({"data": data, "model": model})
    c = collections.Counter()
    Sx = S + patches

    def key(axes):
        return "+".join(mesh.live_axes(axes))

    def attention(first: bool):
        c["model:all_reduce"] += 1 + (train and not first)
        if cfg.use_mla:
            seq = Sx % min(Sx, 512) == 0 and Sx % model == 0
            c["model:all_gather"] += 2 if seq else 1
            c["model:reduce_scatter"] += train
            c["model:all_to_all"] += 2 * seq * (2 if train else 1)
            return
        K = cfg.num_kv_heads
        if K % model == 0:
            return
        c["model:all_gather"] += 1
        c["model:reduce_scatter"] += train
        if not (use_kernels or Sx % min(Sx, 512) or Sx % model):
            c["model:all_to_all"] += 2 * (2 if train else 1)

    def mlp():
        c["model:all_reduce"] += 1 + train

    def moe():
        axes = expert_axes(cfg, mesh)
        c["model:all_reduce"] += train * (model > 1)        # the copy
        if model > 1 and Sx % model == 0 and axes:
            c[key(axes) + ":all_to_all"] += 2 * (2 if train else 1)
            c["model:all_gather"] += 1                      # the join
            c[key(("data", "model")) + ":all_reduce"] += 1  # aux
        else:
            if data > 1:
                c["data:all_gather"] += 1
                c["data:reduce_scatter"] += train
            if axes == ("data", "model"):
                c[key(axes) + ":all_reduce"] += 1
                c["data:all_gather"] += train * (data > 1)  # split's backward
            elif model > 1:
                c["model:all_reduce"] += 1
        if cfg.num_shared_experts and model > 1:
            mlp()

    def rwkv(first: bool):
        c["model:all_reduce"] += 2 + train * (2 - first)
        c["model:all_gather"] += 3
        c["model:reduce_scatter"] += train * 2 * (not first)

    def mamba(first: bool):
        c["model:all_reduce"] += 2 + train * (2 - first)

    first = True
    for kind_, count in layer_plan(cfg):
        for _ in range(1 if kind_ == "shared" else count):
            if kind_ == "rwkv":
                if model > 1:
                    rwkv(first)
            elif kind_ == "mamba":
                if model > 1:
                    mamba(first)
            else:
                if model > 1:
                    attention(first)
                if kind_.endswith("moe"):
                    moe()
                elif model > 1:
                    mlp()
            first = False
    if model > 1:
        if cfg.frontend and cfg.d_model % model == 0:
            c["model:all_gather"] += 1
        vocab = cfg.vocab_size % model == 0
        if vocab and cfg.frontend != "audio":
            c["model:all_reduce"] += 1
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
            if cfg.family != "dense" or cfg.use_mla or cfg.num_experts:
                raise ValueError("ZeRO-3's gathers are counted for dense GQA "
                                 f"models only, not {cfg.name}")
            c["data:all_gather"] += 7 * L + (
                (7 * L - (0 if use_kernels else 3)) if train else 0)
    c = {k: v * (grad_accum if train else 1) for k, v in c.items() if v}
    if train and model * data > 1:
        c["world:all_reduce"] = 1
    return c
