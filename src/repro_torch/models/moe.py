"""Mixture-of-Experts layer (port of ``repro.models.moe``): token-choice
top-k routing, capacity-bounded sort-based dispatch, and the experts as
grouped products; granite-moe (32 experts, top-8, softmax router) and
DeepSeek-V3 (256 routed experts top-8 with sigmoid scores, plus one shared
expert).

Dispatch follows the reference step for step, so the same tokens keep the
same experts and the same capacity slots: a stable sort of the flattened
``(token, choice)`` pairs by expert, ``searchsorted`` for each expert's
first sorted entry, a slot ``pos < C`` kept and the rest sent to a dummy
expert row ``E`` of an ``(E + 1, C, d)`` buffer, the experts as batched
products over ``(E, C, d)``.  The slots are then carried back to token
order (the sort permutation inverted), so the combine gathers each
token's k rows into ``(T, k, d)`` and sums over k in a fixed order, and
two calls give the same bits; the reference scatter-adds them in sorted
order (an ``index_add_`` on CUDA sums with atomics).  The whole path makes
no host synchronisation (no ``item``, ``nonzero``, boolean-mask indexing or
data-dependent shapes), so the serving engine captures it in its graphs.

``groups`` routes G slabs of tokens each on their own, with the capacity
of one slab: the cohort step's clients, as the reference's ``vmap`` of one
client's step routes each client's rows alone.

``tp`` (a serve mesh's ``model`` axis of m ranks,
:class:`repro_torch.topology.serve.ModelParallel`) runs the layer expert
parallel, each rank holding experts ``[r·E/m, (r+1)·E/m)`` (the rules'
expert axis over ``model``), on the two routes of the reference's
``moe_fwd`` under a mesh:

* a chunk whose width S divides m takes ``_moe_fwd_sharded``'s route: the
  rank routes its sequence slice ``x[:, r·S/m:(r+1)·S/m]`` alone at the
  capacity of its own B·S/m tokens, one tiled ``all_to_all`` sends the
  ``(E, C, d)`` slots to the experts' owners and one brings them back,
  the combine is local, aux is the mean over ranks, and one
  ``all_gather`` makes the chunk whole again for the next layer;
* any other chunk (the engine's width-1 decode steps) takes the reference's
  other route: every rank routes all B·S tokens at the global capacity,
  runs only its own experts' slots and combines those rows, and one
  ``all_reduce`` sums the partial rows.

DeepSeek-V3's shared expert is Megatron-split (``mlp_fwd(..., tp=)``).

``tp`` may also be a train mesh (:class:`repro_torch.topology.train.
TrainParallel`): the same two routes under autograd, the sharded one over
the batch's ``data`` rows too (:func:`_moe_fwd_train`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as Lyr

Params = Dict[str, Any]

#: largest fp32 temporary (elements) that ``init_moe`` draws at once
INIT_CHUNK = 1 << 28


def _normal_stack(gen: torch.Generator, shape, in_dim: int,
                  dtype: torch.dtype, keep: Optional[Tuple[int, int]] = None
                  ) -> torch.Tensor:
    """N(0, 1/in_dim) weights of ``shape`` = (L, E, a, b), drawn a few
    experts at a time into the model dtype, so no fp32 temporary of the
    whole stack is made (one DeepSeek-V3 layer's is 15 GB).  ``keep`` =
    (e0, e1) keeps experts [e0, e1) only: every expert is still drawn, in
    the same order, so the kept ones equal the whole stack's."""
    L, E, a, b = shape
    e_lo, e_hi = keep or (0, E)
    out = torch.empty((L, e_hi - e_lo, a, b), dtype=dtype, device=gen.device)
    n = max(1, min(E, INIT_CHUNK // max(1, a * b)))
    std = in_dim ** -0.5
    for li in range(L):
        for e0 in range(0, E, n):
            e1 = min(E, e0 + n)
            w = torch.randn((e1 - e0, a, b), generator=gen, device=gen.device)
            lo, hi = max(e0, e_lo), min(e1, e_hi)
            if lo < hi:
                out[li, lo - e_lo:hi - e_lo] = (w[lo - e0:hi - e0] * std).to(dtype)
    return out


def init_moe(cfg: ModelConfig, gen: torch.Generator, L: int,
             dtype: torch.dtype, experts: Optional[Tuple[int, int]] = None
             ) -> Params:
    """Stacked MoE weights of ``L`` layers: the router ``(L, d, E)`` in
    fp32, the experts ``w_gate``/``w_up`` ``(L, E, d, e_ff)`` and
    ``w_down`` ``(L, E, e_ff, d)`` in the model dtype, and DeepSeek-V3's
    shared expert (a SwiGLU of ``e_ff · num_shared_experts``).  ``L = 0``
    gives the zero-size leaves of an empty segment.  ``experts`` = (e0, e1)
    makes only those experts' stacks (``_normal_stack``'s ``keep``)."""
    d, E = cfg.d_model, cfg.num_experts
    e_ff = cfg.moe_d_ff or cfg.d_ff
    p = {"router": Lyr.dense_init(gen, (L, d, E), d, torch.float32),
         "w_gate": _normal_stack(gen, (L, E, d, e_ff), d, dtype, experts),
         "w_up": _normal_stack(gen, (L, E, d, e_ff), d, dtype, experts),
         "w_down": _normal_stack(gen, (L, E, e_ff, d), e_ff, dtype, experts)}
    if cfg.num_shared_experts:
        p["shared"] = Lyr.init_mlp(cfg, gen, L, dtype,
                                   d_ff=e_ff * cfg.num_shared_experts)
    return p


def router_scores(cfg: ModelConfig, router_w: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """(..., E) routing probabilities in fp32: a softmax, or DeepSeek-V3's
    sigmoid."""
    logits = x.float() @ router_w
    if cfg.router_sigmoid:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def _capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Slots per expert: ``int(f·T·k/E)`` rounded up to a multiple of 8,
    at least 8 (the reference's arithmetic, in Python)."""
    k, E = cfg.experts_per_token, cfg.num_experts
    c = int(cfg.moe_capacity_factor * num_tokens * k / E)
    return max(8, (c + 7) // 8 * 8)


def _route_and_dispatch(cfg: ModelConfig, router_w: torch.Tensor,
                        xt: torch.Tensor, C: int):
    """Top-k routing and capacity dispatch of G token slabs ``xt (G, T,
    d)``, each routed on its own.  Returns the expert buffer ``(G, E, C,
    d)``, the combine metadata ``(dst_e, dst_c, w)`` of shape (G, T·k) in
    token order (entry t·k + j is token t's j-th choice: its expert, or E
    where dropped, its slot and its weight, 0 where dropped) and the
    load-balancing loss per slab ``(G,)``."""
    G, T, d = xt.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    dev = xt.device
    probs = router_scores(cfg, router_w, xt)                   # (G, T, E)
    top_w, top_e = torch.topk(probs, k, dim=-1)                # (G, T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balancing loss; the one-hot counts as a comparison
    experts = torch.arange(E, device=dev)
    me = probs.mean(1)                                          # (G, E)
    ce = (top_e[..., None] == experts).float().sum(2).mean(1)   # (G, E)
    aux = E * (me * ce).sum(-1)

    flat_e = top_e.reshape(G, T * k)        # entry t·k + j: token t's j-th choice
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)                                # sorted experts
    seg_start = torch.searchsorted(se, experts.expand(G, E).contiguous(),
                                   right=False)                 # (G, E)
    pos_sorted = torch.arange(T * k, device=dev) - seg_start.gather(1, se)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = pos < C
    dst_e = torch.where(keep, flat_e, torch.full_like(flat_e, E))
    dst_c = torch.where(keep, pos, torch.zeros_like(pos))
    # one scatter along the slot axis (advanced indexing's backward, with
    # each token k times, sorts on the card)
    rows = xt[:, :, None, :].expand(G, T, k, d).reshape(G, T * k, d)
    slot = (dst_e * C + dst_c)[..., None].expand(G, T * k, d)
    buf = torch.zeros((G, (E + 1) * C, d), dtype=xt.dtype, device=dev)
    buf = buf.scatter(1, slot, rows).reshape(G, E + 1, C, d)
    w = top_w.reshape(G, T * k) * keep
    return buf[:, :E], (dst_e, dst_c, w), aux


def _combine(eo: torch.Tensor, meta, k: int, e0: int = 0) -> torch.Tensor:
    """Each token's k expert outputs, weighted and summed in choice order:
    ``eo (G, E', C, d)`` -> ``(G, T, d)``, ``eo`` holding experts ``[e0,
    e0 + E')`` (all of them by default); a dropped choice, or one of an
    expert outside them, has weight 0."""
    dst_e, dst_c, w = meta
    G, El, C, d = eo.shape
    n = dst_e.shape[1]
    le = dst_e - e0
    mine = (le >= 0) & (le < El)
    slot = (torch.where(mine, le, 0) * C + dst_c)[..., None].expand(G, n, d)
    rows = (eo.reshape(G, El * C, d).gather(1, slot)
            * (w * mine)[..., None].to(eo.dtype))
    return rows.reshape(G, n // k, k, d).sum(2)


def _experts(p: Params, ebuf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert on its slots: ``ebuf (E, N, d)`` ->
    ``(E, N, d)``, the SiLU in fp32 as in the reference."""
    g = torch.bmm(ebuf, p["w_gate"])
    u = torch.bmm(ebuf, p["w_up"])
    h = torch.nn.functional.silu(g.float()).to(ebuf.dtype) * u
    return torch.bmm(h, p["w_down"])


def moe_fwd(cfg: ModelConfig, p: Params, x: torch.Tensor,
            adapters: Optional[Dict] = None, groups: int = 0,
            use_kernel: bool = False, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss).

    ``groups`` = G > 0 splits the batch into G slabs of B/G rows routed
    each on its own, capacity from one slab's tokens, and returns aux of
    shape (G,) (the cohort step's clients); 0 routes all B·S tokens at
    once and returns a scalar aux.  The shared expert (DeepSeek-V3) runs
    on every token through :func:`repro_torch.models.layers.mlp_fwd` with
    ``adapters["shared"]`` (``use_kernel`` as there).  ``tp`` runs the
    layer expert parallel on the rank's experts (the module docstring's
    two routes; ``groups`` 0): a serve mesh's ``model`` axis, or a train
    mesh (:func:`_moe_fwd_train`)."""
    if Lyr._train(tp):
        if tp.mesh.size > 1:
            return _moe_fwd_train(cfg, p, x, adapters, tp, use_kernel)
    elif tp is not None and tp.size > 1:
        return _moe_fwd_tp(cfg, p, x, adapters, tp)
    B, S, d = x.shape
    G = groups or 1
    xt = x.reshape(G, (B // G) * S, d)
    T = xt.shape[1]
    E, k = cfg.num_experts, cfg.experts_per_token
    C = _capacity(cfg, T)
    buf, meta, aux = _route_and_dispatch(cfg, p["router"], xt, C)
    eo = _experts(p, buf.transpose(0, 1).reshape(E, G * C, d))
    out = _combine(eo.reshape(E, G, C, d).transpose(0, 1), meta, k)
    out = out.reshape(B, S, d)
    if cfg.num_shared_experts:
        out = out + Lyr.mlp_fwd(p["shared"], x, (adapters or {}).get("shared"),
                                use_kernel=use_kernel)
    return out, (aux if groups else aux[0])


def _moe_fwd_tp(cfg: ModelConfig, p: Params, x: torch.Tensor,
                adapters: Optional[Dict], tp) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_fwd` on a ``model`` axis of m ranks, ``p`` holding this
    rank's E/m experts and its shard of the shared expert."""
    B, S, d = x.shape
    k, m = cfg.experts_per_token, tp.size
    El = cfg.num_experts // m
    if S % m == 0:
        Sl = S // m
        xl = x[:, tp.index * Sl:(tp.index + 1) * Sl]
        buf, meta, aux = _route_and_dispatch(
            cfg, p["router"], xl.reshape(1, B * Sl, d), _capacity(cfg, B * Sl))
        ebuf = tp.all_to_all(buf[0], split_dim=0, concat_dim=1)  # (E/m, m·C, d)
        eo = tp.all_to_all(_experts(p, ebuf), split_dim=1, concat_dim=0)
        out = _combine(eo[None], meta, k)                          # (1, B·Sl, d)
        # the slices and the ranks' aux in one all_gather, in fp32 (exact
        # for bf16 rows)
        flat = torch.cat([out.reshape(-1).float(), aux.float()])
        allf = tp.mesh.all_gather(flat, "model", dim=0).reshape(m, -1)
        out = (allf[:, :-1].reshape(m, B, Sl, d).transpose(0, 1)
               .reshape(B, S, d).to(x.dtype))
        aux = allf[:, -1].mean()
    else:
        buf, meta, aux = _route_and_dispatch(
            cfg, p["router"], x.reshape(1, B * S, d), _capacity(cfg, B * S))
        e0 = tp.index * El
        eo = _experts(p, buf[0, e0:e0 + El])                       # (E/m, C, d)
        out = tp.reduce(_combine(eo[None], meta, k, e0)).reshape(B, S, d)
        aux = aux[0]
    if cfg.num_shared_experts:
        out = out + Lyr.mlp_fwd(p["shared"], x, (adapters or {}).get("shared"),
                                tp=tp)
    return out, aux


def _moe_fwd_train(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   adapters: Optional[Dict], tp, use_kernel: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_fwd` on a train mesh (``tp`` a :class:`repro_torch.
    topology.train.TrainParallel`; x the rank's rows, whole over
    ``model``; ``p`` holding the rank's experts,
    :func:`repro_torch.topology.train.train_experts`), under autograd.

    Where the reference's ``_moe_fwd_sharded`` runs (a ``model`` axis of
    m > 1 that divides S, and the experts cut over ``("data", "model")``
    or ``("model",)``), the rank routes its slab, its B rows by its S/m
    positions, at the slab's capacity, one ``exchange`` over the expert
    axes sends the slots to the experts' owners and one brings them back,
    the combine is local, the slab rejoins the residual by ``join`` (its
    gradient is whole on every rank) and aux is the slabs' mean over every
    axis (``reduce`` of aux / ranks).  Otherwise the reference's mesh-less
    math: every rank routes every token of the batch (gathered over
    ``data``) at the global capacity, runs its experts and combines their
    rows; the partial rows are summed by one ``reduce`` (over both axes
    and then the rank's rows kept by ``split``, where the experts are cut
    over both) and aux, the same on every rank, keeps 1 / ranks of its
    gradient (:func:`repro_torch.topology.train.once`).  DeepSeek-V3's
    shared expert is Megatron-split (``mlp_fwd(..., tp=)``)."""
    from repro_torch.topology.train import expert_axes, once
    B, S, d = x.shape
    k, m, ranks = cfg.experts_per_token, tp.size, tp.mesh.size
    axes = expert_axes(cfg, tp.mesh)
    xc = tp.copy(x)
    if m > 1 and S % m == 0 and axes:
        Sl = S // m
        xl = xc[:, tp.index * Sl:(tp.index + 1) * Sl]
        buf, meta, aux = _route_and_dispatch(
            cfg, p["router"], xl.reshape(1, B * Sl, d), _capacity(cfg, B * Sl))
        # each slot buffer is dropped once the next is made: at DeepSeek-V3's
        # widths one is E·C·d, gigabytes in fp32 at a capacity of every token
        buf = tp.exchange(buf[0], 0, 1, axes)                    # (E/ep, ep·C, d)
        buf = _experts(p, buf)
        buf = tp.exchange(buf, 1, 0, axes)                       # (E, C, d)
        out = tp.join(_combine(buf[None], meta, k).reshape(B, Sl, d), 1)
        aux = tp.reduce(aux[0] / ranks, ("data", "model"))
    else:
        xa = tp.gather(xc, 0, "data")
        Ba = xa.shape[0]
        buf, meta, aux = _route_and_dispatch(
            cfg, p["router"], xa.reshape(1, Ba * S, d), _capacity(cfg, Ba * S))
        El = p["w_gate"].shape[-3]
        e0 = tp.mesh.axis_index(axes) * El if axes else 0
        if axes == ("data", "model"):
            # every rank's experts differ: sum every rank's rows, keep ours
            out = _combine(_experts(p, buf[0, e0:e0 + El])[None], meta, k, e0)
            out = tp.split(tp.reduce(out.reshape(Ba, S, d), ("data", "model")),
                           0, "data")
        elif axes or tp.index == 0:
            # the data ranks hold the same experts (replicated ones run on
            # model rank 0 only): each combines its own rows
            own = slice(tp.data_index * B * S * k,
                        (tp.data_index + 1) * B * S * k)
            out = tp.reduce(_combine(_experts(p, buf[0, e0:e0 + El])[None],
                                     tuple(t[:, own] for t in meta), k, e0
                                     ).reshape(B, S, d))
        else:
            out = tp.reduce(torch.zeros_like(x))
        aux = once(aux[0], ranks)
    if cfg.num_shared_experts:
        out = out + Lyr.mlp_fwd(p["shared"], x, (adapters or {}).get("shared"),
                                use_kernel=use_kernel, tp=tp)
    return out, aux
