"""Model assembly for every family of the reference: dense, MoE, MLA,
RWKV6, the Mamba2 hybrid and the vision and audio front ends (port of
``repro.models.transformer``).

Parameters keep the reference's layout: ``params["blocks"]`` is a tuple of
segments, each a dict of stacked ``(L, ...)`` leaves under the reference's
keys (a MoE layer's experts ``(L, E, d, e_ff)``), so converting a reference
tree is a copy without renames.  A Python loop over the stacked layers
replaces ``lax.scan``.

granite-moe's plan is ``[("moe", L)]``; DeepSeek-V3's is ``[("mla_dense",
k), ("mla_moe", L - k)]`` (the MoE segment empty, with zero-size ``(0,
...)`` leaves, when a config is cut to its dense layers).  ``forward``
sums the MoE layers' load-balancing losses into its aux.  MLA runs over
full sequences (``mla_fwd``) and on the cached decode path.  RWKV6
(``family="ssm"``) is one ``("rwkv", L)`` segment: ``forward`` runs the
whole sequence (the ``wkv6`` kernel with ``use_kernels``), ``decode`` steps
the recurrent state one token at a time.  Zamba2 (``family="hybrid"``)
plans runs of ``attn_every`` Mamba2 layers, each full run followed by
``("shared", 1)``: the one shared attention block, stored once and
unstacked as ``params["shared_blk"]`` (its adapters under
``adapters["shared_blk"]``, 2-D leaves), applied at each such entry.  Its
cache tuple follows the whole plan: one unstacked attention ring a shared
application and stacked Mamba2 states; ``params["blocks"]`` skips the
shared entries, so the loops keep two indices.  The vision and audio
models plan as dense: ``embed_inputs`` prepends the projected
``patch_embeds`` to the token embeddings, or takes ``frame_embeds`` in
place of tokens (``frontend_proj``, cast to the model dtype after the
product).

Public API:
    layer_plan(cfg)                                 -> [(kind, count)]
    num_shared_applications(cfg)                    -> int
    init(cfg, seed, device=None)                    -> params
    embed_inputs(cfg, params, batch)                -> (B, S, d)
    forward(cfg, params, batch, adapters, ...)      -> (hidden, aux)  [train / prefill]
    logits(cfg, params, hidden)                     -> (B, S, V)
    init_cache(cfg, batch, capacity, ..., device)   -> cache tuple
    decode(cfg, params, cache, batch, ...)          -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as Lyr
from repro_torch.models import moe as Moe
from repro_torch.models import rwkv as Rwkv
from repro_torch.models import ssm as Ssm
from repro_torch.peft.lora import PagedLoRA, matmul
from repro_torch.serve import kvcache as Kv

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """The reference's segment plan."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return [("rwkv", L)]
    if cfg.family == "hybrid":
        plan, remaining = [], L
        while remaining > 0:
            n = min(cfg.attn_every, remaining)
            plan.append(("mamba", n))
            remaining -= n
            if n == cfg.attn_every:
                plan.append(("shared", 1))
        return plan
    if cfg.num_experts:
        kind = "mla_moe" if cfg.use_mla else "moe"
        dense_kind = "mla_dense" if cfg.use_mla else "dense"
        plan = ([(dense_kind, cfg.first_dense_layers),
                 (kind, L - cfg.first_dense_layers)]
                if cfg.first_dense_layers else [(kind, L)])
    else:
        plan = [("mla_dense" if cfg.use_mla else "dense", L)]
    return plan


def num_shared_applications(cfg: ModelConfig) -> int:
    return sum(1 for k, _ in layer_plan(cfg) if k == "shared")


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator, L: int,
                dtype: torch.dtype, experts=None, keep=None) -> Params:
    """``L`` stacked layers of one kind (a dense or MLA layer's weights
    through ``keep(sub, name, leaf)`` as each is drawn)."""
    dev = gen.device
    d = cfg.d_model

    def sub(name):
        return None if keep is None else (lambda leaf, t: keep(name, leaf, t))

    def kept(name, tree):
        return tree if keep is None else {n: keep(name, n, t)
                                          for n, t in tree.items()}
    if kind == "mamba":
        return {"ln": torch.ones((L, d), dtype=dtype, device=dev),
                "mixer": kept("mixer", Ssm.init_mamba2(cfg, gen, L, dtype))}
    if kind == "rwkv":
        return {"ln1": torch.ones((L, d), dtype=dtype, device=dev),
                "ln2": torch.ones((L, d), dtype=dtype, device=dev),
                "mix": kept("mix", Rwkv.init_rwkv6(cfg, gen, L, dtype))}
    attn_init = Lyr.init_mla if kind.startswith("mla") else Lyr.init_attention
    blk = {"ln1": torch.ones((L, d), dtype=dtype, device=dev),
           "attn": attn_init(cfg, gen, L, dtype, keep=sub("attn")),
           "ln2": torch.ones((L, d), dtype=dtype, device=dev)}
    if kind.endswith("moe"):
        moe = Moe.init_moe(cfg, gen, L, dtype, experts)
        if keep is not None:
            # the shared expert's weights (and the router, replicated) as
            # the rules cut them; the expert stacks too unless ``experts``
            # already kept the rank's
            moe = {n: (t if experts is not None and n in ("w_gate", "w_up", "w_down")
                       else ({sn: keep("moe", ("shared", sn), st)
                              for sn, st in t.items()} if n == "shared"
                             else keep("moe", n, t)))
                   for n, t in moe.items()}
        blk["moe"] = moe
    else:
        blk["mlp"] = Lyr.init_mlp(cfg, gen, L, dtype, keep=sub("mlp"))
    return blk


def init(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
         experts: Optional[Tuple[int, int]] = None, keep=None) -> Params:
    """Random weights from a seeded ``torch.Generator``, with the
    reference's distributions: embedding N(0, 0.02²), projections
    N(0, 1/fan_in), norms one.  Expert stacks are drawn a few experts at a
    time on the device (:func:`repro_torch.models.moe.init_moe`);
    ``experts`` = (e0, e1) keeps only those experts (one expert-parallel
    rank's, equal to the whole model's: every rank draws the same
    stream).  A front end adds ``frontend_proj`` (frontend_dim, d); the
    hybrid its ``shared_blk``, made once and unstacked.  ``keep(path,
    leaf)`` takes each embedding, head and dense or MLA weight as soon as
    it is drawn (an RWKV6, Mamba2 or MoE block's weights as the block is
    made; expert stacks only where ``experts`` is None) and returns what
    the tree keeps of it (a train mesh rank's shard,
    :func:`repro_torch.topology.train.init_keep`): the whole model is never
    held, and each shard equals the same slice of the whole init."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, V = cfg.d_model, cfg.vocab_size
    kept = keep or (lambda path, t: t)
    params: Params = {
        "embed": kept(("embed",), torch.randn(
            (V, d), generator=gen, device=dev).mul_(0.02).to(dtype)),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = kept(("lm_head",),
                                 Lyr.dense_init(gen, (d, V), d, dtype))
    if cfg.frontend:
        fd = cfg.frontend_dim or d
        params["frontend_proj"] = kept(("frontend_proj",),
                                       Lyr.dense_init(gen, (fd, d), fd, dtype))
    kinds = [(kind, L) for kind, L in layer_plan(cfg) if kind != "shared"]
    params["blocks"] = tuple(
        _init_block(cfg, kind, gen, L, dtype, experts, _block_keep(keep, ("blocks", i)))
        for i, (kind, L) in enumerate(kinds))
    if cfg.family == "hybrid":
        params["shared_blk"] = _layer(_init_block(
            cfg, "shared", gen, 1, dtype, keep=_block_keep(keep, ("shared_blk",))), 0)
    return params


def _block_keep(keep, prefix: Tuple):
    """``keep(sub, name, leaf)`` of one block under the tree path
    ``prefix`` (``name`` a key, or a tuple of keys under a sub-tree)."""
    if keep is None:
        return None

    def block_keep(sub, name, t):
        tail = name if isinstance(name, tuple) else (name,)
        return keep(prefix + (sub,) + tail, t)
    return block_keep


def _vocab_cut(cfg: ModelConfig, rows: int, tp) -> bool:
    """Whether a table of ``rows`` vocab rows (or columns) is the rank's
    ``model`` slice (the rules cut it where the axis divides V)."""
    return tp is not None and tp.size > 1 and rows * tp.size == cfg.vocab_size


def embed_inputs(cfg: ModelConfig, params: Params, batch: Dict,
                 tp=None) -> torch.Tensor:
    """(B, S, d) inputs: the projected ``patch_embeds`` (vision) before the
    token embeddings, or the projected ``frame_embeds`` (audio) in place of
    tokens, each cast to the model dtype after the product.  Under a train
    mesh ``tp`` whose ``model`` axis cut the embedding's vocab rows, the
    lookup is vocab-parallel: each rank looks up the tokens in its rows,
    zeroes the others and one ``all_reduce`` sums (exact: one rank holds
    each row).  The front end's ``frontend_proj`` is column-parallel there
    (the rules' ``(None, model)``): each rank projects onto its columns
    and one ``all_gather`` makes the product whole before the cast (no
    gradient flows past the frozen projection of the data)."""
    dtype = torch_dtype(cfg.dtype)
    parts = []
    key = {"vision": "patch_embeds", "audio": "frame_embeds"}.get(cfg.frontend)
    if key in batch:
        y = matmul(batch[key], params["frontend_proj"])
        if tp is not None and y.shape[-1] != cfg.d_model:
            y = tp.all_gather(y, "model", y.dim() - 1)
        parts.append(y.to(dtype))
    if "tokens" in batch:
        emb, toks = params["embed"], batch["tokens"]
        n = emb.shape[0]
        if _vocab_cut(cfg, n, tp):
            t = toks.long() - tp.index * n
            mine = (t >= 0) & (t < n)
            rows = emb[t.clamp(0, n - 1)] * mine[..., None].to(emb.dtype)
            parts.append(tp.reduce(rows))
        else:
            parts.append(emb[toks])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def logits(cfg: ModelConfig, params: Params, hidden: torch.Tensor,
           tp=None) -> torch.Tensor:
    """(B, S, V) logits; under a train mesh ``tp`` whose ``model`` axis cut
    the head's vocab the rank's columns are gathered (no gradient: the
    prefill's whole logits on every rank)."""
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    out = hidden @ head
    if _vocab_cut(cfg, head.shape[1], tp):
        out = tp.all_gather(out, "model", out.dim() - 1)
    return out


def check_train_mesh(cfg: ModelConfig, mesh) -> None:
    """Raise ``ValueError`` unless the ``model`` axis of a train mesh
    divides every width that the layers of ``cfg`` take by the rank's
    share with no fallback: RWKV6's and Mamba2's heads (the rank's heads
    of a recurrence) and the ``d_ff`` of a column- then row-parallel pair
    (a dense MLP, the hybrid's shared block, RWKV6's channel mix,
    DeepSeek-V3's shared expert), which a rule left whole would have
    summed once a rank.  Attention that the axis does not divide falls
    back as the reference's ``dispatch_flash`` does, MoE layers route as
    the reference's mesh-less ``moe_fwd`` where ``_moe_fwd_sharded`` would
    not run, and an output the rules leave whole (RWKV6's ``dd_w1`` /
    ``wd1``) is not gathered."""
    n = 1 if mesh is None else mesh.axis_size("model")
    if n == 1:
        return
    kinds = {k for k, c in layer_plan(cfg) if c}
    widths = {}
    if kinds & {"dense", "mla_dense", "shared"}:
        widths["d_ff"] = cfg.d_ff
    if kinds & {"moe", "mla_moe"} and cfg.num_shared_experts:
        widths["moe_d_ff · num_shared_experts"] = (
            (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts)
    if "rwkv" in kinds:
        widths.update({"RWKV heads (d_model / rwkv_head_dim)":
                       cfg.num_rwkv_heads, "d_ff": cfg.d_ff})
    if "mamba" in kinds:
        widths["SSM heads (d_inner / ssm_head_dim)"] = cfg.num_ssm_heads
    bad = {k: v for k, v in widths.items() if v % n}
    if bad:
        raise ValueError(f"{cfg.name}: a model axis of {n} ranks does not "
                         f"divide {bad}, which training on the mesh cuts "
                         "by the rank's share")


def _block_fwd(cfg: ModelConfig, kind: str, p: Params, x, a: Dict,
               use_kernels: bool, groups: int = 0, tp=None):
    """One layer over a full sequence.  Returns (x, aux): a MoE layer's
    load-balancing loss (per cohort client, (groups,), when ``groups``),
    else None.  ``tp``: a train mesh (every kind of layer)."""
    a = a or {}
    if kind == "mamba":
        h = Ssm.mamba2_fwd(cfg, p["mixer"], Lyr.rmsnorm(x, p["ln"], cfg.norm_eps),
                           a.get("mixer"), use_kernel=use_kernels, tp=tp)
        return x + h, None
    if kind == "rwkv":
        h, _ = Rwkv.time_mix(cfg, p["mix"], Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps),
                             a.get("mix"), use_kernel=use_kernels, tp=tp)
        x = x + h
        h, _ = Rwkv.channel_mix(cfg, p["mix"],
                                Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps),
                                a.get("mix"), use_kernel=use_kernels, tp=tp)
        return x + h, None
    attn_fn = Lyr.mla_fwd if kind.startswith("mla") else Lyr.attention_fwd
    h = attn_fn(cfg, p["attn"], Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps),
                a.get("attn"), use_kernel=use_kernels, tp=tp)
    x = x + h
    xn = Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if kind.endswith("moe"):
        h, aux = Moe.moe_fwd(cfg, p["moe"], xn, a.get("moe"), groups=groups,
                             use_kernel=use_kernels, tp=tp)
        return x + h, aux
    h = Lyr.mlp_fwd(p["mlp"], xn, a.get("mlp"), use_kernel=use_kernels, tp=tp)
    return x + h, None


def forward(cfg: ModelConfig, params: Params, batch: Dict,
            adapters: Optional[Dict] = None, use_kernels: bool = False,
            cohort: int = 0, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over ``batch["tokens"]: (B, S)`` (and a front
    end's ``patch_embeds`` or ``frame_embeds``).  Returns
    (final hidden (B,S,d), aux loss): the sum of the MoE layers'
    load-balancing losses, zero for the other families.  ``use_kernels``
    routes GQA attention, the WKV recurrence and the LoRA projections
    through the ``flash_attention``, ``wkv6`` and ``lora_matmul`` kernels
    (MLA's attention is plain on both of its routes, as in the reference).
    ``cohort`` = C > 0: ``adapters`` is a stack of C clients' trees (a
    leading client axis on every leaf, the layer axis second) and the batch
    holds the clients' rows in order, B = C·B_c; everything shared runs once at
    batch B, except that a MoE layer routes each client's rows on their
    own with one client's capacity (the reference ``vmap``s one client's
    step), and aux is per client, shape (C,).  The hybrid's shared block
    takes ``adapters["shared_blk"]`` as they are: 2-D leaves, or (C, r, d)
    client stacks in a cohort (no layer axis to index).  The reference's
    ``remat`` has no counterpart: autograd keeps the activations (a Mamba2
    layer's intra-chunk tensors excepted, :mod:`repro_torch.models.ssm`).
    ``tp`` (a train mesh, :class:`repro_torch.topology.train.
    TrainParallel`; ``params`` the rank's shards by ``train_pspecs``) runs
    every segment tensor-parallel after a vocab-parallel embedding and a
    column-parallel front end: dense, MLA and the hybrid's shared block
    (:mod:`repro_torch.models.layers`), RWKV6 and Mamba2 on the rank's
    heads (:mod:`repro_torch.models.rwkv`, :mod:`repro_torch.models.ssm`)
    and MoE expert parallel (:mod:`repro_torch.models.moe`); the hidden
    states come back whole on every rank, and aux is the MoE layers' sum
    on every rank."""
    if tp is not None:
        check_train_mesh(cfg, tp.mesh)
    x = embed_inputs(cfg, params, batch, tp)
    a_blocks = (adapters or {}).get("blocks", ())
    aux = torch.zeros((cohort,) if cohort else (), dtype=torch.float32,
                      device=x.device)
    seg_i = 0
    for kind, count in layer_plan(cfg):
        if kind == "shared":
            sa = (adapters or {}).get("shared_blk") or {}
            x, _ = _block_fwd(cfg, kind, params["shared_blk"], x, sa,
                              use_kernels, cohort, tp)
            continue
        seg_p = params["blocks"][seg_i]
        seg_a = a_blocks[seg_i] if seg_i < len(a_blocks) and a_blocks[seg_i] else {}
        for i in range(count):
            x, aux_l = _block_fwd(cfg, kind, _layer(seg_p, i), x,
                                  _layer(seg_a, i, 1 if cohort else 0),
                                  use_kernels, cohort, tp)
            if aux_l is not None:
                aux = aux + aux_l
        seg_i += 1
    x = Lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               kv_dtype: Optional[torch.dtype] = None, prefill_chunk: int = 1,
               device: DeviceLike = None) -> Tuple:
    """Cache tuple mirroring the segment plan: per segment a dict of
    stacked rings (``(L, B, cap, K, hd)`` k/v, or MLA's ``(L, B, cap, kvr)``
    latent and ``(L, B, cap, rope)`` key) and ``(L, B)`` positions, or
    RWKV6's stacked recurrent state (``(L, B, d)`` ``tm_x``/``cm_x`` and
    ``(L, B, H, hd, hd)`` ``wkv``, fp32; no capacity), or Mamba2's (``(L,
    B, K-1, d_inner + 2·st)`` ``conv`` and ``(L, B, H, st, hd)`` ``ssm``,
    fp32); a shared entry of the hybrid's plan holds one unstacked ring
    (``(B, cap, K, hd)`` k/v, ``(B,)`` positions).  Sliding windows keep
    ``prefill_chunk - 1`` spare slots, as in the reference."""
    dev = resolve_device(device)
    kv_dtype = kv_dtype or torch_dtype(cfg.dtype)
    if cfg.sliding_window:
        capacity = min(capacity, cfg.sliding_window + max(prefill_chunk, 1) - 1)
    caches = []
    for kind, L in layer_plan(cfg):
        if kind == "shared":
            caches.append(Kv.attn_cache(cfg, batch, capacity, kv_dtype, dev))
            continue
        if kind == "rwkv":
            one = Rwkv.rwkv6_init_state(cfg, batch, dev)
        elif kind == "mamba":
            one = Ssm.mamba2_init_state(cfg, batch, dev)
        else:
            make = Kv.mla_cache if kind.startswith("mla") else Kv.attn_cache
            one = make(cfg, batch, capacity, kv_dtype, dev)
        caches.append({k: torch.zeros((L,) + v.shape, dtype=v.dtype, device=dev)
                       for k, v in one.items()})
    return tuple(caches)


def _layer(tree: Any, i: int, axis: int = 0) -> Any:
    """Layer ``i`` of a stacked parameter or adapter tree, its layer axis
    ``axis`` (1 for a cohort's client-stacked adapters)."""
    if isinstance(tree, PagedLoRA):
        return tree.layer(i)
    if isinstance(tree, dict):
        return {k: _layer(v, i, axis) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dim() > axis:
        return tree.select(axis, i)
    return tree


def _mask_state_rows(new: Dict, old: Dict, n_tokens) -> Dict:
    """Keep the old recurrent state for rows with ``n_tokens == 0`` (the
    n_tokens contract: masked rows leave their cache untouched)."""
    if n_tokens is None:
        return new
    keep = n_tokens > 0
    return {k: torch.where(keep.view((-1,) + (1,) * (t.dim() - 1)),
                           t.to(old[k].dtype), old[k])
            for k, t in new.items()}


def _block_decode(cfg: ModelConfig, kind: str, p: Params, x, cache, a: Dict,
                  n_tokens=None, decode_impl: str = "dense", tp=None):
    """One layer of any kind, one token chunk.  An RWKV6 or Mamba2 layer
    takes one token (C = 1) and writes its new state into the cache's
    buffers in place (rows with ``n_tokens`` 0 keep theirs).  A MoE layer routes the chunk's B·C tokens
    at once, as the reference's decode does (rows with ``n_tokens`` 0
    take capacity too); under ``tp`` it runs expert parallel
    (:func:`repro_torch.models.moe.moe_fwd`)."""
    a = a or {}
    if kind == "mamba":
        if x.shape[1] != 1:
            raise ValueError("SSM decode is a single-token recurrence: "
                             f"got a chunk of {x.shape[1]} tokens")
        h, new = Ssm.mamba2_decode(cfg, p["mixer"],
                                   Lyr.rmsnorm(x, p["ln"], cfg.norm_eps),
                                   cache, a.get("mixer"), tp=tp)
        for k, t in _mask_state_rows(new, cache, n_tokens).items():
            cache[k].copy_(t)
        return x + h, cache
    if kind == "rwkv":
        if x.shape[1] != 1:
            raise ValueError("RWKV decode is a single-token recurrence: "
                             f"got a chunk of {x.shape[1]} tokens")
        h, st = Rwkv.time_mix(cfg, p["mix"], Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps),
                              a.get("mix"), state=cache, tp=tp)
        x = x + h
        h, st2 = Rwkv.channel_mix(cfg, p["mix"],
                                  Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps),
                                  a.get("mix"), state=cache, tp=tp)
        for k, t in _mask_state_rows({**st, **st2}, cache, n_tokens).items():
            cache[k].copy_(t)
        return x + h, cache
    dec_fn = Lyr.mla_decode if kind.startswith("mla") else Lyr.attention_decode
    h, cache = dec_fn(cfg, p["attn"], Lyr.rmsnorm(x, p["ln1"], cfg.norm_eps),
                      cache, a.get("attn"), n_tokens=n_tokens,
                      decode_impl=decode_impl, tp=tp)
    x = x + h
    xn = Lyr.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if kind.endswith("moe"):
        h, _ = Moe.moe_fwd(cfg, p["moe"], xn, a.get("moe"), tp=tp)
    else:
        h = Lyr.mlp_fwd(p["mlp"], xn, a.get("mlp"), tp=tp)
    return x + h, cache


def decode(cfg: ModelConfig, params: Params, cache: Tuple, batch: Dict,
           adapters: Optional[Dict] = None,
           n_tokens: Optional[torch.Tensor] = None,
           decode_impl: str = "dense", tp=None) -> Tuple[torch.Tensor, Tuple]:
    """One decode step over a token chunk ``batch["tokens"]: (B, C)``.

    ``n_tokens: (B,)`` gives the real tokens per row (None = all C; rows
    with 0 leave their cache untouched).  ``decode_impl`` picks the
    attention interior (``"dense"``, ``"streamed"`` or ``"kernel"``; the
    RWKV6 recurrence is the same on all three).  The ring buffers and recurrent states are
    written in place; the returned cache holds the same buffers and the
    advanced positions.  RWKV6 and the hybrid take C = 1.  The cache tuple
    follows the whole plan (``ci``), the hybrid's shared entries included;
    ``params["blocks"]`` skips them (``seg_i``).  ``tp`` (a serve mesh's
    ``model`` axis, :class:`repro_torch.topology.serve.ModelParallel`) runs
    every layer on the rank's shards: attention (GQA, MLA, the hybrid's
    shared block) head-parallel with ``cfg`` holding the rank's attention
    head counts (:mod:`repro_torch.models.layers`), RWKV6 and Mamba2 on
    the rank's heads (:mod:`repro_torch.models.rwkv`,
    :mod:`repro_torch.models.ssm`) and MoE expert parallel
    (:mod:`repro_torch.models.moe`).  Returns (logits (B,C,V), cache)."""
    x = embed_inputs(cfg, params, batch)
    a_blocks = (adapters or {}).get("blocks", ())
    new_caches = []
    seg_i = -1
    for ci, (kind, count) in enumerate(layer_plan(cfg)):
        seg_c = cache[ci]
        if kind == "shared":
            sa = (adapters or {}).get("shared_blk") or {}
            x, c = _block_decode(cfg, kind, params["shared_blk"], x, seg_c, sa,
                                 n_tokens, decode_impl, tp)
            new_caches.append(c)
            continue
        seg_i += 1
        if not count:                     # an empty MoE segment
            new_caches.append(seg_c)
            continue
        seg_p = params["blocks"][seg_i]
        seg_a = a_blocks[seg_i] if seg_i < len(a_blocks) and a_blocks[seg_i] else {}
        pos, length = [], []
        for i in range(count):
            c_l = {k: v[i] for k, v in seg_c.items()}
            x, c_l = _block_decode(cfg, kind, _layer(seg_p, i), x, c_l,
                                   _layer(seg_a, i), n_tokens, decode_impl,
                                   tp)
            if "pos" in c_l:
                pos.append(c_l["pos"])
                length.append(c_l["length"])
        new_caches.append(dict(seg_c, pos=torch.stack(pos),
                               length=torch.stack(length)) if pos else seg_c)
    x = Lyr.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits(cfg, params, x), tuple(new_caches)
