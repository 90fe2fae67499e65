"""Train and eval steps (port of ``repro.train.step``).

``make_train_step`` builds the LoRA fine-tuning step: gradients flow
through the frozen base into the adapter tree only (A, B and the per-layer
``scale``, as the reference's ``value_and_grad`` over the whole tree does),
and AdamW updates those leaves.  ``use_kernels`` runs attention and the
LoRA projections through the ``flash_attention`` and ``lora_matmul``
kernels in both steps; a MoE config's loss adds ``router_aux_coef · aux``.
The train, eval and prefill steps take a front end's batches as
``forward`` does (``patch_embeds`` before ``tokens``, or ``frame_embeds``
and ``labels``); the cohort step stays tokens-only, as the reference's
cohort runner stacks only ``tokens`` and ``loss_mask``.
``make_prefill_step`` is the full-sequence forward that serves a prompt's
next-token logits (RWKV6's recurrence through the ``wkv6`` kernel with
``use_kernels``; MoE and MLA models alike); ``make_serve_step`` the chunked
decode step against a ring cache that serves a batch's next-token logits.

The train, eval and prefill steps take ``mesh=``, a train mesh ``(data,
model)`` (``topology.make_host_mesh(model=)``), where the reference runs
``launch/dryrun.py``'s builds under ``jit``: each rank is given its
shards of the params and its rows of the batch
(:func:`repro_torch.topology.train.shard_params` / ``shard_batch``) and
the whole, replicated adapters and optimizer state.  Every family runs
tensor-parallel over ``model`` (:func:`repro_torch.models.transformer.
forward`): dense GQA, MLA and the hybrid's shared block Megatron-style,
RWKV6 and Mamba2 on the rank's heads, MoE layers expert parallel (over
``("data", "model")`` where the rules cut the experts over both), the
front ends' projection column-parallel; ZeRO-3 above the rules'
threshold; the loss is the global masked mean plus, for MoE, its aux as
the reference's ``_moe_fwd_sharded`` makes it.  Each rank's adapter
gradient is its part of the whole; the parts are summed over ``model``
and ``data`` in one packed ``all_reduce`` after the last microbatch, and
``b_only``, the clip and AdamW then act on the whole gradients, so the
adapters stay equal on every rank.  A width the ``model`` axis must
divide and does not raises ``ValueError``
(:func:`repro_torch.models.transformer.check_train_mesh`).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.config import ModelConfig, OptimConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_update, tree_leaves, tree_map
from repro_torch.topology.train import train_parallel
from repro_torch.train.loss import chunked_ce


def _mesh_parallel(cfg: ModelConfig, mesh):
    """The train mesh as the layers use it, or None without one."""
    if mesh is None:
        return None
    T.check_train_mesh(cfg, mesh)
    return train_parallel(cfg, mesh)


def loss_fn(cfg: ModelConfig, params, adapters, batch: Dict,
            loss_chunk: int = 512, use_kernels: bool = False, tp=None):
    """(loss, metrics) of one batch ``{"tokens", "loss_mask"}``: the masked
    CE plus ``router_aux_coef · aux`` when the config sets the coefficient
    (the MoE layers' load-balancing loss), as in the reference;
    ``metrics["loss"]`` is the CE alone and ``metrics["aux"]`` the aux.
    The CE's targets are ``labels`` where the batch has them (an audio
    batch: ``frame_embeds``, ``labels``, ``loss_mask``), else ``tokens``; a
    vision batch's P ``patch_embeds`` positions are dropped from the hidden
    states before the CE, so the loss is over the text tail only.
    The reference's ``remat`` has no counterpart: autograd keeps the
    activations.  ``tp``: a train mesh (the module docstring)."""
    hidden, aux = T.forward(cfg, params, batch, adapters,
                            use_kernels=use_kernels, tp=tp)
    tokens = batch.get("labels", batch.get("tokens"))
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        hidden = hidden[:, batch["patch_embeds"].shape[1]:]
    loss, metrics = chunked_ce(cfg, params, hidden, tokens, mask, loss_chunk,
                               tp=tp)
    if cfg.router_aux_coef:
        loss = loss + cfg.router_aux_coef * aux
    metrics["aux"] = aux
    return loss, metrics


def _mask_a_grads(grads: Dict) -> Dict:
    """Zero the gradients of A leaves (FFA-LoRA trains B only)."""
    if isinstance(grads, dict):
        return {k: (torch.zeros_like(v) if k == "A" and not isinstance(v, dict)
                    else _mask_a_grads(v)) for k, v in grads.items()}
    return grads


def _unflatten(tree: Dict, leaves):
    """``tree``'s structure with its sorted-order leaves replaced."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


def make_train_step(cfg: ModelConfig, optim: OptimConfig,
                    loss_chunk: int = 512, use_kernels: bool = False,
                    b_only: bool = False, grad_accum: int = 1, mesh=None):
    """Returns ``train_step(params, adapters, opt_state, batch) ->
    (adapters, opt_state, metrics)``.

    ``b_only`` freezes A (FFA-LoRA).  ``grad_accum`` splits the batch into
    that many microbatches along axis 0, sums their fp32 gradients and
    divides by the count; metrics are the microbatch mean.  ``mesh``: a
    train mesh (the module docstring); ``params`` and ``batch`` are then
    the rank's shards and rows (``shard_batch(..., grad_accum)`` keeps
    each microbatch's rows together), and the step's ``tp`` (its
    collective counts) is ``train_step.tp``.  ``train_step.grads(params,
    adapters, batch)`` returns (metrics, the whole gradient tree) without
    the update.
    """
    tp = _mesh_parallel(cfg, mesh)

    def grads_of(params, adapters, batch):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(adapters)]
        a = _unflatten(adapters, leaves)
        loss, metrics = loss_fn(cfg, params, a, batch, loss_chunk, use_kernels,
                                tp)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(t) if g is None else g
              for g, t in zip(gs, leaves)]
        return {k: v.detach() for k, v in metrics.items()}, gs

    def whole_grads(params, adapters, batch):
        """(metrics, the step's whole gradient tree): summed over the
        microbatches and the mesh, divided by ``grad_accum``."""
        if grad_accum == 1:
            metrics, grads = grads_of(params, adapters, batch)
        else:
            n = next(iter(batch.values())).shape[0] // grad_accum
            grads, ms = None, []
            for i in range(grad_accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                m, g = grads_of(params, adapters, mb)
                ms.append(m)
                if grads is None:
                    grads = [torch.zeros(t.shape, dtype=torch.float32,
                                         device=t.device) for t in g]
                grads = [x + y.float() for x, y in zip(grads, g)]
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}
        if tp is not None:
            grads = tp.sum_grads(grads)
        if grad_accum != 1:
            grads = [g / grad_accum for g in grads]
        return metrics, _unflatten(adapters, grads)

    def train_step(params, adapters, opt_state, batch):
        metrics, grads = whole_grads(params, adapters, batch)
        if b_only:
            grads = _mask_a_grads(grads)
        adapters, opt_state = adamw_update(optim, grads, opt_state, adapters)
        return adapters, opt_state, metrics

    train_step.tp = tp
    train_step.grads = whole_grads
    return train_step


def make_cohort_train_step(cfg: ModelConfig, optim: OptimConfig,
                           loss_chunk: int = 512, use_kernels: bool = False,
                           b_only: bool = False):
    """Returns ``cohort_step(params, stacked, opt_state, batch) ->
    (stacked, opt_state, metrics)``: one local step of C clients at once
    (the reference's ``jax.vmap`` of the train step over clients).

    ``stacked`` has a leading client axis on every adapter leaf (and
    ``opt_state``'s moments on theirs); ``batch`` holds ``"tokens"`` and
    ``"loss_mask"`` of shape (C, B, S).  The forward runs once at batch C·B
    with each projection's cohort in one ``lora_matmul`` launch.  The loss
    is the sum over clients of each client's masked mean, so each client's
    gradient is its own (a zero-mask padding replica gets zero CE and
    trains only its own, undelivered, copy); the global-norm clip is per
    client, and AdamW's moments are per client.  A MoE layer routes each
    client's rows on their own (one client's capacity), and each client's
    loss adds its own ``router_aux_coef · aux``; a ragged client's
    zero-masked padding rows take expert capacity and enter its aux, as in
    the reference's vmapped step.  Metrics are per client, shape (C,), ``"aux"`` included."""

    def cohort_step(params, adapters, opt_state, batch):
        C = batch["tokens"].shape[0]
        tokens = batch["tokens"].reshape(-1, batch["tokens"].shape[-1])
        mask = batch["loss_mask"].reshape(tokens.shape)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(adapters)]
        a = _unflatten(adapters, leaves)
        hidden, aux = T.forward(cfg, params, {"tokens": tokens}, a,
                                use_kernels=use_kernels, cohort=C)
        loss, metrics = chunked_ce(cfg, params, hidden, tokens, mask,
                                   loss_chunk, clients=C)
        if cfg.router_aux_coef:
            loss = loss + cfg.router_aux_coef * aux
        metrics["aux"] = aux
        gs = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
        grads = _unflatten(adapters, [torch.zeros_like(t) if g is None else g
                                      for g, t in zip(gs, leaves)])
        if b_only:
            grads = _mask_a_grads(grads)
        adapters, opt_state = adamw_update(optim, grads, opt_state, adapters,
                                           per_client=True)
        return adapters, opt_state, {k: v.detach() for k, v in metrics.items()}

    return cohort_step


def make_eval_step(cfg: ModelConfig, loss_chunk: int = 512,
                   use_kernels: bool = False, mesh=None):
    """Returns ``eval_step(params, adapters, batch) -> metrics`` (no
    gradients; ``mesh`` as :func:`make_train_step`'s, the metrics those of
    the whole batch on every rank)."""
    tp = _mesh_parallel(cfg, mesh)

    def eval_step(params, adapters, batch):
        with torch.no_grad():
            _, metrics = loss_fn(cfg, params, adapters, batch, loss_chunk,
                                 use_kernels, tp)
        return metrics
    eval_step.tp = tp
    return eval_step


def make_prefill_step(cfg: ModelConfig, use_kernels: bool = False, mesh=None):
    """Returns ``prefill_step(params, adapters, batch) -> (B, V)``: the
    full-sequence forward over ``batch`` (``tokens`` (B, S), and a front
    end's embeddings) and the logits of the last position, without
    gradients.  Under a train mesh ``mesh`` the rank's rows go through the
    sharded forward and the whole (B, V) logits come back on every rank
    (the vocab-sharded logits gathered over ``model``, the rows over
    ``data``)."""
    tp = _mesh_parallel(cfg, mesh)

    def prefill_step(params, adapters, batch):
        with torch.no_grad():
            hidden, _ = T.forward(cfg, params, batch, adapters,
                                  use_kernels=use_kernels, tp=tp)
            out = T.logits(cfg, params, hidden[:, -1:], tp)[:, 0]
            return out if tp is None else tp.all_gather(out, "data", 0)
    prefill_step.tp = tp
    return prefill_step


def make_serve_step(cfg: ModelConfig, decode_impl: str = "dense",
                    lora_impl: str = "plain"):
    """Chunked decode against a per-slot cache: ``serve_step(params,
    adapters, cache, batch) -> (next-token logits (B, V), cache)``.

    ``batch``: ``{"tokens": (B, C)}`` and optionally ``"n_tokens": (B,)``
    (real tokens per row) and, with a registry's device state as
    ``adapters``, ``"adapter_ids": (B,)`` (default the base id 0).  Returns
    the logits at each row's last real token.  ``decode_impl`` picks the
    attention interior (dense | streamed | kernel)."""
    from repro_torch.serve.adapters import attach, is_device_state

    def serve_step(params, adapters, cache, batch):
        with torch.no_grad():
            toks = batch["tokens"]
            if is_device_state(adapters):
                ids = batch.get("adapter_ids")
                if ids is None:
                    ids = torch.zeros(toks.shape[0], dtype=torch.int32,
                                      device=toks.device)
                adapters = attach(adapters, ids, impl=lora_impl)
            n = batch.get("n_tokens")
            lg, cache = T.decode(cfg, params, cache, {"tokens": toks}, adapters,
                                 n_tokens=n, decode_impl=decode_impl)
            if n is None:
                return lg[:, -1], cache
            idx = (n.long() - 1).clamp(0, lg.shape[1] - 1)
            return lg.gather(1, idx[:, None, None].expand(-1, 1, lg.shape[-1]))[:, 0], cache
    return serve_step
