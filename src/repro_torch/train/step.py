"""Train and eval steps (port of ``repro.train.step``).

``make_train_step`` builds the LoRA fine-tuning step: gradients flow
through the frozen base into the adapter tree only (A, B and the per-layer
``scale``, as the reference's ``value_and_grad`` over the whole tree does),
and AdamW updates those leaves.  ``use_kernels`` runs attention and the
LoRA projections through the ``flash_attention`` and ``lora_matmul``
kernels in both steps.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.config import ModelConfig, OptimConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_update, tree_leaves, tree_map
from repro_torch.train.loss import chunked_ce


def loss_fn(cfg: ModelConfig, params, adapters, batch: Dict,
            loss_chunk: int = 512, use_kernels: bool = False):
    """(loss, metrics) of one batch ``{"tokens", "loss_mask"}``.  The
    reference's ``remat`` has no counterpart: autograd keeps the
    activations."""
    hidden, aux = T.forward(cfg, params, batch, adapters,
                            use_kernels=use_kernels)
    tokens = batch.get("labels", batch.get("tokens"))
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    loss, metrics = chunked_ce(cfg, params, hidden, tokens, mask, loss_chunk)
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
                    b_only: bool = False, grad_accum: int = 1):
    """Returns ``train_step(params, adapters, opt_state, batch) ->
    (adapters, opt_state, metrics)``.

    ``b_only`` freezes A (FFA-LoRA).  ``grad_accum`` splits the batch into
    that many microbatches along axis 0, sums their fp32 gradients and
    divides by the count; metrics are the microbatch mean.
    """

    def grads_of(params, adapters, batch):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(adapters)]
        a = _unflatten(adapters, leaves)
        loss, metrics = loss_fn(cfg, params, a, batch, loss_chunk, use_kernels)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(t) if g is None else g
              for g, t in zip(gs, leaves)]
        return ({k: v.detach() for k, v in metrics.items()},
                _unflatten(adapters, gs))

    def train_step(params, adapters, opt_state, batch):
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
                    grads = tree_map(lambda t: torch.zeros(
                        t.shape, dtype=torch.float32, device=t.device), g)
                grads = tree_map(lambda x, y: x + y.float(), grads, g)
            grads = tree_map(lambda t: t / grad_accum, grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}
        if b_only:
            grads = _mask_a_grads(grads)
        adapters, opt_state = adamw_update(optim, grads, opt_state, adapters)
        return adapters, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, loss_chunk: int = 512,
                   use_kernels: bool = False):
    """Returns ``eval_step(params, adapters, batch) -> metrics`` (no
    gradients)."""
    def eval_step(params, adapters, batch):
        with torch.no_grad():
            _, metrics = loss_fn(cfg, params, adapters, batch, loss_chunk,
                                 use_kernels)
        return metrics
    return eval_step
