"""AdamW over the adapter tree (port of ``repro.optim.adamw``): schedules,
global-norm clipping, init and update.  The base model is frozen, so only
adapter leaves (A, B and the per-layer ``scale``) have optimizer state.

Adapter trees are nested dicts of tensors; leaves are visited in sorted-key
order,
the order of the reference's pytree flattening, so the clip's global norm
sums in the same order.  Updates are functional: new tensors are returned.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.common.config import OptimConfig


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a nested dict tree in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leafwise over nested dict trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def schedule(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.float()
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=s.device)
    warm = (torch.clamp((s + 1) / cfg.warmup_steps, max=1.0)
            if cfg.warmup_steps else 1.0)
    if cfg.schedule in ("cosine", "linear"):
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
        decay = (0.5 * (1 + torch.cos(math.pi * t)) if cfg.schedule == "cosine"
                 else 1.0 - t)
    else:
        decay = 1.0
    return lr * warm * decay


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def adamw_init(params: Any) -> Dict:
    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    dev = tree_leaves(params)[0].device
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(cfg: OptimConfig, grads: Any, state: Dict, params: Any
                 ) -> Tuple[Any, Dict]:
    step = state["step"] + 1
    if cfg.grad_clip:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    b1, b2 = cfg.betas
    lr = schedule(cfg, step)
    sf = step.float()
    c1, c2 = 1 - b1 ** sf, 1 - b2 ** sf

    def upd(g, m, v, p):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, grads, state["mu"], state["nu"], params)
    new_p, mu, nu = (tree_map(lambda t: t[i], out) for i in range(3))
    return new_p, {"mu": mu, "nu": nu, "step": step}
