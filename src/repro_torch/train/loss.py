"""Losses (port of ``repro.train.loss``).  Chunked cross-entropy: logits
are formed one sequence chunk at a time, so a step holds (B, chunk, vocab)
logits per chunk rather than a single (B, S, vocab) block.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.common.config import ModelConfig


def _ce_chunk(head: torch.Tensor, hidden, targets, mask):
    """hidden: (B,c,d), targets: (B,c), mask: (B,c).  Returns
    (sum_loss, sum_cnt, sum_correct)."""
    logits = (hidden @ head).float()                        # (B,c,V)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (lse - tgt) * mask
    correct = (logits.argmax(dim=-1) == targets).float() * mask
    return nll.sum(), mask.sum(), correct.sum()


def chunked_ce(cfg: ModelConfig, params, hidden: torch.Tensor,
               tokens: torch.Tensor, loss_mask: torch.Tensor,
               chunk: int = 512) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE over ``tokens``, masked by ``loss_mask`` on *target*
    positions; hidden (B,S,d) is aligned with tokens (B,S).  Full chunks of
    ``chunk`` positions, then the remainder chunk; sums accumulate in the
    reference's order."""
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    h = hidden[:, :-1]
    tgt = tokens[:, 1:].long()
    msk = loss_mask[:, 1:].float()
    Sm = h.shape[1]
    c = min(chunk, Sm)
    nc = Sm // c
    s = n = acc = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        s_i, n_i, a_i = _ce_chunk(head, h[:, sl], tgt[:, sl], msk[:, sl])
        s, n, acc = s + s_i, n + n_i, acc + a_i
    if Sm - nc * c:
        sl = slice(nc * c, Sm)
        s_i, n_i, a_i = _ce_chunk(head, h[:, sl], tgt[:, sl], msk[:, sl])
        s, n, acc = s + s_i, n + n_i, acc + a_i
    n = torch.clamp(n, min=1.0)
    return s / n, {"loss": s / n, "tokens": n, "accuracy": acc / n}
