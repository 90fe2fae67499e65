"""Losses (port of ``repro.train.loss``).  Chunked cross-entropy: logits
are formed one sequence chunk at a time, so a step holds (B, chunk, vocab)
logits per chunk rather than a single (B, S, vocab) block.

Under a train mesh (``tp``, :class:`repro_torch.topology.train.
TrainParallel`) the head's vocab columns are the rank's where the rules
cut them, and the CE is vocab-parallel as GSPMD makes the reference's:
each chunk's local logits give the rank's max and argmax, gathered in one
``all_gather`` (the global max and the accuracy's argmax, the lowest index
among equal maxima, as ``argmax`` takes), and the rank's sum of
exponentials beside the target's logit from the rank that owns it, summed
in one ``all_reduce``.  The masked sums and counts of the rank's rows are
summed over ``data`` before the division: the loss is the global masked
mean.  A vision batch's text tail and an audio batch's ``labels`` (no
tokens) take the same path (:func:`repro_torch.train.step.loss_fn` cuts
the tail before the CE); a MoE model's aux, already the same on every
rank, is added after it with its coefficient, as mesh-less.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.common.config import ModelConfig


def _ce_chunk(head: torch.Tensor, hidden, targets, mask, lead: int = 0):
    """hidden: (..., B,c,d), targets: (..., B,c), mask: (..., B,c).  Returns
    (sum_loss, sum_cnt, sum_correct), summed over all but the first
    ``lead`` axes."""
    logits = (hidden @ head).float()                        # (...,B,c,V)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (lse - tgt) * mask
    correct = (logits.argmax(dim=-1) == targets).float() * mask
    return tuple(t.flatten(1).sum(1) if lead else t.sum()
                 for t in (nll, mask, correct))


def _ce_chunk_vocab(head: torch.Tensor, hidden, targets, mask, tp):
    """:func:`_ce_chunk` on the rank's vocab columns ``head`` (d, V/M)."""
    logits = (hidden @ head).float()                        # (B,c,V/M)
    n = head.shape[1]
    off = tp.index * n
    mx, arg = logits.detach().max(dim=-1)
    both = tp.all_gather(torch.stack([mx, (arg + off).float()])[None], "model",
                         0)                                 # (M, 2, B, c)
    best = both[:, 0].argmax(dim=0, keepdim=True)
    m = both[:, 0].gather(0, best)[0]
    pred = both[:, 1].gather(0, best)[0].long()
    t = targets - off
    mine = (t >= 0) & (t < n)
    tgt = torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])[..., 0]
    sums = tp.reduce(torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                                  tgt * mine]))
    nll = (torch.log(sums[0]) + m - sums[1]) * mask
    correct = (pred == targets).float() * mask
    return nll.sum(), mask.sum(), correct.sum()


def chunked_ce(cfg: ModelConfig, params, hidden: torch.Tensor,
               tokens: torch.Tensor, loss_mask: torch.Tensor,
               chunk: int = 512, clients: int = 0,
               tp=None) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE over ``tokens``, masked by ``loss_mask`` on *target*
    positions; hidden (B,S,d) is aligned with tokens (B,S).  Full chunks of
    ``chunk`` positions, then the remainder chunk; sums accumulate in the
    reference's order.  With ``clients`` = C > 0 the batch is C clients'
    rows in order and every returned value is per client, shape (C,): each
    client's own masked mean (a client with no unmasked token gets 0).
    ``tp``: a train mesh (see the module docstring; no client axis)."""
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    vocab_cut = (tp is not None and tp.size > 1
                 and head.shape[1] * tp.size == cfg.vocab_size)
    if vocab_cut:
        hidden = tp.copy(hidden)
    lead = 1 if clients else 0
    if clients:
        hidden = hidden.reshape(clients, -1, *hidden.shape[1:])
        tokens = tokens.reshape(clients, -1, tokens.shape[-1])
        loss_mask = loss_mask.reshape(clients, -1, loss_mask.shape[-1])
    h = hidden[..., :-1, :]
    tgt = tokens[..., 1:].long()
    msk = loss_mask[..., 1:].float()
    Sm = h.shape[-2]
    c = min(chunk, Sm)
    nc = Sm // c
    s = n = acc = torch.zeros((clients,) if clients else (),
                              dtype=torch.float32, device=hidden.device)
    bounds = [(i * c, (i + 1) * c) for i in range(nc)]
    if Sm - nc * c:
        bounds.append((nc * c, Sm))
    for lo, hi in bounds:
        sl = slice(lo, hi)
        if vocab_cut:
            s_i, n_i, a_i = _ce_chunk_vocab(head, h[..., sl, :], tgt[..., sl],
                                            msk[..., sl], tp)
        else:
            s_i, n_i, a_i = _ce_chunk(head, h[..., sl, :], tgt[..., sl],
                                      msk[..., sl], lead)
        s, n, acc = s + s_i, n + n_i, acc + a_i
    if tp is not None and tp.data > 1:
        s, n, acc = tp.reduce(torch.stack([s, n, acc]), "data").unbind(0)
    n = torch.clamp(n, min=1.0)
    return s / n, {"loss": s / n, "tokens": n, "accuracy": acc / n}
