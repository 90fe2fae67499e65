"""Synthetic instruction-tuning corpus + federated non-IID partitioning (a
copy of ``repro.data.synthetic``: numpy only, so the same seed gives the
same clients, batches and eval set, bit for bit, in both packages).

Offline stand-in for Dolly/Alpaca/Wizard: a *learnable* instruction-following
task so federated fine-tuning runs show real convergence differences between
aggregation methods.

Task family: sequence = [BOS, instr_1..instr_m, SEP, resp_1..resp_m, pad...]
where ``resp_i = (instr_i * mult_t + off_t) mod (vocab - 4) + 4`` for a
*task id* ``t``.  Clients draw tasks from Dirichlet(α) proportions over the
task pool (paper §4.1: α = 0.5), so clients are non-IID in task mixture —
the direct analogue of the paper's Dirichlet label-skew splits.

Loss is masked to response positions only (instruction tuning).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

BOS, SEP, EOS, PAD = 1, 2, 3, 0
SPECIAL = 4


@dataclass
class ClientDataset:
    tokens: np.ndarray       # (n, S) int32
    loss_mask: np.ndarray    # (n, S) float32 — 1 on response positions
    num_samples: int

    def batches(self, batch_size: int, rng: np.random.Generator):
        idx = rng.permutation(self.num_samples)
        for i in range(0, self.num_samples - batch_size + 1, batch_size):
            sel = idx[i: i + batch_size]
            yield {"tokens": self.tokens[sel], "loss_mask": self.loss_mask[sel]}


def _make_example(rng, task: int, seq_len: int, vocab: int, num_tasks: int):
    m = (seq_len - 3) // 2
    mult = 1 + 2 * (task % 7)
    off = 3 + 11 * task
    instr = rng.integers(SPECIAL, vocab, size=m)
    resp = (instr * mult + off) % (vocab - SPECIAL) + SPECIAL
    toks = np.full(seq_len, PAD, np.int32)
    toks[0] = BOS
    toks[1: 1 + m] = instr
    toks[1 + m] = SEP
    toks[2 + m: 2 + 2 * m] = resp
    toks[2 + 2 * m] = EOS
    mask = np.zeros(seq_len, np.float32)
    # next-token loss: predicting resp tokens (targets at positions 2+m..)
    mask[2 + m: 3 + 2 * m] = 1.0
    return toks, mask


def dirichlet_partition(num_clients: int, num_tasks: int, alpha: float,
                        rng: np.random.Generator) -> np.ndarray:
    """Per-client task mixture, Dirichlet(alpha) (paper: alpha=0.5)."""
    return rng.dirichlet([alpha] * num_tasks, size=num_clients)


def make_federated_data(num_clients: int = 100, mean_samples: int = 32,
                        seq_len: int = 64, vocab: int = 256,
                        num_tasks: int = 8, alpha: float = 0.5,
                        seed: int = 0) -> List[ClientDataset]:
    rng = np.random.default_rng(seed)
    mix = dirichlet_partition(num_clients, num_tasks, alpha, rng)
    out = []
    for c in range(num_clients):
        n = max(4, int(rng.lognormal(np.log(mean_samples), 0.4)))
        tasks = rng.choice(num_tasks, size=n, p=mix[c])
        toks = np.zeros((n, seq_len), np.int32)
        mask = np.zeros((n, seq_len), np.float32)
        for i, t in enumerate(tasks):
            toks[i], mask[i] = _make_example(rng, int(t), seq_len, vocab, num_tasks)
        out.append(ClientDataset(toks, mask, n))
    return out


def make_eval_data(num_samples: int = 128, seq_len: int = 64, vocab: int = 256,
                   num_tasks: int = 8, seed: int = 1234) -> Dict:
    """Held-out uniform-task eval set (the 'MMLU subset' analogue)."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((num_samples, seq_len), np.int32)
    mask = np.zeros((num_samples, seq_len), np.float32)
    for i in range(num_samples):
        toks[i], mask[i] = _make_example(rng, int(rng.integers(num_tasks)),
                                         seq_len, vocab, num_tasks)
    return {"tokens": toks, "loss_mask": mask}
