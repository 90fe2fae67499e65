"""Shared benchmark utilities (port of the reference's
``benchmarks/common.py``): the bench model and federated setup of the
paper-table and figure modules, :func:`bench_fed` and :func:`timeit`.

:func:`bench_trainer` builds the bench's ``FederatedTrainer`` and runs no
round, so a caller can carry state in (a reference trainer's ``params`` and
``A_init_full``, :mod:`repro_torch.convert`) before the first one;
:func:`bench_fed` is :func:`bench_trainer` plus ``run(rounds)``.  Both take
keyword overrides that go to the trainer unchanged (``cfg``, ``lora``,
``batch_size``, ``seq_len``, ``params``, ``clients``, ``eval_data``,
``device`` and any other ``FederatedTrainer`` keyword); the defaults are the
reference's values.  The trainer runs on ``cuda`` unless ``device="cpu"``
is given.
"""
from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.benchmarks import emit
from repro_torch.common.config import (FedConfig, LoRAConfig, ModelConfig,
                                       OptimConfig)
from repro_torch.core.federated import FederatedTrainer
from repro_torch.device import DeviceLike

__all__ = ["FAST", "BENCH_MODEL", "BENCH_LORA", "BENCH_OPT", "bench_config",
           "bench_trainer", "bench_fed", "timeit", "emit", "main_device"]

FAST = os.environ.get("BENCH_FAST", "0") == "1"

# tiny federated benchmark model (CPU-sized)
BENCH_MODEL = ModelConfig(name="bench-tiny", family="dense", num_layers=4,
                          d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                          d_ff=128, vocab_size=256, dtype="float32")
BENCH_LORA = LoRAConfig(rank=8, alpha=8.0)
BENCH_OPT = OptimConfig(lr=3e-3)
# the paper's heavy-tail rank mix scaled to the bench's 20 clients
RANK_DISTRIBUTION = ((4, 8), (8, 4), (16, 4), (32, 2), (64, 2))


def bench_config(method: str, *, heterogeneous: bool = False, tau=0.9,
                 seed: int = 0, num_clients: int = 20,
                 clients_per_round: int = 5) -> FedConfig:
    """The reference bench's ``FedConfig``: FedIT and FFA zero-pad when the
    ranks are heterogeneous."""
    return FedConfig(
        num_clients=num_clients, clients_per_round=clients_per_round,
        method=method, tau=tau, homogeneous_rank=8,
        heterogeneous=heterogeneous, rank_distribution=RANK_DISTRIBUTION,
        zero_padding=heterogeneous and method in ("fedit", "ffa"), seed=seed)


def bench_trainer(method: str, *, heterogeneous: bool = False, tau=0.9,
                  seed: int = 0, num_clients: int = 20,
                  clients_per_round: int = 5, cfg: ModelConfig = BENCH_MODEL,
                  lora: LoRAConfig = BENCH_LORA, batch_size: int = 8,
                  seq_len: int = 32, params: Optional[Dict] = None,
                  clients=None, eval_data: Optional[Dict] = None,
                  device: DeviceLike = None, **trainer_kw):
    """The bench's trainer, before its first round."""
    fed = bench_config(method, heterogeneous=heterogeneous, tau=tau,
                       seed=seed, num_clients=num_clients,
                       clients_per_round=clients_per_round)
    return FederatedTrainer(cfg, fed, lora, BENCH_OPT, clients=clients,
                            eval_data=eval_data, batch_size=batch_size,
                            local_steps=4, seq_len=seq_len, params=params,
                            device=device, **trainer_kw)


def bench_fed(method: str, *, rounds: int = 0, **bench):
    """:func:`bench_trainer` plus ``run(rounds)`` (10 rounds, 3 under
    ``BENCH_FAST=1``, where ``rounds`` is 0): ``(history, trainer)``."""
    rounds = rounds or (3 if FAST else 10)
    tr = bench_trainer(method, **bench)
    hist = tr.run(rounds)
    return hist, tr


def timeit(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall time in µs of ``fn(*args)``; on the card each call is
    closed by ``torch.cuda.synchronize``, so the time covers its device
    work."""
    def call():
        out = fn(*args)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return out

    for _ in range(warmup):
        call()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(statistics.median(ts))


def main_device(argv=None) -> Optional[str]:
    """A module's ``--device`` flag when it runs as a script: ``cuda``
    (None) unless ``--device cpu``; never a fallback."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    return ap.parse_args(argv).device
