"""Federated launcher: the paper's experimental loop (§4.1) as a CLI, port
of ``repro.launch.fed`` for the flags this slice supports.

  PYTHONPATH=src python -m repro_torch.launch.fed --method florist \
      --rounds 10 [--heter] [--tau 0.9] [--clients 100] [--sample 10] \
      [--svd gram] [--codec bf16] [--device cpu]

``--method`` takes any registered aggregation strategy (the paper's five:
``florist``, ``fedit``, ``ffa``, ``flora``, ``flexlora``); ``--codec``
any ported wire codec.
It runs on ``cuda`` unless it is given ``--device cpu``; without CUDA and
without ``--device cpu`` it raises.  The model is the reference launcher's
small dense config (``--layers``, ``--d-model``), and heterogeneous ranks
follow the paper's heavy-tail distribution scaled to ``--clients``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.common.config import (FedConfig, LoRAConfig, ModelConfig,
                                       OptimConfig)
from repro_torch.core.aggregators import available_aggregators
from repro_torch.core.federated import FederatedTrainer
from repro_torch.core.runtime import available_codecs
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="florist",
                    choices=available_aggregators())
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--sample", type=int, default=10)
    ap.add_argument("--tau", type=float, default=0.9)
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="Dirichlet concentration (paper: 0.5)")
    ap.add_argument("--heter", action="store_true")
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--svd", default="svd", choices=["svd", "gram"])
    ap.add_argument("--codec", default="fp32", choices=available_codecs())
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(name="fed-cli", family="dense", num_layers=args.layers,
                      d_model=args.d_model, num_heads=4, num_kv_heads=2,
                      head_dim=args.d_model // 4, d_ff=2 * args.d_model,
                      vocab_size=512, dtype="float32")
    # paper's heavy-tail heterogeneous rank distribution, scaled to --clients
    c = args.clients
    dist = ((4, 4 * c // 10), (8, 2 * c // 10), (16, 2 * c // 10),
            (32, c // 10), (64, c - (4 * c // 10) - 2 * (2 * c // 10) - c // 10))
    fed = FedConfig(num_clients=c, clients_per_round=args.sample,
                    num_rounds=args.rounds, method=args.method, tau=args.tau,
                    dirichlet_alpha=args.alpha, heterogeneous=args.heter,
                    rank_distribution=dist,
                    zero_padding=args.heter and args.method in ("fedit", "ffa"))
    tr = FederatedTrainer(cfg, fed, LoRAConfig(rank=16, alpha=16.0),
                          OptimConfig(lr=3e-4), local_steps=args.local_steps,
                          svd_method=args.svd, transport=args.codec,
                          device=device)
    hist = tr.run(args.rounds, verbose=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([dataclasses.asdict(h) for h in hist], f, indent=2)
        print(f"history written to {args.out}")
    return hist


if __name__ == "__main__":
    main()
