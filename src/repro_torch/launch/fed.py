"""Federated launcher: the paper's experimental loop (§4.1) as a CLI, port
of ``repro.launch.fed`` for the flags this slice supports.

  PYTHONPATH=src python -m repro_torch.launch.fed --method florist \
      --rounds 10 [--heter] [--tau 0.9] [--clients 100] [--sample 10] \
      [--svd gram] [--codec bf16|int8] [--runner cohort] \
      [--scheduler partial|async|sampled] [--participation 0.1] \
      [--rank-policy resource] [--dp-clip 1.0 --dp-epsilon 8] \
      [--validation full] [--min-clients 2] [--fault-drop 0.2 ...] \
      [--crash-at 2:mid_round] [--checkpoint PATH [--resume]] \
      [--arch granite-moe-1b-a400m [--smoke]] \
      [--runner sharded_cohort --method florist_sharded --world 2 \
       --backend gloo] [--device cpu]

``--method`` takes any registered aggregation strategy (the paper's five:
``florist``, ``fedit``, ``ffa``, ``flora``, ``flexlora``); ``--codec``
any wire codec.  ``--checkpoint PATH`` saves the round-boundary state
atomically every ``--checkpoint-every`` rounds and ``--resume`` restarts
from it bit-identically; the ``--fault-*`` flags and ``--crash-at
ROUND:POINT`` drive the deterministic fault injector.  ``--world N``
runs the loop on N ranks of an SPMD world (spawned here with ``--backend``
gloo or nccl, or ``torchrun``'s): ``--runner sharded_cohort`` shards each
cohort's clients over them and ``--method florist_sharded`` the server's
layers; every rank runs the same seed, rank 0 prints and writes ``--out``
and the checkpoint.  It runs on ``cuda`` unless it is given ``--device cpu``; without CUDA and
without ``--device cpu`` it raises.  The model is the reference launcher's
small dense config (``--layers``, ``--d-model``), or with ``--arch`` a
ported architecture, any of the reference's (``--smoke``: its reduced
config; random seeded weights, LoRA on the family's targets, 64 tokens a
row; ``zamba2-1.2b``, ``phi-3-vision-4.2b`` and ``musicgen-medium`` train
on token rows, as the reference's launcher does), and
heterogeneous ranks follow the paper's heavy-tail distribution scaled to
``--clients``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch.distributed as dist

from repro_torch.common.config import (FedConfig, LoRAConfig, ModelConfig,
                                       OptimConfig)
from repro_torch.configs import get_config, get_smoke_config, lora_targets
from repro_torch.core.aggregators import available_aggregators
from repro_torch.core.federated import FederatedTrainer
from repro_torch.core.privacy import noise_multiplier_for_epsilon
from repro_torch.core.runtime import (CRASH_POINTS, FaultPlan, SampledScheduler,
                                      available_codecs, available_rank_policies,
                                      available_runners, available_schedulers)
from repro_torch.device import resolve_device
from repro_torch.topology import rank0_print, run_world, world


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
    ap.add_argument("--runner", default="sequential",
                    choices=available_runners())
    ap.add_argument("--scheduler", default="sync",
                    choices=available_schedulers())
    ap.add_argument("--codec", default="fp32", choices=available_codecs())
    ap.add_argument("--participation", type=float, default=0.0,
                    help="sampled-scheduler participation fraction "
                         "(overrides --scheduler)")
    ap.add_argument("--rank-policy", default="static",
                    choices=available_rank_policies())
    ap.add_argument("--dp-clip", type=float, default=0.0,
                    help="L2 clip C for each client's update delta")
    ap.add_argument("--dp-sigma", type=float, default=0.0,
                    help="noise multiplier (std = sigma * C on the wire)")
    ap.add_argument("--dp-epsilon", type=float, default=0.0,
                    help="per-round epsilon; calibrates sigma "
                         "(overrides --dp-sigma)")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--arch", default="",
                    help="a ported architecture (default: the small dense "
                         "config of --layers and --d-model)")
    ap.add_argument("--smoke", action="store_true",
                    help="with --arch: its reduced smoke config")
    ap.add_argument("--out", default="")
    ap.add_argument("--checkpoint", default="",
                    help="round-boundary checkpoint path (atomic writes)")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="rounds between checkpoint saves")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists "
                         "(bit-identical replay)")
    ap.add_argument("--validation", default="screen",
                    choices=["off", "screen", "full"],
                    help="server-side update gate mode")
    ap.add_argument("--min-clients", type=int, default=1,
                    help="round quorum: accepted updates required to fold")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--fault-drop", type=float, default=0.0)
    ap.add_argument("--fault-corrupt", type=float, default=0.0)
    ap.add_argument("--fault-duplicate", type=float, default=0.0)
    ap.add_argument("--fault-nan", type=float, default=0.0)
    ap.add_argument("--fault-scale", type=float, default=0.0)
    ap.add_argument("--fault-slow", type=float, default=0.0)
    ap.add_argument("--crash-at", default="",
                    help=f"inject a server crash, e.g. '2:mid_round' "
                         f"(points: {', '.join(CRASH_POINTS)})")
    ap.add_argument("--world", type=int, default=1,
                    help="ranks of the SPMD world (spawned here, or torchrun's)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="torch.distributed backend of a spawned world")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    ranks = run_world(_run, args.world, args.backend, args.device, args=(args,))
    return ranks[min(ranks)]           # rank 0's history (torchrun: this rank's)


def _run(args) -> list:
    """One rank's federated loop; rank 0 prints and writes ``--out``."""
    rank, size = world()
    device = resolve_device(args.device)
    rank0_print(f"SPMD world: {size} rank(s), backend "
                f"{dist.get_backend() if size > 1 else 'none (one process)'}")

    scheduler = args.scheduler
    if args.participation:
        scheduler = SampledScheduler(fraction=args.participation)
    dp_sigma = args.dp_sigma
    if args.dp_epsilon:
        dp_sigma = noise_multiplier_for_epsilon(args.dp_epsilon)
    faults = None
    if (args.fault_drop or args.fault_corrupt or args.fault_duplicate
            or args.fault_nan or args.fault_scale or args.fault_slow
            or args.crash_at):
        crashes = ()
        if args.crash_at:
            rnd, point = args.crash_at.split(":", 1)
            crashes = ((int(rnd), point),)
        faults = FaultPlan(seed=args.fault_seed, drop=args.fault_drop,
                           corrupt=args.fault_corrupt,
                           duplicate=args.fault_duplicate,
                           nan=args.fault_nan, scale=args.fault_scale,
                           slow=args.fault_slow, crashes=crashes)

    if args.arch:
        cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
        lora = LoRAConfig(rank=16, alpha=16.0, targets=lora_targets(cfg))
    else:
        cfg = ModelConfig(name="fed-cli", family="dense", num_layers=args.layers,
                          d_model=args.d_model, num_heads=4, num_kv_heads=2,
                          head_dim=args.d_model // 4, d_ff=2 * args.d_model,
                          vocab_size=512, dtype="float32")
        lora = LoRAConfig(rank=16, alpha=16.0)
    # paper's heavy-tail heterogeneous rank distribution, scaled to --clients
    c = args.clients
    ranks = ((4, 4 * c // 10), (8, 2 * c // 10), (16, 2 * c // 10),
             (32, c // 10), (64, c - (4 * c // 10) - 2 * (2 * c // 10) - c // 10))
    fed = FedConfig(num_clients=c, clients_per_round=args.sample,
                    num_rounds=args.rounds, method=args.method, tau=args.tau,
                    dirichlet_alpha=args.alpha, heterogeneous=args.heter,
                    rank_distribution=ranks,
                    zero_padding=args.heter and args.method in ("fedit", "ffa"))
    tr = FederatedTrainer(cfg, fed, lora,
                          OptimConfig(lr=3e-4), local_steps=args.local_steps,
                          svd_method=args.svd, dp_clip=args.dp_clip,
                          dp_sigma=dp_sigma, runner=args.runner,
                          scheduler=scheduler, rank_policy=args.rank_policy,
                          transport=args.codec, faults=faults,
                          validation=args.validation,
                          min_clients=args.min_clients, device=device)
    hist = tr.run(args.rounds, verbose=True, checkpoint=args.checkpoint,
                  checkpoint_every=args.checkpoint_every, resume=args.resume)
    if args.out and rank == 0:
        with open(args.out, "w") as f:
            json.dump([dataclasses.asdict(h) for h in hist], f, indent=2)
        print(f"history written to {args.out}")
    return hist


if __name__ == "__main__":
    main()
