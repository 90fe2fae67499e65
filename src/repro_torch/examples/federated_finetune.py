"""End to end: federated LoRA fine-tuning with any of the five
aggregation methods on a configurable model.  Port of the reference's
``examples/federated_finetune.py``.

  PYTHONPATH=src python -m repro_torch.examples.federated_finetune \
      [--method florist] [--rounds 10] [--tau 0.9] [--heter] [--model tiny] \
      [--runner cohort] [--scheduler async] [--codec int8] \
      [--clients 1024] [--participation 0.05] [--rank-policy resource] \
      [--dp-clip 1.0] [--dp-epsilon 8] [--checkpoint PATH [--resume]] \
      [--validation full] [--device cpu]

``--model 100m`` builds a ~100M-parameter decoder (12 L × 768); the default
``tiny`` profile runs in seconds on the card.  ``--runner cohort`` trains
each equal-rank cohort through one ``lora_matmul`` launch a projection;
``--scheduler`` swaps the participation semantics; ``--codec`` picks the
wire serialization whose measured bytes are printed each round;
``--rank-policy resource`` adapts each task's rank to a cyclic budget
profile; ``--dp-clip`` / ``--dp-sigma`` privatize every upload on the wire
(``--dp-epsilon`` calibrates σ from a per-round ε).  ``--checkpoint PATH``
saves the round-boundary state atomically every ``--checkpoint-every``
rounds, and ``--resume`` continues bit-identically from the last save.

``--runner sharded_cohort`` and ``--method florist_sharded`` raise: the
multi-device runtime is ``ROADMAP.md`` Queue 1 item 9.  Runs on ``cuda``
unless ``--device cpu`` is given.
"""
import argparse
import os
import time

from repro_torch.common.config import (FedConfig, LoRAConfig, ModelConfig,
                                       OptimConfig)
from repro_torch.core.aggregators import available_aggregators
from repro_torch.core.federated import FederatedTrainer
from repro_torch.core.privacy import noise_multiplier_for_epsilon
from repro_torch.core.runtime import (SampledScheduler, available_codecs,
                                      available_rank_policies,
                                      available_runners, available_schedulers)

PROFILES = {
    "tiny": ModelConfig(name="fed-tiny", family="dense", num_layers=4,
                        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                        d_ff=256, vocab_size=512, dtype="float32"),
    "20m": ModelConfig(name="fed-20m", family="dense", num_layers=8,
                       d_model=384, num_heads=6, num_kv_heads=2, head_dim=64,
                       d_ff=1024, vocab_size=2048, dtype="float32"),
    "100m": ModelConfig(name="fed-100m", family="dense", num_layers=12,
                        d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
                        d_ff=2048, vocab_size=8192, dtype="float32"),
}


def main(argv=None) -> FederatedTrainer:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="florist",
                    choices=available_aggregators() + ["florist_sharded"])
    ap.add_argument("--model", default="tiny", choices=list(PROFILES))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--tau", type=float, default=0.9)
    ap.add_argument("--heter", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runner", default="sequential",
                    choices=available_runners() + ["sharded_cohort"])
    ap.add_argument("--scheduler", default="sync",
                    choices=available_schedulers())
    ap.add_argument("--codec", default="fp32", choices=available_codecs())
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--participation", type=float, default=0.0,
                    help="sampled-scheduler fraction (overrides --scheduler)")
    ap.add_argument("--rank-policy", default="static",
                    choices=available_rank_policies())
    ap.add_argument("--dp-clip", type=float, default=0.0)
    ap.add_argument("--dp-sigma", type=float, default=0.0)
    ap.add_argument("--dp-epsilon", type=float, default=0.0,
                    help="per-round epsilon -> sigma (overrides --dp-sigma)")
    ap.add_argument("--checkpoint", default="",
                    help="round-boundary checkpoint path (atomic writes)")
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint (bit-identical replay)")
    ap.add_argument("--validation", default="screen",
                    choices=["off", "screen", "full"])
    ap.add_argument("--min-clients", type=int, default=1,
                    help="round quorum: accepted updates required to fold")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)

    scheduler = args.scheduler
    if args.participation:
        scheduler = SampledScheduler(fraction=args.participation)
    dp_sigma = args.dp_sigma
    if args.dp_epsilon:
        dp_sigma = noise_multiplier_for_epsilon(args.dp_epsilon)

    cfg = PROFILES[args.model]
    c = args.clients
    # the heavy-tail profile, scaled to --clients (counts must sum to c)
    dist = ((4, 4 * c // 10), (8, 2 * c // 10), (16, 2 * c // 10), (32, c // 10),
            (64, c - (4 * c // 10) - 2 * (2 * c // 10) - c // 10))
    fed = FedConfig(num_clients=c, clients_per_round=8, method=args.method,
                    tau=args.tau, homogeneous_rank=16,
                    heterogeneous=args.heter, rank_distribution=dist,
                    zero_padding=args.heter and args.method in ("fedit", "ffa"),
                    seed=args.seed)
    trainer = FederatedTrainer(cfg, fed, LoRAConfig(rank=16, alpha=16.0),
                               OptimConfig(lr=3e-4), batch_size=8,
                               local_steps=args.local_steps, seq_len=64,
                               dp_clip=args.dp_clip, dp_sigma=dp_sigma,
                               runner=args.runner, scheduler=scheduler,
                               rank_policy=args.rank_policy,
                               transport=args.codec,
                               validation=args.validation,
                               min_clients=args.min_clients,
                               device=args.device)
    per_round = max(1, round(args.participation * c)) if args.participation \
        else fed.clients_per_round
    total_steps = args.rounds * per_round * args.local_steps
    sched_name = scheduler if isinstance(scheduler, str) else scheduler.name
    print(f"== federated fine-tune: {cfg.name} ({cfg.param_count():,} params), "
          f"method={args.method}, runner={args.runner}, "
          f"scheduler={sched_name}, codec={args.codec}, "
          f"{args.rounds} rounds (~{total_steps} local steps total), "
          f"device {trainer.device} ==")
    start = 0
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        start = trainer.restore_checkpoint(args.checkpoint)
        print(f"== resumed from {args.checkpoint} at round {start} ==")
    t0 = time.time()
    for rnd in range(start, args.rounds):
        rec = trainer.run_round(rnd)
        print(f"[{time.time() - t0:7.1f}s] round {rnd:3d} "
              f"loss={rec.eval_loss:.4f} acc={rec.eval_acc:.3f} "
              f"down_rank={rec.download_rank:.0f} "
              f"wire_up_MB={rec.upload_bytes / 2**20:.2f} "
              f"wire_down_MB={rec.download_bytes / 2**20:.2f} "
              f"({rec.wall_secs:.2f}s/round)")
        if args.checkpoint and (rnd + 1) % args.checkpoint_every == 0:
            trainer.save_checkpoint(args.checkpoint, rnd + 1)
    print("done.")
    return trainer


if __name__ == "__main__":
    main()
