"""End to end: federated LoRA fine-tuning with any of the five
aggregation methods on a configurable model.  Port of the reference's
``examples/federated_finetune.py``.

  PYTHONPATH=src python -m repro_torch.examples.federated_finetune \
      [--method florist] [--rounds 10] [--tau 0.9] [--heter] [--model tiny] \
      [--runner cohort] [--scheduler async] [--codec int8] \
      [--clients 1024] [--participation 0.05] [--rank-policy resource] \
      [--dp-clip 1.0] [--dp-epsilon 8] [--checkpoint PATH [--resume]] \
      [--validation full] [--runner sharded_cohort --method florist_sharded \
      --world 2 --backend gloo] [--device cpu]

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

``--runner sharded_cohort`` shards each cohort's client axis over the
ranks of a fed mesh and ``--method florist_sharded`` splits the server's
layers over them; ``--world N`` spawns N local ranks (``--backend gloo``
by default, on one card or the CPU; ``nccl`` where each rank has a card),
or the ranks of ``torchrun`` are used.  Every rank runs the same trainer
from the same seed; only rank 0 prints and writes the checkpoint.  Runs on
``cuda`` unless ``--device cpu`` is given.
"""
import argparse
import types

from repro_torch.common.config import (FedConfig, LoRAConfig, ModelConfig,
                                       OptimConfig)
from repro_torch.core.aggregators import available_aggregators
from repro_torch.core.federated import FederatedTrainer
from repro_torch.core.privacy import noise_multiplier_for_epsilon
from repro_torch.core.runtime import (SampledScheduler, available_codecs,
                                      available_rank_policies,
                                      available_runners, available_schedulers)
from repro_torch.topology import rank0_print, run_world, world

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


def _record(trainer: FederatedTrainer) -> dict:
    """What a spawned rank hands back: its history and global ranks."""
    gs = trainer.global_state
    return {"history": trainer.history,
            "ranks": gs.ranks if gs is not None else None}


def main(argv=None):
    """Returns the trainer; with ``--world N > 1`` started here, a
    namespace of rank 0's ``history`` and ``ranks`` and every rank's
    record (``ranks_by_rank``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="florist",
                    choices=available_aggregators())
    ap.add_argument("--model", default="tiny", choices=list(PROFILES))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--tau", type=float, default=0.9)
    ap.add_argument("--heter", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runner", default="sequential",
                    choices=available_runners())
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
    ap.add_argument("--world", type=int, default=1,
                    help="ranks of the SPMD world (spawned here, or torchrun's)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    ranks = run_world(_run, args.world, args.backend, args.device, args=(args,))
    if len(ranks) > 1:                      # the world was spawned here
        return types.SimpleNamespace(history=ranks[0]["history"],
                                     ranks=ranks[0]["ranks"],
                                     ranks_by_rank=ranks)
    return ranks[min(ranks)]


def _run(args):
    """One rank's run: the trainer in a lone process, its record
    (:func:`_record`) on a rank of a world."""
    _, size = world()
    scheduler = args.scheduler
    if args.participation:
        scheduler = SampledScheduler(fraction=args.participation)
    dp_sigma = args.dp_sigma
    if args.dp_epsilon:
        dp_sigma = noise_multiplier_for_epsilon(args.dp_epsilon)

    cfg = PROFILES[args.model]
    c = args.clients
    # the heavy-tail profile, scaled to --clients (counts must sum to c)
    ranks = ((4, 4 * c // 10), (8, 2 * c // 10), (16, 2 * c // 10), (32, c // 10),
             (64, c - (4 * c // 10) - 2 * (2 * c // 10) - c // 10))
    fed = FedConfig(num_clients=c, clients_per_round=8, method=args.method,
                    tau=args.tau, homogeneous_rank=16,
                    heterogeneous=args.heter, rank_distribution=ranks,
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
    rank0_print(f"== federated fine-tune: {cfg.name} ({cfg.param_count():,} "
                f"params), method={args.method}, runner={args.runner}, "
                f"scheduler={sched_name}, codec={args.codec}, {args.rounds} "
                f"rounds (~{total_steps} local steps total), device "
                f"{trainer.device}, {size} rank(s)"
                f"{', backend ' + args.backend if size > 1 else ''} ==")
    trainer.run(args.rounds, verbose=True, checkpoint=args.checkpoint,
                checkpoint_every=args.checkpoint_every, resume=args.resume)
    rank0_print("done.")
    return _record(trainer) if size > 1 else trainer


if __name__ == "__main__":
    main()
