"""Sweep the energy threshold τ (paper Figs. 5 & 7): total global rank and
eval quality vs τ, on the synthetic federated task.  Port of the
reference's ``examples/threshold_sweep.py``.

  PYTHONPATH=src python -m repro_torch.examples.threshold_sweep [--rounds 6] [--device cpu]
"""
import argparse

from repro_torch.common.config import (FedConfig, LoRAConfig, ModelConfig,
                                       OptimConfig)
from repro_torch.core.aggregators import make_aggregator
from repro_torch.core.federated import FederatedTrainer

CFG = ModelConfig(name="sweep-tiny", family="dense", num_layers=4, d_model=64,
                  num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=256, dtype="float32")


def main(argv=None):
    """Returns ``[(tau, trainer)]`` after the sweep."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--taus", default="0.6,0.8,0.9,0.95,0.99")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)

    print(f"{'tau':>6s} {'total_rank':>11s} {'eff(1/rank)':>12s} "
          f"{'eval_loss':>10s} {'eval_acc':>9s}")
    out = []
    for tau in (float(t) for t in args.taus.split(",")):
        fed = FedConfig(num_clients=20, clients_per_round=5, method="florist",
                        tau=tau, homogeneous_rank=8, seed=0)
        # the strategy is injectable: build it explicitly and hand it to the
        # trainer (same as what fed.method would construct via the registry)
        tr = FederatedTrainer(CFG, fed, LoRAConfig(rank=8, alpha=8.0),
                              OptimConfig(lr=3e-3), batch_size=8,
                              local_steps=4, seq_len=32,
                              aggregator=make_aggregator("florist", tau=tau),
                              device=args.device)
        hist = tr.run(args.rounds)
        last = hist[-1]
        rank = last.global_rank_total
        print(f"{tau:6.2f} {rank:11d} {1.0/max(rank,1):12.2e} "
              f"{last.eval_loss:10.4f} {last.eval_acc:9.3f}")
        out.append((tau, tr))
    return out


if __name__ == "__main__":
    main()
