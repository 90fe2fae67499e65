"""Quickstart: federated FLoRIST rounds on a tiny model, end to end.  Port
of the reference's ``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks through the public API: build a model, give every client a LoRA
adapter, fine-tune locally, aggregate with singular-value thresholding,
inspect the chosen ranks and the communication savings.  Runs on ``cuda``
unless ``--device cpu`` is given.
"""
import argparse

from repro_torch.common.config import (FedConfig, LoRAConfig, ModelConfig,
                                       OptimConfig)
from repro_torch.core import costs as C
from repro_torch.core.federated import FederatedTrainer

ROUNDS = 3


def main(argv=None) -> FederatedTrainer:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    cfg = ModelConfig(name="quickstart-tiny", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                      d_ff=128, vocab_size=256, dtype="float32")
    fed = FedConfig(num_clients=10, clients_per_round=4, method="florist",
                    tau=0.9, homogeneous_rank=8, seed=0)
    trainer = FederatedTrainer(cfg, fed, LoRAConfig(rank=8, alpha=8.0),
                               OptimConfig(lr=3e-3), batch_size=8,
                               local_steps=4, seq_len=32, device=args.device)

    print("== FLoRIST quickstart ==")
    print(f"model: {cfg.name}  params={cfg.param_count():,}")
    print(f"clients: {fed.num_clients} (sample {fed.clients_per_round}/round), "
          f"Dirichlet α={fed.dirichlet_alpha}, τ={fed.tau}")
    for rnd in range(ROUNDS):
        rec = trainer.run_round(rnd)
        print(f"round {rnd}: eval_loss={rec.eval_loss:.4f} "
              f"acc={rec.eval_acc:.3f} "
              f"download_rank={rec.download_rank:.0f} "
              f"(stacked would be "
              f"{fed.clients_per_round * fed.homogeneous_rank * 2 * cfg.num_layers})")
    agg = trainer.global_state
    print("\nper-layer kept ranks (energy threshold τ=0.9):")
    for path, ranks in agg.ranks.items():
        print(f"  {'/'.join(map(str, path))}: {ranks}")
    last = trainer.history[-1]
    print(f"\ndownload cost this round: "
          f"{C.mb(last.download_params):.3f} MB "
          f"(upload {C.mb(last.upload_params):.3f} MB) — analytic FP16")
    # the runtime also *measures* serialized bytes on the wire (fp32 codec
    # here; transport="bf16" on the trainer halves them)
    print(f"measured on the wire:     "
          f"{C.wire_mb(last.download_bytes):.3f} MB down / "
          f"{C.wire_mb(last.upload_bytes):.3f} MB up "
          f"({last.wall_secs:.2f}s/round)")
    return trainer


if __name__ == "__main__":
    main()
