"""Training launcher: LoRA fine-tuning of a ported architecture, the
single-tenant (non-federated) path (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      [--smoke] [--steps 20] [--batch 4] [--seq 64] [--use-kernels] \
      [--ckpt PATH] [--device cpu]

It runs on ``cuda`` unless it is given ``--device cpu``; without CUDA and
without ``--device cpu`` it raises.  Weights are random (``T.init`` seeded
with 0), the adapters ``init_lora`` of rank ``--rank`` and alpha
``--rank`` on the family's LoRA targets; batches cycle over
``make_eval_data``'s ``4 × --batch`` token samples, as the reference's do
(the vision and audio models too: their front ends take no part).
``--arch`` takes any of the reference's architectures, e.g.
``zamba2-1.2b``, ``phi-3-vision-4.2b`` or ``musicgen-medium``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.io import save
from repro_torch.common.config import OptimConfig
from repro_torch.configs import get_config, get_smoke_config, lora_targets
from repro_torch.data.synthetic import make_eval_data
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_init
from repro_torch.peft.lora import init_lora
from repro_torch.train.step import make_eval_step, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = T.init(cfg, 0, dev)
    targets = lora_targets(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    adapters = init_lora(params, targets, args.rank, float(args.rank), gen)
    opt_state = adamw_init(adapters)
    optim = OptimConfig(lr=args.lr)
    step = make_train_step(cfg, optim, loss_chunk=min(args.seq, 512),
                           use_kernels=args.use_kernels,
                           grad_accum=args.grad_accum)
    eval_step = make_eval_step(cfg, loss_chunk=min(args.seq, 512),
                               use_kernels=args.use_kernels)

    ev = make_eval_data(num_samples=args.batch * 4, seq_len=args.seq,
                        vocab=cfg.vocab_size)
    ev = {"tokens": torch.as_tensor(ev["tokens"], device=dev).long(),
          "loss_mask": torch.as_tensor(ev["loss_mask"], device=dev)}

    def batch_at(i):
        lo = (i * args.batch) % (ev["tokens"].shape[0] - args.batch + 1)
        return {k: v[lo: lo + args.batch] for k, v in ev.items()}

    print(f"training {cfg.name}: {cfg.param_count():,} params, LoRA rank "
          f"{args.rank} on {targets}")
    t0 = time.time()
    for i in range(args.steps):
        adapters, opt_state, metrics = step(params, adapters, opt_state,
                                            batch_at(i))
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f} "
                  f"({time.time()-t0:.1f}s)")
    m = eval_step(params, adapters, batch_at(0))
    print(f"final eval: loss={float(m['loss']):.4f} acc={float(m['accuracy']):.3f}")
    if args.ckpt:
        save(args.ckpt, adapters, step=args.steps)
        print(f"adapters saved to {args.ckpt}")


if __name__ == "__main__":
    main()
