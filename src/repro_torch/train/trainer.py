"""Trainer: the single-tenant training loop as a resumable object (port of
``repro.train.trainer``): checkpointing (adapters, optimizer state and
step), periodic eval and a metric history, around the port's train step.

Params come from ``T.init`` with a generator seeded from ``seed`` (or
``params=``); the adapters from ``init_lora`` with a generator seeded from
``seed + 1`` (``jax.random`` and torch draw different streams: parity
carries a reference trainer's trees across, ``repro_torch.convert``).
``TrainerConfig.use_kernels`` runs the train and eval steps through the
``lora_matmul`` and ``flash_attention`` kernels (RWKV6: ``lora_matmul``,
its recurrence through ``wkv_scan`` in the train step and through the
``wkv6`` kernel in the eval step, ``models.rwkv.recurrence_route``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from repro_torch.checkpoint.io import restore, restore_step, save
from repro_torch.common.config import LoRAConfig, ModelConfig, OptimConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_init
from repro_torch.peft.lora import init_lora
from repro_torch.train.step import make_eval_step, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    eval_every: int = 25
    ckpt_every: int = 50
    ckpt_path: str = ""
    loss_chunk: int = 64
    grad_accum: int = 1
    use_kernels: bool = False
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: ModelConfig, lora: LoRAConfig, optim: OptimConfig,
                 tcfg: TrainerConfig, targets: tuple, seed: int = 0,
                 params: Optional[Any] = None, device: DeviceLike = None):
        self.cfg, self.lora, self.optim, self.tcfg = cfg, lora, optim, tcfg
        self.device = resolve_device(device)
        self.params = params if params is not None else \
            T.init(cfg, seed, self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.adapters = init_lora(self.params, targets, lora.rank, lora.alpha,
                                  gen)
        self.opt_state = adamw_init(self.adapters)
        self.step_no = 0
        self._train = make_train_step(
            cfg, optim, loss_chunk=tcfg.loss_chunk,
            use_kernels=tcfg.use_kernels, grad_accum=tcfg.grad_accum)
        self._eval = make_eval_step(cfg, loss_chunk=tcfg.loss_chunk,
                                    use_kernels=tcfg.use_kernels)
        self.history: List[Dict] = []

    # -- checkpointing ---------------------------------------------------------
    def save_ckpt(self, path: Optional[str] = None) -> str:
        path = path or self.tcfg.ckpt_path
        if not path:
            raise ValueError("no checkpoint path configured")
        save(path, {"adapters": self.adapters, "opt": self.opt_state},
             step=self.step_no)
        return path

    def restore_ckpt(self, path: Optional[str] = None) -> int:
        path = path or self.tcfg.ckpt_path
        like = {"adapters": self.adapters, "opt": self.opt_state}
        tree = restore(path, like)
        self.adapters, self.opt_state = tree["adapters"], tree["opt"]
        self.step_no = restore_step(path) or 0
        return self.step_no

    # -- loop --------------------------------------------------------------------
    def _on_device(self, batch: Dict) -> Dict:
        out = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        return {k: v.long() if not v.is_floating_point() else v
                for k, v in out.items()}

    def fit(self, batches: Iterator[Dict], eval_batch: Optional[Dict] = None,
            steps: Optional[int] = None, verbose: bool = False) -> List[Dict]:
        steps = steps or self.tcfg.steps
        t0 = time.time()
        for batch in batches:
            if self.step_no >= steps:
                break
            self.adapters, self.opt_state, metrics = self._train(
                self.params, self.adapters, self.opt_state,
                self._on_device(batch))
            self.step_no += 1
            rec = {"step": self.step_no, "loss": float(metrics["loss"]),
                   "accuracy": float(metrics["accuracy"]),
                   "wall_s": time.time() - t0}
            if eval_batch is not None and self.step_no % self.tcfg.eval_every == 0:
                em = self._eval(self.params, self.adapters,
                                self._on_device(eval_batch))
                rec["eval_loss"] = float(em["loss"])
                rec["eval_accuracy"] = float(em["accuracy"])
            if self.tcfg.ckpt_path and self.step_no % self.tcfg.ckpt_every == 0:
                self.save_ckpt()
            self.history.append(rec)
            if verbose and self.step_no % self.tcfg.log_every == 0:
                print(f"step {rec['step']:5d} loss={rec['loss']:.4f} "
                      f"acc={rec['accuracy']:.3f}")
        return self.history
