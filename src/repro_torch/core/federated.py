"""Federated fine-tuning orchestration (port of ``repro.core.federated``;
paper §4.1 setup).

One round: the ``sync`` scheduler samples clients from the trainer's numpy
rng; the ``sequential`` runner fine-tunes each client's LoRA adapters; each
trained tree crosses the measured ``fp32`` wire and the validation gate
into the streaming aggregator; ``finalize`` runs the FLoRIST SVD pipeline;
the global adapters are broadcast (clients resume from the decoded
broadcast) and evaluated merged into the base.

The train and eval steps run attention and the LoRA projections through
the ``flash_attention`` and ``lora_matmul`` kernels, and ``svd_method=
"gram"`` runs the server's Gram products through ``adapter_gram`` (the
kernels on the card, their plain versions on the CPU).  The reference
reaches those kernels only through launcher flags; its default route
computes the same functions and the parity tests hold the two together.

Not ported yet: checkpoint/resume, fault injection, local DP, and the
runtime seams other than the ones named above.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.config import (FedConfig, LoRAConfig, ModelConfig,
                                       OptimConfig)
from repro_torch.core.aggregators import (AggResult, Aggregator,
                                          accepted_config, make_aggregator)
from repro_torch.core.runtime import (ClientRunner, RankPolicy, RoundScheduler,
                                      Transport, ValidationGate,
                                      make_rank_policy, make_runner,
                                      make_scheduler, make_transport,
                                      make_validator)
from repro_torch.data.synthetic import (ClientDataset, make_eval_data,
                                        make_federated_data)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.peft.lora import init_lora, merge_lora
from repro_torch.train.step import make_eval_step, make_train_step

#: CE chunk of the train step (the reference trainer's)
TRAIN_LOSS_CHUNK = 64


@dataclasses.dataclass
class RoundRecord:
    round: int
    eval_loss: float
    eval_acc: float
    upload_params: int
    download_params: int
    download_rank: float
    global_rank_total: int
    upload_bytes: int = 0        # measured serialized uplink (all clients)
    download_bytes: int = 0      # measured serialized downlink (all clients)
    wall_secs: float = 0.0       # wall-clock of the whole round
    finalize_secs: float = 0.0   # wall-clock of the server's finalize
    rejected: int = 0            # gate rejections (non-finite/shape/dup)
    quorum_met: bool = True      # round reached min_clients accepted updates


class FederatedTrainer:
    """Composition of runner + scheduler + aggregator + transport + gate.

    ``runner`` / ``scheduler`` / ``rank_policy`` / ``transport`` /
    ``validation`` take a registered name or an instance.  Parameters come
    from ``T.init`` with a torch generator seeded by ``fed.seed``; the
    shared A init (``A_init_full``) likewise.  A caller holding a
    reference trainer's state overwrites ``params`` and ``A_init_full``
    with it (:mod:`repro_torch.convert`) before the first round.
    """

    def __init__(self, cfg: ModelConfig, fed: FedConfig, lora: LoRAConfig,
                 optim: OptimConfig,
                 clients: Optional[List[ClientDataset]] = None,
                 eval_data: Optional[Dict] = None, batch_size: int = 8,
                 local_steps: int = 4, seq_len: int = 64,
                 svd_method: str = "svd", targets: Optional[tuple] = None,
                 aggregator: Optional[Aggregator] = None,
                 runner: Any = "sequential", scheduler: Any = "sync",
                 rank_policy: Any = "static", transport: Any = "fp32",
                 validation: Any = "screen", min_clients: int = 1,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.fed, self.lora, self.optim = cfg, fed, lora, optim
        self.batch_size, self.local_steps = batch_size, local_steps
        self.seq_len = seq_len
        self.svd_method = svd_method
        self.gate: ValidationGate = make_validator(
            validation, min_clients=min_clients)
        self.rng = np.random.default_rng(fed.seed)
        self.params = T.init(cfg, fed.seed, self.device)
        self.targets = targets or lora.targets
        self.client_ranks = fed.client_ranks()
        self.max_rank = max(self.client_ranks)
        # one shared init at max rank; client k uses its first r_k rows
        gen = torch.Generator(device=self.device).manual_seed(fed.seed + 1)
        self.A_init_full = init_lora(self.params, self.targets, self.max_rank,
                                     float(self.max_rank), gen)
        self.aggregator = aggregator if aggregator is not None else \
            make_aggregator(fed.method, **accepted_config(fed.method, dict(
                tau=fed.tau, svd_method=svd_method,
                zero_padding=fed.zero_padding)))
        self.runner: ClientRunner = make_runner(runner)
        self.scheduler: RoundScheduler = make_scheduler(scheduler)
        self.rank_policy: RankPolicy = make_rank_policy(rank_policy)
        self.transport: Transport = make_transport(transport)
        self.global_state: Optional[AggResult] = None
        self.clients = clients if clients is not None else make_federated_data(
            num_clients=fed.num_clients, seq_len=seq_len,
            vocab=cfg.vocab_size, alpha=fed.dirichlet_alpha, seed=fed.seed)
        ev = eval_data if eval_data is not None else make_eval_data(
            seq_len=seq_len, vocab=cfg.vocab_size)
        self.eval_batch = {
            "tokens": torch.as_tensor(ev["tokens"], device=self.device).long(),
            "loss_mask": torch.as_tensor(ev["loss_mask"], device=self.device)}
        # the eval chunk is seq_len, as in the reference trainer
        self._eval = make_eval_step(cfg, loss_chunk=seq_len, use_kernels=True)
        self._step = make_train_step(cfg, optim, loss_chunk=TRAIN_LOSS_CHUNK,
                                     use_kernels=True,
                                     b_only=self.aggregator.trains_b_only)
        self.history: List[RoundRecord] = []

    # -- helpers -------------------------------------------------------------
    def _train_step(self):
        return self._step

    def _client_init(self, k: int, rank: Optional[int] = None) -> Dict:
        """Client k's starting adapters for this round (the aggregation
        strategy's client-init semantics)."""
        return self.aggregator.client_init(
            self.global_state,
            self.client_ranks[k] if rank is None else rank,
            self.A_init_full)

    # -- main loop ------------------------------------------------------------
    def run_round(self, rnd: int) -> RoundRecord:
        t0 = time.perf_counter()
        plan = self.scheduler.plan(rnd, self)
        self.rank_policy.assign(rnd, plan, self)
        ranks = [t.rank for t in plan.tasks]
        self.aggregator.begin_round()
        self.gate.begin_round(self.aggregator)
        upload_bytes = 0

        def deliver(task, adapters, init_adapters=None):
            # uplink through the measured wire, then through the gate into
            # the server's accumulators; the trained tree is dropped here
            nonlocal upload_bytes
            adapters, nbytes = self.transport.client_to_server(
                adapters, self.aggregator)
            upload_bytes += nbytes
            self.gate.submit(task, adapters, task.weight, rank=task.rank)

        self.runner.run(self, plan, deliver)
        gstats = self.gate.finish()
        if not gstats.quorum_met or self.aggregator.num_clients == 0:
            return self._degraded_round(rnd, t0, gstats, upload_bytes)
        t_fin = time.perf_counter()
        agg = self.aggregator.finalize()     # ends in a device→host copy
        finalize_secs = time.perf_counter() - t_fin
        dims = self.aggregator.dims
        up = self.aggregator.round_upload_params
        n_down = len(plan.tasks)
        down = self.aggregator.download_params(agg, dims, n_down, ranks)

        # downlink through the measured wire: clients resume from the
        # decoded broadcast; the server evaluates its exact aggregate
        bcast, download_bytes = self.transport.server_to_clients(
            agg, self.aggregator, n_down)
        eval_params = merge_lora(self.params, agg.global_adapters)
        agg.global_adapters = bcast
        self.global_state = agg

        m = self._eval(eval_params, None, self.eval_batch)
        rec = RoundRecord(
            round=rnd,
            eval_loss=float(m["loss"]),
            eval_acc=float(m["accuracy"]),
            upload_params=up,
            download_params=down,
            download_rank=agg.total_download_rank()
            * self.aggregator.download_rank_factor,
            global_rank_total=agg.total_download_rank(),
            upload_bytes=upload_bytes,
            download_bytes=download_bytes,
            wall_secs=time.perf_counter() - t0,
            finalize_secs=finalize_secs,
            rejected=gstats.rejected,
        )
        self.history.append(rec)
        return rec

    def _degraded_round(self, rnd: int, t0: float, gstats,
                        upload_bytes: int) -> RoundRecord:
        """Quorum failure: the previous global state is kept (the half-filled
        accumulator is never finalized) and the record says so."""
        gs = self.global_state
        eval_params = (merge_lora(self.params, gs.global_adapters)
                       if gs is not None else self.params)
        m = self._eval(eval_params, None, self.eval_batch)
        rec = RoundRecord(
            round=rnd,
            eval_loss=float(m["loss"]),
            eval_acc=float(m["accuracy"]),
            upload_params=self.aggregator.round_upload_params,
            download_params=0,
            download_rank=0.0,
            global_rank_total=gs.total_download_rank() if gs is not None else 0,
            upload_bytes=upload_bytes,
            download_bytes=0,
            wall_secs=time.perf_counter() - t0,
            rejected=gstats.rejected,
            quorum_met=False,
        )
        self.history.append(rec)
        return rec

    def run(self, num_rounds: Optional[int] = None,
            verbose: bool = False) -> List[RoundRecord]:
        """Run rounds ``[0, num_rounds)``."""
        for rnd in range(num_rounds or self.fed.num_rounds):
            rec = self.run_round(rnd)
            if verbose:
                print(f"[{self.aggregator.name:9s}] round {rnd:3d} "
                      f"loss={rec.eval_loss:.4f} acc={rec.eval_acc:.3f} "
                      f"down_rank={rec.download_rank:.0f} "
                      f"up={rec.upload_bytes / 2**20:.2f}MB "
                      f"down={rec.download_bytes / 2**20:.2f}MB "
                      f"{rec.wall_secs:.2f}s")
        return self.history
