"""Federated fine-tuning orchestration (port of ``repro.core.federated``;
paper §4.1 setup).

One round: a scheduler (``sync``, ``partial``, ``async``, ``sampled``)
plans who participates from the trainer's numpy rng, a rank policy
(``static``, ``resource``) may adapt each task's rank, and a runner
(``sequential``, or ``cohort``: each equal-rank cohort through one
``lora_matmul`` launch a projection) fine-tunes the clients' LoRA adapters;
each trained tree crosses the measured wire (``fp32``, ``bf16`` or
``int8``; clipped and noised there with ``dp_clip``/``dp_sigma``) and the
validation gate (``off``, ``screen``, ``full``) into the streaming
aggregator, which owns the method's semantics (FLoRIST, FedIT, FFA-LoRA,
FLoRA, FlexLoRA: client re-init, frozen A, merge into the base,
per-client cuts).  Broadcast methods
evaluate the server's exact aggregate merged into the base, and clients
resume from the decoded broadcast; FLoRA folds the decoded stack into the
base itself and evaluates that.

The train and eval steps run attention and the LoRA projections through
the ``flash_attention`` and ``lora_matmul`` kernels, and ``svd_method=
"gram"`` runs FLoRIST's Gram products through ``adapter_gram`` (the
kernels on the card, their plain versions on the CPU).  The reference
reaches those kernels only through launcher flags; its default route
computes the same functions and the parity tests hold the two together.

A deterministic :class:`~repro_torch.core.runtime.faults.FaultPlan`
(``faults=``) drops, delays, duplicates, corrupts and poisons uploads and
crashes the server at a round stage; ``run(checkpoint=, resume=)`` saves
the round-boundary state atomically and replays a killed run to a
bit-identical history.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.common.config import (FedConfig, LoRAConfig, ModelConfig,
                                       OptimConfig)
from repro_torch.core.aggregators import (AggResult, Aggregator,
                                          accepted_config, make_aggregator)
from repro_torch.core.runtime import (ClientRunner, DeadClientError,
                                      RankPolicy, RoundScheduler, ServerCrash,
                                      Transport, ValidationGate,
                                      make_rank_policy, make_runner,
                                      make_scheduler, make_transport,
                                      make_validator)
from repro_torch.data.synthetic import (ClientDataset, make_eval_data,
                                        make_federated_data)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.peft.lora import init_lora, merge_lora
from repro_torch.topology.mesh import rank0_print, world
from repro_torch.train.step import (make_cohort_train_step, make_eval_step,
                                    make_train_step)

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
    retries: int = 0             # uplink re-sends after verification failure
    dead_clients: int = 0        # dropped uploads + retry-exhausted clients
    rejected: int = 0            # gate rejections (non-finite/shape/dup)
    quarantined: int = 0         # norm-outlier quarantines (full mode)
    quorum_met: bool = True      # round reached min_clients accepted updates
    resumes: int = 0             # 1 on the first round after a resume
    sim_secs: float = 0.0        # simulated time (backoff + slow clients)


class FederatedTrainer:
    """Composition of runner + scheduler + aggregator + transport + gate.

    ``runner`` / ``scheduler`` / ``rank_policy`` / ``transport`` /
    ``validation`` take a registered name or an instance.  The base weights
    are ``params`` where given (shared, never written: FLoRA's merge makes
    new leaves), else ``T.init`` with ``fed.seed``; the shared A init
    (``A_init_full``) comes from a torch generator seeded by ``fed.seed +
    1``.  A caller holding a reference trainer's state overwrites
    ``params`` and ``A_init_full`` with it (:mod:`repro_torch.convert`)
    before the first round.  An aggregator that ``needs_a_init`` (FFA) and
    was built without its own ``A_init`` is handed ``A_init_full`` at the
    start of every round, so it sees such an overwrite.

    ``dp_clip``/``dp_sigma`` turn on the transport's local DP stage (noise
    keyed on ``(fed.seed, round, client)``); ``faults`` is a
    :class:`~repro_torch.core.runtime.faults.FaultPlan` (``None``: a
    healthy world).
    """

    def __init__(self, cfg: ModelConfig, fed: FedConfig, lora: LoRAConfig,
                 optim: OptimConfig,
                 clients: Optional[List[ClientDataset]] = None,
                 eval_data: Optional[Dict] = None, batch_size: int = 8,
                 local_steps: int = 4, seq_len: int = 64,
                 svd_method: str = "svd", targets: Optional[tuple] = None,
                 dp_clip: float = 0.0, dp_sigma: float = 0.0,
                 aggregator: Optional[Aggregator] = None,
                 runner: Any = "sequential", scheduler: Any = "sync",
                 rank_policy: Any = "static", transport: Any = "fp32",
                 faults: Any = None, validation: Any = "screen",
                 min_clients: int = 1,
                 params: Optional[Dict] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.fed, self.lora, self.optim = cfg, fed, lora, optim
        self.batch_size, self.local_steps = batch_size, local_steps
        self.seq_len = seq_len
        self.svd_method = svd_method
        self.dp_clip, self.dp_sigma = dp_clip, dp_sigma
        self.faults = faults
        self.gate: ValidationGate = make_validator(
            validation, min_clients=min_clients)
        self.rng = np.random.default_rng(fed.seed)
        self.params = params if params is not None else \
            T.init(cfg, fed.seed, self.device)
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
        self._hand_a_init = (self.aggregator.needs_a_init
                             and getattr(self.aggregator, "A_init", None) is None)
        self.runner: ClientRunner = make_runner(runner)
        self.scheduler: RoundScheduler = make_scheduler(scheduler)
        self.rank_policy: RankPolicy = make_rank_policy(rank_policy)
        self.transport: Transport = make_transport(
            transport, dp_clip=dp_clip, dp_sigma=dp_sigma, dp_seed=fed.seed,
            fault_plan=faults)
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
        self._cohort = make_cohort_train_step(
            cfg, optim, loss_chunk=TRAIN_LOSS_CHUNK, use_kernels=True,
            b_only=self.aggregator.trains_b_only)
        self.history: List[RoundRecord] = []
        self._pending_resumes = 0    # stamped into the first post-resume record

    # -- helpers -------------------------------------------------------------
    def _train_step(self):
        return self._step

    def _cohort_step(self):
        return self._cohort

    def _client_init(self, k: int, rank: Optional[int] = None) -> Dict:
        """Client k's starting adapters for this round (the aggregation
        strategy's client-init semantics)."""
        return self.aggregator.client_init(
            self.global_state,
            self.client_ranks[k] if rank is None else rank,
            self.A_init_full)

    def _maybe_crash(self, rnd: int, point: str) -> None:
        if self.faults is not None and self.faults.should_crash(rnd, point):
            raise ServerCrash(rnd, point)

    # -- main loop ------------------------------------------------------------
    def run_round(self, rnd: int) -> RoundRecord:
        t0 = time.perf_counter()
        self._maybe_crash(rnd, "begin")
        if self._hand_a_init:
            self.aggregator.A_init = self.A_init_full
        clock = self.transport.clock
        sim0 = clock.now if clock is not None else 0.0
        self.transport.reset_stats()
        plan = self.scheduler.plan(rnd, self)
        self.rank_policy.assign(rnd, plan, self)
        ranks = [t.rank for t in plan.tasks]
        self.aggregator.begin_round()
        self.gate.begin_round(self.aggregator)
        upload_bytes = delivered = dropped = 0
        mid_crash_at = max(1, len(plan.tasks) // 2)

        def deliver(task, adapters, init_adapters=None):
            # the client's fault first (drop, delay, poison), then the
            # measured wire (DP against the round's init happens there),
            # then the gate into the server's accumulators; the trained
            # tree is dropped here
            nonlocal upload_bytes, delivered, dropped
            delivered += 1
            fault = (self.faults.client_fault(rnd, task.client_id)
                     if self.faults is not None else None)
            try:
                if fault is not None:
                    if fault.kind == "drop":
                        dropped += 1
                        return
                    if fault.kind == "slow" and clock is not None:
                        clock.advance(fault.delay)
                    adapters = self.faults.poison(adapters, init_adapters,
                                                  rnd, task.client_id)
                adapters, nbytes = self.transport.client_to_server(
                    adapters, self.aggregator, init_adapters=init_adapters,
                    rnd=rnd, client_id=task.client_id)
                upload_bytes += nbytes
                self.gate.submit(task, adapters, task.weight, rank=task.rank,
                                 init_adapters=init_adapters)
                if fault is not None and fault.kind == "duplicate":
                    # at-least-once wire: the gate must fold it once
                    self.gate.submit(task, adapters, task.weight,
                                     rank=task.rank,
                                     init_adapters=init_adapters)
            except DeadClientError:
                pass        # counted in the transport's stats: a drop
            finally:
                if delivered == mid_crash_at:
                    self._maybe_crash(rnd, "mid_round")

        self.runner.run(self, plan, deliver)
        self._maybe_crash(rnd, "pre_finalize")
        gstats = self.gate.finish()
        tstats = self.transport.reset_stats()
        if not gstats.quorum_met or self.aggregator.num_clients == 0:
            return self._degraded_round(rnd, t0, sim0, gstats, tstats,
                                        upload_bytes, dropped)
        t_fin = time.perf_counter()
        agg = self.aggregator.finalize()     # ends in a device→host copy
        finalize_secs = time.perf_counter() - t_fin
        dims = self.aggregator.dims
        up = self.aggregator.round_upload_params
        # participation-aware downlink count: only clients handed the model
        # this round (async: the new dispatches' snapshots)
        n_down = plan.downloads if plan.downloads is not None \
            else len(plan.tasks)
        down = self.aggregator.download_params(agg, dims, n_down, ranks)

        # downlink through the measured wire: what the clients resume from
        # next round is the decoded broadcast
        bcast, download_bytes = self.transport.server_to_clients(
            agg, self.aggregator, n_down)
        if agg.merge_into_base:
            # FLoRA: every client folds the broadcast stack into its base, so
            # the merge consumes the decoded wire tensors, codec included
            if bcast is not None:
                agg.global_adapters = bcast
            self.params = merge_lora(self.params, agg.global_adapters)
            eval_params = self.params
        else:
            # broadcast methods: the server evaluates its exact aggregate
            eval_params = merge_lora(self.params, agg.global_adapters)
            if bcast is not None:
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
            retries=tstats.retries,
            dead_clients=tstats.dead_clients + dropped,
            rejected=gstats.rejected,
            quarantined=gstats.quarantined,
            resumes=self._pending_resumes,
            sim_secs=(clock.now - sim0) if clock is not None else 0.0,
        )
        self._pending_resumes = 0
        self.history.append(rec)
        self._maybe_crash(rnd, "post_round")
        return rec

    def _degraded_round(self, rnd: int, t0: float, sim0: float, gstats,
                        tstats, upload_bytes: int,
                        dropped: int = 0) -> RoundRecord:
        """Quorum failure: the previous global state is kept (the half-filled
        accumulator is never finalized) and the record says so.  A state
        already merged into the base (FLoRA) is not merged again."""
        gs = self.global_state
        if gs is not None and gs.global_adapters is not None \
                and not gs.merge_into_base:
            eval_params = merge_lora(self.params, gs.global_adapters)
        else:
            eval_params = self.params
        m = self._eval(eval_params, None, self.eval_batch)
        clock = self.transport.clock
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
            retries=tstats.retries,
            dead_clients=tstats.dead_clients + dropped,
            rejected=gstats.rejected,
            quarantined=gstats.quarantined,
            quorum_met=False,
            resumes=self._pending_resumes,
            sim_secs=(clock.now - sim0) if clock is not None else 0.0,
        )
        self._pending_resumes = 0
        self.history.append(rec)
        self._maybe_crash(rnd, "post_round")
        return rec

    # -- checkpoint / resume ---------------------------------------------------
    def state_dict(self, next_round: int) -> Dict[str, Any]:
        """Everything a fresh process needs to continue from ``next_round``
        bit-identically: base params, global state, the shared rng's exact
        bit-generator state, the scheduler's in-flight pool, the
        aggregator's streaming accumulators and the RoundRecord history
        (the reference's keys).  Tensors are host copies with their
        dtypes."""
        gs = self.global_state
        return {
            "next_round": int(next_round),
            "rng": self.rng.bit_generator.state,
            "params": ckpt_io.to_host(self.params),
            "global_state": None if gs is None else {
                "method": gs.method,
                "global_adapters": ckpt_io.to_host(gs.global_adapters),
                "per_client": ckpt_io.to_host(gs.per_client),
                "ranks": gs.ranks,
                "spectra": ckpt_io.to_host(gs.spectra),
                "merge_into_base": gs.merge_into_base,
            },
            "scheduler": self.scheduler.state_dict(),
            "aggregator": self.aggregator.state_dict(),
            "history": [dataclasses.asdict(r) for r in self.history],
        }

    def load_state_dict(self, state: Dict[str, Any]) -> int:
        """Inverse of :meth:`state_dict` (tensors onto the trainer's
        device); returns the round to run next."""
        dev = self.device
        self.rng.bit_generator.state = state["rng"]
        self.params = ckpt_io.to_device(state["params"], dev)
        gs = state["global_state"]
        self.global_state = None if gs is None else AggResult(
            method=gs["method"],
            global_adapters=ckpt_io.to_device(gs["global_adapters"], dev),
            per_client=ckpt_io.to_device(gs["per_client"], dev),
            ranks=gs["ranks"],
            spectra=ckpt_io.to_device(gs["spectra"], dev),
            merge_into_base=gs["merge_into_base"],
        )
        self.scheduler.load_state_dict(state["scheduler"], dev)
        self.aggregator.load_state_dict(state["aggregator"], dev)
        self.history = [RoundRecord(**r) for r in state["history"]]
        return int(state["next_round"])

    def save_checkpoint(self, path: str, next_round: int) -> None:
        """Atomically persist the round-boundary state
        (:func:`repro_torch.checkpoint.io.save_state`)."""
        ckpt_io.save_state(path, self.state_dict(next_round))

    def restore_checkpoint(self, path: str) -> int:
        """Restore a :meth:`save_checkpoint` blob; returns the next round.
        The first record produced afterwards carries ``resumes=1``."""
        start = self.load_state_dict(ckpt_io.restore_state(path))
        self._pending_resumes = 1
        return start

    def run(self, num_rounds: Optional[int] = None, verbose: bool = False,
            checkpoint: str = "", checkpoint_every: int = 0,
            resume: bool = False) -> List[RoundRecord]:
        """Run rounds ``[start, num_rounds)``.  With ``checkpoint`` the
        round-boundary state is saved atomically every ``checkpoint_every``
        rounds (default 1); with ``resume`` a killed run restarts from the
        last saved boundary and, every in-round decision being a pure
        function of the restored state, replays to a bit-identical
        history.

        In an SPMD world (a ``sharded_cohort`` runner or a ``florist_sharded``
        aggregator over ``torch.distributed``) every rank runs this same
        loop with the same seed, so sampling, batch draws, the codec's
        rounding, DP noise, fault plans and the gate agree bit for bit
        across ranks; only rank 0 prints and writes the checkpoint (the
        others wait for it), and every rank restores."""
        start = 0
        if resume and checkpoint and os.path.exists(checkpoint):
            start = self.restore_checkpoint(checkpoint)
        every = checkpoint_every or (1 if checkpoint else 0)
        rank, size = world()
        for rnd in range(start, num_rounds or self.fed.num_rounds):
            rec = self.run_round(rnd)
            if verbose:
                rank0_print(f"[{self.aggregator.name:9s}] round {rnd:3d} "
                            f"loss={rec.eval_loss:.4f} acc={rec.eval_acc:.3f} "
                            f"down_rank={rec.download_rank:.0f} "
                            f"up={rec.upload_bytes / 2**20:.2f}MB "
                            f"down={rec.download_bytes / 2**20:.2f}MB "
                            f"{rec.wall_secs:.2f}s")
            if checkpoint and every and (rnd + 1) % every == 0:
                if rank == 0:
                    self.save_checkpoint(checkpoint, rnd + 1)
                if size > 1:
                    dist.barrier()
        return self.history
