"""Per-round federated runtime wall-clock (port of ``benchmarks/fed_bench.py``):
client runners × round schedulers, the DP curve, the fault arm.

The cohort runner trains every equal-(rank, steps) cohort through one
cohort step a local step: each LoRA projection of the whole cohort is one
``lora_matmul`` launch over a client axis, where the sequential runner
launches it once a client.  The default arm times ``sequential`` against
``cohort`` under the ``sync`` and ``async`` schedulers (rounds interleaved
round-robin, medians).  Also:

* ``--smoke`` adds the **utility-against-ε DP curve**: the same rounds with
  the transport's DP stage at decreasing budgets (σ from the classical
  Gaussian-mechanism bound, clip 1.0);
* ``--faults`` runs the **fault arm**: the hardened path (per-block
  checksums and the ``screen`` gate) against both off on clean rounds, and
  a poison-containment probe (10% NaN and 10% scaled clients against the
  ``full`` gate) whose recall it reports;
* ``--scale`` runs the population-scale arm (1024 clients, a sampled
  participation fraction) for ``sequential``, ``cohort`` and
  ``sharded_cohort`` (the client axis over a fed mesh, with FLoRIST's
  layers split by ``florist_sharded``): one row on a one-rank mesh in this
  process and, with ``--world N``, one on a spawned world of N ranks
  (``--backend``, gloo by default; rank 0's times).

Runs on ``cuda`` unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.benchmarks.fed_bench --smoke [--json F]
    PYTHONPATH=src python -m repro_torch.benchmarks.fed_bench --faults
    PYTHONPATH=src python -m repro_torch.benchmarks.fed_bench --scale \
        [--world 2 --backend gloo]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict

import torch

from repro_torch.common.config import (FedConfig, LoRAConfig, ModelConfig,
                                       OptimConfig)
from repro_torch.core.aggregators.florist import FloristAggregator
from repro_torch.core.distributed import ShardedFloristAggregator
from repro_torch.core.federated import FederatedTrainer
from repro_torch.core.privacy import noise_multiplier_for_epsilon
from repro_torch.core.runtime import (FaultPlan, SampledScheduler, Transport,
                                      ValidationGate)
from repro_torch.data.synthetic import make_eval_data, make_federated_data
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.topology import spawn, under_torchrun, world

SMOKE_MODEL = ModelConfig(name="fedbench-tiny", family="dense", num_layers=2,
                          d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
                          d_ff=64, vocab_size=128, dtype="float32")
FULL_MODEL = ModelConfig(name="fedbench-small", family="dense", num_layers=4,
                         d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                         d_ff=256, vocab_size=512, dtype="float32")
SCALE_MODEL = ModelConfig(name="fedbench-nano", family="dense", num_layers=1,
                          d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
                          d_ff=64, vocab_size=128, dtype="float32")
SCALE_SHAPE = {"local_steps": 2, "batch_size": 2, "seq_len": 16}


def make_trainer(cfg: ModelConfig, runner, scheduler, *, clients: int,
                 sample: int, local_steps: int, batch_size: int, seq_len: int,
                 device: torch.device, **kw) -> FederatedTrainer:
    fed = FedConfig(num_clients=clients, clients_per_round=sample,
                    method="florist", tau=0.9, homogeneous_rank=8, seed=0)
    data = kw.pop("clients_data", None)    # a pre-built population, if shared
    return FederatedTrainer(cfg, fed, LoRAConfig(rank=8, alpha=8.0),
                            OptimConfig(lr=3e-3), clients=data,
                            batch_size=batch_size, local_steps=local_steps,
                            seq_len=seq_len,
                            eval_data=make_eval_data(num_samples=32,
                                                     seq_len=seq_len,
                                                     vocab=cfg.vocab_size),
                            runner=runner, scheduler=scheduler, device=device,
                            **kw)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_round(tr: FederatedTrainer, rnd: int) -> float:
    _sync(tr.device)
    t0 = time.perf_counter()
    tr.run_round(rnd)
    _sync(tr.device)
    return (time.perf_counter() - t0) * 1e3


def runner_axis(cfg, dev, *, clients, sample, local_steps, batch_size,
                seq_len, iters, log) -> Dict:
    """``sequential`` and ``cohort`` under ``sync`` and ``async``: two
    warm-up rounds each, then ``iters`` rounds interleaved round-robin."""
    combos = [(runner, scheduler) for runner in ("sequential", "cohort")
              for scheduler in ("sync", "async")]
    trainers = {c: make_trainer(cfg, *c, clients=clients, sample=sample,
                                local_steps=local_steps, batch_size=batch_size,
                                seq_len=seq_len, device=dev) for c in combos}
    rounds = {c: 0 for c in combos}
    for c in combos:
        for _ in range(2):
            trainers[c].run_round(rounds[c])
            rounds[c] += 1
    samples = {c: [] for c in combos}
    for _ in range(iters):
        for c in combos:
            samples[c].append(_timed_round(trainers[c], rounds[c]))
            rounds[c] += 1
    results = []
    for runner, scheduler in combos:
        ms = float(statistics.median(samples[(runner, scheduler)]))
        results.append({"runner": runner, "scheduler": scheduler,
                        "ms_per_round": round(ms, 3)})
        log(f"{runner:10s} {scheduler:7s} {ms:9.2f} ms/round")
    by = {(r["runner"], r["scheduler"]): r["ms_per_round"] for r in results}
    speedup = by[("sequential", "sync")] / by[("cohort", "sync")]
    log(f"speedup (cohort vs sequential, sync): {speedup:.2f}x")
    return {"results": results, "speedup_cohort_vs_sequential": round(speedup, 2)}


def dp_axis(cfg, dev, *, clients, sample, local_steps, batch_size, seq_len,
            log, rounds: int = 3) -> Dict:
    """Utility against ε: the last round's eval loss as the per-round budget
    tightens (σ the classical Gaussian calibration for ε at δ 1e-5)."""
    curve = []
    for eps in (None, 8.0, 2.0, 0.5):
        sigma = 0.0 if eps is None else noise_multiplier_for_epsilon(eps)
        tr = make_trainer(cfg, "cohort", "sync", clients=clients,
                          sample=sample, local_steps=local_steps,
                          batch_size=batch_size, seq_len=seq_len, device=dev,
                          dp_clip=0.0 if eps is None else 1.0, dp_sigma=sigma)
        loss = tr.run(rounds)[-1].eval_loss
        curve.append({"epsilon": eps, "sigma": round(sigma, 4),
                      "eval_loss": round(loss, 5)})
        log(f"dp eps={'inf' if eps is None else f'{eps:g}':>4s} "
            f"sigma={sigma:6.3f} loss={loss:.4f}")
    return {"curve": curve, "loss_ratio_tightest_eps":
            round(curve[-1]["eval_loss"] / curve[0]["eval_loss"], 4)}


def faults_axis(dev, iters: int, log, clients: int = 32, sample: int = 16,
                local_steps: int = 12) -> Dict:
    """The hardened path's cost on clean rounds (checksums and the
    ``screen`` gate against both off, interleaved, alternating which arm
    goes first) and the ``full`` gate's containment of 20% poisoned
    clients (recall = caught / injected)."""
    cfg = SMOKE_MODEL
    batch_size, seq_len = 2, 16
    arms = {"off": dict(validation="off",
                        transport=Transport("fp32", checksums=False)),
            "hardened": dict(validation="screen")}
    trainers = {name: make_trainer(cfg, "cohort", "sync", clients=clients,
                                   sample=sample, local_steps=local_steps,
                                   batch_size=batch_size, seq_len=seq_len,
                                   device=dev, **kw)
                for name, kw in arms.items()}
    rounds = {name: 0 for name in arms}
    for name in arms:                     # FLoRIST's kept rank settles first
        for _ in range(3):
            trainers[name].run_round(rounds[name])
            rounds[name] += 1
    samples = {name: [] for name in arms}
    order = list(arms)
    for it in range(iters):
        for name in (order if it % 2 == 0 else order[::-1]):
            samples[name].append(_timed_round(trainers[name], rounds[name]))
            rounds[name] += 1
    ms = {name: float(statistics.median(s)) for name, s in samples.items()}
    overhead = ms["hardened"] / ms["off"]
    for name in arms:
        log(f"faults {name:9s} {ms[name]:9.2f} ms/round")
    log(f"hardened/off overhead: {overhead:.3f}x")

    plan = FaultPlan(seed=7, nan=0.1, scale=0.1)
    tr = make_trainer(cfg, "cohort", "sync", clients=clients, sample=sample,
                      local_steps=2, batch_size=batch_size, seq_len=seq_len,
                      device=dev, faults=plan,
                      validation=ValidationGate("full"))
    plans = []
    orig_plan = tr.scheduler.plan
    tr.scheduler.plan = lambda rnd, ctx: plans.append(orig_plan(rnd, ctx)) \
        or plans[-1]
    hist = tr.run(3)
    injected = sum(1 for p in plans for t in p.tasks
                   if plan.client_fault(p.round, t.client_id).kind
                   in ("nan", "scale"))
    caught = sum(r.rejected + r.quarantined for r in hist)
    recall = caught / injected if injected else 1.0
    log(f"poison containment: {caught}/{injected} caught (recall {recall:.2f})")
    return {"config": {"model": cfg.name, "num_clients": clients,
                       "clients_per_round": sample, "local_steps": local_steps,
                       "iters": iters},
            "results": [{"arm": n, "ms_per_round": round(v, 3)}
                        for n, v in ms.items()],
            "overhead_hardened_vs_off": round(overhead, 4),
            "poison_injected": injected, "poison_caught": caught,
            "poison_quarantine_recall": round(recall, 4)}


def _scale_trainer(name: str, dev, clients: int, participants: int):
    data = make_federated_data(num_clients=clients, mean_samples=6,
                               seq_len=SCALE_SHAPE["seq_len"],
                               vocab=SCALE_MODEL.vocab_size, seed=0)
    agg_cls = (ShardedFloristAggregator if name == "sharded_cohort"
               else FloristAggregator)
    agg = agg_cls(tau=0.9, svd_method="svd", stream="auto",
                  flush_every=participants)
    return make_trainer(SCALE_MODEL, name,
                        SampledScheduler(fraction=participants / clients),
                        clients=clients, sample=participants, device=dev,
                        aggregator=agg, clients_data=data, **SCALE_SHAPE)


def _scale_rounds(name: str, dev, iters: int, clients: int,
                  participants: int) -> Dict:
    """One runner's warm-up round and ``iters`` timed rounds (on every rank
    of a world, which all run them)."""
    tr = _scale_trainer(name, dev, clients, participants)
    tr.run_round(0)                                       # warm-up round
    sec = statistics.median(_timed_round(tr, 1 + i) for i in range(iters))
    return {"ms_per_round": sec, "peak_live_clients":
            getattr(tr.runner, "peak_live_clients", 0),
            "peak_pending_blocks": tr.aggregator.peak_pending_blocks,
            "eval_loss": tr.history[-1].eval_loss, "world": world()[1]}


def scale_axis(dev, iters: int, log, clients: int = 1024,
               participants: int = 64, world_size: int = 1,
               backend: str = "gloo") -> Dict:
    """Population-scale rounds: a sampled participation fraction of
    ``clients`` through ``sequential``, ``cohort`` and ``sharded_cohort``
    (a one-rank mesh here, and a spawned world of ``world_size`` ranks when
    it is above 1).  ``peak_live_clients`` and FLoRIST's
    ``peak_pending_blocks`` record the O(cohort) memory on both sides.
    The world is spawned here, so the axis refuses to run under
    ``torchrun``."""
    if under_torchrun():
        raise RuntimeError("fed_bench --scale spawns its own world: run it "
                           "as one process, not under torchrun")
    results, runs = [], {}
    arms = [("sequential", 1), ("cohort", 1), ("sharded_cohort", 1)]
    if world_size > 1:
        arms.append(("sharded_cohort", world_size))
    for name, n in arms:
        if n == 1:
            run = _scale_rounds(name, dev, iters, clients, participants)
        else:
            run = spawn(_scale_rounds, n, backend, dev.type,
                        args=(name, dev.type, iters, clients, participants))[0]
        sec = run["ms_per_round"]
        runs[(name, n)] = run
        row = {"runner": name, "ms_per_round": round(sec, 3),
               "rounds_per_sec": round(1e3 / sec, 4)}
        if name == "sharded_cohort":
            row.update(world=n, backend=backend if n > 1 else None,
                       peak_live_clients=run["peak_live_clients"])
        results.append(row)
        log(f"scale {name:15s} world {n} {sec:9.2f} ms/round "
            f"({1e3 / sec:.3f} rounds/s)")
    by = {r["runner"]: r.get("ms_per_round") for r in results[:2]}
    return {"config": {"model": SCALE_MODEL.name, "num_clients": clients,
                       "participants": participants,
                       "local_steps": SCALE_SHAPE["local_steps"]},
            "results": results,
            "speedup_cohort_vs_sequential":
                round(by["sequential"] / by["cohort"], 2),
            "peak_live_clients": runs[("cohort", 1)]["peak_live_clients"],
            "peak_pending_blocks":
                runs[("cohort", 1)]["peak_pending_blocks"]}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small config + few iters, and the DP curve")
    ap.add_argument("--scale", action="store_true",
                    help="the 1024-client sampled arm only")
    ap.add_argument("--faults", action="store_true",
                    help="the hardened path's cost and poison containment")
    ap.add_argument("--json", default="", help="write results to this path")
    ap.add_argument("--iters", type=int, default=0)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--sample", type=int, default=16)
    ap.add_argument("--local-steps", type=int, default=0,
                    help="local steps (default 12 with --smoke, else 8)")
    ap.add_argument("--world", type=int, default=1,
                    help="--scale: also run sharded_cohort on a spawned "
                         "world of this many ranks")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    return ap.parse_args(argv)


def bench(args, device: DeviceLike = None, log: Callable = print) -> Dict:
    """The arm ``args`` selects; returns the reference's report keys."""
    dev = resolve_device(device if device is not None else args.device)
    backend = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if args.faults:
        report = faults_axis(dev, args.iters or 5, log, clients=args.clients,
                             sample=args.sample,
                             local_steps=args.local_steps or 12)
    elif args.scale:
        report = scale_axis(dev, args.iters or 3, log,
                            world_size=args.world, backend=args.backend)
    else:
        cfg = SMOKE_MODEL if args.smoke else FULL_MODEL
        local_steps = args.local_steps or (12 if args.smoke else 8)
        batch_size, seq_len = (2, 16) if args.smoke else (8, 32)
        shape = dict(clients=args.clients, sample=args.sample,
                     local_steps=local_steps, batch_size=batch_size,
                     seq_len=seq_len)
        report = runner_axis(cfg, dev, iters=args.iters or 5, log=log, **shape)
        report["config"] = {"model": cfg.name, "num_clients": args.clients,
                            "clients_per_round": args.sample,
                            "local_steps": local_steps,
                            "iters": args.iters or 5, "smoke": bool(args.smoke)}
        if args.smoke:
            report["dp_axis"] = dp_axis(cfg, dev, log=log, **shape)
    report.setdefault("config", {})["backend"] = backend
    return report


def main(argv=None) -> Dict:
    args = parse_args(argv)
    report = bench(args)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json}")
    return report


if __name__ == "__main__":
    main()
