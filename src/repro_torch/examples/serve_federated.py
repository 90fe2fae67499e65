"""FLoRIST live round->deploy loop: federate, hot-swap, serve — concurrently.
Port of the reference's ``examples/serve_federated.py``.

The paper's output is not a one-shot artifact: every federated round produces
a NEW global adapter, and a deployment keeps serving while training continues.
This example runs that loop for real.  A single :class:`ServeEngine` stays up
the whole time, mounted on an :class:`AdapterRegistry`; after each round the
fresh ``global_adapters`` tree is published with ``registry.swap`` (an atomic
version bump: new pages, new id, name repointed) while requests admitted
against the PREVIOUS version keep decoding in their slots untouched.  Requests
submitted after the swap resolve to the new version, so for a few engine steps
both generations of the adapter serve side by side in one batch; registry
churn only rewrites fixed-shape device pools.

The engine decodes through ``decode_impl="kernel"`` (``ring_decode`` and
``bgmv`` on the card) by default; ``"dense"`` runs the plain routes and
``"streamed"`` the reference's default, flash-decoding over kv blocks in
plain PyTorch.  ``--mesh N`` serves tensor-parallel on a serve mesh of N
ranks (``ServeEngine(mesh=make_serve_mesh(N))``): N local ranks are
spawned (``--backend gloo`` by default, every rank on one card or on the
CPU; ``nccl`` where each rank has a card), or the ranks of ``torchrun``
are used; every rank trains the same rounds from the same seed and serves
the same requests, and only rank 0 prints.  The last line reports the
serving kernels' launches per engine step and the engine's graph captures
(builds under a mesh of more than one rank, whose steps run uncaptured),
where the reference reports its trace counts.  ``--config`` trains and
serves any model of ``repro_torch.launch.serve.CONFIGS`` (the smoke ones
on the CPU; LoRA on the family's ``lora_targets``) in place of the
example's tiny dense model.  Runs on ``cuda`` unless ``--device cpu`` is
given.

  PYTHONPATH=src python -m repro_torch.examples.serve_federated [--rounds 2] \
      [--requests-per-round 2] [--batch-slots 4] [--temperature 0.0] \
      [--decode-impl kernel] [--mesh 2 --backend gloo] [--device cpu] \
      [--config granite_smoke]
"""
import argparse

import numpy as np

from repro_torch.common.config import (FedConfig, LoRAConfig, ModelConfig,
                                       OptimConfig)
from repro_torch.configs import lora_targets
from repro_torch.core.federated import FederatedTrainer
from repro_torch.kernels import ops
from repro_torch.serve.adapters import AdapterRegistry
from repro_torch.serve.engine import SamplingParams, ServeEngine
from repro_torch.topology import (make_serve_mesh, rank0_print, run_world,
                                  world)

SERVING_KERNELS = ("ring_decode", "bgmv")


def main(argv=None) -> dict:
    """Returns the engine, the trainer and what was served: ``outputs``
    (uid -> tokens), ``served_by`` (uid -> adapter id), ``in_flight`` (the
    adapter ids in the batch after each publish) and ``launches`` (the
    serving kernels' launch counts over the engine's steps).  With
    ``--mesh N > 1`` started here, the N ranks run in their own processes:
    rank 0's record comes back without the engine and the trainer, with
    ``ranks_agree`` (every rank emitted the same tokens), ``all_reduces``
    and ``all_to_alls`` (rank 0's, over the engine's steps)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--requests-per-round", type=int, default=2)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-tokens", type=int, default=12)
    ap.add_argument("--overlap-steps", type=int, default=3,
                    help="engine steps run between publish and the next "
                         "round, so old/new adapter versions share a batch")
    ap.add_argument("--decode-impl", default="kernel",
                    choices=["dense", "streamed", "kernel"],
                    help="serving attention interior (kernel = ring_decode "
                         "and bgmv on the card)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="model-parallel ranks of the serve mesh (0 = no "
                         "mesh, one device)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="torch.distributed backend of a spawned mesh")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    ap.add_argument("--config", default="tiny",
                    help="the example's tiny dense model, or any key of "
                         "repro_torch.launch.serve.CONFIGS")
    args = ap.parse_args(argv)
    ranks = run_world(_run, args.mesh, args.backend, args.device, args=(args,))
    if len(ranks) == 1:
        return next(iter(ranks.values()))
    out = ranks[0]                          # the world was spawned here
    out["ranks_agree"] = all(r["outputs"] == out["outputs"]
                             for r in ranks.values())
    return out


def _run(args) -> dict:
    """One rank's rounds and serving; only rank 0 prints."""
    _, size = world()
    log = rank0_print

    if args.config == "tiny":
        cfg = ModelConfig(name="serve-fed-tiny", family="dense", num_layers=2,
                          d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                          d_ff=128, vocab_size=256, dtype="float32")
    else:
        from repro_torch.launch.serve import CONFIGS
        cfg = CONFIGS[args.config][0]
    fed = FedConfig(num_clients=8, clients_per_round=4, method="florist",
                    tau=0.9, homogeneous_rank=8, seed=0)
    trainer = FederatedTrainer(cfg, fed, LoRAConfig(rank=8, alpha=8.0,
                                                    targets=lora_targets(cfg)),
                               OptimConfig(lr=3e-3), batch_size=8,
                               local_steps=2, seq_len=32, device=args.device)

    # One engine, up for the whole run — even before the first round lands
    # (every slot starts on base id 0).  The registry's paged pools are the
    # deploy surface; trainer rounds just publish into them.
    registry = AdapterRegistry(trainer.A_init_full, page_rank=4,
                               num_pages=16, max_adapters=8, max_rank=8,
                               device=trainer.device)
    mesh = (make_serve_mesh(args.mesh, device=trainer.device)
            if args.mesh else None)
    eng = ServeEngine(cfg, trainer.params, batch_slots=args.batch_slots,
                      capacity=64, seed=0, decode_impl=args.decode_impl,
                      registry=registry, device=trainer.device, mesh=mesh)
    if mesh is not None:
        log(f"serve mesh {mesh.shape}: {size} rank(s), backend "
            f"{mesh.backend or 'none (one rank)'}")
    rng = np.random.default_rng(0)
    sp = SamplingParams(temperature=args.temperature, top_k=8,
                        max_tokens=args.max_tokens)

    def submit_wave(n, adapter_id):
        return {eng.submit(rng.integers(1, cfg.vocab_size,
                                        rng.integers(3, 9)).tolist(),
                           sp, adapter_id=adapter_id): adapter_id
                for _ in range(n)}

    def serving_launches():
        counts = ops.launch_counts()
        return {k: counts[k] for k in SERVING_KERNELS}

    served_by = {}   # uid -> adapter id that served it
    outputs = {}     # uid -> generated tokens
    in_flight_after = []
    start = serving_launches()     # the rounds launch neither kernel
    log(f"== live round->deploy loop: {cfg.name}, {args.rounds} rounds ==")
    for rnd in range(args.rounds):
        rec = trainer.run_round(rnd)
        # Publish this round's aggregate.  Round 0 registers the name;
        # later rounds swap — in-flight rows keep their old id's pages.
        if rnd == 0:
            new_id = registry.register("global", trainer.global_state.global_adapters)
        else:
            new_id = registry.swap("global", trainer.global_state.global_adapters)
        log(f"round {rnd}: eval_loss={rec.eval_loss:.4f} "
              f"download_rank={rec.download_rank:.0f} -> published id {new_id}"
              f" (live ids: {registry.live_ids})")

        served_by.update(submit_wave(args.requests_per_round, new_id))
        # Advance without draining: rows from the previous round's version
        # decode next to rows on the one just published.
        outputs.update(eng.run_steps(args.overlap_steps))
        in_flight = sorted({served_by[s.uid] for s in eng.slots
                            if s is not None})
        in_flight_after.append(in_flight)
        log(f"         batch now mixes adapter ids {in_flight} in flight")

    outputs.update(eng.run())
    launches = {k: v - start[k] for k, v in serving_launches().items()}
    for uid in sorted(outputs):
        log(f"  req {uid} [adapter id {served_by[uid]}]: {outputs[uid]}")
    by_id = {i: sum(1 for a in served_by.values() if a == i)
             for i in sorted(set(served_by.values()))}
    log(f"served {len(outputs)} requests across adapter versions {by_id} "
          f"over {args.batch_slots} slots")
    per_step = {k: v / max(eng.steps_run + eng.warmup_steps, 1)
                for k, v in launches.items()}
    log(f"serving-kernel launches per engine step across {args.rounds} "
          f"publishes ({eng.steps_run} steps, {eng.warmup_steps} before "
          f"captures): {per_step}; captures {eng.trace_counts} (hot-swap "
          f"never changes a shape)")
    out = {"outputs": outputs, "served_by": served_by,
           "in_flight": in_flight_after, "launches": launches,
           "all_reduces": eng.tp.all_reduces if eng.tp is not None else 0,
           "all_to_alls": eng.tp.all_to_alls if eng.tp is not None else 0}
    if size > 1:
        return out                       # a rank's record crosses processes
    return dict(out, engine=eng, trainer=trainer, registry=registry)


if __name__ == "__main__":
    main()
