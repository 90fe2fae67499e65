#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no exception is caught):

1. Print the card's name and power limit; build the seven CUDA kernels
   from the sources in the checkout, one ``nvcc`` each, all at once (set-up
   time).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with the tolerance stated beside each comparison;
   ``ring_decode`` also on rings of one and four tiles (one split, no
   merge), at head dims 16, 32 and 128, with n_tokens ragged across rows
   at C 16, and at the edges of each of its four routes (8, 12, 16, 20 and
   64 query rows a KV head); ``mla_ring_decode`` at DeepSeek-V3's latent
   widths (bf16 at C 1 and 16, a window, int8 with per-half scales, fp32);
   ``bgmv`` at the Llama and the MLA projections; ``lora_matmul``,
   ``flash_attention`` and ``adapter_gram`` at the federated round's
   shapes, ragged edges included (``adapter_gram`` also on A stacks read
   where they lie, at the delta route's r 512, twice for equal bits;
   ``flash_attention`` in bf16 also at hd
   16 and 32, T > S, group sizes 1, 2, 3 and 8, windows shorter than a
   tile and longer than S, non-causal); ``wkv6`` at RWKV6-1.6B's prefill
   shape (bf16 and fp32), at strong decay (w = -exp(N(1, 1))) and on a
   ragged sequence, its launch arithmetic held to the built kernel's.  The
   widths the padded tiles opened: ``flash_attention`` and ``ring_decode``
   at head dims 56 and 96 (ring with bf16, fp32 and int8 caches),
   ``mla_ring_decode`` at latent 32 + 16, ``wkv6`` at head dim 32;
   ``lora_matmul`` also at ranks 64 and 128, on its WMMA route (dout
   1003) and at TinyLlama's ``wv`` (2048 → 256) at ranks 4 and 64.  Then
   the two SMOKE configs those widths belong to, end to end through the
   kernels with their launch counts: one ``make_prefill_step(rwkv6_1p6b.SMOKE,
   use_kernels=True)`` call in fp32 (held to the plain route) and in bf16,
   and the ``deepseek_smoke`` engine serving phase 4's traffic, held to its
   plain route as phase 5 does.
3. Each kernel's time (median of 50 launches, CUDA events, L2 flushed
   before each), its bound, its plain version's time and a one-call
   PyTorch yardstick where one exists; ``ring_decode``'s device time by
   kernel at its two main cases (``torch.profiler``: the splits merge in
   the same launch, so one kernel); for ``lora_matmul``, which no one call
   computes, the base product alone (``torch.matmul``) and, at its two
   main shapes, the unfused ``torch.addmm(x W, x Aᵀ, (s·B)ᵀ)``.
4. The serving slice end to end: full-width Llama-3.2-1B (random seeded
   weights, bf16) serving 16 requests over three adapters of ranks 4/8/16
   and the base model, with a mid-flight swap, through
   ``decode_impl="kernel"``, the engine's steps and bursts replayed as
   CUDA graphs; the kernels' launch counts (replays add what each capture
   counted) must equal 16 x (and 16 x 4 x) the engine steps plus the
   steps the graphs' warm-ups ran; profiled windows of decode steps, with
   every row on the base id and with the rows on the live adapters, each
   through ``run_steps`` and as bursts of 8 (phases 2, 8 and 11 as
   well), each window's counted launches equal to the port's kernels its
   replays ran by the profiler trace (the fullest traced replay a call).
5. The engine on the card, kernels against plain versions, at full width in
   fp32 with TF32 off: first prefill step's logits within tolerance, and
   the greedy-token agreement over 16 steps.
6. The federated slice end to end: two FLoRIST rounds of full-width
   Llama-3.2-1B (random seeded weights, bf16; 8 clients of ranks 4/8/16/32,
   4 sampled a round, 4 local steps of 4 × 512 tokens, the Gram SVD route)
   through ``FederatedTrainer``; eval loss, kept ranks, wire bytes, round
   and finalize times, train-step times and tokens/s per round; launch
   counts held to what the code implies; a profiled window of train steps
   and one of FLoRIST finalizes (no copy before an A stack's
   ``adapter_gram``).
7. The federated path on the card in fp32 with TF32 off, at full width and
   4 layers: two train steps on the kernel route against the plain route
   (the first batch's gradients, held to max(1e-4, 4 x each leaf's fp32
   conditioning), loss, adapters, ``scale``), and one FLoRIST finalize on the Gram route
   against the LAPACK route (ranks, spectra, ``B_g A_g``).
8. The MLA serving slice end to end: DeepSeek-V3 at published widths, cut
   to its three dense MLA layers (random seeded weights, bf16), phase 4's
   traffic with adapters on the five MLA targets; ``mla_ring_decode`` must
   run 3 times and ``bgmv`` 12 times (4 targets x 3 layers; ``wkv_b`` is
   folded into the absorbed weights) per engine step; 16 of 16 requests
   with 32 tokens; rates and a profiled window of decode steps.
9. Phase 5 on phase 8's model in fp32 (TF32 off), once with a bf16 and once
   with an int8 latent cache: first-step logits within 5e-3 of max(1,
   |logit|) and the greedy tokens of the kernel and plain engines equal.
10. The RWKV6 prefill end to end: RWKV6-1.6B at published widths (random
    seeded weights, bf16, one rank-16 adapter on its five targets) through
    ``make_prefill_step(use_kernels=True)`` on 8 x 1024 tokens, three
    calls after a warm-up; ``wkv6`` must run 24 and ``lora_matmul`` 120
    times a call; tokens/s and a profiled window.
11. RWKV6 serving end to end: phase 4's traffic on RWKV6-1.6B at
    published widths cut to 6 of its 24 layers, one token per engine
    step; ``bgmv`` must run 30 times per engine step (5 targets x 6
    layers) and ``wkv6`` never; 16 of 16 requests with 32 tokens.
12. RWKV6 in fp32 (TF32 off) at full width: (a) the prefill step's kernel
    route against its plain route, (b) phase 5 on this model, (c) the
    kernel prefill's last logits against ``decode`` fed the same prompt one
    token at a time (registry adapter, ``bgmv``).
13. The paper's five methods (FLoRIST, FedIT, FFA-LoRA, FLoRA, FlexLoRA),
    two rounds each, through ``FederatedTrainer`` on TinyLlama-1.1B at
    published widths, depth cut to 2 of its 22 layers (random seeded
    weights, bf16, built once for the five trainers): LoRA r 16 on
    ``wq``/``wv``, 8 Dirichlet(0.5) clients, 4 a round, 4 local steps of 4
    × 512 tokens, the ``bf16`` wire, FLoRIST on the Gram route.  Launch
    counts (L · 2 · steps ``lora_matmul``, L · (steps + 1) ``flash_attention``, 2 ·
    buckets ``adapter_gram`` for FLoRIST and none for the others), wire
    bytes equal to 2 × the analytic counts, each method's kept ranks,
    FFA's frozen A bit for bit, FLoRA's merge and re-init, finite losses;
    (b) every finalize in fp32 on the card against the CPU (products
    within 1e-4 · max(1, |ΔW|)); the Table 4 counterpart's device times.
    Phase 2 holds ``lora_matmul`` (2048 → 256) and ``flash_attention``
    (32 H / 4 KV) at this path's shapes.
14. The paper's evaluation at full width, through the port's own modules
    (``repro_torch.benchmarks``, each module's ``bench_fed`` replaced by a
    recorder that is ``bench_trainer`` plus the same rounds) on
    TinyLlama-1.1B at published widths, depth cut to 2 of its 22 layers
    (random seeded weights, bf16, built once), LoRA on ``wq``/``wv``, 4 local steps of 4
    × 512 tokens, the bench's 20 clients (5 a round) and rank mix
    ``((4, 8), (8, 4), (16, 4), (32, 2), (64, 2))``, τ 0.9, the ``fp32``
    wire, the ``svd`` route: (a) Table 2's heterogeneous arm, two rounds
    of each method (FedIT and FFA zero-padded): finite losses, FLoRIST's
    ranks in [1, Σ r_k], FedIT's and FFA's the round's largest client
    rank, bytes exactly 4 × the analytic counts and the upload 6,400 · L ·
    Σ r_k parameters (B alone for FFA), exact ``lora_matmul`` and
    ``flash_attention`` launches; per round wall, finalize, median step
    (by client rank), kept and download ranks; and FLoRIST's finalize at
    the mix's widest round (Σ r_k 208); (b) Fig 6 (the same call as (a)'s
    FLoRIST row), Fig 2 (one round at τ 1.0), Fig 5 (two rounds at each
    τ, homogeneous rank 8); (c) Table 2's rows at the bench's own config
    (fp32, both arms, one round since phase 24) on the card against the
    CPU: names,
    kept and download ranks and ``most_efficient`` equal, losses within
    1e-4 · max(1, |loss|); (d) ``agg_bench`` at its non-smoke shape, the
    Gram rows' ``adapter_gram`` launches exact; (e) the quickstart and
    serve-federated examples: every request served, both adapter versions
    in flight after the swap, ``ring_decode`` and ``bgmv`` once a layer
    (a target) an engine step.  Phase 2 also holds ``lora_matmul`` at
    TinyLlama's ``wv`` at this phase's smallest and largest client ranks.
15. The engine's graphs, the streamed route and the benches: (a) phase 4's
    traffic twice (a swap in each, one sampled request) on the graphed
    engine and on the same built step functions run uncaptured, on
    Llama-3.2-1B and on DeepSeek-V3-dense3: every
    request's tokens equal bit for bit, launches exact, captures unchanged
    by the second pass and its swap; (b) ``decode_impl="streamed"``
    against the dense route in fp32 (TF32 off) on Llama-3.2-1B and
    DeepSeek-V3-dense3, fp32 caches at 1e-3 and int8 caches at 5e-3 of
    max(1, |logit|) (Llama's int8 streamed route against the kernel
    route, which dequantizes in fp32 as it does); (c) the decode windows
    of phases 4, 8 and 11 side by side (wall, device busy, idle share a
    step, through ``run_steps`` and as bursts) beside the numbers from
    before the graphs; (d) ``kernel_bench`` and ``serve_bench`` at their
    defaults.
16. The federated runtime: (a) ``lora_matmul`` with a client axis (x (C,
    M, din), A (C, r, din), s·B (C, dout, r), W shared) in one launch
    against its plain version (a per-client loop) at TinyLlama's ``wq`` and
    ``wv``, C 4, M 2048, bf16 and fp32, a ragged C 3, M 200 and the wmma
    route, each timed beside its whole-cohort bound and the same work as
    C launches of C = 1, and ``flash_attention`` at the cohort step's
    batch of 16; then on TinyLlama-1.1B at published widths, depth cut
    to 2 of its 22 layers (phase 13's setup: 8 clients of rank 16, 4 a round, 4
    local steps of 4 × 512 tokens, wq/wv, the bf16 wire): (b) two FLoRIST
    rounds with ``sequential`` and with ``cohort``, the cohort's train-step
    ``lora_matmul`` and ``flash_attention`` launches exactly 1/4 of the
    sequential's, round walls, step medians and a profiled window of each
    runner's step; (d) one round of each scheduler (``sync``,
    ``partial``, ``async``, ``sampled``) and of the ``resource`` rank
    policy under ``cohort`` (2 local steps), one cohort step call a local
    step of each cohort, powers-of-two ranks; (e) two rounds on the hardened wire
    (``int8``, DP at clip 1.0 and σ for ε 8, gate ``full``, drop /
    corrupt / duplicate / NaN / scale faults at 0.2 each) and one without
    DP in which the gate must quarantine a scale-poisoned client, the
    record's retries, dead clients, rejections, quarantines and wire bytes
    and the folded weights equal to those worked out from the fault plan,
    the kept ranks and the int8 byte count; (f) a crash at
    ``mid_round`` of round 1 and a resume from the checkpoint, the history
    and global adapters bit-identical to the uninterrupted run; (c) at 2
    layers in fp32 (TF32 off), cohort against sequential (ΔW within 5e-4,
    eval loss within 1e-4, each client's adapters within 5e-4); (g)
    ``fed_bench``'s runner × scheduler arm and ``federated_finetune``'s
    tiny profile.
17. The four Qwen configs (``launch.serve``'s ``qwen2_0p5b``, ``qwen3_4b``,
    ``qwen2p5_14b_l8``, ``qwen1p5_32b_l4``; random seeded weights, bf16):
    (a) each at published widths serves phase 4's traffic through
    ``decode_impl="kernel"`` on the graphed engine, adapters on ``wq wk wv
    wo`` and a swap, launches exact (``ring_decode`` L and ``bgmv`` 4 · L
    an engine step), 16 of 16 requests, and a profiled burst window on
    live-adapter rows; Qwen2-0.5B at full depth, Qwen3-4B at 12 of its 36,
    Qwen2.5-14B cut to 8 of its 48 layers and Qwen1.5-32B to 4 of its
    64; (b) phase 5 on each at 2 layers and full width in fp32 (TF32
    off), the greedy tokens required equal (``qkv_bias`` and ``qk_norm``
    on the kernel route); (c) ``repro_torch.examples.serve_batch`` at its
    defaults and with ``--decode-impl kernel --int8-cache``.  Phase 2
    holds ``ring_decode`` at groups 7 and 5 (C 1 and 16, bf16 and int8)
    and MHA at hd 128, ``bgmv`` at din 896 / 2560 / 4096 / 5120,
    ``lora_matmul`` at the Qwen projections and ``flash_attention`` at
    the Qwen heads.
18. The single-client trainer: (a) ``Trainer(use_kernels=True)`` on
    Qwen2-0.5B at published widths and full depth, 6 steps of 4 × 512
    tokens, eval and checkpoint every 3, launches exact (``lora_matmul``
    96 and ``flash_attention`` 24 a forward), a second trainer's
    ``restore_ckpt`` bit-equal, the median step, tokens/s and a profiled
    window; (b) ``python -m repro_torch.launch.train --arch qwen2-0.5b
    --steps 4 --use-kernels`` as a subprocess, exit 0 and a finite final
    eval; (c) at 2 layers and full width in fp32 (TF32 off), two train
    steps on the kernel route against the plain route (phase 7's limits).
19. RWKV6 training: (a) two FLoRIST rounds of RWKV6-1.6B at published
    widths, cut to 3 of its 24 layers, through ``FederatedTrainer``
    (sequential runner; rank 16 on its five targets, 4 of 8 clients a
    round, 2 local steps of 2 × 256 tokens, the Gram route): the train
    steps' recurrence through ``wkv_scan``
    (``models.rwkv.recurrence_route``), so ``wkv6`` launches 6 a round
    (the eval forward) and never in a train step, ``lora_matmul`` 30 a
    train forward, ``adapter_gram`` 2 · buckets;
    kept ranks, round wall, step median, peak allocated memory and a
    profiled train step; (b) at 2 layers and full width in fp32 (TF32
    off), the train step's kernel route against its plain route (phase
    7's limits) and the cohort runner against the sequential one (phase
    16 (c)'s limits).

20. MoE and MLA's full-sequence path (random seeded weights, bf16): (a)
    granite-moe-1b-a400m at published widths cut to 6 of its 24 layers
    (d 1024, 16 H / 8 KV, 32 experts top-8, e_ff 512) serves phase 4's
    traffic on the graphed engine (``ring_decode`` 6 and ``bgmv`` 24 an
    engine step, 16 of 16 requests, a profiled burst window on live
    adapters), and its graphed tokens equal its uncaptured tokens bit for
    bit (phase 15 (a)'s check); (b) DeepSeek-V3-L4 (the three dense MLA
    layers and the first MoE layer, 256 experts top-8 and a shared one, at
    published widths) serves the same traffic (``mla_ring_decode`` 4 and
    ``bgmv`` 16 a step), peak memory printed; (c) one granite MoE layer
    on the card against the CPU in fp32 (TF32 off), capacity factor 1.25
    on inputs skewed toward one expert (tokens dropped) and 8.0 (none):
    the same experts and slots kept for every token, outputs within 1e-5 ·
    max(1, |y|), aux within 1e-6; (d) FLoRIST through ``FederatedTrainer``:
    granite at 6 of 24 layers (2 rounds, cohort runner, 4 of 8 clients of
    rank 16, 2 local steps of 4 × 512) and DeepSeek-V3-L4 (1 round,
    sequential runner, 2 of 4 clients, 2 local steps of 4 × 512, LoRA on
    the five MLA targets): launches exact (granite ``lora_matmul`` 24 and
    ``flash_attention`` 6 a forward, DeepSeek ``lora_matmul`` 16 and no
    ``flash_attention``, ``adapter_gram`` 2 a stacked shape), every
    ``lora_matmul`` (C, din, dout) and ``adapter_gram`` (G, m, r, layout)
    the rounds launch one that phases 2/3 and 16 (a) held to its plain
    version, finite losses and aux, kept ranks in [1, Σ r_k], step
    medians, peak memory and a profiled step of each; ``make_prefill_step(use_kernels=True)`` on
    DeepSeek-V3-L4; (e) at 2 layers and full width in fp32 (TF32 off), the
    train step's kernel route against its plain route on granite and on
    the DENSE3 cut (through ``mla_fwd``), phase 7's limits.  Phase 2 holds
    ``ring_decode`` at 16 / 8, ``bgmv`` at 1024 → 1024 / 512 and 7168 →
    1536, ``lora_matmul`` at granite's and MLA's projections and
    ``flash_attention`` at 16 / 8 (B 4 and 16), ``adapter_gram`` at every
    Gram stack of (d) (``GRAM_MOE``); phase 16 (a) ``lora_matmul``'s client
    axis at granite's projections (C 4).
21. The vision and audio front ends and the Mamba2 hybrid (random seeded
    weights, bf16, published widths; phi-3-vision and musicgen cut in depth,
    below): (a) phi-3-vision-4.2b
    (32 L, d 3072, 32 H / 32 KV, hd 96) serves phase 4's traffic on the
    graphed engine (``ring_decode`` L and ``bgmv`` 4 L an engine step, 16
    of 16 requests, a profiled burst window on live adapters), its graphed
    tokens equal its uncaptured tokens bit for bit, and
    ``make_train_step(use_kernels=True)`` takes 2 steps on a vision batch
    shaped as ``launch/specs.input_specs`` shapes one (4 rows of 576 patch
    embeds of 1024 and 448 text tokens): ``lora_matmul`` 4 L and
    ``flash_attention`` L a forward, the loss finite and over the text
    tail only (the CE's token count), step times, idle share, peak
    allocated; (b) musicgen-medium (48 L, d 1536, 24 / 24, vocab 2048)
    serves the same traffic on codebook-token prompts (``ring_decode`` L,
    ``bgmv`` 4 L a step) and trains 2 steps on an audio batch (4 × 512
    frame embeds, labels, no tokens; ``lora_matmul`` 4 L and
    ``flash_attention`` L a forward); (c) zamba2-1.2b (38 Mamba2 layers,
    d 2048, state 64, the shared attention block applied 6 times) serves
    the traffic one token a step (``ring_decode`` 6 and ``bgmv`` 100 a
    step, graphed tokens equal uncaptured), trains two FLoRIST rounds
    through ``FederatedTrainer`` (cohort runner, 4 of 8 clients of rank
    16, 2 local steps of 4 × 512, LoRA on the six hybrid targets:
    ``lora_matmul`` 100 and ``flash_attention`` 6 a forward,
    ``adapter_gram`` 2 a stacked shape, every launched shape one that
    phases 2/3 and 16 (a) check, ranks in [1, Σ r_k], finite losses, step
    median, idle share, peak) and prefills 2 × 512 through
    ``make_prefill_step(use_kernels=True)``; (d) one Mamba2 layer at
    published widths on the card against the CPU in fp32 (TF32 off): the
    forward on 512 tokens (two SSD chunks) and 16 decode steps with a
    masked row, within 1e-4 · max(1, |y|); (e) at full width in fp32 the
    train step's kernel route against its plain route (phase 7's limits)
    on phi-3-vision and musicgen cut to 2 layers (with patches, with
    frames) and zamba2 cut to 4 layers at ``attn_every`` 2, and zamba2's
    16-token decode against its forward within 2e-4 relative.  Phase 2
    holds ``ring_decode`` at 24 / 24 and 32 / 32 hd 64 (32 / 32 hd 96 was
    there), ``bgmv`` at 3072, 1536, 2048 → 8384 and 4096 → 2048,
    ``lora_matmul`` at the three models' projections (phase 16 (a) the
    client axis at zamba2's), ``flash_attention`` at each model's heads
    and batches, ``adapter_gram`` at every Gram stack of (c)
    (``GRAM_HYBRID``).
22. The multi-device path (``repro_torch.topology``, ``ServeEngine(mesh=
    ...)``, ``sharded_cohort``, ``florist_sharded``).  The card is one
    device and NCCL refuses two ranks on one GPU, so the sharded paths run
    as a gloo world of 2 ranks spawned on cuda:0 (``topology.spawn``; gloo
    carries the collectives through the host, every kernel runs on the
    card at its shard's shape, and a rank's exception fails the script).
    (a) Llama-3.2-1B at 4 of its 16 layers (``P22_LLAMA_LAYERS``), bf16,
    tensor-parallel on a serve mesh of 2 with phase 4's traffic, steps
    uncaptured: 16 of 16 requests on
    each rank with the same tokens, ``ring_decode`` L a step at 16 / 4
    heads and ``bgmv`` 4 L a step at the shard widths (``BGMV_SHARD``),
    each rank's pools half of each target's sharded factor, 2 L
    ``all_reduce``s a step and their host time.  (b) fp32, TF32 off, 2
    layers: the mesh-2 kernel engine's first prefill step's logits within
    1e-3 of max(1, |logit|) of the mesh-less engine's on the card and its
    greedy tokens equal over 16 steps; then DeepSeek-V3-dense3 on the
    world with phase 8's traffic (``mla_ring_decode`` 3 a step a rank at
    64 heads).  (c) NCCL at world 1: an ``all_reduce`` on the card, and the
    mesh-1 engine's tokens equal the mesh-less engine's bit for bit (Llama
    cut to 2 layers, graphed).  (d) TinyLlama at ``TINY_LAYERS``, fp32 (TF32
    off), 8 clients of rank 16, 4 a round, 4 steps of 4 × 512, Gram route,
    2 rounds: ``sharded_cohort`` + ``florist_sharded`` on the world against
    one-process ``cohort`` + ``florist``: eval loss within 2e-4, kept ranks
    equal, ΔW within 2e-3, the global adapters equal bit for bit across
    ranks, each rank's launches equal to the one-process run's and every
    ``lora_matmul`` / ``adapter_gram`` shape one that phase 2/3 checks;
    then the same world runs the cohort phases' bf16 (bf16 wire): each
    rank's launches equal to its fp32 run's, the same shapes, finite
    losses, and histories, kept ranks and global adapters equal across
    ranks.
    Phase 2 holds each kernel at those shard shapes: ``ring_decode`` at 16
    / 4, ``bgmv`` at ``BGMV_SHARD`` and ``BGMV_MLA_SHARD``,
    ``mla_ring_decode`` at 64 heads, ``lora_matmul`` at C 2
    (``LORA_SHARD_SHAPES``), ``flash_attention`` at B 8 and
    ``adapter_gram`` at one rank's layer slice (``GRAM_SHARD``).
23. Tensor-parallel serving of every other family, on one spawned gloo
    world of 2 ranks on cuda:0 (as phase 22): (a) granite-moe-1b-a400m
    (16 of 32 experts a rank), (b) DeepSeek-V3-L4 (128 of 256 experts a
    rank, drawn only by their rank; the shared expert split), (c)
    RWKV6-1.6B, (d) zamba2-1.2b (Mamba2's fused leaves cut segment by
    segment), (e) phi-3-vision-4.2b and musicgen-medium, at published
    widths (depths ``P23_SERVE``), bf16, each serving 8 requests of
    32-128 prompt and 16 new tokens on the base id and adapters of ranks 4
    and 8 with a mid-flight ``swap``, chunk 16, the kernel routes, steps
    uncaptured: 8 of 8 requests on each rank with equal tokens, the
    launches exact at the shard shapes (``RING_FAMILY_SHARD``,
    ``BGMV_FAMILY_SHARD``, MLA's 64 heads; every launched shape one phase
    2/3 checks), the ``all_reduce`` and ``all_to_all`` counts of every
    step as its layers call for (a MoE layer's two ``all_to_all``s in a
    chunk step, one ``all_reduce`` in a width-1 step), each rank's bytes
    of params, pools and cache those its specs give it; the decode-step
    wall and the collectives' host time are printed.  (f) fp32, TF32 off,
    at ``P23_PARITY_LAYERS``: the mesh-2 kernel engine against the
    mesh-less one in this process (a MoE model's chunks routed there slice
    by slice, as the reference's ``_moe_fwd_sharded``: ``sliced_moe``),
    first-step logits within 1e-3 of max(1, |logit|) and greedy tokens
    equal over 16 steps; for (a) and (b) one expert-parallel chunk
    through the first MoE layer against ``moe_fwd`` on each sequence
    slice within 1e-5 of max(1, |y|).
24. Training with a ``model`` axis (``make_train_step`` /
    ``make_eval_step`` / ``make_prefill_step(mesh=)``; ZeRO-3 over
    ``data``), random seeded weights, each rank drawing only its shards
    (``T.init(..., keep=init_keep(...))``), adapters r 16 on
    ``lora_targets`` with B ≠ 0, 512-token rows with ragged masks, every
    run's one-process side first in this process, then a gloo world of 2
    on cuda:0 for (a)-(c), (e) and one of 4 for (d): (a) Llama-3.2-1B, 16
    layers, mesh (data=1, model=2), bf16, the kernel routes
    (head-parallel), 2 train steps of 2 x 512 and an eval; (b) the same at
    2 layers in fp32 (TF32 off) on both routes, with the prefill; (c)
    DeepSeek-V3-dense3 (``mla_absorbed``'s sequence-parallel branch) as
    (a), and at 1 layer as (b); (d) Qwen2-0.5B at ``P24_QWEN_LAYERS`` = 4
    of 24 layers on (data=1, model=4) (2 KV heads: ``dispatch_flash``'s
    sequence-parallel branch on the plain route, q/k/v gathered on the
    kernel route) in fp32 on the plain route and one bf16 step of the
    kernel route; (e) Qwen2.5-14B whole (48 layers, 14.77 B parameters,
    above ``ZERO3_THRESHOLD``) on (data=2, model=1), 1 x 512 a rank, bf16,
    the kernels, 1 step.  Checks: the adapters bit-equal on every rank
    after each step; fp32: the loss within 1e-5 of the one-process step's,
    every adapter leaf's gradient within 1e-4 · max(1, max |g|), the
    prefill's whole (B, V) logits on every rank within 1e-4 of max(1,
    |logit|); bf16: the loss within 2e-3 of max(1, |loss|), every leaf's
    gradient (and all of them as one vector) within max(0.15, 4 x its own
    bf16 conditioning) (max(0.05, ...)) in relative L2, the adapters' mean
    |Δ| within 0.25·lr after each step (:func:`train_compare` gives the
    reasons); the launches a step exact (``lora_matmul`` 4 L, and
    ``flash_attention`` L for GQA, a forward) at shapes phase 2/3 holds to
    their plain versions (``LORA_TRAIN_SHARD``, ``FLASH_TRAIN_SHARD``);
    the collectives a step, the eval's and the prefill's as
    ``topology.train.step_collectives`` counts them; each rank's param
    bytes its specs' share, (e)'s ranks half of every ``_COL`` / ``_ROW``
    weight; step times (CUDA events), the collectives' host time and peak
    memory are printed.
25. Training with a ``model`` axis for every other family, as phase 24
    (the same generalized sides, :func:`train_compare`'s checks and
    limits), each rank drawing only its shards (a MoE layer only its
    experts, ``train_experts``; Mamba2's fused leaves segment by segment,
    ``train_pspecs``), r 16 on ``lora_targets``, 512-token rows with ragged
    masks: (a) granite-moe-1b-a400m at 4 of its 24 layers on a gloo world
    of 4 meshed (data=2, model=2), its 32 experts 8 a rank over
    ``("data", "model")``, two bf16 kernel-route steps of 1 x 512 a rank,
    an eval and a prefill; (b) DeepSeek-V3-L4 (3 dense MLA layers and the
    first MoE layer, 128 of 256 experts a rank) on (data=1, model=2), one
    bf16 step of 2 x 512, its peak allocated a rank printed; (c)
    RWKV6-1.6B at 2 of 24 layers, one bf16 step through ``wkv_scan``, an
    eval and a prefill through ``wkv6`` on 16 heads a rank; (d)
    zamba2-1.2b at 6 of 38 layers (one shared-block application); (e)
    phi-3-vision-4.2b at 4 of 32 layers on a vision batch of 2 x (576
    patch embeddings + 448 tokens) and musicgen-medium at 6 of 48 on frame
    embeddings; (b)-(e) on a gloo world of 2, (data=1, model=2), each an
    eval and a prefill with its step but (b).  Each model also at 2 layers
    (zamba2 6) in fp32 (TF32 off) on both routes with the prefill
    (DeepSeek-V3 on one row).  A MoE model runs at the published capacity
    factor 1.25 in bf16 (its slabs drop picks) and at E / k in fp32, which
    drops nothing (:func:`p25_cfg` gives the reason).  The one-process
    side of a MoE model routes each (data, model) slab on its own
    (:func:`slab_moe`: the reference's ``_moe_fwd_sharded``).  Checks as
    phase 24's: the adapters bit-equal on every rank, fp32 loss 1e-5,
    gradients 1e-4 · max(1, max |g|), prefill logits 1e-4 · max(1,
    |logit|), bf16 phase 24's limits, the launches of each step, eval and
    prefill exact (:func:`train_launches`; ``wkv6`` only outside a train
    step) at shapes phase 2/3 holds to their plain versions
    (``LORA_FAMILY_TRAIN``, in fp32 ``LORA_FAMILY_TRAIN_FP32``,
    ``FLASH_FAMILY_TRAIN``, ``WKV6_FAMILY_TRAIN``),
    the collectives as ``step_collectives`` counts them (the experts'
    exchanges over ``("data", "model")``), each rank's bytes its specs'
    share.

Depth cuts to keep the whole script inside its time: phases 13, 14 and 16
run TinyLlama-1.1B at 2 of its 22 layers (``TINY_LAYERS``; full width),
phase 13 (b)'s client trees too; phase 17 cuts Qwen2.5-14B to 8 layers and
Qwen1.5-32B to 4; phase 20 cuts DeepSeek-V3 to 4 of its 61 layers
(``deepseek_v3_671b.L4``, 28.1 GB of bf16 weights).  To pay for phase 21
(287.6 s on an H100 80GB HBM3 at 700 W with zamba2's graphed-vs-uncaptured
pass at 38 layers): phase 11 served RWKV6-1.6B at 12 of its 24
layers (``RWKV_SERVE_LAYERS``; its prefill keeps 24), phase 19 trained
it at 6 (``RWKV_TRAIN_LAYERS``, 12 before), phase 20 (a) and (d) run
granite-moe at 12 of its 24 (``GRANITE_LAYERS``; 6 since phase 24),
phase 21 (c) holds
zamba2's graphed tokens to its uncaptured ones at 6 of its 38 layers
(``ZAMBA2_GRAPH_LAYERS``: one shared application, 12 before phase 23; its
serving, launches and window stay at 38).  To pay for phase 22 (the script took 1242.7 s
from the build on with it, on an H100 80GB HBM3 at 700 W whose host ran
phase 21 in 277.5 s): phase 21 (a) serves and trains phi-3-vision at 8 of
its 32 layers (``PHI3_LAYERS``; 4 since phase 24) and (b) musicgen at 12
of its 48 (``MUSICGEN_LAYERS``; 6 since phase 24), phase 15 (d) runs ``serve_bench``'s mesh axis at
mesh 1 only (phase 22 serves on a world of 2), and each kernel time is
the median of ``REPS`` = 20 launches (50 and then 30 before; 10 since
phase 24).  Phase 23
serves granite-moe, RWKV6, phi-3-vision and musicgen at 2 of their
layers and zamba2 at 6 (one shared-block application), and checks (f)
at 2 layers (zamba2 6; DeepSeek-V3 one dense MLA and one MoE layer): a
gloo step of two ranks on one card costs milliseconds a collective.  To
pay for phase 23 (the script took 1127.0 s from the build on with it, on
an H100 80GB HBM3 at 700 W whose host ran phase 21 in 149.8 s): phase 21
(c)'s graph pass went from 12 to 6 layers, phase 22 (a) to Llama at 8 of
its 16 layers and phase 23's serving from 4 to 2 layers (1121.2 s on a
slower host, the build 85.3 s), then phase 22 (a) to 4 layers
(``P22_LLAMA_LAYERS``), phase 11's RWKV6 serving to 6 of its 24 and
phase 19's training to 3.  To pay for phase 24 (163.8 s alone on an
H100 80GB HBM3 at 700 W before the pinned staging; its ZeRO-3 step's 672
weight gathers through the host take most of it): phase 14 (c) runs
Table 2's bench parity for ``BENCH_PARITY_ROUNDS`` = 1 round (2 before),
each kernel time is the median of ``REPS`` = 10 launches, phase 17
serves Qwen3-4B
at ``QWEN3_LAYERS`` = 12 of its 36 layers, phase 20 runs granite-moe at
6 of its 24 (``GRANITE_LAYERS``), phase 21 phi-3-vision at 4 of 32 and
musicgen at 6 of 48, and the gloo collectives stage through pinned host
memory (``topology.mesh``).  Phase 25 came with no cut (the script took
841.7 s from the build on with it, on an H100 80GB HBM3 at 700 W).
Each phase's seconds are printed (``[phase N: s]``) and kept in the
JSON.

It fails without a CUDA device, and in a directory that lacks the port's
sources.  Details go to ``chiprun_out/chip_smoke.json``.
"""
import collections
import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "int8": 1979e12}
REPS = 10
DEVICE = "cuda"
CARD = "the card"                # nvidia-smi's name and power limit, set by main
# the CUDA kernels of src/repro_torch/kernels/csrc, by function name
PORT_KERNELS = (r"\b(ring_decode_kernel|mla_ring_decode_(kernel|wgmma)|mla_merge_splits|"
                r"bgmv_kernel|"
                r"lora_matmul_(wgmma|wmma|f32)|flash_(bf16|f32)|gram_mma|wkv6_kernel)\b")
# the same kernels by the ops wrapper whose counter counts them
KERNELS_OF = {
    "ring_decode": r"\bring_decode_kernel\b",
    "mla_ring_decode": r"\b(mla_ring_decode_(kernel|wgmma)|mla_merge_splits)\b",
    "bgmv": r"\bbgmv_kernel\b",
    "lora_matmul": r"\blora_matmul_(wgmma|wmma|f32)\b",
    "flash_attention": r"\bflash_(bf16|f32)\b",
    "adapter_gram": r"\bgram_mma\b",
    "wkv6": r"\bwkv6_kernel\b",
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


# depth cuts that pay for the later phases (the docstring's last paragraph)
RWKV_SERVE_LAYERS = 6            # phase 11: RWKV6-1.6B served at 6 of 24
GRANITE_LAYERS = 6               # phase 20 (a), (d): granite-moe at 6 of 24
ZAMBA2_GRAPH_LAYERS = 6          # phase 21 (c)'s graphed-vs-uncaptured pass
P22_LLAMA_LAYERS = 4             # phase 22 (a): Llama-3.2-1B at 4 of 16 layers
PHI3_LAYERS = 4                  # phase 21 (a): phi-3-vision at 4 of 32 layers
MUSICGEN_LAYERS = 6              # phase 21 (b): musicgen at 6 of 48 layers
QWEN3_LAYERS = 12                # phase 17 (a): Qwen3-4B at 12 of 36 layers


CUT_OF = {}                      # a cut config's key -> the key it cuts


def cut_config(key: str, layers: int) -> str:
    """The key of ``launch.serve.CONFIGS[key]`` cut to its first ``layers``
    layers (its ring, chunk and prompts kept), registered under
    ``f"{key}_l{layers}"``."""
    from repro_torch.launch.serve import CONFIGS
    cut = f"{key}_l{layers}"
    cfg, *rest = CONFIGS[key]
    CONFIGS[cut] = (cfg.replace(num_layers=layers), *rest)
    CUT_OF[cut] = key
    return cut


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({ROOT}/src)")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)                       # card name and power limit, as nvidia-smi gives them
    global CARD
    CARD = smi
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"phase 1 build (set-up): {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(logs)) or 'cached'})")
    ptxas = {}
    for name, log in sorted(logs.items()):
        regs = [int(w.split()[-1]) for w in re.findall(r"Used \d+", log)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill", log))
        ptxas[name] = {"kernels": len(regs), "max_registers": max(regs),
                       "spill_bytes": spills}
        print(f"  ptxas[{name}]: {len(regs)} kernels, at most {max(regs)} "
              f"registers per thread, {spills} bytes spilled")

    phase_s = {"1": time.perf_counter() - t0}
    mark = [time.perf_counter()]

    def done(phase: str) -> None:
        """Print and keep the seconds since the last phase ended."""
        now = time.perf_counter()
        phase_s[phase] = now - mark[0]
        mark[0] = now
        print(f"[phase {phase}: {phase_s[phase]:.1f} s]")

    report = {"card": smi, "ptxas": ptxas, "gpu_ms_floor": gpu_floor(torch)}
    report["kernel_cases"] = (kernel_cases(torch) + bgmv_kernel_cases(torch)
                              + mla_kernel_cases(torch)
                              + train_kernel_cases(torch)
                              + cohort_kernel_cases(torch)
                              + wkv6_kernel_cases(torch)
                              + train_shard_kernel_cases(torch)
                              + family_train_kernel_cases(torch))
    report["smoke_widths"] = smoke_widths(torch)
    done("2/3")
    report["e2e"], counts = end_to_end(torch)
    done("4")
    report["parity"] = engine_parity(torch)
    done("5")
    report["federated"], fed_counts = federated_round(torch)
    done("6")
    report["fed_parity"] = federated_parity(torch)
    done("7")
    counts.update(fed_counts)
    report["mla_e2e"], mla_counts = end_to_end(torch, "8", "deepseek_v3_dense3")
    done("8")
    # fp32, TF32 off; the routes sum in another order, so layer 1's output
    # differs by ~1e-7 of itself, and that flips the rounding of a few
    # latent elements that layers 2 and 3 write to a bf16 or int8 cache (a
    # flip moves an element by one bf16 ulp, 2^-8 of it, or one int8 step,
    # 1/127 of its half-row's absmax).  At reduced width on the CPU this
    # moves logits of max ~4.5 by 5.5e-4 (bf16) and 2.3e-3 (int8), against
    # 4.9e-6 with an fp32 cache (at full width on an H100: 1.9e-3 and
    # 1.6e-3 to 5.6e-3, logits of max ~5.2); a wrong mask, scale or row
    # moves them by O(0.1-1).  Limit 5e-3 of max(1, |logit|).
    report["mla_parity"] = engine_parity(
        torch, "9", "deepseek_v3_dense3", ("bfloat16", "int8"), 5e-3,
        require_equal=True)
    done("9")
    counts["mla_ring_decode"] = mla_counts["mla_ring_decode"]
    report["rwkv_prefill"], rwkv_counts = rwkv_prefill(torch)
    done("10")
    counts["wkv6"] = rwkv_counts["wkv6"]
    report["rwkv_e2e"], rwkv_serve_counts = end_to_end(
        torch, "11", cut_config("rwkv6_1p6b", RWKV_SERVE_LAYERS), full_layers=24)
    done("11")
    report["rwkv_parity"] = rwkv_parity(torch)
    done("12")
    report["tinyllama"], tiny_counts = tinyllama_methods(torch)
    done("13")
    report["paper_eval"], eval_counts = paper_evaluation(torch)
    done("14")
    report["phase15"] = phase15(torch, report)
    done("15")
    report["phase16"], cohort_counts = phase16(torch)
    done("16")
    report["qwen"], qwen_counts = phase17(torch)
    done("17")
    report["trainer"], trainer_counts = phase18(torch)
    done("18")
    report["rwkv_train"], rwkv_train_counts = phase19(torch)
    done("19")
    report["moe"], moe_counts = phase20(torch)
    done("20")
    report["phase21"], p21_counts = phase21(torch)
    done("21")
    report["phase22"], p22_counts = phase22(torch)
    done("22")
    report["phase23"], p23_counts = phase23(torch)
    done("23")
    report["phase24"], p24_counts = phase24(torch)
    done("24")
    report["phase25"], p25_counts = phase25(torch)
    done("25")

    def case_rec(name, case):
        return next(r for r in report["kernel_cases"]
                    if r["name"] == name and r["case"] == case)

    def other_path(key, name, case):
        """The case at another path's shape, beside that path's launches."""
        rec = case_rec(name, case)
        return {f"{key}_case": case, f"{key}_max_abs_err": rec["max_abs_err"],
                f"{key}_ms": rec["ms"], f"{key}_bound_ms": rec["bound_ms"]} | {
                    f"{key}_{k}": rec[k] for k in LORA_EXTRA if k in rec}

    kernels = []
    for name, case in (("ring_decode", RING_MAIN),
                       ("mla_ring_decode", MLA_MAIN),
                       ("bgmv", BGMV_MAIN),
                       ("lora_matmul", LORA_MAIN),
                       ("flash_attention", FLASH_MAIN),
                       ("adapter_gram", GRAM_MAIN),
                       ("wkv6", WKV6_MAIN)):
        rec = case_rec(name, case)
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "case")}
            | {"launches": counts[name]}
            | ({"library": rec["library"]} if "library" in rec else {})
            | {k: rec[k] for k in LORA_EXTRA if k in rec}
            | ({"launches_mla_path": mla_counts["bgmv"],
                "launches_rwkv_path": rwkv_serve_counts["bgmv"]}
               | other_path("rwkv_path", "bgmv", BGMV_RWKV)
               if name == "bgmv" else {})
            | ({"launches_rwkv_prefill": rwkv_counts["lora_matmul"]}
               | other_path("rwkv_prefill", "lora_matmul", LORA_RWKV)
               if name == "lora_matmul" else {})
            | (other_path("a_stack", "adapter_gram", GRAM_A)
               if name == "adapter_gram" else {})
            | ({"launches_tinyllama_path": tiny_counts[name]}
               if name in tiny_counts else {})
            | ({"launches_paper_eval_path": eval_counts[name]}
               if name in eval_counts else {})
            | (other_path("tinyllama_path", name, LORA_TINY)
               | other_path("tinyllama_r4", name, LORA_TINY_R4)
               | other_path("tinyllama_r64", name, LORA_TINY_R64)
               if name == "lora_matmul" else {})
            | (other_path("tinyllama_path", name, FLASH_TINY)
               | other_path("cohort", name, FLASH_COHORT)
               if name == "flash_attention" else {})
            | ({"launches_cohort_path": cohort_counts[name]}
               if name in cohort_counts else {})
            | (other_path("cohort", name, LORA_COHORT)
               | other_path("cohort_wv", name, LORA_COHORT_WV)
               | {"cohort_c1_launches_ms": case_rec(name, LORA_COHORT)["c1_launches_ms"],
                  "cohort_wv_c1_launches_ms":
                      case_rec(name, LORA_COHORT_WV)["c1_launches_ms"]}
               if name == "lora_matmul" else {})
            | ({"launches_qwen_path": qwen_counts[name]}
               if name in qwen_counts else {})
            | ({"launches_trainer_path": trainer_counts[name]}
               | other_path("trainer_path", name, LORA_TRAINER
                            if name == "lora_matmul" else FLASH_TRAINER)
               if name in trainer_counts else {})
            | ({"launches_rwkv_train_path": rwkv_train_counts[name]}
               if name in rwkv_train_counts else {})
            | ({"launches_moe_path": moe_counts[name]}
               if name in moe_counts else {})
            | (other_path("granite_path", name, LORA_GRANITE)
               | other_path("granite_cohort", name, LORA_GRANITE_COHORT)
               | other_path("mla_path", name, LORA_MLA)
               if name == "lora_matmul" else {})
            | (other_path("granite_path", name, GRAM_GRANITE)
               | other_path("dsv3_path", name, GRAM_DSV3)
               if name == "adapter_gram" else {})
            | ({"launches_phase21_path": p21_counts[name]}
               if name in p21_counts else {})
            | (other_path("phi3_path", name, LORA_PHI3)
               | other_path("zamba2_path", name, LORA_ZAMBA2)
               if name == "lora_matmul" else {})
            | (other_path("phi3_path", name, FLASH_PHI3)
               if name == "flash_attention" else {})
            | (other_path("zamba2_path", name, RING_ZAMBA2)
               if name == "ring_decode" else {})
            | (other_path("zamba2_path", name, BGMV_ZAMBA2)
               if name == "bgmv" else {})
            | (other_path("zamba2_path", name, GRAM_ZAMBA2)
               if name == "adapter_gram" else {})
            | ({"launches_phase22_path": p22_counts[name]}
               if name in p22_counts else {})
            | (other_path("shard_path", name, SHARD_CASES[name])
               if name in SHARD_CASES else {})
            | ({"launches_phase23_path": p23_counts[name]}
               if name in p23_counts else {})
            | (other_path("family_shard_path", name, FAMILY_SHARD_CASES[name])
               if name in FAMILY_SHARD_CASES else {})
            | ({"launches_phase24_path": p24_counts.get(name, 0)}
               | other_path("train_shard_path", name, P24_CASES[name])
               if name in P24_CASES else {})
            | ({"launches_phase25_path": p25_counts.get(name, 0)}
               | other_path("family_train_shard_path", name, P25_CASES[name])
               if name in P25_CASES else {}))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    report["script_s"] = time.perf_counter() - t0
    report["phase_s"] = phase_s
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    print(f"whole script from the build on: {report['script_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# -- phases 2 and 3: kernels against their plain versions, and their times ----

def gpu_ms(torch, fn, cold: bool = True) -> float:
    """Median device time of ``fn`` over REPS launches.  Before each launch
    the 50 MB L2 is flushed (the decode path reads each layer's cache and
    adapter pages once per step, cold; ``cold=False`` skips the flush, for
    the warm time) and the stream is held busy with a sleep, so the host's
    enqueue cost falls inside the sleep and the event pair encloses only
    the device work."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        if cold:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in times)


def gpu_floor(torch) -> dict:
    """The floor under :func:`gpu_ms`: an empty kernel (``torch.cuda._sleep``
    of 0 cycles) timed the same way, cold and warm.  A bound of 0.1–3 µs is
    read against this, the least one launch costs."""
    floor = {"ms": gpu_ms(torch, lambda: torch.cuda._sleep(0)),
             "warm_ms": gpu_ms(torch, lambda: torch.cuda._sleep(0), cold=False)}
    print(f"  gpu_ms floor (empty kernel): {floor['ms']:.4f} ms cold, "
          f"{floor['warm_ms']:.4f} ms warm")
    return floor


def check(name, got, want, valid, tol):
    """max |got - want| over ``valid`` rows must be <= tol * max(1, |want|)."""
    g, w = got[valid].float(), want[valid].float()
    err = (g - w).abs().max().item()
    scale = max(1.0, w.abs().max().item())
    ok = err <= tol * scale
    print(f"  {name}: max_abs_err {err:.3e} (limit {tol * scale:.3e}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


def check_rows(name, got, want, tol, floor: float = 1e-30):
    """Each row (the last axis) on its own scale: max |got - want| over the
    row must be <= tol * max(floor, max |want| over the row).  Returns max
    |got - want| over all rows."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    rel = (d.amax(-1) / w.abs().amax(-1).clamp_min(floor)).max().item()
    err, mean = d.max().item(), d.mean().item()
    ok = rel <= tol
    scale = "row max |plain|" if floor < 1 else f"max({floor:g}, row max |plain|)"
    print(f"  {name}: max_abs_err {err:.3e}, mean_abs_err {mean:.3e}; worst "
          f"row max |Δ| / {scale} {rel:.3e} (limit {tol:.1e}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


def kernel_cases(torch):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ring_decode import (MIN_TILES, TILE, plan, route,
                                                 split_tiles)
    from repro_torch.models.attention_core import ring_attend_mask
    from repro_torch.serve.kvcache import quant
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    records = []
    print("phase 2/3: kernels against plain versions; times (ms, median of "
          f"{REPS}, L2 flushed) beside bounds at 3.35 TB/s")

    # ring_decode: main-path shapes (hd 64, cap 1024); rows cover a wrapped
    # ring, a full ring, partial rings, a fresh prefill, an inactive row
    # (n = 0, never written), ragged n and a wrap at pos > 2 cap.  Then a
    # ring of one tile (cap 64: one split, normalised in-block, no merge)
    # and the other head dims the kernel is built for.  Then the redesign's
    # edges: n_tokens ragged across all rows at C 16; 8 and 12 rows (route
    # "narrow": a partial 16-row tile), 16 at g 1 (a full one), 20 (route
    # "tensor": two 16-row tiles, the second partial), 64 at g 8; a ring of
    # 4 tiles (one split of exactly MIN_TILES); a cap that is not a tile
    # multiple, wrapped; fp32 at 12 rows (route "rows" with a partial
    # group); int8 at C 16 with ragged n.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    positions = {1024: [1500, 1024, 300, 16, 0, 700, 2100, 64],
                 1000: [1500, 1000, 300, 16, 0, 700, 2100, 64],
                 256: [300, 256, 100, 16, 0, 200, 600, 64],
                 64: [100, 64, 30, 16, 0, 70, 200, 48]}
    ragged_pos = [1030, 2047, 9, 3, 600, 0, 64, 1100]
    ragged_n = [16, 9, 3, 1, 16, 0, 12, 7]
    tol = {"float32": 1e-4, "bfloat16": 2e-3, "int8": 1e-4}
    # fp32: sum order across up to 1024 keys; bf16: both sides compute in
    # fp32 from the same stored bf16 values (the tensor-core route's bf16
    # products are exact in fp32 and P enters P·V as a bf16 hi + lo pair,
    # ≈ 2^-16 of P), margin for exp/sum order; int8: both dequantize per
    # token in fp32
    for kv_name, C, window, hd, cap, H, K, ragged in (
            ("bfloat16", 1, 0, 64, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 64, 1024, 32, 8, False),
            ("bfloat16", 1, 256, 64, 1024, 32, 8, False),
            ("bfloat16", 16, 256, 64, 1024, 32, 8, False),
            ("float32", 1, 0, 64, 1024, 32, 8, False),
            ("float32", 16, 0, 64, 1024, 32, 8, False),
            ("int8", 1, 0, 64, 1024, 32, 8, False),
            ("int8", 16, 0, 64, 1024, 32, 8, False),
            ("bfloat16", 1, 0, 64, 64, 32, 8, False),
            ("bfloat16", 16, 0, 64, 64, 32, 8, False),
            ("int8", 16, 32, 64, 64, 32, 8, False),
            ("bfloat16", 1, 0, 128, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 128, 1024, 32, 8, False),
            ("float32", 16, 0, 128, 1024, 32, 8, False),
            ("int8", 1, 0, 128, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 16, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 32, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 64, 1024, 32, 8, True),
            ("bfloat16", 16, 100, 64, 1000, 32, 8, True),
            ("bfloat16", 2, 0, 64, 1024, 32, 8, False),
            ("bfloat16", 3, 0, 64, 1000, 32, 8, False),
            ("bfloat16", 5, 0, 64, 1024, 32, 8, False),
            ("bfloat16", 16, 0, 64, 1024, 8, 8, False),
            ("bfloat16", 8, 0, 64, 1024, 32, 4, False),
            ("bfloat16", 16, 0, 64, 256, 32, 8, False),
            ("int8", 1, 0, 32, 1000, 32, 8, False),
            ("float32", 3, 0, 16, 256, 32, 8, True),
            ("int8", 16, 0, 64, 1024, 32, 8, True),
            # head dims the padded tiles opened: 56 (qwen2-0.5B's SMOKE
            # config, 7 query heads a KV head here) and 96 (Phi-3-vision, no
            # grouping), on every route and cache dtype; int8 rows of 56
            # bytes travel as 8-byte copies
            ("bfloat16", 1, 0, 56, 1024, 28, 4, False),
            ("bfloat16", 16, 0, 56, 1024, 28, 4, False),
            ("bfloat16", 1, 0, 96, 1024, 32, 32, False),
            ("bfloat16", 16, 0, 96, 1024, 32, 32, False),
            ("float32", 16, 0, 56, 1024, 28, 4, False),
            ("float32", 1, 0, 96, 1024, 32, 32, False),
            ("int8", 1, 0, 56, 1024, 28, 4, False),
            ("int8", 16, 0, 56, 1000, 28, 4, True),
            ("int8", 16, 0, 96, 1024, 32, 32, False),
            # the Qwen configs' groups: Qwen2-0.5B's 7 query heads a KV head
            # (14 / 2, hd 64) and Qwen2.5-14B's 5 (40 / 8, hd 128), at C 1
            # and at a 16-token chunk (112 and 80 rows a KV head), bf16 and
            # int8; Qwen1.5-32B's MHA (40 / 40, hd 128)
            ("bfloat16", 1, 0, 64, 1024, 14, 2, False),
            ("bfloat16", 16, 0, 64, 1024, 14, 2, False),
            ("int8", 1, 0, 64, 1024, 14, 2, False),
            ("int8", 16, 0, 64, 1024, 14, 2, False),
            ("bfloat16", 1, 0, 128, 1024, 40, 8, False),
            ("bfloat16", 16, 0, 128, 1024, 40, 8, False),
            ("int8", 1, 0, 128, 1024, 40, 8, False),
            ("int8", 16, 0, 128, 1024, 40, 8, False),
            ("bfloat16", 1, 0, 128, 1024, 40, 40, False),
            ("bfloat16", 16, 0, 128, 1024, 40, 40, False),
            # granite-moe-1b-a400m's heads (16 / 8, hd 64: 2 query heads a
            # KV head, 32 rows a KV head at a 16-token chunk)
            ("bfloat16", 1, 0, 64, 1024, 16, 8, False),
            ("bfloat16", 16, 0, 64, 1024, 16, 8, False),
            # phase 21: musicgen-medium's MHA (24 / 24, hd 64) and zamba2's
            # shared block (32 / 32, hd 64; one token a step); Phi-3's 32 /
            # 32 at hd 96 is above
            ("bfloat16", 1, 0, 64, 1024, 24, 24, False),
            ("bfloat16", 16, 0, 64, 1024, 24, 24, False),
            ("bfloat16", 1, 0, 64, 1024, 32, 32, False),
            # phase 22 (a): one rank's shard of Llama-3.2-1B on a model axis
            # of 2 (16 of 32 query heads over 4 of 8 KV heads), at a decode
            # step and at the 16-token prefill chunk
            ("bfloat16", 1, 0, 64, 1024, 16, 4, False),
            ("bfloat16", 16, 0, 64, 1024, 16, 4, False),
            # phase 23: one rank's heads on a model axis of 2 of granite-moe
            # (8 / 4), phi-3-vision (16 / 16 at hd 96), musicgen (12 / 12)
            # at a decode step and a 16-token chunk, and zamba2's shared
            # block (16 / 16; one token a step)
            ("bfloat16", 1, 0, 64, 1024, 8, 4, False),
            ("bfloat16", 16, 0, 64, 1024, 8, 4, False),
            ("bfloat16", 1, 0, 96, 1024, 16, 16, False),
            ("bfloat16", 16, 0, 96, 1024, 16, 16, False),
            ("bfloat16", 1, 0, 64, 1024, 12, 12, False),
            ("bfloat16", 16, 0, 64, 1024, 12, 12, False),
            ("bfloat16", 1, 0, 64, 1024, 16, 16, False)):
        B = 8
        how = route(torch.float32 if kv_name == "float32" else torch.bfloat16,
                    getattr(torch, kv_name), H // K * C)
        nsplit = plan(B, C, H, K, cap, sms, how)[1]
        if (nsplit == 1) != (cap < 2 * MIN_TILES * TILE):
            fail(f"ring_decode: cap {cap}, C={C} plans {nsplit} splits; a "
                 f"split walks at least MIN_TILES = {MIN_TILES} resident "
                 f"tiles of {TILE} slots, so exactly the rings of fewer than "
                 f"{2 * MIN_TILES} tiles (cap < {2 * MIN_TILES * TILE}) plan "
                 "one split here")
        pos = torch.tensor(ragged_pos if ragged else positions[cap], device=dev)
        length = torch.clamp(pos, max=cap)
        want_n = ragged_n if ragged else [C, C, C, C, 0, min(5, C), 1, C]
        n = torch.minimum(pos, torch.tensor(want_n, device=dev).clamp(max=C)
                          ).to(torch.int32)
        kf = torch.randn(B, cap, K, hd, generator=gen, device=dev)
        vf = torch.randn(B, cap, K, hd, generator=gen, device=dev)
        qdt = torch.float32 if kv_name == "float32" else torch.bfloat16
        q = torch.randn(B, C, H, hd, generator=gen, device=dev).to(qdt)
        ks = vs = None
        if kv_name == "int8":
            (k, ks), (v, vs) = quant(kf), quant(vf)
        else:
            k, v = kf.to(getattr(torch, kv_name)), vf.to(getattr(torch, kv_name))
        p32, l32 = pos.to(torch.int32), length.to(torch.int32)
        args = (q, k, v, p32, l32, n)
        kw = dict(window=window, k_scale=ks, v_scale=vs)
        got = ops.ring_decode(*args, **kw)
        want = ref.ring_decode_ref(*args, **kw)
        torch.cuda.synchronize()
        valid = torch.arange(C, device=dev)[None, :] < n[:, None]
        case = (f"{'bf16' if kv_name == 'bfloat16' else kv_name} cache, C={C}"
                f"{f', window={window}' if window else ''}"
                f"{', ragged n' if ragged else ''}, "
                f"B={B} H={H} K={K} hd={hd} cap={cap}")
        per_row = [len([t for t in range(nsplit) if split_tiles(
            int(pos[b]), int(length[b]), cap, nsplit, t)]) if int(n[b]) > 0 else 0
            for b in range(B)]
        err = check(f"ring_decode[{case}; route {how}, grid splits "
                    f"{nsplit}, per row {per_row}]", got,
                    want, valid, tol[kv_name])
        ms = gpu_ms(torch, lambda: ops.ring_decode(*args, **kw))
        plain = gpu_ms(torch, lambda: ref.ring_decode_ref(*args, **kw))
        lib = None
        if kv_name != "int8":
            # yardstick: one SDPA call on the same values, pre-transposed to
            # (B, K, cap, hd) and with the ring mask prebuilt (not timed)
            qpos = (pos - n)[:, None] + torch.arange(C, device=dev)[None, :]
            mask = ring_attend_mask(p32, l32, cap, qpos, window)[:, None]
            qt, kt, vt = (x.transpose(1, 2).contiguous().to(qdt)
                          for x in (q, k, v))
            lib = gpu_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        resident = int(length.sum())
        kv_b = 1 if kv_name == "int8" else k.element_size()
        nbytes = (q.numel() * q.element_size() + resident * K * hd * 2 * kv_b
                  + (resident * K * 2 * 4 if kv_name == "int8" else 0)
                  + B * C * H * hd * 4 + 3 * B * 4)
        ops_n = 4 * resident * C * (H // K) * K * hd
        records.append(_record(
            "ring_decode", case, "src/repro_torch/kernels/csrc/ring_decode.cu",
            "src/repro/kernels/ring_decode.py:115", err, ms, plain, lib,
            nbytes, ops_n, kv_name))
        if case in (RING_MAIN, RING_PREFILL):
            records[-1]["device_split"] = ring_split(
                torch, lambda: ops.ring_decode(*args, **kw))

    return records


BGMV_MAIN = "bf16, C=1, B=8 din=2048 dout=2048 pr=4 Pmax=4"


def bgmv_kernel_cases(torch):
    """``bgmv`` at the serving paths' shapes: the Llama path's projections
    (wq/wo 2048->2048, wk/wv 2048->512), the MLA path's (wq_b 1536->24576,
    wkv_a 7168->576, not a multiple of 64 columns a block, wo
    16384->7168) and the RWKV6 path's fp32 x on bf16 pages; rows on
    adapters of ranks 0 (base), 3, 8, 16.  Then ranks 30, 32 and 64 over
    pages of 4 (up to 16 pages, several groups of 4 ranks and 8-wide
    n-tiles, a partial last page) at C = 16 beside the base id.  Each case
    is timed cold (L2 flushed) and warm."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bgmv import plan
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    records = []
    print("phase 2/3: bgmv against its plain version; times cold and warm "
          "beside bounds")
    pr = 4
    ids = torch.tensor([0, 1, 2, 3, 1, 2, 3, 0], dtype=torch.int32, device=dev)
    cases = [(dt, C, din, dout, (0, 3, 8, 16, 0), 4) for dt, C, din, dout in (
        ("bfloat16", 1, 2048, 2048), ("bfloat16", 1, 2048, 512),
        ("bfloat16", 16, 2048, 2048), ("bfloat16", 16, 2048, 512),
        ("float32", 1, 2048, 2048), ("float32", 16, 2048, 512),
        ("bfloat16", 1, 1536, 24576), ("bfloat16", 16, 1536, 24576),
        ("bfloat16", 1, 7168, 576), ("bfloat16", 16, 7168, 576),
        ("bfloat16", 1, 16384, 7168), ("bfloat16", 16, 16384, 7168),
        ("float32", 16, 7168, 576), ("float32/bfloat16", 1, 2048, 2048),
        # the Qwen engines' projections: din 896 (Qwen2-0.5B), 2560 and
        # 4096 (Qwen3-4B's wq and wo), 5120 (Qwen2.5-14B, Qwen1.5-32B)
        ("bfloat16", 1, 896, 896), ("bfloat16", 16, 896, 128),
        ("bfloat16", 1, 2560, 4096), ("bfloat16", 16, 4096, 2560),
        ("bfloat16", 1, 5120, 5120), ("bfloat16", 16, 5120, 5120),
        ("bfloat16", 16, 5120, 1024),
        # granite-moe's projections (d 1024: wq / wo 1024 -> 1024, wk / wv
        # 1024 -> 512) and DeepSeek-V3's wq_a (7168 -> 1536)
        ("bfloat16", 1, 1024, 1024), ("bfloat16", 16, 1024, 512),
        ("bfloat16", 1, 7168, 1536),
        # phase 21: Phi-3's projections (3072 -> 3072, all four: 32 KV
        # heads), musicgen's (1536 -> 1536), zamba2's Mamba2 in_proj
        # (2048 -> 8384) and out_proj (4096 -> 2048; one token a step)
        ("bfloat16", 1, 3072, 3072), ("bfloat16", 16, 3072, 3072),
        ("bfloat16", 1, 1536, 1536), ("bfloat16", 16, 1536, 1536),
        ("bfloat16", 1, 2048, 8384), ("bfloat16", 1, 4096, 2048))]
    # phase 22: one rank's shard widths on a model axis of 2 (Llama's and
    # DeepSeek-V3-dense3's column-parallel dout and row-parallel din),
    # at a decode step and at the prefill chunk
    cases += [(dt, C, din, dout, (0, 3, 8, 16, 0), 4)
              for din, dout in BGMV_SHARD + BGMV_MLA_SHARD
              for dt, C in (("bfloat16", 1), ("bfloat16", 16))]
    # phase 23: the other families' shard widths (BGMV_FAMILY_SHARD) not
    # above, at a decode step and at the prefill chunk (RWKV6 and zamba2
    # take one token a step; RWKV6's r/k/v/g inputs are fp32)
    for key, shapes in BGMV_FAMILY_SHARD.items():
        one_token = key in ("rwkv6_1p6b", "zamba2_1p2b")
        for c in [("bfloat16", C, din, dout, (0, 3, 8, 16, 0), 4)
                  for din, dout in shapes
                  for C in ((1,) if one_token else (1, 16))] + (
                [("float32/bfloat16", 1, 2048, 1024, (0, 3, 8, 16, 0), 4)]
                if key == "rwkv6_1p6b" else []):
            if c not in cases:
                cases.append(c)
    cases += [(dt, 16, din, dout, (0, 30, 32, 64, 0), 16) for dt, din, dout in (
        ("bfloat16", 2048, 2048), ("bfloat16", 16384, 7168),
        ("float32/bfloat16", 2048, 2048))]
    for dt_name, C, din, dout, ranks, Pmax in cases:
        # "x/pages": an RWKV6 bf16 decode feeds r/k/v/g's fp32 inputs
        dt_name, _, page_name = dt_name.partition("/")
        dt, pdt = getattr(torch, dt_name), getattr(torch, page_name or dt_name)
        rank = torch.tensor(ranks, dtype=torch.int32, device=dev)
        P = 32 if Pmax == 4 else 96           # pool pages; 5 table rows of Pmax
        table = torch.randperm(P, generator=gen, device=dev)[:5 * Pmax]
        table = table.reshape(5, Pmax).to(torch.int32)
        scale = torch.tensor([0.0, 2.0, 2.0, 2.0, 0.0], device=dev)
        x = torch.randn(8, C, din, generator=gen, device=dev).to(dt)
        a = (torch.randn(P, pr, din, generator=gen, device=dev) * 0.05).to(pdt)
        b = (torch.randn(P, dout, pr, generator=gen, device=dev) * 0.05).to(pdt)
        args = (x, a, b, table, rank, scale, ids)
        got = ops.bgmv(*args)
        want = ref.bgmv_ref(*args)
        torch.cuda.synchronize()
        base = rank[ids.long()] == 0
        if (got[base] != 0).any():
            fail("bgmv: a rank-0 row is not an exact zero")
        short = {"bfloat16": "bf16", "float32": "fp32"}
        case = (f"{short[dt_name]} x, {short[page_name]} pages"
                if page_name else
                f"{'bf16' if dt_name == 'bfloat16' else dt_name}")
        case += f", C={C}, B=8 din={din} dout={dout} pr={pr} Pmax={Pmax}"
        if Pmax != 4:
            case += f", ranks {'/'.join(str(r) for r in ranks[1:4])}"
        p = plan(C, din, dout, pr, Pmax, dt, pdt)
        err = check(f"bgmv[{case}; route {p.route}, tile {p.tile_n}, "
                    f"{p.clusters} cluster(s) a row, {p.nchunk} chunks of "
                    f"{p.kc}]", got, want,
                    torch.ones(8, dtype=torch.bool, device=dev),
                    1e-4 if dt_name == "float32" else 2e-3)
        ms = gpu_ms(torch, lambda: ops.bgmv(*args))
        warm = gpu_ms(torch, lambda: ops.bgmv(*args), cold=False)
        plain = gpu_ms(torch, lambda: ref.bgmv_ref(*args))
        distinct = sorted(set(ids.tolist()))
        r_rows = [int(rank[i]) for i in ids.tolist()]
        nbytes = (x.numel() * x.element_size() + sum(int(rank[i]) for i in distinct)
                  * (din + dout) * a.element_size() + 8 * C * dout * 4)
        ops_n = 2 * C * sum(r_rows) * (din + dout)
        records.append(_record(
            "bgmv", case, "src/repro_torch/kernels/csrc/bgmv.cu",
            "src/repro/kernels/bgmv.py:55", err, ms, plain, None, nbytes,
            ops_n, dt_name, warm=warm))
    return records


RING_MAIN = "bf16 cache, C=1, B=8 H=32 K=8 hd=64 cap=1024"
RING_PREFILL = "bf16 cache, C=16, B=8 H=32 K=8 hd=64 cap=1024"


def ring_split(torch, fn, reps: int = 20) -> dict:
    """Device time per call by kernel name (``torch.profiler``, L2 flushed
    before each call): the attention kernel and any second launch it
    makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    split = {e.key: e.self_device_time_total / reps
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "elementwise" not in e.key}
    for name, us in split.items():
        print(f"    device split: {us:.2f} us per call  {name[:90]}")
    return split


BGMV_RWKV = "fp32 x, bf16 pages, C=1, B=8 din=2048 dout=2048 pr=4 Pmax=4"
MLA_MAIN = "bf16 cache, C=1, B=8 H=128 kvr=512 rope=64 cap=1024"


def mla_kernel_cases(torch):
    """``mla_ring_decode`` at the MLA path's shapes (B 8, H 128, kvr 512,
    rope 64, ring 1024): bf16 at C 1 and 16, a window of 128, int8 with
    per-half scales, fp32; then at the SMOKE config's widths (32 + 16);
    then bf16 at C 1 and 16 on a ring that holds as many slots as the
    engine's do (32–288 resident of 1024).  Each case is timed cold (L2
    flushed) and warm."""
    import math
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mla_ring_decode import route, splits
    from repro_torch.models.attention_core import ring_attend_mask
    from repro_torch.serve.kvcache import quant
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    records = []
    print("phase 2/3: mla_ring_decode against its plain version; times "
          "beside bounds")
    B, cap = 8, 1024
    # rows: wrapped twice, full, partial, a fresh prefill, never written
    # (n = 0), ragged n, wrapped with n = 1, one tile
    # Each query row is held to its own magnitude (a row averaging
    # hundreds of slots is several times smaller than one averaging a few).
    # Both sides compute in fp32 from the same stored values (bf16 and int8
    # dequantized per half in fp32; fp32 products on both sides, TF32 off
    # by default); they differ only in summation order over up to 1024
    # slots and in exp rounding: limit 1e-4 of the row's max |plain|.
    # (kvr, rope, nope, H): DeepSeek-V3's widths, then its SMOKE config's
    # latent widths, 32 + 16 (padded to 32 + 32 in the kernel), at 16 heads
    main = [(512, 64, 128, 128) + c for c in (
        ("bfloat16", 1, 0), ("bfloat16", 16, 0), ("bfloat16", 1, 128),
        ("bfloat16", 16, 128), ("int8", 1, 0), ("int8", 16, 0),
        ("float32", 1, 0), ("float32", 16, 0))]
    smoke = [(32, 16, 32, 16) + c for c in (
        ("bfloat16", 1, 0), ("bfloat16", 16, 0), ("int8", 1, 0),
        ("int8", 16, 0), ("float32", 16, 0))]
    # the engine's rings: phase 8's prompts of 16-256 tokens plus 32 new
    engine = [(512, 64, 128, 128, "bfloat16", c, 0, "engine") for c in (1, 16)]
    # phase 22 (b): one rank's 64 of DeepSeek-V3's 128 heads (model axis 2)
    main += [(512, 64, 128, 64, "bfloat16", c, 0) for c in (1, 16)]
    engine_pos = torch.tensor([288, 32, 100, 200, 0, 150, 64, 250], device=dev)
    for kvr, rope, nope, H, kv_name, C, window, *ring in main + smoke + engine:
        pos = engine_pos if ring else torch.tensor(
            [1500, 1024, 300, 16, 0, 700, 2100, 64], device=dev)
        length = torch.clamp(pos, max=cap)
        scale = 1.0 / math.sqrt(nope + rope)     # DeepSeek-V3: 1/√(nope+rope)
        n = torch.minimum(pos, torch.tensor([C, C, C, C, 0, min(5, C), 1, C],
                                            device=dev)).to(torch.int32)
        q = torch.randn(B, C, H, kvr + rope, generator=gen, device=dev)
        ckv_f = torch.randn(B, cap, kvr, generator=gen, device=dev)
        kr_f = torch.randn(B, cap, rope, generator=gen, device=dev)
        cs = rs = None
        if kv_name == "int8":
            (ckv, cs), (kr, rs) = quant(ckv_f), quant(kr_f)
        else:
            ckv, kr = (t.to(getattr(torch, kv_name)) for t in (ckv_f, kr_f))
        p32, l32 = pos.to(torch.int32), length.to(torch.int32)
        args = (q, ckv, kr, p32, l32, n)
        kw = dict(scale=scale, window=window, c_kv_scale=cs, k_rope_scale=rs)
        got = ops.mla_ring_decode(*args, **kw)
        want = ref.mla_ring_decode_ref(*args[:6], scale, window, cs, rs)
        torch.cuda.synchronize()
        valid = torch.arange(C, device=dev)[None, :] < n[:, None]
        name = {"bfloat16": "bf16"}.get(kv_name, kv_name)
        case = (f"{name} cache, C={C}{f', window={window}' if window else ''}, "
                f"B={B} H={H} kvr={kvr} rope={rope} cap={cap}"
                f"{', engine ring (32-288 resident)' if ring else ''}")
        how = route(ckv.dtype, kvr, rope)
        nsplit = splits(B, C, H, cap, dev, how)[0]
        err = check_rows(f"mla_ring_decode[{case}; route {how}, {nsplit} "
                         "splits]", got[valid], want[valid], 1e-4)
        ms = gpu_ms(torch, lambda: ops.mla_ring_decode(*args, **kw))
        warm = gpu_ms(torch, lambda: ops.mla_ring_decode(*args, **kw),
                      cold=False)
        plain = gpu_ms(torch, lambda: ref.mla_ring_decode_ref(
            *args[:6], scale, window, cs, rs))
        qpos = (pos - n)[:, None] + torch.arange(C, device=dev)[None, :]
        mask = ring_attend_mask(p32, l32, cap, qpos, window)      # (B,C,cap)
        lib = None
        if kv_name != "int8":
            # yardstick: one SDPA call, MQA over the latent (K = 1 broadcast
            # to the H heads, value = the first kvr key columns), on
            # pre-arranged inputs and the prebuilt ring mask (not timed)
            dt = ckv.dtype
            qt = q.transpose(1, 2).contiguous().to(dt)            # (B,H,C,576)
            kt = torch.cat([ckv, kr], -1)[:, None]                # (B,1,cap,576)
            vt = ckv[:, None]                                     # (B,1,cap,512)
            mt = mask[:, None]
            lib = gpu_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mt, scale=scale, enable_gqa=True))
        resident = int(length.sum())
        eb = ckv.element_size()
        nbytes = (q.numel() * 4 + resident * (kvr + rope) * eb
                  + (resident * 2 * 4 if kv_name == "int8" else 0)
                  + B * C * H * kvr * 4 + 3 * B * 4)
        pairs = int((mask & valid[:, :, None]).sum())   # visible (query, slot)
        ops_n = 2 * H * pairs * ((kvr + rope) + kvr)
        records.append(_record(
            "mla_ring_decode", case,
            "src/repro_torch/kernels/csrc/mla_ring_decode.cu",
            "src/repro/kernels/mla_ring_decode.py:67", err, ms, plain, lib,
            nbytes, ops_n, kv_name,
            library=None if lib is None else
            "scaled_dot_product_attention(attn_mask=ring mask, "
            "enable_gqa=True), K = 1", warm=warm))
        records[-1]["kernel_route"] = how
    return records


def _record(name, case, source, replaces, err, ms, plain, lib, nbytes, ops_n,
            dtype, library=None, warm=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_n / PEAK_OPS[dtype] * 1e3
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "case": case, "max_abs_err": err, "ms": ms,
           "plain_ms": plain, "library_ms": lib,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops_n}
    if library is not None:
        rec["library"] = library
    if warm is not None:
        rec["warm_ms"] = warm
    print(f"  {name}[{case}]: kernel {ms:.4f} ms"
          f"{'' if warm is None else f' (warm {warm:.4f})'}, plain {plain:.4f} ms, "
          f"library {'-' if lib is None else f'{lib:.4f} ms'}, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
          f"{nbytes / 1e6:.2f} MB, {ops_n / 1e9:.3f} GFLOP)")
    return rec


# -- phases 2 and 3 for the federated round's kernels ------------------------

LORA_MAIN = "bf16, M=2048 din=2048 dout=2048 r=16"
# lora_matmul's record beside the contract's keys: the route that ran, its
# tile width, and the yardsticks (no one PyTorch call computes the function)
LORA_EXTRA = ("kernel_route", "tile_n", "grid", "base_matmul_ms", "unfused_ms")
LORA_RWKV = "bf16, M=8192 din=2048 dout=2048 r=16"
LORA_TRAINER = "bf16, M=2048 din=896 dout=896 r=16"          # Qwen2-0.5B's wq
LORA_MOE_SHAPES = ((1024, 1024), (1024, 512), (7168, 1536), (1536, 24576),
                   (7168, 576), (16384, 7168))
LORA_GRANITE = "bf16, M=2048 din=1024 dout=1024 r=16"        # granite's wq
LORA_MLA = "bf16, M=2048 din=16384 dout=7168 r=16"           # DeepSeek-V3's wo
FLASH_TRAINER = "bf16, causal, B=4 S=512 H=14 K=2 hd=64"      # Qwen2-0.5B
FLASH_MAIN = "bf16, causal, B=4 S=512 H=32 K=8 hd=64"
GRAM_MAIN = "fp32, G=32 m=2048 r=64"
# phase 20 (d)'s Gram stacks (G, m, r, layout), fp32, r = Σ r_k: granite-
# moe's two buckets of 2 leaves x GRANITE_LAYERS at r 64 (B stacks m 1024
# for wq/wo and 512 for wk/wv; both A stacks n 1024, read in place), and
# DeepSeek-V3-L4's five MLA targets at r 32 in its dense (G 3) and MoE (G 1)
# segments: B stacks m = dout (wq_a 1536, wq_b 24576, wkv_a 576, wkv_b
# 32768, wo 7168), A stacks n = din (7168, 1536, 512, 16384)
GRAM_MOE = tuple((2 * GRANITE_LAYERS, m, 64, layout) for m, layout in (
    (1024, "col"), (512, "col"), (1024, "row"))) + tuple(
    (G, m, 32, layout) for G in (3, 1)
    for m, layout in ((1536, "col"), (24576, "col"), (576, "col"), (32768, "col"),
                      (7168, "col"), (7168, "row"), (1536, "row"), (512, "row"),
                      (16384, "row")))
GRAM_GRANITE = f"fp32, G={2 * GRANITE_LAYERS} m=1024 r=64"
GRAM_DSV3 = "fp32, G=3 m=32768 r=32"                         # wkv_b's B stack
# phase 21's train steps: (M, din, dout) of Phi-3-vision's and musicgen's
# projections, and (din, dout) of zamba2's (in_proj, out_proj, and the
# shared block's wq..wo), which phase 16 (a) also checks at C 4
LORA_FRONT_SHAPES = ((4096, 3072, 3072), (2048, 1536, 1536))
LORA_HYBRID_SHAPES = ((2048, 8384), (4096, 2048), (2048, 2048))
LORA_PHI3 = "bf16, M=4096 din=3072 dout=3072 r=16"
LORA_ZAMBA2 = "bf16, M=2048 din=2048 dout=8384 r=16"         # Mamba2's in_proj
# phase 21 (c)'s Gram stacks, fp32, r = Σ r_k = 64: zamba2's five buckets,
# Mamba2 in_proj and out_proj in six segments of 6 layers (G 36) and one of
# 2 (G 2), and the shared block's four 2-D leaves (G 4): B stacks m = dout
# (8384, 2048), A stacks n = din (2048, 4096)
GRAM_HYBRID = tuple((G, m, 64, layout) for G in (36, 2)
                    for m, layout in ((8384, "col"), (2048, "row"), (2048, "col"),
                                      (4096, "row"))) + (
    (4, 2048, 64, "col"), (4, 2048, 64, "row"))
GRAM_ZAMBA2 = "fp32, G=36 m=8384 r=64"
# phase 22's shard shapes on a model / data axis of 2: bgmv's (din, dout)
# of a Llama-3.2-1B rank (wq 2048 -> 1024, wk / wv 2048 -> 256, wo 1024 ->
# 2048) and of a DeepSeek-V3-dense3 rank (wq_a 7168 -> 768, wq_b 1536 ->
# 12288, wkv_a 7168 -> 288, wo 8192 -> 7168); lora_matmul's (din, dout) at
# C 2 (TinyLlama's wq and wv); a rank's FLoRIST layer slice of TinyLlama
# at 2 layers, r = 4 x 16 (wq's B stack, both A stacks, wv's B stack)
BGMV_SHARD = ((2048, 1024), (2048, 256), (1024, 2048))
BGMV_MLA_SHARD = ((7168, 768), (1536, 12288), (7168, 288), (8192, 7168))
LORA_SHARD_SHAPES = ((2048, 2048), (2048, 256))
GRAM_SHARD = ((1, 2048, 64, "col"), (1, 2048, 64, "row"), (1, 256, 64, "col"))
RING_SHARD = "bf16 cache, C=1, B=8 H=16 K=4 hd=64 cap=1024"
BGMV_SHARD_MAIN = "bf16, C=1, B=8 din=2048 dout=1024 pr=4 Pmax=4"
MLA_SHARD = "bf16 cache, C=1, B=8 H=64 kvr=512 rope=64 cap=1024"
LORA_SHARD = "fp32, C=2 M=2048 din=2048 dout=2048 r=16"
FLASH_SHARD = "fp32, causal, B=8 S=512 H=32 K=4 hd=64"
GRAM_SHARD_MAIN = "fp32, G=1 m=2048 r=64"
SHARD_CASES = {"ring_decode": RING_SHARD, "bgmv": BGMV_SHARD_MAIN,
               "mla_ring_decode": MLA_SHARD, "lora_matmul": LORA_SHARD,
               "flash_attention": FLASH_SHARD, "adapter_gram": GRAM_SHARD_MAIN}
FLASH_PHI3 = "bf16, causal, B=4 S=1024 H=32 K=32 hd=96"
RING_ZAMBA2 = "bf16 cache, C=1, B=8 H=32 K=32 hd=64 cap=1024"
BGMV_ZAMBA2 = "bf16, C=1, B=8 din=2048 dout=8384 pr=4 Pmax=4"
# phase 23's shard shapes on a model axis of 2, by model: ring_decode's
# (H, K, hd) and bgmv's (din, dout) of one rank.  granite-moe: wq 1024 ->
# 512, wk / wv 1024 -> 256, wo 512 -> 1024; RWKV6: wr wk wv wg 2048 -> 1024
# (fp32 x), wo 1024 -> 2048; zamba2: the shared block as Llama's rank
# (2048 -> 1024, 1024 -> 2048), Mamba2's in_proj cut segment by segment
# (2048 -> 2048 + 2048 + 128 + 32 = 4256) and out_proj 2048 -> 2048;
# phi-3-vision 3072 -> 1536 and 1536 -> 3072; musicgen 1536 -> 768 and 768
# -> 1536; DeepSeek-V3-L4 as DeepSeek-V3-dense3's rank (its MoE layer's
# attention too)
RING_FAMILY_SHARD = {"granite_moe_1b_a400m": (8, 4, 64),
                     "zamba2_1p2b": (16, 16, 64),
                     "phi3_vision_4p2b": (16, 16, 96),
                     "musicgen_medium": (12, 12, 64)}
BGMV_FAMILY_SHARD = {
    "granite_moe_1b_a400m": ((1024, 512), (1024, 256), (512, 1024)),
    "deepseek_v3_l4": BGMV_MLA_SHARD,
    "rwkv6_1p6b": ((2048, 1024), (1024, 2048)),
    "zamba2_1p2b": ((2048, 1024), (1024, 2048), (2048, 4256), (2048, 2048)),
    "phi3_vision_4p2b": ((3072, 1536), (1536, 3072)),
    "musicgen_medium": ((1536, 768), (768, 1536))}
RING_FAMILY_MAIN = "bf16 cache, C=1, B=8 H=8 K=4 hd=64 cap=1024"   # granite
BGMV_FAMILY_MAIN = "bf16, C=1, B=8 din=2048 dout=4256 pr=4 Pmax=4"  # in_proj
FAMILY_SHARD_CASES = {"ring_decode": RING_FAMILY_MAIN, "bgmv": BGMV_FAMILY_MAIN}


def _causal_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible: the work this run needs."""
    total = 0
    for s in range(S):
        hi = min(T, s + 1) if causal else T
        lo = max(0, s - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def flash_case(torch, gen, dt, B, S, T, H, K, hd, causal, window):
    """One ``flash_attention`` case against its plain version, each query
    row held to its own magnitude (bf16 1e-2, fp32 1e-5 of the row's max
    |plain|), with its time, the plain version's, one SDPA call's (no
    window) and its bound; returns the record."""
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(B, T, K, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(B, T, K, hd, generator=gen, device=dev).to(dt)
    got = ops.flash_attention(q, k, v, causal, window)
    want = ref.flash_attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    case = (f"{'bf16' if dt == torch.bfloat16 else 'fp32'}, "
            f"{'causal' if causal else 'full'}"
            f"{f', window={window}' if window else ''}, "
            f"B={B} S={S}{f' T={T}' if T != S else ''} H={H} K={K} hd={hd}")
    err = check_rows(f"flash_attention[{case}]", got, want,
                     1e-2 if dt == torch.bfloat16 else 1e-5)
    ms = gpu_ms(torch, lambda: ops.flash_attention(q, k, v, causal, window))
    plain = gpu_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal,
                                                          window))
    lib = None
    if not window:      # one SDPA call, on pre-transposed inputs
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = gpu_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
    eb = q.element_size()
    nbytes = eb * (2 * q.numel() + k.numel() + v.numel())
    ops_n = 4 * B * H * hd * _causal_pairs(S, T, causal, window)
    return _record(
        "flash_attention", case,
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:70", err, ms, plain, lib,
        nbytes, ops_n, str(dt).split(".")[-1],
        library=None if window else
        f"scaled_dot_product_attention(is_causal={causal}, enable_gqa=True)")


def lora_case(torch, gen, sms, dt, M, din, dout, r):
    """One ``lora_matmul`` case against its plain version (limits in
    :func:`train_kernel_cases`), its time beside its bound, the plain
    version's and the base product's (``torch.matmul``); the unfused
    ``torch.addmm(x W, x Aᵀ, (s·B)ᵀ)`` too at the two main shapes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lora_matmul import TILE_M
    from repro_torch.kernels.lora_matmul import plan as lora_plan
    dev = torch.device(DEVICE)
    dname = {torch.bfloat16: "bf16", torch.float32: "fp32"}
    x = torch.randn(M, din, generator=gen, device=dev).to(dt)
    w = (torch.randn(din, dout, generator=gen, device=dev) / din ** 0.5).to(dt)
    a = torch.randn(r, din, generator=gen, device=dev) * 0.02
    b = torch.randn(dout, r, generator=gen, device=dev) * 0.05
    scale = torch.tensor(16.0 / r, device=dev)
    a_c, b_s = ops.lora_operands(x, w, a, b, scale)
    got = ops.lora_matmul(x, w, a, b, scale)
    want = ref.lora_matmul_ref(x, w, a_c, b_s, 1.0)
    torch.cuda.synchronize()
    case = f"{dname[dt]}, M={M} din={din} dout={dout} r={r}"
    p = lora_plan(M, din, dout, r, dt, sms)
    how = p["route"] + (f" {TILE_M}x{p['bn']} tiles, grid {p['grid']}"
                        if p["bn"] else "")
    err = check(f"lora_matmul[{case}; route {how}]", got, want,
                torch.ones(M, dtype=torch.bool, device=dev),
                2e-2 if dt == torch.bfloat16 else 1e-4)
    ms = gpu_ms(torch, lambda: ops.lora_matmul(x, w, a, b, scale))
    plain = gpu_ms(torch, lambda: ref.lora_matmul_ref(x, w, a_c, b_s, 1.0))
    base = gpu_ms(torch, lambda: torch.matmul(x, w))
    eb = x.element_size()
    nbytes = eb * (M * din + din * dout + r * din + dout * r + M * dout)
    ops_n = 2 * M * din * dout + 2 * M * r * (din + dout)
    rec = _record(
        "lora_matmul", case, "src/repro_torch/kernels/csrc/lora_matmul.cu",
        "src/repro/kernels/lora_matmul.py:31", err, ms, plain, None, nbytes,
        ops_n, str(dt).split(".")[-1])
    rec.update(kernel_route=p["route"], tile_n=p["bn"], grid=p["grid"],
               base_matmul_ms=base)
    if case in (LORA_MAIN, LORA_RWKV):
        bt = b_s.t()
        rec["unfused_ms"] = gpu_ms(
            torch, lambda: torch.addmm(x @ w, x @ a_c.t(), bt))
    print(f"    base product torch.matmul(x, W) {base:.4f} ms"
          + (f", unfused addmm(x W, x Aᵀ, (s·B)ᵀ) {rec['unfused_ms']:.4f} ms"
             if "unfused_ms" in rec else ""))
    return rec


def train_kernel_cases(torch):
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    records = []
    print("phase 2/3: the federated round's kernels against plain versions; "
          "times beside bounds")

    # lora_matmul: the train step's projections (M = 4 x 512 tokens; wq/wo
    # 2048 -> 2048, wk/wv 2048 -> 512; TinyLlama's wv 2048 -> 256, two
    # column tiles on the persistent grid) at the round's client ranks, the
    # RWKV6 prefill's (M = 8 x 1024 tokens, 2048 -> 2048, r 16), and one
    # ragged M / dout / rank; then ranks 64 and 128 (the wgmma route's
    # widest z and its narrower tiles) and a dout that is not a multiple
    # of 8 (the wmma route); then TinyLlama's wv at phase 14's smallest and
    # largest client ranks, 4 and 64 (wq's 2048 -> 2048 at both is above).
    # bf16: both sides round z and s·B at the same points; the plain version
    # rounds x W and the delta to bf16 before adding, the kernel once at
    # the end, so they differ by up to 2 bf16 ulps of the output (an ulp is
    # up to 2^-7 of |y|): limit 2e-2 of max |y|.  fp32 (TF32 off): sum
    # order over din = 2048: limit 1e-4.
    # No one PyTorch call computes this function: beside the kernel stand
    # the base product alone (torch.matmul) and the unfused composition
    # torch.addmm(x W, x Aᵀ, (s·B)ᵀ) at the two main shapes.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dt, M, dout, r in ((torch.bfloat16, 2048, 2048, 16),
                           (torch.bfloat16, 8192, 2048, 16),
                           (torch.bfloat16, 2048, 512, 16),
                           (torch.bfloat16, 2048, 256, 16),
                           (torch.bfloat16, 2048, 2048, 4),
                           (torch.bfloat16, 2048, 2048, 32),
                           (torch.bfloat16, 2048, 512, 32),
                           (torch.bfloat16, 1999, 1000, 7),
                           (torch.float32, 2048, 2048, 16),
                           (torch.float32, 2048, 512, 32),
                           (torch.float32, 1999, 1000, 7),
                           (torch.bfloat16, 2048, 2048, 64),
                           (torch.bfloat16, 2048, 2048, 128),
                           (torch.bfloat16, 2048, 1003, 5),
                           (torch.bfloat16, 2048, 256, 4),
                           (torch.bfloat16, 2048, 256, 64)):
        records.append(lora_case(torch, gen, sms, dt, M, 2048, dout, r))
    # the Qwen configs' projections at r 16 (M 4 x 512, the trainer's
    # batch): Qwen2-0.5B's 896 -> 896 / 128, Qwen3-4B's 2560 -> 4096 / 1024
    # and 4096 -> 2560, Qwen2.5-14B's and Qwen1.5-32B's 5120 -> 5120 / 1024
    for din, dout in ((896, 896), (896, 128), (2560, 4096), (2560, 1024),
                      (4096, 2560), (5120, 5120), (5120, 1024)):
        records.append(lora_case(torch, gen, sms, torch.bfloat16, 2048, din,
                                 dout, 16))
    # phase 20's train steps at r 16, M 4 x 512: granite-moe's 1024 -> 1024
    # (wq, wo) and 1024 -> 512 (wk, wv); DeepSeek-V3's MLA projections on
    # mla_fwd: wq_a 7168 -> 1536, wq_b 1536 -> 24576, wkv_a 7168 -> 576, wo
    # 16384 -> 7168 (wkv_b is folded into the absorbed weight)
    for din, dout in LORA_MOE_SHAPES:
        records.append(lora_case(torch, gen, sms, torch.bfloat16, 2048, din,
                                 dout, 16))
    # phase 21's train steps at r 16: Phi-3-vision's 3072 -> 3072 at M 4 x
    # 1024 (576 patches and 448 text tokens a row), musicgen's 1536 -> 1536
    # at M 4 x 512, and zamba2's Mamba2 in_proj (2048 -> 8384) and out_proj
    # (4096 -> 2048) at M 4 x 512 (the eval and prefill forwards at C 1;
    # its shared block's 2048 -> 2048 is LORA_MAIN)
    for M, din, dout in LORA_FRONT_SHAPES + tuple((2048,) + s for s in LORA_HYBRID_SHAPES[:2]):
        records.append(lora_case(torch, gen, sms, torch.bfloat16, M, din, dout, 16))

    # flash_attention: the train step's attention (B 4, S 512, 32 heads over
    # 8 KV heads, hd 64; TinyLlama's 32 over 4, 8 query heads a KV head),
    # a window, a ragged S and hd 128.  Then the bf16
    # kernel's edges: hd 16 and 32 (their own swizzle widths), T > S
    # (causal), S not a multiple of 64 or of the block's 128 rows, windows
    # shorter than a key tile and longer than S, group sizes 1, 2 and 8
    # (rows s·g + j split across blocks), non-causal.  Each query row
    # is held to its own magnitude: a row that averages hundreds of values
    # is ~20x smaller than the first rows, so one limit over the whole
    # output would let an error in the long rows through.  bf16: the kernel
    # rounds its output to bf16 (up to 2^-8 of an entry) and P to bf16
    # before P·V (as the TPU kernel does); the plain version stays fp32:
    # limit 1e-2 of the row's max |plain| (6.7e-3 measured at most).  fp32:
    # sum order and exp rounding: limit 1e-5 of it (2.3e-6 measured).
    for dt, B, S, T, H, K, hd, causal, window in (
            (torch.bfloat16, 4, 512, 512, 32, 8, 64, True, 0),
            (torch.bfloat16, 4, 512, 512, 32, 4, 64, True, 0),
            (torch.bfloat16, 4, 512, 512, 32, 8, 64, True, 128),
            (torch.bfloat16, 4, 500, 500, 32, 8, 64, True, 0),
            (torch.bfloat16, 4, 512, 512, 16, 4, 128, True, 0),
            (torch.bfloat16, 2, 300, 300, 8, 8, 16, True, 0),
            (torch.bfloat16, 2, 300, 300, 16, 8, 32, True, 50),
            (torch.bfloat16, 2, 200, 333, 16, 2, 64, True, 0),
            (torch.bfloat16, 2, 77, 77, 8, 1, 64, False, 0),
            (torch.bfloat16, 1, 130, 130, 24, 8, 64, True, 20),
            (torch.bfloat16, 1, 64, 64, 8, 1, 128, True, 1000),
            (torch.float32, 4, 512, 512, 32, 8, 64, True, 0),
            (torch.float32, 2, 300, 300, 16, 4, 128, True, 100),
            (torch.float32, 1, 77, 77, 4, 1, 16, True, 0),
            # head dims the padded tiles opened (same limits): 56 in 64-wide
            # tiles (g 7, ragged S), 96 in 128-wide ones (Phi-3-vision's 32
            # heads, no grouping), and hd 8 and 24
            (torch.bfloat16, 4, 500, 500, 28, 4, 56, True, 0),
            (torch.bfloat16, 4, 512, 512, 32, 32, 96, True, 0),
            (torch.bfloat16, 2, 300, 300, 32, 32, 96, True, 64),
            (torch.bfloat16, 1, 130, 200, 8, 2, 8, False, 0),
            (torch.bfloat16, 1, 130, 130, 8, 2, 24, True, 0),
            (torch.float32, 2, 300, 300, 28, 4, 56, True, 64),
            (torch.float32, 2, 300, 300, 32, 32, 96, True, 0),
            # the Qwen configs' heads: Qwen2-0.5B (14 / 2, hd 64), Qwen3-4B
            # (32 / 8, hd 128), Qwen2.5-14B (40 / 8) and Qwen1.5-32B (40 / 40)
            (torch.bfloat16, 4, 512, 512, 14, 2, 64, True, 0),
            (torch.bfloat16, 4, 512, 512, 32, 8, 128, True, 0),
            (torch.bfloat16, 4, 512, 512, 40, 8, 128, True, 0),
            (torch.bfloat16, 4, 512, 512, 40, 40, 128, True, 0),
            # granite-moe's heads (16 / 8, hd 64): one client's batch and
            # phase 20's cohort of four clients
            (torch.bfloat16, 4, 512, 512, 16, 8, 64, True, 0),
            (torch.bfloat16, 16, 512, 512, 16, 8, 64, True, 0),
            # phase 21: Phi-3-vision's 32 / 32 hd 96 at the vision batch's
            # length (576 patches + 448 tokens), musicgen's 24 / 24 hd 64,
            # zamba2's shared block 32 / 32 hd 64 at a client's batch, the
            # prefill's 2 rows, the eval's 8 and the cohort step's 16
            (torch.bfloat16, 4, 1024, 1024, 32, 32, 96, True, 0),
            (torch.bfloat16, 4, 512, 512, 24, 24, 64, True, 0),
            (torch.bfloat16, 4, 512, 512, 32, 32, 64, True, 0),
            (torch.bfloat16, 2, 512, 512, 32, 32, 64, True, 0),
            (torch.bfloat16, 8, 512, 512, 32, 32, 64, True, 0),
            (torch.bfloat16, 16, 512, 512, 32, 32, 64, True, 0)):
        records.append(flash_case(torch, gen, dt, B, S, T, H, K, hd, causal,
                                  window))

    records += gram_kernel_cases(torch)
    return records


# phase 16 (a): the client axis of lora_matmul (one launch for a cohort)
LORA_COHORT = "bf16, C=4 M=2048 din=2048 dout=2048 r=16"
LORA_COHORT_WV = "bf16, C=4 M=2048 din=2048 dout=256 r=16"
# phase 20 (d)'s granite-moe cohort step: wq/wo 1024 -> 1024, wk/wv
# 1024 -> 512 (the MLA run is sequential, C 1)
LORA_MOE_COHORT = ((1024, 1024), (1024, 512))
LORA_GRANITE_COHORT = "bf16, C=4 M=2048 din=1024 dout=1024 r=16"
# the cohort step's attention: TinyLlama's heads at batch C·B = 4 x 4
FLASH_COHORT = "bf16, causal, B=16 S=512 H=32 K=4 hd=64"


def cohort_kernel_cases(torch):
    """``lora_matmul`` with a client axis (x (C, M, din), A (C, r, din),
    s·B (C, dout, r), W shared) in one launch, against its plain version
    (a per-client loop of ``ref.lora_matmul_ref``) at the C = 1 limits
    (bf16 2e-2 of max |y|, fp32 with TF32 off 1e-4): TinyLlama's ``wq``
    (2048 -> 2048) and ``wv`` (2048 -> 256) at r 16, C 4, M 2048 (a cohort
    step's 4 x 512 tokens a client) in bf16 and fp32, and a ragged C 3, M
    200 (and the wmma route, dout 1003), and granite-moe's cohort step
    (``LORA_MOE_COHORT``, C 4, bf16).  For each: the median of 50 (L2
    flushed), the bound of the whole
    cohort's work, and the same work as C separate C = 1 launches.  Then
    ``flash_attention`` at the cohort step's batch C·B = 16 (TinyLlama's
    32 heads over 4, S 512, bf16, causal) at its own limit, 1e-2 of each
    row's max |plain|."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lora_matmul import TILE_M
    from repro_torch.kernels.lora_matmul import plan as lora_plan
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dname = {torch.bfloat16: "bf16", torch.float32: "fp32"}
    records = []
    print("phase 16 (a): lora_matmul with a client axis, one launch a cohort")
    for dt, C, M, din, dout, r in ((
            (torch.bfloat16, 4, 2048, 2048, 2048, 16),
            (torch.bfloat16, 4, 2048, 2048, 256, 16),
            (torch.float32, 4, 2048, 2048, 2048, 16),
            (torch.float32, 4, 2048, 2048, 256, 16),
            (torch.bfloat16, 3, 200, 2048, 2048, 16),
            (torch.bfloat16, 3, 200, 2048, 256, 16),
            (torch.float32, 3, 200, 2048, 256, 16),
            (torch.bfloat16, 3, 200, 2048, 1003, 5))
            + tuple((torch.bfloat16, 4, 2048, din, dout, 16)
                    for din, dout in LORA_MOE_COHORT + LORA_HYBRID_SHAPES)
            # phase 22 (d): one rank's half of a 4-client cohort (C 2)
            + tuple((dt, 2, 2048, din, dout, 16) for dt in (torch.bfloat16,
                                                            torch.float32)
                    for din, dout in LORA_SHARD_SHAPES)):
        x = torch.randn(C, M, din, generator=gen, device=dev).to(dt)
        w = (torch.randn(din, dout, generator=gen, device=dev) / din ** 0.5).to(dt)
        a = torch.randn(C, r, din, generator=gen, device=dev) * 0.02
        b = torch.randn(C, dout, r, generator=gen, device=dev) * 0.05
        scale = torch.linspace(0.5, 2.0, C, device=dev)
        a_c, b_s = ops.lora_operands(x, w, a, b, scale[:, None, None])
        n0 = ops.lora_matmul.launches
        got = ops.lora_matmul(x.reshape(C * M, din), w, a, b, scale)
        launched = ops.lora_matmul.launches - n0
        ops.lora_matmul.launches = n0          # comparison launches do not count
        want = ref.lora_matmul_cohort_ref(x, w, a_c, b_s, 1.0)
        torch.cuda.synchronize()
        case = f"{dname[dt]}, C={C} M={M} din={din} dout={dout} r={r}"
        p = lora_plan(M, din, dout, r, dt, sms, C)
        how = p["route"] + (f" {TILE_M}x{p['bn']} tiles, {p['tiles']} tiles, "
                            f"grid {p['grid']}" if p["bn"] else "")
        if launched != 1:
            fail(f"lora_matmul[{case}]: {launched} launches for one cohort")
        err = check(f"lora_matmul[{case}; route {how}]",
                    got.reshape(C, M, dout), want,
                    torch.ones(C, dtype=torch.bool, device=dev),
                    2e-2 if dt == torch.bfloat16 else 1e-4)
        xf = x.reshape(C * M, din)
        n0 = ops.lora_matmul.launches
        ms = gpu_ms(torch, lambda: ops.lora_matmul(xf, w, a, b, scale))
        ones = gpu_ms(torch, lambda: [ops.lora_matmul(x[c], w, a[c], b[c], scale[c])
                                      for c in range(C)])
        ops.lora_matmul.launches = n0
        plain = gpu_ms(torch, lambda: ref.lora_matmul_cohort_ref(x, w, a_c, b_s, 1.0))
        eb = x.element_size()
        nbytes = eb * C * (M * din + r * din + dout * r + M * dout) + eb * din * dout
        ops_n = C * (2 * M * din * dout + 2 * M * r * (din + dout))
        records.append(_record(
            "lora_matmul", case, "src/repro_torch/kernels/csrc/lora_matmul.cu",
            "src/repro/kernels/lora_matmul.py:31", err, ms, plain, None, nbytes,
            ops_n, str(dt).split(".")[-1]))
        records[-1].update(kernel_route=p["route"], tile_n=p["bn"],
                           grid=p["grid"], clients=C, c1_launches_ms=ones)
        print(f"    the same work as {C} launches of C = 1: {ones:.4f} ms "
              f"(one cohort launch {ms:.4f} ms)")
    records.append(flash_case(torch, gen, torch.bfloat16, 16, 512, 512, 32, 4,
                              64, True, 0))
    # phase 22 (d): the rank's cohort batch, C 2 x B 4
    for dt in (torch.bfloat16, torch.float32):
        records.append(flash_case(torch, gen, dt, 8, 512, 512, 32, 4, 64,
                                  True, 0))
    return records


GRAM_A = "fp32, A stack (G, r, n) read as its transposed view, G=32 r=64 n=2048"


def gram_kernel_cases(torch):
    """``adapter_gram`` through ``ops.adapter_gram``: the Gram SVD route's B
    stacks (a bucket of 2 leaves x 16 layers, m = 2048 for wq/wo and 512
    for wk/wv, r = Σ r_k up to 128, a tail m), its A stacks (stored (G, r,
    n), passed as the transposed view that ``gram_svd`` takes: the kernel
    reads them in place), the delta route's large r, and ragged edges (r 5
    and 12, rows that are not 16-byte multiples, K under one slice, r > 128
    with off-diagonal tiles), and every stack of phase 20 (d)'s rounds
    (``GRAM_MOE``: m up to 32768, G 1 and 3).  The kernel runs 3xTF32 on
    the tensor cores (lo·lo dropped, ~2^-20 of each product), the plain
    version fp32 FMAs (TF32 off), sums in another order over m rows: limit
    1e-4 of max |xᵀx|.  Two calls on the same input must give the same bits (no
    atomics; fixed summing order), and the result must be exactly
    symmetric.  xᵀx needs only its r(r+1)/2 distinct entries, m
    multiply-adds each: G·m·r·(r+1) operations; ``bound_ms`` holds them to
    the fp32 rate of the CUDA cores (the function's type), and
    ``bound_3xtf32_ms`` to the tensor cores' TF32 rate for the three
    products the kernel does instead.  Beside the kernel: warm (no L2
    flush) time, ``torch.bmm``, reading x once (``x.sum()``), and for the A
    stacks the old path, a contiguous copy of the view and then the kernel.
    The plan's shared memory is held to the built kernel's, and its
    cluster to the clusters the card holds at once."""
    from repro_torch.kernels import adapter_gram as ag
    from repro_torch.kernels import ops, ref
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    records = []
    for tile, layout, strips in ((32, "col", 1), (64, "col", 1), (128, "col", 1),
                                 (128, "col", 2), (32, "row", 1), (64, "row", 1),
                                 (128, "row", 1), (128, "row", 2)):
        want = ag.smem_bytes(tile, layout, strips)
        got = ag.compiled_smem_bytes(tile, layout, strips)
        if got != want:
            fail(f"adapter_gram.smem_bytes({tile}, {layout}, {strips}) = {want}, "
                 f"the built kernel's is {got}")
    held = build_fn("adapter_gram", "adapter_gram_max_clusters", 8)
    for G, m, r, layout, timed in (((32, 2048, 64, "col", True), (32, 2048, 16, "col", True),
                                   (32, 2048, 128, "col", True), (32, 512, 16, "col", True),
                                   (32, 512, 64, "col", True), (32, 512, 128, "col", True),
                                   (32, 2000, 60, "col", True), (32, 2048, 64, "row", True),
                                   (32, 2048, 128, "row", True), (4, 2048, 512, "col", True),
                                   (3, 70, 5, "col", False), (2, 1001, 12, "row", False),
                                   (2, 100, 40, "col", False), (1, 8, 200, "col", False),
                                   (2, 300, 130, "row", False), (5, 257, 96, "col", False))
                                  + tuple(c + (True,) for c in GRAM_MOE + GRAM_HYBRID
                                          + GRAM_SHARD)):
        if layout == "col":
            x = torch.randn(G, m, r, generator=gen, device=dev) * 0.05
            stored, lib = x, (lambda x=x: torch.bmm(x.mT, x))
            case = f"fp32, G={G} m={m} r={r}"
        else:
            stored = torch.randn(G, r, m, generator=gen, device=dev) * 0.05
            x = stored.mT
            lib = (lambda a=stored: torch.bmm(a, a.mT))
            case = (f"fp32, A stack (G, r, n) read as its transposed view, "
                    f"G={G} r={r} n={m}")
        p = ag.plan(G, m, r, layout)
        got = ops.adapter_gram(x)
        again = ops.adapter_gram(x)
        want = ref.adapter_gram_ref(x)
        torch.cuda.synchronize()
        err = check(f"adapter_gram[{case}; tile {p.tile}, cluster {p.cluster}, "
                    f"{p.per} x {p.rows} rows a block]", got, want,
                    torch.ones(G, dtype=torch.bool, device=dev), 1e-4)
        if not torch.equal(got, again):
            fail(f"adapter_gram[{case}]: two calls on the same input differ")
        if not torch.equal(got, got.mT):
            fail(f"adapter_gram[{case}]: the result is not exactly symmetric")
        n_held = held(G, m, r, ag.LAYOUTS.index(layout), p.tile, p.cluster, p.per,
                      p.smem)
        if p.cluster > 1 and G * p.tiles > n_held:
            fail(f"adapter_gram[{case}]: {G * p.tiles} clusters of {p.cluster}, "
                 f"the card holds {n_held} at once")
        if not timed:
            continue
        ms = gpu_ms(torch, lambda: ops.adapter_gram(x))
        warm = gpu_ms(torch, lambda: ops.adapter_gram(x), cold=False)
        plain = gpu_ms(torch, lambda: ref.adapter_gram_ref(x))
        nbytes = 4 * (G * m * r + G * r * r)
        ops_n = G * m * r * (r + 1)
        rec = _record("adapter_gram", case, "src/repro_torch/kernels/csrc/adapter_gram.cu",
                      "src/repro/kernels/adapter_gram.py:41", err, ms, plain,
                      gpu_ms(torch, lib), nbytes, ops_n, "float32",
                      library="torch.bmm(x.mT, x)" if layout == "col"
                      else "torch.bmm(a, a.mT) on the stored a", warm=warm)
        rec.update(kernel_route=p.route, tile=p.tile, cluster=p.cluster,
                   rows_per_block=p.rows_per_block, clusters_held=n_held,
                   same_bits=True, read_once_ms=gpu_ms(torch, lambda: stored.sum()),
                   bound_3xtf32_ms=max(nbytes / HBM_BYTES_PER_S,
                                       3 * ops_n / PEAK_OPS["tf32"]) * 1e3)
        line = (f"    3xTF32 bound {rec['bound_3xtf32_ms']:.4f} ms; reading x once "
                f"(x.sum()) {rec['read_once_ms']:.4f} ms")
        if layout == "row":
            rec["copy_then_kernel_ms"] = gpu_ms(
                torch, lambda: ag.adapter_gram_cuda(x.contiguous(), "col"))
            line += (f"; the old path, a contiguous copy then the kernel, "
                     f"{rec['copy_then_kernel_ms']:.4f} ms")
        print(line)
        records.append(rec)
    return records


def build_fn(name: str, symbol: str, n_int: int):
    """A plain C function of a built kernel library taking ``n_int`` ints
    and returning an int."""
    import ctypes
    from repro_torch.kernels import build
    fn = getattr(build.load(name), symbol)
    fn.argtypes = [ctypes.c_int] * n_int
    fn.restype = ctypes.c_int
    return fn


# -- phases 2 and 3 for the RWKV6 prefill's kernel ----------------------------

WKV6_MAIN = "bf16 r/k/v, B=8 S=1024 H=32 hd=64"


def wkv6_kernel_cases(torch):
    """``wkv6`` at RWKV6-1.6B's prefill shape (B 8, S 1024, 32 heads of 64)
    with bf16 and fp32 r/k/v, and a ragged S of 200 (one partial chunk);
    then head dim 32 (the SMOKE config's; 64 heads of a 2048-wide model);
    then the main shape at strong decay.  First the launch arithmetic of
    ``kernels/wkv6.py`` against the built kernel's shared-memory structs."""
    from repro_torch.kernels import wkv6 as wk
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    records = []
    print("phase 2/3: wkv6 against its plain version; times beside bounds")
    for hd in wk.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            built = wk.compiled_smem_bytes(hd, dt)
            planned = wk.smem_bytes(hd, torch.tensor([], dtype=dt).element_size())
            if built != planned:
                fail(f"wkv6: the plan's shared memory at hd {hd} {dt} is "
                     f"{planned} bytes, the built kernel's {built}")
    main_plan = wk.plan(8, 1024, 32, 64, torch.bfloat16,
                        torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"  plan at the main shape: {main_plan}")
    # The kernel sums in another order than the plain scan and forms its
    # products on the tensor cores in 3xTF32 (~2^-20 of each product's
    # size; plain TF32 would leave ~2^-11), over a state that carries ~30
    # tokens (decays e^{-e^{N(-3, 1)}}) or ~2 (e^{-e^{N(1, 1)}}, where
    # running products of the decays underflow as the true ones do): each
    # (b, h) row within 1e-4 of max(1, its max |plain|).
    for dt, B, S, H, hd, mu in ((torch.bfloat16, 8, 1024, 32, 64, -3),
                                (torch.float32, 8, 1024, 32, 64, -3),
                                (torch.bfloat16, 8, 200, 32, 64, -3),
                                (torch.bfloat16, 8, 1024, 64, 32, -3),
                                (torch.float32, 8, 200, 64, 32, -3),
                                (torch.bfloat16, 8, 1024, 32, 64, 1)):
        rec = wkv6_case(torch, gen, dt, B, S, H, hd, mu)
        # the sequential form's bound (5·hd² + 5·hd fp32 operations a token
        # and head on the CUDA cores), the old design's, for the record
        n = B * S * H * hd
        nbytes = 3 * n * (2 if dt == torch.bfloat16 else 4) + 8 * n + 4 * H * hd
        rec["sequential_bound_ms"] = max(
            nbytes / HBM_BYTES_PER_S, (5 * hd * hd + 5 * hd) * B * S * H
            / PEAK_OPS["float32"]) * 1e3
        print(f"    sequential form's bound {rec['sequential_bound_ms']:.4f} ms")
        if rec["case"] == WKV6_MAIN:
            rec["plan"] = dataclasses.asdict(main_plan)
        records.append(rec)
    return records


# -- phase 2, end to end: the SMOKE configs' widths through the kernels -----

SMOKE_PREFILL = (4, 256)          # batch and tokens of the RWKV6 SMOKE call


def smoke_widths(torch):
    """The two SMOKE configs whose widths only the repaired kernels take,
    driven end to end on the card through the kernel routes, with their
    launch counts: one ``make_prefill_step(rwkv6_1p6b.SMOKE,
    use_kernels=True)`` call (head dim 32: ``wkv6``, ``lora_matmul``) held
    to the plain route, and its bf16 twin; then the ``deepseek_smoke``
    engine (latent 32 + 16: ``mla_ring_decode``) serving phase 4's traffic
    through ``decode_impl="kernel"``, and phase 5's check on it."""
    from repro_torch.configs import lora_targets
    from repro_torch.configs.rwkv6_1p6b import SMOKE
    from repro_torch.device import parity_mode
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_prefill_step
    dev = torch.device(DEVICE)
    B, S = SMOKE_PREFILL
    L, targets = SMOKE.num_layers, lora_targets(SMOKE)
    print(f"phase 2: {SMOKE.name} ({L} L, d {SMOKE.d_model}, "
          f"{SMOKE.num_rwkv_heads} heads of {SMOKE.rwkv_head_dim}) prefill of "
          f"{B} x {S} tokens, kernel route vs plain route; " + parity_mode())
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = SMOKE.replace(dtype=dt)
        params = T.init(cfg, 0, dev)
        gen = torch.Generator(device=dev).manual_seed(8)
        ad = make_adapter(params, targets, 16, gen, T.torch_dtype(dt))
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
        ops.reset_launch_counts()
        got = make_prefill_step(cfg, use_kernels=True)(params, ad, {"tokens": toks})
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want_counts = dict.fromkeys(counts, 0) | {"wkv6": L,
                                                  "lora_matmul": L * len(targets)}
        print(f"  {dt}: kernels {json.dumps(counts)} (expected "
              f"{json.dumps(want_counts)})")
        if counts != want_counts:
            fail(f"phase 2: {cfg.name} ({dt}) did not run its kernels")
        if got.shape != (B, cfg.vocab_size) or not bool(torch.isfinite(got).all()):
            fail(f"phase 2: {cfg.name} ({dt}) logits of shape "
                 f"{tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        rec = {"launches": counts}
        if dt == "float32":
            # phase 12 (a)'s limit: fp32 on both routes (TF32 off), wkv6's
            # FMAs and the sums in another order (8.5e-5 at full width)
            want = make_prefill_step(cfg, use_kernels=False)(params, ad,
                                                             {"tokens": toks})
            rec["logits_max_abs_err"] = check(
                f"{cfg.name} fp32 prefill logits, kernel vs plain route", got,
                want, torch.ones(B, dtype=torch.bool, device=dev), 2e-4)
        out[f"rwkv_smoke_{dt}"] = rec
        del params, ad
    out["deepseek_smoke_e2e"], _ = end_to_end(torch, "2", "deepseek_smoke",
                                              "its SMOKE widths")
    # fp32 cache: the routes differ by sum order only (4.9e-6 at reduced
    # width on the CPU, phase 9's note), so phase 5's limit holds
    out["deepseek_smoke_parity"] = engine_parity(
        torch, "2", "deepseek_smoke", ("float32",), 1e-3, require_equal=True)
    torch.cuda.empty_cache()
    return out


# -- phase 4: the slice end to end ------------------------------------------

def serve_launches(cfg, eng, steps: int) -> dict:
    """The launches ``steps`` engine steps of ``eng`` make: the attention
    kernel (``ring_decode``, or ``mla_ring_decode`` for MLA; none for
    RWKV6) once per layer, ``bgmv`` once per layer per bgmv-routed target
    (every LoRA target but MLA's ``wkv_b``, which is folded into the
    absorbed weights instead), the same at every step width.  The hybrid:
    ``ring_decode`` once per shared application, ``bgmv`` 4 a shared
    application (``wq wk wv wo``) and 2 a Mamba2 layer (``in_proj
    out_proj``)."""
    from repro_torch.configs import lora_targets
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import num_shared_applications
    L = cfg.num_layers
    want = dict.fromkeys(ops.WRAPPERS, 0)
    if cfg.family == "hybrid":
        n = num_shared_applications(cfg)
        want["ring_decode"] = n * steps
        want["bgmv"] = (4 * n + 2 * L) * steps
        return want
    want["bgmv"] = L * (len(lora_targets(cfg)) - cfg.use_mla) * steps
    if cfg.use_mla:
        want["mla_ring_decode"] = L * steps * mla_launches_a_call(eng)
    elif cfg.family != "ssm":
        want["ring_decode"] = L * steps
    return want


DECODE_WINDOWS = {"profiled_decode": ("base", 1),
                  "profiled_decode_adapters": ("live", 1),
                  "profiled_burst": ("base", 8),
                  "profiled_burst_adapters": ("live", 8)}


def end_to_end(torch, phase: str = "4", config: str = "llama3p2_1b",
               widths: str = "published widths", windows=tuple(DECODE_WINDOWS),
               full_layers: int = 0):
    """Serve ``launch.serve``'s traffic on ``config`` through the kernels,
    the engine's steps and bursts as CUDA graphs; the launches must be
    :func:`serve_launches` of the engine steps plus the steps its graphs'
    warm-ups ran.  Then decode windows (phase 15 (c); ``windows`` of
    ``DECODE_WINDOWS``): 16 steps through ``run_steps`` (a graph replay and
    a poll a step) and as two bursts of 8 (a replay and a poll a burst), on
    base-id rows and on rows on the live adapters, each on a fresh batch,
    the wall the median of 5 windows.  ``full_layers``: the depth of a
    config cut to fewer layers, printed beside the cut."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import CONFIGS, MAX_TOKENS, N_REQUESTS, serve
    cfg = CONFIGS[config][0]
    depth = (f"depth cut to {cfg.num_layers} of its {full_layers} layers"
             if full_layers else f"{cfg.num_layers} L")
    moe = (f", {cfg.num_experts} experts top-{cfg.experts_per_token} (e_ff "
           f"{cfg.moe_d_ff}{', one shared' if cfg.num_shared_experts else ''})"
           if cfg.num_experts and cfg.num_layers > cfg.first_dense_layers else "")
    if cfg.use_mla:
        shape = (f"{cfg.num_heads} H, q_lora {cfg.q_lora_rank}, kv_lora "
                 f"{cfg.kv_lora_rank}, qk nope/rope {cfg.qk_nope_head_dim}/"
                 f"{cfg.qk_rope_head_dim}, v {cfg.v_head_dim}{moe}")
        dense = min(cfg.num_layers, cfg.first_dense_layers)
        depth = (f"depth cut to its {dense} dense MLA layers"
                 + (f" and {cfg.num_layers - dense} MLA-MoE layer(s) of its "
                    f"{cfg.num_layers if not full_layers else full_layers}"
                    if cfg.num_layers > dense else ""))
    elif cfg.family == "ssm":
        shape = (f"{cfg.num_rwkv_heads} heads of {cfg.rwkv_head_dim}, decay "
                 f"LoRA {cfg.rwkv_decay_lora}; one token per engine step")
    elif cfg.family == "hybrid":
        shape = (f"Mamba2 d_inner {cfg.d_inner}, {cfg.num_ssm_heads} SSM heads "
                 f"of {cfg.ssm_head_dim}, state {cfg.ssm_state}; one shared "
                 f"attention block ({cfg.num_heads} H / {cfg.num_kv_heads} KV, hd "
                 f"{cfg.head_dim}) after every {cfg.attn_every} layers; one "
                 f"token per engine step")
    else:
        shape = (f"{cfg.num_heads} H / {cfg.num_kv_heads} KV, hd "
                 f"{cfg.head_dim}{moe}")
    print(f"phase {phase}: {cfg.name} at {widths} ({depth}, d "
          f"{cfg.d_model}, {shape}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}), random seeded weights, decode_impl=kernel, graphed")
    ops.reset_launch_counts()
    out = serve(config, device=DEVICE, log=lambda s: print("  " + s))
    counts = ops.launch_counts()
    stats = out["stats"]
    eng = out["engine"]
    steps = eng.steps_run
    want = serve_launches(cfg, eng, steps + eng.warmup_steps)
    print(f"  kernels: {json.dumps(counts)} over {steps} engine steps and "
          f"{eng.warmup_steps} warm-up steps before {sum(eng.trace_counts.values())} "
          f"captures {sorted(map(str, eng.trace_counts))} (expected "
          f"{json.dumps(want)})")
    if counts != want:
        fail(f"phase {phase}: launch counts do not match the engine steps")
    res = out["results"]
    if (len(res) != N_REQUESTS
            or any(len(t) != MAX_TOKENS for t in res.values())):
        fail(f"expected {N_REQUESTS} requests x {MAX_TOKENS} tokens, got "
             f"{ {u: len(t) for u, t in res.items()} }")
    if stats["decode_tokens"] + stats["prefill_step_tokens"] != stats["generated_tokens"]:
        fail(f"the step log accounts for {stats['decode_tokens']} + "
             f"{stats['prefill_step_tokens']} tokens, the requests hold "
             f"{stats['generated_tokens']}")
    if any(not 0 <= x < cfg.vocab_size for t in res.values() for x in t):
        fail("a generated token is outside the vocabulary")
    ids = sorted(set(out["served_by"].values()))
    old, new = out["swap"]
    if len(ids) < 4 or new not in ids or old not in ids or 0 not in ids:
        fail(f"traffic did not cover base, old and new adapter ids: {ids}")
    print(f"  served {len(res)} of {N_REQUESTS} requests, {MAX_TOKENS} tokens "
          f"each, on adapter ids {ids}; swap {old} -> {new}")
    pre = (f"prefill {stats['prefill_tok_s']:.1f} prompt tok/s over "
           f"{stats['prefill_steps']} steps (median "
           f"{stats['prefill_step_ms_median']:.3f} ms; they also emitted "
           f"{stats['prefill_step_tokens']} tokens)" if stats["prefill_steps"]
           else "every step one token wide (prompts consumed one token a step)")
    print(f"  {pre}; decode {stats['decode_tok_s']:.1f} tok/s ({stats['decode_tokens']} tokens "
          f"over {stats['decode_steps']} steps, median "
          f"{stats['decode_step_ms_median']:.3f} ms, bursts of 8 timed as one); "
          f"end to end {stats['e2e_tok_s']:.1f} generated tok/s over a wall of "
          f"{stats['wall_s']:.2f} s; prompt and generated tokens over the "
          f"steps' time {stats['step_tok_s']:.1f} tok/s")
    live = [i for i in ids if i and eng.registry.is_live(i)]
    profiled = {}
    for key in windows:
        rows, poll = DECODE_WINDOWS[key]
        profiled[key] = profile_decode(torch, eng, 16, poll_every=poll, reps=5,
                                       adapter_ids=(0,) if rows == "base" else live)
    captures = {str(k): v for k, v in eng.trace_counts.items()}
    warmup = eng.warmup_steps
    del out, eng
    torch.cuda.empty_cache()
    return dict(stats, launches=counts, warmup_steps=warmup, layers=cfg.num_layers,
                captures=captures, **profiled), counts


def mla_launches_a_call(eng) -> int:
    """Kernels one ``mla_ring_decode`` call of ``eng``'s steps launches
    (``mla_ring_decode.launches``): route ``"mma"`` (the SMOKE widths) adds
    its merge kernel where it splits the ring, at width 1 and at the
    prefill chunk alike on the engines here."""
    from repro_torch.kernels import mla_ring_decode as mla
    ckv = next(c["c_kv"] for c in eng.cache if "c_kv" in c)
    _, B, cap, kvr = ckv.shape
    how = mla.route(ckv.dtype, kvr, eng.cfg.qk_rope_head_dim)
    per = {mla.launches(how, mla.splits(B, C, eng.dcfg.num_heads, cap,
                                        ckv.device, how)[0])
           for C in {1, eng.chunk}}
    if len(per) != 1:
        fail(f"mla_ring_decode launches a call differ by step width: {per}")
    return per.pop()


def profile_decode(torch, eng, steps: int = 10, adapter_ids=(0,),
                   poll_every: int = 1, reps: int = 1):
    """Where a decode step's time goes: ``steps`` width-1 engine steps of a
    fresh full batch (``run_steps``; with ``poll_every > 1`` as bursts of
    that many steps, one graph replay and one poll a burst), once under
    ``torch.profiler`` (device time by kernel) and ``reps`` times without
    it (wall time per step, the median); each window starts on a fresh
    batch whose prompts are consumed.  The batch's rows cycle over
    ``adapter_ids``: by default all on the base id, so every ``bgmv``
    launch takes its rank-0 exit; the engine's live adapters make its rows
    do the shrink and expand."""
    from repro_torch.serve.engine import SamplingParams

    def fresh_batch():
        eng.run()                          # what the last window left
        for i in range(eng.B):
            eng.submit(list(range(1 + i, 17 + i)),
                       SamplingParams(max_tokens=steps + 4),
                       adapter_id=adapter_ids[i % len(adapter_ids)])
        eng.run_steps(1 + -(-16 // eng.chunk))   # admission and the prompts
        torch.cuda.synchronize()

    logged = [0]

    def calls():
        """The engine's calls since the last read, each ((width, steps),
        device ms): one graph replay a call, a burst of n steps one call."""
        log = eng.step_log()
        new, logged[0] = log[logged[0]:], len(log)
        out, i = [], 0
        while i < len(new):
            s = new[i]
            out.append(((s["width"], s["burst"]), s["ms"] * s["burst"]))
            i += s["burst"]
        return out

    def run(n):
        eng.run_steps(n, poll_every)

    def run_witnessed(n):
        """``run(n)``; every row, active throughout, must emit ``n`` tokens:
        each call ran on the card."""
        g0 = eng._state["gen_count"].clone()
        run(n)
        short = int((eng._state["gen_count"] - g0 != n).sum())
        if short:
            fail(f"decode window: {short} of {eng.B} rows emitted fewer than "
                 f"{n} tokens in {n} steps")

    rows = ("base id" if tuple(adapter_ids) == (0,) else
            f"adapter ids {'/'.join(map(str, adapter_ids))}")
    how = f"bursts of {poll_every}" if poll_every > 1 else "run_steps"
    out = profile_window(torch, run, steps,
                         f"decode step ({how}), {steps} steps x {eng.B} rows "
                         f"on {rows}" + (f", wall the median of {reps}"
                                         if reps > 1 else ""),
                         setup=fresh_batch, reps=reps, calls=calls,
                         run_profiled=run_witnessed)
    eng.run()
    return dict(out, how=how)


def wrapper_of(kernel: str):
    """The ops wrapper whose counter counts a device kernel of this name
    (``KERNELS_OF``), or None for a kernel that is not the port's."""
    return next((w for w, pat in KERNELS_OF.items() if re.search(pat, kernel)),
                None)


def replay_launches(made, launch_ids, kernels):
    """The port's launches a window of engine calls made, by wrapper, read
    from its profiler trace, and the calls whose replay the trace shows
    short.  ``made``: the calls, each by its graph (one replay a call), all
    of one graph; ``launch_ids``: the correlation ids of the trace's
    ``cudaGraphLaunch`` calls; ``kernels``: (correlation id, wrapper) of
    each of the port's kernels in the trace.  Every replay of a graph runs
    the same kernels, and a trace can lose records but never adds any, so
    each call launched what the fullest traced replay holds (the largest
    count of each wrapper's kernels over the replays)."""
    if len(set(made)) > 1:
        raise ValueError(f"a window of calls of several graphs: {sorted(set(made))}")
    per = {cid: collections.Counter() for cid in launch_ids}
    for cid, wrapper in kernels:
        if cid in per:
            per[cid][wrapper] += 1
    full = collections.Counter()
    for got in per.values():
        full |= got
    short = len(made) - sum(got == full for got in per.values())
    return {w: n * len(made) for w, n in full.items()}, short


# idle seconds inside the profiler before and after a profiled run: device
# records near the profiler's start or stop can fall out of its trace
# (scripts/trace_loss.py)
TRACE_MARGIN_S = 0.05


def profile_window(torch, run, steps: int, label: str, before: str = "",
                   setup=None, reps: int = 1, calls=None, run_profiled=None,
                   raw_events: bool = False, wall_ms: float = 0.0):
    """``run(steps)`` once under ``torch.profiler`` (device time by kernel,
    host time by operator; ``run_profiled`` in its place if given) and
    ``reps`` times without it (wall time per step, the median); the idle
    share is 1 - device busy / wall.  ``setup()``, if given, runs untimed
    before each of them.  With ``before`` (a regex of kernel names), also
    (the device kernel that ran just before, the kernel) for each launch of
    a matching kernel, in order.  ``calls`` (an engine's calls since its
    last read, each (graph, device ms) by the step log's CUDA events)
    splits the idle into the time inside the calls (their ms - busy: graph
    launch and the gaps between a graph's kernels) and between them (wall -
    their ms: the host's poll and bookkeeping), medians over the ``reps``;
    and it holds the launch counters' increase over the profiled run equal
    to the port's kernels its trace shows the calls' replays ran
    (:func:`replay_launches`): the counters of a graph's replays are added
    by bookkeeping, the trace sees the kernels run.  The profiled run sits
    ``TRACE_MARGIN_S`` inside the profiler's start and stop.

    ``raw_events``: trace the device (and the CUDA runtime calls) only and
    sum the trace's raw records by name, instead of building the
    profiler's event tree, which costs ~70 µs an event on the host and
    minutes for a window of ~10^6 events; ``wall_ms`` > 0: the wall per
    step measured by the caller, in place of the ``reps`` timed runs."""
    from repro_torch.kernels import ops
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if setup:
        setup()
    if calls:
        calls()                          # drop the calls setup() made
    counted0 = ops.launch_counts()
    activities = [ProfilerActivity.CUDA] + ([] if raw_events else [ProfilerActivity.CPU])
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        (run_profiled or run)(steps)
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    counted = ops.launch_delta(counted0, ops.launch_counts())
    made = [k for k, _ in calls()] if calls else []
    walls, replays = [wall_ms] if wall_ms else [], []
    for _ in range(0 if wall_ms else reps):
        if setup:
            setup()
        if calls:
            calls()                      # drop the calls setup() made
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
        if calls:
            replays.append(sum(ms for _, ms in calls()) / steps)
    wall_ms = statistics.median(walls)
    by_kernel, by_op = collections.Counter(), collections.Counter()
    if raw_events:
        for e in prof.profiler.kineto_results.events():
            into = by_kernel if e.device_type() == DeviceType.CUDA else by_op
            into[e.name()] += e.duration_ns() / 1e6 / steps
    else:
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:          # kernels and copies
                by_kernel[e.key] = e.self_device_time_total / 1e3 / steps
            elif e.self_cpu_time_total > 0:                # host operators
                by_op[e.key] = e.self_cpu_time_total / 1e3 / steps
    busy = sum(by_kernel.values())
    preceded = []
    if before:
        kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        preceded = [(kern[i - 1].name if i else "", e.name)
                    for i, e in enumerate(kern) if re.search(before, e.name)]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    # the port's own kernels, whether or not they are among the top ones
    port = {k: ms for k, ms in by_kernel.items() if re.search(PORT_KERNELS, k)}
    print(f"  {label}: wall {wall_ms:.3f} ms per step (no profiler); device "
          f"busy {busy:.3f} ms per step (profiler): idle share "
          f"{1 - busy / wall_ms:.3f}")
    for name, ms in top:
        print(f"    device {ms:8.4f} ms/step  {name[:80]}")
    for name, ms in sorted(port.items(), key=lambda kv: -kv[1]):
        print(f"    port kernel {ms:8.4f} ms/step  {name[:80]}")
    for name, ms in top_host:
        print(f"    host   {ms:8.4f} ms/step  {name[:80]} (under the profiler)")
    out = {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
           "idle_share": 1 - busy / wall_ms,
           "top_kernels_ms_per_step": dict(top),
           "port_kernels_ms_per_step": port,
           "top_host_ops_ms_per_step_profiled": dict(top_host)}
    if replays:
        call_ms = statistics.median(replays)
        out.update(call_ms_per_step=call_ms,
                   idle_in_calls_share=(call_ms - busy) / wall_ms,
                   idle_between_calls_share=(wall_ms - call_ms) / wall_ms)
        print(f"    idle inside the engine calls {(call_ms - busy) / wall_ms:.3f} "
              f"(calls {call_ms:.3f} ms per step by CUDA events, median of "
              f"{reps}), between them {(wall_ms - call_ms) / wall_ms:.3f}")
    if calls:
        events = prof.events()
        launches = [e.id for e in events if e.device_type == DeviceType.CPU
                    and e.name == "cudaGraphLaunch"]
        kernels = [(e.id, w) for e in events if e.device_type == DeviceType.CUDA
                   and (w := wrapper_of(e.name))]
        traced, short = replay_launches(made, launches, kernels)
        seen = collections.Counter(w for _, w in kernels)
        print(f"    launches in the profiled run: counted {json.dumps(counted)}, "
              f"{len(made)} calls of what the fullest traced replay holds "
              f"{json.dumps(traced)} ({len(launches)} replays traced, {short} "
              f"short; kernels in the trace {json.dumps(seen)})")
        if counted != traced:
            fail(f"{label}: the launch counters rose by {counted} while the "
                 f"{len(made)} calls' replays ran {traced} launches of the "
                 f"port's kernels by the trace")
        out.update(launches_counted_and_traced=counted,
                   replays_short_in_trace=short)
    if before:
        out["kernel_before_each"] = preceded
    return out


# -- phase 5: the engine, kernels against plain versions --------------------

@contextlib.contextmanager
def decode_route(impl: str):
    """The ``decode_impl`` of a route name of :func:`engine_parity`, with
    ``"plain-kernel"`` the kernel route whose ``ring_decode`` is the
    kernel's plain version (``ref.ring_decode_ref``: every score in fp32,
    an int8 cache dequantized whole in fp32) for the block's duration."""
    from repro_torch.kernels import ops, ref
    if impl != "plain-kernel":
        yield impl
        return

    def plain(q, k, v, pos, length, n_tokens=None, window=0, k_scale=None,
              v_scale=None):
        return ref.ring_decode_ref(q, k, v, pos, length, n_tokens,
                                   window=window, k_scale=k_scale,
                                   v_scale=v_scale)

    kernel = ops.ring_decode
    ops.ring_decode = plain
    try:
        yield "kernel"
    finally:
        ops.ring_decode = kernel


def engine_parity(torch, phase: str = "5", config: str = "llama3p2_1b",
                  kv_dtypes=("float32",), logit_tol: float = 1e-3,
                  require_equal: bool = False,
                  routes=(("kernel", "kernel"), ("dense", "plain")),
                  layers: int = 0):
    """The engine at full width in fp32 (TF32 off), the first of ``routes``
    (``(decode_impl, lora_impl)``: by default the kernel routes) against
    the second (the plain routes), once per cache dtype in ``kv_dtypes``:
    the first prefill
    step's logits (a 16-token chunk; for RWKV6, whose recurrence takes no
    chunks, the logits after 8 one-token steps: at the init's zero bonus u
    the first token's time mix is exactly zero and never reaches the
    adapters) within ``logit_tol`` of max(1, |logit|), then the greedy
    tokens of 8 requests over 16 steps (required equal with
    ``require_equal``).  ``layers`` > 0 cuts the depth."""
    import numpy as np
    from repro_torch.configs import lora_targets
    from repro_torch.device import parity_mode
    from repro_torch.launch.serve import CONFIGS, make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    from repro_torch.serve.adapters import AdapterRegistry, attach
    from repro_torch.serve.engine import SamplingParams, ServeEngine
    (got, _), (ref, _) = routes
    cfg = CONFIGS[config][0].replace(
        dtype="float32", **({"num_layers": layers} if layers else {}))
    cut = f", depth cut to {layers} layers" if layers else ""
    print(f"phase {phase}: engine on the card, {got} vs {ref} routes, "
          f"{cfg.name} at full width in fp32{cut}; " + parity_mode())
    dev = torch.device(DEVICE)
    params = T.init(cfg, 1, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    targets = lora_targets(cfg)
    reg = AdapterRegistry(init_lora(params, targets, 4, 8.0, gen), page_rank=4,
                          max_rank=16, device=dev)
    aid = [0] + [reg.register(f"r{r}", make_adapter(params, targets, r, gen,
                                                     torch.float32))
                 for r in (4, 8, 16)]
    rng = np.random.default_rng(3)
    B = 8
    C, steps = (1, 8) if cfg.family == "ssm" else (16, 1)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, C * steps)),
                           device=dev)
    n = torch.tensor([16, 16, 9, 16, 3, 16, 16, 1] if C == 16
                     else [1, 1, 1, 1, 0, 1, 1, 1], dtype=torch.int32, device=dev)
    ids = torch.tensor([aid[i % 4] for i in range(B)], dtype=torch.int32,
                       device=dev)
    valid = torch.arange(C, device=dev)[None, :] < n[:, None]
    results = {}
    for kv_name in kv_dtypes:
        kv = getattr(torch, kv_name)
        lg = {}
        for impl, lora in routes:
            cache = T.init_cache(cfg, B, 1024, kv, prefill_chunk=C, device=dev)
            with decode_route(impl) as how:
                for i in range(steps):
                    lg[impl], cache = T.decode(
                        cfg, params, cache,
                        {"tokens": toks[:, i * C:(i + 1) * C]},
                        attach(reg.device_state, ids, impl=lora), n_tokens=n,
                        decode_impl=how)
        what = ("first prefill step logits" if steps == 1
                else f"logits after {steps} one-token steps")
        err = check(f"{kv_name} cache: {what}", lg[got], lg[ref],
                    valid, logit_tol)
        del lg
        outs = {}
        for impl, lora in routes:
            with decode_route(impl) as how:
                eng = ServeEngine(cfg, params, registry=reg, batch_slots=B,
                                  capacity=1024, kv_dtype=kv, prefill_chunk=C,
                                  decode_impl=how, lora_impl=lora, device=dev)
                prng = np.random.default_rng(4)
                uids = [eng.submit(prng.integers(1, cfg.vocab_size,
                                                 int(prng.integers(32, 65))).tolist(),
                                   SamplingParams(max_tokens=16),
                                   adapter_id=aid[i % 4])
                        for i in range(B)]
                res = eng.run()
            outs[impl] = [res[u] for u in uids]
            del eng
        pairs = [(a, b) for ra, rb in zip(outs[got], outs[ref])
                 for a, b in zip(ra, rb)]
        agree = sum(a == b for a, b in pairs) / max(1, len(pairs))
        print(f"  {kv_name} cache: greedy-token agreement over 16 steps x {B} "
              f"requests: {agree:.4f} ({sum(a == b for a, b in pairs)}/"
              f"{len(pairs)})")
        if require_equal and (agree != 1.0 or len(pairs) != 16 * B):
            fail(f"phase {phase}: the {got} and {ref} engines' greedy tokens "
                 f"differ ({kv_name} cache)")
        results[kv_name] = {"logits_max_abs_err": err, "greedy_agreement": agree}
    del params, reg
    torch.cuda.empty_cache()
    return results if len(results) > 1 else results[kv_dtypes[0]]


# -- phase 6: the federated slice end to end ---------------------------------

FED_ROUNDS = 2
FED_SEQ = 512
FED_BATCH = 4


def federated_round(torch):
    import numpy as np
    from repro_torch.common.config import FedConfig, LoRAConfig, OptimConfig
    from repro_torch.configs.llama3p2_1b import CONFIG
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.core.runtime import SequentialRunner
    from repro_torch.core.runtime.runners import to_device
    from repro_torch.data.synthetic import make_eval_data
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import adamw_init
    cfg = CONFIG
    L = cfg.num_layers
    print(f"phase 6: {FED_ROUNDS} FLoRIST rounds of {cfg.name} at full width "
          f"({L} L, d {cfg.d_model}, {cfg.num_heads} H / {cfg.num_kv_heads} KV, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}; random seeded weights), 8 "
          f"clients of ranks 4/8/16/32, 4 a round, 4 local steps of "
          f"{FED_BATCH} x {FED_SEQ} tokens, Gram SVD route")
    fed = FedConfig(num_clients=8, clients_per_round=4, heterogeneous=True,
                    rank_distribution=((4, 2), (8, 2), (16, 2), (32, 2)),
                    tau=0.9, method="florist")
    lora = LoRAConfig(rank=16, alpha=16.0, targets=("wq", "wk", "wv", "wo"))
    runner = SequentialRunner(record_steps=True)
    t0 = time.perf_counter()
    tr = FederatedTrainer(cfg, fed, lora, OptimConfig(lr=3e-4),
                          eval_data=make_eval_data(num_samples=16,
                                                   seq_len=FED_SEQ,
                                                   vocab=cfg.vocab_size),
                          batch_size=FED_BATCH, local_steps=4, seq_len=FED_SEQ,
                          svd_method="gram", runner=runner, device=DEVICE)
    torch.cuda.synchronize()
    print(f"  set-up (weights, data, trainer): {time.perf_counter() - t0:.1f} s")
    rounds = []
    ops.reset_launch_counts()
    for rnd in range(FED_ROUNDS):
        before, n_log = ops.launch_counts(), len(runner.step_log())
        rec = tr.run_round(rnd)
        after = ops.launch_counts()
        step_ms = [e["ms"] for e in runner.step_log()[n_log:]]
        steps = len(step_ms)
        buckets = len({(n, m) for _, n, m in tr.aggregator.dims.values()})
        want = {"lora_matmul": L * len(lora.targets) * steps,
                "flash_attention": L * (steps + 1),          # + one eval step
                "adapter_gram": 2 * buckets}                 # B and A stacks
        got = {k: after[k] - before[k] for k in want}
        ranks = tr.global_state.ranks
        r_sum = sum(tr.aggregator.client_ranks)
        tok_s = steps * FED_BATCH * FED_SEQ / (sum(step_ms) / 1e3)
        print(f"  round {rnd}: eval loss {rec.eval_loss:.4f} acc "
              f"{rec.eval_acc:.4f}; clients of ranks "
              f"{tr.aggregator.client_ranks} (Σ {r_sum}); upload "
              f"{rec.upload_bytes} B, download {rec.download_bytes} B; wall "
              f"{rec.wall_secs:.2f} s, finalize {rec.finalize_secs * 1e3:.1f} "
              f"ms; {steps} train steps, median {statistics.median(step_ms):.2f}"
              f" ms (CUDA events), {tok_s:.0f} train tok/s")
        for path, ps in ranks.items():
            print(f"    kept ranks {'/'.join(map(str, path))}: {ps}")
        print(f"    launches {json.dumps(got)}; expected {json.dumps(want)}")
        if got != want:
            fail(f"round {rnd}: launch counts {got} != {want}")
        if not np.isfinite(rec.eval_loss):
            fail(f"round {rnd}: eval loss {rec.eval_loss} is not finite")
        if any(not 1 <= p <= r_sum for ps in ranks.values() for p in ps):
            fail(f"round {rnd}: a kept rank is outside [1, {r_sum}]")
        rounds.append({"record": dataclasses.asdict(rec),
                       "ranks": {"/".join(map(str, k)): v
                                 for k, v in ranks.items()},
                       "client_ranks": list(tr.aggregator.client_ranks),
                       "train_step_ms": step_ms,
                       "train_step_ms_median": statistics.median(step_ms),
                       "train_tok_s": tok_s, "launches": got})
    counts = {k: v for k, v in ops.launch_counts().items()
              if k in ("lora_matmul", "flash_attention", "adapter_gram")}

    # a window of train steps of one rank-16 client, profiled
    step = tr._train_step()
    data = tr.clients[0]
    batch = {"tokens": torch.as_tensor(data.tokens[:FED_BATCH], device=DEVICE).long(),
             "loss_mask": torch.as_tensor(data.loss_mask[:FED_BATCH], device=DEVICE)}
    state = {"a": to_device(tr._client_init(0, 16), tr.device)}
    state["opt"] = adamw_init(state["a"])

    def run(n):
        for _ in range(n):
            state["a"], state["opt"], _ = step(tr.params, state["a"],
                                               state["opt"], batch)

    run(1)
    window = profile_window(torch, run, 3,
                            f"train step, {FED_BATCH} x {FED_SEQ} tokens, r=16")
    finalize = profile_finalize(torch, tr.aggregator, buckets)
    del tr, state
    torch.cuda.empty_cache()
    return {"rounds": rounds, "launches": counts, "profiled_train_step": window,
            "profiled_finalize": finalize}, counts


def profile_finalize(torch, agg, buckets: int, n: int = 3):
    """The last round's FLoRIST finalize again, ``n`` times, profiled: the
    aggregator keeps its stacks until the next ``begin_round``, so each call
    runs the Gram route on the round's real shapes (16 layers, wq wk wv wo
    in two buckets, Σ r_k of the round's clients).  Prints wall, device busy
    and idle share, the top device and host operations, ``adapter_gram``'s
    device time a finalize, and the kernels before its launches: an A
    stack's launch must follow no copy (its transposed view is read where
    it lies)."""
    from repro_torch.kernels import ops

    def run(k):
        for _ in range(k):
            agg.finalize()
    run(1)
    torch.cuda.synchronize()
    before = ops.launch_counts()["adapter_gram"]
    out = profile_window(torch, run, n,
                         f"FLoRIST finalize (Gram route, {buckets} buckets, "
                         f"clients of ranks {agg.client_ranks}), per finalize",
                         before=r"\bgram_mma\b")
    launched = ops.launch_counts()["adapter_gram"] - before
    if launched != 2 * n * 2 * buckets:          # the profiled run and the timed one
        fail(f"finalize window: {launched} adapter_gram launches, expected "
             f"{4 * n * buckets}")
    # the profiler names the build: gram_mma<NB, ROWL, ...>, ROWL true for
    # an A stack read where it lies (the row layout)
    prev = out.pop("kernel_before_each")
    a_prev = [p for p, k in prev if re.search(r"gram_mma<\d+, true", k)]
    out["kernel_before_a_stack"] = sorted(set(a_prev))
    out["kernel_before_b_stack"] = sorted({p for p, k in prev
                                           if re.search(r"gram_mma<\d+, false", k)})
    print("    kernel before each A stack's adapter_gram: "
          + "; ".join(p[:70] for p in out["kernel_before_a_stack"]))
    print("    kernel before each B stack's adapter_gram: "
          + "; ".join(p[:70] for p in out["kernel_before_b_stack"]))
    if not a_prev:
        fail("finalize window: the profile shows no A stack's adapter_gram launch")
    if any(re.search("copy", p, re.I) for p in a_prev):
        fail("finalize window: a copy kernel runs in front of an A stack's "
             "adapter_gram launch")
    out["adapter_gram_ms_per_finalize"] = sum(
        ms for k, ms in out["port_kernels_ms_per_step"].items() if "gram_mma" in k)
    print(f"    adapter_gram device time {out['adapter_gram_ms_per_finalize']:.4f} ms "
          f"a finalize")
    return out


# -- phase 7: the federated path, kernels against plain routes, fp32 ---------

def _leaf_paths(tree, path=()):
    """The key path of each leaf of ``tree``, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _leaf_paths(tree[k], path + (k,))]
    return [path]


def step_route_parity(torch, label, cfg, params, ad, batches, lr: float = 3e-4,
                      loss_chunk: int = 64):
    """The train step on the kernel route against the plain route from the
    same adapters ``ad`` (B ≠ 0), fp32 with TF32 off (the caller's parity
    mode): the first batch's gradients, the losses of two steps
    (``make_train_step``) and the adapters after them.

    The gradients are held leaf by leaf to max(1e-4, 4 x the leaf's own
    fp32 conditioning) of the leaf's largest, the conditioning being how
    far the plain route's gradients move when the embedding is perturbed
    by fp32 rounding (a relative 2^-24 · N(0, 1)): a recurrence over
    hundreds of tokens (RWKV6) moves them by ~1e-4 of that, a transformer
    by ~1e-6."""
    from repro_torch.common.config import OptimConfig
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.train.step import _unflatten, loss_fn, make_train_step

    def first_grads(use_kernels, p):
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(ad)]
        loss, _ = loss_fn(cfg, p, _unflatten(ad, leaves), batches[0],
                          loss_chunk, use_kernels)
        return [g.detach() for g in torch.autograd.grad(loss, leaves)]

    gen = torch.Generator(device=params["embed"].device).manual_seed(9)
    noise = torch.randn(params["embed"].shape, generator=gen,
                        device=params["embed"].device)
    perturbed = dict(params, embed=params["embed"] * (1 + 2.0 ** -24 * noise))
    gk, gp, gq = (first_grads(True, params), first_grads(False, params),
                  first_grads(False, perturbed))
    del noise, perturbed
    out = {}
    for use_kernels in (True, False):
        step = make_train_step(cfg, OptimConfig(lr=lr), loss_chunk=loss_chunk,
                               use_kernels=use_kernels)
        a, opt, losses = ad, adamw_init(ad), []
        for b in batches:
            a, opt, m = step(params, a, opt, b)
            losses.append(float(m["loss"]))
        out[use_kernels] = (losses, a)
    res = {"losses_kernel": out[True][0], "losses_plain": out[False][0]}
    paths = _leaf_paths(ad)
    gmax = [g.abs().max().clamp_min(1e-30) for g in gp]
    cond = [((q - g).abs().max() / m).item() for q, g, m in zip(gq, gp, gmax)]
    tol = [max(1e-4, 4 * c) for c in cond]
    rel = [((k - g).abs().max() / m).item() for k, g, m in zip(gk, gp, gmax)]
    worst = sorted(zip((r / t for r, t in zip(rel, tol)), rel, tol, cond,
                       ("/".join(map(str, q)) for q in paths)))
    res.update(grads_worst_leaf_rel=max(rel), grads_worst_leaf_cond=max(cond),
               grads_worst_share_of_limit=worst[-1][0])
    print(f"  first batch's gradients, max |Δg| / max |g| by leaf: kernel vs "
          f"plain at most {max(rel):.2e}; plain with the embedding perturbed by "
          f"fp32 rounding vs plain at most {max(cond):.2e}; nearest its limit "
          + ", ".join(f"{q} {r:.2e} (limit {t:.2e})" for _, r, t, _, q in worst[-3:]))
    if worst[-1][0] > 1:
        fail(f"{label}: the gradients of the two routes differ")
    # the losses: fp32 on both routes, sums in another order through the
    # layers and a large-vocabulary logsumexp: limit 1e-5 relative
    for i, (lk, lp) in enumerate(zip(out[True][0], out[False][0])):
        ok = abs(lk - lp) <= 1e-5 * max(1.0, abs(lp))
        print(f"  train step {i + 1} loss: kernel {lk:.7f}, plain {lp:.7f} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{label}: train-step losses of the two routes differ")
    # the adapters after 2 steps.  Adam divides by |g|: an entry whose
    # gradient is within the routes' difference of zero can step by up to
    # lr one way on one route and the other way on the other, so A and B
    # are held to a mean |Δ| ≤ 1e-3·lr (a wrong gradient would move most
    # entries by ~lr), and the entries with |Δ| > 0.1·lr whose first
    # gradient is not within its leaf's limit above of zero (where a sign
    # cannot differ) to a share of at most 1e-5 (no bound on max |Δ| can
    # fail: an Adam step moves an entry by at most ~lr).  scale's gradient
    # sums over every token and is never near zero: max |Δ| ≤ 1e-6.
    ka = tree_leaves(out[True][1])
    pa = tree_leaves(out[False][1])
    far, near, n_ab, d_ab, d_s = 0, 0, 0, [], []
    for x, y, q, g, m, t in zip(ka, pa, paths, gp, gmax, tol):
        d = (x - y).abs()
        if q[-1] == "scale":
            d_s.append(d.flatten())
            continue
        d_ab.append(d.flatten())
        n_ab += d.numel()
        big = d > 0.1 * lr
        far += int(big.sum())
        near += int((big & (g.abs() <= t * m)).sum())
    d_ab, d_s = torch.cat(d_ab), torch.cat(d_s)
    mean_ab, max_ab, max_s = float(d_ab.mean()), float(d_ab.max()), float(d_s.max())
    share = (far - near) / n_ab
    res.update(adapters_mean_abs_diff=mean_ab, adapters_max_abs_diff=max_ab,
               adapters_above_0p1_lr=far, adapters_above_0p1_lr_near_zero_grad=near,
               adapters_share_above_0p1_lr_unexplained=share,
               scale_max_abs_diff=max_s)
    print(f"  adapters after {len(batches)} steps: mean |Δ| {mean_ab:.3e} (limit "
          f"{1e-3 * lr:.1e}); |Δ| > 0.1·lr on {far} of {n_ab} entries, {near} of "
          f"them with a first gradient within its leaf's limit of zero (the "
          f"rest: share {share:.2e}, limit 1e-5); max |Δ| {max_ab:.3e}; scale "
          f"max |Δ| {max_s:.3e} (limit 1e-6)")
    if mean_ab > 1e-3 * lr or share > 1e-5 or max_s > 1e-6:
        fail(f"{label}: the adapters of the two routes differ")
    return res


def federated_parity(torch):
    import numpy as np
    from repro_torch.configs.llama3p2_1b import CONFIG
    from repro_torch.core.aggregators import FloristAggregator
    from repro_torch.data.synthetic import make_federated_data
    from repro_torch.device import parity_mode
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    cfg = CONFIG.replace(dtype="float32", num_layers=4)
    L = cfg.num_layers
    print(f"phase 7: federated path on the card, kernel routes vs plain routes, "
          f"full width in fp32, depth cut to {L} layers; " + parity_mode())
    dev = torch.device(DEVICE)
    params = T.init(cfg, 3, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    ad = init_lora(params, ("wq", "wk", "wv", "wo"), 16, 16.0, gen)
    for leaf in ad["blocks"][0]["attn"].values():   # B ≠ 0: dscale ≠ 0 at once
        leaf["B"] = torch.randn(leaf["B"].shape, generator=gen, device=dev) * 0.01
    data = make_federated_data(num_clients=1, seq_len=FED_SEQ,
                               vocab=cfg.vocab_size, seed=5)[0]
    batches = [{"tokens": torch.as_tensor(data.tokens[i:i + 2], device=dev).long(),
                "loss_mask": torch.as_tensor(data.loss_mask[i:i + 2], device=dev)}
               for i in (0, 2)]
    res = step_route_parity(torch, "phase 7", cfg, params, ad, batches)

    # one finalize on the Gram route (adapter_gram) against the LAPACK route
    clients, ranks = [], (4, 8, 16, 32)
    for r in ranks:
        tree = {"blocks": {0: {"attn": {}}}}
        for name, wt in sorted(params["blocks"][0]["attn"].items()):
            if name not in ("wq", "wk", "wv", "wo"):
                continue
            _, din, dout = wt.shape
            tree["blocks"][0]["attn"][name] = {
                "A": torch.randn(L, r, din, generator=gen, device=dev) * 0.02,
                "B": torch.randn(L, dout, r, generator=gen, device=dev) * 0.01,
                "scale": torch.full((L,), 16.0 / r, device=dev)}
        clients.append(tree)
    w = np.random.default_rng(7).dirichlet(np.ones(len(ranks)))
    agg = {m: FloristAggregator(tau=0.9, svd_method=m).aggregate(clients, w)
           for m in ("gram", "svd")}
    worst_s = worst_p = 0.0
    for path, ps in agg["svd"].ranks.items():
        if agg["gram"].ranks[path] != ps:
            fail(f"phase 7: kept ranks of {path} differ: "
                 f"{agg['gram'].ranks[path]} vs {ps}")
        for sg, sv in zip(agg["gram"].spectra[path], agg["svd"].spectra[path]):
            # the Gram route resolves σ down to σ_max·√(r·eps) only
            big = sv > 2 * sv[0] * np.sqrt(len(sv) * np.finfo(np.float32).eps)
            worst_s = max(worst_s, float(np.abs(sg - sv)[big].max() / sv[0]))
        gl = agg["gram"].global_adapters
        sl = agg["svd"].global_adapters
        for k in path:
            gl, sl = gl[k], sl[k]
        pg = torch.einsum("lmr,lrn->lmn", gl["B"], gl["A"])
        pv = torch.einsum("lmr,lrn->lmn", sl["B"], sl["A"])
        worst_p = max(worst_p, float((pg - pv).abs().max() / pv.abs().max()))
    # fp32: the Gram route squares the condition number; above its
    # resolution limit spectra and products agree to 1e-4 of their largest
    print(f"  finalize gram vs svd: ranks equal on {len(agg['svd'].ranks)} "
          f"leaves x {L} layers; spectra max rel err {worst_s:.2e}, B_g A_g "
          f"max rel err {worst_p:.2e} (limit 1e-4)")
    if worst_s > 1e-4 or worst_p > 1e-4:
        fail("phase 7: the Gram route disagrees with the LAPACK route")
    res.update(spectra_max_rel_err=worst_s, products_max_rel_err=worst_p,
               kept_ranks={"/".join(map(str, k)): v
                           for k, v in agg["svd"].ranks.items()})
    return res



# -- phase 10: the RWKV6 prefill end to end ----------------------------------

PREFILL_BATCH, PREFILL_SEQ, PREFILL_CALLS = 8, 1024, 3


def rwkv_prefill(torch):
    """``make_prefill_step(use_kernels=True)`` on RWKV6-1.6B at published
    widths: per call ``wkv6`` once per layer and ``lora_matmul`` once per
    layer and target; tokens/s, and a profiled window of calls."""
    from repro_torch.configs import lora_targets
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import CONFIGS, make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_prefill_step
    cfg = CONFIGS["rwkv6_1p6b"][0]
    L, targets = cfg.num_layers, lora_targets(cfg)
    print(f"phase 10: {cfg.name} prefill at published widths ({L} L, d "
          f"{cfg.d_model}, {cfg.num_rwkv_heads} heads of {cfg.rwkv_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}), random "
          f"seeded weights, one rank-16 adapter on {' '.join(targets)}, "
          f"make_prefill_step(use_kernels=True) on {PREFILL_BATCH} x "
          f"{PREFILL_SEQ} tokens")
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    params = T.init(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    ad = make_adapter(params, targets, 16, gen, T.torch_dtype(cfg.dtype))
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ),
                         generator=gen, device=dev)
    step = make_prefill_step(cfg, use_kernels=True)
    first = step(params, ad, {"tokens": toks})                  # warm-up
    torch.cuda.synchronize()
    print(f"  set-up and warm-up call: {time.perf_counter() - t0:.1f} s")
    ops.reset_launch_counts()
    call_ms = []
    for _ in range(PREFILL_CALLS):
        t1 = time.perf_counter()
        lg = step(params, ad, {"tokens": toks})
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t1) * 1e3)
    counts = ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(wkv6=PREFILL_CALLS * L,
                lora_matmul=PREFILL_CALLS * L * len(targets))
    print(f"  kernels: {json.dumps(counts)} over {PREFILL_CALLS} calls "
          f"(expected {json.dumps(want)})")
    if counts != want:
        fail("phase 10: launch counts do not match the prefill calls")
    if lg.shape != (PREFILL_BATCH, cfg.vocab_size) or not bool(
            torch.isfinite(lg).all()):
        fail(f"phase 10: logits of shape {tuple(lg.shape)}, finite "
             f"{bool(torch.isfinite(lg).all())}")
    drift = float((lg.float() - first.float()).abs().max())
    if drift > 1e-2 * max(1.0, float(first.float().abs().max())):
        fail(f"phase 10: a repeated call moved the logits by {drift:.3e}")
    med = statistics.median(call_ms)
    tok_s = PREFILL_BATCH * PREFILL_SEQ / (med / 1e3)
    print(f"  prefill call median {med:.2f} ms (host clock, synchronised; "
          f"{', '.join(f'{m:.2f}' for m in call_ms)}): {tok_s:.0f} prompt "
          f"tok/s; repeated-call logits drift {drift:.3e}")

    def run(n):
        for _ in range(n):
            step(params, ad, {"tokens": toks})

    window = profile_window(torch, run, 2, f"prefill call, {PREFILL_BATCH} x "
                            f"{PREFILL_SEQ} tokens")
    wkv6_ms = sum(ms for name, ms in window["port_kernels_ms_per_step"].items()
                  if "wkv6_kernel" in name)
    print(f"  wkv6 device time per call: {wkv6_ms:.3f} ms for {L} launches "
          "(the sequential kernel's 6.6 ms: PERF.md)")
    del params, ad, first, lg
    torch.cuda.empty_cache()
    return {"call_ms": call_ms, "call_ms_median": med, "prefill_tok_s": tok_s,
            "launches": counts, "repeat_drift": drift,
            "wkv6_ms_per_call": wkv6_ms, "profiled_prefill": window}, counts


# -- phase 12: RWKV6 in fp32, kernel routes against plain routes --------------

def _double(tree):
    """A parameter or adapter tree with its floating leaves in fp64."""
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_double(v) for v in tree)
    return tree.double() if tree.is_floating_point() else tree


def rwkv_parity(torch):
    from repro_torch.configs import lora_targets
    from repro_torch.device import parity_mode
    from repro_torch.launch.serve import CONFIGS, make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.serve.adapters import AdapterRegistry, attach
    from repro_torch.train.step import make_prefill_step
    cfg = CONFIGS["rwkv6_1p6b"][0].replace(dtype="float32")
    print(f"phase 12: {cfg.name} at full width in fp32, kernel routes vs "
          "plain routes; " + parity_mode())
    dev = torch.device(DEVICE)
    # The reference's init, the bonus u at zero (phases 2/3 check the u term
    # with u ~ N(0, 0.25)).  A bonus u ~ N(0, 0.25) in all 24 layers makes
    # this random model so ill-conditioned that both fp32 routes land as far
    # from an fp64 evaluation as from each other; (a) prints each route's
    # distance to fp64 at this init.
    params = T.init(cfg, 1, dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    targets = lora_targets(cfg)
    ad = make_adapter(params, targets, 16, gen, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen, device=dev)
    res = {}
    # (a) fp32 on both routes; they differ in sum order (the wkv6 kernel's
    # FMAs and its y = r·S + v·Σ r u k against the loop's einsums;
    # lora_matmul's against two matmuls) through 24 layers: limit 1e-3 of
    # max(1, |logit|)
    lk = make_prefill_step(cfg, use_kernels=True)(params, ad, {"tokens": toks})
    lp = make_prefill_step(cfg, use_kernels=False)(params, ad, {"tokens": toks})
    res["prefill_logits_max_abs_err"] = check(
        "(a) prefill step, kernel vs plain route, 4 x 512 tokens: last logits",
        lk, lp, torch.ones(4, dtype=torch.bool, device=dev), 1e-3)
    f64, a64 = _double(params), _double(ad)
    l64 = make_prefill_step(cfg, use_kernels=False)(f64, a64, {"tokens": toks})
    top = float(l64.abs().max())
    res["kernel_vs_fp64_rel"] = float((lk.double() - l64).abs().max()) / top
    res["plain_vs_fp64_rel"] = float((lp.double() - l64).abs().max()) / top
    print(f"      distance to the plain route in fp64, as a share of max |logit|:"
          f" kernel route {res['kernel_vs_fp64_rel']:.3e}, plain route "
          f"{res['plain_vs_fp64_rel']:.3e}")
    del lk, lp, f64, a64, l64
    # (c) the kernel prefill against decode fed the same prompt one token
    # at a time through the registry (bgmv): the reference's own bound for
    # decode against forward, 2e-4 of max |logit| (tests/test_models.py)
    n_dec = 256
    pre = make_prefill_step(cfg, use_kernels=True)(params, ad,
                                                   {"tokens": toks[:, :n_dec]})
    reg = AdapterRegistry(ad, page_rank=4, max_rank=16, num_pages=8,
                          max_adapters=2, device=dev)
    ids = torch.full((4,), reg.register("r16", ad), dtype=torch.int32, device=dev)
    state = attach(reg.device_state, ids, impl="kernel")
    cache = T.init_cache(cfg, 4, n_dec, device=dev)
    t0 = time.perf_counter()
    for t in range(n_dec):
        lg, cache = T.decode(cfg, params, cache, {"tokens": toks[:, t:t + 1]},
                             state, decode_impl="kernel")
    torch.cuda.synchronize()
    rel = float((lg[:, 0] - pre).abs().max()) / float(pre.abs().max())
    ok = rel <= 2e-4
    print(f"  (c) kernel prefill vs {n_dec} one-token decode steps "
          f"({time.perf_counter() - t0:.1f} s): last logits max |Δ| / max "
          f"|logit| {rel:.3e} (limit 2e-4) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("phase 12: decode disagrees with the kernel prefill")
    res["decode_vs_prefill_rel_err"] = rel
    del params, ad, reg, state, cache, pre, lg
    torch.cuda.empty_cache()
    # (b) phase 5 on this model: bgmv against its plain version in the
    # engine (the recurrence is the same on both routes)
    res["engine"] = engine_parity(torch, "12 (b)", "rwkv6_1p6b",
                                  require_equal=True)
    return res


# -- phase 13: the paper's five methods on TinyLlama-1.1B ---------------------

TINY_TARGETS = ("wq", "wv")          # the paper's setting and Table 3's
TINY_RANK = 16
TINY_ROUNDS = 2
# phases 13, 14 and 16 run TinyLlama-1.1B at full width cut to this depth
# (of its 22 layers), to leave the script's time to phases 17-19
TINY_LAYERS = 2
LORA_TINY = "bf16, M=2048 din=2048 dout=256 r=16"
# phase 14's client ranks at TinyLlama's wv (wq's 2048 -> 2048 at r 4 and 64
# are cases of their own above)
LORA_TINY_R4 = "bf16, M=2048 din=2048 dout=256 r=4"
LORA_TINY_R64 = "bf16, M=2048 din=2048 dout=256 r=64"
FLASH_TINY = "bf16, causal, B=4 S=512 H=32 K=4 hd=64"
SIGMA_0, RHO = 2048.0, 0.85          # phase 13 (b)'s known spectrum of ΔW


def tinyllama_methods(torch):
    """Two rounds of each of the paper's five methods (FLoRIST, FedIT,
    FFA-LoRA, FLoRA, FlexLoRA) through ``FederatedTrainer`` on
    TinyLlama-1.1B at published widths, depth cut to ``TINY_LAYERS``
    (random seeded weights, bf16, built once and shared by the five
    trainers), LoRA on
    ``wq`` and ``wv``, 8 Dirichlet(0.5) clients of rank 16, 4 a round, 4
    local steps of 4 x 512 tokens, the ``bf16`` wire, FLoRIST on the Gram
    route.  Per method and round: eval loss and accuracy, kept ranks, wire
    bytes beside 2 x the analytic counts (must be equal), round wall,
    finalize, median train step, the host spans of the rest of the round
    (downlink: ``server_to_clients``, its encode, count and decode; the
    clients' ``client_init``; ``merge_lora``; the eval step; each between
    two ``synchronize`` calls), launches (must match the code).  Then
    FFA's global A against the frozen init (bit for bit), FLoRA's merged
    base and re-init, (b) every finalize on the card against the CPU in
    fp32, and the Table 4 counterpart."""
    import collections

    import repro_torch.core.federated as fed_mod
    from repro_torch.common.config import LoRAConfig
    from repro_torch.configs.tinyllama_1p1b import CONFIG
    from repro_torch.data.synthetic import make_eval_data, make_federated_data
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfg = CONFIG.replace(num_layers=TINY_LAYERS)
    L = cfg.num_layers
    t_phase = time.perf_counter()
    print(f"phase 13: the paper's five methods, {TINY_ROUNDS} rounds each, on "
          f"{cfg.name} at published widths (depth cut to {L} of its "
          f"{CONFIG.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} H / {cfg.num_kv_heads} KV, hd {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; random seeded "
          f"weights), LoRA r {TINY_RANK} on {'/'.join(TINY_TARGETS)}, 8 "
          f"Dirichlet(0.5) clients, 4 a round, 4 local steps of {FED_BATCH} x "
          f"{FED_SEQ} tokens, bf16 wire, FLoRIST on the Gram route")
    t0 = time.perf_counter()
    params = T.init(cfg, 0, DEVICE)
    clients = make_federated_data(num_clients=8, seq_len=FED_SEQ,
                                  vocab=cfg.vocab_size, alpha=0.5, seed=0)
    ev = make_eval_data(num_samples=16, seq_len=FED_SEQ, vocab=cfg.vocab_size)
    torch.cuda.synchronize()
    print(f"  set-up (weights and data, once for the five): "
          f"{time.perf_counter() - t0:.1f} s")
    lora = LoRAConfig(rank=TINY_RANK, alpha=float(TINY_RANK), targets=TINY_TARGETS)
    spans = collections.Counter()                # host secs a round, by span

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spans[name] += time.perf_counter() - t
            return out
        return call

    merge_lora = fed_mod.merge_lora
    fed_mod.merge_lora = timed("merge", merge_lora)
    try:
        methods = tiny_rounds(torch, cfg, params, clients, ev, lora, spans, timed)
    finally:
        fed_mod.merge_lora = merge_lora
    counts = {k: v for k, v in ops.launch_counts().items()
              if k in ("lora_matmul", "flash_attention", "adapter_gram")}
    print(f"  launches over the five methods: {json.dumps(counts)}")
    del params
    torch.cuda.empty_cache()
    parity = methods_parity(torch)
    table4 = table4_counterpart(torch)
    secs = time.perf_counter() - t_phase
    print(f"  phase 13: {secs:.1f} s")
    return {"methods": methods, "launches": counts, "parity": parity,
            "table4": table4, "phase_s": secs}, counts


def tiny_rounds(torch, cfg, params, clients, ev, lora, spans, timed):
    """Phase 13's rounds: ``TINY_ROUNDS`` of each method in ``METHODS``,
    checked as :func:`tinyllama_methods` says; ``spans`` collects the
    host spans that ``timed`` wraps."""
    import numpy as np
    from repro_torch.common.config import FedConfig, OptimConfig
    from repro_torch.core.aggregators import METHODS, adapter_leaf_paths, get_path
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.core.runtime import SequentialRunner
    from repro_torch.kernels import ops
    from repro_torch.peft.lora import match_rank
    L = cfg.num_layers
    methods = {}
    ops.reset_launch_counts()
    for method in METHODS:
        fed = FedConfig(num_clients=8, clients_per_round=4,
                        homogeneous_rank=TINY_RANK, dirichlet_alpha=0.5,
                        tau=0.9, method=method, seed=0)
        runner = SequentialRunner(record_steps=True)
        tr = FederatedTrainer(cfg, fed, lora, OptimConfig(lr=3e-4),
                              clients=clients, eval_data=ev,
                              batch_size=FED_BATCH, local_steps=4,
                              seq_len=FED_SEQ, svd_method="gram", runner=runner,
                              transport="bf16", params=params, device=DEVICE)
        tr.transport.server_to_clients = timed("downlink",
                                               tr.transport.server_to_clients)
        tr.aggregator.client_init = timed("client_init", tr.aggregator.client_init)
        tr._eval = timed("eval", tr._eval)
        rounds = []
        for rnd in range(TINY_ROUNDS):
            before, n_log = ops.launch_counts(), len(runner.step_log())
            spans.clear()
            rec = tr.run_round(rnd)
            spent = dict(spans)
            after = ops.launch_counts()
            step_ms = [e["ms"] for e in runner.step_log()[n_log:]]
            steps = len(step_ms)
            dims = tr.aggregator.dims
            buckets = len({(n, m) for _, n, m in dims.values()})
            want = {"lora_matmul": L * len(TINY_TARGETS) * steps,
                    "flash_attention": L * (steps + 1),          # + one eval step
                    "adapter_gram": 2 * buckets if method == "florist" else 0}
            got = {k: after[k] - before[k] for k in want}
            ranks = tr.global_state.ranks
            r_sum = sum(tr.aggregator.client_ranks)
            print(f"  {method} round {rnd}: eval loss {rec.eval_loss:.4f} acc "
                  f"{rec.eval_acc:.4f}; upload {rec.upload_bytes} B (2 x "
                  f"{rec.upload_params} params), download {rec.download_bytes} B "
                  f"(2 x {rec.download_params}); wall {rec.wall_secs:.2f} s, "
                  f"finalize {rec.finalize_secs * 1e3:.1f} ms; {steps} train "
                  f"steps, median {statistics.median(step_ms):.2f} ms (CUDA events)")
            print(f"    host spans: " + ", ".join(
                f"{k} {spent.get(k, 0.0):.3f} s" for k in
                ("downlink", "client_init", "merge", "eval"))
                + f"; train steps {sum(step_ms) / 1e3:.3f} s (CUDA events)")
            for path, ps in ranks.items():
                print(f"    kept ranks {'/'.join(map(str, path))}: "
                      f"{ps if len(set(ps)) > 1 else f'{ps[0]} x {len(ps)}'}")
            print(f"    launches {json.dumps(got)}; expected {json.dumps(want)}")
            if got != want:
                fail(f"phase 13 {method} round {rnd}: launch counts {got} != {want}")
            if (rec.upload_bytes != 2 * rec.upload_params
                    or rec.download_bytes != 2 * rec.download_params):
                fail(f"phase 13 {method} round {rnd}: wire bytes differ from "
                     "the analytic 2-byte counts")
            if not np.isfinite(rec.eval_loss):
                fail(f"phase 13 {method} round {rnd}: eval loss {rec.eval_loss}")
            for path, ps in ranks.items():
                _, n, m = dims[path]
                ok = {"fedit": all(p == TINY_RANK for p in ps),
                      "ffa": all(p == TINY_RANK for p in ps),
                      "flora": all(p == r_sum for p in ps),
                      "flexlora": all(p == min(TINY_RANK, n, m) for p in ps),
                      "florist": all(1 <= p <= r_sum for p in ps)}[method]
                if len(ps) != L or not ok:
                    fail(f"phase 13 {method} round {rnd}: kept ranks of {path} "
                         f"are {ps}")
            if method == "flora" and rnd == 0:
                # the stack was merged into the base; clients start over at B = 0
                moved = [not torch.equal(get_path(tr.params, ("blocks", 0, "attn", t)),
                                         get_path(params, ("blocks", 0, "attn", t)))
                         for t in TINY_TARGETS]
                init = tr.aggregator.client_init(tr.global_state, TINY_RANK,
                                                 tr.A_init_full)
                a0 = match_rank(tr.A_init_full, TINY_RANK)
                fresh = all(not torch.as_tensor(get_path(init, p)["B"]).any()
                            and torch.equal(get_path(init, p)["A"],
                                            get_path(a0, p)["A"])
                            for p in adapter_leaf_paths(init))
                print(f"    base weights moved by the merge: {moved}; clients "
                      f"start round 1 at B = 0 and the shared A: {fresh}")
                if not all(moved) or not fresh:
                    fail("phase 13 flora: the merge or the re-init did not happen")
            rounds.append({"record": dataclasses.asdict(rec),
                           "ranks": {"/".join(map(str, k)): v for k, v in ranks.items()},
                           "train_step_ms": step_ms,
                           "train_step_ms_median": statistics.median(step_ms),
                           "spans_s": spent,
                           "launches": got})
        if method == "ffa":
            g = tr.global_state.global_adapters
            same = all(torch.equal(torch.as_tensor(get_path(g, p)["A"]),
                                   get_path(tr.A_init_full, p)["A"])
                       for p in adapter_leaf_paths(g))
            print(f"    global A after round {TINY_ROUNDS - 1} equals the frozen "
                  f"init bit for bit: {same}")
            if not same:
                fail("phase 13 ffa: the global A moved off the frozen init")
        methods[method] = rounds
        del tr
        torch.cuda.empty_cache()
    return methods


def parity_trees(kind):
    """Phase 13 (b)'s client trees at TinyLlama's leaf shapes (wq 2048 ->
    2048, wv 2048 -> 256; ``TINY_LAYERS`` layers; 4 clients of rank 16,
    numpy fp32, from seed 13):
    ``(clients, w, a_init, levels)``, with w the clients' weights and
    a_init an FFA A init.

    ``"known"``: each layer's clients hold disjoint columns of one
    orthonormal pair, B at ``levels`` and A divided by w_k, so ΔW = Σ w_k
    B_k A_k has the known spectrum SIGMA_0 · RHO^i, i < 64.
    ``"gaussian"``: i.i.d. standard normal B_k and A_k (``levels`` None),
    whose clustered spectra put the cuts inside clusters."""
    import numpy as np
    from repro_torch.configs.tinyllama_1p1b import CONFIG
    L, d, K, R = TINY_LAYERS, CONFIG.d_model, 4, TINY_RANK
    shapes = {"wq": (d, CONFIG.num_heads * CONFIG.head_dim),
              "wv": (d, CONFIG.num_kv_heads * CONFIG.head_dim)}  # (n_in, m_out)
    rng = np.random.default_rng(13)
    w = rng.dirichlet(np.ones(K))
    ones = np.ones(L, np.float32)
    if kind == "known":
        levels = SIGMA_0 * RHO ** np.arange(K * R)
        bases = {name: [(np.linalg.qr(rng.normal(size=(m, K * R)))[0],
                         np.linalg.qr(rng.normal(size=(n, K * R)))[0])
                        for _ in range(L)] for name, (n, m) in shapes.items()}
        # client k: columns k, k + K, ... of each layer's bases
        clients = [{"blocks": {0: {"attn": {name: {
            "B": np.stack([qb[:, k::K] * levels[k::K] for qb, _ in bases[name]]
                          ).astype(np.float32),
            "A": np.stack([qa[:, k::K].T / w[k] for _, qa in bases[name]]
                          ).astype(np.float32),
            "scale": ones} for name in shapes}}}} for k in range(K)]
    elif kind == "gaussian":
        levels = None
        clients = [{"blocks": {0: {"attn": {name: {
            "B": rng.normal(size=(L, m, R)).astype(np.float32),
            "A": rng.normal(size=(L, R, n)).astype(np.float32),
            "scale": ones} for name, (n, m) in shapes.items()}}}}
            for _ in range(K)]
    else:
        raise ValueError(kind)
    a_init = {"blocks": {0: {"attn": {name: {
        "A": rng.normal(size=(L, R, n)).astype(np.float32)}
        for name, (n, m) in shapes.items()}}}}
    return clients, w, a_init, levels


def exact_svd(clients, w, name, layer):
    """The fp64 SVD of ΔW = Σ w_k B_k A_k of one leaf's layer, exact through
    QR of the stacks: ``(u (m, Σr), s (Σr,), v (n, Σr))``; rank-p cut
    ``(u[:, :p] * s[:p]) @ v[:, :p].T``."""
    import numpy as np
    leaves = [c["blocks"][0]["attn"][name] for c in clients]
    bs = np.concatenate([lf["B"][layer].astype(np.float64) for lf in leaves], 1)
    as_ = np.concatenate([wk * lf["A"][layer].astype(np.float64)
                          for wk, lf in zip(w, leaves)], 0)
    qb, rb = np.linalg.qr(bs)
    qa, ra = np.linalg.qr(as_.T)
    u, s, vt = np.linalg.svd(rb @ ra.T)
    return qb @ u, s, qa @ vt.T


PARITY_CASES = (("florist (svd)", "florist", {"svd_method": "svd"}),
                ("florist (gram)", "florist", {"svd_method": "gram"}),
                ("fedit", "fedit", {}), ("ffa", "ffa", {}),
                ("flora", "flora", {}), ("flexlora", "flexlora", {}))


def parity_finalize(torch, method, kw, data, dev):
    """One aggregator's finalize on ``data`` (:func:`parity_trees`) on
    ``dev``: A and B as numpy off the wire, scale a tensor, FFA handed the
    A init.  Returns (AggResult, seconds to a synchronized finish)."""
    from repro_torch.core.aggregators import make_aggregator
    clients, w, a_init, _ = data
    kw = dict(kw)
    if method == "ffa":
        kw["A_init"] = {"blocks": {0: {"attn": {
            n: {"A": torch.as_tensor(leaf["A"], device=dev)}
            for n, leaf in a_init["blocks"][0]["attn"].items()}}}}
    arriving = [{"blocks": {0: {"attn": {n: {
        "A": leaf["A"], "B": leaf["B"],
        "scale": torch.as_tensor(leaf["scale"], device=dev)}
        for n, leaf in c["blocks"][0]["attn"].items()}}}} for c in clients]
    t0 = time.perf_counter()
    res = make_aggregator(method, **kw).aggregate(arriving, w)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def tree_products(torch, res, dtype=None):
    """The products B·A of ``res``'s global tree and of its per-client
    trees, in ``dtype`` (fp32 by default) on the trees' device:
    ``[{leaf path: (L, m, n)}]``."""
    from repro_torch.core.aggregators import adapter_leaf_paths, get_path
    dtype = dtype or torch.float32
    trees = [res.global_adapters] + list(res.per_client or [])
    return [{p: torch.matmul(torch.as_tensor(get_path(t, p)["B"]).to(dtype),
                             torch.as_tensor(get_path(t, p)["A"]).to(dtype))
             for p in adapter_leaf_paths(t)} for t in trees]


def fp64_distance(torch, res, exact, full_global):
    """max over ``res``'s trees, leaves and layers of |B·A − ΔW's fp64 SVD
    cut at the tree's rank| / max |ΔW|, in fp64 on the trees' device: the
    global tree at its kept ranks (at full rank where ``full_global``:
    FlexLoRA's global tree is the full SVD), per-client trees at
    ``TINY_RANK``.  ``exact``: leaf name -> [:func:`exact_svd`] by layer."""
    worst = 0.0
    for i, tree in enumerate(tree_products(torch, res, torch.float64)):
        for path, prod in tree.items():
            for l, factors in enumerate(exact[path[-1]]):
                u, s, v = (torch.as_tensor(f, device=prod.device) for f in factors)
                p = (len(s) if full_global else res.ranks[path][l]) if i == 0 \
                    else TINY_RANK
                p = min(p, len(s))
                dw = (u * s) @ v.T
                want = (u[:, :p] * s[:p]) @ v[:, :p].T
                worst = max(worst, float((prod[l] - want).abs().max()
                                         / dw.abs().max()))
    return worst


def methods_parity(torch):
    """(b): each of the five finalizes (FLoRIST on both SVD routes), fed the
    same numpy client trees at TinyLlama's leaf shapes (4 clients of rank
    16; wq 2048 -> 2048, wv 2048 -> 256), in fp32 (TF32 off) on the card
    (cuSOLVER, ``adapter_gram``) and on the CPU (LAPACK, the plain Gram
    product).

    First on :func:`parity_trees` "known": ΔW = Σ w_k B_k A_k has the known
    spectrum SIGMA_0 · RHO^i, i < 64, which decays as trained adapters' do,
    and every cut (FLoRIST's τ 0.9, FlexLoRA's rank 16) sits on a 15% gap.
    Kept ranks must be equal (FLoRIST's the known energy rank), the
    products B·A of the global trees and of FlexLoRA's per-client trees
    within 1e-4 · max(1, |ΔW|) (ΔW the CPU's product: fp32 sums in another
    order, and the Gram route squares the condition number), and both
    sides' spectra within 1e-4 of σ_1 of the known one above the Gram
    route's resolution.  Then :func:`gaussian_parity`."""
    import numpy as np
    from repro_torch.configs.tinyllama_1p1b import CONFIG
    from repro_torch.device import parity_mode
    K, R = 4, TINY_RANK
    print(f"phase 13 (b): every finalize on the card against the CPU, fp32, "
          f"{K} clients of rank {R} at {CONFIG.name}'s leaf shapes, ΔW's spectrum "
          f"{SIGMA_0:g} x {RHO}^i; " + parity_mode())
    data = parity_trees("known")
    levels = data[3]
    energy = np.cumsum(levels ** 2) / np.sum(levels ** 2)
    p_known = int(np.searchsorted(energy.astype(np.float32), np.float32(0.9)) + 1)

    def spectrum_err(res):
        """max over leaves and layers of |σ_i - known_i| / σ_1, for the σ
        above the Gram route's resolution σ_1·√(Σr·eps)."""
        worst = 0.0
        for sps in res.spectra.values():
            for sp in sps:
                sp = np.asarray(sp)[:K * R]
                big = levels > 2 * levels[0] * np.sqrt(K * R * np.finfo(np.float32).eps)
                worst = max(worst, float(np.abs(sp - levels)[big].max() / levels[0]))
        return worst

    out = {"known_florist_rank": p_known}
    for label, method, kw in PARITY_CASES:
        gpu, t_gpu = parity_finalize(torch, method, kw, data, DEVICE)
        cpu, t_cpu = parity_finalize(torch, method, kw, data, "cpu")
        if gpu.ranks != cpu.ranks:
            fail(f"phase 13 (b) {label}: kept ranks differ between the card "
                 f"and the CPU: {gpu.ranks} vs {cpu.ranks}")
        if method == "florist" and any(p != p_known for ps in cpu.ranks.values()
                                       for p in ps):
            fail(f"phase 13 (b) {label}: kept ranks {cpu.ranks}, the known "
                 f"energy rank is {p_known}")
        worst, worst_rel = 0.0, 0.0
        for pg, pc in zip(tree_products(torch, gpu), tree_products(torch, cpu)):
            for p in pc:
                dw = pc[p]
                err = float((pg[p].cpu() - dw).abs().max())
                lim = 1e-4 * max(1.0, float(dw.abs().max()))
                worst = max(worst, err / lim)
                worst_rel = max(worst_rel, err / float(dw.abs().max()))
        sp_err = ((spectrum_err(gpu), spectrum_err(cpu)) if gpu.spectra else None)
        n_trees = 1 + len(gpu.per_client or [])
        ok = worst <= 1.0 and (sp_err is None or max(sp_err) <= 1e-4)
        print(f"  {label}: {n_trees} tree{'s' if n_trees > 1 else ''}, ranks "
              f"equal{f' ({p_known} a layer, as known)' if method == 'florist' else ''}; "
              f"max |Δ(B·A)| {worst * 1e-4:.2e} of max(1, |ΔW|) (limit 1e-4; "
              f"{worst_rel:.2e} of max |ΔW|)"
              + (f"; spectra off the known by {sp_err[0]:.2e} (card) and "
                 f"{sp_err[1]:.2e} (CPU) of σ_1 (limit 1e-4)" if sp_err else "")
              + f"; finalize {t_gpu:.2f} s on the card (first call), {t_cpu:.2f} s "
              f"on the CPU {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"phase 13 (b) {label}: the card's finalize disagrees with the CPU's")
        out[label] = {"err_over_limit": worst, "rel_err": worst_rel,
                      "spectrum_err": sp_err, "card_s": t_gpu, "cpu_s": t_cpu}
        del gpu, cpu
        torch.cuda.empty_cache()
    out["gaussian"] = gaussian_parity(torch)
    return out


def gaussian_parity(torch):
    """(b) on :func:`parity_trees` "gaussian": i.i.d. Gaussian factors give
    clustered spectra, so FLoRIST's τ cut and FlexLoRA's rank-16 cut fall
    inside clusters, where a truncated product moves by the route's fp32
    error over a small gap and the card and the CPU need not agree to
    1e-4.  So each side is held to ΔW's fp64 SVD (:func:`exact_svd`) cut at
    the same ranks: the kept ranks must be equal and the card no further
    from fp64 than twice the CPU (LAPACK, the reference's route)."""
    data = parity_trees("gaussian")
    exact = {n: [exact_svd(data[0], data[1], n, l)
                 for l in range(len(data[0][0]["blocks"][0]["attn"][n]["B"]))]
             for n in ("wq", "wv")}
    print("phase 13 (b): the same on i.i.d. Gaussian client trees (cuts inside "
          "spectral clusters), each side held to ΔW's fp64 SVD at the same ranks")
    out = {}
    for label, method, kw in PARITY_CASES:
        if method not in ("florist", "flexlora"):
            continue                    # no truncation: equal sums above
        gpu, t_gpu = parity_finalize(torch, method, kw, data, DEVICE)
        cpu, t_cpu = parity_finalize(torch, method, kw, data, "cpu")
        full = method == "flexlora"
        err = (fp64_distance(torch, gpu, exact, full),
               fp64_distance(torch, cpu, exact, full))
        ok = gpu.ranks == cpu.ranks and err[0] <= 2 * err[1]
        print(f"  {label}: ranks {'equal' if gpu.ranks == cpu.ranks else 'DIFFER'}; "
              f"max |B·A − fp64| {err[0]:.2e} (card) and {err[1]:.2e} (CPU) of "
              f"max |ΔW| (card limit 2 x the CPU's); finalize {t_gpu:.2f} s on the "
              f"card, {t_cpu:.2f} s on the CPU {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"phase 13 (b) {label}: on Gaussian trees the card is further "
                 "from the fp64 SVD than twice the CPU, or its ranks differ")
        out[label] = {"fp64_err_card": err[0], "fp64_err_cpu": err[1],
                      "card_s": t_gpu, "cpu_s": t_cpu}
        del gpu, cpu
        torch.cuda.empty_cache()
    return out


def table4_counterpart(torch):
    """``repro_torch.benchmarks.table4_server_flops`` on the card: the
    elapsed time (between two CUDA events, host syncs inside) of FLoRIST's
    core and of FlexLoRA's dense ΔW plus SVD on one 2048 x 2048 layer (K 10,
    R 16), analytic FLOPs beside; the ratio, claiming nothing."""
    from repro_torch.benchmarks import table4_server_flops as t4
    print("phase 13: Table 4 counterpart (elapsed time between CUDA events; "
          "analytic FLOPs)")
    rows = t4.run(device=DEVICE)
    for r in rows:
        print(f"  {r['name']},{r['us_per_call']},{r['derived']}")
    return rows


# -- phase 14: the paper's evaluation at full width ---------------------------

EVAL_ROUNDS = 2                      # Table 2's arm, Figs 6 and 5 a τ
BENCH_PARITY_ROUNDS = 1              # (c)'s rounds (2 before phase 24)


def paper_evaluation(torch):
    """The reference's paper-evaluation layer run through the port's own
    modules (``repro_torch.benchmarks.table2_accuracy_efficiency``,
    ``fig6_layerwise_rank``, ``fig2_spectrum``, ``fig5_rank_vs_tau``) on
    TinyLlama-1.1B at published widths, depth cut to ``TINY_LAYERS`` (random seeded
    weights, bf16, built once and shared through ``params=``), LoRA on
    ``wq``/``wv``, 4 local steps of 4 x 512 tokens, the bench's 20 clients
    (5 a round) and rank mix, τ 0.9, the fp32 wire and the ``svd`` route:
    (a) Table 2's heterogeneous arm, (b) Figs 6, 2 and 5, then (c) Table 2's
    rows at the bench's own config on the card against the CPU, (d)
    ``agg_bench`` and (e) the quickstart and serve-federated examples.
    Each module's ``bench_fed`` is replaced by :class:`BenchRecorder`,
    which is ``bench_trainer`` plus the same rounds, timed and checked."""
    from repro_torch.benchmarks import (fig2_spectrum, fig5_rank_vs_tau,
                                        fig6_layerwise_rank,
                                        table2_accuracy_efficiency)
    from repro_torch.common.config import LoRAConfig
    from repro_torch.configs.tinyllama_1p1b import CONFIG
    from repro_torch.data.synthetic import make_eval_data, make_federated_data
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfg = CONFIG.replace(num_layers=TINY_LAYERS)
    t_phase = time.perf_counter()
    print(f"phase 14: the paper's evaluation on {CARD} ({cfg.name} at published "
          f"widths, depth cut to {cfg.num_layers} of its {CONFIG.num_layers} "
          f"layers: d {cfg.d_model}, {cfg.num_heads} H / "
          f"{cfg.num_kv_heads} KV, hd {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; random seeded weights), LoRA on "
          f"{'/'.join(TINY_TARGETS)}, 20 Dirichlet(0.5) clients of ranks 4-64, "
          f"5 a round, 4 local steps of {FED_BATCH} x {FED_SEQ} tokens, τ 0.9, "
          f"fp32 wire, svd route")
    t0 = time.perf_counter()
    params = T.init(cfg, 0, DEVICE)
    clients = make_federated_data(num_clients=20, seq_len=FED_SEQ,
                                  vocab=cfg.vocab_size, alpha=0.5, seed=0)
    ev = make_eval_data(num_samples=16, seq_len=FED_SEQ, vocab=cfg.vocab_size)
    torch.cuda.synchronize()
    print(f"  set-up (weights and data, once for the phase): "
          f"{time.perf_counter() - t0:.1f} s")
    bench = dict(cfg=cfg, lora=LoRAConfig(rank=8, alpha=8.0, targets=TINY_TARGETS),
                 batch_size=FED_BATCH, seq_len=FED_SEQ, params=params,
                 clients=clients, eval_data=ev, device=DEVICE)
    rec = BenchRecorder(torch, cfg)
    mods = (table2_accuracy_efficiency, fig6_layerwise_rank, fig2_spectrum,
            fig5_rank_vs_tau)
    saved = [m.bench_fed for m in mods]
    out = {}
    ops.reset_launch_counts()
    try:
        for m in mods:
            m.bench_fed = rec
        print(f"phase 14 (a): Table 2, heterogeneous arm, {EVAL_ROUNDS} rounds "
              f"of each method (FedIT and FFA zero-padded)")
        rows = table2_accuracy_efficiency.run(arms=(True,), rounds=EVAL_ROUNDS,
                                              **bench)
        out["table2"] = print_rows(rows)
        wins = rows[-1]["derived"].split("florist_wins=")[1]
        print(f"  florist_wins={wins} (printed, not required: random weights)")
        out["widest_finalize"] = widest_finalize(torch, cfg)
        print("phase 14 (b): Fig 6 (the same call as (a)'s FLoRIST row), Fig 2 "
              "(one round at τ 1.0), Fig 5 (two rounds a τ, homogeneous rank 8)")
        out["fig6"] = print_rows(fig6_layerwise_rank.run(**bench))
        rec.memo.clear()
        out["fig2"] = print_rows(fig2_spectrum.run(**bench))
        out["fig5"] = print_rows(fig5_rank_vs_tau.run(**bench))
    finally:
        for m, f in zip(mods, saved):
            m.bench_fed = f
    counts = {k: v for k, v in ops.launch_counts().items()
              if k in ("lora_matmul", "flash_attention", "adapter_gram")}
    print(f"  launches over (a) and (b): {json.dumps(counts)}")
    out["runs"], out["launches"] = rec.runs, counts
    del params, bench, rec
    torch.cuda.empty_cache()
    out["bench_parity"] = bench_parity(torch)
    out["agg_bench"] = agg_bench_card(torch)
    out["examples"] = examples_card(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 14: {out['phase_s']:.1f} s on {CARD}")
    return out, counts


WIDEST_RANKS = (64, 64, 32, 32, 16)   # the bench mix's largest Σ r_k, 208


def widest_finalize(torch, cfg):
    """FLoRIST's finalize (svd route, fp64 solves) at the rank mix's widest
    round, five clients of ranks 64, 64, 32, 32 and 16 (Σ r_k 208: the wv
    stacks are 256 x 208), on numpy client trees at TinyLlama's leaf
    shapes; a sampled round need not reach it.  Kept ranks must lie in
    [1, 208] and B·A be finite; the warm finalize is timed."""
    import numpy as np
    from repro_torch.core.aggregators import make_aggregator
    L, d = cfg.num_layers, cfg.d_model
    shapes = {"wq": (d, cfg.num_heads * cfg.head_dim),
              "wv": (d, cfg.num_kv_heads * cfg.head_dim)}     # (n_in, m_out)
    rng = np.random.default_rng(14)
    w = rng.dirichlet(np.ones(len(WIDEST_RANKS)))
    ones = torch.ones(L, device=DEVICE)
    trees = [{"blocks": {0: {"attn": {name: {
        "A": (rng.normal(size=(L, r, n)) * 0.02).astype(np.float32),
        "B": (rng.normal(size=(L, m, r)) * 0.02).astype(np.float32),
        "scale": ones} for name, (n, m) in shapes.items()}}}}
        for r in WIDEST_RANKS]
    secs = []
    for _ in range(2):                      # cold, then warm
        agg = make_aggregator("florist", tau=0.9, svd_method="svd")
        t = time.perf_counter()
        res = agg.aggregate(trees, w)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    r_sum = sum(WIDEST_RANKS)
    ranks = [p for ps in res.ranks.values() for p in ps]
    finite = all(bool(torch.isfinite(torch.as_tensor(lf["B"]) @ torch.as_tensor(
        lf["A"])).all()) for lf in res.global_adapters["blocks"][0]["attn"].values())
    print(f"  FLoRIST finalize at Σ r_k {r_sum} (client ranks {list(WIDEST_RANKS)}, "
          f"svd route, numpy trees at {cfg.name}'s wq/wv shapes): {secs[0] * 1e3:.1f} ms "
          f"cold, {secs[1] * 1e3:.1f} ms warm; kept ranks {min(ranks)}-{max(ranks)}")
    if not finite or not all(1 <= p <= r_sum for p in ranks):
        fail(f"phase 14 (a): the finalize at Σ r_k {r_sum} kept ranks "
             f"{min(ranks)}-{max(ranks)} or gave non-finite factors")
    return {"r_sum": r_sum, "cold_s": secs[0], "warm_s": secs[1],
            "ranks": {"/".join(map(str, k)): v for k, v in res.ranks.items()}}


def print_rows(rows):
    for r in rows:
        print(f"  {r['name']},{r.get('us_per_call', '')},{r.get('derived', '')}")
    return rows


class BenchRecorder:
    """Stands in for ``bench_fed`` in phase 14: ``bench_trainer`` with a
    step-logging runner, then the same rounds one by one, each printed and
    checked (finite eval loss; FLoRIST's kept ranks in [1, Σ r_k]; FedIT's
    and FFA's global rank the zero padding's, the round's largest client
    rank; wire bytes exactly 4 x the analytic counts, and the upload L ·
    Σ r_k · (2048 + 2048 + 256 + 2048) parameters, B alone for FFA; the
    launches of ``lora_matmul`` and ``flash_attention`` exact, none of
    ``adapter_gram`` on the svd route).  A FLoRIST call that was already
    made returns its result again (``memo``): Fig 6 makes Table 2's call."""

    def __init__(self, torch, cfg):
        self.torch, self.cfg = torch, cfg
        self.memo, self.runs = {}, []

    def __call__(self, method, *, rounds=0, heterogeneous=False, tau=0.9, **kw):
        from repro_torch.benchmarks import common
        from repro_torch.core.runtime import SequentialRunner
        from repro_torch.kernels import ops
        key = (method, heterogeneous, tau, rounds)
        if key in self.memo:
            print(f"  {method} (heterogeneous={heterogeneous}, τ {tau}, "
                  f"{rounds} rounds): the call made above, its trainer reused")
            return self.memo[key]
        cfg, L = self.cfg, self.cfg.num_layers
        runner = SequentialRunner(record_steps=True)
        tr = common.bench_trainer(method, heterogeneous=heterogeneous, tau=tau,
                                  runner=runner, **kw)
        per_rank = cfg.d_model + cfg.num_heads * cfg.head_dim \
            + cfg.d_model + cfg.num_kv_heads * cfg.head_dim      # wq + wv
        b_only = cfg.num_heads * cfg.head_dim + cfg.num_kv_heads * cfg.head_dim
        label = f"{method} {'het' if heterogeneous else 'hom'} τ {tau}"
        for rnd in range(rounds):
            before, n_log = ops.launch_counts(), len(runner.step_log())
            r = tr.run_round(rnd)
            after = ops.launch_counts()
            log = runner.step_log()[n_log:]
            step_ms = [e["ms"] for e in log]
            ranks_k = list(tr.aggregator.client_ranks)
            r_sum = sum(ranks_k)
            by_rank = {}
            for e, rk in zip(log, [tr.client_ranks[e["client"]] for e in log]):
                by_rank.setdefault(rk, []).append(e["ms"])
            want = {"lora_matmul": L * len(TINY_TARGETS) * len(step_ms),
                    "flash_attention": L * (len(step_ms) + 1),
                    "adapter_gram": 0}
            got = {k: after[k] - before[k] for k in want}
            ranks = tr.global_state.ranks
            up_want = L * r_sum * (b_only if method == "ffa" else per_rank)
            print(f"  {label} round {rnd}: eval loss {r.eval_loss:.4f} acc "
                  f"{r.eval_acc:.4f}; client ranks {ranks_k} (Σ {r_sum}); wall "
                  f"{r.wall_secs:.2f} s, finalize {r.finalize_secs * 1e3:.1f} ms, "
                  f"{len(step_ms)} steps, median {statistics.median(step_ms):.2f} ms "
                  f"(by client rank: " + ", ".join(
                      f"r{k} {statistics.median(v):.1f}"
                      for k, v in sorted(by_rank.items())) + "); download rank "
                  f"{r.download_rank:.0f}; upload {r.upload_bytes} B (4 x "
                  f"{r.upload_params}), download {r.download_bytes} B (4 x "
                  f"{r.download_params})")
            print("    kept ranks " + "; ".join(
                f"{'/'.join(map(str, p))} {min(ps)}-{max(ps)}"
                for p, ps in ranks.items()) + f"; launches {json.dumps(got)}")
            where = f"phase 14 {label} round {rnd}"
            if got != want:
                fail(f"{where}: launch counts {got} != {want}")
            if (r.upload_bytes != 4 * r.upload_params
                    or r.download_bytes != 4 * r.download_params
                    or r.upload_params != up_want):
                fail(f"{where}: wire bytes or upload count differ from the "
                     f"analytic ones (upload params {r.upload_params}, "
                     f"expected {up_want})")
            if not math.isfinite(r.eval_loss):
                fail(f"{where}: eval loss {r.eval_loss}")
            for path, ps in ranks.items():
                ok = {"fedit": lambda p: p == max(ranks_k),
                      "ffa": lambda p: p == max(ranks_k),
                      "florist": lambda p: 1 <= p <= r_sum}.get(
                          method, lambda p: True)
                if len(ps) != L or not all(ok(p) for p in ps):
                    fail(f"{where}: kept ranks of {path} are {ps}")
            self.runs.append({
                "method": method, "heterogeneous": heterogeneous, "tau": tau,
                "round": rnd, "record": dataclasses.asdict(r),
                "client_ranks": ranks_k,
                "ranks": {"/".join(map(str, k)): v for k, v in ranks.items()},
                "train_step_ms": step_ms,
                "train_step_ms_by_rank": by_rank, "launches": got})
        result = (tr.history, tr)
        if method == "florist":
            self.memo[key] = result
        return result


def tree_to(tree, device):
    """An adapter or params tree (dicts, tuples of tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def bench_parity(torch):
    """(c): Table 2's rows at the bench's own config (``BENCH_MODEL``, fp32)
    for both arms at ``BENCH_PARITY_ROUNDS`` rounds, on the card (kernel
    routes, TF32 off) and
    on the CPU (plain routes), from the same weights and A init (made on
    the CPU).  Row names, kept and download ranks and ``most_efficient``
    must be equal, and each round's eval loss within 1e-4 · max(1, |loss|)
    (phase 7's federated path, fp32 sums in another order)."""
    from repro_torch.benchmarks import common
    from repro_torch.benchmarks import table2_accuracy_efficiency as t2
    from repro_torch.device import parity_mode
    print("phase 14 (c): Table 2 at the bench config (bench-tiny, fp32), both "
          f"arms, {BENCH_PARITY_ROUNDS} round(s), card against CPU; "
          + parity_mode())
    base = {}
    for heter in (False, True):
        tr = common.bench_trainer("florist", heterogeneous=heter, device="cpu")
        base[heter] = (tr.params, tr.A_init_full)

    def on(dev):
        got = {}

        def bench_fed(method, *, rounds=0, heterogeneous=False, **kw):
            params, a_init = base[heterogeneous]
            tr = common.bench_trainer(method, heterogeneous=heterogeneous,
                                      params=tree_to(params, dev), device=dev,
                                      **kw)
            tr.A_init_full = tree_to(a_init, dev)
            hist = tr.run(rounds)
            got[(method, heterogeneous)] = (hist, tr.global_state.ranks)
            return hist, tr

        saved = t2.bench_fed
        t2.bench_fed = bench_fed
        try:
            t = time.perf_counter()
            rows = t2.run(rounds=BENCH_PARITY_ROUNDS)
            if dev == DEVICE:
                torch.cuda.synchronize()
            return rows, got, time.perf_counter() - t
        finally:
            t2.bench_fed = saved

    card, card_runs, t_card = on(DEVICE)
    cpu, cpu_runs, t_cpu = on("cpu")
    worst = 0.0
    for key, (hist, ranks) in cpu_runs.items():
        c_hist, c_ranks = card_runs[key]
        if c_ranks != ranks:
            fail(f"phase 14 (c) {key}: kept ranks differ, card {c_ranks} CPU {ranks}")
        for a, b in zip(c_hist, hist):
            if a.download_rank != b.download_rank:
                fail(f"phase 14 (c) {key}: download rank {a.download_rank} != "
                     f"{b.download_rank}")
            err = abs(a.eval_loss - b.eval_loss) / max(1.0, abs(b.eval_loss))
            worst = max(worst, err)
    for a, b in zip(card, cpu):
        print(f"  card {a['name']},{a['us_per_call']},{a['derived']}")
        print(f"  CPU  {b['name']},{b['us_per_call']},{b['derived']}")
    same = ([r["name"] for r in card] == [r["name"] for r in cpu]
            and all(a["derived"].split("down_rank=")[-1] == b["derived"].split(
                "down_rank=")[-1] for a, b in zip(card, cpu))
            and all(a["derived"].split(";")[0] == b["derived"].split(";")[0]
                    for a, b in zip(card, cpu) if a["name"].endswith("efficient")))
    ok = same and worst <= 1e-4
    print(f"  rows, kept and download ranks and most_efficient "
          f"{'equal' if same else 'DIFFER'}; eval losses within {worst:.2e} of "
          f"max(1, |loss|) (limit 1e-4); {t_card:.1f} s on the card, {t_cpu:.1f} s "
          f"on the CPU {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("phase 14 (c): the card's bench rows disagree with the CPU's")
    return {"card": card, "cpu": cpu, "loss_rel_err": worst,
            "card_s": t_card, "cpu_s": t_cpu}


def agg_bench_card(torch):
    """(d): ``repro_torch.benchmarks.agg_bench`` at its non-smoke shape (3
    leaves x 8 layers, m 256, n 192, client ranks 4/8/16) on the card; the
    Gram rows must launch ``adapter_gram`` twice a (leaf, layer) a round
    (loop) or twice a bucket of equal-shaped leaves (batched, one bucket),
    the svd rows never."""
    from repro_torch.benchmarks import agg_bench
    from repro_torch.kernels import ops
    print(f"phase 14 (d): agg_bench on {CARD} (3 leaves x 8 layers, m 256, "
          "n 192, client ranks 4/8/16, τ 0.9; ms a round, median of 5)")
    launches, layers = {}, 8
    time_round = agg_bench.time_round

    def counted(agg, trees, weights, *, warmup, iters):
        before = ops.launch_counts()["adapter_gram"]
        ms = time_round(agg, trees, weights, warmup=warmup, iters=iters)
        rounds = warmup + iters
        n = ops.launch_counts()["adapter_gram"] - before
        want = 0 if agg.svd_method == "svd" else rounds * 2 * (
            len(trees[0]) * layers if agg.pipeline == "loop" else 1)
        launches[f"{agg.pipeline}/{agg.svd_method}"] = n
        if n != want:
            fail(f"phase 14 (d) {agg.pipeline}/{agg.svd_method}: adapter_gram "
                 f"launched {n} times, expected {want}")
        return ms

    agg_bench.time_round = counted
    try:
        report = agg_bench.run(layers=layers, device=DEVICE,
                               log=lambda s: print("  " + s))
    finally:
        agg_bench.time_round = time_round
    ms = {f"{r['pipeline']}/{r['svd_method']}": r["ms_per_round"]
          for r in report["results"]}
    print(f"  batched/loop: svd {ms['batched/svd'] / ms['loop/svd']:.3f}, gram "
          f"{ms['batched/gram'] / ms['loop/gram']:.3f}; adapter_gram launches "
          f"{json.dumps(launches)} over 6 rounds a route")
    return dict(report, adapter_gram_launches=launches)


def examples_card(torch):
    """(e): the quickstart and serve-federated examples on the card.  Every
    request served with all its tokens, both adapter versions in flight in
    one batch after the swap, and ``ring_decode`` / ``bgmv`` launched L and
    L x 4 times an engine step."""
    from repro_torch.examples import quickstart, serve_federated
    print("phase 14 (e): examples/quickstart and examples/serve_federated on the card")
    t0 = time.perf_counter()
    tr = quickstart.main(["--device", DEVICE])
    t_quick = time.perf_counter() - t0
    losses = [h.eval_loss for h in tr.history]
    if not all(math.isfinite(x) for x in losses) or not tr.global_state.ranks:
        fail(f"phase 14 (e) quickstart: eval losses {losses}")
    t0 = time.perf_counter()
    out = serve_federated.main(["--device", DEVICE])
    t_serve = time.perf_counter() - t0
    eng = out["engine"]
    L = eng.cfg.num_layers
    n_targets = len(out["trainer"].targets)
    steps = eng.steps_run + eng.warmup_steps     # graphs' warm-ups included
    want = {"ring_decode": L * steps, "bgmv": L * n_targets * steps}
    served = len(out["outputs"]) == 4 and all(
        len(t) == 12 for t in out["outputs"].values())
    both = len(out["in_flight"][-1]) == 2
    print(f"  quickstart {t_quick:.1f} s (3 rounds, eval losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}); serve_federated "
          f"{t_serve:.1f} s: {len(out['outputs'])} of 4 requests served, ids "
          f"in flight after the swap {out['in_flight'][-1]}, launches "
          f"{json.dumps(out['launches'])} over {eng.steps_run} engine steps "
          f"and {eng.warmup_steps} warm-up steps "
          f"(expected {json.dumps(want)})")
    if not served or not both or out["launches"] != want:
        fail("phase 14 (e): serve_federated did not serve every request, mix "
             "both adapter versions or launch its kernels once a layer a step")
    return {"quickstart_s": t_quick, "quickstart_losses": losses,
            "serve_s": t_serve, "steps": eng.steps_run,
            "launches": out["launches"], "in_flight": out["in_flight"]}



# -- phase 15: the engine's graphs, the streamed route, the benches ----------

def graph_parity(torch, config: str = "llama3p2_1b", phase: str = "15 (a)"):
    """(a) ``launch.serve``'s traffic (16 requests, one sampled, a swap)
    twice on one engine, graphed and then on the same built functions run
    uncaptured: every request's tokens equal bit for bit, the launches
    exactly :func:`serve_launches` of the steps and warm-up steps, and the
    graphed engine's captures unchanged by the second pass and its swap."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as S
    cfg = S.CONFIGS[config][0]
    print(f"phase {phase}: {cfg.name} ({cfg.num_layers} L), phase 4's traffic "
          "twice (a swap in each), graphed engine vs its step functions "
          "uncaptured")
    runs = {}
    for name in ("graphed", "uncaptured"):
        setup = S.build(config, device=DEVICE)
        eng = setup["engine"]
        if name == "uncaptured":
            # the built step and burst functions run as they are on the
            # card: no warm-up and no capture (captures happen at a
            # shape's first call, so none has happened yet)
            eng._capture = lambda entry: None
        ops.reset_launch_counts()
        passes, captures = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            out = S.traffic(setup, log=lambda s: None)
            torch.cuda.synchronize()
            passes.append({"results": out["results"], "swap": out["swap"],
                           "wall_s": time.perf_counter() - t0,
                           "decode_step_ms_median": out["stats"]["decode_step_ms_median"]})
            captures.append(dict(eng.trace_counts))
        counts = ops.launch_counts()
        want = serve_launches(cfg, eng, eng.steps_run + eng.warmup_steps)
        print(f"  {name}: walls {passes[0]['wall_s']:.2f} / {passes[1]['wall_s']:.2f} s, "
              f"{eng.steps_run} steps + {eng.warmup_steps} warm-up; launches "
              f"{json.dumps(counts)} (expected {json.dumps(want)}); "
              f"{'captures' if name == 'graphed' else 'builds'} "
              f"{ {str(k): v for k, v in captures[1].items()} }")
        if counts != want:
            fail(f"phase {phase}: {name} launch counts do not match the steps")
        if captures[0] != captures[1]:
            fail(f"phase {phase}: {name} captured again in the second pass "
                 f"({captures[0]} -> {captures[1]})")
        runs[name] = {"passes": passes, "launches": counts,
                      "steps": eng.steps_run, "warmup_steps": eng.warmup_steps,
                      "trace_counts": {str(k): v for k, v in captures[1].items()}}
        del setup, eng, out
        torch.cuda.empty_cache()
    for i in range(2):
        a = runs["graphed"]["passes"][i]["results"]
        b = runs["uncaptured"]["passes"][i]["results"]
        sampled = 2 + i * S.N_REQUESTS        # the pass's second request
        if a != b or len(a) != S.N_REQUESTS or sampled not in a:
            diff = sorted(u for u in set(a) | set(b) if a.get(u) != b.get(u))
            fail(f"phase {phase}: pass {i + 1}'s tokens differ between the "
                 f"graphed and uncaptured engines for uids {diff}")
        print(f"  pass {i + 1}: {len(a)} requests' tokens equal bit for bit "
              f"(sampled uid {sampled}: {a[sampled][:6]}...)")
    for r in runs.values():
        for p in r["passes"]:
            del p["results"]
    return runs


def streamed_parity(torch):
    """(b) the streamed route against the dense route at full width in fp32
    (TF32 off): phase 5's check on Llama-3.2-1B and DeepSeek-V3-dense3.
    fp32 caches at phase 5's 1e-3 of max(1, |logit|).  int8 caches at phase
    9's 5e-3: a layer's output differs by sum order (~1e-7 of itself) and
    that flips the int8 rounding of a few cache elements the next layers
    read (2.9e-3 on MLA at reduced width on the CPU).  Llama's dense route
    rounds a dequantized int8 cache to bf16 (1.7e-2 there), so its int8
    streamed route is held to the plain version of the kernel route
    (``"plain-kernel"``: the whole cache dequantized in fp32, as the
    streamed route dequantizes its blocks) and, as a second witness, to
    the kernel route itself."""
    out = {}
    streamed = ("streamed", "plain")
    for config in ("llama3p2_1b", "deepseek_v3_dense3"):
        out[config] = {"float32": engine_parity(
            torch, "15 (b)", config, ("float32",), 1e-3,
            routes=(streamed, ("dense", "plain")))}
        refs = ((("plain-kernel", "plain"), ("kernel", "kernel"))
                if config == "llama3p2_1b" else (("dense", "plain"),))
        for ref in refs:
            key = "int8" if ref is refs[0] else f"int8_against_{ref[0]}"
            out[config][key] = engine_parity(torch, "15 (b)", config,
                                             ("int8",), 5e-3,
                                             routes=(streamed, ref))
            out[config][key]["against"] = ref[0]
    return out


# PERF.md section 5's decode windows from before the engine's graphs
# (H100 80GB HBM3 at 700 W; 10 steps of the Python loop of steps; each
# model at full depth, RWKV6 at 24 layers where phase 11 now serves 12):
# wall ms, busy ms, idle share a step
WINDOWS_BEFORE = {
    "llama3p2_1b": {"base id": (36.2, 4.04, 0.889), "live": (48.1, 4.31, 0.910)},
    "deepseek_v3_dense3": {"base id": (13.6, 8.96, 0.341)},
    "rwkv6_1p6b": {"base id": (55.5, 12.33, 0.778), "live": (62.4, 12.86, 0.794)},
}


def engine_windows(report):
    """(c) the decode windows phases 4, 8 and 11 profiled, side by side:
    wall per step, device busy and idle share through ``run_steps`` (one
    graph replay and one poll a step) and through bursts of 8 (one replay
    and one poll a burst), on base-id rows and live rows, beside PERF.md's
    numbers from before the graphs."""
    print(f"phase 15 (c): decode windows on {CARD} (wall ms / busy ms / idle "
          "share a step)")
    out = {}
    for key, config in (("e2e", "llama3p2_1b"), ("mla_e2e", "deepseek_v3_dense3"),
                        ("rwkv_e2e", "rwkv6_1p6b")):
        rec = report[key]
        rows = {}
        for rows_on, suffix in (("base id", ""), ("live", "_adapters")):
            for how, win in (("run_steps", "profiled_decode"),
                             ("bursts", "profiled_burst")):
                w = rec[win + suffix]
                rows[f"{rows_on}, {how}"] = (w["wall_ms_per_step"],
                                             w["device_busy_ms_per_step"],
                                             w["idle_share"])
        before = WINDOWS_BEFORE[config]
        label = f"{config} ({rec['layers']} L)"
        for name, (wall, busy, idle) in rows.items():
            b = before.get(name.split(",")[0])
            print(f"  {label:25s} {name:20s} {wall:8.3f} / {busy:7.3f} / "
                  f"{idle:.3f}" + (f"   (before: {b[0]} / {b[1]} / {b[2]})"
                                   if b else ""))
        out[config] = {"after": rows, "before_graphs": before}
    return out


def benches(torch):
    """(d) ``kernel_bench`` and ``serve_bench`` once each at their
    defaults, on the card."""
    from repro_torch.benchmarks import kernel_bench, serve_bench
    print("phase 15 (d): repro_torch.benchmarks.kernel_bench and serve_bench "
          "at their defaults")
    t0 = time.perf_counter()
    kb = kernel_bench.report(device=DEVICE, log=lambda s: print("  " + s))
    t1 = time.perf_counter()
    # the mesh axis at mesh 1 only: phase 22 serves on a world of 2
    sb = serve_bench.bench(serve_bench.parse_args([]), device=DEVICE,
                           log=lambda s: print("  " + s), mesh_sizes=(1,))
    t2 = time.perf_counter()
    print(f"  kernel_bench {t1 - t0:.1f} s, serve_bench {t2 - t1:.1f} s")
    return {"kernel_bench": kb, "serve_bench": sb,
            "kernel_bench_s": t1 - t0, "serve_bench_s": t2 - t1}


def phase15(torch, report):
    t0 = time.perf_counter()
    out = {"graph_parity": {c: graph_parity(torch, c)
                            for c in ("llama3p2_1b", "deepseek_v3_dense3")},
           "streamed_parity": streamed_parity(torch),
           "windows": engine_windows(report),
           "benches": benches(torch)}
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 15: {out['phase_s']:.1f} s")
    return out


# -- phase 16: the federated runtime, the cohort runner on the card ----------

COHORT_SCHEDULES = (("sync", "static", {}), ("partial", "static", {}),
                    ("async", "static", {}), ("sampled", "static", {}),
                    ("sync", "resource", {"heterogeneous": True}))
SCHEDULE_STEPS = 2          # (d)'s local steps: the plans and calls, not time


def _tiny_setup(torch, layers: int = 0, dtype: str = ""):
    """TinyLlama-1.1B at published widths (``layers`` > 0 cuts the depth,
    ``dtype`` overrides bf16), random seeded weights, phase 13's 8
    Dirichlet(0.5) clients and eval set, LoRA r 16 on wq/wv."""
    from repro_torch.common.config import LoRAConfig
    from repro_torch.configs.tinyllama_1p1b import CONFIG
    from repro_torch.data.synthetic import make_eval_data, make_federated_data
    from repro_torch.models import transformer as T
    cfg = CONFIG.replace(**({"num_layers": layers} if layers else {}),
                         **({"dtype": dtype} if dtype else {}))
    params = T.init(cfg, 0, DEVICE)
    clients = make_federated_data(num_clients=8, seq_len=FED_SEQ,
                                  vocab=cfg.vocab_size, alpha=0.5, seed=0)
    ev = make_eval_data(num_samples=16, seq_len=FED_SEQ, vocab=cfg.vocab_size)
    lora = LoRAConfig(rank=TINY_RANK, alpha=float(TINY_RANK),
                      targets=TINY_TARGETS)
    return cfg, params, clients, ev, lora


def _tiny_trainer(setup, runner="sequential", fed_kw=None, **kw):
    """Phase 13's FLoRIST trainer (4 of 8 clients a round, 4 local steps of
    4 x 512 tokens unless ``local_steps`` says otherwise, the bf16 wire, the
    Gram route) on a shared setup."""
    from repro_torch.common.config import FedConfig, OptimConfig
    from repro_torch.core.federated import FederatedTrainer
    cfg, params, clients, ev, lora = setup
    fed = FedConfig(**{**dict(num_clients=8, clients_per_round=4,
                              homogeneous_rank=TINY_RANK, dirichlet_alpha=0.5,
                              tau=0.9, method="florist", seed=0,
                              rank_distribution=((4, 2), (8, 2), (16, 2),
                                                 (32, 2))),
                       **(fed_kw or {})})
    kw.setdefault("transport", "bf16")
    kw.setdefault("local_steps", 4)
    return FederatedTrainer(cfg, fed, lora, OptimConfig(lr=3e-4),
                            clients=clients, eval_data=ev, batch_size=FED_BATCH,
                            seq_len=FED_SEQ, svd_method="gram",
                            runner=runner, params=params, device=DEVICE, **kw)


def _recording_plans(tr):
    """Keep every plan the trainer's scheduler makes (rank policy applied
    in place afterwards) in the returned list."""
    plans = []
    orig = tr.scheduler.plan
    tr.scheduler.plan = lambda rnd, ctx: plans.append(orig(rnd, ctx)) or plans[-1]
    return plans


def cohort_rounds(torch, setup):
    """(b) two FLoRIST rounds with ``sequential`` and with ``cohort`` under
    ``sync``: the cohort round's train-step ``lora_matmul`` and
    ``flash_attention`` launches must be exactly 1/4 of the sequential
    round's (and equal L · 2 · steps and L · steps), and both finalize
    through ``adapter_gram`` (2 · buckets a round: the server folds the
    cohort's updates on the card too); round walls and train-step medians
    of both; a profiled window of each runner's step."""
    from repro_torch.core.runtime import CohortRunner, SequentialRunner
    from repro_torch.core.runtime.runners import _stack_cohort, to_device
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import adamw_init
    cfg = setup[0]
    L = cfg.num_layers
    out, launches, trainers = {}, {}, {}
    ops.reset_launch_counts()
    for name, runner in (("sequential", SequentialRunner(record_steps=True)),
                         ("cohort", CohortRunner(record_steps=True))):
        tr = _tiny_trainer(setup, runner)
        trainers[name] = tr
        ops.reset_launch_counts()
        rounds = []
        for rnd in range(TINY_ROUNDS):
            n_log = len(runner.step_log())
            before = ops.launch_counts()
            rec = tr.run_round(rnd)
            got = ops.launch_delta(before, ops.launch_counts())
            log = runner.step_log()[n_log:]
            step_ms = [e["ms"] for e in log]
            calls = len(log)
            buckets = len({(n, m) for _, n, m in tr.aggregator.dims.values()})
            train = {"lora_matmul": got.get("lora_matmul", 0),
                     "flash_attention": got.get("flash_attention", 0) - L,
                     "adapter_gram": got.get("adapter_gram", 0)}
            want = {"lora_matmul": L * len(TINY_TARGETS) * calls,
                    "flash_attention": L * calls,
                    "adapter_gram": 2 * buckets}             # B and A stacks
            tok = sum(len(e["clients"]) for e in log) * FED_BATCH * FED_SEQ
            print(f"  {name} round {rnd}: eval loss {rec.eval_loss:.4f}; wall "
                  f"{rec.wall_secs:.2f} s, finalize {rec.finalize_secs * 1e3:.1f}"
                  f" ms; {calls} train-step calls, median "
                  f"{statistics.median(step_ms):.2f} ms (CUDA events), "
                  f"{tok / (sum(step_ms) / 1e3):.0f} train tok/s; train-step "
                  f"and finalize launches {json.dumps(train)} (expected "
                  f"{json.dumps(want)})")
            if train != want:
                fail(f"phase 16 (b) {name} round {rnd}: launches {train} != {want}")
            if not math.isfinite(rec.eval_loss):
                fail(f"phase 16 (b) {name} round {rnd}: eval loss {rec.eval_loss}")
            rounds.append({"record": dataclasses.asdict(rec), "calls": calls,
                           "train_step_ms": step_ms,
                           "train_step_ms_median": statistics.median(step_ms),
                           "train_tok_s": tok / (sum(step_ms) / 1e3),
                           "train_launches": train})
        launches[name] = {k: sum(r["train_launches"][k] for r in rounds)
                          for k in ("lora_matmul", "flash_attention",
                                    "adapter_gram")}
        out[name] = rounds
    seq, coh = launches["sequential"], launches["cohort"]
    print(f"  train-step launches over {TINY_ROUNDS} rounds: sequential "
          f"{json.dumps(seq)}, cohort {json.dumps(coh)}")
    if any(4 * coh[k] != seq[k] for k in ("lora_matmul", "flash_attention")):
        fail(f"phase 16 (b): cohort launches {coh} are not 1/4 of {seq}")

    # a window of each runner's train step, profiled: one rank-16 client,
    # and the cohort of four in one call
    tr = trainers["cohort"]
    plan = tr.scheduler.plan(TINY_ROUNDS, tr)
    task_init = lambda t: tr._client_init(t.client_id, t.rank)
    stacked, batch, _ = _stack_cohort(tr, TINY_ROUNDS, plan.tasks, task_init, 4)
    cb = {"tokens": torch.as_tensor(batch["tokens"][:, 0], device=DEVICE),
          "loss_mask": torch.as_tensor(batch["loss_mask"][:, 0], device=DEVICE)}
    state = {"c": stacked, "co": adamw_init(stacked),
             "s": to_device(task_init(plan.tasks[0]), tr.device)}
    state["so"] = adamw_init(state["s"])
    sb = {k: v[0] for k, v in cb.items()}
    cstep, sstep = tr._cohort_step(), tr._train_step()

    def run_cohort(n):
        for _ in range(n):
            state["c"], state["co"], _ = cstep(tr.params, state["c"],
                                               state["co"], cb)

    def run_single(n):
        for _ in range(n):
            state["s"], state["so"], _ = sstep(tr.params, state["s"],
                                               state["so"], sb)

    run_cohort(1)
    run_single(1)
    windows = {
        "cohort": profile_window(torch, run_cohort, 3, f"cohort train step, 4 "
                                 f"clients x {FED_BATCH} x {FED_SEQ} tokens, r=16"),
        "sequential": profile_window(torch, run_single, 3, f"train step, one "
                                     f"client, {FED_BATCH} x {FED_SEQ} tokens, r=16")}
    del trainers, tr, state
    torch.cuda.empty_cache()
    return {"rounds": out, "train_launches": launches,
            "profiled_steps": windows}, coh


def _global_products(torch, tr):
    from repro_torch.core.aggregators import adapter_leaf_paths, fold_scale, get_path
    g = tr.global_state.global_adapters
    out = {}
    for path in adapter_leaf_paths(g):
        B, A = fold_scale(get_path(g, path))
        out[path] = (torch.as_tensor(B, device=DEVICE).double()
                     @ torch.as_tensor(A, device=DEVICE).double())
    return out


def cohort_parity(torch):
    """(c) the same setup at 2 layers in fp32 with TF32 off: cohort against
    sequential (:func:`runner_parity`)."""
    from repro_torch.device import parity_mode
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print(f"phase 16 (c): {parity_mode()}")
    setup = _tiny_setup(torch, layers=2, dtype="float32")
    out = runner_parity(torch, "phase 16 (c)", _tiny_trainer(setup),
                        _tiny_trainer(setup, "cohort"))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del setup
    torch.cuda.empty_cache()
    return out


def runner_parity(torch, label, seq, coh, rounds: int = TINY_ROUNDS):
    """Two trainers of one setup, ``seq`` on the sequential runner and
    ``coh`` on the cohort runner: the global ΔW products within 5e-4 of
    max(1, |ΔW|) and the eval loss within 1e-4 after each of ``rounds``
    rounds (the reference's own tolerance); then one round's plan trained
    by both runners from one trainer state, each client's adapters from
    the one cohort call against its sequential training (5e-4 of max(1,
    |x|))."""
    from repro_torch.core.aggregators import adapter_leaf_paths, get_path
    results = []
    for rnd in range(rounds):
        a, b = seq.run_round(rnd), coh.run_round(rnd)
        pa, pb = _global_products(torch, seq), _global_products(torch, coh)
        d = max(((pa[p] - pb[p]).abs().max() / pa[p].abs().max().clamp_min(1.0)).item()
                for p in pa)
        dl = abs(a.eval_loss - b.eval_loss)
        print(f"  round {rnd}: eval loss sequential {a.eval_loss:.6f} cohort "
              f"{b.eval_loss:.6f} (|Δ| {dl:.2e}, limit 1e-4); ΔW max |Δ| / "
              f"max(1, |ΔW|) {d:.2e} (limit 5e-4); kept ranks equal "
              f"{seq.global_state.ranks == coh.global_state.ranks}")
        if dl > 1e-4 or d > 5e-4:
            fail(f"{label} round {rnd}: cohort differs from sequential")
        results.append({"eval_loss": [a.eval_loss, b.eval_loss],
                        "delta_w_rel": d})
    # one trainer state and one plan for both runners: the two trainers'
    # global adapters agree as products, but their SVD factors (the next
    # round's client inits) may rotate within near-degenerate singular values
    from repro_torch.core.runtime import CohortRunner, SequentialRunner
    plan = seq.scheduler.plan(rounds, seq)
    got = {}
    for name, runner in (("sequential", SequentialRunner()),
                         ("cohort", CohortRunner())):
        got[name] = []
        runner.run(seq, plan, lambda t, ad, init: got[name].append((t.client_id, ad)))
    worst = 0.0
    for (ka, ta), (kb, tb) in zip(got["sequential"], got["cohort"]):
        if ka != kb:
            fail(f"{label}: delivery order {ka} != {kb}")
        for p in adapter_leaf_paths(ta):
            for n in ("A", "B"):
                x = torch.as_tensor(get_path(ta, p)[n], device=DEVICE).double()
                y = torch.as_tensor(get_path(tb, p)[n], device=DEVICE).double()
                worst = max(worst, ((x - y).abs().max()
                                    / x.abs().max().clamp_min(1.0)).item())
    print(f"  each client's trained A and B, one cohort call against its "
          f"sequential training: max |Δ| / max(1, |x|) {worst:.2e} (limit 5e-4)")
    if worst > 5e-4:
        fail(f"{label}: a client's cohort-trained adapters differ")
    del seq, coh
    return {"rounds": results, "client_adapters_rel": worst}


def cohort_schedules(torch, setup):
    """(d) one round of each scheduler (``sync``, ``partial``, ``async``,
    ``sampled`` at half the population) and of the ``resource`` rank
    policy on heterogeneous ranks, under ``cohort``, ``SCHEDULE_STEPS``
    local steps a client: every task's rank a
    power of two when the policy is ``resource``, one cohort step call a
    local step of each equal-(rank, steps) cohort, and ``lora_matmul``
    launched L · 2 times a call, ``adapter_gram`` 2 · buckets a round."""
    from repro_torch.core.runtime import CohortRunner, make_scheduler
    from repro_torch.kernels import ops
    L = setup[0].num_layers
    out = {}
    for sched, policy, fed_kw in COHORT_SCHEDULES:
        runner = CohortRunner(record_steps=True)
        scheduler = (make_scheduler("sampled", fraction=0.5)
                     if sched == "sampled" else sched)
        tr = _tiny_trainer(setup, runner, fed_kw, scheduler=scheduler,
                           rank_policy=policy, local_steps=SCHEDULE_STEPS)
        plans = _recording_plans(tr)
        before = ops.launch_counts()
        rec = tr.run_round(0)
        got = ops.launch_delta(before, ops.launch_counts())
        plan, log = plans[-1], runner.step_log()
        cohorts = {}
        for t in plan.tasks:
            cohorts.setdefault((t.rank, t.steps), []).append(t.client_id)
        calls = collections.Counter(tuple(e["clients"]) for e in log)
        want_calls = {tuple(ids): steps for (_, steps), ids in cohorts.items()}
        ranks = [t.rank for t in plan.tasks]
        pow2 = all(r & (r - 1) == 0 for r in ranks)
        print(f"  {sched}/{policy}: tasks (client, rank, steps) "
              f"{[(t.client_id, t.rank, t.steps) for t in plan.tasks]}; "
              f"{len(cohorts)} cohorts, {len(log)} cohort step calls; launches "
              f"{json.dumps(got)}; eval loss {rec.eval_loss:.4f}, wall "
              f"{rec.wall_secs:.2f} s")
        if dict(calls) != want_calls:
            fail(f"phase 16 (d) {sched}/{policy}: step calls {dict(calls)} != "
                 f"one a local step of each cohort {want_calls}")
        buckets = len({(n, m) for _, n, m in tr.aggregator.dims.values()})
        if (got.get("lora_matmul", 0) != L * len(TINY_TARGETS) * len(log)
                or got.get("adapter_gram", 0) != 2 * buckets):
            fail(f"phase 16 (d) {sched}/{policy}: launches {got}")
        if policy == "resource" and not pow2:
            fail(f"phase 16 (d): resource ranks {ranks} are not powers of two")
        if not math.isfinite(rec.eval_loss):
            fail(f"phase 16 (d) {sched}/{policy}: eval loss {rec.eval_loss}")
        out[f"{sched}/{policy}"] = {
            "tasks": [(t.client_id, t.rank, t.steps, t.weight) for t in plan.tasks],
            "cohorts": len(cohorts), "calls": len(log),
            "step_ms_median": statistics.median(e["ms"] for e in log),
            "launches": got, "record": dataclasses.asdict(rec)}
        del tr
    return out


def expected_wire(tr, plan, faults, dp: bool, max_retries: int = 3):
    """The counters, int8 wire bytes and folded weights one round must show,
    worked out from ``FaultPlan.client_fault``, the plan and the gate's
    rules alone: drops and clients corrupted more than ``max_retries``
    times are dead, every corruption below that is a retry, NaN poison and
    the second copy of a duplicate are gate rejections; every other upload
    is held.  With at least ``min_mad_samples`` held and no DP stage (which
    clips a scaled delta back to the bound), the scale-poisoned clients
    are quarantined and the survivors' weights renormalised to the held
    mass.  Each upload attempt costs the client's A and B at 1 byte a
    parameter plus a 4-byte scale header a block, and the downlink the
    kept ranks' A and B (from the aggregator's dims) a receiver, headers
    included.  Returns (counts, expected weights in fold order)."""
    from repro_torch.core.aggregators import adapter_leaf_paths, get_path
    want = {"retries": 0, "dead_clients": 0, "rejected": 0, "attempts": 0}
    held = []
    for t in plan.tasks:
        f = faults.client_fault(plan.round, t.client_id)
        if f.kind == "drop":
            want["dead_clients"] += 1
            continue
        if f.kind == "corrupt":
            want["retries"] += min(f.n_bad, max_retries)
            if f.n_bad > max_retries:
                want["dead_clients"] += 1
                want["attempts"] += max_retries + 1
                continue
            want["attempts"] += f.n_bad + 1
        else:
            want["attempts"] += 1
        if f.kind in ("nan", "duplicate"):
            want["rejected"] += 1
        if f.kind != "nan":
            held.append((t, f.kind))
    quarantine = (not dp and len(held) >= tr.gate.min_mad_samples)
    kept = [t for t, kind in held if not (quarantine and kind == "scale")]
    want["quarantined"] = len(held) - len(kept)
    factor = (sum(t.weight for t, _ in held) / sum(t.weight for t in kept)
              if want["quarantined"] else 1.0)
    init = tr._client_init(plan.tasks[0].client_id, plan.tasks[0].rank)
    paths = adapter_leaf_paths(init)
    per_attempt = sum(math.prod(get_path(init, p)[n].shape) + 4
                      for p in paths for n in ("A", "B"))
    want["upload_bytes"] = want.pop("attempts") * per_attempt
    if kept:
        receivers = (plan.downloads if plan.downloads is not None
                     else len(plan.tasks))
        per_receiver = sum(r_l * (n + m) + 2 * 4
                           for path, (_, n, m) in tr.aggregator.dims.items()
                           for r_l in tr.global_state.ranks[path])
        want["download_bytes"] = receivers * per_receiver
    return want, [t.weight * factor for t in kept]


def _folded_weights(tr):
    """Keep the weight of every update the gate folds into the aggregator
    in the returned list."""
    weights = []
    add = tr.aggregator.add_client
    tr.aggregator.add_client = (lambda update, weight, rank=None:
                                weights.append(weight)
                                or add(update, weight, rank=rank))
    return weights


def hardened_wire(torch, setup):
    """(e) at phase 16's depth under ``cohort``, the ``int8`` codec and gate
    ``full``: two rounds with DP (clip 1.0, σ for ε 8) and a FaultPlan of
    drop, corrupt, duplicate, NaN and scale at 0.2 each, then one round
    without DP whose plan holds one scale-poisoned client among four held
    updates, which the gate's MAD test must quarantine.  In every round
    the record's retries, dead clients, rejections, quarantines and wire
    bytes, and the weights folded into the aggregator, must equal what
    :func:`expected_wire` works out from the plan."""
    from repro_torch.core.privacy import noise_multiplier_for_epsilon
    from repro_torch.core.runtime import FaultPlan, ValidationGate
    sigma = noise_multiplier_for_epsilon(8.0)
    arms = (("dp", FaultPlan(seed=3, drop=0.2, corrupt=0.2, duplicate=0.2,
                             nan=0.2, scale=0.2),
             dict(dp_clip=1.0, dp_sigma=sigma), TINY_ROUNDS),
            ("no dp", FaultPlan(seed=0, scale=0.25), {}, 1))
    out = []
    for arm, faults, dp_kw, rounds in arms:
        tr = _tiny_trainer(setup, "cohort", transport="int8",
                           validation=ValidationGate("full"), faults=faults,
                           **dp_kw)
        plans = _recording_plans(tr)
        folded = _folded_weights(tr)
        for rnd in range(rounds):
            del folded[:]
            rec = tr.run_round(rnd)
            want, weights = expected_wire(tr, plans[-1], faults, bool(dp_kw))
            got = {k: getattr(rec, k) for k in want}
            kinds = [faults.client_fault(rnd, t.client_id).kind
                     for t in plans[-1].tasks]
            w_err = (max(abs(x - y) / y for x, y in zip(folded, weights))
                     if len(folded) == len(weights) and weights else 0.0)
            print(f"  {arm} round {rnd}: faults {kinds}; record "
                  f"{json.dumps(got)}, quorum {rec.quorum_met}, sim "
                  f"{rec.sim_secs:.3f} s; from the plan {json.dumps(want)}; "
                  f"folded weights {[round(w, 6) for w in folded]} (from the "
                  f"plan {[round(w, 6) for w in weights]}, max rel |Δ| "
                  f"{w_err:.1e}); eval loss {rec.eval_loss:.4f}, wall "
                  f"{rec.wall_secs:.2f} s"
                  + (f" (σ {sigma:.4f})" if dp_kw else ""))
            if got != want:
                fail(f"phase 16 (e) {arm} round {rnd}: record {got} != {want}")
            if len(folded) != len(weights) or w_err > 1e-12:
                fail(f"phase 16 (e) {arm} round {rnd}: folded weights "
                     f"{folded} != {weights}")
            if not dp_kw and not want["quarantined"]:
                fail(f"phase 16 (e) {arm} round {rnd}: the plan quarantines "
                     "nothing, so the check cannot bite")
            out.append({"arm": arm, "record": dataclasses.asdict(rec),
                        "faults": kinds, "expected": want,
                        "folded_weights": list(folded),
                        "expected_weights": weights})
        del tr
    return out


def crash_resume(torch, setup):
    """(f) a crash at ``mid_round`` of round 1 under ``cohort``, then a
    fresh trainer resumed from the round-boundary checkpoint: its history
    (times aside) and global adapters must equal the uninterrupted run's
    bit for bit on the card."""
    import shutil

    import numpy as np
    from repro_torch.core.aggregators import adapter_leaf_paths, get_path
    from repro_torch.core.runtime import FaultPlan, ServerCrash
    ck_dir = ROOT / "build" / "phase16"
    ck_dir.mkdir(parents=True, exist_ok=True)
    ck = str(ck_dir / "fed.ckpt")
    t0 = time.perf_counter()
    ref = _tiny_trainer(setup, "cohort")
    ref_hist = ref.run(TINY_ROUNDS)
    plan = FaultPlan(seed=0, crashes=((1, "mid_round"),))
    crashed = _tiny_trainer(setup, "cohort", faults=plan)
    try:
        crashed.run(TINY_ROUNDS, checkpoint=ck)
        fail("phase 16 (f): the injected crash did not happen")
    except ServerCrash as e:
        print(f"  {e}")
    del crashed
    resumed = _tiny_trainer(setup, "cohort", faults=plan.without_crashes())
    hist = resumed.run(TINY_ROUNDS, checkpoint=ck, resume=True)
    strip = lambda r: {k: v for k, v in dataclasses.asdict(r).items()
                       if k not in ("wall_secs", "finalize_secs", "sim_secs",
                                    "resumes")}
    same_hist = [strip(r) for r in hist] == [strip(r) for r in ref_hist]
    g, rg = resumed.global_state.global_adapters, ref.global_state.global_adapters
    diffs = {}
    for p in adapter_leaf_paths(rg):
        for n in ("A", "B"):
            a, b = np.asarray(get_path(rg, p)[n]), np.asarray(get_path(g, p)[n])
            if not np.array_equal(a, b):
                diffs[f"{'/'.join(map(str, p))}/{n}"] = float(np.abs(a - b).max())
    secs = time.perf_counter() - t0
    print(f"  resumed history equal to the uninterrupted run's bit for bit: "
          f"{same_hist}; resumes {[r.resumes for r in hist]}; global adapters "
          f"that differ: {diffs or 'none'}; eval losses "
          f"{[r.eval_loss for r in hist]} vs {[r.eval_loss for r in ref_hist]}; "
          f"{secs:.1f} s")
    shutil.rmtree(ck_dir, ignore_errors=True)
    if not same_hist or diffs:
        fail("phase 16 (f): the resumed run differs from the uninterrupted one")
    del ref, resumed
    return {"bit_identical": True, "eval_loss": [r.eval_loss for r in hist],
            "secs": secs}


def runtime_entry_points(torch):
    """(g) ``fed_bench``'s runner × scheduler arm (its default model and
    clients, 2 local steps, one timed round a combination after two
    warm-ups) and ``federated_finetune`` at its tiny profile, on the
    card."""
    from repro_torch.benchmarks import fed_bench
    from repro_torch.examples import federated_finetune
    print("phase 16 (g): repro_torch.benchmarks.fed_bench (runner x scheduler) "
          "and examples.federated_finetune (tiny, cohort)")
    bench = fed_bench.main(["--iters", "1", "--local-steps", "2",
                            "--device", DEVICE])
    tr = federated_finetune.main(["--rounds", "2", "--runner", "cohort",
                                  "--device", DEVICE])
    if not all(math.isfinite(r.eval_loss) for r in tr.history):
        fail("phase 16 (g): federated_finetune gave a non-finite loss")
    return {"fed_bench": bench,
            "federated_finetune": [dataclasses.asdict(r) for r in tr.history]}


def phase16(torch):
    """Phase 16: the federated runtime on the card, (b) to (g); (a) runs
    with the other kernel cases."""
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    setup = _tiny_setup(torch, layers=TINY_LAYERS)
    cfg = setup[0]
    print(f"phase 16: the federated runtime on {cfg.name} at published widths "
          f"(depth cut to {cfg.num_layers} layers, d {cfg.d_model}, {cfg.dtype}; random seeded "
          f"weights), LoRA r {TINY_RANK} on {'/'.join(TINY_TARGETS)}, 8 clients, "
          f"4 a round, 4 local steps of {FED_BATCH} x {FED_SEQ} tokens")
    out, part_s = {}, {}

    def timed(key, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        part_s[key] = time.perf_counter() - t
        return res

    out["runners"], counts = timed("b", cohort_rounds, torch, setup)
    out["schedulers"] = timed("d", cohort_schedules, torch, setup)
    out["hardened_wire"] = timed("e", hardened_wire, torch, setup)
    out["crash_resume"] = timed("f", crash_resume, torch, setup)
    del setup
    torch.cuda.empty_cache()
    out["parity"] = timed("c", cohort_parity, torch)
    out["entry_points"] = timed("g", runtime_entry_points, torch)
    ops.reset_launch_counts()
    out["part_s"] = part_s
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 16: {out['phase_s']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in part_s.items())
          + ", the rest set-up)")
    return out, counts


# -- phase 17: the Qwen configs at published widths ---------------------------

# launch.serve's Qwen configs and the published depth of each
QWEN_SERVE = (("qwen2_0p5b", 24), ("qwen3_4b", 36), ("qwen2p5_14b_l8", 48),
              ("qwen1p5_32b_l4", 64))
QWEN_SERVE_CUTS = {"qwen3_4b": QWEN3_LAYERS}     # served at this depth


def phase17(torch):
    """(a) phase 4's traffic on each Qwen config (``launch.serve``) through
    ``decode_impl="kernel"`` on the graphed engine, adapters on ``wq wk wv
    wo``, a swap; launches exact (``ring_decode`` L and ``bgmv`` 4 · L an
    engine step); the decode step's wall, busy and idle share from a
    profiled burst window on the live adapters; (b) phase 5 on each at 2 layers and full width
    in fp32 (TF32 off), greedy tokens required equal; (c)
    ``examples.serve_batch`` at its defaults and with ``--decode-impl
    kernel --int8-cache``."""
    from repro_torch.launch.serve import CONFIGS
    t_phase = time.perf_counter()
    out = {"serve": {}, "parity": {}}
    counts = collections.Counter()
    for key, full in QWEN_SERVE:
        served = (cut_config(key, QWEN_SERVE_CUTS[key])
                  if key in QWEN_SERVE_CUTS else key)
        L = CONFIGS[served][0].num_layers
        out["serve"][key], c = end_to_end(
            torch, "17 (a)", served,
            windows=("profiled_burst_adapters",),
            full_layers=full if L != full else 0)
        counts.update(c)
    for key, _ in QWEN_SERVE:
        out["parity"][key] = engine_parity(torch, "17 (b)", key, layers=2,
                                           require_equal=True)
    out["serve_batch"] = serve_batch_card(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 17: {out['phase_s']:.1f} s")
    return out, {k: v for k, v in counts.items() if v}


def serve_batch_card(torch):
    """(c) ``repro_torch.examples.serve_batch`` on the card at its defaults
    (``qwen2-0.5b`` SMOKE, dense route) and with ``--decode-impl kernel
    --int8-cache``: tokens in the vocabulary, ``ring_decode`` launched once
    a layer a call on the kernel route (2 prefill calls of 8 and 24 decode
    calls) and never on the dense one."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import serve_batch
    from repro_torch.kernels import ops
    cfg = get_smoke_config("qwen2-0.5b")
    print("phase 17 (c): repro_torch.examples.serve_batch on the card")
    res = {}
    for name, argv in (("defaults", []),
                       ("kernel_int8", ["--decode-impl", "kernel", "--int8-cache"])):
        ops.reset_launch_counts()
        toks = serve_batch.main(argv + ["--device", DEVICE])
        got = ops.launch_counts()["ring_decode"]
        want = cfg.num_layers * (2 + 24) if argv else 0
        print(f"  {name}: {tuple(toks.shape)} tokens; ring_decode launches "
              f"{got} (expected {want})")
        if got != want:
            fail(f"phase 17 (c): serve_batch {name}: ring_decode launched "
                 f"{got} times, expected {want}")
        if tuple(toks.shape) != (4, 24) or not 0 <= int(toks.min()) <= int(
                toks.max()) < cfg.vocab_size:
            fail(f"phase 17 (c): serve_batch {name} gave tokens {toks}")
        res[name] = {"tokens": toks.tolist(), "ring_decode_launches": got}
    return res


# -- phase 18: the single-client trainer ---------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 512


def _nonzero_b(ad, gen, std: float = 0.01):
    """``ad`` with every B drawn from N(0, std²) (``init_lora``'s B is zero,
    which leaves A's gradient zero at the first step)."""
    import torch
    from repro_torch.serve.adapters import adapter_leaves
    for _, leaf in adapter_leaves(ad):
        b = leaf["B"]
        leaf["B"] = torch.randn(b.shape, generator=gen, device=b.device) * std
    return ad


def phase18(torch):
    """(a) ``Trainer(use_kernels=True)`` on Qwen2-0.5B at published widths
    and full depth: 6 steps of 4 x 512 tokens, ``eval_every`` and
    ``ckpt_every`` 3; launches exact (``lora_matmul`` 96 and
    ``flash_attention`` 24 a forward, train step or eval); a second
    trainer's ``restore_ckpt`` bit-equal; the median step, tokens/s and a
    profiled window.  (b) ``python -m repro_torch.launch.train --arch
    qwen2-0.5b --steps 4 --use-kernels`` as a subprocess.  (c) at 2 layers
    and full width in fp32 (TF32 off): two train steps on the kernel route
    against the plain route (:func:`step_route_parity`)."""
    t_phase = time.perf_counter()
    out, counts = trainer_card(torch)
    out["launcher"] = train_launcher_card(torch)
    out["parity"] = trainer_parity(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 18: {out['phase_s']:.1f} s")
    return out, counts


def trainer_card(torch):
    import shutil

    from repro_torch.common.config import LoRAConfig, OptimConfig
    from repro_torch.configs import lora_targets, qwen2_0p5b
    from repro_torch.data.synthetic import make_eval_data
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = qwen2_0p5b.CONFIG
    L, targets, B = cfg.num_layers, lora_targets(cfg), TRAIN_BATCH
    print(f"phase 18 (a): Trainer(use_kernels=True) on {cfg.name} at published "
          f"widths ({L} L, d {cfg.d_model}, {cfg.num_heads} H / "
          f"{cfg.num_kv_heads} KV, hd {cfg.head_dim}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; random seeded weights), LoRA r 16 on "
          f"{'/'.join(targets)}, {TRAIN_STEPS} steps of {B} x {TRAIN_SEQ} "
          f"tokens, eval and checkpoint every 3")
    ck_dir = ROOT / "build" / "phase18"
    tcfg = TrainerConfig(steps=TRAIN_STEPS, eval_every=3, ckpt_every=3,
                         ckpt_path=str(ck_dir / "trainer.npz"), loss_chunk=512,
                         use_kernels=True)
    lora, optim = LoRAConfig(rank=16, alpha=16.0, targets=targets), OptimConfig(lr=3e-4)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, lora, optim, tcfg, targets, seed=0, device=DEVICE)
    data = make_eval_data(num_samples=B * (TRAIN_STEPS + 1), seq_len=TRAIN_SEQ,
                          vocab=cfg.vocab_size)
    batches = [{k: v[i * B:(i + 1) * B] for k, v in data.items()}
               for i in range(TRAIN_STEPS)]
    ev = {k: v[-B:] for k, v in data.items()}
    ops.reset_launch_counts()
    hist = tr.fit(iter(batches), eval_batch=ev)
    got = ops.launch_counts()
    forwards = TRAIN_STEPS + TRAIN_STEPS // 3          # the steps and the evals
    want = dict.fromkeys(ops.WRAPPERS, 0) | {
        "lora_matmul": L * len(targets) * forwards, "flash_attention": L * forwards}
    walls = [r["wall_s"] for r in hist]
    step_s = [b - a for a, b in zip([0.0] + walls, walls)]
    plain = [s for s, r in zip(step_s, hist) if "eval_loss" not in r]
    for r in hist:
        print(f"  step {r['step']}: loss {r['loss']:.4f} acc {r['accuracy']:.4f}"
              + (f"; eval loss {r['eval_loss']:.4f} acc {r['eval_accuracy']:.4f}"
                 if "eval_loss" in r else "") + f" ({r['wall_s']:.2f} s)")
    med = statistics.median(plain)
    print(f"  launches {json.dumps(got)}; expected {json.dumps(want)}")
    print(f"  median step (no eval or checkpoint) {med * 1e3:.1f} ms, "
          f"{B * TRAIN_SEQ / med:.0f} train tok/s; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if got != want:
        fail(f"phase 18 (a): launch counts {got} != {want}")
    if [("eval_loss" in r) for r in hist] != [False, False, True] * 2:
        fail("phase 18 (a): eval records not at every third step")
    if not all(math.isfinite(r[k]) for r in hist for k in r):
        fail("phase 18 (a): a non-finite loss or accuracy")
    tr2 = Trainer(cfg, lora, optim, tcfg, targets, seed=1, params=tr.params,
                  device=DEVICE)
    step = tr2.restore_ckpt()
    same = all(torch.equal(x, y) and x.dtype == y.dtype for x, y in zip(
        tree_leaves(tr.adapters) + tree_leaves(tr.opt_state),
        tree_leaves(tr2.adapters) + tree_leaves(tr2.opt_state)))
    print(f"  restore_ckpt: step {step}; adapters and AdamW state bit-equal {same}")
    if step != TRAIN_STEPS or not same:
        fail("phase 18 (a): the restored trainer differs from the saved one")
    shutil.rmtree(ck_dir)
    del tr2
    b = tr._on_device(batches[0])
    state = {"a": tr.adapters, "o": tr.opt_state}

    def run(n):
        for _ in range(n):
            state["a"], state["o"], _ = tr._train(tr.params, state["a"],
                                                  state["o"], b)
    run(1)
    window = profile_window(torch, run, 3, f"Trainer step, {B} x {TRAIN_SEQ} "
                            "tokens, r 16", reps=3)
    out = {"history": hist, "launches": got, "step_ms_median": med * 1e3,
           "train_tok_s": B * TRAIN_SEQ / med,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "profiled_step": window}
    del tr, state, b
    torch.cuda.empty_cache()
    return out, {k: v for k, v in got.items() if v}


def train_launcher_card(torch):
    """(b) the launcher's documented run, as a user would start it."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2-0.5b", "--steps", "4", "--use-kernels"]
    print(f"phase 18 (b): {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        print(f"  | {line}")
    final = [ln for ln in lines if ln.startswith("final eval: loss=")]
    if proc.returncode != 0 or not final:
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"phase 18 (b): the launcher exited {proc.returncode}")
    loss = float(final[0].split("loss=")[1].split()[0])
    if not math.isfinite(loss):
        fail(f"phase 18 (b): final eval loss {loss}")
    print(f"  exit 0 in {secs:.1f} s, final eval loss {loss:.4f}")
    return {"stdout": lines, "final_eval_loss": loss, "secs": secs}


def trainer_parity(torch):
    from repro_torch.configs import lora_targets, qwen2_0p5b
    from repro_torch.data.synthetic import make_federated_data
    from repro_torch.device import parity_mode
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    cfg = qwen2_0p5b.CONFIG.replace(dtype="float32", num_layers=2)
    print(f"phase 18 (c): {cfg.name} train step, kernel route vs plain route, "
          f"full width in fp32, depth cut to 2 layers; " + parity_mode())
    dev = torch.device(DEVICE)
    params = T.init(cfg, 3, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    ad = _nonzero_b(init_lora(params, lora_targets(cfg), 16, 16.0, gen), gen)
    data = make_federated_data(num_clients=1, seq_len=TRAIN_SEQ,
                               vocab=cfg.vocab_size, seed=5)[0]
    batches = [{"tokens": torch.as_tensor(data.tokens[i:i + 2], device=dev).long(),
                "loss_mask": torch.as_tensor(data.loss_mask[i:i + 2], device=dev)}
               for i in (0, 2)]
    res = step_route_parity(torch, "phase 18 (c)", cfg, params, ad, batches)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del params, ad
    torch.cuda.empty_cache()
    return res


# -- phase 19: RWKV6 training ------------------------------------------------

RWKV_TRAIN_ROUNDS, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ = 2, 2, 256
# phase 19 (a) trains RWKV6-1.6B at full width cut to this depth (of its
# 24 layers): its host-bound step scales with depth, and the whole script
# must stay inside its time on a slow host
RWKV_TRAIN_LAYERS = 3


def _rwkv_trainer(cfg, params, runner="sequential"):
    """FLoRIST on RWKV6: rank 16 on its five targets, 4 of 8 clients a
    round, 2 local steps of 2 x 256 tokens, the Gram route."""
    from repro_torch.common.config import FedConfig, LoRAConfig, OptimConfig
    from repro_torch.configs import lora_targets
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.synthetic import make_eval_data
    fed = FedConfig(num_clients=8, clients_per_round=4, homogeneous_rank=16,
                    tau=0.9, method="florist", seed=0)
    lora = LoRAConfig(rank=16, alpha=16.0, targets=lora_targets(cfg))
    return FederatedTrainer(
        cfg, fed, lora, OptimConfig(lr=3e-4), params=params,
        eval_data=make_eval_data(num_samples=8, seq_len=RWKV_TRAIN_SEQ,
                                 vocab=cfg.vocab_size),
        batch_size=RWKV_TRAIN_BATCH, local_steps=2, seq_len=RWKV_TRAIN_SEQ,
        svd_method="gram", runner=runner, device=DEVICE)


def phase19(torch):
    """(a) two FLoRIST rounds of RWKV6-1.6B at published widths, cut to
    ``RWKV_TRAIN_LAYERS`` of its 24 layers, through ``FederatedTrainer``
    (sequential runner): the train steps through ``wkv_scan`` and
    ``lora_matmul``, the eval through ``wkv6``; launches exact (``wkv6`` 0
    in the train steps and L an eval forward, ``lora_matmul`` 5 · L a
    train forward, ``adapter_gram`` 2 · buckets a round); kept ranks, round wall, step median, peak allocated memory and
    a profiled train step.  (b) at 2 layers and full width in fp32 (TF32
    off): the train step's kernel route against its plain route, and the
    cohort runner against the sequential one."""
    import numpy as np
    from repro_torch.configs import rwkv6_1p6b
    from repro_torch.core.runtime import SequentialRunner
    from repro_torch.core.runtime.runners import to_device
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    t_phase = time.perf_counter()
    cfg = rwkv6_1p6b.CONFIG.replace(num_layers=RWKV_TRAIN_LAYERS)
    L = cfg.num_layers
    print(f"phase 19 (a): {RWKV_TRAIN_ROUNDS} FLoRIST rounds of {cfg.name} at "
          f"published widths cut to {L} of 24 layers (d {cfg.d_model}, {cfg.num_rwkv_heads} heads "
          f"of {cfg.rwkv_head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}; random "
          f"seeded weights), LoRA r 16 on its 5 targets, 4 of 8 clients a "
          f"round, 2 local steps of {RWKV_TRAIN_BATCH} x {RWKV_TRAIN_SEQ} "
          "tokens, Gram route; train steps through wkv_scan")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runner = SequentialRunner(record_steps=True)
    tr = _rwkv_trainer(cfg, T.init(cfg, 0, DEVICE), runner)
    rounds = []
    ops.reset_launch_counts()
    for rnd in range(RWKV_TRAIN_ROUNDS):
        before, n_log = ops.launch_counts(), len(runner.step_log())
        rec = tr.run_round(rnd)
        step_ms = [e["ms"] for e in runner.step_log()[n_log:]]
        steps = len(step_ms)
        buckets = len({(n, m) for _, n, m in tr.aggregator.dims.values()})
        got = ops.launch_delta(before, ops.launch_counts())
        want = {"lora_matmul": L * 5 * steps, "adapter_gram": 2 * buckets,
                "wkv6": L}
        ranks = tr.global_state.ranks
        r_sum = sum(tr.aggregator.client_ranks)
        tok_s = steps * RWKV_TRAIN_BATCH * RWKV_TRAIN_SEQ / (sum(step_ms) / 1e3)
        print(f"  round {rnd}: eval loss {rec.eval_loss:.4f} acc "
              f"{rec.eval_acc:.4f}; wall {rec.wall_secs:.2f} s, finalize "
              f"{rec.finalize_secs * 1e3:.1f} ms; {steps} train steps, median "
              f"{statistics.median(step_ms):.1f} ms (CUDA events), {tok_s:.0f} "
              f"train tok/s")
        for path, ps in ranks.items():
            print(f"    kept ranks {'/'.join(map(str, path))}: {ps}")
        print(f"    launches {json.dumps(got)}; expected {json.dumps(want)} "
              "(wkv6: the eval forward's; none in the train steps)")
        if got != want:
            fail(f"phase 19 (a) round {rnd}: launch counts {got} != {want}")
        if not np.isfinite(rec.eval_loss):
            fail(f"phase 19 (a) round {rnd}: eval loss {rec.eval_loss}")
        if any(not 1 <= p <= r_sum for ps in ranks.values() for p in ps):
            fail(f"phase 19 (a) round {rnd}: a kept rank is outside [1, {r_sum}]")
        rounds.append({"record": dataclasses.asdict(rec),
                       "ranks": {"/".join(map(str, k)): v for k, v in ranks.items()},
                       "train_step_ms": step_ms,
                       "train_step_ms_median": statistics.median(step_ms),
                       "train_tok_s": tok_s, "launches": got})
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak allocated {peak:.2f} GiB (weights, {RWKV_TRAIN_BATCH} x "
          f"{RWKV_TRAIN_SEQ} tokens through wkv_scan under autograd)")
    counts = {k: v for k, v in ops.launch_counts().items() if v}

    step = tr._train_step()
    data = tr.clients[0]
    batch = {"tokens": torch.as_tensor(data.tokens[:RWKV_TRAIN_BATCH],
                                       device=DEVICE).long(),
             "loss_mask": torch.as_tensor(data.loss_mask[:RWKV_TRAIN_BATCH],
                                          device=DEVICE)}
    state = {"a": to_device(tr._client_init(0, 16), tr.device)}
    state["opt"] = adamw_init(state["a"])

    def run(n):
        for _ in range(n):
            state["a"], state["opt"], _ = step(tr.params, state["a"],
                                               state["opt"], batch)
    t_w = time.perf_counter()
    step_ms = statistics.median(ms for r in rounds for ms in r["train_step_ms"])
    window = profile_window(torch, run, 1, f"RWKV6 train step, {RWKV_TRAIN_BATCH}"
                            f" x {RWKV_TRAIN_SEQ} tokens, r 16 (wall: the rounds' "
                            "median step)", raw_events=True, wall_ms=step_ms)
    print(f"  the profiled window took {time.perf_counter() - t_w:.1f} s")
    out = {"rounds": rounds, "launches": counts, "peak_allocated_gib": peak,
           "profiled_train_step": window}
    del tr, state, batch, step
    torch.cuda.empty_cache()
    out["parity"] = rwkv_train_parity(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 19: {out['phase_s']:.1f} s")
    return out, counts


def rwkv_train_parity(torch):
    from repro_torch.configs import lora_targets, rwkv6_1p6b
    from repro_torch.device import parity_mode
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    cfg = rwkv6_1p6b.CONFIG.replace(dtype="float32", num_layers=2)
    print(f"phase 19 (b): {cfg.name} at full width in fp32, depth cut to 2 "
          f"layers; " + parity_mode())
    dev = torch.device(DEVICE)
    params = T.init(cfg, 3, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    ad = _nonzero_b(init_lora(params, lora_targets(cfg), 16, 16.0, gen), gen)
    rng = torch.Generator(device=dev).manual_seed(5)
    batches = [{"tokens": torch.randint(1, cfg.vocab_size, (2, RWKV_TRAIN_SEQ),
                                        generator=rng, device=dev),
                "loss_mask": torch.ones(2, RWKV_TRAIN_SEQ, device=dev)}
               for _ in range(2)]
    print("  the train step, kernel route (lora_matmul; wkv_scan) vs plain route")
    res = {"step_routes": step_route_parity(torch, "phase 19 (b)", cfg, params,
                                            ad, batches)}
    print("  cohort runner vs sequential runner, two FLoRIST rounds")
    res["runners"] = runner_parity(torch, "phase 19 (b)",
                                   _rwkv_trainer(cfg, params),
                                   _rwkv_trainer(cfg, params, "cohort"))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del params, ad
    torch.cuda.empty_cache()
    return res


# -- phase 20: MoE and MLA's full-sequence path --------------------------------

MOE_ROUNDS, MOE_BATCH, MOE_SEQ, MOE_STEPS = 2, 4, 512, 2
DSV3_BATCH = 4                # DeepSeek-V3-L4's train batch (x 512 tokens)


def phase20(torch):
    """(a) granite-moe-1b-a400m at published widths, cut to
    ``GRANITE_LAYERS`` of its 24 layers, serves phase 4's traffic
    (``ring_decode`` and ``bgmv`` L and 4 · L an engine step,
    a profiled burst window on live adapters) and its graphed tokens equal
    its uncaptured tokens bit for bit; (b) DeepSeek-V3-L4 (the three dense
    MLA layers and the first MoE layer at published widths) serves it
    (``mla_ring_decode`` 4 and ``bgmv`` 16 a step), peak memory; (c) one
    granite MoE layer on the card against the CPU in fp32; (d) FLoRIST
    through ``FederatedTrainer`` on granite (cohort runner) and DeepSeek-V3-L4
    (sequential runner), and ``make_prefill_step(use_kernels=True)`` on
    DeepSeek-V3-L4; (e) the fp32 route parities at 2 layers."""
    t_phase = time.perf_counter()
    out, counts = {}, collections.Counter()
    granite = cut_config("granite_moe_1b_a400m", GRANITE_LAYERS)
    out["granite_serve"], c = end_to_end(torch, "20 (a)", granite, full_layers=24,
                                         windows=("profiled_burst_adapters",))
    counts.update(c)
    out["granite_graphs"] = graph_parity(torch, granite, "20 (a)")
    torch.cuda.reset_peak_memory_stats()
    out["dsv3_serve"], c = end_to_end(torch, "20 (b)", "deepseek_v3_l4",
                                      windows=(), full_layers=61)
    counts.update(c)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out["dsv3_serve"]["peak_allocated_gib"] = peak
    print(f"  peak allocated {peak:.2f} GiB (28.1 GB of bf16 weights)")
    out["moe_layer"] = moe_layer_parity(torch)
    out["granite_fed"], c = moe_federated(torch, "granite")
    counts.update(c)
    out["dsv3_fed"], c = moe_federated(torch, "deepseek")
    counts.update(c)
    out["dsv3_prefill"] = dsv3_prefill(torch)
    out["parity"] = moe_route_parity(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 20: {out['phase_s']:.1f} s")
    return out, {k: v for k, v in counts.items() if v}


def _kept_slots(torch, meta, T: int, E: int, k: int):
    """(T, E) int: the capacity slot of each kept (token, expert) pair of a
    ``moe._route_and_dispatch`` call, -1 where the token does not keep the
    expert, on the CPU."""
    dst_e, dst_c, _ = (m[0].cpu() for m in meta)
    slots = torch.full((T, E + 1), -1, dtype=torch.long)
    slots[torch.arange(T * k) // k, dst_e] = dst_c   # drops land in column E
    return slots[:, :E]


def moe_layer_parity(torch):
    """(c) one granite MoE layer (published widths, fp32, TF32 off) on the
    card against the same layer on the CPU, at capacity factor 1.25 on
    inputs skewed toward expert 0 (tokens dropped) and 8.0 (none): the
    same experts and slots kept for every token, outputs within 1e-5 ·
    max(1, |y|), aux within 1e-6."""
    from repro_torch.configs import granite_moe_1b_a400m
    from repro_torch.device import parity_mode
    from repro_torch.models import moe as Moe
    from repro_torch.models import transformer as T
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    mode = parity_mode()
    res = {}
    for factor in (1.25, 8.0):
        cfg = granite_moe_1b_a400m.CONFIG.replace(dtype="float32",
                                                  moe_capacity_factor=factor)
        E, k = cfg.num_experts, cfg.experts_per_token
        gen = torch.Generator().manual_seed(7)
        p = T._layer(Moe.init_moe(cfg, gen, 1, torch.float32), 0)
        r0 = p["router"][:, 0]
        x = (torch.randn((2, 512, cfg.d_model), generator=gen)
             + 1.5 * r0 / (r0 @ r0))
        pc = {n: t.to(DEVICE) for n, t in p.items()}
        xt = x.reshape(1, -1, cfg.d_model)
        T_ = xt.shape[1]
        C = Moe._capacity(cfg, T_)
        probs = Moe.router_scores(cfg, p["router"], xt[0]).sort(-1).values
        margin = float((probs[:, -k] - probs[:, -k - 1]).min())
        slots = [_kept_slots(torch, Moe._route_and_dispatch(
                     cfg, pp["router"], xx, C)[1], T_, E, k)
                 for pp, xx in ((p, xt), (pc, xt.to(DEVICE)))]
        want, aw = Moe.moe_fwd(cfg, p, x)
        got, ag = Moe.moe_fwd(cfg, pc, x.to(DEVICE))
        same = bool(torch.equal(slots[0], slots[1]))
        kept = int((slots[0] >= 0).sum())
        err = float((got.cpu() - want).abs().max())
        lim = 1e-5 * max(1.0, float(want.abs().max()))
        aerr = abs(float(ag) - float(aw))
        print(f"phase 20 (c): {cfg.name} MoE layer (d {cfg.d_model}, {E} "
              f"experts top-{k}, e_ff {cfg.moe_d_ff}), {T_} tokens, capacity "
              f"factor {factor} ({C} slots an expert): {T_ * k - kept} of "
              f"{T_ * k} choices dropped; card vs CPU: kept experts and slots "
              f"equal {same} (least top-{k} margin {margin:.2e}); max |Δy| "
              f"{err:.2e} (limit {lim:.2e}); |Δaux| {aerr:.2e} (limit 1e-6); "
              + mode)
        if not same:
            fail(f"phase 20 (c): routing differs between card and CPU at "
                 f"factor {factor}")
        if (T_ * k - kept > 0) != (factor < 2):
            fail(f"phase 20 (c): factor {factor} dropped {T_ * k - kept}")
        if err > lim or aerr > 1e-6:
            fail(f"phase 20 (c): outputs or aux differ at factor {factor}")
        res[str(factor)] = {"dropped": T_ * k - kept, "routing_equal": same,
                            "min_topk_margin": margin, "max_abs_err": err,
                            "aux_abs_err": aerr}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return res


@contextlib.contextmanager
def launched_shapes():
    """The shapes of the ``lora_matmul`` and ``adapter_gram`` launches made
    inside, recorded at the kernels' entry points: ``{"lora_matmul": {(C,
    din, dout)}, "adapter_gram": {(G, m, r, layout)}}``."""
    from repro_torch.kernels import ops
    seen = {"lora_matmul": set(), "adapter_gram": set()}
    lora, gram = ops.lora_matmul_cuda, ops.adapter_gram_cuda

    def lora_seen(x, w, a, b):
        seen["lora_matmul"].add((x.shape[0],) + tuple(w.shape))
        return lora(x, w, a, b)

    def gram_seen(stored, layout):
        G, m, r = stored.shape if layout == "col" else stored.mT.shape
        seen["adapter_gram"].add((G, m, r, layout))
        return gram(stored, layout)

    ops.lora_matmul_cuda, ops.adapter_gram_cuda = lora_seen, gram_seen
    try:
        yield seen
    finally:
        ops.lora_matmul_cuda, ops.adapter_gram_cuda = lora, gram


# the (C, din, dout) and (G, m, r, layout) that phases 2/3 and 16 (a) check
# at phase 20 (d)'s widths (lora_matmul at M 2048 and r 16; the eval
# forward's M and kept rank differ)
MOE_CHECKED = {"lora_matmul": {(1,) + s for s in LORA_MOE_SHAPES}
               | {(4,) + s for s in LORA_MOE_COHORT},
               "adapter_gram": set(GRAM_MOE)}


def _florist_trainer(cfg, params, runner, clients: int, per_round: int,
                     batch: int):
    from repro_torch.common.config import FedConfig, LoRAConfig, OptimConfig
    from repro_torch.configs import lora_targets
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.synthetic import make_eval_data
    fed = FedConfig(num_clients=clients, clients_per_round=per_round,
                    homogeneous_rank=16, tau=0.9, method="florist", seed=0)
    lora = LoRAConfig(rank=16, alpha=16.0, targets=lora_targets(cfg))
    return FederatedTrainer(
        cfg, fed, lora, OptimConfig(lr=3e-4), params=params,
        eval_data=make_eval_data(num_samples=8, seq_len=MOE_SEQ,
                                 vocab=cfg.vocab_size),
        batch_size=batch, local_steps=MOE_STEPS, seq_len=MOE_SEQ,
        svd_method="gram", runner=runner, device=DEVICE)


def moe_federated(torch, which: str):
    """(d) FLoRIST rounds, rank 16 on the family's targets, 2 local steps
    of 512-token rows, the Gram route: granite at ``GRANITE_LAYERS`` (2 rounds, 4
    of 8 clients, cohort runner, batch 4: one cohort step a local step) or
    DeepSeek-V3-L4 (1 round, 2 of 4 clients, sequential runner, batch
    ``DSV3_BATCH``).  Launches exact: ``lora_matmul`` 4 · L a train forward
    (granite ``wq wk wv wo``; DeepSeek ``wq_a wq_b wkv_a wo``, ``wkv_b``
    folded into the absorbed weight), ``flash_attention`` L a forward for
    granite (the eval's included) and none for MLA, ``adapter_gram`` 2 ·
    buckets; each kernel's launch shapes among those phases 2/3 and 16 (a)
    check (``MOE_CHECKED``); finite losses and aux, kept ranks in [1, Σ
    r_k], the step median, peak memory, and a profiled train step."""
    import numpy as np
    from repro_torch.configs import (deepseek_v3_671b, granite_moe_1b_a400m,
                                     lora_targets)
    from repro_torch.core.runtime import CohortRunner, SequentialRunner
    from repro_torch.core.runtime.runners import _stack_cohort, to_device
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    granite = which == "granite"
    cfg = (granite_moe_1b_a400m.CONFIG.replace(num_layers=GRANITE_LAYERS)
           if granite else deepseek_v3_671b.L4)
    L = cfg.num_layers
    rounds_n = MOE_ROUNDS if granite else 1
    clients, per_round, batch = (8, 4, MOE_BATCH) if granite else (4, 2, DSV3_BATCH)
    runner = (CohortRunner if granite else SequentialRunner)(record_steps=True)
    print(f"phase 20 (d): {rounds_n} FLoRIST round(s) of {cfg.name} at published "
          f"widths ({L} L, d {cfg.d_model}, {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token}, {cfg.dtype}; random seeded weights), LoRA r "
          f"16 on {'/'.join(lora_targets(cfg))}, {per_round} of {clients} "
          f"clients a round, {MOE_STEPS} local steps of {batch} x {MOE_SEQ} "
          f"tokens, {runner.name} runner, Gram route")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _florist_trainer(cfg, T.init(cfg, 0, DEVICE), runner, clients,
                          per_round, batch)
    rounds = []
    ops.reset_launch_counts()
    with launched_shapes() as seen:
        for rnd in range(rounds_n):
            before, n_log = ops.launch_counts(), len(runner.step_log())
            rec = tr.run_round(rnd)
            log = runner.step_log()[n_log:]
            step_ms = [e["ms"] for e in log]
            calls = len(log)
            # a bucket a stacked shape: DeepSeek's dense and MoE segments
            # (3 and 1 layers) are separate buckets of one width
            buckets = len(set(tr.aggregator.dims.values()))
            got = ops.launch_delta(before, ops.launch_counts())
            want = {"lora_matmul": L * 4 * calls, "adapter_gram": 2 * buckets}
            if granite:
                want["flash_attention"] = L * (calls + 1)     # and the eval's
            ranks = tr.global_state.ranks
            r_sum = sum(tr.aggregator.client_ranks)
            tok = sum(len(e["clients"]) for e in log) * batch * MOE_SEQ
            print(f"  round {rnd}: eval loss {rec.eval_loss:.4f} acc "
                  f"{rec.eval_acc:.4f}; wall {rec.wall_secs:.2f} s, finalize "
                  f"{rec.finalize_secs * 1e3:.1f} ms; {calls} train-step calls, "
                  f"median {statistics.median(step_ms):.1f} ms (CUDA events), "
                  f"{tok / (sum(step_ms) / 1e3):.0f} train tok/s; kept ranks "
                  + ", ".join(f"{'/'.join(map(str, k))}: {v}" for k, v in ranks.items()))
            print(f"    launches {json.dumps(got)}; expected {json.dumps(want)}")
            if got != want:
                fail(f"phase 20 (d) {cfg.name} round {rnd}: launches {got} != {want}")
            if not np.isfinite(rec.eval_loss):
                fail(f"phase 20 (d) {cfg.name} round {rnd}: eval loss {rec.eval_loss}")
            if any(not 1 <= p <= r_sum for ps in ranks.values() for p in ps):
                fail(f"phase 20 (d) {cfg.name} round {rnd}: a kept rank is "
                     f"outside [1, {r_sum}]")
            rounds.append({"record": dataclasses.asdict(rec),
                           "ranks": {"/".join(map(str, k)): v for k, v in ranks.items()},
                           "train_step_ms": step_ms,
                           "train_step_ms_median": statistics.median(step_ms),
                           "train_tok_s": tok / (sum(step_ms) / 1e3), "launches": got})
    print("  launched shapes: " + "; ".join(
        f"{k} {sorted(v, key=str)}" for k, v in seen.items()))
    for k, shapes in seen.items():
        if not shapes <= MOE_CHECKED[k]:
            fail(f"phase 20 (d) {cfg.name}: {k} ran at "
                 f"{sorted(shapes - MOE_CHECKED[k], key=str)}, which no "
                 f"kernel case checks")
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {k: v for k, v in ops.launch_counts().items() if v}

    # one more step on the card: its loss and aux finite, then a profiled window
    plan = tr.scheduler.plan(rounds_n, tr)
    task_init = lambda t: tr._client_init(t.client_id, t.rank)
    if granite:
        stacked, b, _ = _stack_cohort(tr, rounds_n, plan.tasks, task_init, 4)
        b = {"tokens": torch.as_tensor(b["tokens"][:, 0], device=DEVICE),
             "loss_mask": torch.as_tensor(b["loss_mask"][:, 0], device=DEVICE)}
        step = tr._cohort_step()
    else:
        data = tr.clients[plan.tasks[0].client_id]
        b = {"tokens": torch.as_tensor(data.tokens[:batch], device=DEVICE).long(),
             "loss_mask": torch.as_tensor(data.loss_mask[:batch], device=DEVICE)}
        stacked = to_device(task_init(plan.tasks[0]), tr.device)
        step = tr._train_step()
    state = {"a": stacked, "o": adamw_init(stacked)}
    state["a"], state["o"], m = step(tr.params, state["a"], state["o"], b)
    loss, aux = m["loss"].float().cpu(), m["aux"].float().cpu()
    print(f"  a further step: loss {loss.tolist()}, aux {aux.tolist()} "
          f"(router_aux_coef {cfg.router_aux_coef}); peak allocated {peak:.2f} GiB")
    if not (torch.isfinite(loss).all() and torch.isfinite(aux).all()
            and bool((aux > 0).all())):
        fail(f"phase 20 (d) {cfg.name}: loss {loss} or aux {aux}")

    def run(n):
        for _ in range(n):
            state["a"], state["o"], _ = step(tr.params, state["a"], state["o"], b)
    what = "cohort train step, 4 clients" if granite else "train step, one client"
    window = profile_window(torch, run, 3, f"{cfg.name} {what} x {batch} x "
                            f"{MOE_SEQ} tokens, r 16")
    out = {"rounds": rounds, "launches": counts, "peak_allocated_gib": peak,
           "launched_shapes": {k: sorted(v, key=str) for k, v in seen.items()},
           "step_loss": loss.tolist(), "step_aux": aux.tolist(),
           "profiled_train_step": window}
    del tr, state, b, step, stacked
    torch.cuda.empty_cache()
    return out, counts


def dsv3_prefill(torch):
    """(d) ``make_prefill_step(use_kernels=True)`` on DeepSeek-V3-L4 (2 x
    512 tokens, a rank-16 adapter on the five MLA targets): ``lora_matmul``
    16 a call (``wkv_b`` folded), no ``flash_attention`` (MLA's attention
    is plain, as in the reference), finite logits; ms a call."""
    from repro_torch.configs import deepseek_v3_671b, lora_targets
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    from repro_torch.train.step import make_prefill_step
    cfg = deepseek_v3_671b.L4
    dev = torch.device(DEVICE)
    params = T.init(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    ad = _nonzero_b(init_lora(params, lora_targets(cfg), 16, 16.0, gen), gen)
    toks = torch.randint(1, cfg.vocab_size, (2, 512), generator=gen, device=dev)
    step = make_prefill_step(cfg, use_kernels=True)
    step(params, ad, {"tokens": toks})
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lg = step(params, ad, {"tokens": toks})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = {k: v for k, v in ops.launch_counts().items() if v}
    want = {"lora_matmul": 4 * cfg.num_layers}
    print(f"phase 20 (d): make_prefill_step(use_kernels=True) on {cfg.name}, 2 x "
          f"512 tokens: logits {tuple(lg.shape)}, {ms:.1f} ms a call (host "
          f"clock); launches {json.dumps(got)} (expected {json.dumps(want)})")
    if got != want:
        fail(f"phase 20 (d): prefill launches {got} != {want}")
    if tuple(lg.shape) != (2, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
        fail("phase 20 (d): prefill logits")
    del params, ad, lg
    torch.cuda.empty_cache()
    return {"ms": ms, "launches": got}


def moe_route_parity(torch):
    """(e) fp32 (TF32 off) at full width and 2 layers: granite's train step
    on the kernel route against the plain route, and the DENSE3 cut's (the
    train step through ``mla_fwd``: ``lora_matmul`` on its projections
    against the plain products), both at phase 7's limits
    (:func:`step_route_parity`)."""
    from repro_torch.configs import deepseek_v3_671b, granite_moe_1b_a400m, lora_targets
    from repro_torch.data.synthetic import make_federated_data
    from repro_torch.device import parity_mode
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    res = {}
    for key, base in (("granite", granite_moe_1b_a400m.CONFIG),
                      ("dense3", deepseek_v3_671b.DENSE3)):
        cfg = base.replace(dtype="float32", num_layers=2,
                           first_dense_layers=min(2, base.first_dense_layers))
        print(f"phase 20 (e): {cfg.name} train step, kernel route vs plain "
              f"route, full width in fp32, depth cut to 2 layers; " + parity_mode())
        dev = torch.device(DEVICE)
        params = T.init(cfg, 3, dev)
        gen = torch.Generator(device=dev).manual_seed(4)
        ad = _nonzero_b(init_lora(params, lora_targets(cfg), 16, 16.0, gen), gen)
        # the empty MoE segment's zero-size adapters take no gradient
        ad["blocks"] = {i: a for i, a in ad["blocks"].items()
                        if T.layer_plan(cfg)[i][1]}
        data = make_federated_data(num_clients=1, seq_len=MOE_SEQ,
                                   vocab=cfg.vocab_size, seed=5)[0]
        batches = [{"tokens": torch.as_tensor(data.tokens[i:i + 2], device=dev).long(),
                    "loss_mask": torch.as_tensor(data.loss_mask[i:i + 2], device=dev)}
                   for i in (0, 2)]
        res[key] = step_route_parity(torch, f"phase 20 (e) {cfg.name}", cfg,
                                     params, ad, batches)
        del params, ad, batches
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return res


# -- phase 21: the vision and audio front ends, and the Mamba2 hybrid ---------

FRONT_BATCH = 4                # the vision and audio train batches' rows
# the (C, din, dout) and (G, m, r, layout) that phase 2/3 and 16 (a) check at
# phase 21's widths, by model (every lora_matmul launch is C 1 but the
# zamba2 cohort step's)
PHASE21_CHECKED = {
    "phi3_vision_4p2b": {"lora_matmul": {(1, 3072, 3072)}, "adapter_gram": set()},
    "musicgen_medium": {"lora_matmul": {(1, 1536, 1536)}, "adapter_gram": set()},
    "zamba2_1p2b": {"lora_matmul": {(c,) + s for c in (1, 4) for s in LORA_HYBRID_SHAPES},
                    "adapter_gram": set(GRAM_HYBRID)},
}


def phase21(torch):
    """(a) phi-3-vision-4.2b and (b) musicgen-medium at published widths,
    cut to ``PHI3_LAYERS`` and ``MUSICGEN_LAYERS``, serve phase 4's traffic on the graphed engine (Phi-3's graphed
    tokens held to its uncaptured tokens bit for bit) and take two train
    steps on a vision or audio batch; (c) zamba2-1.2b serves the traffic one
    token a step (graphed against uncaptured too), trains through two
    FLoRIST rounds on the cohort runner and prefills; (d) one Mamba2 layer
    on the card against the CPU in fp32; (e) the fp32 route parities at 2
    layers (4 for zamba2) and zamba2's decode against its forward."""
    t_phase = time.perf_counter()
    out, counts = {}, collections.Counter()
    for key, label, graphs, full in (
            (cut_config("phi3_vision_4p2b", PHI3_LAYERS), "21 (a)", True, 32),
            (cut_config("musicgen_medium", MUSICGEN_LAYERS), "21 (b)", False, 48),
            ("zamba2_1p2b", "21 (c)", True, 0)):
        out[f"{key}_serve"], c = end_to_end(torch, label, key,
                                            windows=("profiled_burst_adapters",),
                                            full_layers=full)
        counts.update(c)
        if graphs:
            out[f"{key}_graphs"] = graph_parity(
                torch, key if key != "zamba2_1p2b"
                else cut_config(key, ZAMBA2_GRAPH_LAYERS), label)
        if key != "zamba2_1p2b":
            out[f"{key}_train"], c = frontend_train(torch, key, label)
            counts.update(c)
    out["zamba2_fed"], c = hybrid_federated(torch)
    counts.update(c)
    out["zamba2_prefill"], c = hybrid_prefill(torch)
    counts.update(c)
    out["mamba_layer"] = mamba_layer_parity(torch)
    out["parity"] = phase21_parity(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 21: {out['phase_s']:.1f} s")
    return out, {k: v for k, v in counts.items() if v}


def frontend_batch(torch, cfg, rows: int, gen, dtype=None):
    """A batch shaped as the reference's ``launch/specs.input_specs`` shapes
    a train batch, random from ``gen``: vision ``patch_embeds`` (rows,
    num_patches, frontend_dim) and ``num_patches`` fewer text ``tokens`` of
    1024 with their ``loss_mask``; audio ``frame_embeds`` (rows, 512,
    frontend_dim), ``labels`` and ``loss_mask``, no tokens."""
    dev = gen.device
    dtype = dtype or getattr(torch, cfg.dtype)
    S = 1024 if cfg.frontend == "vision" else 512
    T_ = S - cfg.num_patches if cfg.frontend == "vision" else S
    toks = torch.randint(0, cfg.vocab_size, (rows, T_), generator=gen, device=dev)
    mask = torch.ones((rows, T_), dtype=torch.float32, device=dev)
    if cfg.frontend == "vision":
        emb = torch.randn((rows, cfg.num_patches, cfg.frontend_dim),
                          generator=gen, device=dev).to(dtype)
        return {"patch_embeds": emb, "tokens": toks, "loss_mask": mask}
    emb = torch.randn((rows, S, cfg.frontend_dim), generator=gen, device=dev).to(dtype)
    return {"frame_embeds": emb, "labels": toks, "loss_mask": mask}


def frontend_train(torch, key: str, label: str):
    """(a), (b) ``make_train_step(use_kernels=True)`` takes 2 steps on a
    vision or audio batch of ``FRONT_BATCH`` rows (rank 16 on ``wq wk wv wo``,
    non-zero B): launches exact (``lora_matmul`` 4 · L and ``flash_attention``
    L a forward), every ``lora_matmul`` shape one that phase 2/3 checks, the
    loss finite and counted over the text tail only (the CE's token count
    equals the text mask's target positions), the step times (CUDA
    events), a profiled window of 3 more steps and the peak allocated."""
    from repro_torch.common.config import OptimConfig
    from repro_torch.configs import lora_targets
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import CONFIGS
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.peft.lora import init_lora
    from repro_torch.train.step import make_train_step
    cfg = CONFIGS[key][0]
    dev = torch.device(DEVICE)
    L = cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    ad = _nonzero_b(init_lora(params, lora_targets(cfg), 16, 16.0, gen), gen)
    batch = frontend_batch(torch, cfg, FRONT_BATCH, gen)
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    print(f"phase {label}: make_train_step(use_kernels=True) on {cfg.name} at "
          f"published widths ({L} L, d {cfg.d_model}, {cfg.num_heads} H / "
          f"{cfg.num_kv_heads} KV, hd {cfg.head_dim}, {cfg.dtype}; random seeded "
          f"weights), LoRA r 16 on {'/'.join(lora_targets(cfg))}, a {cfg.frontend} "
          f"batch {json.dumps(shapes)}")
    step = make_train_step(cfg, OptimConfig(lr=3e-4), use_kernels=True)
    state = {"a": ad, "o": adamw_init(ad)}
    ops.reset_launch_counts()
    times, losses, counted = [], [], []
    with launched_shapes() as seen:
        for _ in range(2):
            a0 = torch.cuda.Event(enable_timing=True)
            b0 = torch.cuda.Event(enable_timing=True)
            a0.record()
            state["a"], state["o"], m = step(params, state["a"], state["o"], batch)
            b0.record()
            times.append((a0, b0))
            losses.append(m["loss"])
            counted.append(m["tokens"])
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in times]
    got = {k: v for k, v in ops.launch_counts().items() if v}
    want = {"lora_matmul": 4 * L * 2, "flash_attention": L * 2}
    losses = [float(x) for x in losses]
    counted = [float(x) for x in counted]
    text = float(batch["loss_mask"][:, 1:].sum())
    print(f"  2 steps: {step_ms[0]:.1f} / {step_ms[1]:.1f} ms (CUDA events; "
          f"median {statistics.median(step_ms):.1f}); losses {losses}; tokens "
          f"in the CE {counted} (the text targets: {text:.0f}); launches "
          f"{json.dumps(got)} (expected {json.dumps(want)}); lora_matmul shapes "
          f"{sorted(seen['lora_matmul'])}")
    if got != want:
        fail(f"phase {label}: train launches {got} != {want}")
    if not all(math.isfinite(x) for x in losses) or any(c != text for c in counted):
        fail(f"phase {label}: losses {losses} or CE token counts {counted} "
             f"(want {text})")
    checked = PHASE21_CHECKED[CUT_OF.get(key, key)]
    for k, shapes_seen in seen.items():
        if not shapes_seen <= checked[k]:
            fail(f"phase {label}: {k} ran at {sorted(shapes_seen - checked[k])}, "
                 f"which no kernel case checks")

    def run(n):
        for _ in range(n):
            state["a"], state["o"], _ = step(params, state["a"], state["o"], batch)
    window = profile_window(torch, run, 3, f"{cfg.name} train step, "
                            f"{FRONT_BATCH} x {batch['loss_mask'].shape[1]} text "
                            f"tokens, {cfg.frontend} front end, r 16")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak allocated {peak:.2f} GiB")
    del params, state, batch, step
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
            "losses": losses, "ce_tokens": counted, "launches": got,
            "lora_matmul_shapes": sorted(seen["lora_matmul"]),
            "peak_allocated_gib": peak, "profiled_train_step": window}, got


def hybrid_federated(torch):
    """(c) FLoRIST through ``FederatedTrainer`` on zamba2-1.2b at published
    widths and full depth: 2 rounds, the cohort runner, 4 of 8 clients of
    rank 16 a round, 2 local steps of 4 x 512, LoRA on the six hybrid
    targets, the Gram route.  Launches exact: ``lora_matmul`` 4 · 6 + 2 · 38
    = 100 a train forward (none in the eval, which merges the aggregate
    into the base), ``flash_attention`` 6 a forward (the eval's included),
    ``adapter_gram`` 2 a stacked shape (5 buckets); every ``lora_matmul``
    and ``adapter_gram`` shape one that phases 2/3 and 16 (a) check; kept
    ranks in [1, Σ r_k]; finite losses; step median, peak allocated and a
    profiled cohort step."""
    import numpy as np
    from repro_torch.configs import lora_targets, zamba2_1p2b
    from repro_torch.core.runtime import CohortRunner
    from repro_torch.core.runtime.runners import _stack_cohort
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    cfg = zamba2_1p2b.CONFIG
    L, n_sh = cfg.num_layers, T.num_shared_applications(cfg)
    runner = CohortRunner(record_steps=True)
    print(f"phase 21 (c): {MOE_ROUNDS} FLoRIST rounds of {cfg.name} at published "
          f"widths ({L} Mamba2 layers, d {cfg.d_model}, the shared block applied "
          f"{n_sh} times, {cfg.dtype}; random seeded weights), LoRA r 16 on "
          f"{'/'.join(lora_targets(cfg))}, 4 of 8 clients a round, {MOE_STEPS} "
          f"local steps of {MOE_BATCH} x {MOE_SEQ} tokens, cohort runner, Gram route")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _florist_trainer(cfg, T.init(cfg, 0, DEVICE), runner, 8, 4, MOE_BATCH)
    rounds = []
    ops.reset_launch_counts()
    with launched_shapes() as seen:
        for rnd in range(MOE_ROUNDS):
            before, n_log = ops.launch_counts(), len(runner.step_log())
            rec = tr.run_round(rnd)
            log = runner.step_log()[n_log:]
            step_ms = [e["ms"] for e in log]
            calls = len(log)
            buckets = len(set(tr.aggregator.dims.values()))
            got = ops.launch_delta(before, ops.launch_counts())
            want = {"lora_matmul": (4 * n_sh + 2 * L) * calls,
                    "flash_attention": n_sh * (calls + 1),
                    "adapter_gram": 2 * buckets}
            ranks = tr.global_state.ranks
            r_sum = sum(tr.aggregator.client_ranks)
            tok = sum(len(e["clients"]) for e in log) * MOE_BATCH * MOE_SEQ
            print(f"  round {rnd}: eval loss {rec.eval_loss:.4f} acc "
                  f"{rec.eval_acc:.4f}; wall {rec.wall_secs:.2f} s, finalize "
                  f"{rec.finalize_secs * 1e3:.1f} ms; {calls} cohort-step calls, "
                  f"median {statistics.median(step_ms):.1f} ms (CUDA events), "
                  f"{tok / (sum(step_ms) / 1e3):.0f} train tok/s; {buckets} buckets; "
                  f"kept ranks " + ", ".join(
                      f"{'/'.join(map(str, k))}: {v}" for k, v in ranks.items()))
            print(f"    launches {json.dumps(got)}; expected {json.dumps(want)}")
            if got != want:
                fail(f"phase 21 (c) round {rnd}: launches {got} != {want}")
            if not np.isfinite(rec.eval_loss):
                fail(f"phase 21 (c) round {rnd}: eval loss {rec.eval_loss}")
            if any(not 1 <= p <= r_sum for ps in ranks.values() for p in ps):
                fail(f"phase 21 (c) round {rnd}: a kept rank is outside [1, {r_sum}]")
            rounds.append({"record": dataclasses.asdict(rec),
                           "ranks": {"/".join(map(str, k)): v for k, v in ranks.items()},
                           "train_step_ms": step_ms,
                           "train_step_ms_median": statistics.median(step_ms),
                           "train_tok_s": tok / (sum(step_ms) / 1e3), "launches": got})
    print("  launched shapes: " + "; ".join(
        f"{k} {sorted(v, key=str)}" for k, v in seen.items()))
    checked = PHASE21_CHECKED["zamba2_1p2b"]
    for k, shapes in seen.items():
        if not shapes <= checked[k]:
            fail(f"phase 21 (c): {k} ran at {sorted(shapes - checked[k], key=str)}, "
                 f"which no kernel case checks")
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {k: v for k, v in ops.launch_counts().items() if v}

    # one more cohort step: its losses finite, then a profiled window
    plan = tr.scheduler.plan(MOE_ROUNDS, tr)
    stacked, b, _ = _stack_cohort(tr, MOE_ROUNDS, plan.tasks,
                                  lambda t: tr._client_init(t.client_id, t.rank), 4)
    b = {"tokens": torch.as_tensor(b["tokens"][:, 0], device=DEVICE),
         "loss_mask": torch.as_tensor(b["loss_mask"][:, 0], device=DEVICE)}
    step = tr._cohort_step()
    state = {"a": stacked, "o": adamw_init(stacked)}
    state["a"], state["o"], m = step(tr.params, state["a"], state["o"], b)
    loss = m["loss"].float().cpu()
    print(f"  a further cohort step: losses {loss.tolist()}; peak allocated "
          f"{peak:.2f} GiB")
    if not bool(torch.isfinite(loss).all()):
        fail(f"phase 21 (c): cohort step losses {loss}")

    def run(n):
        for _ in range(n):
            state["a"], state["o"], _ = step(tr.params, state["a"], state["o"], b)
    window = profile_window(torch, run, 2, f"{cfg.name} cohort train step, 4 "
                            f"clients x {MOE_BATCH} x {MOE_SEQ} tokens, r 16",
                            raw_events=True, reps=2)
    out = {"rounds": rounds, "launches": counts, "peak_allocated_gib": peak,
           "launched_shapes": {k: sorted(v, key=str) for k, v in seen.items()},
           "step_loss": loss.tolist(), "profiled_train_step": window}
    del tr, state, b, step, stacked
    torch.cuda.empty_cache()
    return out, counts


def hybrid_prefill(torch):
    """(c) ``make_prefill_step(use_kernels=True)`` on zamba2-1.2b (2 x 512
    tokens, a rank-16 adapter on the six targets): ``lora_matmul`` 100 and
    ``flash_attention`` 6 a call, finite logits; ms a call."""
    from repro_torch.configs import lora_targets, zamba2_1p2b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    from repro_torch.train.step import make_prefill_step
    cfg = zamba2_1p2b.CONFIG
    dev = torch.device(DEVICE)
    params = T.init(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    ad = _nonzero_b(init_lora(params, lora_targets(cfg), 16, 16.0, gen), gen)
    toks = torch.randint(1, cfg.vocab_size, (2, 512), generator=gen, device=dev)
    step = make_prefill_step(cfg, use_kernels=True)
    step(params, ad, {"tokens": toks})
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with launched_shapes() as seen:
        lg = step(params, ad, {"tokens": toks})
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = {k: v for k, v in ops.launch_counts().items() if v}
    n_sh = T.num_shared_applications(cfg)
    want = {"lora_matmul": 4 * n_sh + 2 * cfg.num_layers, "flash_attention": n_sh}
    print(f"phase 21 (c): make_prefill_step(use_kernels=True) on {cfg.name}, 2 x "
          f"512 tokens: logits {tuple(lg.shape)}, {ms:.1f} ms a call (host "
          f"clock); launches {json.dumps(got)} (expected {json.dumps(want)})")
    if got != want:
        fail(f"phase 21 (c): prefill launches {got} != {want}")
    if not seen["lora_matmul"] <= PHASE21_CHECKED["zamba2_1p2b"]["lora_matmul"]:
        fail(f"phase 21 (c): prefill lora_matmul shapes {seen['lora_matmul']}")
    if tuple(lg.shape) != (2, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
        fail("phase 21 (c): prefill logits")
    del params, ad, lg
    torch.cuda.empty_cache()
    return {"ms": ms, "launches": got}, got


def mamba_layer_parity(torch):
    """(d) one Mamba2 layer of zamba2-1.2b at published widths (d 2048,
    d_inner 4096, 64 heads of 64, state 64), fp32 with TF32 off, on the
    card against the same layer on the CPU: the full-sequence forward on 2
    x 512 tokens (two SSD chunks of 256), then 16 decode steps from the
    zero state through the model's ``_block_decode`` (row 1 with
    ``n_tokens`` 0 on every third step), outputs and states within 1e-4 ·
    max(1, |y|)."""
    from repro_torch.configs import zamba2_1p2b
    from repro_torch.device import parity_mode
    from repro_torch.models import ssm as Ssm
    from repro_torch.models import transformer as T
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    mode = parity_mode()
    cfg = zamba2_1p2b.CONFIG.replace(dtype="float32")
    gen = torch.Generator().manual_seed(31)
    p = T._layer(Ssm.init_mamba2(cfg, gen, 1, torch.float32), 0)
    H = cfg.num_ssm_heads
    p["D"] = torch.rand(H, generator=gen) + 0.5
    p["dt_bias"] = torch.randn(H, generator=gen) * 0.5
    p["conv_b"] = torch.randn(p["conv_b"].shape, generator=gen) * 0.1
    blk = {"ln": torch.ones(cfg.d_model), "mixer": p}
    blk_c = {"ln": blk["ln"].to(DEVICE), "mixer": {k: v.to(DEVICE) for k, v in p.items()}}
    x = torch.randn(2, 512, cfg.d_model, generator=gen)
    want = Ssm.mamba2_fwd(cfg, p, x)
    got = Ssm.mamba2_fwd(cfg, blk_c["mixer"], x.to(DEVICE)).cpu()
    err = float((got - want).abs().max())
    lim = 1e-4 * max(1.0, float(want.abs().max()))
    res = {"forward_max_abs_err": err, "forward_limit": lim}
    cache = Ssm.mamba2_init_state(cfg, 2, "cpu")
    cache_c = Ssm.mamba2_init_state(cfg, 2, DEVICE)
    derr, dlim = 0.0, 0.0
    for t in range(16):
        xt = torch.randn(2, 1, cfg.d_model, generator=gen)
        n = torch.tensor([1, 0 if t % 3 == 2 else 1], dtype=torch.int32)
        y, cache = T._block_decode(cfg, "mamba", blk, xt, cache, {}, n)
        yc, cache_c = T._block_decode(cfg, "mamba", blk_c, xt.to(DEVICE), cache_c,
                                      {}, n.to(DEVICE))
        for a, b in [(yc, y)] + [(cache_c[k], cache[k]) for k in ("conv", "ssm")]:
            derr = max(derr, float((a.cpu() - b).abs().max()))
            dlim = max(dlim, 1e-4 * max(1.0, float(b.abs().max())))
    res.update(decode_max_abs_err=derr, decode_limit=dlim)
    print(f"phase 21 (d): one Mamba2 layer of {cfg.name} at published widths, "
          f"card vs CPU in fp32: forward on 2 x 512 tokens (two SSD chunks) max "
          f"|Δy| {err:.2e} (limit {lim:.2e}); 16 decode steps (row 1 masked every "
          f"third step) max |Δ| over outputs and states {derr:.2e} (limit "
          f"{dlim:.2e}); " + mode)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if err > lim or derr > dlim:
        fail("phase 21 (d): the Mamba2 layer differs between card and CPU")
    return res


def phase21_parity(torch):
    """(e) fp32 (TF32 off) at full width: the train step's kernel route
    against its plain route (phase 7's limits, :func:`step_route_parity`)
    on phi-3-vision cut to 2 layers with patches, musicgen cut to 2 layers
    with frames, and zamba2 cut to 4 layers at ``attn_every`` 2 (two shared
    applications); then zamba2's 16-token decode (kernel route: ``ring_decode``
    on the shared rings) against its forward at that cut, within 2e-4 of max
    |logit| (the reference's limit, tests/test_models.py)."""
    from repro_torch.configs import (lora_targets, musicgen_medium,
                                     phi3_vision_4p2b, zamba2_1p2b)
    from repro_torch.data.synthetic import make_federated_data
    from repro_torch.device import parity_mode
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    dev = torch.device(DEVICE)
    res = {}
    for key, cfg in (("phi3", phi3_vision_4p2b.CONFIG.replace(num_layers=2)),
                     ("musicgen", musicgen_medium.CONFIG.replace(num_layers=2)),
                     ("zamba2", zamba2_1p2b.CONFIG.replace(num_layers=4,
                                                           attn_every=2))):
        cfg = cfg.replace(dtype="float32")
        print(f"phase 21 (e): {cfg.name} train step, kernel route vs plain route, "
              f"full width in fp32, {cfg.num_layers} layers; " + parity_mode())
        params = T.init(cfg, 3, dev)
        gen = torch.Generator(device=dev).manual_seed(4)
        ad = _nonzero_b(init_lora(params, lora_targets(cfg), 16, 16.0, gen), gen)
        if cfg.frontend:
            batches = [frontend_batch(torch, cfg, 2, gen) for _ in range(2)]
        else:
            data = make_federated_data(num_clients=1, seq_len=MOE_SEQ,
                                       vocab=cfg.vocab_size, seed=5)[0]
            batches = [{"tokens": torch.as_tensor(data.tokens[i:i + 2], device=dev).long(),
                        "loss_mask": torch.as_tensor(data.loss_mask[i:i + 2], device=dev)}
                       for i in (0, 2)]
        res[key] = step_route_parity(torch, f"phase 21 (e) {cfg.name}", cfg,
                                     params, ad, batches)
        if key == "zamba2":
            res["zamba2_decode"] = hybrid_decode_parity(torch, cfg, params, ad,
                                                        batches[0]["tokens"][:, :16])
        del params, ad, batches
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return res


def hybrid_decode_parity(torch, cfg, params, ad, toks):
    """16 single-token ``decode`` steps (``decode_impl="kernel"``) against
    the forward's logits (``use_kernels``) over the same tokens."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    with torch.no_grad():
        hidden, _ = T.forward(cfg, params, {"tokens": toks}, ad, use_kernels=True)
        full = T.logits(cfg, params, hidden)
        cache = T.init_cache(cfg, toks.shape[0], 16, torch.float32,
                             device=toks.device)
        n0 = ops.launch_counts()
        outs = []
        for t in range(toks.shape[1]):
            lg, cache = T.decode(cfg, params, cache, {"tokens": toks[:, t:t + 1]},
                                 ad, decode_impl="kernel")
            outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    got = ops.launch_delta(n0, ops.launch_counts())
    rel = float((dec - full).abs().max() / full.abs().max())
    want = T.num_shared_applications(cfg) * toks.shape[1]
    print(f"  {cfg.name}: 16 decode steps against the forward: max |Δ logit| / "
          f"max |logit| {rel:.2e} (limit 2e-4); ring_decode launches "
          f"{got.get('ring_decode', 0)} (expected {want})")
    if rel >= 2e-4 or got.get("ring_decode", 0) != want:
        fail("phase 21 (e): zamba2's decode differs from its forward")
    return {"rel_err": rel, "ring_decode_launches": got.get("ring_decode", 0)}


# -- phase 22: multi-device on one card, gloo worlds of 2 ranks ----------------

WORLD = 2                        # ranks of (a), (b), (d)'s worlds
P22_PARITY_LAYERS = 2            # (b)'s fp32 parity depth


def _rank_start(device: str) -> None:
    global DEVICE
    DEVICE = device


@contextlib.contextmanager
def serving_shapes():
    """The shapes the serving kernels launch at inside the block, recorded
    at the kernels' entry points (as :func:`launched_shapes` does):
    ``{"ring_decode": {(H, K, hd)}, "bgmv": {(din, dout)},
    "mla_ring_decode": {H}}``."""
    from repro_torch.kernels import ops
    seen = {"ring_decode": set(), "bgmv": set(), "mla_ring_decode": set()}
    ring, bgmv, mla = ops.ring_decode_cuda, ops.bgmv_cuda, ops.mla_ring_decode_cuda

    def ring_seen(q, k, *a, **kw):
        seen["ring_decode"].add((q.shape[2], k.shape[2], q.shape[3]))
        return ring(q, k, *a, **kw)

    def bgmv_seen(x, a_pages, b_pages, *a, **kw):
        seen["bgmv"].add((a_pages.shape[-1], b_pages.shape[-2]))
        return bgmv(x, a_pages, b_pages, *a, **kw)

    def mla_seen(q, *a, **kw):
        seen["mla_ring_decode"].add(q.shape[2])
        return mla(q, *a, **kw)

    ops.ring_decode_cuda, ops.bgmv_cuda, ops.mla_ring_decode_cuda = (
        ring_seen, bgmv_seen, mla_seen)
    try:
        yield seen
    finally:
        ops.ring_decode_cuda, ops.bgmv_cuda, ops.mla_ring_decode_cuda = ring, bgmv, mla


def _rank_log(rank: int):
    return (lambda s: print(f"  [rank {rank}] {s}", flush=True)) if rank == 0 \
        else (lambda s: None)


def p22_serve(torch, config: str) -> dict:
    """One rank of a tensor-parallel server: ``launch.serve``'s traffic on
    ``config`` (phase 4's for Llama, phase 8's for DeepSeek-V3-dense3)
    through ``ServeEngine(mesh=make_serve_mesh(WORLD))``, uncaptured; its
    launches, kernel shapes, pools, all_reduces and tokens."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as LS
    from repro_torch.topology import make_serve_mesh, world
    rank, _ = world()
    mesh = make_serve_mesh(WORLD, device=DEVICE)
    setup = LS.build(config, device=mesh.device, mesh=mesh)
    eng = setup["engine"]
    ops.reset_launch_counts()
    with serving_shapes() as seen:
        out = LS.traffic(setup, log=_rank_log(rank))
    counts = ops.launch_counts()
    from repro_torch.serve.adapters import adapter_leaves
    pools = {}
    for path, leaf in adapter_leaves(eng.registry.device_state["pools"]):
        pools[path[-1]] = {"A": tuple(leaf["A"].shape), "B": tuple(leaf["B"].shape),
                           "bytes": leaf["A"].numel() * leaf["A"].element_size()
                           + leaf["B"].numel() * leaf["B"].element_size()}
    res = {"results": out["results"], "stats": out["stats"],
           "served_by": out["served_by"], "swap": out["swap"],
           "counts": counts,
           "want": serve_launches(eng.dcfg, eng, eng.steps_run),
           "steps": eng.steps_run, "all_reduces": eng.tp.all_reduces,
           "reduce_s": eng.tp.reduce_s, "heads": (eng.dcfg.num_heads,
                                                   eng.dcfg.num_kv_heads),
           "seen": seen, "pools": pools, "backend": mesh.backend,
           "builds": {str(k): v for k, v in eng.trace_counts.items()}}
    del out, setup, eng
    torch.cuda.empty_cache()
    return res


def p22_parity_side(torch, mesh) -> dict:
    """(b)'s fp32 side on one engine (``mesh`` None: mesh-less): Llama-3.2-
    1B at P22_PARITY_LAYERS layers in fp32, TF32 off, through the kernel
    routes with phase 5's registry; the first 16-token prefill step's
    logits (``T.decode`` on the engine's own shards) and the greedy tokens
    of 8 requests over 16 steps."""
    import numpy as np
    from repro_torch.configs import lora_targets
    from repro_torch.device import parity_mode
    from repro_torch.launch.serve import CONFIGS, make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    from repro_torch.serve.adapters import AdapterRegistry, attach
    from repro_torch.serve.engine import SamplingParams, ServeEngine
    parity_mode()
    cfg = CONFIGS["llama3p2_1b"][0].replace(dtype="float32",
                                            num_layers=P22_PARITY_LAYERS)
    dev = torch.device(DEVICE) if mesh is None else mesh.device
    params = T.init(cfg, 1, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    targets = lora_targets(cfg)
    reg = AdapterRegistry(init_lora(params, targets, 4, 8.0, gen), page_rank=4,
                          max_rank=16, device=dev)
    aid = [0] + [reg.register(f"r{r}", make_adapter(params, targets, r, gen,
                                                     torch.float32))
                 for r in (4, 8, 16)]
    B, C = 8, 16
    eng = ServeEngine(cfg, params, registry=reg, batch_slots=B, capacity=1024,
                      prefill_chunk=C, decode_impl="kernel", device=dev,
                      mesh=mesh)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, C)), device=dev)
    n = torch.tensor([16, 16, 9, 16, 3, 16, 16, 1], dtype=torch.int32,
                     device=dev)
    ids = torch.tensor([aid[i % 4] for i in range(B)], dtype=torch.int32,
                       device=dev)
    cache = T.init_cache(cfg, B, 1024, torch.float32, prefill_chunk=C,
                         device=dev)
    if mesh is not None:
        from repro_torch import topology
        cache = topology.shard(cache, topology.serve_cache_pspecs(
            mesh, cfg, cache), mesh)
    lg, _ = T.decode(eng.dcfg, eng.params, cache, {"tokens": toks},
                     attach(reg.device_state, ids, impl="kernel"), n_tokens=n,
                     decode_impl="kernel", tp=eng.tp)
    prng = np.random.default_rng(4)
    uids = [eng.submit(prng.integers(1, cfg.vocab_size,
                                     int(prng.integers(32, 65))).tolist(),
                       SamplingParams(max_tokens=16), adapter_id=aid[i % 4])
            for i in range(B)]
    res = eng.run()
    out = {"logits": lg.cpu(), "valid": (torch.arange(C, device=dev)[None, :]
                                         < n[:, None]).cpu(),
           "tokens": [res[u] for u in uids],
           "reduces": eng.tp.all_reduces if eng.tp is not None else 0}
    del eng, reg, params, lg
    torch.cuda.empty_cache()
    return out


def p22_serving_rank(device: str = "cuda") -> dict:
    """Every serving case of phase 22 on one rank of the world of
    ``WORLD`` (gloo, every rank on cuda:0): (a) Llama-3.2-1B, (b) the fp32
    parity side and DeepSeek-V3-dense3."""
    import torch
    from repro_torch.topology import make_serve_mesh
    _rank_start(device)
    out = {"llama": p22_serve(torch, cut_config("llama3p2_1b",
                                                P22_LLAMA_LAYERS))}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    out["parity"] = p22_parity_side(torch, make_serve_mesh(WORLD, device=DEVICE))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out["mla"] = p22_serve(torch, "deepseek_v3_dense3")
    return out


def p22_nccl_rank() -> dict:
    """(c): one rank on NCCL: a collective on the card, then the mesh-1
    engine against the mesh-less engine on phase 4's traffic (Llama cut
    to 2 layers, bf16, graphed), tokens bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import serve as LS
    from repro_torch.topology import make_serve_mesh
    x = torch.arange(4.0, device="cuda")
    dist.all_reduce(x)
    key = cut_config("llama3p2_1b", 2)
    runs = {}
    for name, mesh in (("mesh-less", None), ("mesh 1", make_serve_mesh(1))):
        setup = LS.build(key, device="cuda", mesh=mesh)
        out = LS.traffic(setup, log=lambda s: None)
        runs[name] = {"results": out["results"],
                      "captures": sum(setup["engine"].trace_counts.values())}
        del setup, out
        torch.cuda.empty_cache()
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "all_reduce": x.cpu(), "runs": runs}


def p22_fed_side(torch, runner: str, method: str, bf16: bool = False) -> dict:
    """(d)'s federated run on one rank (or in one process): TinyLlama at
    ``TINY_LAYERS`` in fp32 (TF32 off) on the fp32 wire, or with ``bf16``
    in bf16 on the bf16 wire as phases 13-16 train, 8 clients of rank 16,
    4 a round, 4 local steps of 4 x 512 tokens, the Gram route,
    ``TINY_ROUNDS`` rounds; the history, kept ranks, global adapters,
    launches and the ``lora_matmul`` / ``adapter_gram`` shapes launched."""
    from repro_torch.device import parity_mode
    from repro_torch.kernels import ops
    if bf16:
        setup = _tiny_setup(torch, layers=TINY_LAYERS)
        tr = _tiny_trainer(setup, runner, fed_kw={"method": method})
    else:
        parity_mode()
        setup = _tiny_setup(torch, layers=TINY_LAYERS, dtype="float32")
        tr = _tiny_trainer(setup, runner, fed_kw={"method": method},
                           transport="fp32")
    ops.reset_launch_counts()
    with launched_shapes() as seen:
        tr.run(TINY_ROUNDS)
    counts = ops.launch_counts()
    gs = tr.global_state
    out = {"history": [(h.eval_loss, h.upload_bytes, h.download_bytes,
                        h.global_rank_total) for h in tr.history],
           "ranks": gs.ranks, "global": gs.global_adapters, "counts": counts,
           "seen": seen, "peak": getattr(tr.runner, "peak_live_clients", 0)}
    del tr, setup
    torch.cuda.empty_cache()
    return out


def p22_fed_rank(device: str = "cuda") -> dict:
    """(d) on one rank: the fp32 run that is held to the one-process run,
    then the bf16 run of the cohort phases."""
    import torch
    _rank_start(device)
    fp32 = p22_fed_side(torch, "sharded_cohort", "florist_sharded")
    return {"fp32": fp32, "bf16": p22_fed_side(
        torch, "sharded_cohort", "florist_sharded", bf16=True)}


def phase22(torch) -> tuple:
    """Phase 22: the multi-device path on one H100 (the card's one device:
    NCCL refuses two ranks on one GPU, so the sharded paths run as a gloo
    world of ``WORLD`` ranks that share cuda:0; gloo carries the
    collectives through the host and every kernel runs on the card at its
    shard's shape).  (a) tensor-parallel Llama-3.2-1B serving, (b) fp32
    parity against the mesh-less engine and DeepSeek-V3-dense3 serving
    (one world for both), (c) NCCL at world 1, (d) ``sharded_cohort`` +
    ``florist_sharded`` in fp32 against one-process ``cohort`` +
    ``florist``, then in bf16.
    Every rank must finish; a rank's exception fails the script."""
    from repro_torch.launch.serve import CONFIGS, MAX_TOKENS, N_REQUESTS
    from repro_torch.topology import spawn
    report, counts = {}, {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print("phase 22 (b): the mesh-less side in this process")
    base = p22_parity_side(torch, None)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    t0 = time.perf_counter()
    print(f"phase 22 (a), (b): a gloo world of {WORLD} ranks on cuda:0 "
          "(spawned; every rank on the same card)")
    ranks = spawn(p22_serving_rank, WORLD, "gloo", DEVICE, args=(DEVICE,),
                  timeout_s=600)
    print(f"  world of {WORLD}: {time.perf_counter() - t0:.1f} s, spawn included")
    # (a) Llama-3.2-1B at P22_LLAMA_LAYERS layers, phase 4's traffic
    for key, label in (("llama", "(a)"), ("mla", "(b)")):
        cfg = CONFIGS["llama3p2_1b" if key == "llama" else "deepseek_v3_dense3"][0]
        if key == "llama":
            cfg = cfg.replace(num_layers=P22_LLAMA_LAYERS)
        L = cfg.num_layers
        r0 = ranks[0][key]
        heads = (f"{r0['heads'][0]}" if cfg.use_mla
                 else f"{r0['heads'][0]} (KV {r0['heads'][1]})")
        print(f"phase 22 {label}: {cfg.name}, {L} layers, bf16, mesh (data=1, "
              f"model={WORLD}), backend {r0['backend']}; a rank's heads "
              f"{heads}; uncaptured steps (builds {r0['builds']})")
        for r in range(WORLD):
            got = ranks[r][key]
            res = got["results"]
            if len(res) != N_REQUESTS or any(len(t) != MAX_TOKENS
                                             for t in res.values()):
                fail(f"phase 22 {label}: rank {r} served "
                     f"{ {u: len(t) for u, t in res.items()} }")
            if res != r0["results"]:
                fail(f"phase 22 {label}: rank {r}'s tokens differ from rank 0's")
            if got["counts"] != got["want"]:
                fail(f"phase 22 {label}: rank {r} launched {got['counts']}, "
                     f"expected {got['want']} over {got['steps']} steps")
            if got["all_reduces"] != 2 * L * got["steps"]:
                fail(f"phase 22 {label}: rank {r} made {got['all_reduces']} "
                     f"all_reduces over {got['steps']} steps, expected 2 L a step")
        seen = r0["seen"]
        if key == "llama":
            H, K = cfg.num_heads // WORLD, cfg.num_kv_heads // WORLD
            if seen["ring_decode"] != {(H, K, cfg.head_dim)}:
                fail(f"phase 22 (a): ring_decode called at {seen['ring_decode']}")
            if seen["bgmv"] != set(BGMV_SHARD):
                fail(f"phase 22 (a): bgmv called at {seen['bgmv']}, not the "
                     f"shard widths {BGMV_SHARD}")
            full = {"wq": (cfg.d_model, cfg.num_heads * cfg.head_dim),
                    "wk": (cfg.d_model, cfg.num_kv_heads * cfg.head_dim),
                    "wv": (cfg.d_model, cfg.num_kv_heads * cfg.head_dim),
                    "wo": (cfg.num_heads * cfg.head_dim, cfg.d_model)}
            for name, pool in r0["pools"].items():
                din, dout = full[name]
                half = (pool["A"][-1] * WORLD == din if name == "wo"
                        else pool["B"][-2] * WORLD == dout)
                whole = (pool["B"][-2] == dout if name == "wo"
                         else pool["A"][-1] == din)
                if not (half and whole):
                    fail(f"phase 22 (a): {name}'s pools {pool['A']} / "
                         f"{pool['B']} are not the rank's half")
            print(f"  each rank's pools: " + ", ".join(
                f"{n} A {p['A']} B {p['B']}" for n, p in r0["pools"].items())
                + f" ({sum(p['bytes'] for p in r0['pools'].values()) / 2**20:.2f}"
                  " MiB a rank, half of each target's sharded factor)")
        else:
            if seen["mla_ring_decode"] != {cfg.num_heads // WORLD}:
                fail(f"phase 22 (b): mla_ring_decode at {seen['mla_ring_decode']} heads")
            if not seen["bgmv"] <= set(BGMV_MLA_SHARD):
                fail(f"phase 22 (b): bgmv called at {seen['bgmv']}, outside "
                     f"{BGMV_MLA_SHARD}")
        st = r0["stats"]
        steps = r0["steps"]
        print(f"  both ranks served {N_REQUESTS} of {N_REQUESTS} requests x "
              f"{MAX_TOKENS} tokens, the same tokens on both; launches a rank "
              f"{json.dumps({k: v for k, v in r0['counts'].items() if v})} over "
              f"{steps} steps (= {json.dumps({k: v for k, v in r0['want'].items() if v})})")
        print(f"  rank 0: decode step median {st['decode_step_ms_median']:.3f} "
              f"ms, prefill step median {st['prefill_step_ms_median']:.3f} ms "
              f"(CUDA events around each uncaptured step), wall "
              f"{st['wall_s']:.2f} s; {r0['all_reduces'] / steps:.0f} "
              f"all_reduces a step (2 L), {1e3 * r0['reduce_s'] / steps:.3f} ms "
              f"of them a step (host clock, gloo through the host)")
        report[key] = {k: r0[k] for k in ("stats", "counts", "steps",
                                          "all_reduces", "reduce_s", "builds")}
        report[key]["seen"] = {k: sorted(v) for k, v in seen.items()}
        for k, v in r0["counts"].items():
            counts[k] = counts.get(k, 0) + v
    # (b) the fp32 parity against the mesh-less engine on the card
    got = ranks[0]["parity"]
    err = check(f"phase 22 (b): mesh-{WORLD} kernel engine vs mesh-less, first "
                f"16-token prefill step's logits (fp32, TF32 off, "
                f"{P22_PARITY_LAYERS} layers)", got["logits"], base["logits"],
                base["valid"], 1e-3)
    pairs = [(a, b) for ra, rb in zip(got["tokens"], base["tokens"])
             for a, b in zip(ra, rb)]
    agree = sum(a == b for a, b in pairs)
    print(f"  greedy tokens over 16 steps x 8 requests: {agree}/{len(pairs)} "
          f"equal; rank 1's equal rank 0's: "
          f"{ranks[1]['parity']['tokens'] == got['tokens']}")
    if agree != len(pairs) or len(pairs) != 16 * 8 \
            or ranks[1]["parity"]["tokens"] != got["tokens"]:
        fail("phase 22 (b): the mesh engine's greedy tokens differ")
    report["parity"] = {"logits_max_abs_err": err, "greedy_equal": agree}
    # (c) NCCL at world 1
    t0 = time.perf_counter()
    nccl = spawn(p22_nccl_rank, 1, "nccl", "cuda", timeout_s=300)[0]
    runs = nccl["runs"]
    same = runs["mesh-less"]["results"] == runs["mesh 1"]["results"]
    print(f"phase 22 (c): backend {nccl['backend']}, world {nccl['world']}: "
          f"all_reduce on the card {nccl['all_reduce'].tolist()}; the mesh-1 "
          f"engine's tokens equal the mesh-less engine's: {same} "
          f"({len(runs['mesh 1']['results'])} requests, captures "
          f"{runs['mesh 1']['captures']} / {runs['mesh-less']['captures']}; "
          f"{time.perf_counter() - t0:.1f} s)")
    if nccl["backend"] != "nccl" or not same \
            or nccl["all_reduce"].tolist() != [0.0, 1.0, 2.0, 3.0]:
        fail("phase 22 (c): the NCCL mesh-1 engine differs from the mesh-less one")
    report["nccl"] = {"backend": nccl["backend"], "tokens_equal": same}
    # (d) federated: sharded_cohort + florist_sharded on a world of 2
    t0 = time.perf_counter()
    print(f"phase 22 (d): TinyLlama-1.1B at {TINY_LAYERS} layers, fp32 (TF32 "
          f"off; then bf16 on the world), 8 clients of rank {TINY_RANK}, 4 a round, 4 steps of "
          f"{FED_BATCH} x {FED_SEQ}, Gram route, {TINY_ROUNDS} rounds: "
          f"sharded_cohort + florist_sharded on a gloo world of {WORLD} "
          "against cohort + florist in this process")
    one = p22_fed_side(torch, "cohort", "florist")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    fed = spawn(p22_fed_rank, WORLD, "gloo", DEVICE, args=(DEVICE,),
                timeout_s=600)
    half = {r: fed[r]["bf16"] for r in range(WORLD)}
    fed = {r: fed[r]["fp32"] for r in range(WORLD)}
    r0 = fed[0]
    for (la, *ca), (lb, *cb) in zip(r0["history"], one["history"]):
        print(f"  eval loss {la:.6f} (one process {lb:.6f}, |Δ| "
              f"{abs(la - lb):.2e}, limit 2e-4); wire bytes and global rank "
              f"{ca} ({cb})")
        if abs(la - lb) > 2e-4 or ca != cb:
            fail("phase 22 (d): the sharded round differs from the cohort round")
    if r0["ranks"] != one["ranks"]:
        fail(f"phase 22 (d): kept ranks differ: {r0['ranks']} vs {one['ranks']}")
    pa, pb = ({p: prod for p, prod in _products_of(torch, t).items()}
              for t in (r0["global"], one["global"]))
    d = max(((pa[p] - pb[p]).abs().max() / pb[p].abs().max().clamp_min(1.0)).item()
            for p in pb)
    print(f"  ΔW max |Δ| / max(1, |ΔW|) {d:.2e} (limit 2e-3); kept ranks equal")
    if d > 2e-3:
        fail("phase 22 (d): the sharded ΔW differs")
    from repro_torch.core.aggregators import adapter_leaf_paths, get_path
    for path in adapter_leaf_paths(r0["global"]):
        for k in ("A", "B"):
            if not torch.equal(torch.as_tensor(get_path(r0["global"], path)[k]),
                               torch.as_tensor(get_path(fed[1]["global"], path)[k])):
                fail(f"phase 22 (d): rank 1's global {path} {k} differs from rank 0's")
    want_shapes = {"lora_matmul": {(4 // WORLD,) + s for s in LORA_SHARD_SHAPES},
                   "adapter_gram": set(GRAM_SHARD)}
    for r in range(WORLD):
        got = fed[r]
        if got["counts"] != one["counts"]:
            fail(f"phase 22 (d): rank {r} launched {got['counts']}, the "
                 f"one-process cohort run {one['counts']}")
        for k, v in got["seen"].items():
            if not v or not v <= want_shapes[k]:
                fail(f"phase 22 (d): rank {r} launched {k} at {sorted(v)}, "
                     f"outside phase 2/3's {sorted(want_shapes[k])}")
    print(f"  global adapters equal bit for bit on both ranks; launches a "
          f"rank {json.dumps({k: v for k, v in r0['counts'].items() if v})} "
          f"(= the one-process run's); shapes {sorted(r0['seen']['lora_matmul'])}"
          f" {sorted(r0['seen']['adapter_gram'])}; peak live clients "
          f"{r0['peak']}; {time.perf_counter() - t0:.1f} s")
    # the bf16 run of the cohort phases on the same world: the bf16 routes
    # of lora_matmul (C 2) and flash_attention (B 8) under the sharded path
    h0 = half[0]
    for r in range(WORLD):
        got = half[r]
        if got["counts"] != fed[r]["counts"]:
            fail(f"phase 22 (d): rank {r}'s bf16 run launched {got['counts']}, "
                 f"its fp32 run {fed[r]['counts']}")
        for k, v in got["seen"].items():
            if not v or not v <= want_shapes[k]:
                fail(f"phase 22 (d): rank {r}'s bf16 run launched {k} at "
                     f"{sorted(v)}, outside phase 2/3's {sorted(want_shapes[k])}")
        if got["history"] != h0["history"] or got["ranks"] != h0["ranks"]:
            fail(f"phase 22 (d): rank {r}'s bf16 history or kept ranks differ "
                 "from rank 0's")
        for path in adapter_leaf_paths(h0["global"]):
            for k in ("A", "B"):
                if not torch.equal(torch.as_tensor(get_path(h0["global"], path)[k]),
                                   torch.as_tensor(get_path(got["global"], path)[k])):
                    fail(f"phase 22 (d): rank {r}'s bf16 global {path} {k} "
                         "differs from rank 0's")
    losses = [h[0] for h in h0["history"]]
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 22 (d): the bf16 run's eval losses {losses}")
    print(f"  bf16 (the bf16 wire): eval loss "
          + ", ".join(f"{x:.6f}" for x in losses) + " (fp32 run "
          + ", ".join(f"{h[0]:.6f}" for h in r0["history"]) + "); kept ranks "
          f"{h0['ranks']}; both ranks' histories, kept ranks and global "
          f"adapters equal; launches a rank = the fp32 run's; shapes "
          f"{sorted(h0['seen']['lora_matmul'])} "
          f"{sorted(h0['seen']['adapter_gram'])}; peak live clients {h0['peak']}")
    report["fed"] = {"history": r0["history"], "one_process": one["history"],
                     "delta_w_rel": d, "counts": r0["counts"],
                     "bf16_history": h0["history"]}
    for k in r0["counts"]:                         # the fp32 and bf16 runs
        counts[k] = counts.get(k, 0) + r0["counts"][k] + h0["counts"][k]
    del one, fed, half, ranks
    torch.cuda.empty_cache()
    return report, counts


# -- phase 23: tensor-parallel serving of every other family, one card --------

# (label, launch.serve key, layers served (0: the config's own), published
# layers): the depth cuts that keep the phase inside its budget
P23_SERVE = (("(a)", "granite_moe_1b_a400m", 2, 24),
             ("(b)", "deepseek_v3_l4", 0, 61),
             ("(c)", "rwkv6_1p6b", 2, 24),
             ("(d)", "zamba2_1p2b", 6, 38),
             ("(e)", "phi3_vision_4p2b", 2, 32),
             ("(e)", "musicgen_medium", 2, 48))
# (f)'s fp32 depth: 2 layers (DeepSeek-V3: one dense MLA layer and its
# first MoE layer), zamba2 6 (its first shared-block application)
P23_PARITY_LAYERS = {"granite_moe_1b_a400m": 2, "deepseek_v3_l4": 2,
                     "rwkv6_1p6b": 2, "zamba2_1p2b": 6,
                     "phi3_vision_4p2b": 2, "musicgen_medium": 2}
P23_REQUESTS = 8
P23_NEW = 16
P23_PROMPTS = (32, 128)
P23_SWAP_AFTER = 4                # engine steps before the mid-flight swap


def p23_collectives(cfg, width: int, n: int = WORLD) -> tuple:
    """(all_reduces, all_to_alls) one engine step of ``width`` tokens makes
    on a model axis of ``n``: one all_reduce a row-parallel projection
    (attention's ``wo``, an MLP's ``w_down``, DeepSeek-V3's shared expert,
    RWKV6's ``wo`` and ``wcv``, Mamba2's norm and ``out_proj``, the hybrid's
    shared block's two), and a MoE layer's two all_to_alls in a chunk the
    axis divides, else its one all_reduce."""
    from repro_torch.models.transformer import layer_plan
    ar = a2a = 0
    for kind, count in layer_plan(cfg):
        if kind.endswith("moe"):
            ep = width % n == 0
            ar += count * (1 + (not ep) + bool(cfg.num_shared_experts))
            a2a += 2 * count * ep
        else:
            ar += 2 * count
    return ar, a2a


def _p23_model(torch, cfg, mesh, dev, seed: int, max_rank: int):
    """Params (a MoE model's experts only the rank's), a registry with
    adapters of ranks 4 and 8 and the swap's new version of the rank-8
    one, made before the engine places the model."""
    from repro_torch.configs import lora_targets
    from repro_torch.launch.serve import make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    from repro_torch.serve.adapters import AdapterRegistry
    from repro_torch.serve.engine import rank_experts
    dtype = T.torch_dtype(cfg.dtype)
    params = T.init(cfg, seed, dev, experts=rank_experts(cfg, mesh))
    targets = lora_targets(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    reg = AdapterRegistry(init_lora(params, targets, 4, 8.0, gen, dtype=dtype),
                          page_rank=4, max_rank=max_rank, num_pages=32,
                          max_adapters=8, device=dev)
    ids = [0] + [reg.register(f"r{r}", make_adapter(params, targets, r, gen,
                                                     dtype)) for r in (4, 8)]
    return params, reg, ids, make_adapter(params, targets, 8, gen, dtype)


def p23_serve(torch, key: str, layers: int, mesh) -> dict:
    """One rank of (a)-(e): ``key`` at published widths (``layers`` of
    them) on the serve mesh through ``decode_impl="kernel"``, chunk 16,
    uncaptured: 8 requests of 32-128 prompt tokens and 16 new tokens on the
    base id and adapters of ranks 4 and 8, the rank-8 one swapped after 4
    steps; its tokens, launches and kernel shapes, collectives a step,
    placed bytes and times."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import CONFIGS
    from repro_torch.serve.engine import SamplingParams, ServeEngine
    cfg = CONFIGS[key][0]
    if layers:
        cfg = cfg.replace(num_layers=layers)
    dev = mesh.device
    t0 = time.perf_counter()
    params, reg, ids, swap_ad = _p23_model(torch, cfg, mesh, dev, 0, 8)
    eng = ServeEngine(cfg, params, registry=reg, batch_slots=P23_REQUESTS,
                      capacity=1024, prefill_chunk=16, max_tokens_cap=P23_NEW,
                      decode_impl="kernel", device=dev, record_steps=True,
                      mesh=mesh)
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    served = {}

    def submit(aid):
        plen = int(rng.integers(P23_PROMPTS[0], P23_PROMPTS[1] + 1))
        uid = eng.submit(rng.integers(1, cfg.vocab_size, plen).tolist(),
                         SamplingParams(max_tokens=P23_NEW), adapter_id=aid)
        served[uid] = aid

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with serving_shapes() as seen:
        for i in range(P23_REQUESTS - 2):
            submit(ids[i % 3])
        results = eng.run_steps(P23_SWAP_AFTER)
        new = reg.swap("r8", swap_ad)
        for _ in range(2):
            submit(new)
        results.update(eng.run(max_steps=10_000))
    log = eng.step_log()
    wall = time.perf_counter() - t0
    tp = eng.tp
    dec = [s["ms"] for s in log if s["width"] == 1]
    pre = [s["ms"] for s in log if s["width"] > 1]
    res = {"results": results, "served_by": served, "counts": ops.launch_counts(),
           "want": serve_launches(eng.dcfg, eng, eng.steps_run),
           "steps": eng.steps_run,
           "collectives": [(s["width"], s["all_reduces"], s["all_to_alls"])
                           for s in log],
           "placement": eng.placement, "seen": seen, "backend": mesh.backend,
           "all_reduces": tp.all_reduces, "reduce_s": tp.reduce_s,
           "all_to_alls": tp.all_to_alls, "a2a_s": tp.a2a_s,
           "decode_ms": float(np.median(dec)) if dec else 0.0,
           "prefill_ms": float(np.median(pre)) if pre else 0.0,
           "wall_s": wall, "build_s": build_s,
           "builds": {str(k): v for k, v in eng.trace_counts.items()},
           "swap": new, "layers": cfg.num_layers}
    del eng, reg, swap_ad
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def sliced_moe(n: int):
    """Inside the block a mesh-less ``moe_fwd`` routes a chunk whose width
    ``n`` divides as the reference's ``_moe_fwd_sharded`` does on a model
    axis of ``n``: each sequence slice on its own, at the capacity of its
    own tokens, aux the slices' mean (a width-1 step routes every token at
    once, as on the mesh).  Where capacity binds, that is where the meshed
    engine's drops differ from the mesh-less engine's: (f)'s oracle."""
    import torch
    from repro_torch.models import moe as Moe
    whole = Moe.moe_fwd

    def sliced(cfg, p, x, adapters=None, groups=0, use_kernel=False, tp=None):
        S = x.shape[1]
        if tp is not None or groups or S % n or S == 1:
            return whole(cfg, p, x, adapters, groups, use_kernel, tp)
        w = S // n
        parts = [whole(cfg, p, x[:, r * w:(r + 1) * w], adapters)
                 for r in range(n)]
        return (torch.cat([y for y, _ in parts], dim=1),
                torch.stack([a for _, a in parts]).mean())

    Moe.moe_fwd = sliced
    try:
        yield
    finally:
        Moe.moe_fwd = whole


def _p23_parity_cfg(key: str):
    from repro_torch.launch.serve import CONFIGS
    cfg = CONFIGS[key][0]
    return cfg.replace(dtype="float32", num_layers=P23_PARITY_LAYERS[key],
                       first_dense_layers=min(1, cfg.first_dense_layers))


def p23_parity_side(torch, key: str, mesh) -> dict:
    """(f) on one engine (``mesh`` None: mesh-less, in the parent): ``key``
    at ``P23_PARITY_LAYERS`` in fp32 (TF32 off) through the kernel routes
    with adapters of ranks 4 and 8 and the base id: the first 16-token
    prefill step's logits (RWKV6 and zamba2: the logits after 8 one-token
    steps), the greedy tokens of 8 requests over 16 steps, and for a MoE
    model one 16-token chunk through its first MoE layer: expert parallel
    on the mesh, ``moe_fwd`` on each rank's sequence slice without one.
    The mesh-less side routes a MoE model's chunks as the mesh does
    (:func:`sliced_moe`)."""
    from repro_torch.device import parity_mode
    parity_mode()
    cfg = _p23_parity_cfg(key)
    dev = torch.device(DEVICE) if mesh is None else mesh.device
    with (sliced_moe(WORLD) if mesh is None else contextlib.nullcontext()):
        return _p23_parity_run(torch, key, cfg, dev, mesh)


def _p23_parity_run(torch, key, cfg, dev, mesh) -> dict:
    import numpy as np
    from repro_torch import topology
    from repro_torch.models import moe as Moe
    from repro_torch.models import transformer as T
    from repro_torch.serve.adapters import attach
    from repro_torch.serve.engine import (SamplingParams, ServeEngine,
                                          placement_specs)
    params, reg, aid, _ = _p23_model(torch, cfg, mesh, dev, 1, 8)
    B = 8
    C, steps = (1, 8) if cfg.family in ("ssm", "hybrid") else (16, 1)
    eng = ServeEngine(cfg, params, registry=reg, batch_slots=B, capacity=1024,
                      prefill_chunk=16, decode_impl="kernel", device=dev,
                      mesh=mesh)
    del params
    out = {}
    if cfg.num_experts:
        kinds = [k for k, _ in T.layer_plan(cfg) if k != "shared"]
        seg = next(i for i, k in enumerate(kinds) if k.endswith("moe"))
        p = T._layer(eng.params["blocks"][seg]["moe"], 0)
        x = torch.randn((B, 16, cfg.d_model), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
        # mesh-less, moe_fwd is sliced_moe's: each slice on its own
        y, aux = Moe.moe_fwd(cfg, p, x, tp=eng.tp)
        out["moe"] = (y.cpu(), float(aux))
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, C * steps)),
                           device=dev)
    n = torch.tensor([16, 16, 9, 16, 3, 16, 16, 1] if C == 16
                     else [1, 1, 1, 1, 0, 1, 1, 1], dtype=torch.int32,
                     device=dev)
    ids = torch.tensor([aid[i % 3] for i in range(B)], dtype=torch.int32,
                       device=dev)
    cache = T.init_cache(cfg, B, 1024, torch.float32, prefill_chunk=C,
                         device=dev)
    if mesh is not None:
        cache = topology.shard(cache, placement_specs(
            cfg, mesh, {}, cache, {})["cache"], mesh)
    for i in range(steps):
        lg, cache = T.decode(eng.dcfg, eng.params, cache,
                             {"tokens": toks[:, i * C:(i + 1) * C]},
                             attach(reg.device_state, ids, impl="kernel"),
                             n_tokens=n, decode_impl="kernel", tp=eng.tp)
    prng = np.random.default_rng(4)
    uids = [eng.submit(prng.integers(1, cfg.vocab_size,
                                     int(prng.integers(32, 65))).tolist(),
                       SamplingParams(max_tokens=16), adapter_id=aid[i % 3])
            for i in range(B)]
    res = eng.run()
    out.update({"logits": lg.cpu(),
                "valid": (torch.arange(C, device=dev)[None, :]
                          < n[:, None]).cpu(),
                "tokens": [res[u] for u in uids], "steps": steps})
    del eng, reg, lg, cache
    torch.cuda.empty_cache()
    return out


def p23_rank(device: str = "cuda") -> dict:
    """Every case of phase 23 on one rank of the world of ``WORLD`` (gloo,
    every rank on cuda:0): (a)-(e) serving, then (f)'s meshed sides."""
    import torch
    from repro_torch.topology import make_serve_mesh
    _rank_start(device)
    mesh = make_serve_mesh(WORLD, device=DEVICE)
    out = {key: p23_serve(torch, key, layers, mesh)
           for _, key, layers, _ in P23_SERVE}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    out["parity"] = {key: p23_parity_side(torch, key, mesh)
                     for key in P23_PARITY_LAYERS}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


def phase23(torch) -> tuple:
    """Phase 23: tensor-parallel serving of every family phase 22 does not
    serve, on one gloo world of ``WORLD`` ranks on cuda:0 (spawned once).
    (a) granite-moe-1b-a400m (16 of 32 experts a rank), (b) DeepSeek-V3-L4
    (128 of 256 experts a rank, the shared expert split), (c) RWKV6-1.6B,
    (d) zamba2-1.2b, (e) phi-3-vision-4.2b and musicgen-medium, each at
    published widths (depth cut: ``P23_SERVE``), with 8 requests, adapters
    of ranks 4 and 8 and the base id, a mid-flight swap, chunk 16 and the
    kernel routes: 8 of 8 requests on each rank with equal tokens, the
    launches a step exact at the shard shapes phase 2/3 checks, the
    collectives a step exact, each rank's bytes those its specs give it.
    (f) fp32, TF32 off, at ``P23_PARITY_LAYERS``: the mesh-2 kernel engine
    against the mesh-less one in this process, first-step logits within
    1e-3 of max(1, |logit|), greedy tokens equal over 16 steps, and for
    (a) and (b) one expert-parallel chunk through the first MoE layer
    against ``moe_fwd`` on each sequence slice within 1e-5 of max(1, |y|).
    Every rank must finish; a rank's exception fails the script."""
    from repro_torch.launch.serve import CONFIGS
    from repro_torch.topology import spawn
    t_phase = time.perf_counter()
    report, counts = {}, collections.Counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print("phase 23 (f): the mesh-less sides in this process")
    base = {key: p23_parity_side(torch, key, None) for key in P23_PARITY_LAYERS}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    t0 = time.perf_counter()
    print(f"phase 23: a gloo world of {WORLD} ranks on cuda:0 (spawned; every "
          "rank on the same card)")
    ranks = spawn(p23_rank, WORLD, "gloo", DEVICE, args=(DEVICE,), timeout_s=900)
    print(f"  world of {WORLD}: {time.perf_counter() - t0:.1f} s, spawn included")
    for label, key, layers, full in P23_SERVE:
        cfg = CONFIGS[key][0]
        if layers:
            cfg = cfg.replace(num_layers=layers)
        r0 = ranks[0][key]
        depth = (f"{cfg.num_layers} of its {full} layers" if cfg.num_layers < full
                 else f"{full} layers")
        print(f"phase 23 {label}: {cfg.name} at published widths, {depth}, "
              f"bf16, mesh (data=1, model={WORLD}), backend {r0['backend']}, "
              f"uncaptured steps (builds {r0['builds']}); build "
              f"{r0['build_s']:.1f} s")
        for r in range(WORLD):
            got = ranks[r][key]
            res = got["results"]
            if len(res) != P23_REQUESTS or any(len(t) != P23_NEW
                                               for t in res.values()):
                fail(f"phase 23 {label}: rank {r} served "
                     f"{ {u: len(t) for u, t in res.items()} }")
            if res != r0["results"]:
                fail(f"phase 23 {label}: rank {r}'s tokens differ from rank 0's")
            if got["counts"] != got["want"]:
                fail(f"phase 23 {label}: rank {r} launched {got['counts']}, "
                     f"expected {got['want']} over {got['steps']} steps")
            bad = [c for c in got["collectives"]
                   if c[1:] != p23_collectives(cfg, c[0])]
            if bad or len(got["collectives"]) != got["steps"]:
                fail(f"phase 23 {label}: rank {r}'s collectives a step "
                     f"(width, all_reduces, all_to_alls) {bad[:3]}, expected "
                     f"{p23_collectives(cfg, 1)} at width 1 and "
                     f"{p23_collectives(cfg, 16)} at 16")
            for tree, b in got["placement"].items():
                if b["held"] != b["expected"]:
                    fail(f"phase 23 {label}: rank {r} holds {b['held']} bytes "
                         f"of {tree}, its specs give it {b['expected']}")
        seen = r0["seen"]
        ring = RING_FAMILY_SHARD.get(key)
        if seen["ring_decode"] != ({ring} if ring else set()):
            fail(f"phase 23 {label}: ring_decode called at {seen['ring_decode']}")
        if cfg.use_mla and seen["mla_ring_decode"] != {cfg.num_heads // WORLD}:
            fail(f"phase 23 {label}: mla_ring_decode at "
                 f"{seen['mla_ring_decode']} heads")
        if not seen["bgmv"] or not seen["bgmv"] <= set(BGMV_FAMILY_SHARD[key]):
            fail(f"phase 23 {label}: bgmv called at {sorted(seen['bgmv'])}, "
                 f"outside phase 2/3's {BGMV_FAMILY_SHARD[key]}")
        widths = sorted({c[0] for c in r0["collectives"]})
        per = {w: p23_collectives(cfg, w) for w in widths}
        pl = r0["placement"]
        steps = r0["steps"]
        print(f"  both ranks served {P23_REQUESTS} of {P23_REQUESTS} requests "
              f"x {P23_NEW} tokens (swap to id {r0['swap']} after "
              f"{P23_SWAP_AFTER} steps), the same tokens on both; launches a "
              f"rank {json.dumps({k: v for k, v in r0['counts'].items() if v})}"
              f" over {steps} steps (= the expected); kernel shapes "
              f"{json.dumps({k: sorted(v) for k, v in seen.items() if v})}")
        print(f"  collectives a step (width: all_reduces, all_to_alls) "
              f"{per}; a rank holds params {pl['params']['held'] / 2**30:.3f} "
              f"GiB, pools {pl['adapters']['held'] / 2**20:.2f} MiB, cache "
              f"{pl['cache']['held'] / 2**20:.2f} MiB (= its specs' shares)")
        print(f"  rank 0 on {CARD}: decode step median {r0['decode_ms']:.3f} ms"
              f", prefill step median {r0['prefill_ms']:.3f} ms (CUDA events "
              f"around each uncaptured step), wall {r0['wall_s']:.2f} s; "
              f"collectives' host time {1e3 * r0['reduce_s'] / steps:.3f} ms "
              f"(all_reduce) + {1e3 * r0['a2a_s'] / steps:.3f} ms (all_to_all)"
              f" a step (gloo through the host)")
        report[key] = {k: r0[k] for k in (
            "counts", "steps", "all_reduces", "reduce_s", "all_to_alls",
            "a2a_s", "decode_ms", "prefill_ms", "wall_s", "build_s", "builds",
            "placement", "layers")}
        report[key]["seen"] = {k: sorted(v) for k, v in seen.items()}
        report[key]["collectives_a_step"] = {str(w): c for w, c in per.items()}
        counts.update(r0["counts"])
    # (f) fp32 parity against the mesh-less engines in this process
    report["parity"] = {}
    for key in P23_PARITY_LAYERS:
        cfg = _p23_parity_cfg(key)
        got, want = ranks[0]["parity"][key], base[key]
        what = ("first 16-token prefill step's logits" if want["steps"] == 1
                else f"logits after {want['steps']} one-token steps")
        err = check(f"phase 23 (f): {cfg.name} at {cfg.num_layers} layers, "
                    f"mesh-{WORLD} kernel engine vs mesh-less, {what} (fp32, "
                    "TF32 off)", got["logits"], want["logits"], want["valid"],
                    1e-3)
        pairs = [(a, b) for ra, rb in zip(got["tokens"], want["tokens"])
                 for a, b in zip(ra, rb)]
        agree = sum(a == b for a, b in pairs)
        same = ranks[1]["parity"][key]["tokens"] == got["tokens"]
        print(f"  greedy tokens over 16 steps x 8 requests: {agree}/"
              f"{len(pairs)} equal; rank 1's equal rank 0's: {same}")
        if agree != len(pairs) or len(pairs) != 16 * 8 or not same:
            fail(f"phase 23 (f): {cfg.name}'s mesh engine's greedy tokens differ")
        rec = {"logits_max_abs_err": err, "greedy_equal": agree}
        if "moe" in want:
            (y, aux), (wy, waux) = got["moe"], want["moe"]
            e = float((y - wy).abs().max())
            lim = 1e-5 * max(1.0, float(wy.abs().max()))
            print(f"  one 16-token chunk (B 8) through the first MoE layer, "
                  f"expert parallel vs moe_fwd on each of the {WORLD} sequence "
                  f"slices: max |Δy| {e:.2e} (limit {lim:.2e}), |Δaux| "
                  f"{abs(aux - waux):.2e} (limit 1e-6)")
            if e > lim or abs(aux - waux) > 1e-6:
                fail(f"phase 23 (f): {cfg.name}'s expert-parallel chunk differs")
            rec.update(moe_max_abs_err=e, moe_aux_abs_err=abs(aux - waux))
        report["parity"][key] = rec
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 23: {report['phase_s']:.1f} s")
    del ranks, base
    torch.cuda.empty_cache()
    return report, {k: v for k, v in counts.items() if v}


def _products_of(torch, tree):
    from repro_torch.core.aggregators import adapter_leaf_paths, fold_scale, get_path
    out = {}
    for path in adapter_leaf_paths(tree):
        B, A = fold_scale(get_path(tree, path))
        out[path] = (torch.as_tensor(B, device=DEVICE).double()
                     @ torch.as_tensor(A, device=DEVICE).double())
    return out


# -- phase 24: training with a model axis ---------------------------------------

P24_SEQ = 512                    # tokens a row of every phase 24 batch
VISION_ROW = 1024                # positions of a phase 25 vision row
P24_RANK = 16
P24_LR = 1e-4
P24_PARITY_LAYERS = 2            # (b): Llama-3.2-1B's fp32 parity depth
P24_DSV3_PARITY_LAYERS = 1       # (c)'s fp32 parity depth
P24_QWEN_LAYERS = 4              # (d): Qwen2-0.5B at 4 of its 24 layers
# phase 24's kernel shapes on a rank: lora_matmul's (M, din, dout) at r 16
# and flash_attention's (B, S, H, K, hd).  Llama-3.2-1B at model 2 (M 2 x
# 512): wq 2048 -> 1024, wk / wv 2048 -> 256, wo 1024 -> 2048;
# DeepSeek-V3's DENSE3 at model 2: wq_a 7168 -> 768, wkv_a 7168 -> 288,
# wq_b 1536 -> 12288, wo 8192 -> 7168 (wkv_b is folded on the absorbed
# route); Qwen2-0.5B at model 4: wq 896 -> 224, wk / wv 896 -> 32, wo 224
# -> 896; Qwen2.5-14B whole after ZeRO-3's gather at M 1 x 512: wq / wo
# 5120 -> 5120, wk / wv 5120 -> 1024
LORA_TRAIN_SHARD = ((1024, 2048, 1024), (1024, 2048, 256), (1024, 1024, 2048),
                    (1024, 7168, 768), (1024, 7168, 288), (1024, 1536, 12288),
                    (1024, 8192, 7168), (1024, 896, 224), (1024, 896, 32),
                    (1024, 224, 896), (512, 5120, 5120), (512, 5120, 1024))
LORA_TRAIN_SHARD_FP32 = LORA_TRAIN_SHARD[:7]     # (b) and (c)'s fp32 sides
FLASH_TRAIN_SHARD = ((2, 512, 16, 4, 64), (2, 512, 14, 2, 64),
                     (1, 512, 40, 8, 128))
FLASH_TRAIN_SHARD_FP32 = FLASH_TRAIN_SHARD[:1]
LORA_P24 = "bf16, M=1024 din=2048 dout=1024 r=16"            # Llama's wq shard
FLASH_P24 = "bf16, causal, B=2 S=512 H=16 K=4 hd=64"
P24_CASES = {"lora_matmul": LORA_P24, "flash_attention": FLASH_P24}


def train_shard_kernel_cases(torch):
    """Phase 2/3's cases at phase 24's shard shapes."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(24)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print("phase 2/3: lora_matmul and flash_attention at phase 24's shard "
          "shapes")
    recs = [lora_case(torch, gen, sms, dt, M, din, dout, P24_RANK)
            for dt, shapes in ((torch.bfloat16, LORA_TRAIN_SHARD),
                               (torch.float32, LORA_TRAIN_SHARD_FP32))
            for M, din, dout in shapes]
    recs += [flash_case(torch, gen, dt, B, S, S, H, K, hd, True, 0)
             for dt, shapes in ((torch.bfloat16, FLASH_TRAIN_SHARD),
                                (torch.float32, FLASH_TRAIN_SHARD_FP32))
             for B, S, H, K, hd in shapes]
    return recs


@contextlib.contextmanager
def train_shapes():
    """The (dtype, M, din, dout) of each ``lora_matmul`` launch, the
    (dtype, B, S, H, hd, K) of each ``flash_attention`` launch and the
    (dtype, B, S, H, hd) of each ``wkv6`` launch inside."""
    from repro_torch.kernels import ops
    seen = {"lora_matmul": set(), "flash_attention": set(), "wkv6": set()}
    lora, flash, wkv = ops.lora_matmul_cuda, ops.flash_attention_cuda, ops.wkv6_cuda

    def lora_seen(x, w, a, b):
        seen["lora_matmul"].add((str(x.dtype), x.shape[1]) + tuple(w.shape))
        return lora(x, w, a, b)

    def flash_seen(q, k, v, causal, window):
        seen["flash_attention"].add((str(q.dtype),) + tuple(q.shape)
                                    + (k.shape[2],))
        return flash(q, k, v, causal, window)

    def wkv_seen(r, k, v, w, u):
        seen["wkv6"].add((str(r.dtype),) + tuple(r.shape))
        return wkv(r, k, v, w, u)

    ops.lora_matmul_cuda, ops.flash_attention_cuda, ops.wkv6_cuda = (
        lora_seen, flash_seen, wkv_seen)
    try:
        yield seen
    finally:
        ops.lora_matmul_cuda, ops.flash_attention_cuda, ops.wkv6_cuda = (
            lora, flash, wkv)


def train_checked(torch) -> dict:
    """The shapes phase 2/3 holds to their plain versions at phases 24 and
    25's shard shapes, as :func:`train_shapes` records them."""
    b, f = str(torch.bfloat16), str(torch.float32)
    return {"lora_matmul": {(b,) + s for s in LORA_TRAIN_SHARD + LORA_FAMILY_TRAIN}
            | {(f,) + s for s in LORA_TRAIN_SHARD_FP32 + LORA_FAMILY_TRAIN_FP32},
            "flash_attention": {(dt, B, S, H, hd, K) for dt, shapes in (
                (b, FLASH_TRAIN_SHARD + FLASH_FAMILY_TRAIN),
                (f, FLASH_TRAIN_SHARD_FP32 + FLASH_FAMILY_TRAIN))
                for B, S, H, K, hd in shapes},
            "wkv6": {(dt,) + WKV6_FAMILY_TRAIN for dt in (b, f)}}


def _whole_like(torch, cfg, params, mesh):
    """Meta tensors of the whole model's shapes beside ``params`` (the
    rank's shards): what ``init_lora`` reads to make whole adapters."""
    from repro_torch.topology.partitioning import (Segments, _axes,
                                                   fused_pspec, map_with_path,
                                                   param_pspec)
    from repro_torch.topology.train import zero3_on
    if mesh is None:
        return params
    zero3 = zero3_on(cfg)

    def whole(path, t):
        shape = list(t.shape)
        spec = fused_pspec(cfg, mesh, path, param_pspec(mesh, cfg, path, t,
                                                        zero3))
        if (path[-1] in ("w_gate", "w_up", "w_down") and "moe" in path
                and "shared" not in path):       # an expert stack: all E
            shape[-3] = cfg.num_experts
            spec = [None] * len(shape)
        for d, entry in enumerate(spec):
            if isinstance(entry, Segments):
                shape[d] = sum(entry.widths)
                continue
            for a in _axes(entry):
                shape[d] *= mesh.axis_size(a)
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return map_with_path(whole, params)


_INIT_CACHE = {}                 # the last run's params, for a run that shares them


def _train_init(torch, cfg, mesh, dev, seed: int):
    """Seeded params (under ``mesh`` each rank draws only its shards, the
    ranks in turn: each holds a whole leaf while it cuts it; a MoE layer's
    expert stacks only the rank's experts); reused by the next run of the
    same config, mesh and seed (a route comparison's second route)."""
    from repro_torch.models import transformer as T
    from repro_torch.topology.train import init_keep, train_experts
    key = (cfg, None if mesh is None else tuple(mesh.shape.items()), seed)
    if key in _INIT_CACHE:
        return _INIT_CACHE[key]
    _INIT_CACHE.clear()
    torch.cuda.empty_cache()
    if mesh is not None and mesh.size > 1:
        # in step through a one-element all_reduce on the host
        import torch.distributed as dist
        cut = init_keep(cfg, mesh)

        def keep(path, t):
            torch.cuda.empty_cache()         # the last leaf's whole copies
            return cut(path, t)
        for r in range(mesh.size):
            if r == mesh.rank:
                params = T.init(cfg, seed, dev, experts=train_experts(cfg, mesh),
                                keep=keep)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.all_reduce(torch.zeros(1))
    else:
        params = T.init(cfg, seed, dev)
    _INIT_CACHE[key] = params
    return params


def train_batch(torch, cfg, rng, rows: int, dev) -> dict:
    """A seeded batch of ``rows`` with a ragged mask (10% of positions
    off): P24_SEQ tokens; a vision batch's ``num_patches`` patch
    embeddings before ``VISION_ROW`` - ``num_patches`` text tokens (phase
    21's layout); an audio batch's P24_SEQ frames with their labels."""
    S = VISION_ROW - cfg.num_patches if cfg.frontend == "vision" else P24_SEQ
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (rows, S)), device=dev)
    mask = torch.as_tensor((rng.random((rows, S)) > 0.1).astype("float32"),
                           device=dev)
    if cfg.frontend == "audio":
        emb = rng.normal(size=(rows, S, cfg.frontend_dim)).astype("float32")
        return {"frame_embeds": torch.as_tensor(emb, device=dev).to(
            getattr(torch, cfg.dtype)), "labels": toks, "loss_mask": mask}
    b = {"tokens": toks, "loss_mask": mask}
    if cfg.frontend == "vision":
        emb = rng.normal(size=(rows, cfg.num_patches, cfg.frontend_dim))
        b["patch_embeds"] = torch.as_tensor(emb.astype("float32"), device=dev
                                            ).to(getattr(torch, cfg.dtype))
    return b


def p24_side(torch, cfg, mesh, use_kernels: bool, steps: int, rows: int,
             evaluate: bool = False, prefill: bool = False,
             seed: int = 1) -> dict:
    """One side of a phase 24 comparison: ``cfg`` with seeded weights (the
    rank's shards drawn by ``init_keep`` under ``mesh``, the whole model
    without one), whole rank-16 adapters on ``lora_targets`` with B ≠ 0,
    ``steps`` train steps on seeded batches of ``rows`` x P24_SEQ tokens
    (the rank's rows under a mesh; a ragged mask), then an eval and a
    prefill on the first batch.  Returns per step the loss, the adapters,
    the launches, the collectives and their host time and the step's
    device time; the first step's gradients; eval metrics, prefill logits,
    the kernel shapes, peak memory and the rank's param bytes."""
    import numpy as np
    from repro_torch.common.config import OptimConfig
    from repro_torch.configs import lora_targets
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import adamw_init, adamw_update, tree_leaves
    from repro_torch.peft.lora import init_lora
    from repro_torch.topology.train import shard_batch
    from repro_torch.train import step as St
    dev = torch.device(DEVICE) if mesh is None else mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    t_init = time.perf_counter()
    params = _train_init(torch, cfg, mesh, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    ad = _nonzero_b(init_lora(_whole_like(torch, cfg, params, mesh),
                              lora_targets(cfg), P24_RANK, float(P24_RANK),
                              gen), gen)
    rng = np.random.default_rng(seed + 2)
    batches = []
    for _ in range(steps):
        b = train_batch(torch, cfg, rng, rows, dev)
        batches.append(b if mesh is None else shard_batch(cfg, b, mesh))
    optim = OptimConfig(lr=P24_LR)
    step = St.make_train_step(cfg, optim, loss_chunk=512,
                              use_kernels=use_kernels, mesh=mesh)
    tp = step.tp
    opt = adamw_init(ad)
    out = {"loss": [], "adapters": [], "launches": [], "collectives": [],
           "host_s": [], "step_ms": [], "init_s": time.perf_counter() - t_init,
           "paths": ["/".join(map(str, q)) for q in _leaf_paths(ad)]}
    if mesh is None and cfg.dtype != "float32":
        # the one-process gradients' own bf16 conditioning: how far they
        # move when the embedding (an audio model's frame projection) is
        # perturbed by bf16 rounding (a relative 2^-8 · N(0, 1))
        name = "frontend_proj" if cfg.frontend == "audio" else "embed"
        noise = torch.randn(params[name].shape, generator=gen, device=dev)
        emb = params[name]
        pert = dict(params, **{name: (emb.float() * (1 + 2.0 ** -8 * noise)
                                      ).to(emb.dtype)})
        del noise
        out["grads_perturbed"] = [g.float().cpu() for g in tree_leaves(
            step.grads(pert, ad, batches[0])[1])]
        del pert
    with train_shapes() as seen:
        for i, b in enumerate(batches):
            ops.reset_launch_counts()
            if tp is not None:
                tp.reset_counts()
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ev0.record()
            if i == 0:
                m, grads = step.grads(params, ad, b)
                ad, opt = adamw_update(optim, grads, opt, ad)
                out["grads"] = [g.float().cpu() for g in tree_leaves(grads)]
            else:
                ad, opt, m = step(params, ad, opt, b)
            ev1.record()
            torch.cuda.synchronize()
            out["step_ms"].append(ev0.elapsed_time(ev1))
            out["loss"].append(float(m["loss"]))
            out["adapters"].append([a.cpu() for a in tree_leaves(ad)])
            out["launches"].append(ops.launch_counts())
            out["collectives"].append(dict(tp.counts) if tp else {})
            out["host_s"].append(sum(tp.host_s.values()) if tp else 0.0)
        if evaluate:
            ev = St.make_eval_step(cfg, 512, use_kernels, mesh=mesh)
            ops.reset_launch_counts()
            em = ev(params, ad, batches[0])
            out["eval"] = {k: float(v) for k, v in em.items()}
            out["eval_launches"] = ops.launch_counts()
            out["eval_collectives"] = dict(ev.tp.counts) if ev.tp else {}
        if prefill:
            pf = St.make_prefill_step(cfg, use_kernels, mesh=mesh)
            ops.reset_launch_counts()
            out["prefill"] = pf(params, ad, {
                k: v for k, v in batches[0].items()
                if k not in ("loss_mask", "labels")}).float().cpu()
            out["prefill_launches"] = ops.launch_counts()
            out["prefill_collectives"] = dict(pf.tp.counts) if pf.tp else {}
    out["seen"] = seen
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    from repro_torch.topology.partitioning import local_bytes, map_with_path
    from repro_torch.topology.train import train_pspecs
    held = []
    map_with_path(lambda _, t: held.append(t.numel() * t.element_size()),
                  params)
    out["param_bytes"] = sum(held)
    if mesh is not None:
        whole = _whole_like(torch, cfg, params, mesh)
        out["param_bytes_spec"] = local_bytes(
            whole, train_pspecs(mesh, cfg, whole), mesh)
        out["halves"] = _p24_halves(params, whole)
    del params, ad, opt, step, batches
    torch.cuda.empty_cache()
    return out


def _p24_halves(params, whole) -> dict:
    """For each _COL / _ROW weight, the share of the whole it holds."""
    from repro_torch.topology.partitioning import _COL_MODEL, _ROW_MODEL
    shares = {}
    for seg_s, seg_w in zip(params["blocks"], whole["blocks"]):
        for sub in ("attn", "mlp"):
            for name, t in seg_s.get(sub, {}).items():
                if name in _COL_MODEL + _ROW_MODEL and t.numel():
                    shares.setdefault(name, set()).add(
                        t.numel() / seg_w[sub][name].numel())
    return {k: sorted(v) for k, v in shares.items()}


def p24_cfg(key: str, layers: int = 0, dtype: str = ""):
    """Phase 24's configs: ``launch.serve.CONFIGS``' Llama-3.2-1B and
    DeepSeek-V3-dense3, the trainer's Qwen2-0.5B, Qwen2.5-14B whole."""
    from repro_torch.configs import qwen2_0p5b, qwen2p5_14b
    from repro_torch.launch.serve import CONFIGS
    cfg = {"llama": lambda: CONFIGS["llama3p2_1b"][0],
           "dsv3": lambda: CONFIGS["deepseek_v3_dense3"][0],
           "qwen05": lambda: qwen2_0p5b.CONFIG,
           "qwen14": lambda: qwen2p5_14b.CONFIG}[key]()
    if layers:
        cfg = cfg.replace(num_layers=layers)
        if cfg.use_mla:
            cfg = cfg.replace(first_dense_layers=layers)
    return cfg.replace(dtype=dtype) if dtype else cfg


# (label, config, layers, world, model, dtype, kernels, steps, rows, eval,
#  prefill)
P24_RUNS = (
    ("(a)", "llama", 0, 2, 2, "", True, 2, 2, True, False),
    ("(b) kernel", "llama", P24_PARITY_LAYERS, 2, 2, "float32", True, 1, 2,
     False, True),
    ("(b) plain", "llama", P24_PARITY_LAYERS, 2, 2, "float32", False, 1, 2,
     False, True),
    ("(c)", "dsv3", 0, 2, 2, "", True, 2, 2, False, False),
    ("(c) fp32 kernel", "dsv3", P24_DSV3_PARITY_LAYERS, 2, 2, "float32",
     True, 1, 2, False, True),
    ("(c) fp32 plain", "dsv3", P24_DSV3_PARITY_LAYERS, 2, 2, "float32",
     False, 1, 2, False, True),
    ("(e)", "qwen14", 0, 2, 1, "", True, 1, 2, False, False),
    ("(d) plain", "qwen05", P24_QWEN_LAYERS, 4, 4, "float32", False, 1, 2,
     False, True),
    ("(d) kernel", "qwen05", P24_QWEN_LAYERS, 4, 4, "", True, 1, 2, False,
     False),
)


def _p24_run(torch, run, mesh) -> dict:
    label, key, layers, _, _, dtype, uk, steps, rows, ev, pre = run
    from repro_torch.device import parity_mode
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    if dtype == "float32":
        parity_mode()
    try:
        return p24_side(torch, p24_cfg(key, layers, dtype), mesh, uk, steps,
                        rows, ev, pre)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def train_rank(phase: str, world: int, device: str = "cuda") -> dict:
    """Every run of phase ``phase`` (24 or 25) in a world of ``world``
    ranks on one rank."""
    import traceback

    import torch
    from repro_torch.topology import make_host_mesh, world as rank_of
    _rank_start(device)
    rank = rank_of()[0]
    runs, run_fn = TRAIN_PHASES[phase]
    out = {}
    for run in runs:
        if run[3] != world:
            continue
        t0 = time.perf_counter()
        try:
            out[run[0]] = run_fn(torch, run, make_host_mesh(
                model=run[4], device=DEVICE))
        except Exception:
            # a rank's traceback is printed before the world fails (spawn
            # reports the lowest failed rank's only)
            print(f"[rank {rank}] phase {phase} {run[0]} raised:\n"
                  f"{traceback.format_exc()}", flush=True)
            raise
        print(f"  [rank {rank}] phase {phase} {run[0]}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    _INIT_CACHE.clear()
    return out


def _cos_rel(torch, g, w):
    """(relative L2 distance, cosine) of two gradient leaves."""
    g, w = g.double().flatten(), w.double().flatten()
    n = float(w.norm())
    if n == 0.0:
        return float(g.norm()), 1.0
    return float((g - w).norm()) / n, float(g @ w) / (float(g.norm()) * n + 1e-300)


def train_launches(cfg, use_kernels: bool, kind: str) -> dict:
    """The kernels one forward of ``cfg`` launches on the kernel route
    (``kind`` train, eval or prefill): ``lora_matmul`` an adapted
    projection (four an attention layer or shared-block application, MLA's
    ``wkv_b`` folded; five an RWKV6 layer; two a Mamba2 layer),
    ``flash_attention`` a GQA attention, ``wkv6`` an RWKV6 layer outside a
    train step."""
    from repro_torch.models.transformer import layer_plan
    lora = flash = wkv = 0
    for kind_, n in layer_plan(cfg):
        n = 1 if kind_ == "shared" else n
        if kind_ == "rwkv":
            lora, wkv = lora + 5 * n, wkv + n
        elif kind_ == "mamba":
            lora += 2 * n
        else:
            lora += 4 * n
            flash += 0 if cfg.use_mla else n
    return {"lora_matmul": lora * use_kernels,
            "flash_attention": flash * use_kernels,
            "wkv6": wkv * use_kernels * (kind != "train")}


def train_compare(torch, phase: str, run, ranks, ref) -> dict:
    """Hold one run's ranks to each other, to the one-process side and to
    the design's counts; print and return its numbers."""
    from repro_torch.topology.train import step_collectives
    label, key, layers, world, model, dtype, uk, steps, rows, ev, pre = run
    cfg = TRAIN_CFG[phase](key, layers, dtype)
    data = world // model
    got = [ranks[r][label] for r in range(world)]
    g0 = got[0]
    fp32 = dtype == "float32"
    name = (f"phase {phase} {label}: {cfg.name} ({cfg.num_layers} layers, "
            f"{'fp32' if fp32 else 'bf16'}, {'kernel' if uk else 'plain'} "
            f"route) on (data={data}, model={model})")
    print(name)
    # every rank's adapters the same bits after each step
    for r in range(1, world):
        for s in range(steps):
            if not all(torch.equal(a, b) for a, b in
                       zip(got[r]["adapters"][s], g0["adapters"][s])):
                fail(f"{name}: rank {r}'s adapters differ from rank 0's "
                     f"after step {s + 1}")
    rec = {"loss": g0["loss"], "loss_one_process": ref["loss"],
           "step_ms": g0["step_ms"], "host_s": g0["host_s"],
           "collectives": g0["collectives"], "launches": g0["launches"],
           "peak_gib": g0["peak_gib"], "param_bytes": g0["param_bytes"],
           "one_process_step_ms": ref["step_ms"], "init_s": g0["init_s"],
           "one_process_peak_gib": ref["peak_gib"]}
    # the loss and the first step's gradients against the one-process step
    rels = [_cos_rel(torch, g, w) for g, w in zip(g0["grads"], ref["grads"])]
    dl = max(abs(a - b) for a, b in zip(g0["loss"], ref["loss"]))
    if fp32:
        gerr = max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                   for g, w in zip(g0["grads"], ref["grads"]) if w.numel())
        print(f"  loss {g0['loss'][0]:.7f} vs one process {ref['loss'][0]:.7f}"
              f" (|Δ| {dl:.2e}, limit 1e-5); gradients: max |Δg| / max(1, "
              f"max |g|) over leaves {gerr:.2e} (limit 1e-4)")
        if dl > 1e-5 or gerr > 1e-4:
            fail(f"{name}: loss or gradients differ from the one-process step")
        rec.update(loss_abs_err=dl, grads_max_rel_err=gerr)
        if pre:
            e = float((g0["prefill"] - ref["prefill"]).abs().max())
            lim = 1e-4 * max(1.0, float(ref["prefill"].abs().max()))
            print(f"  prefill's whole (B, V) logits on every rank: max |Δ| "
                  f"{e:.2e} (limit {lim:.2e})")
            if e > lim or any(not torch.equal(x["prefill"], g0["prefill"])
                              for x in got):
                fail(f"{name}: prefill logits differ")
            rec["prefill_max_abs_err"] = e
    else:
        # bf16 (8 significant bits): the mesh rounds each row-parallel
        # partial to bf16 before the fp32 sum, so activations differ from
        # the one-process step by ~1 bf16 ulp a layer.  How far that moves
        # a gradient is the gradient's own bf16 conditioning: how far the
        # one-process gradient moves when the embedding is perturbed by
        # bf16 rounding (a relative 2^-8 · N(0, 1)); at full depth it is
        # up to ~25% for the leaves whose gradients are smallest (on an
        # H100 80GB HBM3, Llama-3.2-1B's `wk` scale leaf: 0.31 from the
        # one-process step at a cosine of 0.956, 0.36 of the limit
        # below).  Limits: the loss within 2e-3 of
        # max(1, |loss|) (the CE averages ~1000 tokens); every leaf's
        # gradient, and all leaves as one vector, within max(0.15, 4 x its
        # conditioning) and max(0.05, 4 x the vector's conditioning) of
        # its norm (relative L2: a part dropped or counted twice moves a
        # well-conditioned leaf by 30% or more); and the adapters after
        # each step within a mean |Δ| of 0.25·lr (Adam moves an entry by
        # about ±lr whatever its gradient's size, so only entries whose
        # gradient is within noise of zero may step the other way; a wrong
        # gradient turns half of them: ~lr)
        lim_l = 2e-3 * max(1.0, abs(ref["loss"][0]))
        cond = [_cos_rel(torch, q, w)[0] for q, w in
                zip(ref["grads_perturbed"], ref["grads"])]
        share = [r / max(0.15, 4 * c) for (r, _), c in zip(rels, cond)]
        flat = [torch.cat([t.flatten() for t in ts]) for ts in (
            g0["grads"], ref["grads"], ref["grads_perturbed"])]
        all_rel, all_cos = _cos_rel(torch, flat[0], flat[1])
        all_cond = _cos_rel(torch, flat[2], flat[1])[0]
        share.append(all_rel / max(0.05, 4 * all_cond))
        worst_rel = max(r for r, _ in rels)
        worst_cos = min(c for _, c in rels)
        order = sorted(range(len(rels)), key=lambda i: -share[i])[:3]
        print("  leaves nearest their limits (relative L2, conditioning): "
              + ", ".join(f"{ref['paths'][i]} {rels[i][0]:.3f} "
                          f"({cond[i]:.3f})" for i in order)
              + f"; all leaves {all_rel:.3e} ({all_cond:.3e}), cosine "
              f"{all_cos:.6f}")
        mean_d = [float(torch.cat([(a - b).abs().flatten() for a, b in zip(
            g0["adapters"][s], ref["adapters"][s])]).mean()) for s in range(steps)]
        print(f"  loss {['%.5f' % x for x in g0['loss']]} vs one process "
              f"{['%.5f' % x for x in ref['loss']]} (|Δ| at most {dl:.2e}, "
              f"limit {lim_l:.2e}); first step's gradients: worst leaf relative "
              f"L2 {worst_rel:.3e} (the one process's own bf16 conditioning "
              f"at most {max(cond):.3e}; nearest its limit at "
              f"{max(share):.2f} of it), cosine at least {worst_cos:.6f}; "
              f"adapters' mean |Δ| after each step "
              f"{['%.2e' % x for x in mean_d]} (limit {0.25 * P24_LR:.1e})")
        if dl > lim_l or max(share) > 1 or max(mean_d) > 0.25 * P24_LR:
            fail(f"{name}: the mesh's step differs from the one-process step")
        rec.update(loss_abs_err=dl, grads_worst_rel_l2=worst_rel,
                   grads_worst_cond=max(cond), grads_worst_share=max(share),
                   grads_worst_cos=worst_cos, grads_all_rel_l2=all_rel,
                   grads_all_cond=all_cond, adapters_mean_abs_diff=mean_d)
    # launches a step, an eval and a prefill, exact at the rank's shard
    # shapes
    per_fwd = train_launches(cfg, uk, "train")
    per_eval = train_launches(cfg, uk, "eval")
    for x in got:
        for s, c in enumerate(x["launches"]):
            have = {k: c.get(k, 0) for k in per_fwd}
            if have != per_fwd or sum(c.values()) != sum(per_fwd.values()):
                fail(f"{name}: step {s + 1} launched {c}, expected {per_fwd}")
        for what, on in (("eval", ev), ("prefill", pre)):
            c = x.get(f"{what}_launches", {})
            if on and ({k: c.get(k, 0) for k in per_eval} != per_eval
                       or sum(c.values()) != sum(per_eval.values())):
                fail(f"{name}: the {what} launched {c}, expected {per_eval}")
    checked = train_checked(torch)
    for k, shapes in g0["seen"].items():
        if not shapes <= checked[k]:
            fail(f"{name}: {k} launched at {sorted(shapes - checked[k])}, "
                 "outside phase 2/3's cases")
    # the collectives a step, as the design counts them (a vision row's
    # text tokens after its patches)
    patches = cfg.num_patches if cfg.frontend == "vision" else 0
    kw = dict(loss_chunk=512, use_kernels=uk, patches=patches)
    S = VISION_ROW - patches if patches else P24_SEQ
    want = step_collectives(cfg, model, data, S, **kw)
    for x in got:
        for s, c in enumerate(x["collectives"]):
            if c != want:
                fail(f"{name}: step {s + 1}'s collectives {c}, the design's "
                     f"{want}")
        if ev and x["eval_collectives"] != step_collectives(
                cfg, model, data, S, kind="eval", **kw):
            fail(f"{name}: the eval's collectives {x['eval_collectives']}")
        if pre and x["prefill_collectives"] != step_collectives(
                cfg, model, data, S, kind="prefill", **kw):
            fail(f"{name}: the prefill's collectives {x['prefill_collectives']}")
    # each rank's base bytes: its specs' share
    for x in got:
        if x["param_bytes"] != x["param_bytes_spec"]:
            fail(f"{name}: a rank holds {x['param_bytes']} bytes of params, "
                 f"its specs give it {x['param_bytes_spec']}")
    steps_ms = g0["step_ms"]
    print(f"  adapters bit-equal on the {world} ranks after each step; "
          f"launches a step {json.dumps({k: v for k, v in per_fwd.items() if v})}"
          f"{' (an eval / prefill ' + json.dumps({k: v for k, v in per_eval.items() if v}) + ')' if (ev or pre) and per_eval != per_fwd else ''}"
          f" (= the design's), shapes {json.dumps({k: sorted(v) for k, v in g0['seen'].items() if v})}")
    print(f"  collectives a step {json.dumps(want)} (= the design's), host "
          f"time {['%.3f' % x for x in g0['host_s']]} s; step on {CARD}: "
          f"{['%.1f' % x for x in steps_ms]} ms (rank 0, CUDA events; gloo "
          f"through the host, {world} ranks on one card) vs one process "
          f"{['%.1f' % x for x in ref['step_ms']]} ms; a rank holds "
          f"{g0['param_bytes'] / 2**30:.3f} GiB of params (= its specs' "
          f"share), peak allocated {g0['peak_gib']:.2f} GiB (one process "
          f"{ref['peak_gib']:.2f}); set-up {g0['init_s']:.1f} s (the "
          f"ranks' inits in turn)")
    rec["collectives_design"] = want
    if "halves" in g0:
        rec["halves"] = g0["halves"]
    return rec


def phase24(torch) -> tuple:
    """Phase 24: training with a ``model`` axis (and ZeRO-3 over
    ``data``), every run's one-process side first in this process, then a
    gloo world of 2 ranks on cuda:0 for (a), (b), (c), (e) and one of 4
    for (d) (see the module docstring)."""
    from repro_torch.topology import spawn
    t_phase = time.perf_counter()
    print("phase 24: the one-process sides in this process")
    refs = {}
    for run in P24_RUNS:
        t0 = time.perf_counter()
        refs[run[0]] = _p24_run(torch, run, None)
        print(f"  {run[0]}: one process {time.perf_counter() - t0:.1f} s, "
              f"step {['%.1f' % x for x in refs[run[0]]['step_ms']]} ms")
    report, counts = {}, collections.Counter()
    import gc
    _INIT_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  this process holds {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB on the card ({torch.cuda.memory_reserved() / 2**30:.2f} GiB "
          "reserved) while the worlds run")
    for world in (2, 4):
        t0 = time.perf_counter()
        ranks = spawn(train_rank, world, "gloo", DEVICE,
                      args=("24", world, DEVICE), timeout_s=900)
        print(f"phase 24: a gloo world of {world} ranks on cuda:0: "
              f"{time.perf_counter() - t0:.1f} s, spawn included")
        for run in P24_RUNS:
            if run[3] != world:
                continue
            report[run[0]] = train_compare(torch, "24", run, ranks,
                                           refs[run[0]])
            for c in ranks[0][run[0]]["launches"]:
                counts.update(c)
        del ranks
    e = report["(e)"]["halves"]
    print(f"phase 24 (e): ZeRO-3 share of each _COL / _ROW weight a rank "
          f"holds: {e}; peak allocated a rank {report['(e)']['peak_gib']:.2f}"
          f" GiB")
    if any(v != [0.5] for v in e.values()):
        fail(f"phase 24 (e): a rank's ZeRO-3 shares are {e}, not halves")
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 24: {report['phase_s']:.1f} s")
    del refs
    torch.cuda.empty_cache()
    return report, {k: v for k, v in counts.items() if v}


# -- phase 25: training with a model axis for every other family --------------

# phase 25's kernel shapes on a rank at model 2 (M = the rank's rows x 512, a
# vision row 1024 positions), bf16 and fp32: lora_matmul's (M, din, dout) at
# r 16, beyond phase 24's: granite-moe at one row a rank, wq 1024 -> 512, wk
# / wv 1024 -> 256, wo 512 -> 1024; zamba2's Mamba2 in_proj cut segment by
# segment, 2048 -> 2048 + 2048 + 128 + 32 = 4256, and out_proj 2048 ->
# 2048; phi-3-vision 3072 -> 1536, 1536 -> 3072; musicgen 1536 -> 768, 768
# -> 1536.  RWKV6's wr wk wv wg 2048 -> 1024 and wo 1024 -> 2048 and
# zamba2's shared block are Llama's rank's (phase 24), DeepSeek-V3-L4's
# projections DeepSeek-V3-dense3's.  flash_attention's (B, S, H, K, hd) and
# wkv6's (B, S, H, hd).
LORA_FAMILY_TRAIN = ((512, 1024, 512), (512, 1024, 256), (512, 512, 1024),
                     (1024, 2048, 4256), (1024, 2048, 2048),
                     (2048, 3072, 1536), (2048, 1536, 3072),
                     (1024, 1536, 768), (1024, 768, 1536))
# DeepSeek-V3-L4's fp32 run takes one row a rank: its projections at M 512
LORA_FAMILY_TRAIN_FP32 = LORA_FAMILY_TRAIN + (
    (512, 7168, 768), (512, 7168, 288), (512, 1536, 12288), (512, 8192, 7168))
FLASH_FAMILY_TRAIN = ((1, 512, 8, 4, 64), (2, 512, 16, 16, 64),
                      (2, 1024, 16, 16, 96), (2, 512, 12, 12, 64))
WKV6_FAMILY_TRAIN = (2, 512, 16, 64)
LORA_P25 = "bf16, M=1024 din=2048 dout=4256 r=16"        # zamba2's in_proj
FLASH_P25 = "bf16, causal, B=2 S=1024 H=16 K=16 hd=96"   # phi-3-vision's rank
WKV6_P25 = "bf16 r/k/v, B=2 S=512 H=16 hd=64"            # RWKV6's rank
P25_CASES = {"lora_matmul": LORA_P25, "flash_attention": FLASH_P25,
             "wkv6": WKV6_P25}


def wkv6_case(torch, gen, dt, B, S, H, hd, mu=-3):
    """One ``wkv6`` case at decays w = -exp(N(mu, 1)) against its plain
    version (each (b, h) row within 1e-4 of max(1, its max |plain|): the
    reasons are :func:`wkv6_kernel_cases`'), its time, the plain version's
    and its bound; returns the record."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wk
    dev = torch.device(DEVICE)
    r, k, v = (torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
               for _ in range(3))
    w = -torch.exp(torch.randn(B, S, H, hd, generator=gen, device=dev) + mu)
    u = torch.randn(H, hd, generator=gen, device=dev) * 0.5
    got = ops.wkv6(r, k, v, w, u)
    want = ref.wkv6_ref(r, k, v, w, u)
    torch.cuda.synchronize()
    case = (f"{'bf16' if dt == torch.bfloat16 else 'fp32'} r/k/v, "
            f"B={B} S={S} H={H} hd={hd}"
            + (", strong decay w=-exp(N(1,1))" if mu == 1 else ""))
    err = check_rows(f"wkv6[{case}]", *(
        t.permute(0, 2, 1, 3).reshape(B * H, S * hd) for t in (got, want)),
        1e-4, floor=1.0)
    if not bool(torch.isfinite(got).all()):
        fail(f"wkv6[{case}]: non-finite output")
    ms = gpu_ms(torch, lambda: ops.wkv6(r, k, v, w, u))
    plain = gpu_ms(torch, lambda: ref.wkv6_ref(r, k, v, w, u))
    n = B * S * H * hd
    nbytes = 3 * n * r.element_size() + 4 * n + 4 * H * hd + 4 * n
    # the chunked form's tensor-core products, per token and head: r̃·S and
    # the update Σ k̃ vᵀ (2hd² each), P·V over a chunk (2·C·hd)
    ops_n = (4 * hd * hd + 2 * wk.CHUNK * hd) * B * S * H
    return _record("wkv6", case, "src/repro_torch/kernels/csrc/wkv6.cu",
                   "src/repro/kernels/wkv6.py:47", err, ms, plain, None,
                   nbytes, ops_n, "tf32")


def family_train_kernel_cases(torch):
    """Phase 2/3's cases at phase 25's shard shapes (the limits of
    :func:`train_kernel_cases`, :func:`flash_case` and
    :func:`wkv6_kernel_cases`)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(25)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print("phase 2/3: lora_matmul, flash_attention and wkv6 at phase 25's "
          "shard shapes")
    recs = [lora_case(torch, gen, sms, dt, M, din, dout, P24_RANK)
            for dt, shapes in ((torch.bfloat16, LORA_FAMILY_TRAIN),
                               (torch.float32, LORA_FAMILY_TRAIN_FP32))
            for M, din, dout in shapes]
    recs += [flash_case(torch, gen, dt, B, S, S, H, K, hd, True, 0)
             for dt in (torch.bfloat16, torch.float32)
             for B, S, H, K, hd in FLASH_FAMILY_TRAIN]
    recs += [wkv6_case(torch, gen, dt, *WKV6_FAMILY_TRAIN)
             for dt in (torch.bfloat16, torch.float32)]
    return recs


@contextlib.contextmanager
def slab_moe(data: int, model: int):
    """Inside the block a mesh-less ``moe_fwd`` routes a batch as the
    reference's ``_moe_fwd_sharded`` does on a ``(data, model)`` mesh where
    it runs (the axis divides S, the experts cut): each slab of B/data
    rows by S/model positions on its own, at its own capacity, aux the
    slabs' mean.  Phase 25's one-process oracle of a MoE model; yields a
    counter of the (token, choice) picks that the slabs' capacities drop
    (each expert's picks in a slab beyond its slots)."""
    import torch
    from repro_torch.models import moe as Moe
    from repro_torch.topology.mesh import abstract_mesh
    from repro_torch.topology.train import expert_axes
    whole = Moe.moe_fwd
    mesh = abstract_mesh({"data": data, "model": model})
    drops = collections.Counter()

    def sliced(cfg, p, x, adapters=None, groups=0, use_kernel=False, tp=None):
        B, S, d = x.shape
        if (tp is not None or groups or model == 1 or S % model
                or not expert_axes(cfg, mesh)):
            return whole(cfg, p, x, adapters, groups, use_kernel, tp)
        h, w = B // data, S // model
        rows, auxes = [], []
        for q in range(data):
            cols = []
            for r in range(model):
                xs = x[q * h:(q + 1) * h, r * w:(r + 1) * w]
                y, a = whole(cfg, p, xs, adapters, use_kernel=use_kernel)
                top = Moe.router_scores(cfg, p["router"], xs.reshape(-1, d)
                                        ).topk(cfg.experts_per_token).indices
                load = torch.bincount(top.flatten(), minlength=cfg.num_experts)
                drops["picks"] += int((load - Moe._capacity(cfg, h * w)
                                       ).clamp(min=0).sum())
                cols.append(y)
                auxes.append(a)
            rows.append(torch.cat(cols, dim=1))
        return torch.cat(rows, dim=0), torch.stack(auxes).mean()

    Moe.moe_fwd = sliced
    try:
        yield drops
    finally:
        Moe.moe_fwd = whole


def p25_cfg(key: str, layers: int = 0, dtype: str = ""):
    """Phase 25's configs: ``launch.serve.CONFIGS``' six models of the
    other families at ``layers`` (DeepSeek-V3-L4 at 2: one dense MLA layer
    and its first MoE layer).  A bf16 MoE run keeps the published capacity
    factor 1.25, so its slabs drop picks and bf16's limits hold expert
    parallelism where capacity binds.  An fp32 MoE run takes f = E / k, so
    a slab's slots hold every one of its tokens and nothing is dropped
    (:func:`_p25_run` fails if a pick is): a random router sends most
    picks to a few experts, and where capacity binds a pick that fp32
    rounding flips at the top-k boundary moves every later pick of two
    experts' queues, which drops other tokens on the two sides
    (DeepSeek-V3's fp32 loss then differed by 3.5e-5 at 1.25, on an
    NVIDIA H100 80GB HBM3 at 700 W), beyond fp32's 1e-5.  The binding
    case in fp32 is held on the CPU against the reference's per-slab math
    (``tests/test_torch_train_sharded_families.py``)."""
    from repro_torch.launch.serve import CONFIGS
    cfg = CONFIGS[key][0]
    if layers:
        cfg = cfg.replace(num_layers=layers,
                          first_dense_layers=min(layers - 1,
                                                 cfg.first_dense_layers))
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    if cfg.num_experts and cfg.dtype == "float32":
        cfg = cfg.replace(moe_capacity_factor=cfg.num_experts
                          / cfg.experts_per_token)
    return cfg


# (label, config, layers, world, model, dtype, kernels, steps, rows, eval,
#  prefill): the bf16 runs at phase 25's depths, and each model at 2 layers
#  (zamba2 6: one shared-block application) in fp32 on both routes
# DeepSeek-V3-L4's fp32 run at one 512-token row: its slots for every
# token are (257, 256, 7168) fp32 a slab, 1.9 GB an exchange, beside each
# rank's 27 GB of fp32 weights (two rows would need 3.8 GB)
P25_FP32_ROWS = {"deepseek_v3_l4": 1}
P25_FP32_LAYERS = {"granite_moe_1b_a400m": 2, "deepseek_v3_l4": 2,
                   "rwkv6_1p6b": 2, "zamba2_1p2b": 6, "phi3_vision_4p2b": 2,
                   "musicgen_medium": 2}
P25_RUNS = tuple(
    run for label, key, layers, world, steps, ev in (
        ("(a)", "granite_moe_1b_a400m", 4, 4, 2, True),
        ("(b)", "deepseek_v3_l4", 4, 2, 1, False),
        ("(c)", "rwkv6_1p6b", 2, 2, 1, True),
        ("(d)", "zamba2_1p2b", 6, 2, 1, True),
        ("(e) phi-3-vision", "phi3_vision_4p2b", 4, 2, 1, True),
        ("(e) musicgen", "musicgen_medium", 6, 2, 1, True))
    for run in (
        (label, key, layers, world, 2, "", True, steps, 2, ev, ev),
        (f"{label} fp32 kernel", key, P25_FP32_LAYERS[key], world, 2,
         "float32", True, 1, P25_FP32_ROWS.get(key, 2), False, True),
        (f"{label} fp32 plain", key, P25_FP32_LAYERS[key], world, 2,
         "float32", False, 1, P25_FP32_ROWS.get(key, 2), False, True)))


def _p25_run(torch, run, mesh) -> dict:
    label, key, layers, world, model, dtype, uk, steps, rows, ev, pre = run
    from repro_torch.device import parity_mode
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    if dtype == "float32":
        parity_mode()
    cfg = p25_cfg(key, layers, dtype)
    oracle = (slab_moe(world // model, model) if mesh is None
              else contextlib.nullcontext(collections.Counter()))
    try:
        with oracle as drops:
            out = p24_side(torch, cfg, mesh, uk, steps, rows, ev, pre)
        if dtype == "float32" and drops["picks"]:
            fail(f"phase 25 {label}: a capacity of every slab's tokens "
                 f"dropped {drops['picks']} picks")
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def phase25(torch) -> tuple:
    """Phase 25: training with a ``model`` axis for MoE (expert parallelism
    over ``("data", "model")``), RWKV6, the Mamba2 hybrid and the front
    ends: every run's one-process side first in this process (a MoE
    model's slabs routed by :func:`slab_moe`), then a gloo world of 4
    ranks on cuda:0 for (a) and one of 2 for (b)-(e) (see the module
    docstring)."""
    from repro_torch.topology import spawn
    t_phase = time.perf_counter()
    print("phase 25: the one-process sides in this process")
    refs = {}
    for run in P25_RUNS:
        t0 = time.perf_counter()
        refs[run[0]] = _p25_run(torch, run, None)
        print(f"  {run[0]}: one process {time.perf_counter() - t0:.1f} s, "
              f"step {['%.1f' % x for x in refs[run[0]]['step_ms']]} ms")
    report, counts = {}, collections.Counter()
    import gc
    _INIT_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    for world in (4, 2):
        free, total = torch.cuda.mem_get_info()
        print(f"phase 25: before the world of {world}, this process holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} reserved; the card "
              f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
        t0 = time.perf_counter()
        ranks = spawn(train_rank, world, "gloo", DEVICE,
                      args=("25", world, DEVICE), timeout_s=900)
        print(f"phase 25: a gloo world of {world} ranks on cuda:0: "
              f"{time.perf_counter() - t0:.1f} s, spawn included")
        for run in P25_RUNS:
            if run[3] != world:
                continue
            report[run[0]] = train_compare(torch, "25", run, ranks,
                                           refs[run[0]])
            for c in ranks[0][run[0]]["launches"]:
                counts.update(c)
            for what in ("eval", "prefill"):
                counts.update(ranks[0][run[0]].get(f"{what}_launches", {}))
        del ranks
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 25: {report['phase_s']:.1f} s")
    del refs
    torch.cuda.empty_cache()
    return report, {k: v for k, v in counts.items() if v}


TRAIN_PHASES = {"24": (P24_RUNS, _p24_run), "25": (P25_RUNS, _p25_run)}
TRAIN_CFG = {"24": p24_cfg, "25": p25_cfg}


if __name__ == "__main__":
    main()
