"""PyTorch + CUDA port of the FLoRIST reproduction for one NVIDIA H100.

``repro`` (JAX, Pallas kernels for the TPU) is the reference; this package
mirrors its module names so each counterpart is easy to find.  It imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro``.

The port so far covers two paths.  Serving: a dense GQA decoder
(``models``), the per-slot ring KV cache (``serve.kvcache``), paged LoRA
adapters (``peft.lora``, ``serve.adapters``) and the continuous-batching
``serve.engine.ServeEngine``.  The federated round: LoRA train and eval
steps (``train``, ``optim``), the FLoRIST SVD pipeline and aggregator
(``core.svd``, ``core.aggregators``), the round runtime and
``core.federated.FederatedTrainer``.  Five hand-written CUDA kernels for
Hopper (``kernels/csrc``) carry them: ring flash-decoding and the
batched-gather LoRA delta (serving); the fused LoRA projection, flash
attention and the batched Gram product (the round).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`).
"""
