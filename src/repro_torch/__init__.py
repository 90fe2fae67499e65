"""PyTorch + CUDA port of the FLoRIST reproduction for one NVIDIA H100.

``repro`` (JAX, Pallas kernels for the TPU) is the reference; this package
mirrors its module names so each counterpart is easy to find.  It imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro``.

The port so far covers the multi-tenant serving path: a dense GQA decoder
(``models``), the per-slot ring KV cache (``serve.kvcache``), paged LoRA
adapters (``peft.lora``, ``serve.adapters``), the continuous-batching
``serve.engine.ServeEngine``, and two hand-written CUDA kernels for Hopper
(``kernels/csrc``): ring flash-decoding and the batched-gather LoRA delta.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`).
"""
