"""phi-3-vision-4.2b — phi3-mini LM backbone + CLIP vision frontend (stub).
(a copy of ``repro.configs.phi3_vision_4p2b``)

[hf:microsoft/Phi-3-vision-128k-instruct]  32L d_model=3072 32H (GQA kv=32)
d_ff=8192 vocab=32064.  The ViT/CLIP encoder + projector front-end is a STUB:
``input_specs()`` provides precomputed patch embeddings (576 patches of
dim 1024, CLIP ViT-L/14-336 penultimate features); the framework implements
the language decoder that consumes them plus a linear projector.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
    frontend="vision",
    frontend_dim=1024,
    num_patches=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE = CONFIG.replace(
    name="phi-3-vision-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
    frontend_dim=64, num_patches=8, dtype="float32",
)
