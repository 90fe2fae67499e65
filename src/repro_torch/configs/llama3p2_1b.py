"""LLaMA-3.2-1B — the paper's second experimental model. [ai.meta.com Llama 3.2]

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="Llama 3.2 model card (paper §4.1)",
)

SMOKE = CONFIG.replace(
    name="llama3.2-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, dtype="float32",
)
