"""TinyLlama-1.1B — the paper's primary experimental model. [arXiv:2401.02385]
(a copy of ``repro.configs.tinyllama_1p1b``)

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    source="arXiv:2401.02385 (paper §4.1)",
)

SMOKE = CONFIG.replace(
    name="tinyllama-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, dtype="float32",
)
