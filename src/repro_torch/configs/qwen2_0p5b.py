"""qwen2-0.5b — dense, GQA kv=2, QKV bias, tied embeddings. [arXiv:2407.10671]
(a copy of ``repro.configs.qwen2_0p5b``)

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)

SMOKE = CONFIG.replace(
    name="qwen2-smoke", num_layers=2, d_model=224, num_heads=4,
    num_kv_heads=2, head_dim=56, d_ff=512, vocab_size=512, dtype="float32",
)
