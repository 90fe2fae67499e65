"""qwen3-4b — dense, qk_norm + GQA. [hf:Qwen/Qwen3-8B family]
(a copy of ``repro.configs.qwen3_4b``)

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = CONFIG.replace(
    name="qwen3-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, dtype="float32",
)
