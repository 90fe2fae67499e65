"""qwen1.5-32b — dense, QKV bias. [hf:Qwen/Qwen1.5-0.5B family scaling]
(a copy of ``repro.configs.qwen1p5_32b``)

64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)

SMOKE = CONFIG.replace(
    name="qwen1.5-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512, dtype="float32",
)
