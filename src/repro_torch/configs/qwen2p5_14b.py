"""qwen2.5-14b — dense, GQA + QKV bias. [hf:Qwen/Qwen2.5-0.5B family]
(a copy of ``repro.configs.qwen2p5_14b``)

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE = CONFIG.replace(
    name="qwen2.5-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, dtype="float32",
)
