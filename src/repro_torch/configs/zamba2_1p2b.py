"""zamba2-1.2b — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]
(a copy of ``repro.configs.zamba2_1p2b``)

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
The single shared attention(+MLP) block is stored once and applied after
every 6th Mamba2 layer (params shared across applications, Zamba-style).
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    source="arXiv:2411.15242",
)

SMOKE = CONFIG.replace(
    name="zamba2-smoke", num_layers=4, d_model=256, num_heads=4,
    num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512, attn_every=2,
    ssm_state=16, ssm_head_dim=32, dtype="float32",
)
