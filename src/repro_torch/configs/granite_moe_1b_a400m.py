"""granite-moe-1b-a400m — 32 experts, top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]
(a copy of ``repro.configs.granite_moe_1b_a400m``)

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
(d_ff=512 is the per-expert intermediate size.)
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    router_aux_coef=0.01,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SMOKE = CONFIG.replace(
    name="granite-moe-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=128, vocab_size=512,
    num_experts=4, experts_per_token=2, moe_d_ff=128, dtype="float32",
)
