"""rwkv6-1.6b "Finch" — attention-free, data-dependent decay.
[arXiv:2404.05892]  (a copy of ``repro.configs.rwkv6_1p6b``)

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536, untied embeddings.
Time-mix heads are d_model / rwkv_head_dim = 32 heads of 64.  About
1.62 B parameters: 3.2 GB in bf16, 6.5 GB in fp32, so one H100 holds the
model whole and the port serves it at full depth.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # informational; time-mix heads = d / rwkv_head_dim
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    source="arXiv:2404.05892",
)

SMOKE = CONFIG.replace(
    name="rwkv6-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
    rwkv_head_dim=32, rwkv_decay_lora=16, dtype="float32",
)
