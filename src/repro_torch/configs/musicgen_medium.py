"""musicgen-medium — decoder-only over EnCodec tokens. [arXiv:2306.05284]
(a copy of ``repro.configs.musicgen_medium``)

48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048.  The EnCodec
conv-codec frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (sum of the 4 codebook embeddings, delay-pattern applied) of dim
1024; decode emits codebook-token logits (vocab 2048).
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio",
    frontend_dim=1024,
    num_codebooks=4,
    source="arXiv:2306.05284",
)

SMOKE = CONFIG.replace(
    name="musicgen-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=256,
    frontend_dim=64, dtype="float32",
)
