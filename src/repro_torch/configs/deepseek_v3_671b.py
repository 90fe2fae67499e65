"""deepseek-v3-671b — MLA, 1 shared + 256 routed experts top-8, MTP.
[arXiv:2412.19437]  (a copy of ``repro.configs.deepseek_v3_671b``)

61L d_model=7168 128H (GQA kv=128 → MLA) d_ff=2048 vocab=129280,
MoE 256e top-8.  d_ff=2048 is the per-expert (and dense-layer)
intermediate size; the first 3 layers are dense, the remainder MoE with one
shared expert; MLA caches only the compressed latent (kv_lora_rank 512 + 64
RoPE dims) at decode.

``DENSE3`` is what the port serves: the published widths at depth 3, i.e.
the three dense MLA layers, plan ``[("mla_dense", 3), ("mla_moe", 0)]``.
Cuts from ``CONFIG``:
  * layers 4–61, the MoE layers (256 experts each, ~22.5 GB of experts per
    layer at bf16), are cut: the port has no MoE module yet;
  * ``mtp_depth`` stays 1 but is unused: decode never runs the MTP stream,
    in the reference either.
About 2.55 B parameters (per layer attention 187.1 M and MLP 44.0 M;
embedding plus head 1.85 B): 5.1 GB in bf16, 10.2 GB in fp32.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    router_sigmoid=True,
    router_aux_coef=0.001,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    source="arXiv:2412.19437",
)

SMOKE = CONFIG.replace(
    name="deepseek-v3-smoke", num_layers=3, d_model=256, num_heads=4,
    num_kv_heads=4, head_dim=64, d_ff=256, vocab_size=512,
    num_experts=4, experts_per_token=2, moe_d_ff=128, first_dense_layers=1,
    q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
    v_head_dim=32, dtype="float32",
)

DENSE3 = CONFIG.replace(name="deepseek-v3-dense3", num_layers=3)
