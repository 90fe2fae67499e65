"""Model, LoRA, optimizer and federated configuration (a copy of
``repro.common.config``'s ``ModelConfig``, ``LoRAConfig``, ``OptimConfig``
and ``FedConfig``; the port keeps its own so that it never imports the JAX
package).  Field names and defaults match the reference, so a config prints
and compares the same in both packages; the port's dense path reads the
attention, MLP, numerics and LoRA fields."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (dense / moe / ssm / hybrid / vlm / audio)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False            # Qwen1.5/2/2.5 style
    qk_norm: bool = False             # Qwen3 style per-head RMSNorm on q,k
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # 0 = full attention; >0 = window size
    tie_embeddings: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    router_aux_coef: float = 0.0
    router_sigmoid: bool = False
    moe_capacity_factor: float = 1.25
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    frontend: str = ""
    frontend_dim: int = 0
    num_patches: int = 0
    num_codebooks: int = 0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 16.0
    targets: Sequence[str] = ("wq", "wk", "wv", "wo")
    dropout: float = 0.0


@dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"
    lr: float = 3e-4                  # paper: 0.0003
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    schedule: str = "constant"        # constant | cosine | linear
    warmup_steps: int = 0
    total_steps: int = 1000


@dataclass(frozen=True)
class FedConfig:
    """Federated fine-tuning setup (paper §4.1)."""
    num_clients: int = 100
    clients_per_round: int = 10
    num_rounds: int = 75
    local_epochs: int = 1
    local_steps: int = 0              # if >0, overrides epochs
    dirichlet_alpha: float = 0.5
    method: str = "florist"           # florist|fedit|ffa|flora|flexlora
    tau: float = 0.9                  # energy threshold
    heterogeneous: bool = False
    # paper's heavy-tail rank distribution: 40x4, 20x8, 20x16, 10x32, 10x64
    rank_distribution: Sequence[tuple] = ((4, 40), (8, 20), (16, 20), (32, 10), (64, 10))
    homogeneous_rank: int = 16
    zero_padding: bool = False        # HetLoRA zero-pad for fedit/ffa
    seed: int = 0

    def client_ranks(self) -> list:
        if not self.heterogeneous:
            return [self.homogeneous_rank] * self.num_clients
        ranks = []
        for r, count in self.rank_distribution:
            ranks += [r] * count
        if len(ranks) != self.num_clients:
            raise ValueError(f"rank_distribution covers {len(ranks)} clients, "
                             f"num_clients is {self.num_clients}")
        return ranks
