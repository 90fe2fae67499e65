"""Model, LoRA, optimizer and federated configuration (a copy of
``repro.common.config``'s ``ModelConfig``, ``LoRAConfig``, ``OptimConfig``
and ``FedConfig``; the port keeps its own so that it never imports the JAX
package).  Field names and defaults match the reference, so a config prints
and compares the same in both packages; the port reads the attention, MLA,
RWKV, MLP, numerics and LoRA fields."""
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

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def num_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def num_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic total parameter count (embedding + blocks + head), the
        reference's formula (Table 3's Full-FT row)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        n = V * d                      # embedding
        if not self.tie_embeddings:
            n += d * V                 # lm head
        n += d                         # final norm
        per_layer = 2 * d              # ln1, ln2
        if self.family == "ssm":       # rwkv6 block
            hd = self.rwkv_head_dim
            per_layer += 5 * d * d + d * d          # r,k,v,g,o + w proj
            per_layer += 2 * self.rwkv_decay_lora * d * 5   # ddlerp loras
            per_layer += 2 * (d // hd) * hd          # time_first/decay base
            per_layer += d * ff + ff * d + d * d     # channel mix
        else:
            per_layer += self._attn_params()
            per_layer += self._mlp_params()
        n += L * per_layer
        if self.family == "hybrid":
            # shared attention block counted once, not per layer
            n -= L * self._attn_params()
            n += self._attn_params() + 2 * self.d_model
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        if self.use_mla:
            qr, kvr = self.q_lora_rank, self.kv_lora_rank
            nope, rope, vd = (self.qk_nope_head_dim, self.qk_rope_head_dim,
                              self.v_head_dim)
            H = self.num_heads
            return (d * qr + qr * H * (nope + rope)
                    + d * (kvr + rope) + kvr * H * (nope + vd)
                    + H * vd * d + qr + kvr)
        H, K, hd = self.num_heads, self.num_kv_heads, self.head_dim
        n = d * H * hd + 2 * d * K * hd + H * hd * d
        if self.qkv_bias:
            n += H * hd + 2 * K * hd
        if self.qk_norm:
            n += 2 * hd
        return n

    def _mlp_params(self) -> int:
        d, ff = self.d_model, self.d_ff
        dense = 3 * d * ff            # swiglu gate/up/down
        if self.num_experts:
            e_ff = self.moe_d_ff or ff
            moe = self.num_experts * 3 * d * e_ff + d * self.num_experts
            moe += self.num_shared_experts * 3 * d * e_ff
            # deepseek: first_dense_layers use the dense MLP; average it in
            if self.first_dense_layers:
                frac = self.first_dense_layers / self.num_layers
                return int(frac * dense + (1 - frac) * moe)
            return moe
        return dense

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: only its top-k routed
        experts), the reference's formula."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        e_ff = self.moe_d_ff or self.d_ff
        moe_layers = L - self.first_dense_layers
        all_expert = moe_layers * self.num_experts * 3 * d * e_ff
        active_expert = (all_expert // self.num_experts) * self.experts_per_token
        return self.param_count() - all_expert + active_expert


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
