"""Model configurations the port serves, and the per-family LoRA target
defaults (a copy of ``repro.configs.lora_targets``)."""
from __future__ import annotations

from repro_torch.common.config import ModelConfig


def lora_targets(cfg: ModelConfig) -> tuple:
    """Default LoRA target modules per family (paper: attention q/k/v/o;
    adapted for attention-free / hybrid / MLA families).  Families the port
    does not run yet raise where their models are built."""
    if cfg.use_mla:
        return ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")
    if cfg.family == "ssm":
        return ("wr", "wk", "wv", "wg", "wo")
    if cfg.family == "hybrid":
        return ("wq", "wk", "wv", "wo", "in_proj", "out_proj")
    return ("wq", "wk", "wv", "wo")
