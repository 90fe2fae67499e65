"""Model configurations the port runs (copies of the reference's modules
under ``repro.configs``), the name registry of the reference's
``get_config`` / ``get_smoke_config``, and the per-family LoRA target
defaults (a copy of ``repro.configs.lora_targets``)."""
from __future__ import annotations

import importlib

from repro_torch.common.config import ModelConfig

#: the reference's architectures that the port carries
PORTED = ("tinyllama_1p1b", "llama3p2_1b", "rwkv6_1p6b", "deepseek_v3_671b",
          "qwen1p5_32b", "qwen3_4b", "qwen2p5_14b", "qwen2_0p5b",
          "granite_moe_1b_a400m", "phi3_vision_4p2b", "musicgen_medium",
          "zamba2_1p2b")

_ALIAS = {
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "qwen1.5-32b": "qwen1p5_32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-4b": "qwen3_4b",
    "qwen2.5-14b": "qwen2p5_14b",
    "qwen2-0.5b": "qwen2_0p5b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "musicgen-medium": "musicgen_medium",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "llama-3.2-1b": "llama3p2_1b",
}


def _module(name: str):
    mod_name = _ALIAS.get(name, name)
    if mod_name not in PORTED:
        raise ValueError(f"unknown config {name!r} (ported: {list(PORTED)})")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def lora_targets(cfg: ModelConfig) -> tuple:
    """Default LoRA target modules per family (paper: attention q/k/v/o;
    adapted for attention-free / hybrid / MLA families)."""
    if cfg.use_mla:
        return ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")
    if cfg.family == "ssm":
        return ("wr", "wk", "wv", "wg", "wo")
    if cfg.family == "hybrid":
        return ("wq", "wk", "wv", "wo", "in_proj", "out_proj")
    return ("wq", "wk", "wv", "wo")
