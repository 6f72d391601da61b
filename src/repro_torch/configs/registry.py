"""``--arch <id>`` registry for the assigned architectures."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
}

_CACHE: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    if arch not in _CACHE:
        import importlib
        _CACHE[arch] = importlib.import_module(_MODULES[arch]).CONFIG
    return _CACHE[arch]


def list_archs() -> List[str]:
    return sorted(_MODULES)
