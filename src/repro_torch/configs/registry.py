"""Config registry of the architectures the port runs."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, reduced
from repro_torch.configs.deepseek_67b import CONFIG as deepseek_67b
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as llama4_maverick
from repro_torch.configs.llava_next_34b import CONFIG as llava_next_34b
from repro_torch.configs.minicpm3_4b import CONFIG as minicpm3_4b
from repro_torch.configs.mixtral_8x7b import CONFIG as mixtral_8x7b
from repro_torch.configs.qwen3_0_6b import CONFIG as qwen3_0_6b
from repro_torch.configs.qwen3_1_7b import CONFIG as qwen3_1_7b
from repro_torch.configs.whisper_base import CONFIG as whisper_base
from repro_torch.configs.xlstm_1_3b import CONFIG as xlstm_1_3b
from repro_torch.configs.zamba2_1_2b import CONFIG as zamba2_1_2b

CONFIGS = {
    c.name: c
    for c in (
        mixtral_8x7b,
        llama4_maverick,
        deepseek_67b,
        qwen3_1_7b,
        qwen3_0_6b,
        minicpm3_4b,
        llava_next_34b,
        zamba2_1_2b,
        whisper_base,
        xlstm_1_3b,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]


def get_reduced_config(name: str, **overrides) -> ArchConfig:
    return reduced(get_config(name), **overrides)


__all__ = ["CONFIGS", "get_config", "get_reduced_config"]
