"""Assigned-architecture configs (one module per arch) + registry.

Port of ``repro.configs``: the same ten configurations.
"""
from .base import ModelConfig, get_config, list_configs, register  # noqa

from . import (llama3_2_1b, mistral_large_123b, qwen3_8b, stablelm_12b,   # noqa
               deepseek_v3_671b, granite_moe_1b, seamless_m4t_medium,
               qwen2_vl_72b, xlstm_125m, zamba2_2_7b)

ALL_ARCHS = [
    "llama3.2-1b", "mistral-large-123b", "qwen3-8b", "stablelm-12b",
    "deepseek-v3-671b", "granite-moe-1b-a400m", "seamless-m4t-medium",
    "qwen2-vl-72b", "xlstm-125m", "zamba2-2.7b",
]
