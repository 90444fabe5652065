"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block every 6
layers, ssm_state=64 [arXiv:2411.15242; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b", family="hybrid", block_pattern="zamba2",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, d_head=80, ssm_state=64, ssm_headdim=64,
    zamba_attn_every=6, rope_theta=1e4,
    source="arXiv:2411.15242",
))
