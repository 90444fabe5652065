"""qwen3-8b [dense] — qk_norm + GQA [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-8b", family="dense", block_pattern="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288,
    vocab=151936, d_head=128, qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
))
