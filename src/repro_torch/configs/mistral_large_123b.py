"""mistral-large-123b [dense] — [hf:mistralai/Mistral-Large-Instruct-2407]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-large-123b", family="dense", block_pattern="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab=32768, d_head=128, rope_theta=1e6,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
))
