"""llama3.2-1b [dense] — [hf:meta-llama/Llama-3.2-1B; unverified]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-1b", family="dense", block_pattern="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=128256, d_head=64, rope_theta=5e5, tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
))
