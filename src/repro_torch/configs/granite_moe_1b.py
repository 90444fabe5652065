"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m", family="moe", block_pattern="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, d_head=64, n_experts=32, moe_top_k=8, moe_d_ff=512,
    n_shared_experts=0, first_k_dense=0, rope_theta=1e4,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
