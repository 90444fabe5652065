"""stablelm-12b [dense] — [hf:stabilityai/stablelm-2-12b; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-12b", family="dense", block_pattern="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab=100352, d_head=160, rope_theta=1e4,
    source="hf:stabilityai/stablelm-2-12b",
))
