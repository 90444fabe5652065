"""qwen2-vl-72b [vlm] — M-RoPE backbone; patch frontend is a STUB
[arXiv:2409.12191; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b", family="vlm", block_pattern="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, d_head=128, mrope=True, mrope_sections=(16, 24, 24),
    modality_stub=True, rope_theta=1e6,
    source="arXiv:2409.12191",
))
