"""seamless-m4t-medium [audio] — enc-dec backbone; modality frontend is a
STUB (input_specs() provides precomputed frame embeddings)
[arXiv:2308.11596; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium", family="audio", block_pattern="encdec",
    n_layers=24, n_enc_layers=12, n_dec_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, d_head=64, modality_stub=True, rope_theta=1e4,
    source="arXiv:2308.11596",
))
