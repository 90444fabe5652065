"""xlstm-125m [ssm] — alternating mLSTM/sLSTM blocks [arXiv:2405.04517]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m", family="ssm", block_pattern="xlstm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, d_head=192, tie_embeddings=True,
    source="arXiv:2405.04517",
))
