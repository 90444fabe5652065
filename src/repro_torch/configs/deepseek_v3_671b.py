"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b", family="moe", block_pattern="mla_moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,           # dense-layer FFN width (first_k_dense layers)
    vocab=129280, attn_type="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_experts=256, moe_top_k=8, moe_d_ff=2048, n_shared_experts=1,
    first_k_dense=3, mtp=True, rope_theta=1e4,
    source="arXiv:2412.19437",
))
