"""Model configuration dataclass + registry.

One ``<arch>.py`` per assigned architecture registers its exact published
config here; ``reduced()`` derives the CPU smoke-test variant of the same
family (small widths/layers/experts, identical code paths).

Port of ``repro.configs.base``, field for field; the reference's
``jdtype`` (a JAX dtype) is :attr:`ModelConfig.torch_dtype` here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

_REGISTRY: dict[str, "ModelConfig"] = {}


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str                      # dense | moe | audio | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    block_pattern: str = "dense"     # dense|moe|mla_moe|xlstm|zamba2|encdec
    d_head: int | None = None
    qk_norm: bool = False
    causal: bool = True
    rope_theta: float = 5e5
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)
    # --- MLA (deepseek) ---
    attn_type: str = "gqa"           # gqa | mla
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 8
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    moe_capacity_factor: float = 1.25
    moe_renorm: bool = True
    moe_group_size: int = 512       # dispatch-group tokens (shards over data)
    aux_loss_coef: float = 0.01
    # --- SSM / Mamba2 (zamba2) ---
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_headdim: int = 64
    zamba_attn_every: int = 6
    # --- xLSTM ---
    xlstm_expand: int = 2
    slstm_every: int = 2             # every 2nd block is sLSTM
    # --- enc-dec (seamless) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- frontends / heads ---
    modality_stub: bool = False      # inputs are precomputed embeddings
    mtp: bool = False                # deepseek multi-token prediction
    tie_embeddings: bool = False
    # --- numerics / chunking ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: bool = True
    # dispatch inference paths (prefill/decode) to the Pallas kernels;
    # training keeps the jnp reference (pallas_call has no implicit VJP)
    use_kernels: bool = False
    # --- provenance ---
    source: str = ""

    def __post_init__(self):
        if self.d_head is None:
            self.d_head = self.d_model // self.n_heads

    # derived SSM dims
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    @property
    def xlstm_d_inner(self) -> int:
        return self.xlstm_expand * self.d_model

    @property
    def slstm_ff(self) -> int:
        return 2 * self.d_model

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch supports long_500k (recurrent/hybrid state)."""
        return self.block_pattern in ("xlstm", "zamba2")

    def param_count(self) -> int:
        """Approximate parameter count (sanity checks + MODEL_FLOPS)."""
        d, dh = self.d_model, self.d_head
        def attn_params():
            if self.attn_type == "mla":
                return (d * self.q_lora_rank
                        + self.q_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                        + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                        + self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                        + self.n_heads * self.v_head_dim * d)
            return d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d

        def mlp_params(ff):
            return 3 * d * ff

        n = self.vocab * d  # embed
        if not self.tie_embeddings:
            n += self.vocab * d
        if self.block_pattern in ("dense", "moe", "mla_moe"):
            L = self.n_layers
            k_dense = self.first_k_dense if self.n_experts else L
            moe_layers = L - k_dense if self.n_experts else 0
            dense_layers = L - moe_layers
            n += dense_layers * (attn_params() + mlp_params(self.d_ff))
            if moe_layers:
                per_moe = (attn_params() + d * self.n_experts
                           + self.n_experts * mlp_params(self.moe_d_ff) / 1  # routed
                           + self.n_shared_experts * mlp_params(self.moe_d_ff))
                n += moe_layers * per_moe
        elif self.block_pattern == "encdec":
            per = attn_params() + mlp_params(self.d_ff)
            n += self.n_enc_layers * per
            n += self.n_dec_layers * (per + attn_params())  # + cross-attn
        elif self.block_pattern == "xlstm":
            di = self.xlstm_d_inner
            per_m = 2 * d * di + 3 * di * di + di * d
            per_s = 4 * d * d + d * (d // self.n_heads) * 4 + 3 * d * self.slstm_ff
            n += (self.n_layers // 2) * (per_m + per_s)
        elif self.block_pattern == "zamba2":
            di = self.ssm_d_inner
            conv_dim = di + 2 * self.ssm_state * self.ssm_groups
            per = (d * (2 * di + 2 * self.ssm_state * self.ssm_groups + self.ssm_heads)
                   + self.ssm_conv * conv_dim + di * d)
            n += self.n_layers * per
            n += attn_params()  # one shared attention block
        return int(n)

    def reduced(self) -> "ModelConfig":
        """Smoke-test config: same family/code paths, tiny sizes."""
        r = dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            moe_d_ff=64 if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2),
            moe_capacity_factor=8.0,   # no token drops in smoke tests
            moe_group_size=64,
            first_k_dense=min(self.first_k_dense, 1),
            q_lora_rank=32, kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            mrope_sections=(2, 3, 3) if self.mrope else self.mrope_sections,
            ssm_state=16, ssm_headdim=16, ssm_chunk=16,
            n_enc_layers=2 if self.n_enc_layers else 0,
            n_dec_layers=2 if self.n_dec_layers else 0,
            zamba_attn_every=2,
            q_chunk=32, kv_chunk=32,
            dtype="float32",
            remat=False,
        )
        if r.block_pattern == "zamba2":
            r = dataclasses.replace(r, n_layers=4)
        if r.block_pattern == "xlstm":
            r = dataclasses.replace(r, n_layers=4)
        return r


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import all config modules lazily
        from . import ALL_ARCHS  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from . import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)
