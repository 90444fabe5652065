"""Operations and bytes of the port's work, from shapes alone.

The yardstick of every roofline share and every ``mfu`` metric.  Each
count is of the work the computation needs, whatever implements it:

* an input byte is read once and an output byte written once;
* attention and the SSD scan count the causal (query, key) pairs only;
* the expert GLU counts ``6 d F`` operations for each (token, expert)
  pair that the capacity keeps, and reads the weights of the experts
  that receive a token;
* a matrix product of (m, k) by (k, n) is ``2 m k n`` operations;
  elementwise work (norms, gates, activations, sorts) is not counted.

The peaks are those of one NVIDIA H100 SXM (dense, data sheet): bf16
work is divided by the bf16 peak, float32 work by the TF32 peak, which
no float32-accurate design on this card can pass, and bytes by the HBM3
bandwidth.
"""
from __future__ import annotations

PEAK_BF16 = 989e12       # operations a second
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12     # bytes a second

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def peak_ops(dtype: str) -> float:
    """The peak that work in ``dtype`` is divided by."""
    return {"float32": PEAK_TF32, "bfloat16": PEAK_BF16}[dtype]


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the dtype's peak and the bytes over the bandwidth."""
    return max(ops / peak_ops(dtype), nbytes / PEAK_BYTES)


def matmul_ops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def causal_pairs(tq: int, tk: int) -> int:
    """(query, key) pairs with key <= query when the tq queries are the
    last tq positions of tk."""
    return tq * (tk - tq) + tq * (tq + 1) // 2


def attention(B: int, Tq: int, Tk: int, Hq: int, Hkv: int, D: int,
              dtype: str) -> tuple[int, int]:
    """(operations, bytes) of causal attention: q k^T and p v over the
    causal pairs, 2 D operations each; q, k, v read and o written."""
    ops = 4 * D * causal_pairs(Tq, Tk) * B * Hq
    nbytes = DTYPE_BYTES[dtype] * B * D * (2 * Tq * Hq + 2 * Tk * Hkv)
    return ops, nbytes


def ssd_scan(B: int, T: int, H: int, N: int, P: int, chunk: int,
             dtype: str) -> tuple[int, int]:
    """(operations, bytes) of the chunked SSD scan of B x H sequences of T
    steps: in each chunk of c steps, c b^T and the decayed scores times v
    over its c (c + 1) / 2 causal pairs, the chunk's state (b w)^T v and
    the carried state's term c S over its c steps.  c, b and v are read
    in ``dtype``, log_a in float32; y is written in ``dtype`` and the
    final state in float32."""
    ops = 0
    for start in range(0, T, chunk):
        c = min(chunk, T - start)
        pairs = c * (c + 1) // 2
        ops += 2 * pairs * (N + P) + 4 * c * N * P
    ops *= B * H
    db = DTYPE_BYTES[dtype]
    nbytes = (db * B * T * H * (2 * N + 2 * P) + 4 * B * T * H
              + 4 * B * H * N * P)
    return ops, nbytes


def expert_glu(kept: int, experts_used: int, d: int, F: int,
               dtype: str) -> tuple[int, int]:
    """(operations, bytes) of the expert GLU over ``kept`` (token, expert)
    pairs: each pair's row read and written, the up (d x 2F) and down
    (F x d) weights of ``experts_used`` experts read."""
    ops = 6 * d * F * kept
    nbytes = DTYPE_BYTES[dtype] * (2 * kept * d + experts_used * 3 * d * F)
    return ops, nbytes


# ---------------------------------------------------------------------------
# the chain (core.modelgraph.kernel_chain)
# ---------------------------------------------------------------------------

def chain_block_ops(cfg: dict, kept: int) -> dict[str, int]:
    """Operations of one block of the chain at ``cfg`` (the keys of
    ``GRANITE_MAIN_PATH``), with ``kept`` routed pairs in its MoE."""
    B, T, H, D = cfg["batch"], cfg["seq"], cfg["heads"], cfg["head_dim"]
    d = H * D
    return {
        "attention": attention(B, T, T, H, H, D, "float32")[0],
        "ssd_scan": ssd_scan(B, T, H, cfg["state"], D, min(cfg["chunk"], T),
                             "float32")[0],
        "router": matmul_ops(B * T, d, cfg["experts"]),
        "expert_glu": expert_glu(kept, cfg["experts"], d, cfg["moe_ff"],
                                 "float32")[0],
    }


# ---------------------------------------------------------------------------
# the Zamba2 language model (models.model, block pattern "zamba2")
# ---------------------------------------------------------------------------

def _mamba_dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    di = cfg["ssm_expand"] * d
    H = di // cfg["ssm_headdim"]
    N, G = cfg["ssm_state"], cfg["ssm_groups"]
    conv_dim = di + 2 * N * G
    return dict(d=d, di=di, H=H, N=N, P=cfg["ssm_headdim"],
                conv_dim=conv_dim, proj=di + conv_dim + H)


def zamba2_layer_ops(cfg: dict, B: int, T: int) -> int:
    """Operations of one Mamba-2 layer over B sequences of T tokens from
    an empty state: the input projection, the depthwise conv, the scan,
    the output projection."""
    m = _mamba_dims(cfg)
    tokens = B * T
    return (matmul_ops(tokens, m["d"], m["proj"])
            + 2 * tokens * m["conv_dim"] * cfg["ssm_conv"]
            + ssd_scan(B, T, m["H"], m["N"], m["P"], cfg["ssm_chunk"],
                       cfg["dtype"])[0]
            + matmul_ops(tokens, m["di"], m["d"]))


def zamba2_attention_ops(cfg: dict, B: int, Tq: int, Tk: int) -> int:
    """Operations of one use of the shared attention block: the q, k, v
    and o projections of Tq tokens and causal attention over Tk keys."""
    d, H, Hkv, D = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["d_head"])
    proj = (matmul_ops(B * Tq, d, H * D) + 2 * matmul_ops(B * Tq, d, Hkv * D)
            + matmul_ops(B * Tq, H * D, d))
    return proj + attention(B, Tq, Tk, H, Hkv, D, cfg["dtype"])[0]


def _attention_uses(cfg: dict) -> int:
    return cfg["n_layers"] // cfg["zamba_attn_every"]


def zamba2_prefill_ops(cfg: dict, B: int, T: int) -> int:
    """Operations of a prefill of B prompts of T tokens: every layer,
    every use of the shared block, and the head at the last position."""
    return (cfg["n_layers"] * zamba2_layer_ops(cfg, B, T)
            + _attention_uses(cfg) * zamba2_attention_ops(cfg, B, T, T)
            + matmul_ops(B, cfg["d_model"], cfg["vocab"]))


def zamba2_decode_ops(cfg: dict, B: int, length: int) -> int:
    """Operations of one decode step of B sequences whose new token is at
    position ``length`` (0-based): the layers' projections, conv and state
    update (b v^T and c S over N x P), the shared block over length + 1
    keys, and the head."""
    m = _mamba_dims(cfg)
    layer = (matmul_ops(B, m["d"], m["proj"])
             + 2 * B * m["conv_dim"] * cfg["ssm_conv"]
             + 4 * B * m["H"] * m["N"] * m["P"]
             + matmul_ops(B, m["di"], m["d"]))
    return (cfg["n_layers"] * layer
            + _attention_uses(cfg) * zamba2_attention_ops(
                cfg, B, 1, length + 1)
            + matmul_ops(B, cfg["d_model"], cfg["vocab"]))
