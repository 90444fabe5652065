"""Analytic fused-operator graphs of the model zoo, and the kernel-backed
chain: a runnable OpGraph whose ops carry real payload variant tables.

Port of ``repro.core.modelgraph``.  ``model_op_graph(cfg, ...)`` is a
NumPy copy of the reference's and gives the same graph bit for bit: one
op per GEMM / attention / recurrence / router / norm-act cluster of a
``repro_torch.configs`` model, with exact operand shapes.  MoE layers
emit a fork/join phase (the shared-expert branch beside the routed one).
``kernel_chain`` builds the chain of the three kernels on torch tensors.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .op import FusedOp, OpGraph


def _mm(name: str, batch_tokens: int, d_in: int, d_out: int, dtb: int) -> FusedOp:
    return FusedOp(name=name, kind="matmul",
                   in_shapes=((batch_tokens, d_in), (d_in, d_out)),
                   out_shape=(batch_tokens, d_out), dtype_bytes=dtb)


def _norm(name: str, batch_tokens: int, d: int, dtb: int) -> FusedOp:
    return FusedOp(name=name, kind="norm", in_shapes=((batch_tokens, d),),
                   out_shape=(batch_tokens, d), dtype_bytes=dtb)


def _act(name: str, batch_tokens: int, d: int, dtb: int) -> FusedOp:
    return FusedOp(name=name, kind="act", in_shapes=((batch_tokens, d),),
                   out_shape=(batch_tokens, d), dtype_bytes=dtb)


def _attn(name: str, B: int, H: int, Tq: int, Tk: int, dh: int, dtb: int) -> FusedOp:
    op = FusedOp(name=name, kind="attention",
                 in_shapes=((B, H, Tq, dh), (B, H, Tk, dh)),
                 out_shape=(B, H, Tq, dh), dtype_bytes=dtb)
    # q read + K AND V read (the KV-cache stream that dominates decode) + out
    op.bytes_moved = float(dtb * B * H * (Tq * dh + 2 * Tk * dh + Tq * dh))
    return op


def _scan(name: str, B: int, T: int, H: int, N: int, P: int, dtb: int) -> FusedOp:
    # recurrent state update: flops ~ T x H x N x P MACs (x2) + gating
    op = FusedOp(name=name, kind="scan",
                 in_shapes=((B, T, H, N), (B, T, H, P)),
                 out_shape=(B, T, H, P), dtype_bytes=dtb)
    op.flops = 4.0 * B * T * H * N * P
    return op


def model_op_graph(cfg, *, kind: str = "train", batch: int = 8,
                   seq: int = 2048) -> OpGraph:
    """Fused-op DAG for one forward pass of ``cfg`` at (batch, seq).

    kind: "train"/"prefill" = full-sequence forward; "decode" = one token
    against a cache of ``seq`` (Tk = seq, Tq = 1).
    """
    dtb = 2 if cfg.dtype == "bfloat16" else 4
    B = batch
    Tq = 1 if kind == "decode" else seq
    Tk = seq
    NT = B * Tq                       # tokens processed this step
    d = cfg.d_model

    ops: list[FusedOp] = []
    edges: list[tuple[int, int]] = []
    tail: int | None = None           # index of the op new ops chain onto

    def add(op: FusedOp, after: int | Sequence[int] | None = "tail") -> int:
        nonlocal tail
        idx = len(ops)
        ops.append(op)
        if after == "tail":
            if tail is not None:
                edges.append((tail, idx))
        elif after is None:
            pass
        else:
            for a in (after if isinstance(after, (list, tuple)) else [after]):
                edges.append((a, idx))
        tail = idx
        return idx

    # embedding lookup
    add(FusedOp(name="embed", kind="embed",
                in_shapes=((cfg.vocab, d), (NT,)), out_shape=(NT, d),
                dtype_bytes=dtb))

    def gqa_layer(i: int, prefix: str = "") -> None:
        nonlocal tail
        add(_norm(f"{prefix}L{i}.ln1", NT, d, dtb))
        qkv = cfg.n_heads * cfg.d_head + 2 * cfg.n_kv_heads * cfg.d_head
        add(_mm(f"{prefix}L{i}.qkv", NT, d, qkv, dtb))
        add(_attn(f"{prefix}L{i}.attn", B, cfg.n_heads, Tq, Tk, cfg.d_head, dtb))
        add(_mm(f"{prefix}L{i}.o", NT, cfg.n_heads * cfg.d_head, d, dtb))

    def mla_layer(i: int) -> None:
        add(_norm(f"L{i}.ln1", NT, d, dtb))
        add(_mm(f"L{i}.q_a", NT, d, cfg.q_lora_rank, dtb))
        add(_mm(f"L{i}.q_b", NT, cfg.q_lora_rank,
                cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim), dtb))
        add(_mm(f"L{i}.kv_a", NT, d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtb))
        add(_mm(f"L{i}.kv_b", NT, cfg.kv_lora_rank,
                cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim), dtb))
        add(_attn(f"L{i}.attn", B, cfg.n_heads, Tq, Tk,
                  cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, dtb))
        add(_mm(f"L{i}.o", NT, cfg.n_heads * cfg.v_head_dim, d, dtb))

    def dense_mlp(i: int, prefix: str = "") -> None:
        add(_norm(f"{prefix}L{i}.ln2", NT, d, dtb))
        add(_mm(f"{prefix}L{i}.mlp_up", NT, d, 2 * cfg.d_ff, dtb))
        add(_act(f"{prefix}L{i}.mlp_act", NT, cfg.d_ff, dtb))
        add(_mm(f"{prefix}L{i}.mlp_down", NT, cfg.d_ff, d, dtb))

    def moe_mlp(i: int) -> None:
        """Router -> fork(routed branch || shared branch) -> join."""
        nonlocal tail
        add(_norm(f"L{i}.ln2", NT, d, dtb))
        fork = add(_mm(f"L{i}.router", NT, d, cfg.n_experts, 4))
        # routed branch: dispatch gather, expert GEMMs (active experts
        # only: top-k of tokens), combine scatter
        ff = cfg.moe_d_ff
        tok_k = NT * cfg.moe_top_k
        disp = add(FusedOp(name=f"L{i}.dispatch", kind="gather",
                           in_shapes=((NT, d), (tok_k,)),
                           out_shape=(tok_k, d), dtype_bytes=dtb), after=fork)
        add(_mm(f"L{i}.exp_up", tok_k, d, 2 * ff, dtb))
        add(_act(f"L{i}.exp_act", tok_k, ff, dtb))
        add(_mm(f"L{i}.exp_down", tok_k, ff, d, dtb))
        comb = add(FusedOp(name=f"L{i}.combine", kind="scatter",
                           in_shapes=((tok_k, d), (tok_k,)),
                           out_shape=(NT, d), dtype_bytes=dtb))
        join_srcs = [comb]
        if cfg.n_shared_experts:
            sh_up = add(_mm(f"L{i}.shared_up", NT, d,
                            2 * ff * cfg.n_shared_experts, dtb), after=fork)
            add(_act(f"L{i}.shared_act", NT, ff * cfg.n_shared_experts, dtb))
            sh_dn = add(_mm(f"L{i}.shared_down", NT,
                            ff * cfg.n_shared_experts, d, dtb))
            join_srcs.append(sh_dn)
        add(FusedOp(name=f"L{i}.moe_add", kind="add",
                    in_shapes=((NT, d),) * 2, out_shape=(NT, d),
                    dtype_bytes=dtb), after=join_srcs)

    def mamba_layer(i: int) -> None:
        di, H, N = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state
        P = di // H
        conv_dim = di + 2 * N * cfg.ssm_groups
        add(_norm(f"L{i}.ln1", NT, d, dtb))
        add(_mm(f"L{i}.in_proj", NT, d, 2 * di + 2 * N * cfg.ssm_groups
                + cfg.ssm_heads, dtb))
        add(FusedOp(name=f"L{i}.conv", kind="dwconv",
                    in_shapes=((B, Tq, conv_dim), (conv_dim, 1, cfg.ssm_conv, 1)),
                    out_shape=(B, Tq, conv_dim), dtype_bytes=dtb))
        add(_scan(f"L{i}.ssd", B, Tq, H, N, P, dtb))
        add(_norm(f"L{i}.gate_norm", NT, di, dtb))
        add(_mm(f"L{i}.out_proj", NT, di, d, dtb))

    def xlstm_pair(i: int) -> None:
        di = cfg.xlstm_d_inner
        H = cfg.n_heads
        dh = di // H
        add(_norm(f"L{i}.ln_m", NT, d, dtb))
        add(_mm(f"L{i}.m_up", NT, d, 2 * di, dtb))
        add(_mm(f"L{i}.m_qkv", NT, di, 3 * di, dtb))
        add(_scan(f"L{i}.mlstm", B, Tq, H, dh, dh + 1, dtb))
        add(_mm(f"L{i}.m_down", NT, di, d, dtb))
        add(_norm(f"L{i}.ln_s", NT, d, dtb))
        add(_mm(f"L{i}.s_in", NT, d, 4 * d, dtb))
        add(_scan(f"L{i}.slstm", B, Tq, H, d // H, d // H, dtb))
        add(_mm(f"L{i}.s_ff_up", NT, d, 2 * cfg.slstm_ff, dtb))
        add(_mm(f"L{i}.s_ff_down", NT, cfg.slstm_ff, d, dtb))

    bp = cfg.block_pattern
    if bp in ("dense", "moe"):
        for i in range(cfg.n_layers):
            gqa_layer(i)
            if bp == "moe":
                moe_mlp(i)
            else:
                dense_mlp(i)
    elif bp == "mla_moe":
        for i in range(cfg.n_layers):
            mla_layer(i)
            if i < cfg.first_k_dense:
                dense_mlp(i)
            else:
                moe_mlp(i)
    elif bp == "encdec":
        # encoder tower feeds decoder cross-attention; decoder self-attn
        # and encoder run as two towers joined at cross-attn (fork at embed)
        enc_T = seq
        enc_NT = B * enc_T
        root = tail
        enc_tail = root
        for i in range(cfg.n_enc_layers):
            tail_save = tail
            # encoder ops chain from enc_tail
            if i == 0:
                pass
            gqa_layer(i, prefix="enc.")
            dense_mlp(i, prefix="enc.")
        enc_end = tail
        for i in range(cfg.n_dec_layers):
            gqa_layer(i, prefix="dec.")
            add(_mm(f"dec.L{i}.xq", NT, d, cfg.n_heads * cfg.d_head, dtb))
            add(_attn(f"dec.L{i}.xattn", B, cfg.n_heads, Tq, enc_T,
                      cfg.d_head, dtb))
            add(_mm(f"dec.L{i}.xo", NT, cfg.n_heads * cfg.d_head, d, dtb))
            dense_mlp(i, prefix="dec.")
    elif bp == "xlstm":
        for i in range(cfg.n_layers // 2):
            xlstm_pair(i)
    elif bp == "zamba2":
        for i in range(cfg.n_layers):
            mamba_layer(i)
            if (i + 1) % cfg.zamba_attn_every == 0:
                gqa_layer(i, prefix="shared.")
    else:
        raise ValueError(bp)

    add(_norm("final_norm", NT, d, dtb))
    # prefill emits last-position logits only (cf. models.model.prefill)
    head_tokens = B if kind == "prefill" else NT
    add(_mm("lm_head", head_tokens, d, cfg.vocab, dtb))
    # terminal fused reduction: the CE loss (train) / argmax sample (decode)
    # fuses with the head matmul in XLA, so the inter-op tensor leaving the
    # head is (tokens, 1) — per-token NLL or sampled ids — NOT the full
    # logits.  Modeling it as a separate op with the fused-away input keeps
    # the exit D2H physical (gathering 260 GB of logits is not a thing any
    # real system does).
    add(FusedOp(name="loss" if kind == "train" else "sample", kind="add",
                in_shapes=((head_tokens, 1),), out_shape=(head_tokens, 1),
                dtype_bytes=4))
    return OpGraph(ops, edges=edges)


# The main path's full width: Granite-3.0-1B-A400M
# (src/repro/configs/granite_moe_1b.py: d_model 1024 = 16 heads x 64,
# 32 experts, top-8, moe_d_ff 512), with the SSD scan at Mamba-2's state
# and head dim as Zamba2-2.7B uses them (src/repro/configs/zamba2_2_7b.py:
# ssm_state=64, ssm_headdim=64).  float32, one sequence of 1024 tokens,
# two blocks; capacity works out to 256 slots per expert.
GRANITE_MAIN_PATH = dict(blocks=2, batch=1, seq=1024, heads=16, head_dim=64,
                         state=64, experts=32, top_k=8, moe_ff=512, chunk=64)

# the reference kernel_chain's defaults (a small chain); ``min_capacity``
# is the reference's MoE token tile ``block_m``, the floor of the
# per-expert capacity
CHAIN_DEFAULTS = dict(blocks=1, batch=1, seq=64, heads=2, head_dim=16,
                      state=8, experts=4, moe_ff=16, top_k=2, chunk=32,
                      min_capacity=16)


def chain_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run on the host")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _config(cfg: Mapping) -> dict:
    unknown = sorted(set(cfg) - set(CHAIN_DEFAULTS))
    if unknown:
        raise TypeError(f"kernel_chain: unknown config key(s) {unknown}; "
                        f"known: {sorted(CHAIN_DEFAULTS)}")
    return {**CHAIN_DEFAULTS, **cfg}


def chain_arrays(*, seed: int = 0, **cfg) -> dict[str, np.ndarray]:
    """The chain's input and weights as float32 NumPy arrays drawn from
    ``np.random.default_rng(seed)``, in the reference's draw order: x0,
    then per block j the attention k, v, the SSD c, b, log_a
    (-0.05 |N(0,1)|), and the MoE w_gate, w_up, w_down."""
    c = _config(cfg)
    B, T, H, D = c["batch"], c["seq"], c["heads"], c["head_dim"]
    N, E, F = c["state"], c["experts"], c["moe_ff"]
    d_model = H * D
    rng = np.random.default_rng(seed)

    def rnd(shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    arrays = {"x0": rnd((B, T, H, D))}
    for j in range(c["blocks"]):
        arrays[f"b{j}.attn.k"] = rnd((B, T, H, D), 0.5)
        arrays[f"b{j}.attn.v"] = rnd((B, T, H, D), 0.5)
        arrays[f"b{j}.ssd.c"] = rnd((B, T, H, N), 0.5)
        arrays[f"b{j}.ssd.b"] = rnd((B, T, H, N), 0.5)
        arrays[f"b{j}.ssd.log_a"] = np.float32(-0.05) * np.abs(rnd((B, T, H)))
        arrays[f"b{j}.moe.w_gate"] = rnd((d_model, E), 0.5)
        arrays[f"b{j}.moe.w_up"] = rnd((E, d_model, 2 * F), 0.5)
        arrays[f"b{j}.moe.w_down"] = rnd((E, F, d_model), 0.5)
    return arrays


def arrays_to_device(arrays: Mapping[str, np.ndarray], device
                     ) -> dict[str, torch.Tensor]:
    """NumPy arrays (e.g. the reference chain's weights) as tensors on
    ``device``."""
    device = torch.device(device)
    return {k: torch.tensor(a, device=device) for k, a in arrays.items()}


def kernel_chain(*, arrays: Mapping[str, np.ndarray] | None = None,
                 seed: int = 0, device=None, **cfg):
    """Kernel-backed zoo chain: each block is attention -> act -> SSD
    scan -> sort -> MoE -> act on a ``(batch, seq, heads, head_dim)``
    float32 activation — the three kernels interleaved with the
    host-affine glue the paper maps to the CPU (Fig. 2 classes).  Every
    op carries ``op.fn`` = the PyTorch oracle and ``op.variants`` =
    ``{"cuda": ...}`` for the kernels or ``{"numpy": ...}`` for the glue.

    ``cfg`` takes the keys of ``CHAIN_DEFAULTS`` (``GRANITE_MAIN_PATH``
    is the main path's full width).  ``arrays`` maps the names of
    :func:`chain_arrays` to NumPy arrays (to run the reference chain's
    weights); without it they are drawn from ``seed``.  The weights and
    the input live on ``device`` (default: the card; raises without
    one).  Returns ``(graph, external_inputs)`` with
    ``meta["example_inputs"]`` set on every op.
    """
    from ..kernels import payloads as kp

    c = _config(cfg)
    device = chain_device(device)
    if arrays is None:
        arrays = chain_arrays(seed=seed, **c)
    t = arrays_to_device(arrays, device)
    B, T, H, D = c["batch"], c["seq"], c["heads"], c["head_dim"]
    d_model = H * D
    tokens = B * T
    act_shape = (B, T, H, D)
    cap = -((-tokens * c["top_k"]) // c["experts"])            # ceil
    capacity = max(c["min_capacity"], -(-cap // 8) * 8)     # mult of 8
    x0 = t["x0"]
    ops: list[FusedOp] = []

    def add(name, kind, table, wrap=None):
        op = FusedOp(name=name, kind=kind, in_shapes=(act_shape,),
                     out_shape=act_shape, dtype_bytes=4)
        if wrap is not None:
            table = {k: wrap(fn) for k, fn in table.items()}
        kp.bind_variants(op, table, example_inputs=(x0,))
        ops.append(op)

    def tokenized(fn):
        def run(x):
            return fn(x.reshape(tokens, d_model)).reshape(act_shape)
        return run

    for j in range(c["blocks"]):
        add(f"b{j}.attn", "attention",
            kp.attention_payloads(t[f"b{j}.attn.k"], t[f"b{j}.attn.v"],
                                  causal=True))
        add(f"b{j}.gate", "act", kp.eltwise_payloads(1.0 + 0.25 * j))
        add(f"b{j}.ssd", "scan",
            kp.ssd_payloads(t[f"b{j}.ssd.c"], t[f"b{j}.ssd.b"],
                            t[f"b{j}.ssd.log_a"], chunk=min(c["chunk"], T)))
        add(f"b{j}.sort", "gather", kp.sort_payloads())
        add(f"b{j}.moe", "gather",
            kp.moe_payloads(t[f"b{j}.moe.w_gate"], t[f"b{j}.moe.w_up"],
                            t[f"b{j}.moe.w_down"], capacity=capacity,
                            top_k=c["top_k"]),
            wrap=tokenized)
        add(f"b{j}.out", "act", kp.eltwise_payloads(0.5))

    return OpGraph(ops), {0: (x0,)}
