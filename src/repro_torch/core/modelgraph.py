"""The kernel-backed chain: a runnable OpGraph whose ops carry real
payload variant tables.

Port of ``repro.core.modelgraph.kernel_chain`` (the analytic
``model_op_graph`` of the model zoo waits for the zoo, ``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .op import FusedOp, OpGraph

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
