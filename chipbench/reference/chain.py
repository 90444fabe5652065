"""Plain reference of the kernel chain (``core.modelgraph.kernel_chain``):
a frozen copy of its math, op by op.

Each block is attention -> gate -> SSD scan -> sort -> MoE -> out on a
(batch, seq, heads, head_dim) float32 activation:

* attention: the activation is the query, k and v the block's own,
  causal;
* gate: tanh(x (1 + 0.25 j)) in block j; out: tanh(x / 2);
* SSD scan: the activation is v, c, b and log_a the block's own, from a
  zero state;
* sort: the flattened activation sorted ascending, in its shape;
* MoE on the (tokens, heads x head_dim) rows: softmax of x w_gate, the
  top-k experts by a stable descending sort (ties to the lower index),
  their weights renormalised; a (token, k) assignment beyond its
  expert's capacity, in first-come order over the flattened (token, k)
  stream, is dropped; each kept pair adds its weight times
  (silu(x W_g) * (x W_u)) W_d, with w_up's first F columns the gate.

The weights are named as ``chain_arrays`` names them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import attention, ssd_scan

OPS = ("attn", "gate", "ssd", "sort", "moe", "out")
# the ops before the first MoE: up to there the routing, which a
# reordering of float32 sums can flip, has not yet acted
BEFORE_FIRST_MOE = OPS.index("moe")


def capacity(cfg: dict) -> int:
    """Slots per expert: ceil(tokens x top_k / experts), rounded up to a
    multiple of 8, at least ``min_capacity`` (16 by default)."""
    tokens = cfg["batch"] * cfg["seq"]
    cap = -((-tokens * cfg["top_k"]) // cfg["experts"])
    return max(cfg.get("min_capacity", 16), -(-cap // 8) * 8)


def routing(x, w_gate, top_k: int, cap: int, rnd):
    """(expert index (T, K), renormalised weight (T, K), kept (T, K)) of
    the tokens ``x`` (T, d)."""
    probs = torch.softmax(rnd(x.float()) @ rnd(w_gate.float()), dim=-1)
    gv, gi = torch.sort(probs, dim=-1, descending=True, stable=True)
    gv, gi = gv[:, :top_k], gi[:, :top_k]
    gv = gv / gv.sum(-1, keepdim=True)
    E = w_gate.shape[1]
    onehot = F.one_hot(gi, E).to(torch.int32)                    # T,K,E
    flat = onehot.reshape(-1, E)
    pos = (torch.cumsum(flat, 0, dtype=torch.int32) - flat).reshape(
        onehot.shape)
    kept = (pos * onehot).sum(-1) < cap
    return gi, gv, kept


def moe(x, w_gate, w_up, w_down, *, top_k: int, cap: int, rnd):
    """The routed MoE of tokens ``x`` (T, d); float32 (T, d)."""
    gi, gv, kept = routing(x, w_gate, top_k, cap, rnd)
    xf = x.float()
    Fh = w_down.shape[1]
    out = torch.zeros_like(xf)
    for e in range(w_up.shape[0]):
        t, k = torch.nonzero((gi == e) & kept, as_tuple=True)
        if t.numel() == 0:
            continue
        h = rnd(xf[t]) @ rnd(w_up[e].float())
        act = F.silu(h[:, :Fh]) * h[:, Fh:]
        y = rnd(act) @ rnd(w_down[e].float())
        out.index_add_(0, t, y * gv[t, k][:, None])
    return out


def op(cfg: dict, weights: dict, j: int, name: str, x, rnd):
    """Op ``name`` of block ``j`` on the activation ``x``."""
    w = {k.split(".", 1)[1]: v for k, v in weights.items()
         if k.startswith(f"b{j}.")}
    if name == "attn":
        return attention(x, w["attn.k"], w["attn.v"], rnd=rnd, causal=True)
    if name == "gate":
        return torch.tanh(x.float() * (1.0 + 0.25 * j))
    if name == "ssd":
        y, _ = ssd_scan(w["ssd.c"], w["ssd.b"], x, w["ssd.log_a"], rnd=rnd,
                        chunk=min(cfg["chunk"], cfg["seq"]))
        return y
    if name == "sort":
        return torch.sort(x.float().reshape(-1)).values.reshape(x.shape)
    if name == "moe":
        B, T, H, D = x.shape
        y = moe(x.reshape(B * T, H * D), w["moe.w_gate"], w["moe.w_up"],
                w["moe.w_down"], top_k=cfg["top_k"], cap=capacity(cfg),
                rnd=rnd)
        return y.reshape(x.shape)
    if name == "out":
        return torch.tanh(x.float() * 0.5)
    raise ValueError(name)


def op_names(cfg: dict) -> list[tuple[int, str]]:
    return [(j, name) for j in range(cfg["blocks"]) for name in OPS]


def chained(cfg: dict, weights: dict, x0, n_ops: int, rnd) -> list:
    """The reference's own output of the first ``n_ops`` ops, the first
    fed the request's input ``x0`` and each later one the reference's
    output of the op before it."""
    ref, x = [], x0
    for j, name in op_names(cfg)[:n_ops]:
        x = op(cfg, weights, j, name, x, rnd)
        ref.append(x)
    return ref


def follow(cfg: dict, weights: dict, x0, outs: list, rnd) -> list:
    """The reference's output of every op, each op fed the program's
    output of the op before it (``outs``, in op order) and the first op
    the request's input ``x0``."""
    ref = []
    for i, (j, name) in enumerate(op_names(cfg)):
        x = x0 if i == 0 else outs[i - 1]
        ref.append(op(cfg, weights, j, name, x, rnd))
    return ref
