"""Plain PyTorch oracles for every kernel in this package.

Ports of ``repro.kernels.ref``: the simplest dense form of each
kernel's semantics, the single source of truth the kernels, their plain
versions and the ``"ref"`` payload dialect are all held against.  Each
oracle computes in f32 and returns in the input's dtype, and runs on
whatever device its inputs lie on.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F_


def attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Dense softmax attention.  q (B,Tq,Hq,D); k/v (B,Tk,Hk,D), Hq%Hk==0.

    f32 scores/normalizer, output cast back to q.dtype."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hk, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hk
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Tq, Hk, G, D).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if causal:
        q_pos = q_offset + torch.arange(Tq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Tq, Hq, Dv).to(q.dtype)


def ssd_scan_ref(c, b, v, log_a, *, initial_state=None):
    """Sequential oracle: S_t = exp(log_a_t)*S_{t-1} + b_t v_t^T; y_t = c_t^T S_t.

    c, b: (B,T,H,N); v: (B,T,H,P); log_a: (B,T,H).
    Returns (y (B,T,H,P) in v.dtype, S_final (B,H,N,P) f32).  O(T)
    steps — slow but unambiguous; the chunked algebra must reproduce it."""
    B, T, H, N = b.shape
    P = v.shape[-1]
    S = (torch.zeros((B, H, N, P), dtype=torch.float32, device=v.device)
         if initial_state is None else initial_state.float())
    cf, bf, vf, la = c.float(), b.float(), v.float(), log_a.float()
    ys = []
    for t in range(T):
        S = S * torch.exp(la[:, t])[..., None, None]
        S = S + torch.einsum("bhn,bhp->bhnp", bf[:, t], vf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, t], S))
    return torch.stack(ys, dim=1).to(v.dtype), S


def moe_dispatch_combine_ref(x, gate_idx, gate_vals, w_up, w_down, *,
                             capacity: int):
    """Oracle for the fused MoE expert-apply with capacity dropping.

    x: (T, d) tokens; gate_idx/gate_vals: (T, K); w_up: (E, d, 2F);
    w_down: (E, F, d).  A (token, k) assignment beyond the expert's
    ``capacity`` (in first-come order over the flattened (t, k) stream)
    is dropped.  Returns (T, d) combined expert outputs."""
    T, d = x.shape
    K = gate_idx.shape[1]
    E = w_up.shape[0]
    onehot = F_.one_hot(gate_idx.long(), E).to(torch.int32)       # T,K,E
    flat = onehot.reshape(T * K, E)
    pos = (torch.cumsum(flat, dim=0, dtype=torch.int32) - flat).reshape(T, K, E)
    keep = (pos * onehot).sum(-1) < capacity                      # T,K

    xf = x.float()
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for e in range(E):
        g, u = (xf @ w_up[e].float()).chunk(2, dim=-1)
        y_e = (F_.silu(g) * u) @ w_down[e].float()
        w_e = ((gate_idx == e) * keep * gate_vals).sum(-1)          # T
        out = out + y_e * w_e[:, None]
    return out.to(x.dtype)
