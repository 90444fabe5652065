"""Plain float32 attention and SSD scan, the building blocks of the
references.  Every product's operands pass through ``rnd`` (see
:mod:`chipbench.reference.precision`); sums are float32.  Both run in
blocks (queries, chunks) so that they fit beside nothing else on the
card at the cells' sizes."""
from __future__ import annotations

import math

import torch


def attention(q, k, v, *, rnd, causal: bool = True, q_offset: int = 0,
              block: int = 256):
    """Softmax attention.  q (B, Tq, Hq, D); k, v (B, Tk, Hk, D) with Hq a
    multiple of Hk (each kv head serves Hq / Hk consecutive q heads).
    Query i sits at key position ``q_offset + i``.  Returns float32
    (B, Tq, Hq, D)."""
    B, Tq, Hq, D = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    scale = 1.0 / math.sqrt(D)
    kf, vf = rnd(k.float()), rnd(v.float())
    keys = torch.arange(Tk, device=q.device)
    out = torch.empty((B, Tq, Hq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for s in range(0, Tq, block):
        e = min(s + block, Tq)
        qb = q[:, s:e].float().reshape(B, e - s, Hk, G, D) * scale
        sc = torch.einsum("bqhgd,bkhd->bhgqk", rnd(qb), kf)
        if causal:
            pos = q_offset + torch.arange(s, e, device=q.device)
            sc = sc.masked_fill(~(pos[:, None] >= keys[None, :]),
                                float("-inf"))
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", rnd(p), vf)
        out[:, s:e] = o.reshape(B, e - s, Hq, -1)
    return out


def ssd_scan(c, b, v, log_a, *, rnd, chunk: int):
    """The linear recurrence S_t = exp(log_a_t) S_{t-1} + b_t v_t^T,
    y_t = c_t^T S_t from a zero state, chunk by chunk: within a chunk the
    causal pairs' decayed scores, across chunks the carried state.
    c, b (B, T, H, N); v (B, T, H, P); log_a (B, T, H).  Returns float32
    (y (B, T, H, P), final state (B, H, N, P))."""
    B, T, H, N = b.shape
    P = v.shape[-1]
    S = torch.zeros((B, H, N, P), dtype=torch.float32, device=v.device)
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=v.device)
    for s in range(0, T, chunk):
        e = min(s + chunk, T)
        cg, bg, vg = (t[:, s:e].float() for t in (c, b, v))
        cum = torch.cumsum(log_a[:, s:e].float(), dim=1)          # (B,C,H)
        n = e - s
        ii = torch.arange(n, device=v.device)
        diff = cum[:, :, None, :] - cum[:, None, :, :]           # (B,C,C,H)
        diff = diff.masked_fill(~(ii[:, None] >= ii[None, :])[None, :, :,
                                                                 None],
                                float("-inf"))
        scores = torch.einsum("bihn,bjhn->bijh", rnd(cg), rnd(bg)) \
            * torch.exp(diff)
        yg = torch.einsum("bijh,bjhp->bihp", rnd(scores), rnd(vg))
        yg = yg + torch.einsum("bihn,bhnp->bihp", rnd(cg), rnd(S)) \
            * torch.exp(cum)[..., None]
        y[:, s:e] = yg
        w = torch.exp(cum[:, -1:] - cum)                          # (B,C,H)
        S = S * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bjhn,bjhp->bhnp", rnd(bg * w[..., None]), rnd(vg))
    return y, S
