"""Blockwise causal GQA flash attention: the CUDA kernel and its plain
version.

Port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).  The
kernel (``csrc/flash_attention.cu``) owns one (batch, head, 64-row query
tile) per block and loops over 64-row kv tiles, with both products on
the tensor cores (3xTF32) and an online softmax in registers; its source
states the design and what bounds it.
:func:`flash_attention_plain` repeats the kernel's arithmetic tile by
tile in PyTorch (the same 64 x 64 tiles, mask, causal tile skip and
``l`` clamp), so the kernel can be held against it on the card and the
CPU path runs the same algorithm.
"""
from __future__ import annotations

import math

import torch

from . import _build

BLOCK_Q = 64
BLOCK_K = 64
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 160)


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, T, H, D)")
    B, Tq, Hq, D = q.shape
    Bk, Tk, Hk, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if Hq % Hk:
        raise ValueError(f"flash_attention: Hq={Hq} not a multiple of Hk={Hk}")
    return B, Tq, Hq, D, Tk, Hk, v.shape[-1]


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          q_offset: int = 0):
    """The kernel's algorithm in PyTorch: q (B,Tq,Hq,D), k/v (B,Tk,Hk,D)
    with Hq % Hk == 0; returns (B,Tq,Hq,Dv) in q.dtype."""
    B, Tq, Hq, D, Tk, Hk, Dv = _shapes(q, k, v)
    group = Hq // Hk
    scale = 1.0 / math.sqrt(D)
    qf = (q.float() * scale).transpose(1, 2)                   # B,Hq,Tq,D
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    out = torch.empty((B, Hq, Tq, Dv), dtype=torch.float32, device=q.device)
    for q0 in range(0, Tq, BLOCK_Q):
        qt = qf[:, :, q0:q0 + BLOCK_Q]
        q_pos = q_offset + q0 + torch.arange(qt.shape[2], device=q.device)
        m = torch.full(qt.shape[:3] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qt.shape[:3] + (Dv,), device=q.device)
        n_kv = -(-Tk // BLOCK_K)
        if causal:
            n_kv = min(n_kv, (q_offset + q0 + BLOCK_Q - 1) // BLOCK_K + 1)
        for k0 in range(0, n_kv * BLOCK_K, BLOCK_K):
            kt, vt = kf[:, :, k0:k0 + BLOCK_K], vf[:, :, k0:k0 + BLOCK_K]
            s = qt @ kt.transpose(-1, -2)
            if causal:
                k_pos = k0 + torch.arange(kt.shape[2], device=q.device)
                s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            m = m_new
            acc = acc * alpha + p @ vt
        out[:, :, q0:q0 + BLOCK_Q] = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Launch the CUDA kernel on the current stream of q's device.
    Takes f32 or bf16, contiguous, D == Dv in ``HEAD_DIMS``."""
    B, Tq, Hq, D, Tk, Hk, Dv = _shapes(q, k, v)
    _build.check_operands("flash_attention", q=(q, _build.FLOATS),
                          k=(k, (q.dtype,)), v=(v, (q.dtype,)))
    if D != Dv or D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes D == Dv in "
                         f"{HEAD_DIMS}, got D={D}, Dv={Dv}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset={q_offset} < 0")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), B, Tq, Tk, Hq, Hk, D,
                      int(causal), q_offset, int(q.dtype == torch.bfloat16),
                      stream)
    return o
