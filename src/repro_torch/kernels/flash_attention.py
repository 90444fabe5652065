"""Blockwise causal GQA flash attention: the CUDA kernel and its plain
version.

Port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).  The
kernel (``csrc/flash_attention.cu``) has two designs, both with an online
softmax in registers; its source states each and what bounds it.  f32:
one block a (batch, head, 64-row query tile), looping over 64-row kv
tiles, both products in 3xTF32 ``mma.sync``.  bf16: warp-specialised
``wgmma`` fed by TMA, 128-row query tiles, kv tiles of
:func:`bf16_kv_tile` rows, the 1/sqrt(D) scale (with log2(e)) on S after
the product, and P kept above bf16 as two bf16 terms.
:func:`flash_attention_plain` repeats the kernel's arithmetic tile by
tile in PyTorch (the same tiles, mask, causal tile skip, ``l`` clamp, and
for bf16 the scale on S, base-2 exponentials and P's two terms), so the
kernel can be held against it on the card and the CPU path runs the same
algorithm.  :func:`bf16_ulps` measures a bf16 result in bf16 ulps of a
reference.
"""
from __future__ import annotations

import math

import torch

from . import _build

BLOCK_Q = 64
BLOCK_K = 64
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 160)
LOG2E = math.log2(math.e)


def bf16_kv_tile(D: int) -> int:
    """kv rows a tile of the bf16 kernel (``wg::kv_tile`` in the source)."""
    return 64 if D == 128 else 32


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
    bf16 = q.dtype == torch.bfloat16
    if bf16:   # scale (and log2(e)) on S after the product; p by exp2
        scale = torch.tensor(LOG2E / math.sqrt(D), dtype=torch.float32)
        qf, exp, block_k = q.float(), torch.exp2, bf16_kv_tile(D)
    else:      # q scaled before the product; p by exp
        qf, exp, block_k = q.float() * (1.0 / math.sqrt(D)), torch.exp, \
            BLOCK_K
    qf = qf.transpose(1, 2)                                    # B,Hq,Tq,D
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    out = torch.empty((B, Hq, Tq, Dv), dtype=torch.float32, device=q.device)
    for q0 in range(0, Tq, BLOCK_Q):
        qt = qf[:, :, q0:q0 + BLOCK_Q]
        q_pos = q_offset + q0 + torch.arange(qt.shape[2], device=q.device)
        m = torch.full(qt.shape[:3] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qt.shape[:3] + (Dv,), device=q.device)
        n_kv = -(-Tk // block_k)
        if causal:
            n_kv = min(n_kv, (q_offset + q0 + BLOCK_Q - 1) // block_k + 1)
        for k0 in range(0, n_kv * block_k, block_k):
            kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
            s = qt @ kt.transpose(-1, -2)
            if bf16:
                s = s * scale
            if causal:
                k_pos = k0 + torch.arange(kt.shape[2], device=q.device)
                s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = exp(m - m_new)
            p = exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            m = m_new
            if bf16:   # P V with P as its bf16 terms hi + lo
                hi = p.to(torch.bfloat16).float()
                lo = (p - hi).to(torch.bfloat16).float()
                acc = acc * alpha + hi @ vt + lo @ vt
            else:
                acc = acc * alpha + p @ vt
        out[:, :, q0:q0 + BLOCK_Q] = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def bf16_ulps(got, ref) -> float:
    """The largest ``|got - ref|`` in bf16 ulps, each ulp taken at
    ``max(|ref|, 1e-3 max|ref|)``: 1.0 or less means every element of
    ``got`` is within one bf16 ulp of ``ref``."""
    r = ref.double()
    mag = r.abs().clamp_min(1e-3 * float(r.abs().max()))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got.double() - r).abs() / ulp).max())


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
