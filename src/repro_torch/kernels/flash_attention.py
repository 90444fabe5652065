"""Blockwise causal GQA flash attention: the CUDA kernel and its plain
version.

Port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).  The
kernel (``csrc/flash_attention.cu``) has three designs, all with an
online softmax in registers; its source states each and what bounds it,
and its C entry picks one before the launch by an explicit rule
(:func:`f32_kernel` says which for f32).  bf16: warp-specialised ``wgmma``
fed by TMA, 128-row query tiles, kv tiles of :func:`bf16_kv_tile` rows,
the 1/sqrt(D) scale (with log2(e)) on S after the product, and P kept
above bf16 as two bf16 terms.  f32 at D 64, 128 and 160 on 16-byte
aligned operands: 3xTF32 ``wgmma`` fed by TMA, 64-row query tiles whose
two consumer warpgroups walk alternate kv tiles of :func:`f32_kv_tile`
rows (even, odd) and merge their (m, l, O) at the end.  Other f32 calls
(D 16, 32, operands off 16 bytes): one block a 64-row query tile over
64-row kv tiles, both products in 3xTF32 ``mma.sync``.
:func:`flash_attention_plain` repeats the arithmetic tile by tile in
PyTorch (the same tiles, mask, causal tile skip, ``l`` clamp, base-2
exponentials with log2(e) on S; for bf16 the scale on S and P's two
terms; for f32 q scaled before the product and the two streams of kv
tiles with their merge, as the ``wgmma`` design runs them: the
``mma.sync`` design computes the same function in one stream, within the
f32 bucket), so the kernel can be held against it on the card and the
CPU path runs the same algorithm.  :func:`bf16_ulps` measures a bf16
result in bf16 ulps of a reference.
"""
from __future__ import annotations

import math

import torch

from . import _build

BLOCK_Q = 64
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 160)
LOG2E = math.log2(math.e)


def bf16_kv_tile(D: int) -> int:
    """kv rows a tile of the bf16 kernel (``wg::kv_tile`` in the source)."""
    return 64 if D == 128 else 32


# head dims of the f32 wgmma design (``tf::tma_route`` in the source)
F32_WGMMA_HEAD_DIMS = (64, 128, 160)


def f32_kv_tile(D: int) -> int:
    """kv rows a tile of the f32 ``wgmma`` kernel (``tf::kv_tile`` in the
    source), and of the plain version's f32 arithmetic at every D: at D
    160 only 16-row tiles leave room in shared memory for both consumer
    warpgroups' own tiles beside Q and its lo tile."""
    return 16 if D == 160 else 32 if D == 128 else 64


def f32_kernel(q, k, v) -> str:
    """The kernel an f32 call launches, by the C entry's rule: the 3xTF32
    ``wgmma`` design (``attn_tf32_kernel``) at D in
    :data:`F32_WGMMA_HEAD_DIMS` with q, k and v on 16-byte boundaries (TMA
    reads them), else the ``mma.sync`` design (``attn_kernel``)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return "attn_tf32_kernel" if q.shape[-1] in F32_WGMMA_HEAD_DIMS and \
        aligned else "attn_kernel"


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
    if bf16:   # scale (and log2(e)) on S after the product, one stream
        scale = torch.tensor(LOG2E / math.sqrt(D), dtype=torch.float32)
        qf, block_k, streams = q.float(), bf16_kv_tile(D), 1
    else:      # q scaled before the product, log2(e) on S; kv tiles
        # walked by two streams (even, odd tiles), merged at the end
        scale = torch.tensor(LOG2E, dtype=torch.float32)
        qf, block_k, streams = q.float() * (1.0 / math.sqrt(D)), \
            f32_kv_tile(D), 2
    qf = qf.transpose(1, 2)                                    # B,Hq,Tq,D
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    out = torch.empty((B, Hq, Tq, Dv), dtype=torch.float32, device=q.device)
    for q0 in range(0, Tq, BLOCK_Q):
        qt = qf[:, :, q0:q0 + BLOCK_Q]
        q_pos = q_offset + q0 + torch.arange(qt.shape[2], device=q.device)
        # (m in units of S log2(e), l, acc) of each stream
        st = [(torch.full(qt.shape[:3] + (1,), NEG_INF, device=q.device),
               torch.zeros(qt.shape[:3] + (1,), device=q.device),
               torch.zeros(qt.shape[:3] + (Dv,), device=q.device))
              for _ in range(streams)]
        n_kv = -(-Tk // block_k)
        if causal:
            n_kv = min(n_kv, (q_offset + q0 + BLOCK_Q - 1) // block_k + 1)
        for j in range(n_kv):
            m, l, acc = st[j % streams]
            k0 = j * block_k
            kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
            s = qt @ kt.transpose(-1, -2)
            if causal:      # masked before the scale, as the kernels do
                k_pos = k0 + torch.arange(kt.shape[2], device=q.device)
                s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
            s = s * scale
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            if bf16:   # P V with P as its bf16 terms hi + lo
                hi = p.to(torch.bfloat16).float()
                lo = (p - hi).to(torch.bfloat16).float()
                acc = acc * alpha + hi @ vt + lo @ vt
            else:
                acc = acc * alpha + p @ vt
            st[j % streams] = (m_new, l, acc)
        m = st[0][0]
        for m_i, _, _ in st[1:]:
            m = torch.maximum(m, m_i)
        a = [torch.exp2(m_i - m) for m_i, _, _ in st]
        l = sum(l_i * a_i for (_, l_i, _), a_i in zip(st, a))
        acc = sum(acc_i * a_i for (_, _, acc_i), a_i in zip(st, a))
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
