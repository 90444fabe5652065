"""Chunked Mamba-2 SSD scan: the CUDA kernel and its plain version.

Port of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel).  The kernel
(``csrc/ssd_scan.cu``) runs one block per (batch, head) sequence and
loops over the chunks with the f32 state in shared memory; its source
states the design and what bounds it.  :func:`ssd_scan_plain` repeats the
same chunked algebra in PyTorch (intra-chunk ``((c b^T) o L) v``,
inter-chunk ``(c o e^cum) S``, carry ``S e^tot + (b o e^(tot-cum))^T v``),
so the kernel can be held against it on the card and the CPU path runs
the same algorithm.
"""
from __future__ import annotations

import torch

from . import _build

MAX_CHUNK = 64
MAX_STATE = 128


def _chunk(chunk: int, T: int) -> int:
    return min(chunk, max(T, 1))


def ssd_scan_plain(c, b, v, log_a, *, initial_state=None,
                   chunk: int = MAX_CHUNK):
    """c, b: (B,T,H,N); v: (B,T,H,P); log_a: (B,T,H) (<= 0).  Returns
    (y (B,T,H,P) in v.dtype, S_final (B,H,N,P) f32)."""
    B, T, H, N = b.shape
    P = v.shape[-1]
    C = _chunk(chunk, T)
    nc = -(-T // C)
    pad = nc * C - T

    def heads_first(x):                     # (B,T,H,...) -> (B,H,T,...) f32
        x = x.float().transpose(1, 2)
        return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 3) + (0, pad))

    cf, bf, vf = heads_first(c), heads_first(b), heads_first(v)
    la = torch.nn.functional.pad(log_a.float().transpose(1, 2), (0, pad))
    S = (torch.zeros((B, H, N, P), dtype=torch.float32, device=v.device)
         if initial_state is None else initial_state.float().clone())
    lower = torch.tril(torch.ones((C, C), dtype=torch.bool, device=v.device))
    ys = []
    for t0 in range(0, nc * C, C):
        cc, bb, vv = cf[:, :, t0:t0 + C], bf[:, :, t0:t0 + C], vf[:, :, t0:t0 + C]
        cum = torch.cumsum(la[:, :, t0:t0 + C], dim=-1)           # B,H,C
        tot = cum[..., -1:]
        diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~lower, -1e30)
        y = ((cc @ bb.transpose(-1, -2)) * torch.exp(diff)) @ vv
        y = y + (cc * torch.exp(cum)[..., None]) @ S
        chunk_state = (bb * torch.exp(tot - cum)[..., None]).transpose(-1, -2) @ vv
        S = S * torch.exp(tot)[..., None] + chunk_state
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :T].transpose(1, 2)
    return y.to(v.dtype), S


def ssd_scan_cuda(c, b, v, log_a, *, initial_state=None,
                  chunk: int = MAX_CHUNK):
    """Launch the CUDA kernel on the current stream of v's device.  c, b,
    v share one dtype (f32 or bf16); log_a and initial_state are f32;
    the effective chunk is at most ``MAX_CHUNK`` and N, P at most
    ``MAX_STATE``.  The chunk defaults to ``MAX_CHUNK``, not to the
    Pallas kernel's 256: the kernel keeps a chunk's C x C decay matrix
    in shared memory, and 256 does not fit (``ROADMAP.md``)."""
    B, T, H, N = b.shape
    P = v.shape[-1]
    if c.shape != b.shape or v.shape[:3] != b.shape[:3] \
            or tuple(log_a.shape) != (B, T, H):
        raise ValueError(f"ssd_scan: shapes c {tuple(c.shape)}, b "
                         f"{tuple(b.shape)}, v {tuple(v.shape)}, log_a "
                         f"{tuple(log_a.shape)} disagree")
    C = _chunk(chunk, T)
    if C > MAX_CHUNK or N > MAX_STATE or P > MAX_STATE:
        raise ValueError(f"ssd_scan: the kernel takes chunk <= {MAX_CHUNK} "
                         f"and N, P <= {MAX_STATE}; got chunk={C}, N={N}, "
                         f"P={P}")
    operands = dict(c=(c, _build.FLOATS), b=(b, (c.dtype,)),
                    v=(v, (c.dtype,)), log_a=(log_a, (torch.float32,)))
    if initial_state is not None:
        if tuple(initial_state.shape) != (B, H, N, P):
            raise ValueError(f"ssd_scan: initial_state "
                             f"{tuple(initial_state.shape)} is not (B,H,N,P)"
                             f" = {(B, H, N, P)}")
        operands["initial_state"] = (initial_state, (torch.float32,))
    _build.check_operands("ssd_scan", **operands)
    y = torch.empty_like(v)
    s_final = torch.empty((B, H, N, P), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("ssd_scan", c.data_ptr(), b.data_ptr(), v.data_ptr(),
                      log_a.data_ptr(),
                      None if initial_state is None else initial_state.data_ptr(),
                      y.data_ptr(), s_final.data_ptr(), B, T, H, N, P, C,
                      int(v.dtype == torch.bfloat16), stream)
    return y, s_final
