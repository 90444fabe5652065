"""Chunked Mamba-2 SSD scan: the CUDA kernel and its plain version.

Port of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel).  The kernel
(``csrc/ssd_scan.cu``) runs in three phases, the first and last parallel
over chunks: every chunk's own state contribution, then a short
sequential pass that carries the state across chunks, then every chunk's
outputs on the tensor cores; its source states the design and what
bounds it.  :func:`ssd_scan_plain` repeats the same chunked algebra in
PyTorch in the same phase order (chunk states ``(b o e^(tot-cum))^T v``
for all chunks at once, the carry ``S e^tot + chunk_state`` chunk by
chunk, then intra-chunk ``((c b^T) o L) v`` plus inter-chunk
``(c o e^cum) S_in``), so the kernel can be held against it on the card
and the CPU path runs the same algorithm.
"""
from __future__ import annotations

import torch

from . import _build

MAX_CHUNK = 256
# largest N: the output kernel keeps a block's 64 rows of c (64 x N) in
# shared memory beside its stage buffers (227 KB in f32 at N = 496); P is
# tiled 64 columns a block and has no such limit
MAX_STATE = 496


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

    def chunks(x):               # (B,T,H,...) -> (B,H,nc,C,...) f32, zero pad
        x = x.float().transpose(1, 2)
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 3) + (0, pad))
        return x.reshape(B, H, nc, C, *x.shape[3:])

    cf, bf, vf = chunks(c), chunks(b), chunks(v)
    cum = torch.cumsum(chunks(log_a), dim=-1)                  # B,H,nc,C
    tot = cum[..., -1]                                         # B,H,nc

    # 1. every chunk's own contribution to the state
    w = torch.exp(tot[..., None] - cum)
    chunk_states = (bf * w[..., None]).transpose(-1, -2) @ vf  # B,H,nc,N,P

    # 2. the state entering each chunk, carried in order
    S = (torch.zeros((B, H, N, P), dtype=torch.float32, device=v.device)
         if initial_state is None else initial_state.float())
    decay = torch.exp(tot)
    s_in = []
    for ci in range(nc):
        s_in.append(S)
        S = S * decay[:, :, ci, None, None] + chunk_states[:, :, ci]
    s_in = torch.stack(s_in, dim=2)                            # B,H,nc,N,P

    # 3. every chunk's outputs
    lower = torch.tril(torch.ones((C, C), dtype=torch.bool, device=v.device))
    diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~lower, -1e30)
    y = ((cf @ bf.transpose(-1, -2)) * torch.exp(diff)) @ vf
    y = y + (cf * torch.exp(cum)[..., None]) @ s_in
    y = y.reshape(B, H, nc * C, P)[:, :, :T].transpose(1, 2)
    return y.to(v.dtype), S


def ssd_scan_cuda(c, b, v, log_a, *, initial_state=None,
                  chunk: int = MAX_CHUNK):
    """Launch the CUDA kernel on the current stream of v's device.  c, b,
    v share one dtype (f32 or bf16); log_a and initial_state are f32;
    the effective chunk is at most ``MAX_CHUNK`` (the Pallas kernel's
    default, 256, and the default here) and N at most ``MAX_STATE``."""
    B, T, H, N = b.shape
    P = v.shape[-1]
    if c.shape != b.shape or v.shape[:3] != b.shape[:3] \
            or tuple(log_a.shape) != (B, T, H):
        raise ValueError(f"ssd_scan: shapes c {tuple(c.shape)}, b "
                         f"{tuple(b.shape)}, v {tuple(v.shape)}, log_a "
                         f"{tuple(log_a.shape)} disagree")
    C = _chunk(chunk, T)
    if C > MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"ssd_scan: the kernel takes chunk <= {MAX_CHUNK} "
                         f"and N <= {MAX_STATE}; got chunk={C}, N={N}")
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
    # the chunk states (B, H, nc, N, P), then each chunk's tot (B, H, nc)
    nc = -(-T // C)
    work = torch.empty(B * H * nc * (N * P + 1), dtype=torch.float32,
                       device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("ssd_scan", c.data_ptr(), b.data_ptr(), v.data_ptr(),
                      log_a.data_ptr(),
                      None if initial_state is None else initial_state.data_ptr(),
                      y.data_ptr(), s_final.data_ptr(), work.data_ptr(),
                      B, T, H, N, P, C,
                      int(v.dtype == torch.bfloat16), stream)
    return y, s_final
