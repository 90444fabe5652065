"""One decode step of the gated linear recurrence, the state updated in
place: the CUDA kernel and its plain version.

For each (batch, head), in f32: ``a = exp(log_a)``, ``S' = a S + b v^T``,
``y = S'^T c``; S' is written over S.  Mamba-2's decode step and the
mLSTM's run it (``layers.mamba2_block`` / ``mlstm_block`` with
``state=``).  It ports no Pallas kernel: the reference's decode step is
jnp (``linear_recurrence_step``).  The kernel (``csrc/ssd_step.cu``)
reads S once and writes it once where the PyTorch step passes over it
five times; its source states the design and its bound (bytes).
"""
from __future__ import annotations

import torch

from . import _build


def _shapes(S, c, b, v, log_a) -> tuple[int, int, int, int]:
    B, H, N, P = S.shape
    if tuple(c.shape) != (B, H, N) or tuple(b.shape) != (B, H, N) \
            or tuple(v.shape) != (B, H, P) or tuple(log_a.shape) != (B, H):
        raise ValueError(f"ssd_step: shapes S {tuple(S.shape)}, c "
                         f"{tuple(c.shape)}, b {tuple(b.shape)}, v "
                         f"{tuple(v.shape)}, log_a {tuple(log_a.shape)} "
                         "disagree")
    return B, H, N, P


def ssd_step_plain(S, c, b, v, log_a):
    """S (B,H,N,P) f32; c, b (B,H,N); v (B,H,P); log_a (B,H).  The model's
    step (``layers.linear_recurrence_step``), then S' copied over S.
    Returns (y (B,H,P) in v.dtype, S)."""
    from ..models.layers import linear_recurrence_step
    _shapes(S, c, b, v, log_a)
    y, S_new = linear_recurrence_step(S, c, b, v, log_a)
    S.copy_(S_new)
    return y, S


def ssd_step_cuda(S, c, b, v, log_a):
    """Launch the CUDA kernel on the current stream of S's device.  S is
    f32 and contiguous and is updated in place; c, b and v share one
    dtype (f32 or bf16) and are read at their strides (the decode's
    operands are views); log_a is f32 and contiguous.  Returns (y (B,H,P)
    contiguous in v.dtype, S)."""
    B, H, N, P = _shapes(S, c, b, v, log_a)
    _build.check_operands("ssd_step", strided=("c", "b", "v"),
                          S=(S, (torch.float32,)),
                          c=(c, _build.FLOATS), b=(b, (c.dtype,)),
                          v=(v, (c.dtype,)),
                          log_a=(log_a, (torch.float32,)))
    y = torch.empty((B, H, P), dtype=v.dtype, device=v.device)
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("ssd_step", S.data_ptr(), c.data_ptr(), b.data_ptr(),
                      v.data_ptr(), log_a.data_ptr(), y.data_ptr(),
                      B, H, N, P, *c.stride(), *b.stride(), *v.stride(),
                      int(v.dtype == torch.bfloat16), stream)
    return y, S
