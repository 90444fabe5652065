"""MoE expert GLU: the CUDA kernel, its plain version, and the
dispatch bookkeeping.

Port of ``repro.kernels.moe_gather`` (the Pallas TPU kernel and its XLA
glue).  The kernel (``csrc/expert_glu.cu``) is two grouped tensor-core
GEMMs launched by one C call: the up projection with the GLU in its
epilogue, writing the activation to a scratch buffer, then the down
projection; its source states each design and what bounds it.  The C
entry chooses the design by an explicit rule before the launch:
:func:`bf16_kernels` says which a bf16 call takes (bf16 ``wgmma`` fed by
TMA where TMA reads every row, else the ``mma.sync`` kernel).
:func:`expert_glu_plain` is the same function in PyTorch, rounding
the activation to x's dtype before the down projection exactly where
the kernel does.  :func:`dispatch_indices` stays PyTorch glue, as it was
XLA glue; the gather -> expert GLU -> combine composition is
``ops.moe_dispatch_combine``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F_

from . import _build


def _shapes(x, w_up, w_down):
    E, cap, d = x.shape
    F = w_down.shape[1]
    if tuple(w_up.shape) != (E, d, 2 * F) or tuple(w_down.shape) != (E, F, d):
        raise ValueError(f"expert_glu: shapes x {tuple(x.shape)}, w_up "
                         f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)} "
                         f"disagree (want w_up (E,d,2F), w_down (E,F,d))")
    return E, cap, d, F


# the kernels each bf16 design launches (both projections are one
# template, so a device trace names each design once)
BF16_WGMMA_KERNELS = ("glu_bf16_kernel",)
BF16_MMA_SYNC_KERNELS = ("gemm_kernel",)


def bf16_kernels(x, w_up, w_down) -> tuple[str, ...]:
    """The kernels a bf16 call launches, by the C entry's rule
    (``bf::tma_route``): the ``wgmma`` design where TMA reads every
    operand (d and F multiples of 8, x, w_up and w_down on 16-byte
    boundaries; the wrapper's own act and y always are), else the
    ``mma.sync`` design."""
    d, F = x.shape[-1], w_down.shape[1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w_up, w_down))
    return BF16_WGMMA_KERNELS if d % 8 == 0 and F % 8 == 0 and aligned \
        else BF16_MMA_SYNC_KERNELS


def expert_glu_plain(x, w_up, w_down):
    """x (E, cap, d); w_up (E, d, 2F) = [gate | up]; w_down (E, F, d).
    Returns (silu(x Wg) * (x Wu)) Wd in x.dtype, f32 sums, the
    activation rounded to x.dtype before the down projection."""
    F = _shapes(x, w_up, w_down)[3]
    h = torch.bmm(x.float(), w_up.float())
    a = (F_.silu(h[..., :F]) * h[..., F:]).to(x.dtype)
    return torch.bmm(a.float(), w_down.float()).to(x.dtype)


def expert_glu_cuda(x, w_up, w_down):
    """Launch the CUDA kernel on the current stream of x's device (one
    counted launch: the C call runs the up and the down projection).  x,
    w_up, w_down share one dtype (f32 or bf16)."""
    E, cap, d, F = _shapes(x, w_up, w_down)
    _build.check_operands("expert_glu", x=(x, _build.FLOATS),
                          w_up=(w_up, (x.dtype,)), w_down=(w_down, (x.dtype,)))
    act = torch.empty((E, cap, F), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("expert_glu", x.data_ptr(), w_up.data_ptr(),
                      w_down.data_ptr(), act.data_ptr(), y.data_ptr(), E,
                      cap, d, F, int(x.dtype == torch.bfloat16), stream)
    return y


def dispatch_indices(gate_idx, capacity: int, n_experts: int):
    """Capacity-padded dispatch bookkeeping.

    gate_idx: (T, K) integer.  Returns (token_of (E, cap) int32 with -1
    pads, keep (T, K) bool, pos (T, K) int32) where pos is each (t, k)
    slot's first-come queue position within its expert.  Dropped slots
    are written to an overflow column ``cap`` of an (E, cap + 1) table,
    which is then cut off; only that column receives duplicate indices.
    """
    T, K = gate_idx.shape
    onehot = F_.one_hot(gate_idx.long(), n_experts).to(torch.int32)  # T,K,E
    flat = onehot.reshape(T * K, n_experts)
    # each expert's running count along the (t, k) stream, scanned as
    # rows of the transpose: a scan over the innermost dim is parallel on
    # the card, a dim-0 scan of this narrow matrix is serial per column
    pos_flat = torch.cumsum(flat.t().contiguous(), dim=1,
                            dtype=torch.int32).t() - flat
    pos = (pos_flat.reshape(T, K, n_experts) * onehot).sum(-1,
                                                           dtype=torch.int32)
    keep = pos < capacity
    tok_ids = torch.arange(T, dtype=torch.int32,
                           device=gate_idx.device)[:, None].expand(T, K)
    p_flat = torch.where(keep, pos, capacity).reshape(-1).long()
    token_of = torch.full((n_experts, capacity + 1), -1, dtype=torch.int32,
                          device=gate_idx.device)
    token_of[gate_idx.reshape(-1).long(), p_flat] = tok_ids.reshape(-1)
    return token_of[:, :capacity], keep, pos
