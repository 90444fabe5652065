"""Public entry points of the kernels, dispatched on the tensor's device.

A tensor on the CPU takes the kernel's plain PyTorch version (that is how
the tests run the kernels' algorithms without a card); a tensor anywhere
else launches the CUDA kernel, whose wrapper raises if it cannot (wrong
device, dtype or shape) — there is no fallback.  This replaces the
reference package's ``default_interpret()``, which chose Pallas interpret
mode off the TPU.

``moe_dispatch_combine`` is the MoE composition — dispatch gather ->
:func:`expert_glu` -> weighted combine — in PyTorch glue around the
kernel, as the reference kept it in XLA glue around the Pallas kernel.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_cuda, flash_attention_plain
from .moe_gather import dispatch_indices, expert_glu_cuda, expert_glu_plain
from .ssd_scan import ssd_scan_cuda, ssd_scan_plain


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q (B,Tq,Hq,D); k/v (B,Tk,Hk,D) with Hq % Hk == 0.  Returns
    (B,Tq,Hq,D) in q.dtype."""
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal,
                                q_offset=q_offset)


def ssd_scan(c, b, v, log_a, *, initial_state=None, chunk: int = 256):
    """c, b: (B,T,H,N); v: (B,T,H,P); log_a: (B,T,H) (<= 0).  Returns
    (y (B,T,H,P) in v.dtype, S_final (B,H,N,P) f32)."""
    if _on_cpu(v):
        return ssd_scan_plain(c, b, v, log_a, initial_state=initial_state,
                              chunk=chunk)
    s0 = None if initial_state is None else initial_state.float().contiguous()
    return ssd_scan_cuda(c.contiguous(), b.contiguous(), v.contiguous(),
                         log_a.float().contiguous(), initial_state=s0,
                         chunk=chunk)


def expert_glu(x, w_up, w_down):
    """x: (E, cap, d) capacity-padded per-expert tokens; w_up: (E, d, 2F)
    ([..., :F] gate, [..., F:] up); w_down: (E, F, d).  Returns
    (E, cap, d) expert outputs in x.dtype."""
    if _on_cpu(x):
        return expert_glu_plain(x, w_up, w_down)
    return expert_glu_cuda(x.contiguous(), w_up.contiguous(),
                           w_down.contiguous())


def moe_dispatch_combine(x, gate_idx, gate_vals, w_up, w_down, *,
                         capacity: int):
    """Routed MoE: dispatch (gather into capacity-padded expert queues)
    -> :func:`expert_glu` -> combine (gate-weighted sum over the top-k).
    Matches ``ref.moe_dispatch_combine_ref``."""
    T, d = x.shape
    E = w_up.shape[0]
    token_of, keep, pos = dispatch_indices(gate_idx, capacity, E)
    valid = token_of >= 0
    xe = torch.where(valid[..., None],
                     x[torch.where(valid, token_of, 0).long()],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    ye = expert_glu(xe, w_up, w_down)                             # E,cap,d
    slot = gate_idx.long() * capacity + pos.clamp(max=capacity - 1).long()
    contrib = ye.reshape(E * capacity, d)[slot] \
        * (gate_vals * keep)[..., None].to(x.dtype)
    return contrib.sum(dim=1).to(x.dtype)


__all__ = ["flash_attention", "ssd_scan", "expert_glu",
           "moe_dispatch_combine", "dispatch_indices"]
