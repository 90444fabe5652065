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

On a mesh (any argument a DTensor) each entry point runs its kernel, or
on the CPU its plain version, on every rank's local shard: the
arguments are redistributed so that only the dims the kernel computes
independently stay split (batch and heads; the experts of
:func:`expert_glu`), each rank calls the kernel on its shard, and the
result is put together as a DTensor with those placements.  A split of
any other dim (seq, N, P, d_head) is gathered first, so a kernel never
runs on a slice it would get wrong.  Under GQA the kv heads follow the q
heads: a rank whose q heads are a slice gets the kv heads those q heads
use, sliced by its head offset (or gathered one per q head where the
slice does not fall on group boundaries).
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_cuda, flash_attention_plain
from .moe_gather import dispatch_indices, expert_glu_cuda, expert_glu_plain
from .ssd_scan import ssd_scan_cuda, ssd_scan_plain


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


# ---------------------------------------------------------------------------
# the mesh entry
# ---------------------------------------------------------------------------

def _dtensor_mesh(*xs):
    from torch.distributed.tensor import DTensor
    for x in xs:
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def _placed(x, mesh, pl):
    """The local shard of ``x`` placed as ``pl`` (:func:`sharding.place`)."""
    from ..sharding import place
    return place(x, mesh, pl).to_local()


def _keep(x, dims) -> tuple | None:
    """Placements of ``x`` with only its splits of the tensor dims in
    ``dims`` kept; every other split, and any pending partial sum, made
    whole.  None for a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return None
    return tuple(p if p.is_shard() and p.dim in dims else Replicate()
                 for p in x.placements)


def _assemble(local, mesh, pl, shape):
    from ..sharding import assemble
    return assemble(local.contiguous(), mesh, pl, shape)


def _replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in range(mesh.ndim))


def _head_range(shape, mesh, pl, dim: int) -> tuple[int, int]:
    """(offset, count) of this rank's slice of tensor dim ``dim``."""
    from ..sharding import local_shape_and_offset
    lshape, off = local_shape_and_offset(tuple(shape), mesh, pl)
    return off[dim], lshape[dim]


def _flash_attention_mesh(q, k, v, *, causal: bool, q_offset: int):
    mesh = _dtensor_mesh(q, k, v)
    rep = _replicated(mesh)
    qpl = _keep(q, (0, 2)) or rep
    q_loc = _placed(q, mesh, qpl)
    # k/v: batch split as q's, heads whole (sliced below by q's offset)
    from torch.distributed.tensor import Replicate, Shard
    kpl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in qpl)
    k_loc = _placed(k, mesh, kpl)
    v_loc = _placed(v, mesh, kpl)
    Hq, Hk = q.shape[2], k.shape[2]
    if Hq % Hk:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hk}")
    G = Hq // Hk
    h0, hn = _head_range(q.shape, mesh, qpl, 2)
    if hn != Hq:
        lo, hi = h0 // G, (h0 + hn - 1) // G + 1
        if h0 % G == 0 and hn % G == 0 or (hi - lo == 1 and G % hn == 0):
            k_loc, v_loc = k_loc[:, :, lo:hi], v_loc[:, :, lo:hi]
        else:
            # q heads that cut a group: one kv head per local q head
            idx = torch.tensor([(h0 + i) // G for i in range(hn)],
                               device=k_loc.device)
            k_loc = k_loc.index_select(2, idx)
            v_loc = v_loc.index_select(2, idx)
    out = flash_attention(q_loc, k_loc, v_loc, causal=causal,
                          q_offset=q_offset)
    return _assemble(out, mesh, qpl, tuple(q.shape[:3]) + (v.shape[-1],))


def _ssd_scan_mesh(c, b, v, log_a, *, initial_state, chunk: int):
    from torch.distributed.tensor import Shard
    mesh = _dtensor_mesh(c, b, v, log_a, initial_state)
    rep = _replicated(mesh)
    # v leads: its batch and head splits, shared by c, b and log_a
    vpl = _keep(v, (0, 2)) or rep
    locs = [_placed(x, mesh, vpl) for x in (c, b, v)]
    la = _placed(log_a, mesh, vpl)
    spl = tuple(Shard(1) if p.is_shard(2) else p for p in vpl)
    s0 = None if initial_state is None else _placed(initial_state, mesh, spl)
    y, S = ssd_scan(*locs, la, initial_state=s0, chunk=chunk)
    B, T, H, N = c.shape
    P = v.shape[-1]
    return (_assemble(y, mesh, vpl, (B, T, H, P)),
            _assemble(S, mesh, spl, (B, H, N, P)))


def _expert_glu_mesh(x, w_up, w_down):
    mesh = _dtensor_mesh(x, w_up, w_down)
    # experts lead, as the weights hold them; the tokens follow
    epl = _keep(w_up, (0,)) or _keep(x, (0,)) or _replicated(mesh)
    y = expert_glu(*(_placed(t, mesh, epl) for t in (x, w_up, w_down)))
    return _assemble(y, mesh, epl, tuple(x.shape))


def _on_mesh(*xs) -> bool:
    return _dtensor_mesh(*xs) is not None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q (B,Tq,Hq,D); k/v (B,Tk,Hk,D) with Hq % Hk == 0.  Returns
    (B,Tq,Hq,D) in q.dtype."""
    if _on_mesh(q, k, v):
        return _flash_attention_mesh(q, k, v, causal=causal,
                                     q_offset=q_offset)
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal,
                                q_offset=q_offset)


def ssd_scan(c, b, v, log_a, *, initial_state=None, chunk: int = 256):
    """c, b: (B,T,H,N); v: (B,T,H,P); log_a: (B,T,H) (<= 0).  Returns
    (y (B,T,H,P) in v.dtype, S_final (B,H,N,P) f32)."""
    if _on_mesh(c, b, v, log_a, initial_state):
        return _ssd_scan_mesh(c, b, v, log_a, initial_state=initial_state,
                              chunk=chunk)
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
    if _on_mesh(x, w_up, w_down):
        return _expert_glu_mesh(x, w_up, w_down)
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
