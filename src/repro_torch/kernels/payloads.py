"""Kernel payload variant tables: the kernels as per-target op payloads.

Port of ``repro.kernels.payloads``.  Each factory returns a
``{dialect: callable}`` table for one fused-op payload, with weights and
side operands closed over so a single activation flows through a chain
graph.  Dialects:

* ``"ref"``   — the PyTorch oracle from :mod:`repro_torch.kernels.ref`
  (bound as ``op.fn``: the interpreter path and every probe verify
  against it);
* ``"cuda"``  — the hand-written CUDA kernel via
  :mod:`repro_torch.kernels.ops` (on a CPU tensor: its plain version);
* ``"numpy"`` — host NumPy, for the host-affine ops the paper maps to
  the CPU (eltwise glue, sort).  It converts at its boundary: a tensor
  comes in, goes to the host as a NumPy array, and a CPU tensor goes out.

Every payload returns a torch tensor and runs on the device of its
input.  The closed-over tensors are kept once per device, copied there
at first use (:class:`PerDevice`), so one op can run on any lane.
``bind_variants(op, table)`` installs a table on a
:class:`~repro_torch.core.op.FusedOp` and records example inputs for
measured profiling.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Mapping

import numpy as np
import torch

from . import ops, ref

PayloadTable = Mapping[str, Callable[..., Any]]


def bind_variants(op, table: PayloadTable,
                  example_inputs: tuple | None = None):
    """Install a payload table on a ``FusedOp``: ``table["ref"]`` becomes
    the reference ``op.fn``, every other dialect goes into
    ``op.variants``; ``example_inputs`` (if given) lands in
    ``op.meta["example_inputs"]`` for the measured profiler."""
    if "ref" not in table:
        raise ValueError("payload table needs a 'ref' entry (the oracle)")
    op.fn = table["ref"]
    op.variants = {k: fn for k, fn in table.items() if k != "ref"}
    if example_inputs is not None:
        op.meta["example_inputs"] = example_inputs
    return op


class PerDevice:
    """Closed-over tensors, one copy per device, made at first use."""

    def __init__(self, **tensors):
        self._src = tensors
        self._copies: dict[torch.device, dict] = {}
        self._lock = threading.Lock()

    def on(self, device) -> dict:
        device = torch.device(device)
        got = self._copies.get(device)
        if got is None:
            with self._lock:
                got = self._copies.get(device)
                if got is None:
                    got = {k: None if t is None else t.to(device)
                           for k, t in self._src.items()}
                    self._copies[device] = got
        return got


# ---------------------------------------------------------------------------
# kernel payloads (activation in, activation out; weights closed over)
# ---------------------------------------------------------------------------


def attention_payloads(k, v, *, causal: bool = True, q_offset: int = 0) -> dict:
    """Fused attention: activation is the query ``(B, Tq, Hq, D)``; the
    key/value streams (e.g. a decode KV cache) are closed over."""
    kv = PerDevice(k=k, v=v)

    def ref_fn(q):
        w = kv.on(q.device)
        return ref.attention_ref(q, w["k"], w["v"], causal=causal,
                                 q_offset=q_offset)

    def cuda_fn(q):
        w = kv.on(q.device)
        return ops.flash_attention(q, w["k"], w["v"], causal=causal,
                                   q_offset=q_offset)
    return {"ref": ref_fn, "cuda": cuda_fn}


def ssd_payloads(c, b, log_a, *, initial_state=None, chunk: int = 32) -> dict:
    """SSD recurrence: activation is the value stream ``(B, T, H, P)``;
    the state/input projections and decay gates are closed over.  Only
    the sequence output flows (the carried state is layer-internal)."""
    side = PerDevice(c=c, b=b, log_a=log_a, s0=initial_state)

    def ref_fn(x):
        w = side.on(x.device)
        y, _ = ref.ssd_scan_ref(w["c"], w["b"], x, w["log_a"],
                                initial_state=w["s0"])
        return y

    def cuda_fn(x):
        w = side.on(x.device)
        y, _ = ops.ssd_scan(w["c"], w["b"], x, w["log_a"],
                            initial_state=w["s0"], chunk=chunk)
        return y
    return {"ref": ref_fn, "cuda": cuda_fn}


def top_k_gates(logits, top_k: int):
    """Softmax top-k gating with ties broken toward the lower expert
    index, as ``jax.lax.top_k`` breaks them (a stable descending sort,
    not ``torch.topk``, whose tie order is unspecified).  Returns
    (indices (T, K) int64, renormalised f32 weights (T, K))."""
    probs = torch.softmax(logits, dim=-1)
    gv, gi = torch.sort(probs, dim=-1, descending=True, stable=True)
    gv, gi = gv[..., :top_k], gi[..., :top_k]
    return gi, gv / gv.sum(-1, keepdim=True)


def moe_payloads(w_gate, w_up, w_down, *, capacity: int,
                 top_k: int = 2) -> dict:
    """Routed MoE layer: activation ``(T, d)`` tokens; router + expert
    weights closed over.  Gating (softmax top-k, renormalized) is shared
    PyTorch code so the dialects differ only in dispatch/combine."""
    wts = PerDevice(w_gate=w_gate, w_up=w_up, w_down=w_down)

    def gates(x, w):
        gi, gv = top_k_gates(x.float() @ w["w_gate"].float(), top_k)
        return gi, gv.to(x.dtype)

    def ref_fn(x):
        w = wts.on(x.device)
        gi, gv = gates(x, w)
        return ref.moe_dispatch_combine_ref(x, gi, gv, w["w_up"],
                                            w["w_down"], capacity=capacity)

    def cuda_fn(x):
        w = wts.on(x.device)
        gi, gv = gates(x, w)
        return ops.moe_dispatch_combine(x, gi, gv, w["w_up"], w["w_down"],
                                        capacity=capacity)
    return {"ref": ref_fn, "cuda": cuda_fn}


# ---------------------------------------------------------------------------
# host-affine payloads (the CPU-mapped glue the paper's Fig. 2 CPU class)
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def eltwise_payloads(scale: float = 1.0) -> dict:
    """Elementwise gate/activation with a NumPy host variant."""
    s32 = np.float32(scale)

    def ref_fn(x):
        return torch.tanh(x * float(s32))

    def numpy_fn(x):
        return torch.from_numpy(np.tanh(_host(x) * s32))
    return {"ref": ref_fn, "numpy": numpy_fn}


def sort_payloads() -> dict:
    """Shape-preserving full sort of the flattened activation — the
    classic host-affine op."""
    def ref_fn(x):
        return torch.sort(x.reshape(-1)).values.reshape(x.shape)

    def numpy_fn(x):
        a = _host(x)
        return torch.from_numpy(np.sort(a.reshape(-1)).reshape(a.shape))
    return {"ref": ref_fn, "numpy": numpy_fn}
