"""Roofline terms of a step, counted from the aten ops it runs.

Port of ``repro.launch.roofline``.  The reference walks a jaxpr
(``count_jaxpr``, multiplying scan bodies by their trip counts) and
parses collectives out of compiled HLO (``collective_bytes_hlo``).  The
port runs the step once under a ``TorchDispatchMode``
(:class:`OpCounter`), which sees the ops on plain (or ``meta``) tensors:

* :func:`count_ops` runs the step without a mesh, at global shapes (on
  ``meta`` tensors in the dry-run): FLOPs are exact for
  ``mm``/``bmm``/``addmm``/``baddbmm``/convolution (PyTorch's own flop
  formulas), and bytes follow the reference's fusion model — anchor ops
  (GEMM/conv/gather/scatter/reduce/sort/cumsum/...) count input and
  output traffic, elementwise and layout ops count 0 bytes and one FLOP
  per output element.  Totals are GLOBAL; per-chip is / n_chips under
  even sharding, as the reference has it.
* on a mesh, DTensor runs each op as local ops on the shards and issues
  c10d functional collectives; the mode counts those
  (:func:`collective_bytes`: bytes per chip by kind, times the
  reference's ring ``_wire_factor`` over the group's size) and the peak
  of one rank's live local bytes.

The port loops over layers in Python, so every layer's ops are seen and
nothing needs a trip multiplier.
"""
from __future__ import annotations

import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# c10d functional op -> collective kind
_COLLECTIVE_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# aten ops whose traffic the fusion model counts (the reference's ANCHORS:
# dot/conv, gather/scatter, dynamic (update) slices, reductions, sort,
# top-k, fft, cumulative ops, argmax/argmin, iota)
ANCHORS = {
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
    "convolution", "gather", "index", "index_select", "embedding",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "index_add",
    "index_copy", "slice_scatter", "select_scatter", "sum", "amax", "amin",
    "max", "min", "sort", "topk", "_fft_r2c", "_fft_c2r", "_fft_c2c",
    "cumsum", "logcumsumexp", "argmax", "argmin", "arange",
}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
           "convolution"}
_NO_COUNT = {"detach", "wait_tensor", "device",
             "empty", "empty_like", "empty_strided"}


def _name(func) -> str:
    packet = getattr(func, "_overloadpacket", None)
    return packet.__name__ if packet is not None else str(func)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _numel(t) -> float:
    n = 1
    for d in t.shape:
        n *= int(d)
    return float(n)


def _nbytes(t) -> float:
    return _numel(t) * t.element_size()


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


def _wire_factor(op: str, n: int) -> float:
    """Per-chip wire bytes as a multiple of the op's output, for a ring
    implementation over a group of size n (the reference's table):

      all-reduce      2(n-1)/n x tensor     (reduce-scatter + all-gather)
      all-gather      (n-1)/n  x output     (output full)
      reduce-scatter  (n-1)    x output     (output the shard)
      all-to-all      (n-1)/n  x tensor
      collective-permute  1    x tensor
    """
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op == "all-gather":
        return (n - 1) / n
    if op == "reduce-scatter":
        return float(n - 1)
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, fused bytes, collective bytes and live memory of the
    plain-tensor ops run under it.  Fake tensors do not count: DTensor's
    sharding propagation runs ops on fake tensors of its own, at global
    shapes, which are not the rank's work."""

    def __init__(self, track_memory: bool = True):
        super().__init__()
        self.track_memory = track_memory
        self.flops = 0.0
        self.bytes = 0.0
        self.matmul_flops = 0.0
        self.collectives = {k: 0.0 for k in COLLECTIVE_OPS}
        self.collective_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.live = 0.0
        self.peak = 0.0
        self._held: dict[int, tuple] = {}

    @staticmethod
    def _ours(t) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return not isinstance(t, FakeTensor)

    # -- live bytes ---------------------------------------------------------
    def hold(self, tensors) -> None:
        """Count ``tensors``' local storage as live (inputs made before
        the mode was entered)."""
        from torch.distributed.tensor import DTensor
        for t in _tensors(tensors):
            if isinstance(t, DTensor):
                t = t._local_tensor
            self._track(t)

    def _track(self, t) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._held:
            return
        nbytes = float(st.nbytes())

        def gone(_ref, key=key, nbytes=nbytes):
            if self._held.pop(key, None) is not None:
                self.live -= nbytes
        try:
            ref = weakref.ref(st, gone)
        except TypeError:
            return
        self._held[key] = (ref, nbytes)
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    # -- counting -------------------------------------------------------------
    def _count(self, name, func, args, kwargs, outs) -> None:
        if name in _MATMUL:
            from torch.utils.flop_counter import flop_registry
            f = flop_registry[func._overloadpacket]
            flops = float(f(*args, out_val=outs[0], **kwargs))
            self.flops += flops
            self.matmul_flops += flops
            self.bytes += (sum(map(_nbytes, _tensors(args)))
                           + sum(map(_nbytes, outs)))
            return
        self.flops += sum(map(_numel, outs))
        if name in ANCHORS:
            self.bytes += (sum(map(_nbytes, _tensors(args)))
                           + sum(map(_nbytes, outs)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # hand the op to DTensor: its local ops come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        name = _name(func)
        outs = [t for t in _tensors(out) if self._ours(t)]
        kind = _COLLECTIVE_OF.get(name)
        if kind is not None:
            n = _group_size(args[-1])
            for o in outs[:1]:
                self.collectives[kind] += _nbytes(o) * _wire_factor(kind, n)
                self.collective_counts[kind] += 1
        elif outs and name not in _NO_COUNT:
            self._count(name, func, args, kwargs, outs)
        if self.track_memory:
            for t in outs:
                self._track(t)
        return out

    def totals(self) -> dict[str, float]:
        return {"flops": self.flops, "bytes": self.bytes,
                "matmul_flops": self.matmul_flops}


def count_ops(fn: Callable, *args) -> dict[str, float]:
    """Run ``fn(*args)`` (plain tensors, no mesh; ``meta`` tensors count
    shapes without computing) once under
    :class:`OpCounter`; returns {'flops', 'bytes', 'matmul_flops'} — the
    counterpart of the reference's ``count_jaxpr``."""
    with OpCounter(track_memory=False) as c:
        fn(*args)
    return c.totals()


def collective_bytes(counter: OpCounter) -> dict[str, float]:
    """Per-chip wire bytes by collective kind — the counterpart of the
    reference's ``collective_bytes_hlo``."""
    return dict(counter.collectives)
