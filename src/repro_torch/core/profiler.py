"""Profiler (Algorithm 1, Stage 1).

Port of ``repro.core.profiler``.  Two complementary paths fill the same
``CostTable``:

* ``AnalyticProfiler`` — per-PU analytic cost models (``EdgeSoCCostModel``),
  used when the target PUs don't physically exist.
* ``MeasuredProfiler`` — wall-clock measurement of each fused operator on
  real backends (the paper's extract-and-measure flow, with fewer
  iterations than its 20 warm-up + 200 measured).

CUDA calls return before the card has finished, so every timed call is
fenced with ``torch.cuda.synchronize`` on the devices its inputs and
outputs lie on.  A ``jit=True`` target's cell on a CUDA device is timed
as the lane serves it: the op captured as a CUDA graph
(:mod:`repro_torch.core.capture`) and replayed, inputs copied in and
outputs copied out, as the reference times such a cell jitted.

``trace_fused_ops`` extracts a fused-operator graph from an arbitrary
PyTorch callable via its aten graph (``make_fx``; the reference walks a
jaxpr), applying a backend-compiler-like fusion rule (elementwise /
reduction / layout ops fuse into the preceding anchor op, the paper's
"Conv-BN-ReLU" granularity).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .capture import capture_call
from .costmodel import CostEntry, CostTable, EdgeSoCCostModel
from .op import FusedOp, OpGraph

_log = logging.getLogger(__name__)

# aten op (overload packet name) -> op kind: the reference's jaxpr
# primitive classes, named as aten names them
_ANCHOR_KINDS: dict[str, str] = {
    "mm": "matmul", "bmm": "matmul", "addmm": "matmul",
    "baddbmm": "matmul", "addbmm": "matmul", "mv": "matmul",
    "addmv": "matmul", "dot": "matmul", "matmul": "matmul",
    "convolution": "conv2d",
    "cumsum": "cumsum", "logcumsumexp": "cumsum",
    "scan": "scan", "while_loop": "scan",
    "gather": "gather", "index": "gather", "index_select": "gather",
    "embedding": "gather", "take_along_dim": "gather",
    "scatter": "scatter", "scatter_add": "scatter", "scatter_reduce": "scatter",
    "index_put": "scatter", "index_add": "scatter", "index_copy": "scatter",
    "_fft_r2c": "rdft", "_fft_c2r": "rdft", "_fft_c2c": "rdft",
    "sort": "gather", "argmax": "gather", "topk": "gather",
    "slice_scatter": "scatter", "select_scatter": "scatter",
}
_ELTWISE = {
    "add", "sub", "mul", "div", "maximum", "minimum", "exp", "log", "tanh",
    "sigmoid", "rsqrt", "sqrt", "pow", "neg", "sign", "abs", "erf", "where",
    "clamp", "clamp_min", "clamp_max", "_to_copy", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "lt", "le", "gt", "ge", "eq", "ne",
    "squeeze", "unsqueeze", "cos", "sin", "floor", "ceil", "round",
    "detach", "clone", "copy", "copy_", "real", "imag", "complex", "conj",
    "silu", "gelu", "relu", "softplus", "reciprocal", "log_sigmoid_forward",
    "exp2", "expm1", "log1p", "fill", "masked_fill", "lift_fresh_copy",
}
_REDUCE = {"sum", "amax", "amin", "max", "min", "prod", "mean", "argmin",
           "any", "all", "_softmax", "_log_softmax", "logsumexp", "var",
           "std", "norm", "linalg_vector_norm"}
_LAYOUT = {"view", "reshape", "_unsafe_view", "permute", "transpose", "t",
           "expand", "cat", "stack", "slice", "flip", "constant_pad_nd",
           "arange", "split", "split_with_sizes", "chunk", "unbind",
           "select", "alias", "contiguous", "zeros", "ones", "full",
           "empty", "zeros_like", "ones_like", "full_like", "empty_like",
           "new_zeros", "new_ones", "new_empty", "scalar_tensor",
           "repeat", "roll", "narrow", "diagonal", "unfold", "as_strided"}


def _aten_name(target) -> str:
    """The aten op's name without its overload ("mm" of aten.mm.default),
    or a higher-order op's ("scan")."""
    packet = getattr(target, "_overloadpacket", None)
    if packet is not None:
        return packet.__name__
    name = getattr(target, "name", None)
    if callable(name):
        return name()
    return getattr(target, "__name__", str(target))


def _classify(op_name: str) -> str | None:
    if op_name in _ANCHOR_KINDS:
        return _ANCHOR_KINDS[op_name]
    if op_name in _ELTWISE:
        return "eltwise"
    if op_name in _REDUCE:
        return "reduce"
    if op_name in _LAYOUT:
        return "layout"
    return None


def trace_fused_ops(fn: Callable, *example_args, name: str = "model") -> OpGraph:
    """Extract a fused-operator chain from a PyTorch callable.

    Fusion rule: anchor ops (GEMM/conv/scan/gather/fft/...) start a new
    fused operator; elementwise / reduction / layout ops fuse into the
    current one.  The result is a sequential chain in program order.
    The graph is the aten graph ``make_fx`` records from one call on
    ``example_args``: Python loops are unrolled (the reference's
    ``lax.scan`` over layers is one ``scan`` op; the port's loop over
    layers gives each layer's ops), and a higher-order ``scan`` stays one
    anchor op — it is the fused recurrence kernel.
    """
    from torch.fx.experimental.proxy_tensor import make_fx
    gm = make_fx(fn)(*example_args)
    fused: list[FusedOp] = []
    extra_flops = 0.0
    extra_bytes = 0.0

    def meta_of(node) -> tuple[tuple[int, ...], int]:
        v = node.meta.get("val") if hasattr(node, "meta") else None
        if isinstance(v, (tuple, list)):
            v = v[0] if v else None
        if isinstance(v, torch.Tensor):
            return tuple(int(d) for d in v.shape), int(v.element_size())
        return (), 2

    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        op_name = _aten_name(node.target)
        if op_name == "getitem":
            continue
        kind = _classify(op_name)
        out_shape, dtb = meta_of(node)
        in_shapes = tuple(meta_of(a)[0] for a in node.all_input_nodes
                          if a.op != "get_attr")
        if kind in ("eltwise", "reduce", "layout", None):
            # fuse into the current op
            n_out = float(np.prod(out_shape)) if out_shape else 0.0
            extra_flops += n_out
            extra_bytes += n_out * dtb
            continue
        op = FusedOp(name=f"{name}.{len(fused)}.{op_name}", kind=kind,
                     in_shapes=in_shapes, out_shape=out_shape,
                     dtype_bytes=dtb)
        if fused and (extra_flops or extra_bytes):
            fused[-1].flops += extra_flops
            fused[-1].bytes_moved += extra_bytes
        extra_flops = extra_bytes = 0.0
        fused.append(op)
    if fused and (extra_flops or extra_bytes):
        fused[-1].flops += extra_flops
        fused[-1].bytes_moved += extra_bytes
    if not fused:
        fused = [FusedOp(name=f"{name}.all", kind="other", out_shape=(1,))]
    return OpGraph(fused, edges=None)


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One payload's timing distribution: ``median`` (the robust number
    the cost table consumes), ``best`` (the min — what a noiseless
    machine would report), and the raw ``times`` so jitter is never
    hidden by a single scalar."""

    median: float
    best: float
    times: tuple[float, ...]
    captured: bool = False      # timed as a captured CUDA-graph replay

    @property
    def spread(self) -> float:
        """max/best - 1: the visible jitter of this measurement."""
        return (max(self.times) / self.best - 1.0) if self.best > 0 else 0.0

    def __float__(self) -> float:
        return self.median


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


def fence(*objs) -> None:
    """Wait until the CUDA work behind the tensors in ``objs`` (nested
    tuples/lists allowed) has finished."""
    for dev in {t.device for t in _tensors(objs) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def place(args: Sequence[Any], device) -> tuple:
    """``args`` with every tensor moved to ``device`` (identity when
    ``device`` is None)."""
    if device is None:
        return tuple(args)
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


def _captured(fn: Callable, args: tuple, device):
    """``fn`` as a replay of its capture on ``device``'s CUDA device
    (None where there is none, or the capture fails — the lane then
    serves it eagerly too)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    try:
        cap, _ = capture_call(fn, args, device)
    except Exception as e:
        _log.info("measure_callable_stats: capture failed (%s: %s); "
                  "timing eagerly", type(e).__name__, e)
        return None
    return cap


def measure_callable_stats(fn: Callable, args: Sequence[Any], *,
                           warmup: int = 3, iters: int = 10,
                           jit: bool = True,
                           device: Any = None) -> Measurement:
    """Wall-clock :class:`Measurement` of ``fn(*args)``.

    ``device`` moves the inputs there first (so transfers are not billed
    to the payload).  ``jit=True`` with a CUDA ``device`` times the call
    captured as a CUDA graph and replayed (``captured`` in the result;
    eagerly when the capture fails), ``jit=False`` eagerly.  Every
    warm-up and timed call is fenced on the devices of its inputs and
    outputs: without the fence a CUDA payload times as its launch cost
    alone."""
    args = place(args, device)
    cap = _captured(fn, args, device) if jit else None
    run = fn if cap is None else (lambda *a: cap.replay(a))
    try:
        for _ in range(max(warmup, 1)):   # at least once: first-use builds
            fence(args, run(*args))
        ts = []
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            out = run(*args)
            fence(args, out)
            ts.append(time.perf_counter() - t0)
    finally:
        if cap is not None:
            cap.release()
    return Measurement(median=float(np.median(ts)), best=float(min(ts)),
                       times=tuple(ts), captured=cap is not None)


def measure_callable(fn: Callable, args: Sequence[Any], *, warmup: int = 3,
                     iters: int = 10, jit: bool = True,
                     device: Any = None) -> float:
    """Median wall-clock seconds of ``fn(*args)`` (fenced).  Scalar form
    of :func:`measure_callable_stats`."""
    return measure_callable_stats(fn, args, warmup=warmup, iters=iters,
                                  jit=jit, device=device).median


class AnalyticProfiler:
    """Fill a CostTable from analytic PU models (no hardware needed)."""

    def __init__(self, model: EdgeSoCCostModel | None = None):
        self.model = model or EdgeSoCCostModel()

    def profile(self, graph: OpGraph) -> CostTable:
        return self.model.build_table(graph)


class MeasuredProfiler:
    """Fill the cost table from real wall-clock measurements.

    Two modes share the constructor:

    * **CPU-anchored (default, ``targets=None``).**  The paper's
      offline-profiling stand-in when the PUs don't physically exist:
      measure each payload once on the host, anchor the CPU column, and
      derive the accelerator columns via the analytic per-PU ratios.
    * **Per-target (``targets={lane: Target}``).**  The real loop: each
      op's resolved payload variant (``op.payload_for(target.dialect)``)
      is measured *on every bound backend*, its inputs moved to the
      target's device, and each measurement lands directly in that
      lane's column (``kernel`` = median; ``dispatch``/``h2d``/``d2h``/
      ``power`` from the target's declared pricing), as a captured
      replay on a ``jit`` target's CUDA device.  Full distributions
      go to ``table.meta["measurements"]``
      (``{(op, lane): {"median", "best", "spread", "captured"}}``).
      Payload-less ops fall back to the analytic CPU estimate on every
      lane (noted in ``table.meta["analytic_fallback"]``); an op a
      target declares in ``meta["unsupported_on"]`` gets no cell on
      that lane.

    A measurement that *fails* is never silently swallowed: each failure
    is logged, collected into the returned table's
    ``meta["profile_failures"]`` (``{op index: "ExcType: message"}`` in
    CPU-anchored mode, ``{(op index, lane): ...}`` per-target — where a
    failed cell is *omitted*, i.e. the op is unsupported on that
    backend), and under ``strict=True`` re-raised with the op named
    instead of falling back.
    """

    def __init__(self, model: EdgeSoCCostModel | None = None,
                 warmup: int = 2, iters: int = 5, strict: bool = False,
                 targets=None):
        from .targets import resolve_targets
        self.model = model or EdgeSoCCostModel()
        self.warmup = warmup
        self.iters = iters
        self.strict = strict
        self.targets = resolve_targets(targets)

    def profile(self, graph: OpGraph,
                strict: bool | None = None) -> CostTable:
        strict = self.strict if strict is None else strict
        if self.targets is not None:
            return self._profile_targets(graph, strict)
        failures: dict[int, str] = {}
        table = CostTable(list(self.model.pus))
        table.meta["profile_failures"] = failures
        for i, op in enumerate(graph.ops):
            analytic = {name: self.model.entry(op, pu)
                        for name, pu in self.model.pus.items()}
            cpu_est = analytic.get("CPU")
            measured = None
            if op.fn is not None and "example_inputs" in op.meta:
                try:
                    measured = measure_callable(
                        op.fn, op.meta["example_inputs"],
                        warmup=self.warmup, iters=self.iters)
                except Exception as e:
                    if strict:
                        raise RuntimeError(
                            f"MeasuredProfiler: measuring op {i} "
                            f"({op.name!r}, kind {op.kind!r}) failed"
                        ) from e
                    failures[i] = f"{type(e).__name__}: {e}"
                    _log.warning(
                        "MeasuredProfiler: op %d (%s) measurement failed "
                        "(%s); falling back to the analytic CPU estimate",
                        i, op.name, failures[i])
                    measured = None
            scale = (measured / cpu_est.kernel
                     if (measured and cpu_est and cpu_est.kernel > 0) else 1.0)
            for name, e in analytic.items():
                if e is None:
                    continue
                table.set(i, name, CostEntry(
                    kernel=e.kernel * scale, dispatch=e.dispatch,
                    h2d=e.h2d, d2h=e.d2h, power=e.power))
        return table

    # -- per-target mode ----------------------------------------------------
    def _analytic_anchor(self, op: FusedOp) -> CostEntry | None:
        """Analytic estimate for payload-less ops: the model's CPU spec
        (any host spec if "CPU" is absent)."""
        pu = self.model.pus.get("CPU")
        if pu is None:
            pu = next(iter(self.model.pus.values()))
        return self.model.entry(op, pu)

    def _profile_targets(self, graph: OpGraph, strict: bool) -> CostTable:
        """Measure every op on every bound backend; see the class docs."""
        targets = self.targets
        failures: dict[tuple[int, str], str] = {}
        stats: dict[tuple[int, str], dict] = {}
        fallback: list[tuple[int, str]] = []
        table = CostTable(list(targets))
        table.meta["profile_failures"] = failures
        table.meta["measurements"] = stats
        table.meta["analytic_fallback"] = fallback
        table.meta["targets"] = {lane: t.name for lane, t in targets.items()}
        for i, op in enumerate(graph.ops):
            unsupported = op.meta.get("unsupported_on", ())
            for lane, tgt in targets.items():
                if lane in unsupported or tgt.name in unsupported:
                    continue
                fn = op.payload_for(tgt.dialect)
                if fn is None or "example_inputs" not in op.meta:
                    est = self._analytic_anchor(op)
                    if est is None:
                        continue
                    fallback.append((i, lane))
                    table.set(i, lane, CostEntry(
                        kernel=est.kernel, dispatch=tgt.dispatch_s,
                        h2d=tgt.handoff_s, d2h=tgt.handoff_s,
                        power=tgt.power_compute))
                    continue
                try:
                    m = measure_callable_stats(
                        fn, op.meta["example_inputs"],
                        warmup=self.warmup, iters=self.iters,
                        jit=tgt.jit, device=tgt.device)
                except Exception as e:
                    if strict:
                        raise RuntimeError(
                            f"MeasuredProfiler: measuring op {i} "
                            f"({op.name!r}, kind {op.kind!r}) on target "
                            f"{tgt.name!r} (lane {lane!r}) failed") from e
                    failures[(i, lane)] = f"{type(e).__name__}: {e}"
                    _log.warning(
                        "MeasuredProfiler: op %d (%s) failed on target %s "
                        "(%s); cell omitted — op unsupported on this lane",
                        i, op.name, tgt.name, failures[(i, lane)])
                    continue
                stats[(i, lane)] = {"median": m.median, "best": m.best,
                                    "spread": m.spread,
                                    "captured": m.captured}
                table.set(i, lane, CostEntry(
                    kernel=m.median, dispatch=tgt.dispatch_s,
                    h2d=tgt.handoff_s, d2h=tgt.handoff_s,
                    power=tgt.power_compute))
        return table
