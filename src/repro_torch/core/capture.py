"""Calls captured as CUDA graphs: the port's counterpart of ``jax.jit``.

The reference package compiles each lane segment with ``jax.jit`` and
times a ``jit=True`` target's cells jitted.  PyTorch runs eagerly, and
on this path the host's time to issue a segment's kernels is what bounds
it, so the port captures the call once as a ``torch.cuda.CUDAGraph`` and
replays it: one launch for the whole call.

:func:`capture_call` captures ``fn(*args)`` over tensor arguments on one
CUDA device:

* **Streams.**  Capture cannot run on the legacy default stream.  When
  the caller's current stream is the default one, the call is captured
  on a side stream (one per device) that first waits on the current
  stream; otherwise — a lane's own stream in a threaded program — on the
  current stream.  ``fn`` runs once eagerly on that stream just before
  the capture, so lazy per-stream state (cuBLAS workspaces) is set up
  outside it.  Capture uses ``capture_error_mode="thread_local"``, so
  launches and allocations of other threads (other lanes) during a
  capture do not break it.  Each graph has its own memory pool.
* **Static buffers.**  The graph reads fixed input tensors (clones of
  the arguments it was captured with) and writes fixed output tensors.
  :meth:`CapturedCall.replay` copies new arguments into the inputs on
  the current stream (from the host too; an argument that *is* its
  static input is not copied, so state the graph updates in place, like
  a decode step's cache, stays where it is), replays the graph there and
  returns *clones* of the outputs, so no run's outputs are overwritten by
  a later run.  A replay is valid only for the arguments' signature at
  capture (shapes, dtypes, devices: :func:`arg_signature`); the caller
  checks it.
* **Counts.**  A captured kernel wrapper does not launch, so the
  kernels' launches (and any other count the captured Python makes) are
  recorded at capture time (:func:`repro_torch.tracing.recording`) and
  added to the counters at every replay, with ``capture.copy_in_bytes``
  (the arguments copied into the static inputs) and
  ``capture.clone_bytes`` (the outputs' clones, sized once at capture).
* **Spans.**  ``capture.capture`` around a capture; ``capture.replay``
  around a replay, holding ``capture.copy_in``, ``capture.graph`` (the
  graph's launch) and ``capture.clone_out``.

Nothing here syncs the host.  Anything in ``fn`` that does (``.item()``,
``nonzero``, a copy from pageable host memory) makes the capture raise,
and the caller runs eagerly instead.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Sequence

import torch

from .. import tracing

_side: dict[torch.device, torch.cuda.Stream] = {}
_side_lock = threading.Lock()


def arg_signature(a) -> tuple:
    """(shape, dtype, device) of one input, without copying it to the
    host."""
    return (tuple(a.shape), str(a.dtype), str(getattr(a, "device", "")))


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    with _side_lock:
        s = _side.get(device)
        if s is None:
            s = _side[device] = torch.cuda.Stream(device=device)
        return s


def _as_tuple(out) -> tuple | None:
    """``out`` as a tuple of tensors, or None when it is not a tensor or
    a tuple of them."""
    outs = out if isinstance(out, tuple) else (out,)
    return outs if all(isinstance(o, torch.Tensor) for o in outs) else None


class CapturedCall:
    """One captured call: the graph, its static input and output tensors
    and the kernel launches it replays (see the module docs)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, static_in: tuple,
                 static_out: tuple, single: bool,
                 launches: collections.Counter):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.single = single
        # what each replay adds to the counters
        self.counts = collections.Counter(launches)
        self.counts["capture.clone_bytes"] = sum(o.nbytes
                                                 for o in static_out)
        self._streams: set[int] = set()

    def replay(self, args: Sequence[torch.Tensor]):
        """Copy ``args`` into the static inputs, replay the graph on the
        current stream and return clones of its outputs (one tensor or a
        tuple, as the captured call returned)."""
        stream = torch.cuda.current_stream(self.static_out[0].device)
        if stream.stream_id not in self._streams:
            # the static tensors are used on this stream from now on: the
            # caching allocator must not hand their memory to another
            # stream while it may still run here
            self._streams.add(stream.stream_id)
            for t in self.static_in + self.static_out:
                t.record_stream(stream)
        with tracing.span("capture.replay"):
            copied = 0
            with tracing.span("capture.copy_in"):
                for buf, a in zip(self.static_in, args):
                    if a is not buf:    # a static input handed back as is
                        buf.copy_(a)
                        copied += buf.nbytes
            with tracing.span("capture.graph"):
                self.graph.replay()
            tracing.add(self.counts)
            tracing.count("capture.copy_in_bytes", copied)
            with tracing.span("capture.clone_out"):
                outs = tuple(o.clone() for o in self.static_out)
        return outs[0] if self.single else outs

    def release(self) -> None:
        """Drop the graph and its memory pool (idempotent)."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
            self.static_in = self.static_out = ()


def capture_call(fn: Callable[..., Any], args: Sequence[torch.Tensor],
                 device) -> tuple[CapturedCall, Any]:
    """Capture ``fn(*args)`` on CUDA ``device`` (see the module docs).

    Returns the :class:`CapturedCall` and the outputs of the eager run
    made on the capture stream just before the capture.  Raises when
    ``fn`` cannot be captured: an argument or output that is not a tensor
    on ``device``, or anything ``fn`` does that a capture refuses."""
    device = torch.device(device)
    if not all(isinstance(a, torch.Tensor) and a.device == device
               for a in args):
        raise TypeError("capture_call: every argument must be a tensor on "
                        f"{device}")
    with tracing.span("capture.capture"):
        return _capture_call(fn, args, device)


def _capture_call(fn, args, device) -> tuple[CapturedCall, Any]:
    cur = torch.cuda.current_stream(device)
    side = cur == torch.cuda.default_stream(device)
    stream = _side_stream(device) if side else cur
    static_in = tuple(a.clone() for a in args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        if side:
            stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            eager = fn(*static_in)
            with tracing.recording() as launches:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = fn(*static_in)
                finally:
                    graph.capture_end()
        if side:
            cur.wait_stream(stream)
            for t in _as_tuple(eager) or ():
                t.record_stream(cur)
    outs = _as_tuple(out)
    if outs is None or not all(o.device == device for o in outs):
        graph.reset()
        raise TypeError("capture_call: the call must return tensors on "
                        f"{device}")
    return CapturedCall(graph, static_in, outs, not isinstance(out, tuple),
                        launches), eager
