"""Compiled lane programs: the segment-fused execution path.

Port of ``repro.core.laneprogram``.  A :class:`LaneProgram` removes the
per-op interpreter's dispatch and event overhead in two moves:

* **Segment partitioning.**  Each PU lane's FIFO queue is cut into
  *maximal contiguous same-lane segments*: a new segment starts only at
  a cross-lane boundary (an op whose predecessor ran on another lane —
  the handoff points), after an op whose output another lane reads (a
  fork: the consumer waits for that op, not for the rest of the
  producer's lane), at a request switch on a shared lane, or at a
  co-scheduled concurrent step (co-scheduled ops stay individually
  dispatched so the granularity the contention laws priced is preserved
  — they become single-op *barrier* segments).  The segments of a
  sequential chain admit one order, and the program runs them inline,
  with no threads or events at all.  A program whose segments can
  co-execute (parallel branches, concurrent requests) runs one worker
  thread per lane (:class:`LanePool`), with one event per segment,
  waited on only across the boundary cuts.

* **Segment composition with verified variants.**  Each segment's op
  payloads compose into one callable.  On a lane bound to a
  :class:`~repro_torch.core.targets.Target` the segment keeps the
  reference payloads as its oracle and resolves the target dialect's
  variants; the first (*cold*) run serves the reference outputs and
  probes every variant op against them, each fed the reference
  composition's own inputs — accepted when bitwise equal, else when
  within the target's per-dtype or declared tolerance, else rejected
  (the segment then serves the reference for good).  A variant is never
  served unverified.  A kernel-dialect variant that fails to run raises
  instead (:data:`KERNEL_DIALECTS`).

* **Segment capture: the counterpart of the reference's ``jax.jit``.**
  On a lane whose target jits (``Target.jit``) and runs on a CUDA
  device, the cold run then captures whichever composition the segment
  serves as a CUDA graph (:mod:`repro_torch.core.capture`) and keeps it
  by the reference's rule: its replay must match the eager composition
  on the probe inputs and on a perturbed copy of them (:func:`_perturb`),
  bitwise on both legs, or within the target's *declared* tolerance
  (``atol``/``rtol``) on both.  ``jit_verified`` records which rule
  admitted it and the segment's mode becomes ``JIT``: warm runs copy the
  inputs into the graph's static buffers, replay it in one launch and
  hand out copies of its outputs.  Anything else — a capture that
  raises (a payload that syncs the host), outputs that are not tensors
  on the device, a leg that disagrees — leaves the segment eager with
  ``jit_verified = None`` and the reason in ``capture_error``; it changes
  no device and no kernel.  A replay serves only the input signature
  (shapes, dtypes, devices) it was captured at; other inputs run eagerly.

**Devices and streams.**  Every segment of a device-bound target moves
its inputs to the target's device before running — the reference
composition, the probe and every warm run alike — so a lane never
computes on the device its inputs happened to arrive on.  A program run
inline launches all its CUDA work on the caller's current stream, so the
stream itself orders every handoff.  A threaded program gives each CUDA
lane a stream of its own, made once per program: the lane's worker runs
every task inside ``torch.cuda.device(dev)`` and
``torch.cuda.stream(lane_stream)``, and the kernels' wrappers launch on
that stream (``torch.cuda.current_stream()`` is per thread).  Streams do
not order each other, so every handoff out of a CUDA lane carries a
``torch.cuda.Event`` recorded on the producer's stream and published
with the segment's ``threading.Event``:

* a consumer on another CUDA lane makes its stream wait on it
  (``Stream.wait_event``) before it launches, and marks the tensors it
  reads with ``record_stream`` so the caching allocator does not hand
  their memory back to the producer's stream while it still reads them;
* a consumer on a host lane waits on the host for the event before its
  ``.to("cpu")`` copies (which run on the host thread's stream, not the
  producer's), polling ``Event.query()`` under the run's deadline
  (:meth:`~repro_torch.core.faults.RunContext.wait_device`): no wait is
  unbounded, and an asynchronous CUDA error surfaces there as a typed
  :class:`~repro_torch.core.errors.ExecutionError`.

Each lane's stream first waits on the caller's current stream (the
inputs may still be in flight there), and ``run`` ends with the caller's
current stream waiting on every lane's last event, so the outputs it
returns are complete on the caller's stream (they are marked with
``record_stream`` for it).  ``run`` itself does not wait for the card.

Op payloads must be **pure** on this path: the cold run executes the
reference and the variant payloads, and warm runs replay the composed
callable — a payload with internal state would advance differently
than under the per-op interpreter, which remains the oracle
(``Orchestrator.execute(..., compile=False)``).  Purity is also what
makes the fault runtime's segment-granularity retry safe
(:mod:`repro_torch.core.faults`).  A program's first ``run`` settles its
segments' probes, so one program must not be run from two threads at
once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..fault.manager import RecoverableError
from .capture import arg_signature as _arg_signature
from .capture import capture_call
from .errors import ExecutionError, PULostError
from .faults import (_JOIN_GRACE, ExecutionPolicy, FaultPlan, RunContext,
                     _Aborted, run_with_retries)
from .op import OpGraph
from .profiler import _tensors, place
from .targets import KERNEL_DIALECTS, variant_tolerance

# segment execution modes
COLD = "cold"        # not yet run: the next run probes, then captures
WARM = "warm"        # settled, eager: the verified variant or the reference
JIT = "jit"          # settled, captured: replays a verified CUDA graph

_BITS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def _tensor(x):
    return torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) \
        else x


def _bitwise_equal(a, b) -> bool:
    """True iff two payload outputs are bitwise identical (dtype, shape
    and raw bits, compared on ``a``'s device — ``allclose`` is
    deliberately not used here)."""
    if a is None or b is None:
        return a is None and b is None
    a, b = _tensor(a), _tensor(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    b = b.to(a.device)
    if a.is_floating_point():          # compare bits, not values
        bits = _BITS[a.element_size()]
        a = a.contiguous().view(bits)
        b = b.contiguous().view(bits)
    return bool(torch.equal(a, b))


def _perturb(x):
    """A same-shape/dtype input with different float values, for the
    second leg of capture verification: ``x * 0.7371 + 0.1113`` in the
    input's own dtype, bitwise as the reference computes it on a NumPy
    array (non-floats pass through)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return x
    a = torch.tensor(0.7371, dtype=x.dtype, device=x.device)
    b = torch.tensor(0.1113, dtype=x.dtype, device=x.device)
    return x * a + b


def _capture_device(target) -> torch.device | None:
    """The CUDA device a segment bound to ``target`` captures on, or None:
    a target that does not jit, or has no CUDA device, never captures."""
    device = None if target is None or not target.jit else target.device
    if device is None or torch.device(device).type != "cuda":
        return None
    return torch.device(device)


def _capture(fn: Callable, args: Sequence, device):
    """The capture seam: ``fn(*args)`` captured on ``device``; returns
    (a captured call with ``replay(args)`` and ``release()``, the eager
    outputs of ``fn(*args)`` it ran first)."""
    return capture_call(fn, args, device)


def results_bitwise_equal(a: Mapping[int, Any], b: Mapping[int, Any]) -> bool:
    """Bitwise comparison of two executor results dicts (the strict form
    of ``ScheduleExecutor.outputs_close``: dtypes and bits must match)."""
    if set(a) != set(b):
        return False
    return all(_bitwise_equal(a[k], b[k]) for k in a)


def probe_error(ref, got, target=None) -> tuple[float, float, float]:
    """How far a variant output is from the reference output, in
    float64: (max |got - ref|, that over max |ref| — the error normalised
    by the output's largest magnitude —, and the least atol that would
    pass ``allclose`` at the target's rtol for this dtype).  NaNs for
    outputs that are not comparable floats."""
    a, b = _tensor(ref), _tensor(got)
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.is_floating_point() and a.shape == b.shape
            and a.numel()):
        return float("nan"), float("nan"), float("nan")
    rtol = (target.tolerance(a.dtype) if target is not None
            else variant_tolerance(a.dtype))[1]
    a = a.double()
    diff = (b.to(a.device).double() - a).abs()
    err = float(diff.max())
    scale = float(a.abs().max())
    need = max(float((diff - rtol * a.abs()).max()), 0.0)
    return err, (err / scale if scale > 0 else err), need


def _within_tolerance(ref, got, target) -> bool:
    """Variant-vs-reference closeness at the target's per-dtype tolerance
    bucket (non-float outputs must be bitwise; shape/dtype must match)."""
    if ref is None or got is None:
        return ref is None and got is None
    a, b = _tensor(ref), _tensor(got)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return _bitwise_equal(a, b)
    atol, rtol = (target.tolerance_for(a) if target is not None
                  else variant_tolerance(a.dtype))
    if atol == 0.0 and rtol == 0.0:
        return _bitwise_equal(a, b)
    return bool(torch.allclose(a.double(), b.to(a.device).double(),
                               atol=atol, rtol=rtol))


@dataclasses.dataclass
class Segment:
    """A maximal run of same-lane ops composed into one callable.

    ``items`` are ``(request, op)`` pairs in lane-queue order; ``deps``
    are indices of segments on *other* lanes whose outputs this segment
    reads (same-lane predecessors are implicit in FIFO order).  A
    ``barrier`` segment holds exactly one co-scheduled concurrent-step op
    and is never fused with its neighbours.

    When the lane is bound to a :class:`~repro_torch.core.targets.Target`,
    ``fns`` holds the reference payloads (the probe oracle) and
    ``var_fns`` the target-dialect variants; the cold run verifies each
    variant op against the reference outputs before any is ever served.
    ``verified`` records the outcome (``"bitwise"`` / ``"tolerance"`` /
    ``"rejected"`` / ``"error: ..."``, the last for non-kernel dialects
    only) and
    ``probe_errors`` the per-op ``probe_error`` of a non-bitwise probe.
    ``jit_verified`` records which rule admitted the segment's captured
    graph (``"bitwise"`` / ``"tolerance"``, None when it runs eagerly),
    ``capture_error`` why a capture was not kept.
    """

    index: int
    lane: str
    barrier: bool = False
    target: Any = None
    items: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    fns: list[Callable | None] = dataclasses.field(default_factory=list)
    var_fns: list[Callable | None] | None = None
    use_variant: bool = False
    verified: str | None = None
    probe_errors: list[tuple[float, float, float]] | None = None
    jit_verified: str | None = None
    capture_error: str | None = None
    deps: list[int] = dataclasses.field(default_factory=list)
    # results of other segments this segment reads, in flat order
    flat_refs: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    # per item: arg sources after the op's external inputs — ("f", j) is
    # flat input j (another segment's output), ("o", t) is item t's output
    argspecs: list[list[tuple[str, int]]] = dataclasses.field(
        default_factory=list)
    # one descriptive wait label per entry of ``deps`` (watchdog messages)
    dep_whats: list[str] = dataclasses.field(default_factory=list)
    mode: str = COLD
    _graph: Any = dataclasses.field(default=None, repr=False)
    _sig: tuple | None = dataclasses.field(default=None, repr=False)

    # -- composition --------------------------------------------------------
    def _compose(self, fns: Sequence[Callable | None], flat: tuple,
                 ext_lists: tuple, feed: Sequence[Any] | None = None
                 ) -> tuple:
        """Run every op of the segment over a payload list.  Arg order
        per op matches the interpreter exactly: external inputs first,
        then predecessor outputs in ``graph.pred`` order.  ``feed``, when
        given, supplies the segment-internal predecessor outputs in place
        of the ones this composition computes (the probe feeds every
        variant op the reference composition's own inputs)."""
        outs: list[Any] = []
        for t, spec in enumerate(self.argspecs):
            fn = fns[t]
            if fn is None:
                outs.append(None)
                continue
            internal = outs if feed is None else feed
            deps = tuple(flat[j] if kind == "f" else internal[j]
                         for kind, j in spec)
            outs.append(fn(*(tuple(ext_lists[t]) + deps)))
        return tuple(outs)

    def _place(self, flat: tuple, ext_lists: tuple) -> tuple[tuple, tuple]:
        """Move segment inputs to the bound target's device (identity
        when no target/device is bound)."""
        device = None if self.target is None else self.target.device
        return place(flat, device), tuple(place(e, device) for e in ext_lists)

    def _gather(self, results: Sequence[dict], ext: Sequence[dict]):
        flat = tuple(results[r][p] for r, p in self.flat_refs)
        ext_lists = tuple(tuple(ext[r].get(i, ())) for r, i in self.items)
        return flat, ext_lists

    def _leaves(self, flat: tuple, ext_lists: tuple) -> list:
        """The segment's inputs as one flat list (a captured graph's
        arguments): the flat inputs, then each item's external ones."""
        return list(flat) + [v for e in ext_lists for v in e]

    def execute(self, results: Sequence[dict], ext: Sequence[dict]) -> None:
        flat, ext_lists = self._gather(results, ext)
        sig = None
        if self.mode != WARM:
            leaves = self._leaves(flat, ext_lists)
            sig = (tuple(_arg_signature(v) for v in leaves)
                   if all(isinstance(v, torch.Tensor) for v in leaves)
                   else None)
            if self.mode == JIT and sig == self._sig:
                outs = self._graph.replay(leaves)
                for (r, i), o in zip(self.items, outs):
                    results[r][i] = o
                return
        flat, ext_lists = self._place(flat, ext_lists)
        if self.use_variant:
            outs = self._compose(self.var_fns, flat, ext_lists)
        else:
            outs = self._compose(self.fns, flat, ext_lists)
            if self.mode == COLD:
                self._settle(flat, ext_lists, outs, sig)
        for (r, i), o in zip(self.items, outs):
            results[r][i] = o

    def _settle(self, flat, ext_lists, outs, sig) -> None:
        """Cold-run settling.  ``outs`` are the eager *reference* outputs
        (what this cold run serves — a variant is never served
        unverified).  Order of business: probe the target variant
        against them, then capture whichever composition survived,
        honouring the target's jit policy."""
        if self.var_fns is not None:
            self._verify_variant(flat, ext_lists, outs)
        self.mode = WARM
        self._maybe_compile(flat, ext_lists, sig)

    def _maybe_compile(self, flat, ext_lists, sig) -> None:
        """Capture the served composition as a CUDA graph where the
        target jits on a CUDA device and every input is a tensor, and
        keep it only if :meth:`_jit_verify` admits it."""
        device = _capture_device(self.target)
        if device is None:
            return
        fns = self.var_fns if self.use_variant else self.fns
        if sig is None or any(fn is None for fn in fns):
            self.capture_error = "an input or a payload is not a tensor op"
            return
        self._jit_verify(fns, flat, ext_lists, sig, device)

    def _jit_verify(self, fns, flat, ext_lists, sig, device) -> None:
        """The reference's jit probe, for a captured graph: its replay
        must match the eager composition on the probe inputs and on a
        perturbed copy of them — bitwise on both legs, or within the
        target's declared tolerance (``atol``/``rtol``) on both.  On
        success the graph is kept for warm runs, ``mode`` flips to JIT
        and ``jit_verified`` records which rule admitted it; anything
        else (a capture that raises included) leaves the segment eager."""
        tgt = self.target
        declared = tgt is not None and bool(tgt.atol or tgt.rtol)

        def admit(ref_o, got_o):
            if len(got_o) != len(ref_o):
                return None
            if all(_bitwise_equal(a, b) for a, b in zip(ref_o, got_o)):
                return "bitwise"
            if declared and all(_within_tolerance(a, b, tgt)
                                for a, b in zip(ref_o, got_o)):
                return "tolerance"
            return None

        n_flat, sizes = len(flat), [len(e) for e in ext_lists]

        def composed(*leaves):
            rest = iter(leaves[n_flat:])
            return self._compose(fns, tuple(leaves[:n_flat]), tuple(
                tuple(next(rest) for _ in range(k)) for k in sizes))

        leaves = self._leaves(flat, ext_lists)
        cap, how = None, None
        try:
            cap, eager = _capture(composed, leaves, device)
            how = admit(tuple(eager), tuple(cap.replay(leaves)))
            if how is None:
                self.capture_error = "the replay differs on the probe inputs"
            else:
                leaves2 = [_perturb(v) for v in leaves]
                how2 = admit(composed(*leaves2), tuple(cap.replay(leaves2)))
                if how2 is None:
                    self.capture_error = ("the replay differs on the "
                                          "perturbed inputs")
                how = (None if how2 is None
                       else ("bitwise" if how == how2 == "bitwise"
                             else "tolerance"))
        except Exception as e:
            how = None
            self.capture_error = f"{type(e).__name__}: {e}"
        if how is None:
            if cap is not None:
                cap.release()
            return
        self._graph, self._sig = cap, sig
        self.jit_verified = how
        self.capture_error = None
        self.mode = JIT

    def _drop_capture(self) -> None:
        """Release the captured graph; the segment runs eagerly from now
        on (``jit_verified`` keeps what the probe found)."""
        if self._graph is not None:
            self._graph.release()
            self._graph = None
        if self.mode == JIT:
            self.mode = WARM

    def _verify_variant(self, flat, ext_lists, ref_outs) -> None:
        """Probe the variants against the reference outputs (which this
        cold run serves), op by op: each variant op runs on the inputs
        its reference op ran on, so it is held to its own error, not to
        the upstream ops' error as the chain amplifies it.  (The
        reference package probes the variant composition whole; at the
        main path's width that measures the chain's conditioning rather
        than any one kernel.)  Accepts on bitwise equality, else on the
        target's tolerance; rejection drops ``var_fns`` so the segment
        permanently serves the reference payloads, and so does an
        execution error — except on a kernel dialect, where it raises
        (the segment stays cold, so a rerun probes again)."""
        try:
            got = self._compose(self.var_fns, flat, ext_lists,
                                feed=ref_outs)
        except Exception as e:
            if self.target.dialect in KERNEL_DIALECTS:
                raise RuntimeError(
                    f"segment {self.index} on lane {self.lane!r}: the "
                    f"{self.target.dialect!r} variant failed in its "
                    f"probe: {type(e).__name__}: {e}") from e
            self.verified = f"error: {type(e).__name__}: {e}"
            self.var_fns = None
            return
        if len(got) == len(ref_outs) and all(
                _bitwise_equal(a, b) for a, b in zip(ref_outs, got)):
            self.verified = "bitwise"
            self.use_variant = True
            return
        self.probe_errors = [probe_error(a, b, self.target)
                             for a, b in zip(ref_outs, got)]
        if len(got) == len(ref_outs) and all(
                _within_tolerance(a, b, self.target)
                for a, b in zip(ref_outs, got)):
            self.verified = "tolerance"
            self.use_variant = True
        else:
            self.verified = "rejected"
            self.var_fns = None


class SegmentTime(NamedTuple):
    """One segment of a run, as ``LaneProgram.run(trace=...)`` records
    it: its lane, its ``(request, op)`` items, the host's wall seconds
    for its call (for a CUDA lane: the time to issue its work, which the
    card may finish later), and its start in seconds from the run's
    start."""

    lane: str
    items: tuple
    seconds: float
    start: float


def _current_stream(device):
    """The calling thread's current stream on ``device``."""
    return torch.cuda.current_stream(device)


def _cuda_device_of(value):
    """The device of the first CUDA tensor in ``value``, else None."""
    for t in _tensors(value):
        if t.is_cuda:
            return t.device
    return None


def _on_stream(device, stream) -> contextlib.ExitStack:
    """Enter ``device`` and make ``stream`` this thread's current
    stream."""
    ctx = contextlib.ExitStack()
    ctx.enter_context(torch.cuda.device(device))
    ctx.enter_context(torch.cuda.stream(stream))
    return ctx


class LanePool:
    """Persistent lane workers: one daemon thread + FIFO task queue per
    lane (the command-queue model, kept warm across runs so thread spawn
    cost never lands on the dispatch path).

    ``streams`` maps a CUDA lane to its ``(device, stream)``: that
    lane's worker runs every task on its device with the stream as its
    current stream, so everything the task launches goes to the lane's
    stream.

    Threads are **daemon** deliberately: a payload that hangs in native
    code past the watchdog budget wedges its worker, and a non-daemon
    thread would then block interpreter exit forever.  The watchdog
    backstop drops the whole pool (``shutdown``) and the next run builds
    a fresh one; wedged daemon workers leak harmlessly.
    """

    def __init__(self, lanes: Sequence[str],
                 streams: Mapping[str, tuple] | None = None):
        self._queues: dict[str, queue.SimpleQueue] = {}
        streams = streams or {}
        for pu in lanes:
            q: queue.SimpleQueue = queue.SimpleQueue()
            self._queues[pu] = q
            threading.Thread(target=self._worker,
                             args=(q, streams.get(pu)),
                             name=f"lane-{pu}", daemon=True).start()

    @staticmethod
    def _worker(q: "queue.SimpleQueue", stream: tuple | None) -> None:
        while True:
            task = q.get()
            if task is None:
                return
            fn, done = task
            try:
                if stream is None:
                    fn()
                else:
                    with _on_stream(*stream):
                        fn()
            except BaseException:   # submitted fns do their own reporting
                pass
            finally:
                done.set()

    def submit(self, lane: str, fn: Callable[[], None]) -> threading.Event:
        """Enqueue ``fn`` on ``lane``; the returned event is set when it
        finishes (success or not — errors are the fn's job to record)."""
        done = threading.Event()
        self._queues[lane].put((fn, done))
        return done

    def shutdown(self) -> None:
        for q in self._queues.values():
            q.put(None)


class LaneProgram:
    """A compiled plan: per-lane segment lists + cross-lane handoff deps.

    Build with :func:`compile_lane_program` (or the ``ScheduleExecutor``
    ``compile_*`` wrappers); ``run(external_inputs)`` returns the same
    results shape as the interpreter (``run_scheduled`` for
    single-graph programs, ``run_concurrent`` for M-request programs).
    """

    def __init__(self, graphs: Sequence[OpGraph],
                 segments: list[Segment],
                 lane_segments: dict[str, list[Segment]],
                 single: bool):
        self.graphs = list(graphs)
        self.segments = segments
        self.lane_segments = lane_segments
        self.lanes = [pu for pu, segs in lane_segments.items() if segs]
        self.single = single
        self.n_requests = len(self.graphs)
        self.runs = 0
        # a program whose segment DAG (handoff deps + per-lane FIFO
        # order) admits exactly ONE topological order is inherently
        # serial: run() executes it inline, with no threads and no
        # events.  Sequential chains always qualify; programs with real
        # co-execution (parallel branches, concurrent requests) keep
        # persistent lane workers, one CUDA stream per CUDA lane.
        self.serial_order = self._serial_order()
        self._pool: LanePool | None = None
        self._streams: dict[str, tuple] | None = None
        # segments whose completion another lane waits on, plus each
        # lane's last: the ones that publish a CUDA event when their
        # lane has a stream
        self._publish = {d for s in segments for d in s.deps} | {
            segs[-1].index for segs in lane_segments.values() if segs}
        # identity snapshot of every covered op's fn + variant table,
        # taken at compile time (see payloads_current)
        self._payload_tokens: dict[tuple[int, int], tuple] = {
            (r, i): self.graphs[r].ops[i].payload_token()
            for seg in segments for (r, i) in seg.items}

    def payloads_current(self) -> bool:
        """True while every op's payload *and variant table* are still
        the ones baked in at compile time; the orchestrator recompiles on
        a mismatch, so a stale composition is never served."""
        for (r, i), (fn0, var0) in self._payload_tokens.items():
            op = self.graphs[r].ops[i]
            if op.fn is not fn0:
                return False
            variants = op.variants
            if len(variants) != len(var0):
                return False
            for key, f in var0:
                if variants.get(key) is not f:
                    return False
        return True

    def close(self) -> None:
        """Release the persistent lane-worker pool and the segments'
        captured graphs with their memory pools (idempotent; a later
        ``run`` lazily recreates the pool and runs those segments
        eagerly).  Called on cache eviction so idle worker threads and
        graphs don't outlive the program's cache entry."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        for seg in self.segments:
            seg._drop_capture()

    def _serial_order(self) -> list[Segment] | None:
        n = len(self.segments)
        indeg = [0] * n
        succ: list[list[int]] = [[] for _ in range(n)]
        for s in self.segments:
            for d in s.deps:
                succ[d].append(s.index)
                indeg[s.index] += 1
        for segs in self.lane_segments.values():
            for a, b in zip(segs, segs[1:]):
                succ[a.index].append(b.index)
                indeg[b.index] += 1
        ready = [i for i in range(n) if indeg[i] == 0]
        order: list[int] = []
        while ready:
            if len(ready) > 1:
                return None            # two segments could co-execute
            u = ready.pop()
            order.append(u)
            for v in succ[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        return [self.segments[i] for i in order] if len(order) == n else None

    def lane_streams(self) -> dict[str, tuple]:
        """``{lane: (device, stream)}`` of the program's CUDA lanes (the
        lanes bound to a target on a CUDA device), made at the first
        threaded run and kept for the program's life."""
        if self._streams is None:
            streams = {}
            for pu in self.lanes:
                tgt = self.lane_segments[pu][0].target
                dev = None if tgt is None else tgt.device
                if dev is not None and torch.device(dev).type == "cuda":
                    dev = torch.device(dev)
                    streams[pu] = (dev, torch.cuda.Stream(device=dev))
            self._streams = streams
        return self._streams

    @property
    def stats(self) -> dict:
        """Structure + verification summary (verdicts settle after the
        first ``run``; before it every segment reports ``cold``)."""
        return {
            "n_ops": sum(len(s.items) for s in self.segments),
            "n_segments": len(self.segments),
            "n_jitted": sum(1 for s in self.segments if s.mode == JIT),
            "n_cold": sum(1 for s in self.segments if s.mode == COLD),
            "n_barrier": sum(1 for s in self.segments if s.barrier),
            "n_variant": sum(1 for s in self.segments if s.use_variant),
            "variant_verified": {s.index: s.verified for s in self.segments
                                 if s.verified is not None},
            "variant_errors": {s.index: s.probe_errors
                               for s in self.segments
                               if s.probe_errors is not None},
            "jit_verified": {s.index: s.jit_verified for s in self.segments
                             if s.jit_verified is not None},
            "capture_errors": {s.index: s.capture_error
                               for s in self.segments
                               if s.capture_error is not None},
            "lane_targets": {s.lane: s.target.name for s in self.segments
                             if s.target is not None},
            "max_segment_ops": max((len(s.items) for s in self.segments),
                                   default=0),
            "serial": self.serial_order is not None,
            "runs": self.runs,
        }

    def _exec_segment(self, seg: Segment, results, ext,
                      run: RunContext | None) -> None:
        """Execute one segment under the fault runtime: injected faults
        fire per (request, op) item, transient failures retry the whole
        segment with backoff (payloads are pure on this path, and a
        failed ``execute`` writes no results, so re-execution is clean),
        and a captured segment whose replay fails with a non-transient
        error falls back to its eager composition once — the capture
        probe's fallback rule — before giving up.  ``run=None`` is the
        fault-free serial fast path."""
        what = (f"segment {seg.index} on lane {seg.lane!r} "
                f"(ops {seg.items[0]}..{seg.items[-1]})")

        def attempt():
            if run is not None and run.faults is not None:
                for (r, i) in seg.items:
                    run.faults.fire(seg.lane, r, i, run)
            seg.execute(results, ext)

        r0, i0 = seg.items[0]
        if run is not None:
            run.current[seg.lane] = what
        try:
            run_with_retries(run, attempt, what,
                             lane=seg.lane, request=r0, op=i0)
        except (ExecutionError, RecoverableError):
            raise
        except Exception:
            if seg.mode != JIT:
                raise
            seg._drop_capture()
            run_with_retries(run, attempt, what,
                             lane=seg.lane, request=r0, op=i0)
        finally:
            if run is not None:
                run.current.pop(seg.lane, None)

    def run(self, external_inputs=None, *,
            policy: ExecutionPolicy | None = None,
            faults: FaultPlan | None = None,
            estimate: float | None = None,
            trace: list | None = None,
            completed=None,
            segment_timings: list | None = None):
        """Execute the program; same results shape as the interpreter.

        ``policy`` tunes the watchdog/retry runtime (``estimate`` — e.g.
        the plan's cost-model latency — scales the watchdog budget) and
        ``faults`` injects a scripted
        :class:`~repro_torch.core.faults.FaultPlan`.  Every cross-lane
        wait is deadline-bounded, device waits included; on a permanent
        PU loss the raised
        :class:`~repro_torch.core.errors.PULostError` carries the
        execution frontier (results of every segment completed before
        the loss).

        ``external_inputs`` is one ``{op: (args...)}`` mapping for a
        single-graph program and a sequence of them, one per request, for
        an M-request program.  ``trace``, when a list, receives one
        :class:`SegmentTime` per executed segment.

        ``completed`` seeds the results with an execution frontier (one
        ``{op: value}`` dict for single-graph programs, a sequence of
        them for M-request programs): a program compiled over a *window*
        of remaining ops (``compile_concurrent(..., completed=...)``)
        reads its cross-window inputs from the frontier instead of
        recomputing them, and returns them with its own results.
        ``segment_timings``, when a list, receives one ``(lane, items,
        wall_seconds)`` tuple per completed segment, as the reference
        records them.
        """
        if self.single:
            ext = [dict(external_inputs or {})]
            seeds = [dict(completed or {})]
        else:
            ext_seq = list(external_inputs or [None] * self.n_requests)
            if len(ext_seq) != self.n_requests:
                raise ValueError(
                    f"program covers {self.n_requests} requests, got "
                    f"{len(ext_seq)} input mapping(s)")
            ext = [dict(e or {}) for e in ext_seq]
            seeds = [dict(c or {}) for c in
                     (completed or [None] * self.n_requests)]
        results: list[dict[int, Any]] = seeds
        t_run = time.perf_counter()

        def exec_seg(seg: Segment, run: RunContext | None) -> None:
            t0 = time.perf_counter()
            self._exec_segment(seg, results, ext, run)
            t1 = time.perf_counter()
            if trace is not None:
                trace.append(SegmentTime(seg.lane, tuple(seg.items),
                                         t1 - t0, t0 - t_run))
            if segment_timings is not None:
                segment_timings.append((seg.lane, tuple(seg.items),
                                        t1 - t0))

        if self.serial_order is not None:
            # inherently serial: no cross-lane waits exist, so fault-free
            # runs skip the RunContext entirely (the warm fast path)
            run = (RunContext(policy, faults, estimate)
                   if faults is not None else None)
            try:
                for seg in self.serial_order:
                    exec_seg(seg, run)
            except PULostError as e:
                if e.partial is None:
                    e.partial = [dict(res) for res in results]
                raise
            self.runs += 1
            return results[0] if self.single else results
        self._run_threaded(results, exec_seg,
                           RunContext(policy, faults, estimate))
        self.runs += 1
        return results[0] if self.single else results

    def _run_threaded(self, results, exec_seg, run: RunContext) -> None:
        """One worker per lane, handoffs by segment events (and CUDA
        events out of a CUDA lane; see the module docstring)."""
        streams = self.lane_streams()
        done = [threading.Event() for _ in self.segments]
        device_ev: list[Any] = [None] * len(self.segments)

        def release_all() -> None:
            for ev in done:
                ev.set()

        run.release = release_all
        # each lane stream starts behind the caller's current stream,
        # where the inputs may still be in flight
        start_ev = {}
        for dev, _ in streams.values():
            if dev not in start_ev:
                start_ev[dev] = _current_stream(dev).record_event()

        def publish(seg: Segment, stream):
            """The CUDA event a consumer of ``seg`` waits on: recorded on
            the lane's stream, or — for a lane without one whose outputs
            lie on a card — on the thread's current stream there."""
            if stream is not None:
                return stream[1].record_event()
            if not streams:
                return None
            dev = _cuda_device_of([results[r].get(i) for r, i in seg.items])
            return None if dev is None else _current_stream(dev).record_event()

        def lane_worker(pu: str) -> None:
            stream = streams.get(pu)
            try:
                if stream is not None:
                    stream[1].wait_event(start_ev[stream[0]])
                for seg in self.lane_segments[pu]:
                    for d, dwhat in zip(seg.deps, seg.dep_whats):
                        if not done[d].is_set():
                            run.wait(done[d], dwhat)
                        ev = device_ev[d]
                        if ev is None:
                            continue
                        if stream is None:
                            run.wait_device(ev, dwhat)
                        else:
                            stream[1].wait_event(ev)
                    run.check_abort()
                    if stream is not None:
                        for r, p in seg.flat_refs:
                            for t in _tensors(results[r].get(p)):
                                if t.is_cuda:
                                    t.record_stream(stream[1])
                    exec_seg(seg, run)
                    if seg.index in self._publish:
                        device_ev[seg.index] = publish(seg, stream)
                    done[seg.index].set()
            except _Aborted:
                pass  # a peer already failed; unwind silently
            except BaseException as e:
                run.fail(e)

        if self._pool is None:
            self._pool = LanePool(self.lanes, streams)
        tasks = [(pu, self._pool.submit(pu, lambda pu=pu: lane_worker(pu)))
                 for pu in self.lanes]
        for pu, task_done in tasks:
            if run.deadline is None:
                task_done.wait()
            elif not task_done.wait(
                    max(run.deadline - time.monotonic(), 0.0) + _JOIN_GRACE):
                # backstop: a payload the watchdog cannot interrupt wedged
                # this worker — drop the whole pool (daemon threads; the
                # next run builds a fresh one) and surface a typed timeout
                run.abort.set()
                release_all()
                self.close()
                raise run._timeout(f"lane worker {pu!r}")
        if run.errors:
            err = run.first_error()
            if isinstance(err, PULostError) and err.partial is None:
                err.partial = [dict(res) for res in results]
            raise err
        # the caller's stream waits for every lane's last event, and the
        # outputs made on a lane stream are marked as used on it
        for pu, (dev, stream) in streams.items():
            caller = _current_stream(dev)
            caller.wait_event(device_ev[self.lane_segments[pu][-1].index])
            for seg in self.lane_segments[pu]:
                for r, i in seg.items:
                    for t in _tensors(results[r][i]):
                        if t.is_cuda:
                            t.record_stream(caller)


def compile_lane_program(graphs: Sequence[OpGraph],
                         lane_items: Mapping[str, Sequence[tuple[int, int]]],
                         barriers: frozenset[tuple[int, int]] | set = frozenset(),
                         single: bool = False,
                         targets: Mapping[str, Any] | None = None
                         ) -> LaneProgram:
    """Partition per-lane op queues into segments and build the program.

    ``lane_items`` maps each PU lane to its FIFO queue of ``(request,
    op)`` pairs (already validated/ordered by the executor); ``barriers``
    are co-scheduled concurrent-step ops that must stay single-op
    segments.  Cut rules, applied walking each queue in order — a new
    segment starts when:

    * the op (or the previous op) is a barrier op,
    * the request changes (segments never span requests), or
    * any predecessor ran on a *different* lane (the handoff cut: waits
      happen only at segment starts, so a cross-lane input is only legal
      for a segment's first op), or
    * the previous op's output is read on a different lane (the fork
      cut: a segment publishes its outputs when it ends, so without it
      a consumer on another lane would wait for every later op of the
      producer's segment — the reference's partition, which serializes
      a fork whose producer lane goes on with one of its towers).

    Same-lane predecessors never cut.  ``single`` marks a program over
    one graph (``run`` then takes and returns one mapping).

    A predecessor absent from every lane queue is a *frontier* op (window
    programs over a partially-executed plan): it cuts like a cross-lane
    handoff and resolves as a flat input read from the ``completed``
    seeds at run time, with no segment dependency.

    ``targets`` optionally binds lane names to
    :class:`~repro_torch.core.targets.Target`\\ s: a bound segment keeps
    the reference payloads as its probe oracle and additionally resolves
    the target dialect's variant payloads at compile time (served only
    after the cold-run verification — see :class:`Segment`).
    """
    lane_of: dict[tuple[int, int], str] = {}
    for pu, items in lane_items.items():
        for it in items:
            lane_of[it] = pu
    # ops whose output a consumer on another lane reads
    read_elsewhere = {(r, p) for (r, i), pu in lane_of.items()
                      for p in graphs[r].pred[i]
                      if lane_of.get((r, p), pu) != pu}

    tmap = dict(targets or {})
    segments: list[Segment] = []
    lane_segments: dict[str, list[Segment]] = {pu: [] for pu in lane_items}
    seg_of: dict[tuple[int, int], Segment] = {}
    for pu, items in lane_items.items():
        cur: Segment | None = None
        for (r, i) in items:
            barrier = (r, i) in barriers
            cross = any(lane_of.get((r, p)) != pu
                        for p in graphs[r].pred[i])
            if (cur is None or barrier or cur.barrier
                    or cur.items[-1][0] != r or cross
                    or cur.items[-1] in read_elsewhere):
                cur = Segment(index=len(segments), lane=pu, barrier=barrier,
                              target=tmap.get(pu))
                segments.append(cur)
                lane_segments[pu].append(cur)
            cur.items.append((r, i))
            cur.fns.append(graphs[r].ops[i].fn)
            seg_of[(r, i)] = cur

    # compile-time variant selection: a segment on a non-"ref"-dialect
    # target gets the resolved variant payload list iff any op actually
    # carries a variant for that dialect (otherwise the reference path
    # is the variant path and nothing needs verifying)
    for seg in segments:
        tgt = seg.target
        if tgt is None or tgt.dialect in (None, "ref"):
            continue
        vf = [graphs[r].ops[i].payload_for(tgt.dialect)
              for (r, i) in seg.items]
        if any(v is not f for v, f in zip(vf, seg.fns)):
            seg.var_fns = vf

    for seg in segments:
        internal = {it: t for t, it in enumerate(seg.items)}
        flat_index: dict[tuple[int, int], int] = {}
        deps: set[int] = set()
        for (r, i) in seg.items:
            spec: list[tuple[str, int]] = []
            for p in graphs[r].pred[i]:
                src = (r, p)
                t2 = internal.get(src)
                if t2 is not None:
                    spec.append(("o", t2))
                    continue
                j = flat_index.setdefault(src, len(flat_index))
                spec.append(("f", j))
                producer = seg_of.get(src)
                if producer is not None and producer.lane != seg.lane:
                    deps.add(producer.index)
            seg.argspecs.append(spec)
        seg.flat_refs = sorted(flat_index, key=flat_index.get)
        seg.deps = sorted(deps)
        seg.dep_whats = [
            f"segment {seg.index} on lane {seg.lane!r} (first op "
            f"{seg.items[0]}) waiting for segment {d} on lane "
            f"{segments[d].lane!r} (ops {segments[d].items[0]}.."
            f"{segments[d].items[-1]})"
            for d in seg.deps]
    return LaneProgram(graphs, segments, lane_segments, single=single)
