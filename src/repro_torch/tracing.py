"""Spans and counters inside the port, on the profiler's clock.

**Spans.**  ``with span(name, **attrs):`` names a piece of the port's
host work.  A span is on exactly while a ``torch.profiler`` profile runs
in the process (``torch.autograd.profiler._is_profiler_enabled``);
nothing else switches it on.  Off, :func:`span` returns one shared no-op
context manager: one flag read, no clock read.  On, a span

* enters ``torch.profiler.record_function(name)``, so it sits in the
  profiler's own timeline, on the clock of the device's operations (an
  idle gap of the device falls inside the port's span that was open at
  the time, and ``export_chrome_trace`` writes the spans with the rest);
* appends a record to :func:`spans`: ``name``, ``start_ns`` and
  ``end_ns`` (``time.perf_counter_ns``), ``id``, ``parent`` (the id of
  the span it opened inside, or None), ``request`` (the id of its root
  span), ``thread``, ``attrs`` and ``counts`` (what :func:`count` added
  while it was the innermost open span).

Each thread keeps its own stack of open spans.  A span opened with none
open is a root and starts a request of its own; its descendants carry
the root's id as their ``request``.  A thread that works for a span of
another thread (a lane worker for the run that submitted its task) takes
it as its outer span with :func:`adopt`.  While a thread captures a CUDA
graph (:func:`recording`) it records no span: the Python inside does not
run at a replay, where the replay's own span stands for it.

**Counters.**  ``count(name, n)`` adds ``n`` to totals kept since the
process started (:func:`counters`), and while tracing is on also to the
innermost open span's ``counts``.  While a thread captures a CUDA graph
(:func:`recording`) its counts go into the capture's counter instead,
and :func:`add` counts them again at every replay of the graph: a
captured kernel launches once per replay, not at capture.

The newest :data:`KEEP` records are kept (older ones are dropped as new
ones open); :func:`reset` forgets them all.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function


class _Local(threading.local):
    stack: list | None = None    # this thread's open spans
    recording = None             # the counter of a capture on this thread


KEEP = 1 << 16                   # span records kept, the newest
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_local = _Local()
_records: collections.deque = collections.deque(maxlen=KEEP)
_totals: dict = {}
_ids = itertools.count(1)


def _stack() -> list:
    stack = _local.stack
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "rec", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.rec, self.rf = name, attrs, None, None

    def __enter__(self):
        if _local.recording is not None:     # under a capture
            return None
        stack = _stack()
        parent = stack[-1] if stack else None
        sid = next(_ids)
        rec = {"name": self.name, "start_ns": 0, "end_ns": None, "id": sid,
               "parent": None if parent is None else parent["id"],
               "request": sid if parent is None else parent["request"],
               "thread": threading.get_ident(), "attrs": self.attrs,
               "counts": {}}
        self.rf = record_function(self.name)
        self.rf.__enter__()
        rec["start_ns"] = time.perf_counter_ns()
        stack.append(rec)
        with _lock:
            _records.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec is None:
            return False
        rec["end_ns"] = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:
            stack.remove(rec)
        self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager around one piece of the port's work (see the
    module docs); the shared no-op one while no profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def current() -> dict | None:
    """The innermost span open on this thread, or None."""
    stack = _local.stack
    return stack[-1] if stack else None


@contextlib.contextmanager
def _adopted(parent: dict):
    stack = _stack()
    stack.append(parent)
    try:
        yield parent
    finally:
        if parent in stack:
            stack.remove(parent)


def adopt(parent: dict | None):
    """On this thread, ``parent`` (a span that another thread opened, from
    :func:`current`) as the outer span of what opens inside."""
    return _OFF if parent is None else _adopted(parent)


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` (see the module docs)."""
    add({name: n})


def add(counts) -> None:
    """:func:`count` each of ``{name: n}``: a replayed graph's counts, as
    :func:`recording` recorded them at its capture."""
    recording = _local.recording
    if recording is not None:
        recording.update(counts)
        return
    stack = _local.stack if _autograd_profiler._is_profiler_enabled \
        else None
    held = stack[-1]["counts"] if stack else {}
    with _lock:
        for name, n in counts.items():
            _totals[name] = _totals.get(name, 0) + n
            held[name] = held.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Around a CUDA graph's capture on this thread: the counts this
    thread makes, into the yielded ``Counter`` and not into the totals
    (nothing runs until a replay, which adds them with :func:`add`), and
    no span."""
    outer = _local.recording
    _local.recording = collections.Counter()
    try:
        yield _local.recording
    finally:
        _local.recording = outer


def spans() -> list[dict]:
    """The newest :data:`KEEP` spans recorded since the last
    :func:`reset`, in the order they opened (an open span has ``end_ns``
    None)."""
    with _lock:
        return list(_records)


def counters() -> dict:
    """Every counter's total since the process started, or since the
    :func:`reset` that last cleared it."""
    with _lock:
        return dict(_totals)


def reset(prefix: str | None = None) -> None:
    """Forget the recorded spans and every counter; with ``prefix``, only
    the counters whose names start with it."""
    with _lock:
        if prefix is None:
            _records.clear()
            _totals.clear()
            return
        for name in [n for n in _totals if n.startswith(prefix)]:
            del _totals[name]
