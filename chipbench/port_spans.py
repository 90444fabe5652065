"""The port's own spans and counters (``repro_torch.tracing``), as the
per-layer metrics read them.

The port records spans while a torch profiler runs.  Every traffic loop
stops its profiler at the end of its last traced window, so of the root
spans of one kind the last *n* are exactly the window's units, *n* the
traced record's count of them (:data:`UNITS`).  A root's descendants are
the spans that carry its request id.  Each reader returns None where the
port records none of this: a checkout of the port without
``repro_torch.tracing``, or a window that holds fewer roots than units.
"""
from __future__ import annotations

from .trace import union_s

# root span -> the traced record's count of the window's units
UNITS = {"orchestrator.execute": "units", "model.prefill": "prefills",
         "engine.decode_step": "decode_steps"}
REPLAY_BYTES = ("capture.copy_in_bytes", "capture.clone_bytes")


def _tracing():
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def port_spans() -> list | None:
    tracing = _tracing()
    return None if tracing is None else tracing.spans()


def port_counters() -> dict | None:
    tracing = _tracing()
    return None if tracing is None else tracing.counters()


def window(rec: dict, root: str, spans: list | None = None) -> list | None:
    """The last *n* closed root spans named ``root`` of ``spans`` (by
    default the port's), each a copy with its descendants in order under
    ``descendants``; None where there are fewer than *n*."""
    n = rec["trace"].get(UNITS[root])
    spans = port_spans() if spans is None else spans
    if not n or spans is None:
        return None
    roots = [s for s in spans if s["name"] == root and s["parent"] is None
             and s["end_ns"] is not None]
    if len(roots) < n:
        return None
    units = {r["request"]: {**r, "descendants": []} for r in roots[-n:]}
    for s in spans:
        unit = units.get(s["request"])
        if unit is not None and s["id"] != unit["id"]:
            unit["descendants"].append(s)
    return list(units.values())


def seconds(span: dict) -> float:
    return 1e-9 * (span["end_ns"] - span["start_ns"])


def outside(span: dict, name: str) -> float:
    """Seconds of ``span`` (as :func:`window` gives it) outside the union
    of its descendants named ``name``."""
    s0, s1 = span["start_ns"], span["end_ns"]
    inner = [(max(d["start_ns"], s0), min(d["end_ns"], s1))
             for d in span["descendants"]
             if d["name"] == name and d["end_ns"] is not None]
    return 1e-9 * (s1 - s0 - union_s((a, b) for a, b in inner if b > a))


def counted(span: dict, names) -> int:
    """What the counters ``names`` added inside ``span`` and its
    descendants."""
    return sum(s["counts"].get(n, 0) for s in [span, *span["descendants"]]
               for n in names)


def host_share(rec: dict, root: str):
    """Percent of the window's ``root`` spans outside their graphs'
    launches (``capture.graph``): the port's own host work, as a share of
    its traced units.  A share and not milliseconds: the profiler slows
    the host by a different amount in each run, and both parts of a unit
    alike."""
    units = window(rec, root)
    if not units:
        return None
    return 100 * sum(outside(u, "capture.graph") for u in units) / sum(
        seconds(u) for u in units)


def replay_copy_mb(rec: dict, root: str):
    """Mean megabytes (1e6 bytes) a ``root`` span of the window copies
    into and out of its captured graphs' static buffers."""
    units = window(rec, root)
    if not units:
        return None
    return 1e-6 * sum(counted(u, REPLAY_BYTES) for u in units) / len(units)
