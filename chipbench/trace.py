"""One traced window: ``torch.profiler`` over a fixed piece of a cell's
traffic, reduced to what the per-layer metrics read.

A window is the span of a ``chipbench.window`` annotation that the
traffic loop opens on an idle card, or after synchronising it, and
closes after synchronising it again, so every device operation of the
window lies inside it; a trace may hold several, and its numbers are
summed over them.  From the trace:

* ``busy_s``: the union of the device operations' intervals (kernels,
  copies, sets) inside the window;
* ``kernel_s``: device seconds by operation name;
* ``idle``: the window's idle gaps, each named by the innermost host
  operation running at its midpoint, seconds summed by name.

A process traces once: later traces in one process have been seen to
lose the port's kernels.
"""
from __future__ import annotations

import bisect
import contextlib
import re
from typing import Iterable

WINDOW = "chipbench.window"

# the __global__ functions of each C entry of src/repro_torch/csrc
ENTRY_KERNELS = {
    "flash_attention": ("attn_kernel", "attn_tf32_kernel",
                        "attn_wgmma_kernel"),
    "ssd_scan": ("chunk_out_kernel", "out_kernel", "out_tf32_kernel",
                 "out_wgmma_kernel", "out_wide_tf32_kernel", "pad_v_kernel",
                 "pass_kernel", "state_kernel", "state_tf32_kernel",
                 "state_wgmma_kernel"),
    "expert_glu": ("gemm_kernel", "glu_bf16_kernel", "glu_wgmma_kernel"),
}
_ENTRY_OF = {k: e for e, ks in ENTRY_KERNELS.items() for k in ks}
# a kernel's name in a trace: the identifier after a blank or a scope,
# before its template arguments or its parameters
_IDENT = re.compile(r"(?:^|[\s:])([A-Za-z_]\w*)\s*[<(]")


def entry_of(kernel_name: str) -> str | None:
    """The port's C entry that launches the device kernel so named, or
    None for any other kernel (cuBLAS, PyTorch's own)."""
    for ident in _IDENT.findall(kernel_name):
        if ident in _ENTRY_OF:
            return _ENTRY_OF[ident]
    return None


def union_s(intervals: Iterable[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce(windows: list, device_ops: list, host_ops: list,
           top: int = 10) -> dict:
    """The summary of the windows ``windows`` (each (start, end); they do
    not overlap) from the device operations and host operations, each a
    list of (start, end, name) in one clock (any unit; the result is in
    that unit's seconds when it is seconds).  Lengths and times are
    summed over the windows."""
    window_s, busy, n_dev = 0.0, 0.0, 0
    kernel_s: dict[str, float] = {}
    idle: dict[str, float] = {}
    # by start, an outer operation before an inner one that starts with it
    host = sorted((h for h in host_ops if h[2] != WINDOW),
                  key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    for w0, w1 in windows:
        dev = [(max(s, w0), min(e, w1), n) for s, e, n in device_ops
               if e > w0 and s < w1 and e > s]
        window_s += w1 - w0
        busy += union_s((s, e) for s, e, _ in dev)
        n_dev += len(dev)
        for s, e, n in dev:
            kernel_s[n] = kernel_s.get(n, 0.0) + (e - s)
        cur = w0
        for s, e, _ in sorted(dev) + [(w1, w1, None)]:
            if s > cur:
                name = _host_at(host, starts, 0.5 * (cur + s))
                idle[name] = idle.get(name, 0.0) + (s - cur)
            cur = max(cur, e)
    return {
        "window_s": window_s, "busy_s": busy, "kernel_s": kernel_s,
        "n_device_ops": n_dev, "windows": len(windows),
        "device_ops": sorted(([n[:160], t] for n, t in kernel_s.items()),
                             key=lambda r: -r[1])[:top],
        "idle_gaps": sorted(([n[:160], t] for n, t in idle.items()),
                            key=lambda r: -r[1])[:top],
    }


def _host_at(host: list, starts: list, t: float, scan: int = 4096) -> str:
    """The innermost host operation running at ``t``: of those that
    cover it, the one that started last (host operations of one thread
    nest), looked for among the ``scan`` that started last before it."""
    i = bisect.bisect_right(starts, t)
    for hs, he, name in reversed(host[max(0, i - scan):i]):
        if he >= t:
            return name
    return "host"


def device_s_of(summary: dict, entry: str) -> float:
    """Device seconds of every kernel of the port's C entry ``entry``."""
    return sum(t for n, t in summary["kernel_s"].items()
               if entry_of(n) == entry)


class Tracer:
    """``with Tracer(on) as tr:`` around a traced window; ``tr.summary``
    afterwards (None when ``on`` is false)."""

    def __init__(self, on: bool):
        self.on = on
        self.summary = None
        self._prof = None

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    @contextlib.contextmanager
    def window(self):
        """The traced window itself, inside the profiler."""
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import record_function
        with record_function(WINDOW):
            yield
            torch.cuda.synchronize()

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof.events())
        return False


def summarize(events) -> dict:
    """:func:`reduce` over a profiler's events (microseconds) and every
    window they hold, in seconds, with the count of device kernels."""
    from torch.autograd import DeviceType
    windows, dev, host = [], [], []
    for ev in events:
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.name == WINDOW and ev.device_type == DeviceType.CPU:
            windows.append((s, e))
        elif ev.device_type == DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) or \
                    ev.name.startswith("chipbench."):
                continue
            dev.append((s, e, ev.name))
        else:
            host.append((s, e, ev.name))
    if not windows:
        raise RuntimeError("the trace holds no chipbench.window span")
    windows.sort()
    out = reduce(windows, dev, host)
    out["n_kernels"] = sum(1 for s, e, n in dev
                           for w0, w1 in windows
                           if e > w0 and s < w1
                           and not n.startswith(("Memcpy", "Memset")))
    return out
