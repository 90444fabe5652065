"""Arithmetic that several metric readers share."""
from __future__ import annotations

from .trace import device_s_of


def roofline(rec: dict, entry: str):
    """The bound per call of the port's C entry ``entry`` (the traced
    work's ``<entry>.bound_s`` over its ``<entry>.calls``) over its device
    time per call (its kernels' trace time over the launches counted), in
    percent; None where the window ran no such call."""
    tr = rec["trace"]
    calls = tr["work"].get(f"{entry}.calls", 0)
    launches = tr["launches"].get(entry, 0)
    device_s = device_s_of(tr, entry)
    if not calls or not launches or device_s <= 0:
        return None
    bound = tr["work"][f"{entry}.bound_s"] / calls
    return 100.0 * bound / (device_s / launches)


def idle_share(rec: dict):
    tr = rec["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
