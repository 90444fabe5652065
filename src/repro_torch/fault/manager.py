"""Fault vocabulary shared by the port's runtimes.

The port carries only ``RecoverableError`` from ``repro.fault.manager``
so far: the heartbeat tracker, straggler detector and checkpoint/restart
loop belong to the training slice (``ROADMAP.md``).  The inference
execution runtime (:mod:`repro_torch.core.faults`) retries through this
type, so a payload only needs one way to say "this failure is
transient, re-execute me".
"""
from __future__ import annotations

__all__ = ["RecoverableError"]


class RecoverableError(RuntimeError):
    """Raised when a transient/hardware fault should trigger retry
    instead of failing the run (the injected ``TransientFault`` of
    :mod:`repro_torch.core.faults` subclasses this)."""
