"""Fault-tolerance runtime: heartbeats, straggler mitigation, restart policy.

Port of ``repro.fault.manager`` (a copy: the module is pure Python).  The
manager wraps the train loop with three mechanisms:

* **Heartbeats + failure detection**: each host registers a heartbeat per
  step; a host silent for ``failure_timeout`` is declared dead.  The
  clock is injectable so tests drive it.
* **Straggler mitigation**: per-step wall-clock is tracked in a rolling
  window; a host whose step time exceeds ``straggler_factor`` x the
  cluster median is flagged, and ``on_straggler`` is called with it.
* **Checkpoint/restart**: ``run_with_recovery`` retries the step function
  through ``RecoverableError``; a restart reloads the latest atomic
  checkpoint (:mod:`repro_torch.checkpoint.ckpt`) and resumes there.

``RecoverableError`` is also the transient-fault vocabulary of the
inference execution runtime (:mod:`repro_torch.core.faults`, whose
injected ``TransientFault`` subclasses it), so a payload or a step only
needs one way to say "this failure is transient, re-execute me".
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

__all__ = ["RecoverableError", "FaultConfig", "HeartbeatTracker",
           "StragglerDetector", "RecoveryStats", "run_with_recovery"]


class RecoverableError(RuntimeError):
    """Raised when a transient/hardware fault should trigger retry or
    checkpoint-restart instead of failing the run (the injected
    ``TransientFault`` of :mod:`repro_torch.core.faults` subclasses
    this)."""


@dataclasses.dataclass
class FaultConfig:
    failure_timeout: float = 60.0     # s without heartbeat -> dead
    straggler_factor: float = 1.5     # x median step time -> straggler
    straggler_window: int = 20        # rolling window (steps)
    max_restarts: int = 5
    checkpoint_every: int = 100       # steps


class HeartbeatTracker:
    def __init__(self, cfg: FaultConfig, n_hosts: int, clock=time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.last: dict[int, float] = {h: clock() for h in range(n_hosts)}

    def beat(self, host: int, t: float | None = None) -> None:
        self.last[host] = self.clock() if t is None else t

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = self.clock() if now is None else now
        return [h for h, t in self.last.items()
                if now - t > self.cfg.failure_timeout]


class StragglerDetector:
    def __init__(self, cfg: FaultConfig, n_hosts: int):
        self.cfg = cfg
        self.times: dict[int, collections.deque] = {
            h: collections.deque(maxlen=cfg.straggler_window)
            for h in range(n_hosts)}

    def record(self, host: int, step_time: float) -> None:
        self.times[host].append(step_time)

    def medians(self) -> dict[int, float]:
        out = {}
        for h, dq in self.times.items():
            if dq:
                s = sorted(dq)
                out[h] = s[len(s) // 2]
        return out

    def stragglers(self) -> list[int]:
        med = self.medians()
        if len(med) < 2:
            return []
        cluster = sorted(med.values())[len(med) // 2]
        return [h for h, m in med.items()
                if m > self.cfg.straggler_factor * cluster]


@dataclasses.dataclass
class RecoveryStats:
    restarts: int = 0
    stragglers_flagged: int = 0
    failures_detected: int = 0


def run_with_recovery(step_fn: Callable[[int], None], *,
                      start_step: int,
                      total_steps: int,
                      cfg: FaultConfig,
                      save_fn: Callable[[int], None],
                      restore_fn: Callable[[], int],
                      on_straggler: Callable[[list[int]], None] | None = None,
                      detector: StragglerDetector | None = None,
                      host: int = 0) -> RecoveryStats:
    """Drive ``step_fn`` from start to total with checkpoint/restart.

    ``restore_fn`` reloads the latest checkpoint and returns its step —
    the loop resumes there (exactness is the checkpoint module's
    contract: optimizer state, rng, and the data cursor all round-trip).
    """
    stats = RecoveryStats()
    step = start_step
    while step < total_steps:
        try:
            t0 = time.monotonic()
            step_fn(step)
            if detector is not None:
                detector.record(host, time.monotonic() - t0)
                bad = detector.stragglers()
                if bad:
                    stats.stragglers_flagged += len(bad)
                    if on_straggler is not None:
                        on_straggler(bad)
            step += 1
            if step % cfg.checkpoint_every == 0 or step == total_steps:
                save_fn(step)
        except RecoverableError:
            stats.failures_detected += 1
            stats.restarts += 1
            if stats.restarts > cfg.max_restarts:
                raise
            step = restore_fn()
    return stats
