"""Shared scheduler + execution-runtime error types.

A copy of ``repro.core.errors``.  Lives in its own leaf module so the
search engine (:mod:`repro_torch.core.search`) and the execution runtime (:mod:`repro_torch.core.executor` /
:mod:`repro_torch.core.laneprogram` / :mod:`repro_torch.core.faults`) can raise the
same exceptions without circular imports.
"""
from __future__ import annotations

from typing import Any


class InfeasibleScheduleError(ValueError):
    """No PU can run some op (profiling gap, compile failure on every PU,
    or a runtime condition that masked the last capable PU).

    Raised with context — which request, which op, which chain position —
    instead of a bare ``ValueError`` from deep inside a solver loop.
    """


class ExecutionError(RuntimeError):
    """Base class for failures of the execution runtime (as opposed to
    planning failures, which are :class:`InfeasibleScheduleError`)."""


class ExecutionTimeoutError(ExecutionError):
    """A cross-lane wait (or a whole run) exceeded its watchdog budget.

    Every ``threading.Event`` wait in the executor's interpreter, and
    every injected stall in a compiled
    :class:`~repro_torch.core.laneprogram.LaneProgram`, is bounded by a deadline
    derived from the plan's cost-model estimate times a configurable
    factor (see :class:`~repro_torch.core.faults.ExecutionPolicy`); a lane that
    hangs raises this — naming the lane, op/segment, and elapsed vs
    budget — instead of deadlocking the run forever.

    ``inflight`` is a structured snapshot of ``RunContext.current`` at
    the deadline (``{lane: in-flight work description}``): the lanes
    that were still executing when the watchdog fired.  Health tracking
    (``repro.core.health``, not yet ported) uses it to attribute the
    timeout to the stalled lane(s) instead of blaming the whole PU set.
    """

    def __init__(self, message: str,
                 inflight: dict[str, str] | None = None):
        super().__init__(message)
        self.inflight: dict[str, str] = dict(inflight or {})


class PULostError(ExecutionError):
    """A PU lane died permanently mid-run (injected via
    :class:`~repro_torch.core.faults.FaultPlan` kind ``"pu_lost"``, or raised
    by a payload that detects its device is gone).

    Carries the loss point and — attached by the executor before the
    error propagates — the execution *frontier*: ``partial`` is the list
    of per-request results dicts completed before the loss, which
    ``Orchestrator.execute`` uses to re-plan the remaining ops on the
    surviving PUs and resume without recomputing finished work.
    """

    def __init__(self, message: str, pu: str | None = None,
                 request: int | None = None, op: int | None = None):
        super().__init__(message)
        self.pu = pu
        self.request = request
        self.op = op
        # per-request {op: result} dicts completed before the loss;
        # attached by the raising executor path
        self.partial: list[dict[int, Any]] | None = None


class FaultRetryExceededError(ExecutionError):
    """A transient (``RecoverableError``) failure persisted through every
    bounded retry attempt; raised ``from`` the final transient error with
    the failing point and attempt count in the message.

    Carries the failing point structurally (``lane``/``request``/``op``,
    any of which may be ``None`` when the caller had no point context) so
    the serving layer can attribute the exhaustion to a lane's health
    record and shed exactly the affected request."""

    def __init__(self, message: str, lane: str | None = None,
                 request: int | None = None, op: int | None = None):
        super().__init__(message)
        self.lane = lane
        self.request = request
        self.op = op
