"""Fault model & degraded-mode semantics of the execution runtime (a copy
of ``repro.core.faults``).

Edge SoCs are shared, thermally-limited, contended machines: PUs stall,
throttle, and drop out *mid-inference*, not just between requests.  The
scheduling side already reacts to condition changes between executions
(``Orchestrator.on_condition`` restitches plans); this module is the
runtime half — the fault model both executor paths (the per-op
interpreter oracle and the compiled ``LaneProgram``) enforce, plus the
scriptable injection machinery that tests and benchmarks drive it with.

**Fault taxonomy** (``FaultSpec.kind``) and what the runtime guarantees
for each:

* ``"transient"`` — a payload raises
  :class:`~repro_torch.fault.manager.RecoverableError` (the same signal the
  train-loop fault manager retries through — one vocabulary for both
  runtimes; the injected form is :class:`TransientFault`).
  **Recoverable.**  The failing unit (one op on the interpreter path,
  one fused segment on the compiled path) retries with exponential
  backoff up to ``ExecutionPolicy.max_retries`` times; retry is safe
  because payloads are documented pure on the compiled path, and raising
  ``RecoverableError`` is a payload's explicit opt-in to re-execution on
  the interpreter path.  A fault that persists through every attempt
  raises :class:`~repro_torch.core.errors.FaultRetryExceededError` — typed,
  never silent.

* ``"straggler"`` — the lane sleeps ``delay`` seconds before the op
  (thermal throttling, a co-resident process).  **Recoverable** as long
  as the watchdog budget absorbs the slowdown: execution completes with
  identical outputs, just later.  A straggler that pushes past the
  deadline degenerates into the stall case below.

* ``"stall"`` — the lane hangs at the injection point for ``delay``
  seconds (``float("inf")`` = forever).  **Recoverable** when ``delay``
  fits the budget.  Otherwise the watchdog converts the hang into a
  typed :class:`~repro_torch.core.errors.ExecutionTimeoutError`: every
  cross-lane wait is deadline-bounded — a host lane's wait for CUDA work
  on another lane's stream too (:meth:`RunContext.wait_device` polls
  the CUDA event, never a bare ``synchronize()``) —, the stalled lane
  itself sleeps abort-aware and raises at the deadline, and worker pools
  shut down cleanly — **no execution path can block forever**.

* ``"pu_lost"`` — the lane dies permanently from the injection point on
  (every later dispatch on it raises
  :class:`~repro_torch.core.errors.PULostError`).  **Recoverable by
  re-planning**: the executor attaches the execution frontier (completed
  per-request results) to the error; ``Orchestrator.execute`` folds the
  loss into the session condition (``RuntimeCondition.lose``,
  invalidating stale cached plans via ``on_condition``), re-plans the
  *remaining* ops on the surviving PUs, and resumes from the frontier.
  **Bitwise-recovery guarantee:** recovered outputs are bitwise
  identical to the fault-free run — completed results are reused, and
  the remaining pure payloads compute the same values regardless of
  which host-thread lane runs them.  When no surviving PU can run some
  remaining op, recovery raises
  :class:`~repro_torch.core.errors.InfeasibleScheduleError` with op context.

**Watchdog semantics.**  :class:`ExecutionPolicy` turns the plan's
cost-model estimate into a wall-clock budget
(``max(min_timeout, timeout_factor * estimate)``, or the explicit
``timeout``); :class:`RunContext` threads that deadline through every
event wait, worker join, and injected sleep of a run.  The first failure
on any lane sets the run's abort flag and releases every event, so
sibling lanes parked on a dead producer unwind immediately instead of
deadlocking (they raise the internal ``_Aborted`` control signal and
exit silently; only the original error surfaces).  ``watchdog=False``
restores the pre-fault-runtime semantics (unbounded waits, no injection
hooks).

**Retry limits.**  ``max_retries`` bounds re-execution per unit (default
2 retries → 3 attempts); backoff is ``backoff * 2**(attempt-1)`` seconds
and abort-aware, so a peer's failure interrupts a backoff sleep.

Injection is *seeded and scriptable*: a :class:`FaultPlan` is an ordered
list of :class:`FaultSpec` match rules ((lane, request, op) points, each
with a bounded fire count), plus ``FaultPlan.sample`` for seeded random
single-fault scenarios.  Both executor paths call ``FaultPlan.fire`` at
every dispatch point — per op on the interpreter, per fused segment
(covering each of its items) on the compiled path — so a fault can be
placed at any (lane, op/segment) point of either path.

**Serving-scope injection.**  A single execution is one fault surface;
a *serving run* (``ServingEngine(execution="real")``) is many chunked
executions sharing one persistent ``FaultPlan``, which extends the
semantics three ways:

* **Time-indexed arming** — a :class:`ChaosTrace` scripts faults on the
  serving run's *virtual clock*: each :class:`ChaosEvent` carries a
  ``time`` and is folded into the live plan (:meth:`FaultPlan.add`) only
  once the serving loop's clock reaches it.  The executor never sees the
  trace, only the armed specs — the serving loop cannot peek ahead at
  the script, which keeps chaos tests honest.
* **Request-indexed targeting** — a ``ChaosEvent.rid`` names a *serving
  request id* (stable across the run), not an execution slot.  Execution
  slots are positional and shift as requests admit/retire, so the
  serving loop re-translates rid → current slot immediately before each
  chunked execution (an event whose rid is not in flight arms against a
  sentinel slot that matches nothing until it is).
* **Lane revival** — ``kind="pu_restored"`` events model a PU coming
  back (a device reset, thermal recovery): :meth:`FaultPlan.revive` drops
  the lane from ``lost``.  Revival is *ground truth only* — the serving
  loop does not learn of it from the plan; the health layer's half-open
  circuit-breaker probe (:mod:`repro_torch.core.health`) must re-discover the
  lane by dispatching to it and observing success.

Fired counts stay global across the chunks of a serving run (same
statefulness as across retry/resume of a single run), so a bounded storm
is bounded over the whole run, not per chunk.
"""
from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
from typing import Callable, Iterable, Sequence

from ..fault.manager import RecoverableError

from .errors import (ExecutionError, ExecutionTimeoutError,
                     FaultRetryExceededError, PULostError)

FAULT_KINDS = ("transient", "stall", "straggler", "pu_lost")

# extra wall-clock the run joiner grants lane workers past the deadline
# before declaring a lane truly hung (covers watchdog raise + unwind time)
_JOIN_GRACE = 2.0


class TransientFault(RecoverableError):
    """Injected transient payload failure — the runtime's retryable
    fault, sharing the train-loop fault manager's ``RecoverableError``
    vocabulary so one ``except`` clause covers both runtimes."""


class _Aborted(BaseException):
    """Internal control signal: a peer lane already failed; unwind this
    lane silently.  Derives from ``BaseException`` so payload-level
    ``except Exception`` blocks (including the retry machinery) can
    never swallow it."""


@dataclasses.dataclass
class ExecutionPolicy:
    """Watchdog + retry knobs of one execution run.

    ``budget`` derives the run's wall-clock deadline: the explicit
    ``timeout`` when set, else ``timeout_factor`` times the plan's
    cost-model estimate, floored at ``min_timeout`` (cost-model units
    are idealized device-seconds; the floor absorbs host-thread
    scheduling noise that dwarfs ms-scale estimates).  ``watchdog=False``
    disables deadlines and fault hooks entirely — the pre-fault-runtime
    execution semantics, kept as the measured overhead baseline.
    """

    timeout: float | None = None      # explicit per-run budget (seconds)
    timeout_factor: float = 200.0     # x plan cost-model estimate
    min_timeout: float = 10.0         # budget floor (seconds)
    max_retries: int = 2              # transient retries per op/segment
    backoff: float = 0.002            # base backoff (doubles per attempt)
    watchdog: bool = True             # False -> unbounded waits, no hooks

    def budget(self, estimate: float | None = None) -> float | None:
        """Wall-clock budget for a run whose cost-model estimate is
        ``estimate`` (``None`` = no estimate); ``None`` = unbounded."""
        if not self.watchdog:
            return None
        if self.timeout is not None:
            return float(self.timeout)
        if estimate is not None and estimate > 0.0:
            return max(self.min_timeout, self.timeout_factor * estimate)
        return self.min_timeout


DEFAULT_POLICY = ExecutionPolicy()


class RunContext:
    """Shared per-run state: deadline, abort flag, error collection.

    One ``RunContext`` spans one executor run across all its lanes.  All
    blocking operations of the run go through it (``wait`` for handoff
    events, ``stall``/``backoff_sleep`` for injected or retry sleeps) so
    every one of them is deadline-bounded and abort-aware.
    """

    __slots__ = ("policy", "faults", "budget", "t0", "deadline", "abort",
                 "errors", "current", "release", "retries", "_lock")

    def __init__(self, policy: ExecutionPolicy | None = None,
                 faults: "FaultPlan | None" = None,
                 estimate: float | None = None):
        self.policy = policy if policy is not None else DEFAULT_POLICY
        self.faults = faults if (self.policy.watchdog or faults is None) \
            else None
        if faults is not None and not self.policy.watchdog:
            # injection needs the watchdog machinery (abort-aware sleeps,
            # bounded waits) to uphold the no-hang guarantee
            raise ValueError(
                "FaultPlan injection requires ExecutionPolicy.watchdog=True "
                "(watchdog=False is the bare pre-fault baseline)")
        self.budget = self.policy.budget(estimate)
        self.t0 = time.monotonic()
        self.deadline = None if self.budget is None else self.t0 + self.budget
        self.abort = threading.Event()
        self.errors: list[BaseException] = []
        self.current: dict[str, str] = {}   # lane -> in-flight description
        self.release: Callable[[], None] | None = None
        self.retries = 0
        self._lock = threading.Lock()

    # -- timing --------------------------------------------------------------
    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def remaining(self) -> float | None:
        return None if self.deadline is None \
            else self.deadline - time.monotonic()

    def _timeout(self, what: str) -> ExecutionTimeoutError:
        inflight = dict(self.current)
        busy = "; ".join(f"{lane}: {d}" for lane, d in
                         sorted(inflight.items())) or "none"
        return ExecutionTimeoutError(
            f"{what} did not complete within the watchdog budget "
            f"({self.elapsed():.2f}s elapsed vs {self.budget:.2f}s budget; "
            f"in-flight: {busy})", inflight=inflight)

    # -- blocking primitives -------------------------------------------------
    def check_abort(self) -> None:
        if self.abort.is_set():
            raise _Aborted()

    def wait(self, ev: threading.Event, what: str) -> None:
        """Deadline-bounded ``ev.wait()``: raises
        :class:`ExecutionTimeoutError` (naming ``what`` plus elapsed vs
        budget) at the deadline, and ``_Aborted`` when a peer lane has
        already failed (failures release every event, so the wake-up is
        immediate)."""
        if self.deadline is None:
            ev.wait()
        elif not ev.wait(max(self.deadline - time.monotonic(), 0.0)):
            self.check_abort()
            raise self._timeout(what)
        self.check_abort()

    def wait_device(self, ev, what: str) -> None:
        """Deadline-bounded host wait for the device work behind ``ev``
        (a ``torch.cuda.Event``, or anything with a ``query()`` that
        turns true): polls ``query()`` with a growing pause (10 µs to
        0.2 ms), raises :class:`ExecutionTimeoutError` at the deadline and
        ``_Aborted`` when a peer lane has failed.  Never a bare
        ``synchronize()``: an asynchronous CUDA error that ``query()``
        reports surfaces here as an :class:`ExecutionError` naming
        ``what``."""
        pause = 1e-5
        while True:
            try:
                if ev.query():
                    break
            except Exception as e:
                raise ExecutionError(
                    f"{what}: the device reported an error: "
                    f"{type(e).__name__}: {e}") from e
            if self.deadline is not None and \
                    time.monotonic() >= self.deadline:
                self.check_abort()
                raise self._timeout(what)
            if self.abort.wait(pause):
                raise _Aborted()
            pause = min(2 * pause, 2e-4)
        self.check_abort()

    def stall(self, duration: float, what: str) -> None:
        """Abort-aware sleep for injected stalls/stragglers.  Sleeps at
        most to the deadline; a stall whose requested duration was
        truncated by the deadline raises the typed timeout (this is how
        an injected infinite hang resolves on the lane that hangs)."""
        rem = self.remaining()
        t = duration if rem is None else min(duration, max(rem, 0.0))
        if t == float("inf"):
            self.abort.wait()               # only abort can end it
            raise _Aborted()
        if self.abort.wait(t):
            raise _Aborted()
        if rem is not None and duration > t:
            raise self._timeout(what)

    def backoff_sleep(self, attempt: int) -> None:
        d = self.policy.backoff * (2.0 ** (attempt - 1))
        rem = self.remaining()
        if rem is not None:
            d = min(d, max(rem, 0.0))
        if self.abort.wait(d):
            raise _Aborted()

    # -- failure propagation -------------------------------------------------
    def fail(self, e: BaseException) -> None:
        """Record a lane failure, flip the abort flag, and release every
        event of the run so no sibling lane stays parked on a dead
        producer (the first recorded error is the one re-raised)."""
        with self._lock:
            self.errors.append(e)
        self.abort.set()
        if self.release is not None:
            self.release()

    def first_error(self) -> BaseException:
        """The error to surface: a ``PULostError`` wins over secondary
        errors (it carries the recovery semantics), else the first
        recorded failure."""
        for e in self.errors:
            if isinstance(e, PULostError):
                return e
        return self.errors[0]


def run_with_retries(run: RunContext | None, attempt: Callable[[], object],
                     what: str, lane: str | None = None,
                     request: int | None = None, op: int | None = None):
    """Drive ``attempt`` through the bounded-retry policy: transient
    (``RecoverableError``) failures retry with exponential backoff up to
    ``max_retries`` times, then raise
    :class:`FaultRetryExceededError` ``from`` the final transient error
    (carrying the ``lane``/``request``/``op`` point when the caller
    supplied one).  Non-transient exceptions propagate immediately.
    ``run=None`` (the fault-free serial fast path) retries under the
    default policy with a plain sleep."""
    policy = run.policy if run is not None else DEFAULT_POLICY
    attempts = 0
    while True:
        try:
            return attempt()
        except RecoverableError as e:
            attempts += 1
            if run is not None:
                run.retries += 1
            if attempts > policy.max_retries:
                raise FaultRetryExceededError(
                    f"{what} still failing after {policy.max_retries} "
                    f"retried attempt(s): {e}",
                    lane=lane, request=request, op=op) from e
            if run is not None:
                run.backoff_sleep(attempts)
            else:
                time.sleep(policy.backoff * (2.0 ** (attempts - 1)))


# ---------------------------------------------------------------------------
# scriptable fault injection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultSpec:
    """One injection rule: fire ``kind`` at every dispatch point matching
    the non-``None`` fields, at most ``count`` times (``count <= 0`` =
    unlimited).  ``delay`` is the stall duration / straggler slowdown in
    wall-clock seconds (``float("inf")`` hangs a stall forever — the
    watchdog, not the fault, ends it)."""

    kind: str
    lane: str | None = None
    request: int | None = None
    op: int | None = None
    count: int = 1
    delay: float = 0.05

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.delay < 0:
            raise ValueError(f"delay must be >= 0, got {self.delay}")

    def matches(self, lane: str, request: int, op: int) -> bool:
        return ((self.lane is None or self.lane == lane)
                and (self.request is None or self.request == request)
                and (self.op is None or self.op == op))


class FaultPlan:
    """A seeded, scriptable set of faults to inject into one or more
    executor runs.

    Both executor paths call :meth:`fire` at every dispatch point — per
    op on the interpreter, per fused segment (iterating its (request,
    op) items) on the compiled ``LaneProgram`` — so specs can target any
    (lane, op/segment) point of either path.  The plan is stateful:
    fired counts persist across runs (a one-shot transient consumed
    during the first attempt does not re-fire during the retry or the
    post-recovery resume), and a ``pu_lost`` lane stays dead for every
    later dispatch until :meth:`reset`.  Thread-safe: lanes fire
    concurrently.
    """

    def __init__(self, specs: Iterable[FaultSpec] = (), seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self.lost: set[str] = set()
        self.fired: list[tuple[str, str, int, int]] = []  # (kind, lane, r, op)
        self._remaining = [s.count for s in self.specs]
        self._lock = threading.Lock()

    # -- construction helpers ------------------------------------------------
    @classmethod
    def single(cls, kind: str, **kw) -> "FaultPlan":
        """One-spec plan: ``FaultPlan.single("pu_lost", request=0, op=3)``."""
        return cls([FaultSpec(kind=kind, **kw)])

    @classmethod
    def sample(cls, points: Sequence[tuple[int, int]], n: int = 1,
               kinds: Sequence[str] = FAULT_KINDS, seed: int = 0,
               delay: float = 0.05) -> "FaultPlan":
        """Seeded random single-fault scenario generator: draw ``n``
        (request, op) points (with their kinds) from ``points`` — the
        same seed always produces the same plan."""
        rng = random.Random(seed)
        specs = [FaultSpec(kind=rng.choice(list(kinds)), request=r, op=op,
                           delay=delay)
                 for r, op in (rng.choice(list(points)) for _ in range(n))]
        return cls(specs, seed=seed)

    def reset(self) -> None:
        """Restore every spec's fire budget and revive lost lanes."""
        with self._lock:
            self._remaining = [s.count for s in self.specs]
            self.lost.clear()
            self.fired.clear()

    def add(self, spec: FaultSpec) -> None:
        """Arm ``spec`` into a live plan with a fresh fire budget — how a
        :class:`ChaosTrace` event becomes active once the serving clock
        reaches its time.  Thread-safe against concurrent :meth:`fire`."""
        with self._lock:
            self.specs.append(spec)
            self._remaining.append(spec.count)

    def revive(self, lane: str) -> bool:
        """Bring a lost lane back (``"pu_restored"`` chaos semantics):
        later dispatches on ``lane`` no longer raise
        :class:`~repro_torch.core.errors.PULostError` from permanence.  Armed
        ``pu_lost`` specs are untouched — a second loss can still fire.
        Returns whether the lane was actually lost."""
        with self._lock:
            was = lane in self.lost
            self.lost.discard(lane)
            return was

    # -- the runtime hook ----------------------------------------------------
    def fire(self, lane: str, request: int, op: int, run: RunContext) -> None:
        """Called by the executor before dispatching ``op`` of
        ``request`` on ``lane``; raises/sleeps per the first matching
        armed spec.  A lane already lost raises immediately (permanence)."""
        if lane in self.lost:
            raise PULostError(
                f"PU {lane!r} is lost (permanent fault injected earlier); "
                f"cannot dispatch op {op} of request {request}",
                pu=lane, request=request, op=op)
        spec = None
        with self._lock:
            for k, s in enumerate(self.specs):
                if self._remaining[k] != 0 and s.matches(lane, request, op):
                    if self._remaining[k] > 0:
                        self._remaining[k] -= 1
                    spec = s
                    self.fired.append((s.kind, lane, request, op))
                    break
        if spec is None:
            return
        point = f"op {op} of request {request} on lane {lane!r}"
        if spec.kind == "pu_lost":
            self.lost.add(lane)
            raise PULostError(
                f"PU {lane!r} lost permanently at {point} (injected)",
                pu=lane, request=request, op=op)
        if spec.kind == "transient":
            raise TransientFault(f"injected transient fault at {point}")
        # stall / straggler: abort-aware bounded sleep; an over-budget
        # stall resolves as a typed timeout on this very lane
        run.stall(spec.delay, f"injected {spec.kind} ({spec.delay}s) at "
                              f"{point}")


# ---------------------------------------------------------------------------
# serving-scope chaos scripting
# ---------------------------------------------------------------------------

# ChaosEvent kinds = FAULT_KINDS plus lane revival (serving-scope only)
CHAOS_KINDS = FAULT_KINDS + ("pu_restored",)


@dataclasses.dataclass
class ChaosEvent:
    """One scripted serving-run fault: at virtual time ``time``, arm a
    fault (or revive a lane).

    ``kind`` is a :data:`FAULT_KINDS` member — armed as a
    :class:`FaultSpec` with the event's (lane, op, count, delay) match
    fields — or ``"pu_restored"``, which calls :meth:`FaultPlan.revive`
    instead.  ``rid`` targets a *serving request id* (translated to an
    execution slot per chunk by the serving loop); ``lane``/``op`` match
    as in :class:`FaultSpec`; ``count`` bounds total fires across the
    rest of the run.
    """

    time: float
    kind: str
    lane: str | None = None
    rid: int | None = None
    op: int | None = None
    count: int = 1
    delay: float = 0.05

    def __post_init__(self) -> None:
        if self.kind not in CHAOS_KINDS:
            raise ValueError(
                f"unknown chaos kind {self.kind!r}; one of {CHAOS_KINDS}")
        if not (self.time >= 0.0):
            raise ValueError(
                f"chaos events live on the serving clock; time must be "
                f">= 0, got {self.time!r}")
        if self.kind in ("pu_lost", "pu_restored") and self.lane is None:
            raise ValueError(f"{self.kind} events must name a lane")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosEvent":
        return cls(**d)

    def spec(self) -> FaultSpec:
        """The :class:`FaultSpec` this event arms (``request`` is left
        ``None``; the serving loop re-binds rid-targeted specs to the
        live execution slot before each chunk)."""
        if self.kind == "pu_restored":
            raise ValueError("pu_restored events arm no FaultSpec")
        return FaultSpec(kind=self.kind, lane=self.lane, op=self.op,
                         count=self.count, delay=self.delay)


@dataclasses.dataclass
class ChaosTrace:
    """A time-ordered script of :class:`ChaosEvent` for one serving run.

    The JSON round-trip (:meth:`to_json` / :meth:`from_json`) makes a
    failing chaos run a replayable artifact — ship the trace, not the
    seed.  ``kind`` is a free-form scenario label carried through to
    reports (``"transient_storm"``, ``"pu_lost_return"``, ...).
    """

    events: list[ChaosEvent] = dataclasses.field(default_factory=list)
    kind: str = "custom"
    seed: int = 0

    def __post_init__(self) -> None:
        self.events = sorted(self.events, key=lambda e: e.time)

    def __len__(self) -> int:
        return len(self.events)

    def to_json(self) -> str:
        return json.dumps({"kind": self.kind, "seed": self.seed,
                           "events": [e.to_dict() for e in self.events]})

    @classmethod
    def from_json(cls, s: str) -> "ChaosTrace":
        d = json.loads(s)
        return cls(events=[ChaosEvent.from_dict(e) for e in d["events"]],
                   kind=d.get("kind", "custom"), seed=d.get("seed", 0))
