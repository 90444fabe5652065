"""Per-target health tracking and circuit breaking for degraded-mode
serving.

A copy of ``repro.core.health``: the same detectors, breaker states,
transitions, ``stats()`` and ``condition()``, pure Python on the host.

The planning layer trusts profiled costs; the fault runtime
(:mod:`repro_torch.core.faults`) recovers a *single* execution.  This
module is the piece between them: a per-PU :class:`HealthMonitor` that
watches every real execution the serving loop performs and decides when
a target is *degrading* — before it takes the whole serving set down
with it.

Two independent detectors feed one actuator:

* **Consecutive-failure counting** — every failure attributable to a
  lane (an injected or real ``PULostError``, a watchdog timeout whose
  in-flight snapshot names the lane, a transient storm that exhausts the
  retry budget) bumps that lane's consecutive-failure counter; any
  success on the lane resets it.  Crossing
  ``HealthPolicy.failure_threshold`` opens the breaker.  A hard PU loss
  (:class:`~repro_torch.core.errors.PULostError`) opens it immediately — there
  is no point counting a dead lane's failures.

* **EWMA latency-drift tracking** — each completed op contributes a
  measured-wall-clock / predicted-cost ratio to its lane's EWMA.  The
  first ``HealthPolicy.calibration`` observations establish the lane's
  baseline ratio (wall seconds per cost-model second is an arbitrary
  host-dependent constant — only *drift relative to the lane's own
  baseline* is meaningful, echoing the context-dependent operator-cost
  shifts measured for real NPUs).  When the EWMA exceeds ``baseline *
  rescale_threshold`` the monitor recommends a *rescale*: a
  ``RuntimeCondition.slowdown`` factor equal to the measured drift, so
  the planner re-prices the lane instead of abandoning it.  Hysteresis
  (``rescale_hysteresis``, plus a minimum relative change before a
  recommended factor is revised) keeps EWMA noise from thrashing the
  plan cache.

The actuator is the **circuit breaker** (per lane):

    closed ──(failures ≥ threshold, or PU loss)──▶ open
    open ──(cooldown elapsed on the serving clock)──▶ half_open
    half_open ──(probe dispatch succeeds)──▶ closed   (re-admit)
    half_open ──(probe dispatch fails)──▶ open        (cooldown × backoff)

``open`` lanes are folded into the session condition as unavailable
(:meth:`HealthMonitor.condition` composes with
``RuntimeCondition.lose``/``restore``), which makes
``Orchestrator.on_condition`` invalidate affected cached plans and the
serving loop warm-re-plan the entire active set on the survivors.
``half_open`` lanes re-enter the planning table; the next chunk that
actually dispatches to the lane is the probe.  The monitor never reads
the chaos script — re-admission happens only on *observed* success.

Every transition is recorded (:class:`BreakerTransition`) with its
serving-clock time and reason; ``ServeReport.breaker["transitions"]``
surfaces the list for availability accounting.
"""
from __future__ import annotations

import dataclasses

from .dynamic import RuntimeCondition

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


@dataclasses.dataclass
class HealthPolicy:
    """Knobs of the per-target health state machine.

    ``cooldown`` is measured on the *serving clock* (the virtual-time
    axis arrivals live on), not wall clock — chaos scripts and probe
    scheduling then share one deterministic timeline.
    """

    failure_threshold: int = 2        # consecutive failures -> open
    cooldown: float = 0.5             # open -> half-open (serving-clock s)
    cooldown_backoff: float = 2.0     # cooldown multiplier per failed probe
    max_cooldown: float = 30.0        # cooldown growth cap
    ewma_alpha: float = 0.25          # drift EWMA smoothing factor
    calibration: int = 8              # observations forming the baseline
    rescale_threshold: float = 4.0    # EWMA/baseline ratio -> recommend
    rescale_hysteresis: float = 0.5   # drop rescale below thr * hysteresis
    rescale_min_change: float = 1.25  # relative change before re-recommending

    def __post_init__(self) -> None:
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.rescale_threshold <= 1.0:
            raise ValueError("rescale_threshold must be > 1")
        if self.cooldown < 0.0 or self.max_cooldown < self.cooldown:
            raise ValueError("need 0 <= cooldown <= max_cooldown")


@dataclasses.dataclass
class BreakerTransition:
    """One breaker state change (or drift-rescale event) on one lane."""

    time: float                       # serving-clock time
    pu: str
    frm: str
    to: str
    reason: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TargetHealth:
    """Mutable health record of one PU lane."""

    pu: str
    state: str = BREAKER_CLOSED
    consecutive_failures: int = 0
    failures: int = 0                 # total attributed failures
    successes: int = 0                # total successfully completed ops
    opened_at: float | None = None    # serving-clock time of last open
    cooldown: float = 0.0             # current open->half_open wait
    n_obs: int = 0                    # drift observations so far
    baseline: float | None = None     # calibrated wall/predicted ratio
    ewma: float | None = None         # running wall/predicted EWMA
    rescale: float | None = None      # active recommended slowdown factor

    def drift(self) -> float | None:
        """EWMA ratio relative to the calibrated baseline (1.0 = on
        profile), or ``None`` before calibration completes."""
        if self.baseline is None or self.ewma is None or self.baseline <= 0:
            return None
        return self.ewma / self.baseline


class HealthMonitor:
    """Per-target health ledger + circuit breaker for a serving run.

    The serving loop feeds it observations (:meth:`observe` per completed
    op, :meth:`record_failure` / :meth:`record_loss` per attributed
    failure), polls :meth:`due_probes` at boundaries, reports probe
    outcomes via :meth:`probe_result`, and applies :meth:`condition` to
    the orchestrator whenever :meth:`dirty` says the health-derived view
    of the PU set changed.
    """

    def __init__(self, policy: HealthPolicy | None = None):
        self.policy = policy if policy is not None else HealthPolicy()
        self.targets: dict[str, TargetHealth] = {}
        self.transitions: list[BreakerTransition] = []
        self.opens = 0
        self.readmits = 0
        self.probes = 0
        self.rescales = 0
        self._dirty = False

    def health(self, pu: str) -> TargetHealth:
        th = self.targets.get(pu)
        if th is None:
            th = self.targets[pu] = TargetHealth(
                pu=pu, cooldown=self.policy.cooldown)
        return th

    def dirty(self) -> bool:
        """True once since the last call if the health-derived condition
        (open set or recommended rescales) changed."""
        d, self._dirty = self._dirty, False
        return d

    def _transition(self, th: TargetHealth, to: str, now: float,
                    reason: str) -> None:
        self.transitions.append(BreakerTransition(
            time=now, pu=th.pu, frm=th.state, to=to, reason=reason))
        th.state = to
        self._dirty = True

    # -- success / drift path ------------------------------------------------
    def observe(self, pu: str, predicted: float, measured: float,
                now: float) -> None:
        """Record one completed op on ``pu``: ``predicted`` cost-model
        seconds took ``measured`` wall seconds.  Success evidence (resets
        the consecutive-failure counter) plus one EWMA drift sample."""
        th = self.health(pu)
        th.successes += 1
        th.consecutive_failures = 0
        if predicted <= 0.0 or measured < 0.0:
            return
        p = self.policy
        ratio = measured / predicted
        th.ewma = ratio if th.ewma is None else (
            p.ewma_alpha * ratio + (1.0 - p.ewma_alpha) * th.ewma)
        th.n_obs += 1
        if th.n_obs == p.calibration:
            th.baseline = th.ewma
        if th.baseline is None:
            return
        drift = th.drift()
        if th.rescale is None:
            if drift is not None and drift >= p.rescale_threshold:
                th.rescale = drift
                self.rescales += 1
                self._dirty = True
                self.transitions.append(BreakerTransition(
                    time=now, pu=pu, frm=th.state, to=th.state,
                    reason=f"drift_rescale x{drift:.1f}"))
        else:
            if drift is None or drift < p.rescale_threshold * \
                    p.rescale_hysteresis:
                th.rescale = None
                self._dirty = True
                self.transitions.append(BreakerTransition(
                    time=now, pu=pu, frm=th.state, to=th.state,
                    reason="drift_recovered"))
            elif (drift / th.rescale >= p.rescale_min_change
                  or th.rescale / drift >= p.rescale_min_change):
                th.rescale = drift
                self._dirty = True

    # -- failure path --------------------------------------------------------
    def record_failure(self, pu: str, now: float,
                       reason: str = "failure") -> bool:
        """One failure attributed to ``pu``; returns True when this
        failure opened (or re-opened) the breaker."""
        th = self.health(pu)
        th.failures += 1
        th.consecutive_failures += 1
        if th.state == BREAKER_HALF_OPEN:
            self.probe_result(pu, ok=False, now=now, reason=reason)
            return True
        if th.state == BREAKER_CLOSED and \
                th.consecutive_failures >= self.policy.failure_threshold:
            self._open(th, now, reason)
            return True
        return False

    def record_loss(self, pu: str, now: float) -> None:
        """A hard PU loss: open immediately regardless of counters."""
        th = self.health(pu)
        th.failures += 1
        th.consecutive_failures += 1
        if th.state == BREAKER_HALF_OPEN:
            self.probe_result(pu, ok=False, now=now, reason="pu_lost")
        elif th.state != BREAKER_OPEN:
            self._open(th, now, "pu_lost")

    def _open(self, th: TargetHealth, now: float, reason: str) -> None:
        self.opens += 1
        th.opened_at = now
        self._transition(th, BREAKER_OPEN, now, reason)

    # -- probe scheduling ----------------------------------------------------
    def due_probes(self, now: float) -> list[str]:
        """Open lanes whose cooldown elapsed — flipped to half-open and
        returned; the caller re-admits them into the planning table so
        the next dispatching chunk becomes the probe."""
        due = []
        for th in self.targets.values():
            if th.state == BREAKER_OPEN and th.opened_at is not None \
                    and now - th.opened_at >= th.cooldown:
                self.probes += 1
                self._transition(th, BREAKER_HALF_OPEN, now, "cooldown")
                due.append(th.pu)
        return due

    def probe_result(self, pu: str, ok: bool, now: float,
                     reason: str = "") -> None:
        """Outcome of a half-open lane's probe dispatch: success closes
        the breaker (re-admission, cooldown reset); failure re-opens it
        with the cooldown grown by ``cooldown_backoff``."""
        th = self.health(pu)
        if th.state != BREAKER_HALF_OPEN:
            return
        if ok:
            self.readmits += 1
            th.consecutive_failures = 0
            th.cooldown = self.policy.cooldown
            th.opened_at = None
            self._transition(th, BREAKER_CLOSED, now, "probe_ok")
        else:
            self.opens += 1
            th.cooldown = min(th.cooldown * self.policy.cooldown_backoff,
                              self.policy.max_cooldown)
            th.opened_at = now
            self._transition(th, BREAKER_OPEN, now,
                             reason or "probe_failed")

    # -- condition synthesis -------------------------------------------------
    def quarantined(self) -> set[str]:
        """Lanes currently breaker-open (half-open lanes are back in the
        table — they are being probed)."""
        return {p for p, th in self.targets.items()
                if th.state == BREAKER_OPEN}

    def half_open(self) -> set[str]:
        return {p for p, th in self.targets.items()
                if th.state == BREAKER_HALF_OPEN}

    def condition(self, base: RuntimeCondition | None = None
                  ) -> RuntimeCondition:
        """The health-adjusted runtime condition: ``base`` (the session's
        externally-imposed condition) with breaker-open lanes folded
        unavailable and active drift rescales folded as slowdowns.
        Half-open lanes are restored so the planner can route the probe."""
        cond = base if base is not None else RuntimeCondition()
        slowdown = dict(cond.slowdown)
        for pu, th in self.targets.items():
            if th.rescale is not None and th.state == BREAKER_CLOSED:
                slowdown[pu] = th.rescale
            else:
                slowdown.pop(pu, None)
        unavailable = (frozenset(cond.unavailable) - self.half_open()) \
            | self.quarantined()
        return RuntimeCondition(slowdown=slowdown,
                                unavailable=frozenset(unavailable))

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        """JSON-ready availability accounting for ``ServeReport``."""
        return {
            "opens": self.opens,
            "probes": self.probes,
            "readmits": self.readmits,
            "rescales": self.rescales,
            "quarantined": sorted(self.quarantined()),
            "half_open": sorted(self.half_open()),
            "targets": {
                pu: {"state": th.state, "failures": th.failures,
                     "successes": th.successes,
                     "consecutive_failures": th.consecutive_failures,
                     "drift": th.drift(), "rescale": th.rescale}
                for pu, th in sorted(self.targets.items())},
            "transitions": [t.to_dict() for t in self.transitions],
        }
