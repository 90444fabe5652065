"""Streaming serving engine: an async front end over the Orchestrator.

A copy of ``repro.core.serve``.  The orchestrator exposes the
online-admission API (``admit`` / ``advance`` / ``retire`` /
``replan_active``); this module is the traffic loop that drives it at
load.  Arrival traces, the virtual clock, admission, shedding, windows,
chaos arming and health handling are the reference's, on the host.

* :class:`ArrivalTrace` — reproducible request streams: ``poisson``
  (memoryless arrivals at a target rate) and ``bursty`` (Poisson
  background plus clustered bursts, the hard case for admission).
* :class:`ServingEngine` — an asyncio event loop feeding the
  orchestrator: continuous admission into a bounded concurrent set,
  **bounded re-plan latency** via windowed warm re-plans
  (``horizon_states``; every admit/advance/retire event costs one
  O(budget) incremental solve, never a full-grid re-solve), per-request
  SLO deadlines with optimistic-bound shedding, and graceful shedding of
  requests a re-plan proves infeasible
  (:class:`~repro_torch.core.errors.InfeasibleScheduleError`) instead of
  taking the serving loop down.
* :class:`ServeReport` — sustained throughput, p50/p99 *plan* latency
  (wall-clock re-plan cost, the scheduler's own overhead) and p50/p99
  *request* latency (virtual queueing + execution time), plus the
  warm/cold re-plan split from ``orchestrator.stats``.

Two execution modes share the loop:

* ``execution="virtual"`` (default) — a planned :class:`ConcurrentStep`
  "runs" by advancing the virtual clock by its cost-model latency and
  recording progress via ``advance`` — the same discrete-event
  convention as the cost-model benchmarks, so the loop exercises the
  full planning path at thousands of requests without burning hours of
  wall clock.  Re-plan latencies are the real wall-clock cost of the
  plan calls.

* ``execution="real"`` — advance events come from *completed execution*:
  at every boundary the loop carves the next window of planned steps
  (up to the arrival horizon or the first request completion), executes
  it through the fault runtime (``ScheduleExecutor.run_concurrent`` on
  the interpreter oracle, or compiled :class:`LaneProgram` segments
  with ``compile_exec=True``), and only then advances the orchestrator
  and the virtual clock by what actually finished.  The virtual clock
  still sequences arrivals/SLOs — it is the serving timeline chaos
  scripts (:class:`~repro_torch.core.faults.ChaosTrace`) and breaker
  cooldowns run on.  A per-target
  :class:`~repro_torch.core.health.HealthMonitor` watches every window:
  transient faults retry in-loop, a degrading PU trips its circuit
  breaker and is quarantined via ``Orchestrator.on_condition``
  (warm-re-planning the entire active set on the survivors), a
  half-open probe re-admits it on observed success, and unrecoverable
  requests are shed with a typed reason
  (:data:`SHED_REASONS`) — never a hang, and never a silent wrong
  answer: every completed request's outputs are checked bitwise against
  a fault-free solo run (``RequestRecord.bitwise_ok``), once the run
  has drained.

**The oracle of a served request.**  The reference holds each completed
request bitwise to ``run_monolithic`` of its model, which holds there
because every lane runs the same payload.  Here lanes serve different
payloads on different devices, so the solo run is the request's model
alone *with the op → lane assignment it was actually given*
(``RequestRecord.assignment``, recorded op by op as windows commit, so
after a recovery its tail names the new lanes): on the interpreter, or
— with ``compile_exec=True`` — as the first run of one fresh compiled
program over that assignment, which is what every window program
serves: a window program runs once, so it serves its cold run (the
reference payloads on each lane's device, the variants only probed).
Where every lane serves the reference payload on one device, both are
bitwise ``run_monolithic``, the reference's oracle.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from typing import Mapping, Sequence

import numpy as np

from .errors import (ExecutionTimeoutError, FaultRetryExceededError,
                     InfeasibleScheduleError, PULostError)
from .faults import ChaosTrace, ExecutionPolicy, FaultPlan
from .health import HealthMonitor, HealthPolicy
from .laneprogram import results_bitwise_equal
from .op import FusedOp, OpGraph, chain_graph
from .orchestrator import Orchestrator, Plan
from .schedule import ConcurrentSchedule
from .search import DEFAULT_HORIZON_STATES

# the typed shed vocabulary: every shed request carries exactly one
#   slo        — the optimistic remaining-work bound misses the deadline
#   infeasible — no available PU supports some remaining op
#   timeout    — a window kept exceeding the watchdog budget past the
#                in-loop retry allowance
#   fault      — a fault persisted through every retry and could be
#                pinned on this request
SHED_REASONS = ("slo", "infeasible", "timeout", "fault")
# solo-run oracles an engine keeps (one per model and assignment)
_MAX_REFS = 64


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request arrival: which model, when (virtual seconds), and an
    optional absolute SLO budget in virtual seconds (``None`` defers to
    the engine's ``slo_factor`` policy, if any)."""
    rid: int
    model: str
    time: float
    slo: float | None = None


@dataclasses.dataclass
class ArrivalTrace:
    """A reproducible arrival stream (sorted by time)."""
    arrivals: list[Arrival]
    kind: str = "custom"

    def __post_init__(self) -> None:
        self.arrivals = sorted(self.arrivals, key=lambda a: a.time)

    def __len__(self) -> int:
        return len(self.arrivals)

    def to_json(self) -> str:
        """Serialize the exact stream (floats round-trip via repr): a
        failing serving run ships as a replayable artifact, not a
        seed + generator-version pair."""
        return json.dumps({
            "kind": self.kind,
            "arrivals": [dataclasses.asdict(a) for a in self.arrivals]})

    @classmethod
    def from_json(cls, s: str) -> "ArrivalTrace":
        d = json.loads(s)
        return cls(arrivals=[Arrival(**a) for a in d["arrivals"]],
                   kind=d.get("kind", "custom"))

    @classmethod
    def poisson(cls, models: Sequence[str], rate: float, n: int,
                seed: int = 0, slo: float | None = None) -> "ArrivalTrace":
        """``n`` arrivals with Exp(``rate``) inter-arrival gaps, models
        drawn uniformly — the classic open-loop load model."""
        if rate <= 0 or n < 0:
            raise ValueError(f"poisson: need rate > 0 and n >= 0, got "
                             f"rate={rate}, n={n}")
        rng = np.random.default_rng(seed)
        ts = np.cumsum(rng.exponential(1.0 / rate, size=n))
        picks = rng.integers(0, len(models), size=n)
        return cls([Arrival(i, models[int(picks[i])], float(ts[i]), slo)
                    for i in range(n)], kind="poisson")

    @classmethod
    def bursty(cls, models: Sequence[str], rate: float, n: int,
               burst_every: int = 5, burst_size: int = 3,
               burst_span: float = 1e-3, seed: int = 0,
               slo: float | None = None) -> "ArrivalTrace":
        """Poisson background where every ``burst_every``-th arrival
        brings ``burst_size - 1`` near-simultaneous companions (within
        ``burst_span`` virtual seconds) — clustered admissions that
        stress bounded re-plan latency."""
        base = cls.poisson(models, rate, n, seed=seed, slo=slo)
        rng = np.random.default_rng(seed + 1)
        out = list(base.arrivals)
        rid = n
        for k, a in enumerate(base.arrivals):
            if burst_every and k % burst_every == 0:
                for j in range(burst_size - 1):
                    out.append(Arrival(
                        rid, models[int(rng.integers(0, len(models)))],
                        a.time + float(rng.uniform(0, burst_span)), slo))
                    rid += 1
        return cls(out, kind="bursty")


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle record of one served (or shed) request."""
    rid: int
    model: str
    arrival: float
    deadline: float | None
    ops_total: int
    ops_done: int = 0
    handle: int | None = None
    admitted_at: float | None = None
    finished_at: float | None = None
    shed: bool = False
    shed_reason: str = ""          # one of SHED_REASONS when shed
    # real-execution bookkeeping
    retries: int = 0               # window re-executions touching this req
    recovered: bool = False        # survived at least one fault recovery
    bitwise_ok: bool | None = None  # outputs == fault-free solo run
    results: dict = dataclasses.field(default_factory=dict, repr=False)
    # op -> lane each completed op ran on (the solo run's assignment)
    assignment: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def latency(self) -> float | None:
        """Virtual arrival→completion latency (queueing + execution)."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


@dataclasses.dataclass
class ServeReport:
    """What a serving run sustained, and what it cost to plan it.

    The availability block (``recovered`` … ``breaker``) is populated by
    real-execution runs: recovery latency is the wall-clock cost from
    catching a fault to a successful warm re-plan of the active set, and
    ``breaker`` carries the
    :class:`~repro_torch.core.health.HealthMonitor`
    stats including the full breaker-transition log.  ``cache`` is the
    over-the-run delta of ``Orchestrator.cache_stats()`` (LRU evictions
    + ``ConcurrentCaches`` trims), so cache-pressure-induced slowdowns
    show up in serving output."""
    n_requests: int
    completed: int
    shed: int
    makespan: float               # virtual seconds, first arrival -> drain
    throughput: float             # completed requests / virtual second
    latency_p50: float            # virtual request latency percentiles
    latency_p99: float
    plan_ms_p50: float            # wall-clock re-plan latency percentiles
    plan_ms_p99: float
    plan_events: int
    replans_warm: int
    replans_cold: int
    occupancy_mean: float         # time-weighted mean concurrent set size
    # availability accounting (real-execution runs)
    recovered: int = 0            # completed despite >= 1 fault recovery
    retried: int = 0              # window re-executions
    recoveries: int = 0           # fault -> re-plan recovery cycles
    recovery_ms_p50: float = 0.0  # wall-clock fault -> re-planned
    recovery_ms_p99: float = 0.0
    shed_reasons: dict = dataclasses.field(default_factory=dict)
    bitwise_checked: int = 0      # completions verified vs solo reference
    bitwise_failures: int = 0     # MUST stay 0: silent-wrong-answer count
    exec_wall_s: float = 0.0      # wall clock spent really executing
    breaker: dict = dataclasses.field(default_factory=dict)
    cache: dict = dataclasses.field(default_factory=dict)
    requests: list[RequestRecord] = dataclasses.field(
        default_factory=list, repr=False)

    def to_dict(self) -> dict:
        # not dataclasses.asdict: that would deep-copy every request's
        # results payloads just to drop them
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "requests"}


class ServingEngine:
    """Continuous-admission serving loop over one :class:`Orchestrator`.

    ``models`` maps model names to their inference graphs (or bare op
    sequences); each is registered once and cloned per concurrent
    in-flight request through handle aliasing (``register(graph,
    table=...)`` always gets a fresh handle, so two in-flight requests
    of the same model hold distinct admission slots; finished handles
    return to a per-model free pool, keeping the registration count
    bounded by peak concurrency).

    The loop is an asyncio pipeline — a producer task feeding arrivals
    into a queue, the scheduler task draining it — with virtual-time
    execution (see module docstring).  Every membership or progress
    boundary costs exactly one windowed warm re-plan of at most
    ``horizon_states`` grid states, so admission latency stays bounded
    no matter how much work is in flight.  ``max_concurrent`` bounds the
    co-scheduled set (grid width); excess arrivals queue FIFO.

    Shedding keeps the loop alive instead of failing a whole run:

    * **SLO**: a request whose optimistic remaining-work bound (suffix
      sum of per-op best-PU costs) can no longer meet its deadline is
      shed at admission or at the next re-plan boundary.
    * **Infeasibility**: when a re-plan raises
      :class:`InfeasibleScheduleError` (e.g. a condition change left an
      op with no supporting PU), the offending requests are shed and the
      survivors re-planned.
    * **Degradation** (``execution="real"``): a window that keeps timing
      out is shed ``"timeout"``; a fault that survives every retry and
      names a request sheds exactly that request ``"fault"``; a PU whose
      breaker opens is quarantined and the active set warm-re-planned on
      the survivors (see module docstring).

    Real-execution knobs: ``inputs`` maps model name → ``{op index:
    args tuple}`` external inputs (shared by every request of the
    model); ``exec_policy`` is the per-window watchdog/retry policy;
    ``health_policy`` tunes the breaker; ``max_window_retries`` bounds
    in-loop re-execution of a failed window before shedding;
    ``compile_exec=True`` executes windows as compiled
    :class:`~repro_torch.core.laneprogram.LaneProgram` segments instead
    of the per-op interpreter (each window program is closed after its
    run).

    After a real-execution run, ``health`` holds its
    :class:`~repro_torch.core.health.HealthMonitor`, ``faults`` its live
    :class:`~repro_torch.core.faults.FaultPlan` (``faults.fired`` lists
    what the armed chaos events fired) and ``window_seconds`` the wall
    seconds of each window execution, failed attempts included.
    """

    def __init__(self, orch: Orchestrator,
                 models: Mapping[str, OpGraph | Sequence[FusedOp]],
                 objective: str = "latency",
                 horizon_states: int | None = DEFAULT_HORIZON_STATES,
                 max_concurrent: int = 3,
                 slo_factor: float | None = None,
                 execution: str = "virtual",
                 inputs: Mapping[str, Mapping[int, tuple]] | None = None,
                 exec_policy: ExecutionPolicy | None = None,
                 health_policy: HealthPolicy | None = None,
                 max_window_retries: int = 2,
                 compile_exec: bool = False):
        if not models:
            raise ValueError("ServingEngine needs at least one model")
        if max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be >= 1, got {max_concurrent}")
        if execution not in ("virtual", "real"):
            raise ValueError(
                f"execution must be 'virtual' or 'real', got {execution!r}")
        self.orch = orch
        self.objective = objective
        self.horizon_states = horizon_states
        self.max_concurrent = max_concurrent
        self.slo_factor = slo_factor
        self.execution = execution
        self.exec_policy = exec_policy
        self.health_policy = health_policy
        self.max_window_retries = max_window_retries
        self.compile_exec = compile_exec
        self.health: HealthMonitor | None = None   # set per serve() run
        self.faults: FaultPlan | None = None       # set per serve() run
        self.window_seconds: list[float] = []      # set per serve() run
        self._inputs: dict[str, dict] = {
            m: dict(v) for m, v in (inputs or {}).items()}
        # (model, assignment) -> fault-free solo results, a bounded LRU
        self._refs: dict[tuple, dict] = {}
        self._graphs: dict[str, OpGraph] = {}
        self._base: dict[str, int] = {}       # model -> provider handle
        self._tables: dict[str, object] = {}  # model -> profiled CostTable
        self._free: dict[str, list[int]] = {}  # model -> reusable handles
        self._bound: dict[str, np.ndarray] = {}  # optimistic suffix bound
        for name, g in models.items():
            if not isinstance(g, OpGraph):
                g = chain_graph(list(g))
            self._graphs[name] = g
            h = orch.register(g)
            self._base[name] = h
            self._tables[name] = orch._reg(h).table
            self._free[name] = [h]
            wl = orch.workload(h)
            d = wl.dense
            best = np.where(d.mask, d.w, np.inf).min(axis=1)
            best = np.where(np.isfinite(best), best, 0.0)  # infeasible ops
            self._bound[name] = np.concatenate(
                (np.cumsum(best[::-1])[::-1], [0.0]))

    # -- handle aliasing -----------------------------------------------------
    def _acquire(self, model: str) -> int:
        free = self._free[model]
        if free:
            return free.pop()
        # an explicit-table registration always gets a fresh handle: the
        # same model can hold several concurrent admission slots
        return self.orch.register(self._graphs[model],
                                  table=self._tables[model])

    def _release(self, model: str, h: int) -> None:
        self._free[model].append(h)

    def _ref(self, rec: RequestRecord) -> dict:
        """Fault-free solo reference outputs of a served request (memoized
        per model and assignment): its model run alone with the op →
        lane assignment it was given — on the interpreter, or with
        ``compile_exec`` as the first run of a fresh compiled program
        (see the module docstring).  The oracle every real-mode
        completion is checked bitwise against."""
        key = (rec.model, tuple(sorted(rec.assignment.items())))
        ref = self._refs.get(key)
        if ref is not None:
            self._refs[key] = self._refs.pop(key)      # LRU refresh
            return ref
        graph, ext = self._graphs[rec.model], self._inputs.get(rec.model)
        ex = self.orch.executor
        if self.compile_exec:
            prog = ex.compile_scheduled(graph, rec.assignment)
            try:
                ref = prog.run(ext)
            finally:
                prog.close()
        else:
            ref = ex.run_scheduled(graph, rec.assignment, ext)
        self._refs[key] = ref
        while len(self._refs) > _MAX_REFS:
            self._refs.pop(next(iter(self._refs)))
        return ref

    # -- serving loop --------------------------------------------------------
    def serve(self, trace: ArrivalTrace,
              chaos: ChaosTrace | None = None) -> ServeReport:
        """Run a trace to drain (synchronous wrapper over the async
        loop).  ``chaos`` scripts seeded faults across the run on the
        serving clock (real execution only)."""
        return asyncio.run(self.serve_async(trace, chaos))

    async def serve_async(self, trace: ArrivalTrace,
                          chaos: ChaosTrace | None = None) -> ServeReport:
        if chaos is not None and self.execution != "real":
            raise ValueError(
                "a ChaosTrace needs execution='real' — virtual serving "
                "never dispatches, so there is nothing to inject into")
        queue: asyncio.Queue = asyncio.Queue()

        async def produce() -> None:
            for a in trace.arrivals:
                await queue.put(a)
            await queue.put(None)          # end of stream

        producer = asyncio.create_task(produce())
        try:
            report = await self._schedule(queue, len(trace.arrivals), chaos)
        finally:
            producer.cancel()
        return report

    async def _schedule(self, queue: asyncio.Queue, n_expected: int,
                        chaos: ChaosTrace | None = None) -> ServeReport:
        orch = self.orch
        now = 0.0
        t0 = None                      # virtual time of first arrival
        plan_ms: list[float] = []
        records: list[RequestRecord] = []
        inflight: dict[int, RequestRecord] = {}   # handle -> record
        waiting: list[RequestRecord] = []         # admitted=no, FIFO
        pending: Arrival | None = None            # next undelivered arrival
        stream_done = False
        busy_time = 0.0                # integral of |active| over time
        warm0 = orch.stats["replans_warm"]
        cold0 = orch.stats["replans_cold"]
        cache0 = orch.cache_stats()
        plan: Plan | None = None
        cursor = 0                     # next step of `plan` to run

        # -- real-execution state -------------------------------------------
        real = self.execution == "real"
        health = HealthMonitor(self.health_policy) if real else None
        self.health = health
        base_cond = orch.condition     # externally-imposed condition
        faults = FaultPlan([], seed=chaos.seed if chaos else 0)
        self.faults = faults
        self.window_seconds = window_s = []
        chaos_events = list(chaos.events) if chaos is not None else []
        chaos_idx = 0
        rid_specs: list = []           # (ChaosEvent, armed FaultSpec) pairs
        recovery_ms: list[float] = []
        recoveries = 0
        retried = 0
        exec_wall = 0.0

        def record_of(a: Arrival) -> RequestRecord:
            wl = orch.workload(self._base[a.model])
            slo = a.slo
            if slo is None and self.slo_factor is not None:
                slo = self.slo_factor * float(self._bound[a.model][0])
            return RequestRecord(
                rid=a.rid, model=a.model, arrival=a.time,
                deadline=None if slo is None else a.time + slo,
                ops_total=wl.n)

        def bound(rec: RequestRecord) -> float:
            return float(self._bound[rec.model][rec.ops_done])

        def shed(rec: RequestRecord, reason: str) -> None:
            rec.shed, rec.shed_reason = True, reason
            if rec.handle is not None:
                rec_h = rec.handle
                rec.handle = None
                self._release(rec.model, rec_h)

        def timed(fn, *args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            plan_ms.append((time.perf_counter() - t) * 1e3)
            return out

        def admit_due() -> bool:
            """Admit waiting requests while capacity allows; returns
            whether membership changed (plan invalidated)."""
            nonlocal plan
            changed = False
            while waiting and len(inflight) < self.max_concurrent:
                rec = waiting.pop(0)
                if rec.deadline is not None and \
                        now + bound(rec) > rec.deadline:
                    shed(rec, "slo")           # cannot make it: shed now
                    continue
                h = self._acquire(rec.model)
                rec.handle = h
                rec.admitted_at = now
                inflight[h] = rec
                plan = timed(orch.admit, h, self.objective,
                             self.horizon_states)
                changed = True
            return changed

        def replan() -> None:
            """Windowed warm re-plan with graceful shedding."""
            nonlocal plan, cursor
            while True:
                try:
                    if plan is None and inflight:
                        plan = timed(orch.replan_active, self.objective,
                                     self.horizon_states)
                    cursor = 0
                    return
                except InfeasibleScheduleError:
                    bad = [h for h, rec in inflight.items()
                           if self._infeasible(rec)]
                    if not bad:
                        raise          # not a per-request infeasibility
                    for h in bad:
                        rec = inflight.pop(h)
                        orch.retire(h, self.objective,
                                    self.horizon_states)
                        shed(rec, "infeasible")
                    plan = None

        # -- real-execution helpers -----------------------------------------
        def arm_chaos() -> None:
            """Fold chaos events whose scripted time has arrived into the
            live fault plan (the executor only ever sees armed specs)."""
            nonlocal chaos_idx
            while chaos_idx < len(chaos_events) \
                    and chaos_events[chaos_idx].time <= now:
                ev = chaos_events[chaos_idx]
                chaos_idx += 1
                if ev.kind == "pu_restored":
                    faults.revive(ev.lane)
                    continue
                spec = ev.spec()
                if ev.rid is not None:
                    spec.request = -1      # bound per window (slots shift)
                    rid_specs.append((ev, spec))
                faults.add(spec)

        def bind_rid_specs(handles) -> None:
            """Re-translate rid-targeted specs to this window's execution
            slots (slot = position in the plan's handle tuple)."""
            slot_of = {inflight[h].rid: s for s, h in enumerate(handles)
                       if h in inflight}
            for ev, spec in rid_specs:
                spec.request = slot_of.get(ev.rid, -1)

        def apply_health() -> None:
            """Fold the health-derived condition into the orchestrator
            and warm re-plan the entire active set on the survivors
            (requests with no surviving PU shed typed)."""
            nonlocal plan
            orch.on_condition(health.condition(base_cond))
            plan = None
            replan()

        def finish(h: int) -> None:
            nonlocal plan, cursor
            rec = inflight.pop(h)
            rec.finished_at = now
            rec.handle = None
            plan = timed(orch.retire, h, self.objective,
                         self.horizon_states)
            cursor = 0
            self._release(rec.model, h)

        def shed_inflight(h: int, reason: str) -> None:
            rec = inflight.pop(h)
            orch.retire(h, self.objective, self.horizon_states)
            shed(rec, reason)

        def recover(t_fail: float) -> None:
            """One fault -> re-plan recovery cycle, timed wall-clock from
            the catch to the re-planned active set."""
            nonlocal recoveries
            recoveries += 1
            for rec in inflight.values():
                rec.recovered = True
            apply_health()
            recovery_ms.append((time.perf_counter() - t_fail) * 1e3)

        def commit(handles, results, steps) -> None:
            """Fold executed results into the request frontiers, advance
            the orchestrator by what newly completed, and move the
            serving clock past the fully-completed step prefix."""
            nonlocal now, busy_time, cursor
            lane_of = {(slot, op): pu for st in steps
                       for slot, (op, pu) in enumerate(zip(st.ops, st.pus))
                       if op is not None}
            for slot, h in enumerate(handles):
                rec = inflight.get(h)
                if rec is None:
                    continue
                fresh = [op for op in results[slot]
                         if op not in rec.results]
                rec.results.update(results[slot])
                rec.assignment.update((op, lane_of[(slot, op)])
                                      for op in fresh)
                if fresh:
                    orch.advance(h, len(fresh))
                    rec.ops_done += len(fresh)
            for st in steps:
                if not all(op is None
                           or op in inflight[handles[slot]].results
                           for slot, op in enumerate(st.ops)
                           if handles[slot] in inflight):
                    break
                cursor += 1
                busy_time += len(inflight) * st.cost
                now += st.cost
            for h in [h for h, rec in inflight.items()
                      if rec.ops_done >= rec.ops_total]:
                finish(h)

        def select_window() -> int:
            """End index (exclusive) of the step window to execute this
            boundary: stop at the arrival horizon or after a step that
            completes a request — the same boundaries the virtual loop
            observes, so both modes re-plan at identical membership
            events."""
            steps = plan.schedule.steps
            horizon = pending.time if pending is not None else None
            t = now
            done = {h: inflight[h].ops_done for h in plan.handles}
            end = cursor
            while end < len(steps):
                if horizon is not None and t >= horizon:
                    break
                st = steps[end]
                end += 1
                t += st.cost
                fin = False
                for slot, op in enumerate(st.ops):
                    if op is None:
                        continue
                    h = plan.handles[slot]
                    done[h] += 1
                    if done[h] >= inflight[h].ops_total:
                        fin = True
                if fin:
                    break
            return end

        def exec_window(end: int) -> None:
            """Really execute plan steps [cursor:end) through the fault
            runtime, with in-loop retries, breaker-driven quarantine +
            fleet-wide re-plan, and typed shedding."""
            nonlocal plan, retried, exec_wall
            handles = plan.handles
            steps = list(plan.schedule.steps[cursor:end])
            graphs = [orch._reg(h).graph for h in handles]
            ext = [self._inputs.get(inflight[h].model) for h in handles]
            est = sum(st.cost for st in steps)
            sub = ConcurrentSchedule(steps=steps, latency=est, energy=0.0,
                                     objective=self.objective,
                                     mode="window")
            window_pus = sorted({pu for st in steps for pu in st.pus
                                 if pu is not None})
            attempts = 0
            while True:
                arm_chaos()
                bind_rid_specs(handles)
                frontiers = [dict(inflight[h].results) if h in inflight
                             else {} for h in handles]
                timings: list = []
                tw = time.perf_counter()
                try:
                    if self.compile_exec:
                        seg_t: list = []
                        prog = orch.executor.compile_concurrent(
                            graphs, sub, completed=frontiers, partial=True)
                        try:
                            results = prog.run(
                                ext, policy=self.exec_policy, faults=faults,
                                estimate=est, completed=frontiers,
                                segment_timings=seg_t)
                        finally:
                            prog.close()
                        timings = [(lane, r, i, dt / max(len(items), 1))
                                   for lane, items, dt in seg_t
                                   for (r, i) in items]
                    else:
                        results = orch.executor.run_concurrent(
                            graphs, sub, ext, completed=frontiers,
                            policy=self.exec_policy, faults=faults,
                            estimate=est, partial=True,
                            op_timings=timings)
                except PULostError as err:
                    window_s.append(time.perf_counter() - tw)
                    exec_wall += window_s[-1]
                    t_fail = time.perf_counter()
                    commit(handles, err.partial or frontiers, steps)
                    health.record_loss(err.pu, now)
                    recover(t_fail)
                    return
                except ExecutionTimeoutError as err:
                    window_s.append(time.perf_counter() - tw)
                    exec_wall += window_s[-1]
                    t_fail = time.perf_counter()
                    lanes = sorted(err.inflight) or window_pus
                    opened = False
                    for lane in lanes:
                        opened |= health.record_failure(
                            lane, now, "timeout")
                    attempts += 1
                    retried += 1
                    for h in handles:
                        if h in inflight:
                            inflight[h].retries += 1
                    if opened:
                        recover(t_fail)
                        return
                    if attempts <= self.max_window_retries:
                        continue       # discard + re-execute the window
                    for h in handles:
                        if h in inflight:
                            shed_inflight(h, "timeout")
                    plan = None
                    return
                except FaultRetryExceededError as err:
                    window_s.append(time.perf_counter() - tw)
                    exec_wall += window_s[-1]
                    t_fail = time.perf_counter()
                    opened = err.lane is not None and health.record_failure(
                        err.lane, now, "retry_exceeded")
                    attempts += 1
                    retried += 1
                    for h in handles:
                        if h in inflight:
                            inflight[h].retries += 1
                    if opened:
                        recover(t_fail)
                        return
                    if attempts <= self.max_window_retries:
                        continue
                    if err.request is not None \
                            and 0 <= err.request < len(handles) \
                            and handles[err.request] in inflight:
                        shed_inflight(handles[err.request], "fault")
                    else:
                        for h in handles:
                            if h in inflight:
                                shed_inflight(h, "fault")
                    plan = None
                    return
                # -- success ------------------------------------------------
                window_s.append(time.perf_counter() - tw)
                exec_wall += window_s[-1]
                slot_model = [inflight[h].model if h in inflight else None
                              for h in handles]
                commit(handles, results, steps)
                for pu, r, i, dt in timings:
                    if slot_model[r] is None:
                        continue
                    pred = self._predicted(slot_model[r], i, pu)
                    if pred is not None:
                        health.observe(pu, pred, dt, now)
                executed = {pu for pu, _r, _i, _dt in timings} \
                    if timings else set(window_pus)
                for pu in executed & health.half_open():
                    health.probe_result(pu, ok=True, now=now)
                if health.dirty():
                    apply_health()     # e.g. a drift rescale folded in
                return

        while True:
            # -- drain the arrival stream up to the virtual clock ------------
            while not stream_done:
                if pending is None:
                    if queue.empty() and (inflight or waiting):
                        break          # nothing delivered yet; keep serving
                    item = await queue.get()
                    if item is None:
                        stream_done = True
                        break
                    pending = item
                if pending.time > now and (inflight or waiting):
                    break              # future arrival; serve current work
                now = max(now, pending.time)
                if t0 is None:
                    t0 = pending.time
                rec = record_of(pending)
                records.append(rec)
                if rec.ops_total and not self._model_feasible(rec.model):
                    shed(rec, "infeasible")
                else:
                    waiting.append(rec)
                pending = None
            if not inflight and not waiting:
                if stream_done and pending is None:
                    break              # drained
                continue

            # -- membership / progress boundary: admit + (re)plan ------------
            if real:
                arm_chaos()            # the serving clock reached new events
                if health.due_probes(now):
                    apply_health()     # half-open: re-admit for probing
            if admit_due():
                cursor = 0
            if plan is None:
                replan()
            if plan is None:           # everything fully advanced
                for h, rec in list(inflight.items()):
                    rec.finished_at = now
                    rec.handle = None
                    inflight.pop(h)
                    orch.retire(h, self.objective, self.horizon_states)
                    self._release(rec.model, h)
                continue

            if real:
                # -- really execute the next step window ---------------------
                end = select_window()
                if end <= cursor:
                    plan = None        # window exhausted: warm re-plan
                else:
                    exec_window(end)
                    if plan is not None and cursor >= \
                            len(plan.schedule.steps):
                        plan = None
            else:
                # -- run planned steps in virtual time -----------------------
                steps = plan.schedule.steps
                handles = plan.handles
                horizon = pending.time if pending is not None else None
                finished: list[int] = []
                while cursor < len(steps):
                    if horizon is not None and now >= horizon:
                        break          # an arrival is due: admit first
                    step = steps[cursor]
                    cursor += 1
                    busy_time += len(inflight) * step.cost
                    now += step.cost
                    for slot, op in enumerate(step.ops):
                        if op is None:
                            continue
                        h = handles[slot]
                        rec = inflight[h]
                        orch.advance(h, 1)
                        rec.ops_done += 1
                        if rec.ops_done >= rec.ops_total:
                            finished.append(h)
                    if finished:
                        break          # membership change: re-plan
                for h in finished:
                    rec = inflight.pop(h)
                    rec.finished_at = now
                    rec.handle = None
                    plan = timed(orch.retire, h, self.objective,
                                 self.horizon_states)
                    cursor = 0
                    self._release(rec.model, h)
                if not finished and cursor >= len(steps):
                    plan = None        # window exhausted: warm re-plan
            # mid-flight SLO check at the boundary
            for h, rec in list(inflight.items()):
                if rec.deadline is not None and \
                        now + bound(rec) > rec.deadline:
                    inflight.pop(h)
                    orch.retire(h, self.objective, self.horizon_states)
                    shed(rec, "slo")
                    plan = None
            await asyncio.sleep(0)     # cooperative yield per boundary

        if real:
            # each completion against its solo run, once the run drained:
            # a solo run is not serving work, so it must not count in the
            # recovery or re-plan times
            for rec in records:
                if rec.finished_at is not None:
                    rec.bitwise_ok = results_bitwise_equal(rec.results,
                                                           self._ref(rec))
        lats = [r.latency for r in records if r.latency is not None]
        completed = len(lats)
        makespan = max(now - (t0 or 0.0), 0.0)
        shed_reasons: dict[str, int] = {}
        for r in records:
            if r.shed:
                shed_reasons[r.shed_reason] = \
                    shed_reasons.get(r.shed_reason, 0) + 1
        cache1 = orch.cache_stats()
        cache_delta = {k: v - cache0.get(k, 0)
                       for k, v in cache1.items() if isinstance(v, int)}
        cache_delta["sizes"] = cache1.get("sizes", {})
        checked = [r for r in records if r.bitwise_ok is not None]
        return ServeReport(
            n_requests=len(records),
            completed=completed,
            shed=sum(r.shed for r in records),
            makespan=makespan,
            throughput=completed / makespan if makespan > 0 else 0.0,
            latency_p50=_pct(lats, 50), latency_p99=_pct(lats, 99),
            plan_ms_p50=_pct(plan_ms, 50), plan_ms_p99=_pct(plan_ms, 99),
            plan_events=len(plan_ms),
            replans_warm=orch.stats["replans_warm"] - warm0,
            replans_cold=orch.stats["replans_cold"] - cold0,
            occupancy_mean=busy_time / makespan if makespan > 0 else 0.0,
            recovered=sum(1 for r in records
                          if r.recovered and r.latency is not None),
            retried=retried,
            recoveries=recoveries,
            recovery_ms_p50=_pct(recovery_ms, 50),
            recovery_ms_p99=_pct(recovery_ms, 99),
            shed_reasons=shed_reasons,
            bitwise_checked=len(checked),
            bitwise_failures=sum(1 for r in checked if not r.bitwise_ok),
            exec_wall_s=exec_wall,
            breaker=health.stats() if health is not None else {},
            cache=cache_delta,
            requests=records)

    def _predicted(self, model: str, op: int, pu: str) -> float | None:
        """Cost-model latency for ``op`` of ``model`` on ``pu`` (drift ref)."""
        wl = self.orch.workload(self._base[model])
        d = wl.dense
        try:
            pos = list(wl.chain).index(op)
            j = list(d.pus).index(pu)
        except ValueError:
            return None
        if not d.mask[pos, j]:
            return None
        return float(d.w[pos, j])

    # -- feasibility probes --------------------------------------------------
    def _avail_cols(self, model: str) -> list[int]:
        d = self.orch.workload(self._base[model]).dense
        gone = self.orch.condition.unavailable
        return [i for i, pu in enumerate(d.pus) if pu not in gone]

    def _model_feasible(self, model: str) -> bool:
        d = self.orch.workload(self._base[model]).dense
        cols = self._avail_cols(model)
        if not cols:
            return False
        return bool(d.mask[:, cols].any(axis=1).all())

    def _infeasible(self, rec: RequestRecord) -> bool:
        d = self.orch.workload(self._base[rec.model]).dense
        cols = self._avail_cols(rec.model)
        if not cols:
            return True
        return not bool(d.mask[rec.ops_done:, cols].any(axis=1).all())
