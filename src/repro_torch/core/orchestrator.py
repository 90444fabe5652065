"""``Orchestrator`` — the session-style front door of BIDENT.

Port of the sequential part of ``repro.core.orchestrator``: the
register → plan → execute flow of a serving system,

    orch = Orchestrator(MeasuredProfiler(targets=reg), targets=reg)
    h = orch.register(graph)              # profile + dense Workload, once
    plan = orch.plan(h)                   # sequential DP, cached
    outputs = orch.execute(plan, inputs)  # compiled lane program

* ``register`` profiles the graph through the configured cost provider
  (or takes a prebuilt ``CostTable``) and memoizes the dense
  ``Workload``.  Malformed inputs fail here with descriptive errors.
* ``plan`` solves one chain handle with the sequential DP; the result
  is bitwise identical to the direct ``solve_sequential`` call and is
  cached keyed by (workload signature, objective).  Every other regime
  of the reference — parallel, concurrent, aligned and DAG plans,
  runtime conditions, admission, PU-loss recovery — raises
  ``NotImplementedError`` naming its ``ROADMAP.md`` item.
* ``execute`` runs a plan through a compiled, cached
  :class:`~repro_torch.core.laneprogram.LaneProgram` by default;
  ``compile=False`` runs the per-op interpreter, the bitwise oracle.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping, Sequence

from .costmodel import EDGE_PUS, CostTable, PUSpec
from .executor import ScheduleExecutor
from .faults import ExecutionPolicy, FaultPlan
from .laneprogram import LaneProgram
from .op import FusedOp, OpGraph, chain_graph
from .schedule import SeqSchedule, schedule_from_dict, schedule_to_dict
from .search import solve_sequential
from .targets import pu_specs_for_targets, resolve_targets
from .workload import Workload

PLAN_MODES = ("auto", "sequential")
_NOT_PORTED = ("{what} is not ported yet (ROADMAP.md, 'Modules to port', "
               "item {item})")


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(_NOT_PORTED.format(what=what, item=item))


@dataclasses.dataclass
class Plan:
    """Result of ``Orchestrator.plan``: one schedule plus the routing
    metadata needed to execute or serialize it."""

    kind: str          # "sequential" (the only kind the port plans yet)
    schedule: SeqSchedule
    objective: str
    handles: tuple[int, ...] = ()
    mode: str = ""
    # the plan-cache key this plan was stored under (the program cache
    # reuses it); not serialized: restored plans fall back to a content
    # hash
    cache_key: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def latency(self) -> float:
        return self.schedule.latency

    @property
    def energy(self) -> float:
        return self.schedule.energy

    @property
    def route(self) -> list[list[tuple[int, str]]]:
        """Per-request ``[(op index, PU name), ...]`` in execution order."""
        s = self.schedule
        return [list(zip(s.chain, s.assignment))]

    def to_json(self) -> str:
        return json.dumps({"kind": self.kind, "objective": self.objective,
                           "handles": list(self.handles), "mode": self.mode,
                           "schedule": schedule_to_dict(self.schedule)})

    @classmethod
    def from_json(cls, s: str) -> "Plan":
        d = json.loads(s)
        return cls(kind=d["kind"], schedule=schedule_from_dict(d["schedule"]),
                   objective=d["objective"], handles=tuple(d["handles"]),
                   mode=d.get("mode", ""))


def _arg_signature(a) -> tuple:
    """(shape, dtype) of one input, without copying it to the host."""
    return (tuple(a.shape), str(a.dtype), str(getattr(a, "device", "")))


def _inputs_signature(inputs) -> tuple | None:
    """Hashable shapes/dtypes/devices signature of ``execute`` inputs."""
    if inputs is None:
        return None
    return tuple(sorted((i, tuple(_arg_signature(a) for a in args))
                        for i, args in inputs.items()))


@dataclasses.dataclass
class _Registration:
    handle: int
    graph: OpGraph
    chain: list[int]
    table: CostTable
    wl: Workload
    sig: str          # Workload content signature (chain + dense arrays)
    # the exact object the caller registered — kept alive so the
    # id()-keyed memo can never collide with a recycled address
    source: Any = None


class Orchestrator:
    """Session front door: register inference graphs once, plan with
    caching, and execute plans on the multi-lane executor.

    ``cost`` is the cost provider: an ``EdgeSoCCostModel``-like object
    (``build_table(graph)``), a profiler (``profile(graph)``), or a
    prebuilt ``CostTable`` applied to every registered graph (op indices
    must then match that table).

    ``targets`` binds PU lane names to registered execution
    :class:`~repro_torch.core.targets.Target`\\ s (a ``{lane: Target}``
    mapping, a :class:`~repro_torch.core.targets.TargetRegistry`, or an
    iterable of targets).  When bound, ``pus`` defaults to the targets'
    synthesized specs and the compiled execution path serves per-target
    payload variants (probe-verified).  The interpreter path
    (``execute(compile=False)``) always runs the reference payloads.
    """

    def __init__(self, cost, pus: Mapping[str, PUSpec] | None = None,
                 max_cached_plans: int = 256, max_cached_programs: int = 64,
                 targets=None):
        if not (isinstance(cost, CostTable) or hasattr(cost, "build_table")
                or hasattr(cost, "profile")):
            raise TypeError(
                "cost must be a CostTable, a cost model with "
                "build_table(graph), or a profiler with profile(graph); "
                f"got {type(cost).__name__}")
        self.cost = cost
        self.targets = resolve_targets(targets)
        if pus is None:
            pus = (pu_specs_for_targets(self.targets)
                   if self.targets else EDGE_PUS)
        self.pus = dict(pus)
        if self.targets:
            unknown = sorted(set(self.targets) - set(self.pus))
            if unknown:
                raise ValueError(
                    f"target binding names lane(s) {unknown} absent from "
                    f"the PU set {sorted(self.pus)}")
        self.executor = ScheduleExecutor(list(self.pus),
                                         targets=self.targets)
        self.stats = {"hits": 0, "misses": 0,
                      "program_hits": 0, "program_misses": 0,
                      "plan_evictions": 0, "program_evictions": 0}
        self._max_plans = max_cached_plans
        self._max_programs = max_cached_programs
        self._programs: dict[tuple, LaneProgram] = {}  # insertion-ordered LRU
        self._regs: dict[int, _Registration] = {}
        self._by_graph: dict[int, int] = {}          # id(graph) -> handle
        self._plans: dict[tuple, Plan] = {}          # insertion-ordered LRU

    def _evict_lru(self, cache: dict, cap: int, stat: str) -> None:
        """Drop oldest entries of an insertion-ordered LRU dict past
        ``cap``, counting them under ``stats[stat]``."""
        while len(cache) > cap:
            cache.pop(next(iter(cache)))
            self.stats[stat] += 1

    # -- register -----------------------------------------------------------
    def register(self, graph: OpGraph | Sequence[FusedOp],
                 table: CostTable | None = None) -> int:
        """Profile ``graph`` (unless ``table`` is given) and build its
        dense ``Workload`` once; returns a handle for ``plan``.

        Re-registering the same graph (or op-sequence) object without an
        explicit ``table`` returns the existing handle without
        re-profiling; explicitly-tabled registrations always get a fresh
        handle.  A bare sequence of ``FusedOp``s is wrapped into a chain
        graph.
        """
        source = graph
        memo_key = id(source)
        explicit_table = table is not None
        if not explicit_table and memo_key in self._by_graph:
            return self._by_graph[memo_key]
        if not isinstance(graph, OpGraph):
            graph = chain_graph(list(graph))
        if not len(graph.ops):
            raise ValueError("register: the graph has no ops")
        if table is None:
            if isinstance(self.cost, CostTable):
                table = self.cost
            elif hasattr(self.cost, "build_table"):
                table = self.cost.build_table(graph)
            else:
                table = self.cost.profile(graph)
        chain = graph.topo_order()
        wl = Workload.build(chain, table, self.pus, ops=graph.ops)
        h = len(self._regs)
        self._regs[h] = _Registration(handle=h, graph=graph, chain=chain,
                                      table=table, wl=wl,
                                      sig=wl.signature(), source=source)
        if not explicit_table:
            self._by_graph[memo_key] = h
        return h

    def workload(self, h: int) -> Workload:
        """The memoized dense Workload of a registered handle."""
        return self._reg(h).wl

    def _reg(self, h: int) -> _Registration:
        try:
            return self._regs[h]
        except KeyError:
            raise KeyError(
                f"unknown handle {h!r}; register(graph) first "
                f"(valid handles: {sorted(self._regs)})") from None

    # -- plan ---------------------------------------------------------------
    def plan(self, handles: int | Sequence[int], objective: str = "latency",
             mode: str = "auto") -> Plan:
        """Solve (or serve from cache) the schedule of one chain handle
        with the sequential DP (``mode`` ``"auto"`` or ``"sequential"``).
        Bitwise identical to the direct ``solve_sequential`` call."""
        hs = (handles,) if isinstance(handles, int) else tuple(handles)
        if not hs:
            raise ValueError("plan: no handles given")
        regs = [self._reg(h) for h in hs]
        if len(hs) > 1 or mode in ("concurrent", "aligned"):
            raise _not_ported("concurrent planning of several handles", 1)
        if mode in ("parallel", "dag"):
            raise _not_ported(f"mode={mode!r}", 1)
        if mode not in PLAN_MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {PLAN_MODES}")
        reg = regs[0]
        if not reg.graph.is_chain() or len(reg.graph.components()) > 1:
            raise _not_ported("planning a graph that is not one chain "
                              "(fork/join or disconnected)", 1)
        key = (reg.sig, objective, "sequential")
        plan = self._plans.get(key)
        if plan is not None:
            self.stats["hits"] += 1
            self._plans[key] = self._plans.pop(key)   # LRU refresh
            return plan if plan.handles == hs \
                else dataclasses.replace(plan, handles=hs)
        self.stats["misses"] += 1
        sched = solve_sequential(reg.wl.chain, reg.graph.ops, reg.table,
                                 self.pus, objective, workload=reg.wl)
        plan = Plan("sequential", sched, objective, hs, "sequential",
                    cache_key=key)
        self._plans[key] = plan
        self._evict_lru(self._plans, self._max_plans, "plan_evictions")
        return plan

    # -- execute ------------------------------------------------------------
    def execute(self, plan: Plan, inputs=None, *, compile: bool = True,
                policy: ExecutionPolicy | None = None,
                faults: FaultPlan | None = None) -> Any:
        """Run a plan on the multi-lane executor; takes one
        ``{op: (args...)}`` mapping and returns the graph's results dict.

        By default execution goes through the compiled, cached lane
        program (:meth:`program_for`); ``compile=False`` runs the per-op
        interpreter, the bitwise oracle.  ``policy``/``faults`` drive the
        fault runtime as in the reference; a PU loss propagates as
        :class:`~repro_torch.core.errors.PULostError` (re-planning onto
        the surviving PUs needs runtime conditions, ROADMAP.md item 2).
        """
        if plan.kind != "sequential":
            raise _not_ported(f"executing a {plan.kind!r} plan", 1)
        if not compile:
            graph = self._execute_regs(plan)[0].graph
            return self.executor.run_scheduled(
                graph, plan.schedule, inputs,
                policy=policy, faults=faults, estimate=plan.latency)
        return self.program_for(plan, inputs).run(
            inputs, policy=policy, faults=faults, estimate=plan.latency)

    def program_for(self, plan: Plan, inputs=None) -> LaneProgram:
        """The compiled :class:`LaneProgram` for a plan (cached).

        The cache key is (plan cache key — or a content hash for plans
        restored from JSON —, the plan's handles, and the shapes, dtypes
        and devices of ``inputs``); a program whose payloads were rebound
        after compilation is recompiled, never served.
        """
        key = (self._plan_token(plan), plan.handles,
               _inputs_signature(inputs))
        prog = self._programs.get(key)
        if prog is not None:
            if prog.payloads_current():
                self.stats["program_hits"] += 1
                self._programs[key] = self._programs.pop(key)  # LRU refresh
                return prog
            del self._programs[key]
        self.stats["program_misses"] += 1
        graph = self._execute_regs(plan)[0].graph
        prog = self.executor.compile_scheduled(graph, plan.schedule)
        self._programs[key] = prog
        self._evict_lru(self._programs, self._max_programs,
                        "program_evictions")
        return prog

    def _execute_regs(self, plan: Plan) -> list[_Registration]:
        if not plan.handles:
            raise ValueError("plan carries no handles; was it built by "
                             "this orchestrator (or restored from JSON "
                             "with handles intact)?")
        regs = [self._reg(h) for h in plan.handles]
        # a stale/re-registered plan must fail here with the handle named,
        # not deep inside lane-queue construction
        for reg, route in zip(regs, plan.route):
            n = len(reg.graph.ops)
            bad = [i for i, _ in route if not 0 <= i < n]
            if bad:
                raise ValueError(
                    f"plan does not match handle {reg.handle}: it routes "
                    f"op {bad[0]} but the graph registered under that "
                    f"handle has {n} op(s) — the plan is stale")
            unknown = sorted({p for _, p in route if p not in self.pus})
            if unknown:
                raise ValueError(
                    f"plan for handle {reg.handle} routes ops to unknown "
                    f"PU(s) {unknown}; this session's PUs are "
                    f"{sorted(self.pus)}")
        return regs

    def _plan_token(self, plan: Plan):
        if plan.cache_key is None:
            # JSON-restored / hand-built plan: memoize the content hash
            plan.cache_key = ("content", hashlib.blake2b(
                plan.to_json().encode(), digest_size=16).hexdigest())
        return plan.cache_key
