"""``Orchestrator`` — the session-style front door of BIDENT.

Port of ``repro.core.orchestrator``: the register → plan → execute flow
of a serving system,

    orch = Orchestrator(MeasuredProfiler(targets=reg), targets=reg)
    h = orch.register(graph)              # profile + dense Workload, once
    plan = orch.plan(h)                   # routed solve, cached
    outputs = orch.execute(plan, inputs)  # compiled lane program

* ``register`` profiles the graph through the configured cost provider
  (or takes a prebuilt ``CostTable``) and memoizes the dense
  ``Workload``.  Malformed inputs fail here with descriptive errors.
* ``plan`` routes by shape as the reference does: one chain handle →
  the sequential DP; one fork/join handle → the phase/branch parallel
  solve; one *disconnected* handle (a union of chains) → the DAG route;
  several handles → the M-ary concurrent search (``mode="aligned"``
  opts a pair into the lockstep solver, ``mode="dag"`` forces the
  antichain-frontier front door
  :func:`~repro_torch.core.search.solve_dag` for any single-handle
  shape).  Results are bitwise identical to the direct solver calls and
  cached keyed by (workload signatures + progress, objective, resolved
  mode, route knobs, runtime-condition scaling); the
  objective-independent solver state (``ConcurrentCaches``) is one pool
  per condition.
* ``on_condition`` folds in a
  :class:`~repro_torch.core.dynamic.RuntimeCondition` (per-PU column
  scalings on the dense views, unavailable PUs dropped).  Cached plans,
  pools, condition views and warm solvers priced under a now-stale
  assumption about a changed PU are invalidated; active chain handles
  re-plan through their :class:`~repro_torch.core.dynamic.DynamicScheduler`
  from their current progress (hysteresis and plan stitching included).
* ``admit`` / ``advance`` / ``retire`` / ``replan_active`` maintain the
  online serving set: each re-plan covers every active request's
  *remaining* ops (``Workload.tail`` views), served by a warm
  :class:`~repro_torch.core.search.IncrementalConcurrentSolver` per
  workload tuple whose schedules are bitwise the cold
  ``solve_concurrent`` ones (``stats["replans_warm"]`` /
  ``stats["replans_cold"]`` count the split); ``horizon_states`` bounds
  a re-plan to the next exact window
  (:func:`~repro_torch.core.search.solve_concurrent_horizon`).
  ``admit`` / ``retire`` / ``replan_active`` return ``None``, not a
  ``Plan``, when nothing is left to schedule.
* ``execute`` runs a plan through a compiled, cached
  :class:`~repro_torch.core.laneprogram.LaneProgram` by default — inline
  for a chain, on one worker thread and one CUDA stream per lane when
  segments can co-execute; ``compile=False`` runs the per-op
  interpreter, the bitwise oracle.  DAG plans synchronise lanes only at
  the graph's true dependency edges.  Concurrent plans take one input
  mapping per request and return one results dict per request.  A
  permanent PU loss mid-run is recovered by default
  (``recover=True``): the loss folds into the session condition, the
  ops missing from the frontier are re-planned onto the surviving PUs,
  and the run resumes on the interpreter seeded with the completed
  results.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping, Sequence

from .capture import arg_signature as _arg_signature
from .contention import ContentionModel
from .costmodel import EDGE_PUS, CostTable, PUSpec
from .dynamic import DynamicScheduler, RuntimeCondition
from .errors import PULostError
from .executor import ScheduleExecutor
from .faults import ExecutionPolicy, FaultPlan
from .laneprogram import LaneProgram
from .op import FusedOp, OpGraph, chain_graph
from .schedule import (ConcurrentSchedule, ConcurrentStep, DagSchedule,
                       ParallelSchedule, SeqSchedule, schedule_from_dict,
                       schedule_to_dict)
from .search import (DAG_ALGORITHMS, ConcurrentCaches,
                     IncrementalConcurrentSolver, _pair_cache,
                     solve_concurrent, solve_concurrent_aligned,
                     solve_concurrent_horizon, solve_dag, solve_parallel,
                     solve_sequential)
from .targets import pu_specs_for_targets, resolve_targets
from .workload import Workload

PLAN_MODES = ("auto", "sequential", "parallel", "concurrent", "aligned",
              "dag")
# concurrent-search routes accepted by plan(algorithm=...), as in the
# reference (mode="dag" takes search.DAG_ALGORITHMS instead)
CONCURRENT_ALGORITHMS = ("auto", "grid", "grid_astar", "rolling", "pairwise")


@dataclasses.dataclass
class Plan:
    """Uniform result of ``Orchestrator.plan``: one schedule of any kind
    plus the routing metadata needed to execute or serialize it."""

    kind: str          # "sequential" | "parallel" | "concurrent" | "dag"
    schedule: (SeqSchedule | ParallelSchedule | ConcurrentSchedule
               | DagSchedule)
    objective: str
    handles: tuple[int, ...] = ()
    mode: str = ""            # resolved plan mode (e.g. "aligned")
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
        """Per-request ``[(op index, PU name), ...]`` in execution order.
        For parallel plans the order is phase by phase, each branch's
        chain listed whole; for DAG plans step by step (co-scheduled ops
        listed together)."""
        s = self.schedule
        if isinstance(s, SeqSchedule):
            return [list(zip(s.chain, s.assignment))]
        if isinstance(s, DagSchedule):
            return [[(o, p) for st in s.steps
                     for o, p in zip(st.ops, st.pus)]]
        if isinstance(s, ParallelSchedule):
            out: list[tuple[int, str]] = []
            for ph in s.phases:
                for br in ph.branches:
                    out.extend(zip(br.branch_ops, br.assignment))
            return [out]
        return [s.assignment_of(r) for r in range(s.n_requests)]

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


def _inputs_signature(inputs) -> tuple | None:
    """Hashable shapes/dtypes/devices signature of ``execute`` inputs:
    one sorted ``(op, per-arg signature)`` tuple per request mapping."""
    if inputs is None:
        return None

    def one(mapping) -> tuple:
        if mapping is None:
            return ()
        return tuple(sorted((i, tuple(_arg_signature(a) for a in args))
                            for i, args in mapping.items()))

    if isinstance(inputs, Mapping):
        return ("single", one(inputs))
    return ("multi", tuple(one(m) for m in inputs))


@dataclasses.dataclass
class _Registration:
    handle: int
    graph: OpGraph
    chain: list[int]
    table: CostTable
    wl: Workload
    sig: str          # Workload content signature (chain + dense arrays)
    struct_sig: str   # graph edge-structure hash (phases/branches)
    # the exact object the caller registered — kept alive so the
    # id()-keyed memo can never collide with a recycled address
    source: Any = None
    # lazily-built DAG workload (``Workload.from_graph`` — same dense
    # arrays as ``wl`` plus explicit predecessor sets).  Kept separate so
    # the preds-free ``wl``/``sig`` the chain/concurrent routes key their
    # caches by are untouched by DAG planning.
    dag_wl: Workload | None = None


class Orchestrator:
    """Session front door: register inference graphs once, plan under any
    objective/regime with caching, react to runtime conditions, and
    execute plans on the multi-lane executor.

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
                 contention: ContentionModel | None = None,
                 max_cached_plans: int = 256, max_cache_pools: int = 32,
                 max_cached_programs: int = 64, targets=None):
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
        self.contention = contention or ContentionModel()
        self.executor = ScheduleExecutor(list(self.pus),
                                         targets=self.targets)
        self.condition = RuntimeCondition()
        self.stats = {"hits": 0, "misses": 0, "invalidated": 0,
                      "program_hits": 0, "program_misses": 0,
                      "recoveries": 0,
                      "replans_warm": 0, "replans_cold": 0,
                      "plan_evictions": 0, "pool_evictions": 0,
                      "cond_view_evictions": 0, "program_evictions": 0,
                      "warm_evictions": 0}
        self._max_plans = max_cached_plans
        self._max_pools = max_cache_pools
        self._max_programs = max_cached_programs
        self._programs: dict[tuple, LaneProgram] = {}  # insertion-ordered LRU
        self._regs: dict[int, _Registration] = {}
        self._by_graph: dict[int, int] = {}          # id(graph) -> handle
        self._plans: dict[tuple, Plan] = {}          # insertion-ordered LRU
        self._pools: dict[tuple, ConcurrentCaches] = {}
        self._cond_views: dict[tuple, Workload] = {}
        self._warm: dict[tuple, IncrementalConcurrentSolver] = {}
        self._active: dict[int, int] = {}            # handle -> ops done
        self._dyn: dict[tuple[int, str], DynamicScheduler] = {}

    def _evict_lru(self, cache: dict, cap: int, stat: str,
                   close: bool = False) -> None:
        """Drop oldest entries of an insertion-ordered LRU dict past
        ``cap``, counting them under ``stats[stat]``."""
        while len(cache) > cap:
            victim = cache.pop(next(iter(cache)))
            if close:
                victim.close()
            self.stats[stat] += 1

    def cache_stats(self) -> dict:
        """Bounded-cache pressure snapshot: the session's LRU eviction
        counters plus the live pools' ``ConcurrentCaches`` trim counters
        and current cache sizes.  ``ServeReport.cache`` surfaces the
        over-a-run delta of the counters.  (Trim counters cover the
        *live* pools; a pool evicted whole takes its counts with it —
        the eviction itself shows up in ``pool_evictions``.)"""
        counters = {k: self.stats[k] for k in (
            "plan_evictions", "pool_evictions", "cond_view_evictions",
            "program_evictions", "warm_evictions", "invalidated")}
        trims = {"pair_trims": 0, "group_table_trims": 0,
                 "group_scope_trims": 0}
        for pool in self._pools.values():
            for k in trims:
                trims[k] += pool.stats[k]
        return {**counters, **trims,
                "sizes": {"plans": len(self._plans),
                          "pools": len(self._pools),
                          "cond_views": len(self._cond_views),
                          "warm_solvers": len(self._warm),
                          "programs": len(self._programs)}}

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
        struct_sig = hashlib.blake2b(repr(sorted(graph.edges)).encode(),
                                     digest_size=8).hexdigest()
        self._regs[h] = _Registration(handle=h, graph=graph, chain=chain,
                                      table=table, wl=wl,
                                      sig=wl.signature(),
                                      struct_sig=struct_sig, source=source)
        if not explicit_table:
            self._by_graph[memo_key] = h
        return h

    def workload(self, h: int) -> Workload:
        """The memoized dense Workload of a registered handle (nominal
        profile; conditions are applied per plan, not destructively)."""
        return self._reg(h).wl

    def _reg(self, h: int) -> _Registration:
        try:
            return self._regs[h]
        except KeyError:
            raise KeyError(
                f"unknown handle {h!r}; register(graph) first "
                f"(valid handles: {sorted(self._regs)})") from None

    # -- runtime condition ---------------------------------------------------
    def _cond_key(self, cond: RuntimeCondition | None = None) -> tuple:
        return (cond if cond is not None else self.condition).key(self.pus)

    def _cond_view(self, key: tuple, base: Workload) -> Workload:
        """``base`` under the active condition, memoized in the
        ``_cond_views`` LRU under ``key`` (the condition key last)."""
        wl = self._cond_views.get(key)
        if wl is None:
            wl = base.under_condition(self.condition.slowdown,
                                      self.condition.unavailable)
            self._cond_views[key] = wl
            self._evict_lru(self._cond_views, self._max_pools,
                            "cond_view_evictions")
        else:
            self._cond_views[key] = self._cond_views.pop(key)  # LRU refresh
        return wl

    def _wl(self, reg: _Registration) -> Workload:
        """Registration workload under the active condition (memoized
        derived view; the nominal workload itself when no condition)."""
        if self.condition.nominal:
            return reg.wl
        return self._cond_view((reg.handle, self._cond_key()), reg.wl)

    def _dag_wl(self, reg: _Registration) -> Workload:
        """Registration DAG workload (``Workload.from_graph``, built
        lazily) under the active condition.  ``under_condition`` carries
        the predecessor sets, so the derived view keeps its DAG shape;
        views share the ``_cond_views`` LRU under a dag-tagged key."""
        if reg.dag_wl is None:
            reg.dag_wl = Workload.from_graph(reg.graph, reg.table, self.pus)
        if self.condition.nominal:
            return reg.dag_wl
        return self._cond_view(((reg.handle, "dag"), self._cond_key()),
                               reg.dag_wl)

    def on_condition(self, cond: RuntimeCondition
                     ) -> dict[tuple[int, str], Plan]:
        """Fold a runtime condition into the session.

        Cached plans, solver pools, condition views and warm solvers are
        invalidated *per changed PU*: an entry priced under an assumption
        about a changed PU that disagrees with the new condition is
        dropped (keys fully encode the condition, so this is staleness
        hygiene, not hit-correctness; entries that already agree with
        the new factors on every changed PU survive).  Active chain
        handles re-plan through their ``DynamicScheduler`` trackers from
        current progress — hysteresis and prefix/tail stitching apply —
        and the re-stitched sequential plans are returned keyed by
        ``(handle, objective)``, one entry per tracker (a
        latency-objective tracker is created for active chain handles
        that have none).

        PU names the session doesn't know are rejected loudly — a typo'd
        ``slowdown`` key would otherwise silently leave the real PU
        unthrottled in every re-plan.
        """
        unknown = sorted(p for p in set(cond.slowdown) | set(cond.unavailable)
                         if p not in self.pus)
        if unknown:
            raise ValueError(
                f"on_condition: unknown PU name(s) {unknown}; this "
                f"session's PUs are {sorted(self.pus)}")
        old, new = self._cond_key(), self._cond_key(cond)
        changed = {p for (p, f0), (_, f1) in zip(old, new) if f0 != f1}
        if changed:
            new_f = dict(new)
            for cache in (self._plans, self._pools, self._cond_views,
                          self._warm):
                for key in list(cache):
                    entry_cond = key[-1]
                    if any(p in changed and f != new_f[p]
                           for p, f in entry_cond):
                        del cache[key]
                        if cache is self._plans:
                            self.stats["invalidated"] += 1
        self.condition = cond
        out: dict[tuple[int, str], Plan] = {}
        for h, progress in self._active.items():
            reg = self._regs[h]
            if not reg.graph.is_chain():
                continue
            if not any(dh == h for dh, _ in self._dyn):
                self.dynamic(h)        # default latency-objective tracker
            for (dh, objective), dyn in list(self._dyn.items()):
                if dh != h:
                    continue
                sched = dyn.on_condition(progress, cond)
                out[(h, objective)] = Plan(kind="sequential", schedule=sched,
                                           objective=objective, handles=(h,),
                                           mode="sequential")
        return out

    def dynamic(self, h: int, objective: str = "latency",
                replan_threshold: float = 0.05) -> DynamicScheduler:
        """The handle's ``DynamicScheduler`` (created lazily, sharing the
        memoized workload); ``on_condition`` re-plans through it."""
        reg = self._reg(h)
        if not reg.graph.is_chain():
            raise ValueError(
                f"handle {h}: dynamic re-planning needs a chain graph "
                "(the DAG regimes re-plan via plan() under a condition)")
        key = (h, objective)
        dyn = self._dyn.get(key)
        if dyn is None:
            dyn = DynamicScheduler(reg.chain, reg.graph.ops, reg.table,
                                   self.pus, objective,
                                   replan_threshold=replan_threshold,
                                   workload=reg.wl)
            self._dyn[key] = dyn
        return dyn

    # -- plan ---------------------------------------------------------------
    def plan(self, handles: int | Sequence[int], objective: str = "latency",
             mode: str = "auto", algorithm: str = "auto",
             max_states: int | None = None) -> Plan:
        """Solve (or serve from cache) a schedule for one or more handles.

        ``mode="auto"`` routes a single chain handle to the sequential
        DP, a single fork/join handle to the phase/branch parallel solve,
        a single *disconnected* handle (a union of chains) to the DAG
        route, and several handles to the M-ary concurrent search;
        ``"aligned"`` forces the lockstep pair solver for exactly two
        handles; ``"dag"`` forces the antichain-frontier front door
        (:func:`~repro_torch.core.search.solve_dag`) for any
        single-handle graph shape.  Results are bitwise identical to the
        corresponding direct solver call on the same workloads.

        ``algorithm`` and ``max_states`` are route knobs passed through
        verbatim: for concurrent plans the
        :func:`~repro_torch.core.search.solve_concurrent` set (``"grid"``,
        ``"grid_astar"``, ``"rolling"``, ``"pairwise"``), for DAG plans
        the :func:`~repro_torch.core.search.solve_dag` set (``"chain"``,
        ``"union-grid"``, ``"phase"``, ``"frontier"``); ``max_states``
        bounds the exact-solve grid / discovered order ideals.  Both are
        part of the plan-cache key, and they are rejected for modes
        without such knobs rather than silently ignored.
        """
        hs = (handles,) if isinstance(handles, int) else tuple(handles)
        if not hs:
            raise ValueError("plan: no handles given")
        regs = [self._reg(h) for h in hs]
        if mode not in PLAN_MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {PLAN_MODES}")
        if max_states is not None and max_states < 1:
            raise ValueError(f"max_states must be >= 1, got {max_states}")
        if mode == "auto":
            if len(hs) > 1:
                mode = "concurrent"
            elif not regs[0].graph.is_chain():
                mode = "parallel"
            elif len(regs[0].graph.components()) > 1:
                # degree-wise a "chain" but disconnected: a union of
                # chains has no single sequence to DP over — route it to
                # the DAG front door (union-grid co-scheduling)
                mode = "dag"
            else:
                mode = "sequential"
        allowed = (DAG_ALGORITHMS if mode == "dag"
                   else CONCURRENT_ALGORITHMS)
        if algorithm not in allowed:
            raise ValueError(f"unknown algorithm {algorithm!r}; one of "
                             f"{allowed} for mode={mode!r}")
        if mode in ("sequential", "parallel", "dag") and len(hs) != 1:
            raise ValueError(
                f"mode={mode!r} plans one handle, got {len(hs)}")
        if mode == "aligned" and len(hs) != 2:
            raise ValueError(
                f"mode='aligned' is the lockstep pair solver, got "
                f"{len(hs)} handle(s)")
        if algorithm != "auto" or max_states is not None:
            if mode not in ("concurrent", "dag"):
                raise ValueError(
                    "algorithm=/max_states= are knobs of the M-ary "
                    "concurrent search and the DAG route; this plan "
                    f"resolved to mode={mode!r}")
            if mode == "concurrent" and len(hs) == 1:
                raise ValueError(
                    "algorithm=/max_states= route the M >= 2 concurrent "
                    "search; a single-request concurrent plan is a solo "
                    "best-PU walk with nothing to route")
        return self._plan_cached(
            [(reg, 0) for reg in regs], hs, objective, mode,
            algorithm, max_states)

    def _plan_cached(self, regs_progress: list[tuple[_Registration, int]],
                     hs: tuple[int, ...], objective: str, mode: str,
                     algorithm: str = "auto",
                     max_states: int | None = None,
                     horizon_states: int | None = None) -> Plan:
        # the sequential/concurrent solvers consume only the chain + dense
        # cost views (covered by the workload signature); the parallel
        # and DAG solves also consume the graph's edge structure
        # (phases/branches — predecessor sets), so their keys include the
        # structure hash.  algorithm/max_states/horizon_states are in the
        # key: a forced-pairwise plan is never served a cached grid one,
        # nor a full plan a cached horizon window.  The condition stays
        # the LAST element, as in the reference.
        if mode in ("parallel", "dag"):
            wl_key = tuple((reg.sig, reg.struct_sig, prog)
                           for reg, prog in regs_progress)
        else:
            wl_key = tuple((reg.sig, prog) for reg, prog in regs_progress)
        key = (wl_key, objective, mode, algorithm, max_states,
               horizon_states, self._cond_key())
        plan = self._plans.get(key)
        if plan is not None:
            self.stats["hits"] += 1
            self._plans[key] = self._plans.pop(key)   # LRU refresh
            if plan.handles != hs:
                # equal signatures make the *schedule* shareable, but the
                # handles must be the caller's — execute() resolves graphs
                # (and their op payloads) through them
                plan = dataclasses.replace(plan, handles=hs)
            return plan
        self.stats["misses"] += 1
        plan = self._solve(regs_progress, hs, objective, mode,
                           algorithm, max_states, horizon_states)
        plan.cache_key = key
        self._plans[key] = plan
        self._evict_lru(self._plans, self._max_plans, "plan_evictions")
        return plan

    def _pool(self) -> ConcurrentCaches:
        """Objective-independent solver state (pair-cost matrices, group
        edge tables) shared across every concurrent solve under the same
        condition.  ``ConcurrentCaches`` keys everything by content
        signature, so overlapping handle sets, re-admitted models and
        tail re-plans all hit the same tables.  A pool never spans
        conditions: condition-scaled workloads get new signatures, so a
        per-condition pool is re-priced exactly once per change."""
        key = (self._cond_key(),)    # condition last: on_condition reads it
        pool = self._pools.get(key)
        if pool is None:
            pool = ConcurrentCaches()
            self._pools[key] = pool
            self._evict_lru(self._pools, self._max_pools, "pool_evictions")
        else:
            self._pools[key] = self._pools.pop(key)   # LRU refresh
        return pool

    def _warm_solver(self, wls: list[Workload]
                     ) -> IncrementalConcurrentSolver:
        """Memoized warm re-planner for a (full-workload signatures,
        condition) tuple, sharing the per-condition cache pool with the
        cold path — cold solves warm the pool for later warm solves and
        vice versa."""
        key = (tuple(wl.signature() for wl in wls), self._cond_key())
        inc = self._warm.get(key)
        if inc is None:
            inc = IncrementalConcurrentSolver(wls, self.contention,
                                              caches=self._pool())
            self._warm[key] = inc
            self._evict_lru(self._warm, self._max_pools, "warm_evictions")
        else:
            self._warm[key] = self._warm.pop(key)     # LRU refresh
        return inc

    def _solve(self, regs_progress: list[tuple[_Registration, int]],
               hs: tuple[int, ...], objective: str, mode: str,
               algorithm: str = "auto",
               max_states: int | None = None,
               horizon_states: int | None = None) -> Plan:
        nominal = self.condition.nominal
        wls_full = [self._wl(reg) for reg, _ in regs_progress]
        wls = [wl if prog == 0 else wl.tail(prog)
               for wl, (_, prog) in zip(wls_full, regs_progress)]
        if mode == "sequential":
            reg, wl = regs_progress[0][0], wls[0]
            sched = solve_sequential(
                wl.chain, reg.graph.ops, reg.table if nominal else None,
                self.pus, objective, workload=wl)
            return Plan("sequential", sched, objective, hs, mode)
        if mode == "parallel":
            reg, wl = regs_progress[0][0], wls[0]
            sched = solve_parallel(
                reg.graph, reg.table if nominal else None, self.pus,
                self.contention, objective, workload=wl)
            return Plan("parallel", sched, objective, hs, mode)
        if mode == "dag":
            # DAG plans always cover the whole graph (progress tails drop
            # predecessor sets; recovery re-plans from 0 and skips the
            # completed frontier at execution time, like parallel plans)
            reg = regs_progress[0][0]
            sched = solve_dag(
                reg.graph, reg.table if nominal else None, self.pus,
                self.contention, objective, algorithm=algorithm,
                workload=self._dag_wl(reg), caches=self._pool(),
                max_states=max_states)
            return Plan("dag", sched, objective, hs, mode)
        pool = self._pool()
        if mode == "aligned":
            w0, w1 = wls
            cache = _pair_cache(pool, self.contention, wls, 0, 1)
            sched = solve_concurrent_aligned(
                w0.chain, w0.table, w1.chain, w1.table, self.pus,
                self.contention, objective, dense0=w0.dense,
                dense1=w1.dense, cache=cache)
            return Plan("concurrent", sched, objective, hs, mode)
        if algorithm == "auto" and max_states is None:
            # warm fast path: the persistent per-tuple incremental solver
            # (bitwise the cold routes below; None on routes it cannot
            # reproduce bitwise)
            inc = self._warm_solver(wls_full)
            sched = inc.solve([prog for _, prog in regs_progress],
                              objective, horizon_states=horizon_states)
            if sched is not None:
                self.stats["replans_warm"] += 1
                return Plan("concurrent", sched, objective, hs, mode)
        self.stats["replans_cold"] += 1
        if horizon_states is not None:
            sched = solve_concurrent_horizon(
                wls, self.contention, objective, caches=pool,
                horizon_states=horizon_states)
            return Plan("concurrent", sched, objective, hs, mode)
        kw = {} if max_states is None else {"max_states": max_states}
        sched = solve_concurrent(wls, self.contention, objective,
                                 algorithm=algorithm, caches=pool, **kw)
        return Plan("concurrent", sched, objective, hs, mode)

    # -- online admission (the serving scenario) ----------------------------
    def admit(self, h: int, objective: str = "latency",
              horizon_states: int | None = None) -> Plan | None:
        """Admit a registered request into the active concurrent set and
        re-plan the set from every member's current progress — the
        request-arriving-mid-flight case.

        Returns ``None`` — never a ``Plan`` — exactly when no active
        request (the admitted one included) has remaining ops.
        ``horizon_states`` bounds the re-plan to the next exact window
        (see :meth:`replan_active`)."""
        self._reg(h)
        self._active.setdefault(h, 0)
        return self._replan_active(objective, horizon_states)

    def retire(self, h: int, objective: str = "latency",
               horizon_states: int | None = None) -> Plan | None:
        """Remove a request from the active set (completed or cancelled)
        and re-plan the remainder.  Returns ``None`` exactly when there
        is nothing left to schedule: the set emptied, or every remaining
        member is fully advanced.  A handle not in the active set raises
        ``KeyError``."""
        if h not in self._active:
            raise KeyError(f"handle {h} is not in the active set "
                           f"({sorted(self._active)})")
        del self._active[h]
        if not self._active:
            return None
        return self._replan_active(objective, horizon_states)

    def advance(self, h: int, n_ops: int = 1) -> int:
        """Record execution progress (completed op count) for an active
        request; the next re-plan covers only the remaining tail."""
        if h not in self._active:
            raise KeyError(f"handle {h} is not in the active set")
        if n_ops < 0:
            raise ValueError(f"advance: n_ops must be >= 0, got {n_ops}")
        reg = self._regs[h]
        self._active[h] = min(self._active[h] + n_ops, reg.wl.n)
        return self._active[h]

    def replan_active(self, objective: str = "latency",
                      horizon_states: int | None = None) -> Plan | None:
        """Re-plan the active concurrent set from every member's current
        progress without changing membership, warm whenever possible
        (``stats["replans_warm"]``).  With ``horizon_states`` the plan
        covers only the next exact window of ``<= horizon_states`` grid
        states (``schedule.mode == "horizon"``), and the caller re-plans
        again at the window frontier.  Returns ``None`` exactly when no
        active request has remaining ops."""
        return self._replan_active(objective, horizon_states)

    def _replan_active(self, objective: str,
                       horizon_states: int | None = None) -> Plan | None:
        items = [(h, p) for h, p in sorted(self._active.items())
                 if p < self._regs[h].wl.n]
        if not items:
            return None
        regs_progress = [(self._regs[h], p) for h, p in items]
        return self._plan_cached(regs_progress, tuple(h for h, _ in items),
                                 objective, "concurrent",
                                 horizon_states=horizon_states)

    # -- execute ------------------------------------------------------------
    def execute(self, plan: Plan, inputs=None, *, compile: bool = True,
                policy: ExecutionPolicy | None = None,
                faults: FaultPlan | None = None,
                recover: bool = True,
                trace: list | None = None) -> Any:
        """Run a plan on the multi-lane executor.

        Sequential, parallel and DAG plans take one ``{op: (args...)}``
        mapping and return that graph's results dict; concurrent plans
        take a sequence of such mappings (one per request, in handle
        order) and return a list of results dicts.

        By default execution goes through the compiled, cached lane
        program (:meth:`program_for`); ``compile=False`` runs the per-op
        interpreter, the bitwise oracle.  ``trace`` (compiled path)
        receives one :class:`~repro_torch.core.laneprogram.SegmentTime`
        per segment.  ``policy`` tunes the watchdog/retry knobs and
        ``faults`` injects a scripted
        :class:`~repro_torch.core.faults.FaultPlan`, as in the reference.

        With ``recover=True`` (the default) a permanent mid-run PU loss
        is handled here: the loss is folded into the session condition
        (:meth:`on_condition` — invalidating stale cached plans), the ops
        missing from the frontier are re-planned onto the surviving PUs,
        and execution resumes on the interpreter seeded with the
        completed results, which are reused as they are.  The frontier of
        a compiled run is per segment: a loss inside a segment loses the
        whole segment's ops.  ``recover=False`` propagates the
        :class:`~repro_torch.core.errors.PULostError` (frontier attached
        as ``err.partial``) to the caller.
        """
        try:
            return self._execute_once(plan, inputs, compile, policy, faults,
                                      trace)
        except PULostError as err:
            if not recover:
                raise
            return self._recover(plan, inputs, err, policy, faults)

    def _execute_once(self, plan: Plan, inputs, compile: bool,
                      policy: ExecutionPolicy | None,
                      faults: FaultPlan | None, trace: list | None) -> Any:
        if not compile:
            regs = self._execute_regs(plan)
            graphs = [reg.graph for reg in regs]
            if plan.kind == "dag":
                return self.executor.run_dag(
                    graphs[0], plan.schedule, inputs,
                    policy=policy, faults=faults, estimate=plan.latency)
            if plan.kind in ("sequential", "parallel"):
                return self.executor.run_scheduled(
                    graphs[0], plan.schedule, inputs,
                    policy=policy, faults=faults, estimate=plan.latency)
            return self.executor.run_concurrent(
                graphs, plan.schedule, inputs,
                policy=policy, faults=faults, estimate=plan.latency)
        return self.program_for(plan, inputs).run(
            inputs, policy=policy, faults=faults, estimate=plan.latency,
            trace=trace)

    # -- mid-run recovery ---------------------------------------------------
    @staticmethod
    def _chain_progress(chain: Sequence[int],
                        done: Mapping[int, Any]) -> int:
        """Completed-prefix length of a chain under a frontier (results
        record in chain order, so the frontier is always a prefix)."""
        k = 0
        while k < len(chain) and chain[k] in done:
            k += 1
        return k

    def _recover(self, plan: Plan, inputs, err: PULostError,
                 policy: ExecutionPolicy | None,
                 faults: FaultPlan | None) -> Any:
        """Re-plan-and-resume after a permanent mid-run PU loss.

        Folds each lost PU into the session :class:`RuntimeCondition`
        (``on_condition`` invalidates cached plans priced with it and
        re-stitches active trackers), re-plans the ops still missing
        from the frontier onto the surviving PUs, and resumes on the
        interpreter path seeded with the completed results.  Loops if
        another PU dies during the resume; raises
        :class:`~repro_torch.core.errors.InfeasibleScheduleError` when no
        surviving PU can run a remaining op, and re-raises the loss when
        it carries no usable PU identity.
        """
        m = len(plan.handles)
        partials: list[dict[int, Any]] = [{} for _ in range(m)]
        lost_seen: set[str] = set()
        while True:
            if err.pu is None or err.pu in lost_seen:
                raise err   # no identity to exclude / no progress possible
            lost_seen.add(err.pu)
            for d, p in zip(partials, err.partial or []):
                d.update(p)
            self.on_condition(self.condition.lose(err.pu))
            self.stats["recoveries"] += 1
            try:
                return self._resume(plan, inputs, partials, policy, faults)
            except PULostError as e2:
                err = e2

    def _resume(self, plan: Plan, inputs,
                partials: list[dict[int, Any]],
                policy: ExecutionPolicy | None,
                faults: FaultPlan | None) -> Any:
        """Re-plan the non-frontier ops under the current (degraded)
        condition and run them on the interpreter path, seeded with the
        frontier results."""
        regs = self._execute_regs(plan)
        graphs = [reg.graph for reg in regs]
        objective = plan.objective

        if plan.kind == "parallel":
            # branch/phase structure is condition-independent: re-plan the
            # whole DAG under the degraded condition; the frontier seed
            # skips every already-completed op at execution time
            sub = self._plan_cached([(regs[0], 0)], plan.handles, objective,
                                    "parallel")
            return self.executor.run_scheduled(
                graphs[0], sub.schedule, inputs, policy=policy,
                faults=faults, completed=partials[0],
                estimate=sub.latency)

        if plan.kind == "dag":
            # same shape as parallel: precedence structure survives the
            # condition change, so re-plan the whole DAG onto the
            # surviving PUs and let the lane queues skip the frontier
            sub = self._plan_cached([(regs[0], 0)], plan.handles, objective,
                                    "dag")
            return self.executor.run_dag(
                graphs[0], sub.schedule, inputs, policy=policy,
                faults=faults, completed=partials[0],
                estimate=sub.latency)

        if plan.kind == "sequential":
            done = partials[0]
            prog = self._chain_progress(regs[0].chain, done)
            if prog == len(regs[0].chain):
                return dict(done)          # the loss hit after the last op
            sub = self._plan_cached([(regs[0], prog)], plan.handles,
                                    objective, "sequential")
            amap = dict(zip(sub.schedule.chain, sub.schedule.assignment))
            return self.executor.run_scheduled(
                graphs[0], amap, inputs, policy=policy, faults=faults,
                completed=done, estimate=sub.latency)

        # concurrent: re-plan only the requests with remaining ops, then
        # widen the sub-schedule back to all M request slots
        items = [(r, reg, self._chain_progress(reg.chain, partials[r]))
                 for r, reg in enumerate(regs)]
        remaining = [(r, reg, prog) for r, reg, prog in items
                     if prog < len(reg.chain)]
        if not remaining:
            return [dict(d) for d in partials]
        sub = self._plan_cached(
            [(reg, prog) for _, reg, prog in remaining],
            tuple(plan.handles[r] for r, _, _ in remaining),
            objective, "concurrent")
        slot = {k: r for k, (r, _, _) in enumerate(remaining)}

        def widen(vals: tuple) -> tuple:
            out: list = [None] * len(regs)
            for k, v in enumerate(vals):
                out[slot[k]] = v
            return tuple(out)

        ssched = sub.schedule
        full = ConcurrentSchedule(
            steps=[ConcurrentStep(ops=widen(st.ops), pus=widen(st.pus),
                                  cost=st.cost) for st in ssched.steps],
            latency=ssched.latency, energy=ssched.energy,
            objective=ssched.objective, mode=ssched.mode)
        return self.executor.run_concurrent(
            graphs, full, inputs, policy=policy, faults=faults,
            completed=partials, estimate=full.latency)

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
            self._programs.pop(key).close()
        self.stats["program_misses"] += 1
        regs = self._execute_regs(plan)
        graphs = [reg.graph for reg in regs]
        if plan.kind == "dag":
            prog = self.executor.compile_dag(graphs[0], plan.schedule)
        elif plan.kind in ("sequential", "parallel"):
            prog = self.executor.compile_scheduled(graphs[0], plan.schedule)
        else:
            prog = self.executor.compile_concurrent(graphs, plan.schedule)
        self._programs[key] = prog
        self._evict_lru(self._programs, self._max_programs,
                        "program_evictions", close=True)
        return prog

    def _execute_regs(self, plan: Plan) -> list[_Registration]:
        if not plan.handles:
            raise ValueError("plan carries no handles; was it built by "
                             "this orchestrator (or restored from JSON "
                             "with handles intact)?")
        regs = [self._reg(h) for h in plan.handles]
        # a stale/re-registered plan must fail here with the handle named,
        # not deep inside lane-queue construction
        routes = plan.route
        if len(routes) != len(regs):
            raise ValueError(
                f"plan routes {len(routes)} request(s) but carries "
                f"{len(regs)} handle(s) {plan.handles} — the plan does not "
                "match this orchestrator's registrations")
        for reg, route in zip(regs, routes):
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
