"""Search engine (Algorithm 1, Stage 3): the sequential, parallel, DAG
and concurrent solvers, and the serving-time re-planners.

A copy of ``repro.core.search``: the reference's code as it stands, so
every route gives bitwise the reference's schedules, latencies, energies
and error messages:

* ``dijkstra`` — textbook Dijkstra over the explicit execution graph
  (node-weighted; node weights folded into incoming edges).
* ``sequential_dp`` — the O(N K^2) topological-order recurrence (Eq. 1),
  vectorized to one NumPy matrix op per chain position over the dense
  ``(K, K)`` transition matrix (``graph.DenseChain``).  The scalar
  reference (``sequential_dp_reference``) is kept; tests assert both give
  bit-identical costs and assignments, and both equal ``dijkstra``.
* ``solve_parallel`` — phase/branch partitioning + per-branch search +
  contention-adjusted makespans (§3.3.2); the contention re-walk is a
  gathered-array computation instead of a per-op Python loop.
* ``solve_dag`` — the unified front door over op DAGs: antichain-frontier
  scheduling whose state is an order ideal of DAG nodes.  Linear chains
  dispatch to the chain DP, disjoint unions of chains to the exact grid
  sweep, and fork/join shapes to ``solve_parallel`` — each bit-for-bit —
  while ``algorithm="frontier"`` runs the exact DP over order ideals
  (``_solve_dag_frontier``), co-scheduled antichain steps priced by the
  same solo edges / group-law tables as the grid sweep.
* ``solve_concurrent_aligned`` / ``solve_concurrent_joint`` — the two
  pair modes (§3.2.2 / §3.3.3).  The joint solver is A* over the
  (i, j) progress grid: edge costs come from memoized ``(K0, K1)``
  pair-cost matrices (``contention.PairCostCache``) reduced to one
  min-edge per transition, and the admissible heuristic is the exact
  cost-to-go computed by a vectorized backward DP over the grid
  (``_cost_to_go``).  Scalar reference implementations (``*_reference``)
  are retained and used automatically for ``ContentionModel`` subclasses
  that override the co-execution cost laws.
* ``solve_concurrent`` — the M-request generalization over ``Workload``
  views: M = 2 dispatches to the pair A* bit-for-bit; M-dimensional
  progress grids up to ``max_states`` are searched exactly by a
  vectorized anti-diagonal sweep (``_solve_concurrent_grid``; the
  retained heap A*, ``algorithm="grid_astar"``, is its equivalence
  oracle), larger grids stitch a rolling-horizon merge
  (``_solve_concurrent_rolling``), and custom contention laws take the
  pairwise-merge fallback (``_solve_concurrent_pairwise``).
* ``solve_concurrent_horizon`` — the exact bounded-lookahead window of a
  concurrent schedule (the serving loop's bounded-latency re-plan), and
  ``IncrementalConcurrentSolver`` — the warm re-planner of a fixed
  workload tuple, whose schedules from any progress are bitwise the cold
  ``solve_concurrent`` / ``solve_concurrent_horizon`` ones on the tails.
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import Mapping, Sequence

import numpy as np

from .contention import (ContentionModel, GroupCostCache, PairCostCache,
                         uses_default_coexec, uses_default_group)
from .costmodel import CostTable, DenseCostTable, PUSpec, transition_cost
from .errors import InfeasibleScheduleError
from .graph import (ExecGraph, build_dense_chain, build_sequential_graph,
                    node_weight)
from .op import FusedOp, OpGraph
from .schedule import (BranchSchedule, ConcurrentSchedule, ConcurrentStep,
                       DagSchedule, DagStep, ParallelSchedule, PhaseSchedule,
                       SeqSchedule)
from .workload import Workload

# ---------------------------------------------------------------------------
# Shortest path on the explicit graph
# ---------------------------------------------------------------------------


def dijkstra(g: ExecGraph) -> tuple[float, list[str]]:
    """Shortest s->t path; returns (cost, PU assignment per chain position)."""
    INF = float("inf")
    dist: dict[int, float] = {g.S: 0.0}
    prev: dict[int, int] = {}
    heap: list[tuple[float, int]] = [(0.0, g.S)]
    done: set[int] = set()
    while heap:
        d, u = heapq.heappop(heap)
        if u in done:
            continue
        done.add(u)
        if u == g.T:
            break
        for v, ew in g.adj.get(u, ()):  # edge weight + node weight of v
            nd = d + ew + g.node_w.get(v, 0.0)
            if nd < dist.get(v, INF):
                dist[v] = nd
                prev[v] = u
                heapq.heappush(heap, (nd, v))
    if g.T not in dist:
        raise ValueError("no feasible path (some op unsupported everywhere?)")
    # reconstruct
    rev_ids = {v: k for k, v in g.node_ids.items()}
    path: list[str] = []
    cur = g.T
    while cur != g.S:
        cur = prev[cur]
        if cur in rev_ids:
            path.append(rev_ids[cur][1])
    path.reverse()
    return dist[g.T], path


# ---------------------------------------------------------------------------
# Sequential DP (Eq. 1) — vectorized + scalar reference
# ---------------------------------------------------------------------------


def sequential_dp(
    chain: Sequence[int],
    ops: Sequence[FusedOp],
    table: CostTable,
    pus: Mapping[str, PUSpec],
    objective: str = "latency",
    dense: DenseCostTable | None = None,
) -> tuple[float, list[str]]:
    """Eq. (1) dynamic program over the dense chain's batched transition
    tensor: all ``(K, K)`` transition matrices and node weights are built
    in one vectorized shot, then the recurrence runs one matrix op per
    chain position (for small K — the edge SoC's 3 PUs — the per-position
    minimisation runs as a tight loop over the precomputed arrays
    instead, since NumPy's per-call overhead exceeds the K^2 arithmetic).

    Bit-identical to ``sequential_dp_reference`` (same additions in the
    same order, same first-minimum tie-break) and the same optimum as
    ``dijkstra``.
    """
    dc = build_dense_chain(chain, ops, table, pus, objective, dense=dense)
    n = len(chain)
    k = dc.dense.k
    pu_names = dc.dense.pus
    if k >= 8:
        cost = dc.entry_w + dc.node_w[0]             # (K,)
        trans = dc.transitions()
        back = np.empty((n - 1, k), dtype=np.int64) if n > 1 else None
        for pos in range(1, n):
            m = cost[:, None] + trans[pos - 1]       # (K, K): prev k -> next j
            back[pos - 1] = np.argmin(m, axis=0)     # first minimum, PU order
            cost = dc.node_w[pos] + np.min(m, axis=0)
        total = cost + dc.exit_w
        bp = int(np.argmin(total))
        best = float(total[bp])
        if not np.isfinite(best):
            raise ValueError(
                "no feasible path (some op unsupported everywhere?)")
        idxs = [bp]
        for pos in range(n - 1, 0, -1):
            bp = int(back[pos - 1][bp])
            idxs.append(bp)
        idxs.reverse()
        return best, [pu_names[i] for i in idxs]
    # small-K path: same recurrence over the same batched arrays
    INF = float("inf")
    trans = dc.transitions().tolist()
    nws = dc.node_w.tolist()
    cost = (dc.entry_w + dc.node_w[0]).tolist()
    rng = range(k)
    back: list[list[int]] = []
    for pos in range(1, n):
        t = trans[pos - 1]
        nw = nws[pos]
        ncost = [0.0] * k
        nback = [0] * k
        for j in rng:
            best, barg = INF, 0
            for kk in rng:
                c = cost[kk] + t[kk][j]
                if c < best:
                    best, barg = c, kk
            ncost[j] = nw[j] + best
            nback[j] = barg
        cost = ncost
        back.append(nback)
    exit_w = dc.exit_w.tolist()
    best, bp = INF, 0
    for j in rng:
        c = cost[j] + exit_w[j]
        if c < best:
            best, bp = c, j
    if best == INF:
        raise ValueError("no feasible path (some op unsupported everywhere?)")
    idxs = [bp]
    for pos in range(n - 1, 0, -1):
        bp = back[pos - 1][bp]
        idxs.append(bp)
    idxs.reverse()
    return best, [pu_names[i] for i in idxs]


def sequential_dp_reference(
    chain: Sequence[int],
    ops: Sequence[FusedOp],
    table: CostTable,
    pus: Mapping[str, PUSpec],
    objective: str = "latency",
) -> tuple[float, list[str]]:
    """Scalar Eq. (1) recurrence (pre-vectorization reference)."""
    INF = float("inf")

    def escale(pu: str) -> float:
        return pus[pu].power_memory if objective == "energy" else 1.0

    sup = [table.supported_pus(oi) for oi in chain]
    # base case: cost(1, j) = H2D(O_1, P_j) + w(v_1j)
    cost = {p: table.require(chain[0], p).h2d * escale(p)
            + node_weight(table.require(chain[0], p), objective)
            for p in sup[0]}
    back: list[dict[str, str]] = []
    for pos in range(1, len(chain)):
        oi_prev, oi = chain[pos - 1], chain[pos]
        ncost: dict[str, float] = {}
        nback: dict[str, str] = {}
        for pj in sup[pos]:
            w = node_weight(table.require(oi, pj), objective)
            best, barg = INF, None
            for pk in sup[pos - 1]:
                tc = transition_cost(pus, table, oi_prev, pk, oi, pj) * escale(pj)
                c = cost[pk] + tc
                if c < best:
                    best, barg = c, pk
            ncost[pj] = w + best
            nback[pj] = barg
        cost = ncost
        back.append(nback)
    # final D2H
    lastpos = len(chain) - 1
    best, bp = INF, None
    for p in sup[lastpos]:
        c = cost[p] + table.require(chain[lastpos], p).d2h * escale(p)
        if c < best:
            best, bp = c, p
    # backtrack
    assign = [bp]
    for pos in range(len(chain) - 1, 0, -1):
        bp = back[pos - 1][bp]
        assign.append(bp)
    assign.reverse()
    return best, assign


def solve_sequential(
    chain: Sequence[int],
    ops: Sequence[FusedOp],
    table: CostTable | None,
    pus: Mapping[str, PUSpec],
    objective: str = "latency",
    algorithm: str = "dp",
    workload: Workload | None = None,
) -> SeqSchedule:
    """Sequential solve on the dense ``Workload`` layer.

    Pass ``workload`` to reuse a prebuilt dense view (``table`` may then
    be ``None``); otherwise the scalar table is ingested once here.  The
    ``dijkstra`` / ``dp_reference`` algorithms are the explicit-graph /
    scalar oracles and still walk the dict table.
    """
    wl = workload if workload is not None else Workload.build(
        chain, table, pus, ops=ops)
    oracle_table = table if table is not None else wl.table
    if algorithm in ("dijkstra", "dp_reference") and oracle_table is None:
        raise ValueError(
            f"algorithm={algorithm!r} walks the scalar oracle table, but "
            "none is available (the workload is a derived dense view); "
            "pass the table or use algorithm='dp'")
    if algorithm == "dijkstra":
        g = build_sequential_graph(chain, ops, oracle_table, pus, objective)
        _, assign = dijkstra(g)
    elif algorithm == "dp":
        _, assign = sequential_dp(chain, ops, table, pus, objective,
                                  dense=wl.dense)
    elif algorithm == "dp_reference":
        _, assign = sequential_dp_reference(chain, ops, oracle_table, pus,
                                            objective)
    else:
        raise ValueError(algorithm)
    lat, eng = wl.evaluate(assign)
    return SeqSchedule(chain=list(chain), assignment=assign, latency=lat,
                       energy=eng, objective=objective)


# ---------------------------------------------------------------------------
# Intra-model parallel search (§3.3.2)
# ---------------------------------------------------------------------------


def _rewalk_branch(
    wl: Workload, assign: Sequence[str], contention: ContentionModel,
    others: set[str],
) -> tuple[float, float]:
    """Contention-adjusted (latency, energy) of a fixed branch assignment:
    every op cost scaled by the max SF vs the PU set used by the *other*
    branches; transitions unscaled.  One gather over the branch
    workload's dense rows — O(branch length), not O(model size)."""
    d = wl.dense
    c = wl.cols(assign)
    rows = np.arange(d.n)
    wv = d.w[rows, c]
    pv = d.power[rows, c]
    h2dv = d.h2d[rows, c]
    d2hv = d.d2h[rows, c]
    accv = d.acc[c]
    sf_of = {p: contention.branch_factor(p, others) for p in set(assign)}
    sfv = np.array([sf_of[p] for p in assign])
    pmv = wl.power_memory[c]
    # inter-op transitions (same PU -> 0; accelerator-gated H2D/D2H)
    same = c[1:] == c[:-1]
    tcv = np.where(same, 0.0,
                   np.where(accv[1:], h2dv[1:], 0.0)
                   + np.where(accv[:-1], d2hv[:-1], 0.0))
    lat = float(h2dv[0] + np.sum(wv * sfv) + np.sum(tcv) + d2hv[-1])
    eng = float(h2dv[0] * pmv[0] + np.sum(wv * sfv * pv)
                + np.sum(tcv * pmv[1:]) + d2hv[-1] * pmv[-1])
    return lat, eng


def solve_parallel(
    graph: OpGraph,
    table: CostTable | None,
    pus: Mapping[str, PUSpec],
    contention: ContentionModel | None = None,
    objective: str = "latency",
    workload: Workload | None = None,
) -> ParallelSchedule:
    """Phase partition -> per-branch search -> contention-adjusted makespan.

    Per phase we also evaluate serialising all branches on the per-branch
    optimal assignments and keep whichever is cheaper, so parallel
    orchestration never regresses below the sequential schedule (paper
    Table 3 reports parallel speedup >= sequential speedup everywhere).

    The whole graph is ingested into one ``Workload``; per-branch views
    are row-selections of it (no dict walks per branch).
    """
    contention = contention or ContentionModel()
    wl_full = workload if workload is not None else Workload.build(
        list(range(len(graph.ops))), table, pus, ops=graph.ops)
    phases_out: list[PhaseSchedule] = []
    total_lat = 0.0
    total_eng = 0.0
    for phase in graph.phases():
        brs: list[BranchSchedule] = []
        br_wls: list[Workload] = []
        for br in phase.branches:
            bwl = wl_full.select(br.ops)
            s = solve_sequential(br.ops, graph.ops, table, pus, objective,
                                 workload=bwl)
            br_wls.append(bwl)
            brs.append(BranchSchedule(
                branch_ops=list(br.ops), assignment=s.assignment,
                solo_latency=s.latency, adj_latency=s.latency, energy=s.energy))
        if len(brs) > 1:
            pu_sets = [set(b.assignment) for b in brs]
            for bi, b in enumerate(brs):
                others: set[str] = set().union(
                    *(pu_sets[j] for j in range(len(brs)) if j != bi))
                b.adj_latency, b.energy = _rewalk_branch(
                    br_wls[bi], b.assignment, contention, others)
            par_makespan = max(b.adj_latency for b in brs)
            par_energy = sum(b.energy for b in brs)
            seq_makespan = sum(b.solo_latency for b in brs)
            # serialised energy: recompute without SF (solo energies)
            seq_energy = 0.0
            for bwl, b in zip(br_wls, brs):
                _, e = bwl.evaluate(b.assignment)
                seq_energy += e
            key_par = par_makespan if objective == "latency" else par_energy
            key_seq = seq_makespan if objective == "latency" else seq_energy
            if key_par <= key_seq:
                phases_out.append(PhaseSchedule(
                    index=phase.index, parallel=True, branches=brs,
                    makespan=par_makespan, energy=par_energy))
                total_lat += par_makespan
                total_eng += par_energy
            else:
                for b in brs:  # revert adjustment bookkeeping
                    b.adj_latency = b.solo_latency
                phases_out.append(PhaseSchedule(
                    index=phase.index, parallel=False, branches=brs,
                    makespan=seq_makespan, energy=seq_energy))
                total_lat += seq_makespan
                total_eng += seq_energy
        else:
            b = brs[0]
            phases_out.append(PhaseSchedule(
                index=phase.index, parallel=False, branches=brs,
                makespan=b.solo_latency, energy=b.energy))
            total_lat += b.solo_latency
            total_eng += b.energy
    return ParallelSchedule(phases=phases_out, latency=total_lat,
                            energy=total_eng, objective=objective)


# ---------------------------------------------------------------------------
# DAG (antichain-frontier) search — chains and branches unified
# ---------------------------------------------------------------------------


DAG_ALGORITHMS = ("auto", "chain", "union-grid", "phase", "frontier")

# A frontier advance co-schedules at most this many ready ops per step:
# one op per PU of the paper's edge SoC.  Larger antichains still
# execute (across consecutive steps); the cap bounds the per-ideal
# subset fan-out and the group-edge table size (``n_sig ** k`` cells).
_DAG_GROUP_CAP = 3


def _seq_to_dag(wl: Workload, s: SeqSchedule) -> DagSchedule:
    """Chain-route conversion: one singleton step per position.

    Step costs carry the exact sequential decomposition (boundary H2D on
    the first step, incoming transition per step, boundary D2H on the
    last), but ``latency``/``energy`` are the authoritative
    ``SeqSchedule`` values (bitwise the chain DP's)."""
    d = wl.dense
    c = wl.cols(s.assignment)
    rows = np.arange(d.n)
    cost = d.w[rows, c]            # fancy indexing: already a fresh array
    if cost.dtype != np.float64:
        cost = cost.astype(float)
    h2d = d.h2d[rows, c]
    d2h = d.d2h[rows, c]
    accv = d.acc[c]
    cost[0] += h2d[0]
    cost[-1] += d2h[-1]
    if d.n > 1:
        same = c[1:] == c[:-1]
        cost[1:] += np.where(same, 0.0,
                             np.where(accv[1:], h2d[1:], 0.0)
                             + np.where(accv[:-1], d2h[:-1], 0.0))
    pu_t = {p: (p,) for p in set(s.assignment)}   # few PUs, many steps
    steps = list(map(DagStep, zip(s.chain),      # zip -> the (op,) tuples
                     map(pu_t.__getitem__, s.assignment), cost.tolist()))
    return DagSchedule(steps=steps, latency=s.latency, energy=s.energy,
                       objective=s.objective, mode="chain")


def _concurrent_to_dag(cs: ConcurrentSchedule, mode: str) -> DagSchedule:
    """Union-of-chains conversion: drop the per-request ``None`` padding
    (each non-idle (op, pu) pair carries over in request order)."""
    steps = [DagStep(
        ops=tuple(o for o in st.ops if o is not None),
        pus=tuple(p for p in st.pus if p is not None),
        cost=st.cost) for st in cs.steps]
    return DagSchedule(steps=steps, latency=cs.latency, energy=cs.energy,
                       objective=cs.objective, mode=mode)


def _parallel_to_dag(par: ParallelSchedule) -> DagSchedule:
    """Phase-route conversion: one step per fork/join phase (a
    precedence-closed unit — ops listed branch-by-branch in branch
    order, *not* an antichain), cost = the phase makespan.  Latency,
    energy, and the per-op assignment are bitwise ``solve_parallel``'s.
    """
    steps = []
    for ph in par.phases:
        ops = tuple(o for b in ph.branches for o in b.branch_ops)
        pus_ = tuple(p for b in ph.branches for p in b.assignment)
        steps.append(DagStep(ops=ops, pus=pus_, cost=float(ph.makespan)))
    return DagSchedule(steps=steps, latency=par.latency, energy=par.energy,
                       objective=par.objective, mode="phase")


def solve_dag(
    graph: OpGraph,
    table: CostTable | None,
    pus: Mapping[str, PUSpec],
    contention: ContentionModel | None = None,
    objective: str = "latency",
    algorithm: str = "auto",
    workload: Workload | None = None,
    caches: ConcurrentCaches | None = None,
    max_states: int | None = None,
    group_cap: int = _DAG_GROUP_CAP,
) -> DagSchedule:
    """Schedule an op DAG as antichain-frontier advances — the front door
    that unifies the chain, branch, and general-DAG shapes.

    Routes (``algorithm="auto"`` picks the first match; each named route
    can be forced):

    * ``"chain"`` — a single linear chain: dispatches to the sequential
      chain DP **bit-for-bit** (full sequential cost semantics: boundary
      H2D/D2H and inter-op transitions included).
    * ``"union-grid"`` — a disjoint union of linear chains: dispatches
      each component to one axis of the exact anti-diagonal grid sweep
      **bit-for-bit** (the concurrent formulation: node weights only,
      group advances priced by the contention model's group laws).
    * ``"phase"`` — anything else: dispatches to the retained
      fork/join branch route (``solve_parallel``) **bit-for-bit** (the
      old branch re-walk, demoted to oracle duty).
    * ``"frontier"`` — the generalization (never auto-selected, so the
      oracle-reproducing routes above stay bitwise): exact DP over the
      DAG's order ideals, each step advancing an antichain of ready
      nodes, priced exactly like the grid sweep (solo edges for
      singletons, :class:`~repro_torch.core.contention.GroupCostCache` group
      laws for co-scheduled sets).  On a union of chains the ideal
      lattice *is* the progress grid, so this reduces to today's sweep;
      on a general DAG it finds step-level co-schedules the phase route
      cannot (ops of different fork/join phases overlapping), which is
      the paper's intra-model-parallelism win.

    Pass ``workload`` (a DAG workload from :meth:`Workload.from_graph`,
    possibly ``under_condition``-adjusted) to reuse a prebuilt dense
    view; ``table`` may then be ``None``.  ``max_states`` bounds the
    frontier route's discovered order ideals (and the union route's
    grid) — a memory bound, as for ``solve_concurrent``.
    """
    contention = contention or ContentionModel()
    if algorithm not in DAG_ALGORITHMS:
        raise ValueError(algorithm)
    n_ops = len(graph.ops)
    if workload is not None and (
            len(workload.chain) != n_ops
            or sorted(workload.chain) != list(range(n_ops))):
        raise ValueError(
            f"solve_dag: the workload's rows ({len(workload.chain)} ops) "
            f"do not cover the graph's {n_ops} ops exactly — build it "
            "with Workload.from_graph(graph, table, pus)")

    def need_wl(preds: bool) -> Workload:
        # the chain/union/phase oracles never read predecessor sets, so
        # only the frontier route pays for ``from_graph`` — this keeps
        # the dispatch overhead on linear DAGs at the plain-build cost
        if workload is not None:
            return workload
        if preds:
            return Workload.from_graph(graph, table, pus)
        return Workload.build(graph.topo_order(), table, pus, ops=graph.ops)

    all_chains = graph.is_chain()   # degrees <= 1: chain(s), possibly many
    # for a degree-<=1 graph every edge merges two components, so the
    # component count is n - #edges — no union-find needed to route
    n_comps = n_ops - graph.n_edges if all_chains else None
    comps: list[list[int]] | None = None
    if all_chains and n_comps > 1:
        comps = graph.components()
    if algorithm == "auto":
        if all_chains and n_comps == 1:
            algorithm = "chain"
        elif (all_chains and uses_default_group(contention)
              and math.prod(len(c) + 1 for c in comps)
              <= (max_states if max_states is not None
                  else DEFAULT_MAX_STATES)):
            algorithm = "union-grid"
        else:
            algorithm = "phase"
    if algorithm == "chain":
        if not (all_chains and n_comps == 1):
            raise ValueError(
                "algorithm='chain' requires a single linear chain; this "
                f"graph has {len(graph.components())} component(s) and "
                f"{'only chain' if all_chains else 'fork/join'} structure "
                "— use 'auto', 'phase', or 'frontier'")
        wl = need_wl(preds=False)
        s = solve_sequential(wl.chain, graph.ops, table, pus, objective,
                             workload=wl)
        return _seq_to_dag(wl, s)
    if algorithm == "union-grid":
        if not all_chains:
            raise ValueError(
                "algorithm='union-grid' requires a disjoint union of "
                "linear chains (no forks/joins) — use 'auto', 'phase', "
                "or 'frontier'")
        if not uses_default_group(contention):
            raise ValueError(
                "algorithm='union-grid' dispatches to the exact grid "
                "sweep, which requires the default group co-execution "
                f"laws; {type(contention).__name__} overrides them — use "
                "'auto' or 'phase'")
        if comps is None:
            comps = graph.components()
        wl = need_wl(preds=False)
        comp_wls = [wl.select(c) for c in comps]
        cs = _solve_concurrent_grid(comp_wls, contention, objective, caches)
        return _concurrent_to_dag(cs, "union-grid")
    if algorithm == "phase":
        par = solve_parallel(graph, table, pus, contention, objective,
                             workload=need_wl(preds=False))
        return _parallel_to_dag(par)
    wl = need_wl(preds=True)
    if wl.preds is None and not (all_chains and n_comps == 1):
        raise ValueError(
            "algorithm='frontier' on a non-chain graph needs a DAG "
            "workload carrying predecessor sets — build it with "
            "Workload.from_graph(graph, table, pus) (a preds-free "
            "workload would be scheduled under linear-chain precedence)")
    return _solve_dag_frontier(wl, contention, objective,
                               caches=caches, max_states=max_states,
                               group_cap=group_cap)


def _dag_infeasible(wl: Workload, pos: int) -> InfeasibleScheduleError:
    """DAG-route infeasibility: name the node and its predecessor
    context (a request-index/chain-position message is meaningless for
    DAG nodes)."""
    preds = wl.pred_positions(pos)
    pstr = (", ".join(wl.op_name(q) for q in preds) if preds
            else "none (a source node)")
    return InfeasibleScheduleError(
        f"DAG node {wl.op_name(pos)} (topological position {pos}; "
        f"predecessors: {pstr}) is unsupported on every PU — no frontier "
        "advance can ever schedule it, so the DAG cannot complete")


def _solve_dag_frontier(
    wl: Workload, cm: ContentionModel, objective: str,
    caches: ConcurrentCaches | None = None,
    max_states: int | None = None,
    group_cap: int = _DAG_GROUP_CAP,
) -> DagSchedule:
    """Exact DP over the DAG's order ideals (downward-closed node sets).

    State = the completed ideal as a bitmask over topological positions;
    the *frontier* of an ideal is its antichain of ready positions (all
    predecessors inside).  A transition advances any non-empty ready
    subset of size ``<= group_cap``: singletons are priced from the
    dense solo edges, larger sets from the contention model's group law
    via a :class:`~repro_torch.core.contention.GroupCostCache` over ``k``
    copies of this workload's dense table (memoized per ``k`` — and per
    content signature when a :class:`ConcurrentCaches` pool is passed,
    where it is shared with any grid solve over content-identical
    workloads).  Every transition strictly grows the ideal, so ideals
    are relaxed exactly, grouped by popcount (the anti-diagonal order);
    ties resolve to the first strict improvement in (ideal, subset-size,
    position-lexicographic) order — deterministic.  On a union of
    chains, ideals are exactly the progress-grid states and the
    transitions the grid's advance subsets, so this reduces to today's
    sweep.
    """
    if not uses_default_group(cm):
        raise ValueError(
            "the frontier route prices co-scheduled antichains with the "
            "default group co-execution laws via GroupCostCache; "
            f"{type(cm).__name__} overrides them — use algorithm='phase'")
    n = wl.n
    if n > 63:
        raise ValueError(
            f"the frontier route's ideal bitmasks cover at most 63 nodes "
            f"(graph has {n}) — use algorithm='phase'")
    if max_states is None:
        max_states = DEFAULT_MAX_STATES
    d = wl.dense
    skey, sarg, sw, se = _solo_edges(d, objective)
    bad = ~np.isfinite(np.asarray(skey))
    if bad.any():
        raise _dag_infeasible(wl, int(np.argmax(bad)))
    pred_mask = [0] * n
    for i in range(n):
        for q in wl.pred_positions(i):
            pred_mask[i] |= 1 << q
    sig = d.sig
    # adaptive group cap: a near-unique-signature profile would make the
    # k-ary edge table (n_sig ** k cells) dwarf the search — shrink k
    # until the table fits the rolling-route cap
    cap = max(1, group_cap)
    while cap > 1 and d.n_sig ** cap > _ROLLING_TABLE_CAP:
        cap -= 1

    group_tabs: dict[int, tuple] = {}

    def tables(k: int) -> tuple:
        tabs = group_tabs.get(k)
        if tabs is None:
            if caches is not None:
                key = (wl.signature(),) * k
                gc = caches.group_tables.get(key)
                created = gc is None
                if created:
                    gc = GroupCostCache(cm, [d] * k)
                    caches.group_tables[key] = gc
                else:
                    caches.group_tables[key] = caches.group_tables.pop(key)
                tabs = gc.edge_tables(objective)
                if created:
                    caches.trim()
            else:
                tabs = GroupCostCache(cm, [d] * k).edge_tables(objective)
            group_tabs[k] = tabs
        return tabs

    full = (1 << n) - 1
    INF = float("inf")
    dist: dict[int, float] = {0: 0.0}
    # act[ideal] = (prev ideal, ops positions, pus, step cost, step energy)
    act: dict[int, tuple] = {}
    levels: list[list[int]] = [[] for _ in range(n + 1)]
    levels[0].append(0)

    for t in range(n):
        lvl = sorted(levels[t])
        for ideal in lvl:
            base = dist[ideal]
            rest = ~ideal
            ready = [i for i in range(n)
                     if (rest >> i) & 1 and (pred_mask[i] & rest) == 0]
            kmax = min(cap, len(ready))
            for k in range(1, kmax + 1):
                if k == 1:
                    combos = ((i,) for i in ready)
                else:
                    combos = itertools.combinations(ready, k)
                    ktab, stab, etab, atab = tables(k)
                for S in combos:
                    if k == 1:
                        i = S[0]
                        key = float(skey[i])
                        cost = float(sw[i])
                        energy = float(se[i])
                        pus_ = (d.pus[int(sarg[i])],)
                    else:
                        idx = tuple(int(sig[i]) for i in S)
                        key = float(ktab[idx])
                        if not math.isfinite(key):
                            continue   # pragma: no cover - gated above
                        cost = float(stab[idx])
                        energy = float(etab[idx])
                        ci = int(atab[idx])
                        js = []
                        for _ in range(k):
                            ci, j = divmod(ci, d.k)
                            js.append(j)
                        js.reverse()
                        pus_ = tuple(d.pus[j] for j in js)
                    nmask = ideal
                    for i in S:
                        nmask |= 1 << i
                    nd = base + key
                    old = dist.get(nmask)
                    if old is None:
                        if len(dist) >= max_states:
                            raise ValueError(
                                f"frontier sweep exceeded max_states="
                                f"{max_states} order ideals (a memory "
                                "bound) — raise max_states or use "
                                "algorithm='phase'")
                        dist[nmask] = nd
                        act[nmask] = (ideal, S, pus_, cost, energy)
                        levels[t + k].append(nmask)
                    elif nd < old:
                        dist[nmask] = nd
                        act[nmask] = (ideal, S, pus_, cost, energy)

    if not math.isfinite(dist.get(full, INF)):  # pragma: no cover
        raise InfeasibleScheduleError(
            "frontier sweep exhausted without completing the DAG (every "
            "node passed the per-PU support gate, so this indicates an "
            "internal inconsistency)")

    steps: list[DagStep] = []
    total_energy = 0.0
    s = full
    while s != 0:
        prev, S, pus_, cost, energy = act[s]
        steps.append(DagStep(ops=tuple(wl.chain[i] for i in S), pus=pus_,
                             cost=cost))
        total_energy += energy
        s = prev
    steps.reverse()
    latency = sum(st.cost for st in steps)
    return DagSchedule(steps=steps, latency=latency, energy=total_energy,
                       objective=objective, mode="frontier")


# ---------------------------------------------------------------------------
# Multi-model concurrent search (§3.2.2 / §3.3.3)
# ---------------------------------------------------------------------------


def _solo_w(table: CostTable, oi: int, pu: str) -> float:
    return table.require(oi, pu).w


def _require_pair_tables(table0: CostTable | None, table1: CostTable | None,
                         cm: ContentionModel) -> None:
    """The scalar reference routes walk the dict tables; derived dense
    views (``Workload.tail``/``under_condition``/...) carry none, so fail
    with a descriptive error instead of an ``AttributeError`` mid-walk."""
    if table0 is None or table1 is None:
        raise ValueError(
            "this solve routes to the scalar reference solver (custom "
            f"contention laws on {type(cm).__name__}, or an explicit "
            "reference algorithm), which walks the scalar CostTables — "
            "but at least one chain has none (a derived dense view); "
            "solve from Workload.build(...) of an adjusted table instead")


def _solo_edges(d: DenseCostTable, objective: str
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-position solo-advance edges: (key, chosen PU idx, w, energy)."""
    key = d.w if objective == "latency" else d.energy
    arg = np.argmin(key, axis=1)                 # first minimum, PU order
    rows = np.arange(d.n)
    return key[rows, arg], arg, d.w[rows, arg], d.energy[rows, arg]


def _suffix_heuristic(d: DenseCostTable, objective: str, scale: float
                      ) -> np.ndarray:
    """Admissible remaining-cost bound per progress index: suffix sums of
    each op's best-PU solo cost, scaled by the contention model's minimum
    co-execution factor.  (The loose-but-free bound; ``_cost_to_go``
    tightens it to the exact relaxed optimum.)"""
    m = np.min(d.w if objective == "latency" else d.energy, axis=1) * scale
    suf = np.zeros(d.n + 1)
    suf[:-1] = np.cumsum(m[::-1])[::-1]
    return suf


def _cost_to_go(pk: np.ndarray, sk0: np.ndarray, sk1: np.ndarray,
                sig0: list[int], sig1_idx: np.ndarray) -> np.ndarray:
    """Exact optimal cost-to-go over the (i, j) progress grid.

    Backward DP, one vectorized row per chain-0 position: the within-row
    dependency (solo chain-1 advances) is a suffix running-min after
    rebasing by chain-1 solo prefix sums, so each row is O(n1) NumPy work.
    This is the A* heuristic — exact up to accumulated FP rounding
    (<= (n0 + n1) ulps), so A* expands only the optimal corridor instead
    of flooding the grid.
    """
    n0, n1 = len(sig0), len(sig1_idx)
    q1 = np.zeros(n1 + 1)
    q1[:-1] = np.cumsum(sk1[::-1])[::-1]
    ctg = np.empty((n0 + 1, n1 + 1))
    ctg[n0] = q1
    c2 = np.empty(n1 + 1)
    for i in range(n0 - 1, -1, -1):
        nxt = ctg[i + 1]
        prow = pk[sig0[i]].take(sig1_idx)
        np.minimum(prow + nxt[1:], sk0[i] + nxt[:-1], out=c2[:-1])
        c2[-1] = sk0[i] + nxt[-1]
        t = c2 - q1
        rev = t[::-1]
        np.minimum.accumulate(rev, out=rev)
        np.add(q1, t, out=ctg[i])
    return ctg


def solve_concurrent_aligned(
    chain0: Sequence[int], table0: CostTable,
    chain1: Sequence[int], table1: CostTable,
    pus: Mapping[str, PUSpec],
    contention: ContentionModel | None = None,
    objective: str = "latency",
    dense0: DenseCostTable | None = None,
    dense1: DenseCostTable | None = None,
    cache: PairCostCache | None = None,
) -> ConcurrentSchedule:
    """Aligned Dijkstra: both requests advance in lockstep (same-model pairs).

    At each step the search selects a PU pair (d0, d1).  Same-PU step cost =
    average of measured concurrent execution times; cross-PU = max of
    (contention-adjusted) solo times.  Tails (unequal lengths) advance solo.
    Per-step PU-pair minimisation runs on the memoized dense pair-cost
    matrices; pass ``cache`` to share one ``PairCostCache`` across this
    pair's latency- and energy-objective solves.  A custom contention
    model falls back to the scalar reference.
    """
    contention = contention or ContentionModel()
    if not uses_default_coexec(contention):
        _require_pair_tables(table0, table1, contention)
        return solve_concurrent_aligned_reference(
            chain0, table0, chain1, table1, pus, contention, objective)
    if cache is not None:
        d0, d1 = cache.d0, cache.d1
    else:
        d0 = dense0 if dense0 is not None else DenseCostTable.from_chain(
            chain0, table0, pus)
        d1 = dense1 if dense1 is not None else DenseCostTable.from_chain(
            chain1, table1, pus)
        cache = PairCostCache(contention, d0, d1)
    k1 = d1.k
    n = min(d0.n, d1.n)
    steps: list[ConcurrentStep] = []
    total = 0.0
    energy = 0.0
    sig0, sig1 = d0.sig.tolist(), d1.sig.tolist()
    pk, ps, pe, pa = cache.edge_tables(objective)
    pkl, psl, pel, pal = pk.tolist(), ps.tolist(), pe.tolist(), pa.tolist()
    for i in range(n):
        s0, s1 = sig0[i], sig1[i]
        if pkl[s0][s1] == float("inf"):
            d0.require_row(i)
            d1.require_row(i)
        p0i, p1i = divmod(pal[s0][s1], k1)
        step_cost = psl[s0][s1]
        steps.append(ConcurrentStep(ops=(chain0[i], chain1[i]),
                                    pus=(d0.pus[p0i], d1.pus[p1i]),
                                    cost=step_cost))
        total += step_cost
        energy += pel[s0][s1]
    # solo tail for the longer request
    dl, idx = (d0, 0) if d0.n > n else (d1, 1)
    longer = chain0 if idx == 0 else chain1
    _, sarg, sw, se = _solo_edges(dl, objective)
    for i in range(n, dl.n):
        dl.require_row(i)
        p = dl.pus[int(sarg[i])]
        w, e = float(sw[i]), float(se[i])
        ops = (longer[i], None) if idx == 0 else (None, longer[i])
        pus_ = (p, None) if idx == 0 else (None, p)
        steps.append(ConcurrentStep(ops=ops, pus=pus_, cost=w))
        total += w
        energy += e
    return ConcurrentSchedule(steps=steps, latency=total, energy=energy,
                              objective=objective, mode="aligned")


def solve_concurrent_aligned_reference(
    chain0: Sequence[int], table0: CostTable,
    chain1: Sequence[int], table1: CostTable,
    pus: Mapping[str, PUSpec],
    contention: ContentionModel | None = None,
    objective: str = "latency",
) -> ConcurrentSchedule:
    """Scalar aligned-mode solver (pre-vectorization reference)."""
    contention = contention or ContentionModel()
    n = min(len(chain0), len(chain1))
    steps: list[ConcurrentStep] = []
    total = 0.0
    energy = 0.0
    for i in range(n):
        o0, o1 = chain0[i], chain1[i]
        best = None
        for d0 in table0.supported_pus(o0):
            t0 = _solo_w(table0, o0, d0)
            p0 = table0.require(o0, d0).power
            for d1 in table1.supported_pus(o1):
                t1 = _solo_w(table1, o1, d1)
                p1 = table1.require(o1, d1).power
                step = contention.pair_step_cost(t0, d0, t1, d1)
                cc0, cc1 = contention.co_exec(t0, d0, t1, d1)
                # energy: each op runs for its concurrent duration at its
                # PU's power (time-shared same-PU execution draws the PU's
                # power once -> charge each op its solo share).
                if d0 == d1:
                    e = t0 * p0 + t1 * p1
                else:
                    e = cc0 * p0 + cc1 * p1
                key = step if objective == "latency" else e
                if best is None or key < best[0]:
                    best = (key, step, e, d0, d1)
        _, step_cost, step_energy, d0, d1 = best
        steps.append(ConcurrentStep(ops=(o0, o1), pus=(d0, d1), cost=step_cost))
        total += step_cost
        energy += step_energy
    # solo tail for the longer request
    longer, table_l, idx = ((chain0, table0, 0) if len(chain0) > n
                            else (chain1, table1, 1))
    for i in range(n, len(longer)):
        oi = longer[i]
        cands = [(node_weight(table_l.require(oi, p), "latency"),
                  table_l.require(oi, p).energy, p)
                 for p in table_l.supported_pus(oi)]
        key_i = 0 if objective == "latency" else 1
        w, e, p = min(cands, key=lambda c: c[key_i])
        ops = (oi, None) if idx == 0 else (None, oi)
        pus_ = (p, None) if idx == 0 else (None, p)
        steps.append(ConcurrentStep(ops=ops, pus=pus_, cost=w))
        total += w
        energy += e
    return ConcurrentSchedule(steps=steps, latency=total, energy=energy,
                              objective=objective, mode="aligned")


def solve_concurrent_joint(
    chain0: Sequence[int], table0: CostTable,
    chain1: Sequence[int], table1: CostTable,
    pus: Mapping[str, PUSpec],
    contention: ContentionModel | None = None,
    objective: str = "latency",
    algorithm: str = "auto",
    dense0: DenseCostTable | None = None,
    dense1: DenseCostTable | None = None,
    cache: PairCostCache | None = None,
) -> ConcurrentSchedule:
    """Joint (i, j) search: each request's progress tracked independently.

    State (i, j) = completed op counts.  Transitions: advance both
    (i+1, j+1), advance request 0 solo (i+1, j), or advance request 1 solo
    (i, j+1) — allowing asymmetric completion with solo tails (paper
    §3.2.2).

    Runs as A* on the dense progress grid: all PU options for a transition
    share a successor, so each state has at most three precomputed
    min-edges, and the consistent suffix-sum heuristic steers expansion
    down the optimal corridor instead of flooding the grid like the
    reference Dijkstra.  Identical cost/assignment semantics to
    ``solve_concurrent_joint_reference``.
    """
    contention = contention or ContentionModel()
    if algorithm == "auto":
        algorithm = "astar" if uses_default_coexec(contention) else "dijkstra"
    if algorithm == "dijkstra":
        _require_pair_tables(table0, table1, contention)
        return solve_concurrent_joint_reference(
            chain0, table0, chain1, table1, pus, contention, objective)
    if algorithm != "astar":
        raise ValueError(algorithm)
    if not uses_default_coexec(contention):
        raise ValueError(
            "algorithm='astar' requires the default co-execution cost laws; "
            f"{type(contention).__name__} overrides them — use "
            "algorithm='auto' or 'dijkstra'")

    if cache is not None:
        d0, d1 = cache.d0, cache.d1
    else:
        d0 = dense0 if dense0 is not None else DenseCostTable.from_chain(
            chain0, table0, pus)
        d1 = dense1 if dense1 is not None else DenseCostTable.from_chain(
            chain1, table1, pus)
        cache = PairCostCache(contention, d0, d1)
    n0, n1 = d0.n, d1.n
    k1 = d1.k
    pk, ps, pe, pa = cache.edge_tables(objective)
    sk0, sa0, sw0, se0 = _solo_edges(d0, objective)
    sk1, sa1, sw1, se1 = _solo_edges(d1, objective)
    if not (np.isfinite(sk0).all() and np.isfinite(sk1).all()):
        # some op unsupported on every PU: no transition can advance it
        raise ValueError("joint search failed to reach target state")

    sig0, sig1 = d0.sig.tolist(), d1.sig.tolist()
    sk0l, sk1l = sk0.tolist(), sk1.tolist()
    pkl = pk.tolist()    # nested Python lists: cheaper hot-loop indexing
    hs = _cost_to_go(pk, sk0, sk1, sig0, d1.sig).ravel()

    # f is quantized before entering the heap and ties break toward
    # *larger* g (deeper states).  Schedules whose true costs coincide
    # (e.g. energy mode, where pairing two ops on their shared best PU
    # costs exactly their solo sum) reach f values that differ only by
    # accumulated FP rounding; without quantization that noise orders the
    # plateau breadth-first and the search floods the whole grid.  The
    # quantum sits ~100x above worst-case accumulated rounding and ~100x
    # below any physically meaningful cost gap, and bounds the returned
    # path's suboptimality by 2 quanta (~1e-11 relative) — tie-free
    # instances still return the bitwise-exact reference optimum.
    c00 = hs[0]
    quantum = (c00 if c00 > 0 else 1.0) * (n0 + n1 + 64) * 1e-15
    inv_q = 1.0 / quantum

    n1p = n1 + 1
    n_states = (n0 + 1) * n1p
    dist = np.full(n_states, np.inf)
    act = np.zeros(n_states, dtype=np.int8)  # 1 = pair, 2 = solo0, 3 = solo1
    target = n_states - 1
    dist[0] = 0.0
    heap: list[tuple[int, float, int]] = [(int(c00 * inv_q), 0.0, 0)]
    found = False
    while heap:
        fq, ng, s = heapq.heappop(heap)
        g = -ng
        if g > dist[s]:
            continue
        if s == target:
            found = True
            break
        i, j = divmod(s, n1p)
        if i < n0 and j < n1:
            nd = g + pkl[sig0[i]][sig1[j]]
            ns = s + n1p + 1
            if nd < dist[ns]:
                dist[ns] = nd
                act[ns] = 1
                heapq.heappush(heap, (int((nd + hs[ns]) * inv_q), -nd, ns))
        if i < n0:
            nd = g + sk0l[i]
            ns = s + n1p
            if nd < dist[ns]:
                dist[ns] = nd
                act[ns] = 2
                heapq.heappush(heap, (int((nd + hs[ns]) * inv_q), -nd, ns))
        if j < n1:
            nd = g + sk1l[j]
            ns = s + 1
            if nd < dist[ns]:
                dist[ns] = nd
                act[ns] = 3
                heapq.heappush(heap, (int((nd + hs[ns]) * inv_q), -nd, ns))
    if not found:
        raise ValueError("joint search failed to reach target state")
    # reconstruct (energy accumulated target -> start, like the reference)
    steps: list[ConcurrentStep] = []
    energy = 0.0
    i, j = n0, n1
    while (i, j) != (0, 0):
        a = int(act[i * n1p + j])
        if a == 1:
            i -= 1
            j -= 1
            p0i, p1i = divmod(int(pa[sig0[i], sig1[j]]), k1)
            steps.append(ConcurrentStep(
                ops=(chain0[i], chain1[j]),
                pus=(d0.pus[p0i], d1.pus[p1i]),
                cost=float(ps[sig0[i], sig1[j]])))
            energy += float(pe[sig0[i], sig1[j]])
        elif a == 2:
            i -= 1
            steps.append(ConcurrentStep(
                ops=(chain0[i], None), pus=(d0.pus[int(sa0[i])], None),
                cost=float(sw0[i])))
            energy += float(se0[i])
        elif a == 3:
            j -= 1
            steps.append(ConcurrentStep(
                ops=(None, chain1[j]), pus=(None, d1.pus[int(sa1[j])]),
                cost=float(sw1[j])))
            energy += float(se1[j])
        else:  # pragma: no cover - would mean a corrupt predecessor chain
            raise RuntimeError(f"joint A*: no action recorded at ({i}, {j})")
    steps.reverse()
    latency = sum(s.cost for s in steps)
    return ConcurrentSchedule(steps=steps, latency=latency, energy=energy,
                              objective=objective, mode="joint")


def solve_concurrent_joint_reference(
    chain0: Sequence[int], table0: CostTable,
    chain1: Sequence[int], table1: CostTable,
    pus: Mapping[str, PUSpec],
    contention: ContentionModel | None = None,
    objective: str = "latency",
) -> ConcurrentSchedule:
    """Joint (i, j) Dijkstra over dict states (pre-A* reference)."""
    contention = contention or ContentionModel()
    n0, n1 = len(chain0), len(chain1)
    INF = float("inf")
    dist: dict[tuple[int, int], float] = {(0, 0): 0.0}
    prev: dict[tuple[int, int], tuple[tuple[int, int], ConcurrentStep, float]] = {}
    heap: list[tuple[float, tuple[int, int]]] = [(0.0, (0, 0))]
    done: set[tuple[int, int]] = set()

    def step_options(i: int, j: int):
        # (next_state, step, objective_key, energy)
        if i < n0 and j < n1:
            o0, o1 = chain0[i], chain1[j]
            for d0 in table0.supported_pus(o0):
                t0 = _solo_w(table0, o0, d0)
                p0 = table0.require(o0, d0).power
                for d1 in table1.supported_pus(o1):
                    t1 = _solo_w(table1, o1, d1)
                    p1 = table1.require(o1, d1).power
                    step = contention.pair_step_cost(t0, d0, t1, d1)
                    cc0, cc1 = contention.co_exec(t0, d0, t1, d1)
                    e = (t0 * p0 + t1 * p1) if d0 == d1 else (cc0 * p0 + cc1 * p1)
                    yield ((i + 1, j + 1),
                           ConcurrentStep(ops=(o0, o1), pus=(d0, d1), cost=step),
                           step if objective == "latency" else e, e)
        if i < n0:
            o0 = chain0[i]
            for d0 in table0.supported_pus(o0):
                ent = table0.require(o0, d0)
                yield ((i + 1, j),
                       ConcurrentStep(ops=(o0, None), pus=(d0, None), cost=ent.w),
                       ent.w if objective == "latency" else ent.energy, ent.energy)
        if j < n1:
            o1 = chain1[j]
            for d1 in table1.supported_pus(o1):
                ent = table1.require(o1, d1)
                yield ((i, j + 1),
                       ConcurrentStep(ops=(None, o1), pus=(None, d1), cost=ent.w),
                       ent.w if objective == "latency" else ent.energy, ent.energy)

    target = (n0, n1)
    while heap:
        d, st = heapq.heappop(heap)
        if st in done:
            continue
        done.add(st)
        if st == target:
            break
        for nxt, step, key, e in step_options(*st):
            nd = d + key
            if nd < dist.get(nxt, INF):
                dist[nxt] = nd
                prev[nxt] = (st, step, e)
                heapq.heappush(heap, (nd, nxt))
    if target not in dist:
        raise ValueError("joint search failed to reach target state")
    # reconstruct
    steps: list[ConcurrentStep] = []
    energy = 0.0
    cur = target
    while cur != (0, 0):
        st, step, e = prev[cur]
        steps.append(step)
        energy += e
        cur = st
    steps.reverse()
    latency = sum(s.cost for s in steps)
    return ConcurrentSchedule(steps=steps, latency=latency, energy=energy,
                              objective=objective, mode="joint")


# ---------------------------------------------------------------------------
# M-request concurrent search over Workloads (generalizes the pair solvers)
# ---------------------------------------------------------------------------


class ConcurrentCaches:
    """Objective-independent setup shared across repeated
    ``solve_concurrent`` calls under one contention model and runtime
    condition.

    ``pair`` memoizes ``PairCostCache`` instances and ``group_tables``
    the vectorized grid sweep's per-subset
    :class:`~repro_torch.core.contention.GroupCostCache` tables (both
    objectives' bests per entry, shared by the full-grid and every
    rolling-horizon window solve).  Both are keyed by the participating
    workloads' **content signatures** (``Workload.signature()``), so a
    single pool safely serves *different* workload tuples: overlapping
    handle sets, tail re-plans at any progress, and re-admitted models
    all hit the same tables — the backbone of warm-start incremental
    re-planning (equal signatures ⇒ identical dense views ⇒ identical
    table contents).  ``group`` memoizes the retained heap A*'s scalar
    per-(subset, signature-tuple) edges; its inner ids are only
    meaningful per workload tuple, so entries are scoped under the
    tuple's signature key.

    A pool must not be shared across contention models or runtime
    conditions — both change table contents without changing the keys
    (the orchestrator keys its pools by condition for exactly this
    reason).

    Because one pool now serves a whole serving session, it is bounded:
    ``pair`` and ``group_tables`` are insertion-ordered LRUs trimmed to
    ``max_table_bytes`` (half each; the newest entry always survives),
    and ``group`` keeps the most recent ``max_group_scopes`` tuple
    memos.  Eviction only costs a rebuild on the next miss — values are
    content-derived, so correctness is unaffected.
    """

    def __init__(self, max_table_bytes: int = 512 * 2**20,
                 max_group_scopes: int = 64) -> None:
        self.pair: dict[tuple[str, str], PairCostCache] = {}
        self.group: dict[tuple[str, ...], dict] = {}
        self.group_tables: dict[tuple, GroupCostCache] = {}
        self.max_table_bytes = max_table_bytes
        self.max_group_scopes = max_group_scopes
        # monotonic trim counters, surfaced by Orchestrator.cache_stats()
        # (and from there ServeReport): sustained growth during a serving
        # run is the cache-pressure signal behind re-plan slowdowns
        self.stats = {"pair_trims": 0, "group_table_trims": 0,
                      "group_scope_trims": 0}

    def trim(self) -> None:
        """Evict oldest ``pair``/``group_tables`` entries past the byte
        budget (lazily built tables are accounted as they fill) and
        oldest ``group`` scopes past the scope cap.  Entries still
        referenced by an in-flight solve stay alive until it finishes.
        Every eviction bumps the matching ``stats`` counter."""
        half = self.max_table_bytes // 2
        for d, key in ((self.pair, "pair_trims"),
                       (self.group_tables, "group_table_trims")):
            while len(d) > 1 and \
                    sum(v.nbytes() for v in d.values()) > half:
                d.pop(next(iter(d)))
                self.stats[key] += 1
        while len(self.group) > self.max_group_scopes:
            self.group.pop(next(iter(self.group)))
            self.stats["group_scope_trims"] += 1


def _require_oracle_tables(wls: Sequence[Workload],
                           cm: ContentionModel) -> None:
    """Custom co-execution laws route to the scalar reference solvers,
    which need each workload's oracle ``CostTable``.  Derived dense views
    (``under_condition``/``tail``/``select``/``spliced``) carry none —
    their rows no longer correspond to the source dict — so reject them
    loudly instead of silently pricing the wrong costs."""
    if uses_default_coexec(cm):
        return
    for r, wl in enumerate(wls):
        if wl.table is None:
            raise ValueError(
                f"{type(cm).__name__} overrides the co-execution laws, "
                "which requires the scalar reference solvers — but "
                f"workload {r} has no oracle CostTable (it is a derived "
                "dense view); solve from a Workload.build(...) of the "
                "adjusted table instead")


def _solo_step_walk(wl: Workload, req: int, m: int, objective: str,
                    lo: int = 0, hi: int | None = None,
                    solo: tuple | None = None,
                    ) -> tuple[list[ConcurrentStep], float, float]:
    """Solo-advance steps for one request inside an M-request schedule:
    each op on its best PU by ``objective`` (node weights only — the
    concurrent formulation prices no inter-op transitions).  ``lo``/
    ``hi`` bound the walked span (warm tail / bounded-horizon re-plans);
    ``solo`` passes precomputed ``_solo_edges`` arrays."""
    d = wl.dense
    _, sarg, sw, se = solo if solo is not None else _solo_edges(d, objective)
    steps: list[ConcurrentStep] = []
    lat = 0.0
    eng = 0.0
    for i in range(lo, d.n if hi is None else hi):
        d.require_row(i)
        ops = [None] * m
        pus_: list[str | None] = [None] * m
        ops[req] = wl.chain[i]
        pus_[req] = d.pus[int(sarg[i])]
        w, e = float(sw[i]), float(se[i])
        steps.append(ConcurrentStep(ops=tuple(ops), pus=tuple(pus_), cost=w))
        lat += w
        eng += e
    return steps, lat, eng


DEFAULT_MAX_STATES = 2_000_000     # exact-grid ceiling: a MEMORY bound
DEFAULT_WINDOW_STATES = 65_536     # rolling-horizon per-window grid budget
DEFAULT_HORIZON_STATES = 1_024     # bounded-lookahead serving re-plan budget

# Boxes up to this many states take the sweep's hoisted relaxation path
# (per-subset sources/keys/successors precomputed in diagonal-major
# order, ~170 B/state peak); larger boxes stream per diagonal.  Both
# paths are bitwise-identical — the cap trades peak memory against the
# per-NumPy-call overhead that dominates small warm re-plan boxes.
_SWEEP_HOIST_CAP = 131_072

# Boxes up to this many states take the destination-major merged
# relaxation: all subsets' edges are concatenated, sorted once by
# (dst diagonal, dst, cold write order), and each diagonal resolves in
# one batched group-min — ~9 NumPy calls per diagonal instead of ~8 per
# (diagonal, subset).  This is the serving re-plan hot path (horizon
# windows are <= ~2k states).  The edge sort is O(E log E) over
# E ~ 2^m * states edges, so large boxes fall back to the hoisted path.
_SWEEP_MERGE_CAP = 8_192


def solve_concurrent(
    workloads: Sequence[Workload],
    contention: ContentionModel | None = None,
    objective: str = "latency",
    algorithm: str = "auto",
    max_states: int | None = None,
    caches: ConcurrentCaches | None = None,
    window_states: int = DEFAULT_WINDOW_STATES,
) -> ConcurrentSchedule:
    """Joint co-scheduling of M >= 1 concurrent requests.

    The single formulation of the paper's §3.2.2, generalized: state =
    per-request completed-op counts; a transition advances any non-empty
    subset of requests one op each, priced by the contention model's
    group co-execution laws.

    * **M = 1** — a solo walk (each op on its best PU by objective).
    * **M = 2** — dispatched to ``solve_concurrent_joint``: the dense
      pair A* fast path, bit-for-bit (the retained pair solvers ARE the
      M = 2 case).
    * **M >= 3, grids up to ``max_states``** — exact vectorized
      anti-diagonal sweep of the M-dimensional progress grid
      (``algorithm="grid"`` forces it; ``"grid_astar"`` forces the
      retained heap A* oracle; both raise if the grid exceeds
      ``max_states`` or the contention model overrides the group laws).
      ``max_states`` (``None`` = ``DEFAULT_MAX_STATES``) is a *memory*
      bound (~100 bytes/state for the sweep's dense per-state arrays),
      not a time bound; it governs the M >= 3 routes and the explicitly
      grid-forced M = 2 solves — passing it alongside the M = 2 pair
      fast path (which is corridor-exact and not state-bounded) raises
      rather than silently ignoring it.
    * **M >= 3, larger grids** — the rolling-horizon merge
      (``algorithm="rolling"`` forces it): the next window of ops across
      ALL M requests is co-scheduled with an exact grid sweep
      (``<= window_states`` states per window, window lengths
      proportional to remaining chain lengths) and windows are stitched
      back-to-back.  Upper-bounds the exact grid optimum and recovers
      cross-request concurrency the old pairwise merge serialized away.
    * **custom contention laws** — the documented pairwise-merge
      fallback (``algorithm="pairwise"`` forces it): requests sorted by
      descending solo-best cost, adjacent pairs co-scheduled with the
      exact pair A* (whose scalar reference honours overridden pair
      laws), pairs executed back-to-back, an odd cheapest request
      running solo.

    ``algorithm="auto"`` picks the exact sweep when it fits
    ``max_states``, the rolling-horizon merge when it does not, and
    pairwise only under custom contention laws (or for the degenerate
    near-unique-signature profiles whose shared group tables would dwarf
    the rolling windows; forcing ``"rolling"`` there raises instead of
    silently downgrading).  Pass ``caches`` (a
    :class:`ConcurrentCaches` dedicated to this workload tuple) to share
    the objective-independent setup across a latency + energy solve
    pair.
    """
    contention = contention or ContentionModel()
    wls = list(workloads)
    m = len(wls)
    if m == 0:
        raise ValueError("solve_concurrent needs at least one workload")
    if algorithm not in ("auto", "astar", "dijkstra", "grid", "grid_astar",
                         "rolling", "pairwise"):
        raise ValueError(algorithm)
    if m == 1:
        if algorithm != "auto" or max_states is not None:
            raise ValueError(
                "algorithm=/max_states= were forced, but a single request "
                "has no concurrent search to route — the M = 1 solve is a "
                "solo best-PU walk; drop the arguments")
        steps, lat, eng = _solo_step_walk(wls[0], 0, 1, objective)
        return ConcurrentSchedule(steps=steps, latency=lat, energy=eng,
                                  objective=objective, mode="joint")
    _require_oracle_tables(wls, contention)
    if m == 2 and algorithm in ("auto", "astar", "dijkstra"):
        if max_states is not None:
            raise ValueError(
                "max_states bounds the grid/rolling routes, but this M = 2 "
                "solve dispatches to the pair A* fast path (corridor-exact, "
                "not state-bounded) — drop max_states, or force "
                "algorithm='grid'/'grid_astar'/'rolling'/'pairwise' to "
                "apply a state-bounded route")
        pair_algo = "auto" if algorithm == "auto" else algorithm
        cache = _pair_cache(caches, contention, wls, 0, 1)
        return solve_concurrent_joint(
            wls[0].chain, wls[0].table, wls[1].chain, wls[1].table,
            wls[0].pus, contention, objective, algorithm=pair_algo,
            dense0=wls[0].dense, dense1=wls[1].dense, cache=cache)
    if max_states is None:
        max_states = DEFAULT_MAX_STATES
    n_states = math.prod(wl.n + 1 for wl in wls)
    default_laws = uses_default_group(contention)
    if algorithm in ("grid", "grid_astar"):
        if not default_laws:
            raise ValueError(
                f"algorithm={algorithm!r} requires the default group "
                f"co-execution laws; {type(contention).__name__} overrides "
                "them — use algorithm='auto' or 'pairwise'")
        if n_states > max_states:
            raise ValueError(
                f"algorithm={algorithm!r} on {n_states} states exceeds "
                f"max_states={max_states}; raise max_states (a memory "
                "bound of ~100 bytes/state) or use algorithm='rolling' "
                "or 'pairwise'")
        if algorithm == "grid":
            return _solve_concurrent_grid(wls, contention, objective, caches)
        group_memo = None
        if caches is not None:
            # the heap A* memo's (subset, signature-id) keys are only
            # meaningful for one workload tuple — scope them under the
            # tuple's content signatures so a shared pool stays safe
            scope = tuple(wl.signature() for wl in wls)
            group_memo = caches.group.setdefault(scope, {})
            caches.group[scope] = caches.group.pop(scope)  # LRU refresh
            caches.trim()
        return _solve_concurrent_grid_astar(wls, contention, objective,
                                            group_memo)
    if algorithm == "rolling":
        if not default_laws:
            raise ValueError(
                "algorithm='rolling' co-schedules each window with the "
                "exact grid sweep, which requires the default group "
                f"co-execution laws; {type(contention).__name__} overrides "
                "them — use algorithm='auto' or 'pairwise'")
        sig_states = _group_table_states(wls)
        if sig_states > _ROLLING_TABLE_CAP:
            raise ValueError(
                "algorithm='rolling' shares group-edge tables over the "
                f"requests' full signature alphabets, and {sig_states} "
                f"signature tuples exceed the {_ROLLING_TABLE_CAP} table "
                "cap (near-unique per-op signatures, e.g. a measured "
                "profile) — use algorithm='auto' or 'pairwise'")
        return _solve_concurrent_rolling(wls, contention, objective, caches,
                                         min(window_states, max_states))
    if algorithm == "pairwise":
        return _solve_concurrent_pairwise(wls, contention, objective, caches)
    if algorithm != "auto":   # "astar"/"dijkstra": pair-only spellings
        raise ValueError(
            f"algorithm={algorithm!r} names the two-request pair solvers "
            f"and does not generalize to M = {m} requests — use "
            "'auto', 'grid', 'grid_astar', 'rolling', or 'pairwise'")
    if not default_laws:
        return _solve_concurrent_pairwise(wls, contention, objective, caches)
    if n_states <= max_states:
        return _solve_concurrent_grid(wls, contention, objective, caches)
    if _group_table_states(wls) <= _ROLLING_TABLE_CAP:
        return _solve_concurrent_rolling(wls, contention, objective, caches,
                                         min(window_states, max_states))
    return _solve_concurrent_pairwise(wls, contention, objective, caches)


def _pair_cache(caches: ConcurrentCaches | None, cm: ContentionModel,
                wls: Sequence[Workload], a: int, b: int
                ) -> PairCostCache | None:
    """Memoized PairCostCache for requests (a, b), keyed by the pair's
    content signatures so any workload tuple containing an identically
    priced pair reuses it; None when the pair solver should build its
    own (no pool, or custom laws where the dense cache is unused)."""
    if caches is None or not uses_default_coexec(cm):
        return None
    key = (wls[a].signature(), wls[b].signature())
    cache = caches.pair.get(key)
    if cache is None:
        cache = PairCostCache(cm, wls[a].dense, wls[b].dense)
        caches.pair[key] = cache
        caches.trim()
    else:
        caches.pair[key] = caches.pair.pop(key)       # LRU refresh
    return cache


def _require_all_advanceable(wls: Sequence[Workload],
                             solo_keys: Sequence[np.ndarray]) -> None:
    """Descriptive infeasibility gate for the M-request solvers: an op
    with no supported PU can never be advanced by any transition, so
    every route fails identically — report which request, which op, and
    where, instead of an opaque search-exhaustion error later."""
    for r, (wl, key) in enumerate(zip(wls, solo_keys)):
        bad = ~np.isfinite(np.asarray(key))
        if bad.any():
            pos = int(np.argmax(bad))
            raise InfeasibleScheduleError(
                f"request {r}: {wl.op_name(pos)} at chain position {pos} "
                "is unsupported on every PU — no concurrent transition "
                "can advance it")


class _GridContext:
    """Per-solve vectorized inputs shared by the full-grid sweep and the
    rolling-horizon windows: per-request dense solo edges, signature-id
    arrays, and lazily built per-subset group-edge tables
    (:class:`~repro_torch.core.contention.GroupCostCache`).  When backed by a
    shared :class:`ConcurrentCaches` pool the tables are keyed by the
    requests' *content signatures* (``Workload.signature()``), so every
    window of a rolling solve, the companion solve under the other
    objective, AND any later solve over content-identical workloads —
    a tail re-plan, an overlapping handle set, a re-admitted model —
    reuses them; an unpooled context falls back to request-index keys.
    """

    def __init__(self, wls: Sequence[Workload], cm: ContentionModel,
                 objective: str, caches: ConcurrentCaches | None = None,
                 check_advanceable: bool = True):
        self.wls = list(wls)
        self.m = len(self.wls)
        self.cm = cm
        self.objective = objective
        self.denses = [wl.dense for wl in self.wls]
        self.pu_lists = [d.pus for d in self.denses]
        self.solo = [_solo_edges(d, objective) for d in self.denses]
        if check_advanceable:
            _require_all_advanceable(self.wls, [s[0] for s in self.solo])
        self.sigs = [d.sig for d in self.denses]
        self._caches = caches
        self._pooled = caches is not None
        self._keys: list[str] | None = None   # content signatures, lazy
        self._tables = caches.group_tables if caches is not None else {}

    def tables(self, reqs: tuple[int, ...]
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        if self._pooled:
            if self._keys is None:
                self._keys = [wl.signature() for wl in self.wls]
            key: tuple = tuple(self._keys[r] for r in reqs)
        else:
            key = reqs
        gc = self._tables.get(key)
        created = gc is None
        if created:
            gc = GroupCostCache(self.cm, [self.denses[r] for r in reqs])
            self._tables[key] = gc
        elif self._pooled:
            self._tables[key] = self._tables.pop(key)   # LRU refresh
        tabs = gc.edge_tables(self.objective)
        if created and self._pooled:
            # trim after the build so the new entry's size is accounted
            self._caches.trim()
        return tabs

    def sweep(self, lo: Sequence[int], hi: Sequence[int]
              ) -> tuple[list[ConcurrentStep], float]:
        """Exact anti-diagonal DP over the progress sub-box
        ``prod([lo_r, hi_r])``; returns ``(steps, energy)``.

        All states with equal total progress form an anti-diagonal; every
        transition strictly increases total progress, so diagonals are a
        topological order and each one is relaxed in a handful of batched
        NumPy operations per advance subset.  Within one (diagonal,
        subset) relaxation distinct sources map to distinct successors
        (``s + delta`` is injective), so the scatter needs no conflict
        resolution; ties between subsets resolve to the first strict
        improvement in (source-diagonal, subset-bitmask) order — a fixed,
        deterministic policy.  Unlike the retained heap A*
        (quantized-priority tie plateaus, suboptimality <= 2 quanta),
        the sweep returns the exact FP-minimal objective.

        Three relaxation paths, all bitwise-identical (same candidate
        values, same tie policy): boxes up to ``_SWEEP_MERGE_CAP``
        states run destination-major — every subset's edges are
        concatenated, sorted once by (dst diagonal, dst, cold write
        order) and each diagonal resolves as one batched first-achiever
        group-min, collapsing the per-(diagonal, subset) NumPy overhead
        that dominates the small warm re-plan boxes of the serving hot
        path.  Boxes up to ``_SWEEP_HOIST_CAP`` run the hoisted path:
        per-subset valid-source lists, gathered edge keys and successor
        indices precomputed over the whole box in diagonal-major order,
        leaving a gather/add/compare/scatter per (diagonal, subset).
        Larger boxes stream per diagonal to keep peak memory at a few
        arrays per state.
        """
        m = self.m
        sizes = [hi[r] - lo[r] for r in range(m)]
        shape = [s + 1 for s in sizes]
        strides = [0] * m
        strides[m - 1] = 1
        for r in range(m - 2, -1, -1):
            strides[r] = strides[r + 1] * shape[r + 1]
        n_states = strides[0] * shape[0]
        target = n_states - 1
        if target == 0:
            return [], 0.0
        flat = np.arange(n_states)
        pos = [(flat // strides[r]) % shape[r] for r in range(m)]
        apos = [pos[r] + lo[r] for r in range(m)]   # absolute chain position
        tsum = pos[0].copy()
        for r in range(1, m):
            tsum += pos[r]
        if n_states > _SWEEP_MERGE_CAP:   # diagonal-major source order —
            # only the hoisted/streaming paths consume it
            order = np.argsort(tsum, kind="stable")
            offs = np.concatenate(
                ([0], np.cumsum(np.bincount(tsum,
                                            minlength=sum(sizes) + 1))))
        can = [pos[r] < sizes[r] for r in range(m)]
        sk = [self.solo[r][0] for r in range(m)]
        subsets = []    # (bits, reqs, delta, key_table_flat, table_shape)
        for bits in range(1, 1 << m):
            reqs = tuple(r for r in range(m) if bits & (1 << r))
            if any(sizes[r] == 0 for r in reqs):
                continue        # a finished request can never advance
            delta = sum(strides[r] for r in reqs)
            if len(reqs) == 1:
                subsets.append((bits, reqs, delta, None, None))
            else:
                tab = self.tables(reqs)[0]
                subsets.append((bits, reqs, delta, tab.ravel(), tab.shape))

        dist = np.full(n_states, np.inf)
        act = np.zeros(n_states, dtype=np.int32)    # subset bitmask taken
        dist[0] = 0.0
        if n_states <= _SWEEP_MERGE_CAP:
            # destination-major merged relaxation: dist[src] is final
            # before any edge out of src is relaxed (every transition
            # strictly deepens the diagonal), so dist[dst] is the plain
            # min over incoming candidates and act[dst] the FIRST
            # candidate attaining it in the cold write order
            # (source-diagonal asc == popcount desc, then subset order)
            # — strict-`<` sequential relaxation keeps exactly that
            # first achiever, so values AND actions are bitwise-equal.
            S_, K_, D_, B_, R_ = [], [], [], [], []
            for bits, reqs, delta, kflat, tshape in subsets:
                valid = can[reqs[0]]
                for r in reqs[1:]:
                    valid = valid & can[r]
                srcs = np.flatnonzero(valid)
                if kflat is None:
                    r0 = reqs[0]
                    keys = sk[r0][apos[r0][srcs]]
                else:
                    idx = self.sigs[reqs[0]][apos[reqs[0]][srcs]]
                    for r, sdim in zip(reqs[1:], tshape[1:]):
                        idx = idx * sdim + self.sigs[r][apos[r][srcs]]
                    keys = kflat[idx]
                S_.append(srcs)
                K_.append(keys)
                D_.append(srcs + delta)
                B_.append(np.full(srcs.size, bits, dtype=np.int32))
                R_.append(np.full(srcs.size, m - len(reqs),
                                  dtype=np.int64))
            S = np.concatenate(S_)
            K = np.concatenate(K_)
            D = np.concatenate(D_)
            B = np.concatenate(B_)
            R = np.concatenate(R_)
            skey = (tsum[D] * n_states + D) * (m + 1) + R
            perm = np.argsort(skey, kind="stable")
            S, K, D, B = S[perm], K[perm], D[perm], B[perm]
            E = D.size
            gs = np.flatnonzero(
                np.concatenate(([True], D[1:] != D[:-1])))
            uD = D[gs]
            gcnt = np.diff(np.append(gs, E))
            tmax = int(tsum[target])
            eoffs = np.concatenate(
                ([0], np.cumsum(np.bincount(tsum[D],
                                            minlength=tmax + 1))))
            goffs = np.concatenate(
                ([0], np.cumsum(np.bincount(tsum[uD],
                                            minlength=tmax + 1))))
            lidx = np.arange(E)
            for t in range(1, tmax + 1):
                a, z = eoffs[t], eoffs[t + 1]
                if a == z:
                    continue
                ga, gz = goffs[t], goffs[t + 1]
                starts = gs[ga:gz] - a
                nd = dist[S[a:z]] + K[a:z]
                mins = np.minimum.reduceat(nd, starts)
                cand = np.where(nd == np.repeat(mins, gcnt[ga:gz]),
                                lidx[a:z], E)
                first = np.minimum.reduceat(cand, starts)
                ud = uD[ga:gz]
                dist[ud] = mins
                act[ud] = B[first]
        elif n_states <= _SWEEP_HOIST_CAP:
            # hoisted path: per-subset valid sources / keys / successors
            # precomputed over the whole box in diagonal-major order
            plans = []      # (bits, srcs, keys, dsts, per-diagonal offsets)
            for bits, reqs, delta, kflat, tshape in subsets:
                valid = can[reqs[0]]
                for r in reqs[1:]:
                    valid = valid & can[r]
                vo = valid[order]
                srcs = order[vo]
                voffs = np.concatenate(([0], np.cumsum(vo)))[offs]
                if kflat is None:
                    r0 = reqs[0]
                    keys = sk[r0][apos[r0][srcs]]
                else:
                    idx = self.sigs[reqs[0]][apos[reqs[0]][srcs]]
                    for r, sdim in zip(reqs[1:], tshape[1:]):
                        idx = idx * sdim + self.sigs[r][apos[r][srcs]]
                    keys = kflat[idx]
                plans.append((bits, srcs, keys, srcs + delta, voffs))
            for t in range(len(offs) - 2):  # last diagonal is the target
                for bits, srcs, keys, dsts, voffs in plans:
                    a, z = voffs[t], voffs[t + 1]
                    if a == z:
                        continue
                    nd = dist[srcs[a:z]] + keys[a:z]
                    nst = dsts[a:z]
                    better = nd < dist[nst]
                    if better.any():
                        b = nst[better]
                        dist[b] = nd[better]
                        act[b] = bits
        else:
            for t in range(len(offs) - 2):  # last diagonal is the target
                seg = order[offs[t]:offs[t + 1]]
                dseg = dist[seg]
                for bits, reqs, delta, kflat, tshape in subsets:
                    valid = can[reqs[0]][seg]
                    for r in reqs[1:]:
                        valid = valid & can[r][seg]
                    sv = seg[valid]
                    if not sv.size:
                        continue
                    gv = dseg[valid]
                    if kflat is None:
                        r0 = reqs[0]
                        key = sk[r0][apos[r0][sv]]
                    else:
                        idx = self.sigs[reqs[0]][apos[reqs[0]][sv]]
                        for r, sdim in zip(reqs[1:], tshape[1:]):
                            idx = idx * sdim + self.sigs[r][apos[r][sv]]
                        key = kflat[idx]
                    nd = gv + key
                    nst = sv + delta
                    better = nd < dist[nst]
                    if better.any():
                        b = nst[better]
                        dist[b] = nd[better]
                        act[b] = bits
        if not np.isfinite(dist[target]):  # pragma: no cover - gated above
            raise InfeasibleScheduleError(
                "grid sweep exhausted without reaching the all-requests-"
                "complete state (every op passed the per-PU support gate, "
                "so this indicates an internal inconsistency)")

        # reconstruct target -> start (energy accumulated in that order,
        # like the pair A* and the retained heap grid A*)
        by_bits = {bits: (reqs, delta) for bits, reqs, delta, _, _ in subsets}
        steps: list[ConcurrentStep] = []
        energy = 0.0
        posv = list(sizes)
        s = target
        while s != 0:
            bits = int(act[s])
            if bits == 0:  # pragma: no cover - corrupt predecessor chain
                raise RuntimeError(f"grid sweep: no action recorded at {posv}")
            reqs, delta = by_bits[bits]
            for r in reqs:
                posv[r] -= 1
            s -= delta
            ops: list[int | None] = [None] * m
            pus_: list[str | None] = [None] * m
            if len(reqs) == 1:
                r = reqs[0]
                ap = lo[r] + posv[r]
                _, sarg, sw, se = self.solo[r]
                ops[r] = self.wls[r].chain[ap]
                pus_[r] = self.pu_lists[r][int(sarg[ap])]
                cost = float(sw[ap])
                energy += float(se[ap])
            else:
                _, ps, pe, pa = self.tables(reqs)
                key = tuple(int(self.sigs[r][lo[r] + posv[r]]) for r in reqs)
                cost = float(ps[key])
                energy += float(pe[key])
                ci = int(pa[key])
                combo: list[int] = []
                for r in reversed(reqs):
                    ci, j = divmod(ci, self.denses[r].k)
                    combo.append(j)
                combo.reverse()
                for r, j in zip(reqs, combo):
                    ops[r] = self.wls[r].chain[lo[r] + posv[r]]
                    pus_[r] = self.pu_lists[r][j]
            steps.append(ConcurrentStep(ops=tuple(ops), pus=tuple(pus_),
                                        cost=cost))
        steps.reverse()
        return steps, energy


def _solve_concurrent_grid(
    wls: Sequence[Workload], cm: ContentionModel, objective: str,
    caches: ConcurrentCaches | None = None,
) -> ConcurrentSchedule:
    """Exact vectorized anti-diagonal sweep of the M-dimensional progress
    grid (see :meth:`_GridContext.sweep`).  Singleton advances are priced
    from the dense solo-edge arrays; group advances gather from the
    per-(subset, signature-tuple) edge tables built once per solve."""
    ctx = _GridContext(wls, cm, objective, caches)
    steps, energy = ctx.sweep([0] * len(wls), [wl.n for wl in wls])
    latency = sum(st.cost for st in steps)
    return ConcurrentSchedule(steps=steps, latency=latency, energy=energy,
                              objective=objective, mode="joint-grid")


def _window_lengths(rem: Sequence[int], budget: int) -> list[int]:
    """Rolling-horizon window lengths: the largest proportional scaling
    of the remaining chain lengths whose window sub-grid fits ``budget``
    states.  Every unfinished request advances at least one op per
    window (the progress guarantee; with many requests and a tiny budget
    that floor may overshoot the budget slightly)."""
    if math.prod(r + 1 for r in rem) <= budget:
        return list(rem)                   # final window: exact to the end

    def scaled(a: float) -> list[int]:
        return [min(r, max(1, int(a * r))) if r else 0 for r in rem]

    lo_a, hi_a = 0.0, 1.0
    for _ in range(40):
        mid = 0.5 * (lo_a + hi_a)
        if math.prod(x + 1 for x in scaled(mid)) <= budget:
            lo_a = mid
        else:
            hi_a = mid
    return scaled(lo_a)


# the rolling route's shared group tables cover the requests' full
# signature alphabets; a near-unique-signature profile (e.g. measured
# tables where every op times differently) could make them larger than
# the windows they serve — ``solve_concurrent`` routes such instances to
# the pairwise merge under "auto" and rejects a forced "rolling" loudly.
# Each signature tuple retains 2 objectives x 4 float64/int64 cells
# (64 B) in the dominant all-requests table, so the cap bounds the
# memoized footprint to ~64 MB — the same order as a max_states-sized
# sweep's per-state arrays (zoo alphabets are orders of magnitude below)
_ROLLING_TABLE_CAP = 1_000_000


def _group_table_states(wls: Sequence[Workload]) -> int:
    """Signature tuples of the largest (all-requests) group-edge table —
    the dominant term of the rolling route's shared-table footprint."""
    return math.prod(wl.dense.n_sig for wl in wls)


def _solve_concurrent_rolling(
    wls: Sequence[Workload], cm: ContentionModel, objective: str,
    caches: ConcurrentCaches | None = None,
    window_states: int = DEFAULT_WINDOW_STATES,
) -> ConcurrentSchedule:
    """Rolling-horizon merge for grids beyond the exact-solve ceiling.

    The next window of ops across ALL M requests — window lengths
    proportional to each request's remaining chain, bounded to
    ``window_states`` grid states — is co-scheduled with the exact
    vectorized sweep, and windows are stitched back-to-back.  Each
    stitched schedule is a feasible path of the full progress grid, so
    its cost upper-bounds the exact grid optimum; unlike the pairwise
    merge it keeps ops of *every* request available for co-execution at
    all times instead of serializing disjoint pairs.
    """
    m = len(wls)
    ctx = _GridContext(wls, cm, objective, caches)
    ns = [wl.n for wl in wls]
    done = [0] * m
    steps: list[ConcurrentStep] = []
    energy = 0.0
    while any(done[r] < ns[r] for r in range(m)):
        rem = [ns[r] - done[r] for r in range(m)]
        w = _window_lengths(rem, window_states)
        hi = [done[r] + w[r] for r in range(m)]
        wsteps, weng = ctx.sweep(done, hi)
        steps.extend(wsteps)
        energy += weng
        done = hi
    latency = sum(st.cost for st in steps)
    return ConcurrentSchedule(steps=steps, latency=latency, energy=energy,
                              objective=objective, mode="rolling")


def _solve_concurrent_grid_astar(
    wls: Sequence[Workload], cm: ContentionModel, objective: str,
    group_memo: dict | None = None,
) -> ConcurrentSchedule:
    """Retained heap A* on the M-dimensional progress grid (the
    pre-vectorization implementation, kept as the equivalence oracle for
    the anti-diagonal sweep — ``algorithm="grid_astar"``).

    Same structure as the pair A*: singleton advances use the per-request
    solo edges; subset advances of size >= 2 are priced by the group
    co-execution laws, minimized over all supported PU combinations and
    memoized per (subset, signature-tuple) — the model zoo's repeated
    layer shapes make the memo hit rate high.  The admissible heuristic
    is the per-request scaled suffix bound (max across requests for
    latency — a makespan dominates every request's remaining floor — and
    the sum for energy, which is additive per op).
    """
    m = len(wls)
    denses = [wl.dense for wl in wls]
    ns = [d.n for d in denses]
    solo = [_solo_edges(d, objective) for d in denses]
    _require_all_advanceable(wls, [s[0] for s in solo])
    sigs = [d.sig.tolist() for d in denses]
    sk = [s[0].tolist() for s in solo]
    scale = cm.min_factor()
    sufs = [_suffix_heuristic(d, objective, scale) for d in denses]

    # dense heuristic over the whole grid (<= max_states floats)
    shape = tuple(n + 1 for n in ns)
    if objective == "latency":
        h = np.zeros(shape)
        for r, suf in enumerate(sufs):
            np.maximum(h, suf.reshape([-1 if i == r else 1
                                       for i in range(m)]), out=h)
    else:
        h = sum(suf.reshape([-1 if i == r else 1 for i in range(m)])
                for r, suf in enumerate(sufs))
        h = np.ascontiguousarray(h)
    hs = h.ravel()

    strides = [0] * m
    strides[m - 1] = 1
    for r in range(m - 2, -1, -1):
        strides[r] = strides[r + 1] * shape[r + 1]
    n_states = strides[0] * shape[0]
    target = n_states - 1

    # subset masks, their advancing-request tuples and state deltas
    masks = []
    for bits in range(1, 1 << m):
        reqs = tuple(r for r in range(m) if bits & (1 << r))
        masks.append((bits, reqs, sum(strides[r] for r in reqs)))

    pu_lists = [d.pus for d in denses]
    if group_memo is None:
        group_memo = {}
    obj_idx = 0 if objective == "latency" else 1

    def group_edge(reqs: tuple[int, ...], sig_key: tuple[int, ...]) -> tuple:
        """(key, step_cost, energy, pu-index tuple) minimized over all
        supported PU combos; first minimum in lexicographic PU-index
        order (the M-ary analog of the pair cache's row-major argmin).
        One enumeration computes BOTH objectives' bests — the memo is
        objective-independent, so a shared pool serves a latency solve
        and an energy solve of the same workload tuple."""
        res = group_memo.get((reqs, sig_key))
        if res is not None:
            return res[obj_idx]
        rows = [denses[r].sig_row[s] for r, s in zip(reqs, sig_key)]
        wrows = [denses[r].w[row] for r, row in zip(reqs, rows)]
        prows = [denses[r].power[row] for r, row in zip(reqs, rows)]
        sup = [np.flatnonzero(denses[r].mask[row])
               for r, row in zip(reqs, rows)]
        inf = float("inf")
        best_l = best_e = (inf, inf, inf, None)
        for combo in itertools.product(*sup):
            ts = [float(wr[j]) for wr, j in zip(wrows, combo)]
            pws = [float(pr[j]) for pr, j in zip(prows, combo)]
            pnames = [pu_lists[r][j] for r, j in zip(reqs, combo)]
            step = cm.group_step_cost(ts, pnames)
            e = cm.group_energy(ts, pws, pnames)
            if step < best_l[0]:
                best_l = (step, step, e, combo)
            if e < best_e[0]:
                best_e = (e, step, e, combo)
        group_memo[(reqs, sig_key)] = (best_l, best_e)
        return best_l if obj_idx == 0 else best_e

    # tie plateaus: same quantization + deeper-g tie-break as the pair A*
    c00 = float(hs[0])
    quantum = (c00 if c00 > 0 else 1.0) * (sum(ns) + 64) * 1e-15
    inv_q = 1.0 / quantum

    dist = np.full(n_states, np.inf)
    act = np.zeros(n_states, dtype=np.int32)   # subset bitmask taken
    dist[0] = 0.0
    heap: list[tuple[int, float, int]] = [(int(c00 * inv_q), 0.0, 0)]
    found = False
    while heap:
        fq, ng, s = heapq.heappop(heap)
        g = -ng
        if g > dist[s]:
            continue
        if s == target:
            found = True
            break
        pos = []
        rem = s
        for st in strides:
            q, rem = divmod(rem, st)
            pos.append(q)
        for bits, reqs, delta in masks:
            ok = True
            for r in reqs:
                if pos[r] >= ns[r]:
                    ok = False
                    break
            if not ok:
                continue
            if len(reqs) == 1:
                r = reqs[0]
                key = sk[r][pos[r]]
            else:
                key = group_edge(
                    reqs, tuple(sigs[r][pos[r]] for r in reqs))[0]
                if key == float("inf"):
                    continue
            nd = g + key
            nst = s + delta
            if nd < dist[nst]:
                dist[nst] = nd
                act[nst] = bits
                heapq.heappush(
                    heap, (int((nd + hs[nst]) * inv_q), -nd, nst))
    if not found:  # pragma: no cover - gated by _require_all_advanceable
        raise InfeasibleScheduleError(
            "grid A* exhausted without reaching the all-requests-complete "
            "state (every op passed the per-PU support gate, so this "
            "indicates an internal inconsistency)")

    # reconstruct target -> start
    steps: list[ConcurrentStep] = []
    energy = 0.0
    pos = list(ns)
    s = target
    while s != 0:
        bits = int(act[s])
        if bits == 0:  # pragma: no cover - corrupt predecessor chain
            raise RuntimeError(f"grid A*: no action recorded at {pos}")
        reqs = tuple(r for r in range(m) if bits & (1 << r))
        for r in reqs:
            pos[r] -= 1
        s -= sum(strides[r] for r in reqs)
        ops: list[int | None] = [None] * m
        pus_: list[str | None] = [None] * m
        if len(reqs) == 1:
            r = reqs[0]
            _, sarg, sw, se = solo[r]
            ops[r] = wls[r].chain[pos[r]]
            pus_[r] = pu_lists[r][int(sarg[pos[r]])]
            cost = float(sw[pos[r]])
            energy += float(se[pos[r]])
        else:
            _, cost, e, combo = group_edge(
                reqs, tuple(sigs[r][pos[r]] for r in reqs))
            for r, j in zip(reqs, combo):
                ops[r] = wls[r].chain[pos[r]]
                pus_[r] = pu_lists[r][j]
            energy += e
        steps.append(ConcurrentStep(ops=tuple(ops), pus=tuple(pus_),
                                    cost=cost))
    steps.reverse()
    latency = sum(st.cost for st in steps)
    return ConcurrentSchedule(steps=steps, latency=latency, energy=energy,
                              objective=objective, mode="joint-grid")


def _solve_concurrent_pairwise(
    wls: Sequence[Workload], cm: ContentionModel, objective: str,
    caches: ConcurrentCaches | None = None,
) -> ConcurrentSchedule:
    """Pairwise-merge fallback for M-request co-scheduling.

    Requests are sorted by descending solo-best cost (suffix total of
    each op's best-PU solo cost) and *adjacent* requests pair up — the
    two longest together, then the next two, and so on — because a
    well-overlapped pair's makespan approaches the longer member's solo
    time, so pairing long with long minimizes the serialized total.
    Each pair is co-scheduled with the exact pair A* (or its scalar
    reference under custom contention laws); pairs run back-to-back;
    an odd cheapest request runs solo at the end.  The result is a
    feasible M-ary ``ConcurrentSchedule`` (only ops within a pair
    co-execute) whose cost upper-bounds the exact grid optimum.
    """
    m = len(wls)
    solo_keys = [_solo_edges(wl.dense, objective)[0] for wl in wls]
    # an unadvanceable op would otherwise sort its request first (inf
    # total) and surface later as the pair solver's opaque error
    _require_all_advanceable(wls, solo_keys)
    totals = [float(np.sum(skr)) for skr in solo_keys]
    order = sorted(range(m), key=lambda r: (-totals[r], r))
    steps: list[ConcurrentStep] = []
    latency = 0.0
    energy = 0.0
    for a, b in zip(order[::2], order[1::2]):
        pair = solve_concurrent_joint(
            wls[a].chain, wls[a].table, wls[b].chain, wls[b].table,
            wls[a].pus, cm, objective,
            dense0=wls[a].dense, dense1=wls[b].dense,
            cache=_pair_cache(caches, cm, wls, a, b))
        for st in pair.steps:
            ops: list[int | None] = [None] * m
            pus_: list[str | None] = [None] * m
            ops[a], ops[b] = st.ops
            pus_[a], pus_[b] = st.pus
            steps.append(ConcurrentStep(ops=tuple(ops), pus=tuple(pus_),
                                        cost=st.cost))
        latency += pair.latency
        energy += pair.energy
    if m % 2:
        r = order[-1]
        solo_steps, lat, eng = _solo_step_walk(wls[r], r, m, objective)
        steps.extend(solo_steps)
        latency += lat
        energy += eng
    return ConcurrentSchedule(steps=steps, latency=latency, energy=energy,
                              objective=objective, mode="pairwise")



# ---------------------------------------------------------------------------
# Warm-start incremental re-planning (the serving hot path)
# ---------------------------------------------------------------------------


def solve_concurrent_horizon(
    workloads: Sequence[Workload],
    contention: ContentionModel | None = None,
    objective: str = "latency",
    caches: ConcurrentCaches | None = None,
    horizon_states: int = DEFAULT_HORIZON_STATES,
) -> ConcurrentSchedule:
    """Exact bounded-lookahead *prefix* of a concurrent schedule.

    Co-schedules only the next window of ops across all M requests —
    window lengths proportional to each request's remaining chain,
    bounded to ``horizon_states`` grid states — with the exact
    vectorized sweep, and returns that window (``mode="horizon"``).
    This is the serving engine's bounded-latency re-plan primitive: the
    cost of a re-plan is O(``horizon_states``) regardless of how much
    work remains, so admission never stalls behind a full-grid solve.
    The window is a feasible prefix of a full schedule (every unfinished
    request advances ≥ 1 op); callers execute it and re-plan at the
    window frontier.  Requires the default group co-execution laws
    (custom laws have no windowed exact route — use
    ``solve_concurrent(algorithm="pairwise")``).
    """
    contention = contention or ContentionModel()
    wls = list(workloads)
    m = len(wls)
    if m == 0:
        raise ValueError("solve_concurrent_horizon needs at least one "
                         "workload")
    if horizon_states < 2:
        raise ValueError(
            f"horizon_states must be >= 2 (one advanced op needs a "
            f"2-state axis), got {horizon_states}")
    if m == 1:
        w = _window_lengths([wls[0].n], horizon_states)[0]
        steps, lat, eng = _solo_step_walk(wls[0], 0, 1, objective, 0, w)
        return ConcurrentSchedule(steps=steps, latency=lat, energy=eng,
                                  objective=objective, mode="horizon")
    if not uses_default_group(contention):
        raise ValueError(
            "solve_concurrent_horizon windows the exact grid sweep, which "
            "requires the default group co-execution laws; "
            f"{type(contention).__name__} overrides them — use "
            "solve_concurrent(algorithm='pairwise') for a full solve")
    ctx = _GridContext(wls, contention, objective, caches)
    w = _window_lengths([wl.n for wl in wls], horizon_states)
    steps, energy = ctx.sweep([0] * m, w)
    return ConcurrentSchedule(steps=steps,
                              latency=sum(st.cost for st in steps),
                              energy=energy, objective=objective,
                              mode="horizon")


class _PairCacheView:
    """A parent :class:`~repro_torch.core.contention.PairCostCache` re-exposed
    over tail dense views that carry the *parent's* signature ids
    (``_tail_sig_view``): table lookups by those ids return values
    bitwise-identical to a tail-built cache's, because each entry
    depends only on the signature's row content.  Internal to the warm
    M = 2 re-plan path — the views must never be used to *build* a new
    cache (their ``sig_row`` still indexes parent rows)."""

    def __init__(self, cache: PairCostCache, d0: DenseCostTable,
                 d1: DenseCostTable):
        self._cache = cache
        self.d0 = d0
        self.d1 = d1

    def edge_tables(self, objective: str):
        return self._cache.edge_tables(objective)


def _tail_sig_view(wl: Workload, pos: int) -> Workload:
    """``wl.tail(pos)`` whose dense view keeps the parent's signature
    ids (instead of lazily re-deriving a tail-local alphabet), so the
    parent's signature-indexed edge tables stay directly addressable.
    ``sig_row`` is inherited verbatim and indexes *parent* rows — valid
    for table lookups only, never for building caches from the view."""
    if pos == 0:
        return wl
    tl = wl.tail(pos)
    d, pd = tl.dense, wl.dense
    d._sig = pd.sig[pos:]
    d._sig_row = pd.sig_row
    return tl


class IncrementalConcurrentSolver:
    """Warm-start re-planner for a fixed concurrent workload tuple.

    Built once per (workload tuple, contention model, condition) — the
    orchestrator keeps one per active handle set — it persists the
    per-objective grid contexts (solo edges, signature arrays) and
    shares the content-keyed pair/group edge tables of a
    :class:`ConcurrentCaches` pool, so that every re-plan event of the
    serving lifecycle prices only what changed:

    * **advance** — the remaining sub-box is re-swept on the persistent
      context; no tail views, no ``np.unique`` signature derivation, no
      edge-table builds.
    * **retire** (a member finishes) — the surviving subset's context is
      assembled from the same memoized per-request pieces, and every
      group table over surviving members is a pool hit.
    * **admit** (a new member) — the orchestrator builds a solver for
      the widened tuple; tables over previously-seen members (and over
      re-admitted models, keyed by content) are pool hits, so only
      subsets involving genuinely new content are priced.
    * **condition fold-in** — condition-scaled workloads have new
      content signatures, so their tables re-price exactly once into
      the new condition's pool and every subsequent re-plan under that
      condition is warm again.

    ``solve(progress, objective)`` returns a schedule **bitwise
    identical** to ``solve_concurrent([wl.tail(p) for unfinished], ...)``
    on the same state — same auto routing (solo walk / pair A* /
    grid sweep / rolling merge), same relaxation order, same tie
    policy, same FP accumulation — the cold solver remains the oracle
    (``tests/test_torch_admission.py`` replays random traces against
    it, and against the reference package).  Routes the warm layer
    cannot reproduce bit-for-bit (custom contention laws, the pairwise
    fallback) return ``None`` so callers fall back to the cold solver.
    ``horizon_states`` bounds a re-plan to the next window, mirroring
    :func:`solve_concurrent_horizon`.
    """

    def __init__(self, workloads: Sequence[Workload],
                 contention: ContentionModel | None = None,
                 caches: ConcurrentCaches | None = None,
                 max_states: int | None = None,
                 window_states: int = DEFAULT_WINDOW_STATES):
        self.wls = list(workloads)
        self.m = len(self.wls)
        if self.m == 0:
            raise ValueError("IncrementalConcurrentSolver needs at least "
                             "one workload")
        self.cm = contention or ContentionModel()
        self.caches = caches if caches is not None else ConcurrentCaches()
        self.max_states = (DEFAULT_MAX_STATES if max_states is None
                           else max_states)
        self.window_states = window_states
        self.ns = [wl.n for wl in self.wls]
        self.stats = {"solves": 0, "delegated": 0}
        self._ctx: dict[tuple, _GridContext] = {}
        self._solo: dict[tuple[int, str], tuple] = {}
        self._last_bad: dict[tuple[int, str], int] = {}

    # -- memoized per-request pieces ----------------------------------------
    def _solo_for(self, r: int, objective: str) -> tuple:
        key = (r, objective)
        solo = self._solo.get(key)
        if solo is None:
            solo = _solo_edges(self.wls[r].dense, objective)
            self._solo[key] = solo
        return solo

    def _context(self, active: tuple[int, ...], objective: str
                 ) -> _GridContext:
        key = (active, objective)
        ctx = self._ctx.get(key)
        if ctx is None:
            # feasibility is progress-dependent, so it is checked per
            # solve over the remaining tail (mirroring the cold error),
            # not once over the full chains here
            ctx = _GridContext([self.wls[r] for r in active], self.cm,
                               objective, self.caches,
                               check_advanceable=False)
            self._ctx[key] = ctx
        return ctx

    def _check_tails(self, active: tuple[int, ...], progress: Sequence[int],
                     objective: str) -> None:
        """Per-solve advanceability gate over the remaining tails —
        message-identical to ``_require_all_advanceable`` on the cold
        path's tail workloads (request indices are positions in the
        active tuple; chain positions are tail-relative)."""
        for idx, r in enumerate(active):
            key = (r, objective)
            last = self._last_bad.get(key)
            if last is None:
                bad = ~np.isfinite(np.asarray(self._solo_for(r, objective)[0]))
                last = int(bad.nonzero()[0][-1]) if bad.any() else -1
                self._last_bad[key] = last
            p = progress[r]
            if last >= p:
                skey = np.asarray(self._solo_for(r, objective)[0])
                pos = int(np.argmax(~np.isfinite(skey[p:])))
                raise InfeasibleScheduleError(
                    f"request {idx}: {self.wls[r].op_name(p + pos)} at "
                    f"chain position {pos} is unsupported on every PU — "
                    "no concurrent transition can advance it")

    def _tail_n_sig(self, r: int, p: int) -> int:
        return int(np.unique(self.wls[r].dense.sig[p:]).size)

    # -- solve routes --------------------------------------------------------
    def _solo_tail(self, r: int, lo: int, hi: int | None, objective: str,
                   mode: str) -> ConcurrentSchedule:
        steps, lat, eng = _solo_step_walk(self.wls[r], 0, 1, objective,
                                          lo, hi,
                                          solo=self._solo_for(r, objective))
        return ConcurrentSchedule(steps=steps, latency=lat, energy=eng,
                                  objective=objective, mode=mode)

    def _solve_pair(self, active: tuple[int, ...], progress: Sequence[int],
                    objective: str) -> ConcurrentSchedule:
        a, b = active
        wa, wb = self.wls[a], self.wls[b]
        pa, pb = progress[a], progress[b]
        base = _pair_cache(self.caches, self.cm, self.wls, a, b)
        ta, tb = _tail_sig_view(wa, pa), _tail_sig_view(wb, pb)
        cache = (base if pa == 0 and pb == 0
                 else _PairCacheView(base, ta.dense, tb.dense))
        return solve_concurrent_joint(
            ta.chain, ta.table, tb.chain, tb.table, wa.pus, self.cm,
            objective, algorithm="astar", cache=cache)

    def _sweep_box(self, active: tuple[int, ...], progress: Sequence[int],
                   hi: Sequence[int], objective: str, mode: str
                   ) -> ConcurrentSchedule:
        ctx = self._context(active, objective)
        steps, energy = ctx.sweep([progress[r] for r in active], hi)
        return ConcurrentSchedule(steps=steps,
                                  latency=sum(st.cost for st in steps),
                                  energy=energy, objective=objective,
                                  mode=mode)

    def _solve_rolling(self, active: tuple[int, ...],
                       progress: Sequence[int], objective: str
                       ) -> ConcurrentSchedule:
        ctx = self._context(active, objective)
        budget = min(self.window_states, self.max_states)
        ns = [self.ns[r] for r in active]
        done = [progress[r] for r in active]
        steps: list[ConcurrentStep] = []
        energy = 0.0
        while any(d < n for d, n in zip(done, ns)):
            rem = [n - d for d, n in zip(done, ns)]
            w = _window_lengths(rem, budget)
            hi = [d + wi for d, wi in zip(done, w)]
            wsteps, weng = ctx.sweep(done, hi)
            steps.extend(wsteps)
            energy += weng
            done = hi
        return ConcurrentSchedule(steps=steps,
                                  latency=sum(st.cost for st in steps),
                                  energy=energy, objective=objective,
                                  mode="rolling")

    def solve(self, progress: Sequence[int], objective: str = "latency",
              horizon_states: int | None = None) -> ConcurrentSchedule | None:
        """Warm re-plan from ``progress`` (completed-op count per
        request; fully-advanced requests drop out of the schedule, whose
        step tuples cover only the unfinished ones, exactly like the
        cold path's active-set filtering).  Returns ``None`` when the
        state routes to a path the warm layer cannot reproduce bitwise
        (custom contention laws / pairwise) — fall back to
        :func:`solve_concurrent`."""
        progress = list(progress)
        if len(progress) != self.m:
            raise ValueError(
                f"progress has {len(progress)} entries for {self.m} "
                "workloads")
        for r, (p, n) in enumerate(zip(progress, self.ns)):
            if not 0 <= p <= n:
                raise ValueError(
                    f"request {r}: progress {p} outside [0, {n}]")
        active = tuple(r for r in range(self.m) if progress[r] < self.ns[r])
        if not active:
            raise ValueError("solve: every request is fully advanced — "
                             "nothing left to schedule")
        if horizon_states is not None:
            return self._solve_horizon(active, progress, objective,
                                       horizon_states)
        if len(active) == 1:
            self.stats["solves"] += 1
            return self._solo_tail(active[0], progress[active[0]], None,
                                   objective, "joint")
        if not uses_default_coexec(self.cm):
            self.stats["delegated"] += 1
            return None
        if len(active) == 2:
            self.stats["solves"] += 1
            return self._solve_pair(active, progress, objective)
        if not uses_default_group(self.cm):
            self.stats["delegated"] += 1
            return None
        rem = [self.ns[r] - progress[r] for r in active]
        n_states = math.prod(x + 1 for x in rem)
        if n_states <= self.max_states:
            self._check_tails(active, progress, objective)
            self.stats["solves"] += 1
            return self._sweep_box(active, progress,
                                   [self.ns[r] for r in active],
                                   objective, "joint-grid")
        sig_states = math.prod(self._tail_n_sig(r, progress[r])
                               for r in active)
        if sig_states <= _ROLLING_TABLE_CAP:
            self._check_tails(active, progress, objective)
            self.stats["solves"] += 1
            return self._solve_rolling(active, progress, objective)
        self.stats["delegated"] += 1
        return None

    def _solve_horizon(self, active: tuple[int, ...],
                       progress: Sequence[int], objective: str,
                       horizon_states: int) -> ConcurrentSchedule | None:
        if horizon_states < 2:
            raise ValueError(
                f"horizon_states must be >= 2 (one advanced op needs a "
                f"2-state axis), got {horizon_states}")
        if len(active) == 1:
            r = active[0]
            p = progress[r]
            w = _window_lengths([self.ns[r] - p], horizon_states)[0]
            self.stats["solves"] += 1
            return self._solo_tail(r, p, p + w, objective, "horizon")
        if not uses_default_group(self.cm):
            self.stats["delegated"] += 1
            return None      # cold solve_concurrent_horizon raises for this
        self._check_tails(active, progress, objective)
        rem = [self.ns[r] - progress[r] for r in active]
        w = _window_lengths(rem, horizon_states)
        hi = [progress[r] + wi for r, wi in zip(active, w)]
        self.stats["solves"] += 1
        return self._sweep_box(active, progress, hi, objective, "horizon")
