"""Search engine (Algorithm 1, Stage 3): the sequential solvers.

A copy of the chain part of ``repro.core.search``; the concurrent, DAG
and incremental solvers are not ported yet (``ROADMAP.md``).

* ``dijkstra`` — textbook Dijkstra over the explicit execution graph
  (node-weighted; node weights folded into incoming edges).
* ``sequential_dp`` — the O(N K^2) topological-order recurrence (Eq. 1),
  vectorized to one NumPy matrix op per chain position over the dense
  ``(K, K)`` transition matrix (``graph.DenseChain``).  The scalar
  reference (``sequential_dp_reference``) is kept; tests assert both give
  bit-identical costs and assignments, and both equal ``dijkstra``.
* ``solve_sequential`` — the front door over the dense ``Workload``.
"""
from __future__ import annotations

import heapq
from typing import Mapping, Sequence

import numpy as np

from .costmodel import CostTable, DenseCostTable, PUSpec, transition_cost
from .graph import (ExecGraph, build_dense_chain, build_sequential_graph,
                    node_weight)
from .op import FusedOp
from .schedule import SeqSchedule
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
