"""Execution-graph builder (Algorithm 1, Stage 2).

Encodes the operator->PU mapping problem as a weighted directed graph:

* node ``v_{i,j}`` = execute fused op ``O_i`` on PU ``P_j``; weight =
  dispatch + kernel time of ``O_i`` on ``P_j`` (energy mode: ``w x p``).
* edge ``v_{i,j} -> v_{i+1,k}``: 0 if ``j == k``; otherwise the profiled
  PU-transition (H2D/D2H) cost.
* virtual ``s`` / ``t`` nodes carry the initial H2D and final D2H costs.

The graph is an explicit object (not just the DP recurrence) so that the
shortest-path reduction in the paper is directly visible and testable:
``search.dijkstra`` on this graph must equal ``search.sequential_dp``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np

from .costmodel import CostTable, DenseCostTable, PUSpec, transition_cost
from .op import FusedOp, OpGraph

Objective = str  # "latency" | "energy"


def node_weight(entry, objective: Objective) -> float:
    if objective == "latency":
        return entry.w
    if objective == "energy":
        return entry.w * entry.power
    raise ValueError(f"unknown objective {objective!r}")


@dataclasses.dataclass
class ExecGraph:
    """Explicit weighted digraph over (op, PU) states, plus s/t."""

    # node ids: 0 = s, 1 = t, then 2 + i*K + j for (op i, pu j) among
    # *supported* pairs (unsupported pairs get no node — paper §3.1).
    n_ops: int
    pus: list[str]
    node_ids: dict[tuple[int, str], int]
    node_w: dict[int, float]
    adj: dict[int, list[tuple[int, float]]]  # u -> [(v, edge_weight)]
    S: int = 0
    T: int = 1

    def nodes(self) -> int:
        return 2 + len(self.node_ids)


def build_sequential_graph(
    chain: Sequence[int],
    ops: Sequence[FusedOp],
    table: CostTable,
    pus: Mapping[str, PUSpec],
    objective: Objective = "latency",
) -> ExecGraph:
    """Build the sequential execution graph for a chain of op indices.

    ``chain`` lists op indices (into ``ops``) forming a linear dependency
    chain O_1 -> ... -> O_N.
    """
    pu_names = list(table.pus)
    node_ids: dict[tuple[int, str], int] = {}
    node_w: dict[int, float] = {}
    adj: dict[int, list[tuple[int, float]]] = {0: [], 1: []}

    nid = 2
    for pos, oi in enumerate(chain):
        sup = table.supported_pus(oi)
        if not sup:
            raise ValueError(f"op {oi} ({ops[oi].name}) unsupported on all PUs")
        for p in sup:
            node_ids[(pos, p)] = nid
            e = table.require(oi, p)
            node_w[nid] = node_weight(e, objective)
            adj[nid] = []
            nid += 1

    def energy_scale(pu: str) -> float:
        # transition edges consume time on the interconnect/host; in energy
        # mode we charge them at the destination PU's memory-bound power.
        return pus[pu].power_memory if objective == "energy" else 1.0

    # s -> first op nodes: H2D cost of O_1 on P_j (zero for CPU/host).
    first = chain[0]
    for p in table.supported_pus(first):
        w = table.require(first, p).h2d * energy_scale(p)
        adj[0].append((node_ids[(0, p)], w))

    # consecutive ops, all PU pairs
    for pos in range(len(chain) - 1):
        oi, oj = chain[pos], chain[pos + 1]
        for pj in table.supported_pus(oi):
            u = node_ids[(pos, pj)]
            for pk in table.supported_pus(oj):
                v = node_ids[(pos + 1, pk)]
                tc = transition_cost(pus, table, oi, pj, oj, pk)
                adj[u].append((v, tc * energy_scale(pk)))

    # last op nodes -> t: D2H cost of O_N on P_j
    lastpos = len(chain) - 1
    last = chain[lastpos]
    for p in table.supported_pus(last):
        u = node_ids[(lastpos, p)]
        w = table.require(last, p).d2h * energy_scale(p)
        adj[u].append((1, w))

    return ExecGraph(n_ops=len(chain), pus=pu_names, node_ids=node_ids,
                     node_w=node_w, adj=adj)


# ---------------------------------------------------------------------------
# Dense (implicit) execution graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DenseChain:
    """Array view of the sequential execution graph (no explicit nodes).

    Same semantics as ``build_sequential_graph`` — node weights, the
    s->first H2D edges, the last->t D2H edges, and the per-position
    ``(K, K)`` transition matrices — but held as NumPy arrays so the DP
    recurrence is one matrix op per chain position.  ``transition(pos)``
    returns ``T[k, j]`` = cost of moving from (op ``pos-1``, PU ``k``) to
    (op ``pos``, PU ``j``), energy-scaled exactly like the explicit graph's
    edges.
    """

    dense: DenseCostTable
    objective: Objective
    esc: np.ndarray        # (K,) transition energy scale (1.0 in latency mode)
    node_w: np.ndarray     # (N, K) node weights; inf where unsupported
    entry_w: np.ndarray    # (K,) s -> (op 0, PU j) edge weights
    exit_w: np.ndarray     # (K,) (op N-1, PU j) -> t edge weights
    _trans: np.ndarray | None = None

    def transitions(self) -> np.ndarray:
        """All ``(N-1, K, K)`` transition matrices, built in one batched op.

        ``transitions()[p][k][j]`` = cost of moving from (op ``p``, PU
        ``k``) to (op ``p+1``, PU ``j``): same PU -> 0; otherwise the
        accelerator-gated H2D of the next op plus D2H of the previous op,
        energy-scaled by the destination PU exactly like the explicit
        graph's edges.
        """
        if self._trans is None:
            d = self.dense
            h2d_next = np.where(d.acc, d.h2d, 0.0)[1:]       # (N-1, K)
            d2h_prev = np.where(d.acc, d.d2h, 0.0)[:-1]      # (N-1, K)
            t = ((h2d_next[:, None, :] + d2h_prev[:, :, None])
                 * self.esc[None, None, :])
            k = d.k
            t[:, np.arange(k), np.arange(k)] = 0.0
            self._trans = t
        return self._trans

    def transition(self, pos: int) -> np.ndarray:
        """(K, K) transition-cost matrix into chain position ``pos``."""
        return self.transitions()[pos - 1]


def build_dense_chain(
    chain: Sequence[int],
    ops: Sequence[FusedOp],
    table: CostTable,
    pus: Mapping[str, PUSpec],
    objective: Objective = "latency",
    dense: DenseCostTable | None = None,
) -> DenseChain:
    """Dense equivalent of ``build_sequential_graph``."""
    d = dense if dense is not None else DenseCostTable.from_chain(chain, table, pus)
    for pos, oi in enumerate(chain):
        if not d.mask[pos].any():
            raise ValueError(f"op {oi} ({ops[oi].name}) unsupported on all PUs")
    if objective == "latency":
        esc = np.ones(d.k)
        node_w = d.w
    elif objective == "energy":
        esc = np.array([pus[p].power_memory for p in d.pus])
        node_w = d.energy
    else:
        raise ValueError(f"unknown objective {objective!r}")
    # boundary edges are NOT accelerator-gated (matches the explicit graph)
    entry_w = d.h2d[0] * esc
    exit_w = d.d2h[-1] * esc
    return DenseChain(dense=d, objective=objective, esc=esc, node_w=node_w,
                      entry_w=entry_w, exit_w=exit_w)
