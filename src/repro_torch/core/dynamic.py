"""Dynamic operator-level scheduling + intra-PU tile mapping.

A NumPy copy of ``repro.core.dynamic`` (the paper's §6 Future Work):

1. **Dynamic scheduling** — BIDENT's static schedule is optimal for the
   profiled costs, but "thermal throttling reduces PU throughput,
   concurrent system processes compete for memory bandwidth" (§6).
   ``DynamicScheduler`` keeps the offline cost table, folds in a
   lightweight runtime *condition* (per-PU throughput multipliers from
   monitoring), and re-runs the shortest-path search from the next
   unexecuted operator when conditions drift beyond a hysteresis
   threshold.  ``RuntimeCondition`` is also how the orchestrator folds a
   lost lane (``lose``) and a returned one (``restore``) into planning.

2. **Tile-level mapping** — ``tile_split`` splits a tiled PU between two
   co-scheduled operators by compute- vs memory-boundedness, the
   paper's proposed allocator.

Remaps, stitched plans and ``simulate`` are bitwise the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

from .costmodel import CostEntry, CostTable, PUSpec
from .errors import InfeasibleScheduleError
from .op import FusedOp
from .schedule import SeqSchedule
from .search import solve_sequential
from .workload import Workload


# ---------------------------------------------------------------------------
# runtime conditions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RuntimeCondition:
    """Per-PU throughput multipliers from runtime monitoring.

    slowdown[pu] = 1.0 means nominal; 2.0 means ops on that PU currently
    take twice their profiled time (thermal throttling, a co-resident
    process, bandwidth pressure).  ``unavailable`` PUs are dropped from
    the table entirely (the paper's compile-failure semantics applied at
    runtime — e.g. a PU claimed by another tenant).
    """

    slowdown: Mapping[str, float] = dataclasses.field(default_factory=dict)
    unavailable: frozenset[str] = frozenset()

    def factor(self, pu: str) -> float:
        return float(self.slowdown.get(pu, 1.0))

    def key(self, pus: Iterable[str]) -> tuple[tuple[str, float | None], ...]:
        """Canonical per-PU scaling tuple over ``pus``: ``(name, factor)``
        with ``None`` marking an unavailable PU.  Two conditions with
        equal keys price every workload identically, which is what the
        orchestrator keys its plan cache on (and diffs to decide which
        PUs' cached plans to invalidate)."""
        return tuple((p, None if p in self.unavailable else self.factor(p))
                     for p in sorted(pus))

    @property
    def nominal(self) -> bool:
        return not self.unavailable and all(
            float(f) == 1.0 for f in self.slowdown.values())

    def lose(self, *pus: str) -> "RuntimeCondition":
        """This condition with ``pus`` additionally unavailable — how a
        permanent mid-run PU loss folds into the session condition
        (``Orchestrator`` recovery: re-plan the remaining ops on the
        surviving PUs)."""
        return RuntimeCondition(
            slowdown=dict(self.slowdown),
            unavailable=frozenset(self.unavailable) | set(pus))

    def restore(self, *pus: str) -> "RuntimeCondition":
        """This condition with ``pus`` available again (and any slowdown
        override on them dropped) — the inverse of :meth:`lose`, how a
        half-open circuit-breaker probe re-admits a quarantined PU into
        the planning table (:mod:`repro_torch.core.health`)."""
        back = set(pus)
        return RuntimeCondition(
            slowdown={p: f for p, f in self.slowdown.items()
                      if p not in back},
            unavailable=frozenset(self.unavailable) - back)


# InfeasibleScheduleError lives in ``errors`` (``dynamic`` imports
# ``search``, so ``search`` cannot import us); re-exported here as the
# reference does.
__all__ = ["DynamicScheduler", "RuntimeCondition", "InfeasibleScheduleError",
           "RemapEvent", "adjusted_table"]


def adjusted_table(table: CostTable, cond: RuntimeCondition) -> CostTable:
    """Scalar cost table under a runtime condition.

    Oracle/compat helper only: the ``DynamicScheduler`` hot path applies
    conditions as per-PU column scalings on the dense ``Workload`` view
    (``Workload.under_condition``) and never rebuilds a dict table."""
    out = CostTable(list(table.pus))
    for (oi, pu), e in table.items():
        if pu in cond.unavailable:
            continue
        f = cond.factor(pu)
        out.set(oi, pu, CostEntry(kernel=e.kernel * f, dispatch=e.dispatch,
                                  h2d=e.h2d, d2h=e.d2h, power=e.power))
    return out


# ---------------------------------------------------------------------------
# dynamic scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RemapEvent:
    at_op: int                    # chain position where remapping happened
    reason: str
    old_tail_cost: float          # predicted cost of keeping the old plan
    new_tail_cost: float          # predicted cost of the re-planned tail


class DynamicScheduler:
    """Executes a chain op-by-op, re-planning the *tail* when runtime
    conditions drift.

    Hysteresis: re-plan only when the predicted tail improvement exceeds
    ``replan_threshold`` (relative), so monitoring noise doesn't thrash
    the schedule — the paper's requirement that remapping overhead "not
    negate the latency benefit".

    Runs entirely on the dense ``Workload`` layer: a runtime condition is
    applied as per-PU column scalings on the ``(N, K)`` views
    (``Workload.under_condition``) — O(K) column rescales instead of the
    old per-``on_condition`` dict-table rebuild — and tail evaluation /
    re-planning consume row-sliced views of the same arrays.
    """

    def __init__(self, chain: Sequence[int], ops: Sequence[FusedOp],
                 table: CostTable | None, pus: Mapping[str, PUSpec],
                 objective: str = "latency",
                 replan_threshold: float = 0.05,
                 workload: Workload | None = None):
        if table is None and workload is None:
            raise ValueError(
                "DynamicScheduler needs a CostTable or a prebuilt Workload")
        self.chain = list(chain)
        self.ops = ops
        self.base_table = table
        self.pus = pus
        self.objective = objective
        self.threshold = replan_threshold
        self.workload = workload if workload is not None else Workload.build(
            chain, table, pus, ops=ops)
        self.plan = solve_sequential(self.chain, ops, table, pus, objective,
                                     workload=self.workload)
        self.events: list[RemapEvent] = []

    def _adjusted(self, cond: RuntimeCondition) -> Workload:
        return self.workload.under_condition(cond.slowdown, cond.unavailable)

    def tail_cost(self, pos: int, assignment: Sequence[str],
                  wl: Workload) -> float:
        """Cost of executing chain[pos:] under ``assignment`` and the
        (condition-adjusted) workload ``wl``; +inf when the kept
        assignment is infeasible (e.g. an unavailable PU)."""
        if pos >= len(self.chain):
            return 0.0
        lat, eng = wl.tail(pos).evaluate(list(assignment[pos:]),
                                         allow_infeasible=True)
        return lat if self.objective == "latency" else eng

    def on_condition(self, pos: int, cond: RuntimeCondition,
                     wl_adj: Workload | None = None) -> SeqSchedule:
        """Called between ops: re-plan chain[pos:] if conditions warrant.

        A re-planned schedule carries *real* latency/energy: the stitched
        assignment is re-evaluated on a spliced workload — the
        already-executed prefix priced at the nominal profile, the new
        tail under the current condition — so downstream consumers never
        see NaN placeholders.  Pass ``wl_adj`` to reuse an
        already-adjusted workload for ``cond``.
        """
        if wl_adj is None:
            wl_adj = self._adjusted(cond)
        keep = self.tail_cost(pos, self.plan.assignment, wl_adj)
        tail = self.chain[pos:]
        if not tail:
            return self.plan
        tail_wl = wl_adj.tail(pos)
        try:
            replanned = solve_sequential(tail, self.ops, None, self.pus,
                                         self.objective, workload=tail_wl)
        except ValueError as err:
            raise InfeasibleScheduleError(
                f"re-planning chain[{pos}:] is infeasible under the active "
                f"runtime condition (slowdown={dict(cond.slowdown)}, "
                f"unavailable={sorted(cond.unavailable)}): {err}") from err
        new_cost = (replanned.latency if self.objective == "latency"
                    else replanned.energy)
        if keep == float("inf") or new_cost < keep * (1 - self.threshold):
            self.events.append(RemapEvent(
                at_op=pos,
                reason="unavailable PU" if keep == float("inf")
                else "condition drift",
                old_tail_cost=keep, new_tail_cost=new_cost))
            stitched = (list(self.plan.assignment[:pos])
                        + list(replanned.assignment))
            lat, eng = self.workload.spliced(wl_adj, pos).evaluate(stitched)
            self.plan = SeqSchedule(
                chain=self.chain, assignment=stitched,
                latency=lat, energy=eng, objective=self.objective)
        return self.plan

    def simulate(self, conditions: Mapping[int, RuntimeCondition]) -> float:
        """Execute the whole chain, applying ``conditions[pos]`` when
        reached; returns realised latency (ops run under the condition
        active at their position).

        Raises :class:`InfeasibleScheduleError` (not a bare
        ``IndexError``) when an op has no supported PU under the active
        condition.
        """
        cond = RuntimeCondition()
        wl = self.workload
        d = wl.dense
        total = 0.0
        for pos in range(len(self.chain)):
            if pos in conditions:
                cond = conditions[pos]
                wl = self._adjusted(cond)
                self.on_condition(pos, cond, wl_adj=wl)
                d = wl.dense
            pu = self.plan.assignment[pos]
            j = wl.col(pu)
            if not d.mask[pos, j]:
                raise InfeasibleScheduleError(
                    f"{wl.op_name(pos)} at position {pos} cannot run on "
                    f"{pu} under the active runtime condition "
                    f"(slowdown={dict(cond.slowdown)}, "
                    f"unavailable={sorted(cond.unavailable)})")
            total += float(d.w[pos, j])
            if pos + 1 < len(self.chain):
                jn = wl.col(self.plan.assignment[pos + 1])
                if not d.mask[pos + 1, jn]:
                    sup = np.flatnonzero(d.mask[pos + 1])
                    if len(sup) == 0:
                        raise InfeasibleScheduleError(
                            f"{wl.op_name(pos + 1)} at position {pos + 1} "
                            f"has no supported PU under the active runtime "
                            f"condition (slowdown={dict(cond.slowdown)}, "
                            f"unavailable={sorted(cond.unavailable)}) — "
                            "the schedule cannot make progress")
                    jn = int(sup[0])
                # transition: accelerator-gated H2D of next + D2H of prev
                if jn != j:
                    total += ((float(d.h2d[pos + 1, jn]) if d.acc[jn] else 0.0)
                              + (float(d.d2h[pos, j]) if d.acc[j] else 0.0))
        return total


# ---------------------------------------------------------------------------
# intra-PU tile-level mapping (paper §6, second item)
# ---------------------------------------------------------------------------


def ridge_intensity(pu: PUSpec, dtype_bytes: int = 2) -> float:
    """Roofline ridge point of a PU: FLOPs/byte where compute == memory."""
    return pu.peak_gemm.get(dtype_bytes, pu.peak_gemm[2]) / pu.mem_bw


def tile_split(op_a: FusedOp, op_b: FusedOp, pu: PUSpec,
               n_tiles: int = 6) -> tuple[int, int, float]:
    """Split a tiled PU between two data-independent operators.

    Ops *below* the ridge point (memory-bound) gain little from extra
    tiles (bandwidth is shared); compute-bound ops scale with tiles.
    Returns (tiles_a, tiles_b, makespan) minimizing the pair makespan
    over all integer splits, with:

      t(op, k) = max(flops/(peak * k/n_tiles), bytes/mem_bw)

    i.e. compute scales with the tile share, the shared memory system
    does not — exactly the paper's proposed allocation rule.
    """
    def t(op: FusedOp, k: int) -> float:
        if k == 0:
            return float("inf")
        eff = pu.kind_eff.get(op.kind, pu.kind_eff["other"])
        peak = pu.peak_gemm.get(op.dtype_bytes, pu.peak_gemm[2]) * eff
        t_compute = op.flops / (peak * k / n_tiles)
        t_memory = op.bytes_moved / pu.mem_bw
        return max(t_compute, t_memory)

    best = None
    for ka in range(1, n_tiles):
        mk = max(t(op_a, ka), t(op_b, n_tiles - ka))
        if best is None or mk < best[2]:
            best = (ka, n_tiles - ka, mk)
    return best
