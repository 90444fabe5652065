"""Schedule objects + cost accounting.

A ``Schedule`` is the static output of the search engine (paper §3.4: "The
output schedule is a static mapping that is applied directly by the
execution orchestrator").  ``evaluate_*`` re-derives latency and energy for
a *fixed* assignment, so that e.g. the energy of a latency-optimised
schedule can be compared against the energy-optimised one (paper Fig. 6).

Evaluation runs on the dense ``Workload`` layer (one gather over the
``(N, K)`` arrays); the scalar dict walk is retained as
``evaluate_sequential_reference`` for the equivalence suite.

``schedule_to_dict`` / ``schedule_from_dict`` give every schedule kind a
lossless JSON-able form (floats survive ``json`` round-trips bitwise via
``repr`` shortest-round-trip printing) — the serialization layer behind
``orchestrator.Plan.to_json``/``from_json``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from .costmodel import CostTable, PUSpec, transition_cost
from .op import FusedOp
from .workload import Workload


@dataclasses.dataclass
class SeqSchedule:
    """Sequential schedule: one PU per op along a chain."""

    chain: list[int]               # op indices
    assignment: list[str]          # PU per chain position
    latency: float
    energy: float
    objective: str

    def pu_of(self, op_idx: int) -> str:
        return self.assignment[self.chain.index(op_idx)]


@dataclasses.dataclass
class BranchSchedule:
    branch_ops: list[int]
    assignment: list[str]
    solo_latency: float            # before contention adjustment
    adj_latency: float             # after SF adjustment
    energy: float


@dataclasses.dataclass
class PhaseSchedule:
    index: int
    parallel: bool                 # whether branches co-execute
    branches: list[BranchSchedule]
    makespan: float
    energy: float


@dataclasses.dataclass
class ParallelSchedule:
    phases: list[PhaseSchedule]
    latency: float
    energy: float
    objective: str

    @property
    def assignment(self) -> dict[int, str]:
        out: dict[int, str] = {}
        for ph in self.phases:
            for br in ph.branches:
                for o, p in zip(br.branch_ops, br.assignment):
                    out[o] = p
        return out

    @property
    def n_concurrent_phases(self) -> int:
        return sum(1 for ph in self.phases if ph.parallel and len(ph.branches) > 1)


@dataclasses.dataclass
class ConcurrentStep:
    """One step of an M-request concurrent schedule.

    ``ops[r]`` / ``pus[r]`` give request ``r``'s op index and PU for this
    step, or ``None`` when request ``r`` does not advance.  The original
    two-request solvers emit 2-tuples; the M-ary solvers emit M-tuples.
    """

    ops: tuple[int | None, ...]   # op index per request (None = idle)
    pus: tuple[str | None, ...]
    cost: float


@dataclasses.dataclass
class ConcurrentSchedule:
    steps: list[ConcurrentStep]
    latency: float
    energy: float
    objective: str
    mode: str  # "aligned" | "joint" | "joint-grid" | "rolling" | "pairwise"

    @property
    def n_requests(self) -> int:
        return len(self.steps[0].ops) if self.steps else 0

    def assignment_of(self, request: int) -> list[tuple[int, str]]:
        out = []
        for st in self.steps:
            if st.ops[request] is not None:
                out.append((st.ops[request], st.pus[request]))
        return out


@dataclasses.dataclass(slots=True)
class DagStep:
    """One step of a DAG (antichain-frontier) schedule.

    ``ops`` is the antichain of DAG node indices advanced this step —
    mutually independent ops, all of whose predecessors completed in
    earlier steps.  ``pus[j]`` is the PU running ``ops[j]``.  A singleton
    step is ordinary sequential progress; a multi-op step co-executes its
    ops under the contention model (the paper's intra-model parallelism).
    """

    ops: tuple[int, ...]           # DAG node indices (len >= 1, no None)
    pus: tuple[str, ...]           # PU per op
    cost: float


@dataclasses.dataclass
class DagSchedule:
    """Static schedule over an op DAG: a sequence of antichain steps whose
    union, in order, is a topological linear extension of the DAG."""

    steps: list[DagStep]
    latency: float
    energy: float
    objective: str
    mode: str  # "chain" | "union-grid" | "phase" | "frontier"

    @property
    def assignment(self) -> dict[int, str]:
        out: dict[int, str] = {}
        for st in self.steps:
            for o, p in zip(st.ops, st.pus):
                out[o] = p
        return out

    @property
    def order(self) -> list[int]:
        """Node completion order (a linear extension of the DAG)."""
        return [o for st in self.steps for o in st.ops]

    @property
    def n_parallel_steps(self) -> int:
        return sum(1 for st in self.steps if len(st.ops) > 1)


# ---------------------------------------------------------------------------
# Fixed-assignment evaluation (dense Workload layer)
# ---------------------------------------------------------------------------


def evaluate_sequential(
    chain: Sequence[int],
    assignment: Sequence[str],
    ops: Sequence[FusedOp],
    table: CostTable,
    pus: Mapping[str, PUSpec],
    workload: Workload | None = None,
) -> tuple[float, float]:
    """(latency, energy) of a fixed sequential assignment, including the
    boundary H2D/D2H and inter-op transition costs of the execution graph.

    Runs as one dense gather on the ``Workload`` view; pass ``workload``
    to reuse a prebuilt one (otherwise the scalar table is ingested once
    per call)."""
    wl = workload if workload is not None else Workload.build(
        chain, table, pus, ops=ops)
    return wl.evaluate(assignment)


def evaluate_sequential_reference(
    chain: Sequence[int],
    assignment: Sequence[str],
    ops: Sequence[FusedOp],
    table: CostTable,
    pus: Mapping[str, PUSpec],
) -> tuple[float, float]:
    """Scalar dict-walk evaluation (pre-Workload oracle, kept for the
    equivalence regression suite)."""
    assert len(chain) == len(assignment)
    lat = 0.0
    eng = 0.0
    first, last = chain[0], chain[-1]
    e0 = table.require(first, assignment[0])
    lat += e0.h2d
    eng += e0.h2d * pus[assignment[0]].power_memory
    for pos, (oi, p) in enumerate(zip(chain, assignment)):
        e = table.require(oi, p)
        lat += e.w
        eng += e.w * e.power
        if pos + 1 < len(chain):
            oj, pk = chain[pos + 1], assignment[pos + 1]
            tc = transition_cost(pus, table, oi, p, oj, pk)
            lat += tc
            eng += tc * pus[pk].power_memory
    eN = table.require(last, assignment[-1])
    lat += eN.d2h
    eng += eN.d2h * pus[assignment[-1]].power_memory
    return lat, eng


def single_pu_cost(
    chain: Sequence[int],
    pu: str,
    ops: Sequence[FusedOp],
    table: CostTable,
    pus: Mapping[str, PUSpec],
    workload: Workload | None = None,
) -> tuple[float, float] | None:
    """(latency, energy) of monolithic execution on one PU; None if any op
    is unsupported there (the paper's compile-failure case)."""
    wl = workload if workload is not None else Workload.build(
        chain, table, pus, ops=ops)
    return wl.single_pu(pu)


# ---------------------------------------------------------------------------
# Lossless (de)serialization of every schedule kind
# ---------------------------------------------------------------------------


AnySchedule = SeqSchedule | ParallelSchedule | ConcurrentSchedule | DagSchedule


def schedule_to_dict(s: AnySchedule) -> dict:
    """JSON-able dict of any schedule kind, tagged with ``"type"``.

    The inverse ``schedule_from_dict`` reconstructs an ``==``-equal
    schedule: every float survives a JSON round-trip bitwise and every
    tuple/list shape is restored exactly.
    """
    if isinstance(s, SeqSchedule):
        return {"type": "sequential", "chain": list(s.chain),
                "assignment": list(s.assignment), "latency": s.latency,
                "energy": s.energy, "objective": s.objective}
    if isinstance(s, ParallelSchedule):
        return {
            "type": "parallel", "latency": s.latency, "energy": s.energy,
            "objective": s.objective,
            "phases": [{
                "index": ph.index, "parallel": ph.parallel,
                "makespan": ph.makespan, "energy": ph.energy,
                "branches": [{
                    "branch_ops": list(b.branch_ops),
                    "assignment": list(b.assignment),
                    "solo_latency": b.solo_latency,
                    "adj_latency": b.adj_latency, "energy": b.energy,
                } for b in ph.branches],
            } for ph in s.phases],
        }
    if isinstance(s, ConcurrentSchedule):
        return {"type": "concurrent", "latency": s.latency,
                "energy": s.energy, "objective": s.objective, "mode": s.mode,
                "steps": [{"ops": list(st.ops), "pus": list(st.pus),
                           "cost": st.cost} for st in s.steps]}
    if isinstance(s, DagSchedule):
        return {"type": "dag", "latency": s.latency, "energy": s.energy,
                "objective": s.objective, "mode": s.mode,
                "steps": [{"ops": list(st.ops), "pus": list(st.pus),
                           "cost": st.cost} for st in s.steps]}
    raise TypeError(f"not a schedule: {type(s).__name__}")


def schedule_from_dict(d: Mapping) -> AnySchedule:
    """Rebuild the schedule serialized by :func:`schedule_to_dict`."""
    kind = d.get("type")
    if kind == "sequential":
        return SeqSchedule(chain=list(d["chain"]),
                           assignment=list(d["assignment"]),
                           latency=d["latency"], energy=d["energy"],
                           objective=d["objective"])
    if kind == "parallel":
        return ParallelSchedule(
            phases=[PhaseSchedule(
                index=ph["index"], parallel=ph["parallel"],
                makespan=ph["makespan"], energy=ph["energy"],
                branches=[BranchSchedule(
                    branch_ops=list(b["branch_ops"]),
                    assignment=list(b["assignment"]),
                    solo_latency=b["solo_latency"],
                    adj_latency=b["adj_latency"], energy=b["energy"],
                ) for b in ph["branches"]],
            ) for ph in d["phases"]],
            latency=d["latency"], energy=d["energy"],
            objective=d["objective"])
    if kind == "concurrent":
        return ConcurrentSchedule(
            steps=[ConcurrentStep(ops=tuple(st["ops"]), pus=tuple(st["pus"]),
                                  cost=st["cost"]) for st in d["steps"]],
            latency=d["latency"], energy=d["energy"],
            objective=d["objective"], mode=d["mode"])
    if kind == "dag":
        return DagSchedule(
            steps=[DagStep(ops=tuple(st["ops"]), pus=tuple(st["pus"]),
                           cost=st["cost"]) for st in d["steps"]],
            latency=d["latency"], energy=d["energy"],
            objective=d["objective"], mode=d["mode"])
    raise ValueError(f"unknown schedule type {kind!r}")
