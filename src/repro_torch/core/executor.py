"""Execution orchestrator: applies a static schedule and really runs it.

Port of the sequential part of ``repro.core.executor``.  Each PU is an
execution *lane* (a worker thread with a FIFO command queue).  Two
execution paths share the lane model:

* the **per-op interpreter** (``run_scheduled``): ops are enqueued onto
  their assigned lane in dependency order and cross-lane dependencies
  synchronise via one event per op.  This is the bitwise-equivalence
  oracle: orchestrated execution must produce outputs identical to
  monolithic single-lane execution (``run_monolithic``).  It always runs
  the reference payloads ``op.fn``, on whatever device their inputs are;

* the **compiled path** (``compile_scheduled`` →
  :class:`~repro_torch.core.laneprogram.LaneProgram`): each lane's queue
  is partitioned into maximal contiguous same-lane segments, each placed
  on its target's device and serving that target's verified payload
  variants, run inline in the one order a sequential chain's segments
  admit.

Both paths run under the fault runtime of :mod:`repro_torch.core.faults`.
The concurrent and DAG lane queues (``run_concurrent``, ``run_dag`` and
their compiled forms) are not ported yet (``ROADMAP.md``).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Mapping, Sequence

import torch

from .errors import PULostError
from .faults import (_JOIN_GRACE, ExecutionPolicy, FaultPlan, RunContext,
                     _Aborted, run_with_retries)
from .laneprogram import LaneProgram, _tensor, compile_lane_program
from .op import OpGraph


class ScheduleExecutor:
    """Runs an OpGraph whose ops carry ``fn`` payloads under an assignment.

    ``targets`` optionally binds lane names to registered
    :class:`~repro_torch.core.targets.Target`\\ s (see
    :mod:`repro_torch.core.backends`): the **compiled** path then selects
    and device-places each lane's payload variants per its bound target.
    The per-op interpreter deliberately ignores the binding — it always
    executes ``op.fn`` and remains the single-variant bitwise oracle.
    """

    def __init__(self, pus: Sequence[str], targets=None):
        from .targets import resolve_targets
        self.pus = list(pus)
        self.targets = resolve_targets(targets)
        if self.targets:
            unknown = sorted(set(self.targets) - set(self.pus))
            if unknown:
                raise ValueError(
                    f"target binding names lane(s) {unknown} not in the "
                    f"executor's PU set {self.pus}")

    def run_monolithic(self, graph: OpGraph,
                       external_inputs: Mapping[int, tuple] | None = None) -> dict[int, Any]:
        """Reference: run everything on one lane in topological order."""
        ext = dict(external_inputs or {})
        results: dict[int, Any] = {}
        for i in graph.topo_order():
            op = graph.ops[i]
            if op.fn is None:
                results[i] = None
            else:
                e = ext.get(i, ())
                dep_vals = tuple(results[p] for p in graph.pred[i])
                results[i] = op.fn(*(tuple(e) + dep_vals))
        return results

    # ------------------------------------------------------------------
    # assignment normalization (shared by both paths)
    # ------------------------------------------------------------------
    def _normalize_assignment(self, graph: OpGraph, assignment
                              ) -> dict[int, str]:
        """``{op index: PU name}`` from a mapping or a ``SeqSchedule``
        (via its chain), with coverage validation."""
        if hasattr(assignment, "chain") and hasattr(assignment, "assignment"):
            assignment = dict(zip(assignment.chain, assignment.assignment))
        missing = [i for i in range(len(graph.ops)) if i not in assignment]
        if missing:
            raise ValueError(
                f"assignment does not cover the graph: {len(missing)} op(s) "
                f"unassigned (e.g. {missing[:5]}) — partial (tail/admission) "
                "plans cannot be executed on the full graph")
        unknown = sorted({p for p in assignment.values() if p not in self.pus})
        if unknown:
            raise ValueError(f"assignment names unknown lane(s) {unknown}; "
                             f"the executor's lanes are {self.pus}")
        return dict(assignment)

    def _lane_items(self, graph: OpGraph, assignment: Mapping[int, str]
                    ) -> dict[str, list[tuple[int, int]]]:
        """One FIFO lane per PU; ops enqueue in topological order as
        ``(request 0, op)`` items."""
        lane_items: dict[str, list[tuple[int, int]]] = {p: [] for p in self.pus}
        for i in graph.topo_order():
            lane_items[assignment[i]].append((0, i))
        return lane_items

    # ------------------------------------------------------------------
    # per-op interpreter (the bitwise-equivalence oracle)
    # ------------------------------------------------------------------
    def run_scheduled(self, graph: OpGraph, assignment,
                      external_inputs: Mapping[int, tuple] | None = None, *,
                      policy: ExecutionPolicy | None = None,
                      faults: FaultPlan | None = None,
                      estimate: float | None = None) -> dict[int, Any]:
        """Run under the schedule: one worker lane per PU, event-synced.

        ``assignment`` is an ``{op index: PU name}`` mapping or a
        ``SeqSchedule``.  ``policy`` tunes the watchdog/retry runtime
        (``estimate`` — e.g. the plan's cost-model latency — scales the
        watchdog budget) and ``faults`` injects a scripted
        :class:`~repro_torch.core.faults.FaultPlan`.
        """
        assignment = self._normalize_assignment(graph, assignment)
        lane_queues = self._lane_items(graph, assignment)
        ext = dict(external_inputs or {})
        results: dict[int, Any] = {}
        done_ev = {i: threading.Event() for i in range(len(graph.ops))}
        run = RunContext(policy, faults, estimate)

        def release_all() -> None:
            for ev in done_ev.values():
                ev.set()

        run.release = release_all

        def exec_op(pu: str, i: int) -> None:
            for p in graph.pred[i]:
                if not done_ev[p].is_set():
                    run.wait(done_ev[p], f"op {i} on lane {pu!r} "
                                         f"(waiting for op {p})")
            run.check_abort()
            op = graph.ops[i]
            what = f"op {i} on lane {pu!r}"
            run.current[pu] = what

            def attempt():
                if run.faults is not None:
                    run.faults.fire(pu, 0, i, run)
                if op.fn is None:
                    return None
                dep_vals = tuple(results[p] for p in graph.pred[i])
                return op.fn(*(tuple(ext.get(i, ())) + dep_vals))

            results[i] = run_with_retries(run, attempt, what,
                                          lane=pu, request=0, op=i)
            run.current.pop(pu, None)
            done_ev[i].set()

        def lane_worker(pu: str) -> None:
            try:
                for _, i in lane_queues[pu]:
                    exec_op(pu, i)
            except _Aborted:
                pass  # a peer already failed; unwind silently
            except BaseException as e:
                run.fail(e)

        threads = [threading.Thread(target=lane_worker, args=(pu,),
                                    name=f"lane-{pu}", daemon=True)
                   for pu in lane_queues if lane_queues[pu]]
        for t in threads:
            t.start()
        for t in threads:
            if run.deadline is None:
                t.join()
            else:
                t.join(max(run.deadline - time.monotonic(), 0.0) + _JOIN_GRACE)
                if t.is_alive():
                    # backstop: a payload the watchdog cannot interrupt
                    # (daemon thread — it cannot block process exit)
                    run.abort.set()
                    release_all()
                    raise run._timeout(f"lane worker {t.name!r}")
        if run.errors:
            err = run.first_error()
            if isinstance(err, PULostError) and err.partial is None:
                err.partial = [dict(results)]
            raise err
        return results

    # ------------------------------------------------------------------
    # compiled path (laneprogram)
    # ------------------------------------------------------------------
    def compile_scheduled(self, graph: OpGraph, assignment) -> LaneProgram:
        """Compile a sequential plan into a :class:`LaneProgram`.

        Accepts the same ``assignment`` forms as ``run_scheduled``;
        ``program.run(external_inputs)`` then returns the same results
        dict, with per-op dispatch/event overhead collapsed to one
        composed call per segment.
        """
        assignment = self._normalize_assignment(graph, assignment)
        return compile_lane_program([graph], self._lane_items(graph, assignment),
                                    targets=self.targets)

    # ------------------------------------------------------------------
    @staticmethod
    def outputs_close(a: Mapping[int, Any], b: Mapping[int, Any],
                      rtol: float = 0.0, atol: float = 0.0) -> bool:
        """Orchestrated vs monolithic outputs must match (exactly by
        default: the schedule must not change numerics).  Compared in
        float64 on the device of ``a``'s tensors."""
        if set(a) != set(b):
            return False
        for k in a:
            x, y = _tensor(a[k]), _tensor(b[k])
            if x is None and y is None:
                continue
            if x is None or y is None or x.shape != y.shape:
                return False
            if not torch.allclose(x.double(), y.to(x.device).double(),
                                  rtol=rtol, atol=atol):
                return False
        return True
