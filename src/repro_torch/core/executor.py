"""Execution orchestrator: applies a static schedule and really runs it.

Port of ``repro.core.executor``.  Each PU is an execution *lane* (a
worker thread with a FIFO command queue).  Two execution paths share the
lane model:

* the **per-op interpreter** (``run_scheduled`` / ``run_dag`` /
  ``run_concurrent``, all on the shared threaded runtime
  ``_run_lanes``): ops are enqueued onto their assigned lane in
  dependency order and cross-lane dependencies synchronise via one
  event per op.  This is the bitwise-equivalence oracle: orchestrated
  execution must produce outputs identical to monolithic single-lane
  execution (``run_monolithic``).  It always runs the reference payloads
  ``op.fn``, on whatever device their inputs are;

* the **compiled path** (``compile_scheduled`` / ``compile_dag`` /
  ``compile_concurrent`` →
  :class:`~repro_torch.core.laneprogram.LaneProgram`): each lane's
  queue is partitioned into maximal contiguous same-lane segments, each
  placed on its target's device and serving that target's verified
  payload variants — run inline when the segments admit one order (a
  sequential chain), else on one worker thread and one CUDA stream per
  lane.

A ``DagSchedule`` enqueues its ops per lane in step order, and lanes
synchronise only at the graph's true dependency edges, with no step
barriers, so independent subgraphs on different lanes overlap.  Both
paths run under the fault runtime of :mod:`repro_torch.core.faults`.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Mapping, Sequence

import torch

from .errors import InfeasibleScheduleError, PULostError
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
    # assignment / schedule normalization (shared by both paths)
    # ------------------------------------------------------------------
    def _normalize_assignment(self, graph: OpGraph, assignment,
                              completed: Mapping[int, Any] | None = None
                              ) -> dict[int, str]:
        """``{op index: PU name}`` from a mapping or any schedule object
        exposing one (``SeqSchedule`` — via its chain — or
        ``ParallelSchedule.assignment``), with coverage validation.
        Ops already present in ``completed`` (a resume frontier) need no
        assignment."""
        if hasattr(assignment, "chain") and hasattr(assignment, "assignment"):
            assignment = dict(zip(assignment.chain, assignment.assignment))
        elif hasattr(assignment, "assignment"):
            assignment = assignment.assignment
        have = set(assignment) | set(completed or ())
        missing = [i for i in range(len(graph.ops)) if i not in have]
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

    def _scheduled_lane_queues(self, graph: OpGraph,
                               assignment: Mapping[int, str],
                               completed: Mapping[int, Any] | None = None
                               ) -> dict[str, list[tuple[int, int]]]:
        """One FIFO lane per PU; ops enqueue in topological order as
        ``(request 0, op)`` items.  Completed (frontier) ops are not
        re-enqueued."""
        lane_queues: dict[str, list[tuple[int, int]]] = {
            p: [] for p in self.pus}
        done = completed or ()
        for i in graph.topo_order():
            if i in done:
                continue
            lane_queues[assignment[i]].append((0, i))
        return lane_queues

    def _concurrent_lane_queues(self, graphs: Sequence[OpGraph], schedule,
                                completed: Sequence[Mapping[int, Any]] | None
                                = None, partial: bool = False
                                ) -> tuple[dict[str, list[tuple[int, int]]],
                                           set[tuple[int, int]]]:
        """Lane queues in schedule-step order + the co-scheduled op set.

        Validates coverage AND dependency order (a mis-ordered schedule
        would otherwise deadlock the lane workers instead of raising).
        Ops of a step where >= 2 requests advance together are returned
        as *barrier* ops: the compiled path keeps them individually
        dispatched so the co-execution granularity the contention laws
        priced is preserved.  ``completed`` (a resume frontier) seeds the
        per-request done sets: frontier ops need no schedule step and
        satisfy dependency/coverage checks.  ``partial=True`` skips the
        final full-coverage check — a *window* of a longer plan (the
        serving loop runs plans window by window) is a valid unit of
        execution as long as precedence holds; dependency validation is
        never skipped.
        """
        m = len(graphs)
        if schedule.n_requests != m:
            raise ValueError(
                f"schedule covers {schedule.n_requests} requests, "
                f"got {m} graphs")
        lane_queues: dict[str, list[tuple[int, int]]] = {
            p: [] for p in self.pus}
        barriers: set[tuple[int, int]] = set()
        seen: list[set[int]] = [set(completed[r]) if completed else set()
                                for r in range(m)]
        for st in schedule.steps:
            active = [(r, oi, pu) for r, (oi, pu)
                      in enumerate(zip(st.ops, st.pus)) if oi is not None]
            for r, oi, pu in active:
                if completed and oi in seen[r] and oi in completed[r]:
                    continue  # frontier op re-listed by a stale schedule
                missing_pred = [p for p in graphs[r].pred[oi]
                                if p not in seen[r]]
                if missing_pred:
                    raise ValueError(
                        f"schedule lists op {oi} of request {r} before its "
                        f"predecessor(s) {missing_pred} — executing it "
                        "would deadlock the lanes")
                if pu not in lane_queues:
                    raise ValueError(
                        f"schedule assigns op {oi} of request {r} to "
                        f"unknown lane {pu!r}; the executor's lanes are "
                        f"{self.pus}")
                lane_queues[pu].append((r, oi))
                seen[r].add(oi)
                if len(active) > 1:
                    barriers.add((r, oi))
        if not partial:
            for r, g in enumerate(graphs):
                if seen[r] != set(range(len(g.ops))):
                    missing = sorted(set(range(len(g.ops))) - seen[r])
                    raise ValueError(
                        f"schedule does not cover request {r}: missing ops "
                        f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
        return lane_queues, barriers

    def _dag_lane_queues(self, graph: OpGraph, schedule,
                         completed: Mapping[int, Any] | None = None
                         ) -> dict[str, list[tuple[int, int]]]:
        """Lane queues in DAG-schedule step order.

        Ops enqueue onto their assigned lane in the order the
        ``DagSchedule`` lists them; synchronization at runtime comes from
        the graph's *true dependency edges* only (per-op events in the
        interpreter, segment cuts in the compiled path) — no step
        barriers, so independent subgraphs on different lanes overlap
        (the paper's intra-model-parallelism win).  Coverage and
        precedence are validated here: a step op whose predecessors have
        not all been listed earlier (same step counts, in listed order)
        raises :class:`InfeasibleScheduleError` naming the node and its
        unmet predecessors instead of deadlocking the lane workers.
        Frontier (``completed``) ops count as listed and are not
        re-enqueued.
        """
        lane_queues: dict[str, list[tuple[int, int]]] = {
            p: [] for p in self.pus}
        seen: set[int] = set(completed or ())

        def _nm(i: int) -> str:
            return f"op {i} ({graph.ops[i].name})"

        for st in schedule.steps:
            for oi, pu in zip(st.ops, st.pus):
                if completed and oi in seen and oi in completed:
                    continue  # frontier op re-listed by a stale schedule
                unmet = [p for p in graph.pred[oi] if p not in seen]
                if unmet:
                    raise InfeasibleScheduleError(
                        f"DAG schedule lists node {_nm(oi)} before its "
                        f"unmet predecessor(s) "
                        f"{[_nm(p) for p in unmet]} — executing it would "
                        "deadlock the lanes")
                if pu not in lane_queues:
                    raise ValueError(
                        f"DAG schedule assigns {_nm(oi)} to unknown lane "
                        f"{pu!r} (executor lanes: {self.pus})")
                lane_queues[pu].append((0, oi))
                seen.add(oi)
        if seen != set(range(len(graph.ops))):
            missing = sorted(set(range(len(graph.ops))) - seen)
            raise ValueError(
                f"DAG schedule does not cover the graph: missing ops "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
        return lane_queues

    # ------------------------------------------------------------------
    # per-op interpreter (the bitwise-equivalence oracle)
    # ------------------------------------------------------------------
    def run_scheduled(self, graph: OpGraph, assignment,
                      external_inputs: Mapping[int, tuple] | None = None, *,
                      policy: ExecutionPolicy | None = None,
                      faults: FaultPlan | None = None,
                      completed: Mapping[int, Any] | None = None,
                      estimate: float | None = None) -> dict[int, Any]:
        """Run under the schedule: one worker lane per PU, event-synced.

        ``assignment`` is an ``{op index: PU name}`` mapping, or any
        schedule object exposing one (``SeqSchedule`` or
        ``ParallelSchedule``).  ``policy`` tunes the watchdog/retry
        runtime (``estimate`` — e.g. the plan's cost-model latency —
        scales the watchdog budget), ``faults`` injects a scripted
        :class:`~repro_torch.core.faults.FaultPlan`, and ``completed``
        resumes from an execution frontier: ops with a recorded result
        are not re-run (their values seed the results dict).
        """
        assignment = self._normalize_assignment(graph, assignment, completed)
        lane_queues = self._scheduled_lane_queues(graph, assignment,
                                                  completed)
        return self._run_lanes([graph], lane_queues, [external_inputs],
                               policy=policy, faults=faults,
                               completed=[completed] if completed else None,
                               estimate=estimate)[0]

    def run_dag(self, graph: OpGraph, schedule,
                external_inputs: Mapping[int, tuple] | None = None, *,
                policy: ExecutionPolicy | None = None,
                faults: FaultPlan | None = None,
                completed: Mapping[int, Any] | None = None,
                estimate: float | None = None) -> dict[int, Any]:
        """Run a ``DagSchedule``: ops enqueue per-lane in step order and
        cross-lane synchronization happens only at true dependency edges,
        so a multi-op (antichain) step's ops really overlap across lanes.

        ``policy`` / ``faults`` / ``completed`` / ``estimate`` behave as
        in :meth:`run_scheduled`.
        """
        lane_queues = self._dag_lane_queues(graph, schedule, completed)
        return self._run_lanes([graph], lane_queues, [external_inputs],
                               policy=policy, faults=faults,
                               completed=[completed] if completed else None,
                               estimate=estimate)[0]

    def run_concurrent(self, graphs: Sequence[OpGraph], schedule,
                       external_inputs: Sequence[Mapping[int, tuple] | None]
                       | None = None, *,
                       policy: ExecutionPolicy | None = None,
                       faults: FaultPlan | None = None,
                       completed: Sequence[Mapping[int, Any]] | None = None,
                       estimate: float | None = None,
                       partial: bool = False,
                       op_timings: list | None = None
                       ) -> list[dict[int, Any]]:
        """Run an M-model ``ConcurrentSchedule`` across the PU lanes.

        All M models' ops are multiplexed onto the *shared* lanes (one
        FIFO worker per PU): ops enqueue in schedule-step order, so two
        co-scheduled ops land on their assigned lanes side by side and
        same-PU co-scheduled ops serialise on one queue.  Dependencies
        are per-model (requests are independent); each model's results
        dict is returned in request order.

        ``policy`` / ``faults`` / ``completed`` / ``estimate`` behave as
        in :meth:`run_scheduled` (``completed`` is one frontier dict per
        request).  ``partial=True`` accepts a schedule that covers only a
        *window* of each request's remaining ops (precedence is still
        validated against the frontier) — the unit the serving loop
        advances by.  ``op_timings``, when a list, receives one ``(pu,
        request, op, wall_seconds)`` tuple per completed op.
        """
        m = len(graphs)
        lane_queues, _ = self._concurrent_lane_queues(graphs, schedule,
                                                      completed, partial)
        ext = list(external_inputs or [None] * m)
        return self._run_lanes(list(graphs), lane_queues, ext,
                               policy=policy, faults=faults,
                               completed=completed, estimate=estimate,
                               op_timings=op_timings)

    def _run_lanes(self, graphs: Sequence[OpGraph],
                   lane_queues: Mapping[str, Sequence[tuple[int, int]]],
                   ext: Sequence[Mapping[int, tuple] | None], *,
                   policy: ExecutionPolicy | None,
                   faults: FaultPlan | None,
                   completed: Sequence[Mapping[int, Any]] | None,
                   estimate: float | None,
                   op_timings: list | None = None) -> list[dict[int, Any]]:
        """Shared lane runtime of both interpreter entry points.

        One daemon worker thread per non-empty lane; per-op events bound
        by the run's watchdog budget; the first failure aborts the run
        and releases every event so no lane stays parked on a dead
        producer.  Every worker launches on its
        thread's default stream, which all threads of one device share,
        so CUDA work of the interpreter is ordered by that one stream.
        Frontier (``completed``) results seed the results dicts with
        their events pre-set.
        """
        m = len(graphs)
        results: list[dict[int, Any]] = [
            dict(completed[r]) if completed and completed[r] else {}
            for r in range(m)]
        done_ev: dict[tuple[int, int], threading.Event] = {
            (r, i): threading.Event()
            for r, g in enumerate(graphs) for i in range(len(g.ops))}
        for r in range(m):
            for i in results[r]:
                done_ev[(r, i)].set()

        run = RunContext(policy, faults, estimate)

        def release_all() -> None:
            for ev in done_ev.values():
                ev.set()

        run.release = release_all

        def exec_op(pu: str, r: int, i: int) -> None:
            g = graphs[r]
            for p in g.pred[i]:
                if not done_ev[(r, p)].is_set():
                    run.wait(done_ev[(r, p)],
                             f"op {i} of request {r} on lane {pu!r} "
                             f"(waiting for op {p})")
            run.check_abort()
            op = g.ops[i]
            what = f"op {i} of request {r} on lane {pu!r}"
            run.current[pu] = what

            def attempt():
                if run.faults is not None:
                    run.faults.fire(pu, r, i, run)
                if op.fn is None:
                    return None
                e = (ext[r] or {}).get(i, ())
                dep_vals = tuple(results[r][p] for p in g.pred[i])
                return op.fn(*(tuple(e) + dep_vals))

            t0 = time.monotonic() if op_timings is not None else 0.0
            results[r][i] = run_with_retries(run, attempt, what,
                                             lane=pu, request=r, op=i)
            if op_timings is not None:
                op_timings.append((pu, r, i, time.monotonic() - t0))
            run.current.pop(pu, None)
            done_ev[(r, i)].set()

        def lane_worker(pu: str) -> None:
            try:
                for r, i in lane_queues[pu]:
                    exec_op(pu, r, i)
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
                err.partial = [dict(res) for res in results]
            raise err
        return results

    # ------------------------------------------------------------------
    # compiled path (laneprogram)
    # ------------------------------------------------------------------
    def compile_scheduled(self, graph: OpGraph, assignment,
                          completed: Mapping[int, Any] | None = None
                          ) -> LaneProgram:
        """Compile a sequential/parallel plan into a :class:`LaneProgram`.

        Accepts the same ``assignment`` forms as ``run_scheduled``;
        ``program.run(external_inputs)`` then returns the same results
        dict, with per-op dispatch/event overhead collapsed to one
        composed call + one event per segment.  ``completed`` compiles
        the program over the ops outside that frontier; run it with the
        same frontier (``program.run(..., completed=...)``).
        """
        assignment = self._normalize_assignment(graph, assignment, completed)
        queues = self._scheduled_lane_queues(graph, assignment, completed)
        return compile_lane_program([graph], queues, single=True,
                                    targets=self.targets)

    def compile_dag(self, graph: OpGraph, schedule,
                    completed: Mapping[int, Any] | None = None
                    ) -> LaneProgram:
        """Compile a ``DagSchedule`` into a :class:`LaneProgram`: each
        lane's queue (in step order) partitions into fused segments with
        events only at cross-lane dependency cuts, so independent
        subgraphs on different lanes overlap exactly as in :meth:`run_dag`;
        ``program.run(external_inputs)`` matches it bitwise.
        ``completed`` behaves as in :meth:`compile_scheduled`."""
        lane_queues = self._dag_lane_queues(graph, schedule, completed)
        return compile_lane_program([graph], lane_queues, single=True,
                                    targets=self.targets)

    def compile_concurrent(self, graphs: Sequence[OpGraph], schedule,
                           completed: Sequence[Mapping[int, Any]] | None
                           = None, partial: bool = False) -> LaneProgram:
        """Compile an M-model ``ConcurrentSchedule`` into a
        :class:`LaneProgram` (co-scheduled steps become single-op barrier
        segments); ``program.run(inputs)`` matches ``run_concurrent``.

        ``completed``/``partial`` compile a *window* program over the
        remaining ops of a partially-executed plan; run it with the same
        frontier (``program.run(..., completed=...)``) so cross-window
        inputs resolve from already-computed values."""
        lane_queues, barriers = self._concurrent_lane_queues(
            graphs, schedule, completed, partial)
        return compile_lane_program(list(graphs), lane_queues,
                                    barriers=barriers, single=False,
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
