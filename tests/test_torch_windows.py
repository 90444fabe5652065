"""Executing plans window by window from a frontier, on the CPU: the
frontier and window options of the executor and the lane programs, and
the online-admission loop that ``chip_smoke.py`` phase 6 drives on the
card, at a small size.

* ``run_scheduled`` / ``run_dag`` / ``run_concurrent`` and every
  ``compile_*`` take ``completed`` (a frontier: those ops are not run
  again, their values seed the results); ``run_concurrent`` and
  ``compile_concurrent`` take ``partial`` (a window of the plan);
  ``run_concurrent`` records ``op_timings`` and ``LaneProgram.run``
  ``segment_timings``.
* The admission loop: request A admitted alone, B and C admitted while
  it runs, each re-plan a horizon window (warm, bitwise the cold solve),
  each window run through the interpreter and through a compiled window
  program, ``advance`` by what completed, ``retire`` at the end.  Every
  request's outputs are bitwise its run alone with the op -> lane
  assignment it was given, and within 1e-5 of the JAX package's chain.
"""
import numpy as np
import pytest
import torch

from repro.core.executor import ScheduleExecutor as JExecutor
from repro.core.modelgraph import kernel_chain as jax_kernel_chain
from repro_torch.core import (ConcurrentCaches, ConcurrentSchedule,
                              CostEntry, CostTable, DagSchedule, DagStep,
                              Orchestrator, Target, kernel_chain,
                              results_bitwise_equal, solve_concurrent,
                              solve_concurrent_horizon)
from repro_torch.core.backends import default_registry
from test_torch_main_path import CFG, reference_arrays

SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def chains():
    """Per seed: the port's chain on the reference chain's arrays, and
    the JAX package's outputs for it."""
    out = []
    for seed in SEEDS:
        arrays = reference_arrays(seed, **CFG)
        jgraph, jext = jax_kernel_chain(seed=seed, **CFG)
        jres = JExecutor(["CPU"]).run_monolithic(jgraph, jext)
        graph, ext = kernel_chain(arrays=arrays, device="cpu", **CFG)
        out.append((graph, ext, jres))
    return out


def _lanes(kind):
    reg = default_registry(device="cpu")
    if kind == "host lanes":        # numpy-eager serves a NumPy variant
        return {n: reg.get(n) for n in reg.names()}
    return {"torch-cpu": reg.get("torch-cpu"),
            "torch-cpu-b": Target("torch-cpu-b", kind="cpu", dialect="ref",
                                  jit=False, device=torch.device("cpu"))}


def _tables(lanes, n_ops, seeds):
    tables = []
    for k, seed in enumerate(seeds):
        rng = np.random.default_rng(200 + seed)
        table = CostTable(list(lanes))
        for i in range(n_ops):
            for j, lane in enumerate(lanes):
                w = float(rng.uniform(1e-4, 1e-3)) * (1.0 if j == k % 2
                                                      else 3.0)
                table.set(i, lane, CostEntry(kernel=w, dispatch=1e-5,
                                             h2d=0.0, d2h=0.0, power=10.0))
        tables.append(table)
    return tables


def test_resume_from_a_frontier_is_bitwise_the_full_run(chains):
    """Every entry point, given the first half of a run as its frontier,
    runs only the rest and returns the full run's results."""
    graph, ext, _ = chains[0]
    lanes = _lanes("reference lanes")
    ex = Orchestrator(CostTable(list(lanes)), targets=lanes).executor
    n = len(graph)
    assign = {i: ("torch-cpu", "torch-cpu-b")[i % 2] for i in range(n)}
    full = ex.run_scheduled(graph, assign, ext)
    front = {i: full[i] for i in range(n // 2)}
    rest = {i: assign[i] for i in range(n // 2, n)}
    assert results_bitwise_equal(
        ex.run_scheduled(graph, rest, ext, completed=front), full)
    prog = ex.compile_scheduled(graph, rest, completed=front)
    assert sorted(i for s in prog.segments for _, i in s.items) == \
        list(range(n // 2, n))
    assert results_bitwise_equal(prog.run(ext, completed=front), full)
    sched = DagSchedule(
        steps=[DagStep(ops=(i,), pus=(assign[i],), cost=1e-3)
               for i in range(n)],
        latency=n * 1e-3, energy=0.0, objective="latency", mode="chain")
    assert results_bitwise_equal(
        ex.run_dag(graph, sched, ext, completed=front), full)
    dprog = ex.compile_dag(graph, sched, completed=front)
    timings = []
    assert results_bitwise_equal(
        dprog.run(ext, completed=front, segment_timings=timings), full)
    assert sorted(i for _, items, _ in timings for _, i in items) == \
        list(range(n // 2, n))
    assert all(lane in lanes and secs >= 0 for lane, _, secs in timings)


def test_a_window_must_keep_precedence_but_not_coverage(chains):
    graphs = [chains[r][0] for r in range(2)]
    lanes = _lanes("reference lanes")
    tables = _tables(lanes, len(graphs[0]), SEEDS[:2])
    orch = Orchestrator(tables[0], targets=lanes)
    hs = [orch.register(g, table=t) for g, t in zip(graphs, tables)]
    plan = orch.plan(hs)
    steps = plan.schedule.steps
    sub = ConcurrentSchedule(steps=steps[:3], latency=0.0, energy=0.0,
                             objective="latency", mode="window")
    with pytest.raises(ValueError, match="does not cover request"):
        orch.executor.compile_concurrent(graphs, sub)
    orch.executor.compile_concurrent(graphs, sub, partial=True)
    late = ConcurrentSchedule(steps=steps[3:], latency=0.0, energy=0.0,
                              objective="latency", mode="window")
    with pytest.raises(ValueError, match="before its predecessor"):
        orch.executor.compile_concurrent(graphs, late, partial=True)


def _select_window(plan, cursor, now, arrival, ops_done, n_ops):
    """``serve.py``'s window: plan steps from ``cursor`` up to the next
    arrival, or through the first step that completes a request; returns
    (end, the estimated clock at its end)."""
    steps = plan.schedule.steps
    t, end, count = now, cursor, dict(ops_done)
    while end < len(steps):
        if arrival is not None and t >= arrival:
            break
        st = steps[end]
        end += 1
        t += st.cost
        fin = False
        for k, op in enumerate(st.ops):
            if op is not None:
                h = plan.handles[k]
                count[h] += 1
                fin |= count[h] >= n_ops[h]
        if fin:
            break
    return end, t


def _cold(orch, horizon):
    """The cold solve of the orchestrator's active state."""
    items = [(h, p) for h, p in sorted(orch._active.items())
             if p < orch.workload(h).n]
    wls = [orch.workload(h).tail(p) if p else orch.workload(h)
           for h, p in items]
    if horizon is None:
        return solve_concurrent(wls, orch.contention,
                                caches=ConcurrentCaches())
    return solve_concurrent_horizon(wls, orch.contention,
                                    caches=ConcurrentCaches(),
                                    horizon_states=horizon)


def _admission_loop(chains, lanes, horizon):
    """Phase 6 of ``chip_smoke.py`` at a small size: A admitted, B at
    40% and C at 70% of A's predicted latency on the plan's estimated
    clock.  Returns per request its results and op -> lane assignment,
    the orchestrator and the number of windows run."""
    graphs = [chains[r][0] for r in range(3)]
    exts = [chains[r][1] for r in range(3)]
    tables = _tables(lanes, len(graphs[0]), SEEDS)
    orch = Orchestrator(tables[0], targets=lanes)
    hs = [orch.register(g, table=t) for g, t in zip(graphs, tables)]
    total = orch.plan(hs[0]).latency
    waiting = [(0.0, hs[0]), (0.4 * total, hs[1]), (0.7 * total, hs[2])]
    n_ops = {h: len(g) for h, g in zip(hs, graphs)}
    done = {h: {} for h in hs}
    assign = {h: {} for h in hs}
    now, cursor, plan, windows = 0.0, 0, None, 0

    def check(p):
        if p is not None:
            assert p.schedule.steps == _cold(orch, horizon).steps
        return p

    while True:
        while waiting and waiting[0][0] <= now:
            plan, cursor = check(orch.admit(waiting.pop(0)[1],
                                            horizon_states=horizon)), 0
        if plan is None:
            plan, cursor = check(orch.replan_active(
                horizon_states=horizon)), 0
        if plan is None:
            if not waiting:
                break
            now = waiting[0][0]
            continue
        end, t = _select_window(plan, cursor, now,
                                waiting[0][0] if waiting else None,
                                {h: len(done[h]) for h in plan.handles},
                                n_ops)
        if end <= cursor:
            plan = None
            continue
        sub = ConcurrentSchedule(steps=list(plan.schedule.steps[cursor:end]),
                                 latency=t - now, energy=0.0,
                                 objective="latency", mode="window")
        gs = [graphs[hs.index(h)] for h in plan.handles]
        es = [exts[hs.index(h)] for h in plan.handles]
        front = [dict(done[h]) for h in plan.handles]
        timings = []
        interp = orch.executor.run_concurrent(
            gs, sub, es, completed=front, partial=True, op_timings=timings)
        prog = orch.executor.compile_concurrent(gs, sub, completed=front,
                                                partial=True)
        cold = prog.run(es, completed=front)
        seg_t = []
        warm = prog.run(es, completed=front, segment_timings=seg_t)
        prog.close()
        ran = sorted((k, o) for st in sub.steps
                     for k, o in enumerate(st.ops) if o is not None)
        assert sorted((r, i) for _, r, i, _ in timings) == ran
        assert sorted(it for _, items, _ in seg_t for it in items) == ran
        for k, h in enumerate(plan.handles):
            assert results_bitwise_equal(cold[k], interp[k])
            fresh = [i for i in warm[k] if i not in done[h]]
            done[h].update(warm[k])
            assign[h].update((st.ops[k], st.pus[k]) for st in sub.steps
                             if st.ops[k] is not None)
            orch.advance(h, len(fresh))
        windows += 1
        now, cursor = t, end
        finished = [h for h in plan.handles if len(done[h]) >= n_ops[h]]
        if cursor >= len(plan.schedule.steps):
            plan = None
        for h in finished:
            plan, cursor = check(orch.retire(h, horizon_states=horizon)), 0
    return [done[h] for h in hs], orch, windows, [assign[h] for h in hs]


@pytest.mark.parametrize("lane_set", ["reference lanes", "host lanes"])
@pytest.mark.parametrize("horizon", [8, None])
def test_admission_loop_outputs_match_alone_and_jax(chains, lane_set,
                                                    horizon):
    lanes = _lanes(lane_set)
    results, orch, windows, assigns = _admission_loop(chains, lanes, horizon)
    assert orch._active == {}
    assert orch.stats["replans_warm"] >= 1 and orch.stats["replans_cold"] == 0
    assert windows >= 3
    for r, (graph, ext, jres) in enumerate(chains):
        assert sorted(results[r]) == list(range(len(graph)))
        alone = orch.executor.compile_scheduled(graph, assigns[r])
        alone.run(ext)
        assert results_bitwise_equal(results[r], alone.run(ext)), r
        for i in range(len(graph)):
            np.testing.assert_allclose(results[r][i].numpy(),
                                       np.asarray(jres[i]), rtol=1e-5,
                                       atol=1e-5)
