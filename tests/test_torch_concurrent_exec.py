"""The port's threaded lane runtime on the CPU: concurrent and parallel
programs of small kernel chains, errors, and device waits.

* Two and three small ``kernel_chain``s (the reference chain's default
  widths, ``device="cpu"``) planned jointly on two host lanes: each
  request's outputs from the concurrent compiled program are bitwise
  its isolated compiled run with the same op → lane assignment, bitwise
  (or, where a NumPy variant was accepted within its tolerance, within
  it) the per-op interpreter's, and within 1e-5 of the JAX package's
  chain on the same arrays.
* An error on one lane releases the other lanes: the run raises the
  original error well within its deadline, on both executor paths.
* A device event that never completes times out as a typed error, and
  one whose ``query()`` raises surfaces as a typed error: the host never
  waits on the card without a deadline.
"""
import contextlib
import time

import numpy as np
import pytest
import torch

from repro.core.executor import ScheduleExecutor as JExecutor
from repro.core.modelgraph import kernel_chain as jax_kernel_chain
from repro_torch.core import (ConcurrentSchedule, ConcurrentStep, CostEntry,
                              CostTable, ExecutionPolicy, FusedOp, OpGraph,
                              Orchestrator, ScheduleExecutor, Target,
                              chain_graph, kernel_chain,
                              results_bitwise_equal, variant_tolerance)
from repro_torch.core import laneprogram as lp
from repro_torch.core.backends import default_registry
from repro_torch.core.errors import ExecutionError, ExecutionTimeoutError
from test_torch_main_path import CFG, reference_arrays

SEEDS = (0, 1, 2)


def _ref_lane_pair():
    """torch-cpu and a second reference-dialect host lane: every
    segment serves the reference payloads, so outputs are bitwise the
    interpreter's."""
    reg = default_registry(device="cpu")
    other = Target("torch-cpu-b", kind="cpu", dialect="ref",
                   device=torch.device("cpu"), dispatch_s=1e-5)
    return {"torch-cpu": reg.get("torch-cpu"), "torch-cpu-b": other}


def _host_lanes():
    reg = default_registry(device="cpu")
    return {name: reg.get(name) for name in reg.names()}


@pytest.fixture(scope="module")
def chains():
    """Per seed: the port's chain on the reference chain's arrays, and
    the JAX package's outputs for it."""
    out = []
    for seed in SEEDS:
        arrays = reference_arrays(seed, **CFG)
        jgraph, jext = jax_kernel_chain(seed=seed, **CFG)
        assert np.asarray(jext[0][0]).tobytes() == arrays["x0"].tobytes()
        jres = JExecutor(["CPU"]).run_monolithic(jgraph, jext)
        graph, ext = kernel_chain(arrays=arrays, device="cpu", **CFG)
        out.append((graph, ext, jres))
    return out


def _tables(lanes, n_ops, seeds, affinity=None):
    """Seeded per-request cost tables over ``lanes``.  ``affinity[r]``
    makes request r cheap on one lane (so the planner co-schedules the
    requests side by side)."""
    tables = []
    for k, seed in enumerate(seeds):
        rng = np.random.default_rng(100 + seed)
        table = CostTable(list(lanes))
        for i in range(n_ops):
            for lane in lanes:
                w = float(rng.uniform(1e-4, 1e-3))
                if affinity is not None and lane != affinity[k]:
                    w *= 20.0
                table.set(i, lane, CostEntry(kernel=w, dispatch=1e-5,
                                             h2d=0.0, d2h=0.0, power=10.0))
        tables.append(table)
    return tables


def _plan(chains, lanes, m, affinity=None):
    graphs = [chains[r][0] for r in range(m)]
    tables = _tables(lanes, len(graphs[0]), SEEDS[:m], affinity)
    orch = Orchestrator(tables[0], targets=lanes)
    hs = [orch.register(g, table=t) for g, t in zip(graphs, tables)]
    return orch, orch.plan(hs), graphs, [chains[r][1] for r in range(m)]


def _close_to_interpreter(got, oracle, verdicts) -> bool:
    if all(v == "bitwise" for v in verdicts):
        return results_bitwise_equal(got, oracle)
    atol, rtol = variant_tolerance(torch.float32)
    return all(torch.allclose(got[k], oracle[k], atol=atol, rtol=rtol)
               for k in got)


@pytest.mark.parametrize("lane_set", ["reference lanes", "host lanes"])
@pytest.mark.parametrize("m,affinity", [(2, ("a", "b")), (2, None),
                                        (3, ("a", "b", "a")), (3, None)])
def test_concurrent_chains_match_isolated_interpreter_and_jax(
        chains, lane_set, m, affinity):
    lanes = _ref_lane_pair() if lane_set == "reference lanes" \
        else _host_lanes()
    names = list(lanes)
    if affinity is not None:
        affinity = tuple(names[0] if a == "a" else names[1]
                         for a in affinity)
    orch, plan, graphs, exts = _plan(chains, lanes, m, affinity)
    assert plan.kind == "concurrent" and plan.schedule.n_requests == m
    prog = orch.program_for(plan, exts)
    if affinity is not None:     # requests side by side on both lanes
        assert prog.stats["n_barrier"] > 0 and not prog.stats["serial"]
    oracle = orch.execute(plan, exts, compile=False)
    cold = orch.execute(plan, exts)              # probes the variants
    warm = orch.execute(plan, exts)
    again = orch.execute(plan, exts)
    assert orch.stats["program_hits"] >= 2
    verdicts = list(prog.stats["variant_verified"].values())
    assert set(verdicts) <= {"bitwise", "tolerance"}
    if lane_set == "reference lanes":
        assert verdicts == []
    for r in range(m):
        assert results_bitwise_equal(cold[r], oracle[r])  # cold serves refs
        assert results_bitwise_equal(warm[r], again[r])
        assert _close_to_interpreter(warm[r], oracle[r], verdicts)
        # the request alone, compiled with the same op -> lane assignment
        alone = orch.executor.compile_scheduled(
            graphs[r], dict(plan.schedule.assignment_of(r)))
        alone.run(exts[r])
        assert results_bitwise_equal(warm[r], alone.run(exts[r])), r
        jres = chains[r][2]
        for i in range(len(graphs[r])):
            np.testing.assert_allclose(warm[r][i].numpy(),
                                       np.asarray(jres[i]), rtol=1e-5,
                                       atol=1e-5)
    trace = []
    orch.execute(plan, exts, trace=trace)
    assert sorted(it for t in trace for it in t.items) == sorted(
        (r, i) for r in range(m) for i in range(len(graphs[r])))
    assert all(t.lane in lanes and t.seconds >= 0 and t.start >= 0
               for t in trace)
    prog.close()


def test_parallel_plan_of_a_fork_runs_bitwise_the_interpreter():
    """A fork/join graph planned by ``solve_parallel`` with its stem and
    its two branches on three lanes runs threaded (both branches wait
    only on the stem) and matches the interpreter bitwise."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 8), dtype=np.float32))
    fns = [lambda a: a @ a.T, lambda a: a.tanh(), lambda a: a.sin() * 2.0,
           lambda a: a.exp(), lambda a, b: a + b]
    ops = [FusedOp(name=f"f{i}", kind="other", fn=f) for i, f in
           enumerate(fns)]
    graph = OpGraph(ops, edges=[(0, 1), (0, 2), (1, 3), (2, 4), (3, 4)])
    lanes = {**_ref_lane_pair(),
             "torch-cpu-c": Target("torch-cpu-c", kind="cpu", dialect="ref",
                                   device=torch.device("cpu"))}
    home = {0: 0, 1: 1, 2: 2, 3: 1, 4: 0}      # op -> its cheap lane
    table = CostTable(list(lanes))
    for i in range(len(ops)):
        for k, lane in enumerate(lanes):
            table.set(i, lane, CostEntry(
                kernel=1e-4 if home[i] == k else 2e-3, dispatch=1e-5,
                h2d=0.0, d2h=0.0, power=10.0))
    orch = Orchestrator(table, targets=lanes)
    plan = orch.plan(orch.register(graph))
    assert plan.kind == "parallel"
    assert any(ph.parallel for ph in plan.schedule.phases)
    oracle = orch.execute(plan, {0: (x,)}, compile=False)
    for _ in range(2):
        assert results_bitwise_equal(orch.execute(plan, {0: (x,)}), oracle)
    prog = orch.program_for(plan, {0: (x,)})
    assert not prog.stats["serial"] and prog.runs == 2


# ---------------------------------------------------------------------------
# errors and waits
# ---------------------------------------------------------------------------


def _boom(a):
    raise RuntimeError("payload exploded")


def _three_request_schedule():
    """Request 1's failing op runs first on lane a, while lane b runs
    request 2; then lane b waits for request 0's first op, queued on lane
    a behind the failing one."""
    g0 = chain_graph([FusedOp("a0", "act", fn=lambda a: a + 1.0),
                      FusedOp("b0", "act", fn=lambda a: a * 2.0)])
    g1 = chain_graph([FusedOp("boom", "act", fn=_boom)])
    g2 = chain_graph([FusedOp("c0", "act", fn=lambda a: a - 1.0)])
    sched = ConcurrentSchedule(steps=[
        ConcurrentStep(ops=(None, 0, None), pus=(None, "a", None), cost=1e-3),
        ConcurrentStep(ops=(None, None, 0), pus=(None, None, "b"), cost=1e-3),
        ConcurrentStep(ops=(0, None, None), pus=("a", None, None), cost=1e-3),
        ConcurrentStep(ops=(1, None, None), pus=("b", None, None), cost=1e-3)],
        latency=4e-3, energy=0.0, objective="latency", mode="joint")
    return [g0, g1, g2], sched


@pytest.mark.parametrize("path", ["compiled", "interpreter"])
def test_an_error_on_one_lane_releases_the_others(path):
    graphs, sched = _three_request_schedule()
    ex = ScheduleExecutor(["a", "b"])
    inputs = [{0: (torch.ones(4),)} for _ in graphs]
    policy = ExecutionPolicy(timeout=20.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="payload exploded"):
        if path == "compiled":
            prog = ex.compile_concurrent(graphs, sched)
            assert not prog.stats["serial"]
            prog.run(inputs, policy=policy)
        else:
            ex.run_concurrent(graphs, sched, inputs, policy=policy)
    assert time.monotonic() - t0 < 5.0


class _Event:
    """A stand-in for ``torch.cuda.Event``: ``query()`` never turns
    true, or raises."""

    def __init__(self, error: bool = False):
        self.error = error

    def query(self):
        if self.error:
            raise RuntimeError("CUDA error: an illegal memory access")
        return False


class _Stream:
    def __init__(self, error: bool = False):
        self.error = error

    def wait_event(self, ev):
        pass

    def record_event(self):
        return _Event(self.error)


@pytest.mark.parametrize("error", [False, True])
def test_a_device_wait_never_blocks_without_a_deadline(monkeypatch, error):
    """Lane ``a`` stands in for a CUDA lane (its stream publishes events
    that never complete); lane ``b`` is a host lane and must wait for
    the event before reading ``a``'s output."""
    stream = _Stream(error)
    monkeypatch.setattr(lp, "_on_stream",
                        lambda dev, s: contextlib.nullcontext())
    monkeypatch.setattr(lp, "_current_stream", lambda dev: stream)
    graph = OpGraph([FusedOp("p", "act", fn=lambda a: a + 1.0),
                     FusedOp("q", "act", fn=lambda a: a * 2.0),
                     FusedOp("r", "act", fn=lambda a: a - 1.0)],
                    edges=[(0, 1), (0, 2)])
    ex = ScheduleExecutor(["a", "b", "c"])
    prog = ex.compile_scheduled(graph, {0: "a", 1: "b", 2: "c"})
    prog.lane_streams = lambda: {"a": ("card", stream)}
    t0 = time.monotonic()
    with pytest.raises(ExecutionError) as e:
        prog.run({0: (torch.ones(4),)}, policy=ExecutionPolicy(timeout=0.5))
    assert time.monotonic() - t0 < 5.0
    if error:
        assert not isinstance(e.value, ExecutionTimeoutError)
        assert "illegal memory access" in str(e.value)
    else:
        assert isinstance(e.value, ExecutionTimeoutError)
        assert "waiting for segment 0 on lane 'a'" in str(e.value)
    prog.close()
