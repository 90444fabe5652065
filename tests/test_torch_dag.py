"""Parity of the port's DAG planning and execution with the JAX reference.

The DAG front door (``solve_dag``: the ``"chain"``, ``"union-grid"``,
``"phase"`` and ``"frontier"`` routes and ``"auto"``) is NumPy in both
packages, so the same graphs — drawn from the same seeded
``np.random.default_rng`` as ``tests/test_dag.py`` draws them — and the
same cost tables must give the same schedules, latencies, energies
(compared by ``float.hex``) and schedule JSON, bitwise, and the same
error messages.  Case by case this file mirrors ``tests/test_dag.py``:

* the oracle routes (chain DP, grid sweep, ``solve_parallel``) and the
  frontier DP against the reference and against each other;
* executed DAG plans (``run_dag`` and ``compile_dag``) bitwise against
  the port's ``run_monolithic`` and within 1e-5 of the reference's, for
  a chain, a union of chains, a diamond and ``vla_pipeline``;
* the orchestrator's ``mode="dag"``: auto-routing of a disconnected
  graph, its plan cache, plan JSON;
* small kernel chains joined into a union DAG and a fork DAG (1 block,
  seq 64, 2 heads of 16, the reference chain's weights) run through the
  port's compiled DAG plans on host lanes, within 1e-5 of the JAX
  package's ``run_monolithic`` of the same graph.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.paperzoo as JZ
import repro_torch.core as P
import repro_torch.core.paperzoo as PZ
from repro.core.modelgraph import kernel_chain as jax_kernel_chain
from repro_torch.core.backends import default_registry
from test_torch_main_path import CFG, reference_arrays

KINDS = ["matmul", "conv2d", "add", "rdft", "cumsum", "gather", "norm",
         "act", "softmax"]


# ---------------------------------------------------------------------------
# graph specs, drawn as tests/test_dag.py draws its graphs, built in both
# packages
# ---------------------------------------------------------------------------


def _random_specs(rng, n, unsupported_frac=0.0) -> list[dict]:
    specs = []
    for i in range(n):
        kind = KINDS[rng.integers(len(KINDS))]
        if kind in ("matmul", "conv2d"):
            sz = int(rng.integers(32, 384))
            spec = dict(name=f"op{i}", kind="matmul",
                        in_shapes=((1, sz, sz), (sz, sz)),
                        out_shape=(1, sz, sz))
        else:
            numel = int(rng.integers(1_000, 1_000_000))
            spec = dict(name=f"op{i}", kind=kind, in_shapes=((numel,),),
                        out_shape=(numel,))
        if rng.random() < unsupported_frac:
            spec["unsupported_on"] = ("NPU",)
        specs.append(spec)
    return specs


def linear_spec(rng, n):
    return (_random_specs(rng, n, unsupported_frac=0.15),
            [(i, i + 1) for i in range(n - 1)])


def union_spec(rng):
    m = int(rng.integers(2, 4))
    lens = [int(rng.integers(1, 4)) for _ in range(m)]
    n = sum(lens)
    specs = _random_specs(rng, n)
    perm = rng.permutation(n).tolist()
    edges, k = [], 0
    for ln in lens:
        ids = perm[k:k + ln]
        edges += list(zip(ids, ids[1:]))
        k += ln
    return specs, edges


def branch_spec(rng):
    specs: list[dict] = []
    edges: list[tuple[int, int]] = []

    def grow(after, ln):
        prev = after
        for _ in range(ln):
            idx = len(specs)
            specs.append(_random_specs(rng, 1)[0])
            specs[-1]["name"] = f"op{idx}"
            if prev is not None:
                edges.append((prev, idx))
            prev = idx
        return prev

    tail = grow(None, int(rng.integers(1, 3)))
    for _ in range(int(rng.integers(1, 3))):
        ends = [grow(tail, int(rng.integers(1, 3)))
                for _ in range(int(rng.integers(2, 4)))]
        join = len(specs)
        specs.append(_random_specs(rng, 1)[0])
        specs[-1]["name"] = f"op{join}"
        edges += [(e, join) for e in ends]
        tail = grow(join, int(rng.integers(1, 3)))
    return specs, edges


def diamond_spec():
    return ([dict(name=f"d{i}", kind="matmul",
                  in_shapes=((1, 128, 128), (128, 128)),
                  out_shape=(1, 128, 128)) for i in range(6)],
            [(0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 5)])


def build(pkg, spec):
    specs, edges = spec
    ops = []
    for s in specs:
        op = pkg.FusedOp(name=s["name"], kind=s["kind"],
                         in_shapes=s["in_shapes"], out_shape=s["out_shape"])
        if "unsupported_on" in s:
            op.meta["unsupported_on"] = s["unsupported_on"]
        ops.append(op)
    return pkg.OpGraph(ops, edges=edges)


def both(spec):
    """(reference graph, its table, port graph, its table)."""
    jg, pg = build(J, spec), build(P, spec)
    return (jg, J.EdgeSoCCostModel().build_table(jg),
            pg, P.EdgeSoCCostModel().build_table(pg))


def same(j, p) -> None:
    """Two schedules equal bitwise: JSON, latency and energy bits."""
    assert p.latency.hex() == j.latency.hex()
    assert p.energy.hex() == j.energy.hex()
    assert json.dumps(P.schedule_to_dict(p)) == json.dumps(
        J.schedule_to_dict(j))


def solve_both(spec, **kw):
    jg, jt, pg, pt = both(spec)
    j = J.solve_dag(jg, jt, J.EDGE_PUS, **kw)
    p = P.solve_dag(pg, pt, P.EDGE_PUS, **kw)
    same(j, p)
    return pg, pt, p


# ---------------------------------------------------------------------------
# oracle routes and the frontier DP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("objective", ["latency", "energy"])
def test_linear_dag_matches_reference_and_chain_dp(seed, objective):
    rng = np.random.default_rng(seed)
    spec = linear_spec(rng, n=int(rng.integers(2, 12)))
    g, table, dag = solve_both(spec, objective=objective)
    seq = P.solve_sequential(g.topo_order(), g.ops, table, P.EDGE_PUS,
                             objective)
    assert dag.mode == "chain"
    assert dag.latency == seq.latency and dag.energy == seq.energy
    assert dag.order == list(seq.chain)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("objective", ["latency", "energy"])
def test_union_of_chains_matches_reference_and_grid_sweep(seed, objective):
    rng = np.random.default_rng(100 + seed)
    g, table, dag = solve_both(union_spec(rng), objective=objective)
    wl = P.Workload.from_graph(g, table, P.EDGE_PUS)
    grid = P.solve_concurrent([wl.select(c) for c in g.components()],
                              P.ContentionModel(), objective,
                              algorithm="grid")
    assert dag.mode == "union-grid"
    assert dag.latency == grid.latency and dag.energy == grid.energy


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("objective", ["latency", "energy"])
def test_branch_dag_matches_reference_and_solve_parallel(seed, objective):
    rng = np.random.default_rng(200 + seed)
    g, table, dag = solve_both(branch_spec(rng), objective=objective)
    par = P.solve_parallel(g, table, P.EDGE_PUS, P.ContentionModel(),
                           objective)
    assert dag.mode == "phase"
    assert dag.latency == par.latency and dag.energy == par.energy


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("objective", ["latency", "energy"])
def test_frontier_on_unions_matches_reference_and_the_sweep(seed, objective):
    rng = np.random.default_rng(300 + seed)
    spec = union_spec(rng)
    _, _, grid = solve_both(spec, objective=objective,
                            algorithm="union-grid")
    _, _, fr = solve_both(spec, objective=objective, algorithm="frontier")
    assert fr.mode == "frontier"
    assert getattr(fr, objective) == getattr(grid, objective)


@pytest.mark.parametrize("seed", range(6))
def test_frontier_matches_reference_and_beats_serialization(seed):
    rng = np.random.default_rng(400 + seed)
    g, table, fr = solve_both(branch_spec(rng), algorithm="frontier")
    wl = P.Workload.from_graph(g, table, P.EDGE_PUS)
    w = np.where(np.isfinite(wl.dense.w), wl.dense.w, np.inf)
    assert fr.latency <= float(np.min(w, axis=1).sum()) + 1e-12
    done: set[int] = set()
    for st in fr.steps:
        assert all(set(g.pred[o]) <= done for o in st.ops)
        done |= set(st.ops)
    assert done == set(range(len(g.ops)))


def test_frontier_shares_group_tables_in_a_pool_as_the_reference():
    spec = branch_spec(np.random.default_rng(401))
    jg, jt, pg, pt = both(spec)
    jc, pc = J.ConcurrentCaches(), P.ConcurrentCaches()
    for objective in ("latency", "energy", "latency"):
        same(J.solve_dag(jg, jt, J.EDGE_PUS, objective=objective,
                         algorithm="frontier", caches=jc),
             P.solve_dag(pg, pt, P.EDGE_PUS, objective=objective,
                         algorithm="frontier", caches=pc))
    assert set(pc.group_tables) == set(jc.group_tables)


def _messages(call) -> tuple[str, str]:
    out = []
    for pkg in (J, P):
        with pytest.raises(Exception) as e:
            call(pkg)
        out.append((type(e.value).__name__, str(e.value)))
    return tuple(out)


def _harsh(pkg):
    """A contention model that overrides the group laws."""
    class Harsh(pkg.ContentionModel):
        def group_step_cost(self, times, pus):
            return 2.0 * sum(times)
    return Harsh()


def test_forced_route_validation_messages_match():
    diamond = diamond_spec()
    union = union_spec(np.random.default_rng(5))
    big = ([dict(name=f"c{i}", kind="add", in_shapes=((64,),),
                 out_shape=(64,)) for i in range(64)],
           [(0, i) for i in range(1, 64)])

    def solve(spec, **kw):
        def call(pkg):
            g = build(pkg, spec)
            return pkg.solve_dag(g, pkg.EdgeSoCCostModel().build_table(g),
                                 pkg.EDGE_PUS, **kw)
        return call

    def preds_free(pkg):
        g = build(pkg, diamond)
        table = pkg.EdgeSoCCostModel().build_table(g)
        wl = pkg.Workload.build(g.topo_order(), table, pkg.EDGE_PUS,
                                ops=g.ops)
        return pkg.solve_dag(g, table, pkg.EDGE_PUS, algorithm="frontier",
                             workload=wl)

    def short_workload(pkg):
        g = build(pkg, diamond)
        table = pkg.EdgeSoCCostModel().build_table(g)
        wl = pkg.Workload.build([0, 1, 2], table, pkg.EDGE_PUS,
                                ops=g.ops)
        return pkg.solve_dag(g, table, pkg.EDGE_PUS, workload=wl)

    def infeasible(pkg):
        ops = [pkg.FusedOp(name=f"n{i}", kind="matmul",
                           in_shapes=((1, 64, 64), (64, 64)),
                           out_shape=(1, 64, 64)) for i in range(4)]
        ops[3].name = "join_op"
        ops[3].meta["unsupported_on"] = ("CPU", "GPU")
        g = pkg.OpGraph(ops, edges=[(0, 1), (0, 2), (1, 3), (2, 3)])
        table = pkg.EdgeSoCCostModel().build_table(g)
        wl = pkg.Workload.from_graph(g, table, pkg.EDGE_PUS).under_condition(
            {}, unavailable=("NPU",))
        return pkg.solve_dag(g, table, pkg.EDGE_PUS, algorithm="frontier",
                             workload=wl)

    def harsh(alg):
        def call(pkg):
            g = build(pkg, union if alg == "union-grid" else diamond)
            return pkg.solve_dag(g, pkg.EdgeSoCCostModel().build_table(g),
                                 pkg.EDGE_PUS, _harsh(pkg),
                                 algorithm=alg)
        return call

    calls = [solve(diamond, algorithm="chain"),
             solve(diamond, algorithm="union-grid"),
             solve(diamond, algorithm="bogus"),
             solve(diamond, algorithm="frontier", max_states=3),
             solve(big, algorithm="frontier"),
             preds_free, short_workload, infeasible,
             harsh("union-grid"), harsh("frontier")]
    for call in calls:
        (jt, jm), (pt, pm) = _messages(call)
        assert (pt, pm) == (jt, jm)
    assert "join_op" in _messages(infeasible)[1][1]


def test_dag_schedule_json_roundtrip():
    jg, jt, pg, pt = both(diamond_spec())
    for alg in ("phase", "frontier"):
        sched = P.solve_dag(pg, pt, P.EDGE_PUS, algorithm=alg)
        text = json.dumps(P.schedule_to_dict(sched))
        back = P.schedule_from_dict(json.loads(text))
        assert isinstance(back, P.DagSchedule) and back == sched
        assert text == json.dumps(J.schedule_to_dict(
            J.solve_dag(jg, jt, J.EDGE_PUS, algorithm=alg)))


# ---------------------------------------------------------------------------
# execution: both paths bitwise the port's single-lane run, within 1e-5 of
# the reference's
# ---------------------------------------------------------------------------


def _payloads(jg, pg, seed=7):
    """Pure (8, 8)-latent payloads, NumPy on the reference graph and
    torch on the port's, from the same weights; external inputs for the
    sources."""
    rng = np.random.default_rng(seed)
    for jop, pop in zip(jg.ops, pg.ops):
        w = rng.standard_normal((8, 8)).astype(np.float32)
        wt = torch.from_numpy(w)

        def jfn(*args, _w=w):
            return np.tanh(sum(np.asarray(a, dtype=np.float32)
                               for a in args) @ _w)

        def pfn(*args, _w=wt):
            return torch.tanh(sum(args) @ _w)

        jop.fn, pop.fn = jfn, pfn
    xs = {i: rng.standard_normal((8, 8)).astype(np.float32)
          for i in range(len(jg.ops)) if not jg.pred[i]}
    return ({i: (x,) for i, x in xs.items()},
            {i: (torch.from_numpy(x),) for i, x in xs.items()})


def _shape_spec(shape):
    rng = np.random.default_rng(sum(map(ord, shape)))
    if shape == "chain":
        return linear_spec(rng, 5)
    if shape == "union":
        return union_spec(rng)
    return diamond_spec()


@pytest.mark.parametrize("alg", ["auto", "phase", "frontier"])
@pytest.mark.parametrize("shape", ["chain", "union", "diamond", "vla"])
def test_executed_dag_plan_matches_monolithic(shape, alg):
    if shape == "vla":
        jg, pg = JZ.vla_pipeline(), PZ.vla_pipeline()
        jt = J.EdgeSoCCostModel().build_table(jg)
        pt = P.EdgeSoCCostModel().build_table(pg)
    else:
        jg, jt, pg, pt = both(_shape_spec(shape))
    jin, pin = _payloads(jg, pg)
    ex = P.ScheduleExecutor(list(P.EDGE_PUS))
    ref = ex.run_monolithic(pg, pin)
    jref = J.ScheduleExecutor(list(J.EDGE_PUS)).run_monolithic(jg, jin)
    sched = P.solve_dag(pg, pt, P.EDGE_PUS, algorithm=alg)
    same(J.solve_dag(jg, jt, J.EDGE_PUS, algorithm=alg), sched)
    assert P.results_bitwise_equal(ex.run_dag(pg, sched, pin), ref)
    prog = ex.compile_dag(pg, sched)
    for _ in range(2):
        assert P.results_bitwise_equal(prog.run(pin), ref)
    for i in ref:
        np.testing.assert_allclose(ref[i].numpy(), jref[i], rtol=1e-5,
                                   atol=1e-5)
    prog.close()


def _bad_schedules(pkg):
    S, T = pkg.DagSchedule, pkg.DagStep
    kw = dict(latency=4.0, energy=0.0, objective="latency", mode="frontier")
    return [
        # the join (op 5) listed before its predecessors ran
        S(steps=[T(ops=(0,), pus=("CPU",), cost=1.0),
                 T(ops=(5,), pus=("CPU",), cost=1.0),
                 T(ops=(1, 2), pus=("CPU", "GPU"), cost=1.0),
                 T(ops=(3, 4), pus=("CPU", "GPU"), cost=1.0)], **kw),
        # an unknown lane
        S(steps=[T(ops=(0,), pus=("TPU",), cost=1.0)], **kw),
        # a schedule that does not cover the graph
        S(steps=[T(ops=(0,), pus=("CPU",), cost=1.0),
                 T(ops=(1, 2), pus=("CPU", "GPU"), cost=1.0)], **kw),
    ]


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("path", ["run_dag", "compile_dag"])
def test_executor_rejects_bad_dag_schedules_with_the_same_message(case,
                                                                  path):
    msgs = []
    for pkg in (J, P):
        g = build(pkg, diamond_spec())
        ex = pkg.ScheduleExecutor(list(pkg.EDGE_PUS))
        bad = _bad_schedules(pkg)[case]
        with pytest.raises(Exception) as e:
            if path == "run_dag":
                ex.run_dag(g, bad, {})
            else:
                ex.compile_dag(g, bad)
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[1] == msgs[0]
    if case == 0:
        assert msgs[1][0] == "InfeasibleScheduleError"
        assert "d5" in msgs[1][1] and "unmet predecessor" in msgs[1][1]


def test_a_fork_read_on_another_lane_ends_its_segment():
    """The producer of a fork goes on with its own tower on its lane: the
    consumer on the other lane waits for the producer's op alone, so the
    two towers overlap (without the fork cut the producer's segment
    would hold its whole tower, and the program would run serially)."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8, 8), dtype=np.float32))
    fns = [lambda a: a @ a.T, lambda a: a.tanh(), lambda a: a.sin(),
           lambda a: a.exp(), lambda a: a * 2.0]
    graph = P.OpGraph([P.FusedOp(name=f"f{i}", kind="other", fn=f)
                       for i, f in enumerate(fns)],
                      edges=[(0, 1), (1, 2), (0, 3), (3, 4)])
    sched = P.DagSchedule(
        steps=[P.DagStep(ops=(0,), pus=("a",), cost=1.0),
               P.DagStep(ops=(1, 3), pus=("a", "b"), cost=1.0),
               P.DagStep(ops=(2, 4), pus=("a", "b"), cost=1.0)],
        latency=3.0, energy=0.0, objective="latency", mode="frontier")
    ex = P.ScheduleExecutor(["a", "b"])
    prog = ex.compile_dag(graph, sched)
    assert [s.items for s in prog.lane_segments["a"]] == [
        [(0, 0)], [(0, 1), (0, 2)]]
    assert [s.deps for s in prog.lane_segments["b"]] == [[0]]
    assert not prog.stats["serial"]
    oracle = ex.run_dag(graph, sched, {0: (x,)})
    assert P.results_bitwise_equal(prog.run({0: (x,)}), oracle)
    assert P.results_bitwise_equal(ex.run_monolithic(graph, {0: (x,)}),
                                   oracle)
    prog.close()


# ---------------------------------------------------------------------------
# the orchestrator's DAG route
# ---------------------------------------------------------------------------


def _orchs(spec):
    jo = J.Orchestrator(J.EdgeSoCCostModel(), pus=J.EDGE_PUS)
    po = P.Orchestrator(P.EdgeSoCCostModel(), pus=P.EDGE_PUS)
    jg, pg = build(J, spec), build(P, spec)
    return jo, jo.register(jg), jg, po, po.register(pg), pg


def test_orchestrator_auto_routes_a_disconnected_graph_to_dag():
    jo, jh, _, po, ph, pg = _orchs(union_spec(np.random.default_rng(5)))
    plan = po.plan(ph)
    assert plan.kind == "dag" and plan.schedule.mode == "union-grid"
    assert plan.to_json() == jo.plan(jh).to_json()
    direct = P.solve_dag(pg, po._reg(ph).table, P.EDGE_PUS, po.contention)
    assert plan.latency.hex() == direct.latency.hex()


def test_orchestrator_dag_mode_matches_reference_hits_and_misses():
    jo, jh, _, po, ph, _ = _orchs(diamond_spec())
    calls = [dict(), dict(mode="dag"), dict(mode="dag"),
             dict(mode="dag", algorithm="frontier"),
             dict(mode="dag", algorithm="frontier", objective="energy"),
             dict(mode="dag", algorithm="phase"),
             dict(mode="dag", algorithm="frontier", max_states=1000),
             dict(mode="dag", algorithm="frontier")]
    for kw in calls:
        jp, pp = jo.plan(jh, **kw), po.plan(ph, **kw)
        assert (pp.kind, pp.mode) == (jp.kind, jp.mode)
        same(jp.schedule, pp.schedule)
        assert pp.to_json() == jp.to_json()
        for k in ("hits", "misses"):
            assert po.stats[k] == jo.stats[k], (kw, k)
    auto, dag = po.plan(ph), po.plan(ph, mode="dag")
    assert auto.kind == "parallel" and dag.schedule.mode == "phase"
    assert dag.latency == auto.latency and dag.energy == auto.energy
    assert po.plan(ph, mode="dag") is dag


def test_orchestrator_dag_argument_errors_match_reference():
    jo, jh, _, po, ph, _ = _orchs(diamond_spec())
    jh2 = jo.register(build(J, diamond_spec()))
    ph2 = po.register(build(P, diamond_spec()))
    for hs_j, hs_p, kw in [
            (jh, ph, dict(mode="dag", algorithm="grid")),
            (jh, ph, dict(mode="dag", algorithm="bogus")),
            ((jh, jh2), (ph, ph2), dict(mode="dag")),
            (jh, ph, dict(algorithm="frontier")),
            (jh, ph, dict(mode="dag", max_states=0))]:
        with pytest.raises(ValueError) as je:
            jo.plan(hs_j, **kw)
        with pytest.raises(ValueError) as pe:
            po.plan(hs_p, **kw)
        assert str(pe.value) == str(je.value)


def test_orchestrator_dag_plan_json_roundtrip_and_execute():
    jo, jh, jg, po, ph, pg = _orchs(diamond_spec())
    jin, pin = _payloads(jg, pg)
    plan = po.plan(ph, mode="dag", algorithm="frontier")
    restored = P.Plan.from_json(plan.to_json())
    assert restored.kind == "dag" and restored.schedule == plan.schedule
    assert restored.route == plan.route
    assert plan.to_json() == jo.plan(jh, mode="dag",
                                     algorithm="frontier").to_json()
    ref = po.executor.run_monolithic(pg, pin)
    assert P.results_bitwise_equal(po.execute(restored, pin), ref)
    assert P.results_bitwise_equal(po.execute(plan, pin, compile=False), ref)
    assert po.stats["program_misses"] == 1


# ---------------------------------------------------------------------------
# kernel chains joined into DAGs, on host lanes
# ---------------------------------------------------------------------------


def _join(pkg, chains, fork_at=None):
    """One graph over several chains' ops.  ``fork_at=(a, k)`` hangs
    chain 1 off op ``k`` of chain 0 (its first op takes that output
    instead of an external input); else the chains stay disjoint."""
    ops, edges, ext, base = [], [], {}, 0
    for c, (graph, cext) in enumerate(chains):
        for op in graph.ops:
            if c:
                op.name = f"t{c}.{op.name}"
            ops.append(op)
        edges += [(a + base, b + base) for a, b in graph.edges]
        if c and fork_at is not None:
            edges.append((fork_at, base))
        else:
            ext.update({i + base: v for i, v in cext.items()})
        base += len(graph.ops)
    return pkg.OpGraph(ops, edges=edges), ext


SHAPES = {"union": ((0, 1), None), "fork": ((0, 2), 1)}


@pytest.fixture(scope="module")
def kernel_dags():
    """Per DAG shape: the port's graph on the reference chains' arrays,
    its external inputs, and the JAX package's outputs for it."""
    out = {}
    for shape, (seeds, fork_at) in SHAPES.items():
        jchains = [jax_kernel_chain(seed=s, **CFG) for s in seeds]
        jgraph, jext = _join(J, jchains, fork_at)
        jres = J.ScheduleExecutor(["CPU"]).run_monolithic(jgraph, jext)
        pchains = [P.kernel_chain(arrays=reference_arrays(s, **CFG),
                                  device="cpu", **CFG) for s in seeds]
        pgraph, pext = _join(P, pchains, fork_at)
        assert [op.name for op in pgraph.ops] == [op.name for op in
                                                  jgraph.ops]
        assert pgraph.edges == jgraph.edges
        out[shape] = (pgraph, pext, jres)
    return out


def _lanes(kind):
    reg = default_registry(device="cpu")
    if kind == "host lanes":
        return {name: reg.get(name) for name in reg.names()}
    return {"torch-cpu": reg.get("torch-cpu"),
            "torch-cpu-b": P.Target("torch-cpu-b", kind="cpu", dialect="ref",
                                    device=torch.device("cpu"))}


def _table(lanes, graph, seed):
    """Seeded costs with each chain cheap on its own lane, so the plans
    co-schedule the two towers side by side."""
    rng = np.random.default_rng(seed)
    names = list(lanes)
    table = P.CostTable(names)
    for i, op in enumerate(graph.ops):
        home = names[1] if op.name.startswith("t1.") else names[0]
        for lane in names:
            w = float(rng.uniform(1e-4, 1e-3)) * (1.0 if lane == home
                                                  else 20.0)
            table.set(i, lane, P.CostEntry(kernel=w, dispatch=1e-5, h2d=0.0,
                                           d2h=0.0, power=10.0))
    return table


@pytest.mark.parametrize("lane_set", ["reference lanes", "host lanes"])
@pytest.mark.parametrize("shape,alg,mode", [
    ("union", "auto", "union-grid"), ("union", "frontier", "frontier"),
    ("fork", "auto", "phase"), ("fork", "frontier", "frontier")])
def test_kernel_chain_dags_compiled_on_host_lanes(kernel_dags, lane_set,
                                                  shape, alg, mode):
    graph, ext, jres = kernel_dags[shape]
    lanes = _lanes(lane_set)
    orch = P.Orchestrator(_table(lanes, graph, 11), targets=lanes)
    h = orch.register(graph)
    plan = orch.plan(h, mode="dag", algorithm=alg)
    assert plan.kind == "dag" and plan.schedule.mode == mode
    assert plan.schedule.n_parallel_steps > 0
    oracle = orch.execute(plan, ext, compile=False)      # run_dag
    cold = orch.execute(plan, ext)
    warm = orch.execute(plan, ext)
    again = orch.execute(plan, ext)
    prog = orch.program_for(plan, ext)
    assert not prog.stats["serial"]
    verdicts = list(prog.stats["variant_verified"].values())
    assert set(verdicts) <= {"bitwise", "tolerance"}
    assert P.results_bitwise_equal(cold, oracle)       # cold serves refs
    assert P.results_bitwise_equal(warm, again)
    if all(v == "bitwise" for v in verdicts):
        assert P.results_bitwise_equal(warm, oracle)
    else:
        atol, rtol = P.variant_tolerance(torch.float32)
        assert all(torch.allclose(warm[i], oracle[i], atol=atol, rtol=rtol)
                   for i in warm)
    if lane_set == "reference lanes":
        assert verdicts == []
    for i in range(len(graph)):
        np.testing.assert_allclose(warm[i].numpy(), np.asarray(jres[i]),
                                   rtol=1e-5, atol=1e-5)
    prog.close()
