"""Parity of the port's concurrent and parallel planning with the JAX
reference.

The planners are NumPy in both packages (``repro_torch.core`` keeps its
own copies of ``contention`` and of the concurrent part of ``search``),
so the same cost tables — drawn from the same seeded
``np.random.default_rng`` as ``tests/test_concurrent_m.py`` draws them —
must give the same schedules, latencies, energies and plan JSON,
bitwise, through both packages: every ``solve_concurrent`` route (the
grid's heap A* oracle also in ``tests/test_torch_zoo.py``), the aligned
pair solver, ``solve_parallel``, the two contention caches, and the
orchestrator's concurrent, aligned and parallel modes.
"""
import json

import numpy as np
import pytest

import repro.core as J
import repro.core.contention as JC
import repro_torch.core as P
import repro_torch.core.contention as PC

PUS = ("CPU", "GPU", "NPU")


def _rows(seed: int, sizes, drop_frac=0.25) -> list[list[dict]]:
    """Per request, per op: {pu: (kernel, dispatch, h2d, d2h, power)},
    drawn as ``test_concurrent_m.random_workload`` draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        ops = []
        for _ in range(n):
            sup = [p for p in PUS if rng.random() > drop_frac]
            if not sup:
                sup = [PUS[int(rng.integers(len(PUS)))]]
            ops.append({pu: (float(rng.uniform(1e-6, 1e-3)),
                             float(rng.uniform(0, 1e-5)),
                             float(rng.uniform(0, 1e-4)),
                             float(rng.uniform(0, 1e-4)),
                             float(rng.uniform(5.0, 30.0)))
                        for pu in sup})
        out.append(ops)
    return out


def _table(pkg, ops_rows):
    table = pkg.CostTable(list(PUS))
    for i, row in enumerate(ops_rows):
        for pu, (k, d, h, o, w) in row.items():
            table.set(i, pu, pkg.CostEntry(kernel=k, dispatch=d, h2d=h,
                                           d2h=o, power=w))
    return table


def _ops(pkg, n, tag=""):
    return [pkg.FusedOp(name=f"{tag}o{i}", kind="other", out_shape=(4,))
            for i in range(n)]


def _workloads(pkg, rows):
    return [pkg.Workload.build(list(range(len(r))), _table(pkg, r),
                               pkg.EDGE_PUS, ops=_ops(pkg, len(r)))
            for r in rows]


def _same(j_sched, p_sched):
    """Bitwise: the schedule dicts (every float through ``repr``) and the
    totals' bits."""
    assert json.dumps(P.schedule_to_dict(p_sched)) == \
        json.dumps(J.schedule_to_dict(j_sched))
    assert p_sched.latency.hex() == j_sched.latency.hex()
    assert p_sched.energy.hex() == j_sched.energy.hex()
    assert getattr(p_sched, "mode", None) == getattr(j_sched, "mode", None)


def _harsh(base):
    class Harsh(base):
        """Custom pair laws: the routes must fall back to pairwise and
        the scalar reference pair solvers."""

        def co_exec(self, t_a, pu_a, t_b, pu_b):
            return 10.0 * t_a, 10.0 * t_b

        def pair_step_cost(self, t_a, pu_a, t_b, pu_b):
            return 10.0 * max(t_a, t_b)
    return Harsh()


# ---------------------------------------------------------------------------
# solve_concurrent, every ported route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("objective", ["latency", "energy"])
@pytest.mark.parametrize("m,seed", [(1, 0), (2, 1), (2, 2), (3, 3), (3, 4),
                                    (4, 5)])
def test_solve_concurrent_auto_bitwise(m, seed, objective):
    rows = _rows(seed, [int(s) for s in
                        np.random.default_rng(seed).integers(3, 8, m)])
    j = J.solve_concurrent(_workloads(J, rows), J.ContentionModel(),
                           objective)
    p = P.solve_concurrent(_workloads(P, rows), P.ContentionModel(),
                           objective)
    _same(j, p)


@pytest.mark.parametrize("objective", ["latency", "energy"])
@pytest.mark.parametrize("algorithm,m,kw", [
    ("grid", 2, {}), ("grid", 3, {}), ("grid", 4, {}),
    ("astar", 2, {}), ("dijkstra", 2, {}),
    ("rolling", 3, {"window_states": 40}),
    ("rolling", 4, {"window_states": 30}),
    ("pairwise", 3, {}), ("pairwise", 4, {}),
])
def test_solve_concurrent_forced_routes_bitwise(algorithm, m, kw, objective):
    rows = _rows(10 + m, [5, 7, 4, 6][:m])
    j = J.solve_concurrent(_workloads(J, rows), J.ContentionModel(),
                           objective, algorithm=algorithm, **kw)
    p = P.solve_concurrent(_workloads(P, rows), P.ContentionModel(),
                           objective, algorithm=algorithm, **kw)
    _same(j, p)
    if algorithm == "rolling":
        assert p.mode == "rolling"


def test_auto_rolls_beyond_max_states_bitwise():
    rows = _rows(8, [9, 9, 9])
    j = J.solve_concurrent(_workloads(J, rows), J.ContentionModel(),
                           max_states=100)
    p = P.solve_concurrent(_workloads(P, rows), P.ContentionModel(),
                           max_states=100)
    assert p.mode == "rolling"
    _same(j, p)


@pytest.mark.parametrize("m", [2, 3])
def test_custom_laws_route_to_pairwise_bitwise(m):
    rows = _rows(4, [4] * m, drop_frac=0.0)
    j = J.solve_concurrent(_workloads(J, rows), _harsh(J.ContentionModel))
    p = P.solve_concurrent(_workloads(P, rows), _harsh(P.ContentionModel))
    if m == 3:
        assert p.mode == "pairwise"
    _same(j, p)
    assert not PC.uses_default_coexec(_harsh(P.ContentionModel))


def test_shared_caches_serve_both_objectives_bitwise():
    rows = _rows(21, [6, 5, 7])
    jc, pc = J.ConcurrentCaches(), P.ConcurrentCaches()
    for objective in ("latency", "energy", "latency"):
        _same(J.solve_concurrent(_workloads(J, rows), J.ContentionModel(),
                                 objective, caches=jc),
              P.solve_concurrent(_workloads(P, rows), P.ContentionModel(),
                                 objective, caches=pc))
    assert set(pc.pair) == set(jc.pair) and \
        set(pc.group_tables) == set(jc.group_tables)


def test_unported_routes_name_their_roadmap_item():
    """The routes that once raised naming item 7 — ``on_condition`` and
    ``execute(recover=True)``, now the default — behave as the
    reference's: a lane lost mid-run is folded into the session
    condition, the rest re-planned onto the survivors and resumed, with
    the same counters and plan JSON, for a chain and a concurrent
    plan."""
    rows = _rows(0, [3, 3], drop_frac=0.0)
    out = []
    for pkg in (P, J):
        orch, hs, _ = _orch(pkg, rows)
        res = []
        for handles in (hs[0], hs):
            plan = orch.plan(handles)
            lane = plan.route[0][1][1]
            faults = pkg.FaultPlan.single("pu_lost", lane=lane, op=1)
            got = orch.execute(plan, None if handles is hs[0]
                               else [None, None], faults=faults)
            got = got if isinstance(got, list) else [got]
            res.append(([sorted(d) for d in got], lane,
                        sorted(orch.condition.unavailable),
                        orch.plan(handles).to_json()))
            orch.on_condition(pkg.RuntimeCondition())
        out.append((res, orch.stats["recoveries"], orch.cache_stats()))
    assert out[0] == out[1]
    assert out[0][1] == 2


@pytest.mark.parametrize("objective", ["latency", "energy"])
def test_horizon_and_warm_replanners_match_the_reference(objective):
    """``solve_concurrent_horizon`` and ``IncrementalConcurrentSolver``
    (items 3 and 4, once asserted missing above) give the reference's
    schedules bitwise, from the start and from a progress state."""
    rows = _rows(0, [3, 3, 3])
    for budget in (4, 64):
        _same(J.solve_concurrent_horizon(_workloads(J, rows),
                                         J.ContentionModel(), objective,
                                         horizon_states=budget),
              P.solve_concurrent_horizon(_workloads(P, rows),
                                         P.ContentionModel(), objective,
                                         horizon_states=budget))
    inc = {pkg: pkg.IncrementalConcurrentSolver(_workloads(pkg, rows))
           for pkg in (J, P)}
    for progress in ([0, 0, 0], [1, 0, 2], [3, 1, 3]):
        for hz in (None, 8):
            _same(inc[J].solve(progress, objective, horizon_states=hz),
                  inc[P].solve(progress, objective, horizon_states=hz))
    assert inc[P].stats == inc[J].stats


@pytest.mark.parametrize("algorithm", ["grid", "grid_astar", "rolling",
                                       "pairwise"])
def test_infeasible_request_message_matches(algorithm):
    """An op no PU can run (built directly, as ``Workload.build``
    refuses it) raises the same typed error, naming request, op and
    position, on every route."""
    rows = _rows(30, [3, 4, 3], drop_frac=0.0)
    rows[1][2] = {}
    errs = []
    for pkg in (J, P):
        wls = _workloads(pkg, [rows[0], rows[2]])
        table = _table(pkg, rows[1])
        bad = pkg.Workload(chain=[0, 1, 2, 3],
                           dense=pkg.DenseCostTable.from_chain(
                               [0, 1, 2, 3], table, pkg.EDGE_PUS),
                           pus=pkg.EDGE_PUS, ops=_ops(pkg, 4), table=table)
        with pytest.raises(pkg.InfeasibleScheduleError) as e:
            pkg.solve_concurrent([wls[0], bad, wls[1]], algorithm=algorithm)
        errs.append(str(e.value))
    assert errs[1] == errs[0] and "request 1: op 2" in errs[1]


# ---------------------------------------------------------------------------
# the pair solvers and the contention caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("objective", ["latency", "energy"])
@pytest.mark.parametrize("seed", [0, 1])
def test_aligned_pair_solver_bitwise(seed, objective):
    rows = _rows(40 + seed, [6, 8])
    out = []
    for pkg in (J, P):
        t0, t1 = _table(pkg, rows[0]), _table(pkg, rows[1])
        c0, c1 = list(range(6)), list(range(8))
        fast = pkg.solve_concurrent_aligned(c0, t0, c1, t1, pkg.EDGE_PUS,
                                            pkg.ContentionModel(), objective)
        ref = pkg.search.solve_concurrent_aligned_reference(
            c0, t0, c1, t1, pkg.EDGE_PUS, pkg.ContentionModel(), objective)
        out.append((fast, ref))
    _same(out[0][0], out[1][0])
    _same(out[0][1], out[1][1])


@pytest.mark.parametrize("objective", ["latency", "energy"])
def test_joint_reference_solver_bitwise(objective):
    rows = _rows(50, [5, 6])
    out = []
    for pkg in (J, P):
        t0, t1 = _table(pkg, rows[0]), _table(pkg, rows[1])
        out.append(pkg.search.solve_concurrent_joint_reference(
            list(range(5)), t0, list(range(6)), t1, pkg.EDGE_PUS,
            pkg.ContentionModel(), objective))
    _same(*out)


def test_pair_cost_cache_bitwise():
    rows = _rows(60, [7, 9])
    jw, pw = _workloads(J, rows), _workloads(P, rows)
    jc = JC.PairCostCache(JC.ContentionModel(), jw[0].dense, jw[1].dense)
    pc = PC.PairCostCache(PC.ContentionModel(), pw[0].dense, pw[1].dense)
    for objective in ("latency", "energy"):
        for a, b in zip(jc.edge_tables(objective), pc.edge_tables(objective)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert pc.nbytes() == jc.nbytes()


@pytest.mark.parametrize("g", [2, 3])
def test_group_cost_cache_bitwise(g):
    """Held against the reference's own cache, not the scalar
    enumeration: at g = 3 the reference's energy table is one ulp from
    that enumeration (``test_grid_sweep.py``), and the port keeps the
    reference's summation order."""
    rows = _rows(200 + g, [int(s) for s in
                           np.random.default_rng(g).integers(3, 7, g)])
    jw, pw = _workloads(J, rows), _workloads(P, rows)
    jc = JC.GroupCostCache(JC.ContentionModel(), [w.dense for w in jw])
    pc = PC.GroupCostCache(PC.ContentionModel(), [w.dense for w in pw])
    for objective in ("latency", "energy"):
        for a, b in zip(jc.edge_tables(objective), pc.edge_tables(objective)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_batched_group_laws_bitwise():
    rng = np.random.default_rng(7)
    jm, pm = JC.ContentionModel(), PC.ContentionModel()
    for g in (2, 3, 4):
        pus_ = [PUS[int(i)] for i in rng.integers(0, 3, g)]
        ts = rng.uniform(1e-6, 1e-3, (64, g))
        pws = rng.uniform(5.0, 30.0, (64, g))
        assert pm.group_step_cost_batch(ts, pus_).tobytes() == \
            jm.group_step_cost_batch(ts, pus_).tobytes()
        assert pm.group_energy_batch(ts, pws, pus_).tobytes() == \
            jm.group_energy_batch(ts, pws, pus_).tobytes()


# ---------------------------------------------------------------------------
# solve_parallel on a fork/join graph
# ---------------------------------------------------------------------------


FORK_EDGES = [(0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 5), (5, 6),
              (6, 7), (6, 8), (7, 9), (8, 9)]


def _fork(pkg, rows):
    ops = _ops(pkg, len(rows))
    return pkg.OpGraph(ops, edges=FORK_EDGES), _table(pkg, rows)


@pytest.mark.parametrize("objective", ["latency", "energy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_parallel_bitwise(seed, objective):
    rows = _rows(70 + seed, [10])[0]
    out = []
    for pkg in (J, P):
        graph, table = _fork(pkg, rows)
        out.append(pkg.solve_parallel(graph, table, pkg.EDGE_PUS,
                                      pkg.ContentionModel(), objective))
    _same(*out)
    if objective == "latency" and seed == 0:   # a parallel phase won
        assert any(ph.parallel for ph in out[1].phases)


# ---------------------------------------------------------------------------
# the orchestrator's new modes, against the reference orchestrator
# ---------------------------------------------------------------------------


def _orch(pkg, rows_per_req, fork_rows=None):
    tables = [_table(pkg, r) for r in rows_per_req]
    orch = pkg.Orchestrator(tables[0], pus=pkg.EDGE_PUS)
    hs = [orch.register(_ops(pkg, len(r), f"r{k}"), table=t)
          for k, (r, t) in enumerate(zip(rows_per_req, tables))]
    hf = None
    if fork_rows is not None:
        graph, table = _fork(pkg, fork_rows)
        hf = orch.register(graph, table=table)
    return orch, hs, hf


@pytest.mark.parametrize("objective", ["latency", "energy"])
def test_orchestrator_new_modes_bitwise(objective):
    rows = _rows(80, [6, 5, 7, 4])
    fork = _rows(81, [10])[0]
    jo, jh, jf = _orch(J, rows, fork)
    po, ph, pf = _orch(P, rows, fork)
    calls = [
        dict(handles=jh[:2]), dict(handles=jh[:3]), dict(handles=jh),
        dict(handles=jh[:3], mode="concurrent"),
        dict(handles=jh[:1], mode="concurrent"),
        dict(handles=jh[:2], mode="aligned"),
        dict(handles=jh[:3], algorithm="grid"),
        dict(handles=jh[:3], algorithm="rolling"),
        dict(handles=jh[:3], algorithm="pairwise"),
        dict(handles=jh[:3], max_states=50),
        dict(handles=jf), dict(handles=jf, mode="parallel"),
        dict(handles=jh[0], mode="parallel"),
    ]
    for call in calls:
        hs = call.pop("handles")
        # the handles are registration indices, equal in both sessions
        jp = jo.plan(hs, objective=objective, **call)
        pp = po.plan(hs, objective=objective, **call)
        assert pp.to_json() == jp.to_json(), call
        assert (pp.kind, pp.mode) == (jp.kind, jp.mode)
        assert pp.latency.hex() == jp.latency.hex()
        assert pp.route == jp.route
        back = P.Plan.from_json(pp.to_json())
        assert back.to_json() == pp.to_json()
        again = po.plan(hs, objective=objective, **call)
        assert again.to_json() == pp.to_json()
        jo.plan(hs, objective=objective, **call)
    assert (po.stats["hits"], po.stats["misses"]) == \
        (jo.stats["hits"], jo.stats["misses"])
    assert po.stats["hits"] >= len(calls)


def test_orchestrator_argument_checks_match():
    rows = _rows(90, [4, 4, 4])
    jo, jh, _ = _orch(J, rows)
    po, ph, _ = _orch(P, rows)
    bad = [
        dict(handles=jh[:3], mode="aligned"),
        dict(handles=jh[:2], mode="sequential"),
        dict(handles=jh[0], algorithm="grid"),
        dict(handles=jh[:1], mode="concurrent", algorithm="grid"),
        dict(handles=jh[:2], algorithm="bogus"),
        dict(handles=jh[:2], max_states=0),
        dict(handles=jh[:2], mode="nope"),
        # the DAG route's and the grid A*'s own argument checks
        dict(handles=jh[0], mode="dag", algorithm="grid"),
        dict(handles=jh[0], mode="dag", algorithm="grid_astar"),
        dict(handles=jh[:2], mode="dag"),
        dict(handles=jh[0], algorithm="frontier"),
        dict(handles=jh[:2], mode="concurrent", algorithm="frontier"),
        dict(handles=jh[0], algorithm="grid_astar"),
        dict(handles=jh[:3], algorithm="grid_astar", max_states=10),
        dict(handles=jh[:2], algorithm="grid_astar", max_states=10),
    ]
    for call in bad:
        hs = call.pop("handles")
        with pytest.raises(ValueError) as je:
            jo.plan(hs, **call)
        with pytest.raises(ValueError) as pe:
            po.plan(hs, **call)
        assert str(pe.value) == str(je.value)


def test_session_calls_of_later_slices_name_their_items():
    """``on_condition`` (item 7, once asserted missing here) inside the
    admission loop: the same calls give the same re-stitched plans, plan
    JSON and counters in both packages."""
    jo, jh, _ = _orch(J, _rows(91, [3, 3], drop_frac=0.0))
    po, ph, _ = _orch(P, _rows(91, [3, 3], drop_frac=0.0))
    conds = [dict(slowdown={"GPU": 8.0}), dict(unavailable={"NPU"}),
             dict(slowdown={"CPU": 2.0}, unavailable={"GPU"}), dict()]
    for h in ph:
        assert po.admit(h).to_json() == jo.admit(h).to_json()
    po.advance(ph[0], 1)
    jo.advance(jh[0], 1)
    for kw in conds:
        want = jo.on_condition(J.RuntimeCondition(
            slowdown=kw.get("slowdown", {}),
            unavailable=frozenset(kw.get("unavailable", ()))))
        got = po.on_condition(P.RuntimeCondition(
            slowdown=kw.get("slowdown", {}),
            unavailable=frozenset(kw.get("unavailable", ()))))
        assert {k: v.to_json() for k, v in got.items()} == \
            {k: v.to_json() for k, v in want.items()}, kw
        assert po.replan_active().to_json() == \
            jo.replan_active().to_json(), kw
    assert po.stats == jo.stats and po.stats["invalidated"] > 0


def test_session_admission_calls_match_the_reference():
    """``admit`` / ``advance`` / ``retire`` / ``replan_active`` (item 5,
    once asserted missing above): the same calls give the same plan
    JSON, progress counts and ``None`` results in both packages."""
    jo, jh, _ = _orch(J, _rows(91, [3, 3]))
    po, ph, _ = _orch(P, _rows(91, [3, 3]))
    assert jh == ph
    calls = [("admit", ph[0]), ("advance", ph[0]), ("admit", ph[1]),
             ("replan_active",), ("advance", ph[1], 2),
             ("replan_active",), ("retire", ph[0]), ("advance", ph[1], 5),
             ("replan_active",), ("retire", ph[1])]
    for name, *args in calls:
        want, got = getattr(jo, name)(*args), getattr(po, name)(*args)
        if hasattr(want, "to_json"):
            assert got.to_json() == want.to_json(), name
        else:
            assert got == want, name
    assert po.stats["replans_warm"] == jo.stats["replans_warm"] > 0
