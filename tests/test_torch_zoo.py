"""Parity of the port's paper zoo and of the grid's retained heap A*
(``solve_concurrent(..., algorithm="grid_astar")``) with the JAX
reference.

* Every ``zoo()`` graph and ``vla_pipeline()`` has the reference's ops
  (name, kind, shapes, ``dtype_bytes``, ``unsupported_on``) and edges.
* ``vla_pipeline``'s sequential, phase and frontier plans on
  ``EdgeSoCCostModel`` tables are bitwise the reference's, and the
  frontier beats the sequential route (``tests/test_dag.py``).
* The heap A* is bitwise the reference's at M = 3 and 4 for both
  objectives, with and without a shared cache pool, and equal in
  objective to the port's own vectorized sweep (``"grid"``) as
  ``tests/test_grid_sweep.py`` holds the reference's two.
"""
from __future__ import annotations

import json

import pytest

import repro.core as J
import repro.core.paperzoo as JZ
import repro_torch.core as P
import repro_torch.core.paperzoo as PZ
from test_torch_concurrent import _rows, _same, _workloads


def _op_fields(op) -> tuple:
    return (op.name, op.kind, tuple(map(tuple, op.in_shapes)),
            tuple(op.out_shape), op.dtype_bytes,
            tuple(op.meta.get("unsupported_on", ())))


def test_zoo_names_match():
    assert PZ.ZOO_NAMES == JZ.ZOO_NAMES
    assert list(PZ.zoo()) == list(JZ.zoo())


@pytest.mark.parametrize("name", list(JZ.ZOO_NAMES) + ["vla_pipeline"])
def test_zoo_graph_matches_reference(name):
    if name == "vla_pipeline":
        jg, pg = JZ.vla_pipeline(), PZ.vla_pipeline()
    else:
        jg, pg = JZ.zoo()[name], PZ.zoo()[name]
    assert [_op_fields(op) for op in pg.ops] == \
        [_op_fields(op) for op in jg.ops]
    assert pg.edges == jg.edges
    assert pg.topo_order() == jg.topo_order()
    # the analytic cost model prices them bitwise alike
    jt = J.EdgeSoCCostModel().build_table(jg)
    pt = P.EdgeSoCCostModel().build_table(pg)
    assert sorted((k, v.kernel.hex(), v.power.hex()) for k, v in pt.items()) \
        == sorted((k, v.kernel.hex(), v.power.hex()) for k, v in jt.items())


@pytest.mark.parametrize("objective", ["latency", "energy"])
def test_vla_pipeline_plans_match_reference(objective):
    jg, pg = JZ.vla_pipeline(), PZ.vla_pipeline()
    jt = J.EdgeSoCCostModel().build_table(jg)
    pt = P.EdgeSoCCostModel().build_table(pg)
    js = J.solve_sequential(jg.topo_order(), jg.ops, jt, J.EDGE_PUS,
                            objective)
    ps = P.solve_sequential(pg.topo_order(), pg.ops, pt, P.EDGE_PUS,
                            objective)
    _same(js, ps)
    plans = {}
    for alg in ("auto", "phase", "frontier"):
        j = J.solve_dag(jg, jt, J.EDGE_PUS, objective=objective,
                        algorithm=alg)
        p = P.solve_dag(pg, pt, P.EDGE_PUS, objective=objective,
                        algorithm=alg)
        _same(j, p)
        plans[alg] = p
    assert plans["auto"].mode == "phase"
    fr = plans["frontier"]
    assert fr.n_parallel_steps > 0
    assert getattr(fr, objective) < getattr(ps, objective)
    # the orchestrator's DAG route gives the same plans and JSON
    jo = J.Orchestrator(J.EdgeSoCCostModel(), pus=J.EDGE_PUS)
    po = P.Orchestrator(P.EdgeSoCCostModel(), pus=P.EDGE_PUS)
    jh, ph = jo.register(jg), po.register(pg)
    for kw in (dict(), dict(mode="dag"), dict(mode="dag",
                                              algorithm="frontier")):
        assert po.plan(ph, objective, **kw).to_json() == \
            jo.plan(jh, objective, **kw).to_json()


@pytest.mark.parametrize("objective", ["latency", "energy"])
@pytest.mark.parametrize("m,seed", [(3, 40), (3, 41), (4, 42)])
def test_grid_astar_matches_reference_and_the_sweep(m, seed, objective):
    rows = _rows(seed, [5, 4, 6, 3][:m])
    j = J.solve_concurrent(_workloads(J, rows), J.ContentionModel(),
                           objective, algorithm="grid_astar")
    p = P.solve_concurrent(_workloads(P, rows), P.ContentionModel(),
                           objective, algorithm="grid_astar")
    _same(j, p)
    assert p.mode == "joint-grid"
    grid = P.solve_concurrent(_workloads(P, rows), P.ContentionModel(),
                              objective, algorithm="grid")
    # the relation tests/test_grid_sweep.py holds the two to: bitwise in
    # latency; energy mode has exact ties between grouping structures,
    # which may differ by accumulated rounding
    if objective == "latency":
        assert p.latency == grid.latency
    else:
        assert p.energy == pytest.approx(grid.energy, rel=1e-11)


def test_grid_astar_shares_its_memo_in_a_pool_as_the_reference():
    rows = _rows(43, [4, 5, 3])
    jc, pc = J.ConcurrentCaches(), P.ConcurrentCaches()
    for objective in ("latency", "energy", "latency"):
        _same(J.solve_concurrent(_workloads(J, rows), J.ContentionModel(),
                                 objective, algorithm="grid_astar",
                                 caches=jc),
              P.solve_concurrent(_workloads(P, rows), P.ContentionModel(),
                                 objective, algorithm="grid_astar",
                                 caches=pc))
    assert list(pc.group) == list(jc.group)
    assert json.dumps(sorted(map(repr, pc.group[next(iter(pc.group))]))) == \
        json.dumps(sorted(map(repr, jc.group[next(iter(jc.group))])))
