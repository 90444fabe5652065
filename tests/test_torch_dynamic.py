"""Parity of the port's runtime conditions and dynamic scheduler with
the JAX reference, and of the orchestrator's condition handling.

``core/dynamic.py`` is NumPy in both packages, so the same cost tables
(seeded ``np.random.default_rng`` rows, and the paper's analytic chain
of ``tests/test_dynamic.py``) must give the same condition keys,
adjusted tables, remap events, stitched plans, realised latencies and
error messages, bitwise (floats compared by ``float.hex``).  The
orchestrator's ``on_condition`` must invalidate the same cached plans,
return the same re-stitched plans and leave the same plan JSON, cache
counters and condition views behind, for chain, fork, union-DAG and
concurrent plans.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

import repro.core as J
import repro.core.costmodel as JCM
import repro.core.dynamic as JD
import repro_torch.core as P
import repro_torch.core.costmodel as PCM
import repro_torch.core.dynamic as PD
from test_torch_concurrent import _fork, _ops, _rows, _table

PUS = ("CPU", "GPU", "NPU")

CONDITIONS = [
    dict(),
    dict(slowdown={"GPU": 4.0}),
    dict(slowdown={"GPU": 1.01}),
    dict(slowdown={"CPU": 1.5, "NPU": 0.5}),
    dict(unavailable=frozenset({"GPU"})),
    dict(slowdown={"NPU": 3.0}, unavailable=frozenset({"CPU"})),
]


def _cond(pkg, kw):
    return pkg.RuntimeCondition(**kw)


def _analytic_chain(pkg, cm, n):
    ops = [cm.make_matmul(512, name=f"mm{i}") if i % 2 == 0
           else cm.make_cumsum(4096, 128) for i in range(n)]
    g = pkg.OpGraph(ops)
    return g, pkg.AnalyticProfiler().profile(g)


def _sched_same(p, j):
    assert p.assignment == j.assignment
    assert p.latency.hex() == j.latency.hex()
    assert p.energy.hex() == j.energy.hex()


@pytest.mark.parametrize("kw", CONDITIONS)
def test_condition_keys_and_their_algebra_match(kw):
    pc, jc = _cond(P, kw), _cond(J, kw)
    assert pc.key(PUS) == jc.key(PUS)
    assert pc.nominal == jc.nominal
    for p, j in ((pc.lose("NPU"), jc.lose("NPU")),
                 (pc.restore("GPU"), jc.restore("GPU")),
                 (pc.lose("CPU").restore("CPU", "NPU"),
                  jc.lose("CPU").restore("CPU", "NPU"))):
        assert p.key(PUS) == j.key(PUS)
        assert (dict(p.slowdown), p.unavailable) == \
            (dict(j.slowdown), j.unavailable)
        assert p.factor("GPU") == j.factor("GPU")


@pytest.mark.parametrize("kw", CONDITIONS)
def test_adjusted_table_is_the_reference(kw):
    rows = _rows(3, [7])[0]
    p = PD.adjusted_table(_table(P, rows), _cond(P, kw))
    j = JD.adjusted_table(_table(J, rows), _cond(J, kw))
    assert p.pus == j.pus
    got = {k: (e.kernel.hex(), e.dispatch, e.h2d, e.d2h, e.power)
           for k, e in p.items()}
    want = {k: (e.kernel.hex(), e.dispatch, e.h2d, e.d2h, e.power)
            for k, e in j.items()}
    assert got == want


@pytest.mark.parametrize("objective", ["latency", "energy"])
@pytest.mark.parametrize("pos", [0, 3, 5, 9])
@pytest.mark.parametrize("kw", CONDITIONS[1:])
def test_on_condition_remaps_as_the_reference(kw, pos, objective):
    out = []
    for pkg, cm in ((P, PCM), (J, JCM)):
        g, table = _analytic_chain(pkg, cm, 10)
        dyn = pkg.DynamicScheduler(g.topo_order(), g.ops, table,
                                   pkg.EDGE_PUS, objective)
        plan = dyn.on_condition(pos, _cond(pkg, kw))
        out.append((dyn, plan))
    (pd, pp), (jd, jp) = out
    _sched_same(pp, jp)
    assert [vars(e) for e in pd.events] == [vars(e) for e in jd.events]
    for e_p, e_j in zip(pd.events, jd.events):
        assert e_p.old_tail_cost.hex() == e_j.old_tail_cost.hex()
        assert e_p.new_tail_cost.hex() == e_j.new_tail_cost.hex()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_realises_the_reference_latency(seed):
    rng = np.random.default_rng(seed)
    n = 12
    script = {int(p): CONDITIONS[int(rng.integers(1, len(CONDITIONS)))]
              for p in rng.choice(n, 3, replace=False)}
    rows = _rows(50 + seed, [n], drop_frac=0.0)[0]
    out = []
    for pkg in (P, J):
        dyn = pkg.DynamicScheduler(list(range(n)), _ops(pkg, n),
                                   _table(pkg, rows), pkg.EDGE_PUS,
                                   replan_threshold=0.02)
        try:
            total = dyn.simulate({p: _cond(pkg, kw)
                                  for p, kw in script.items()})
            res = ("ok", total.hex())
        except pkg.InfeasibleScheduleError as e:
            res = ("infeasible", str(e))
        out.append((res, dyn.plan, [vars(e) for e in dyn.events]))
    (pr, pplan, pev), (jr, jplan, jev) = out
    assert pr == jr
    _sched_same(pplan, jplan)
    assert pev == jev


def test_total_loss_and_unsupported_assignment_fail_alike():
    msgs = []
    for pkg, cm in ((P, PCM), (J, JCM)):
        g, table = _analytic_chain(pkg, cm, 6)
        chain = g.topo_order()
        dyn = pkg.DynamicScheduler(chain, g.ops, table, pkg.EDGE_PUS)
        doom = pkg.RuntimeCondition(unavailable=frozenset(PUS))
        with pytest.raises(pkg.InfeasibleScheduleError) as e1:
            dyn.simulate({3: doom})
        dyn = pkg.DynamicScheduler(chain, g.ops, table, pkg.EDGE_PUS)
        dyn.plan.assignment[4] = "NPU"
        dyn.workload = dyn.workload.under_condition({}, {"NPU"})
        with pytest.raises(pkg.InfeasibleScheduleError) as e2:
            dyn.simulate({})
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[0] == msgs[1]


def test_tile_split_and_ridge_match():
    for n in (256, 1024, 2048):
        a = [cm.make_matmul(n) for cm in (PCM, JCM)]
        b = [cm.make_eltwise("add", 1 << 22) for cm in (PCM, JCM)]
        for pu in PUS:
            p = PD.tile_split(a[0], b[0], PCM.EDGE_PUS[pu], n_tiles=6)
            j = JD.tile_split(a[1], b[1], JCM.EDGE_PUS[pu], n_tiles=6)
            assert p[:2] == j[:2] and p[2].hex() == j[2].hex()
            for nbytes in (1, 2):
                assert PD.ridge_intensity(PCM.EDGE_PUS[pu], nbytes) == \
                    JD.ridge_intensity(JCM.EDGE_PUS[pu], nbytes)


# ---------------------------------------------------------------------------
# the orchestrator's session condition
# ---------------------------------------------------------------------------


def _session(pkg):
    """Three chains and a fork, each with its own table; handles 0-2 are
    the chains, 3 the fork."""
    rows = _rows(80, [6, 5, 7], drop_frac=0.0)
    tables = [_table(pkg, r) for r in rows]
    orch = pkg.Orchestrator(tables[0], pus=pkg.EDGE_PUS,
                            max_cache_pools=3)
    hs = [orch.register(_ops(pkg, len(r), f"r{k}"), table=t)
          for k, (r, t) in enumerate(zip(rows, tables))]
    graph, table = _fork(pkg, _rows(81, [10], drop_frac=0.0)[0])
    hs.append(orch.register(graph, table=table))
    return orch, hs


PLANS = [dict(handles=0), dict(handles=(0, 1)), dict(handles=(0, 1, 2)),
         dict(handles=3), dict(handles=3, mode="dag"),
         dict(handles=(0, 1), mode="aligned")]


def _plan_all(orch, objective="latency"):
    out = []
    for call in PLANS:
        call = dict(call)
        out.append(orch.plan(call.pop("handles"), objective=objective,
                             **call).to_json())
    return out


def test_on_condition_invalidates_and_restitches_as_the_reference():
    (po, ph), (jo, jh) = _session(P), _session(J)
    for orch in (po, jo):
        for objective in ("latency", "energy"):
            _plan_all(orch, objective)
        orch.admit(0)
        orch.admit(1)
        orch.advance(0, 2)
        orch.dynamic(1, "energy", replan_threshold=0.0)
    assert po.cache_stats() == jo.cache_stats()
    for kw in CONDITIONS[1:] + [CONDITIONS[1], dict()]:
        got = po.on_condition(_cond(P, kw))
        want = jo.on_condition(_cond(J, kw))
        assert sorted(got) == sorted(want), kw
        for key in want:
            assert got[key].to_json() == want[key].to_json(), (kw, key)
        assert po.stats["invalidated"] == jo.stats["invalidated"], kw
        assert _plan_all(po) == _plan_all(jo), kw
        assert po.replan_active().to_json() == jo.replan_active().to_json()
        assert po.cache_stats() == jo.cache_stats(), kw
        assert po._cond_key() == jo._cond_key()
    assert po.stats == jo.stats
    assert po.stats["invalidated"] > 0 and po.stats["cond_view_evictions"] > 0


def test_dag_plans_follow_the_condition():
    """The DAG route's workload is priced under the session condition (a
    dag-tagged condition view), as in the reference."""
    (po, ph), (jo, jh) = _session(P), _session(J)
    for kw in (dict(slowdown={"GPU": 6.0}), dict(unavailable={"NPU"})):
        for orch, pkg in ((po, P), (jo, J)):
            orch.on_condition(pkg.RuntimeCondition(
                slowdown=kw.get("slowdown", {}),
                unavailable=frozenset(kw.get("unavailable", ()))))
        for alg in ("auto", "frontier"):
            p = po.plan(3, mode="dag", algorithm=alg)
            j = jo.plan(3, mode="dag", algorithm=alg)
            assert p.to_json() == j.to_json()
            if "unavailable" in kw:
                assert "NPU" not in json.dumps(p.route)


def test_on_condition_rejects_unknown_pus_and_dynamic_needs_a_chain():
    (po, ph), (jo, jh) = _session(P), _session(J)
    for orch, pkg in ((po, P), (jo, J)):
        with pytest.raises(ValueError, match="unknown PU"):
            orch.on_condition(pkg.RuntimeCondition(slowdown={"gpu": 2.0}))
        with pytest.raises(ValueError, match="chain graph"):
            orch.dynamic(3)
    assert po.dynamic(0).plan.assignment == jo.dynamic(0).plan.assignment
