"""PU-loss recovery (``Orchestrator.execute(recover=True)``, the default)
against the JAX reference, on the CPU.

Small kernel chains (1 block, seq 64, 2 heads of 16, the reference
chain's weights) run as sequential, parallel (a fork of two chains),
DAG (a union of two chains) and concurrent (two chains, two handles)
plans on two host lanes named after the reference's CPU and GPU, whose
``PUSpec``\\ s both packages plan with.  For every op of each plan, a
``pu_lost`` fault on the lane that op is planned on goes through the
compiled path of both packages; each package folds the loss into its
session condition, re-plans the remaining ops onto the survivor and
resumes on the interpreter.  The recovered outputs are within 1e-5 of
the JAX package's and bitwise the port's fault-free run,
``stats["recoveries"]`` is equal, and the degraded session plans as the
reference's does (plan JSON).  Every test runs under a hard time limit.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as P
from repro.core.modelgraph import kernel_chain as jax_kernel_chain
from test_torch_dag import _join
from test_torch_main_path import CFG, reference_arrays
from test_torch_serve import hard_timeout

LANES = ("CPU", "GPU")


@pytest.fixture(autouse=True)
def _no_hang():
    with hard_timeout(120.0):
        yield


def _pus(pkg):
    return {name: pkg.EDGE_PUS[name] for name in LANES}


def _table(pkg, graph, seed):
    """Seeded costs: each chain (ops named ``t1.*`` are the second) cheap
    on its own lane, and the first chain's ops alternate lanes in pairs,
    so every plan uses both lanes."""
    rng = np.random.default_rng(seed)
    table = pkg.CostTable(list(LANES))
    for i, op in enumerate(graph.ops):
        home = 1 if op.name.startswith("t1.") else (i // 2) % 2
        for j, lane in enumerate(LANES):
            w = float(rng.uniform(1e-4, 1e-3)) * (1.0 if j == home else 5.0)
            table.set(i, lane, pkg.CostEntry(kernel=w, dispatch=1e-5,
                                             h2d=0.0, d2h=0.0, power=10.0))
    return table


def _graphs(pkg, chains):
    """(graphs, per-request inputs) of each plan kind."""
    c0, c1 = chains
    return {
        "sequential": ([c0[0]], [c0[1]]),
        "parallel": tuple([x] for x in _join(pkg, [c0, c1], fork_at=1)),
        "dag": tuple([x] for x in _join(pkg, [c0, c1])),
        "concurrent": ([c0[0], c1[0]], [c0[1], c1[1]]),
    }


@pytest.fixture(scope="module")
def cases():
    """Per plan kind: each package's graphs and inputs."""
    jc = [jax_kernel_chain(seed=s, **CFG) for s in (0, 1)]
    pc = [P.kernel_chain(arrays=reference_arrays(s, **CFG), device="cpu",
                         **CFG) for s in (0, 1)]
    jg, pg = _graphs(J, jc), _graphs(P, pc)
    return {kind: (jg[kind], pg[kind]) for kind in jg}


def _session(pkg, graphs, kind):
    """A fresh session over ``graphs`` (each with its own table) and its
    plan of ``kind``."""
    tables = [_table(pkg, g, 40 + k) for k, g in enumerate(graphs)]
    orch = pkg.Orchestrator(tables[0], pus=_pus(pkg))
    hs = [orch.register(g, table=t) for g, t in zip(graphs, tables)]
    plan = orch.plan(hs if kind == "concurrent" else hs[0])
    assert plan.kind == kind
    return orch, plan


def _outputs(kind, res):
    return res if kind == "concurrent" else [res]


def _points(plan):
    """Every (request, op, planned lane) of a plan."""
    return [(r, i, lane) for r, route in enumerate(plan.route)
            for i, lane in route]


@pytest.mark.parametrize("kind", ["sequential", "parallel", "dag",
                                  "concurrent"])
def test_pu_loss_at_every_op_recovers_as_the_reference(cases, kind):
    """One session per package; after each recovery the nominal
    condition is restored, so the next run replays the cached program.
    A chain's program runs inline, so its frontier at the loss — and with
    it every re-plan, cache entry and counter — is the reference's; the
    other plans run one thread per lane, and how far the surviving lane
    got before the loss surfaced is a matter of timing."""
    (jgraphs, jins), (pgraphs, pins) = cases[kind]
    one = kind != "concurrent"
    one_lane_order = kind == "sequential"
    jin, pin = (jins[0], pins[0]) if one else (jins, pins)
    po, pplan = _session(P, pgraphs, kind)
    jo, jplan = _session(J, jgraphs, kind)
    assert pplan.to_json() == jplan.to_json()
    assert set(lane for _, _, lane in _points(pplan)) == set(LANES)
    clean = _outputs(kind, po.execute(pplan, pin))
    jo.execute(jplan, jin)
    hs = tuple(range(len(pgraphs))) if kind == "concurrent" else 0
    for n, (r, i, lane) in enumerate(_points(pplan), 1):
        pf = P.FaultPlan.single("pu_lost", lane=lane, op=i)
        jf = J.FaultPlan.single("pu_lost", lane=lane, op=i)
        got = _outputs(kind, po.execute(pplan, pin, faults=pf))
        want = _outputs(kind, jo.execute(jplan, jin, faults=jf))
        where = f"{kind}: loss of {lane} at op {i} of request {r}"
        assert [f[:2] for f in pf.fired] == [("pu_lost", lane)], where
        assert po.stats["recoveries"] == jo.stats["recoveries"] == n, where
        assert po.condition.unavailable == jo.condition.unavailable \
            == frozenset({lane}), where
        for g, w, c in zip(got, want, clean):
            assert sorted(g) == sorted(w) == sorted(c), where
            assert P.results_bitwise_equal(g, c), where
            for k in g:
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=where)
        # the degraded session plans on the survivor, as the reference's
        again = po.plan(hs)
        assert again.to_json() == jo.plan(hs).to_json(), where
        assert {ln for _, _, ln in _points(again)} == set(LANES) - {lane}
        for orch in (po, jo):
            orch.on_condition(type(orch.condition)())
        if one_lane_order:
            assert po.cache_stats() == jo.cache_stats(), where
        pplan, jplan = po.plan(hs), jo.plan(hs)
    if one_lane_order:
        assert po.stats == jo.stats


def test_recover_false_propagates_the_loss_with_its_frontier(cases):
    (jgraphs, jins), (pgraphs, pins) = cases["sequential"]
    po, pplan = _session(P, pgraphs, "sequential")
    jo, jplan = _session(J, jgraphs, "sequential")
    r, i, lane = _points(pplan)[3]
    with pytest.raises(P.PULostError) as pe:
        po.execute(pplan, pins[0], recover=False,
                   faults=P.FaultPlan.single("pu_lost", lane=lane, op=i))
    with pytest.raises(J.PULostError) as je:
        jo.execute(jplan, jins[0], recover=False,
                   faults=J.FaultPlan.single("pu_lost", lane=lane, op=i))
    assert (pe.value.pu, pe.value.op) == (je.value.pu, je.value.op)
    assert [sorted(d) for d in pe.value.partial] == \
        [sorted(d) for d in je.value.partial]
    assert po.stats["recoveries"] == jo.stats["recoveries"] == 0
    assert po.condition.nominal


def test_interpreter_path_recovers_from_an_op_frontier(cases):
    """On the interpreter the frontier is per op: every op before the
    lost one is kept, and the tail runs on the survivor."""
    (jgraphs, jins), (pgraphs, pins) = cases["sequential"]
    po, pplan = _session(P, pgraphs, "sequential")
    jo, jplan = _session(J, jgraphs, "sequential")
    clean = po.execute(pplan, pins[0], compile=False)
    for n, (r, i, lane) in enumerate(_points(pplan), 1):
        got = po.execute(pplan, pins[0], compile=False,
                         faults=P.FaultPlan.single("pu_lost", lane=lane,
                                                   op=i))
        want = jo.execute(jplan, jins[0], compile=False,
                          faults=J.FaultPlan.single("pu_lost", lane=lane,
                                                    op=i))
        assert po.stats["recoveries"] == jo.stats["recoveries"] == n
        assert P.results_bitwise_equal(got, clean)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5)
        for orch in (po, jo):
            orch.on_condition(type(orch.condition)())
        pplan, jplan = po.plan(0), jo.plan(0)


def test_a_loss_of_every_lane_fails_alike_in_both_packages(cases):
    """With every lane lost the re-plan has no PU for the remaining ops:
    the same error, with the same message, from both packages."""
    (jgraphs, jins), (pgraphs, pins) = cases["sequential"]
    po, pplan = _session(P, pgraphs, "sequential")
    jo, jplan = _session(J, jgraphs, "sequential")
    errs = []
    for pkg, orch, plan, ins in ((P, po, pplan, pins), (J, jo, jplan, jins)):
        faults = pkg.FaultPlan([pkg.FaultSpec("pu_lost", lane=lane)
                                for lane in LANES])
        with pytest.raises(ValueError) as e:
            orch.execute(plan, ins[0], faults=faults)
        errs.append(e.value)
    assert type(errs[0]).__name__ == type(errs[1]).__name__
    assert str(errs[0]) == str(errs[1])
    assert po.stats["recoveries"] == jo.stats["recoveries"] == 2
    assert po.condition.unavailable == jo.condition.unavailable
