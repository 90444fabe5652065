"""Parity of the port's host planning layer with the JAX reference.

The planning layer is NumPy in both packages (``repro_torch.core`` keeps
its own copies of ``op``, ``costmodel``, ``workload``, ``graph``,
``schedule`` and the sequential solvers), so the same cost table — built
from the same NumPy numbers — must give the same route and the same
``schedule_to_dict`` JSON, bitwise, through both packages' orchestrators
and solvers.
"""
import json

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as P
import repro_torch.core.backends as PB

KINDS = ("matmul", "attention", "act", "scan", "gather", "norm")


def _numbers(seed: int, n: int, pus: list[str]) -> list[dict]:
    """Per-op {pu: (kernel, dispatch, h2d, d2h, power)} with a few
    unsupported cells; the first PU supports everything (feasible)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {}
        for j, pu in enumerate(pus):
            if j and rng.random() < 0.15:
                continue
            row[pu] = tuple(float(x) for x in (
                rng.lognormal(-7, 1.5), rng.uniform(1e-6, 5e-5),
                rng.uniform(0, 1e-3), rng.uniform(0, 1e-3),
                rng.uniform(5, 30)))
        rows.append(row)
    return rows


def _plan_json(pkg, rows, pus_specs, n, objective) -> tuple[str, str]:
    ops = [pkg.FusedOp(name=f"op{i}", kind=KINDS[i % len(KINDS)],
                       in_shapes=((8, 16),), out_shape=(8, 16))
           for i in range(n)]
    table = pkg.CostTable(list(pus_specs))
    for i, row in enumerate(rows):
        for pu, (k, d, h, o, w) in row.items():
            table.set(i, pu, pkg.CostEntry(kernel=k, dispatch=d, h2d=h,
                                           d2h=o, power=w))
    orch = pkg.Orchestrator(table, pus=pus_specs)
    plan = orch.plan(orch.register(ops), objective=objective)
    direct = {alg: pkg.solve_sequential(list(range(n)), ops, table,
                                        pus_specs, objective, algorithm=alg)
              for alg in ("dp", "dp_reference", "dijkstra")}
    assert all(s.assignment == plan.schedule.assignment
               for s in direct.values())
    return (json.dumps(pkg.schedule_to_dict(plan.schedule)), plan.to_json())


@pytest.mark.parametrize("objective", ["latency", "energy"])
@pytest.mark.parametrize("seed,n", [(0, 12), (1, 40), (2, 200)])
def test_edge_pus_plan_bitwise_equal(seed, n, objective):
    rows = _numbers(seed, n, list(J.EDGE_PUS))
    j_sched, j_plan = _plan_json(J, rows, J.EDGE_PUS, n, objective)
    p_sched, p_plan = _plan_json(P, rows, P.EDGE_PUS, n, objective)
    assert p_sched == j_sched
    assert p_plan == j_plan


@pytest.mark.parametrize("objective", ["latency", "energy"])
@pytest.mark.parametrize("seed", [3, 4])
def test_target_lanes_plan_bitwise_equal(seed, objective):
    """The port's four lanes, priced as their targets declare, against
    the reference's ``Target`` carrying the same pricing fields."""
    fields = ("name", "kind", "is_accelerator", "dispatch_s", "handoff_s",
              "power_compute", "power_memory")
    cuda = dict(kind="cuda", is_accelerator=True, dispatch_s=1e-5,
                handoff_s=PB.builtin.CUDA_HANDOFF_S, power_compute=700.0,
                power_memory=400.0)
    port_targets = [PB.numpy_eager(), PB.torch_cpu(),
                    P.Target("cuda:0", **cuda),
                    P.Target("cuda-kernels", dialect="cuda", **cuda)]
    ref_targets = [J.Target(**{f: getattr(t, f) for f in fields})
                   for t in port_targets]
    p_specs = P.targets.pu_specs_for_targets({t.name: t for t in port_targets})
    j_specs = J.pu_specs_for_targets({t.name: t for t in ref_targets})
    rows = _numbers(seed, 24, list(p_specs))
    assert _plan_json(P, rows, p_specs, 24, objective) == \
        _plan_json(J, rows, j_specs, 24, objective)


def test_plan_json_round_trip_and_cache():
    rows = _numbers(5, 16, list(P.EDGE_PUS))
    ops = [P.FusedOp(name=f"op{i}", kind="matmul", in_shapes=((4, 4),),
                     out_shape=(4, 4)) for i in range(16)]
    table = P.CostTable(list(P.EDGE_PUS))
    for i, row in enumerate(rows):
        for pu, (k, d, h, o, w) in row.items():
            table.set(i, pu, P.CostEntry(kernel=k, dispatch=d, h2d=h,
                                         d2h=o, power=w))
    orch = P.Orchestrator(table, pus=P.EDGE_PUS)
    h = orch.register(ops)
    plan = orch.plan(h)
    assert orch.plan(h) is plan and orch.stats["hits"] == 1
    back = P.Plan.from_json(plan.to_json())
    assert back.route == plan.route and back.latency == plan.latency
    # two requests: the concurrent search, as the reference plans it
    pair = orch.plan([h, h])
    jtable = J.CostTable(list(J.EDGE_PUS))
    for i, row in enumerate(rows):
        for pu, (k, d, hh, o, w) in row.items():
            jtable.set(i, pu, J.CostEntry(kernel=k, dispatch=d, h2d=hh,
                                          d2h=o, power=w))
    jorch = J.Orchestrator(jtable, pus=J.EDGE_PUS)
    jh = jorch.register([J.FusedOp(name=f"op{i}", kind="matmul",
                                   in_shapes=((4, 4),), out_shape=(4, 4))
                         for i in range(16)])
    assert pair.kind == "concurrent"
    assert pair.to_json() == jorch.plan([jh, jh]).to_json()
    assert P.Plan.from_json(pair.to_json()).route == pair.route
    # one chain through the DAG front door: the chain DP, as the
    # reference plans it
    dag = orch.plan(h, mode="dag")
    assert dag.kind == "dag" and dag.schedule.mode == "chain"
    assert dag.to_json() == jorch.plan(jh, mode="dag").to_json()
    assert dag.latency.hex() == plan.latency.hex()
    assert P.Plan.from_json(dag.to_json()).route == dag.route
