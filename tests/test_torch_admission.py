"""Online admission and the warm re-planners of the port, against the
JAX package.

The serving lifecycle (``admit`` / ``advance`` / ``retire`` /
``replan_active``) is served by the pooled
:class:`IncrementalConcurrentSolver`; the cold ``solve_concurrent`` /
``solve_concurrent_horizon`` routes are its oracle.  These tests port
``tests/test_incremental_replan.py``'s ten cases (random admission /
advance / retire traces, windowed re-plans, the shrinking set, the
``None`` contract, infeasibility messages, eviction counters, bounded
caches) and hold every plan the port hands out bitwise to the port's
cold solve *and* to the reference orchestrator driven through the same
events: schedules, plan JSON, latencies' bits and the warm/cold counters.
The traces' condition events fold a slowdown into both sessions
(``on_condition``), as the reference's trace does.
"""
import json

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as P

PUS = ("CPU", "GPU", "NPU")


def _rows(rng, n_ops, drop_frac=0.2):
    """Per op: {pu: (kernel, dispatch, h2d, d2h, power)}, drawn as
    ``test_incremental_replan.random_model`` draws them."""
    ops = []
    for _ in range(n_ops):
        sup = [p for p in PUS if rng.random() > drop_frac]
        if not sup:
            sup = [PUS[int(rng.integers(len(PUS)))]]
        ops.append({pu: (float(rng.uniform(1e-6, 1e-3)),
                         float(rng.uniform(0, 1e-5)),
                         float(rng.uniform(0, 1e-4)),
                         float(rng.uniform(0, 1e-4)),
                         float(rng.uniform(5.0, 30.0))) for pu in sup})
    return ops


def _model(pkg, rows):
    table = pkg.CostTable(list(PUS))
    ops = []
    for i, row in enumerate(rows):
        ops.append(pkg.FusedOp(name=f"o{i}", kind="other", out_shape=(4,)))
        for pu, (k, d, h, o, w) in row.items():
            table.set(i, pu, pkg.CostEntry(kernel=k, dispatch=d, h2d=h,
                                           d2h=o, power=w))
    return pkg.chain_graph(ops), table


class Twin:
    """The same session in both packages: one orchestrator each over the
    same seeded models, driven by the same calls."""

    def __init__(self, seed, n_models=3, lo=4, hi=8, **kw):
        rng = np.random.default_rng(seed)
        rows = [_rows(rng, int(rng.integers(lo, hi)))
                for _ in range(n_models)]
        self.orch, self.hs = {}, {}
        for pkg in (J, P):
            models = [_model(pkg, r) for r in rows]
            orch = pkg.Orchestrator(models[0][1], **kw)
            self.orch[pkg] = orch
            self.hs[pkg] = [orch.register(g, table=t) for g, t in models]
        assert self.hs[J] == self.hs[P]
        self.handles = self.hs[P]

    def __call__(self, method, *args, **kw):
        """Call ``method`` on both sessions; the port's result (a plan,
        None, a count or an error) must equal the reference's."""
        got = {}
        for pkg in (J, P):
            try:
                got[pkg] = ("ok", getattr(self.orch[pkg], method)(*args,
                                                                  **kw))
            except (KeyError, ValueError, J.InfeasibleScheduleError,
                    P.InfeasibleScheduleError) as e:
                got[pkg] = (type(e).__name__, str(e))
        (jk, jv), (pk, pv) = got[J], got[P]
        assert pk == jk, (method, got)
        if jk != "ok":
            assert pv == jv
            return None
        assert (pv is None) == (jv is None), (method, got)
        if hasattr(jv, "to_json"):
            assert pv.to_json() == jv.to_json()
            assert pv.latency.hex() == jv.latency.hex()
            assert pv.energy.hex() == jv.energy.hex()
            assert pv.handles == jv.handles
        else:
            assert pv == jv
        for key in ("hits", "misses", "replans_warm", "replans_cold",
                    "plan_evictions", "warm_evictions"):
            assert self.orch[P].stats[key] == self.orch[J].stats[key], key
        return pv


def cold_reference(orch, objective, horizon_states=None):
    """Independent cold solve of the port orchestrator's active state:
    condition-scaled workloads, tails from progress, sorted handle
    order, fresh caches."""
    items = [(h, p) for h, p in sorted(orch._active.items())
             if p < orch.workload(h).n]
    if not items:
        return None
    wls = []
    for h, p in items:
        wl = orch.workload(h)
        if not orch.condition.nominal:
            wl = wl.under_condition(orch.condition.slowdown,
                                    orch.condition.unavailable)
        wls.append(wl if p == 0 else wl.tail(p))
    if horizon_states is not None:
        return P.solve_concurrent_horizon(wls, orch.contention, objective,
                                          caches=P.ConcurrentCaches(),
                                          horizon_states=horizon_states)
    return P.solve_concurrent(wls, orch.contention, objective,
                              caches=P.ConcurrentCaches())


def assert_bitwise(plan, cold):
    if plan is None or cold is None:
        assert plan is None and cold is None
        return
    s = plan.schedule
    assert s.latency == cold.latency
    assert s.energy == cold.energy
    assert s.steps == cold.steps


def replay_trace(seed, horizon_states=None, n_events=15):
    """A random admission / advance / retire / condition trace (the
    reference test's draw order), every plan held to the cold solve and
    to the reference session."""
    rng = np.random.default_rng(seed)
    twin = Twin(seed)
    orch = twin.orch[P]
    objective = "latency" if seed % 2 == 0 else "energy"
    pool = list(twin.handles)
    checked = 0
    for _ in range(n_events):
        ev = rng.random()
        if ev < 0.35 and pool:                       # admit
            h = pool.pop(int(rng.integers(len(pool))))
            plan = twin("admit", h, objective, horizon_states=horizon_states)
        elif ev < 0.70 and orch._active:             # advance + re-plan
            h = sorted(orch._active)[int(rng.integers(len(orch._active)))]
            twin("advance", h, int(rng.integers(1, 3)))
            plan = twin("replan_active", objective,
                        horizon_states=horizon_states)
        elif ev < 0.85 and orch._active:             # retire one member
            h = sorted(orch._active)[int(rng.integers(len(orch._active)))]
            twin("retire", h, objective, horizon_states=horizon_states)
            pool.append(h)
            plan = twin("replan_active", objective,
                        horizon_states=horizon_states)
        else:                                        # condition fold-in
            pu = PUS[int(rng.integers(len(PUS)))]
            factor = float(rng.uniform(1.0, 2.0))
            got, want = (twin.orch[pkg].on_condition(
                pkg.RuntimeCondition(slowdown={pu: factor}))
                for pkg in (P, J))
            assert {k: v.to_json() for k, v in got.items()} == \
                {k: v.to_json() for k, v in want.items()}
            plan = twin("replan_active", objective,
                        horizon_states=horizon_states)
        assert_bitwise(plan, cold_reference(orch, objective, horizon_states))
        if plan is not None:
            checked += 1
    return orch, checked


@pytest.mark.parametrize("seed", range(4))
def test_trace_full_replans_bitwise_equal_cold(seed):
    orch, checked = replay_trace(seed)
    assert checked > 0
    assert orch.stats["replans_warm"] > 0
    assert orch.stats["replans_cold"] == 0


@pytest.mark.parametrize("seed", range(2))
def test_trace_windowed_replans_bitwise_equal_cold(seed):
    orch, checked = replay_trace(seed, horizon_states=64)
    assert checked > 0
    assert orch.stats["replans_warm"] > 0
    assert orch.stats["replans_cold"] == 0


def test_shrinking_active_set_stays_bitwise():
    """M=3 -> 2 -> 1 retirement ladder, re-planning after each step."""
    twin = Twin(7)
    orch = twin.orch[P]
    for h in twin.handles:
        assert_bitwise(twin("admit", h), cold_reference(orch, "latency"))
    for h in twin.handles:
        twin("advance", h, 1)
    for h in twin.handles:
        twin("retire", h)
        plan = twin("replan_active")
        assert_bitwise(plan, cold_reference(orch, "latency"))


def test_admit_retire_none_contract():
    twin = Twin(11)
    orch = twin.orch[P]
    h0, h1, _ = twin.handles
    twin("admit", h0)
    twin("advance", h0, orch.workload(h0).n)
    assert twin("replan_active") is None
    assert twin("admit", h1) is not None     # an unfinished member again
    twin("advance", h1, orch.workload(h1).n)
    assert twin("admit", h0) is None         # everything fully advanced
    assert twin("retire", h0) is None        # survivor is fully advanced
    assert twin("retire", h1) is None        # active set empties
    # unknown handles and bad counts raise the reference's errors
    for call in (("retire", 12345), ("advance", 12345),
                 ("advance", h0, -1), ("admit", 999)):
        twin(*call)
    with pytest.raises(KeyError):
        orch.retire(12345)
    twin("admit", h0)
    with pytest.raises(ValueError, match="n_ops must be >= 0"):
        orch.advance(h0, -1)


def test_retire_to_empty_returns_none():
    twin = Twin(13)
    h0 = twin.handles[0]
    assert twin("admit", h0) is not None
    assert twin("retire", h0) is None


def test_infeasible_error_message_matches_cold():
    """A request with an op no PU can run (built directly, as the
    reference's test builds it) raises the same InfeasibleScheduleError
    from the warm solver as from the cold solve, in both packages, from
    any progress before the stranded op."""
    rng = np.random.default_rng(17)
    rows = [_rows(rng, 4, 0.0), _rows(rng, 5, 0.0), _rows(rng, 4, 0.0)]
    rows[0][2] = {}                 # op 2 of request 0: no PU runs it
    msgs = {}
    for pkg in (J, P):
        wls = []
        for row in rows:
            g, t = _model(pkg, row)
            chain = list(range(len(row)))
            wls.append(pkg.Workload(
                chain=chain, dense=pkg.DenseCostTable.from_chain(
                    chain, t, pkg.EDGE_PUS),
                pus=pkg.EDGE_PUS, ops=g.ops, table=t))
        inc = pkg.IncrementalConcurrentSolver(wls, pkg.ContentionModel())
        for progress in ([0, 0, 0], [1, 2, 1], [2, 0, 3]):
            with pytest.raises(pkg.InfeasibleScheduleError) as warm:
                inc.solve(progress)
            with pytest.raises(pkg.InfeasibleScheduleError) as cold:
                pkg.solve_concurrent(
                    [wl if p == 0 else wl.tail(p)
                     for wl, p in zip(wls, progress)],
                    pkg.ContentionModel())
            assert str(warm.value) == str(cold.value)
            assert "o2" in str(warm.value)
            msgs.setdefault(tuple(progress), []).append(str(warm.value))
    assert all(len(set(m)) == 1 for m in msgs.values())


def test_plan_cache_eviction_counters():
    twin = Twin(19, n_models=4, lo=4, hi=5, max_cached_plans=2)
    for h in twin.handles:
        twin("plan", [h])
    assert twin.orch[P].stats["plan_evictions"] >= 2
    assert len(twin.orch[P]._plans) <= 2


def test_warm_solver_eviction_counters():
    """The warm solvers are an LRU of ``max_cache_pools`` entries, one
    per active signature tuple, evictions counted as the reference
    counts them."""
    twin = Twin(23, max_cache_pools=1)
    h0, h1, _ = twin.handles
    assert twin("admit", h0) is not None
    assert twin("retire", h0) is None
    assert twin("admit", h1) is not None
    orch = twin.orch[P]
    assert orch.stats["warm_evictions"] >= 1
    assert len(orch._warm) <= 1
    assert orch.stats["warm_evictions"] == \
        twin.orch[J].stats["warm_evictions"]


def test_windowed_plan_mode_and_progress():
    """A horizon plan is a strict prefix: mode 'horizon' and every
    unfinished request advances at least one op."""
    twin = Twin(29)
    for h in twin.handles:
        twin("admit", h)
    plan = twin("replan_active", horizon_states=8)
    assert plan.schedule.mode == "horizon"
    for r in range(len(plan.handles)):
        assert any(st.ops[r] is not None for st in plan.schedule.steps)


def test_bounded_caches_still_bitwise():
    """Aggressively tiny cache budgets only cost rebuilds, never change
    plans."""
    twin = Twin(31)
    orch = twin.orch[P]
    for h in twin.handles:
        twin("admit", h)
    for pkg in (J, P):
        pool = twin.orch[pkg]._pool()
        pool.max_table_bytes = 1
        pool.max_group_scopes = 1
    for h in twin.handles:
        twin("advance", h, 1)
        assert_bitwise(twin("replan_active"),
                       cold_reference(orch, "latency"))


# ---------------------------------------------------------------------------
# the solvers themselves, against the reference's
# ---------------------------------------------------------------------------


def _workloads(pkg, rows):
    out = []
    for row in rows:
        g, t = _model(pkg, row)
        out.append(pkg.Workload.build(list(range(len(row))), t, pkg.EDGE_PUS,
                                      ops=g.ops))
    return out


def _same(j_sched, p_sched):
    assert json.dumps(P.schedule_to_dict(p_sched)) == \
        json.dumps(J.schedule_to_dict(j_sched))
    assert p_sched.latency.hex() == j_sched.latency.hex()
    assert p_sched.energy.hex() == j_sched.energy.hex()
    assert p_sched.mode == j_sched.mode


@pytest.mark.parametrize("objective", ["latency", "energy"])
@pytest.mark.parametrize("m,seed,budget", [(1, 0, 8), (2, 1, 16),
                                           (3, 2, 64), (3, 3, 1024),
                                           (4, 4, 96)])
def test_solve_concurrent_horizon_windows_bitwise(m, seed, budget,
                                                  objective):
    """Each window, and the next window from its frontier, bitwise the
    reference's, until every request is done."""
    rng = np.random.default_rng(seed)
    rows = [_rows(rng, int(rng.integers(5, 12)), 0.25) for _ in range(m)]
    wl = {pkg: _workloads(pkg, rows) for pkg in (J, P)}
    caches = {J: J.ConcurrentCaches(), P: P.ConcurrentCaches()}
    done = [0] * m
    windows = 0
    while True:
        active = [r for r in range(m) if done[r] < len(rows[r])]
        if not active:
            break
        got = {pkg: pkg.solve_concurrent_horizon(
            [wl[pkg][r].tail(done[r]) if done[r] else wl[pkg][r]
             for r in active], pkg.ContentionModel(), objective,
            caches=caches[pkg], horizon_states=budget) for pkg in (J, P)}
        _same(got[J], got[P])
        assert got[P].mode == "horizon"
        for st in got[P].steps:
            for k, o in enumerate(st.ops):
                done[active[k]] += o is not None
        windows += 1
    assert windows >= 1 + (budget < 100)


def test_horizon_and_solver_argument_errors_match():
    rows = [_rows(np.random.default_rng(5), 4) for _ in range(2)]
    for call in (
            lambda pkg, w: pkg.solve_concurrent_horizon([]),
            lambda pkg, w: pkg.solve_concurrent_horizon(w, horizon_states=1),
            lambda pkg, w: pkg.IncrementalConcurrentSolver([]),
            lambda pkg, w: pkg.IncrementalConcurrentSolver(w).solve([0]),
            lambda pkg, w: pkg.IncrementalConcurrentSolver(w).solve([0, 9]),
            lambda pkg, w: pkg.IncrementalConcurrentSolver(w).solve(
                [w[0].n, w[1].n]),
            lambda pkg, w: pkg.IncrementalConcurrentSolver(w).solve(
                [0, 0], horizon_states=1)):
        msgs = []
        for pkg in (J, P):
            with pytest.raises(ValueError) as e:
                call(pkg, _workloads(pkg, rows))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("objective", ["latency", "energy"])
@pytest.mark.parametrize("m,seed", [(2, 40), (3, 41), (4, 42)])
def test_incremental_solver_walk_bitwise(m, seed, objective):
    """One warm solver per package, walked through random progress
    states with and without a horizon: every schedule and the solver's
    own counters bitwise the reference's (the rolling route included, by
    a small ``max_states``)."""
    rng = np.random.default_rng(seed)
    rows = [_rows(rng, int(rng.integers(6, 10)), 0.25) for _ in range(m)]
    inc = {pkg: pkg.IncrementalConcurrentSolver(
        _workloads(pkg, rows), pkg.ContentionModel(), max_states=200,
        window_states=64) for pkg in (J, P)}
    ns = [len(r) for r in rows]
    progress = [0] * m
    while any(p < n for p, n in zip(progress, ns)):
        for hz in (None, 16):
            got = {pkg: inc[pkg].solve(progress, objective,
                                       horizon_states=hz)
                   for pkg in (J, P)}
            assert (got[J] is None) == (got[P] is None)
            if got[J] is not None:
                _same(got[J], got[P])
        r = int(rng.integers(m))
        progress[r] = min(ns[r], progress[r] + int(rng.integers(1, 3)))
    assert inc[P].stats == inc[J].stats
    assert inc[P].stats["solves"] > 0


def test_custom_laws_delegate_to_the_cold_route_as_the_reference_does():
    """Custom pair laws: the warm solver returns None (delegated) and the
    orchestrator's re-plan takes the cold pairwise route, counted as a
    cold re-plan, with the reference's plan JSON."""
    plans = {}
    for pkg in (J, P):
        class Harsh(pkg.ContentionModel):
            def co_exec(self, t_a, pu_a, t_b, pu_b):
                return 10.0 * t_a, 10.0 * t_b

            def pair_step_cost(self, t_a, pu_a, t_b, pu_b):
                return 10.0 * max(t_a, t_b)

        rng = np.random.default_rng(3)
        models = [_model(pkg, _rows(rng, 5, 0.0)) for _ in range(3)]
        orch = pkg.Orchestrator(models[0][1], contention=Harsh())
        hs = [orch.register(g, table=t) for g, t in models]
        out = [orch.admit(h).to_json() for h in hs]
        # a tail has no oracle cost table for the scalar pair laws: the
        # cold route refuses it, with the same message in both packages
        orch.advance(hs[0], 2)
        with pytest.raises(ValueError) as e:
            orch.replan_active()
        plans[pkg] = (out, str(e.value), orch.stats["replans_warm"],
                      orch.stats["replans_cold"])
    assert plans[P] == plans[J]
    assert plans[P][3] > 0
