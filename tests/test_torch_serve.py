"""The port's serving engine against the JAX reference, on the CPU.

* **Traces.**  ``ArrivalTrace`` (``poisson``, ``bursty``) and
  ``ChaosTrace`` JSON is the reference's string for string, and the
  validation errors are the same.
* **Virtual mode.**  The same models over the same seeded cost table,
  served from the same trace, give every request the same admission,
  finish and shed times and shed reasons, the same ``makespan`` (by
  ``float.hex``), re-plan counts and occupancy — with and without SLOs,
  with bursts, and under a condition that strands a model.
* **Real mode under chaos.**  Two small kernel chains (1 block, seq 64,
  2 heads of 16, the reference chain's weights) served on two host
  lanes that run the reference payloads, through the interpreter and
  through compiled window programs, under the four scenarios of the
  reference's chaos bench (a transient storm, a straggler, a stalled
  lane, a lost lane that returns): the run drains
  (``completed + shed == n``), no completed request is a silent wrong
  answer (``bitwise_failures == 0``: each is bitwise its solo run with
  the assignment it was given, which on these lanes is the port's
  ``run_monolithic`` and within 1e-5 of the JAX package's), every
  scripted event fired, and no handle leaks.  Breaker transitions depend
  on wall-clock timing, so they are checked for their shape only, never
  compared between runs.  Every test runs under a hard time limit.
"""
from __future__ import annotations

import contextlib
import signal

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as P
from repro.core.executor import ScheduleExecutor as JExecutor
from repro.core.modelgraph import kernel_chain as jax_kernel_chain
from test_torch_main_path import CFG, reference_arrays

PUS = ("CPU", "GPU", "NPU")


class HardTimeout(Exception):
    pass


@contextlib.contextmanager
def hard_timeout(seconds: float):
    def handler(signum, frame):
        raise HardTimeout(f"exceeded the {seconds}s hard limit — a serving "
                          "path blocked")
    old = signal.signal(signal.SIGALRM, handler)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _no_hang():
    with hard_timeout(60.0):
        yield


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,kw", [
    ("poisson", dict(rate=5.0, n=20, seed=3)),
    ("poisson", dict(rate=700.0, n=9, seed=11, slo=0.02)),
    ("bursty", dict(rate=7.0, n=15, seed=5, slo=0.25)),
    ("bursty", dict(rate=40.0, n=12, burst_every=3, burst_size=4,
                    burst_span=1e-2, seed=2)),
])
def test_arrival_trace_json_is_the_reference(kind, kw):
    models = ["x", "y", "z"]
    p = getattr(P.ArrivalTrace, kind)(models, **kw)
    j = getattr(J.ArrivalTrace, kind)(models, **kw)
    assert p.to_json() == j.to_json()
    back = P.ArrivalTrace.from_json(j.to_json())
    assert back.arrivals == p.arrivals and back.kind == p.kind


def test_chaos_trace_json_and_validation_are_the_reference():
    events = [dict(time=0.2, kind="pu_lost", lane="GPU"),
              dict(time=0.05, kind="transient", rid=3, count=2),
              dict(time=0.4, kind="pu_restored", lane="GPU"),
              dict(time=0.1, kind="stall", lane="CPU", delay=0.4)]
    p = P.ChaosTrace([P.ChaosEvent(**e) for e in events], kind="mixed",
                     seed=9)
    j = J.ChaosTrace([J.ChaosEvent(**e) for e in events], kind="mixed",
                     seed=9)
    assert p.to_json() == j.to_json()
    assert P.ChaosTrace.from_json(j.to_json()).events == p.events
    assert P.CHAOS_KINDS == J.CHAOS_KINDS
    spec = p.events[0].spec()
    assert (spec.kind, spec.lane, spec.count) == ("transient", None, 2)
    for bad in (dict(time=0.0, kind="meteor"),
                dict(time=0.0, kind="pu_lost"),
                dict(time=-1.0, kind="transient", rid=0)):
        with pytest.raises(ValueError) as pe:
            P.ChaosEvent(**bad)
        with pytest.raises(ValueError) as je:
            J.ChaosEvent(**bad)
        assert str(pe.value) == str(je.value)
    for bad in (dict(rate=0.0, n=3), dict(rate=1.0, n=-1)):
        with pytest.raises(ValueError) as pe:
            P.ArrivalTrace.poisson(["x"], **bad)
        with pytest.raises(ValueError) as je:
            J.ArrivalTrace.poisson(["x"], **bad)
        assert str(pe.value) == str(je.value)


# ---------------------------------------------------------------------------
# virtual mode
# ---------------------------------------------------------------------------


def _virtual_engine(pkg, seed, lengths=(4, 5, 3), npu_only_idx=None,
                    **engine_kw):
    """``tests/test_serve.py``'s engine: chain models over one shared
    seeded cost table, in either package."""
    rng = np.random.default_rng(seed)
    table = pkg.CostTable(list(PUS))
    for i in range(max(lengths)):
        sup = ("NPU",) if i == npu_only_idx else PUS
        for pu in sup:
            table.set(i, pu, pkg.CostEntry(
                kernel=float(rng.uniform(1e-5, 1e-3)),
                dispatch=float(rng.uniform(0, 1e-5)),
                h2d=float(rng.uniform(0, 1e-4)),
                d2h=float(rng.uniform(0, 1e-4)),
                power=float(rng.uniform(5.0, 30.0))))
    models = {f"model{k}": pkg.chain_graph(
        [pkg.FusedOp(name=f"m{k}o{i}", kind="other", out_shape=(4,))
         for i in range(n)]) for k, n in enumerate(lengths)}
    orch = pkg.Orchestrator(table)
    return orch, pkg.ServingEngine(orch, models, **engine_kw)


def _records(rep):
    return [(r.rid, r.model, r.arrival, r.deadline, r.ops_total, r.ops_done,
             r.admitted_at, r.finished_at, r.shed, r.shed_reason)
            for r in rep.requests]


def _same_virtual(prep, jrep):
    assert _records(prep) == _records(jrep)
    assert prep.makespan.hex() == jrep.makespan.hex()
    for f in ("n_requests", "completed", "shed", "plan_events",
              "replans_warm", "replans_cold", "shed_reasons"):
        assert getattr(prep, f) == getattr(jrep, f), f
    for f in ("throughput", "latency_p50", "latency_p99", "occupancy_mean"):
        assert getattr(prep, f).hex() == getattr(jrep, f).hex(), f


@pytest.mark.parametrize("case", [
    dict(seed=0, engine=dict(max_concurrent=3),
         trace=("poisson", dict(rate=50.0, n=15, seed=1))),
    dict(seed=1, engine=dict(max_concurrent=1),
         trace=("poisson", dict(rate=400.0, n=8, seed=4))),
    dict(seed=2, engine=dict(max_concurrent=2, slo_factor=1.6),
         trace=("bursty", dict(rate=300.0, n=12, seed=6))),
    dict(seed=3, engine=dict(max_concurrent=3, horizon_states=None),
         trace=("bursty", dict(rate=90.0, n=10, seed=8, slo=4e-3))),
    dict(seed=4, engine=dict(max_concurrent=2, objective="energy",
                             horizon_states=16),
         trace=("poisson", dict(rate=200.0, n=10, seed=9))),
])
def test_virtual_serving_is_the_reference(case):
    reps = []
    for pkg in (P, J):
        orch, eng = _virtual_engine(pkg, case["seed"], **case["engine"])
        kind, kw = case["trace"]
        trace = getattr(pkg.ArrivalTrace, kind)(list(eng._graphs), **kw)
        reps.append((eng.serve(trace), orch))
    (prep, po), (jrep, jo) = reps
    _same_virtual(prep, jrep)
    assert prep.cache == jrep.cache
    assert po.stats["replans_warm"] == jo.stats["replans_warm"] > 0
    assert po._active == jo._active == {}


def test_virtual_serving_sheds_a_stranded_model_as_the_reference():
    reps = []
    for pkg in (P, J):
        orch, eng = _virtual_engine(pkg, 3, npu_only_idx=4,
                                    max_concurrent=3)
        orch.on_condition(pkg.RuntimeCondition(unavailable={"NPU"}))
        trace = pkg.ArrivalTrace.poisson(list(eng._graphs), rate=200.0,
                                         n=9, seed=3)
        reps.append(eng.serve(trace))
    _same_virtual(*reps)
    assert reps[0].shed_reasons == {"infeasible": reps[0].shed} != {}


def test_virtual_serving_refuses_chaos_as_the_reference():
    for pkg in (P, J):
        _, eng = _virtual_engine(pkg, 0)
        trace = pkg.ArrivalTrace.poisson(["model0"], rate=10.0, n=2, seed=0)
        chaos = pkg.ChaosTrace([pkg.ChaosEvent(time=0.0, kind="transient",
                                               rid=0)])
        with pytest.raises(ValueError, match="execution='real'"):
            eng.serve(trace, chaos=chaos)


# ---------------------------------------------------------------------------
# real mode under chaos, on two host lanes
# ---------------------------------------------------------------------------

LANES = {"torch-cpu": P.Target("torch-cpu", kind="cpu", dialect="ref",
                               device=torch.device("cpu")),
         "torch-cpu-b": P.Target("torch-cpu-b", kind="cpu", dialect="ref",
                                 device=torch.device("cpu"))}


@pytest.fixture(scope="module")
def chains():
    """Per model: the port's chain on the reference chain's arrays, its
    inputs, and the JAX package's outputs for it."""
    out = {}
    for name, seed in (("A", 0), ("B", 1)):
        jgraph, jext = jax_kernel_chain(seed=seed, **CFG)
        graph, ext = P.kernel_chain(arrays=reference_arrays(seed, **CFG),
                                    device="cpu", **CFG)
        out[name] = (graph, ext, JExecutor(["CPU"]).run_monolithic(
            jgraph, jext))
    return out


def _real_engine(chains, **kw):
    """A fresh engine per run (chaos changes the session condition): one
    seeded table for both six-op chains, each op cheaper on one lane."""
    rng = np.random.default_rng(7)
    table = P.CostTable(list(LANES))
    for i in range(len(chains["A"][0])):
        for j, lane in enumerate(LANES):
            w = float(rng.uniform(2e-4, 8e-4)) * (1.0 if j == i % 2 else 2.0)
            table.set(i, lane, P.CostEntry(kernel=w, dispatch=1e-5, h2d=0.0,
                                           d2h=0.0, power=10.0))
    orch = P.Orchestrator(table, targets=LANES)
    kw.setdefault("max_concurrent", 2)
    eng = P.ServingEngine(orch, {m: c[0] for m, c in chains.items()},
                          execution="real",
                          inputs={m: c[1] for m, c in chains.items()}, **kw)
    return orch, eng


def _predicted(orch, eng):
    return orch.plan(eng._base["A"]).latency


def _check_run(orch, eng, rep, chains, chaos=None):
    """Drained, no silent wrong answer, every scripted event fired, no
    leaked handle; each completed request bitwise ``run_monolithic`` and
    within 1e-5 of the JAX package."""
    assert rep.completed + rep.shed == rep.n_requests
    assert rep.bitwise_failures == 0
    assert rep.bitwise_checked == rep.completed
    assert orch._active == {}
    free = [h for hs in eng._free.values() for h in hs]
    assert len(free) == len(set(free))
    mono = {m: eng.orch.executor.run_monolithic(c[0], c[1])
            for m, c in chains.items()}
    for rec in rep.requests:
        if rec.shed:
            assert rec.shed_reason in P.SHED_REASONS
            continue
        assert rec.bitwise_ok is True and rec.handle is None
        assert sorted(rec.assignment) == list(range(rec.ops_total))
        assert set(rec.assignment.values()) <= set(LANES)
        assert P.results_bitwise_equal(rec.results, mono[rec.model])
        jres = chains[rec.model][2]
        for i, v in rec.results.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jres[i]),
                                       rtol=1e-5, atol=1e-5)
    for ev in (chaos.events if chaos is not None else ()):
        if ev.kind == "pu_restored":
            continue
        fired = [f for f in eng.faults.fired if f[0] == ev.kind
                 and (ev.lane is None or f[1] == ev.lane)]
        assert fired, f"scripted {ev.kind} on {ev.lane} never fired"
        if ev.count > 0:
            assert len(fired) == ev.count


@pytest.mark.parametrize("compile_exec", [False, True])
def test_fault_free_real_serving_is_bitwise(chains, compile_exec):
    orch, eng = _real_engine(chains, compile_exec=compile_exec)
    rate = 1.5 / _predicted(orch, eng)
    rep = eng.serve(P.ArrivalTrace.poisson(["A", "B"], rate=rate, n=6,
                                           seed=1))
    assert rep.completed == 6 and rep.shed == 0 and rep.exec_wall_s > 0
    assert len(eng.window_seconds) >= 1
    _check_run(orch, eng, rep, chains)


def _scenario(name, trace, lane):
    t = [a.time for a in trace.arrivals]
    events = {
        "transient_storm": [P.ChaosEvent(time=0.0, kind="transient",
                                         count=4)],
        "straggler": [P.ChaosEvent(time=0.0, kind="straggler", lane=lane,
                                   delay=0.005, count=-1)],
        "stall": [P.ChaosEvent(time=0.0, kind="stall", lane=lane,
                               delay=30.0, count=-1)],
        "pu_lost_return": [P.ChaosEvent(time=t[3], kind="pu_lost",
                                        lane=lane),
                           P.ChaosEvent(time=t[6], kind="pu_restored",
                                        lane=lane)],
    }[name]
    return P.ChaosTrace(events, kind=name, seed=3)


@pytest.mark.parametrize("compile_exec", [False, True])
@pytest.mark.parametrize("name", ["transient_storm", "straggler", "stall",
                                  "pu_lost_return"])
def test_chaos_scenarios_drain_without_a_wrong_answer(chains, name,
                                                      compile_exec):
    probe, _ = _real_engine(chains)
    lat = probe.plan(0).latency
    lane = probe.plan(0).route[0][0][1]       # a lane the plans use
    kw = dict(compile_exec=compile_exec,
              health_policy=P.HealthPolicy(cooldown=0.25 * lat,
                                           cooldown_backoff=1.0,
                                           calibration=4))
    if name == "stall":
        kw.update(exec_policy=P.ExecutionPolicy(timeout=0.2,
                                                min_timeout=0.2,
                                                max_retries=0),
                  max_window_retries=1)
    orch, eng = _real_engine(chains, **kw)
    trace = P.ArrivalTrace.poisson(["A", "B"], rate=1.5 / lat, n=8, seed=5)
    chaos = _scenario(name, trace, lane)
    rep = eng.serve(trace, chaos=P.ChaosTrace.from_json(chaos.to_json()))
    _check_run(orch, eng, rep, chains, chaos)
    tr = [(t["pu"], t["frm"], t["to"], t["reason"])
          for t in rep.breaker["transitions"]]
    if name == "pu_lost_return":
        assert rep.recoveries >= 1 and rep.recovered >= 1
        assert rep.recovery_ms_p50 > 0.0
        seq = [(f, to) for pu, f, to, _ in tr if pu == lane and f != to]
        assert ("closed", "open") in seq and ("open", "half_open") in seq
        assert seq[-1] == ("half_open", "closed")
        assert rep.breaker["targets"][lane]["state"] == "closed"
        assert any(len(set(r.assignment.values())) == 2
                   for r in rep.requests if not r.shed)
    if name == "stall":
        assert rep.retried >= 1
        assert any(reason == "timeout" for *_, reason in tr)
    if name == "straggler":
        assert rep.breaker["targets"][lane]["successes"] > 0
    assert rep.cache["sizes"]
