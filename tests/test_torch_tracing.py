"""The port's spans and counters (``repro_torch.tracing``) on the CPU.

A small chain planned across two host lanes and run through
``Orchestrator.execute``: with no profiler nothing is recorded and no
``record_function`` is entered; under ``torch.profiler`` the spans nest
as the port's layers do, and the profiler's own events hold the same
names nested alike.  Counters add to the innermost open span and to the
totals, and the kernels' launch counters reset apart from the rest.  A prefill is one span, and
the planner's profiling counts its seconds on the host lanes.
"""
import collections
import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import kernels, tracing
from repro_torch.core import (CostEntry, CostTable, FusedOp, Orchestrator,
                              Target, chain_graph)
from repro_torch.models import model as M

LANES = ("torch-cpu-a", "torch-cpu-b")


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _chain_on_two_lanes():
    """Four ops alternating between two host lanes, the orchestrator, its
    plan and the input."""
    lanes = {n: Target(n, kind="cpu", dialect="ref",
                       device=torch.device("cpu")) for n in LANES}
    fns = [lambda a: a * 2.0, lambda a: a.tanh(), lambda a: a + 1.0,
           lambda a: a.sin()]
    graph = chain_graph([FusedOp(f"f{i}", "act", fn=f)
                         for i, f in enumerate(fns)])
    table = CostTable(list(lanes))
    for i in range(len(fns)):
        for k, lane in enumerate(lanes):
            table.set(i, lane, CostEntry(
                kernel=1e-4 if i % 2 == k else 1e-2, dispatch=1e-6,
                h2d=0.0, d2h=0.0, power=10.0))
    orch = Orchestrator(table, targets=lanes)
    plan = orch.plan(orch.register(graph))
    assert [pu for _, pu in plan.route[0]] == [LANES[i % 2]
                                                for i in range(4)]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8), dtype=np.float32))
    return orch, plan, {0: (x,)}


def test_no_profiler_records_no_span_and_enters_no_record_function(
        monkeypatch):
    orch, plan, ext = _chain_on_two_lanes()

    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(tracing, "record_function", entered)
    assert not torch.autograd.profiler._is_profiler_enabled
    orch.execute(plan, ext)
    orch.execute(plan, ext)
    assert tracing.spans() == []
    assert tracing.span("any") is tracing.span("other")


def test_spans_nest_as_the_layers_and_as_the_profilers_events():
    orch, plan, ext = _chain_on_two_lanes()
    orch.execute(plan, ext)                      # compiled outside
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        orch.execute(plan, ext)
    spans = tracing.spans()
    by_id = {s["id"]: s for s in spans}
    root, = [s for s in spans if s["parent"] is None]
    assert root["name"] == "orchestrator.execute"
    assert all(s["request"] == root["id"] and s["end_ns"] >= s["start_ns"]
               for s in spans)

    def parent(s):
        return by_id[s["parent"]]["name"] if s["parent"] else None

    tree = sorted((s["name"], parent(s)) for s in spans)
    assert tree == sorted(
        [("orchestrator.execute", None),
         ("orchestrator.program_for", "orchestrator.execute"),
         ("laneprogram.run", "orchestrator.execute")]
        + [("laneprogram.segment", "laneprogram.run")] * 4)
    segs = [s for s in spans if s["name"] == "laneprogram.segment"]
    # in the chain's order, each op once, each on its planned lane
    assert [s["attrs"]["lane"] for s in segs] == [LANES[i % 2]
                                                  for i in range(4)]
    assert all(s["attrs"]["n_ops"] == 1 and s["attrs"]["mode"] == "warm"
               for s in segs)
    prog = orch.program_for(plan, ext)
    assert [prog.segments[s["attrs"]["index"]].items for s in segs] == [
        [(0, i)] for i in range(4)]

    names = {s["name"] for s in spans}
    events = [e for e in prof.events() if e.name in names]
    assert sorted(e.name for e in events) == sorted(s["name"] for s in spans)

    def span_parent(e):
        p = e.cpu_parent
        while p is not None and p.name not in names:
            p = p.cpu_parent
        return None if p is None else p.name

    assert sorted((e.name, span_parent(e)) for e in events) == tree


def test_a_miss_compiles_inside_program_for():
    orch, plan, ext = _chain_on_two_lanes()
    with profile(activities=[ProfilerActivity.CPU]):
        orch.execute(plan, ext)
    by_id = {s["id"]: s for s in tracing.spans()}
    compiled, = [s for s in by_id.values()
                 if s["name"] == "orchestrator.compile"]
    assert by_id[compiled["parent"]]["name"] == "orchestrator.program_for"
    assert [s["attrs"]["mode"] for s in by_id.values()
            if s["name"] == "laneprogram.segment"] == ["cold"] * 4


def test_count_adds_to_the_innermost_span_and_to_the_totals():
    before = tracing.counters().get("t.n", 0)
    tracing.count("t.n", 2)                      # tracing off
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer", k=1):
            tracing.count("t.n", 3)
            with tracing.span("inner"):
                tracing.count("t.n", 4)
                tracing.add({"t.n": 1, "t.m": 5})
            tracing.count("t.m", 1)
    outer, inner = tracing.spans()
    assert outer["counts"] == {"t.n": 3, "t.m": 1}
    assert inner["counts"] == {"t.n": 5, "t.m": 5}
    assert inner["parent"] == outer["id"] == inner["request"]
    assert outer["attrs"] == {"k": 1}
    assert tracing.counters()["t.n"] == before + 10
    assert tracing.counters()["t.m"] == 6


def test_counts_under_a_recording_wait_for_the_replays():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.recording() as rec:
            with tracing.span("captured"):
                tracing.count("kernels.launches.ssd_scan", 2)
                tracing.count("t.other")
    assert tracing.spans() == [] and tracing.counters() == {}
    for _ in range(3):
        tracing.add(rec)
    assert kernels.launch_counts()["ssd_scan"] == 6
    assert tracing.counters()["t.other"] == 3


def test_reset_launch_counts_leaves_the_set_up_counters_alone():
    tracing.count("kernels.launches.expert_glu", 2)
    tracing.count("planner.measure_s.cpu", 1.25)
    tracing.count("capture.clone_bytes", 64)
    assert kernels.launch_counts() == {"flash_attention": 0, "ssd_scan": 0,
                                       "expert_glu": 2, "ssd_step": 0}
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {"flash_attention": 0, "ssd_scan": 0,
                                       "expert_glu": 0, "ssd_step": 0}
    assert tracing.counters() == {"planner.measure_s.cpu": 1.25,
                                  "capture.clone_bytes": 64}


def test_the_newest_records_are_kept(monkeypatch):
    monkeypatch.setattr(tracing, "_records", collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for n in range(5):
            with tracing.span(f"s{n}"):
                pass
    assert [s["name"] for s in tracing.spans()] == ["s2", "s3", "s4"]
    assert tracing.KEEP >= 1 << 12


def test_a_prefill_is_one_root_span():
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              use_kernels=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 8), dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]):
        M.prefill(cfg, params, {"tokens": tokens}, max_len=12)
    root, = tracing.spans()
    assert root["name"] == "model.prefill" and root["parent"] is None
    assert root["end_ns"] >= root["start_ns"]


def test_the_profiler_counts_its_seconds_on_the_host_lanes():
    """Always on, with no profiler running: the seconds of every
    measurement on a host lane, and no span."""
    from repro_torch.core import MeasuredProfiler
    lanes = {n: Target(n, kind="cpu", dialect="ref",
                       device=torch.device("cpu")) for n in LANES}
    x = torch.ones(4, 8)
    ops = [FusedOp(f"f{i}", "act", fn=lambda a: a + 1.0,
                   meta={"example_inputs": (x,)}) for i in range(3)]
    graph = chain_graph(ops)
    t0 = time.perf_counter()
    MeasuredProfiler(targets=lanes, warmup=1, iters=2).profile(graph)
    wall = time.perf_counter() - t0
    assert 0 < tracing.counters()["planner.measure_s.cpu"] <= wall
    assert list(tracing.counters()) == ["planner.measure_s.cpu"]
    assert tracing.spans() == []
