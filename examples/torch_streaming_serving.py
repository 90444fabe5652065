"""Streaming serving on the fig8 zoo, on PyTorch: warm-start incremental
re-planning under live Poisson and bursty request traffic (the port of
``examples/streaming_serving.py``).

The :class:`ServingEngine` drives the orchestrator's online-admission API
(``admit`` / ``advance`` / ``retire``) as an asyncio serving loop:
requests arrive on a trace, are admitted into a bounded concurrent set,
and every membership or progress boundary is re-planned **warm** — the
pooled incremental solver re-prices only the affected region and sweeps
one bounded ``horizon_states`` window, so re-plan latency stays ~1 ms on
the full-resolution M=3 zoo set where a cold re-solve costs tens to
hundreds of ms (every warm plan is bitwise-identical to the cold
solve).  Deadline-tagged requests that
can no longer meet their SLO are shed gracefully instead of stalling the
set.

The last act switches to ``execution="real"``: requests really execute
through the fault runtime while a :class:`ChaosTrace` kills a PU mid-run
and brings it back — the per-target circuit breaker quarantines the
lane, the active set warm-re-plans on the survivors, and a half-open
probe re-admits the lane once it is observed healthy again.  Every
completed request is checked bitwise against a fault-free solo run.  The
chains' payloads are PyTorch on the card (``--device cpu`` for the host).

Run:  PYTHONPATH=src python examples/torch_streaming_serving.py
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (ArrivalTrace, ChaosEvent, ChaosTrace,
                              EdgeSoCCostModel, ExecutionPolicy, FusedOp,
                              HealthPolicy, Orchestrator, ServingEngine,
                              chain_graph)
from repro_torch.core.modelgraph import chain_device
from repro_torch.core.paperzoo import zoo

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device of the chaos act's payloads "
                     "(default: the card)")
args = ap.parse_args()
device = chain_device(args.device)

MODELS = ("ViT-B/16 FP16", "ResNet-50 FP16", "SNN-VGG9 FP16")

graphs = {name: zoo()[name] for name in MODELS}
orch = Orchestrator(EdgeSoCCostModel())
eng = ServingEngine(orch, graphs, max_concurrent=3)

# -- steady Poisson load --------------------------------------------------
trace = ArrivalTrace.poisson(list(MODELS), rate=4.0, n=20, seed=0)
rep = eng.serve(trace)
print(f"poisson  n={rep.n_requests:3d}: {rep.completed} served, "
      f"{rep.shed} shed, {rep.throughput:5.1f} req/s sustained")
print(f"         plan latency p50/p99 {rep.plan_ms_p50:.2f}/"
      f"{rep.plan_ms_p99:.2f} ms (wall)  "
      f"request latency p50/p99 {1e3 * rep.latency_p50:.1f}/"
      f"{1e3 * rep.latency_p99:.1f} ms")
print(f"         re-plans: {rep.replans_warm} warm, "
      f"{rep.replans_cold} cold")

# -- bursty overload with SLO deadlines -----------------------------------
# 3-request bursts land near-simultaneously; a tight SLO (2.5x each
# model's solo-best latency) forces the engine to shed what cannot make
# its deadline instead of letting the queue blow up
eng2 = ServingEngine(Orchestrator(EdgeSoCCostModel()), graphs,
                     max_concurrent=3, slo_factor=2.5)
burst = ArrivalTrace.bursty(list(MODELS), rate=60.0, n=20, burst_every=4,
                            burst_size=3, seed=1)
rep2 = eng2.serve(burst)
print(f"bursty   n={rep2.n_requests:3d}: {rep2.completed} served, "
      f"{rep2.shed} shed under SLO, {rep2.throughput:5.1f} req/s, "
      f"mean occupancy {rep2.occupancy_mean:.2f}/{eng2.max_concurrent}")
assert rep2.completed + rep2.shed == rep2.n_requests
assert rep.replans_cold == 0 and rep2.replans_cold == 0

# -- degraded-mode serving: real execution under chaos --------------------
# small torch-payload chains (the zoo graphs carry no executable payloads)
def _tensor(seed, shape):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(a.astype(np.float32)).to(device)


def _chain(n, salt):
    def payload(k):
        w = _tensor(salt * 97 + k, (8, 8))
        return lambda x, w=w: torch.tanh(x @ w)
    g = chain_graph([FusedOp(name=f"c{salt}_{k}", kind="matmul",
                             flops=1e6, bytes_moved=1e4, fn=payload(k))
                     for k in range(n)])
    return g, {0: (_tensor(salt, (1, 8)),)}


gA, inA = _chain(5, 1)
gB, inB = _chain(4, 2)
# the breaker's cooldown and the chaos script run on the serving clock; a
# drift rescale reads wall-clock op times (a loaded host slows the CPU lane
# past the threshold, its cost grows and no plan probes it again), so it
# is off here and the re-admission follows the serving clock alone
eng3 = ServingEngine(Orchestrator(EdgeSoCCostModel()), {"A": gA, "B": gB},
                     execution="real", inputs={"A": inA, "B": inB},
                     exec_policy=ExecutionPolicy(timeout=20.0),
                     health_policy=HealthPolicy(
                         cooldown=0.005, rescale_threshold=float("inf")),
                     max_concurrent=2)
trace3 = ArrivalTrace.poisson(["A", "B"], rate=50.0, n=12, seed=3)
chaos = ChaosTrace([
    ChaosEvent(time=trace3.arrivals[4].time, kind="pu_lost", lane="CPU"),
    ChaosEvent(time=trace3.arrivals[8].time, kind="pu_restored",
               lane="CPU"),
], kind="pu_lost_return", seed=3)
rep3 = eng3.serve(trace3, chaos=chaos)
b = rep3.breaker
print(f"chaos    n={rep3.n_requests:3d}: {rep3.completed} served "
      f"({rep3.recovered} through a recovery), {rep3.shed} shed "
      f"{rep3.shed_reasons}, bitwise {rep3.bitwise_checked} checked / "
      f"{rep3.bitwise_failures} failed")
print(f"         breaker: {b['opens']} opens, {b['probes']} probes, "
      f"{b['readmits']} readmits; {rep3.recoveries} recoveries "
      f"(p50 {rep3.recovery_ms_p50:.2f} ms)")
for t in b["transitions"]:
    print(f"           t={t['time']:.3f}s {t['pu']}: "
          f"{t['frm']} -> {t['to']} ({t['reason']})")
assert rep3.bitwise_failures == 0
assert b["opens"] >= 1 and b["readmits"] >= 1
