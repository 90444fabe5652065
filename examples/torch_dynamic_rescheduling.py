"""Dynamic operator-level rescheduling on PyTorch — the paper's §6 future
work, live, through the orchestrator's condition hook (the port of
``examples/dynamic_rescheduling.py``).

A hybrid GEMM+scan workload is registered and admitted; halfway through,
the GPU thermally throttles 4x.  ``orch.on_condition`` invalidates the
cached plans priced under the stale GPU assumption and re-plans the
active request through its ``DynamicScheduler`` from current progress
(sub-millisecond tail re-search, hysteresis included), returning the
stitched plan — prefix at the nominal profile, tail under the throttled
condition.  The low-level ``DynamicScheduler.simulate`` then replays the
whole chain to compare realised latencies against a static schedule.

The second act is the mid-run case the condition hook alone can't cover:
a PU dies *during* execution.  A scripted ``FaultPlan`` kills a lane
partway through a real run; the executor surfaces the loss with the
completed-results frontier attached, and ``orch.execute`` recovers —
re-plans the remaining ops on the surviving PUs and resumes — with
outputs bitwise-identical to the fault-free run.  Its payloads are
PyTorch on the card (``--device cpu`` for the host).

Run:  PYTHONPATH=src python examples/torch_dynamic_rescheduling.py
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (EDGE_PUS, AnalyticProfiler, FaultPlan,
                              FusedOp, OpGraph, Orchestrator,
                              RuntimeCondition, chain_graph,
                              results_bitwise_equal)
from repro_torch.core.costmodel import make_cumsum, make_matmul
from repro_torch.core.dynamic import DynamicScheduler
from repro_torch.core.modelgraph import chain_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device of the fault demo's payloads "
                     "(default: the card)")
args = ap.parse_args()
device = chain_device(args.device)

ops = []
for i in range(12):
    ops.append(make_matmul(512, name=f"mm{i}") if i % 2 == 0
               else make_cumsum(4096, 128))
g = OpGraph(ops)

orch = Orchestrator(AnalyticProfiler())
h = orch.register(g)
plan0 = orch.plan(h)
print("event: GPU throttles 4.0x before op 6\n")

# the serving view: the request is active and 6 ops in when the
# monitoring condition arrives
orch.admit(h)
orch.advance(h, 6)
restitched = orch.on_condition(
    RuntimeCondition(slowdown={"GPU": 4.0}))[(h, "latency")]
print(f"static plan : {plan0.schedule.assignment}")
print(f"dynamic plan: {restitched.schedule.assignment}")
for e in orch.dynamic(h).events:
    print(f"remap at op {e.at_op} ({e.reason}): tail "
          f"{e.old_tail_cost*1e3:.2f} -> {e.new_tail_cost*1e3:.2f} ms predicted")
# the stitched plan carries real re-evaluated numbers (prefix at the
# nominal profile, tail under the throttled condition) — no NaNs
print(f"stitched plan: {restitched.latency*1e3:.2f} ms / "
      f"{restitched.energy*1e3:.2f} mJ predicted")
# cached nominal plans priced with GPU@1.0 were invalidated per-PU
print(f"plan cache after invalidation: {orch.stats}")

# -- realised latency: replay on the low-level DynamicScheduler ----------
event = {6: RuntimeCondition(slowdown={"GPU": 4.0})}
table = orch.workload(h).table
chain = g.topo_order()
dyn = DynamicScheduler(chain, g.ops, table, EDGE_PUS)
t_dyn = dyn.simulate(event)
static = DynamicScheduler(chain, g.ops, table, EDGE_PUS,
                          replan_threshold=1e9)
t_static = static.simulate(event)
print(f"\nrealised latency: static {t_static*1e3:.2f} ms, "
      f"dynamic {t_dyn*1e3:.2f} ms ({t_static/t_dyn:.2f}x)")
assert t_dyn < t_static
assert dyn.plan.assignment == restitched.schedule.assignment

# -- mid-run PU loss: fault injection + re-plan-and-resume recovery ------
print("\nevent: the lane holding op 5 dies permanently DURING execution\n")
ops2 = []
for i in range(10):
    c = float(np.float32(1.0 + 0.01 * i))
    ops2.append(FusedOp(name=f"f{i}", kind="matmul", flops=1e7,
                        bytes_moved=1e5,
                        fn=(lambda c: lambda x: torch.tanh(x * c))(c)))
g2 = chain_graph(ops2)
x0 = torch.from_numpy(
    np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8)).to(device)
inputs = {0: (x0,)}

orch2 = Orchestrator(AnalyticProfiler())
plan2 = orch2.plan(orch2.register(g2))
reference = orch2.execute(plan2, inputs)          # fault-free run

# kill whatever lane op 5 lands on, the moment it is dispatched
faults = FaultPlan.single("pu_lost", request=0, op=5)
recovered = orch2.execute(plan2, inputs, faults=faults)

lost = next(iter(faults.lost))
print(f"lost PU      : {lost} (at op 5; injected via FaultPlan)")
print(f"recoveries   : {orch2.stats['recoveries']} "
      f"(condition now marks {sorted(orch2.condition.unavailable)} "
      "unavailable; stale cached plans were invalidated)")
replanned = orch2.plan(plan2.handles)
print(f"re-planned   : {replanned.schedule.assignment} (survivors only)")
assert lost not in replanned.schedule.assignment
assert results_bitwise_equal(recovered, reference)
print("recovered outputs are bitwise-identical to the fault-free run")
