"""The paper's multi-stage VLA pipeline as a DAG workload on PyTorch:
vision encoder || language encoder -> fusion -> action head, planned by
the antichain-frontier DAG route and executed end to end (the port of
``examples/vla_pipeline.py``).

1. Build the compact VLA pipeline DAG (``paperzoo.vla_pipeline``): a
   conv tower (NPU-affine) forking from the inputs in parallel with a
   GEMM/attention tower (GPU-affine), joined by fusion + action head.
2. Plan it three ways: best *sequential* route (one PU-hopping sequence
   over a serialization of the DAG), the fork/join phase route, and the
   antichain-frontier route (``solve_dag(algorithm="frontier")``) that
   co-schedules the two encoders step by step on different PUs.
3. Execute the frontier plan on the multi-lane executor — lanes
   synchronize only at true dependency edges — and check the outputs
   bitwise against the single-lane reference run.  The payloads are
   PyTorch on the card (``--device cpu`` for the host).

Run:  PYTHONPATH=src python examples/torch_vla_pipeline.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (EDGE_PUS, EdgeSoCCostModel, Orchestrator,
                              results_bitwise_equal, solve_sequential)
from repro_torch.core.modelgraph import chain_device
from repro_torch.core.paperzoo import vla_pipeline

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device of the payloads (default: the card)")
args = ap.parse_args()
device = chain_device(args.device)

# -- 1: the DAG ------------------------------------------------------------
graph = vla_pipeline()
n_vis = sum(op.name.startswith("vis.") for op in graph.ops)
n_lang = sum(op.name.startswith("lang.") for op in graph.ops)
print(f"VLA pipeline DAG: {len(graph.ops)} fused ops "
      f"({n_vis} vision, {n_lang} language, fusion + action head), "
      f"{len(graph.edges)} edges")

# attach small pure payloads so the plan actually executes: every op maps
# its predecessors' (8, 8) latents to a new latent (the analytic shapes
# above drive the cost model; payloads only need to be deterministic)
rng = np.random.default_rng(0)
for op in graph.ops:
    w = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    w = w.to(device)

    def fn(*args, _w=w):
        x = sum(args[1:], args[0])
        return torch.tanh(x @ _w)

    op.fn = fn

# -- 2: plan ---------------------------------------------------------------
orch = Orchestrator(EdgeSoCCostModel(), pus=EDGE_PUS)
h = orch.register(graph)
table = orch._reg(h).table

# best sequential route: the chain DP over a serialization of the DAG —
# one op at a time on the best PU-hopping sequence (no co-execution)
seq = solve_sequential(graph.topo_order(), graph.ops, table, EDGE_PUS,
                       "latency")
phase = orch.plan(h, mode="dag", algorithm="phase")
frontier = orch.plan(h, mode="dag", algorithm="frontier")

print(f"\nbest sequential route : {seq.latency * 1e3:.4f} ms")
print(f"fork/join phase route : {phase.latency * 1e3:.4f} ms "
      f"({seq.latency / phase.latency:.2f}x vs sequential)")
print(f"antichain frontier    : {frontier.latency * 1e3:.4f} ms "
      f"({seq.latency / frontier.latency:.2f}x vs sequential, "
      f"{frontier.schedule.n_parallel_steps} co-scheduled steps)")
assert frontier.latency < seq.latency, \
    "intra-model parallelism must beat the best sequential route"

# -- 3: execute ------------------------------------------------------------
x = {0: (torch.from_numpy(
    rng.standard_normal((8, 8)).astype(np.float32)).to(device),)}
ref = orch.executor.run_monolithic(graph, x)

t0 = time.perf_counter()
out = orch.execute(frontier, x)                  # compiled lane program
t_first = time.perf_counter() - t0
t0 = time.perf_counter()
out = orch.execute(frontier, x)                  # warm: cached program
t_warm = time.perf_counter() - t0
ok = results_bitwise_equal(out, ref)
print(f"\nexecuted frontier plan on {len(EDGE_PUS)} lanes: "
      f"bitwise == single-lane reference: {ok} "
      f"(compile+run {t_first * 1e3:.1f} ms, warm run {t_warm * 1e3:.1f} ms)")
assert ok
print("VLA pipeline: planned and executed as a DAG workload: OK")
