"""Quickstart on PyTorch: BIDENT's register → plan → execute flow in ~60
lines (the port of ``examples/quickstart.py``).

The ``Orchestrator`` is the front door: hand it a cost provider once,
``register`` each inference graph (profiled + densified once, behind a
handle), ``plan`` whatever regime you need — the router picks the
sequential DP for chains, the phase/branch parallel solve when ``Branch``
nodes are present, the M-ary concurrent search for multiple handles — and
``execute`` the returned ``Plan`` on the multi-lane executor.  Repeated
``plan`` calls are served from the plan cache.

1. Build a small model as a fused-operator graph (PyTorch payloads on
   the card, weights drawn from a seeded NumPy generator).
2. ``register`` it (profile on the edge-SoC cost model: CPU / GPU / NPU).
3. ``plan`` the three regimes: sequential, intra-model parallel,
   two concurrent requests.
4. ``execute`` the sequential plan and verify the outputs match
   monolithic execution exactly.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the card by default; without one it raises unless ``--device cpu``)
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (AnalyticProfiler, FusedOp, OpGraph,
                              Orchestrator, ScheduleExecutor)
from repro_torch.core.modelgraph import chain_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device of the payloads (default: the card)")
args = ap.parse_args()
device = chain_device(args.device)

# -- 1. a tiny two-branch model: shared proj -> (conv path || scan path) --
rng = np.random.default_rng(0)


def tensor(shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)


x = tensor((1, 256, 256))
w1 = tensor((256, 256), 0.05)
w2 = tensor((256, 128), 0.05)

ops = [
    FusedOp(name="proj", kind="matmul", in_shapes=((1, 256, 256), (256, 256)),
            out_shape=(1, 256, 256), fn=lambda a: a @ w1),
    FusedOp(name="gemm_branch", kind="matmul",
            in_shapes=((1, 256, 256), (256, 128)), out_shape=(1, 256, 128),
            fn=lambda a: torch.relu(a @ w2)),
    FusedOp(name="scan_branch", kind="cumsum", in_shapes=((1, 256, 256),),
            out_shape=(1, 256, 256), fn=lambda a: torch.cumsum(a, dim=1)),
    FusedOp(name="join", kind="add", in_shapes=((1, 256, 128),) * 2,
            out_shape=(1, 256, 128),
            fn=lambda b, c: b + c[..., :128]),
]
graph = OpGraph(ops, edges=[(0, 1), (0, 2), (1, 3), (2, 3)])

# -- 2. register: profile -> (op, PU) cost table -> dense Workload, once --
orch = Orchestrator(AnalyticProfiler())
h = orch.register(graph)
table = orch.workload(h).table
print("supported PUs per op:",
      {op.name: table.supported_pus(i) for i, op in enumerate(graph.ops)})

# -- 3a. sequential shortest-path mapping ---------------------------------
seq = orch.plan(h, mode="sequential")
print("sequential:", [(graph.ops[o].name, p) for o, p in seq.route[0]],
      f"latency {seq.latency*1e6:.1f} us")

# -- 3b. intra-model parallel (auto-routed: the graph has Branch nodes) ---
par = orch.plan(h)
print(f"parallel: {par.latency*1e6:.1f} us "
      f"({par.schedule.n_concurrent_phases} concurrent phase(s))")

# -- 3c. two concurrent requests of this model ----------------------------
conc = orch.plan((h, h))
print(f"concurrent 2x: {conc.latency*1e6:.1f} us "
      f"(vs serial 2x sequential = {2*seq.latency*1e6:.1f} us)")
assert orch.plan((h, h)) is conc, "second identical plan() is a cache hit"

# -- 4. really run the plan; outputs must match monolithic ----------------
inputs = {0: (x,)}
orch_out = orch.execute(seq, inputs)
mono = orch.executor.run_monolithic(graph, inputs)
assert ScheduleExecutor.outputs_close(mono, orch_out), \
    "orchestration changed numerics!"
print("orchestrated output == monolithic output: OK")
