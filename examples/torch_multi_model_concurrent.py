"""Multi-model concurrent inference on PyTorch: the paper's Fig. 7(b),
extended from pairs to M concurrent requests — register → plan → execute
(the port of ``examples/multi_model_concurrent.py``).

Three models register with one ``Orchestrator``; ``plan`` over
the handle tuple routes to the M-request joint search (the exact grid
sweep here; pairs keep the 2-D A*), and ``execute`` really runs the
schedule across the multi-lane executor (one worker lane per PU, all
models multiplexed onto the shared lanes) — through the compiled lane
program by default (segment-fused, cached; co-scheduled steps stay
single-op barrier segments), with the per-op interpreter kept as the
bitwise oracle via ``compile=False`` — and checks each model's outputs
against isolated execution.  The serving scenario is then played out
online: two requests are admitted, make progress, and a third arrives
mid-flight — ``admit`` re-plans the concurrent set over every active
request's remaining ops.

The payloads are PyTorch on the card (``--device cpu`` for the host),
weights from a seeded NumPy generator; the plan is host arithmetic on
the analytic cost model and does not depend on them.

Run:  PYTHONPATH=src python examples/torch_multi_model_concurrent.py
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


def normal(seed: int, shape, scale: float = 1.0) -> torch.Tensor:
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(device)


def gemm_model(name: str, n_layers: int, width: int):
    """A GEMM-heavy request (GPU-affine)."""
    ws = [normal(i, (width, width), (1.0 / width) ** 0.5)
          for i in range(n_layers)]
    ops = [FusedOp(name=f"{name}.mm{i}", kind="matmul",
                   in_shapes=((1, width, width), (width, width)),
                   out_shape=(1, width, width),
                   fn=(lambda w: lambda a: torch.relu(a @ w))(ws[i]))
           for i in range(n_layers)]
    return OpGraph(ops), normal(1000, (1, width, width))


def scan_model(name: str, n_layers: int, width: int):
    """A recurrence-heavy request (CPU-affine — Mamba/KAN class)."""
    ops = []
    for i in range(n_layers):
        ops.append(FusedOp(
            name=f"{name}.scan{i}", kind="cumsum",
            in_shapes=((1, width, width),), out_shape=(1, width, width),
            fn=lambda a: torch.cumsum(a, dim=1) / a.shape[1]))
    return OpGraph(ops), normal(1001, (1, width, width))


def conv_model(name: str, n_layers: int, width: int):
    """A conv-heavy request (NPU-affine — ResNet/SNN class)."""
    ops = []
    for i in range(n_layers):
        w = normal(100 + i, (width, width), (1.0 / width) ** 0.5)
        ops.append(FusedOp(
            name=f"{name}.cv{i}", kind="conv2d",
            in_shapes=((1, 32, 24, 24), (32, 32, 3, 3)),
            out_shape=(1, 32, 24, 24),
            fn=(lambda wi: lambda a: torch.tanh(a @ wi))(w)))
    return OpGraph(ops), normal(1002, (1, width, width))


models = [gemm_model("A", 8, 512), scan_model("B", 8, 512),
          conv_model("C", 6, 512)]
orch = Orchestrator(AnalyticProfiler())
handles = [orch.register(g) for g, _ in models]
serial = sum(orch.workload(h).best_solo()[1]   # best single PU, back to back
             for h in handles)

plan = orch.plan(handles)
print(f"serial best-single: {1e3*serial:.2f} ms")
print(f"BIDENT {len(models)}-model concurrent ({plan.schedule.mode}): "
      f"{1e3*plan.latency:.2f} ms -> {serial/plan.latency:.2f}x")

# show the first few co-scheduled steps (Fig. 7(b) style)
print("\nfirst 6 concurrent steps:")
for st in plan.schedule.steps[:6]:
    cols = []
    for r, (g, _) in enumerate(models):
        cols.append(f"{g.ops[st.ops[r]].name}@{st.pus[r]}"
                    if st.ops[r] is not None else "--idle--")
    print("  " + " || ".join(f"{c:16s}" for c in cols)
          + f" ({st.cost*1e6:7.1f} us)")

# really execute the M-model plan across the shared PU lanes — through
# the compiled path (the default): lane queues partition into segments,
# segment payloads fuse (captured as CUDA graphs on the card where
# bitwise-safe), and a repeat execute() hits the cached program.  Verify
# every model's outputs against isolated execution AND against the
# per-op interpreter oracle.
inputs = [{0: (x,)} for _, x in models]
conc = orch.execute(plan, inputs)                       # compiled
oracle = orch.execute(plan, inputs, compile=False)      # interpreter
graphs = [g for g, _ in models]
for g, x, got, ref in zip(graphs, inputs, conc, oracle):
    mono = orch.executor.run_monolithic(g, x)
    assert ScheduleExecutor.outputs_close(mono, got)
    assert ScheduleExecutor.outputs_close(ref, got)
prog = orch.program_for(plan, inputs)
s = prog.stats
orch.execute(plan, inputs)                              # program-cache hit
print(f"\nall {len(models)} models' compiled outputs == isolated == "
      f"interpreter oracle: OK")
print(f"compiled lane program: {s['n_segments']} segments over "
      f"{s['n_ops']} ops ({s['n_jitted']} captured, "
      f"{s['n_segments'] - s['n_jitted'] - s['n_cold']} eager, "
      f"{s['n_barrier']} co-scheduled barriers); "
      f"program cache hits {orch.stats['program_hits']}")

# -- the serving scenario: a request arrives mid-flight -------------------
hA, hB, hC = handles
orch.admit(hA)
orch.admit(hB)
orch.advance(hA, 5)           # A is 5 ops in when C arrives
orch.advance(hB, 3)
online = orch.admit(hC)
rem = [len(r) for r in online.route]
print(f"\nonline admission: C arrives with A at op 5/8, B at op 3/8 -> "
      f"re-planned over remaining ops {rem} "
      f"({1e3*online.latency:.2f} ms, mode {online.schedule.mode})")
done = orch.retire(hA)
print(f"A retires -> re-planned set {done.handles}, "
      f"{1e3*done.latency:.2f} ms")
