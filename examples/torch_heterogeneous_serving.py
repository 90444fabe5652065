"""Heterogeneous serving on PyTorch: BIDENT's Fig. 5 on a real model,
through the register → plan → execute front door (the port of
``examples/heterogeneous_serving.py``).

The ``Orchestrator`` owns the cost provider and the plan cache —
the serving posture: ``register`` the decode-step operator graph once
(profiled + densified behind a handle), then ``plan`` it under latency
AND energy objectives (the second objective reuses the same memoized
``Workload``; a repeated ``plan`` call is a cache hit).  The per-operator
PU path (the paper's Fig. 5 "highlighted path") is read off
``plan.route``, and batched requests are then actually served with the
engine.

The second half swaps the analytic EdgeSoC cost model for the real
registered targets of the builtin registry: on the card its four lanes
(``numpy-eager``, ``torch-cpu``, ``cuda:0`` and ``cuda-kernels``, the
hand-written CUDA kernels), with ``--device cpu`` the two host lanes.  The
kernel-backed chain (attention, SSD scan, MoE) is profiled on every lane,
planned, and its compiled lane program executes on the bound backends,
probe-verified against the reference composition.  The zoo engine then
serves the reduced model, with the kernels (``use_kernels``) on the card.

Run:  PYTHONPATH=src python examples/torch_heterogeneous_serving.py
      [--arch ...] [--batch 2] [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import EdgeSoCCostModel, MeasuredProfiler, Orchestrator
from repro_torch.core.backends import default_registry
from repro_torch.core.modelgraph import (chain_device, kernel_chain,
                                         model_op_graph)
from repro_torch.core.targets import KERNEL_DIALECTS
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine
from repro_torch.sharding import Policy

# each output of the planned kernel chain lies within this fraction of the
# oracle's largest value of the same output (f32; each kernel segment's own
# probe holds it to its lane's tolerance bucket, and the chain compounds
# their rounding)
ORACLE_TOL = 3e-4

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="zamba2-2.7b", choices=ALL_ARCHS)
ap.add_argument("--batch", type=int, default=2)
ap.add_argument("--device", default=None,
                help="device of the chain and the engine (default: the "
                     "card, its four lanes)")
args = ap.parse_args()
device = chain_device(args.device)

# -- register the decode-step operator graph ------------------------------
cfg_full = get_config(args.arch)
g = model_op_graph(cfg_full, kind="decode", batch=1, seq=2048)
orch = Orchestrator(EdgeSoCCostModel())
h = orch.register(g)

for objective in ("latency", "energy"):
    plan = orch.plan(h, objective=objective)
    counts: dict[str, int] = {}
    for _, pu in plan.route[0]:
        counts[pu] = counts.get(pu, 0) + 1
    print(f"{args.arch} decode, {objective}-optimal: "
          f"{plan.latency*1e3:.2f} ms / {plan.energy*1e3:.1f} mJ, "
          f"assignment {counts}")

# Fig. 5-style path for the first layer's operators (cache hit: the
# latency plan above is served back from the plan cache)
plan = orch.plan(h)
table = orch.workload(h).table
print("\nper-operator path (first 12 ops):")
for oi, pu in plan.route[0][:12]:
    op = g.ops[oi]
    best1 = min(table.supported_pus(oi),
                key=lambda p: table.require(oi, p).w)
    print(f"  {op.name:24s} kind={op.kind:9s} -> {pu}"
          + ("   (solo-best: %s)" % best1 if best1 != pu else ""))

_, base, _ = orch.workload(h).best_solo()
print(f"\nbest single PU {base*1e3:.2f} ms -> BIDENT {plan.latency*1e3:.2f} ms "
      f"({base/plan.latency:.2f}x)   [plan cache: {orch.stats}]")

# the compiled execution path: the plan's lane queues partition into
# maximal same-PU segments with handoff events only at the cross-lane
# cuts — the dispatch shape a real command-queue runtime would see
prog = orch.program_for(plan)
s = prog.stats
print(f"compiled lane program: {s['n_ops']} ops -> {s['n_segments']} "
      f"segments ({s['n_ops'] / max(s['n_segments'], 1):.1f} ops/segment; "
      f"{'serial' if s['serial'] else 'multi-lane'} dispatch)")

# -- the same loop on the REAL registered targets -------------------------
# The registry carries the builtin backends as data; binding them as PU
# lanes makes the orchestrator profile, plan, and execute on the actual
# backends instead of the analytic EdgeSoC model.
reg = default_registry(device=None if device.type == "cuda" else "cpu")
binding = {name: reg.get(name) for name in reg.names()}
kg, kext = kernel_chain(blocks=1, seq=64, heads=2, head_dim=16,
                        state=8, moe_ff=16, chunk=32, device=device)
ktable = MeasuredProfiler(warmup=1, iters=3, targets=binding).profile(kg)
korch = Orchestrator(ktable, targets=binding)
kplan = korch.plan(korch.register(kg))
kprog = korch.program_for(kplan)
# the first run probes each variant segment and serves the reference
# composition's outputs; the second runs what the probes accepted
kprog.run(kext)
kout = kprog.run(kext)
kref = korch.executor.run_monolithic(kg, kext)
route = [pu for _, pu in kplan.route[0]]
ks = kprog.stats
# every segment on a kernel lane passed its probe against the reference
# composition, and every output agrees with the oracle
kernel_verdicts = {seg.index: seg.verified for seg in kprog.segments
                   if seg.target is not None
                   and seg.target.dialect in KERNEL_DIALECTS}
oracle_err = max(
    float((kout[i].double().cpu() - kref[i].double().cpu()).abs().max()
          / kref[i].double().abs().max().clamp_min(1e-30).cpu())
    for i in kref) if set(kout) == set(kref) else float("inf")
match = (oracle_err <= ORACLE_TOL and all(
    v in ("bitwise", "tolerance") for v in kernel_verdicts.values()))
print(f"\nreal targets {list(binding)}: measured plan "
      f"{kplan.latency*1e6:.0f} us predicted, route "
      f"{dict((p, route.count(p)) for p in dict.fromkeys(route))}, "
      f"{ks['n_segments']} segments on bound backends "
      f"(verified: {ks['variant_verified'] or 'bitwise'}), outputs "
      f"{'match' if match else 'MISMATCH'} oracle")
assert match, (kernel_verdicts, oracle_err)
kprog.close()

# -- actually serve requests (the reduced config) -------------------------
cfg = dataclasses.replace(cfg_full.reduced(),
                          use_kernels=device.type == "cuda")
params = M.init_params(cfg, torch.Generator(device).manual_seed(0),
                       device=device)
engine = Engine(cfg=cfg, params=params, policy=Policy())
prompts = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab, (args.batch, 16), dtype=np.int32)).to(device)
out = engine.generate(prompts, max_new=8)
out = engine.generate(prompts, max_new=8)   # decode step: no re-capture
print(f"\nserved batch: prompts {tuple(prompts.shape)} -> generated "
      f"{tuple(out.shape)} (decode-step traces: "
      f"{sum(engine.decode_trace_counts.values())} across 2 generate calls)")
engine.release()
