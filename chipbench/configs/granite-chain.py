"""granite-chain: BIDENT's own loop over the kernel chain.

The chain (``core.modelgraph.kernel_chain``) at the sizes of
``granite-chain.json`` is profiled on every lane (``MeasuredProfiler``),
planned for latency (``Orchestrator.plan``) and run through
``Orchestrator.execute``, which serves the compiled, captured lane
program.  The weights and the inputs are drawn on the device from the
seed in one call, in ``chain_arrays``' layout and scales, and handed to
the chain as ``arrays``; the inputs are then kept on the host, where a
request finds its input and from where it is staged.

The check follows the program op by op (``reference/chain.py``): each
op of the reference is fed the program's output of the op before it,
since at these widths the chain turns a reordering of float32 sums into
a different routing of its MoE; the first op is fed the request's input.
It compares each op's output with the program's, the largest difference
over the largest magnitude of the reference's output (``op_err``).  Up
to the first MoE, before any routing, it also runs the reference on its
own from the request's input (``reference.chain.chained``), so that
error which builds up from op to op is held too (``drift_err``: the
worst of those ops by the same measure).
"""
from __future__ import annotations

import time
import warnings

import torch

from chipbench import workcounts
from chipbench.reference import chain as ref
from chipbench.reference.precision import rounding, strict_float32

CHAIN_KEYS = ("blocks", "batch", "seq", "heads", "head_dim", "state",
              "experts", "top_k", "moe_ff", "chunk", "min_capacity")


def draw(cfg: dict, n_inputs: int, seed: int, device) -> dict:
    """The inputs ``x0.<i>`` and every block's weights, named as
    ``chain_arrays`` names them, as views of one standard normal draw on
    ``device``: inputs at scale 1, log_a as -0.05 |z|, the rest at 0.5."""
    B, T, H, D = cfg["batch"], cfg["seq"], cfg["heads"], cfg["head_dim"]
    N, E, F = cfg["state"], cfg["experts"], cfg["moe_ff"]
    d = H * D
    shapes = [(f"x0.{i}", (B, T, H, D)) for i in range(n_inputs)]
    for j in range(cfg["blocks"]):
        shapes += [(f"b{j}.attn.k", (B, T, H, D)),
                   (f"b{j}.attn.v", (B, T, H, D)),
                   (f"b{j}.ssd.c", (B, T, H, N)),
                   (f"b{j}.ssd.b", (B, T, H, N)),
                   (f"b{j}.ssd.log_a", (B, T, H)),
                   (f"b{j}.moe.w_gate", (d, E)),
                   (f"b{j}.moe.w_up", (E, d, 2 * F)),
                   (f"b{j}.moe.w_down", (E, F, d))]
    sizes = [torch.Size(s).numel() for _, s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        t = flat[off:off + n].view(shape)
        off += n
        if name.endswith("log_a"):
            t.abs_().mul_(-0.05)
        elif not name.startswith("x0."):
            t.mul_(0.5)
        out[name] = t
    return out


class ChainSystem:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans):
        from repro_torch.core import (MeasuredProfiler, Orchestrator,
                                      kernel_chain)
        from repro_torch.core.backends import default_registry
        self.cfg, self.device = cfg, device
        self.chain = {k: cfg[k] for k in CHAIN_KEYS}
        n_inputs = traffic["inputs"]
        t0 = time.perf_counter()
        drawn = draw(self.chain, n_inputs, seed, device)
        xs = [drawn.pop(f"x0.{i}") for i in range(n_inputs)]
        self.weights = drawn
        pin = device.type == "cuda"
        self.inputs = [x.cpu().pin_memory() if pin else x.cpu() for x in xs]
        with warnings.catch_warnings():
            # kernel_chain copies each array to the device
            warnings.simplefilter("ignore", UserWarning)
            graph, _ = kernel_chain(arrays={"x0": xs[0], **drawn},
                                    device=device, **self.chain)
        reg = default_registry(device=device)
        binding = {lane: reg.get(lane) for lane in cfg["lanes"]}
        t1 = time.perf_counter()
        table = MeasuredProfiler(strict=True, targets=binding,
                                 **cfg["profile"]).profile(graph)
        t2 = time.perf_counter()
        self.orch = Orchestrator(table, targets=binding)
        self.plan = self.orch.plan(self.orch.register(graph),
                                   objective=cfg["objective"])
        spans.update(chain_s=t1 - t0, profile_s=t2 - t1,
                     plan_s=time.perf_counter() - t2)
        self.n_ops = len(graph)

    def warm(self) -> None:
        """The plan's program compiled (probed and captured) and run warm,
        on the staged path."""
        for j in range(2):
            self.request(j % len(self.inputs))

    def request(self, j: int) -> list:
        """Input ``j`` staged to the device, the plan executed, waited
        for; every op's output, in op order."""
        x = self.inputs[j].to(self.device, non_blocking=True)
        outs = self.orch.execute(self.plan, {0: (x,)})
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return [outs[i] for i in range(self.n_ops)]

    def work(self, outs: list) -> dict:
        """Operations of one request and the bound of its expert GLU
        calls, from the routing of the program's own sort outputs."""
        cfg = self.chain
        cap = ref.capacity(cfg)
        d = cfg["heads"] * cfg["head_dim"]
        total = {"ops": 0, "expert_glu.bound_s": 0.0, "expert_glu.calls": 0}
        for j in range(cfg["blocks"]):
            x = outs[ref.op_names(cfg).index((j, "sort"))].to(self.device)
            gi, _, kept = ref.routing(x.reshape(-1, d),
                                      self.weights[f"b{j}.moe.w_gate"],
                                      cfg["top_k"], cap, lambda t: t)
            n_kept = int(kept.sum())
            used = int(torch.unique(gi[kept]).numel())
            total["ops"] += sum(workcounts.chain_block_ops(cfg,
                                                           n_kept).values())
            total["expert_glu.bound_s"] += workcounts.bound_s(
                *workcounts.expert_glu(n_kept, used, d, cfg["moe_ff"],
                                       "float32"), "float32")
            total["expert_glu.calls"] += 1
        return total

    def release(self) -> None:
        """Drop the program and its captured graphs."""
        self.orch = self.plan = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, kept: list, controls) -> dict:
        """``op_err`` and ``drift_err`` of the program, and of each
        precision in ``controls`` put in its place, over the kept
        requests."""
        strict_float32()
        names = ("op_err", "drift_err")
        out = {who: dict.fromkeys(names, 0.0)
               for who in ("program", *controls)}
        f32 = rounding("float32")
        n_drift = ref.BEFORE_FIRST_MOE
        for j, outs in kept:
            x0 = self.inputs[j].to(self.device)
            outs = [o.to(self.device) for o in outs]
            want = ref.follow(self.cfg, self.weights, x0, outs, f32)
            alone = ref.chained(self.cfg, self.weights, x0, n_drift, f32)
            got = {"program": (outs, outs[:n_drift])}
            for p in controls:
                got[p] = (ref.follow(self.cfg, self.weights, x0, outs,
                                     rounding(p)),
                          ref.chained(self.cfg, self.weights, x0, n_drift,
                                      rounding(p)))
            for who, (ys, drift) in got.items():
                errs = {"op_err": max(op_err(y, w)
                                      for y, w in zip(ys, want)),
                        "drift_err": max(op_err(y, w)
                                         for y, w in zip(drift, alone))}
                for n in names:
                    out[who][n] = max(out[who][n], errs[n])
        return out


def op_err(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    w = want.double()
    return float((got.double() - w).abs().max() / w.abs().max())


def build(cfg: dict, traffic: dict, seed: int, device, spans: dict):
    return ChainSystem(cfg, traffic, seed, device, spans)
