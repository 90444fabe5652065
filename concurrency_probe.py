#!/usr/bin/env python3
"""Where the concurrent program's time goes on the card.

Run from the root of a checkout, on a machine with an NVIDIA H100 (after
or instead of ``chip_smoke.py``; it builds the kernels the same way):

    python3 concurrency_probe.py

It sets up what ``chip_smoke.py`` phases 3 and 4 set up (request A at
the Granite widths, B at seq 256, profiled on the four lanes, planned
jointly), then times the (A, B) concurrent program's warm run, fenced,
median of 5, under conditions that each remove one suspected cost:

* ``threaded`` — as ``Orchestrator.execute`` runs it: one thread and
  one CUDA stream per lane;
* ``switch 50us`` — the same with ``sys.setswitchinterval(5e-5)`` (the
  interpreter hands the GIL to a waiting thread after 50 µs instead of
  5 ms);
* ``1 intra-op thread`` — the same with ``torch.set_num_threads(1)`` (the
  host lanes' torch ops no longer spread over every core);
* ``gc off`` — the same with Python's garbage collector disabled;
* ``inline, plan's lanes`` — each request alone with the plan's op →
  lane assignment, inline on one thread and one stream, back to back;
* ``one lane, plan's steps`` — the plan's steps with every op on
  ``cuda-kernels``: one lane, so the program runs inline, but cut into
  the plan's barrier segments;
* ``back to back`` — each request's own sequential plan, compiled, one
  after the other.

Every line names the card and its power limit; a failed setup exits
non-zero.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPEATS = 5


def main() -> int:
    try:
        import torch
    except ImportError:
        print("concurrency_probe: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("concurrency_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import (ConcurrentSchedule, ConcurrentStep,
                                  GRANITE_MAIN_PATH, MeasuredProfiler,
                                  kernel_chain)
    from repro_torch.core.profiler import fence

    env = cs.phase_environment()
    main = cs.phase_main_path(GRANITE_MAIN_PATH)
    orch, binding = main["orch"], main["binding"]
    graph_b, ext_b = kernel_chain(seed=1, **{**GRANITE_MAIN_PATH,
                                             "seq": 256})
    table_b = MeasuredProfiler(warmup=1, iters=3, strict=True,
                               targets=binding).profile(graph_b)
    hs = [main["h"], orch.register(graph_b, table=table_b)]
    graphs, exts = [main["graph"], graph_b], [main["ext"], ext_b]
    plan = orch.plan(hs)

    def timed(fn) -> tuple:
        """(median, min, max) seconds of ``REPEATS`` warm runs, and the
        caching allocator's device allocations (``cudaMalloc``) during
        them."""
        fence([list(o.values()) for o in fn()])
        allocs = torch.cuda.memory_stats()["num_device_alloc"]
        ts = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            fence([list(o.values()) for o in fn()])
            ts.append(time.perf_counter() - t0)
        allocs = torch.cuda.memory_stats()["num_device_alloc"] - allocs
        return sorted(ts)[len(ts) // 2], min(ts), max(ts), allocs

    alone = [orch.executor.compile_scheduled(
        g, dict(plan.schedule.assignment_of(k)))
        for k, g in enumerate(graphs)]
    steps = [ConcurrentStep(ops=st.ops, pus=tuple(
        None if p is None else "cuda-kernels" for p in st.pus),
        cost=st.cost) for st in plan.schedule.steps]
    one_lane = orch.executor.compile_concurrent(graphs, ConcurrentSchedule(
        steps=steps, latency=plan.latency, energy=plan.energy,
        objective=plan.objective, mode=plan.schedule.mode))
    seq = [orch.program_for(orch.plan(h), e) for h, e in zip(hs, exts)]

    rows = {}
    rows["threaded"] = timed(lambda: orch.execute(plan, exts))
    old = sys.getswitchinterval()
    sys.setswitchinterval(5e-5)
    rows["switch 50us"] = timed(lambda: orch.execute(plan, exts))
    sys.setswitchinterval(old)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rows["1 intra-op thread"] = timed(lambda: orch.execute(plan, exts))
    torch.set_num_threads(n_threads)
    gc.collect()
    gc.disable()
    rows["gc off"] = timed(lambda: orch.execute(plan, exts))
    gc.enable()
    rows["inline, plan's lanes"] = timed(
        lambda: [p.run(e) for p, e in zip(alone, exts)])
    rows["one lane, plan's steps"] = timed(lambda: one_lane.run(exts))
    rows["back to back"] = timed(
        lambda: [p.run(e) for p, e in zip(seq, exts)])
    rows["threaded, again"] = timed(lambda: orch.execute(plan, exts))

    def segments(prog, ext) -> str:
        """Host ms of each segment of one warm inline run."""
        trace = []
        fence(list(prog.run(ext, trace=trace).values()))
        return "  ".join(f"{t.lane}:{[i for _, i in t.items]}:"
                         f"{1e3 * t.seconds:.3f}" for t in trace)

    print(env["card"])
    for k, name in enumerate("AB"):
        route = dict(plan.schedule.assignment_of(k))
        print(f"request {name}: plan's lanes "
              f"{[route[i] for i in range(len(graphs[k]))]}")
        print(f"  alone on the plan's lanes, segments (lane:ops:host ms): "
              f"{segments(alone[k], exts[k])}")
        print(f"  its own sequential plan, segments: "
              f"{segments(seq[k], exts[k])}")
    print(f"(A, B) plan: predicted {1e3 * plan.latency:.3f} ms; "
          f"torch intra-op threads {n_threads}; {REPEATS} warm runs each, "
          "fenced (median, min, max; cudaMalloc calls during them):")
    for label, (med, lo, hi, allocs) in rows.items():
        print(f"  {label:24s} {1e3 * med:9.3f} ms  ({1e3 * lo:.3f} - "
              f"{1e3 * hi:.3f})  allocs {allocs}")
    orch.program_for(plan, exts).close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
