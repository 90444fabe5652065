#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing falls back to the CPU):

1. environment — the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions; builds the three kernels from the sources in
   ``src/repro_torch/csrc`` and times the build; prints ptxas's registers
   and spills per instantiation, and whether each instantiation of the
   bf16 attention, the f32 attention at D 64 / 128 / 160, the bf16 SSD scan,
   the f32 SSD scan at N = 64 and at N 128-448 and the f32 and bf16
   expert GLU holds
   ``HGMMA`` (wgmma) in its SASS and, where it loads by TMA, ``UTMALDG``;
2. kernels — holds each CUDA kernel against its plain PyTorch version on
   the card, at shapes of ``tests/test_kernels.py`` (GQA, padded T,
   decode with ``q_offset``, ``initial_state``, capacity drop), at the
   main-path shapes, at d = 2048 for the expert GLU and at chunks 128
   and 256 (one case under strong decay) for the SSD scan, in f32 and
   bf16, and the f32 scan above N = 64 at small sizes
   (``F32_WIDE_SSD_CASES``: N 128-448, P 385 and 384, initial states,
   ragged T, operands off 16 bytes); checks that each kernel is bitwise
   equal between two runs on the same inputs, and that each f32 attention
   call and each f32 scan call at the main path and above N = 64 launched
   the design the C entry's rule names (from a child's device trace); and
   times kernel, plain version, (where one exists) a
   library call and, for the f32 attention, SSD scan and expert GLU, the
   earlier ``mma.sync`` kernels on the same operands (the scan also by
   kernel on the device, in a child process); the bf16 expert GLU at the
   main path's widths, Granite's decode (cap 16) and DeepSeek-V3's expert
   widths beside the ``mma.sync`` kernel and the bmm GLU, with its bound
   and each kernel's distance in bf16 ulps from the plain version, and the
   kernels its rule launched from a child's device trace;
3. main path — ``kernel_chain`` at the Granite-3.0-1B-A400M widths:
   ``MeasuredProfiler(strict=True)`` over the four lanes (numpy-eager,
   torch-cpu, cuda:0, cuda-kernels; the CUDA lanes' cells timed as
   captured replays), ``Orchestrator.plan``, the compiled program on the
   planned route and on every single-lane route, each checked against
   the interpreter oracle, with each CUDA segment's ``jit_verified``;
   one warm run of the planned route through ``Orchestrator.execute``,
   with the kernels' launch counts zeroed just before it and read just
   after; then the planned route and the ``cuda-kernels`` route each
   compiled twice, captured and eager (copies of the CUDA targets with
   ``jit=False``), timed in turns, traced, and held to each other by
   ``jit_verified``'s rule — every CUDA segment of the planned route
   must be captured;
4. concurrent requests — phase 3's chain (A) beside two chains at seq
   256 with their own weights (B, C), planned jointly as (A, B) and
   (A, B, C) on the same lanes and run as compiled concurrent programs
   (one worker thread and one CUDA stream per lane): predicted against
   measured makespan, against the requests' own programs back to back;
   each request bitwise its run alone with the same op -> lane
   assignment, within the route bound of the interpreter and bitwise
   between two warm runs; the segments' host intervals, a device trace's
   busy time per stream and the streams' overlap; and each kernel's
   launches in one warm concurrent run, counted from zero;
5. DAG plans — two DAGs of the same chains as one handle each: U, the
   union of A and B (24 ops, no edge between them), and F, a fork (A's
   12 ops and a one-block tower D of its own weights hung off A's op 5),
   with phases 3 and 4's measured cost rows and D profiled anew.  U
   auto-routes to the DAG route's union-grid sweep, whose latency the
   frontier DP matches; F auto-routes to the parallel solve, and
   ``mode="dag"`` gives the phase route at its latency, bitwise.  Each of
   the four DAG plans (U union-grid and frontier, F phase and frontier)
   runs compiled: within the route bound of the interpreter (``run_dag``),
   two warm runs bitwise equal, every kernel segment verified, every
   output on its lane's device, launches as its kernel-lane ops;
   predicted against measured, co-scheduled steps, a device trace's
   stream overlap and idle share.  Baselines: every op on
   ``cuda-kernels`` (which must launch all three kernels), the best
   sequential route over the topological order, and for U the two
   requests' own programs back to back;
6. online admission — A admitted alone, B and C (phase 4's) admitted as
   the executed steps' estimated cost passes 40% and 70% of A's
   predicted latency; every re-plan a horizon window
   (``DEFAULT_HORIZON_STATES``), held bitwise to the cold solve of the
   same progress; each window of steps compiled as a window program from
   the frontier (``completed=``, ``partial=True``), run cold (probe and
   capture) and warm (committed), ``advance`` by what completed and
   ``retire`` at each request's end.  Each request's outputs are bitwise
   its run alone with the op -> lane assignment it was given and within
   the route bound of the interpreter; windows, re-plans with their solve
   ms, the cold cost per window and each request's time from admission
   to completion are printed;
7. serving under faults — (a) phase 3's planned route of A, and the same
   route cut by one op on ``cuda:0``, lose ``cuda-kernels`` at an early
   and a late kernel op under ``Orchestrator.execute`` (``recover=True``,
   the default): one recovery each, the completed prefix bitwise the
   fault-free run's, the result bitwise the interpreter's resume from
   that frontier on the stitched assignment and within the route bound
   of the oracle; ``on_condition`` on an active A re-stitches it
   bitwise as ``DynamicScheduler.on_condition`` does; the nominal
   condition is restored.  (b) ``ServingEngine(execution="real",
   compile_exec=True)`` serves A, B and C (phases 3-4's graphs and
   measured tables, on a fresh session) from a Poisson trace of 8
   requests at 1.5 per A's predicted latency under bench_chaos's four
   scenarios aimed at the card's lanes (a transient storm; a straggler
   and a stall on ``cuda-kernels``, the stall's watchdog budget set
   from phase 6's cold window costs; ``cuda-kernels`` lost and
   restored): each run drains, no completion is a wrong answer (bitwise
   its solo run with the assignment it was given, within the route
   bound of the interpreter), every scripted event fired, and after the
   loss the kernel lane's breaker opens, half-opens and closes.  The
   reports, breaker transitions with their reasons, cache deltas and
   window costs are printed; every kernel of the chain launched in the
   phase;
8. model zoo serving — (a) Llama-3.2-1B, Zamba2-2.7B and xLSTM-125M at
   their published widths and depths in bf16 with ``use_kernels=True``
   (weights from ``init_params`` with a seeded generator on the card)
   serve 4 prompts of 1024 tokens through ``Engine.generate(max_new=
   32)``: one prefill launches ``flash_attention`` 16 times (Llama) or
   ``ssd_scan`` 54 times (Zamba2) or 6 times (xLSTM's mLSTM at N = 384,
   P = 385), counted from zero, and decode ``ssd_step`` once a Mamba-2
   layer or mLSTM block a step and nothing else; the kernel prefill's
   logits and every cache leaf against the plain path's
   (``use_kernels=False``) within the bf16 bucket of the largest value,
   or within ZOO_SPREAD times the spread between two correct plain paths
   where one is given (the scan at chunk 128), whichever is larger; each
   kernel call of the prefill within the bucket of the layer's plain
   math on the same inputs; in f32 at full width, the same comparison
   within 2e-4 at cut depth (Llama 2 layers, Zamba2 6, xLSTM 4) and at
   full depth; every captured decode step's logits and cache bitwise the
   eager ``decode_step``'s; two generates capture once and give the
   checked loop's tokens.  StableLM-12B (d_head 160) at full width, cut
   to 4 of its 40 layers: the kernel prefill against the plain one in
   bf16 and f32, each attention call held.  Prefill and decode times
   (captured and eager, in turns), tokens per second, peak memory, a
   device trace of a prefill and of captured steps, and each kernel at
   these shapes beside SDPA and its bound are printed.  (b) every arch
   reduced, prefill and 4 decode steps with the kernels against
   without (the decode step's kernel against the plain step on the
   model's own operands), in f32 within 2e-4, each launching the kernels
   its pattern calls and the plain path none.  (c) the zoo's kernel shapes — the prefill attention at each
   head width of the dense archs (q (4, 1024, 32, D), k/v 8 heads,
   causal: Llama-3.2-1B's D 64, Qwen3-8B's 128, StableLM-12B's 160) and
   xLSTM-125M's mLSTM scan (c/b (4, 1024, 4, 384), v (4, 1024, 4, 385),
   chunk 256) — in bf16 and f32 against the plain versions, bitwise run
   to run, with kernel, plain, SDPA and bound times (in f32, each
   design's C entry beside the earlier ``mma.sync`` kernels' on the same
   operands, and the kernels by name and device time from a child's
   trace, which must be the rule's; the bf16 attention's
   bound counts P as two bf16 terms: 6 D operations a pair); the bf16
   attention also within one bf16 ulp of the f32 kernel on the upcast
   inputs, element by element (SDPA's distance printed beside it);
   shapes beyond the kernels (N > ``MAX_STATE``, D = 96) raise
   ``ValueError`` and launch nothing;
9. training — Llama-3.2-1B at its published widths and depth (bf16
   params, f32 AdamW state, remat on), ``SyntheticTokenSource`` batches
   of 8 x 1024, under ``deterministic_training``: (a) 6 steps
   uninterrupted; (b) the same 6 steps through ``launch.train.main``
   with a checkpoint every 3 steps and a ``RecoverableError`` injected
   at step 4, so ``run_with_recovery`` restores step 3's checkpoint and
   goes on: the losses bitwise (a)'s, the final checkpoint restoring
   (a)'s params bitwise, one restart; (c) one step with top-k
   compression and one with 2 microbatches.  Step time (median of the
   warm steps), tokens a second, the bf16-peak share (6 x params x
   tokens / step time / 989 TFLOP/s), peak memory, checkpoint save and
   restore seconds and a traced step's device-busy share are printed;
   the phase has a time budget;
10. the mesh — on ``make_host_mesh()``, a (1, 1) mesh over one NCCL
   rank: (a) Llama-3.2-1B's phase 9 step through ``jit_train_step`` with
   ``Policy(mesh, fsdp=True)`` for 3 steps on phase 9's batches, losses
   and params bitwise phase 9's unsharded steps (else the largest
   difference is printed and held within 1e-6 relative), step time
   beside phase 9's; (b) ``jit_prefill`` and 4 ``jit_decode_step``s of
   Llama-3.2-1B and Zamba2-2.7B at full width in bf16 with the kernels:
   ``flash_attention`` / ``ssd_scan`` launch as in phase 8's prefill
   (through the kernels' mesh entry), counted from zero, and logits and
   every cache leaf are bitwise the meshless ``prefill`` /
   ``decode_step``'s, prefill ms beside phase 8's and a traced mesh
   prefill's device-busy share; (c) ``autoshard`` and
   ``autoshard_parallel`` on ``model_op_graph`` of Granite-3.0-1B
   (train, 256 x 4096) and DeepSeek-V3 (decode, 128 x 32768) at
   (16, 16) on the H100 constants (speedup and route printed),
   ``emit_overrides`` applied to Granite's ``loss_fn`` at full width,
   1 x 1024, on the card's mesh (bitwise the meshless loss), and the
   measurements behind the constants (a launch's host time, a one-rank
   NCCL all-reduce, a bf16 GEMM's and the bf16 flash attention's share of
   the peak); (d) ``launch.dryrun`` in a child process on the host for
   ``llama3.2-1b|train_4k|16x16`` and ``deepseek-v3-671b|decode_32k|
   2x16x16`` (fake groups of 256 and 512 ranks): per-device GiB against
   the card's 80, FLOPs, bytes, collective bytes by kind and the
   dominant term, each cell within 60 s, beside the reference's
   compiled record of the same cell (constants, ``DRYRUN_REFERENCE``):
   the port's GiB a device within 2x the reference's, its collective B a
   chip within ``DRYRUN_COLL_CEILING`` times the reference's, and
   ``select_layer``'s share of them logged.  The phase has a time
   budget;
11. the examples — each of ``examples/torch_*.py`` in this process on
   the card (``train_e2e`` at 2 layers of width 256, 40 steps, a
   checkpoint every 20): each must finish and print its last check
   (outputs against the oracle, a recovery bitwise, the resumed train
   run bitwise the uninterrupted one, the step under autoshard's
   overrides bitwise the meshless one) and leave no process group
   behind; the kernels' launches over ``torch_heterogeneous_serving``
   (its kernel chain profiled on the four lanes, the planned run, the
   engine with the kernels) are counted from zero, each at least once,
   and added to the ``kernels`` line once what it launched is held
   against the plain versions at its shapes: its planned run's kernel
   segments verified by their probes and its outputs within 3e-4 of the
   oracle (the example's own check), its chain with every op on
   ``cuda-kernels`` verified and within ``ROUTE_BUCKET`` of the oracle,
   and its engine's kernel prefill against the plain prefill within 2e-4
   (f32), every leaf.  The phase has a time budget.

The second-to-last line is the ``{"kernels": [...]}`` summary (phase 2's
three kernels, and the decode step's at Zamba2-2.7B's decode shape from
phase 8 (c), its launches those of phases 8 and 10's decode steps), the
last line ``{"ok": true, "device": {...}}``.  A full log goes to
``chiprun_out/chip_smoke.log``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LOG = ROOT / "chiprun_out" / "chip_smoke.log"

# H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, TF32 and bf16
# on the tensor cores, HBM3 bandwidth.  Bounds below are stated against
# these.  Every kernel runs its f32 products in 3xTF32 on the tensor
# cores, so it is bound by three TF32 products per f32 one; its CUDA-core
# f32 bound is printed beside it.
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

F32_TOL, BF16_TOL = 3e-5, 3e-2          # tests/test_kernels.py buckets
LANES = ("numpy-eager", "torch-cpu", "cuda:0", "cuda-kernels")
REPEATS = 3                              # warm runs timed per route
CAPTURE_REPEATS = 11     # warm runs of each of phase 3's captured / eager pair
# which kernel each op of kernel_chain launches on the kernel lane
KERNEL_OF_OP = {"attn": "flash_attention", "ssd": "ssd_scan",
                "moe": "expert_glu"}
# the kernels a chain launches (the decode step's, ssd_step, is not one)
CHAIN_KERNELS = tuple(KERNEL_OF_OP.values())
# A whole route is held to the oracle op by op, on the error normalised
# by the output's largest magnitude: within the f32 variant bucket, or
# within SPREAD times the spread between two correct runs of the
# reference payloads (host and card) at that op, whichever is larger.
# At the Granite widths the chain amplifies any f32 reordering (the two
# reference runs differ by up to 1.6e-2 at the last tanh), so a route's
# drift is bounded by the chain's conditioning; each kernel on its own
# is held to the bucket by its lane's probe and by phase 2.
ROUTE_BUCKET, SPREAD = 3e-4, 4.0
# the __global__ functions of src/repro_torch/csrc (a device trace names
# the stream each one ran on)
HAND_KERNELS = ("attn_kernel", "attn_wgmma_kernel", "attn_tf32_kernel",
                "gemm_kernel",
                "glu_wgmma_kernel", "glu_bf16_kernel", "state_kernel",
                "pass_kernel",
                "out_kernel", "state_wgmma_kernel", "chunk_out_kernel",
                "out_wgmma_kernel", "state_tf32_kernel", "out_tf32_kernel",
                "out_wide_tf32_kernel", "pad_v_kernel", "ssd_step_kernel")

_log_lines: list[str] = []


def log(msg: str = "") -> None:
    print(msg, flush=True)
    _log_lines.append(msg)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    log(f"  [{'PASS' if ok else 'FAIL'}] {what}")
    if not ok:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def norm_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|), in float64."""
    g, w = got.double(), want.double().to(got.device)
    err = float((g - w).abs().max())
    scale = float(w.abs().max())
    return err, err / scale if scale > 0 else err


def rand(rng, shape, dtype, scale=1.0):
    import torch
    a = rng.standard_normal(shape, dtype="float32") * scale
    return torch.from_numpy(a).to("cuda").to(dtype)


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def ssd_flops(B: int, H: int, nc: int, C: int, N: int, P: int,
              bf16: bool) -> int:
    """Operations of the chunked SSD scan over B x H sequences of nc
    chunks of C steps: c b^T and G v over a chunk's C (C + 1) / 2 causal
    (query, key) pairs, the inter term c S_in and the chunk state (b o
    w)^T v over its C steps.  In bf16, under the contract, c b^T is exact
    in one bf16 pass and each product with an f32 operand (G, S_in, b o
    w) takes two bf16 terms; in f32 each product is one pass (tc_bound
    counts 3xTF32's three)."""
    pairs = C * (C + 1) // 2
    if bf16:
        return B * H * nc * (2 * pairs * N + 4 * pairs * P + 8 * C * N * P)
    return B * H * nc * (2 * pairs * (N + P) + 4 * C * N * P)


def tc_bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """Bound of a tensor-core kernel: f32 products as 3xTF32 (three TF32
    products each), bf16 ones at the bf16 peak."""
    import torch
    if dtype == torch.bfloat16:
        return bound(flops, nbytes, PEAK_BF16)
    return bound(3 * flops, nbytes, PEAK_TF32)


def bitwise_equal(a, b) -> bool:
    """Same shape, dtype and bits (NaNs included)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return bool(torch.equal(a.view(bits), b.view(bits)))


def check_repeatable(name, label, fn, args) -> None:
    """Two runs of ``fn(*args)`` give the same bits (fixed-order sums);
    ``fn`` returns a tensor or a tuple of tensors."""
    import torch
    first, second = fn(*args), fn(*args)
    torch.cuda.synchronize()
    if isinstance(first, torch.Tensor):
        first, second = (first,), (second,)
    check(all(bitwise_equal(a, b) for a, b in zip(first, second)),
          f"{name} {label} {str(args[0].dtype)[6:]}: two runs on the same "
          "inputs are bitwise equal")


def _expected_launches(prog) -> dict:
    """Launches of each kernel in one run of ``prog``: one per op of a
    kernel kind in a segment that serves the kernel dialect."""
    from repro_torch import kernels
    from repro_torch.core import KERNEL_DIALECTS
    expected = dict.fromkeys(kernels.launch_counts(), 0)
    for seg in prog.segments:
        if seg.use_variant and seg.target.dialect in KERNEL_DIALECTS:
            for r, i in seg.items:
                kind = prog.graphs[r].ops[i].name.rsplit(".", 1)[-1]
                if kind in KERNEL_OF_OP:
                    expected[KERNEL_OF_OP[kind]] += 1
    return expected


def _counted_run(run, prog, label, every_kernel: bool) -> dict:
    """One warm ``run()`` with the launch counts zeroed just before and
    read just after; each kernel must have launched once per kernel-lane
    op of its kind (each of the chain's at least once when
    ``every_kernel``)."""
    from repro_torch import kernels
    from repro_torch.core.profiler import fence
    kernels.reset_launch_counts()
    fence([list(o.values()) for o in run()])
    counts = kernels.launch_counts()
    expected = _expected_launches(prog)
    log(f"    kernel launches in one warm run ({label}): {counts}")
    for name, count in counts.items():
        check(count == expected[name] and (count >= 1 or not every_kernel
                                           or name not in CHAIN_KERNELS),
              f"{label}: {name} launched {count} times (its kernel-lane "
              f"ops: {expected[name]}"
              + (", at least 1)" if every_kernel and name in CHAIN_KERNELS
                 else ")"))
    return counts


# ---------------------------------------------------------------------------
# phase 1: environment and build
# ---------------------------------------------------------------------------

def phase_environment() -> dict:
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log("== phase 1: environment")
    log(card)
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    # the mma.sync expert GLU (gemm_kernel) on the aligned f32 rows, the
    # mma.sync f32 attention (attn_kernel) at D 64 / 128 / 160 on aligned
    # operands and the mma.sync f32 scan at N = 64, phase 2's and 8's
    # baselines, built beside the kernels (kernel_variants.py's mma_sync)
    import kernel_variants
    baseline = kernel_variants.start(
        ("expert_glu", "flash_attention", "ssd_scan"), ("mma_sync",))
    paths = _build.build_all()
    for name in _build.KERNELS:
        _build.function(name)
    log(f"built {len(paths)} kernels in {time.perf_counter() - t0:.1f}s")
    baselines = kernel_variants.finish(baseline)
    glu_baseline = kernel_variants.bind(baselines["mma_sync", "expert_glu"],
                                        "expert_glu")
    attn_baseline = kernel_variants.bind(
        baselines["mma_sync", "flash_attention"], "flash_attention")
    ssd_baseline = kernel_variants.bind(baselines["mma_sync", "ssd_scan"],
                                        "ssd_scan")
    log(f"built the baselines in {time.perf_counter() - t0:.1f}s")
    log("ptxas, per instantiation (registers a thread, static shared "
        "memory, spill stores / loads):")
    for name, out in _build.build_log.items():
        usage = _build.ptxas_usage(out)
        names = _build.demangle([u["name"] for u in usage])
        for u, full in zip(usage, names):
            end = full.find(">(")       # cut the parameter list
            short = full[:end + 1] if end >= 0 else full
            short = short.replace("void ", "").replace("<unnamed>::", "")
            log(f"  {name}: {u['registers']:3d} regs, smem {u['smem']} B, "
                f"spills {u['spill_stores']} / {u['spill_loads']} B  "
                f"{short[:100]}")
    _hopper_sass(paths["flash_attention"], ("attn_wgmma_kernel",),
                 "the bf16 attention", "Lb1E")
    # the f32 attention at D 64, 128 and 160: 3xTF32 wgmma, fed by TMA
    _hopper_sass(paths["flash_attention"], ("attn_tf32_kernel",),
                 "the f32 wgmma attention", "attn_tf32_kernel")
    # the bf16 scan: its chunk states and carry, then its chunk outputs
    # (a block a chunk at N <= 64, a block a q tile above)
    _hopper_sass(paths["ssd_scan"], ("state_wgmma_kernel", "chunk_out_kernel",
                                     "out_wgmma_kernel"),
                 "the bf16 SSD scan", "ILb1E")
    # the f32 scan at N = 64 and at N 128-448: 3xTF32 wgmma, every
    # instantiation fed by TMA (b always, v where TMA reads it)
    _hopper_sass(paths["ssd_scan"], ("state_tf32_kernel", "out_tf32_kernel",
                                     "out_wide_tf32_kernel"),
                 "the f32 wgmma SSD scan", "tf32_kernel")
    # the f32 expert GLU on 16-byte rows: TF32 wgmma, every
    # instantiation fed by TMA
    _hopper_sass(paths["expert_glu"], ("glu_wgmma_kernel",),
                 "the f32 expert GLU", "glu_wgmma_kernel")
    # the bf16 expert GLU on 16-byte rows: bf16 wgmma, every
    # instantiation fed by TMA
    _hopper_sass(paths["expert_glu"], ("glu_bf16_kernel",),
                 "the bf16 expert GLU", "glu_bf16_kernel")
    return {"card": card, "glu_baseline": glu_baseline,
            "attn_baseline": attn_baseline, "ssd_baseline": ssd_baseline}


def _hopper_sass(lib, kernels: tuple, what: str, tma_mark: str) -> None:
    """Whether the built library's SASS (``cuobjdump -sass``) holds
    ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA loads) in each instantiation of
    the wgmma ``kernels``: every one must run wgmma, and the TMA ones
    (whose mangled name holds ``tma_mark``: ``attn_wgmma_kernel<D,
    true>``, the bf16 scan's kernels with their first template argument
    ``true``, c and b or b by TMA, every ``glu_wgmma_kernel``,
    ``glu_bf16_kernel``, ``attn_tf32_kernel`` and f32 scan kernel) must
    load by TMA."""
    import re
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib.name}")
    funcs = re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)",
                       out.stdout, re.S)
    wg = [(n, body) for n, body in funcs if any(k in n for k in kernels)]
    names = _build.demangle([n for n, _ in wg])
    log(f"SASS of {what} (wgmma: HGMMA, TMA loads: UTMALDG):")
    ok = bool(wg)
    n_tma = 0
    for (mangled, body), full in zip(wg, names):
        kernel = next(k for k in kernels if k in full)
        k0 = full.find(kernel)
        short = full[k0:full.find(">(") + 1 or full.find("(", k0)]
        hgmma, utmaldg = body.count("HGMMA"), body.count("UTMALDG")
        tma = tma_mark in mangled
        n_tma += tma
        ok = ok and hgmma > 0 and (utmaldg > 0 or not tma)
        log(f"  {short or mangled}: HGMMA {hgmma}, UTMALDG {utmaldg}")
    check(ok, f"every one of the {len(wg)} instantiations of {what} runs "
              f"wgmma, and the {n_tma} TMA ones load by TMA")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _attn_case(rng, B, Tq, Tk, Hq, Hk, D, causal, off, dtype):
    from repro_torch.kernels import flash_attention as fa
    q = rand(rng, (B, Tq, Hq, D), dtype)
    k = rand(rng, (B, Tk, Hk, D), dtype)
    v = rand(rng, (B, Tk, Hk, D), dtype)
    got = fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
    want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off)
    return (q, k, v), got, want


def _unaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past an
    allocation's start, so not on a 16-byte boundary."""
    import torch
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    u = flat[1:].view(t.shape)
    u.copy_(t)
    return u


def _ssd_case(rng, B, T, H, N, P, chunk, with_s0, dtype, decay=None):
    """One SSD case; ``decay`` (< 0) draws log_a around that value per
    step instead of -softplus(N(0, 1))."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    c = rand(rng, (B, T, H, N), dtype, 0.5)
    b = rand(rng, (B, T, H, N), dtype, 0.5)
    v = rand(rng, (B, T, H, P), dtype)
    if decay is None:
        la = -torch.nn.functional.softplus(rand(rng, (B, T, H),
                                                torch.float32))
    else:
        la = (decay + 0.5 * rand(rng, (B, T, H), torch.float32)).clamp(max=0)
    s0 = rand(rng, (B, H, N, P), torch.float32) if with_s0 else None
    y, s = ss.ssd_scan_cuda(c, b, v, la, initial_state=s0, chunk=chunk)
    yp, sp = ss.ssd_scan_plain(c, b, v, la, initial_state=s0, chunk=chunk)
    return (c, b, v, la, s0), (y, s), (yp, sp)


def _ssd_entry(fn, c, b, v, la, chunk):
    """A call of the scan's C entry point ``fn`` (the shipped library's or
    a baseline's) on c, b, v, log_a at ``chunk``, no initial state, into
    its own y (``.y``) and final state; fails on a cudaError_t."""
    import torch
    B, T, H, N = c.shape
    P = v.shape[-1]
    y = torch.empty_like(v)
    s = torch.empty((B, H, N, P), device=v.device)
    from repro_torch.kernels import ssd_scan as ss
    work = torch.empty(ss.scratch_floats(c, b, v, chunk), device=v.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(c.data_ptr(), b.data_ptr(), v.data_ptr(), la.data_ptr(),
                 None, y.data_ptr(), s.data_ptr(), work.data_ptr(), B, T, H,
                 N, P, chunk, int(v.dtype == torch.bfloat16), stream)
        if err != 0:
            check(False, f"ssd_scan's C entry: cudaError_t {err}")
    call.y = y
    return call


def _glu_case(rng, E, cap, d, F, dtype, scale):
    from repro_torch.kernels import moe_gather as mg
    x = rand(rng, (E, cap, d), dtype)
    w_up = rand(rng, (E, d, 2 * F), dtype, scale)
    w_down = rand(rng, (E, F, d), dtype, scale)
    return (x, w_up, w_down), mg.expert_glu_cuda(x, w_up, w_down), \
        mg.expert_glu_plain(x, w_up, w_down)


def _hold(name, label, got, want, dtype, elementwise: bool) -> float:
    import torch
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err, rel = norm_err(got, want)
    ok = rel <= tol
    if elementwise:
        ok = ok and bool(torch.allclose(got.double(), want.double(),
                                        atol=tol, rtol=tol))
    check(ok, f"{name} {label} {str(dtype)[6:]}: max err {err:.3e}, "
              f"/max|plain| {rel:.3e} <= {tol:g}"
              + (" (and elementwise)" if elementwise else ""))
    return err


# _f32_routes's child: each f32 attention call's kernels by name, from a
# device trace, beside the kernel the C entry's rule names
_F32_ROUTE_CHILD = """
import json, sys
import torch
import chip_smoke as cs
from repro_torch.kernels import flash_attention as fa
out = {}
for label, (B, Tq, Tk, Hq, Hk, D, unaligned) in json.loads(sys.argv[1]).items():
    q = torch.randn(B, Tq, Hq, D, device="cuda")
    k, v = (torch.randn(B, Tk, Hk, D, device="cuda") for _ in range(2))
    if unaligned:
        k, v = cs._unaligned(k), cs._unaligned(v)
    ran = cs._device_times(lambda: fa.flash_attention_cuda(q, k, v), calls=1)
    out[label] = [sorted(ran), fa.f32_kernel(q, k, v)]
print(json.dumps(out))
"""


def _f32_routes(cases: dict) -> None:
    """Each f32 attention call of ``cases`` ({label: (B, Tq, Tk, Hq, Hk,
    D, k/v unaligned)}) launched, in a device trace, the one kernel the C
    entry's rule names (``flash_attention.f32_kernel``: the wgmma design
    at D 64, 128 and 160 on 16-byte boundaries, else the mma.sync one).  The
    traces are taken in a child process: late in a whole run this
    process's traces can hold none of the port's kernels (PERF.md §7).
    The child loads the library this run built."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    run = subprocess.run([sys.executable, "-c", _F32_ROUTE_CHILD,
                          json.dumps(cases)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    check(run.returncode == 0,
          f"the f32 attention's kernels by name in a child process: exit "
          f"{run.returncode} {run.stderr.strip()[-400:]}")
    for label, (ran, want) in json.loads(
            run.stdout.strip().splitlines()[-1]).items():
        check(ran == [want], f"flash_attention {label} float32: launched "
                             f"{ran}, the rule's {want}")


# phase 2's f32 scan above N = 64 at small sizes, (B, T, H, N, P, chunk,
# initial state, operands off 16 bytes): the wide design at xLSTM-125M's
# mLSTM widths (N 384, P 385: v copied into padded rows first) and beside
# them (P 384: v read as it lies; N 128, 448; N 256 with v off 16 bytes),
# ragged T, and b off 16 bytes, which the rule sends to the mma.sync
# kernels
F32_WIDE_SSD_CASES = {
    "N 384 P 385, T 300 chunk 256, initial_state":
        (1, 300, 2, 384, 385, 256, True, ()),
    "N 384 P 384, T 200 chunk 64": (2, 200, 1, 384, 384, 64, False, ()),
    "N 128 P 385, T 300 chunk 128, initial_state":
        (1, 300, 2, 128, 385, 128, True, ()),
    "N 128 P 384, T 100 < chunk, initial_state":
        (1, 100, 3, 128, 384, 256, True, ()),
    "N 256 P 100, v off 16 bytes": (1, 150, 2, 256, 100, 64, True, ("v",)),
    "N 448 P 200, T 333 chunk 128, initial_state":
        (1, 333, 2, 448, 200, 128, True, ()),
    "N 384 P 385, b off 16 bytes (the mma.sync kernels)":
        (1, 200, 2, 384, 385, 256, False, ("b",)),
}


def _f32_wide_ssd_case(rng, B, T, H, N, P, chunk, with_s0, off):
    """One case of ``F32_WIDE_SSD_CASES`` in f32: (c, b, v, log_a, s0),
    the operands named in ``off`` copied off a 16-byte boundary."""
    import torch
    f32 = torch.float32
    x = dict(c=rand(rng, (B, T, H, N), f32, 0.5),
             b=rand(rng, (B, T, H, N), f32, 0.5), v=rand(rng, (B, T, H, P), f32))
    for name in off:
        x[name] = _unaligned(x[name])
    la = -torch.nn.functional.softplus(rand(rng, (B, T, H), f32))
    s0 = rand(rng, (B, H, N, P), f32) if with_s0 else None
    return x["c"], x["b"], x["v"], la, s0


# _f32_scan_routes's child: each f32 scan case's kernels by name, from a
# device trace, beside the kernels the C entry's rule names
_SCAN_ROUTE_CHILD = """
import json, sys
import numpy as np
import chip_smoke as cs
from repro_torch.kernels import ssd_scan as ss
out = {}
for label, case in json.loads(sys.argv[1]).items():
    c, b, v, la, s0 = cs._f32_wide_ssd_case(np.random.default_rng(0), *case)
    ran = cs._device_times(lambda: ss.ssd_scan_cuda(
        c, b, v, la, initial_state=s0, chunk=case[5]), calls=1)
    out[label] = [sorted(ran), sorted(ss.f32_kernels(c, b, v))]
print(json.dumps(out))
"""


def _f32_scan_routes(cases: dict) -> None:
    """Each f32 scan call of ``cases`` (``F32_WIDE_SSD_CASES``'s form)
    launched, in a child's device trace, the kernels the C entry's rule
    names (``ssd_scan.f32_kernels``), and the rule named the wide design
    (with v's padded copy where TMA cannot read v) for every case but
    those labelled for the mma.sync kernels."""
    from repro_torch.kernels import ssd_scan as ss
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    run = subprocess.run([sys.executable, "-c", _SCAN_ROUTE_CHILD,
                          json.dumps(cases)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    check(run.returncode == 0,
          f"the f32 scan's kernels by name in a child process: exit "
          f"{run.returncode} {run.stderr.strip()[-400:]}")
    for label, (ran, want) in json.loads(
            run.stdout.strip().splitlines()[-1]).items():
        designs = (ss.F32_MMA_SYNC_KERNELS,) if "mma.sync" in label else \
            (ss.F32_WIDE_KERNELS, ss.F32_WIDE_PAD_KERNELS)
        check(ran == want and any(want == sorted(d) for d in designs),
              f"ssd_scan {label} float32: launched {ran}, the rule's {want}")


# _bf16_glu_rows's child: the bf16 expert GLU's kernels by name, from a
# device trace, beside the kernels the C entry's rule names
_GLU_ROUTE_CHILD = """
import json, sys
import torch
import chip_smoke as cs
from repro_torch.kernels import moe_gather as mg
out = {}
for label, (E, cap, d, F, unaligned) in json.loads(sys.argv[1]).items():
    x, wu, wd = cs._bf16_glu_operands(E, cap, d, F)
    if unaligned:
        x = cs._unaligned(x)
    ran = cs._device_times(lambda: mg.expert_glu_cuda(x, wu, wd), calls=1)
    out[label] = [sorted(ran), sorted(mg.bf16_kernels(x, wu, wd))]
print(json.dumps(out))
"""

def _bf16_glu_operands(E, cap, d, F):
    """x (E, cap, d), w_up (E, d, 2F), w_down (E, F, d) in bf16, drawn on
    the card from a seeded generator (DeepSeek-V3's 2.8 GB of weights in
    a moment), the weights at scale 0.5."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    return tuple((s * torch.randn(shape, device="cuda", generator=g)).to(
        torch.bfloat16) for shape, s in (((E, cap, d), 1.0),
                                         ((E, d, 2 * F), 0.5),
                                         ((E, F, d), 0.5)))


def _bf16_glu_rows(env: dict, main_shape: tuple) -> dict:
    """The bf16 expert GLU at the main path's widths, at Granite's decode
    (cap 16) and at DeepSeek-V3's expert widths, operands drawn on the
    card: the call (the design the C entry's rule names) within the bf16
    bucket of the plain version and bitwise run to run; the C entry's
    time beside the mma.sync kernel's (phase 1's baseline) on the same
    operands, the plain version's and the bmm GLU's, the bound (bf16
    tensor cores, each byte
    once), and each kernel's largest distance in bf16 ulps from the plain
    version (``bf16_ulps``), the call's no larger than the mma.sync
    kernel's and whether the two give the same bits.  A child's device
    trace shows the rule's kernels at the main path's widths, and the
    mma.sync one for x off 16 bytes.  Returns {label: row}."""
    import torch
    import torch.nn.functional as F_

    import kernel_variants
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gather as mg
    bf16 = torch.bfloat16
    E, cap, d, F = main_shape
    shapes = {"main path": main_shape,
              # Granite's decode: 64 tokens x top-8 over its 32 experts
              "Granite decode, cap 16": (E, 16, d, F),
              "DeepSeek-V3 experts": kernel_variants.DEEPSEEK_GLU}
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, (E, cap, d, F) in shapes.items():
        x, w_up, w_down = _bf16_glu_operands(E, cap, d, F)
        check(mg.bf16_kernels(x, w_up, w_down) == mg.BF16_WGMMA_KERNELS,
              f"expert_glu {label} bfloat16: the rule names the wgmma design")
        want = mg.expert_glu_plain(x, w_up, w_down)
        got = mg.expert_glu_cuda(x, w_up, w_down)
        _hold("expert_glu", label, got, want, bf16, False)
        check_repeatable("expert_glu", label, mg.expert_glu_cuda,
                         (x, w_up, w_down))
        act = torch.empty((E, cap, F), dtype=bf16, device="cuda")
        y, y_base = torch.empty_like(x), torch.empty_like(x)

        def entry(fn, y):
            def call():
                err = fn(x.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                         act.data_ptr(), y.data_ptr(), E, cap, d, F, 1,
                         stream)
                if err:        # no check line a call: it would be timed
                    check(False, f"expert_glu {label}: cudaError_t {err}")
            return call
        shipped = entry(_build.function("expert_glu"), y)
        base = entry(env["glu_baseline"], y_base)
        shipped()
        base()
        _hold("expert_glu", f"{label}, the mma.sync kernel", y_base, want,
              bf16, False)
        check(torch.equal(y, got), f"expert_glu {label} bfloat16: the C "
                                   "entry gives the wrapper's bits")

        def bmm_glu():
            h = torch.bmm(x, w_up)
            return torch.bmm(F_.silu(h[..., :F]) * h[..., F:], w_down)
        flops = E * cap * (4 * d * F + 2 * F * d)
        nbytes = 2 * (2 * x.numel() + w_up.numel() + w_down.numel())
        b_ms, b_by = tc_bound(flops, nbytes, bf16)
        row = dict(shape=(E, cap, d, F), ms=time_ms(shipped, iters=20),
                   mma_sync_ms=time_ms(base, iters=20),
                   plain_ms=time_ms(lambda: mg.expert_glu_plain(
                       x, w_up, w_down), iters=3),
                   library_ms=time_ms(bmm_glu, iters=20), bound_ms=b_ms,
                   bound_by=b_by, ops_ms=1e3 * flops / PEAK_BF16,
                   ulps=fa.bf16_ulps(got, want),
                   mma_sync_ulps=fa.bf16_ulps(y_base, want),
                   mma_sync_bits=bitwise_equal(got, y_base))
        log(f"  expert_glu bf16 {label} {row['shape']}: kernel "
            f"{row['ms']:.4f} ms, the mma.sync kernel "
            f"{row['mma_sync_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bmm GLU {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; operations {row['ops_ms']:.4f} ms); "
            f"{row['ulps']:.2f} bf16 ulps from "
            f"plain (the mma.sync kernel {row['mma_sync_ulps']:.2f}"
            + (", the same bits" if row["mma_sync_bits"] else "") + ")")
        check(row["ulps"] <= row["mma_sync_ulps"],
              f"expert_glu {label} bfloat16: no further from plain in bf16 "
              f"ulps than the mma.sync kernel")
        out[label] = row
        del x, w_up, w_down, want, got, act, y, y_base
    torch.cuda.empty_cache()     # DeepSeek's plain version held ~9 GB
    # which kernels the rule launched, in a child's device trace
    env_c = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    E, cap, d, F = main_shape
    cases = {"main path": (E, cap, d, F, False),
             "x off 16 bytes": (2, 64, 64, 32, True)}
    run = subprocess.run([sys.executable, "-c", _GLU_ROUTE_CHILD,
                          json.dumps(cases)], cwd=ROOT, env=env_c,
                         capture_output=True, text=True, timeout=300)
    check(run.returncode == 0,
          f"the bf16 expert GLU's kernels by name in a child process: exit "
          f"{run.returncode} {run.stderr.strip()[-400:]}")
    for label, (ran, want) in json.loads(
            run.stdout.strip().splitlines()[-1]).items():
        check(ran == want, f"expert_glu {label} bfloat16: launched {ran}, "
                           f"the rule's {want}")
    return out


def phase_kernels(main_cfg: dict, env: dict) -> dict:
    """Every kernel against its plain version; returns the per-kernel
    rows of the summary line (all but ``launches``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F_
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gather as mg
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.payloads import top_k_gates

    log("== phase 2: kernels against their plain versions on the card")
    rng = np.random.default_rng(0)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {}

    B, T, H, D = (main_cfg[k] for k in ("batch", "seq", "heads", "head_dim"))
    N, E, F, K = (main_cfg[k] for k in ("state", "experts", "moe_ff", "top_k"))
    d = H * D
    cap = -(-(B * T * K) // E)

    # -- flash attention -------------------------------------------------
    attn_cases = [
        ("GQA 4/2", (2, 256, 256, 4, 2, 64, True, 0), True),
        ("padded T=200, GQA 4/1", (2, 200, 200, 4, 1, 32, True, 0), True),
        ("non-causal D=128", (1, 64, 512, 4, 2, 128, False, 0), True),
        ("decode Tq=1 q_offset=299", (1, 1, 300, 4, 2, 64, True, 299), True),
        ("causal D=128, GQA 4/2, padded T=200",
         (2, 200, 200, 4, 2, 128, True, 0), True),
        ("decode Tq=1 q_offset=299 D=128",
         (1, 1, 300, 4, 2, 128, True, 299), True),
        ("causal D=160, GQA 4/2, padded T=200",
         (2, 200, 200, 4, 2, 160, True, 0), True),
        ("non-causal D=160, Tq != Tk", (1, 96, 150, 4, 2, 160, False, 0),
         True),
        ("q_offset=263 D=160, a partial q tile",
         (1, 37, 300, 8, 2, 160, True, 263), True),
        ("Granite GQA 16/8", (B, T, T, H, 8, D, True, 0), False),
        ("main path", (B, T, T, H, H, D, True, 0), False),
    ]
    for dtype in (f32, bf16):
        for label, shape, small in attn_cases:
            args, got, want = _attn_case(rng, *shape, dtype)
            err = _hold("flash_attention", label, got, want, dtype, small)
            if label == "main path" or (dtype == f32 and small):
                check_repeatable("flash_attention", label,
                                 fa.flash_attention_cuda, args)
            if label == "main path" and dtype == f32:
                main_err = err
    # k and v off a 16-byte boundary: plain loads (bf16), the mma.sync
    # kernel's plain loads (f32, by the rule)
    for dtype in (f32, bf16):
        (q, k, v), _, want = _attn_case(rng, 1, 96, 96, 4, 2, 64, True, 0,
                                        dtype)
        got = fa.flash_attention_cuda(q, _unaligned(k), _unaligned(v))
        _hold("flash_attention", "k, v not 16-byte aligned", got, want,
              dtype, True)
    # which f32 design each case, and the zoo's f32 prefill shapes, took
    from repro_torch.configs import get_config
    routes = {label: shape[:6] + (False,) for label, shape, _ in attn_cases}
    routes["k, v not 16-byte aligned"] = (1, 96, 96, 4, 2, 64, True)
    routes["D=160, k, v not 16-byte aligned"] = (1, 96, 96, 4, 2, 160, True)
    for arch in ZOO_SHAPES[:3]:
        sh = _zoo_call_shapes(arch, get_config(arch))[1]
        routes[f"at {arch}'s prefill shapes"] = (
            sh["q"][0], sh["q"][1], sh["kv"][1], sh["q"][2], sh["kv"][2],
            sh["q"][3], False)
    _f32_routes(routes)
    (q, k, v), _, _ = _attn_case(rng, B, T, T, H, H, D, True, 0, f32)
    # the mma.sync kernel (attn_kernel) on the same operands
    o_base = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def attn_baseline():
        err = env["attn_baseline"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   o_base.data_ptr(), B, T, T, H, H, D, 1, 0,
                                   0, stream)
        if err:   # no log line a call: the timing would read the host
            check(False, f"the mma.sync f32 attention: cudaError_t {err}")
    attn_baseline()
    _hold("flash_attention", "main path, the mma.sync kernel", o_base,
          fa.flash_attention_plain(q, k, v), f32, False)
    pairs = H * sum(min(t + 1, T) for t in range(T)) * B
    b_ms, b_by = tc_bound(pairs * 4 * D, 4 * q.numel() * 4, f32)
    cc_ms = bound(pairs * 4 * D, 4 * q.numel() * 4, PEAK_F32)[0]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:118",
        max_abs_err=main_err,
        ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v)),
        plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v), iters=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F_.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)), cuda_core_bound_ms=cc_ms,
        mma_sync_ms=time_ms(attn_baseline))

    # -- SSD scan ----------------------------------------------------------
    ssd_cases = [
        ("B=2 T=128", (2, 128, 2, 16, 32, 32, False), True),
        ("padded T=100", (1, 100, 3, 8, 16, 32, False), True),
        ("initial_state", (2, 64, 2, 16, 16, 16, True), True),
        ("T=17 < chunk, initial_state", (1, 17, 2, 8, 8, 32, True), True),
        ("main path + initial_state", (B, T, H, N, D, 64, True), False),
        ("main path", (B, T, H, N, D, main_cfg["chunk"], False), False),
        # the Pallas kernel's own chunks, at Zamba2's N = P = 64 with a
        # padded last chunk
        ("Zamba2 T=1000 chunk 128", (1, 1000, H, N, D, 128, False), False),
        ("Zamba2 T=1000 chunk 128 + initial_state",
         (1, 1000, H, N, D, 128, True), False),
        ("Zamba2 T=1000 chunk 256", (1, 1000, H, N, D, 256, False), False),
        ("Zamba2 T=1000 chunk 256 + initial_state",
         (1, 1000, H, N, D, 256, True), False),
        # log_a ~ -5 a step: cum reaches ~-1280 in a chunk of 256, where
        # exp(cum_i) exp(-cum_j) overflows and exp(cum_i - cum_j) does not
        ("strong decay chunk 256", (1, 1000, H, N, D, 256, True), False),
    ]
    for dtype in (f32, bf16):
        for label, shape, small in ssd_cases:
            decay = -5.0 if label.startswith("strong decay") else None
            args, (y, s), (yp, sp) = _ssd_case(rng, *shape, dtype, decay)
            err = _hold("ssd_scan", label, y, yp, dtype, small)
            _hold("ssd_scan", label + " state", s, sp, f32, False)
            check(bool(torch.isfinite(y.float()).all()
                       and torch.isfinite(s).all()),
                  f"ssd_scan {label} {str(dtype)[6:]}: finite outputs")
            if label in ("main path", "Zamba2 T=1000 chunk 256"):
                check_repeatable(
                    "ssd_scan", label,
                    lambda c, b, v, la, s0, ch=shape[5]: ss.ssd_scan_cuda(
                        c, b, v, la, initial_state=s0, chunk=ch), args)
            if label == "main path" and dtype == f32:
                main_err = err
    # the f32 scan above N = 64 (F32_WIDE_SSD_CASES): within F32_TOL of
    # the plain version, bitwise run to run, the rule's kernels
    for label, case in F32_WIDE_SSD_CASES.items():
        args = _f32_wide_ssd_case(rng, *case)

        def scan(c, b, v, la, s0, ch=case[5]):
            return ss.ssd_scan_cuda(c, b, v, la, initial_state=s0, chunk=ch)
        (y, s), (yp, sp) = scan(*args), ss.ssd_scan_plain(
            *args[:4], initial_state=args[4], chunk=case[5])
        _hold("ssd_scan", label, y, yp, f32, False)
        _hold("ssd_scan", label + " state", s, sp, f32, False)
        check(bool(torch.isfinite(y).all() and torch.isfinite(s).all()),
              f"ssd_scan {label} float32: finite outputs")
        check_repeatable("ssd_scan", label, scan, args)
    _f32_scan_routes(F32_WIDE_SSD_CASES)
    (c, b, v, la, _), _, _ = _ssd_case(rng, B, T, H, N, D,
                                       main_cfg["chunk"], False, f32)
    C_ = main_cfg["chunk"]
    ssd_ops = ssd_flops(B, H, -(-T // C_), C_, N, D, bf16=False)
    ssd_bytes = 4 * (c.numel() + b.numel() + 2 * v.numel() + la.numel()
                     + B * H * N * D)
    b_ms, b_by = tc_bound(ssd_ops, ssd_bytes, f32)
    cc_ms = bound(ssd_ops, ssd_bytes, PEAK_F32)[0]
    # the C entry point of the shipped kernels and of the mma.sync
    # kernels (phase 1's baseline) on the same operands; the device time
    # by kernel, and which kernels the rule launched, from a child's trace
    entry = _ssd_entry(_build.function("ssd_scan"), c, b, v, la, C_)
    base = _ssd_entry(env["ssd_baseline"], c, b, v, la, C_)
    base()
    _hold("ssd_scan", "main path, the mma.sync kernels", base.y,
          ss.ssd_scan_plain(c, b, v, la, chunk=C_)[0], f32, False)
    by_kernel = _scan_device_times(B, T, H, N, D, C_, "float32")
    check(sorted(by_kernel) == sorted(ss.f32_kernels(c, b, v)),
          f"ssd_scan main path float32: launched {sorted(by_kernel)}, the "
          f"rule's {sorted(ss.f32_kernels(c, b, v))}")
    log("  ssd_scan main path float32, device ms a launch by kernel: "
        + ", ".join(f"{k} {ms:.4f}" for k, ms in by_kernel.items()))
    rows["ssd_scan"] = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:112",
        max_abs_err=main_err,
        ms=time_ms(lambda: ss.ssd_scan_cuda(c, b, v, la,
                                            chunk=main_cfg["chunk"])),
        plain_ms=time_ms(lambda: ss.ssd_scan_plain(
            c, b, v, la, chunk=main_cfg["chunk"]), iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        cuda_core_bound_ms=cc_ms, c_entry_ms=time_ms(entry, iters=50),
        mma_sync_ms=time_ms(base, iters=50), by_kernel=by_kernel,
        device_ms=sum(by_kernel.values()))

    # -- expert GLU ---------------------------------------------------------
    glu_cases = [
        ("E=4 cap=32 d=32 F=16", (4, 32, 32, 16), 0.1, True),
        ("E=8 cap=24 d=64 F=32", (8, 24, 64, 32), 0.1, True),
        ("E=4 cap=128 d=32 F=16", (4, 128, 32, 16), 0.1, True),
        ("E=2 cap=16 d=16 F=8", (2, 16, 16, 8), 0.1, True),
        ("E=3 cap=20 d=18 F=10 (rows not 16-byte aligned)",
         (3, 20, 18, 10), 0.1, True),
        ("main path", (E, cap, d, F), 0.5, False),
        ("E=4 cap=256 d=2048 F=512", (4, cap, 2 * d, F), 0.5, False),
        # the f32 wgmma kernel's edges: a ragged last token tile, one
        # expert, a row tile past F and d, rows of 36 and 20 floats
        (f"cap={cap - 56} (a ragged token tile)", (E, cap - 56, d, F), 0.5,
         False),
        ("E=1", (1, cap, d, F), 0.5, False),
        ("E=3 cap=70 d=36 F=20", (3, 70, 36, 20), 0.1, True),
        # Granite's decode: 64 tokens x top-8 over 32 experts; the bf16
        # design's 128-row token tile
        ("cap=16 (decode)", (E, 16, d, F), 0.5, False),
        ("cap=100", (E, 100, d, F), 0.5, False),
    ]
    for dtype in (f32, bf16):
        for label, shape, scale, small in glu_cases:
            args, got, want = _glu_case(rng, *shape, dtype, scale)
            err = _hold("expert_glu", label, got, want, dtype, small)
            if not small:
                check_repeatable("expert_glu", label, mg.expert_glu_cuda,
                                 args)
            if label == "main path" and dtype == f32:
                main_err = err
    # capacity drop through the whole MoE composition, against the oracle
    for dtype in (f32, bf16):
        Tm, dm, Em, Km, Fm, capm = 128, 64, 8, 2, 32, 24
        x = rand(rng, (Tm, dm), dtype)
        gi, gv = top_k_gates(rand(rng, (Tm, Em), f32), Km)
        gv = gv.to(dtype)
        w_up = rand(rng, (Em, dm, 2 * Fm), dtype, 0.1)
        w_down = rand(rng, (Em, Fm, dm), dtype, 0.1)
        _, keep, _ = mg.dispatch_indices(gi, capm, Em)
        got = ops.moe_dispatch_combine(x, gi, gv, w_up, w_down, capacity=capm)
        want = ref.moe_dispatch_combine_ref(x, gi, gv, w_up, w_down,
                                            capacity=capm)
        tol = 5e-2 if dtype == bf16 else 2e-4     # test_kernels.py MoE bucket
        err, rel = norm_err(got, want)
        check(rel <= tol and bool(torch.allclose(
            got.double(), want.double(), atol=tol, rtol=tol)),
            f"moe_dispatch_combine capacity drop "
            f"({int((~keep).sum())} of {keep.numel()} slots dropped) "
            f"{str(dtype)[6:]}: /max|oracle| {rel:.3e} <= {tol:g}")
    (x, w_up, w_down), _, _ = _glu_case(rng, E, cap, d, F, f32, 0.5)
    glu_flops = E * cap * (4 * d * F + 2 * F * d)
    glu_bytes = 4 * (2 * x.numel() + w_up.numel() + w_down.numel())
    b_ms, b_by = tc_bound(glu_flops, glu_bytes, f32)
    cc_ms = bound(glu_flops, glu_bytes, PEAK_F32)[0]

    def bmm_glu():
        h = torch.bmm(x, w_up)
        return torch.bmm(F_.silu(h[..., :F]) * h[..., F:], w_down)
    # the mma.sync kernel (gemm_kernel) on the same operands, in one process
    act, y = torch.empty((E, cap, F), device="cuda"), torch.empty_like(x)

    def baseline():
        err = env["glu_baseline"](x.data_ptr(), w_up.data_ptr(),
                                  w_down.data_ptr(), act.data_ptr(),
                                  y.data_ptr(), E, cap, d, F, 0, stream)
        if err:   # no log line a call: the timing would read the host
            check(False, f"the mma.sync expert GLU: cudaError_t {err}")
    baseline()
    _hold("expert_glu", "main path, the mma.sync kernel", y,
          mg.expert_glu_plain(x, w_up, w_down), f32, False)
    rows["expert_glu"] = dict(
        name="expert_glu", route="cuda",
        source="src/repro_torch/csrc/expert_glu.cu",
        replaces="src/repro/kernels/moe_gather.py:79",
        max_abs_err=main_err,
        ms=time_ms(lambda: mg.expert_glu_cuda(x, w_up, w_down), iters=5),
        plain_ms=time_ms(lambda: mg.expert_glu_plain(x, w_up, w_down),
                         iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(bmm_glu, iters=5), cuda_core_bound_ms=cc_ms,
        mma_sync_ms=time_ms(baseline, iters=5))
    rows["expert_glu"]["bf16"] = _bf16_glu_rows(env, (E, cap, d, F))
    for r in rows.values():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        cc = r.get("cuda_core_bound_ms")
        tc = "" if cc is None else \
            f", 3xTF32 tensor cores; f32 CUDA-core bound {cc:.4f} ms"
        old, entry = r.get("mma_sync_ms"), r.get("c_entry_ms")
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms"
            + ("" if entry is None else
               f" (by its C entry {entry:.4f} ms, {r['device_ms']:.4f} on "
               "the device)")
            + ("" if old is None else
               f" (the mma.sync kernel {old:.4f} ms)")
            + f", plain {r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}{tc})")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def _drift_ok(label, outs, want, spread) -> float:
    """Every op of ``outs`` within its route bound of ``want`` (see
    ROUTE_BUCKET); returns the worst normalised error."""
    errs = [norm_err(outs[i], want[i])[1] for i in range(len(outs))]
    over = [f"op {i}: {e:.2e} > {max(ROUTE_BUCKET, SPREAD * s):.2e}"
            for i, (e, s) in enumerate(zip(errs, spread))
            if not e <= max(ROUTE_BUCKET, SPREAD * s)]
    check(not over, f"{label}: every op within max({ROUTE_BUCKET:g}, "
                    f"{SPREAD:g} x the reference spread) of the largest "
                    f"output (worst {max(errs):.3e})"
                    + (f" {over}" if over else ""))
    return max(errs)


def _route_matches(label, outs, oracle, route, binding, verdicts, spread):
    """The repo's own rule for a compiled program against the interpreter
    oracle: bitwise when every probe was bitwise (or none ran) and the
    route runs on the oracle's device; else each op within its route
    bound (``_drift_ok``).  Also: every op's output lies on its lane's
    device.  Returns the worst error normalised by the output's largest
    magnitude."""
    from repro_torch.core import results_bitwise_equal
    n = len(outs)
    misplaced = [f"op {i} on {outs[i].device}, lane {route[i]!r} on "
                 f"{binding[route[i]].device}" for i in range(n)
                 if outs[i].device != binding[route[i]].device]
    check(not misplaced, f"route {label}: every op's output lies on its "
                         "lane's device" + (f" {misplaced}" if misplaced
                                            else ""))
    worst = max(norm_err(outs[i], oracle[i])[1] for i in range(n))
    same_device = all(outs[i].device == oracle[i].device for i in range(n))
    if same_device and all(v == "bitwise" for v in verdicts):
        check(results_bitwise_equal(outs, oracle),
              f"route {label}: bitwise equal to the interpreter oracle")
        return worst
    return _drift_ok(f"route {label} against the interpreter oracle",
                     outs, oracle, spread)


def _trace(prog, ext, label) -> float | None:
    """One traced warm run of a compiled program (see
    :func:`_trace_call`)."""
    from repro_torch.core.profiler import fence
    return _trace_call(label, lambda: fence(list(prog.run(ext).values())))


def _trace_call(label, run, top: int = 12) -> float | None:
    """One traced warm ``run()`` (which waits for its device work): device
    time by kernel name and the device's busy share of the run's wall
    time (tracing slows the host, so the idle share it gives is an upper
    bound).  Returns the busy share, None when the trace holds no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue        # host ops: their device time is their kernels'
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(us for us, _, _ in rows) / 1e6
    if not rows:
        log(f"  traced {label}: wall {1e3 * wall:.3f} ms, no device time "
            "in the trace (device busy share not measured)")
        return None
    log(f"  traced {label}: wall {1e3 * wall:.3f} ms, device busy "
        f"{1e3 * busy:.3f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(n for _, n, _ in rows)} device ops")
    for us, n, key in rows[:top]:
        log(f"    {us / 1e3:9.3f} ms  x{n:<4d} {key[:90]}")
    return busy / wall


def _jit_summary(label, prog, graphs) -> None:
    """Each segment on a CUDA lane: its ops, mode and ``jit_verified``
    (and why a capture was not kept)."""
    for seg in prog.segments:
        dev = None if seg.target is None else seg.target.device
        if dev is None or dev.type != "cuda":
            continue
        names = [graphs[r].ops[i].name for r, i in seg.items]
        why = f", {seg.capture_error}" if seg.capture_error else ""
        log(f"    {label} segment {seg.index} on {seg.lane} "
            f"({names[0]}..{names[-1]}, {len(names)} ops): mode "
            f"{seg.mode}, jit_verified {seg.jit_verified!r}{why}")


def _eager_binding(binding) -> dict:
    """The same lanes with copies of the CUDA targets that do not
    capture (``jit=False``)."""
    import dataclasses
    return {lane: dataclasses.replace(t, jit=False) if t.jit else t
            for lane, t in binding.items()}


def _captured_against_eager(label, graph, ext, assign, orch, binding,
                            spread, must_capture) -> dict:
    """The same route compiled twice — against the CUDA targets, which
    capture their segments, and against copies that do not — timed in
    turns over CAPTURE_REPEATS warm runs each, traced once each, and held
    to each other by ``jit_verified``'s rule: bitwise where every CUDA
    segment was admitted bitwise, else within the route bound."""
    from repro_torch.core import ScheduleExecutor, results_bitwise_equal
    from repro_torch.core.laneprogram import JIT
    eager_ex = ScheduleExecutor(list(binding),
                                targets=_eager_binding(binding))
    progs = {"captured": orch.executor.compile_scheduled(graph, assign),
             "eager": eager_ex.compile_scheduled(graph, assign)}
    for prog in progs.values():
        _fenced(lambda: [prog.run(ext)])               # cold: probe, capture
    _jit_summary(f"{label} (captured)", progs["captured"], [graph])
    cuda_segs = [seg for seg in progs["captured"].segments
                 if seg.target is not None
                 and seg.target.device.type == "cuda"]
    if must_capture:
        check(all(seg.mode == JIT for seg in cuda_segs),
              f"{label}: every segment on a CUDA lane is captured "
              f"({sum(seg.mode == JIT for seg in cuda_segs)} of "
              f"{len(cuda_segs)}; "
              f"{progs['captured'].stats['capture_errors']})")
    times = {k: [] for k in progs}
    outs = {}
    for _ in range(CAPTURE_REPEATS):
        for k, prog in progs.items():
            t, o = _fenced(lambda: [prog.run(ext)])
            times[k].append(t)
            outs[k] = o[0]
    verdicts = [seg.jit_verified for seg in cuda_segs]
    if cuda_segs and all(v == "bitwise" for v in verdicts):
        check(results_bitwise_equal(outs["captured"], outs["eager"]),
              f"{label}: captured outputs bitwise the eager program's "
              f"(every CUDA segment jit_verified 'bitwise')")
    else:
        _drift_ok(f"{label}: captured against eager (jit_verified "
                  f"{verdicts})", outs["captured"], outs["eager"], spread)
    out = {}
    for k, prog in progs.items():
        med = _median(times[k])
        share = _trace(prog, ext, f"{label} ({k})")
        log(f"  route {label} ({k}): median {1e3 * med:.3f} ms over "
            f"{len(times[k])} warm runs (runs "
            f"{', '.join(f'{1e3 * t:.3f}' for t in times[k])})")
        out[k] = dict(median=med, runs=times[k], busy=share)
    log(f"  route {label}: captured / eager "
        f"{out['captured']['median'] / out['eager']['median']:.3f}")
    for prog in progs.values():
        prog.close()
    return out


def phase_main_path(main_cfg: dict) -> dict:
    import torch
    from repro_torch.core import MeasuredProfiler, Orchestrator, kernel_chain
    from repro_torch.core.backends import default_registry
    from repro_torch.core.profiler import fence

    log("== phase 3: main path at the Granite-3.0-1B-A400M widths")
    log(f"config: {json.dumps(main_cfg)}")
    t0 = time.perf_counter()
    graph, ext = kernel_chain(seed=0, **main_cfg)
    log(f"chain: {len(graph)} ops, built in {time.perf_counter() - t0:.1f}s")
    reg = default_registry()
    binding = {name: reg.get(name) for name in LANES}
    for lane in LANES:
        t = binding[lane]
        log(f"  lane {lane}: {t!r}, f32 probe tolerance "
            f"{t.tolerance(torch.float32)}"
            + (" (atol x max|ref| of each op)" if t.atol_scaled else ""))
    n = len(graph)

    t0 = time.perf_counter()
    table = MeasuredProfiler(warmup=1, iters=3, strict=True,
                             targets=binding).profile(graph)
    t_profile = time.perf_counter() - t0
    fails = table.meta["profile_failures"]
    check(not fails, f"profiled {len(table.meta['measurements'])} "
                     f"(op, lane) cells in {t_profile:.1f}s, failures: "
                     f"{fails or 'none'}")
    cuda_cells = [m for (_, lane), m in table.meta["measurements"].items()
                  if binding[lane].device.type == "cuda"]
    check(all(m["captured"] for m in cuda_cells),
          f"{sum(m['captured'] for m in cuda_cells)} of {len(cuda_cells)} "
          "cells on the CUDA lanes timed as captured replays")
    for i, op in enumerate(graph.ops):
        cells = "  ".join(
            f"{lane} {1e3 * table.meta['measurements'][(i, lane)]['median']:9.3f}"
            for lane in LANES)
        log(f"  op {i:2d} {op.name:8s} ms: {cells}")

    orch = Orchestrator(table, targets=binding)
    h = orch.register(graph)
    plan = orch.plan(h)
    planned = tuple(lane for _, lane in plan.route[0])
    log(f"planned route: {list(planned)}")
    log(f"predicted e2e: {1e3 * plan.latency:.3f} ms")
    # the interpreter oracle (reference payloads, op by op) on the card,
    # and on the host for the routes that run on the host
    oracle = orch.execute(plan, ext, compile=False)
    host_ext = {0: tuple(x.cpu() for x in ext[0])}
    host_oracle = orch.execute(plan, host_ext, compile=False)
    fence(list(oracle.values()))
    spread = [norm_err(host_oracle[i], oracle[i])[1] for i in range(n)]
    log(f"  reference payloads, host against card, error / max|card| by "
        f"op: {[f'{e:.1e}' for e in spread]}")

    routes = {"planned": planned}
    routes.update({lane: (lane,) * n for lane in LANES})
    results = {}
    for label, route in routes.items():
        prog = (orch.program_for(plan, ext) if label == "planned" else
                orch.executor.compile_scheduled(
                    graph, {i: route[i] for i in range(n)}))
        fence(list(prog.run(ext).values()))        # cold: probes variants
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            outs = prog.run(ext)
            fence(list(outs.values()))
            times.append(time.perf_counter() - t0)
        st = prog.stats
        pred = orch.workload(h).evaluate(list(route))[0]
        results[label] = dict(route=route, outs=outs, stats=st,
                              times=times, pred=pred)
        log(f"  route {label}: measured median "
            f"{1e3 * sorted(times)[len(times) // 2]:.3f} ms (runs "
            f"{', '.join(f'{1e3 * t:.3f}' for t in times)}), predicted "
            f"{1e3 * pred:.3f} ms; {st['n_segments']} segment(s), "
            f"verdicts {st['variant_verified']}")
        for seg, errs in st["variant_errors"].items():
            log(f"    segment {seg} probe, by op (max abs err, / max|ref|,"
                f" atol needed at the lane's rtol): "
                f"{[tuple(f'{x:.2e}' for x in e) for e in errs]}")
        _jit_summary(f"route {label}", prog, [graph])
        on_host = all(binding[lane].device.type == "cpu" for lane in route)
        _route_matches(label, outs, host_oracle if on_host else oracle,
                       route, binding, st["variant_verified"].values(),
                       spread)
        for seg in prog.segments:
            if seg.target is not None and seg.target.dialect == "cuda":
                check(seg.verified in ("bitwise", "tolerance"),
                      f"route {label}: cuda-dialect segment {seg.index} "
                      f"verified {seg.verified!r}")

    # the main path's own launches: one warm run of the planned route
    # through the user's entry point, counted from zero
    prog = orch.program_for(plan, ext)
    counts = _counted_run(lambda: [orch.execute(plan, ext)], prog,
                          "the planned route", every_kernel=True)

    ck, c0 = results["cuda-kernels"]["outs"], results["cuda:0"]["outs"]
    _drift_ok("all-cuda-kernels route against the all-cuda:0 route",
              ck, c0, spread)

    # captured against eager: the planned route (whose CUDA segments
    # must all be captured) and the kernel lane's single-lane route
    both = {}
    for label, route in (("planned", planned),
                         ("cuda-kernels", ("cuda-kernels",) * n)):
        both[label] = _captured_against_eager(
            label, graph, ext, {i: route[i] for i in range(n)}, orch,
            binding, spread, must_capture=label == "planned")
    return {"counts": counts, "orch": orch, "binding": binding, "h": h,
            "graph": graph, "ext": ext, "spread": spread, "capture": both}


# ---------------------------------------------------------------------------
# phase 4: concurrent requests at the Granite widths
# ---------------------------------------------------------------------------

def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _fenced(fn):
    """Wall seconds of ``fn()`` (which returns results dicts), fenced on
    the card; returns (seconds, results)."""
    from repro_torch.core.profiler import fence
    t0 = time.perf_counter()
    outs = fn()
    fence([list(o.values()) for o in outs])
    return time.perf_counter() - t0, outs


def _plan_summary(label, plan, names, graphs) -> None:
    """Routes by lane, co-scheduled steps and the predicted makespan."""
    steps = plan.schedule.steps
    co = sum(1 for st in steps if sum(o is not None for o in st.ops) > 1)
    log(f"  plan ({label}), mode {plan.mode!r} ({plan.schedule.mode}): "
        f"predicted makespan {1e3 * plan.latency:.3f} ms, {len(steps)} "
        f"steps, {co} co-scheduled (barrier) steps")
    for r, name in enumerate(names):
        lanes = dict(plan.schedule.assignment_of(r))
        route = [lanes[i] for i in range(len(graphs[r]))]
        counts = {lane: route.count(lane) for lane in dict.fromkeys(route)}
        log(f"    request {name}: {counts}  {route}")


def _union(iv) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _busy(iv) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(b - a for a, b in _union(iv))


def _overlap(iv_a, iv_b) -> float:
    """Length of the intersection of the unions of two interval sets."""
    ua, ub = _union(iv_a), _union(iv_b)
    i = j = 0
    total = 0.0
    while i < len(ua) and j < len(ub):
        lo, hi = max(ua[i][0], ub[j][0]), min(ua[i][1], ub[j][1])
        total += max(0.0, hi - lo)
        if ua[i][1] < ub[j][1]:
            i += 1
        else:
            j += 1
    return total


def _segment_spans(run, prog, name) -> None:
    """One warm ``orch.execute`` (``run()``, which returns a list of
    results dicts) under ``torch.profiler``, host events only: each
    ``laneprogram.segment`` span of the route (:mod:`repro_torch.tracing`)
    with its lane, its first..last item (``name(request, op)``) and its
    host interval in ms from the route's start, in the order they
    started, so segments that overlap across lanes show it; then the
    host ms in segments by lane."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tracing
    with profile(activities=[ProfilerActivity.CPU]):
        _fenced(run)
    spans = tracing.spans()
    root = [s for s in spans if s["name"] == "orchestrator.execute"
            and s["parent"] is None][-1]
    segs = sorted((s for s in spans if s["request"] == root["id"]
                   and s["name"] == "laneprogram.segment"),
                  key=lambda s: s["start_ns"])
    log("    segments of one warm run (lane, first..last item, host "
        "interval ms from the route's start):")
    per_lane: dict = {}
    for s in segs:
        items = prog.segments[s["attrs"]["index"]].items
        a, b = (1e-6 * (t - root["start_ns"])
                for t in (s["start_ns"], s["end_ns"]))
        log(f"      {s['attrs']['lane']:13s} {name(*items[0])}.."
            f"{name(*items[-1])}  {a:8.3f} - {b:8.3f}")
        per_lane[s["attrs"]["lane"]] = \
            per_lane.get(s["attrs"]["lane"], 0.0) + b - a
    log(f"    host ms in segments by lane: "
        f"{ {k: round(v, 3) for k, v in per_lane.items()} }, "
        f"sum {sum(per_lane.values()):.3f} ms, route "
        f"{1e-6 * (root['end_ns'] - root['start_ns']):.3f} ms (traced)")


def _stream_trace(run, label, phase: int = 4) -> dict | None:
    """One warm run of ``run()`` (which returns a list of results dicts)
    under ``torch.profiler``: device busy time per CUDA stream and the
    overlap between streams, from the exported trace's kernel, copy and
    memset intervals.  Returns the run's traced wall ms, busy ms, stream
    overlap ms and idle share (None when the trace has no device
    events)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.profiler import fence
    fence([list(o.values()) for o in run()])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = run()
        fence([list(o.values()) for o in outs])
        wall = time.perf_counter() - t0
    path = LOG.parent / f"phase{phase}_trace_{label}.json"
    LOG.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    by_stream: dict = {}
    names: dict = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        sid = ev.get("args", {}).get("stream")
        a = float(ev["ts"])
        by_stream.setdefault(sid, []).append((a, a + float(ev["dur"])))
        name = ev.get("name", "")
        hand = [k for k in HAND_KERNELS if k in name]
        if ev.get("cat") == "kernel" and hand:
            names.setdefault(sid, set()).add(hand[0])
    if not by_stream:
        log(f"  device trace ({label}): no device events recorded "
            "(not measured)")
        return None
    all_iv = [iv for ivs in by_stream.values() for iv in ivs]
    busy_all = _busy(all_iv) / 1e3
    log(f"  device trace ({label}), one warm run: wall "
        f"{1e3 * wall:.3f} ms (traced), device busy {busy_all:.3f} ms "
        f"on all streams together, idle "
        f"{100 * (1 - busy_all / (1e3 * wall)):.1f}%")
    for sid, ivs in sorted(by_stream.items(), key=lambda kv: str(kv[0])):
        kern = sorted(names.get(sid, ()))
        log(f"    stream {sid}: {len(ivs)} device ops, busy "
            f"{_busy(ivs) / 1e3:.3f} ms"
            + (f", hand-written kernels {kern}" if kern else ""))
    sids = sorted(by_stream, key=str)
    pairs = [(a, b) for k, a in enumerate(sids) for b in sids[k + 1:]]
    total = 0.0
    for a, b in pairs:
        ov = _overlap(by_stream[a], by_stream[b]) / 1e3
        total += ov
        log(f"    overlap of streams {a} and {b}: {ov:.3f} ms")
    log(f"  streams overlapped {total:.3f} ms of {busy_all:.3f} ms busy "
        f"({label})")
    return dict(wall=1e3 * wall, busy=busy_all, overlap=total,
                idle=1 - busy_all / (1e3 * wall), streams=len(by_stream))


def _host_spread(graph, ext, card_outs) -> list:
    """Per op: the error between the reference payloads on the host and
    on the card, over the largest output (the chain's conditioning, as
    phase 3 measures it for request A)."""
    from repro_torch.core import ScheduleExecutor
    host_ext = {i: tuple(x.cpu() for x in args) for i, args in ext.items()}
    host = ScheduleExecutor(["cpu"]).run_monolithic(graph, host_ext)
    return [norm_err(host[i], card_outs[i])[1] for i in range(len(graph))]


def phase_concurrent(main_cfg: dict, main: dict) -> dict:
    """Requests A (phase 3's chain), B and C (seq 256, their own
    weights) planned jointly on the same four lanes and run at once."""
    from repro_torch.core import (MeasuredProfiler, kernel_chain,
                                  results_bitwise_equal)
    from repro_torch.core.profiler import fence

    log("== phase 4: concurrent requests at the Granite widths")
    orch, binding = main["orch"], main["binding"]
    short = {**main_cfg, "seq": 256}
    log(f"requests: A = phase 3's chain (seed 0, seq {main_cfg['seq']}); "
        f"B, C = {json.dumps(short)} (seeds 1, 2, own weights)")
    graphs, exts, hs = [main["graph"]], [main["ext"]], [main["h"]]
    t0 = time.perf_counter()
    for seed in (1, 2):
        graph, ext = kernel_chain(seed=seed, **short)
        table = MeasuredProfiler(warmup=1, iters=3, strict=True,
                                 targets=binding).profile(graph)
        fails = table.meta["profile_failures"]
        check(not fails, f"request {'ABC'[seed]}: profiled "
                         f"{len(table.meta['measurements'])} cells, "
                         f"failures: {fails or 'none'}")
        graphs.append(graph)
        exts.append(ext)
        hs.append(orch.register(graph, table=table))
    log(f"  built and profiled B and C in {time.perf_counter() - t0:.1f}s")
    names = "ABC"
    n = len(graphs[0])

    # each request alone: its sequential plan, the back-to-back sum and
    # the best single lane
    seq_plans = [orch.plan(h) for h in hs]
    for r, p in enumerate(seq_plans):
        log(f"  request {names[r]} alone: sequential plan predicted "
            f"{1e3 * p.latency:.3f} ms, route "
            f"{[lane for _, lane in p.route[0]]}")
    singles = {lane: [orch.workload(h).evaluate([lane] * n)[0] for h in hs]
               for lane in LANES}

    # the oracles: reference payloads op by op, and each request's spread
    spreads = [main["spread"]] + [
        _host_spread(graphs[r], exts[r],
                     orch.executor.run_monolithic(graphs[r], exts[r]))
        for r in (1, 2)]
    for r in (1, 2):
        log(f"  request {names[r]}: reference payloads, host against card,"
            f" error / max|card| by op: "
            f"{[f'{e:.1e}' for e in spreads[r]]}")

    summary = {}
    for group in ((0, 1), (0, 1, 2)):
        label = "".join(names[r] for r in group)
        gh = [hs[r] for r in group]
        gg = [graphs[r] for r in group]
        ge = [exts[r] for r in group]
        t0 = time.perf_counter()
        plan = orch.plan(gh)
        t_plan = time.perf_counter() - t0
        check(plan.kind == "concurrent" and plan.mode == "concurrent",
              f"({label}) plan(mode='auto') is a concurrent plan, solved "
              f"in {1e3 * t_plan:.1f} ms")
        _plan_summary(label, plan, [names[r] for r in group], gg)
        b2b = sum(seq_plans[r].latency for r in group)
        best = min(LANES, key=lambda lane: sum(singles[lane][r]
                                               for r in group))
        log(f"    back-to-back sequential plans {1e3 * b2b:.3f} ms; best "
            f"single lane {best} {1e3 * sum(singles[best][r] for r in group):.3f}"
            f" ms; predicted concurrent / back-to-back "
            f"{plan.latency / b2b:.3f}")

        # the program: cold (probes), then warm runs fenced on the card
        prog = orch.program_for(plan, ge)
        st = prog.stats
        log(f"    program: {st['n_segments']} segments, "
            f"{st['n_barrier']} barrier, lanes {prog.lanes}, CUDA lane "
            f"streams {sorted(prog.lane_streams()) if not st['serial'] else 'none (serial)'}")
        t_cold, _ = _fenced(lambda: orch.execute(plan, ge))
        runs = [_fenced(lambda: orch.execute(plan, ge))
                for _ in range(REPEATS)]
        times = [t for t, _ in runs]
        outs, outs2 = runs[0][1], runs[1][1]
        verdicts = prog.stats["variant_verified"]
        log(f"    cold run {1e3 * t_cold:.1f} ms; verdicts {verdicts}")
        _jit_summary(f"({label})", prog, gg)
        for seg in prog.segments:
            kinds = {gg[r].ops[i].name.rsplit(".", 1)[-1]
                     for r, i in seg.items}
            if seg.target is not None and seg.target.dialect == "cuda" \
                    and kinds & set(KERNEL_OF_OP):
                check(seg.verified in ("bitwise", "tolerance"),
                      f"({label}) cuda-dialect segment {seg.index} "
                      f"({sorted(kinds)}) verified {seg.verified!r}")

        # back to back: each request's own compiled sequential program
        seq_progs = [orch.program_for(seq_plans[r], exts[r]) for r in group]
        for r, p in zip(group, seq_progs):
            fence(list(p.run(exts[r]).values()))
        b2b_runs = [_fenced(lambda: [p.run(exts[r]) for r, p in
                                     zip(group, seq_progs)])[0]
                    for _ in range(REPEATS)]
        conc, seqt = _median(times), _median(b2b_runs)
        log(f"    measured concurrent makespan median {1e3 * conc:.3f} ms "
            f"(runs {', '.join(f'{1e3 * t:.3f}' for t in times)}); "
            f"predicted {1e3 * plan.latency:.3f} ms, predicted / measured "
            f"{plan.latency / conc:.3f}")
        log(f"    measured back-to-back sequential programs median "
            f"{1e3 * seqt:.3f} ms (runs "
            f"{', '.join(f'{1e3 * t:.3f}' for t in b2b_runs)}); concurrent "
            f"/ back-to-back {conc / seqt:.3f}")

        # (a) each request bitwise its own run alone, compiled with the
        # same op -> lane assignment; (b) within the route bound of the
        # per-op interpreter oracle; (c) two warm runs bitwise equal
        oracle = orch.execute(plan, ge, compile=False)
        fence([list(o.values()) for o in oracle])
        alones = []
        for k, r in enumerate(group):
            alone = orch.executor.compile_scheduled(
                graphs[r], dict(plan.schedule.assignment_of(k)))
            fence(list(alone.run(exts[r]).values()))
            alones.append(alone)
        # the same routes with no threads: each request alone, inline
        # on this thread's stream, one after another
        inline = _median([_fenced(lambda: [p.run(exts[r]) for r, p in
                                           zip(group, alones)])[0]
                          for _ in range(REPEATS)])
        log(f"    the concurrent plan's routes run alone back to back (no "
            f"threads, one stream) median {1e3 * inline:.3f} ms; threaded "
            f"/ that {conc / inline:.3f}")
        for k, r in enumerate(group):
            assign = dict(plan.schedule.assignment_of(k))
            got_alone = alones[k].run(exts[r])
            fence(list(got_alone.values()))
            check(results_bitwise_equal(outs[k], got_alone),
                  f"({label}) request {names[r]}: (a) bitwise equal to the "
                  "request alone, compiled with the same op -> lane "
                  "assignment")
            route = tuple(assign[i] for i in range(n))
            seg_verdicts = [seg.verified for seg in prog.segments
                            if seg.items[0][0] == k
                            and seg.verified is not None]
            _route_matches(f"({label}) request {names[r]} (b)", outs[k],
                           oracle[k], route, binding, seg_verdicts,
                           spreads[r])
            check(results_bitwise_equal(outs[k], outs2[k]),
                  f"({label}) request {names[r]}: (c) two warm runs are "
                  "bitwise equal")

        # the segments' lanes and host intervals in one warm run
        _segment_spans(lambda: orch.execute(plan, ge), prog,
                       lambda r, i: f"{(r, i)}")
        _stream_trace(lambda: orch.execute(plan, ge), label)

        # the concurrent path's launches: one warm run, counted from zero
        counts = _counted_run(lambda: orch.execute(plan, ge), prog,
                              f"({label}) concurrent", every_kernel=True)
        summary[label] = dict(predicted=plan.latency, measured=conc,
                              back_to_back=seqt, counts=counts)
        prog.close()
    return {"sets": summary, "graphs": graphs, "exts": exts, "hs": hs,
            "seq_plans": seq_plans, "spreads": spreads}


# ---------------------------------------------------------------------------
# phase 5: DAG plans at the Granite widths
# ---------------------------------------------------------------------------

def _dag_graph(parts, edges=()):
    """One OpGraph over several chains' ops: ``parts`` is a list of
    ``(prefix, graph, external inputs or None)``; each chain keeps its
    own edges, its ops get ``prefix`` on their names, and ``edges`` (in
    the joined numbering) link them.  Returns (graph, external inputs,
    offset of each part)."""
    import dataclasses
    from repro_torch.core import OpGraph
    ops, all_edges, ext, offsets = [], list(edges), {}, []
    for prefix, graph, gext in parts:
        base = len(ops)
        offsets.append(base)
        ops += [dataclasses.replace(op, name=prefix + op.name)
                for op in graph.ops]
        all_edges += [(a + base, b + base) for a, b in graph.edges]
        ext.update({i + base: v for i, v in (gext or {}).items()})
    return OpGraph(ops, edges=all_edges), ext, offsets


def _joined_table(lanes, parts):
    """A CostTable over a joined graph from its parts' measured tables
    (``(table, offset)``): the same ops at the same shapes, so their
    measured rows carry over, re-indexed."""
    from repro_torch.core import CostTable
    table = CostTable(list(lanes))
    for part, off in parts:
        for (i, lane), entry in part.items():
            table.set(i + off, lane, entry)
    return table


def _dag_plan_summary(label, plan, graph) -> None:
    """A DAG plan's steps, lanes and predicted latency."""
    sched = plan.schedule
    lanes = list(sched.assignment.values())
    counts = {lane: lanes.count(lane) for lane in dict.fromkeys(lanes)}
    log(f"  plan {label}: kind {plan.kind!r}, schedule mode "
        f"{sched.mode!r}, predicted {1e3 * plan.latency:.3f} ms "
        f"({plan.latency.hex()}); {len(sched.steps)} steps, "
        f"{sched.n_parallel_steps} co-scheduled (multi-op); lanes {counts}")
    for st in sched.steps:
        log(f"    {1e3 * st.cost:8.3f} ms  "
            + ", ".join(f"{graph.ops[o].name}@{p}"
                        for o, p in zip(st.ops, st.pus)))


def _run_dag_plan(label, orch, plan, graph, ext, binding, spread) -> dict:
    """Checks (a)-(e) and the measurements of one DAG plan."""
    from repro_torch.core import KERNEL_DIALECTS, results_bitwise_equal
    from repro_torch.core.profiler import fence
    n = len(graph)
    prog = orch.program_for(plan, ext)
    st = prog.stats
    log(f"    program: {st['n_segments']} segments, lanes {prog.lanes}, "
        + ("serial (inline)" if st["serial"] else
           f"threaded, CUDA lane streams {sorted(prog.lane_streams())}"))
    t_cold, _ = _fenced(lambda: [orch.execute(plan, ext)])
    runs = [_fenced(lambda: [orch.execute(plan, ext)])
            for _ in range(REPEATS)]
    times = [t for t, _ in runs]
    outs, outs2 = runs[0][1][0], runs[1][1][0]
    verdicts = prog.stats["variant_verified"]
    log(f"    cold run {1e3 * t_cold:.1f} ms; verdicts {verdicts}")
    _jit_summary(label, prog, [graph])
    measured = _median(times)
    log(f"    measured median {1e3 * measured:.3f} ms (runs "
        f"{', '.join(f'{1e3 * t:.3f}' for t in times)}); predicted "
        f"{1e3 * plan.latency:.3f} ms, predicted / measured "
        f"{plan.latency / measured:.3f}")
    # (a) and (d): within the route bound of the interpreter (run_dag),
    # every output on its lane's device
    oracle = orch.execute(plan, ext, compile=False)
    fence(list(oracle.values()))
    assign = dict(plan.route[0])
    route = tuple(assign[i] for i in range(n))
    _route_matches(f"{label} (a)", outs, oracle, route, binding,
                   verdicts.values(), spread)
    # (b) two warm runs bitwise equal
    check(results_bitwise_equal(outs, outs2),
          f"{label}: (b) two warm runs are bitwise equal")
    # (c) every kernel-dialect segment verified
    for seg in prog.segments:
        kinds = {graph.ops[i].name.rsplit(".", 1)[-1] for _, i in seg.items}
        if seg.target is not None and \
                seg.target.dialect in KERNEL_DIALECTS and \
                kinds & set(KERNEL_OF_OP):
            check(seg.verified in ("bitwise", "tolerance"),
                  f"{label}: (c) kernel segment {seg.index} "
                  f"({sorted(kinds)}) verified {seg.verified!r}")
    # (e) the kernels' launches where the plan puts their ops on the
    # kernel lane
    counts = _counted_run(lambda: [orch.execute(plan, ext)], prog, label,
                          every_kernel=False)
    _segment_spans(lambda: [orch.execute(plan, ext)], prog,
                   lambda r, i: graph.ops[i].name)
    dev = _stream_trace(lambda: [orch.execute(plan, ext)], label, phase=5)
    return dict(predicted=plan.latency, measured=measured, runs=times,
                co=plan.schedule.n_parallel_steps,
                steps=len(plan.schedule.steps), counts=counts, device=dev)


def _run_baseline(label, prog, run, graph, oracle, route, binding, spread,
                  predicted, every_kernel) -> dict:
    """A compiled baseline: cold run, route bound against the oracle,
    median of 3 fenced warm runs; launches counted from zero when
    ``every_kernel`` (then each kernel must launch)."""
    _fenced(run)
    runs = [_fenced(run) for _ in range(REPEATS)]
    times = [t for t, _ in runs]
    outs = runs[0][1]
    merged = {}
    for o in outs:
        merged.update(o)
    if route is not None:
        _route_matches(label, merged, oracle, route, binding,
                       prog.stats["variant_verified"].values(), spread)
    measured = _median(times)
    log(f"    {label}: measured median {1e3 * measured:.3f} ms (runs "
        f"{', '.join(f'{1e3 * t:.3f}' for t in times)}), predicted "
        f"{1e3 * predicted:.3f} ms")
    counts = (_counted_run(run, prog, label, every_kernel=True)
              if every_kernel else None)
    return dict(predicted=predicted, measured=measured, runs=times,
                counts=counts)


def phase_dag(main_cfg: dict, main: dict, conc: dict) -> dict:
    """Two DAGs of the Granite chain on phase 3's lanes: U, the union of
    requests A and B (24 ops, one handle, no edge between them), and F,
    a fork (A's 12 ops and a one-block tower D hung off A's op 5)."""
    from repro_torch.core import (MeasuredProfiler, kernel_chain,
                                  solve_sequential)
    from repro_torch.core.profiler import fence

    log("== phase 5: DAG plans at the Granite widths")
    orch, binding = main["orch"], main["binding"]
    gA, gB = conc["graphs"][0], conc["graphs"][1]
    eA, eB = conc["exts"][0], conc["exts"][1]
    tA = orch.workload(main["h"]).table
    tB = orch.workload(conc["hs"][1]).table
    t0 = time.perf_counter()
    gD, _ = kernel_chain(seed=2, **{**main_cfg, "blocks": 1})
    tD = MeasuredProfiler(warmup=1, iters=3, strict=True,
                          targets=binding).profile(gD)
    fails = tD.meta["profile_failures"]
    check(not fails, f"tower D (one block, seq {main_cfg['seq']}, seed 2): "
                     f"profiled {len(tD.meta['measurements'])} cells in "
                     f"{time.perf_counter() - t0:.1f}s, failures: "
                     f"{fails or 'none'}")
    for i, op in enumerate(gD.ops):
        cells = "  ".join(
            f"{lane} {1e3 * tD.meta['measurements'][(i, lane)]['median']:9.3f}"
            for lane in LANES)
        log(f"  D op {i} {op.name:8s} ms: {cells}")

    gU, eU, offU = _dag_graph([("", gA, eA), ("B.", gB, eB)])
    fork = [i for i, op in enumerate(gA.ops) if op.name == "b0.out"][0]
    gF, eF, offF = _dag_graph([("", gA, eA), ("D.", gD, None)],
                              edges=[(fork, len(gA))])
    tU = _joined_table(LANES, [(tA, 0), (tB, offU[1])])
    tF = _joined_table(LANES, [(tA, 0), (tD, offF[1])])
    hU, hF = orch.register(gU, table=tU), orch.register(gF, table=tF)
    log(f"  U: {len(gU)} ops, {len(gU.components())} components "
        f"(A seq {main_cfg['seq']}, B seq 256), inputs at ops "
        f"{sorted(eU)}; F: {len(gF)} ops, D's first op after A's op "
        f"{fork} ({gA.ops[fork].name}), {len(gF.phases())} phases")

    # the routes the issue fixes, checked before anything runs
    t0 = time.perf_counter()
    pU = orch.plan(hU)
    pUf = orch.plan(hU, mode="dag", algorithm="frontier")
    pF = orch.plan(hF)
    pFd = orch.plan(hF, mode="dag")
    pFf = orch.plan(hF, mode="dag", algorithm="frontier")
    log(f"  five plans solved in {1e3 * (time.perf_counter() - t0):.1f} ms")
    check(pU.kind == "dag" and pU.schedule.mode == "union-grid",
          f"U: plan() auto-routes the disconnected handle to the DAG route "
          f"(kind {pU.kind!r}, mode {pU.schedule.mode!r})")
    check(pUf.schedule.mode == "frontier"
          and pUf.latency.hex() == pU.latency.hex(),
          f"U: the frontier plan's latency {pUf.latency.hex()} equals the "
          f"union-grid sweep's {pU.latency.hex()}")
    check(pF.kind == "parallel",
          f"F: plan() auto-routes the fork to the parallel solve "
          f"(kind {pF.kind!r})")
    check(pFd.kind == "dag" and pFd.schedule.mode == "phase"
          and pFd.latency.hex() == pF.latency.hex(),
          f"F: mode='dag' takes the phase route ({pFd.schedule.mode!r}) "
          f"at the parallel plan's latency, bitwise "
          f"({pFd.latency.hex()} vs {pF.latency.hex()})")
    check(pFf.schedule.mode == "frontier",
          "F: mode='dag', algorithm='frontier' is the frontier plan")

    spreadU = main["spread"] + conc["spreads"][1]
    spreadF = _host_spread(gF, eF, orch.executor.run_monolithic(gF, eF))
    log(f"  F: reference payloads, host against card, error / max|card| "
        f"by op: {[f'{e:.1e}' for e in spreadF]}")
    out = {}
    for label, plan, graph, ext, h, spread in (
            ("U-union-grid", pU, gU, eU, hU, spreadU),
            ("U-frontier", pUf, gU, eU, hU, spreadU),
            ("F-phase", pFd, gF, eF, hF, spreadF),
            ("F-frontier", pFf, gF, eF, hF, spreadF)):
        log(f"  -- {label}")
        _dag_plan_summary(label, plan, graph)
        out[label] = _run_dag_plan(label, orch, plan, graph, ext, binding,
                                   spread)

    # baselines: every op on the kernel lane; the best sequential route
    # over the topological order; for U, A's and B's own programs
    for name, graph, ext, h, table, spread in (
            ("U", gU, eU, hU, tU, spreadU), ("F", gF, eF, hF, tF, spreadF)):
        n = len(graph)
        log(f"  -- baselines of {name}")
        oracle = orch.executor.run_dag(graph, pU.schedule if name == "U"
                                       else pFf.schedule, ext)
        fence(list(oracle.values()))
        allk = orch.executor.compile_scheduled(
            graph, {i: "cuda-kernels" for i in range(n)})
        wl = orch.workload(h)
        out[f"{name}-all-cuda-kernels"] = _run_baseline(
            f"{name} every op on cuda-kernels", allk,
            lambda: [allk.run(ext)], graph, oracle,
            ("cuda-kernels",) * n, binding, spread,
            wl.evaluate(["cuda-kernels"] * n)[0], every_kernel=True)
        seq = solve_sequential(wl.chain, graph.ops, table, orch.pus,
                               "latency", workload=wl)
        seq_prog = orch.executor.compile_scheduled(graph, seq)
        amap = dict(zip(seq.chain, seq.assignment))
        lanes = {p: seq.assignment.count(p)
                 for p in dict.fromkeys(seq.assignment)}
        log(f"    best sequential route over the topological order: {lanes}")
        out[f"{name}-sequential"] = _run_baseline(
            f"{name} best sequential route", seq_prog,
            lambda: [seq_prog.run(ext)], graph, oracle,
            tuple(amap[i] for i in range(n)), binding, spread, seq.latency,
            every_kernel=False)
        allk.close()
        seq_prog.close()
    sp = [conc["seq_plans"][0], conc["seq_plans"][1]]
    progs = [orch.program_for(p, e) for p, e in zip(sp, (eA, eB))]
    out["U-back-to-back"] = _run_baseline(
        "U as A's and B's own sequential programs back to back", progs[0],
        lambda: [p.run(e) for p, e in zip(progs, (eA, eB))], gU, None,
        None, binding, None, sp[0].latency + sp[1].latency,
        every_kernel=False)

    log("  summary (ms): plan, predicted, measured median, predicted / "
        "measured, co-scheduled steps / steps, stream overlap / busy, "
        "idle share")
    for label, r in out.items():
        dev = r.get("device")
        extra = ""
        if "co" in r:
            extra = f", {r['co']} / {r['steps']}"
            if dev is not None:
                extra += (f", {dev['overlap']:.3f} / {dev['busy']:.3f}, "
                          f"{100 * dev['idle']:.1f}%")
        log(f"    {label}: {1e3 * r['predicted']:.3f}, "
            f"{1e3 * r['measured']:.3f}, "
            f"{r['predicted'] / r['measured']:.3f}{extra}")
    return out


# ---------------------------------------------------------------------------
# phase 6: online admission at the Granite widths
# ---------------------------------------------------------------------------

def _select_window(plan, cursor, now, arrival, ops_done, n_ops):
    """``serve.py``'s window (``select_window``): the plan's steps from
    ``cursor`` up to the next arrival on the estimated clock, or through
    the first step that completes a request.  Returns (end, the
    estimated clock at its end)."""
    steps = plan.schedule.steps
    t, end, count = now, cursor, dict(ops_done)
    while end < len(steps):
        if arrival is not None and t >= arrival:
            break
        st = steps[end]
        end += 1
        t += st.cost
        fin = False
        for k, op in enumerate(st.ops):
            if op is not None:
                h = plan.handles[k]
                count[h] += 1
                fin |= count[h] >= n_ops[h]
        if fin:
            break
    return end, t


def phase_admission(main_cfg: dict, main: dict, conc: dict) -> dict:
    """Requests arriving mid-flight, with phase 4's lanes, tables and
    weights: A admitted alone, B once the executed steps' estimated cost
    passes 40% of A's predicted latency, C at 70%.  Each re-plan is a
    horizon window from every request's progress; each window of steps
    runs as a compiled window program from the frontier (cold: probe and
    capture; then warm, whose results are committed), the way
    ``serve.py``'s real-execution loop runs windows; ``advance`` by what
    completed, ``retire`` as each request finishes."""
    from repro_torch import kernels
    from repro_torch.core import (DEFAULT_HORIZON_STATES, ConcurrentCaches,
                                  ConcurrentSchedule, results_bitwise_equal,
                                  solve_concurrent_horizon)
    from repro_torch.core.laneprogram import JIT
    from repro_torch.core.profiler import fence

    log("== phase 6: online admission at the Granite widths")
    orch, binding = main["orch"], main["binding"]
    graphs, exts, hs = conc["graphs"], conc["exts"], conc["hs"]
    names = "ABC"
    horizon = DEFAULT_HORIZON_STATES
    lat_a = conc["seq_plans"][0].latency
    waiting = [(0.0, 0), (0.4 * lat_a, 1), (0.7 * lat_a, 2)]
    log(f"  A (seq {main_cfg['seq']}) admitted at 0; A's predicted latency "
        f"{1e3 * lat_a:.3f} ms; B, C (seq 256) admitted once the executed "
        f"steps' estimated cost passes {1e3 * waiting[1][0]:.3f} and "
        f"{1e3 * waiting[2][0]:.3f} ms; horizon_states {horizon}")
    slot = {h: r for r, h in enumerate(hs)}
    n_ops = {h: len(graphs[r]) for r, h in enumerate(hs)}
    done = {h: {} for h in hs}
    assign = {h: {} for h in hs}
    verdicts = {h: [] for h in hs}
    admitted, finished = {}, {}
    replans, windows = [], []
    warm0, cold0 = orch.stats["replans_warm"], orch.stats["replans_cold"]

    def replan(event, call, *args):
        t0 = time.perf_counter()
        p = call(*args, horizon_states=horizon)
        ms = 1e3 * (time.perf_counter() - t0)
        if p is not None:
            items = [(h, q) for h, q in sorted(orch._active.items())
                     if q < n_ops[h]]
            cold = solve_concurrent_horizon(
                [orch.workload(h).tail(q) if q else orch.workload(h)
                 for h, q in items], orch.contention,
                caches=ConcurrentCaches(), horizon_states=horizon)
            check(p.schedule.steps == cold.steps
                  and p.latency.hex() == cold.latency.hex(),
                  f"re-plan {len(replans) + 1} ({event}): the plan equals "
                  f"the cold solve of the same progress, bitwise "
                  f"({p.latency.hex()})")
        replans.append((event, ms, p))
        log(f"    re-plan {len(replans)} ({event}): solve {ms:.3f} ms, "
            + ("None" if p is None else
               f"{len(p.schedule.steps)} steps ({p.schedule.mode}) over "
               f"{''.join(names[slot[h]] for h in p.handles)}, progress "
               f"{ {names[slot[h]]: q for h, q in orch._active.items()} }"))
        return p

    now, cursor, plan = 0.0, 0, None
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    while True:
        while waiting and waiting[0][0] <= now:
            r = waiting.pop(0)[1]
            admitted[hs[r]] = time.perf_counter()
            plan, cursor = replan(f"admit {names[r]}", orch.admit, hs[r]), 0
        if plan is None:
            plan, cursor = replan("window frontier", orch.replan_active), 0
        if plan is None:
            if not waiting:
                break
            now = waiting[0][0]
            continue
        end, t = _select_window(plan, cursor, now,
                                waiting[0][0] if waiting else None,
                                {h: len(done[h]) for h in plan.handles},
                                n_ops)
        if end <= cursor:
            plan = None
            continue
        steps = list(plan.schedule.steps[cursor:end])
        sub = ConcurrentSchedule(steps=steps, latency=t - now, energy=0.0,
                                 objective=plan.objective, mode="window")
        gs = [graphs[slot[h]] for h in plan.handles]
        es = [exts[slot[h]] for h in plan.handles]
        front = [dict(done[h]) for h in plan.handles]
        t0 = time.perf_counter()
        prog = orch.executor.compile_concurrent(gs, sub, completed=front,
                                                partial=True)
        fence([list(o.values()) for o in prog.run(es, completed=front)])
        t_cold = time.perf_counter() - t0
        before, seg_t = kernels.launch_counts(), []
        t_warm, res = _fenced(lambda: prog.run(es, completed=front,
                                                segment_timings=seg_t))
        after, expected = kernels.launch_counts(), _expected_launches(prog)
        check(all(after[k] - before[k] == expected[k] for k in after),
              f"window {len(windows) + 1}: the warm run launched each "
              f"kernel once per kernel-lane op ({expected})")
        cuda = [seg for seg in prog.segments if seg.target is not None
                and seg.target.device.type == "cuda"]
        windows.append(dict(
            steps=len(steps), cold=t_cold, warm=t_warm,
            segments=len(prog.segments), cuda=len(cuda),
            jitted=sum(seg.mode == JIT for seg in cuda),
            who="".join(names[slot[h]] for h in plan.handles)))
        log(f"    window {len(windows)} ({windows[-1]['who']}): "
            f"{len(steps)} steps, estimated {1e3 * (t - now):.3f} ms; "
            f"{len(prog.segments)} segments, {windows[-1]['jitted']} of "
            f"{len(cuda)} on CUDA lanes captured; cold (probe + capture) "
            f"{1e3 * t_cold:.1f} ms, warm {1e3 * t_warm:.3f} ms")
        for k, h in enumerate(plan.handles):
            fresh = [i for i in res[k] if i not in done[h]]
            done[h].update(res[k])
            assign[h].update((st.ops[k], st.pus[k]) for st in steps
                             if st.ops[k] is not None)
            verdicts[h] += [seg.verified for seg in prog.segments
                            if seg.items[0][0] == k
                            and seg.verified is not None]
            orch.advance(h, len(fresh))
        prog.close()
        now, cursor = t, end
        fin = [h for h in plan.handles if len(done[h]) >= n_ops[h]]
        if cursor >= len(plan.schedule.steps):
            plan = None
        for h in fin:
            finished[h] = time.perf_counter()
            plan, cursor = replan(f"retire {names[slot[h]]}", orch.retire,
                                  h), 0
    wall = time.perf_counter() - t_start
    counts = kernels.launch_counts()
    log(f"  {len(windows)} windows, {len(replans)} re-plans in "
        f"{wall:.2f} s; launches over the phase: {counts}")

    retires = [p for event, _, p in replans if event.startswith("retire")]
    check(orch._active == {} and len(retires) == 3 and retires[-1] is None,
          "the last retire returns None and leaves no active request")
    n_warm = orch.stats["replans_warm"] - warm0
    check(n_warm >= 1 and orch.stats["replans_cold"] == cold0,
          f"{n_warm} warm re-plans, {orch.stats['replans_cold'] - cold0} "
          "cold")
    check(all(counts[k] >= 1 for k in CHAIN_KERNELS)
          and not counts["ssd_step"],
          f"every kernel of the chain launched in the phase, the decode "
          f"step's none ({counts})")
    for r, h in enumerate(hs):
        graph, ext = graphs[r], exts[r]
        check(sorted(done[h]) == list(range(n_ops[h])),
              f"request {names[r]}: every op completed")
        alone = orch.executor.compile_scheduled(graph, assign[h])
        fence(list(alone.run(ext).values()))
        got = alone.run(ext)
        fence(list(got.values()))
        check(results_bitwise_equal(done[h], got),
              f"request {names[r]}: bitwise equal to its run alone with "
              "the op -> lane assignment it was given")
        alone.close()
        oracle = orch.executor.run_scheduled(graph, assign[h], ext)
        fence(list(oracle.values()))
        route = tuple(assign[h][i] for i in range(n_ops[h]))
        _route_matches(f"request {names[r]} (admission)", done[h], oracle,
                       route, binding, verdicts[h], conc["spreads"][r])
        lanes = {lane: route.count(lane) for lane in dict.fromkeys(route)}
        log(f"  request {names[r]}: admission to completion "
            f"{1e3 * (finished[h] - admitted[h]):.1f} ms; lanes {lanes}")
    colds = [w["cold"] for w in windows]
    log(f"  cold cost per window (compile, probe, capture): median "
        f"{1e3 * _median(colds):.1f} ms, total {1e3 * sum(colds):.1f} ms; "
        f"warm window runs total "
        f"{1e3 * sum(w['warm'] for w in windows):.3f} ms; solve ms "
        f"{[round(ms, 3) for _, ms, _ in replans]}")
    return dict(windows=windows, replans=replans, counts=counts, wall=wall)


# ---------------------------------------------------------------------------
# phase 7: serving under faults at the Granite widths
# ---------------------------------------------------------------------------

KERNEL_LANE = "cuda-kernels"
N_SERVED = 8                 # requests per chaos scenario
SCENARIO_LIMIT_S = 240.0     # hard wall-clock limit of one scenario


def _kernel_ops(graph, route) -> list[int]:
    """Ops of ``graph`` that launch a hand-written kernel on the kernel
    lane under ``route``."""
    return [i for i, op in enumerate(graph.ops)
            if op.name.rsplit(".", 1)[-1] in KERNEL_OF_OP
            and route[i] == KERNEL_LANE]


def _recover_once(label, orch, plan, h, graph, ext, k, oracle, spread):
    """One ``pu_lost`` on the kernel lane at op ``k`` of ``plan`` (whose
    program is warm): the frontier at the loss (``recover=False``), then
    the default ``execute`` recovering from it.  Checks the recovery
    count, the prefix bitwise the fault-free run's, the whole result
    bitwise the interpreter's resume of the stitched assignment and
    within the route bound of the oracle; restores the nominal
    condition."""
    from repro_torch.core import (FaultPlan, PULostError, RuntimeCondition,
                                  results_bitwise_equal, solve_sequential)
    from repro_torch.core.profiler import fence
    n = len(graph)
    clean = orch.execute(plan, ext)
    fence(list(clean.values()))
    faults = FaultPlan.single("pu_lost", lane=KERNEL_LANE, op=k)
    try:
        orch.execute(plan, ext, recover=False, faults=faults)
        check(False, f"{label}: the pu_lost at op {k} fired")
    except PULostError as e:
        prefix = dict(e.partial[0])
    fence(list(prefix.values()))
    check(results_bitwise_equal(prefix, {i: clean[i] for i in prefix}),
          f"{label}: the completed prefix at the loss (ops "
          f"{sorted(prefix)}) is bitwise the fault-free run's")
    faults.reset()
    r0 = orch.stats["recoveries"]
    t0 = time.perf_counter()
    got = orch.execute(plan, ext, faults=faults)
    fence(list(got.values()))
    wall = time.perf_counter() - t0
    check(orch.stats["recoveries"] == r0 + 1
          and orch.condition.unavailable == {KERNEL_LANE},
          f"{label}: stats['recoveries'] {r0} -> "
          f"{orch.stats['recoveries']}, {KERNEL_LANE} unavailable")
    p = len(prefix)
    wl = orch.workload(h).under_condition(orch.condition.slowdown,
                                          orch.condition.unavailable)
    tail = solve_sequential(wl.chain[p:], graph.ops, None, orch.pus,
                            workload=wl.tail(p))
    stitched = dict(zip(tail.chain, tail.assignment))
    want = orch.executor.run_scheduled(graph, stitched, ext,
                                       completed=prefix)
    fence(list(want.values()))
    check(results_bitwise_equal(got, want),
          f"{label}: the result is bitwise the interpreter's resume from "
          f"the frontier on the stitched assignment (tail on "
          f"{sorted(set(stitched.values()))})")
    check(results_bitwise_equal({i: got[i] for i in prefix}, prefix),
          f"{label}: the recovered result keeps the prefix as it was")
    _drift_ok(f"{label}: recovered result against the interpreter oracle",
              got, oracle, spread)
    log(f"    {label}: loss at op {k} ({graph.ops[k].name}), prefix "
        f"{p} of {n} ops, recovered execute {1e3 * wall:.1f} ms "
        f"(re-plan + interpreter resume)")
    orch.on_condition(RuntimeCondition())
    check(orch.condition.nominal, f"{label}: nominal condition restored")
    return wall


def _recovery_on_main_path(main) -> dict:
    """(a) Recovery of phase 3's planned route of A, and of the same
    route cut by one op on ``cuda:0`` (so that the compiled frontier at
    the loss is not empty), from a kernel-lane loss at an early and a
    late kernel op; then ``on_condition``'s re-stitched plan against the
    dynamic scheduler's."""
    from repro_torch.core import (DynamicScheduler, Plan, RuntimeCondition,
                                  SeqSchedule)
    from repro_torch.core.profiler import fence
    orch, h, graph, ext = main["orch"], main["h"], main["graph"], main["ext"]
    spread = main["spread"]
    n = len(graph)
    plan = orch.plan(h)
    route0 = [lane for _, lane in plan.route[0]]
    oracle = orch.execute(plan, ext, compile=False)
    fence(list(oracle.values()))
    kops = _kernel_ops(graph, route0)
    check(len(kops) >= 2, f"the planned route runs {len(kops)} kernel ops "
                          f"on {KERNEL_LANE}")
    early, late = kops[1], kops[-1]      # kops[0] may be op 0: no cut
    walls = {}
    for k in (early, late):
        walls[("planned", k)] = _recover_once(
            f"planned route, loss at op {k}", orch, plan, h, graph, ext,
            k, oracle, spread)
        route = list(route0)
        route[k - 1] = "cuda:0"
        lat, eng = orch.workload(h).evaluate(route)
        cut = Plan("sequential", SeqSchedule(list(range(n)), route, lat,
                                             eng, "latency"),
                   "latency", (h,), "sequential")
        fence(list(orch.execute(cut, ext).values()))     # cold: capture
        walls[("cut", k)] = _recover_once(
            f"route cut at op {k - 1}, loss at op {k}", orch, cut, h, graph,
            ext, k, oracle, spread)
        orch.program_for(cut, ext).close()
    check(orch.plan(h).route == plan.route,
          "after the recoveries the nominal plan is phase 3's route again")

    # on_condition re-stitches an active chain as the dynamic scheduler
    # does, bitwise
    mid = n // 2
    orch.admit(h)
    orch.advance(h, mid)
    cond = RuntimeCondition(slowdown={KERNEL_LANE: 8.0})
    got = orch.on_condition(cond)
    reg = orch._reg(h)
    dyn = DynamicScheduler(reg.chain, graph.ops, reg.table, orch.pus,
                           workload=reg.wl)
    want = dyn.on_condition(mid, cond)
    sched = got[(h, "latency")].schedule
    check(list(got) == [(h, "latency")]
          and sched.assignment == want.assignment
          and sched.latency.hex() == want.latency.hex(),
          f"on_condition({KERNEL_LANE} x8) at op {mid}: the re-stitched "
          f"plan is bitwise DynamicScheduler.on_condition's "
          f"({sched.latency.hex()}, tail {sched.assignment[mid:]})")
    orch.retire(h)
    orch.on_condition(RuntimeCondition())
    check(orch.condition.nominal and orch.plan(h).route == plan.route,
          "nominal condition restored; phase 3's plan again")
    return walls


class _Measured:
    """Cost provider over tables measured in phases 3 and 4: a graph's
    table by the graph's identity (nothing is profiled again)."""

    def __init__(self, tables: dict):
        self.tables = tables

    def profile(self, graph):
        return self.tables[id(graph)]


def _scenario(name, trace, stall_budget):
    """bench_chaos's four scenarios, aimed at the card's lanes: (chaos
    trace, engine keywords)."""
    from repro_torch.core import (ChaosEvent, ChaosTrace, ExecutionPolicy,
                                  HealthPolicy)
    t = [a.time for a in trace.arrivals]
    if name == "transient_storm":
        return [ChaosEvent(time=0.0, kind="transient", count=4)], {}
    if name == "straggler":
        return ([ChaosEvent(time=0.0, kind="straggler", lane=KERNEL_LANE,
                            delay=0.005, count=-1)],
                dict(calibration=4))
    if name == "stall":
        return ([ChaosEvent(time=0.0, kind="stall", lane=KERNEL_LANE,
                            delay=30.0, count=-1)],
                dict(exec_policy=ExecutionPolicy(
                    timeout=stall_budget, min_timeout=stall_budget,
                    max_retries=0), max_window_retries=1))
    return ([ChaosEvent(time=t[3], kind="pu_lost", lane=KERNEL_LANE),
             ChaosEvent(time=t[6], kind="pu_restored", lane=KERNEL_LANE)],
            dict(cooldown_backoff=1.0))


def _hard_limit(seconds):
    """A context that fails the check if its body runs past ``seconds``
    of wall clock (SIGALRM in the main thread)."""
    import contextlib
    import signal

    @contextlib.contextmanager
    def limit():
        def on_alarm(signum, frame):
            raise CheckFailed(f"a serving scenario ran past {seconds:.0f} s")
        old = signal.signal(signal.SIGALRM, on_alarm)
        signal.setitimer(signal.ITIMER_REAL, seconds)
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0.0)
            signal.signal(signal.SIGALRM, old)
    return limit()


def _serve_scenario(name, main, conc, lat_a, stall_budget) -> dict:
    """One chaos scenario through ``ServingEngine(execution="real",
    compile_exec=True)`` on a fresh session over phases 3-4's lanes and
    tables; checks and prints its report."""
    from repro_torch.core import (ArrivalTrace, ChaosTrace, HealthPolicy,
                                  Orchestrator, SHED_REASONS, ServingEngine)
    from repro_torch.core.profiler import fence
    orch0, binding = main["orch"], main["binding"]
    graphs, exts, hs = conc["graphs"], conc["exts"], conc["hs"]
    names = "ABC"
    tables = {id(g): orch0._reg(h).table for g, h in zip(graphs, hs)}
    orch = Orchestrator(_Measured(tables), targets=binding)
    trace = ArrivalTrace.poisson(list(names), rate=1.5 / lat_a,
                                 n=N_SERVED, seed=7)
    events, kw = _scenario(name, trace, stall_budget)
    health = dict(cooldown=0.25 * lat_a)
    for key in ("calibration", "cooldown_backoff"):
        if key in kw:
            health[key] = kw.pop(key)
    eng = ServingEngine(orch, dict(zip(names, graphs)), execution="real",
                        compile_exec=True, max_concurrent=3,
                        inputs=dict(zip(names, exts)),
                        health_policy=HealthPolicy(**health), **kw)
    chaos = ChaosTrace(events, kind=name, seed=7)
    t0 = time.perf_counter()
    with _hard_limit(SCENARIO_LIMIT_S):
        rep = eng.serve(trace, chaos=chaos)
    wall = time.perf_counter() - t0
    log(f"  scenario {name}: {len(chaos)} scripted event(s) "
        f"{[(e.kind, e.lane, round(1e3 * e.time, 3)) for e in events]} "
        f"(ms on the serving clock); served in {wall:.1f} s wall")
    log(f"    completed {rep.completed}, shed {rep.shed} "
        f"{rep.shed_reasons}; throughput {rep.throughput:.1f} req/s and "
        f"request p50 / p99 {1e3 * rep.latency_p50:.3f} / "
        f"{1e3 * rep.latency_p99:.3f} ms (serving clock); plan ms p50 / "
        f"p99 {rep.plan_ms_p50:.3f} / {rep.plan_ms_p99:.3f} over "
        f"{rep.plan_events} re-plans ({rep.replans_warm} warm, "
        f"{rep.replans_cold} cold)")
    ws = eng.window_seconds
    log(f"    recoveries {rep.recoveries} (ms p50 / p99 "
        f"{rep.recovery_ms_p50:.1f} / {rep.recovery_ms_p99:.1f}), "
        f"recovered {rep.recovered}, retried {rep.retried}; exec_wall_s "
        f"{rep.exec_wall_s:.3f} over {len(ws)} window runs (cold each: "
        f"median {1e3 * _median(ws):.1f} ms, max {1e3 * max(ws):.1f} ms)")
    log(f"    breaker: opens {rep.breaker['opens']}, probes "
        f"{rep.breaker['probes']}, readmits {rep.breaker['readmits']}, "
        f"rescales {rep.breaker['rescales']}")
    for t in rep.breaker["transitions"]:
        log(f"      {1e3 * t['time']:9.3f} ms  {t['pu']:13s} {t['frm']:9s}"
            f" -> {t['to']:9s} {t['reason']}")
    log(f"    cache_stats delta {rep.cache}")
    fired = eng.faults.fired
    log(f"    fired: {len(fired)} ({sorted({f[:2] for f in fired})})")

    check(rep.completed + rep.shed == rep.n_requests == N_SERVED
          and all(r.shed_reason in SHED_REASONS for r in rep.requests
                  if r.shed),
          f"{name}: completed + shed == n ({rep.completed} + {rep.shed})")
    check(rep.bitwise_failures == 0 and rep.bitwise_checked ==
          rep.completed, f"{name}: bitwise_failures 0 of "
          f"{rep.bitwise_checked} completions (each against its solo run "
          f"with the assignment it was given)")
    check(orch._active == {}, f"{name}: no request left active")
    for ev in events:
        if ev.kind == "pu_restored":
            continue
        n_fired = sum(1 for f in fired if f[0] == ev.kind
                      and (ev.lane is None or f[1] == ev.lane))
        check(n_fired >= 1 and (ev.count <= 0 or n_fired == ev.count),
              f"{name}: the scripted {ev.kind} on {ev.lane or 'any lane'} "
              f"fired {n_fired} time(s)")
    model_of = dict(zip(names, range(3)))
    two_lanes = 0
    for rec in rep.requests:
        if rec.shed:
            continue
        r = model_of[rec.model]
        route = tuple(rec.assignment[i] for i in range(rec.ops_total))
        two_lanes += len(set(route)) > 1
        oracle = orch.executor.run_scheduled(graphs[r], rec.assignment,
                                             exts[r])
        fence(list(oracle.values()))
        misplaced = [i for i in range(rec.ops_total)
                     if rec.results[i].device != binding[route[i]].device]
        check(not misplaced, f"{name}: request {rec.rid} ({rec.model}): "
                             f"every op's output on its lane's device")
        _drift_ok(f"{name}: request {rec.rid} ({rec.model}, lanes "
                  f"{sorted(set(route))}) against the interpreter oracle",
                  rec.results, oracle, conc["spreads"][r])
    if name == "pu_lost_return":
        seq = [(t["frm"], t["to"]) for t in rep.breaker["transitions"]
               if t["pu"] == KERNEL_LANE and t["frm"] != t["to"]]
        opened = seq.index(("closed", "open")) if ("closed", "open") in \
            seq else None
        check(rep.recoveries >= 1, f"{name}: recoveries "
                                   f"{rep.recoveries} >= 1")
        check(opened is not None and ("open", "half_open") in
              seq[opened:] and seq[-1] == ("half_open", "closed")
              and rep.breaker["targets"][KERNEL_LANE]["state"] ==
              "closed", f"{name}: the {KERNEL_LANE} breaker went open -> "
                        f"half_open -> closed ({seq})")
        check(two_lanes >= 1, f"{name}: {two_lanes} request(s) ran on two "
                              "lanes or more")
    return dict(report=rep, wall=wall, windows=ws)


def phase_serving(main_cfg: dict, main: dict, conc: dict,
                  adm: dict) -> dict:
    """(a) recovery of the main path from a kernel-lane loss, and (b) the
    serving engine under bench_chaos's four scenarios."""
    from repro_torch import kernels
    log("== phase 7: serving under faults at the Granite widths")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    walls = _recovery_on_main_path(main)
    log(f"  (a) done in {time.perf_counter() - t0:.1f} s; recovered "
        f"execute ms {[round(1e3 * w, 1) for w in walls.values()]}")
    lat_a = conc["seq_plans"][0].latency
    colds = [w["cold"] for w in adm["windows"]]
    warms = [w["warm"] for w in adm["windows"]]
    stall_budget = max(2.0, 4.0 * max(colds))
    log(f"  (b) A's predicted latency {1e3 * lat_a:.3f} ms; arrivals at "
        f"{1.5 / lat_a:.1f} req/s; phase 6's window costs: cold median "
        f"{1e3 * _median(colds):.1f} ms, max {1e3 * max(colds):.1f} ms, "
        f"warm median {1e3 * _median(warms):.3f} ms; the stall scenario's "
        f"watchdog budget {stall_budget:.2f} s")
    out = {}
    for name in ("transient_storm", "straggler", "stall", "pu_lost_return"):
        out[name] = _serve_scenario(name, main, conc, lat_a, stall_budget)
    counts = kernels.launch_counts()
    check(all(counts[k] >= 1 for k in CHAIN_KERNELS)
          and not counts["ssd_step"],
          f"every kernel of the chain launched in the phase, the decode "
          f"step's none ({counts})")
    log(f"  phase 7 in {time.perf_counter() - t0:.1f} s")
    return dict(recovery=walls, scenarios=out, counts=counts)


# The decode step's kernel (phase 8 (c)): (label, B, H, N, P, dtype of
# c, b and v) at Zamba2-2.7B's Mamba-2 decode at the benchmark's batch 32
# (80 heads of 64 x 64: the 16-byte route) and xLSTM-125M's mLSTM decode at
# phase 8's batch (4 heads of 384 x 385: the one-float route)
SSD_STEP_CASES = (("zamba2-2.7b", 32, 80, 64, 64, "bfloat16"),
                  ("xlstm-125m mLSTM", 4, 4, 384, 385, "float32"),
                  ("xlstm-125m mLSTM", 4, 4, 384, 385, "bfloat16"))
# the states a timed round updates in turn, one a Zamba2-2.7B layer: 2.26
# GB at its decode shape, so no call finds its state in the 50 MB L2
SSD_STEP_STATES = 54


def round_ms(fn, states, rounds: int = 10) -> float:
    """Device ms a call of ``fn(S)`` over ``states`` in turn: one round
    captured as a CUDA graph, its replays timed by CUDA events, so the
    host's launches stay out of the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for S in states:
            fn(S)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for S in states:
            fn(S)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (rounds * len(states))
    del graph
    torch.cuda.empty_cache()
    return ms


def step_operands(B, H, N, P, dtype) -> tuple:
    """The decode step's operands drawn on the card (S, c, b, v, log_a;
    c, b and v in ``dtype``, a torch dtype's name) and the bytes its
    bound counts: S read and written, every other operand and y once."""
    import torch
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(3)

    def draw(*shape, scale=1.0, to=torch.float32):
        return (scale * torch.randn(shape, device="cuda",
                                    generator=gen)).to(to)
    S = draw(B, H, N, P, scale=0.5)
    c, b, v = draw(B, H, N, to=dt), draw(B, H, N, to=dt), draw(B, H, P, to=dt)
    la = -torch.nn.functional.softplus(draw(B, H))
    nbytes = 2 * S.nbytes + c.nbytes + b.nbytes + 2 * v.nbytes + la.nbytes
    return (S, c, b, v, la), nbytes


def _ssd_step_case(label, B, H, N, P, dtype) -> dict:
    """The decode step's kernel at one shape against its plain version on
    the card: S' in place and bitwise the plain step's, y within the f32
    bucket (bf16: one ulp, or 1e-5 of the largest), one launch, bitwise
    run to run; then timed over ``SSD_STEP_STATES`` states in turn."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ssd_step as st
    dt = getattr(torch, dtype)
    (S, c, b, v, la), nbytes = step_operands(B, H, N, P, dtype)
    Sk, Sp, Sr = S.clone(), S.clone(), S.clone()
    kernels.reset_launch_counts()
    y, out = st.ssd_step_cuda(Sk, c, b, v, la)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    yp, _ = st.ssd_step_plain(Sp, c, b, v, la)
    y2, _ = st.ssd_step_cuda(Sr, c, b, v, la)
    shape = f"({B}, {H}, {N}, {P}) {dtype}"
    check(out is Sk and launches["ssd_step"] == 1
          and sum(launches.values()) == 1 and bitwise_equal(Sk, Sp),
          f"ssd_step at {label} {shape}: one launch, S' written over S, "
          "bitwise the plain step's")
    yd, ypd = y.double(), yp.double()
    if dt == torch.float32:
        err = norm_err(y, yp)[1]
        ok, what = err <= F32_TOL, f"{err:.2e} of the largest <= {F32_TOL}"
    else:
        gap = (yd - ypd).abs()
        ok = bool((gap <= 2.0 ** -7 * ypd.abs()
                   + 1e-5 * float(ypd.abs().max())).all())
        err, what = float(gap.max()), "one bf16 ulp or 1e-5 of the largest"
    check(ok, f"ssd_step at {label} {shape}: y within {what} of the plain "
              f"step's (max |diff| {float((yd - ypd).abs().max()):.3e})")
    check(bitwise_equal(y, y2) and bitwise_equal(Sk, Sr),
          f"ssd_step at {label} {shape}: two runs bitwise equal")
    states = [S.clone() for _ in range(SSD_STEP_STATES)]
    ms = round_ms(lambda s: st.ssd_step_cuda(s, c, b, v, la), states)
    plain_ms = round_ms(lambda s: st.ssd_step_plain(s, c, b, v, la), states)
    device = _device_times(lambda: [st.ssd_step_cuda(s, c, b, v, la)
                                    for s in states], calls=2)
    bound_ms = 1e3 * nbytes / PEAK_BYTES
    row = dict(name="ssd_step", route="cuda",
               source="src/repro_torch/csrc/ssd_step.cu", replaces=None,
               arch=label, shapes=shape, ms=ms,
               device_ms=device.get("ssd_step_kernel"), plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by="bytes", library_ms=None,
               nbytes=nbytes, y_err=err,
               max_abs_err=float((yd - ypd).abs().max()))
    dev = "not measured (the trace held no ssd_step_kernel)" \
        if row["device_ms"] is None else f"{row['device_ms']:.4f} ms"
    log(f"  ssd_step at {label} {shape}: kernel {ms:.4f} ms a call (CUDA "
        f"graph of {SSD_STEP_STATES} states in turn), on the device {dev}, "
        f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s: {100 * bound_ms / ms:.1f}%), plain "
        f"{plain_ms:.4f} ms")
    del states
    torch.cuda.empty_cache()
    return row


def _ssd_step_shapes() -> list:
    """(c) the decode step's kernel at ``SSD_STEP_CASES``; a state the
    kernel does not take (bf16, not contiguous) raises and launches
    nothing."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    rows = [_ssd_step_case(*case) for case in SSD_STEP_CASES]
    c = torch.zeros((2, 4, 64), device="cuda")
    v, la = torch.zeros((2, 4, 64), device="cuda"), \
        torch.zeros((2, 4), device="cuda")
    cases = {
        "ssd_step on a bf16 state": (
            TypeError, torch.zeros((2, 4, 64, 64), device="cuda",
                                   dtype=torch.bfloat16)),
        "ssd_step on a state that is not contiguous": (
            ValueError, torch.zeros((2, 4, 64, 64),
                                    device="cuda").transpose(2, 3)),
    }
    for label, (err, S) in cases.items():
        kernels.reset_launch_counts()
        try:
            ops.ssd_step(S, c, c, v, la)
            raised = None
        except err as e:
            raised = e
        torch.cuda.synchronize()
        check(raised is not None and not any(kernels.launch_counts().values()),
              f"no fallback: {label} raises {err.__name__} ({raised})")
    return rows


# ---------------------------------------------------------------------------
# phase 8: the model zoo served at full width
# ---------------------------------------------------------------------------

N_PROMPTS, PROMPT_LEN, MAX_NEW = 4, 1024, 32
# Llama-3.2-1B's attention and Zamba2-2.7B's Mamba-2 scans go through the
# kernels (the reference's use_kernels prefill): (arch, kernel, launches
# per prefill, a second correct plain path: the config fields it changes)
ZOO_FULL = (("llama3.2-1b", "flash_attention", 16, None),
            ("zamba2-2.7b", "ssd_scan", 54, {"ssm_chunk": 128}),
            ("xlstm-125m", "ssd_scan", 6, {"ssm_chunk": 128}))
# The whole bf16 model is held to the plain path within the bf16 bucket,
# or within ZOO_SPREAD times the spread between two correct plain paths
# (the scan at chunk 256 and at 128), whichever is larger: over Zamba2's
# 54 layers bf16 rounding alone moves the leaves by ~6e-2 of their
# largest value (PERF.md, zoo serving).  Each kernel call is held to the
# layer's plain math on the same inputs within the bucket, and the f32
# model within ZOO_F32_TOL at full depth.
ZOO_SPREAD = 2.0
# the comparison in f32 at full width: cut depth, and full depth
ZOO_F32_DEPTH = {"llama3.2-1b": (2, 16), "zamba2-2.7b": (6, 54),
                 "xlstm-125m": (4, 12)}
ZOO_F32_TOL = 2e-4     # tests/test_kernel_integration_compress.py's bound
# xLSTM-125M's sLSTM half steps through the prompt one token at a time: a
# prefill is a host-bound loop of ~150k small device ops (2-3 s, 6.4%
# device-busy in a trace on an H100 80GB HBM3 at 700 W, PERF.md), so its
# prefill is timed once each way, its decode loops run once each way, and
# its prefill is not traced
ZOO_HOST_BOUND = ("xlstm-125m",)
ZOO_DECODE_STEPS = 4   # phase 8 (b): decode steps after each prefill


def _leaves_err(got, want) -> tuple[bool, float, int]:
    """(every leaf of ``got`` finite and its int leaves equal to
    ``want``'s, the worst leaf error over the largest |value| of the
    same leaf of ``want``, the number of leaves)."""
    import torch
    from repro_torch.models import model as M
    g_leaves, w_leaves = M.tree_leaves(got), M.tree_leaves(want)
    ok = len(g_leaves) == len(w_leaves)
    worst = 0.0
    for g, w in zip(g_leaves, w_leaves):
        if g.is_floating_point():
            ok = ok and bool(torch.isfinite(g.float()).all())
            worst = max(worst, norm_err(g, w)[1])
        else:
            ok = ok and torch.equal(g, w)
    return ok, worst, len(g_leaves)


def _leaves_close(label, got, want, tol) -> float:
    """Every leaf of ``got`` within ``tol`` of the largest |value| of the
    same leaf of ``want``; returns the worst ratio."""
    ok, worst, n = _leaves_err(got, want)
    check(ok and worst <= tol,
          f"{label}: {n} leaves, finite, int leaves equal, worst error / "
          f"max|value| {worst:.3e} <= {tol:g}")
    return worst


def _zoo_prompts(vocab: int):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(
        0, vocab, (N_PROMPTS, PROMPT_LEN), dtype=np.int32)).to("cuda")


def _wall(fn) -> float:
    """Wall seconds of ``fn()``, synchronised with the card on both
    sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _counted(fn):
    """``fn()`` with the launch counts zeroed just before it and read just
    after (once the card is done)."""
    import torch
    from repro_torch import kernels
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def _zoo_call_shapes(arch, cfg) -> tuple[str, dict]:
    """The kernel ``arch``'s prefill calls, and its operands' shapes at
    phase 8's batch (N_PROMPTS x PROMPT_LEN)."""
    B, T = N_PROMPTS, PROMPT_LEN
    if cfg.block_pattern in ("dense", "moe"):
        return "flash_attention", dict(
            q=(B, T, cfg.n_heads, cfg.d_head),
            kv=(B, T, cfg.n_kv_heads, cfg.d_head))
    if cfg.block_pattern == "xlstm":       # the mLSTM: v and a ones column
        H = cfg.n_heads
        dh = cfg.xlstm_d_inner // H
        return "ssd_scan", dict(cb=(B, T, H, dh), v=(B, T, H, dh + 1),
                                chunk=cfg.ssm_chunk, ones=True)
    H = cfg.ssm_heads
    return "ssd_scan", dict(cb=(B, T, H, cfg.ssm_state),
                            v=(B, T, H, cfg.ssm_d_inner // H),
                            chunk=cfg.ssm_chunk, ones=False)


def _zoo_kernel_times(arch, cfg, dtype=None, repeat=False,
                      attn_baseline=None, ssd_baseline=None) -> dict:
    """The kernel of ``arch``'s prefill at its shapes (random inputs of
    those shapes, in ``dtype``, default bf16): held against its plain
    version within the dtype's bucket (and, with ``repeat``, bitwise
    between two runs); kernel, plain version, library call and bound.
    In f32, given ``attn_baseline`` or ``ssd_baseline`` (phase 1's builds
    of the mma.sync attention and scan), that kernel is held and timed on
    the same operands where the rule sends the call elsewhere; with
    ``repeat`` the scan's device time by kernel is read from a child's
    trace, and its kernels must be the rule's."""
    import torch
    import torch.nn.functional as F_
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    import numpy as np
    rng = np.random.default_rng(1)
    dtype = dtype or torch.bfloat16
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    name = f"{arch} {str(dtype)[6:]}"
    kernel, sh = _zoo_call_shapes(arch, cfg)
    if kernel == "flash_attention":
        q = rand(rng, sh["q"], dtype)
        k = rand(rng, sh["kv"], dtype)
        v = rand(rng, sh["kv"], dtype)
        B, T, Hq, D = sh["q"]
        Hk = sh["kv"][2]
        err, rel = norm_err(fa.flash_attention_cuda(q, k, v),
                            fa.flash_attention_plain(q, k, v))
        check(rel <= tol, f"flash_attention at {name}'s prefill shapes: "
                          f"/max|plain| {rel:.3e} <= {tol}")
        if repeat:
            check_repeatable("flash_attention", f"at {arch}'s shapes",
                             fa.flash_attention_cuda, (q, k, v))
        extra = {}
        if dtype == torch.float32 and attn_baseline is not None:
            from repro_torch.kernels import _build
            o = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream

            def entry(fn):
                def call():
                    e = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), B, T, T, Hq, Hk, D, 1, 0, 0, stream)
                    if e:   # no log line a call: the timing would read the host
                        check(False, f"the f32 attention's C entry: "
                                     f"cudaError_t {e}")
                return call
            base = entry(attn_baseline)
            base()
            _hold("flash_attention", f"at {arch}'s shapes, the mma.sync "
                  "kernel", o, fa.flash_attention_plain(q, k, v), dtype,
                  False)
            # the mma.sync kernel's time, and the shipped C entry's (the
            # rule's kernel without the wrapper)
            shipped = entry(_build.function("flash_attention"))
            extra["mma_sync_ms"] = time_ms(base)
            extra["c_entry_ms"] = time_ms(shipped)
        pairs = Hq * B * T * (T + 1) // 2
        # q, k, v read once and o written once; bf16 under the contract
        # (P above bf16): 2 D for Q K^T and 2 x 2 D for P as two bf16
        # terms, at the bf16 peak; f32 as 3xTF32
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound(6 * D * pairs, nbytes, PEAK_BF16) \
            if dtype == torch.bfloat16 else tc_bound(4 * D * pairs, nbytes,
                                                     dtype)
        G = Hq // Hk
        qh = q.transpose(1, 2).contiguous()
        kh, vh = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
                  for x in (k, v))
        ulps = {}
        if dtype == torch.bfloat16:
            # every element within one bf16 ulp of the f32 kernel on the
            # upcast inputs (rounded to bf16), SDPA's distance beside it
            ref = fa.flash_attention_cuda(q.float(), k.float(),
                                          v.float()).to(dtype)
            sdpa = F_.scaled_dot_product_attention(qh, kh, vh,
                                                   is_causal=True)
            ulps = dict(ulps=fa.bf16_ulps(fa.flash_attention_cuda(q, k, v),
                                          ref),
                        sdpa_ulps=fa.bf16_ulps(sdpa.transpose(1, 2), ref))
            del ref, sdpa
            check(ulps["ulps"] <= 1.0,
                  f"flash_attention at {name}'s prefill shapes: every "
                  f"element within one bf16 ulp of the f32 kernel on the "
                  f"upcast inputs ({ulps['ulps']:.2f} ulps at max(|ref|, "
                  f"1e-3 max|ref|); SDPA {ulps['sdpa_ulps']:.2f})")
        return dict(name="flash_attention", shapes=f"q {tuple(q.shape)}, "
                    f"k/v {tuple(k.shape)} {str(dtype)[6:]} causal",
                    ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v)),
                    plain_ms=time_ms(lambda: fa.flash_attention_plain(
                        q, k, v), iters=2, warmup=1),
                    library_ms=time_ms(lambda: F_.scaled_dot_product_attention(
                        qh, kh, vh, is_causal=True)),
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                    rel_err=rel, **ulps, **extra)
    B, T, H, N = sh["cb"]
    P, C = sh["v"][-1], sh["chunk"]
    c = rand(rng, sh["cb"], dtype, 0.5)
    b = rand(rng, sh["cb"], dtype, 0.5)
    if sh["ones"]:
        v = torch.cat([rand(rng, sh["v"][:-1] + (P - 1,), dtype),
                       torch.ones(sh["v"][:-1] + (1,), device="cuda",
                                  dtype=dtype)], dim=-1)
    else:
        v = rand(rng, sh["v"], dtype)
    la = -torch.nn.functional.softplus(rand(rng, (B, T, H), torch.float32))
    (y, s), (yp, sp) = (f(c, b, v, la, chunk=C) for f in
                        (ss.ssd_scan_cuda, ss.ssd_scan_plain))
    err, rel = norm_err(y, yp)
    s_rel = norm_err(s, sp)[1]
    check(rel <= tol and s_rel <= tol,
          f"ssd_scan at {name}'s prefill shapes: /max|plain| y {rel:.3e}, "
          f"state {s_rel:.3e} <= {tol}")
    extra = {}
    if dtype == torch.bfloat16:
        # every element of y within one bf16 ulp of the f32 kernel on the
        # upcast inputs (rounded to bf16), the final state within F32_TOL
        # of the f32 kernel's largest value; the plain version's distances
        # beside them
        yf, sf = ss.ssd_scan_cuda(c.float(), b.float(), v.float(), la,
                                  chunk=C)
        ref = yf.to(dtype)
        extra = dict(ulps=fa.bf16_ulps(y, ref),
                     plain_ulps=fa.bf16_ulps(yp, ref),
                     state_err=norm_err(s, sf)[1],
                     plain_state_err=norm_err(sp, sf)[1])
        del yf, sf, ref
        check(extra["ulps"] <= 1.0 and extra["state_err"] <= F32_TOL,
              f"ssd_scan at {name}'s prefill shapes: every element of y "
              f"within one bf16 ulp of the f32 kernel on the upcast inputs "
              f"({extra['ulps']:.2f} ulps at max(|ref|, 1e-3 max|ref|); "
              f"plain {extra['plain_ulps']:.2f}), the final state within "
              f"{F32_TOL:g} of its largest value ({extra['state_err']:.2e};"
              f" plain {extra['plain_state_err']:.2e})")
        if repeat:
            extra["by_kernel"] = _scan_device_times(B, T, H, N, P, C)
    elif repeat:
        extra["by_kernel"] = _scan_device_times(B, T, H, N, P, C, "float32")
        rule = ss.f32_kernels(c, b, v)
        check(sorted(extra["by_kernel"]) == sorted(rule),
              f"ssd_scan at {name}'s prefill shapes: launched "
              f"{sorted(extra['by_kernel'])}, the rule's {sorted(rule)}")
        if ssd_baseline is not None and rule != ss.F32_MMA_SYNC_KERNELS:
            from repro_torch.kernels import _build
            base = _ssd_entry(ssd_baseline, c, b, v, la, C)
            base()
            _hold("ssd_scan", f"at {arch}'s shapes, the mma.sync kernels",
                  base.y, yp, dtype, False)
            # the mma.sync kernels' time, and the shipped C entry's (the
            # rule's kernels without the wrapper), in turns
            shipped = _ssd_entry(_build.function("ssd_scan"), c, b, v, la, C)
            extra["mma_sync_ms"] = time_ms(base)
            extra["c_entry_ms"] = time_ms(shipped)
    if repeat:
        check_repeatable("ssd_scan", f"at {arch}'s shapes",
                         lambda *a: ss.ssd_scan_cuda(*a, chunk=C),
                         (c, b, v, la))
    nc = -(-T // C)
    nbytes = c.element_size() * (c.numel() + b.numel() + 2 * v.numel()) \
        + 4 * la.numel() + 4 * B * H * N * P
    flops = ssd_flops(B, H, nc, C, N, P, dtype == torch.bfloat16)
    b_ms, b_by = tc_bound(flops, nbytes, dtype)
    extra["ops_ms"] = 1e3 * (flops / PEAK_BF16 if dtype == torch.bfloat16
                             else 3 * flops / PEAK_TF32)
    extra["bytes_ms"] = 1e3 * nbytes / PEAK_BYTES
    return dict(name="ssd_scan", shapes=f"c/b {tuple(c.shape)}, v "
                f"{tuple(v.shape)} {str(dtype)[6:]}, chunk {C}",
                ms=time_ms(lambda: ss.ssd_scan_cuda(c, b, v, la, chunk=C)),
                plain_ms=time_ms(lambda: ss.ssd_scan_plain(c, b, v, la,
                                                           chunk=C),
                                 iters=2, warmup=1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, rel_err=rel, **extra)


def _device_times(fn, calls: int = 5) -> dict:
    """Device ms a launch of each of the port's kernels (``HAND_KERNELS``)
    that ``calls`` calls of ``fn()`` launch, from a device trace (each
    kernel's device time over the launches the trace recorded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        hand = [k for k in HAND_KERNELS
                if f"::{k}<" in ev.key or f"::{k}(" in ev.key]
        if ev.device_type == DeviceType.CUDA and hand:
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            out[hand[0]] = us / 1e3 / max(ev.count, 1)
    return out


# _scan_device_times's child: the scan at one shape and dtype, inputs
# drawn as _zoo_kernel_times draws them, its device ms a launch by kernel
# as JSON
_SCAN_TIMES_CHILD = """
import json, sys
import numpy as np, torch
import chip_smoke as cs
from repro_torch.kernels import ssd_scan as ss
B, T, H, N, P, C = map(int, sys.argv[1:7])
rng, dt = np.random.default_rng(1), getattr(torch, sys.argv[7])
c, b = (cs.rand(rng, (B, T, H, N), dt, 0.5) for _ in range(2))
v = cs.rand(rng, (B, T, H, P), dt)
la = -torch.nn.functional.softplus(cs.rand(rng, (B, T, H), torch.float32))
fn = lambda: ss.ssd_scan_cuda(c, b, v, la, chunk=C)
print(json.dumps(cs._device_times(fn)))
"""


def _scan_device_times(B, T, H, N, P, C, dtype="bfloat16") -> dict:
    """The scan's device ms a launch by kernel at (B, T, H, N, P, chunk C)
    in ``dtype`` (a torch dtype's name), from ``_device_times`` in a
    child process: in a whole run,
    after the traced prefills and captured decodes, this process's traces
    of the scan held some of its kernels or none, while a fresh process's
    hold each.  The child loads the library this run built."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    run = subprocess.run(
        [sys.executable, "-c", _SCAN_TIMES_CHILD,
         *map(str, (B, T, H, N, P, C)), dtype],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    check(run.returncode == 0,
          f"ssd_scan's device times by kernel in a child process: exit "
          f"{run.returncode} {run.stderr.strip()[-400:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def _log_kernel_times(arch, times, n_launch) -> None:
    lib = "n/a" if times["library_ms"] is None else \
        f"{times['library_ms']:.4f}"
    log(f"  {arch}: {times['name']} at {times['shapes']}: kernel "
        f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, library "
        f"{lib} ms, bound {times['bound_ms']:.4f} ms ({times['bound_by']}), "
        f"launches per prefill {n_launch}"
        + (f"; the C entry {times['c_entry_ms']:.4f} ms"
           if "c_entry_ms" in times else "")
        + (f"; the mma.sync kernel {times['mma_sync_ms']:.4f} ms"
           if "mma_sync_ms" in times else ""))
    if "bytes_ms" in times:
        log(f"    bound by operations {times['ops_ms']:.4f} ms, by bytes "
            f"{times['bytes_ms']:.4f} ms")
    if times.get("by_kernel"):
        log("    device ms a launch by kernel: " + ", ".join(
            f"{k} {ms:.4f}" for k, ms in times["by_kernel"].items()))
    elif "by_kernel" in times:
        log("    device ms a launch by kernel: not measured (the trace "
            "held none of the port's kernels)")


def _held_kernel_calls(run) -> list:
    """``run()`` with every ``ops.flash_attention``/``ops.ssd_scan`` call
    also computed by the layer's plain math (``plain_attention``,
    ``chunked_linear_recurrence``) on the same inputs; returns (kernel,
    error / max|plain|) per call.  The kernel's result is what the model
    goes on with."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    real_fa, real_ssd = ops.flash_attention, ops.ssd_scan
    errs = []

    def fa(q, k, v, *, causal=True, q_offset=0):
        o = real_fa(q, k, v, causal=causal, q_offset=q_offset)
        want = L.plain_attention(q, k, v, causal=causal, q_offset=q_offset)
        errs.append(("flash_attention", norm_err(o, want)[1]))
        return o

    def ssd(c, b, v, log_a, *, initial_state=None, chunk=256):
        y, s = real_ssd(c, b, v, log_a, initial_state=initial_state,
                        chunk=chunk)
        yw, sw = L.chunked_linear_recurrence(c, b, v, log_a, chunk=chunk,
                                             initial_state=initial_state)
        errs.append(("ssd_scan", max(norm_err(y, yw)[1],
                                     norm_err(s, sw)[1])))
        return y, s
    ops.flash_attention, ops.ssd_scan = fa, ssd
    try:
        run()
    finally:
        ops.flash_attention, ops.ssd_scan = real_fa, real_ssd
    return errs


def _recurrent_layers(cfg) -> int:
    """The layers whose decode runs the decode step's kernel: Zamba2's
    Mamba-2 layers, xLSTM's mLSTM blocks (one a pair), none elsewhere."""
    return {"zamba2": cfg.n_layers,
            "xlstm": cfg.n_layers // 2}.get(cfg.block_pattern, 0)


def _serve_full_width(arch, kernel, n_launch, second) -> dict:
    """(a) ``arch`` at its published widths and depth in bf16 with the
    kernels: prefill against the plain path, captured decode against the
    eager step, two generates."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    cfg = dataclasses.replace(get_config(arch), use_kernels=True)
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_par = sum(x.numel() for x in M.tree_leaves(params))
    log(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_par / 1e9:.3f} B parameters ({cfg.dtype}), initialised on the "
        f"card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompts = _zoo_prompts(cfg.vocab)
    max_len = PROMPT_LEN + MAX_NEW
    batch = {"tokens": prompts}

    def prefill(c):
        return M.prefill(c, params, batch, max_len=max_len)
    (logits, cache), counts = _counted(lambda: prefill(cfg))
    want = {name: 0 for name in counts}
    want[kernel] = n_launch
    check(counts == want, f"{arch}: one prefill with the kernels launched "
                          f"{counts} (expected {want})")
    (logits_p, cache_p), counts_p = _counted(lambda: prefill(plain_cfg))
    check(not any(counts_p.values()),
          f"{arch}: the plain prefill launched no kernel ({counts_p})")
    tol, spread = BF16_TOL, None
    if second is not None:
        _, spread, _ = _leaves_err(
            list(prefill(dataclasses.replace(plain_cfg, **second))),
            [logits_p, cache_p])
        tol = max(BF16_TOL, ZOO_SPREAD * spread)
        log(f"  {arch}: two correct plain prefills ({second} against the "
            f"config's) differ by {spread:.3e} of the largest value; bound "
            f"max({BF16_TOL}, {ZOO_SPREAD} x that) = {tol:.3e}")
    worst = _leaves_close(f"{arch} bf16 prefill, kernels against plain",
                          [logits, cache], [logits_p, cache_p], tol)
    del logits_p, cache_p
    held = _held_kernel_calls(lambda: prefill(cfg))
    check(len(held) == n_launch and all(e <= BF16_TOL for _, e in held),
          f"{arch}: each of the prefill's {len(held)} {kernel} calls within "
          f"{BF16_TOL} of the layer's plain math on the same inputs (worst "
          f"{max(e for _, e in held):.3e})")
    light = arch in ZOO_HOST_BOUND
    t_pre = [_wall(lambda: prefill(cfg)) for _ in range(1 if light else 3)]
    t_pre_plain = [_wall(lambda: prefill(plain_cfg))
                   for _ in range(1 if light else 2)]

    # captured decode, step by step against the eager step on the same
    # cache; the decode step's kernel its only launches
    eng = Engine(cfg=cfg, params=params)
    step = eng.decode_step_fn()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    toks, all_bitwise = [], True
    from repro_torch import kernels
    kernels.reset_launch_counts()
    for i in range(MAX_NEW):
        toks.append(tok)
        e_logits, e_cache = M.decode_step(cfg, params, cache, {"tokens": tok})
        logits, cache = step(params, cache, {"tokens": tok})
        same = bitwise_equal(logits, e_logits) and all(
            bitwise_equal(a, b) for a, b in zip(M.tree_leaves(cache),
                                                M.tree_leaves(e_cache)))
        all_bitwise = all_bitwise and same
        if not same:
            log(f"    step {i}: captured differs from eager "
                f"(logits {norm_err(logits, e_logits)})")
        del e_logits, e_cache
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    dec_counts = kernels.launch_counts()
    manual = torch.cat(toks, dim=1)
    check(all_bitwise, f"{arch}: all {MAX_NEW} captured decode steps' logits "
                       "and caches bitwise the eager decode_step's")
    # the decode step's kernel once a recurrent layer a step, in the eager
    # steps and in the captured ones (the first call steps once before
    # the capture, each replay counts what the capture recorded); no
    # other kernel
    want_dec = dict.fromkeys(dec_counts, 0)
    want_dec["ssd_step"] = 2 * MAX_NEW * _recurrent_layers(cfg)
    check(dec_counts == want_dec,
          f"{arch}: {MAX_NEW} eager and {MAX_NEW} captured decode steps "
          f"launched {dec_counts} (expected {want_dec})")
    check(sum(eng.decode_trace_counts.values()) == 1,
          f"{arch}: one capture for the signature "
          f"({list(eng.decode_trace_counts.values())})")

    # decode per token: captured replays against eager steps, in turns
    def decode_loop(captured: bool):
        _, c = prefill(cfg)
        t = tok.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MAX_NEW):
            if captured:
                lg, c = step(params, c, {"tokens": t})
            else:
                lg, c = M.decode_step(cfg, params, c, {"tokens": t},
                                      donate=True)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / MAX_NEW
    d_cap, d_eager = [], []
    for captured in (True, False) if light else (True, False, False, True):
        (d_cap if captured else d_eager).append(decode_loop(captured))

    # where the device time goes: one prefill, then captured steps from
    # the prompt's cache (copied into the graph's on the first)
    _, c0 = prefill(cfg)
    n_traced = min(8, MAX_NEW)

    def decode_steps():
        c = c0
        for _ in range(n_traced):
            _, c = step(params, c, {"tokens": tok})
        torch.cuda.synchronize()
    busy = (None if light else _trace_call(
                f"{arch} prefill (kernels)",
                lambda: (prefill(cfg), torch.cuda.synchronize()), top=8),
            _trace_call(f"{arch} {n_traced} captured decode steps",
                        decode_steps, top=8))
    del c0

    # the user's entry point: two same-shape generates
    walls, outs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(eng.generate(prompts, max_new=MAX_NEW))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(torch.equal(outs[0], outs[1]) and torch.equal(outs[0], manual),
          f"{arch}: two generates give the same {tuple(outs[0].shape)} "
          "tokens as the checked loop")
    check(sum(eng.decode_trace_counts.values()) == 1
          and len(eng.decode_trace_counts) == 1,
          f"{arch}: two same-shape generates captured once "
          f"({eng.decode_trace_counts and list(eng.decode_trace_counts.values())})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng.release()
    times = _zoo_kernel_times(arch, cfg)
    res = dict(arch=arch, prefill_ms=[1e3 * t for t in t_pre],
               plain_prefill_ms=[1e3 * t for t in t_pre_plain],
               decode_ms_captured=d_cap, decode_ms_eager=d_eager,
               generate_s=walls,
               tok_per_s=[N_PROMPTS * MAX_NEW / w for w in walls],
               peak_gib=peak, prefill_err=worst, spread=spread, busy=busy,
               call_err=max(e for _, e in held), kernel=times,
               first_tokens=outs[0][0, :8].tolist(),
               decode_launches=dec_counts)
    log(f"  {arch}: prefill ms (kernels) {[round(t, 2) for t in res['prefill_ms']]}, "
        f"plain {[round(t, 2) for t in res['plain_prefill_ms']]}; decode "
        f"ms/token captured {[round(t, 3) for t in d_cap]}, eager "
        f"{[round(t, 3) for t in d_eager]}; generate({N_PROMPTS} x "
        f"{PROMPT_LEN}, {MAX_NEW} new) {[round(w, 3) for w in walls]} s = "
        f"{[round(x, 1) for x in res['tok_per_s']]} tok/s; peak "
        f"{peak:.2f} GiB; first tokens {res['first_tokens']}")
    _log_kernel_times(arch, times, n_launch)
    del params, cache, eng, step
    torch.cuda.empty_cache()
    return res


def _f32_prefill(arch, depth) -> float:
    """(a) f32 at full width and ``depth`` layers: the kernel prefill
    against the plain one within the reference's f32 bound."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                              dtype="float32", use_kernels=True)
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    batch = {"tokens": _zoo_prompts(cfg.vocab)}
    got = M.prefill(cfg, params, batch, max_len=PROMPT_LEN + MAX_NEW)
    want = M.prefill(dataclasses.replace(cfg, use_kernels=False), params,
                     batch, max_len=PROMPT_LEN + MAX_NEW)
    worst = _leaves_close(f"{arch} f32, {depth} layers, prefill kernels "
                          "against plain", list(got), list(want), ZOO_F32_TOL)
    del params, got, want
    torch.cuda.empty_cache()
    return worst


def _zoo_batch(cfg, B, T, rng):
    import torch
    b = {}
    if cfg.block_pattern == "encdec" or cfg.modality_stub:
        b["embeds"] = rand(rng, (B, T, cfg.d_model), torch.float32, 0.1)
    if cfg.block_pattern == "encdec" or not cfg.modality_stub:
        b["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab, (B, T), dtype="int32")).to("cuda")
    return b


def _reduced_arch(arch) -> dict:
    """(b) ``arch`` reduced on the card: prefill and decode steps with the
    kernels against without, in f32."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch).reduced(), use_kernels=True)
    plain = dataclasses.replace(cfg, use_kernels=False)
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    B, T = 2, 64
    b = _zoo_batch(cfg, B, T + ZOO_DECODE_STEPS, rng)
    if cfg.block_pattern == "encdec":
        pre = {"embeds": b["embeds"], "tokens": b["tokens"][:, :T]}
    else:
        pre = {k: v[:, :T] for k, v in b.items()}
    max_len = T + ZOO_DECODE_STEPS
    (lk, ck), counts = _counted(lambda: M.prefill(cfg, params, pre, max_len))
    lp, cp = M.prefill(plain, params, pre, max_len)
    bp = cfg.block_pattern
    want = {name: 0 for name in counts}
    if bp in ("dense", "moe"):
        want["flash_attention"] = cfg.n_layers
    elif bp == "zamba2":
        want["ssd_scan"] = cfg.n_layers
    elif bp == "xlstm":
        want["ssd_scan"] = cfg.n_layers // 2
    check(counts == want, f"{arch} reduced: prefill launched {counts}")
    ok, worst, n = _leaves_err([lk, ck], [lp, cp])
    dec_k, dec_p = {}, {}
    for t in range(T, T + ZOO_DECODE_STEPS):
        if cfg.modality_stub and bp != "encdec":
            step = {"embeds": b["embeds"][:, t:t + 1]}
        else:
            step = {"tokens": b["tokens"][:, t:t + 1]}
        (lk, ck), nk = _counted(
            lambda: M.decode_step(cfg, params, ck, step, donate=True))
        (lp, cp), np_ = _counted(
            lambda: M.decode_step(plain, params, cp, step, donate=True))
        dec_k = {k: dec_k.get(k, 0) + v for k, v in nk.items()}
        dec_p = {k: dec_p.get(k, 0) + v for k, v in np_.items()}
        ok_t, worst_t, _ = _leaves_err([lk, ck], [lp, cp])
        ok, worst = ok and ok_t, max(worst, worst_t)
    want_k = dict.fromkeys(dec_k, 0)
    want_k["ssd_step"] = ZOO_DECODE_STEPS * _recurrent_layers(cfg)
    check(dec_k == want_k and not any(dec_p.values()),
          f"{arch} reduced: {ZOO_DECODE_STEPS} decode steps launched "
          f"{dec_k} with the kernels (expected {want_k}), {dec_p} without")
    check(ok and worst <= ZOO_F32_TOL,
          f"{arch} reduced: prefill and {ZOO_DECODE_STEPS} decode steps "
          f"with kernels against without, {n} leaves each, finite, worst "
          f"error / max|value| {worst:.3e} <= {ZOO_F32_TOL:g}")
    return dict(counts=counts, worst=worst, decode_launches=dec_k)


# The zoo's kernel shapes the kernels took last (phase 8 (c)): StableLM-12B's
# attention at d_head 160 and xLSTM-125M's mLSTM scan at N 384 / P 385, in
# bf16 and f32, at each arch's prefill shapes
# the attention at each head width of the zoo's dense archs (d_head 64,
# 128, 160) and the widest scan
ZOO_SHAPES = ("llama3.2-1b", "qwen3-8b", "stablelm-12b", "zamba2-2.7b",
              "xlstm-125m")
# StableLM-12B's kernel prefill against its plain one at full width, cut
# to this many of its 40 layers (the phase's time)
STABLELM_DEPTH = 4


def _zoo_kernel_shapes(env: dict) -> list:
    """(c) each kernel at the zoo's widest call shapes against its plain
    version, bitwise run to run, with its times (the f32 attention beside
    mma.sync kernel, phase 1's ``attn_baseline``); a shape beyond
    the kernels still raises and launches nothing."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    import numpy as np
    rows = []
    for arch in ZOO_SHAPES:
        cfg = get_config(arch)
        for dtype in (torch.bfloat16, torch.float32):
            kernels.reset_launch_counts()
            t = _zoo_kernel_times(arch, cfg, dtype, repeat=True,
                                  attn_baseline=env.get("attn_baseline"),
                                  ssd_baseline=env.get("ssd_baseline"))
            torch.cuda.synchronize()
            t["launches"] = kernels.launch_counts()[t["name"]]
            t["arch"], t["dtype"] = arch, str(dtype)[6:]
            _log_kernel_times(arch, t, "-")
            rows.append(t)
    rng = np.random.default_rng(2)
    wide = rand(rng, (1, 64, 1, ss.MAX_STATE + 16), torch.bfloat16)
    cases = {
        f"ssd_scan at N = {ss.MAX_STATE + 16} (> {ss.MAX_STATE})":
            lambda: ops.ssd_scan(wide, wide, wide,
                                 -torch.ones((1, 64, 1), device="cuda")),
        "flash_attention at D = 96 (no kernel instantiation)":
            lambda: ops.flash_attention(
                rand(rng, (1, 64, 4, 96), torch.bfloat16),
                rand(rng, (1, 64, 2, 96), torch.bfloat16),
                rand(rng, (1, 64, 2, 96), torch.bfloat16)),
    }
    for label, fn in cases.items():
        kernels.reset_launch_counts()
        try:
            fn()
            raised = None
        except ValueError as e:
            raised = e
        torch.cuda.synchronize()
        check(raised is not None and not any(kernels.launch_counts().values()),
              f"no fallback: {label} raises ValueError ({raised})")
    return rows


def _stablelm_prefill() -> dict:
    """(a) StableLM-12B at full width, cut to STABLELM_DEPTH layers: the
    kernel prefill (d_head 160 attention) against the plain one, in bf16
    within the bucket (each kernel call too) and in f32 within
    ZOO_F32_TOL."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    full = get_config("stablelm-12b")
    out = {}
    for dtype, tol in (("bfloat16", BF16_TOL), ("float32", ZOO_F32_TOL)):
        cfg = dataclasses.replace(full, n_layers=STABLELM_DEPTH, dtype=dtype,
                                  use_kernels=True)
        log(f"  stablelm-12b {dtype}: full width (d_model {cfg.d_model}, "
            f"d_head {cfg.d_head}, {cfg.n_heads}/{cfg.n_kv_heads} heads), "
            f"depth cut to {STABLELM_DEPTH} of {full.n_layers} layers")
        params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        batch = {"tokens": _zoo_prompts(cfg.vocab)}

        def prefill(c):
            return M.prefill(c, params, batch, max_len=PROMPT_LEN + MAX_NEW)
        got, counts = _counted(lambda: prefill(cfg))
        check(counts["flash_attention"] == STABLELM_DEPTH
              and not counts["ssd_scan"] and not counts["expert_glu"],
              f"stablelm-12b {dtype}: one prefill launched {counts}")
        want = prefill(dataclasses.replace(cfg, use_kernels=False))
        worst = _leaves_close(f"stablelm-12b {dtype}, {STABLELM_DEPTH} "
                              "layers, prefill kernels against plain",
                              list(got), list(want), tol)
        del got, want
        held = _held_kernel_calls(lambda: prefill(cfg))
        call_tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
        check(len(held) == STABLELM_DEPTH
              and all(e <= call_tol for _, e in held),
              f"stablelm-12b {dtype}: each of the prefill's {len(held)} "
              f"flash_attention calls within {call_tol} of the layer's plain "
              f"math (worst {max(e for _, e in held):.3e})")
        out[dtype] = dict(worst=worst, call_err=max(e for _, e in held),
                          prefill_ms=[1e3 * _wall(lambda: prefill(cfg))
                                      for _ in range(2)])
        del params
        torch.cuda.empty_cache()
    log(f"  stablelm-12b: prefill ms (kernels, {STABLELM_DEPTH} layers) "
        f"bf16 {[round(t, 2) for t in out['bfloat16']['prefill_ms']]}, "
        f"f32 {[round(t, 2) for t in out['float32']['prefill_ms']]}")
    return out


def phase_zoo(env: dict) -> dict:
    """The model zoo: Llama-3.2-1B, Zamba2-2.7B and xLSTM-125M served at
    full width, StableLM-12B's prefill at full width and cut depth (a),
    every arch reduced (b), and the zoo's kernel shapes (c)."""
    from repro_torch.configs import ALL_ARCHS
    log("== phase 8: model zoo serving on the card")
    log(env["card"])
    t0 = time.perf_counter()
    full = {arch: _serve_full_width(arch, kernel, n, second)
            for arch, kernel, n, second in ZOO_FULL}
    f32 = {(arch, d): _f32_prefill(arch, d)
           for arch, depths in ZOO_F32_DEPTH.items() for d in depths}
    stablelm = _stablelm_prefill()
    log(f"  (a) done in {time.perf_counter() - t0:.1f} s; f32 worst errors "
        + ", ".join(f"{a} {d} layers {e:.2e}" for (a, d), e in f32.items())
        + f"; stablelm-12b ({STABLELM_DEPTH} layers) bf16 "
        f"{stablelm['bfloat16']['worst']:.2e}, f32 "
        f"{stablelm['float32']['worst']:.2e}")
    t1 = time.perf_counter()
    reduced = {arch: _reduced_arch(arch) for arch in ALL_ARCHS}
    log(f"  (b) every arch reduced in {time.perf_counter() - t1:.1f} s: "
        + ", ".join(f"{a} {r['worst']:.1e}" for a, r in reduced.items()))
    t2 = time.perf_counter()
    shapes = _zoo_kernel_shapes(env)
    steps = _ssd_step_shapes()
    log(f"  (c) the zoo's kernel shapes in "
        f"{time.perf_counter() - t2:.1f} s")
    log(f"  phase 8 in {time.perf_counter() - t0:.1f} s")
    return dict(full=full, f32=f32, reduced=reduced, stablelm=stablelm,
                shapes=shapes, steps=steps)


# One child process's prefill timing (prefill_turns): one arch of the zoo
# at its published widths and depth (or the first `layers`) in a dtype with
# the kernels, phase 8's batch; one warm-up prefill, then three timed.
# Only entry points that every slice of the port has: it runs on an
# earlier checkout too.
_PREFILL_CHILD = """
import dataclasses, json, sys, time
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.models import model as M
arch, dtype = sys.argv[1], sys.argv[2]
B, T, new, layers = map(int, sys.argv[3:])
cfg = dataclasses.replace(get_config(arch), use_kernels=True, dtype=dtype)
if layers:
    cfg = dataclasses.replace(cfg, n_layers=layers)
params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
tokens = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab, (B, T), dtype=np.int32)).to("cuda")
def run():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M.prefill(cfg, params, {"tokens": tokens}, max_len=T + new)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)
run()
print(json.dumps({"ms": [run() for _ in range(3)]}))
"""


def prefill_turns(parent, arch: str = "zamba2-2.7b",
                  dtype: str = "bfloat16", layers: int = 0) -> dict:
    """``arch``'s prefill in ``dtype`` with the kernels (phase 8's batch;
    its first ``layers`` layers where that is not 0, for a model whose
    whole depth does not fit the card, as StableLM-12B's in f32 does not)
    timed in child processes of ``parent`` (the root of another checkout
    inside this one, such as the parent commit unpacked into a directory
    that .gitignore lists) and of this checkout, in turns parent, change,
    change, parent, all on the same card: each child builds its
    checkout's kernels (under that checkout) and times three prefills
    after a warm-up.  Not part of the run with no arguments; call it as
    ``python3 -c 'import chip_smoke as c; c.prefill_turns("DIR")'``.
    Returns {"parent": [ms, ...], "change": [ms, ...]}."""
    import torch
    roots = {"parent": Path(parent).resolve(), "change": ROOT}
    check(roots["parent"].is_relative_to(ROOT)
          and (roots["parent"] / "src" / "repro_torch").is_dir(),
          f"{parent}: a checkout inside {ROOT}")
    depth = f", {layers} layers" if layers else ""
    log(f"== {arch} {dtype} prefill{depth}, the parent's kernels against "
        "this checkout's (parent, change, change, parent)")
    out = {"parent": [], "change": []}
    for which in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=str(roots[which] / "src"))
        run = subprocess.run(
            [sys.executable, "-c", _PREFILL_CHILD, arch, dtype,
             str(N_PROMPTS), str(PROMPT_LEN), str(MAX_NEW), str(layers)],
            cwd=roots[which], env=env, capture_output=True, text=True,
            timeout=900)
        check(run.returncode == 0,
              f"{arch} prefill of the {which} ({roots[which]}): exit "
              f"{run.returncode} {run.stderr.strip()[-400:]}")
        ms = json.loads(run.stdout.strip().splitlines()[-1])["ms"]
        out[which] += ms
        log(f"  {which}: prefill ms {[round(t, 2) for t in ms]}")
    log(f"  {arch} {dtype} prefill{depth} on "
        f"{torch.cuda.get_device_name(0)}: parent "
        f"{min(out['parent']):.2f}-{max(out['parent']):.2f} ms, change "
        f"{min(out['change']):.2f}-{max(out['change']):.2f} ms")
    return out


# One child process's f32 and bf16 scans (scan_bits_turns): inputs drawn
# on the card from a seeded generator, a digest of each call's y and final
# state as JSON
_SCAN_BITS_CHILD = """
import hashlib, json, sys
import torch
from repro_torch.kernels import ssd_scan as ss
out = {}
for label, (B, T, H, N, P, C, dt, with_s0) in json.loads(sys.argv[1]).items():
    g = torch.Generator(device="cuda").manual_seed(7)
    dtype = getattr(torch, dt)
    c, b = ((0.5 * torch.randn(B, T, H, N, device="cuda", generator=g)).to(
        dtype) for _ in range(2))
    v = torch.randn(B, T, H, P, device="cuda", generator=g).to(dtype)
    la = -torch.nn.functional.softplus(torch.randn(B, T, H, device="cuda",
                                                   generator=g))
    s0 = torch.randn(B, H, N, P, device="cuda", generator=g) \\
        if with_s0 else None
    y, s = ss.ssd_scan_cuda(c, b, v, la, initial_state=s0, chunk=C)
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for t in (y, s):
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    out[label] = digest.hexdigest()
out["module"] = ss.__file__
print(json.dumps(out))
"""
# (B, T, H, N, P, chunk, dtype, initial state): the main path's f32 scan,
# Zamba2-2.7B's prefill scan in f32 and bf16, and the mLSTM's in bf16,
# which a change to the f32 design above N = 64 leaves as they were; the
# mLSTM's f32 call, which such a change moves
SCAN_BITS_CASES = {
    "main path f32": (1, 1024, 16, 64, 64, 64, "float32", False),
    "main path f32, initial_state": (1, 1024, 16, 64, 64, 64, "float32",
                                     True),
    "Zamba2-2.7B f32": (4, 1024, 80, 64, 64, 256, "float32", False),
    "Zamba2-2.7B bf16": (4, 1024, 80, 64, 64, 256, "bfloat16", False),
    "mLSTM bf16": (4, 1024, 4, 384, 385, 256, "bfloat16", False),
    "mLSTM f32": (4, 1024, 4, 384, 385, 256, "float32", False),
}


def scan_bits_turns(parent, moved=("mLSTM f32",)) -> dict:
    """Whether the scan gives the parent's bits: each case of
    ``SCAN_BITS_CASES`` in child processes of ``parent`` (the root of
    another checkout inside this one, such as the parent commit unpacked
    into a directory that .gitignore lists) and of this checkout, in turns
    parent, change, change, parent, on the same card (each child builds
    its checkout's kernels); every case but those in ``moved`` must give
    the same digest of y and the final state in all four, and every case
    the same in the two turns of each checkout.  Not part of the run with
    no arguments; call it as ``python3 -c 'import chip_smoke as c;
    c.scan_bits_turns("DIR")'``.  Returns {"parent": [digests, ...],
    "change": [...]}."""
    roots = {"parent": Path(parent).resolve(), "change": ROOT}
    check(roots["parent"].is_relative_to(ROOT)
          and (roots["parent"] / "src" / "repro_torch").is_dir(),
          f"{parent}: a checkout inside {ROOT}")
    log("== the scan's bits, the parent's kernels against this checkout's "
        "(parent, change, change, parent)")
    out = {"parent": [], "change": []}
    for which in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=str(roots[which] / "src"))
        run = subprocess.run(
            [sys.executable, "-c", _SCAN_BITS_CHILD,
             json.dumps(SCAN_BITS_CASES)], cwd=roots[which], env=env,
            capture_output=True, text=True, timeout=900)
        check(run.returncode == 0,
              f"the scans of the {which} ({roots[which]}): exit "
              f"{run.returncode} {run.stderr.strip()[-400:]}")
        got = json.loads(run.stdout.strip().splitlines()[-1])
        module = Path(got.pop("module")).resolve()
        check(module.is_relative_to(roots[which] / "src"),
              f"the {which}'s scans ran its own module ({module})")
        out[which].append(got)
    for label in SCAN_BITS_CASES:
        digests = {which: {d[label] for d in out[which]} for which in out}
        same = digests["parent"] == digests["change"]
        log(f"  {label}: parent {sorted(digests['parent'])[0][:16]}, change "
            f"{sorted(digests['change'])[0][:16]}: "
            + ("the same bits" if same else "other bits"))
        check(all(len(d) == 1 for d in digests.values()),
              f"ssd_scan {label}: each checkout's two turns bitwise equal")
        if label not in moved:
            check(same, f"ssd_scan {label}: bitwise the parent's")
    return out


# One child process's timing of the main path (route_turns): phase 3's
# chain at GRANITE_MAIN_PATH with every op on `cuda-kernels`, one captured
# segment (the planned route); two cold runs (the probe, the capture), then
# warm runs fenced on the card.  Only entry points that every slice of
# the port since the capture has: it runs on an earlier checkout too.
_ROUTE_CHILD = """
import json, sys, time
import torch
from repro_torch.core import GRANITE_MAIN_PATH, ScheduleExecutor, kernel_chain
from repro_torch.core.backends import default_registry
from repro_torch.core.profiler import fence
lane = "cuda-kernels"
graph, ext = kernel_chain(seed=0, **GRANITE_MAIN_PATH)
ex = ScheduleExecutor([lane], targets={lane: default_registry().get(lane)})
prog = ex.compile_scheduled(graph, {i: lane for i in range(len(graph))})
def run():
    t0 = time.perf_counter()
    fence(list(prog.run(ext).values()))
    return 1e3 * (time.perf_counter() - t0)
run(); run()
ms = [run() for _ in range(int(sys.argv[1]))]
print(json.dumps({"ms": ms, "captured": [s.mode for s in prog.segments]}))
"""


def route_turns(parent, runs: int = CAPTURE_REPEATS) -> dict:
    """Phase 3's captured main-path route (every op on `cuda-kernels`,
    one captured segment) timed in child processes of ``parent`` (the
    root of another checkout inside this one, such as the parent commit
    unpacked into a directory that .gitignore lists) and of this
    checkout, in turns parent, change, change, parent, on the same card;
    each child builds its checkout's kernels and times ``runs`` warm runs.
    Not part of the run with no arguments; call it as ``python3 -c
    'import chip_smoke as c; c.route_turns("DIR")'``.  Returns
    {"parent": [ms, ...], "change": [ms, ...]}."""
    import torch
    roots = {"parent": Path(parent).resolve(), "change": ROOT}
    check(roots["parent"].is_relative_to(ROOT)
          and (roots["parent"] / "src" / "repro_torch").is_dir(),
          f"{parent}: a checkout inside {ROOT}")
    log("== the main path's captured route, the parent's kernels against "
        "this checkout's (parent, change, change, parent)")
    out = {"parent": [], "change": []}
    for which in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=str(roots[which] / "src"))
        run = subprocess.run([sys.executable, "-c", _ROUTE_CHILD, str(runs)],
                             cwd=roots[which], env=env, capture_output=True,
                             text=True, timeout=900)
        check(run.returncode == 0,
              f"main path of the {which} ({roots[which]}): exit "
              f"{run.returncode} {run.stderr.strip()[-400:]}")
        got = json.loads(run.stdout.strip().splitlines()[-1])
        out[which] += got["ms"]
        log(f"  {which}: segments {got['captured']}, median "
            f"{_median(got['ms']):.3f} ms, runs "
            f"{[round(t, 3) for t in got['ms']]}")
    log(f"  main path's captured route on {torch.cuda.get_device_name(0)}: "
        f"parent {min(out['parent']):.3f}-{max(out['parent']):.3f} ms "
        f"(median {_median(out['parent']):.3f}), change "
        f"{min(out['change']):.3f}-{max(out['change']):.3f} ms (median "
        f"{_median(out['change']):.3f})")
    return out


# ---------------------------------------------------------------------------
# phase 9: training at full width
# ---------------------------------------------------------------------------

TRAIN_ARCH = "llama3.2-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 6
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 3, 4
TRAIN_BUDGET_S = 300.0       # phase 9's share of the script's time limit
TRAIN_CKPT_DIR = ROOT / "build" / "ckpt" / "chip_smoke"


def _train_args(ckpt_dir) -> list:
    """``launch.train``'s arguments for phase 9's run (its defaults: lr
    1e-3, warmup 10, seed 0)."""
    return ["--device", "cuda", "--reduced", "0", "--arch", TRAIN_ARCH,
            "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--ckpt-every", str(TRAIN_CKPT_EVERY),
            "--ckpt-dir", str(ckpt_dir), "--log-every", "1"]


def _train_batch(source, i) -> dict:
    import torch
    return {k: torch.from_numpy(v).to("cuda") for k, v in source(i).items()}


def phase_train(env: dict) -> dict:
    """Llama-3.2-1B trained at its published widths and depth (bf16
    params, f32 AdamW state, remat on, batch 8 x 1024): (a) 6 steps
    uninterrupted; (b) the same 6 steps through ``launch.train.main``
    with a checkpoint every 3 and a ``RecoverableError`` injected at step
    4, which restores step 3's checkpoint and goes on: its losses and
    final checkpoint bitwise (a)'s; (c) one step with top-k compression
    and one with 2 microbatches."""
    import dataclasses
    import math
    import shutil
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenSource
    from repro_torch.fault.manager import RecoverableError
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import CompressionConfig, init_residual
    from repro_torch.train import trainer as T

    log("== phase 9: training at full width on the card")
    log(env["card"])
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    source = SyntheticTokenSource(DataConfig(
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab=cfg.vocab,
        seed=0))
    # launch.train's optimizer for --steps TRAIN_STEPS, --lr 1e-3
    tc = T.TrainConfig(opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                                             total_steps=TRAIN_STEPS))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    n_par = sum(x.numel() for x in M.tree_leaves(params))
    opt = adamw.init_state(tc.opt, params)
    log(f"  {TRAIN_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_par / 1e9:.3f} B parameters ({cfg.dtype}), AdamW state "
        f"{tc.opt.state_dtype}, remat {cfg.remat}, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}")
    step = T.make_train_step(cfg, tc)

    # (a) uninterrupted; the params after MESH_TRAIN_STEPS steps are kept
    # for phase 10's step on the mesh
    losses, step_s = [], []
    with T.deterministic_training():
        for i in range(TRAIN_STEPS):
            batch = _train_batch(source, i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))        # waits for the card
            step_s.append(time.perf_counter() - t)
            if i + 1 == MESH_TRAIN_STEPS:
                params_at = M.tree_map(lambda x: x.detach().clone(), params)
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = _trace_call(f"{TRAIN_ARCH} train step",
                           lambda: (step(params, opt, batch),
                                    torch.cuda.synchronize()), top=10)
    check(all(map(math.isfinite, losses)),
          f"(a) {TRAIN_STEPS} steps uninterrupted: losses finite "
          f"{[round(x, 4) for x in losses]}")
    warm = sorted(step_s[1:])
    med = warm[len(warm) // 2]
    share = 6 * n_par * tokens / med / PEAK_BF16
    log(f"  (a) step s {[round(x, 3) for x in step_s]}; median warm "
        f"{1e3 * med:.1f} ms = {tokens / med:.0f} tokens/s; 6 x params x "
        f"tokens / step time = {100 * share:.1f}% of the bf16 peak "
        f"(989 TFLOP/s); peak memory {peak:.2f} GiB")
    want_params = M.tree_map(lambda x: x.detach().clone(), params)
    del opt, params, batch, met
    torch.cuda.empty_cache()

    # (b) the train driver, a fault injected at step TRAIN_FAIL_AT
    fired, io = [], {"save": [], "restore": []}

    class FailsOnce(SyntheticTokenSource):
        def __call__(self, i):
            if i == TRAIN_FAIL_AT and not fired:
                fired.append(i)
                raise RecoverableError(f"injected at step {i}")
            return super().__call__(i)

    def timed(kind, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            io[kind].append(time.perf_counter() - t)
            return out
        return run

    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    real = (launch_train.SyntheticTokenSource, ckpt.save, ckpt.restore)
    launch_train.SyntheticTokenSource = FailsOnce
    ckpt.save, ckpt.restore = timed("save", ckpt.save), \
        timed("restore", ckpt.restore)
    try:
        res = launch_train.main(_train_args(TRAIN_CKPT_DIR))
    finally:
        launch_train.SyntheticTokenSource, ckpt.save, ckpt.restore = real
    stats = res["stats"]
    got = res["losses"]
    check(fired == [TRAIN_FAIL_AT] and stats.restarts == 1
          and stats.failures_detected == 1 and len(got) == TRAIN_STEPS + 1,
          f"(b) launch.train: the fault at step {TRAIN_FAIL_AT} fired once, "
          f"one restart ({stats}), {len(got)} steps run")
    redo = TRAIN_CKPT_EVERY          # the step the restart resumed at
    check(got[:redo + 1] + got[redo + 2:] == losses
          and got[redo + 1] == losses[redo],
          f"(b) the resumed run's losses are bitwise the uninterrupted "
          f"run's (step {redo} run twice: {got[redo]!r}, {got[redo + 1]!r})")
    kept = sorted(os.listdir(TRAIN_CKPT_DIR))
    check(kept == [f"step_{TRAIN_CKPT_EVERY:08d}", f"step_{TRAIN_STEPS:08d}"],
          f"(b) checkpoints {kept}")
    target = {"params": M.param_shapes(cfg)}
    target["opt"] = adamw.init_state(tc.opt, target["params"])
    final, extra = ckpt.restore(str(TRAIN_CKPT_DIR), target, device="cuda")
    check(extra == {"data": {"step": TRAIN_STEPS, "seed": 0}}
          and all(bitwise_equal(a, b) for a, b in zip(
              M.tree_leaves(final["params"]), M.tree_leaves(want_params)))
          and int(final["opt"]["step"]) == TRAIN_STEPS,
          f"(b) the final checkpoint round-trips to the uninterrupted run's "
          f"params, bitwise ({len(M.tree_leaves(want_params))} leaves), "
          f"step {int(final['opt']['step'])}")
    log(f"  (b) checkpoint save s {[round(x, 2) for x in io['save']]}, "
        f"restore s {[round(x, 2) for x in io['restore']]} "
        f"({sum(x.numel() * x.element_size() for x in M.tree_leaves(final)) / 2**30:.2f} GiB)")
    del final, want_params
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) one step with top-k compression (the loss is taken before the
    # gradient is compressed: the plain step's, bitwise), one with 2
    # microbatches (the mean of the halves' losses)
    other = {}
    for label, tc2, tol in (
            ("compress k_frac 0.1", dataclasses.replace(
                tc, compress=CompressionConfig(k_frac=0.1)), 0.0),
            ("2 microbatches", dataclasses.replace(tc, microbatches=2),
             1e-3)):
        params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        opt = adamw.init_state(tc2.opt, params)
        if tc2.compress is not None:
            opt = {"opt": opt, "residual": init_residual(params)}
        step2 = T.make_train_step(cfg, tc2)
        with T.deterministic_training():
            batch = _train_batch(source, 0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, met = step2(params, opt, batch)
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            dt = time.perf_counter() - t
        check(math.isfinite(loss) and math.isfinite(gnorm)
              and abs(loss - losses[0]) <= tol * abs(losses[0]),
              f"(c) one step with {label}: loss {loss!r} (grad norm "
              f"{gnorm:.4f}) finite, within {tol:g} of the plain step's "
              f"{losses[0]!r}, {dt:.2f} s")
        other[label] = dict(loss=loss, s=dt)
        del params, opt, batch, met
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    check(wall <= TRAIN_BUDGET_S,
          f"phase 9 in {wall:.1f} s (budget {TRAIN_BUDGET_S:.0f} s)")
    return dict(losses=losses, step_s=step_s, median_s=med,
                tok_per_s=tokens / med, share=share, peak_gib=peak,
                busy=busy, save_s=io["save"], restore_s=io["restore"],
                other=other, wall=wall, params_at=params_at)


# ---------------------------------------------------------------------------
# phase 10: the mesh
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 3
MESH_DECODE_STEPS = 4
MESH_BUDGET_S = 360.0        # phase 10's share of the script's time limit
# (arch, graph kind, batch, seq) of the autoshard runs: the reference's
# example cell and a decode cell of the largest config
AUTOSHARD_CELLS = (("granite-moe-1b-a400m", "train", 256, 4096),
                   ("deepseek-v3-671b", "decode", 128, 32768))
# the spread of HOP_LAT's readings (a one-rank NCCL all-reduce, seconds)
# behind core/autoshard.py's median: autoshard is solved at both ends too
HOP_SPREAD = (2.61e-5, 8.95e-5)
DRYRUN_CELLS = (("llama3.2-1b", "train_4k", False),
                ("deepseek-v3-671b", "decode_32k", True))
DRYRUN_BUDGET_S = 60.0       # wall seconds of one dry-run cell
CARD_GIB = 80.0
# The reference's compiled record of the same cells: repro.launch.dryrun
# (XLA on 512 host devices of an 8-core CPU container, JAX 0.9.0)
# through the production mesh with Auto axes (its jax.make_mesh now makes
# Explicit ones, which its sharding constraints refuse), as
# ``PYTHONPATH=src python tests/test_torch_dryrun.py --production`` prints
# them; PERF.md, the dry-run table.  GiB a device (argument + output +
# temp), collective B a chip by kind, FLOPs a chip.  The card has no JAX,
# so they are constants.
DRYRUN_REFERENCE = {
    "llama3.2-1b|train_4k|16x16": (
        15.5136, {"all-gather": 4.4507e9, "all-reduce": 8.5068e10,
                  "all-to-all": 5.0332e8, "collective-permute": 2.1475e10},
        4.6307e13),
    "deepseek-v3-671b|decode_32k|2x16x16": (
        51.9831, {"all-gather": 3.5096e9, "all-reduce": 2.9118e8,
                  "all-to-all": 3.9935e8, "collective-permute": 2.7022e8},
        1.6195e11),
}
# the port's GiB a device is held within this multiple of the reference's
DRYRUN_GIB_CEILING = 2.0
# the port's collective B a chip, total over kinds, is held within these
# multiples of the reference's total: 1.1x the ratios this phase measured
# once the attention's k/v gradients stayed partial sums and the
# projections' column blocks were exchanged, not gathered, 0.3811 and
# 0.2143 (0.5142 and 0.2143 before, 0.5162 before sharding.select_layer
# fetched a layer by broadcast; PERF.md)
DRYRUN_COLL_CEILING = {
    "llama3.2-1b|train_4k|16x16": 0.42,
    "deepseek-v3-671b|decode_32k|2x16x16": 0.236,
}
# the collective kinds that sharding.select_layer alone issues (a layer's
# broadcast from its owner, its gradient's reduce to it)
SELECT_LAYER_KINDS = ("broadcast", "reduce")


def _local_leaves(tree) -> list:
    from repro_torch.models import model as M
    return [x.full_tensor() if hasattr(x, "full_tensor") else x
            for x in M.tree_leaves(tree)]


def _mesh_against(label, got, want) -> bool:
    """Every leaf of ``got`` (a tree on the mesh) bitwise ``want``'s;
    logs the largest difference where one is not."""
    g, w = _local_leaves(got), _local_leaves(want)
    same = len(g) == len(w) and all(bitwise_equal(a, b) for a, b in zip(g, w))
    if not same:
        worst = max((norm_err(a, b)[1], i) for i, (a, b) in
                    enumerate(zip(g, w)) if a.shape == b.shape)
        log(f"    {label}: not bitwise; largest difference over the "
            f"largest value {worst[0]:.3e} at leaf {worst[1]}")
    return same


def _mesh_train(train: dict, mesh) -> dict:
    """(a) Llama-3.2-1B's phase 9 step through ``jit_train_step`` with
    ``Policy(mesh, fsdp=True)`` for MESH_TRAIN_STEPS steps on phase 9's
    batches: losses and params against phase 9's unsharded steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenSource
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.sharding import Policy
    from repro_torch.train import trainer as T

    cfg = get_config(TRAIN_ARCH)
    source = SyntheticTokenSource(DataConfig(
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab=cfg.vocab,
        seed=0))
    tc = T.TrainConfig(opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                                             total_steps=TRAIN_STEPS))
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    opt = adamw.init_state(tc.opt, params)
    step = T.jit_train_step(cfg, tc, Policy(mesh=mesh, fsdp=True),
                            M.param_shapes(cfg), _train_batch(source, 0))
    losses, step_s = [], []
    with T.deterministic_training():
        for i in range(MESH_TRAIN_STEPS):
            batch = _train_batch(source, i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"].full_tensor()))
            step_s.append(time.perf_counter() - t)
    want = train["losses"][:MESH_TRAIN_STEPS]
    bitwise = losses == want and _mesh_against(
        "(a) params", params, train["params_at"])
    if bitwise:
        check(True, f"(a) {MESH_TRAIN_STEPS} steps of jit_train_step on the "
                    f"{tuple(mesh.shape)} mesh: losses {losses} and every "
                    "param bitwise phase 9's unsharded steps")
    else:
        rel = max(norm_err(a, b)[1] for a, b in zip(
            _local_leaves(params), M.tree_leaves(train["params_at"])))
        log(f"    (a) losses {losses} against phase 9's {want}")
        check(rel <= 1e-6 and all(abs(a - b) <= 1e-6 * abs(b)
                                  for a, b in zip(losses, want)),
              f"(a) not bitwise (above); losses and params within 1e-6 "
              f"relative of phase 9's (params {rel:.3e})")
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    log(f"  (a) step s on the mesh {[round(x, 3) for x in step_s]}, median "
        f"warm {1e3 * med:.1f} ms against phase 9's unsharded "
        f"{1e3 * train['median_s']:.1f} ms")
    del params, opt, met, train["params_at"]
    torch.cuda.empty_cache()
    return dict(losses=losses, step_s=step_s, median_s=med, bitwise=bitwise)


def _mesh_serve(zoo: dict, mesh) -> dict:
    """(b) ``jit_prefill`` and MESH_DECODE_STEPS ``jit_decode_step``s of
    Llama-3.2-1B and Zamba2-2.7B at full width in bf16 with the kernels:
    launches counted from zero, logits and caches bitwise the meshless
    ``prefill`` / ``decode_step``'s."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.sharding import Policy

    launches, res = {}, {}
    for arch, kernel, n_launch, _ in ZOO_FULL[:2]:
        cfg = dataclasses.replace(get_config(arch), use_kernels=True)
        params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        batch = {"tokens": _zoo_prompts(cfg.vocab)}
        max_len = PROMPT_LEN + MAX_NEW
        policy = Policy(mesh=mesh)
        pre = E.jit_prefill(cfg, policy, M.param_shapes(cfg), batch, max_len)
        (logits, cache), counts = _counted(lambda: pre(params, batch))
        want = {name: 0 for name in counts}
        want[kernel] = n_launch
        check(counts == want, f"(b) {arch}: one prefill on the mesh launched "
                              f"{counts} (phase 8's: {want})")
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        l0, c0 = M.prefill(cfg, params, batch, max_len=max_len)
        check(_mesh_against(f"(b) {arch} prefill", [logits, cache],
                            [l0, c0]),
              f"(b) {arch}: prefill logits and all "
              f"{len(M.tree_leaves(c0))} cache leaves on the mesh bitwise "
              "the meshless prefill's")
        tok = torch.argmax(l0[:, -1], dim=-1)[:, None].to(torch.int32)
        dec = E.jit_decode_step(cfg, policy, M.param_shapes(cfg), c0,
                                {"tokens": tok})
        same, dec_counts = True, {}
        for _ in range(MESH_DECODE_STEPS):
            l0, c0 = M.decode_step(cfg, params, c0, {"tokens": tok})
            (logits, cache), n = _counted(
                lambda: dec(params, cache, {"tokens": tok}))
            dec_counts = {k: dec_counts.get(k, 0) + v for k, v in n.items()}
            same = _mesh_against(f"(b) {arch} decode", [logits, cache],
                                 [l0, c0]) and same
            tok = torch.argmax(l0[:, -1], dim=-1)[:, None].to(torch.int32)
        want_dec = dict.fromkeys(dec_counts, 0)
        want_dec["ssd_step"] = MESH_DECODE_STEPS * _recurrent_layers(cfg)
        check(same and dec_counts == want_dec,
              f"(b) {arch}: {MESH_DECODE_STEPS} decode steps on the mesh, "
              "logits and cache bitwise the meshless decode_step's, "
              f"launched {dec_counts} (expected {want_dec}: the decode "
              "step's kernel on the rank's heads)")
        for name, n in dec_counts.items():
            launches[name] = launches.get(name, 0) + n
        t_pre = [1e3 * _wall(lambda: pre(params, batch)) for _ in range(3)]
        log(f"  (b) {arch}: prefill ms on the mesh "
            f"{[round(t, 2) for t in t_pre]} against phase 8's meshless "
            f"{[round(t, 2) for t in zoo['full'][arch]['prefill_ms']]}")
        busy = _trace_call(f"{arch} prefill on the mesh",
                           lambda: (pre(params, batch),
                                    torch.cuda.synchronize()), top=6)
        res[arch] = dict(prefill_ms=t_pre, busy=busy)
        del params, logits, cache, l0, c0, pre, dec
        torch.cuda.empty_cache()
    return dict(launches=launches, serve=res)


def _card_constants() -> dict:
    """The measurements behind ``core/autoshard.py``'s H100 constants:
    the host time of one kernel launch (DISPATCH_S), a one-rank NCCL
    all-reduce of 4 bytes (HOP_LAT, a guess for a hop), a bf16 GEMM's
    and the port's bf16 flash_attention's share of the bf16 peak
    (KIND_EFF)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import autoshard as A
    from repro_torch.kernels import ops
    x = torch.zeros(1, device="cuda")
    n = 2000
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    launch = (time.perf_counter() - t0) / n
    y = torch.ones(1, device="cuda")
    for _ in range(20):
        dist.all_reduce(y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(y)
    torch.cuda.synchronize()
    hop = (time.perf_counter() - t0) / 200
    rng = np.random.default_rng(0)
    m = 8192
    a, b = (rand(rng, (m, m), torch.bfloat16) for _ in range(2))
    gemm_ms = time_ms(lambda: a @ b, iters=20)
    gemm = 2 * m ** 3 / (gemm_ms / 1e3) / PEAK_BF16
    B, T, Hq, Hk, D = N_PROMPTS, PROMPT_LEN, 32, 8, 64
    q = rand(rng, (B, T, Hq, D), torch.bfloat16)
    k, v = (rand(rng, (B, T, Hk, D), torch.bfloat16) for _ in range(2))
    attn_ms = time_ms(lambda: ops.flash_attention(q, k, v), iters=20)
    attn = 2 * B * Hq * T * T * D / (attn_ms / 1e3) / PEAK_BF16
    log(f"  (c) measured on this card: one kernel launch {1e6 * launch:.2f} "
        f"us (DISPATCH_S {1e6 * A.DISPATCH_S:.2f} us); a one-rank NCCL "
        f"all-reduce of 4 B {1e6 * hop:.2f} us (HOP_LAT "
        f"{1e6 * A.HOP_LAT:.2f} us); bf16 GEMM {m}^3 {gemm_ms:.3f} ms = "
        f"{100 * gemm:.1f}% of the bf16 peak (KIND_EFF matmul "
        f"{A.KIND_EFF['matmul']}); bf16 flash_attention at Llama's prefill "
        f"shape {attn_ms:.3f} ms = {100 * attn:.1f}% (KIND_EFF attention "
        f"{A.KIND_EFF['attention']})")
    return dict(launch_s=launch, hop_s=hop, gemm_share=gemm,
                attention_share=attn)


def _mesh_autoshard(mesh) -> dict:
    """(c) the autoshard pass at (16, 16) on the H100 constants, its
    overrides applied to Granite-3.0-1B's loss on the card's mesh, and
    the measurements behind the constants."""
    import numpy as np
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.core import autoshard as A
    from repro_torch.core.modelgraph import model_op_graph
    from repro_torch.models import model as M
    from repro_torch.sharding import NamedSharding, Policy
    from repro_torch.train import trainer as T

    out = {"constants": _card_constants()}
    hop_lat = A.HOP_LAT
    for arch, kind, B, S in AUTOSHARD_CELLS:
        g = model_op_graph(get_config(arch), kind=kind, batch=B, seq=S)
        t0 = time.perf_counter()
        r = A.autoshard(g, d_data=16, d_model=16)
        par = A.autoshard_parallel(g, d_data=16, d_model=16)
        dt = time.perf_counter() - t0
        feas = {k: v for k, v in r.single.items() if v is not None}
        routes = {}
        for a in r.schedule.assignment:
            routes[a] = routes.get(a, 0) + 1
        par_speedup = feas[r.best_single] / par.latency
        log(f"  (c) autoshard {arch} {kind} batch {B} seq {S} at (16, 16), "
            f"{len(g.ops)} ops, solved in {dt:.2f} s: sequential "
            f"{1e3 * r.schedule.latency:.3f} ms = {r.speedup:.3f}x the best "
            f"single strategy ({r.best_single} "
            f"{1e3 * feas[r.best_single]:.3f} ms); phase-parallel "
            f"{1e3 * par.latency:.3f} ms = {par_speedup:.3f}x; route "
            f"{routes}")
        # HOP_LAT is a guess (one card shows no hop): the same solve at
        # the ends of its readings' spread and at this run's reading
        sweep = {}
        try:
            for hop in HOP_SPREAD + (out["constants"]["hop_s"],):
                A.HOP_LAT = hop
                rh = A.autoshard(g, d_data=16, d_model=16)
                ph = A.autoshard_parallel(g, d_data=16, d_model=16)
                best = rh.single[rh.best_single]
                sweep[f"{1e6 * hop:.1f}"] = (rh.speedup, best / ph.latency)
        finally:
            A.HOP_LAT = hop_lat
        log(f"  (c) autoshard {arch} {kind} at HOP_LAT (us): sequential, "
            f"phase-parallel speedup " + "; ".join(
                f"{k}: {a:.3f}x, {b:.3f}x" for k, (a, b) in sweep.items()))
        out[arch] = dict(speedup=r.speedup, par_speedup=par_speedup,
                         routes=routes, hop_sweep=sweep, result=r)
    granite = out["granite-moe-1b-a400m"]["result"]
    overrides = A.emit_overrides({
        "moe_xe": "EP" if "EP" in granite.schedule.assignment else "DP_TP",
        "mlp_h": "DP_TP", "attn_q": "DP_TP"})
    cfg = get_config("granite-moe-1b-a400m")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 1025),
                                        dtype="int32")).to("cuda")
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    policy = Policy(mesh=mesh, fsdp=True, overrides=overrides)
    with torch.no_grad():
        want = float(M.loss_fn(cfg, params, batch)[0])
        with implicit_replication():
            pd = T.distribute_tree(params, T.param_shardings(policy, params))
            bd = T.distribute_tree(batch, M.tree_map(
                lambda s: NamedSharding(mesh, s),
                T.batch_pspecs(policy, batch)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = float(M.loss_fn(cfg, pd, bd, policy)[0].full_tensor())
            dt = time.perf_counter() - t0
    check(got == want, f"(c) granite-moe-1b-a400m loss_fn (full width, 1 x "
                       f"1024) under the emitted overrides {overrides} on the "
                       f"card's mesh: {got!r}, bitwise the meshless loss "
                       f"{want!r} ({dt:.2f} s)")
    del params, pd
    torch.cuda.empty_cache()
    for arch in (a for a, *_ in AUTOSHARD_CELLS):
        out[arch].pop("result")
    return out


# a (1, 4) mesh splits Zamba2-2.7B's heads four ways: each rank's scan
# runs on its quarter of them (one card runs the quarters in turn)
MESH_HEAD_SPLIT = 4


def _scan_head_quarters() -> dict:
    """(e) The SSD scan kernel at Zamba2-2.7B's prefill shape (phase 8's
    N_PROMPTS x PROMPT_LEN, 80 heads, N = P = 64), in f32 and bf16: on
    each quarter of the heads, y and the final state bitwise the matching
    heads of the whole call.  The split-head mesh path (the Mamba-2 block
    on each rank's heads, the kernel through its mesh entry) relies on
    it; one card cannot run a (1, 4) NCCL mesh."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cfg = get_config("zamba2-2.7b")
    _, shp = _zoo_call_shapes("zamba2-2.7b", cfg)
    B, T, H, N = shp["cb"]
    P, chunk = shp["v"][-1], shp["chunk"]
    q = H // MESH_HEAD_SPLIT
    rng = np.random.default_rng(7)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        c, b = (rand(rng, shp["cb"], dtype, 0.5) for _ in range(2))
        v = rand(rng, shp["v"], dtype)
        la = -torch.nn.functional.softplus(rand(rng, (B, T, H),
                                                torch.float32))
        y, st = ops.ssd_scan(c, b, v, la, chunk=chunk)
        same = []
        for i in range(MESH_HEAD_SPLIT):
            h = slice(i * q, (i + 1) * q)
            yq, sq = ops.ssd_scan(c[:, :, h], b[:, :, h], v[:, :, h],
                                  la[:, :, h], chunk=chunk)
            same.append(bitwise_equal(yq, y[:, :, h].contiguous())
                        and bitwise_equal(sq, st[:, h].contiguous()))
        torch.cuda.synchronize()
        name = str(dtype).replace("torch.", "")
        check(all(same), f"(e) ssd_scan at Zamba2-2.7B's prefill shape "
                         f"(B, T, H, N, P) = {(B, T, H, N, P)}, chunk "
                         f"{chunk}, {name}: y and the final state of each "
                         f"of {MESH_HEAD_SPLIT} quarters of the heads ({q} "
                         f"each) bitwise the matching heads of the whole "
                         f"call ({same})")
        out[name] = all(same)
    return out


def _mesh_dryrun() -> dict:
    """(d) the dry-run of two production cells in a child process on the
    host (a fake process group, no device)."""
    dest = ROOT / "chiprun_out" / "dryrun_phase10.json"
    dest.parent.mkdir(exist_ok=True)
    if dest.exists():
        dest.unlink()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", PYTHONWARNINGS="ignore")
    out = {}
    for arch, shape, multi_pod in DRYRUN_CELLS:
        key = f"{arch}|{shape}|{'2x16x16' if multi_pod else '16x16'}"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(dest), "--force"] + \
            (["--multi-pod"] if multi_pod else [])
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=4 * DRYRUN_BUDGET_S, env=env)
        wall = time.perf_counter() - t0
        rec = json.loads(dest.read_text()).get(key, {}) \
            if dest.exists() else {}
        check(proc.returncode == 0 and rec.get("status") == "ok",
              f"(d) dry-run {key}: {rec.get('status')} "
              f"{rec.get('error', proc.stderr[-500:])}")
        r = rec["roofline"]
        coll = {k: v for k, v in rec["collectives"].items() if v}
        log(f"  (d) {key}: {rec['n_chips']} ranks, "
            f"{rec['bytes_per_device'] / 2**30:.2f} GiB per device (the "
            f"card holds {CARD_GIB:.0f} GiB), {rec['flops_per_chip']:.4g} "
            f"FLOPs and {rec['bytes_per_chip']:.4g} B per chip, collective "
            f"B per chip {coll}; compute {1e3 * r['compute_s']:.3f} ms, "
            f"memory {1e3 * r['memory_s']:.3f} ms, collective "
            f"{1e3 * r['collective_s']:.3f} ms: {r['dominant']} dominates; "
            f"useful FLOP ratio {rec['useful_flop_ratio']:.3f}; step run "
            f"{rec['lower_s']} s + count {rec['count_s']} s, wall "
            f"{wall:.1f} s")
        gib, ref_coll, ref_flops = DRYRUN_REFERENCE[key]
        port_gib = rec["bytes_per_device"] / 2**30
        total = sum(coll.values())
        ratio = total / sum(ref_coll.values())
        log(f"  (d) {key} reference (compiled, constants of PERF.md): "
            f"{gib:.2f} GiB per device, {ref_flops:.4g} FLOPs per chip, "
            f"collective B per chip {ref_coll}; port / reference: "
            f"{port_gib / gib:.3f}x GiB, {ratio:.4f}x collective B, "
            f"{rec['flops_per_chip'] / ref_flops:.3f}x FLOPs")
        fetch = sum(coll.get(k, 0.0) for k in SELECT_LAYER_KINDS)
        log(f"  (d) {key}: select_layer moves {fetch:.4g} B per chip, "
            f"{100 * fetch / total:.1f}% of the port's collective B")
        check(port_gib <= DRYRUN_GIB_CEILING * gib,
              f"(d) {key}: {port_gib:.2f} GiB per device within "
              f"{DRYRUN_GIB_CEILING:.0f}x the reference's {gib:.2f}")
        ceiling = DRYRUN_COLL_CEILING[key]
        check(ratio <= ceiling,
              f"(d) {key}: collective B per chip {ratio:.4f}x the "
              f"reference's, within {ceiling}x")
        check(wall <= DRYRUN_BUDGET_S,
              f"(d) {key} in {wall:.1f} s (budget {DRYRUN_BUDGET_S:.0f} s)")
        out[key] = dict(rec, wall=wall, collective_ratio=ratio,
                        select_layer_bytes=fetch)
    return out


def phase_mesh(env: dict, zoo: dict, train: dict) -> dict:
    """The mesh: (a) training, (b) serving with the kernels, (c) autoshard
    and its overrides, on a (1, 1) NCCL mesh over the card; (e) the scan
    kernel on each quarter of Zamba2-2.7B's heads against the whole call;
    (d) the dry-run of two production cells on the host."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    log("== phase 10: the mesh")
    log(env["card"])
    t0 = time.perf_counter()
    mesh = make_host_mesh()
    log(f"  mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
        f"{dist.get_world_size()} rank ({dist.get_backend()})")
    try:
        tr = _mesh_train(train, mesh)
        sv = _mesh_serve(zoo, mesh)
        au = _mesh_autoshard(mesh)
    finally:
        dist.destroy_process_group()
    quarters = _scan_head_quarters()
    dr = _mesh_dryrun()
    wall = time.perf_counter() - t0
    check(wall <= MESH_BUDGET_S,
          f"phase 10 in {wall:.1f} s (budget {MESH_BUDGET_S:.0f} s)")
    return dict(train=tr, launches=sv["launches"], serve=sv["serve"],
                autoshard=au, head_quarters=quarters, dryrun=dr, wall=wall)


# ---------------------------------------------------------------------------
# phase 11: the examples on the card
# ---------------------------------------------------------------------------

EXAMPLES_BUDGET_S = 120.0    # phase 11's share of the script's time limit
E2E_CKPT_DIR = ROOT / "build" / "ckpt" / "chip_smoke_e2e"
# example -> its arguments on the card (the train run cut to ~30 s) and
# what it prints last once its own checks hold
EXAMPLES = (
    ("quickstart", [], "orchestrated output == monolithic output: OK"),
    ("multi_model_concurrent", [], "A retires -> re-planned set"),
    ("dynamic_rescheduling", [], "recovered outputs are bitwise-identical"),
    ("vla_pipeline", [], "planned and executed as a DAG workload: OK"),
    ("streaming_serving", [], "breaker:"),
    ("heterogeneous_serving", [], "served batch:"),
    ("train_e2e", ["--steps", "40", "--d-model", "256", "--layers", "2",
                   "--seq", "128", "--batch", "8", "--ckpt-every", "20",
                   "--lr", "3e-3", "--ckpt-dir", str(E2E_CKPT_DIR)],
     "parameters bitwise the uninterrupted run's: OK"),
    ("autoshard_h100", [], "bitwise the meshless step's"),
)


def _run_example(name: str, args: list) -> tuple[list[str], float, dict]:
    """``examples/torch_<name>.py`` in this process, on the card (no
    ``--device``), as ``__main__``; returns its printed lines, wall s and
    module globals.  An exception it raises (its own asserts) propagates."""
    import contextlib
    import io
    import runpy
    path = ROOT / "examples" / f"torch_{name}.py"
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = [str(path), *args]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            g = runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
    return buf.getvalue().splitlines(), time.perf_counter() - t0, g


def _hold_heterogeneous(g: dict) -> None:
    """What ``torch_heterogeneous_serving`` launched, held against the
    plain versions at its own shapes (after its launches were counted):
    its planned chain's kernel segments verified by their probes; the
    chain with every op on the kernel lane (each kernel launched) against
    the oracle; the engine's kernel prefill against the plain prefill."""
    import dataclasses

    import torch
    from repro_torch.models import model as M
    from repro_torch.core.targets import KERNEL_DIALECTS
    kprog, kg, kext, kref = g["kprog"], g["kg"], g["kext"], g["kref"]
    check(g["oracle_err"] <= g["ORACLE_TOL"],
          f"torch_heterogeneous_serving: its planned run's warm outputs "
          f"within {g['ORACLE_TOL']:g} of the oracle (worst error / "
          f"max|value| {g['oracle_err']:.3e})")
    for seg in kprog.segments:
        if seg.target is not None and seg.target.dialect in KERNEL_DIALECTS:
            check(seg.verified in ("bitwise", "tolerance"),
                  f"torch_heterogeneous_serving: planned kernel segment "
                  f"{seg.index} on {seg.lane} verified {seg.verified!r}")
    n = len(kg)
    allk = g["korch"].executor.compile_scheduled(
        kg, {i: KERNEL_LANE for i in range(n)})
    allk.run(kext)              # cold: the probes, the reference's outputs
    outs, counts = _counted(lambda: allk.run(kext))
    allk.close()
    log(f"  its chain, every op on {KERNEL_LANE}: verdicts "
        f"{allk.stats['variant_verified']}, warm run's launches {counts}")
    check(all(counts[k] >= 1 for k in KERNEL_OF_OP.values()),
          f"the chain on {KERNEL_LANE} launched every kernel ({counts})")
    for seg in allk.segments:
        check(seg.verified in ("bitwise", "tolerance"),
              f"the chain on {KERNEL_LANE}: segment {seg.index} verified "
              f"{seg.verified!r}")
    _drift_ok(f"the chain on {KERNEL_LANE} against the oracle", outs, kref,
              [0.0] * n)
    cfg, params, prompts = g["cfg"], g["params"], g["prompts"]
    check(cfg.use_kernels and cfg.dtype == "float32",
          "the example's engine served the f32 model with the kernels")
    batch = {"tokens": prompts}
    max_len = prompts.shape[1] + 8
    (lk, ck), counts = _counted(
        lambda: M.prefill(cfg, params, batch, max_len))
    plain = M.prefill(dataclasses.replace(cfg, use_kernels=False), params,
                      batch, max_len)
    torch.cuda.synchronize()
    _leaves_close(f"its engine's kernel prefill (launches {counts}) against "
                  f"the plain prefill, logits and every cache leaf",
                  [lk, ck], list(plain), ZOO_F32_TOL)
    check(any(counts.values()), "its engine's prefill launched a kernel")


def phase_examples(env: dict) -> dict:
    """Each of the port's eight examples on the card, in this process; the
    kernels' launches counted over ``torch_heterogeneous_serving``."""
    import shutil

    import torch.distributed as dist
    from repro_torch import kernels
    log("== phase 11: the examples on the card")
    log(env["card"])
    t0 = time.perf_counter()
    shutil.rmtree(E2E_CKPT_DIR, ignore_errors=True)
    launches, walls = {}, {}
    try:
        for name, args, last in EXAMPLES:
            kernels.reset_launch_counts()
            try:
                lines, wall, g = _run_example(name, args)
            except Exception as e:
                import traceback
                log(traceback.format_exc()[-3000:])
                check(False, f"torch_{name}: {type(e).__name__}: {e}")
            counts = kernels.launch_counts()
            for line in lines:
                log(f"    | {line}")
            check(any(last in line for line in lines),
                  f"torch_{name} finished in {wall:.1f} s, its checks "
                  f"held (printed {last!r})")
            check(not dist.is_initialized(),
                  f"torch_{name} left no process group behind")
            walls[name] = wall
            if name == "heterogeneous_serving":
                launches = counts
                log(f"  kernel launches in torch_heterogeneous_serving "
                    f"(profile on four lanes, planned run, engine): "
                    f"{counts}")
                check(all(counts[k] >= 1 for k in CHAIN_KERNELS),
                      "torch_heterogeneous_serving launched every kernel "
                      "of the chain")
                _hold_heterogeneous(g)
    finally:
        shutil.rmtree(E2E_CKPT_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    check(wall <= EXAMPLES_BUDGET_S,
          f"phase 11 in {wall:.1f} s (budget {EXAMPLES_BUDGET_S:.0f} s)")
    return dict(launches=launches, walls=walls, wall=wall)


def main() -> int:
    # phase 9's restart restores Llama-3.2-1B's params and f32 AdamW state
    # among the cached blocks of the steps before it: in fixed-size
    # segments an H100 80GB was seen to hold 20.66 GiB reserved but
    # unallocated and refuse a 2 GiB request, so segments grow instead
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); the smoke run needs the card", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {src / 'repro_torch'} not found: run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core import GRANITE_MAIN_PATH

    t_start = time.perf_counter()
    try:
        env = phase_environment()
        rows = phase_kernels(GRANITE_MAIN_PATH, env)
        main = phase_main_path(GRANITE_MAIN_PATH)
        conc = phase_concurrent(GRANITE_MAIN_PATH, main)
        phase_dag(GRANITE_MAIN_PATH, main, conc)
        adm = phase_admission(GRANITE_MAIN_PATH, main, conc)
        phase_serving(GRANITE_MAIN_PATH, main, conc, adm)
        zoo = phase_zoo(env)
        train = phase_train(env)
        mesh = phase_mesh(env, zoo, train)
        examples = phase_examples(env)
    except CheckFailed as e:
        log(f"chip_smoke: FAILED: {e}")
        return 1
    finally:
        LOG.parent.mkdir(exist_ok=True)
        LOG.write_text("\n".join(_log_lines) + "\n")
    # the decode step's kernel at Zamba2-2.7B's decode shape, its
    # launches those of phases 8 and 10's decode steps, counted from zero
    rows["ssd_step"] = dict(zoo["steps"][0], launches=sum(
        r["decode_launches"]["ssd_step"]
        for part in ("full", "reduced") for r in zoo[part].values()))
    for name, row in rows.items():
        row["launches"] = (row.get("launches", 0)
                           + main["counts"].get(name, 0)
                           + mesh["launches"].get(name, 0)
                           + examples["launches"].get(name, 0))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(env["card"])
    print(json.dumps({"kernels": [
        {k: rows[n][k] for k in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}
        for n in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
