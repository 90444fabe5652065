#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing falls back to the CPU):

1. environment — the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions; builds the three kernels from the sources in
   ``src/repro_torch/csrc`` and times the build;
2. kernels — holds each CUDA kernel against its plain PyTorch version on
   the card, at shapes of ``tests/test_kernels.py`` (GQA, padded T,
   decode with ``q_offset``, ``initial_state``, capacity drop), at the
   main-path shapes and at d = 2048 for the expert GLU, in f32 and bf16;
   checks that the tensor-core kernels are bitwise equal between two runs
   on the same inputs; and times kernel, plain version and (where one
   exists) a library call;
3. main path — ``kernel_chain`` at the Granite-3.0-1B-A400M widths:
   ``MeasuredProfiler(strict=True)`` over the four lanes (numpy-eager,
   torch-cpu, cuda:0, cuda-kernels), ``Orchestrator.plan``, the compiled
   program on the planned route and on every single-lane route, each
   checked against the interpreter oracle; then one warm run of the
   planned route through ``Orchestrator.execute``, with the kernels'
   launch counts zeroed just before it and read just after.

The second-to-last line is the ``{"kernels": [...]}`` summary, the last
line ``{"ok": true, "device": {...}}``.  A full log goes to
``chiprun_out/chip_smoke.log``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LOG = ROOT / "chiprun_out" / "chip_smoke.log"

# H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, TF32 and bf16
# on the tensor cores, HBM3 bandwidth.  Bounds below are stated against
# these.  A kernel whose f32 products run in 3xTF32 on the tensor cores
# (expert_glu, flash_attention) is bound by three TF32 products per f32
# one; its CUDA-core f32 bound is printed beside it.
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

F32_TOL, BF16_TOL = 3e-5, 3e-2          # tests/test_kernels.py buckets
LANES = ("numpy-eager", "torch-cpu", "cuda:0", "cuda-kernels")
REPEATS = 3                              # warm runs timed per route
# which kernel each op of kernel_chain launches on the kernel lane
KERNEL_OF_OP = {"attn": "flash_attention", "ssd": "ssd_scan",
                "moe": "expert_glu"}
# A whole route is held to the oracle op by op, on the error normalised
# by the output's largest magnitude: within the f32 variant bucket, or
# within SPREAD times the spread between two correct runs of the
# reference payloads (host and card) at that op, whichever is larger.
# At the Granite widths the chain amplifies any f32 reordering (the two
# reference runs differ by up to 1.6e-2 at the last tanh), so a route's
# drift is bounded by the chain's conditioning; each kernel on its own
# is held to the bucket by its lane's probe and by phase 2.
ROUTE_BUCKET, SPREAD = 3e-4, 4.0

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
    """Two runs of ``fn(*args)`` give the same bits (fixed-order sums)."""
    import torch
    first, second = fn(*args), fn(*args)
    torch.cuda.synchronize()
    check(bitwise_equal(first, second),
          f"{name} {label} {str(args[0].dtype)[6:]}: two runs on the same "
          "inputs are bitwise equal")


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
    paths = _build.build_all()
    for name in _build.KERNELS:
        _build.function(name)
    log(f"built {len(paths)} kernels in {time.perf_counter() - t0:.1f}s")
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
    return {"card": card}


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


def _ssd_case(rng, B, T, H, N, P, chunk, with_s0, dtype):
    import torch
    from repro_torch.kernels import ssd_scan as ss
    c = rand(rng, (B, T, H, N), dtype, 0.5)
    b = rand(rng, (B, T, H, N), dtype, 0.5)
    v = rand(rng, (B, T, H, P), dtype)
    la = -torch.nn.functional.softplus(rand(rng, (B, T, H), torch.float32))
    s0 = rand(rng, (B, H, N, P), torch.float32) if with_s0 else None
    y, s = ss.ssd_scan_cuda(c, b, v, la, initial_state=s0, chunk=chunk)
    yp, sp = ss.ssd_scan_plain(c, b, v, la, initial_state=s0, chunk=chunk)
    return (c, b, v, la, s0), (y, s), (yp, sp)


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


def phase_kernels(main_cfg: dict) -> dict:
    """Every kernel against its plain version; returns the per-kernel
    rows of the summary line (all but ``launches``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F_
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
        ("Granite GQA 16/8", (B, T, T, H, 8, D, True, 0), False),
        ("main path", (B, T, T, H, H, D, True, 0), False),
    ]
    for dtype in (f32, bf16):
        for label, shape, small in attn_cases:
            args, got, want = _attn_case(rng, *shape, dtype)
            err = _hold("flash_attention", label, got, want, dtype, small)
            if label == "main path":
                check_repeatable("flash_attention", label,
                                 fa.flash_attention_cuda, args)
                if dtype == f32:
                    main_err = err
    # k and v off a 16-byte boundary take plain loads, not cp.async
    for dtype in (f32, bf16):
        (q, k, v), _, want = _attn_case(rng, 1, 96, 96, 4, 2, 64, True, 0,
                                        dtype)
        got = fa.flash_attention_cuda(q, _unaligned(k), _unaligned(v))
        _hold("flash_attention", "k, v not 16-byte aligned", got, want,
              dtype, True)
    (q, k, v), _, _ = _attn_case(rng, B, T, T, H, H, D, True, 0, f32)
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
            qh, kh, vh, is_causal=True)), cuda_core_bound_ms=cc_ms)

    # -- SSD scan ----------------------------------------------------------
    ssd_cases = [
        ("B=2 T=128", (2, 128, 2, 16, 32, 32, False), True),
        ("padded T=100", (1, 100, 3, 8, 16, 32, False), True),
        ("initial_state", (2, 64, 2, 16, 16, 16, True), True),
        ("T=17 < chunk, initial_state", (1, 17, 2, 8, 8, 32, True), True),
        ("main path + initial_state", (B, T, H, N, D, 64, True), False),
        ("main path", (B, T, H, N, D, main_cfg["chunk"], False), False),
    ]
    for dtype in (f32, bf16):
        for label, shape, small in ssd_cases:
            _, (y, s), (yp, sp) = _ssd_case(rng, *shape, dtype)
            err = _hold("ssd_scan", label, y, yp, dtype, small)
            _hold("ssd_scan", label + " state", s, sp, f32, False)
            if label == "main path" and dtype == f32:
                main_err = err
    (c, b, v, la, _), _, _ = _ssd_case(rng, B, T, H, N, D,
                                       main_cfg["chunk"], False, f32)
    steps = B * T * H
    b_ms, b_by = bound(steps * 4 * N * D,
                       4 * (c.numel() + b.numel() + 2 * v.numel()
                            + la.numel() + B * H * N * D), PEAK_F32)
    rows["ssd_scan"] = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:112",
        max_abs_err=main_err,
        ms=time_ms(lambda: ss.ssd_scan_cuda(c, b, v, la,
                                            chunk=main_cfg["chunk"])),
        plain_ms=time_ms(lambda: ss.ssd_scan_plain(
            c, b, v, la, chunk=main_cfg["chunk"]), iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

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
    ]
    for dtype in (f32, bf16):
        for label, shape, scale, small in glu_cases:
            args, got, want = _glu_case(rng, *shape, dtype, scale)
            err = _hold("expert_glu", label, got, want, dtype, small)
            if label == "main path":
                check_repeatable("expert_glu", label, mg.expert_glu_cuda,
                                 args)
                if dtype == f32:
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
    rows["expert_glu"] = dict(
        name="expert_glu", route="cuda",
        source="src/repro_torch/csrc/expert_glu.cu",
        replaces="src/repro/kernels/moe_gather.py:79",
        max_abs_err=main_err,
        ms=time_ms(lambda: mg.expert_glu_cuda(x, w_up, w_down), iters=5),
        plain_ms=time_ms(lambda: mg.expert_glu_plain(x, w_up, w_down),
                         iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(bmm_glu, iters=5), cuda_core_bound_ms=cc_ms)
    for r in rows.values():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        cc = r.get("cuda_core_bound_ms")
        tc = "" if cc is None else \
            f", 3xTF32 tensor cores; f32 CUDA-core bound {cc:.4f} ms"
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
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


def _trace(prog, ext) -> None:
    """One traced warm run of a compiled program: device time by kernel
    name and the device's busy share of the run's wall time (tracing
    slows the host, so the idle share it gives is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.profiler import fence
    fence(list(prog.run(ext).values()))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fence(list(prog.run(ext).values()))
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
    log(f"  traced planned route: wall {1e3 * wall:.3f} ms, device busy "
        f"{1e3 * busy:.3f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(n for _, n, _ in rows)} kernels")
    for us, n, key in rows[:12]:
        log(f"    {us / 1e3:9.3f} ms  x{n:<4d} {key[:90]}")


def phase_main_path(main_cfg: dict) -> dict:
    import torch
    from repro_torch import kernels
    from repro_torch.core import (KERNEL_DIALECTS, MeasuredProfiler,
                                  Orchestrator, kernel_chain)
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
    kernels.reset_launch_counts()
    fence(list(orch.execute(plan, ext).values()))
    counts = kernels.launch_counts()
    expected = dict.fromkeys(counts, 0)
    for seg in prog.segments:
        if seg.use_variant and seg.target.dialect in KERNEL_DIALECTS:
            for _, i in seg.items:
                kind = graph.ops[i].name.rsplit(".", 1)[-1]
                if kind in KERNEL_OF_OP:
                    expected[KERNEL_OF_OP[kind]] += 1
    log(f"kernel launches in one run of the planned route: {counts}")
    for name, count in counts.items():
        check(count == expected[name] >= 1,
              f"{name} launched {count} times in one run of the planned "
              f"route (its kernel-lane ops: {expected[name]}, at least 1)")

    _trace(prog, ext)

    ck, c0 = results["cuda-kernels"]["outs"], results["cuda:0"]["outs"]
    _drift_ok("all-cuda-kernels route against the all-cuda:0 route",
              ck, c0, spread)
    return {"counts": counts}


def main() -> int:
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
        rows = phase_kernels(GRANITE_MAIN_PATH)
        main = phase_main_path(GRANITE_MAIN_PATH)
    except CheckFailed as e:
        log(f"chip_smoke: FAILED: {e}")
        return 1
    finally:
        LOG.parent.mkdir(exist_ok=True)
        LOG.write_text("\n".join(_log_lines) + "\n")
    for name, row in rows.items():
        row["launches"] = main["counts"][name]
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
