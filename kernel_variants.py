#!/usr/bin/env python3
"""Design variants of the tensor-core kernels, timed on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 kernel_variants.py

Builds ``src/repro_torch/csrc/expert_glu.cu``, ``flash_attention.cu``
and ``ssd_scan.cu`` as they are ("shipped") and with one design choice
undone at a time, by a textual substitution of the sources (each
substitution must match, so a variant cannot silently become the shipped
kernel), into ``build/kernels/variants/``.  Each variant runs at the
main-path shapes (``GRANITE_MAIN_PATH``; the SSD scan at chunks 64, the
main path's, 128 and 256) in f32 and bf16 and prints its time (CUDA
events), its error over the largest output of the plain version, and the
time of one library call for the same function where there is one, all
in one process:

* ``cvt_rna`` — the 3xTF32 split by two ``cvt.rna.tf32.f32`` instead of
  integer rounding (same numbers, more instructions);
* ``no_fold`` — the GLU's f32 stages summed straight into the running
  sum, one chain of ``mma`` over all of K (shows the tensor cores'
  truncating accumulator);
* ``one_tf32`` — only the hi.hi product (wrong by ~3e-4: a speed ceiling
  for the products, not a kernel to ship);
* ``warps16`` — the GLU with 16 warps of 32 x 32 instead of 8 of 64 x 32;
* ``fold64`` — the SSD scan's fresh accumulator spans 64 of K instead of
  32: at the main path (N = 64, kv tiles of 64, chunk 64) every product
  is one chain, so this shows what the fold costs there and how far the
  truncating accumulator drifts without it.

A full log goes to ``chiprun_out/kernel_variants.log``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "kernels" / "variants"
LOG = ROOT / "chiprun_out" / "kernel_variants.log"

SPLIT = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi));")
CVT_RNA = ('  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
           '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - '
           '__uint_as_float(hi)));')
GLU_STAGE = "mma_stage(stage, stage + BM * L::AS, part, wr, ncol, lane);"
GLU_FOLD = "for (int q = 0; q < 4; ++q) acc[mi][j][q] += part[mi][j][q];"
GLU_THREE = ("        bident::mma_tf32(part[mi][j], al, bh[j]);\n"
             "        bident::mma_tf32(part[mi][j], ah, bl[j]);\n"
             "        bident::mma_tf32(part[mi][j], ah, bh[j]);")
GLU_ONE = "        bident::mma_tf32(part[mi][j], ah, bh[j]);"
ATTN_THREE = ("  bident::mma_tf32(c, al, bh);\n"
              "  if constexpr (sizeof(T) == 4) bident::mma_tf32(c, ah, bl);\n"
              "  bident::mma_tf32(c, ah, bh);")
ATTN_ONE = "  bident::mma_tf32(c, ah, bh);"
SSD_THREE = ("  if constexpr (!A_EXACT) bident::mma_tf32(c, al, bh);\n"
             "  if constexpr (!B_EXACT) bident::mma_tf32(c, ah, bl);\n"
             "  bident::mma_tf32(c, ah, bh);")
SSD_ONE = "  bident::mma_tf32(c, ah, bh);"
SSD_FOLD = "constexpr int FOLD_K8 = 4;"
WARPS_M = "constexpr int WARPS_M = 2;"
BOUNDS = "__launch_bounds__(NT, Layout<T>::F32 ? 1 : 2)"

# variant -> {file: [(old, new), ...]}; each kernel builds with its own
# copy of common.cuh
VARIANTS = {
    "shipped": {},
    "cvt_rna": {"common.cuh": [(SPLIT, CVT_RNA)]},
    "no_fold": {"expert_glu.cu": [(GLU_STAGE, GLU_STAGE.replace("part",
                                                                 "acc")),
                                  (GLU_FOLD, ";")]},
    "one_tf32": {"expert_glu.cu": [(GLU_THREE, GLU_ONE)],
                 "flash_attention.cu": [(ATTN_THREE, ATTN_ONE)],
                 "ssd_scan.cu": [(SSD_THREE, SSD_ONE)]},
    "warps16": {"expert_glu.cu": [(WARPS_M, "constexpr int WARPS_M = 4;"),
                                  (BOUNDS, "__launch_bounds__(NT, 1)")]},
    "fold64": {"ssd_scan.cu": [(SSD_FOLD, "constexpr int FOLD_K8 = 8;")]},
}
KERNELS = ("expert_glu", "flash_attention", "ssd_scan")

_log_lines: list[str] = []


def log(msg: str = "") -> None:
    print(msg, flush=True)
    _log_lines.append(msg)


def sources(variant: str, kernel: str) -> dict[str, str] | None:
    """The variant's copy of ``kernel``'s sources, or None where the
    variant leaves that kernel as shipped (and it is not ``shipped``)."""
    subs = VARIANTS[variant]
    touched = [f for f in subs if f in ("common.cuh", f"{kernel}.cu")]
    if variant != "shipped" and not touched:
        return None
    files = {f: (CSRC / f).read_text() for f in ("common.cuh",
                                                 f"{kernel}.cu")}
    for f in touched:
        for old, new in subs[f]:
            if old not in files[f]:
                raise RuntimeError(f"variant {variant}: {f} no longer holds "
                                   f"{old!r}")
            files[f] = files[f].replace(old, new)
    return files


def build() -> dict[tuple[str, str], ctypes.CDLL]:
    """Every (variant, kernel) library, one nvcc each, all in parallel."""
    from repro_torch.kernels import _build
    procs = {}
    for variant in VARIANTS:
        for kernel in KERNELS:
            files = sources(variant, kernel)
            if files is None:
                continue
            d = OUT / variant / kernel
            d.mkdir(parents=True, exist_ok=True)
            for name, text in files.items():
                (d / name).write_text(text)
            procs[variant, kernel] = subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                 str(d / f"{kernel}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key} build failed:\n{out}")
        usage = _build.ptxas_usage(out)
        log(f"  {key[0]:9s} {key[1]:16s} registers "
            f"{min(u['registers'] for u in usage)}-"
            f"{max(u['registers'] for u in usage)}, spill stores up to "
            f"{max(u['spill_stores'] for u in usage)} B")
        libs[key] = ctypes.CDLL(str(OUT / key[0] / key[1] / "lib.so"))
    return libs


def host_us(fn, iters: int = 1000) -> float:
    """Mean host time of ``fn()`` in microseconds, without a sync inside
    the timed loop (the launches' own cost on the host)."""
    import time

    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def bind(lib, kernel):
    from repro_torch.kernels import _build
    symbol, argtypes = _build._SIGNATURES[kernel]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F_
    from chip_smoke import norm_err, time_ms
    from repro_torch.core import GRANITE_MAIN_PATH
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gather as mg
    from repro_torch.kernels import ssd_scan as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip())
    libs = build()
    cfg = GRANITE_MAIN_PATH
    B, T, H, D = (cfg[k] for k in ("batch", "seq", "heads", "head_dim"))
    E, F, K = (cfg[k] for k in ("experts", "moe_ff", "top_k"))
    d, cap = H * D, -(-(B * T * K) // E)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream

    def rand(shape, dtype, scale=1.0):
        a = rng.standard_normal(shape, dtype="float32") * scale
        return torch.from_numpy(a).cuda().to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        name = str(dtype)[6:]
        x, wu, wd = (rand((E, cap, d), dtype), rand((E, d, 2 * F), dtype, .5),
                     rand((E, F, d), dtype, .5))
        want = mg.expert_glu_plain(x, wu, wd)
        act, y = torch.empty((E, cap, F), dtype=dtype, device="cuda"), \
            torch.empty_like(x)

        def bmm_glu():
            h = torch.bmm(x, wu)
            return torch.bmm(F_.silu(h[..., :F]) * h[..., F:], wd)
        log(f"expert_glu {name} at (E, cap, d, F) = ({E}, {cap}, {d}, {F}):"
            f" bmm GLU {time_ms(bmm_glu, iters=20):.4f} ms")
        for variant in VARIANTS:
            if (variant, "expert_glu") not in libs:
                continue
            fn = bind(libs[variant, "expert_glu"], "expert_glu")

            def call():
                err = fn(x.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                         act.data_ptr(), y.data_ptr(), E, cap, d, F, bf,
                         stream)
                if err:
                    raise RuntimeError(f"{variant}: cudaError_t {err}")
            call()
            torch.cuda.synchronize()
            rel = norm_err(y, want)[1]
            log(f"  {variant:9s} {time_ms(call, iters=20):.4f} ms, error "
                f"/ max|plain| {rel:.3e}")

        q, k, v = (rand((B, T, H, D), dtype) for _ in range(3))
        want = fa.flash_attention_plain(q, k, v)
        o = torch.empty_like(q)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = time_ms(lambda: F_.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), iters=20)
        log(f"flash_attention {name} at (B, T, H, D) = ({B}, {T}, {H}, {D}),"
            f" causal: SDPA {sdpa:.4f} ms")
        for variant in VARIANTS:
            if (variant, "flash_attention") not in libs:
                continue
            fn = bind(libs[variant, "flash_attention"], "flash_attention")

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), B, T, T, H, H, D, 1, 0, bf, stream)
                if err:
                    raise RuntimeError(f"{variant}: cudaError_t {err}")
            call()
            torch.cuda.synchronize()
            rel = norm_err(o, want)[1]
            log(f"  {variant:9s} {time_ms(call, iters=20):.4f} ms, error "
                f"/ max|plain| {rel:.3e}")
        # the SSD scan at the main path's widths and three chunks
        N, P = cfg["state"], D
        c_, b_ = rand((B, T, H, N), dtype, .5), rand((B, T, H, N), dtype, .5)
        v_ = rand((B, T, H, P), dtype)
        la = -F_.softplus(rand((B, T, H), torch.float32))
        y_, s_ = torch.empty_like(v_), torch.empty((B, H, N, P), device="cuda")
        for chunk in (64, 128, 256):
            want = ss.ssd_scan_plain(c_, b_, v_, la, chunk=chunk)[0]
            work = torch.empty(B * H * -(-T // chunk) * (N * P + 1),
                               device="cuda")
            log(f"ssd_scan {name} at (B, T, H, N, P) = ({B}, {T}, {H}, {N},"
                f" {P}), chunk {chunk}:")
            for variant in VARIANTS:
                if (variant, "ssd_scan") not in libs:
                    continue
                fn = bind(libs[variant, "ssd_scan"], "ssd_scan")

                def call():
                    err = fn(c_.data_ptr(), b_.data_ptr(), v_.data_ptr(),
                             la.data_ptr(), None, y_.data_ptr(),
                             s_.data_ptr(), work.data_ptr(), B, T, H, N, P,
                             chunk, bf, stream)
                    if err:
                        raise RuntimeError(f"{variant}: cudaError_t {err}")
                call()
                torch.cuda.synchronize()
                rel = norm_err(y_, want)[1]
                log(f"  {variant:9s} {time_ms(call, iters=50):.4f} ms, error "
                    f"/ max|plain| {rel:.3e}")
                if variant == "shipped" and chunk == 64:
                    raw_call = call
            # host time a call (no sync), of the C entry point and of the
            # wrapper, which also allocates and checks: where it exceeds
            # the device time, a wrapper timed by CUDA events reads it
            log(f"  host time a call at chunk 64: C entry point "
                f"{host_us(raw_call):.1f} us, ssd_scan_cuda "
                f"{host_us(lambda: ss.ssd_scan_cuda(c_, b_, v_, la, chunk=64)):.1f}"
                f" us")
    LOG.parent.mkdir(exist_ok=True)
    LOG.write_text("\n".join(_log_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
