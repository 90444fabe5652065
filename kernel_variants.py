#!/usr/bin/env python3
"""Design variants of the tensor-core kernels, timed on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 kernel_variants.py

Builds ``src/repro_torch/csrc/expert_glu.cu`` and ``flash_attention.cu``
as they are ("shipped") and with one design choice undone at a time, by a
textual substitution of the sources (each substitution must match, so a
variant cannot silently become the shipped kernel), into
``build/kernels/variants/``.  Each variant runs at the main-path shapes
(``GRANITE_MAIN_PATH``) in f32 and bf16 and prints its time (CUDA
events), its error over the largest output of the plain version, and the
time of one library call for the same function, all in one process:

* ``cvt_rna`` — the 3xTF32 split by two ``cvt.rna.tf32.f32`` instead of
  integer rounding (same numbers, more instructions);
* ``no_fold`` — the GLU's f32 stages summed straight into the running
  sum, one chain of ``mma`` over all of K (shows the tensor cores'
  truncating accumulator);
* ``one_tf32`` — only the hi.hi product (wrong by ~3e-4: a speed ceiling
  for the products, not a kernel to ship);
* ``warps16`` — the GLU with 16 warps of 32 x 32 instead of 8 of 64 x 32.

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
WARPS_M = "constexpr int WARPS_M = 2;"
BOUNDS = "__launch_bounds__(NT, Layout<T>::F32 ? 1 : 2)"

# variant -> {file: [(old, new), ...]}; expert_glu and flash_attention
# each build with their own copy of common.cuh
VARIANTS = {
    "shipped": {},
    "cvt_rna": {"common.cuh": [(SPLIT, CVT_RNA)]},
    "no_fold": {"expert_glu.cu": [(GLU_STAGE, GLU_STAGE.replace("part",
                                                                 "acc")),
                                  (GLU_FOLD, ";")]},
    "one_tf32": {"expert_glu.cu": [(GLU_THREE, GLU_ONE)],
                 "flash_attention.cu": [(ATTN_THREE, ATTN_ONE)]},
    "warps16": {"expert_glu.cu": [(WARPS_M, "constexpr int WARPS_M = 4;"),
                                  (BOUNDS, "__launch_bounds__(NT, 1)")]},
}
KERNELS = ("expert_glu", "flash_attention")

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
    LOG.parent.mkdir(exist_ok=True)
    LOG.write_text("\n".join(_log_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
