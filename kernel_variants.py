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
main path's, 128 and 256) in f32 and bf16 (the expert GLU's in the dtype
whose design each changes, ``GLU_F32`` and ``GLU_BF16``) and prints its
time (CUDA events),
its error over the largest output of the plain version (the expert
GLU's also whether two runs agree bitwise), and the time of one library
call for the same function where there is one, all in one process:

* ``cvt_rna`` — the 3xTF32 split by two ``cvt.rna.tf32.f32`` instead of
  integer rounding (same numbers, more instructions);
* ``one_tf32`` — only the hi.hi product (wrong by ~3e-4: a speed ceiling
  for the products, not a kernel to ship); at the f32 expert GLU it also
  says whether the tensor cores truncate or round the raw f32 bits of
  ``wgmma``'s shared-memory operand (``_glu_truncation``);
* for the f32 expert GLU (``glu_wgmma_kernel``, TF32 ``wgmma`` fed by
  TMA): ``mma_sync`` — the ``mma.sync`` kernel (``gemm_kernel``, which
  bf16 takes) on the aligned rows, the baseline, in the same process;
  ``fold1`` and ``no_fold`` — the fresh accumulator every stage (K 32)
  instead of every 4, or never (one
  truncating chain over K: shows the drift); ``bm64`` — a 64-token tile
  (more blocks, each weight tile read four times); ``ring4`` — a ring of
  4 stages instead of 3; and the ablations (wrong results, timed only)
  ``no_lohi`` — no a_lo.b_hi product, ``no_bsplit`` — no split pass (B's
  lo tile left as it lies), ``no_mma`` — no products at all (the loads,
  splits and barriers alone);
* for the bf16 expert GLU (``glu_bf16_kernel``, bf16 ``wgmma`` fed by
  TMA, the weights read N-major), at the main path's widths and at
  DeepSeek-V3's expert widths (``DEEPSEEK_GLU``), each with its distance
  in bf16 ulps from the plain version: ``mma_sync`` — the ``mma.sync``
  kernel (``gemm_kernel``) on the same operands, the baseline;
  ``ring3`` — a ring of 3 stages (of 4; 5 do not fit beside the
  256-token tile); ``bm128`` — the 128-token tile at every cap (one m64
  slab a warpgroup, each weight tile read by two blocks at cap 256;
  shipped: at caps up to 128); and the ablation
  ``no_mma`` — no products (the loads and barriers alone);
* for the f32 SSD scan (``state_tf32_kernel`` and ``out_tf32_kernel``,
  3xTF32 ``wgmma`` fed by TMA at N = 64): ``mma_sync`` — the three
  ``mma.sync`` kernels on the same operands, the baseline; ``one_tf32``
  — hi.hi alone in every chain; ``fold64`` — the fresh accumulators of
  the chunk states and of c b^T and c S_in span 64 of K instead of 32
  (one chain over N); ``st32`` and ``st64`` — the state kernel's block
  over 32 or 64 state rows at every grid (the shipped rule takes 32
  where 64 would leave half the SMs without a walker); ``f32_stages2``
  — the outputs kernel's ring two deep instead of three;
  ``st_stages3`` — the state kernel's ring three deep instead of six;
  ``out_1buf`` — the outputs kernel with one split buffer, two blocks
  an SM; and the ablations ``no_mma`` — no products in any chain (the
  loads, the splits and transposes, the decay and the barriers alone),
  ``no_stage`` — the state kernel without its staging of (w o b)^T,
  ``walk_loads`` — the state kernel with neither staging nor products
  (the walk's loads, fragment reads and barriers alone), ``no_kv_split`` —
  the outputs kernel without its kv tiles' split, ``no_decay_f32`` —
  without the decay; each at the main path's widths and at Zamba2-2.7B's
  f32 prefill shape, bitwise run to run or not;
* for the f32 SSD scan above N = 64 (``state_tf32_kernel`` and
  ``out_wide_tf32_kernel``, v copied into padded rows by
  ``pad_v_kernel`` where TMA cannot read it), at xLSTM-125M's mLSTM f32
  prefill shape (``SSD_F32_WIDE``): ``mma_sync``, ``cvt_rna``,
  ``one_tf32``, ``fold64``, ``no_mma``, ``st32``, ``st64``,
  ``st_stages3``, ``no_stage`` and ``walk_loads`` as above; ``wide_ring3``
  — the outputs kernel's ring 3 deep (of 2); ``wide_splits1`` — one split
  buffer (of 2: the splits and the products take turns); ``wide_split4``
  — all four warps of the split warpgroup split, its thread 0 issuing the
  loads between items (shipped: three split, the fourth loads); and the
  ablation
  ``wide_score_p0`` — the score c b^T only in the blocks of P's first
  column tile: at P = 385 each of the 7 tiles' blocks computes the q
  tile's score over all of N, so this bounds what computing it once per
  (chunk, q tile) could save; each with the device time by kernel for
  ``shipped`` and ``mma_sync``;
* for the f32 attention (``attn_tf32_kernel``, 3xTF32 ``wgmma`` fed by
  TMA at D 64, 128 and 160): ``mma_sync`` — the ``mma.sync`` kernel
  (``attn_kernel``) on the same operands, the baseline; ``one_tf32`` —
  hi.hi alone in both chains (the mma.sync kernel's too); ``f32_kv32`` — kv
  tiles of 32 rows at D 64 (of 64); ``f32_ring3`` — a ring of 3 stages
  (one shallower at D 160, where 4 fit); ``f32_stages2`` — a ring of 2
  stages at every D; ``pv_ahead`` — P V's next pass issued before the
  last is folded in (two fresh accumulators in turn); ``kv_one_wg`` —
  warpgroup 0 walks every kv tile (no split of the kv walk between the
  two consumer warpgroups); ``o_in_place`` — P V summed straight into O
  scaled by alpha, with no fresh accumulator (fewer registers; the
  truncating accumulator's drift over the whole kv walk, which the main
  path's chain does not hold); and the ablation ``no_mma`` — no products
  in either chain (the loads, the splits of K lo and V^T, the softmax
  and the barriers alone); each also at Qwen3-8B's and StableLM-12B's
  f32 prefill shapes (D 128 and 160), bitwise run to run or not;
* ``p_one_bf16`` — the bf16 attention's P V with P as one bf16 term (hi
  only): the speed that rounding P to bf16, as SDPA does, buys; it must
  fail the one-ulp check;
* ``stages2`` — the bf16 attention's ring of K / V tiles two deep
  instead of three (where three fit);
* ``kv32``, ``kv64``, ``kv128`` — the bf16 attention's kv tiles 32, 64
  or 128 rows at every D (shipped: 64 at D 128, 32 elsewhere);
* ``no_split``, ``no_softmax`` — ablations of the bf16 attention (wrong
  results, timed only): P's lo term without its split (lo = hi), and no
  softmax at all (S straight into P's terms, alpha 1): what the split and
  the whole softmax cost beside the products and the pipeline;
* for the bf16 SSD scan (``state_wgmma_kernel``, ``chunk_out_kernel``
  at N <= 64, ``out_wgmma_kernel`` above): ``qtile`` — N <= 64 through
  the q-tile kernel too (a block a 128-row q tile, b and v streamed
  through a ring) instead of a block a chunk; ``stages2`` — the q-tile
  kernel's ring two deep instead of three; ``kv64`` — kv tiles of 64
  rows instead of 32 in both; ``s_three`` and ``w_three`` — S_in, and
  w o v in the chunk states, as three bf16 terms instead of two;
  ``g_two`` — G as two bf16 terms instead of three (fails one ulp at the
  mLSTM's shape); and the ablations (wrong results, timed only) ``g_one_bf16`` — G as one bf16 term — ``no_inter``
  — S_in in no terms, no inter term — ``no_decay`` — G without its decay
  and mask — ``no_gv`` — no G v products — and ``score_p0`` — the
  score c b^T skipped by ``out_wgmma_kernel``'s blocks of P's column tiles
  past the first: at the mLSTM's P = 385 each of the 7 tiles' blocks
  computes the q tile's score over all of N, so this is what computing it
  once per (chunk, q tile) could save at most;
* for the decode step (``ssd_step_kernel``, at ``chip_smoke.py``'s
  ``SSD_STEP_CASES``, a CUDA graph over ``SSD_STEP_STATES`` states in
  turn): ``step_scalar`` — one float a column at every P (no 16-byte
  rows); ``step_unroll1`` — each row stored before the next is loaded (no
  batch of loads in flight); ``step_cached`` — Zamba2's 16-byte rows
  without the streaming hints; ``step_tile64`` — 64 column units a block
  (fewer, larger blocks at the mLSTM's P = 385); each against the bytes
  bound, and whether it gives the shipped kernel's bits.

The bf16 attention's variants also run at the zoo's three prefill shapes
(Llama-3.2-1B, Qwen3-8B and StableLM-12B: q (4, 1024, 32, D), k/v 8
heads, causal), each with its distance in bf16 ulps from the shipped f32
kernel on the upcast inputs (``bf16_ulps``) beside SDPA's; the bf16 SSD
scan's at Zamba2-2.7B's and xLSTM-125M's prefill shapes (chunk 256), each
with its distance in ulps and its final state's error from the shipped
f32 kernel, beside the plain version's.  Arguments
name kernels to run alone (default all four), e.g.
``python3 kernel_variants.py flash_attention``.

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
# the f32 expert GLU (namespace tc of expert_glu.cu): its route, fold,
# products, token tile and the split of B's lo term
GLU_ROUTE = "if (tc::tma_route(x, w_up, w_down, act, d, F))"
GLU_FOLD = "constexpr int FOLD = 4;"
GLU_THREE = ("hopper::WgmmaTf32<BM>::rs(part, al[kk], dh, !(fresh && kk == 0));\n"
             "      hopper::WgmmaTf32<BM>::rs(part, ah[kk], dl, 1);\n"
             "      hopper::WgmmaTf32<BM>::rs(part, ah[kk], dh, 1);")
GLU_TWO = ("hopper::WgmmaTf32<BM>::rs(part, ah[kk], dl, !(fresh && kk == 0));\n"
           "      hopper::WgmmaTf32<BM>::rs(part, ah[kk], dh, 1);")
GLU_ONE = "hopper::WgmmaTf32<BM>::rs(part, ah[kk], dh, !(fresh && kk == 0));"
GLU_BM = "constexpr int BM = 128;     // token rows a block: the wgmma's N"
GLU_SPLIT = "  for (int q = 0; q < STEPS; ++q) {"
GLU_RING = "constexpr int STAGES = 3;   // the ring"
# the bf16 expert GLU (namespace bf of expert_glu.cu): its route, ring,
# token-tile rule and products
BF_ROUTE = "if (bf::tma_route(x, w_up, w_down, act, y, d, F))"
BF_RING = "constexpr int STAGES = 4;   // the ring of TMA stages"
BF_NARROW = "const bool narrow = cap <= 128;"
BF_MMA = ("        hopper::Wgmma<128>::ss_t(\n"
          "            acc[i], hopper::make_desc(a + i * 8192 + kk * 32, 16, "
          "1024, 128),\n"
          "            db, kt > 0 || kk > 0);")
# the mma.sync f32 attention (attn_kernel)
ATTN_THREE = ("  bident::mma_tf32(c, al, bh);\n"
              "  bident::mma_tf32(c, ah, bl);\n"
              "  bident::mma_tf32(c, ah, bh);")
ATTN_ONE = "  bident::mma_tf32(c, ah, bh);"
# the f32 attention on TF32 wgmma (namespace tf of flash_attention.cu):
# its route, both chains' three products, kv tile, stages, and the split
# of the kv tiles between its two consumer warpgroups
ATTN_ROUTE = "if (tf::tma_route(q, k, v, D))"
TF_S_THREE = ("    hopper::WgmmaTf32<C::BK>::ss(sc, hopper::make_desc(ql + qo, 16, 1024, 128),\n"
              "                                 dk, kk > 0);\n"
              "    hopper::WgmmaTf32<C::BK>::ss(sc, dq, hopper::make_desc(kl + ko, 16, 1024, 128), 1);\n"
              "    hopper::WgmmaTf32<C::BK>::ss(sc, dq, dk, 1);")
TF_S_ONE = "    hopper::WgmmaTf32<C::BK>::ss(sc, dq, dk, kk > 0);"
TF_PV_THREE = ("    hopper::WgmmaTf32<DH>::rs(pv, lo[kk], dh, kk > 0);\n"
               "    hopper::WgmmaTf32<DH>::rs(pv, hi[kk], hopper::make_desc(vtl + off, 16, 8 * C::VT_SW, C::VT_SW), 1);\n"
               "    hopper::WgmmaTf32<DH>::rs(pv, hi[kk], dh, 1);")
TF_PV_ONE = "    hopper::WgmmaTf32<DH>::rs(pv, hi[kk], dh, kk > 0);"
TF_KV = "return D == 160 ? 16 : D == 128 ? 32 : 64;"
TF_RING = "constexpr int RING = 4;"
TF_WALK = "for (int j = w; j < nk; j += 2) {"
TF_FOLD = """    // O = O alpha + P V with an f32 add, DH columns a pass
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += DH) {
      float pv[DH / 2];
      pv_mma<D, DH, BK>(pv, hi, lo, vth + c0 * C::VT_SW, vtl + c0 * C::VT_SW);
      hopper::wgmma_wait<0>();
      hopper::reg_fence(pv);
#pragma unroll
      for (int x = 0; x < DH / 2; ++x)
        acc[c0 / 2 + x] = acc[c0 / 2 + x] * alpha[(x >> 1) & 1] + pv[x];
    }
"""
TF_IN_PLACE = """#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] *= alpha[(x >> 1) & 1];
    pv_mma<D, D, BK>(acc, hi, lo, vth, vtl);
    hopper::wgmma_wait<0>();
    hopper::reg_fence(acc);
"""
TF_PV_AHEAD = """    // O = O alpha + P V with an f32 add, DH columns a pass, each pass
    // issued before the last is folded in
    float pv[2][DH / 2];
    pv_mma<D, DH, BK>(pv[0], hi, lo, vth, vtl);
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += DH) {
      float (&cur)[DH / 2] = pv[c0 / DH & 1];
      if (c0 + DH < D) {
        pv_mma<D, DH, BK>(pv[(c0 / DH + 1) & 1], hi, lo,
                          vth + (c0 + DH) * C::VT_SW, vtl + (c0 + DH) * C::VT_SW);
        hopper::wgmma_wait<1>();
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::reg_fence(cur);
#pragma unroll
      for (int x = 0; x < DH / 2; ++x)
        acc[c0 / 2 + x] = acc[c0 / 2 + x] * alpha[(x >> 1) & 1] + cur[x];
    }
"""
TF_PV_FIRST = "hopper::WgmmaTf32<DH>::rs(pv, lo[kk], dh, kk > 0);"
# the f32 SSD scan on TF32 wgmma (namespace tf of ssd_scan.cu): its
# route, the three products of each of its chains (the chunk states, c b^T
# and c S_in, G v), its folds, the state tile's rule and the rings
SSD_ROUTE = "if (tf::tma_route(c, b, v, N, P))"
SSD_ST_THREE = ("      hopper::WgmmaTf32<NS>::rs(part, ah[kk], bl, !(fresh && kk == 0));\n"
                "      hopper::WgmmaTf32<NS>::rs(part, al[kk], bh, 1);\n"
                "      hopper::WgmmaTf32<NS>::rs(part, ah[kk], bh, 1);\n")
SSD_ST_ONE = "      hopper::WgmmaTf32<NS>::rs(part, ah[kk], bh, !(fresh && kk == 0));\n"
SSD_C_THREE = ("      M::rs(d, cl[kk], dh, kk > k0);\n"
               "      M::rs(d, ch[kk], dl, 1);\n"
               "      M::rs(d, ch[kk], dh, 1);\n")
SSD_C_ONE = "      M::rs(d, ch[kk], dh, kk > k0);\n"
SSD_GV_THREE = ("      hopper::WgmmaTf32<PW>::rs(part, gl[kk], dh, kk > 0);\n"
                "      hopper::WgmmaTf32<PW>::rs(part, gh[kk], kdesc(vtl, kk), 1);\n"
                "      hopper::WgmmaTf32<PW>::rs(part, gh[kk], dh, 1);\n")
SSD_GV_ONE = "      hopper::WgmmaTf32<PW>::rs(part, gh[kk], dh, kk > 0);\n"
# the wide outputs kernel's three products (every chain of it: two
# interleaved, or one in two halves), its ring, its score, and the C
# entry's route for v where TMA cannot read it
SSD_WIDE_THREE = ("      M::rs(da, al[kk], h0, kk > 0);\n"
                  "      if (two) M::rs(db, al[kk + 4], h1, kk > 0);\n"
                  "      M::rs(da, ah[kk], l0, 1);\n"
                  "      if (two) M::rs(db, ah[kk + 4], l1, 1);\n"
                  "      M::rs(da, ah[kk], h0, 1);\n"
                  "      if (two) M::rs(db, ah[kk + 4], h1, 1);\n")
SSD_WIDE_ONE = ("      M::rs(da, ah[kk], h0, kk > 0);\n"
                "      if (two) M::rs(db, ah[kk + 4], h1, kk > 0);\n")
SSD_WIDE_THREE_B = ("        M::rs(da, al[kk + 4], h1, 1);\n"
                    "        M::rs(da, ah[kk + 4], kdesc(yl1, kk), 1);\n"
                    "        M::rs(da, ah[kk + 4], h1, 1);\n")
SSD_WIDE_ONE_B = "        M::rs(da, ah[kk + 4], h1, 1);\n"
SSD_WIDE_RING = "constexpr int WIDE_STAGES = 2;"
SSD_WIDE_SPLITS = "constexpr int WIDE_SPLITS = 2;"
SSD_WIDE_SPLIT_WARPS = "constexpr int WIDE_SPLIT_WARPS = 3;"
SSD_WIDE_SCORE = ("    products(sb, sb + 2 * SUB64, sb + SUB64, sb + 3 * SUB64, "
                  "gv || TWO);")
SSD_FOLDS = ("constexpr int ST_FOLD = 32;", "constexpr int N_FOLD = 32;")
SSD_COLS = "return 2 * blocks64 <= SMS ? 32 : 64;"
SSD_OUT_RING = "constexpr int OUT_STAGES = 3;"
SSD_ST_RING = "constexpr int ST_STAGES = 6;    // b / v tiles in flight, state kernel"
SSD_NSPLIT = "constexpr int NSPLIT = 2;"
SSD_STAGE = "      for (int e = si; e < NS * KVT / 8; e += 128)"
SSD_SPLIT = ("    split_tile(st, st, bf + L::BL, 2 * SUB, i, 128);\n#pragma unroll\n"
             "    for (int e = i; e < PW * KVT / 8; e += 128)")
SSD_DECAY_F32 = ("        const float gv = x * expf(cum_i[hr] - cum[col]);\n"
                 "        gx[e] = !mask || (col <= row && row < Cv) ? gv : 0.f;")
PV_LO = ("#pragma unroll\n"
         "  for (int kk = 0; kk < BK / 16; ++kk)\n"
         "    hopper::Wgmma<D>::rs(acc, lo[kk],\n"
         "                         hopper::make_desc(vs + kk * 16 * C::SW, "
         "C::KV_SUB,\n"
         "                                           8 * C::SW, C::SW));\n")
KV_TILE = "return D == 128 ? 64 : 32;"
SPLIT_LO = ("const __nv_bfloat162 pl = __floats2bfloat162_rn(x0 - __low2float(ph),\n"
            "                                                      x1 - __high2float(ph));")
SOFTMAX = "                                        int causal, int t) {\n"
STAGES = "constexpr int MAX_STAGES = 3;"
# the bf16 SSD scan's chunk outputs (namespace wg of ssd_scan.cu)
SSD_KV = "constexpr int KV = 32;"
SSD_S_TERMS = "constexpr int S_TERMS = 2;"
SSD_G_TERMS = "constexpr int G_TERMS = 3;"
SSD_CHUNK = "if (nsub == 1)"
SSD_DECAY = ("                                      int Cv, int kbase, "
             "bool mask, int t) {\n")
SSD_GV = """  hopper::wgmma_fence();
#pragma unroll
  for (int term = 0; term < G_TERMS; ++term)"""
SSD_W_TERMS = "constexpr int W_TERMS = 2;"
SSD_SCORE = ", L.c_sub(), nsub);"   # out_wgmma_kernel's two score calls

# the decode step's route to 16-byte rows, its rows loaded together,
# its streaming loads and stores, its column tile
STEP_VEC = "if (P % 4 == 0 && aligned16(S))"
STEP_UNROLL = "constexpr int UNROLL = 4;"
STEP_LOAD = "const float4 t = __ldcs(reinterpret_cast<const float4*>(p));"
STEP_STORE = ("__stcs(reinterpret_cast<float4*>(p), make_float4(s[0], s[1], "
              "s[2], s[3]));")
STEP_TILE = "constexpr int TILE_UNITS = 16;"

# variant -> {file: [(old, new), ...]}; each kernel builds with its own
# copy of common.cuh
VARIANTS = {
    "shipped": {},
    "cvt_rna": {"common.cuh": [(SPLIT, CVT_RNA)]},
    # the f32 expert GLU: the mma.sync gemm_kernel (cp.async) on the
    # aligned rows, the baseline; one fold per stage (K 32) or none (one
    # chain over K); the token tile at 64; a ring of 4 stages (of 3);
    # and the ablations (wrong
    # results, timed only) without a_lo.b_hi, hi.hi alone (as for every
    # kernel: the products' speed ceiling; at the GLU it also shows whether
    # the tensor cores truncate or round B's raw bits), no split pass (B's
    # lo tile left as it lies) and no products at all (the loads, splits
    # and barriers alone)
    "mma_sync": {"expert_glu.cu": [(GLU_ROUTE, GLU_ROUTE.replace(
        "if (", "if (false && ")), ("return run<float, false>(",
                                     "return dispatch<float>("),
                                    (BF_ROUTE, BF_ROUTE.replace(
                                        "if (", "if (false && "))],
                 "flash_attention.cu": [(ATTN_ROUTE, ATTN_ROUTE.replace(
                     "if (", "if (false && "))],
                 "ssd_scan.cu": [(SSD_ROUTE, SSD_ROUTE.replace(
                     "if (", "if (false && "))]},
    "fold1": {"expert_glu.cu": [(GLU_FOLD, GLU_FOLD.replace("4", "1"))]},
    "no_fold": {"expert_glu.cu": [(GLU_FOLD, GLU_FOLD.replace(
        "4", "1 << 30"))]},
    "bm64": {"expert_glu.cu": [(GLU_BM, GLU_BM.replace("128", "64"))]},
    "no_lohi": {"expert_glu.cu": [(GLU_THREE, GLU_TWO)]},
    "no_bsplit": {"expert_glu.cu": [(GLU_SPLIT, GLU_SPLIT.replace(
        "q < STEPS", "q < 0"))]},
    "no_mma": {"expert_glu.cu": [(GLU_THREE, ""), (BF_MMA, "        ;")],
               "flash_attention.cu": [(TF_S_THREE, ""), (TF_PV_THREE, "")],
               "ssd_scan.cu": [(SSD_ST_THREE, ""), (SSD_C_THREE, ""),
                               (SSD_GV_THREE, ""), (SSD_WIDE_THREE, ""),
                               (SSD_WIDE_THREE_B, "")]},
    "ring4": {"expert_glu.cu": [(GLU_RING, GLU_RING.replace("3;", "4;"))]},
    # the bf16 expert GLU: a ring of 3 stages (of 4; 5 do not fit); the
    # 128-row token tile at every cap (each weight tile read by two blocks
    # at cap 256)
    "ring3": {"expert_glu.cu": [(BF_RING, BF_RING.replace("4;", "3;"))]},
    "bm128": {"expert_glu.cu": [(BF_NARROW, "const bool narrow = true;")]},
    "one_tf32": {"expert_glu.cu": [(GLU_THREE, GLU_ONE)],
                 "flash_attention.cu": [(ATTN_THREE, ATTN_ONE),
                                        (TF_S_THREE, TF_S_ONE),
                                        (TF_PV_THREE, TF_PV_ONE)],
                 "ssd_scan.cu": [(SSD_ST_THREE, SSD_ST_ONE),
                                 (SSD_C_THREE, SSD_C_ONE),
                                 (SSD_GV_THREE, SSD_GV_ONE),
                                 (SSD_WIDE_THREE, SSD_WIDE_ONE),
                                 (SSD_WIDE_THREE_B, SSD_WIDE_ONE_B)]},
    "fold64": {"ssd_scan.cu": [(f, f.replace("32;", "64;"))
                               for f in SSD_FOLDS]},
    "p_one_bf16": {"flash_attention.cu": [(PV_LO, "")]},
    "stages2": {"flash_attention.cu": [(STAGES, STAGES.replace("3", "2"))],
                "ssd_scan.cu": [(STAGES, STAGES.replace("3", "2"))]},
    "kv32": {"flash_attention.cu": [(KV_TILE, "return 32;")]},
    "kv64": {"flash_attention.cu": [(KV_TILE, "return 64;")],
             "ssd_scan.cu": [(SSD_KV, SSD_KV.replace("32", "64"))]},
    "kv128": {"flash_attention.cu": [(KV_TILE, "return 128;")]},
    # the bf16 SSD scan: the chunk outputs through the q-tile kernel, or a
    # block a chunk; S_in, w o v as three bf16 terms, G as two
    "qtile": {"ssd_scan.cu": [(SSD_CHUNK, "if (false)")]},
    "s_three": {"ssd_scan.cu": [(SSD_S_TERMS, SSD_S_TERMS.replace("2", "3"))]},
    "w_three": {"ssd_scan.cu": [(SSD_W_TERMS, SSD_W_TERMS.replace("2", "3"))]},
    "g_two": {"ssd_scan.cu": [(SSD_G_TERMS, SSD_G_TERMS.replace("3", "2"))]},
    # ablations of the bf16 SSD scan (wrong results, timed only): G as one
    # bf16 term (must fail one ulp), no inter term, no decay, no G v, the
    # q-tile kernel's score only in the blocks of P's first column tile
    "g_one_bf16": {"ssd_scan.cu": [(SSD_G_TERMS,
                                    SSD_G_TERMS.replace("3", "1"))]},
    "no_inter": {"ssd_scan.cu": [(SSD_S_TERMS, SSD_S_TERMS.replace("2", "0"))]},
    "no_decay": {"ssd_scan.cu": [(SSD_DECAY, SSD_DECAY + "  return;\n")]},
    "no_gv": {"ssd_scan.cu": [(SSD_GV, SSD_GV.replace("term < G_TERMS",
                                                      "term < 0"))]},
    "score_p0": {"ssd_scan.cu": [(SSD_SCORE, SSD_SCORE.replace(
        "nsub)", "pt ? 0 : nsub)"))]},
    # the f32 attention on TF32 wgmma: kv tiles of 32 rows at D 64 (of
    # 64), a ring of 2 stages at every D, one stage shallower at D 160 (3
    # of 4), and warpgroup 0 walking every kv tile (warpgroup 1 none: no
    # split of the kv walk, nothing to merge)
    "f32_kv32": {"flash_attention.cu": [(TF_KV, "return D == 160 ? 16 : 32;")]},
    "f32_ring3": {"flash_attention.cu": [(TF_RING, TF_RING.replace(
        "4;", "3;"))]},
    # P V's passes each issued before the last is folded in (two fresh
    # accumulators in turn)
    "pv_ahead": {"flash_attention.cu": [(TF_FOLD, TF_PV_AHEAD)]},
    "f32_stages2": {"flash_attention.cu": [(TF_RING, TF_RING.replace(
        "4;", "2;"))],
                    "ssd_scan.cu": [(SSD_OUT_RING, SSD_OUT_RING.replace(
                        "3", "2"))]},
    # the f32 SSD scan on TF32 wgmma: the state kernel's block over 32 or
    # 64 state rows at every grid (shipped: 32 where 64 would leave half
    # the SMs without a walker), its ring 3 deep (of 6)
    "st32": {"ssd_scan.cu": [(SSD_COLS, "return 32;")]},
    "st64": {"ssd_scan.cu": [(SSD_COLS, "return 64;")]},
    "st_stages3": {"ssd_scan.cu": [(SSD_ST_RING, SSD_ST_RING.replace(
        "6;", "3;"))]},
    # ... and its outputs kernel with one split buffer, two blocks an SM
    "out_1buf": {"ssd_scan.cu": [(SSD_NSPLIT, SSD_NSPLIT.replace("2", "1"))]},
    # ablations of the f32 SSD scan (wrong results, timed only): the state
    # kernel without its staging of (w o b)^T, and with neither staging
    # nor products (its loads, fragment reads and barriers alone); the
    # outputs kernel without its kv tiles' split, and without the decay
    "no_stage": {"ssd_scan.cu": [(SSD_STAGE, SSD_STAGE.replace(
        "e < NS * KVT / 8", "e < 0"))]},
    "walk_loads": {"ssd_scan.cu": [(SSD_STAGE, SSD_STAGE.replace(
        "e < NS * KVT / 8", "e < 0")), (SSD_ST_THREE, "")]},
    "no_kv_split": {"ssd_scan.cu": [(SSD_SPLIT, "#pragma unroll\n    for (int e = i; "
                                  "e < 0; e += 128)")]},
    "no_decay_f32": {"ssd_scan.cu": [(SSD_DECAY_F32, "        gx[e] = x;")]},
    # the f32 SSD scan above N = 64: the wide outputs kernel's ring 3
    # deep (of 2; 4 do not fit beside c and two split buffers at N = 448),
    # one split buffer (of 2: the splits and the products in turn); and
    # the ablation (wrong results, timed only) with the score only in the
    # blocks of P's first column tile: what computing it once per (chunk,
    # q tile) could save at most
    "wide_ring3": {"ssd_scan.cu": [(SSD_WIDE_RING, SSD_WIDE_RING.replace(
        "2;", "3;"))]},
    "wide_splits1": {"ssd_scan.cu": [(SSD_WIDE_SPLITS, SSD_WIDE_SPLITS.replace(
        "2;", "1;"))]},
    "wide_split4": {"ssd_scan.cu": [(SSD_WIDE_SPLIT_WARPS,
                                     SSD_WIDE_SPLIT_WARPS.replace("3;", "4;"))]},
    "wide_score_p0": {"ssd_scan.cu": [(SSD_WIDE_SCORE, (
        "    if (it < NI || gv || pt == 0)\n  " + SSD_WIDE_SCORE))]},
    "kv_one_wg": {"flash_attention.cu": [(TF_WALK, (
        "for (int j = 0; j < (w == 0 ? nk : 0); ++j) {"))]},
    # P V summed straight into O scaled by alpha (no fresh accumulator)
    "o_in_place": {"flash_attention.cu": [
        (TF_FOLD, TF_IN_PLACE),
        (TF_PV_FIRST, TF_PV_FIRST.replace("kk > 0", "1"))]},
    # ablations of the bf16 attention's softmax (wrong results; what each
    # part of the per-pair work costs)
    "no_split": {"flash_attention.cu": [(SPLIT_LO, "const __nv_bfloat162 pl = ph;")]},
    "no_softmax": {"flash_attention.cu": [
        (SOFTMAX, SOFTMAX + "  alpha[0] = alpha[1] = 1.f;\n  return;\n")]},
    "step_scalar": {"ssd_step.cu": [(STEP_VEC, "if (false)")]},
    "step_unroll1": {"ssd_step.cu": [(STEP_UNROLL, STEP_UNROLL.replace(
        "4", "1"))]},
    "step_cached": {"ssd_step.cu": [
        (STEP_LOAD, "const float4 t = *reinterpret_cast<const float4*>(p);"),
        (STEP_STORE, "*reinterpret_cast<float4*>(p) = "
                     "make_float4(s[0], s[1], s[2], s[3]);")]},
    "step_tile64": {"ssd_step.cu": [(STEP_TILE, STEP_TILE.replace("16", "64"))]},
}
# the decode step's variants
STEP_VARIANTS = ("shipped", "step_scalar", "step_unroll1", "step_cached",
                 "step_tile64")
# the bf16 attention at the zoo's prefill shapes: (arch, its variants)
ZOO_ATTENTION = ("llama3.2-1b", "qwen3-8b", "stablelm-12b")
ATTN_BF16 = ("shipped", "p_one_bf16", "stages2", "kv32", "kv64", "kv128",
             "no_split", "no_softmax")
# the f32 attention's variants, at the main path and at Qwen3-8B's and
# StableLM-12B's f32 prefill shapes
ATTN_F32 = ("shipped", "mma_sync", "cvt_rna", "one_tf32", "no_mma",
            "f32_kv32", "f32_ring3", "f32_stages2", "pv_ahead", "kv_one_wg",
            "o_in_place")
ZOO_ATTENTION_F32 = ("qwen3-8b", "stablelm-12b")
# the bf16 SSD scan at the zoo's prefill shapes, chunk 256: (arch, c/b
# shape, v shape, v's last column ones), and its variants
ZOO_SSD = (("zamba2-2.7b", (4, 1024, 80, 64), (4, 1024, 80, 64), False),
           ("xlstm-125m", (4, 1024, 4, 384), (4, 1024, 4, 385), True))
SSD_BF16 = ("shipped", "qtile", "stages2", "kv64", "s_three", "w_three",
            "g_two", "g_one_bf16", "no_inter", "no_decay", "no_gv",
            "score_p0")
# the f32 SSD scan's variants, at the main path's widths and at
# Zamba2-2.7B's f32 prefill shape (N = 64); above N = 64 (the wide
# outputs kernel) at xLSTM-125M's mLSTM f32 prefill shape
SSD_F32 = ("shipped", "mma_sync", "cvt_rna", "one_tf32", "fold64", "no_mma",
           "st32", "st64", "f32_stages2", "st_stages3", "out_1buf",
           "no_stage", "walk_loads", "no_kv_split", "no_decay_f32")
SSD_F32_WIDE = ("shipped", "mma_sync", "cvt_rna", "one_tf32", "fold64",
                "no_mma", "st32", "st64", "st_stages3", "no_stage",
                "walk_loads", "wide_ring3", "wide_splits1", "wide_split4",
                "wide_score_p0")
ZOO_SSD_F32 = (("zamba2-2.7b", (4, 1024, 80, 64), (4, 1024, 80, 64), False),
               ("xlstm-125m", (4, 1024, 4, 384), (4, 1024, 4, 385), True))
# the expert GLU's variants in each dtype (the f32 ones change the TF32
# design, the bf16 ones the bf16 design; mma_sync and no_mma both)
GLU_F32 = ("shipped", "mma_sync", "cvt_rna", "one_tf32", "fold1", "no_fold",
           "bm64", "ring4", "no_lohi", "no_bsplit", "no_mma")
GLU_BF16 = ("shipped", "mma_sync", "ring3", "bm128", "no_mma")
# (E, cap, d, F) of DeepSeek-V3's experts (configs/deepseek_v3_671b.py):
# one rank's 32 of 256 experts under an 8-way expert split, 8192 routed
# tokens of a prefill (top-8) spread over the 256
DEEPSEEK_GLU = (32, 256, 7168, 2048)
KERNELS = ("expert_glu", "flash_attention", "ssd_scan", "ssd_step")

_log_lines: list[str] = []


def log(msg: str = "") -> None:
    print(msg, flush=True)
    _log_lines.append(msg)


def sources(variant: str, kernel: str) -> dict[str, str] | None:
    """The variant's copy of ``kernel``'s sources (its ``.cu`` and every
    header it includes), or None where the variant leaves that kernel as
    shipped (and it is not ``shipped``)."""
    from repro_torch.kernels import _build
    files = {f.name: f.read_text() for f in _build.sources(kernel)}
    subs = VARIANTS[variant]
    touched = [f for f in subs if f in files]
    if variant != "shipped" and not touched:
        return None
    for f in touched:
        for old, new in subs[f]:
            if old not in files[f]:
                raise RuntimeError(f"variant {variant}: {f} no longer holds "
                                   f"{old!r}")
            files[f] = files[f].replace(old, new)
    return files


def build(kernels=KERNELS, variants=None) -> dict[tuple[str, str],
                                                  ctypes.CDLL]:
    """Every (variant, kernel) library (of ``variants``, default all), one
    nvcc each, all in parallel."""
    return finish(start(kernels, variants))


def start(kernels=KERNELS, variants=None) -> dict:
    """Start the builds of :func:`build`; :func:`finish` waits for them."""
    from repro_torch.kernels import _build
    procs = {}
    for variant in variants or VARIANTS:
        for kernel in kernels:
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
    return procs


def finish(procs: dict) -> dict[tuple[str, str], ctypes.CDLL]:
    """Wait for the builds :func:`start` began; their libraries, loaded."""
    from repro_torch.kernels import _build
    libs = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key} build failed:\n{out}")
        usage = _build.ptxas_usage(out)
        serialized = [line.split("function '")[-1].split("'")[0]
                      for line in out.splitlines() if "C7515" in line]
        for name in _build.demangle(serialized):
            log(f"    wgmma serialized in {name[:name.find('>(') + 1]}")
        log(f"  {key[0]:9s} {key[1]:16s} registers "
            f"{min(u['registers'] for u in usage)}-"
            f"{max(u['registers'] for u in usage)}, spill stores up to "
            f"{max(u['spill_stores'] for u in usage)} B, wgmma serialized "
            f"in {out.count('C7515')} functions")
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


def _zoo_attention(libs, rand, stream) -> None:
    """The bf16 attention's variants at the zoo's prefill shapes: time,
    error over the plain version's largest output, and the distance in
    bf16 ulps from the shipped f32 kernel on the upcast inputs (SDPA's
    beside it)."""
    import torch
    import torch.nn.functional as F_
    from chip_smoke import norm_err, time_ms
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    bf16 = torch.bfloat16
    for arch in ZOO_ATTENTION:
        cfg = get_config(arch)
        B, T, Hq, Hk, D = 4, 1024, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        q = rand((B, T, Hq, D), bf16)
        k, v = rand((B, T, Hk, D), bf16), rand((B, T, Hk, D), bf16)
        want = fa.flash_attention_plain(q, k, v)
        ref = fa.flash_attention_cuda(q.float(), k.float(),
                                      v.float()).to(bf16)
        qh = q.transpose(1, 2)
        kh, vh = (x.repeat_interleave(Hq // Hk, dim=2).transpose(1, 2)
                  for x in (k, v))
        sdpa = F_.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        log(f"flash_attention bf16 at {arch}'s prefill, q {tuple(q.shape)}, "
            f"k/v {tuple(k.shape)}, causal: SDPA "
            f"{time_ms(lambda: F_.scaled_dot_product_attention(qh, kh, vh, is_causal=True), iters=20):.4f} ms, "
            f"{fa.bf16_ulps(sdpa.transpose(1, 2), ref):.2f} ulps")
        o = torch.empty_like(q)
        for variant in ATTN_BF16:
            if (variant, "flash_attention") not in libs:
                continue
            fn = bind(libs[variant, "flash_attention"], "flash_attention")

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), B, T, T, Hq, Hk, D, 1, 0, 1, stream)
                if err:
                    raise RuntimeError(f"{variant}: cudaError_t {err}")
            call()
            torch.cuda.synchronize()
            log(f"  {variant:10s} {time_ms(call, iters=20):.4f} ms, error / "
                f"max|plain| {norm_err(o, want)[1]:.3e}, "
                f"{fa.bf16_ulps(o, ref):.2f} ulps")


def _zoo_attention_f32(libs, rand, stream) -> None:
    """The f32 attention's variants at Qwen3-8B's and StableLM-12B's f32
    prefill shapes (q (4, 1024, 32, D), k/v 8 heads, causal; D 128 and
    160): time, error over the plain version's largest output, and whether
    two runs agree bitwise, beside SDPA's time."""
    import torch
    import torch.nn.functional as F_
    from chip_smoke import norm_err, time_ms
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    f32 = torch.float32
    for arch in ZOO_ATTENTION_F32:
        cfg = get_config(arch)
        B, T, Hq, Hk, D = 4, 1024, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        q = rand((B, T, Hq, D), f32)
        k, v = rand((B, T, Hk, D), f32), rand((B, T, Hk, D), f32)
        want = fa.flash_attention_plain(q, k, v)
        qh = q.transpose(1, 2)
        kh, vh = (x.repeat_interleave(Hq // Hk, dim=2).transpose(1, 2)
                  for x in (k, v))
        log(f"flash_attention float32 at {arch}'s prefill, q "
            f"{tuple(q.shape)}, k/v {tuple(k.shape)}, causal: SDPA "
            f"{time_ms(lambda: F_.scaled_dot_product_attention(qh, kh, vh, is_causal=True), iters=20):.4f} ms")
        o = torch.empty_like(q)
        for variant in ATTN_F32:
            if (variant, "flash_attention") not in libs:
                continue
            fn = bind(libs[variant, "flash_attention"], "flash_attention")

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), B, T, T, Hq, Hk, D, 1, 0, 0, stream)
                if err:
                    raise RuntimeError(f"{variant}: cudaError_t {err}")
            call()
            torch.cuda.synchronize()
            first = o.clone()
            call()
            torch.cuda.synchronize()
            log(f"  {variant:11s} {time_ms(call, iters=20):.4f} ms, error / "
                f"max|plain| {norm_err(o, want)[1]:.3e}"
                + ("" if torch.equal(o, first) else
                   ", NOT bitwise run to run"))
        del q, k, v, want, o, qh, kh, vh


def _ssd_f64(c, b, v, la, C):
    """y of the chunked SSD algebra in f64 (``ssd_scan_plain``'s phases
    without their f32 casts), for T a multiple of C."""
    import torch
    B, T, H, N = c.shape
    nc = T // C

    def ch(x):
        return x.double().transpose(1, 2).reshape(B, H, nc, C, *x.shape[3:])
    cf, bf, vf, cum = ch(c), ch(b), ch(v), torch.cumsum(ch(la), dim=-1)
    tot = cum[..., -1]
    states = (bf * torch.exp(tot[..., None] - cum)[..., None]).transpose(
        -1, -2) @ vf
    S = torch.zeros_like(states[:, :, 0])
    s_in = []
    for i in range(nc):
        s_in.append(S)
        S = S * torch.exp(tot[:, :, i, None, None]) + states[:, :, i]
    lower = torch.tril(torch.ones((C, C), dtype=torch.bool, device=c.device))
    diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~lower, -1e300)
    y = ((cf @ bf.transpose(-1, -2)) * torch.exp(diff)) @ vf \
        + (cf * torch.exp(cum)[..., None]) @ torch.stack(s_in, dim=2)
    return y.reshape(B, H, T, -1).transpose(1, 2)


def _zoo_ssd(libs, rand, stream) -> None:
    """The bf16 SSD scan's variants at the zoo's prefill shapes (chunk
    256): time of the C entry point, and the distance in bf16 ulps of y
    and the final state's error over its largest value, both from the
    shipped f32 kernel on the upcast inputs (the plain version's
    beside them)."""
    import torch
    import torch.nn.functional as F_
    from chip_smoke import norm_err, time_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    bf16, C = torch.bfloat16, 256
    for arch, cb, vs, ones in ZOO_SSD:
        B, T, H, N = cb
        P = vs[-1]
        c, b = rand(cb, bf16, .5), rand(cb, bf16, .5)
        v = rand(vs, bf16)
        if ones:
            v[..., -1] = 1
        la = -F_.softplus(rand((B, T, H), torch.float32))
        y_ref, s_ref = ss.ssd_scan_cuda(c.float(), b.float(), v.float(), la,
                                        chunk=C)
        y_ref = y_ref.to(bf16)
        yp, sp = ss.ssd_scan_plain(c, b, v, la, chunk=C)
        # the same algebra in f64: how far the f32 kernel itself lies
        y64 = _ssd_f64(c, b, v, la, C).to(bf16)
        log(f"ssd_scan bf16 at {arch}'s prefill, c/b {cb}, v {vs}, chunk "
            f"{C}: plain {fa.bf16_ulps(yp, y_ref):.2f} ulps, state "
            f"{norm_err(sp, s_ref)[1]:.2e}; from the f64 algebra: f32 "
            f"kernel {fa.bf16_ulps(y_ref, y64):.2f} ulps, plain "
            f"{fa.bf16_ulps(yp, y64):.2f} ulps")
        del yp, sp
        y, s = torch.empty_like(v), torch.empty_like(s_ref)
        work = torch.empty(ss.scratch_floats(c, b, v, C), device="cuda")
        for variant in SSD_BF16:
            if (variant, "ssd_scan") not in libs:
                continue
            call = _ssd_call(libs, variant, c, b, v, la, y, s, work, C,
                             stream)
            try:
                call()
                torch.cuda.synchronize()
            except RuntimeError as e:
                log(f"  {variant:10s} refused at this shape ({e})")
                continue
            log(f"  {variant:10s} {time_ms(call, iters=20):.4f} ms, "
                f"{fa.bf16_ulps(y, y_ref):.2f} ulps ({fa.bf16_ulps(y, y64):.2f}"
                f" from f64), state {norm_err(s, s_ref)[1]:.2e}")


def _ssd_call(libs, variant, c, b, v, la, y, s, work, chunk, stream):
    """A call of ``variant``'s scan C entry point on these buffers (no
    initial state), raising on a cudaError_t."""
    import torch
    fn = bind(libs[variant, "ssd_scan"], "ssd_scan")
    B, T, H, N = c.shape
    P = v.shape[-1]
    bf = int(v.dtype == torch.bfloat16)

    def call():
        err = fn(c.data_ptr(), b.data_ptr(), v.data_ptr(), la.data_ptr(),
                 None, y.data_ptr(), s.data_ptr(), work.data_ptr(), B, T, H,
                 N, P, chunk, bf, stream)
        if err:
            raise RuntimeError(f"{variant}: cudaError_t {err}")
    return call


def _zoo_ssd_f32(libs, rand, stream) -> None:
    """The f32 SSD scan's variants at Zamba2-2.7B's f32 prefill shape
    (``SSD_F32``) and at xLSTM-125M's mLSTM's (``SSD_F32_WIDE``; v with
    its column of ones), chunk 256: time of the C entry point, error of y
    over the plain version's largest output and over the f64 algebra's,
    the final state's error, and whether two runs agree bitwise."""
    import torch
    import torch.nn.functional as F_
    from chip_smoke import norm_err, time_ms
    from repro_torch.kernels import ssd_scan as ss
    f32, C = torch.float32, 256
    for arch, cb, vs, ones in ZOO_SSD_F32:
        B, T, H, N = cb
        c, b = rand(cb, f32, .5), rand(cb, f32, .5)
        v = rand(vs, f32)
        if ones:
            v[..., -1] = 1
        la = -F_.softplus(rand((B, T, H), f32))
        yp, sp = ss.ssd_scan_plain(c, b, v, la, chunk=C)
        y64 = _ssd_f64(c, b, v, la, C)
        log(f"ssd_scan float32 at {arch}'s prefill, c/b {cb}, v {vs}, chunk "
            f"{C}: plain {norm_err(yp, y64)[1]:.2e} from the f64 algebra; "
            f"the rule's kernels {ss.f32_kernels(c, b, v)}")
        y, s = torch.empty_like(v), torch.empty_like(sp)
        work = torch.empty(ss.scratch_floats(c, b, v, C), device="cuda")
        for variant in SSD_F32 if N == 64 else SSD_F32_WIDE:
            if (variant, "ssd_scan") not in libs:
                continue
            call = _ssd_call(libs, variant, c, b, v, la, y, s, work, C,
                             stream)
            call()
            torch.cuda.synchronize()
            first = y.clone()
            call()
            torch.cuda.synchronize()
            log(f"  {variant:13s} {time_ms(call, iters=20):.4f} ms, error / "
                f"max|plain| {norm_err(y, yp)[1]:.3e} "
                f"({norm_err(y, y64)[1]:.3e} from f64), state "
                f"{norm_err(s, sp)[1]:.2e}"
                + ("" if torch.equal(y, first) else
                   ", NOT bitwise run to run"))
            if variant in ("shipped", "mma_sync") and N > 64:
                log("    device ms a call by kernel: " + ", ".join(
                    f"{k} {ms:.4f}" for k, ms in _device_ms(call).items()))
        del c, b, v, yp, sp, y64, y, s, work


def _step_variants(libs) -> None:
    """The decode step's variants at ``chip_smoke.SSD_STEP_CASES``: device
    ms a call over ``SSD_STEP_STATES`` states in turn (a CUDA graph of a
    round, as ``chip_smoke.round_ms`` times it), its share of the bytes
    bound, and whether the new state and y are the shipped kernel's
    bits."""
    import torch
    from chip_smoke import (PEAK_BYTES, SSD_STEP_CASES, SSD_STEP_STATES,
                            round_ms, bitwise_equal, step_operands)
    for label, B, H, N, P, dtype in SSD_STEP_CASES:
        (S, c, b, v, la), nbytes = step_operands(B, H, N, P, dtype)
        y = torch.empty_like(v)
        bound_ms = 1e3 * nbytes / PEAK_BYTES
        log(f"ssd_step at {label} ({B}, {H}, {N}, {P}) {dtype}: bound "
            f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB)")
        shipped = None
        for variant in STEP_VARIANTS:
            if (variant, "ssd_step") not in libs:
                continue
            fn = bind(libs[variant, "ssd_step"], "ssd_step")

            def call(s):
                err = fn(s.data_ptr(), c.data_ptr(), b.data_ptr(),
                         v.data_ptr(), la.data_ptr(), y.data_ptr(), B, H, N,
                         P, *c.stride(), *b.stride(), *v.stride(),
                         int(v.dtype == torch.bfloat16),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{variant} ssd_step: cudaError_t "
                                       f"{err}")
            one = S.clone()
            call(one)
            torch.cuda.synchronize()
            bits = (one, y.clone())
            shipped = shipped or bits
            same = all(bitwise_equal(a, w) for a, w in zip(bits, shipped))
            states = [S.clone() for _ in range(SSD_STEP_STATES)]
            ms = round_ms(call, states)
            log(f"  {variant:13s} {ms:.4f} ms ({100 * bound_ms / ms:.1f}% of "
                f"the bound), {'' if same else 'not '}the shipped bits")
            del states


def _glu_variants(libs, variants, shape, rand, stream, dtype) -> None:
    """The expert GLU's ``variants`` at (E, cap, d, F) = ``shape`` in
    ``dtype`` (operands from ``rand``): the C entry's time, the error over
    the plain version's largest output, whether two runs agree bitwise and,
    in bf16, the largest distance in bf16 ulps from the plain version
    (``bf16_ulps``) and whether it gives the ``mma.sync`` kernel's bits,
    beside the bmm GLU's time."""
    import torch
    import torch.nn.functional as F_
    from chip_smoke import norm_err, time_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gather as mg
    E, cap, d, F = shape
    bf = int(dtype == torch.bfloat16)
    x, wu, wd = (rand((E, cap, d), dtype), rand((E, d, 2 * F), dtype, .5),
                 rand((E, F, d), dtype, .5))
    want = mg.expert_glu_plain(x, wu, wd)
    act, y = torch.empty((E, cap, F), dtype=dtype, device="cuda"), \
        torch.empty_like(x)

    def bmm_glu():
        h = torch.bmm(x, wu)
        return torch.bmm(F_.silu(h[..., :F]) * h[..., F:], wd)
    # the card's copy rate on the weights: what the bytes can move at
    w_copy = torch.empty_like(wu)
    copy_ms = time_ms(lambda: w_copy.copy_(wu), iters=5)
    del w_copy
    log(f"expert_glu {str(dtype)[6:]} at (E, cap, d, F) = {shape}: bmm GLU "
        f"{time_ms(bmm_glu, iters=20):.4f} ms; a copy of w_up "
        f"{copy_ms:.4f} ms ({2 * wu.numel() * wu.element_size() / copy_ms / 1e9:.3f}"
        f" TB/s read + written)")
    outs = {}
    for variant in variants:
        if (variant, "expert_glu") not in libs:
            continue
        fn = bind(libs[variant, "expert_glu"], "expert_glu")

        def call():
            err = fn(x.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                     act.data_ptr(), y.data_ptr(), E, cap, d, F, bf, stream)
            if err:
                raise RuntimeError(f"{variant}: cudaError_t {err}")
        call()
        torch.cuda.synchronize()
        rel = norm_err(y, want)[1]
        ulps = fa.bf16_ulps(y, want) if bf else None
        again = y.clone()
        call()
        torch.cuda.synchronize()
        log(f"  {variant:9s} {time_ms(call, iters=20):.4f} ms, error "
            f"/ max|plain| {rel:.3e}"
            + ("" if ulps is None else f", {ulps:.2f} ulps from plain")
            + ("" if torch.equal(y, again) else ", NOT bitwise run to run"))
        if variant == "one_tf32":
            _glu_truncation(y, x, wu, wd)
        if bf:
            outs[variant] = again
        if variant in ("shipped", "mma_sync"):
            log("    device ms a call by kernel: " + ", ".join(
                f"{k} {ms:.4f}" for k, ms in _device_ms(call).items()))
    if "mma_sync" in outs:
        same = [v for v, o in outs.items() if torch.equal(o, outs["mma_sync"])]
        log(f"  bitwise the mma.sync kernel's output: {same}")


def _device_ms(fn, calls: int = 5) -> dict:
    """Device ms a call of each kernel instantiation ``fn()`` launches, by
    its name with template arguments, from a device trace."""
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
        if ev.device_type == DeviceType.CUDA:
            name = ev.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0]
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            out[name] = us / 1e3 / calls
    return out


def _tf32_hi(x, rounding: str):
    """x's TF32 hi term: its top 19 bits (``trunc``) or x rounded to
    them, ties away from zero (``rna``, as ``split_tf32``)."""
    import torch
    bits = x.float().contiguous().view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _glu_truncation(y, x, wu, wd) -> None:
    """Whether the tensor cores truncate or round the raw f32 bits of
    `wgmma`'s shared-memory operand: the f32 GLU's ``one_tf32`` output
    (hi.hi products only; the weights' hi split in registers, rna) against
    the same products in f64 with B (x, then the activation) truncated,
    and rounded.  The split of B's lo term must match the one it is
    nearer: the other lies the whole hi.hi error away (~1e-3 of the
    largest output at the main path), the matching one only where an
    activation near a TF32 boundary falls the other way (~1e-4)."""
    import torch
    import torch.nn.functional as F_
    from chip_smoke import norm_err
    F = wd.shape[1]
    got = {}
    for how in ("trunc", "rna"):
        h = torch.bmm(_tf32_hi(x, how).double(),
                      _tf32_hi(wu, "rna").double())
        a = (F_.silu(h[..., :F]) * h[..., F:]).float()
        want = torch.bmm(_tf32_hi(a, how).double(),
                         _tf32_hi(wd, "rna").double())
        got[how] = norm_err(y, want)[1]
    near = min(got, key=got.get)
    log(f"    one_tf32 against hi.hi in f64 with B truncated: "
        f"{got['trunc']:.3e}, with B rounded: {got['rna']:.3e}: the tensor "
        f"cores {'truncate' if near == 'trunc' else 'round'} B's raw bits")


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
    from repro_torch.kernels import ssd_scan as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip())
    chosen = tuple(sys.argv[1:]) or KERNELS
    unknown = set(chosen) - set(KERNELS)
    if unknown:
        print(f"kernel_variants: no kernel {sorted(unknown)}; the kernels "
              f"are {KERNELS}", file=sys.stderr)
        return 2
    libs = build(chosen)
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
        if "expert_glu" in chosen:
            if dtype == torch.float32:
                _glu_variants(libs, GLU_F32, (E, cap, d, F), rand, stream,
                              dtype)
            else:
                # bf16 at the main path's widths and at DeepSeek-V3's,
                # whose 2.8 GB of weights are drawn on the card
                gen = torch.Generator(device="cuda").manual_seed(0)

                def drand(shape, dtype, scale=1.0):
                    return (scale * torch.randn(shape, device="cuda",
                                                generator=gen)).to(dtype)
                for shape, make in (((E, cap, d, F), rand),
                                    (DEEPSEEK_GLU, drand)):
                    _glu_variants(libs, GLU_BF16, shape, make, stream, dtype)

        if "flash_attention" in chosen:
            q, k, v = (rand((B, T, H, D), dtype) for _ in range(3))
            want = fa.flash_attention_plain(q, k, v)
            o = torch.empty_like(q)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = time_ms(lambda: F_.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), iters=20)
            log(f"flash_attention {name} at (B, T, H, D) = ({B}, {T}, {H}, {D}),"
                f" causal: SDPA {sdpa:.4f} ms")
            # each dtype's own variants (the others leave its path as shipped)
            for variant in ATTN_F32 if dtype == torch.float32 else \
                    [v for v in VARIANTS if v not in ATTN_F32[1:]]:
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
        if "ssd_scan" in chosen:
            # the SSD scan at the main path's widths and three chunks
            N, P = cfg["state"], D
            c_, b_ = rand((B, T, H, N), dtype, .5), rand((B, T, H, N), dtype, .5)
            v_ = rand((B, T, H, P), dtype)
            la = -F_.softplus(rand((B, T, H), torch.float32))
            y_, s_ = torch.empty_like(v_), torch.empty((B, H, N, P), device="cuda")
            for chunk in (64, 128, 256):
                want = ss.ssd_scan_plain(c_, b_, v_, la, chunk=chunk)[0]
                work = torch.empty(ss.scratch_floats(c_, b_, v_, chunk),
                                   device="cuda")
                log(f"ssd_scan {name} at (B, T, H, N, P) = ({B}, {T}, {H}, {N},"
                    f" {P}), chunk {chunk}:")
                for variant in SSD_F32 if dtype == torch.float32 else SSD_BF16:
                    if (variant, "ssd_scan") not in libs:
                        continue
                    call = _ssd_call(libs, variant, c_, b_, v_, la, y_, s_,
                                     work, chunk, stream)
                    call()
                    torch.cuda.synchronize()
                    rel = norm_err(y_, want)[1]
                    again = y_.clone()
                    call()
                    torch.cuda.synchronize()
                    log(f"  {variant:11s} {time_ms(call, iters=50):.4f} ms, "
                        f"error / max|plain| {rel:.3e}"
                        + ("" if torch.equal(y_, again) else ", NOT bitwise "
                           "run to run"))
                    if variant == "shipped" and chunk == 64:
                        raw_call = call
                # host time a call (no sync), of the C entry point and of the
                # wrapper, which also allocates and checks: where it exceeds
                # the device time, a wrapper timed by CUDA events reads it
                log(f"  host time a call at chunk 64: C entry point "
                    f"{host_us(raw_call):.1f} us, ssd_scan_cuda "
                    f"{host_us(lambda: ss.ssd_scan_cuda(c_, b_, v_, la, chunk=64)):.1f}"
                    f" us")
    if "flash_attention" in chosen:
        _zoo_attention(libs, rand, stream)
        _zoo_attention_f32(libs, rand, stream)
    if "ssd_scan" in chosen:
        _zoo_ssd(libs, rand, stream)
        _zoo_ssd_f32(libs, rand, stream)
    if "ssd_step" in chosen:
        _step_variants(libs)
    LOG.parent.mkdir(exist_ok=True)
    LOG.write_text("\n".join(_log_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
