// MoE expert GLU for Hopper (sm_90a): two grouped tensor-core GEMMs.
//
// Replaces the Pallas TPU kernel `expert_glu` / `_expert_glu_kernel` of
// src/repro/kernels/moe_gather.py.  For each expert e and token row m:
//
//   y[e, m] = (silu(x[e, m] Wg[e]) * (x[e, m] Wu[e])) Wd[e]
//
// with w_up (E, d, 2F) packing gate columns [0, F) and up columns
// [F, 2F), w_down (E, F, d).  All sums are f32.  As in the Pallas kernel
// (moe_gather.py:50) the activation is rounded to x's dtype before the
// down projection, so a bf16 run rounds exactly where the TPU kernel
// does.
//
// Design for the card.  The TPU kernel fuses both projections so the
// hidden activation stays in VMEM.  Here that fusion would pin a block's
// whole (rows x d) output accumulator in registers and make every block
// re-read its expert's weights for a few rows.  So one C call runs two
// kernels on the stream, and the activation makes one round trip through
// device memory (an (E, cap, F) buffer, 16 MB at the main path against
// 201 MB of f32 weights): the up projection with the GLU in its epilogue
// (silu(g) * u in f32, rounded to x's dtype, written as the activation),
// then the down projection.  No atomics, no split-K: each output is one
// thread's fixed-order sum, so a run is bitwise repeatable.  Three designs,
// chosen by an explicit rule of the C entry (never on error):
//
// ---- f32, rows on 16-byte strides: TF32 wgmma fed by TMA (namespace tc) ----
//
// f32-accurate products on the tensor cores take three TF32 ones (3xTF32,
// common.cuh): a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.  TF32 `wgmma`
// reads both shared-memory operands K-major only (its transpose bits exist
// for 16-bit types), and the weights w_up (E, d, 2F) and w_down (E, F, d)
// are N-major; a transposed copy would move 2 x 201 MB a call.  So each
// kernel computes the transpose, C^T = W^T B^T: the weights are the A
// operand, read from registers (each thread loads its own fragment from
// the N-major tile that TMA landed, so A's layout in shared memory does
// not matter, and splits it into TF32 hi and lo there), and x (E, cap, d)
// and the activation (E, cap, F), both K-major, are B, straight from the
// TMA tile.  The weights are read in place, once per token tile.
//
// B's lo term needs a shared-memory tile of its own: each stage's x (or
// activation) tile is split, once per block, into lo = x - hi beside it,
// where hi is what the tensor cores read of x's raw bits (the top 19: they
// truncate, so the raw tile is the hi term; tests/test_torch_tf32x3.py
// shows that a split assuming rounding would miss the f32 bucket, and
// kernel_variants.py's one_tf32 shows the card truncating).  The two
// consumer warpgroups each split half the tile, one stage ahead, while
// their products run.
//
// A block is 128 weight columns (for the GLU: 64 gate columns and the 64
// up columns that match them) x 128 token rows of one expert, 288 threads:
// warp 8 keeps a ring of 3 stages of depth 32 in flight by TMA (four
// 32 x 32 weight sub-tiles and a 32 x 128 x / activation tile a stage,
// beside room for its lo tile, 128-byte swizzle), and consumer warpgroup
// w runs `wgmma` m64n128k8 on 64 of the weight columns: its A row
// 16 warp + g is a gate column and row 16 warp + g + 8 the up column that
// matches it, so silu(g) * u pairs in one thread, and the columns are
// ordered so a warp's fragment loads hit all 32 banks of the swizzled
// rows.  Each k8 step runs a_lo.b_hi, a_hi.b_lo, a_hi.b_hi.  The tensor
// cores' accumulator truncates at every step (one chain over K drifts to
// 1.75e-5 of the largest output on the card: within the bucket, but not
// by much), so every FOLD = 4 stages (K 128) are summed in a fresh
// accumulator and added to the running sum with an f32 add.  The grid's
// fastest index is the token tile, so the blocks that share a weight tile
// run together and the second read comes from L2.  Outputs are written
// from the accumulators with plain stores (16 contiguous bytes a group of
// four threads).
//
// What holds it short of its bound is the data path: with no products at
// all (kernel_variants.py's no_mma) the loads, splits and barriers take
// longer than the products' own bound, and the products overlap them only
// in part.  More loads in flight or fewer bytes from L2 did not shorten
// it: on the card a ring of 4 or 5 stages, a persistent block loading the
// next tile under this one's epilogue, a block without a producer warp
// (255 registers: double-buffered fragments, one stage of products in
// flight) and a cluster of the two blocks that share a weight tile, each
// loading half of it by TMA multicast (25% fewer bytes from L2), were
// each slower, and so was a 64-token tile (PERF.md).
//
// ---- bf16, rows on 16-byte strides: bf16 wgmma fed by TMA (namespace bf) ----
//
// bf16 `wgmma` reads B from shared memory N-major (its transpose bit), so
// the products take their natural orientation: A is x (or the
// activation), K-major, and B the weights as they lie, N-major, both
// tiles landed by TMA with the 128-byte swizzle and read by descriptor; no
// operand passes through registers and no transposed copy is made.  A
// block is BM token rows x 128 product columns of one expert (for the
// GLU: 64 gate columns and the 64 up columns that match them, two TMA
// boxes that one m64n128k16 reads as its B's two 64-column sub-tiles), 288
// threads: warp 8 keeps a ring of 4 stages of depth 64 (one swizzled row
// of bf16: the x / activation tile and two 64 x 64 weight boxes) in flight
// by TMA, and consumer warpgroup w runs one m64n128k16 a k16 step for each
// 64-row slab of its BM / 2 token rows.  BM is 256 (48 KB a stage; at cap
// 256 a block covers every token of its expert, so each weight tile is
// read once), or 128 where that holds every token: at decode's cap 16
// two blocks then fit an SM and the whole grid runs in one wave.  A box
// of x / activation rows covers the tile, or at a smaller cap only the
// m64 slabs that hold tokens (TMA's zero fill of the rest costs as much
// as a load); a warpgroup with no tokens in its rows drops out.  Gate
// column c and up column c land in one thread at accumulator elements
// 4j + q and 4 (j + 8) + q, so silu(g) * u is formed in f32 and rounded to
// bf16 there, as the Pallas kernel rounds.  A stage's products stay in
// flight while the next stage's are issued (the ring slot is released one
// stage late).  Outputs go out as bf16 pairs, 4-byte stores, masked at the
// ragged edges.
//
// Numerics: each output is one chain over K of the tensor cores' k16
// steps in K order.  On the card that gives the mma.sync kernel's bits
// exactly (its m16n8k16 steps sum the same 16 products a step in the same
// order; kernel_variants.py and chip_smoke.py compare them).  A fresh
// accumulator every 4 stages, as the f32 design folds, moved the largest
// distance from plain at d = 7168 from 115 to 79 bf16 ulps and the largest
// error not at all (3.07e-3 of the largest output: the output's rounding),
// but a second set of accumulators leaves room for one 64-row slab a
// warpgroup: the 128-row tile, 10-30% slower at cap 256 (PERF.md).
//
// What bounds it is the data path: with no products at all (no_mma) it
// takes as long as with them, streaming the weights from HBM at ~2.4 TB/s
// where a device copy of them moves 3.0 (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md).  Neither fewer bytes into shared memory nor more of them in
// flight moved that: on the card, a 2- or 4-block cluster loading each x
// tile once by TMA multicast, a 192-column tile (22% fewer bytes a
// product; 192 accumulators a thread, the producer warpgroup's registers
// handed over by setmaxnreg), separate rings for x and the weights, a
// deeper ring at small caps, L2 eviction hints (weights first, x last)
// and a 256-byte L2 promotion were each no faster, or slower.
//
// ---- bf16 and f32 rows TMA cannot read: mma.sync (gemm_kernel) ----
//
// Both projections as one tensor-core GEMM: a block tile is 128 token
// rows x 128 product columns (for the GLU, 64 gate and the 64 up columns
// that match them), 8 warps, each owning a 64 x 32 piece of the tile (4 x
// 4 `mma.sync` tiles; in the GLU kernel its gate and up columns meet in
// one thread).  A and B tiles of depth 32 stream through a 4-stage ring
// in shared memory by `cp.async` (plain loads for rows that are not
// 16-byte aligned); rows are padded so every fragment load (`ldmatrix`
// for A, and for bf16 B) hits distinct banks.  bf16 operands go through
// one `m16n8k16` bf16 product each, as the Pallas kernel multiplies bf16
// by bf16 into f32, straight into the running sum (its drift is far below
// a bf16 output's rounding); two blocks fit an SM.  f32 operands (only
// those TMA cannot read: d or F not a multiple of 4, or a base off 16
// bytes) go through 3xTF32 `m16n8k8` products split in registers, each
// 32-deep stage summed in a fresh accumulator.
//
// Bound: at the main-path shape (32 experts x 256 slots, d = 1024,
// F = 512, f32) the work is 25.8 GFLOP of products against ~268 MB of
// traffic (the f32 weights dominate).  f32-accurate products cost three
// TF32 ones: 3 x 25.8 GFLOP / 495 TFLOP/s = 156 us on the tensor cores,
// against 80 us for the bytes, so the kernel is bound by operations.  In
// bf16 the same call moves 134 MB, 40 us at 3.35 TB/s, against 26 us of
// products at 989 TFLOP/s: bound by bytes, as at DeepSeek-V3's expert
// widths (3.05 GB, 0.91 ms) and at decode.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 128;       // token rows per block tile
constexpr int BN = 128;       // product columns per block tile
constexpr int HALF = BN / 2;  // GLU: gate columns | up columns of a tile
constexpr int BK = 32;        // reduction depth per pipeline stage
constexpr int STAGES = 4;     // depth of the shared-memory ring
constexpr int WARPS_M = 2;    // warps along the tile's rows ...
constexpr int WARPS_N = 4;    // ... and along its columns
constexpr int NT = 32 * WARPS_M * WARPS_N;
constexpr int MI = BM / 16 / WARPS_M;  // m16 tiles per warp
constexpr int NJ = BN / 8 / WARPS_N;   // n8 tiles per warp (4: 32 columns)
static_assert(NJ == 4, "the GLU pairs n8 tiles 0, 1 (gate) with 2, 3 (up)");

template <typename T>
struct Layout {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int AS = BK + VEC;         // row stride of the A tile
  static constexpr int BS = BN + 8;           // row stride of the B tile
  static constexpr int STAGE = BM * AS + BK * BS;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(T);
};

// One 32-deep stage of 3xTF32 products into `part`: A rows wr.. by
// `ldmatrix`, B tile columns ncol[j].. by 32-bit loads, each value split
// into its TF32 hi and lo parts in registers.
__device__ __forceinline__ void mma_stage(const float* __restrict__ As,
                                          const float* __restrict__ Bs,
                                          float (&part)[MI][NJ][4], int wr,
                                          const int (&ncol)[NJ], int lane) {
  constexpr int AS = Layout<float>::AS, BS = Layout<float>::BS;
  const int g = lane >> 2, t = lane & 3;
  // this lane's row address for ldmatrix: row lane % 8 of the tiles
  // (rows 0-7, k 0-3), (rows 8-15, k 0-3), (rows 0-7, k 4-7), (8-15, 4-7)
  const int a_off = (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * AS +
                    4 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bident::split_tf32(Bs[(ks * 8 + t + 4 * r) * BS + ncol[j] + g],
                           bh[j][r], bl[j][r]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      uint32_t a[4], ah[4], al[4];
      bident::ldmatrix_x4(a, As + a_off + mi * 16 * AS + ks * 8);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bident::split_tf32(__uint_as_float(a[q]), ah[q], al[q]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        bident::mma_tf32(part[mi][j], al, bh[j]);
        bident::mma_tf32(part[mi][j], ah, bl[j]);
        bident::mma_tf32(part[mi][j], ah, bh[j]);
      }
    }
  }
}

// The same stage for bf16 operands, one bf16 product per tile, straight
// into the accumulator: A by `ldmatrix`, B (k-major rows) by `ldmatrix`
// with transpose.
__device__ __forceinline__ void mma_stage(const __nv_bfloat16* __restrict__ s,
                                          float (&acc)[MI][NJ][4], int wr,
                                          const int (&ncol)[NJ], int lane) {
  constexpr int AS = Layout<__nv_bfloat16>::AS;
  constexpr int BS = Layout<__nv_bfloat16>::BS;
  const __nv_bfloat16* Bs = s + BM * AS;
  // A: tiles (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  const int a_off = (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * AS +
                    8 * (lane >> 4);
  // B: tiles (k 0-7, n-tile 2p), (k 8-15, 2p), (k 0-7, 2p+1), (k 8-15, 2p+1)
  const int b_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int b_col = 8 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t b[NJ][2];
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p) {
      uint32_t r[4];
      bident::ldmatrix_x4<true>(
          r, Bs + (ks * 16 + b_row) * BS + ncol[2 * p] + b_col);
      b[2 * p][0] = r[0];
      b[2 * p][1] = r[1];
      b[2 * p + 1][0] = r[2];
      b[2 * p + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      uint32_t a[4];
      bident::ldmatrix_x4(a, s + a_off + mi * 16 * AS + ks * 16);
#pragma unroll
      for (int j = 0; j < NJ; ++j) bident::mma_bf16(acc[mi][j], a, b[j]);
    }
  }
}

// One block tile of one expert's A (M x K, row-major) . B (K x ldb,
// row-major).  GLU: the tile's columns [0, 64) are B's columns c0 + c
// (gate) and [64, 128) its columns N + c0 + c (up), ldb = 2N, and the
// block writes the 128 x 64 activation round(silu(gate) * up) into C
// (M x N).  Otherwise: columns c0 + c, ldb = N, and the block writes the
// 128 x 128 product.  An f32 block holds two sums of its tile (the
// running one and the stage's) in ~240 registers a thread, so one block
// fits an SM; a bf16 block holds one and two fit.
template <typename T, bool GLU, bool ASYNC>
__global__ void __launch_bounds__(NT, Layout<T>::F32 ? 1 : 2)
    gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                T* __restrict__ C, int M, int K, int N) {
  using L = Layout<T>;
  constexpr int VEC = L::VEC;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * (GLU ? HALF : BN);
  const int ldb = GLU ? 2 * N : N;
  A += (size_t)e * M * K;
  B += (size_t)e * K * ldb;
  C += (size_t)e * M * N;
  // each 64-column half of the B tile: its first column in B, and how
  // many columns from there are valid
  const int col0 = c0, col1 = GLU ? N + c0 : c0 + HALF;
  const int lim0 = N - c0, lim1 = GLU ? N - c0 : N - c0 - HALF;

  auto load_stage = [&](int kt, int s) {
    T* As = smem + s * L::STAGE;
    T* Bs = As + BM * L::AS;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BM * BK / VEC / NT; ++i) {
      const int c = threadIdx.x + NT * i;
      const int r = c / (BK / VEC), kc = c % (BK / VEC) * VEC;
      const int row = m0 + r, k = k0 + kc;
      const int nv = row < M ? min(max(K - k, 0), VEC) : 0;
      bident::load_chunk<ASYNC>(As + r * L::AS + kc,
                                nv > 0 ? A + (size_t)row * K + k : A, nv);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / VEC / NT; ++i) {
      const int c = threadIdx.x + NT * i;
      const int r = c / (BN / VEC), cc = c % (BN / VEC) * VEC;
      const bool hi = cc >= HALF;
      const int ch = hi ? cc - HALF : cc, k = k0 + r;
      const int nv = k < K ? min(max((hi ? lim1 : lim0) - ch, 0), VEC) : 0;
      bident::load_chunk<ASYNC>(
          Bs + r * L::BS + cc,
          nv > 0 ? B + (size_t)k * ldb + (hi ? col1 : col0) + ch : B, nv);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / WARPS_N * (MI * 16);  // the warp's first tile row
  const int wn = warp % WARPS_N;
  int ncol[NJ];                            // tile column of n8 tile j
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    ncol[j] = GLU ? (j >> 1) * HALF + wn * 16 + (j & 1) * 8 : wn * 32 + j * 8;

  float acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    bident::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    bident::cp_async_wait<STAGES - 2>();  // stage kt has landed ...
    __syncthreads();                      // ... and stage kt-1 is consumed
    if (kt + STAGES - 1 < nk)
      load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    bident::cp_async_commit();
    const T* stage = smem + (kt % STAGES) * L::STAGE;
    if constexpr (L::F32) {
      // the stage's sum starts from zero and joins the running sum with
      // an f32 add, so the tensor cores' truncation cannot build up over K
      float part[MI][NJ][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[mi][j][q] = 0.f;
      mma_stage(stage, stage + BM * L::AS, part, wr, ncol, lane);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][j][q] += part[mi][j][q];
    } else {
      mma_stage(stage, acc, wr, ncol, lane);
    }
  }

  // accumulator element q of tile (mi, j): row g + 8 (q / 2), column
  // 2t + q % 2 of that tile
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wr + mi * 16 + g + 8 * hr;
      if (row >= M) continue;
      T* out = C + (size_t)row * N;
      if constexpr (GLU) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int f = c0 + wn * 16 + jj * 8 + 2 * t + cc;
            const float gate = acc[mi][jj][2 * hr + cc];
            const float up = acc[mi][jj + 2][2 * hr + cc];
            if (f < N)
              out[f] = bident::from_f32<T>(gate / (1.f + expf(-gate)) * up);
          }
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int n = c0 + wn * 32 + j * 8 + 2 * t + cc;
            if (n < N) out[n] = bident::from_f32<T>(acc[mi][j][2 * hr + cc]);
          }
      }
    }
}

template <typename T, bool GLU, bool ASYNC>
cudaError_t launch_gemm(const void* A, const void* B, void* C, int E, int M,
                        int K, int N, cudaStream_t stream) {
  constexpr size_t smem = Layout<T>::SMEM;
  constexpr int cols = GLU ? HALF : BN;
  cudaError_t err = bident::allow_smem(gemm_kernel<T, GLU, ASYNC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + cols - 1) / cols, (M + BM - 1) / BM, E);
  gemm_kernel<T, GLU, ASYNC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C),
      M, K, N);
  return cudaGetLastError();
}

template <typename T, bool ASYNC>
cudaError_t run(const void* x, const void* w_up, const void* w_down,
                void* act, void* y, int E, int cap, int d, int F,
                cudaStream_t stream) {
  cudaError_t err =
      launch_gemm<T, true, ASYNC>(x, w_up, act, E, cap, d, F, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T, false, ASYNC>(act, w_down, y, E, cap, F, d, stream);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w_up, const void* w_down,
                     void* act, void* y, int E, int cap, int d, int F,
                     cudaStream_t stream) {
  constexpr int VEC = Layout<T>::VEC;
  const bool async = d % VEC == 0 && F % VEC == 0 &&
                     bident::aligned16(x) && bident::aligned16(w_up) &&
                     bident::aligned16(w_down) && bident::aligned16(act);
  return async ? run<T, true>(x, w_up, w_down, act, y, E, cap, d, F, stream)
               : run<T, false>(x, w_up, w_down, act, y, E, cap, d, F, stream);
}

// ---------------------------------------------------------------------------
// f32: TF32 wgmma fed by TMA (namespace tc)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128;     // token rows a block: the wgmma's N
constexpr int BK = 32;      // K a stage: one 128-byte swizzled row of f32
constexpr int FOLD = 4;     // stages summed in a fresh accumulator
constexpr int NT = 288;     // two consumer warpgroups + one producer warp
constexpr int STAGES = 3;   // the ring
constexpr uint32_t SUB = BK * 128;           // a 32-column weight sub-tile
constexpr uint32_t A_BYTES = 4 * SUB;        // the stage's weight tile
constexpr uint32_t B_BYTES = BM * 128;       // its x / act tile, or lo tile
constexpr uint32_t STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr size_t SMEM = 1024 + STAGES * (STAGE_BYTES + 24);
static_assert(SMEM <= 232448, "over the 227 KB of shared memory a block may use");

// The lo term of each element of the stage's B tile: x - hi, where hi is
// what the tensor cores read of x's raw bits (the top 19: truncation), so
// that hi + lo = x exactly.  Consumer warpgroup w splits rows [w BM / 2,
// (w + 1) BM / 2) of the tile, 16 bytes a thread a step; the tile is
// swizzled, but the split is elementwise, so lo lands where x lies.
__device__ __forceinline__ void split_b(const uint8_t* b, uint8_t* lo, int w,
                                        int i) {
  constexpr int STEPS = B_BYTES / 2 / 16 / 128;
#pragma unroll
  for (int q = 0; q < STEPS; ++q) {
    const uint32_t off = w * (B_BYTES / 2) + 16 * (i + 128 * q);
    const float4 x = *reinterpret_cast<const float4*>(b + off);
    float4 l;
    l.x = x.x - __uint_as_float(__float_as_uint(x.x) & 0xffffe000u);
    l.y = x.y - __uint_as_float(__float_as_uint(x.y) & 0xffffe000u);
    l.z = x.z - __uint_as_float(__float_as_uint(x.z) & 0xffffe000u);
    l.w = x.w - __uint_as_float(__float_as_uint(x.w) & 0xffffe000u);
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// One block computes a (128 weight columns) x (BM tokens) tile of the
// transposed product of one expert, C^T = W^T B^T over K: W (K x cols)
// through `amap` as (cols, K, E), B (M x K) through `bmap` as (K, M, E).
// GLU: the tile's weight columns are gate columns r0 .. r0 + 63 and the
// up columns N + r0 .. that match them, and the block writes the 64 x BM
// activation silu(gate) * up into C (E, M, N).  Otherwise: columns
// r0 .. r0 + 127, written into C (E, M, N) as the product.  The grid's
// fastest index is the token tile, so the blocks that share a weight
// tile run together.  See the note at the head of the file.
template <bool GLU>
__global__ void __launch_bounds__(NT, 1)
    glu_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap,
                     float* __restrict__ C, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  // stage s: weight sub-tiles 0-3, the B tile, its lo tile
  uint8_t* tiles = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + STAGES * STAGE_BYTES);
  uint64_t* split = full + STAGES;
  uint64_t* empty = split + STAGES;

  const int m0 = blockIdx.x * BM, e = blockIdx.z;
  const int r0 = blockIdx.y * (GLU ? 64 : 128);
  const int nk = (K + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&split[s], 8);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (role == 2) {
    // ---- producer: one thread keeps the ring's TMA loads in flight ----
    if (tid != 256) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
      uint8_t* st = tiles + s * STAGE_BYTES;
      hopper::mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
#pragma unroll
      for (int sub = 0; sub < 4; ++sub) {
        const int col = GLU ? (sub & 1) * 32 + (sub >> 1) * N + r0
                            : r0 + 32 * sub;
        hopper::tma_load_3d(st + sub * SUB, &amap, &full[s], col, kt * BK, e);
      }
      hopper::tma_load_3d(st + A_BYTES, &bmap, &full[s], kt * BK, m0, e);
    }
    return;
  }

  // ---- consumers: warpgroup w takes 64 of the block's 128 A rows ----
  const int w = role, i = tid % 128;
  const int warp = i / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // A row 16 warp + g (+ 8) is column fc of sub-tile s0 (s1): for the GLU
  // the gate (up) columns of the pair, so silu(g) * u meets in one thread.
  // fc spreads a warp's loads over all 32 banks of the swizzled rows.
  const int s0 = GLU ? w : 2 * w, s1 = GLU ? 2 + w : 2 * w + 1;
  const int fc = 4 * warp + (g & 3) + 16 * (g >> 2);
  const uint32_t frag0 = t * 128 + (((fc >> 2) ^ t) << 4) + (fc & 3) * 4;
  const uint32_t frag4 =
      (t + 4) * 128 + (((fc >> 2) ^ (t + 4)) << 4) + (fc & 3) * 4;

  // this warpgroup's half of stage kt's lo tile, once the stage has landed
  auto split_stage = [&](int kt) {
    const int s = kt % STAGES;
    uint8_t* st = tiles + s * STAGE_BYTES;
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
    split_b(st + A_BYTES, st + A_BYTES + B_BYTES, w, i);
    hopper::fence_proxy_async();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&split[s]);
  };

  float acc[BM / 2], part[BM / 2];
#pragma unroll
  for (int q = 0; q < BM / 2; ++q) acc[q] = part[q] = 0.f;

  split_stage(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    const uint8_t* st = tiles + s * STAGE_BYTES;
    // the stage's A fragments, split into TF32 hi and lo in registers
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint8_t* p0 = st + s0 * SUB + kk * 1024;
      const uint8_t* p1 = st + s1 * SUB + kk * 1024;
      bident::split_tf32(*reinterpret_cast<const float*>(p0 + frag0),
                         ah[kk][0], al[kk][0]);
      bident::split_tf32(*reinterpret_cast<const float*>(p1 + frag0),
                         ah[kk][1], al[kk][1]);
      bident::split_tf32(*reinterpret_cast<const float*>(p0 + frag4),
                         ah[kk][2], al[kk][2]);
      bident::split_tf32(*reinterpret_cast<const float*>(p1 + frag4),
                         ah[kk][3], al[kk][3]);
    }
    hopper::mbar_wait(&split[s], (kt / STAGES) & 1);
    const uint32_t b_hi = hopper::smem_u32(st + A_BYTES);
    const uint32_t b_lo = b_hi + B_BYTES;
    const int fresh = kt % FOLD == 0;
    hopper::reg_fence(part);
    hopper::reg_fence(ah);
    hopper::reg_fence(al);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t dh = hopper::make_desc(b_hi + 32 * kk, 16, 1024, 128);
      const uint64_t dl = hopper::make_desc(b_lo + 32 * kk, 16, 1024, 128);
      hopper::WgmmaTf32<BM>::rs(part, al[kk], dh, !(fresh && kk == 0));
      hopper::WgmmaTf32<BM>::rs(part, ah[kk], dl, 1);
      hopper::WgmmaTf32<BM>::rs(part, ah[kk], dh, 1);
    }
    hopper::wgmma_commit();
    // the next stage's lo tile, while these products run
    if (kt + 1 < nk) split_stage(kt + 1);
    hopper::wgmma_wait<0>();
    hopper::reg_fence(part);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    if (kt % FOLD == FOLD - 1 || kt == nk - 1) {
#pragma unroll
      for (int q = 0; q < BM / 2; ++q) acc[q] += part[q];
    }
  }

  // accumulator element 4j + q: A row 16 warp + g + 8 (q / 2), token
  // 8j + 2t + q % 2 of the tile
  float* out = C + (size_t)e * M * N;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = m0 + 8 * j + 2 * t + c;
      if (m >= M) continue;
      if constexpr (GLU) {
        const int f = r0 + 32 * w + fc;
        const float gate = acc[4 * j + c], up = acc[4 * j + 2 + c];
        if (f < N) out[(size_t)m * N + f] = gate / (1.f + expf(-gate)) * up;
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = r0 + 64 * w + 32 * h + fc;
          if (n < N) out[(size_t)m * N + n] = acc[4 * j + 2 * h + c];
        }
      }
    }
}

// TMA reads every operand: rows of d and F floats on 16-byte strides,
// 16-byte aligned bases (y is written by plain stores)
inline bool tma_route(const void* x, const void* w_up, const void* w_down,
                      const void* act, int d, int F) {
  return d % 4 == 0 && F % 4 == 0 && bident::aligned16(x) &&
         bident::aligned16(w_up) && bident::aligned16(w_down) &&
         bident::aligned16(act);
}

template <bool GLU>
cudaError_t launch(const CUtensorMap& am, const CUtensorMap& bm, float* C,
                   int E, int M, int K, int N, cudaStream_t stream) {
  constexpr int COLS = GLU ? 64 : 128;   // output columns a block
  const dim3 grid((M + BM - 1) / BM, (N + COLS - 1) / COLS, E);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = bident::allow_smem(glu_wgmma_kernel<GLU>, SMEM);
  if (err != cudaSuccess) return err;
  glu_wgmma_kernel<GLU><<<grid, NT, SMEM, stream>>>(am, bm, C, M, K, N);
  return cudaGetLastError();
}

cudaError_t run(const void* x, const void* w_up, const void* w_down,
                void* act, void* y, int E, int cap, int d, int F,
                cudaStream_t stream) {
  CUtensorMap um{}, xm{}, dm{}, am{};
  if (!(hopper::encode_f32_3d(&um, w_up, 2 * F, d, E, BK) &&
        hopper::encode_f32_3d(&xm, x, d, cap, E, BM) &&
        hopper::encode_f32_3d(&dm, w_down, d, F, E, BK) &&
        hopper::encode_f32_3d(&am, act, F, cap, E, BM)))
    return cudaErrorInvalidValue;
  cudaError_t err = launch<true>(um, xm, static_cast<float*>(act), E, cap, d,
                                 F, stream);
  if (err != cudaSuccess) return err;
  return launch<false>(dm, am, static_cast<float*>(y), E, cap, F, d, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16: bf16 wgmma fed by TMA, the weights read N-major (namespace bf)
// ---------------------------------------------------------------------------
namespace bf {

constexpr int BK = 64;      // K a stage: one 128-byte swizzled row of bf16
constexpr int NT = 288;     // two consumer warpgroups + one producer warp
constexpr int STAGES = 4;   // the ring of TMA stages
constexpr uint32_t B_SUB = BK * 128;         // a 64-column weight box

// Shared memory of a block whose stages hold `a_rows` x / act rows and two
// weight boxes.
constexpr size_t smem_bytes(int a_rows) {
  return 1024 + STAGES * (a_rows * 128 + 2 * B_SUB + 16);
}
static_assert(smem_bytes(256) <= 232448,
              "over the 227 KB of shared memory a block may use");

// A consumer warpgroup's outputs from its sums r: slab i holds rows
// row0 + 64 i (+ 8) (row0 carries the thread's g), element 4j + q column
// c0 + 8j + 2t + q % 2 of the tile.  GLU: elements j < 8 are gate columns
// and 4 (j + 8) + q the up column that matches each, so silu(g) * u pairs
// in one thread, in f32, rounded to bf16.  Two columns a 4-byte store.
template <bool GLU, int MW>
__device__ __forceinline__ void store(const float (&r)[MW][64],
                                      __nv_bfloat16* __restrict__ C,
                                      int row0, int c0, int M, int N, int t) {
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 64 * i + 8 * h;
      if (m >= M) continue;
      __nv_bfloat16* out = C + (size_t)m * N;
#pragma unroll
      for (int j = 0; j < (GLU ? 8 : 16); ++j) {
        const int n = c0 + 8 * j + 2 * t;
        if (n >= N) continue;
        float v0 = r[i][4 * j + 2 * h], v1 = r[i][4 * j + 2 * h + 1];
        if constexpr (GLU) {
          v0 = v0 / (1.f + expf(-v0)) * r[i][4 * (j + 8) + 2 * h];
          v1 = v1 / (1.f + expf(-v1)) * r[i][4 * (j + 8) + 2 * h + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(out + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

// One block computes a BM-token x 128-column tile of one expert's product
// A B over K: A (M x K, K-major) through `amap` as (K, M, E), B (K x cols,
// N-major, as the weights lie) through `bmap` as (cols, K, E), two boxes
// of 64 columns a stage that one m64n128k16 `wgmma` reads as its N-major
// B.  GLU: the boxes are gate columns c0 .. c0 + 63 and the up columns
// N + c0 .. that match them, and the block writes the BM x 64 activation
// silu(gate) * up into C (E, M, N).  Otherwise: columns c0 .. c0 + 127,
// written into C (E, M, N).  `amap` reads `a_rows` (BM, or fewer where M
// is: 64 at decode) rows a box; rows past them are never stored.  A
// 128-row tile fits two blocks an SM.  See the note at the head of the
// file.
template <bool GLU, int BM>
__global__ void __launch_bounds__(NT, BM == 128 ? 2 : 1)
    glu_bf16_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bmap,
                    __nv_bfloat16* __restrict__ C, int M, int K, int N,
                    int a_rows) {
  constexpr int MW = BM / 128;   // m64 row slabs a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  // stage s: the x / act tile's a_rows, then the two weight boxes
  uint8_t* tiles = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t stage_bytes = a_rows * 128 + 2 * B_SUB;
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + STAGES * stage_bytes);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM, e = blockIdx.z;
  const int c0 = blockIdx.y * (GLU ? 64 : 128);
  const int nk = (K + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  // the consumer warpgroups whose rows hold tokens (at decode, the first)
  const int live = M - m0 > BM / 2 ? 2 : 1;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * live);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (role == 2) {
    // ---- producer: one thread keeps the ring's TMA loads in flight ----
    if (tid != 256) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
      uint8_t* st = tiles + s * stage_bytes;
      uint8_t* w_st = st + a_rows * 128;
      hopper::mbar_expect_tx(&full[s], stage_bytes);
      hopper::tma_load_3d(st, &amap, &full[s], kt * BK, m0, e);
      hopper::tma_load_3d(w_st, &bmap, &full[s], c0, kt * BK, e);
      hopper::tma_load_3d(w_st + B_SUB, &bmap, &full[s],
                          GLU ? N + c0 : c0 + 64, kt * BK, e);
    }
    return;
  }
  if (role >= live) return;

  // ---- consumers: warpgroup w takes rows [w BM / 2, (w + 1) BM / 2) ----
  const int w = role, warp = (tid / 32) % 4, lane = tid % 32;
  float acc[MW][64] = {};   // one chain over K an output

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    const uint32_t st = hopper::smem_u32(tiles + s * stage_bytes);
    const uint32_t a = st + w * (BM / 2) * 128;
    const uint32_t b = st + a_rows * 128;
    const bool last = kt == nk - 1;
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
#pragma unroll
    for (int i = 0; i < MW; ++i) hopper::reg_fence(acc[i]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = hopper::make_desc(b + kk * 2048, B_SUB, 1024, 128);
#pragma unroll
      for (int i = 0; i < MW; ++i)
        hopper::Wgmma<128>::ss_t(
            acc[i], hopper::make_desc(a + i * 8192 + kk * 32, 16, 1024, 128),
            db, kt > 0 || kk > 0);
    }
    hopper::wgmma_commit();
    // this stage's group stays in flight, so stage kt - 1's products are
    // done: its ring slot is free (the last stage waits for its own)
    if (last)
      hopper::wgmma_wait<0>();
    else
      hopper::wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < MW; ++i) hopper::reg_fence(acc[i]);
    __syncwarp();
    if (lane == 0) {
      if (kt > 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
      if (last) hopper::mbar_arrive(&empty[s]);
    }
  }

  const int row0 = m0 + w * (BM / 2) + 16 * warp + lane / 4;
  store<GLU, MW>(acc, C + (size_t)e * M * N, row0, c0, M, N, lane % 4);
}

// TMA reads every operand: rows of d and F bf16 on 16-byte strides,
// 16-byte aligned bases (y, written two columns a store, too)
inline bool tma_route(const void* x, const void* w_up, const void* w_down,
                      const void* act, const void* y, int d, int F) {
  return d % 8 == 0 && F % 8 == 0 && bident::aligned16(x) &&
         bident::aligned16(w_up) && bident::aligned16(w_down) &&
         bident::aligned16(act) && bident::aligned16(y);
}

template <bool GLU, int BM>
cudaError_t launch(const CUtensorMap& am, const CUtensorMap& bm, void* C,
                   int E, int M, int K, int N, int a_rows,
                   cudaStream_t stream) {
  constexpr int COLS = GLU ? 64 : 128;   // output columns a block
  const dim3 grid((M + BM - 1) / BM, (N + COLS - 1) / COLS, E);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err =
      bident::allow_smem(glu_bf16_kernel<GLU, BM>, smem_bytes(BM));
  if (err != cudaSuccess) return err;
  glu_bf16_kernel<GLU, BM><<<grid, NT, smem_bytes(a_rows), stream>>>(
      am, bm, static_cast<__nv_bfloat16*>(C), M, K, N, a_rows);
  return cudaGetLastError();
}

// Both projections at token tile BM; x and act are read `a_rows` rows a box
template <int BM>
cudaError_t run(const void* x, const void* w_up, const void* w_down,
                void* act, void* y, int E, int cap, int d, int F, int a_rows,
                cudaStream_t stream) {
  CUtensorMap xm{}, um{}, am{}, dm{};
  if (!(hopper::encode_bf16_3d(&xm, x, d, cap, E, a_rows) &&
        hopper::encode_bf16_3d(&um, w_up, 2 * F, d, E, BK) &&
        hopper::encode_bf16_3d(&am, act, F, cap, E, a_rows) &&
        hopper::encode_bf16_3d(&dm, w_down, d, F, E, BK)))
    return cudaErrorInvalidValue;
  cudaError_t err =
      launch<true, BM>(xm, um, act, E, cap, d, F, a_rows, stream);
  if (err != cudaSuccess) return err;
  return launch<false, BM>(am, dm, y, E, cap, F, d, a_rows, stream);
}

// The token tile: 256 rows (at cap 256 every token of an expert, so each
// weight tile is read once), or 128 where they hold every token (two
// blocks an SM); a box of x / act rows covers the tile or, at a cap under
// it, the m64 slabs that hold tokens (TMA's zero fill of the rest is not
// free)
cudaError_t run(const void* x, const void* w_up, const void* w_down,
                void* act, void* y, int E, int cap, int d, int F,
                cudaStream_t stream) {
  const bool narrow = cap <= 128;
  const int bm = narrow ? 128 : 256;
  const int a_rows = cap < bm ? (cap + 63) / 64 * 64 : bm;
  return narrow ? run<128>(x, w_up, w_down, act, y, E, cap, d, F, a_rows,
                           stream)
                : run<256>(x, w_up, w_down, act, y, E, cap, d, F, a_rows,
                           stream);
}

}  // namespace bf

}  // namespace

// C entry point (bound with ctypes).  x (E, cap, d), w_up (E, d, 2F),
// w_down (E, F, d), act (E, cap, F) scratch for the activation, y (E,
// cap, d): contiguous device buffers, float32 or (bf16 != 0) bfloat16.
// Runs both kernels on `stream`; returns the first cudaError_t.
extern "C" int bident_expert_glu(const void* x, const void* w_up,
                                 const void* w_down, void* act, void* y,
                                 int E, int cap, int d, int F, int bf16,
                                 void* stream) {
  if (E <= 0 || cap <= 0 || d <= 0 || F <= 0 || E > 65535 ||
      (cap + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16: wgmma fed by TMA where TMA reads every operand, else mma.sync
  if (bf16) {
    if (bf::tma_route(x, w_up, w_down, act, y, d, F))
      return bf::run(x, w_up, w_down, act, y, E, cap, d, F, s);
    return dispatch<__nv_bfloat16>(x, w_up, w_down, act, y, E, cap, d, F, s);
  }
  // f32: TF32 wgmma where TMA reads every operand, else mma.sync with
  // plain loads (cp.async needs the 16-byte rows TMA takes)
  if (tc::tma_route(x, w_up, w_down, act, d, F))
    return tc::run(x, w_up, w_down, act, y, E, cap, d, F, s);
  return run<float, false>(x, w_up, w_down, act, y, E, cap, d, F, s);
}
