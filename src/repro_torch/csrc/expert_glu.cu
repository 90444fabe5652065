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
// whole (rows x d) output accumulator in registers, which caps the token
// tile at 32 rows and d at 1024, and makes every block re-read its
// expert's weights for 32 rows.  So one C call runs two kernels on the
// stream, and the activation makes one round trip through device memory
// (an (E, cap, F) buffer, 16 MB at the main path against 268 MB of
// weights):
//
// 1. up projection + GLU: a block tile is 128 token rows x (64 gate
//    columns and the 64 up columns that match them) of one expert, over
//    K = d; its epilogue computes silu(g) * u in f32, rounds it to x's
//    dtype and writes the activation;
// 2. down projection: (cap x F) . (F x d) per expert, 128 x 128 tiles
//    over K = F.
//
// Both are one tensor-core GEMM: 8 warps, each owning a 64 x 32 piece of
// the tile (4 x 4 `mma.sync` tiles; in the GLU kernel its gate and up
// columns meet in one thread, so the epilogue needs no exchange).  A and
// B tiles of depth 32 stream through a 4-stage ring in shared memory by
// `cp.async`, three stages in flight while one is multiplied; rows are
// padded so every fragment load (`ldmatrix` for A, and for bf16 B) hits
// distinct banks.  f32 operands go through 3xTF32 `m16n8k8` products
// (common.cuh), split into TF32 hi and lo parts in registers as they are
// loaded; each stage is summed in a fresh accumulator that joins the
// running sum with an f32 add, in stage order.  (Splitting each stage
// once per block into a second shared buffer, so that the four warps
// reading an A element do not each split it, was slower on the card: the
// extra barrier and shared-memory traffic cost more than the splits.)
// bf16 operands go through one `m16n8k16` bf16 product each, as the
// Pallas kernel multiplies bf16 by bf16 into f32, straight into the
// running sum (one `mma` per 16 of K, whose drift is far below a bf16
// output's rounding), which leaves room for two blocks per SM.  No
// atomics, no split-K: each output is one thread's fixed-order sum.  Rows
// that are not 16-byte aligned (d or F not a multiple of 16 bytes) take
// plain loads into the same ring.
//
// Bound: at the main-path shape (32 experts x 256 slots, d = 1024,
// F = 512, f32) the work is 25.8 GFLOP of products against ~268 MB of
// traffic (the f32 weights dominate).  f32-accurate products cost three
// TF32 ones: 3 x 25.8 GFLOP / 495 TFLOP/s = 156 us on the tensor cores,
// against 80 us for the bytes, so the kernel is bound by operations.
// Each weight element now serves 128 token rows per block, not 32.
#include "common.cuh"

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
  return bf16 ? dispatch<__nv_bfloat16>(x, w_up, w_down, act, y, E, cap, d,
                                        F, s)
              : dispatch<float>(x, w_up, w_down, act, y, E, cap, d, F, s);
}
