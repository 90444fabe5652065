// Fused MoE expert GLU for Hopper (sm_90a).
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
// does.  The (cap x 2F) hidden activation never reaches device memory.
//
// Design for the card.  One block owns one (expert, 32-token tile) and
// loops over F in tiles of 64: per tile it computes the 32 x (64 gate +
// 64 up) hidden block, applies the GLU, rounds, and adds the 32 x 64
// activation times the matching 64 rows of w_down into the block's f32
// (32 x d) accumulator, which stays in registers for the whole F loop.
//
// * Up projection: the x tile sits in shared memory transposed (k-major,
//   rows padded to 36 floats so a float4 is aligned); 32 x 128 slices
//   of w_up stream through two shared buffers, the next slice's loads in
//   flight while the current one is multiplied.  Thread (ty, tx) of the 8 x
//   32 grid owns rows 4ty..4ty+3 and gate/up columns 2tx, 2tx+1: per k
//   one float4 (its four x values, a broadcast) and two float2 (its
//   weights) feed 16 FMAs.  Gate and up of a column meet in one thread,
//   so the GLU needs no exchange.
// * Down projection: thread t owns output columns t + 256c of all 32
//   rows (128 floats at d = 1024).  Per hidden column j it reads its
//   w_down values straight from device memory — coalesced across the
//   block, four rows at a time with the next four in flight — and the
//   activation column as eight float4 broadcasts: 8 shared loads per 128
//   FMAs.
//
// No atomics, no split reduction: each output is one thread's
// fixed-order sum.
//
// Bound: at the main-path shape (32 experts x 256 slots, d = 1024,
// F = 512) the work is ~25.8 GFLOP of f32 products against ~268 MB of
// traffic (the f32 weights dominate), so the kernel is bound by f32
// operations (67 TFLOP/s without tensor cores, ~385 us), not bytes.
// What holds it below that: one 189 KB block (8 warps) per SM hides
// latency poorly, and every block re-reads its expert's weights (from
// L2 after the first tile of that expert).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 32;   // token rows per block
constexpr int BF = 64;   // hidden (F) columns per tile
constexpr int KD = 32;   // reduction depth per streamed w_up slice
constexpr int NT = 256;  // threads per block (8 x 32)
constexpr int XS = 36;   // row stride of the transposed x and a tiles

constexpr int WS = KD * 2 * BF;   // floats in one w_up slice
constexpr int WPT = WS / NT;       // ... that each thread loads
constexpr int PF = 4;              // w_down rows fetched per group

inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

inline size_t smem_floats(int d) {
  return (size_t)round_up(d, KD) * XS + 2 * (size_t)WS + (size_t)BF * XS;
}

// This thread's share of the KD x (BF gate | BF up) slice of w_up at
// reduction offset k0, hidden offset f0 (zero outside d and F).
template <typename T>
__device__ __forceinline__ void fetch_w_up(const T* __restrict__ w_up,
                                           float (&r)[WPT], int e, int d,
                                           int F, int f0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    const int el = tid + NT * i;
    const int kk = el / (2 * BF), j = el % (2 * BF);
    const int gk = k0 + kk, fc = f0 + (j % BF);
    const size_t col = j < BF ? fc : F + fc;
    r[i] = (gk < d && fc < F)
               ? bident::to_f32(w_up[((size_t)e * d + gk) * 2 * (size_t)F + col])
               : 0.f;
  }
}

__device__ __forceinline__ void store_stage(float* __restrict__ buf,
                                            const float (&r)[WPT], int tid) {
#pragma unroll
  for (int i = 0; i < WPT; ++i) buf[tid + NT * i] = r[i];
}

// Rows j0 .. j0+PF-1 of this F tile of w_down, at this thread's output
// columns (zero past nf rows or d columns).
template <typename T, int NC>
__device__ __forceinline__ void fetch_w_down(const T* __restrict__ wd,
                                             float (&r)[PF][NC], int j0,
                                             int nf, int d, int tid) {
#pragma unroll
  for (int q = 0; q < PF; ++q)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tid + NT * c;
      r[q][c] = (j0 + q < nf && col < d)
                    ? bident::to_f32(wd[(size_t)(j0 + q) * d + col])
                    : 0.f;
    }
}

template <typename T, int NC>
__global__ void __launch_bounds__(NT, 1)
    glu_kernel(const T* __restrict__ x, const T* __restrict__ w_up,
               const T* __restrict__ w_down, T* __restrict__ y, int cap,
               int d, int F) {
  const int dpad = (d + KD - 1) / KD * KD;
  extern __shared__ float4 smem4[];
  float* xT = reinterpret_cast<float*>(smem4);  // dpad x XS: x, k-major
  float* ws = xT + dpad * XS;                    // 2 x (KD x 2BF): gate | up
  float* aT = ws + 2 * WS;                       // BF x XS: activation

  const int m0 = blockIdx.x * BM;
  const int e = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 5;        // up projection: rows 4ty .. 4ty+3
  const int tx = tid & 31;        // ... hidden columns 2tx, 2tx+1

  for (int el = tid; el < BM * dpad; el += NT) {
    const int r = el / dpad, k = el % dpad, row = m0 + r;
    xT[k * XS + r] = (row < cap && k < d)
                         ? bident::to_f32(x[((size_t)e * cap + row) * d + k])
                         : 0.f;
  }

  float acc[BM][NC];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int f0 = 0; f0 < F; f0 += BF) {
    float hg[4][2], hu[4][2];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) hg[rr][jj] = hu[rr][jj] = 0.f;

    // w_up slices stream through two shared buffers: the next slice's
    // loads are in flight (in registers) while this one is multiplied
    float stage[WPT];
    fetch_w_up(w_up, stage, e, d, F, f0, 0, tid);
    store_stage(ws, stage, tid);
    __syncthreads();
    const int nk = dpad / KD;
    for (int ks = 0; ks < nk; ++ks) {
      const float* cur = ws + (ks & 1) * WS;
      if (ks + 1 < nk) fetch_w_up(w_up, stage, e, d, F, f0, (ks + 1) * KD, tid);
      const float* xk = xT + ks * KD * XS + 4 * ty;
#pragma unroll 8
      for (int kk = 0; kk < KD; ++kk) {
        const float4 xv = *reinterpret_cast<const float4*>(&xk[kk * XS]);
        const float2 wg =
            *reinterpret_cast<const float2*>(&cur[kk * 2 * BF + 2 * tx]);
        const float2 wu =
            *reinterpret_cast<const float2*>(&cur[kk * 2 * BF + BF + 2 * tx]);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          hg[rr][0] = fmaf(xr[rr], wg.x, hg[rr][0]);
          hg[rr][1] = fmaf(xr[rr], wg.y, hg[rr][1]);
          hu[rr][0] = fmaf(xr[rr], wu.x, hu[rr][0]);
          hu[rr][1] = fmaf(xr[rr], wu.y, hu[rr][1]);
        }
      }
      if (ks + 1 < nk) store_stage(ws + ((ks + 1) & 1) * WS, stage, tid);
      __syncthreads();
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float g = hg[rr][jj];
        const float sig = 1.f / (1.f + expf(-g));
        aT[(2 * tx + jj) * XS + 4 * ty + rr] =
            bident::round_to<T>(g * sig * hu[rr][jj]);
      }
    __syncthreads();

    // down projection: w_down rows arrive PF at a time, the next group's
    // loads in flight while this group is multiplied
    const int nf = min(BF, F - f0);
    const T* wd = w_down + ((size_t)e * F + f0) * d;
    float wn[PF][NC];
    fetch_w_down(wd, wn, 0, nf, d, tid);
    for (int j0 = 0; j0 < nf; j0 += PF) {
      float wc[PF][NC];
#pragma unroll
      for (int q = 0; q < PF; ++q)
#pragma unroll
        for (int c = 0; c < NC; ++c) wc[q][c] = wn[q][c];
      fetch_w_down(wd, wn, j0 + PF, nf, d, tid);
#pragma unroll
      for (int q = 0; q < PF; ++q) {
        if (j0 + q >= nf) break;
#pragma unroll
        for (int r4 = 0; r4 < BM / 4; ++r4) {
          const float4 av =
              *reinterpret_cast<const float4*>(&aT[(j0 + q) * XS + 4 * r4]);
          const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int c = 0; c < NC; ++c)
              acc[4 * r4 + rr][c] = fmaf(ar[rr], wc[q][c], acc[4 * r4 + rr][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int row = m0 + r;
    if (row >= cap) break;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tid + NT * c;
      if (col < d)
        y[((size_t)e * cap + row) * d + col] = bident::from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* x, const void* w_up, const void* w_down,
                   void* y, int E, int cap, int d, int F,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaError_t err = bident::allow_smem(glu_kernel<T, NC>, smem);
  if (err != cudaSuccess) return err;
  glu_kernel<T, NC><<<dim3((cap + BM - 1) / BM, E), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_up),
      static_cast<const T*>(w_down), static_cast<T*>(y), cap, d, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w_up, const void* w_down,
                     void* y, int E, int cap, int d, int F,
                     cudaStream_t stream) {
  switch ((d + NT - 1) / NT) {
    case 1: return launch<T, 1>(x, w_up, w_down, y, E, cap, d, F, stream);
    case 2: return launch<T, 2>(x, w_up, w_down, y, E, cap, d, F, stream);
    case 3: return launch<T, 3>(x, w_up, w_down, y, E, cap, d, F, stream);
    case 4: return launch<T, 4>(x, w_up, w_down, y, E, cap, d, F, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes).  x (E, cap, d), w_up (E, d, 2F),
// w_down (E, F, d), y (E, cap, d): contiguous device buffers, float32 or
// (bf16 != 0) bfloat16.  d is at most 1024 (the register accumulator
// holds four columns per thread).  Returns the launch's cudaError_t.
extern "C" int bident_expert_glu(const void* x, const void* w_up,
                                 const void* w_down, void* y, int E, int cap,
                                 int d, int F, int bf16, void* stream) {
  if (E <= 0 || cap <= 0 || d <= 0 || d > 4 * NT || F <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(x, w_up, w_down, y, E, cap, d, F, s)
              : dispatch<float>(x, w_up, w_down, y, E, cap, d, F, s);
}
