// Blockwise causal GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_attn_kernel` of
// src/repro/kernels/flash_attention.py.  Same contract: q (B,Tq,Hq,D),
// k and v (B,Tk,Hk,D) with Hq % Hk == 0 (query head h reads kv head
// h / (Hq/Hk)); q pre-scaled by 1/sqrt(D) in f32; online softmax with f32
// running max m, denominator l (clamped at 1e-30) and accumulator; kv
// positions past Tk and, when causal, above the diagonal (q_offset +
// query row < kv position) masked with -1e30; with `causal`, kv tiles
// wholly above the diagonal are skipped; output in q's dtype.
//
// Design for the card, not the TPU grid.  The Pallas grid walks kv blocks
// as a sequential grid axis carrying m/l/acc in VMEM scratch; here one
// block owns one (batch, head, 64-row query tile) and loops over 64-row
// kv tiles itself.  256 threads form a 16x16 grid: thread (ty, tx) owns
// score rows ty+16i and columns tx+16j (a 4x4 micro-tile), and output
// rows ty+16i, columns tx+16c.  The 16 threads that share a row are one
// half-warp, so the row max and row sum are xor-shuffles; m, l and the
// accumulator live in registers, the only shared-memory traffic is the
// q/k/v tiles and the probability tile P that feeds P.V.  Rows of the
// q and k tiles are padded by one float so the half-warp's 16 rows fall
// in 16 different banks.
//
// Bound: at the main-path shape (1 x 1024 x 16 x 64, causal) the work is
// ~2.1 GFLOP of f32 products against ~17 MB of traffic, so the kernel is
// bound by f32 operations (67 TFLOP/s without tensor cores, ~32 us), not
// bytes.  This first version keeps the products on the CUDA cores in
// full f32 (TF32 tensor cores would not hold the 3e-4 f32 bucket); its
// inner loop issues one shared-memory load per two FMAs, which is what
// holds it below the f32 peak.
#include <cmath>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int Tq, int Tk,
                int Hq, int Hk, int causal, int q_offset, float scale) {
  constexpr int DP = D + 1;    // padded row stride of the q and k tiles
  constexpr int PP = BK + 1;   // padded row stride of the P tile
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D, t = q0 + r;
    float val = 0.f;
    if (t < Tq) val = bident::to_f32(q[((size_t)(b * Tq + t) * Hq + h) * D + d]) * scale;
    Qs[r * DP + d] = val;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q_offset + q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e % D, t = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < Tk) {
        const size_t off = ((size_t)(b * Tk + t) * Hk + hk) * D + d;
        kv = bident::to_f32(k[off]);
        vv = bident::to_f32(v[off]);
      }
      Ks[r * DP + d] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_offset + q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool ok = k_pos < Tk && (!causal || q_pos >= k_pos);
        s[i][j] = ok ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pa[4], vb[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vb[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      o[((size_t)(b * Tq + t) * Hq + h) * D + tx + 16 * c] =
          bident::from_f32<T>(acc[i][c] / lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Tq, int Tk, int Hq, int Hk, int causal,
                   int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = bident::allow_smem(attn_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  attn_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, Tk, Hq, Hk, causal,
      q_offset, static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int Tq, int Tk, int Hq, int Hk,
                     int causal, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes).  q/k/v/o are contiguous device
// buffers of the shapes above; `bf16` selects bfloat16 operands (else
// float32).  Returns the launch's cudaError_t (0 on success).
extern "C" int bident_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int B, int Tq,
                                      int Tk, int Hq, int Hk, int D,
                                      int causal, int q_offset, int bf16,
                                      void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || Hk <= 0 || Hq % Hk != 0 || q_offset < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, s)
              : dispatch<float>(D, q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, s);
}
