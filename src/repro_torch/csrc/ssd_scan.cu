// Chunked Mamba-2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` / `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py.  Recurrence S_t = exp(log_a_t) S_{t-1}
// + b_t v_t^T, y_t = c_t^T S_t, evaluated chunk by chunk as the Pallas
// kernel does:
//
//   intra:  y  = ((c b^T) o L) v          L[i,j] = exp(cum_i - cum_j), i >= j
//   inter:  y += (c o exp(cum)) S_prev
//   carry:  S  = S_prev exp(tot) + (b o exp(tot - cum))^T v
//
// with cum the in-chunk prefix sum of log_a and tot its last entry.  The
// (N, P) state is f32; padded tail steps (t >= T) get log_a = 0 and b = 0
// so they carry the state through unchanged.  y is written in v's dtype,
// the final state in f32.
//
// Design for the card.  The Pallas grid (B, H, chunks) runs its chunk
// axis sequentially with the state in VMEM scratch; on the GPU blocks
// run in no order, so the chunk axis is a loop inside the block.  The
// state's P columns are independent of each other (y[:, p] and S[:, p]
// read only v[:, p]), so one block owns one (batch, head, 16-column
// slice of P): the main path gets B*H*P/16 = 64 blocks instead of 16.
// Each block recomputes the chunk's C x C intra-chunk matrix G — the
// price of the split — and keeps its (N x 16) slice of the f32 state in
// shared memory for the whole sequence, next to the chunk's c, b tiles,
// its v columns and the decay vectors.  Each phase of a chunk (G =
// (c b^T) o L, then y, then the carry) is a loop of independent dot
// products over the block's 256 threads, separated by barriers; every
// sum runs in a fixed order, so a run is bitwise reproducible.  Rows of
// the c and b tiles are padded by one float: consecutive threads read
// consecutive rows of b when they build G.
//
// Bound: the main path (B*H = 16 sequences of 1024 steps, N = P = 64,
// chunk 64) moves ~17 MB (c, b, v and log_a in, y and the final state
// out) against ~0.27 GFLOP for the recurrence itself, so the least time
// is set by the bytes (~5 us).  Known limit of this design: 64 blocks
// leave half of the card's 132 SMs idle, every block walks its 16 chunks
// in order, and the redundant G and the shared-memory dot products (two
// loads per FMA) keep it far from that bound.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int CMAX = 64;
constexpr int PB = 16;   // state columns per block

inline size_t smem_floats(int C, int N) {
  return (size_t)2 * C * (N + 1) + (size_t)C * PB + (size_t)N * PB +
         (size_t)C * C + 3 * C;
}

template <typename T>
__global__ void __launch_bounds__(NT)
    ssd_kernel(const T* __restrict__ c, const T* __restrict__ b,
               const T* __restrict__ v, const float* __restrict__ log_a,
               const float* __restrict__ s0, T* __restrict__ y,
               float* __restrict__ s_final, int T_len, int H, int N, int P,
               int C) {
  const int NP1 = N + 1;
  extern __shared__ float smem[];
  float* cs = smem;              // C x (N+1)
  float* bs = cs + C * NP1;      // C x (N+1)
  float* vs = bs + C * NP1;      // C x PB, this block's v columns
  float* S = vs + C * PB;        // N x PB, this block's state columns
  float* G = S + N * PB;         // C x C, (c b^T) o L
  float* cum = G + C * C;        // C, prefix sum of log_a
  float* ecum = cum + C;         // C, exp(cum)
  float* wdec = ecum + C;        // C, exp(tot - cum)

  const int h = blockIdx.x;
  const int bb = blockIdx.y;
  const int p0 = blockIdx.z * PB;
  const int tid = threadIdx.x;
  const size_t sp = (size_t)(bb * H + h) * N * P;

  for (int e = tid; e < N * PB; e += NT) {
    const int n = e / PB, p = p0 + e % PB;
    S[e] = (s0 && p < P) ? s0[sp + (size_t)n * P + p] : 0.f;
  }

  const int n_chunks = (T_len + C - 1) / C;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * C;
    __syncthreads();  // the previous chunk's tiles and S are consumed
    for (int e = tid; e < C * N; e += NT) {
      const int i = e / N, n = e % N, t = t0 + i;
      float cv = 0.f, bv = 0.f;
      if (t < T_len) {
        const size_t off = ((size_t)(bb * T_len + t) * H + h) * N + n;
        cv = bident::to_f32(c[off]);
        bv = bident::to_f32(b[off]);
      }
      cs[i * NP1 + n] = cv;
      bs[i * NP1 + n] = bv;
    }
    for (int e = tid; e < C * PB; e += NT) {
      const int i = e / PB, p = p0 + e % PB, t = t0 + i;
      vs[e] = (t < T_len && p < P)
                  ? bident::to_f32(v[((size_t)(bb * T_len + t) * H + h) * P + p])
                  : 0.f;
    }
    if (tid < 32) {
      // in-chunk prefix sum of log_a: one warp, two elements a lane,
      // shuffle scans in a fixed order (padded steps add 0)
      const int t = t0 + tid, u = t + 32;
      float a = (tid < C && t < T_len)
                    ? log_a[(size_t)(bb * T_len + t) * H + h] : 0.f;
      float z = (tid + 32 < C && u < T_len)
                    ? log_a[(size_t)(bb * T_len + u) * H + h] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float ua = __shfl_up_sync(0xffffffffu, a, off);
        const float uz = __shfl_up_sync(0xffffffffu, z, off);
        if (tid >= off) {
          a += ua;
          z += uz;
        }
      }
      z += __shfl_sync(0xffffffffu, a, 31);
      if (tid < C) cum[tid] = a;
      if (tid + 32 < C) cum[tid + 32] = z;
    }
    __syncthreads();
    if (tid < C) {
      ecum[tid] = expf(cum[tid]);
      wdec[tid] = expf(cum[C - 1] - cum[tid]);
    }

    for (int e = tid; e < C * C; e += NT) {
      const int i = e / C, j = e % C;
      float g = 0.f;
      if (j <= i) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n)
          dot = fmaf(cs[i * NP1 + n], bs[j * NP1 + n], dot);
        g = dot * expf(cum[i] - cum[j]);
      }
      G[e] = g;
    }
    __syncthreads();

    for (int e = tid; e < C * PB; e += NT) {
      const int i = e / PB, pl = e % PB, t = t0 + i;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j)
        intra = fmaf(G[i * C + j], vs[j * PB + pl], intra);
      float inter = 0.f;
      const float ei = ecum[i];
      for (int n = 0; n < N; ++n)
        inter = fmaf(cs[i * NP1 + n] * ei, S[n * PB + pl], inter);
      if (t < T_len && p0 + pl < P)
        y[((size_t)(bb * T_len + t) * H + h) * P + p0 + pl] =
            bident::from_f32<T>(intra + inter);
    }
    __syncthreads();  // y has read S; now carry it

    const float etot = expf(cum[C - 1]);
    for (int e = tid; e < N * PB; e += NT) {
      const int n = e / PB, pl = e % PB;
      float cs_ = 0.f;
      for (int i = 0; i < C; ++i)
        cs_ = fmaf(bs[i * NP1 + n] * wdec[i], vs[i * PB + pl], cs_);
      S[e] = S[e] * etot + cs_;
    }
  }
  __syncthreads();
  for (int e = tid; e < N * PB; e += NT) {
    const int n = e / PB, p = p0 + e % PB;
    if (p < P) s_final[sp + (size_t)n * P + p] = S[e];
  }
}

template <typename T>
cudaError_t launch(const void* c, const void* b, const void* v,
                   const float* log_a, const float* s0, void* y,
                   float* s_final, int B, int T_len, int H, int N, int P,
                   int C, cudaStream_t stream) {
  const size_t smem = smem_floats(C, N) * sizeof(float);
  cudaError_t err = bident::allow_smem(ssd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<dim3(H, B, (P + PB - 1) / PB), NT, smem, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(b),
      static_cast<const T*>(v), log_a, s0, static_cast<T*>(y), s_final,
      T_len, H, N, P, C);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  c, b (B,T,H,N) and v (B,T,H,P) in
// float32 or (bf16 != 0) bfloat16; log_a (B,T,H) float32; s0 (B,H,N,P)
// float32 or NULL for a zero initial state; y (B,T,H,P) in v's dtype;
// s_final (B,H,N,P) float32.  All contiguous device buffers.  The chunk
// length C is at most 64 and N at most 128 (shared-memory budget).
// Returns the launch's cudaError_t (0 on success).
extern "C" int bident_ssd_scan(const void* c, const void* b, const void* v,
                               const void* log_a, const void* s0, void* y,
                               void* s_final, int B, int T_len, int H, int N,
                               int P, int C, int bf16, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || C <= 0 || C > CMAX || N <= 0 ||
      N > 128 || P <= 0 || P > 128)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* st = static_cast<const float*>(s0);
  float* sf = static_cast<float*>(s_final);
  return bf16 ? launch<__nv_bfloat16>(c, b, v, la, st, y, sf, B, T_len, H, N, P, C, s)
              : launch<float>(c, b, v, la, st, y, sf, B, T_len, H, N, P, C, s);
}
