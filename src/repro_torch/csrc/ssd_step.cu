// One decode step of the gated linear recurrence (Mamba-2's SSD, the
// mLSTM) for Hopper (sm_90a), the state updated in place.
//
// For each (batch, head), in f32:
//
//   a  = exp(log_a)
//   S' = a S + b v^T          (S: N x P, f32, written over S)
//   y  = S'^T c               (P values, written in v's dtype)
//
// It replaces no Pallas kernel: the reference's decode step is jnp
// (repro.models.layers.linear_recurrence_step), which XLA fuses into one
// pass over the donated state.  In PyTorch the same step is five passes
// over S (S a, b v^T, the add, the read-out, the copy into the cache),
// each a read or write of the whole f32 state; at Zamba2-2.7B's decode
// (batch 32, 80 heads, N = P = 64: 41.9 MB a layer) that is ~378 MB a
// layer.  This kernel reads S once and writes it once (83.9 MB a layer).
//
// Bound: bytes.  About 0.5 flop a byte, so no tensor core helps; the
// least time is S's read and write over the card's bandwidth (25.0 us a
// layer at Zamba2-2.7B's decode on an H100 at 3.35 TB/s).  Design:
//
// * one block of 256 threads per (b, h, tile of up to 16 column units);
//   a column unit is 4 floats (16-byte loads and stores) where P % 4 == 0
//   and S lies on a 16-byte boundary, else one float (the mLSTM's P =
//   N + 1); Zamba2-2.7B's decode is 2,560 blocks of one tile each, the
//   mLSTM's at batch 4 400 blocks of 25 tiles (64-column tiles gave 112
//   blocks and 1.7x its time: PERF.md);
// * c and b (N values) and the tile's v are staged in shared memory in
//   f32, read through their strides (the decode's operands are views: at
//   Zamba2-2.7B c and b are one group's rows for every head, batch-minor,
//   so a copy into (B, H, N) would be three more kernels a layer), and
//   a = exp(log_a) is computed once a block;
// * a thread owns one column unit and walks the rows n = g, g + G, ...
//   (g its row group, G = 256 / units in the tile: 16), loading
//   UNROLL rows before it updates and stores any, so that the loads are in
//   flight together (the compiler cannot move a load of S past a store to
//   S through the same pointer);
// * S' = fl(fl(a S) + fl(b v)): a product and a sum, each rounded (no
//   contraction into an FMA), as PyTorch's S * a + b v^T computes it, so
//   the new state is bitwise the plain step's;
// * y: each thread sums c[n] S'[n, :] over its rows in order, then the
//   row groups' partial sums are added in order through shared memory.
//   No atomics, so a run is bitwise reproducible and a captured step
//   gives the eager step's bits.
#include "common.cuh"

namespace {

using namespace bident;

constexpr int THREADS = 256;
constexpr int TILE_UNITS = 16;   // column units a block at most
constexpr int UNROLL = 4;        // rows a thread loads before it stores

// Element strides of c and b over (batch, head, row) and of v over
// (batch, head, column).
struct Strides {
  int cb, ch, cn, bb, bh, bn, vb, vh, vp;
};

template <int VEC>
struct Row;
template <>
struct Row<4> {
  static __device__ __forceinline__ void load(float (&s)[4], const float* p) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    s[0] = t.x, s[1] = t.y, s[2] = t.z, s[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&s)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(s[0], s[1], s[2], s[3]));
  }
};
template <>
struct Row<1> {
  static __device__ __forceinline__ void load(float (&s)[1], const float* p) {
    s[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&s)[1]) {
    __stcs(p, s[0]);
  }
};

// units: column units of a row (P / VEC); tile: column units a block
// (min(units, TILE_UNITS)); groups: row groups (THREADS / tile).  S is
// read and written with the streaming hints (ld.global.cs, st.global.cs),
// each line being touched once a step: 4.5% less time than plain loads
// and stores at Zamba2-2.7B's decode (PERF.md).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    ssd_step_kernel(float* __restrict__ S, const T* __restrict__ c,
                    const T* __restrict__ b, const T* __restrict__ v,
                    const float* __restrict__ log_a, T* __restrict__ y,
                    Strides st, int H, int N, int P, int units, int tile,
                    int groups) {
  extern __shared__ float smem[];
  float* sc = smem;                        // N
  float* sb = sc + N;                      // N
  float* sv = sb + N;                      // tile * VEC
  float* red = sv + tile * VEC;            // groups * tile * VEC
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int u0 = blockIdx.y * tile;
  const size_t bi = bh / H, hi = bh % H;
  const T* cr = c + bi * st.cb + hi * st.ch;
  const T* br = b + bi * st.bb + hi * st.bh;
  const T* vr = v + bi * st.vb + hi * st.vh;
  for (int i = tid; i < N; i += THREADS) {
    sc[i] = to_f32(cr[static_cast<size_t>(i) * st.cn]);
    sb[i] = to_f32(br[static_cast<size_t>(i) * st.bn]);
  }
  for (int i = tid; i < tile * VEC; i += THREADS) {
    const int p = u0 * VEC + i;
    sv[i] = p < P ? to_f32(vr[static_cast<size_t>(p) * st.vp]) : 0.f;
  }
  const float a = expf(log_a[bh]);
  __syncthreads();

  const int g = tid / tile, cu = tid % tile, u = u0 + cu;
  const bool active = g < groups && u < units;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  if (active) {
    float vv[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) vv[k] = sv[cu * VEC + k];
    float* col = S + static_cast<size_t>(bh) * N * P + u * VEC;
    for (int n0 = g; n0 < N; n0 += groups * UNROLL) {
      float s[UNROLL][VEC];
#pragma unroll
      for (int r = 0; r < UNROLL; ++r) {
        const int n = n0 + r * groups;
        if (n < N) Row<VEC>::load(s[r], col + static_cast<size_t>(n) * P);
      }
#pragma unroll
      for (int r = 0; r < UNROLL; ++r) {
        const int n = n0 + r * groups;
        if (n < N) {
          const float bn = sb[n], cn = sc[n];
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            s[r][k] = __fadd_rn(__fmul_rn(s[r][k], a), __fmul_rn(bn, vv[k]));
            acc[k] = fmaf(cn, s[r][k], acc[k]);
          }
          Row<VEC>::store(col + static_cast<size_t>(n) * P, s[r]);
        }
      }
    }
  }
  if (g < groups) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[(g * tile + cu) * VEC + k] = acc[k];
  }
  __syncthreads();
  if (g == 0 && u < units) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float t = 0.f;
      for (int j = 0; j < groups; ++j) t += red[(j * tile + cu) * VEC + k];
      y[static_cast<size_t>(bh) * P + u * VEC + k] = from_f32<T>(t);
    }
  }
}

template <typename T, int VEC>
cudaError_t run(float* S, const void* c, const void* b, const void* v,
                const float* log_a, void* y, const Strides& st, int B, int H,
                int N, int P, cudaStream_t stream) {
  const int units = P / VEC;
  const int tile = units < TILE_UNITS ? units : TILE_UNITS;
  const int groups = THREADS / tile;
  const int tiles = (units + tile - 1) / tile;
  const size_t smem = sizeof(float) *
                      (2 * static_cast<size_t>(N) + tile * VEC * (1 + groups));
  auto kernel = ssd_step_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B * H, tiles), THREADS, smem, stream>>>(
      S, static_cast<const T*>(c), static_cast<const T*>(b),
      static_cast<const T*>(v), log_a, static_cast<T*>(y), st, H, N, P, units,
      tile, groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(float* S, const void* c, const void* b, const void* v,
                     const float* log_a, void* y, const Strides& st, int B,
                     int H, int N, int P, cudaStream_t stream) {
  // 16-byte rows where every row of S starts on a 16-byte boundary
  if (P % 4 == 0 && aligned16(S))
    return run<T, 4>(S, c, b, v, log_a, y, st, B, H, N, P, stream);
  return run<T, 1>(S, c, b, v, log_a, y, st, B, H, N, P, stream);
}

}  // namespace

// S (B, H, N, P) f32, contiguous, updated in place; c, b (B, H, N) and
// v (B, H, P) in one dtype (f32, or bf16 when bf16 != 0), at the element
// strides (cb, ch, cn), (bb, bh, bn) and (vb, vh, vp); log_a (B, H) f32
// and y (B, H, P) in v's dtype, contiguous.
extern "C" int bident_ssd_step(void* S, const void* c, const void* b,
                               const void* v, const void* log_a, void* y,
                               int B, int H, int N, int P, int cb, int ch,
                               int cn, int bb, int bh, int bn, int vb, int vh,
                               int vp, int bf16, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || P <= 0 ||
      static_cast<long long>(B) * H > 2147483647LL)
    return cudaErrorInvalidValue;
  const Strides st{cb, ch, cn, bb, bh, bn, vb, vh, vp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* St = static_cast<float*>(S);
  const float* la = static_cast<const float*>(log_a);
  if (bf16)
    return dispatch<__nv_bfloat16>(St, c, b, v, la, y, st, B, H, N, P, s);
  return dispatch<float>(St, c, b, v, la, y, st, B, H, N, P, s);
}
