// Blockwise causal GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_attn_kernel` of
// src/repro/kernels/flash_attention.py.  Same contract: q (B,Tq,Hq,D),
// k and v (B,Tk,Hk,D) with Hq % Hk == 0 (query head h reads kv head
// h / (Hq/Hk)); q pre-scaled by 1/sqrt(D) in f32; online softmax with f32
// running max m, denominator l (clamped at 1e-30) and accumulator; kv
// positions past Tk and, when causal, above the diagonal (q_offset +
// query row < kv position) masked with -1e30; with `causal`, kv tiles
// wholly above the diagonal are skipped; output in q's dtype.  As in the
// Pallas kernel, q, k, v and p are f32 in the products (a bf16 run
// upcasts; p is never rounded to bf16).
//
// Design for the card, not the TPU grid.  The Pallas grid walks kv blocks
// as a sequential grid axis carrying m/l/acc in VMEM scratch; here one
// block owns one (batch, head, 64-row query tile) and loops over 64-row
// kv tiles itself, in the FlashAttention-2 layout: each of its 4 warps
// owns 16 query rows, so S = Q K^T, the softmax and O += P V stay inside
// the warp.  Both products run on the tensor cores as `m16n8k8` TF32
// `mma.sync` in the 3xTF32 split (common.cuh), which keeps f32 accuracy;
// a bf16 k or v is exact in TF32, so its lo products are skipped.  A
// thread holds two columns of two rows of each S tile, so a row's max and
// sum are two xor-shuffles inside its quad of lanes.
//
// P stays in registers.  The S accumulator gives thread (g, t) kv columns
// 2t and 2t+1 of an 8-column slice, where the A operand of P V wants
// columns t and t+4.  Rather than pass P through shared memory (a store,
// a barrier and a load per tile), the kernel relabels the slice: A's k
// index t stands for kv 2t and t+4 for kv 2t+1, and V's B fragment is read
// from the same permuted rows.  Each slice's sum over kv is then taken in
// a fixed, permuted order, the same in every run.  P V of one kv tile is
// summed in a fresh accumulator and folded in as acc * alpha + pv with f32
// arithmetic, as the Pallas kernel writes it.
//
// q is scaled and split into its TF32 hi and lo parts once, into shared
// memory, and read by `ldmatrix` for every kv tile.  K and V tiles are
// double-buffered in shared memory by `cp.async`: the next tile is in
// flight while this one is multiplied.  Rows are padded
// by 16 bytes so the fragment loads of a warp hit distinct banks.  With
// `causal` the query tiles run heaviest first, so the last wave of
// blocks is the lightest.
//
// D = 160 (StableLM-12B's head).  In f32 the split q (2 x 64 x 164 x 4 B
// = 82 KB) and the double-buffered K and V tiles (4 x 64 x 164 x 4 B =
// 164 KB) come to 246 KB, over the 227 KB a block may have.  There q is
// kept once, scaled, as f32 (41 KB; 205 KB in all) and each `ldmatrix`
// fragment is split into hi and lo in registers: the same bits as the
// stored split, for 12 more integer and float operations per 8-deep step
// of 24 products.  (bf16 K and V tiles halve, so bf16 keeps the stored
// split: 170 KB.)  O's accumulator grows to 20 n8 tiles a warp; P V is
// then summed in two passes of 10 tiles each, so the fresh accumulator
// `pv` holds 40 registers rather than 80.  Each output tile's sum over kv
// runs in the same order in either pass, so the result is the one-pass
// result, bit for bit.
//
// Bound: at the main-path shape (1 x 1024 x 16 x 64, causal) the work is
// 2.15 GFLOP of products against ~17 MB of traffic; f32-accurate products
// cost three TF32 ones: 3 x 2.15 GFLOP / 495 TFLOP/s = 13 us on the
// tensor cores, against 5 us for the bytes, so the kernel is bound by
// operations.
#include <cmath>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // kv rows per tile
constexpr int NT = 128;       // 4 warps
constexpr int SJ = BK / 8;    // n8 tiles of S per warp
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int QS = D + 4;    // row stride of the Q hi / lo tiles
  static constexpr int KS = D + VEC;  // row stride of the K and V tiles
  static constexpr size_t KV_BYTES = sizeof(T) * BK * KS;   // one tile
  // q as its split (hi and lo tiles), or as one f32 tile split at each
  // fragment load where the split does not fit beside 2 x (K, V)
  static constexpr bool Q_SPLIT =
      2 * sizeof(uint32_t) * BQ * QS + 4 * KV_BYTES <= 232448;
  static constexpr size_t Q_BYTES =
      (Q_SPLIT ? 2 : 1) * sizeof(uint32_t) * BQ * QS;
  static constexpr size_t SMEM = Q_BYTES + 4 * KV_BYTES;    // 2 x (K, V)
  static_assert(SMEM <= 232448, "over the 227 KB of shared memory a block may use");
};

// The TF32 operand(s) of one K or V value: hi and lo for f32; for bf16
// the value itself, exact in TF32.
__device__ __forceinline__ void operand(float x, uint32_t& hi, uint32_t& lo) {
  bident::split_tf32(x, hi, lo);
}
__device__ __forceinline__ void operand(__nv_bfloat16 x, uint32_t& hi,
                                        uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(x));
  lo = 0u;
}

// c += a.b in 3xTF32; with an exact b (bf16) its lo product is skipped.
template <typename T>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  bident::mma_tf32(c, al, bh);
  if constexpr (sizeof(T) == 4) bident::mma_tf32(c, ah, bl);
  bident::mma_tf32(c, ah, bh);
}

template <typename T, int D, bool ASYNC>
__global__ void __launch_bounds__(NT)
    attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int B, int Tq,
                int Tk, int Hq, int Hk, int causal, int q_offset,
                float scale) {
  using L = Layout<T, D>;
  constexpr int VEC = L::VEC, QS = L::QS, KS = L::KS;
  constexpr int DJ = D / 8;   // n8 tiles of O per warp
  // n8 tiles of O per pass of P V (two passes above 16 tiles)
  constexpr int DH = DJ > 16 ? DJ / 2 : DJ;
  static_assert(DJ % DH == 0, "P V passes must cover O");
  extern __shared__ float4 smem4[];
  // TF32 hi parts of q (without Q_SPLIT: q itself, scaled, as f32 bits)
  uint32_t* Qh = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* Ql = Qh + BQ * QS;                         // ... and lo parts
  T* KV = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) + L::Q_BYTES);

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int hk = h / (Hq / Hk);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // q scaled in f32 and split once, for every kv tile
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, tq = q0 + r;
    const float qv =
        tq < Tq ? bident::to_f32(q[((size_t)(b * Tq + tq) * Hq + h) * D + c]) *
                      scale
                : 0.f;
    if constexpr (L::Q_SPLIT)
      bident::split_tf32(qv, Qh[r * QS + c], Ql[r * QS + c]);
    else
      Qh[r * QS + c] = __float_as_uint(qv);
  }

  // K and V of kv tile kt into buffer s (zero past Tk)
  auto load_tile = [&](int kt, int s) {
    T* Ks = KV + (2 * s) * BK * KS;
    T* Vs = Ks + BK * KS;
    for (int c = tid; c < BK * D / VEC; c += NT) {
      const int r = c / (D / VEC), cc = c % (D / VEC) * VEC;
      const int tk = kt * BK + r;
      const bool ok = tk < Tk;
      const size_t off = ok ? ((size_t)(b * Tk + tk) * Hk + hk) * D + cc : 0;
      bident::load_chunk<ASYNC>(Ks + r * KS + cc, k + off, ok ? VEC : 0);
      bident::load_chunk<ASYNC>(Vs + r * KS + cc, v + off, ok ? VEC : 0);
    }
  };

  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q_offset + q0 + BQ - 1) / BK + 1);

  // rows of this thread: g and g + 8 of the warp's 16
  const int r_lo = warp * 16 + g;
  // this lane's ldmatrix row of the warp's Q tiles (rows 0-7, k 0-3),
  // (rows 8-15, k 0-3), (rows 0-7, k 4-7), (rows 8-15, k 4-7)
  const int q_off = (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * QS +
                    4 * (lane >> 4);
  const int qpos[2] = {q_offset + q0 + r_lo, q_offset + q0 + r_lo + 8};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DJ][4];
#pragma unroll
  for (int j = 0; j < DJ; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;

  load_tile(0, 0);
  bident::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile(kt + 1, (kt + 1) & 1);
    bident::cp_async_commit();
    bident::cp_async_wait<1>();   // tile kt has landed
    __syncthreads();
    const T* Ks = KV + (2 * (kt & 1)) * BK * KS;
    const T* Vs = Ks + BK * KS;

    // S = Q K^T for the warp's 16 rows x 64 kv columns
    float s[SJ][4];
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      bident::ldmatrix_x4(ah, Qh + q_off + kk * 8);
      if constexpr (L::Q_SPLIT) {
        bident::ldmatrix_x4(al, Ql + q_off + kk * 8);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          bident::split_tf32(__uint_as_float(ah[x]), ah[x], al[x]);
      }
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const T* kr = Ks + (j * 8 + g) * KS + kk * 8 + t;   // B(k, n) = K[n][k]
        uint32_t bh[2], bl[2];
        operand(kr[0], bh[0], bl[0]);
        operand(kr[4], bh[1], bl[1]);
        mma3<T>(s[j], ah, al, bh, bl);
      }
    }

    // mask, online softmax; element x of tile j: row g + 8 (x / 2), kv
    // column 8j + 2t + x % 2
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < SJ; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int kpos = kt * BK + j * 8 + 2 * t + cc;
          const bool ok = kpos < Tk && (!causal || qpos[hr] >= kpos);
          float& sv = s[j][2 * hr + cc];
          sv = ok ? sv : NEG_INF;
          mx = fmaxf(mx, sv);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      alpha[hr] = expf(m[hr] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < SJ; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          float& sv = s[j][2 * hr + cc];
          sv = expf(sv - m_new);   // s now holds p
          ps += sv;
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[hr] = l[hr] * alpha[hr] + ps;
      m[hr] = m_new;
    }

    // pv = P V, P from registers with each 8-column slice's kv order
    // permuted (A's k index t <-> kv 2t, t + 4 <-> kv 2t + 1); O's tiles
    // d0 .. d0 + DH per pass
#pragma unroll
    for (int d0 = 0; d0 < DJ; d0 += DH) {
      float pv[DH][4];
#pragma unroll
      for (int j = 0; j < DH; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) pv[j][x] = 0.f;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        uint32_t ph[4], pl[4];
        bident::split_tf32(s[j][0], ph[0], pl[0]);   // (g,     kv 2t)
        bident::split_tf32(s[j][2], ph[1], pl[1]);   // (g + 8, kv 2t)
        bident::split_tf32(s[j][1], ph[2], pl[2]);   // (g,     kv 2t + 1)
        bident::split_tf32(s[j][3], ph[3], pl[3]);   // (g + 8, kv 2t + 1)
        const T* vr = Vs + (j * 8 + 2 * t) * KS + g + d0 * 8;
#pragma unroll
        for (int dj = 0; dj < DH; ++dj) {
          uint32_t bh[2], bl[2];
          operand(vr[dj * 8], bh[0], bl[0]);        // V[8j + 2t][8dj + g]
          operand(vr[KS + dj * 8], bh[1], bl[1]);   // V[8j + 2t + 1][...]
          mma3<T>(pv[dj], ph, pl, bh, bl);
        }
      }
#pragma unroll
      for (int dj = 0; dj < DH; ++dj)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          acc[d0 + dj][x] = acc[d0 + dj][x] * alpha[x >> 1] + pv[dj][x];
    }
    __syncthreads();   // buffer kt & 1 is free for tile kt + 2
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int tq = q0 + r_lo + 8 * hr;
    if (tq >= Tq) continue;
    const float lc = fmaxf(l[hr], 1e-30f);
    T* out = o + ((size_t)(b * Tq + tq) * Hq + h) * D;
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
        out[dj * 8 + 2 * t + cc] =
            bident::from_f32<T>(acc[dj][2 * hr + cc] / lc);
  }
}

template <typename T, int D, bool ASYNC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Tq, int Tk, int Hq, int Hk, int causal,
                   int q_offset, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::SMEM;
  cudaError_t err = bident::allow_smem(attn_kernel<T, D, ASYNC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Tq + BQ - 1) / BQ);
  attn_kernel<T, D, ASYNC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), B, Tq, Tk, Hq, Hk,
      causal, q_offset,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_aligned(const void* q, const void* k, const void* v,
                           void* o, int B, int Tq, int Tk, int Hq, int Hk,
                           int causal, int q_offset, cudaStream_t stream) {
  return bident::aligned16(k) && bident::aligned16(v)
             ? launch<T, D, true>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal,
                                  q_offset, stream)
             : launch<T, D, false>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal,
                                   q_offset, stream);
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int Tq, int Tk, int Hq, int Hk,
                     int causal, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_aligned<T, 16>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 32: return launch_aligned<T, 32>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 64: return launch_aligned<T, 64>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 128: return launch_aligned<T, 128>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 160: return launch_aligned<T, 160>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
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
  if (B <= 0 || Tq <= 0 || Tk <= 0 || Hk <= 0 || Hq % Hk != 0 ||
      q_offset < 0 || (Tq + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, s)
              : dispatch<float>(D, q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, s);
}
