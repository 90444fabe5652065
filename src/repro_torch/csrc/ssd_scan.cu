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
// axis sequentially with the state in VMEM scratch.  Here only the carry
// is sequential, and it is short; everything else is parallel over
// chunks, in three kernels launched by one C call (Mamba-2's own GPU
// structure):
//
//   1. chunk states: one block per (b, h, chunk, 64 state columns, 128
//      state rows) computes the chunk's cum and tot and its own
//      contribution (b o exp(tot - cum))^T v, a (128, 64) f32 tile of
//      the (N, P) one, into a scratch buffer (B, H, nc, N, P) that the
//      wrapper allocates, and tot into a (B, H, nc) one (rows of the
//      state are independent, so slicing N sums nothing across blocks);
//   2. state pass: one thread per (b, h, n, p) walks the chunks in order,
//      S = S exp(tot) + chunk_state from s0 (the Pallas carry, the same
//      operations in the same order), overwriting each chunk state with
//      the state entering that chunk, and writes the final state;
//   3. chunk outputs: one block per (b, h, chunk, 64-row q tile, 64
//      columns of P) is causal linear attention with a decay mask, in
//      the layout of flash_attention.cu: 4 warps of 16 rows; the score
//      tile c b^T of each 64-row kv tile is masked, scaled by
//      exp(cum_i - cum_j) and kept in registers with the kv order
//      permuted within each 8-wide slice, so its product with v needs no
//      shared-memory trip; the inter term is c S_in with each row scaled
//      by exp(cum_i).  No C x C tile is held anywhere, so the chunk goes
//      up to the Pallas kernel's 256.
//
// Kernel 3 and large states.  Its contractions run over N (c S_in and
// c b^T).  The block keeps its 64 c rows (64 x N) in shared memory and
// streams the rest through two buffers by `cp.async`, in stages of 128
// state rows: first S_in's slices (128 x 64 f32), then for each kv tile
// its b slices (64 x 128), the last with the tile's v (64 x 64).  Each
// slice's products are summed into the same register accumulators, in
// the order of N, with the fresh-accumulator stages of FOLD_K8 below at
// the same boundaries as one unsliced pass: for N <= 128 there is one
// slice, and for any N the result is that of a pass over all of N, bit
// for bit, with no atomics and no split across blocks.  At N = 384 in
// f32 that is 97 KB of c rows and 2 x 50 KB of buffers (xLSTM-125M's
// mLSTM, N = 384, P = 385); the c rows bound N at 496 in f32.
//
// Unaligned rows.  `cp.async` copies 16 bytes from a 16-byte boundary, so
// rows of b, v (and S_in) whose length is not a multiple of 16 bytes (v
// of P = 385: the mLSTM's v with its column of ones) take plain loads
// and 16-byte stores into shared memory instead (ASYNC = false), and the
// last 64-column tile of P masks its dead columns.
//
// The prefix sum is one warp's shuffle scan in a fixed order, the same
// function in kernels 1 and 3, so both see the same bits of cum.  The
// decay is always taken in difference form, exp(cum_i - cum_j) and
// exp(tot - cum_i) (both <= 0 in the exponent): the split form
// exp(cum_i) exp(-cum_j) overflows at chunk 256 under strong decay.
//
// Products.  Every product runs on the tensor cores as `m16n8k8` TF32
// `mma.sync` in the 3xTF32 split (common.cuh), which keeps f32 accuracy;
// a bf16 c, b or v is exact in TF32, so its lo products are skipped (the
// decay-scaled operands b o w and G = (c b^T) o L, and the state, are f32
// and keep all three).  The accumulator truncates, so every chain is at
// most 32 deep in K: a fresh accumulator per 32-deep stage, added to the
// running sum in f32 (FOLD_K8 below).  Every sum runs in a fixed order
// and nothing uses atomics, so two runs give the same bits.
//
// Bound: the main path (B*H = 16 sequences of 1024 steps, N = P = 64,
// chunk 64) moves 17.1 MB (c, b, v and log_a in, y and the final state
// out): 5.1 us at 3.35 TB/s, against 0.54 GFLOP of chunked algebra with
// full tiles, 3.3 us as 3xTF32 at 495 TFLOP/s: bound by the bytes.  The
// chunk states and passed states add ~17 MB of round trips of this
// design's own (mostly in L2).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 128;       // 4 warps
constexpr int CMAX = 256;     // longest chunk
constexpr int SL = 128;       // state rows per slice (kernels 1 and 3)
constexpr int MAX_N = 496;    // largest N (kernel 3's c rows in f32)
constexpr int PT = 64;        // state columns per block (kernels 1 and 3)
constexpr int KS = 32;        // chunk rows per stage of kernel 1
constexpr int BQ = 64;        // q rows per block of kernel 3 (16 per warp)
constexpr int BK = 64;        // kv rows per tile of kernel 3
static_assert(BQ == BK, "kernel 3 loads q and kv rows with one loop");
constexpr int FOLD_K8 = 4;    // k8 steps summed in one fresh accumulator
constexpr int PASS_BATCH = 8; // chunk states loaded ahead in the pass

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// rows of N in one slice: at most SL
__host__ __device__ inline int slice_rows(int N) { return N < SL ? N : SL; }

// The TF32 operand(s) of one value: hi and lo for f32; for an exact value
// (a bf16 operand) the value itself and no lo.
template <bool EXACT>
__device__ __forceinline__ void operand(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    bident::split_tf32(x, hi, lo);
  }
}

// c += a.b in 3xTF32; the lo product of an exact operand is skipped.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if constexpr (!A_EXACT) bident::mma_tf32(c, al, bh);
  if constexpr (!B_EXACT) bident::mma_tf32(c, ah, bl);
  bident::mma_tf32(c, ah, bh);
}

template <int NJ>
__device__ __forceinline__ void zero(float (&a)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) a[j][x] = 0.f;
}

// acc += part, then part = 0: the end of one stage's fresh accumulator
template <int NJ>
__device__ __forceinline__ void fold(float (&acc)[NJ][4],
                                     float (&part)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      acc[j][x] += part[j][x];
      part[j][x] = 0.f;
    }
}

// cum[i] = log_a[t0] + ... + log_a[t0 + i] for i < C, padded steps
// (t >= T) adding 0; by one warp, 32 steps a round: a shuffle scan of the
// round, plus the last entry of the round before.  The same order in
// every kernel and every run.  The loads of all rounds are issued first.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ log_a,
                                             float* cum, int bb, int h,
                                             int t0, int T_len, int H, int C,
                                             int lane) {
  float a[CMAX / 32];
#pragma unroll
  for (int k = 0; k < CMAX / 32; ++k) {
    const int i = 32 * k + lane, t = t0 + i;
    a[k] = (i < C && t < T_len) ? log_a[(size_t)(bb * T_len + t) * H + h]
                                : 0.f;
  }
  float carry = 0.f;
#pragma unroll
  for (int k = 0; k < CMAX / 32; ++k) {
    if (32 * k >= C) break;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, a[k], off);
      if (lane >= off) a[k] += u;
    }
    if (k > 0) a[k] += carry;
    carry = __shfl_sync(0xffffffffu, a[k], 31);
    if (32 * k + lane < C) cum[32 * k + lane] = a[k];
  }
}

// Elements cc .. cc + 16 / sizeof(T) of a tile row in shared memory from
// device row `src`, of which the first `n_valid` elements exist (0 for a
// row past the chunk or the sequence; `src` then only needs to be a
// valid pointer); the rest are set to zero.
template <bool ASYNC, typename T>
__device__ __forceinline__ void load_row_chunk(T* dst, const T* src, int cc,
                                               int n_valid) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = min(max(n_valid - cc, 0), VEC);
  bident::load_chunk<ASYNC>(dst + cc, nv > 0 ? src + cc : src, nv);
}

// ---------------------------------------------------------------------------
// kernel 1: chunk states
// ---------------------------------------------------------------------------

template <typename T>
struct StateLayout {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int VS = PT + 8;   // row stride of the v stages
  // row stride of the b stages: a slice's NP16 + 8, so the column reads
  // of a warp (rows t, columns g) hit distinct banks
  static __host__ __device__ int bs(int N) {
    return round_up(slice_rows(N), 16) + 8;
  }
  static size_t smem(int N) {
    return 2 * CMAX * sizeof(float) +
           2 * KS * (size_t)(bs(N) + VS) * sizeof(T);
  }
};

// MT: m16 tiles of the slice's rows per warp (1 for N <= 64, else 2)
template <typename T, bool ASYNC, int MT>
__global__ void __launch_bounds__(NT)
    state_kernel(const T* __restrict__ b, const T* __restrict__ v,
                 const float* __restrict__ log_a, float* __restrict__ states,
                 float* __restrict__ tot, int T_len, int H, int N, int P,
                 int C, int nc) {
  using L = StateLayout<T>;
  constexpr int VEC = L::VEC, VS = L::VS;
  constexpr bool EXACT = sizeof(T) == 2;
  // blockIdx.z: the 64-column tile of P, then the 128-row slice of N
  const int pt = (P + PT - 1) / PT;
  const int p0 = blockIdx.z % pt * PT, n0 = blockIdx.z / pt * SL;
  const int BS = L::bs(N), NP16 = round_up(slice_rows(N - n0), 16);
  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);   // CMAX
  float* w = cum + CMAX;                          // CMAX, exp(tot - cum)
  T* stage = reinterpret_cast<T*>(w + CMAX);      // 2 x (b KS x BS, v KS x VS)

  const int ci = blockIdx.x, bh = blockIdx.y;
  const int bb = bh / H, h = bh % H;
  const int t0 = ci * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_stages = (C + KS - 1) / KS;

  auto load_stage = [&](int s, int buf) {
    T* bs_ = stage + buf * KS * (BS + VS);
    T* vs_ = bs_ + KS * BS;
    for (int e = tid; e < KS * (NP16 / VEC); e += NT) {
      const int r = e / (NP16 / VEC), cc = e % (NP16 / VEC) * VEC;
      const int i = s * KS + r, tt = t0 + i;
      const bool ok = i < C && tt < T_len;
      load_row_chunk<ASYNC>(
          bs_ + r * BS,
          ok ? b + ((size_t)(bb * T_len + tt) * H + h) * N + n0 : b, cc,
          ok ? N - n0 : 0);
    }
    for (int e = tid; e < KS * (PT / VEC); e += NT) {
      const int r = e / (PT / VEC), cc = e % (PT / VEC) * VEC;
      const int i = s * KS + r, tt = t0 + i;
      const bool ok = i < C && tt < T_len;
      load_row_chunk<ASYNC>(
          vs_ + r * VS,
          ok ? v + ((size_t)(bb * T_len + tt) * H + h) * P + p0 : v, cc,
          ok ? P - p0 : 0);
    }
  };

  load_stage(0, 0);
  bident::cp_async_commit();
  if (warp == 0) chunk_cumsum(log_a, cum, bb, h, t0, T_len, H, C, lane);
  __syncthreads();
  const float ctot = cum[C - 1];
  for (int i = tid; i < n_stages * KS; i += NT)
    w[i] = i < C ? expf(ctot - cum[i]) : 0.f;
  if (blockIdx.z == 0 && tid == 0) tot[(size_t)bh * nc + ci] = ctot;

  // a stage is KS / 8 k8 steps; each m tile's fresh sum is folded every
  // FOLD_K8 of them, so one sum serves all m tiles where that is every
  // stage
  constexpr int FOLD_STAGES = FOLD_K8 / (KS / 8);
  constexpr int PARTS = FOLD_STAGES > 1 ? MT : 1;
  float acc[MT][PT / 8][4], part[PARTS][PT / 8][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) zero(acc[mi]);
#pragma unroll
  for (int mi = 0; mi < PARTS; ++mi) zero(part[mi]);

  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) load_stage(s + 1, (s + 1) & 1);
    bident::cp_async_commit();
    bident::cp_async_wait<1>();   // stage s has landed
    __syncthreads();              // ... for every thread, and w is written
    const T* bs_ = stage + (s & 1) * KS * (BS + VS);
    const T* vs_ = bs_ + KS * BS;
    const float* ws = w + s * KS;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int m0 = (warp + 4 * mi) * 16;
      if (m0 >= NP16) break;
#pragma unroll
      for (int kk = 0; kk < KS / 8; ++kk) {
        // A(m, k) = b[k][m] w[k]: row m of (b o w)^T
        const int k0 = kk * 8 + t;
        uint32_t ah[4], al[4];
        bident::split_tf32(bident::to_f32(bs_[k0 * BS + m0 + g]) * ws[k0],
                           ah[0], al[0]);
        bident::split_tf32(bident::to_f32(bs_[k0 * BS + m0 + g + 8]) * ws[k0],
                           ah[1], al[1]);
        bident::split_tf32(
            bident::to_f32(bs_[(k0 + 4) * BS + m0 + g]) * ws[k0 + 4], ah[2],
            al[2]);
        bident::split_tf32(
            bident::to_f32(bs_[(k0 + 4) * BS + m0 + g + 8]) * ws[k0 + 4],
            ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < PT / 8; ++j) {
          uint32_t bh[2], bl[2];
          operand<EXACT>(bident::to_f32(vs_[k0 * VS + j * 8 + g]), bh[0],
                         bl[0]);
          operand<EXACT>(bident::to_f32(vs_[(k0 + 4) * VS + j * 8 + g]),
                         bh[1], bl[1]);
          mma3<false, EXACT>(part[mi % PARTS][j], ah, al, bh, bl);
        }
      }
      if ((s + 1) % FOLD_STAGES == 0 || s + 1 == n_stages)
        fold(acc[mi], part[mi % PARTS]);
    }
    __syncthreads();   // buffer s & 1 is free for stage s + 2
  }

  float* out = states + ((size_t)bh * nc + ci) * N * P;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int m0 = (warp + 4 * mi) * 16;
#pragma unroll
    for (int j = 0; j < PT / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int n = n0 + m0 + g + 8 * (x >> 1),
                  p = p0 + j * 8 + 2 * t + (x & 1);
        if (n < N && p < P) out[(size_t)n * P + p] = acc[mi][j][x];
      }
  }
}

// ---------------------------------------------------------------------------
// kernel 2: the state pass
// ---------------------------------------------------------------------------

// One thread per (b, h, n, p): S = s0 (or 0); for each chunk c in order,
// hand S to the chunk (in place of its chunk state) and carry it,
// S = S exp(tot_c) + chunk_state_c, in the Pallas kernel's operations
// (a product, then a sum, each rounded); the last S is the final state.
// Chunk states are read PASS_BATCH at a time ahead of the carry.
__global__ void __launch_bounds__(256)
    pass_kernel(const float* __restrict__ s0, float* __restrict__ states,
                const float* __restrict__ tot, float* __restrict__ s_final,
                int BH, int NP, int nc) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BH * NP) return;
  const int bh = idx / NP, e = idx % NP;
  float S = s0 ? s0[idx] : 0.f;
  float* st = states + (size_t)bh * nc * NP + e;
  const float* tt = tot + (size_t)bh * nc;
  for (int c0 = 0; c0 < nc; c0 += PASS_BATCH) {
    float cs[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (c0 + k < nc) cs[k] = st[(size_t)(c0 + k) * NP];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (c0 + k < nc) {
        st[(size_t)(c0 + k) * NP] = S;
        S = __fadd_rn(__fmul_rn(S, expf(tt[c0 + k])), cs[k]);
      }
  }
  s_final[idx] = S;
}

// ---------------------------------------------------------------------------
// kernel 3: chunk outputs
// ---------------------------------------------------------------------------

template <typename T>
struct OutLayout {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int VS = PT + VEC;   // row stride of the v tiles
  static constexpr int SS = PT + 8;     // row stride of the S_in slices
  // row stride of the c rows: NP8 + VEC, so a warp's fragment loads
  // (rows g, columns t) hit distinct banks; of the b slices the same for
  // a slice's width
  static __host__ __device__ int cs(int N) { return round_up(N, 8) + VEC; }
  static __host__ __device__ int bs(int N) { return cs(slice_rows(N)); }
  // one stage buffer: a b slice (and v tile), or an S_in slice
  static __host__ __device__ size_t buf(int N) {
    const size_t kv = sizeof(T) * BK * (size_t)(bs(N) + VS);
    const size_t st = sizeof(float) * (size_t)slice_rows(round_up(N, 8)) * SS;
    return kv > st ? kv : st;
  }
  static size_t smem(int N) {
    return sizeof(float) * CMAX + sizeof(T) * (size_t)BQ * cs(N) +
           2 * buf(N);
  }
};

template <typename T, bool ASYNC>
__global__ void __launch_bounds__(NT, 2)
    out_kernel(const T* __restrict__ c, const T* __restrict__ b,
               const T* __restrict__ v, const float* __restrict__ log_a,
               const float* __restrict__ states, T* __restrict__ y,
               int T_len, int H, int N, int P, int C, int nc) {
  using L = OutLayout<T>;
  constexpr int VEC = L::VEC, VS = L::VS, SS = L::SS;
  constexpr int DJ = PT / 8;          // n8 tiles of y per warp
  constexpr int SJ = BK / 8;          // n8 tiles of the score per warp
  constexpr int SK8 = SL / 8;         // k8 steps per slice of N
  static_assert(SK8 % FOLD_K8 == 0, "slices must end on a fold");
  constexpr bool EXACT = sizeof(T) == 2;
  const int CS = L::cs(N), BS = L::bs(N), NP8 = round_up(N, 8);
  const int NK8 = NP8 / 8;
  const int NSL = (NP8 + SL - 1) / SL;            // slices of N
  const size_t BUF = L::buf(N);
  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);   // CMAX
  T* cs = reinterpret_cast<T*>(cum + CMAX);       // BQ x CS, c
  char* bufs = reinterpret_cast<char*>(cs + BQ * CS);   // 2 x BUF

  const int QT = (C + BQ - 1) / BQ;
  const int qt = QT - 1 - blockIdx.x / nc;        // heaviest q tiles first
  const int ci = blockIdx.x % nc;
  const int bh = blockIdx.y, p0 = blockIdx.z * PT;
  const int bb = bh / H, h = bh % H;
  const int t0 = ci * C, q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // rows r0 .. r0 + BK of the chunk from x (row length n, of which
  // n_valid from column col0 on) into a tile of stride `stride` (zero
  // past the chunk and T)
  auto load_rows = [&](T* dst, const T* x, int r0, int n, int stride,
                       int width, int col0) {
    for (int e = tid; e < BK * (width / VEC); e += NT) {
      const int r = e / (width / VEC), cc = e % (width / VEC) * VEC;
      const int i = r0 + r, tt = t0 + i;
      const bool ok = i < C && tt < T_len;
      load_row_chunk<ASYNC>(
          dst + r * stride,
          ok ? x + ((size_t)(bb * T_len + tt) * H + h) * n + col0 : x, cc,
          ok ? min(n - col0, width) : 0);
    }
  };
  const float* s_in = states + ((size_t)bh * nc + ci) * N * P;
  // stage st into buffer sb: for st < NSL slice st of S_in (f32, P % 4
  // == 0 where ASYNC); then kv tile (st - NSL) / NSL's b slice
  // (st - NSL) % NSL, the last slice with the tile's v
  auto load_stage = [&](int st, int sb) {
    char* base = bufs + sb * BUF;
    if (st < NSL) {
      float* Ss = reinterpret_cast<float*>(base);
      const int n0 = st * SL, rows = slice_rows(NP8 - n0);
      for (int e = tid; e < rows * (PT / 4); e += NT) {
        const int r = e / (PT / 4), cc = e % (PT / 4) * 4, n = n0 + r;
        load_row_chunk<ASYNC>(Ss + r * SS,
                              n < N ? s_in + (size_t)n * P + p0 : s_in, cc,
                              n < N ? min(P - p0, PT) : 0);
      }
    } else {
      const int kt = (st - NSL) / NSL, ns = (st - NSL) % NSL;
      T* bs_ = reinterpret_cast<T*>(base);
      load_rows(bs_, b, kt * BK, N, BS, slice_rows(NP8 - ns * SL), ns * SL);
      if (ns == NSL - 1) load_rows(bs_ + BK * BS, v, kt * BK, P, VS, PT, p0);
    }
  };

  // the first group in flight: this q tile's c rows and S_in's first slice
  load_rows(cs, c, q0, N, CS, NP8, 0);
  load_stage(0, 0);
  bident::cp_async_commit();
  if (warp == 0) chunk_cumsum(log_a, cum, bb, h, t0, T_len, H, C, lane);
  __syncthreads();

  // rows of this thread: g and g + 8 of the warp's 16
  const int r_lo = warp * 16 + g;
  const int i_row[2] = {q0 + r_lo, q0 + r_lo + 8};
  float cum_i[2], e_i[2];   // cum and exp(cum) of the rows (0 past C)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    cum_i[hr] = i_row[hr] < C ? cum[i_row[hr]] : 0.f;
    e_i[hr] = i_row[hr] < C ? expf(cum_i[hr]) : 0.f;
  }
  // A fragment of k8 step kk of the warp's 16 c rows: (g, t), (g + 8, t),
  // (g, t + 4), (g + 8, t + 4)
  const T* c_row = cs + r_lo * CS + t;
  auto c_frag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    const T* cr = c_row + kk * 8;
    operand<EXACT>(bident::to_f32(cr[0]), ah[0], al[0]);
    operand<EXACT>(bident::to_f32(cr[8 * CS]), ah[1], al[1]);
    operand<EXACT>(bident::to_f32(cr[4]), ah[2], al[2]);
    operand<EXACT>(bident::to_f32(cr[8 * CS + 4]), ah[3], al[3]);
  };

  float acc[DJ][4], part[DJ][4];
  zero(acc);
  zero(part);
  // s = c b^T for the warp's 16 rows x 64 kv columns, over the slices
  float s[SJ][4], sp[SJ][4];
  zero(s);
  zero(sp);

  const int nk = qt + 1;   // kv tiles up to the diagonal
  const int n_st = NSL * (1 + nk);
  for (int st = 0; st < n_st; ++st) {
    if (st + 1 < n_st) load_stage(st + 1, (st + 1) & 1);
    bident::cp_async_commit();
    bident::cp_async_wait<1>();   // stage st (and c) has landed
    __syncthreads();
    const char* base = bufs + (st & 1) * BUF;

    if (st < NSL) {
      // inter: y = exp(cum_i) (c S_in)_i over this slice's k8 steps, one
      // fresh sum per FOLD_K8 of them
      const float* Ss = reinterpret_cast<const float*>(base);
      const int k0 = st * SK8, k1 = min(k0 + SK8, NK8);
      for (int k8 = k0; k8 < k1; k8 += FOLD_K8) {
        for (int kk = k8; kk < min(k8 + FOLD_K8, k1); ++kk) {
          uint32_t ah[4], al[4];
          c_frag(kk, ah, al);
          const float* sr = Ss + ((kk - k0) * 8 + t) * SS + g;
#pragma unroll
          for (int dj = 0; dj < DJ; ++dj) {
            uint32_t bh[2], bl[2];
            bident::split_tf32(sr[dj * 8], bh[0], bl[0]);
            bident::split_tf32(sr[4 * SS + dj * 8], bh[1], bl[1]);
            mma3<EXACT, false>(part[dj], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int dj = 0; dj < DJ; ++dj)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            acc[dj][x] += e_i[x >> 1] * part[dj][x];
            part[dj][x] = 0.f;
          }
      }
    } else {
      // intra: y += ((c b^T) o L) v, kv tile kt, b slice ns
      const int kt = (st - NSL) / NSL, ns = (st - NSL) % NSL;
      const T* bs_ = reinterpret_cast<const T*>(base);
      const int k0 = ns * SK8, k1 = min(k0 + SK8, NK8);
      for (int k8 = k0; k8 < k1; k8 += FOLD_K8) {
        for (int kk = k8; kk < min(k8 + FOLD_K8, k1); ++kk) {
          uint32_t ah[4], al[4];
          c_frag(kk, ah, al);
#pragma unroll
          for (int j = 0; j < SJ; ++j) {
            // B(k, n) = b[n][k]
            const T* br = bs_ + (j * 8 + g) * BS + (kk - k0) * 8 + t;
            uint32_t bh[2], bl[2];
            operand<EXACT>(bident::to_f32(br[0]), bh[0], bl[0]);
            operand<EXACT>(bident::to_f32(br[4]), bh[1], bl[1]);
            mma3<EXACT, EXACT>(sp[j], ah, al, bh, bl);
          }
        }
        fold(s, sp);
      }

      if (ns == NSL - 1) {
        const T* vs_ = bs_ + BK * BS;
        // G = s o L: element x of tile j is row g + 8 (x / 2), kv column
        // 8j + 2t + x % 2 of the chunk's tile kt; zero above the diagonal
#pragma unroll
        for (int j = 0; j < SJ; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int hr = x >> 1, jc = kt * BK + j * 8 + 2 * t + (x & 1);
            s[j][x] = (jc <= i_row[hr] && i_row[hr] < C)
                          ? s[j][x] * expf(cum_i[hr] - cum[jc])
                          : 0.f;
          }

        // y += G v, G from registers with each 8-column slice's kv order
        // permuted (A's k index t <-> kv 2t, t + 4 <-> kv 2t + 1); one
        // fresh sum per FOLD_K8 slices
#pragma unroll
        for (int j0 = 0; j0 < SJ; j0 += FOLD_K8) {
#pragma unroll
          for (int j = j0; j < j0 + FOLD_K8 && j < SJ; ++j) {
            uint32_t gh[4], gl[4];
            bident::split_tf32(s[j][0], gh[0], gl[0]);   // (g,     kv 2t)
            bident::split_tf32(s[j][2], gh[1], gl[1]);   // (g + 8, kv 2t)
            bident::split_tf32(s[j][1], gh[2], gl[2]);   // (g,     kv 2t + 1)
            bident::split_tf32(s[j][3], gh[3], gl[3]);   // (g + 8, kv 2t + 1)
            const T* vr = vs_ + (j * 8 + 2 * t) * VS + g;
#pragma unroll
            for (int dj = 0; dj < DJ; ++dj) {
              uint32_t bh[2], bl[2];
              operand<EXACT>(bident::to_f32(vr[dj * 8]), bh[0], bl[0]);
              operand<EXACT>(bident::to_f32(vr[VS + dj * 8]), bh[1], bl[1]);
              mma3<false, EXACT>(part[dj], gh, gl, bh, bl);
            }
          }
          fold(acc, part);
        }
        zero(s);   // the next kv tile's score starts afresh
      }
    }
    __syncthreads();   // buffer st & 1 is free for stage st + 2
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = i_row[hr], tt = t0 + i;
    if (i >= C || tt >= T_len) continue;
    T* out = y + ((size_t)(bb * T_len + tt) * H + h) * P;
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int p = p0 + dj * 8 + 2 * t + cc;
        if (p < P) out[p] = bident::from_f32<T>(acc[dj][2 * hr + cc]);
      }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, bool ASYNC>
cudaError_t launch(const void* c, const void* b, const void* v,
                   const float* log_a, const float* s0, void* y,
                   float* s_final, float* work, int B, int T_len, int H,
                   int N, int P, int C, cudaStream_t stream) {
  const int nc = (T_len + C - 1) / C, BH = B * H;
  const int pt = (P + PT - 1) / PT, nsl = (N + SL - 1) / SL;
  float* states = work;                          // BH x nc x N x P
  float* tot = work + (size_t)BH * nc * N * P;   // BH x nc
  const T* ct = static_cast<const T*>(c);
  const T* bt = static_cast<const T*>(b);
  const T* vt = static_cast<const T*>(v);

  cudaError_t err;
  const size_t smem1 = StateLayout<T>::smem(N);
  if (N <= 64) {
    err = bident::allow_smem(state_kernel<T, ASYNC, 1>, smem1);
    if (err != cudaSuccess) return err;
    state_kernel<T, ASYNC, 1><<<dim3(nc, BH, pt * nsl), NT, smem1, stream>>>(
        bt, vt, log_a, states, tot, T_len, H, N, P, C, nc);
  } else {
    err = bident::allow_smem(state_kernel<T, ASYNC, 2>, smem1);
    if (err != cudaSuccess) return err;
    state_kernel<T, ASYNC, 2><<<dim3(nc, BH, pt * nsl), NT, smem1, stream>>>(
        bt, vt, log_a, states, tot, T_len, H, N, P, C, nc);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long n_state = (long long)BH * N * P;
  pass_kernel<<<(unsigned)((n_state + 255) / 256), 256, 0, stream>>>(
      s0, states, tot, s_final, BH, N * P, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem3 = OutLayout<T>::smem(N);
  err = bident::allow_smem(out_kernel<T, ASYNC>, smem3);
  if (err != cudaSuccess) return err;
  const int QT = (C + BQ - 1) / BQ;
  out_kernel<T, ASYNC><<<dim3(QT * nc, BH, pt), NT, smem3, stream>>>(
      ct, bt, vt, log_a, states, static_cast<T*>(y), T_len, H, N, P, C,
      nc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_aligned(const void* c, const void* b, const void* v,
                           const float* log_a, const float* s0, void* y,
                           float* s_final, float* work, int B, int T_len,
                           int H, int N, int P, int C, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // cp.async needs every row of c, b and v to start on a 16-byte boundary
  return bident::aligned16(c) && bident::aligned16(b) &&
                 bident::aligned16(v) && N % VEC == 0 && P % VEC == 0
             ? launch<T, true>(c, b, v, log_a, s0, y, s_final, work, B,
                               T_len, H, N, P, C, stream)
             : launch<T, false>(c, b, v, log_a, s0, y, s_final, work, B,
                                T_len, H, N, P, C, stream);
}

}  // namespace

// C entry point (bound with ctypes).  c, b (B,T,H,N) and v (B,T,H,P) in
// float32 or (bf16 != 0) bfloat16; log_a (B,T,H) float32; s0 (B,H,N,P)
// float32 or NULL for a zero initial state; y (B,T,H,P) in v's dtype;
// s_final (B,H,N,P) float32; work, float32 scratch of B*H*nc*(N*P + 1)
// elements with nc = ceil(T / C).  All contiguous device buffers.  The
// chunk length C is at most 256 and N at most 496; P is tiled 64 columns
// a block (at most 65535 blocks of grid z in kernel 1: ceil(P / 64)
// times ceil(N / 128)).  Runs the three kernels on `stream`; returns the
// first cudaError_t (0 on success).
extern "C" int bident_ssd_scan(const void* c, const void* b, const void* v,
                               const void* log_a, const void* s0, void* y,
                               void* s_final, void* work, int B, int T_len,
                               int H, int N, int P, int C, int bf16,
                               void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || C <= 0 || C > CMAX || N <= 0 ||
      N > MAX_N || P <= 0 || B * H > 65535 ||
      (long long)((P + PT - 1) / PT) * ((N + SL - 1) / SL) > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* st = static_cast<const float*>(s0);
  float* sf = static_cast<float*>(s_final);
  float* wk = static_cast<float*>(work);
  return bf16 ? launch_aligned<__nv_bfloat16>(c, b, v, la, st, y, sf, wk, B,
                                              T_len, H, N, P, C, s)
              : launch_aligned<float>(c, b, v, la, st, y, sf, wk, B, T_len,
                                      H, N, P, C, s);
}
