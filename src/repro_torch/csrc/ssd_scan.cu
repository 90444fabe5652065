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
// the final state in f32.  Chunk <= 256, N <= 496, any P; no atomics and
// no split reductions, so two runs give the same bits.  Two designs, one
// for each dtype.
//
// ---- bf16: wgmma and TMA (state_wgmma_kernel, then chunk_out_kernel at
// N <= 64 or out_wgmma_kernel above) ----
//
// A product of two bf16 numbers is exact in f32, so c b^T runs as one
// bf16 `wgmma` pass with f32 sums.  The f32 operands are taken as bf16
// terms, t1 = bf16(x), t2 = bf16(x - t1), ..., each a pass of its own
// against the same bf16 tile: w o v (w = exp(tot - cum)) in the chunk
// states and S_in in the inter term as two terms, G = (c b^T) o L in G v
// as three (with two, y at xLSTM-125M's mLSTM shape lies 2 bf16 ulps from
// the f64 algebra; with three, 1, as the f32 kernel does: PERF.md).
//
// 1. state_wgmma_kernel: chunk states and the state pass in one kernel.
//    One block of one consumer warpgroup and a producer warp owns one (b,
//    h, 64 state rows, 64 state columns) and walks the chunks in order with
//    S in f32 registers (wgmma's accumulator layout).  A chunk's own state
//    is b^T (w o v) in a fresh accumulator: b straight from TMA as the
//    M-major A operand, w o v staged in shared memory by the consumers as
//    the N-major B operand, tile j's staging while tile j - 1's wgmmas run.
//    Then S goes out as the state entering the chunk (S_in) and is carried,
//    S = S exp(tot) + state, a product and then a sum, each rounded, as the
//    f32 state pass does it; the last S is the final state.
// 2. chunk_out_kernel (N <= 64, Zamba2-2.7B's state): one block owns one
//    (b, h, chunk, 64 columns of P): 288 threads, two consumer warpgroups
//    and a producer warp.  The chunk's c, b and v (96 KB at chunk 256)
//    come in once, a 4-D TMA box a 64-row tile with its own mbarrier, and
//    stay; S_in is read and staged as bf16 terms once.  The q tiles of 64
//    rows go to the warpgroups by their kv tiles, heaviest with lightest
//    (at chunk 256: 3 and 0 to one, 2 and 1 to the other).  A q tile is
//    causal linear attention with a decay mask: its inter term c S_in
//    into a second accumulator, then per kv tile of 32 rows the score S =
//    c b^T (wgmma, both K-major), G = S o exp(cum_i - cum_j) masked above
//    the diagonal and split into its terms in registers (the accumulator
//    layout is wgmma's A fragment layout), and G v as RS wgmmas with v
//    N-major (the transpose bit); the score of tile j is issued before G
//    v of tile j - 1, G's decay runs while that product does.  A block a
//    chunk reads each of the chunk's tiles once: a block a q tile (below)
//    read b, v and S_in again for every q tile, ~2x the bytes, from L2.
//    A persistent block loading the next chunk under this one's products
//    measured no faster (PERF.md).
// 3. out_wgmma_kernel (N > 64: a chunk's c alone is 192 KB at the
//    mLSTM's N = 384): one block owns one (b, h, chunk, 128-row q tile of
//    two warpgroups, 64 columns of P), c rows loaded once, b and v tiles
//    streamed through a ring of three stages (two where three do not fit;
//    one consumer warpgroup at N = 496); the inter term after the kv loop,
//    S_in's slices of 64 state rows staged one at a time.  It loops over
//    N's 64-column sub-tiles at run time (ptxas serialises its wgmmas).
//
// Tiles are stored in the swizzled layout both TMA and wgmma read
// (hopper.cuh), 64 columns with the 128-byte swizzle; a 4-D map over
// (D, H, T, B) reads rows past T as zeros.  Rows off a 16-byte boundary
// (v at the mLSTM's P = 385, or any unaligned operand) take the producer
// warp's plain loads into the same layout; N not a multiple of 64 is
// zero-padded.  A mbarrier wait still open after 10 s traps.
//
// Bound, under this contract: c, b, v in and y out in bf16, log_a and the
// final state in f32, each once; c b^T in one bf16 pass and G v, the inter
// term and the chunk states with their f32 operand in two terms, B H nc
// (2 K N + 4 K P + 8 C N P) operations over a chunk's K = C (C + 1) / 2
// causal pairs.  At Zamba2-2.7B's prefill (c/b/v (4, 1024, 80, 64), chunk
// 256) that is 174 MB, 52.0 us at 3.35 TB/s, against 26.9 GFLOP, 27.2 us
// at 989 TFLOP/s: bound by the bytes.  The kernels add the S_in round trip (21 MB) and G
// v's third term.
//
// ---- f32: 3xTF32 mma.sync (state_kernel, pass_kernel, out_kernel) ----
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
// `mma.sync` in the 3xTF32 split (common.cuh), which keeps f32 accuracy
// (the templates' branches for exact bf16 operands are not instantiated:
// bf16 takes the design above).  The accumulator truncates, so every
// chain is at most 32 deep in K: a fresh accumulator per 32-deep stage,
// added to the running sum in f32 (FOLD_K8 below).  Every sum runs in a
// fixed order and nothing uses atomics, so two runs give the same bits.
//
// Bound: the main path (B*H = 16 sequences of 1024 steps, N = P = 64,
// chunk 64) moves 17.1 MB (c, b, v and log_a in, y and the final state
// out): 5.1 us at 3.35 TB/s, against 0.40 GFLOP of chunked algebra over
// the causal pairs, 2.5 us as 3xTF32 at 495 TFLOP/s: bound by the bytes.
// The chunk states and passed states add ~17 MB of round trips of this
// design's own (mostly in L2).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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
// kernel 3 for bf16: chunk outputs on wgmma, operands by TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQW = 64;         // q rows a consumer warpgroup
constexpr int CW = 64;          // columns of a shared-memory sub-tile
constexpr int SW = 2 * CW;      // bytes of a sub-tile row = the swizzle
constexpr int KV = 32;          // kv rows a tile
constexpr int MAX_STAGES = 3;   // b / v tiles in flight, where they fit
constexpr int G_TERMS = 3;      // bf16 terms of G = (c b^T) o L
constexpr int ST_KV = 64;       // chunk rows a tile of the state kernel
constexpr int ST_STAGES = 2;    // its b / v tiles in flight
constexpr int W_TERMS = 2;      // bf16 terms of w o v in the chunk states
constexpr int S_TERMS = 2;      // bf16 terms of S_in
constexpr uint32_t SUB = 64 * SW;   // a 64 x 64 bf16 tile (8 KB)
constexpr size_t SMEM_MAX = 232448;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(KV % 16 == 0 && CMAX % KV == 0, "kv tiles of k16 steps");

// Shared memory of a block with `wgs` consumer warpgroups, N in `nsub`
// sub-tiles of 64 columns and a ring of `stages`, from a 1024-byte aligned
// base: c (wgs x 64 rows), the staged slice of S_in (S_TERMS tiles), the
// ring's b tiles, its v tiles, cum, and the mbarriers.
struct Smem {
  int wgs, nsub, stages;
  __host__ __device__ uint32_t c_sub() const { return wgs * BQW * SW; }
  __host__ __device__ uint32_t b_bytes() const { return KV * SW * nsub; }
  static constexpr uint32_t B_SUB = KV * SW, V_BYTES = KV * SW;
  __host__ __device__ uint32_t s_off() const { return c_sub() * nsub; }
  __host__ __device__ uint32_t b_off() const { return s_off() + S_TERMS * SUB; }
  __host__ __device__ uint32_t v_off() const {
    return b_off() + stages * b_bytes();
  }
  __host__ __device__ uint32_t cum_off() const {
    return v_off() + stages * V_BYTES;
  }
  __host__ __device__ uint32_t bar_off() const { return cum_off() + 4 * CMAX; }
  __host__ __device__ size_t bytes() const {
    return 1024 + bar_off() + 8 * (1 + 3 * stages);
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The thread-load path (operands TMA cannot read): rows t0 .. t0 + rows -
// 1 of head h of batch bb of x (B, T, H, W), columns col0 .. col0 + 64
// nsub - 1, into the swizzled sub-tiles at dst (sub_bytes apart), with
// zeros past T and past W; by the 32 lanes of one warp.
__device__ __forceinline__ void load_rows(uint8_t* dst, uint32_t sub_bytes,
                                          int nsub, const __nv_bfloat16* x,
                                          int bb, int T, int H, int h, int W,
                                          int col0, int t0, int rows,
                                          int lane) {
  const int CH = nsub * (CW / 8);   // 16-byte chunks a row
  for (int e = lane; e < rows * CH; e += 32) {
    const int r = e / CH, ch = e % CH, tt = t0 + r, col = col0 + ch * 8;
    alignas(16) __nv_bfloat16 el[8];
    const __nv_bfloat16* src = x + ((size_t)(bb * T + tt) * H + h) * W + col;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      el[i] = tt < T && col + i < W ? src[i] : __float2bfloat16(0.f);
    uint32_t off = r * SW + (ch % (CW / 8)) * 16;
    off ^= ((off >> 7) & (SW / 16 - 1)) << 4;
    *reinterpret_cast<uint4*>(dst + (ch / (CW / 8)) * sub_bytes + off) =
        *reinterpret_cast<const uint4*>(el);
  }
  hopper::fence_proxy_async();
  __syncwarp();
}

// the score c b^T of one kv tile over N (b's tile at shared address ba),
// issued and committed: 4 nsub wgmmas of k16 (NSUB > 0: nsub is NSUB)
template <int NSUB>
__device__ __forceinline__ void s_mma(float (&sc)[KV / 2], uint32_t ca,
                                      uint32_t ba, uint32_t c_sub, int nsub) {
  hopper::wgmma_fence();
#pragma unroll
  for (int st = 0; st < (NSUB > 0 ? NSUB : nsub); ++st)
#pragma unroll
    for (int kk = 0; kk < CW / 16; ++kk)
      hopper::Wgmma<KV>::ss(
          sc, hopper::make_desc(ca + st * c_sub + kk * 32, 16, 8 * SW, SW),
          hopper::make_desc(ba + st * Smem::B_SUB + kk * 32, 16, 8 * SW, SW),
          st > 0 || kk > 0);
  hopper::wgmma_commit();
}

// y += G v for one kv tile (v's tile at shared address vs): each of G's
// bf16 terms in turn, KV / 16 wgmmas of k16 each, with v N-major
__device__ __forceinline__ void gv_mma(float (&acc)[CW / 2],
                                       uint32_t (&gt)[G_TERMS][KV / 16][4],
                                       uint32_t vs) {
  hopper::reg_fence(acc);
  hopper::reg_fence(gt);
  hopper::wgmma_fence();
#pragma unroll
  for (int term = 0; term < G_TERMS; ++term)
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk)
      hopper::Wgmma<CW>::rs(acc, gt[term][kk],
                            hopper::make_desc(vs + kk * 16 * SW,
                                              Smem::V_BYTES, 8 * SW, SW));
  hopper::wgmma_commit();
}

// G = S o exp(cum_i - cum_j) for one kv tile (kv rows from kbase), in the
// accumulator layout: element 4 jn + e is row row0 + 8 (e / 2), kv column
// kbase + 8 jn + 2t + e % 2.  Where `mask` says the tile reaches above the
// diagonal or past the chunk's rows, G is 0 for j > i and for i >= Cv.
__device__ __forceinline__ void decay(float (&sc)[KV / 2], const float* cum,
                                      const float (&cum_i)[2], int row0,
                                      int Cv, int kbase, bool mask, int t) {
#pragma unroll
  for (int jn = 0; jn < KV / 8; ++jn) {
    const float2 cj =
        *reinterpret_cast<const float2*>(cum + kbase + 8 * jn + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1, row = row0 + 8 * hr;
      const int col = kbase + 8 * jn + 2 * t + (e & 1);
      float& x = sc[4 * jn + e];
      const float gx = x * ex2((cum_i[hr] - ((e & 1) ? cj.y : cj.x)) * LOG2E);
      x = !mask || (col <= row && row < Cv) ? gx : 0.f;
    }
  }
}

// G as G_TERMS bf16 terms, hi = bf16(g), lo = bf16(g - hi), ..., in
// wgmma's A layout: k-slice kk's register r holds elements 8 kk + 2r and
// 8 kk + 2r + 1 of sc
__device__ __forceinline__ void split_g(const float (&sc)[KV / 2],
                                        uint32_t (&gt)[G_TERMS][KV / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KV / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
#pragma unroll
      for (int term = 0; term < G_TERMS; ++term) {
        const __nv_bfloat162 x = __floats2bfloat162_rn(x0, x1);
        x0 -= __low2float(x);
        x1 -= __high2float(x);
        gt[term][kk][r] = *reinterpret_cast<const uint32_t*>(&x);
      }
    }
}

// lane 0 of each warp frees a stage (4 wgs arrivals: the consumer warps)
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// One block owns one (b, h, chunk, wgs x 64-row q tile, 64 columns of P);
// see the note at the head of the file.  The producer warp loads the
// block's c rows once and each kv tile's b and v into a ring.  Consumer
// warpgroup w, kv tile j in this order: the score c b_j^T issued;
// G_{j-1} v_{j-1} issued behind it; the score awaited; G_j = score o L
// (while G_{j-1} v_{j-1} runs); that product awaited and its stage freed;
// G_j split into its bf16 terms.  Tile 0 and the last tile's product are
// peeled off the loop, so that every wgmma in the loop is unconditional.
// Then the inter term, y += exp(cum_i) (c S_in)_i, with S_in's slices of
// 64 state rows staged in shared memory as S_TERMS bf16 terms by the
// consumers themselves (the first slice's loads in flight since the
// block began).
template <bool TMA_CB, bool TMA_V>
__global__ void __launch_bounds__(2 * 128 + 32, 1)
    out_wgmma_kernel(const __grid_constant__ CUtensorMap cmap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __nv_bfloat16* __restrict__ c,
                     const __nv_bfloat16* __restrict__ b,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ log_a,
                     const float* __restrict__ states,
                     __nv_bfloat16* __restrict__ y, int T_len, int H, int N,
                     int P, int C, int nc, int stages) {
  const int wgs = (blockDim.x - 32) / 128;
  const Smem L{wgs, (N + CW - 1) / CW, stages};
  const int nsub = L.nsub, BQB = wgs * BQW;
  const int QT = (C + BQB - 1) / BQB, PTL = (P + CW - 1) / CW;
  // the block: the P tile fastest, then the q tiles of a chunk, heaviest
  // first (a chunk's blocks run together and share its b and v in L2)
  int idx = blockIdx.x;
  const int pt = idx % PTL;
  idx /= PTL;
  const int qt = QT - 1 - idx % QT;
  idx /= QT;
  const int ci = idx % nc, bh = idx / nc;
  const int bb = bh / H, h = bh % H;
  const int t0 = ci * C, q0 = qt * BQB, p0 = pt * CW;
  const int Cv = min(C, T_len - t0);   // the chunk's rows within T
  if (q0 >= Cv) return;                // the whole q tile is padding
  // kv tiles up to the block's last row
  const int nk = (min(Cv, q0 + BQB) + KV - 1) / KV;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* Cs = base;
  uint8_t* Ss = base + L.s_off();
  uint8_t* Bs = base + L.b_off();
  uint8_t* Vs = base + L.v_off();
  float* cum = reinterpret_cast<float*>(base + L.cum_off());
  uint64_t* c_full = reinterpret_cast<uint64_t*>(base + L.bar_off());
  uint64_t* b_full = c_full + 1;
  uint64_t* v_full = b_full + stages;
  uint64_t* empty = v_full + stages;

  const int tid = threadIdx.x;
  // warpgroups 0 .. wgs - 1 consume, the last warp (role wgs) produces;
  // read as warp-uniform so that the compiler sees each warpgroup's
  // wgmmas as converged
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    hopper::mbar_init(c_full, 1);
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&b_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 4 * wgs);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (role == wgs) {
    // ---- producer ----
    const int lane = tid - 128 * wgs;
    if constexpr (TMA_CB && TMA_V) {
      if (lane != 0) return;
    }
    if constexpr (TMA_CB) {
      if (lane == 0) {
        hopper::mbar_expect_tx(c_full, L.c_sub() * nsub);
        for (int st = 0; st < nsub; ++st)
          hopper::tma_load_4d(Cs + st * L.c_sub(), &cmap, c_full, st * CW, h,
                              t0 + q0, bb);
      }
    } else {
      load_rows(Cs, L.c_sub(), nsub, c, bb, T_len, H, h, N, 0, t0 + q0, BQB,
                lane);
      if (lane == 0) hopper::mbar_arrive(c_full);
    }
    for (int j = 0; j < nk; ++j) {
      const int s = j % stages, r0 = t0 + j * KV;
      if (j >= stages) hopper::mbar_wait(&empty[s], ((j / stages) & 1) ^ 1);
      uint8_t* bd = Bs + s * L.b_bytes();
      uint8_t* vd = Vs + s * Smem::V_BYTES;
      if constexpr (TMA_CB) {
        if (lane == 0) {
          hopper::mbar_expect_tx(&b_full[s], L.b_bytes());
          for (int st = 0; st < nsub; ++st)
            hopper::tma_load_4d(bd + st * Smem::B_SUB, &bmap, &b_full[s],
                                st * CW, h, r0, bb);
        }
      } else {
        load_rows(bd, Smem::B_SUB, nsub, b, bb, T_len, H, h, N, 0, r0, KV,
                  lane);
        if (lane == 0) hopper::mbar_arrive(&b_full[s]);
      }
      if constexpr (TMA_V) {
        if (lane == 0) {
          hopper::mbar_expect_tx(&v_full[s], Smem::V_BYTES);
          hopper::tma_load_4d(vd, &vmap, &v_full[s], p0, h, r0, bb);
        }
      } else {
        load_rows(vd, Smem::V_BYTES, 1, v, bb, T_len, H, h, P, p0, r0, KV,
                  lane);
        if (lane == 0) hopper::mbar_arrive(&v_full[s]);
      }
    }
  } else {
    // ---- consumers ----
    const int w = role, nthr = 128 * wgs;
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_w = q0 + w * BQW;                // the warpgroup's first row
    const int rows_end = min(Cv, row_w + BQW);
    const int nk_w = rows_end > row_w ? (rows_end + KV - 1) / KV : 1;
    const int row0 = row_w + warp * 16 + g;        // and row0 + 8
    const uint32_t c_addr = hopper::smem_u32(Cs) + w * BQW * SW;
    const uint32_t s_addr = hopper::smem_u32(Ss);
    const uint32_t b_addr = hopper::smem_u32(Bs);
    const uint32_t v_addr = hopper::smem_u32(Vs);

    // S_in's slices of 64 state rows (64 x 64 f32 from the state kernel)
    // are read by the consumers, 16-byte chunks of a bf16 row each, into
    // registers: the first slice's loads are issued now and stay in flight
    // through the kv loop; the inter term runs after it.
    const float* s_in = states + ((size_t)bh * nc + ci) * N * P;
    constexpr int MAX_CHUNKS = 64 * (CW / 8) / 128;   // a thread's, at wgs 1
    const int n_chunks = 64 * (CW / 8) / nthr;
    float pre[MAX_CHUNKS][8];
    auto fetch = [&](int sl) {
#pragma unroll
      for (int k = 0; k < MAX_CHUNKS; ++k) {
        if (k >= n_chunks) break;
        const int e = k * nthr + tid, r = e / (CW / 8), ch = e % (CW / 8);
        const int n = sl * 64 + r, p = p0 + ch * 8;
        const float* src = s_in + (size_t)n * P + p;
        if (P % 4 == 0 && n < N && p + 8 <= P) {   // two aligned float4
          const float4 x0 = *reinterpret_cast<const float4*>(src);
          const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
          pre[k][0] = x0.x, pre[k][1] = x0.y, pre[k][2] = x0.z;
          pre[k][3] = x0.w, pre[k][4] = x1.x, pre[k][5] = x1.y;
          pre[k][6] = x1.z, pre[k][7] = x1.w;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            pre[k][i] = n < N && p + i < P ? src[i] : 0.f;
        }
      }
    };
    fetch(0);
    // the chunk's prefix sum, by the first consumer warp; the other
    // consumers read it after the first named barrier below
    if (tid < 32) chunk_cumsum(log_a, cum, bb, h, t0, T_len, H, C, lane);

    float acc[CW / 2];
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) acc[i] = 0.f;
    // intra: acc = G v over the kv tiles up to the warpgroup's last row
    uint32_t gt[G_TERMS][KV / 16][4];   // G's terms, of the last tile
    // a tile needs the mask where it reaches above the warpgroup's first
    // row, or where the warpgroup has rows past the chunk's
    auto masked = [&](int j) {
      return (j + 1) * KV - 1 > row_w || row_w + BQW > Cv;
    };
    float cum_i[2], e_i[2];   // each row's cum and exp(cum) (0 past Cv)
    hopper::mbar_wait(c_full, 0);
    {   // kv tile 0: score, G, its terms
      hopper::mbar_wait(&b_full[0], 0);
      float sc[KV / 2];
      s_mma<0>(sc, c_addr, b_addr, L.c_sub(), nsub);
      hopper::named_bar_sync(1, nthr);   // cum is written
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 8 * hr;
        cum_i[hr] = row < Cv ? cum[row] : 0.f;
        e_i[hr] = row < Cv ? expf(cum_i[hr]) : 0.f;
      }
      hopper::wgmma_wait<0>();
      hopper::reg_fence(sc);
      decay(sc, cum, cum_i, row0, Cv, 0, masked(0), t);
      split_g(sc, gt);
    }
    for (int j = 1; j < nk_w; ++j) {
      const int s = j % stages, sp = (j - 1) % stages;
      hopper::mbar_wait(&b_full[s], (j / stages) & 1);
      float sc[KV / 2];
      s_mma<0>(sc, c_addr, b_addr + s * L.b_bytes(), L.c_sub(), nsub);
      // G v of tile j - 1, behind the score of tile j
      hopper::mbar_wait(&v_full[sp], ((j - 1) / stages) & 1);
      gv_mma(acc, gt, v_addr + sp * Smem::V_BYTES);
      hopper::wgmma_wait<1>();          // the score of tile j
      hopper::reg_fence(sc);
      decay(sc, cum, cum_i, row0, Cv, j * KV, masked(j), t);
      hopper::wgmma_wait<0>();          // G v of tile j - 1
      hopper::reg_fence(acc);
      release(&empty[sp], lane);
      split_g(sc, gt);
    }
    {   // the last tile's G v
      const int s = (nk_w - 1) % stages;
      hopper::mbar_wait(&v_full[s], ((nk_w - 1) / stages) & 1);
      gv_mma(acc, gt, v_addr + s * Smem::V_BYTES);
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
      release(&empty[s], lane);
    }
    // tiles past this warpgroup's rows: free their stages
    for (int j = nk_w; j < nk; ++j) {
      const int s = j % stages;
      hopper::mbar_wait(&b_full[s], (j / stages) & 1);
      hopper::mbar_wait(&v_full[s], (j / stages) & 1);
      release(&empty[s], lane);
    }


    // inter: acc += exp(cum_i) (c S_in)_i, a fresh accumulator over N's
    // slices, each slice of S_in split into S_TERMS bf16 terms and stored
    // in the N-major swizzled layout by the consumers
    float inter[CW / 2];
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) inter[i] = 0.f;
#pragma unroll
    for (int sl = 0; sl < nsub; ++sl) {
      if (sl > 0) {   // the previous slice's wgmmas are done with the tile
        hopper::wgmma_wait<0>();
        hopper::reg_fence(inter);
        fetch(sl);
      }
      hopper::named_bar_sync(1, nthr);
#pragma unroll
      for (int k = 0; k < MAX_CHUNKS; ++k) {
        if (k >= n_chunks) break;
        const int e = k * nthr + tid, r = e / (CW / 8), ch = e % (CW / 8);
        uint32_t off = r * SW + ch * 16;
        off ^= ((off >> 7) & (SW / 16 - 1)) << 4;
        float rest[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) rest[i] = pre[k][i];
#pragma unroll
        for (int term = 0; term < S_TERMS; ++term) {
          uint32_t packed[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 x =
                __floats2bfloat162_rn(rest[2 * i], rest[2 * i + 1]);
            rest[2 * i] -= __low2float(x);
            rest[2 * i + 1] -= __high2float(x);
            packed[i] = *reinterpret_cast<const uint32_t*>(&x);
          }
          *reinterpret_cast<uint4*>(Ss + term * SUB + off) =
              make_uint4(packed[0], packed[1], packed[2], packed[3]);
        }
      }
      hopper::fence_proxy_async();
      hopper::named_bar_sync(1, nthr);
      hopper::reg_fence(inter);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk)
#pragma unroll
        for (int term = 0; term < S_TERMS; ++term)
          hopper::Wgmma<CW>::ss_t(
              inter,
              hopper::make_desc(c_addr + sl * L.c_sub() + kk * 32, 16,
                                8 * SW, SW),
              hopper::make_desc(s_addr + term * SUB + kk * 16 * SW, SUB,
                                8 * SW, SW),
              1);
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::reg_fence(inter);
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) acc[i] += e_i[(i >> 1) & 1] * inter[i];

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= Cv) continue;
      __nv_bfloat16* out = y + ((size_t)(bb * T_len + t0 + row) * H + h) * P;
#pragma unroll
      for (int jn = 0; jn < CW / 8; ++jn) {
        const int p = p0 + 8 * jn + 2 * t;
        const float a0 = acc[4 * jn + 2 * hr], a1 = acc[4 * jn + 2 * hr + 1];
        if (P % 2 == 0) {   // pairs on a 4-byte boundary
          if (p < P)
            *reinterpret_cast<__nv_bfloat162*>(out + p) =
                __floats2bfloat162_rn(a0, a1);
        } else {
          if (p < P) out[p] = __float2bfloat16(a0);
          if (p + 1 < P) out[p + 1] = __float2bfloat16(a1);
        }
      }
    }
  }
}

// ---- N <= 64: one block a chunk (chunk_out_kernel) ----

constexpr int CQ = CMAX / 64;   // 64-row tiles of a chunk, at most
static_assert(64 % KV == 0, "kv tiles within the 64-row tiles");

// Shared memory of a chunk's block, from a 1024-byte aligned base: the
// chunk's c, b and v as 64-row tiles (CQ each), the staged S_in
// (S_TERMS tiles), cum, and one mbarrier a tile.
struct ChunkSmem {
  static constexpr uint32_t TILE = 64 * SW;
  static constexpr uint32_t B_OFF = CQ * TILE, V_OFF = 2 * CQ * TILE;
  static constexpr uint32_t S_OFF = 3 * CQ * TILE;
  static constexpr uint32_t CUM_OFF = S_OFF + S_TERMS * TILE;
  static constexpr uint32_t BAR_OFF = CUM_OFF + 4 * CMAX;
  static constexpr size_t BYTES = 1024 + BAR_OFF + 8 * 3 * CQ;
};

// One block owns one (b, h, chunk, 64 columns of P) at N <= 64: the
// chunk's c, b and v (96 KB at chunk 256) come in once, by TMA or the
// producer warp's plain loads, a barrier for each 64-row tile, and stay;
// S_in (64 x 64 f32) is read and staged as S_TERMS bf16 terms once.  The
// chunk's q tiles (64 rows) go to the two consumer warpgroups by their
// kv tiles, heaviest first: at chunk 256, tiles 3 and 0 (4 + 1 kv tiles)
// to one, 2 and 1 (3 + 2) to the other.  A q tile: the kv loop of the
// q-tile kernel (the score of tile j issued before G v of tile j - 1, G's
// decay while that product runs), its inter term c S_in issued first
// into a second accumulator (at kv tiles of 32 rows both accumulators,
// the score and G's terms fit the 168 registers a thread of a block of
// 288 may have), then y = G v + exp(cum_i) c S_in.
template <bool TMA_CB, bool TMA_V>
__global__ void __launch_bounds__(2 * 128 + 32, 1)
    chunk_out_kernel(const __grid_constant__ CUtensorMap cmap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __nv_bfloat16* __restrict__ c,
                     const __nv_bfloat16* __restrict__ b,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ log_a,
                     const float* __restrict__ states,
                     __nv_bfloat16* __restrict__ y, int T_len, int H, int N,
                     int P, int C, int nc) {
  using L = ChunkSmem;
  const int PTL = (P + CW - 1) / CW;
  int idx = blockIdx.x;
  const int pt = idx % PTL;
  idx /= PTL;
  const int ci = idx % nc, bh = idx / nc;
  const int bb = bh / H, h = bh % H;
  const int t0 = ci * C, p0 = pt * CW;
  const int Cv = min(C, T_len - t0);   // the chunk's rows within T
  const int QT = (Cv + 63) / 64;       // its 64-row tiles (q and kv)

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* Cs = base;
  uint8_t* Bs = base + L::B_OFF;
  uint8_t* Vs = base + L::V_OFF;
  uint8_t* Ss = base + L::S_OFF;
  float* cum = reinterpret_cast<float*>(base + L::CUM_OFF);
  uint64_t* c_full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* b_full = c_full + CQ;
  uint64_t* v_full = b_full + CQ;

  const int tid = threadIdx.x;
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int q = 0; q < CQ; ++q) {
      hopper::mbar_init(&c_full[q], 1);
      hopper::mbar_init(&b_full[q], 1);
      hopper::mbar_init(&v_full[q], 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // the q tiles of warpgroup w: the heaviest and the lightest to one, the
  // two middle ones to the other (fewer tiles: as many as there are)
  auto q_tile = [&](int w, int m) {
    return m == 0 ? QT - 1 - w
                  : (w == 0 ? (QT == 4 ? 0 : -1) : (QT >= 3 ? QT - 3 : -1));
  };

  if (role == 2) {
    // ---- producer: the two first q tiles' c, then kv tile by kv tile ----
    const int lane = tid - 256;
    if constexpr (TMA_CB && TMA_V) {
      if (lane != 0) return;
    }
    auto load_c = [&](int q) {
      if constexpr (TMA_CB) {
        if (lane == 0) {
          hopper::mbar_expect_tx(&c_full[q], L::TILE);
          hopper::tma_load_4d(Cs + q * L::TILE, &cmap, &c_full[q], 0, h,
                              t0 + 64 * q, bb);
        }
      } else {
        load_rows(Cs + q * L::TILE, L::TILE, 1, c, bb, T_len, H, h, N, 0,
                  t0 + 64 * q, 64, lane);
        if (lane == 0) hopper::mbar_arrive(&c_full[q]);
      }
    };
    // the warpgroups' first q tiles' c, then kv tile by kv tile, then the
    // second q tiles' c
    load_c(q_tile(0, 0));
    if (q_tile(1, 0) >= 0) load_c(q_tile(1, 0));
    for (int k = 0; k < QT; ++k) {
      if constexpr (TMA_CB) {
        if (lane == 0) {
          hopper::mbar_expect_tx(&b_full[k], L::TILE);
          hopper::tma_load_4d(Bs + k * L::TILE, &bmap, &b_full[k], 0, h,
                              t0 + 64 * k, bb);
        }
      } else {
        load_rows(Bs + k * L::TILE, L::TILE, 1, b, bb, T_len, H, h, N, 0,
                  t0 + 64 * k, 64, lane);
        if (lane == 0) hopper::mbar_arrive(&b_full[k]);
      }
      if constexpr (TMA_V) {
        if (lane == 0) {
          hopper::mbar_expect_tx(&v_full[k], L::TILE);
          hopper::tma_load_4d(Vs + k * L::TILE, &vmap, &v_full[k], p0, h,
                              t0 + 64 * k, bb);
        }
      } else {
        load_rows(Vs + k * L::TILE, L::TILE, 1, v, bb, T_len, H, h, P, p0,
                  t0 + 64 * k, 64, lane);
        if (lane == 0) hopper::mbar_arrive(&v_full[k]);
      }
    }
    for (int w = 1; w >= 0; --w)
      if (q_tile(w, 1) >= 0) load_c(q_tile(w, 1));
  } else {
    // ---- consumers ----
    const int w = role;
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // S_in (the chunk's 64 x 64 f32 state tile) into registers, 16-byte
    // chunks of a bf16 row each; the loads fly while warp 0 sums cum
    const float* s_in = states + ((size_t)bh * nc + ci) * N * P;
    float pre[2][8];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = k * 256 + tid, r = e / (CW / 8), ch = e % (CW / 8);
      const int p = p0 + ch * 8;
      const float* src = s_in + (size_t)r * P + p;
      if (P % 4 == 0 && r < N && p + 8 <= P) {   // two aligned float4
        const float4 x0 = *reinterpret_cast<const float4*>(src);
        const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
        pre[k][0] = x0.x, pre[k][1] = x0.y, pre[k][2] = x0.z;
        pre[k][3] = x0.w, pre[k][4] = x1.x, pre[k][5] = x1.y;
        pre[k][6] = x1.z, pre[k][7] = x1.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pre[k][i] = r < N && p + i < P ? src[i] : 0.f;
      }
    }
    if (tid < 32) chunk_cumsum(log_a, cum, bb, h, t0, T_len, H, C, lane);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = k * 256 + tid, r = e / (CW / 8), ch = e % (CW / 8);
      uint32_t off = r * SW + ch * 16;
      off ^= ((off >> 7) & (SW / 16 - 1)) << 4;
#pragma unroll
      for (int term = 0; term < S_TERMS; ++term) {
        uint32_t packed[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 x =
              __floats2bfloat162_rn(pre[k][2 * i], pre[k][2 * i + 1]);
          pre[k][2 * i] -= __low2float(x);
          pre[k][2 * i + 1] -= __high2float(x);
          packed[i] = *reinterpret_cast<const uint32_t*>(&x);
        }
        *reinterpret_cast<uint4*>(Ss + term * L::TILE + off) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
    hopper::fence_proxy_async();
    hopper::named_bar_sync(1, 256);   // S_in staged, cum written

    const uint32_t c_base = hopper::smem_u32(Cs);
    const uint32_t s_addr = hopper::smem_u32(Ss);
    const uint32_t b_addr = hopper::smem_u32(Bs);
    const uint32_t v_addr = hopper::smem_u32(Vs);
#pragma unroll 1
    for (int m = 0; m < 2; ++m) {
      const int qt = q_tile(w, m);
      if (qt < 0) continue;
      const int row_w = qt * 64, row0 = row_w + warp * 16 + g;
      const uint32_t c_addr = c_base + qt * L::TILE;
      float cum_i[2], e_i[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 8 * hr;
        cum_i[hr] = row < Cv ? cum[row] : 0.f;
        e_i[hr] = row < Cv ? expf(cum_i[hr]) : 0.f;
      }
      float acc[CW / 2], inter[CW / 2];
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) acc[i] = 0.f;
      hopper::mbar_wait(&c_full[qt], 0);
      // inter: c S_in into a second accumulator, issued first: it runs
      // under the kv loop
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk)
#pragma unroll
        for (int term = 0; term < S_TERMS; ++term)
          hopper::Wgmma<CW>::ss_t(
              inter,
              hopper::make_desc(c_addr + kk * 32, 16, 8 * SW, SW),
              hopper::make_desc(s_addr + term * L::TILE + kk * 16 * SW,
                                L::TILE, 8 * SW, SW),
              kk > 0 || term > 0);
      hopper::wgmma_commit();
      // intra: acc = G v over the kv tiles (KV rows, within the resident
      // 64-row tiles, whose barriers they wait on) up to the q tile's
      // last row; the mask where a tile reaches above the q tile's first
      // row, or the q tile has rows past the chunk's
      const bool rows_past = row_w + 64 > Cv;
      const int nk = (row_w + 64) / KV;
      uint32_t gt[G_TERMS][KV / 16][4];
      {   // kv tile 0
        hopper::mbar_wait(&b_full[0], 0);
        float sc[KV / 2];
        s_mma<1>(sc, c_addr, b_addr, 0, 1);
        hopper::wgmma_wait<0>();
        hopper::reg_fence(sc);
        hopper::reg_fence(inter);
        decay(sc, cum, cum_i, row0, Cv, 0, KV - 1 > row_w || rows_past, t);
        split_g(sc, gt);
      }
      for (int j = 1; j < nk; ++j) {
        hopper::mbar_wait(&b_full[j * KV / 64], 0);
        float sc[KV / 2];
        s_mma<1>(sc, c_addr, b_addr + j * KV * SW, 0, 1);
        hopper::mbar_wait(&v_full[(j - 1) * KV / 64], 0);
        gv_mma(acc, gt, v_addr + (j - 1) * KV * SW);
        hopper::wgmma_wait<1>();          // the score of tile j
        hopper::reg_fence(sc);
        decay(sc, cum, cum_i, row0, Cv, j * KV,
              (j + 1) * KV - 1 > row_w || rows_past, t);
        hopper::wgmma_wait<0>();          // G v of tile j - 1
        hopper::reg_fence(acc);
        split_g(sc, gt);
      }
      hopper::mbar_wait(&v_full[(nk - 1) * KV / 64], 0);
      gv_mma(acc, gt, v_addr + (nk - 1) * KV * SW);
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
#pragma unroll
      for (int i = 0; i < CW / 2; ++i)
        acc[i] += e_i[(i >> 1) & 1] * inter[i];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 8 * hr;
        if (row >= Cv) continue;
        __nv_bfloat16* out =
            y + ((size_t)(bb * T_len + t0 + row) * H + h) * P;
#pragma unroll
        for (int jn = 0; jn < CW / 8; ++jn) {
          const int p = p0 + 8 * jn + 2 * t;
          const float a0 = acc[4 * jn + 2 * hr],
                      a1 = acc[4 * jn + 2 * hr + 1];
          if (P % 2 == 0) {   // pairs on a 4-byte boundary
            if (p < P)
              *reinterpret_cast<__nv_bfloat162*>(out + p) =
                  __floats2bfloat162_rn(a0, a1);
          } else {
            if (p < P) out[p] = __float2bfloat16(a0);
            if (p + 1 < P) out[p + 1] = __float2bfloat16(a1);
          }
        }
      }
    }
  }
}

// Shared memory of the state kernel, from a 1024-byte aligned base: the
// ring's b tiles and v tiles (ST_KV rows of 64 columns each), two staging
// buffers of w o v (W_TERMS tiles each), cum, and the mbarriers.
struct StateSmem {
  static constexpr uint32_t TILE = ST_KV * SW;
  static constexpr uint32_t V_OFF = ST_STAGES * TILE;
  static constexpr uint32_t W_OFF = 2 * ST_STAGES * TILE;
  static constexpr uint32_t CUM_OFF = W_OFF + 2 * W_TERMS * TILE;
  static constexpr uint32_t BAR_OFF = CUM_OFF + 4 * CMAX;
  static constexpr size_t BYTES = 1024 + BAR_OFF + 8 * 2 * ST_STAGES;
};

// Chunk states and the state pass in one kernel (bf16 b, v).  One block
// owns one (b, h, 64 state rows, 64 state columns) and walks the chunks in
// order with the state S in f32 registers, in wgmma's accumulator layout:
// each chunk's own state b^T (w o v), w = exp(tot - cum), is a fresh
// accumulator over the chunk's kv tiles (b exact as the M-major A operand,
// straight from TMA; w o v as W_TERMS bf16 terms staged in shared memory
// by the consumers, the N-major B operand); then S goes out as the state
// entering the chunk (S_in, for the chunk outputs) and is carried, S = S
// exp(tot) + state, a product and then a sum, each rounded, as the state
// pass does it.  The producer warp keeps b and v tiles in flight across
// chunk boundaries; the staging of tile j runs while tile j - 1's wgmmas
// do.
template <bool TMA_B, bool TMA_V>
__global__ void __launch_bounds__(128 + 32, 3)
    state_wgmma_kernel(const __grid_constant__ CUtensorMap bmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __nv_bfloat16* __restrict__ b,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ log_a,
                       const float* __restrict__ s0,
                       float* __restrict__ states,
                       float* __restrict__ s_final, int T_len, int H, int N,
                       int P, int C, int nc) {
  using L = StateSmem;
  const int PTL = (P + CW - 1) / CW, NTL = (N + CW - 1) / CW;
  int idx = blockIdx.x;
  const int pt = idx % PTL;
  idx /= PTL;
  const int nt = idx % NTL, bh = idx / NTL;
  const int bb = bh / H, h = bh % H, n0 = nt * CW, p0 = pt * CW;
  const int kt = (C + ST_KV - 1) / ST_KV;   // kv tiles a chunk
  const int ntiles = nc * kt;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* Bs = base;
  uint8_t* Vs = base + L::V_OFF;
  uint8_t* Ws = base + L::W_OFF;
  float* cum = reinterpret_cast<float*>(base + L::CUM_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* empty = full + ST_STAGES;

  const int tid = threadIdx.x;
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int s = 0; s < ST_STAGES; ++s) {
      hopper::mbar_init(&full[s], 2);   // b's arrival and v's
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (role == 1) {
    // ---- producer: every chunk's b and v tiles, in order ----
    const int lane = tid - 128;
    if constexpr (TMA_B && TMA_V) {
      if (lane != 0) return;
    }
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % ST_STAGES;
      const int r0 = j / kt * C + j % kt * ST_KV;
      if (j >= ST_STAGES)
        hopper::mbar_wait(&empty[s], ((j / ST_STAGES) & 1) ^ 1);
      if constexpr (TMA_B) {
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[s], L::TILE);
          hopper::tma_load_4d(Bs + s * L::TILE, &bmap, &full[s], n0, h, r0,
                              bb);
        }
      } else {
        load_rows(Bs + s * L::TILE, L::TILE, 1, b, bb, T_len, H, h, N, n0,
                  r0, ST_KV, lane);
        if (lane == 0) hopper::mbar_arrive(&full[s]);
      }
      if constexpr (TMA_V) {
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[s], L::TILE);
          hopper::tma_load_4d(Vs + s * L::TILE, &vmap, &full[s], p0, h, r0,
                              bb);
        }
      } else {
        load_rows(Vs + s * L::TILE, L::TILE, 1, v, bb, T_len, H, h, P, p0,
                  r0, ST_KV, lane);
        if (lane == 0) hopper::mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: one warpgroup ----
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // element i of S and of a chunk's state: row n0 + 16 warp + g + 8 (i /
    // 2 % 2), column p0 + 8 (i / 4) + 2t + i % 2
    auto at = [&](int i, int& n, int& p) {
      n = n0 + 16 * warp + g + 8 * ((i >> 1) & 1);
      p = p0 + 8 * (i >> 2) + 2 * t + (i & 1);
    };
    float S[CW / 2], cs[CW / 2];
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) {
      int n, p;
      at(i, n, p);
      S[i] = s0 != nullptr && n < N && p < P
                 ? s0[((size_t)bh * N + n) * P + p] : 0.f;
    }
    const uint32_t b_addr = hopper::smem_u32(Bs);
    const uint32_t w_addr = hopper::smem_u32(Ws);
    for (int ci = 0; ci < nc; ++ci) {
      // the chunk's prefix sum, once every thread is done with the last's
      hopper::named_bar_sync(1, 128);
      if (warp == 0)
        chunk_cumsum(log_a, cum, bb, h, ci * C, T_len, H, C, lane);
      hopper::named_bar_sync(1, 128);
      const float tot = cum[C - 1];
      for (int jj = 0; jj < kt; ++jj) {
        const int j = ci * kt + jj, s = j % ST_STAGES;
        hopper::mbar_wait(&full[s], (j / ST_STAGES) & 1);
        // w o v as W_TERMS bf16 terms into staging buffer j % 2 (tile
        // j - 2's wgmmas, its last reader, are done), 16-byte chunks of
        // the swizzled rows; rows past the chunk get w = 0
        const uint8_t* vt = Vs + s * L::TILE;
        uint8_t* wt = Ws + (j & 1) * W_TERMS * L::TILE;
#pragma unroll
        for (int k = 0; k < ST_KV * (CW / 8) / 128; ++k) {
          const int e = k * 128 + tid, r = e / (CW / 8), ch = e % (CW / 8);
          uint32_t off = r * SW + ch * 16;
          off ^= ((off >> 7) & (SW / 16 - 1)) << 4;
          const int i = jj * ST_KV + r;
          const float w = i < C ? expf(tot - cum[i]) : 0.f;
          const uint4 raw4 = *reinterpret_cast<const uint4*>(vt + off);
          const __nv_bfloat162* x2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw4);
          float x[8];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            x[2 * q] = __low2float(x2[q]) * w;
            x[2 * q + 1] = __high2float(x2[q]) * w;
          }
#pragma unroll
          for (int term = 0; term < W_TERMS; ++term) {
            uint32_t packed[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const __nv_bfloat162 y2 =
                  __floats2bfloat162_rn(x[2 * q], x[2 * q + 1]);
              x[2 * q] -= __low2float(y2);
              x[2 * q + 1] -= __high2float(y2);
              packed[q] = *reinterpret_cast<const uint32_t*>(&y2);
            }
            *reinterpret_cast<uint4*>(wt + term * L::TILE + off) =
                make_uint4(packed[0], packed[1], packed[2], packed[3]);
          }
        }
        hopper::fence_proxy_async();
        hopper::named_bar_sync(1, 128);
        hopper::reg_fence(cs);
        hopper::wgmma_fence();
#pragma unroll
        for (int term = 0; term < W_TERMS; ++term)
#pragma unroll
          for (int kk = 0; kk < ST_KV / 16; ++kk)
            hopper::Wgmma<CW>::ss_tt(
                cs,
                hopper::make_desc(b_addr + s * L::TILE + kk * 16 * SW,
                                  L::TILE, 8 * SW, SW),
                hopper::make_desc(w_addr + ((j & 1) * W_TERMS + term) *
                                                L::TILE + kk * 16 * SW,
                                  L::TILE, 8 * SW, SW),
                jj > 0 || term > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();   // tile j - 1's wgmmas
        hopper::reg_fence(cs);
        if (j > 0) release(&empty[(j - 1) % ST_STAGES], lane);
      }
      hopper::wgmma_wait<0>();
      hopper::reg_fence(cs);
      // S_in of this chunk, then the carry
      float* out = states + (size_t)(bh * nc + ci) * N * P;
      const float d = expf(tot);
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) {
        int n, p;
        at(i, n, p);
        if (n < N && p < P) out[(size_t)n * P + p] = S[i];
        S[i] = __fadd_rn(__fmul_rn(S[i], d), cs[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) {
      int n, p;
      at(i, n, p);
      if (n < N && p < P) s_final[((size_t)bh * N + n) * P + p] = S[i];
    }
  }
}

// Chunk outputs at N <= 64, a block a chunk: c and b by TMA where their
// rows start on 16-byte boundaries, v too where its rows do.
cudaError_t launch_chunk(const void* c, const void* b, const void* v,
                         const float* log_a, const float* states, void* y,
                         int B, int T_len, int H, int N, int P, int C,
                         int nc, cudaStream_t stream) {
  const bool tma_cb =
      bident::aligned16(c) && bident::aligned16(b) && N % 8 == 0;
  const bool tma_v = tma_cb && bident::aligned16(v) && P % 8 == 0;
  CUtensorMap cm{}, bm{}, vm{};
  if (tma_cb && !(hopper::encode_bthd(&cm, c, B, T_len, H, N, CW, 64) &&
                  hopper::encode_bthd(&bm, b, B, T_len, H, N, CW, 64)))
    return cudaErrorInvalidValue;
  if (tma_v && !hopper::encode_bthd(&vm, v, B, T_len, H, P, CW, 64))
    return cudaErrorInvalidValue;
  const auto kernel = tma_v    ? chunk_out_kernel<true, true>
                      : tma_cb ? chunk_out_kernel<true, false>
                               : chunk_out_kernel<false, false>;
  cudaError_t err = bident::allow_smem(kernel, ChunkSmem::BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * nc * ((P + CW - 1) / CW);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 2 * 128 + 32, ChunkSmem::BYTES, stream>>>(
      cm, bm, vm, static_cast<const __nv_bfloat16*>(c),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(v), log_a, states,
      static_cast<__nv_bfloat16*>(y), T_len, H, N, P, C, nc);
  return cudaGetLastError();
}

// Chunk outputs of bf16 c, b, v from the state pass's S_in (`states`):
// the block's shape is the largest that fits shared memory (two consumer
// warpgroups, else one; a ring of three stages, else two).  c and b go by
// TMA where their rows start on 16-byte boundaries, v too where its rows
// do; the rest take the producer warp's plain loads.
cudaError_t launch_out(const void* c, const void* b, const void* v,
                       const float* log_a, const float* states, void* y,
                       int B, int T_len, int H, int N, int P, int C, int nc,
                       cudaStream_t stream) {
  const int nsub = (N + CW - 1) / CW;
  if (nsub == 1)
    return launch_chunk(c, b, v, log_a, states, y, B, T_len, H, N, P, C, nc,
                        stream);
  Smem L{0, nsub, 0};
  for (int wgs = 2; wgs >= 1 && L.wgs == 0; --wgs)
    for (int st = MAX_STAGES; st >= 2 && L.wgs == 0; --st)
      if (Smem{wgs, nsub, st}.bytes() <= SMEM_MAX) L = Smem{wgs, nsub, st};
  if (L.wgs == 0) return cudaErrorInvalidValue;
  const bool tma_cb =
      bident::aligned16(c) && bident::aligned16(b) && N % 8 == 0;
  const bool tma_v = tma_cb && bident::aligned16(v) && P % 8 == 0;
  CUtensorMap cm{}, bm{}, vm{};
  if (tma_cb &&
      !(hopper::encode_bthd(&cm, c, B, T_len, H, N, CW, L.wgs * BQW) &&
        hopper::encode_bthd(&bm, b, B, T_len, H, N, CW, KV)))
    return cudaErrorInvalidValue;
  if (tma_v && !hopper::encode_bthd(&vm, v, B, T_len, H, P, CW, KV))
    return cudaErrorInvalidValue;
  const auto kernel = tma_v    ? out_wgmma_kernel<true, true>
                      : tma_cb ? out_wgmma_kernel<true, false>
                               : out_wgmma_kernel<false, false>;
  cudaError_t err = bident::allow_smem(kernel, L.bytes());
  if (err != cudaSuccess) return err;
  const int BQB = L.wgs * BQW;
  const long long blocks = (long long)B * H * nc * ((C + BQB - 1) / BQB) *
                           ((P + CW - 1) / CW);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, L.wgs * 128 + 32, L.bytes(), stream>>>(
      cm, bm, vm, static_cast<const __nv_bfloat16*>(c),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(v), log_a, states,
      static_cast<__nv_bfloat16*>(y), T_len, H, N, P, C, nc, L.stages);
  return cudaGetLastError();
}

// The bf16 scan: the state kernel (S_in of every chunk into `work`, the
// final state), then the chunk outputs.  b and v go by TMA where their
// rows start on 16-byte boundaries, else by the producer's plain loads.
cudaError_t launch(const void* c, const void* b, const void* v,
                   const float* log_a, const float* s0, void* y,
                   float* s_final, float* work, int B, int T_len, int H,
                   int N, int P, int C, cudaStream_t stream) {
  const int nc = (T_len + C - 1) / C;
  const bool tma_b = bident::aligned16(b) && N % 8 == 0;
  const bool tma_v = bident::aligned16(v) && P % 8 == 0;
  CUtensorMap bm{}, vm{};
  if (tma_b && !hopper::encode_bthd(&bm, b, B, T_len, H, N, CW, ST_KV))
    return cudaErrorInvalidValue;
  if (tma_v && !hopper::encode_bthd(&vm, v, B, T_len, H, P, CW, ST_KV))
    return cudaErrorInvalidValue;
  const auto kernel = tma_b ? (tma_v ? state_wgmma_kernel<true, true>
                                     : state_wgmma_kernel<true, false>)
                            : (tma_v ? state_wgmma_kernel<false, true>
                                     : state_wgmma_kernel<false, false>);
  cudaError_t err = bident::allow_smem(kernel, StateSmem::BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + CW - 1) / CW) *
                           ((P + CW - 1) / CW);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 128 + 32, StateSmem::BYTES, stream>>>(
      bm, vm, static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(v), log_a, s0, work, s_final, T_len,
      H, N, P, C, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_out(c, b, v, log_a, work, y, B, T_len, H, N, P, C, nc,
                    stream);
}

}  // namespace wg

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
  return bf16 ? wg::launch(c, b, v, la, st, y, sf, wk, B, T_len, H, N, P, C,
                           s)
              : launch_aligned<float>(c, b, v, la, st, y, sf, wk, B, T_len,
                                      H, N, P, C, s);
}
