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
// no split reductions, so two runs give the same bits.  Three designs,
// chosen before the launch by an explicit rule of the C entry (never on
// error): bf16 on wgmma fed by TMA; f32 with c and b readable by TMA, at
// N = 64 with v readable too or at N 128-448 with any v (tf::tma_route),
// on 3xTF32 wgmma fed by TMA; every other f32 call on the three 3xTF32
// mma.sync kernels.
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
// ---- f32 at N = 64: 3xTF32 wgmma fed by TMA (tf::state_tf32_kernel,
// then tf::out_tf32_kernel) ----
//
// The rule: N = 64, P a multiple of 4 and at least 32 (rows on 16 bytes,
// one 32-column box), c, b, v on 16-byte boundaries: the main path
// (B H = 16, T 1024, N = P = 64, chunk 64) and Zamba2-2.7B (chunk 128,
// 256).  f32-accurate products take three TF32 ones, per k8 step lo.hi,
// hi.lo, hi.hi (common.cuh).  The choices, each emulated on the CPU first
// (tests/test_torch_tf32x3.py):
//
// (1) Two kernels.  The state kernel walks the chunks as the bf16 one
// does: a block owns one (b, h, 64 columns of P, NS state rows), keeps
// S^T (64 x NS) in f32 registers, sums each chunk's own state in a fresh
// accumulator, writes S_in^T, then carries S = S exp(tot) + state, a
// product and then a sum, each rounded.  The ring keeps b and v tiles in
// flight across chunk boundaries, and a warp of its own computes each
// chunk's cum and w = exp(tot - cum) up to SLOTS chunks ahead of the
// walk.  the mma.sync design's pass kernel and its chunk-state round trip go away.
// (2) TF32 wgmma takes no transpose: its shared-memory operands are
// K-major.  The chunk state is accumulated transposed, S^T = v^T (w o b)
// over the chunk's rows: v^T is the register A operand, its fragments read
// straight from the landed v tile, and (w o b)^T is written K-major by a
// staging warpgroup.  S_in^T then lands in `work` K-major, (B, H, nc, P,
// N), and the outputs kernel loads it by TMA as the B operand of c S_in.
// The score c b^T takes c's fragments from registers (read once from its
// TMA tile) and b from its TMA tile (K-major over N); v is N-major for G
// v, so the consumers write v^T K-major.  Every A operand comes from
// registers: a TF32 wgmma that reads A and B from shared memory (each
// three times, for the hi and lo products) took the SM's shared-memory
// bandwidth, and TMA's writes of the next tile landed only as the
// products ended (a device timeline, PERF.md).
// (3) G stays in registers as the A operand: the score's accumulator
// gives thread (g, t) kv columns 2t and 2t + 1 of each 8-column slice,
// so v^T holds each 8 kv positions in the order 0, 2, 4, 6, 1, 3, 5, 7
// and G's hi and lo are its registers as they lie; masked above the
// diagonal and past the chunk's rows.
// (4) Every operand is taken as its TF32 hi term rounded to nearest
// beside lo = x - hi, as the mma.sync kernels split theirs: in registers (v^T,
// c, G), rounded in place with a lo tile beside it (b, S_in^T), or
// written so (w o b, v^T in G v).  A raw tile read as its own hi term (the
// tensor cores truncate it) would leave lo terms whose truncation always
// pulls toward zero: 2-3x the mma.sync kernels' shrink at T 1024 on the CPU.  The fresh
// accumulators are the mma.sync kernels': 32 rows of a chunk state (ST_FOLD), 32 of N
// in c b^T and c S_in (N_FOLD, two accumulators added), a kv tile of 32
// rows in G v (KVT); one chain over N doubles the shrink.  So the
// emulated arithmetic is the mma.sync kernels', and the decay stays expf in difference
// form, as there.
// (5) Parallelism.  The state kernel has B H (P / 64) (64 / NS) walkers:
// NS = 32 where 64-row tiles would leave half the SMs without one (the
// main path: 32 walkers of 32 tiles), else 64 (Zamba2-2.7B: 320).  The
// outputs kernel is one consumer warpgroup and a producer warp a block
// per (b, h, chunk, 64-row q tile, 64 columns of P), heaviest q tiles
// first: 256 blocks at the main path, 5120 at Zamba2; at chunk 256 each
// q tile's block reads the chunk's b and v up to its diagonal again, from
// L2.  Tile j + 1's split (b rounded in place, v^T) runs while the score
// of tile j does, and the score of tile j + 1 behind G v of tile j.
// (6) Budgets.  State kernel (320 threads, at most 168 registers a
// thread): the MMA warpgroup holds S^T, the chunk's state and the fresh
// accumulator (3 x NS / 2 registers) and two tiles' v^T fragments (64);
// shared memory 6 ring stages of b and v (6 x 12 KB at NS 32), 3 staged
// (w o b)^T tiles (3 x 8 KB) and the w slots (4 KB): 100 KB (149 KB at NS
// 64, which spills 132 bytes).  Outputs kernel (160 threads, 204
// registers): c's fragments (64), acc, G v's fresh accumulator, the
// score's two halves and G's two terms (128); c's tile (then S_in^T's lo
// tile) and S_in^T (32 KB), 3 ring stages of b and v (48 KB), two split
// buffers of b lo, v^T hi and lo (48 KB) and cum: 129 KB, one block an SM
// (two, with one split buffer, measured no faster).  N = 384 (the mLSTM)
// does not fit this outputs kernel: c's fragments alone would take 384
// registers a thread, and a q tile's S_in^T with its lo tile 2 x 64 x
// 384 x 4 = 192 KB; above N = 64 the outputs kernel is the wide one
// (below).
// (7) No atomics, and no order that varies: bitwise repeatable.
//
// Bound: as below for the mma.sync design (5.1 us at the main path, by
// the bytes); this design adds the S_in^T round trip through `work` (4 MB
// at the main path, 21 MB at Zamba2-2.7B's prefill, mostly in L2).  What
// holds it (PERF.md): with no products the loads and splits keep 3/4 of
// the time at the main path; there the state kernel with neither its
// staging nor its products (kernel_variants.py's walk_loads) still takes
// most of the scan: each of the 32 walks paces its tiles' loads.
//
// ---- f32 at N 128-448: 3xTF32 wgmma fed by TMA (tf::pad_v_kernel where
// v needs it, tf::state_tf32_kernel, then tf::out_wide_tf32_kernel) ----
//
// The rule: N a multiple of 64 from 128 to 448 (xLSTM-125M's mLSTM: N
// 384, P 385, chunk 256), c and b on 16-byte boundaries, v at any P and
// alignment.  The numerics are the N = 64 design's (every operand's hi
// term rounded to TF32 beside its lo term; fresh accumulators every 32
// of N in c b^T and c S_in, every KVT chunk rows in G v and the chunk
// states), so tests/test_torch_tf32x3.py emulates it at the mLSTM's
// widths too.
//
// (1) v.  TMA reads rows on 16 bytes only; the mLSTM's v rows are 1540
// bytes.  Where TMA cannot read v (tf::pad_v), the C entry first copies
// it into `work`, past the chunk states, as rows of padded_p(P) floats
// (pad_v_kernel, one pass over v); both kernels then read that copy by
// TMA.  The producers' own 4-byte cp.async copies of v measured slower in
// development builds (the state kernel's walk paces its tiles' loads).
// (2) Chunk states: state_tf32_kernel over N, a block a (b, h, 64
// columns of P, NS state rows): B H (N / NS) (P / 64) walkers, 672 at the
// mLSTM (NS 64).
// (3) Chunk outputs: out_wide_tf32_kernel, a block a (b, h, chunk, 64-row
// q tile, 64 columns of P), 256 threads.  c's 64 rows stay in shared
// memory (96 KB at N 384); the block's other operands stream through a
// ring as items of two 64-row sub-tiles: S_in^T by 64 of N, then per pair
// of kv tiles b by 64 of N and the v tile.  Warpgroup 1 splits each item
// into TF32 hi and lo tiles (v as v^T, the kv order permuted) and issues
// the loads; warpgroup 0 runs an item as two interleaved chains of
// m64n64k8 wgmmas, c's A fragments read from its tile and split in
// registers a step at a time (G's, once a pair's score is in).  A chain of
// the three products on 32 of K waits on each product before it, so two
// chains a step; a warpgroup that issues wgmmas stalls until the tensor
// cores take them, so the splits have a warpgroup of their own (three
// warps of it; the fourth issues the loads); eight warps keep 255
// registers a thread.
// (4) Budgets (N 448): c 112 KB, WIDE_STAGES ring stages of 16 KB, two
// split buffers of 32 KB, cum: 210 KB, one block an SM.
// (5) What holds it: shared memory.  An item moves ~128 KB through it
// (TMA's 16 KB, the split's 16 KB read and 32 KB written, the products'
// 48 KB of B tiles, c's 16 KB of fragments), ~1000 clocks at 128 bytes a
// clock, against ~770 clocks of 3xTF32 tensor work (PERF.md has the
// times).  Each of the 7 column tiles of P (the mLSTM's P = 385) loads
// and splits the same b and reads the same c again, for its own score.
//
// ---- f32 elsewhere: 3xTF32 mma.sync (state_kernel, pass_kernel,
// out_kernel) ----
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
// `mma.sync` in the 3xTF32 split (common.cuh), which keeps f32 accuracy.
// The accumulator truncates, so every
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

// c += a.b in 3xTF32: a_lo.b_hi, a_hi.b_lo, a_hi.b_hi (common.cuh)
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  bident::mma_tf32(c, al, bh);
  bident::mma_tf32(c, ah, bl);
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

// Elements cc .. cc + 3 of a tile row in shared memory from device row
// `src`, of which the first `n_valid` elements exist (0 for a row past
// the chunk or the sequence; `src` then only needs to be a valid
// pointer); the rest are set to zero.
template <bool ASYNC>
__device__ __forceinline__ void load_row_chunk(float* dst, const float* src,
                                               int cc, int n_valid) {
  constexpr int VEC = 4;
  const int nv = min(max(n_valid - cc, 0), VEC);
  bident::load_chunk<ASYNC>(dst + cc, nv > 0 ? src + cc : src, nv);
}

// ---------------------------------------------------------------------------
// kernel 1: chunk states
// ---------------------------------------------------------------------------

struct StateLayout {
  static constexpr int VEC = 4;
  static constexpr int VS = PT + 8;   // row stride of the v stages
  // row stride of the b stages: a slice's NP16 + 8, so the column reads
  // of a warp (rows t, columns g) hit distinct banks
  static __host__ __device__ int bs(int N) {
    return round_up(slice_rows(N), 16) + 8;
  }
  static size_t smem(int N) {
    return 2 * CMAX * sizeof(float) +
           2 * KS * (size_t)(bs(N) + VS) * sizeof(float);
  }
};

// MT: m16 tiles of the slice's rows per warp (1 for N <= 64, else 2)
template <bool ASYNC, int MT>
__global__ void __launch_bounds__(NT)
    state_kernel(const float* __restrict__ b, const float* __restrict__ v,
                 const float* __restrict__ log_a, float* __restrict__ states,
                 float* __restrict__ tot, int T_len, int H, int N, int P,
                 int C, int nc) {
  using L = StateLayout;
  constexpr int VEC = L::VEC, VS = L::VS;
  // blockIdx.z: the 64-column tile of P, then the 128-row slice of N
  const int pt = (P + PT - 1) / PT;
  const int p0 = blockIdx.z % pt * PT, n0 = blockIdx.z / pt * SL;
  const int BS = L::bs(N), NP16 = round_up(slice_rows(N - n0), 16);
  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);   // CMAX
  float* w = cum + CMAX;                          // CMAX, exp(tot - cum)
  float* stage = w + CMAX;                        // 2 x (b KS x BS, v KS x VS)

  const int ci = blockIdx.x, bh = blockIdx.y;
  const int bb = bh / H, h = bh % H;
  const int t0 = ci * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_stages = (C + KS - 1) / KS;

  auto load_stage = [&](int s, int buf) {
    float* bs_ = stage + buf * KS * (BS + VS);
    float* vs_ = bs_ + KS * BS;
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
    const float* bs_ = stage + (s & 1) * KS * (BS + VS);
    const float* vs_ = bs_ + KS * BS;
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
        bident::split_tf32(bs_[k0 * BS + m0 + g] * ws[k0], ah[0], al[0]);
        bident::split_tf32(bs_[k0 * BS + m0 + g + 8] * ws[k0], ah[1], al[1]);
        bident::split_tf32(bs_[(k0 + 4) * BS + m0 + g] * ws[k0 + 4], ah[2],
                           al[2]);
        bident::split_tf32(bs_[(k0 + 4) * BS + m0 + g + 8] * ws[k0 + 4],
                           ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < PT / 8; ++j) {
          uint32_t bh[2], bl[2];
          bident::split_tf32(vs_[k0 * VS + j * 8 + g], bh[0], bl[0]);
          bident::split_tf32(vs_[(k0 + 4) * VS + j * 8 + g], bh[1], bl[1]);
          mma3(part[mi % PARTS][j], ah, al, bh, bl);
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

struct OutLayout {
  static constexpr int VEC = 4;
  static constexpr int VS = PT + VEC;   // row stride of the v tiles
  static constexpr int SS = PT + 8;     // row stride of the S_in slices
  // row stride of the c rows: NP8 + VEC, so a warp's fragment loads
  // (rows g, columns t) hit distinct banks; of the b slices the same for
  // a slice's width
  static __host__ __device__ int cs(int N) { return round_up(N, 8) + VEC; }
  static __host__ __device__ int bs(int N) { return cs(slice_rows(N)); }
  // one stage buffer: a b slice (and v tile), or an S_in slice
  static __host__ __device__ size_t buf(int N) {
    const size_t kv = sizeof(float) * BK * (size_t)(bs(N) + VS);
    const size_t st = sizeof(float) * (size_t)slice_rows(round_up(N, 8)) * SS;
    return kv > st ? kv : st;
  }
  static size_t smem(int N) {
    return sizeof(float) * CMAX + sizeof(float) * (size_t)BQ * cs(N) +
           2 * buf(N);
  }
};

template <bool ASYNC>
__global__ void __launch_bounds__(NT, 2)
    out_kernel(const float* __restrict__ c, const float* __restrict__ b,
               const float* __restrict__ v, const float* __restrict__ log_a,
               const float* __restrict__ states, float* __restrict__ y,
               int T_len, int H, int N, int P, int C, int nc) {
  using L = OutLayout;
  constexpr int VEC = L::VEC, VS = L::VS, SS = L::SS;
  constexpr int DJ = PT / 8;          // n8 tiles of y per warp
  constexpr int SJ = BK / 8;          // n8 tiles of the score per warp
  constexpr int SK8 = SL / 8;         // k8 steps per slice of N
  static_assert(SK8 % FOLD_K8 == 0, "slices must end on a fold");
  const int CS = L::cs(N), BS = L::bs(N), NP8 = round_up(N, 8);
  const int NK8 = NP8 / 8;
  const int NSL = (NP8 + SL - 1) / SL;            // slices of N
  const size_t BUF = L::buf(N);
  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);   // CMAX
  float* cs = cum + CMAX;                         // BQ x CS, c
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
  auto load_rows = [&](float* dst, const float* x, int r0, int n,
                       int stride,
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
      float* bs_ = reinterpret_cast<float*>(base);
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
  const float* c_row = cs + r_lo * CS + t;
  auto c_frag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    const float* cr = c_row + kk * 8;
    bident::split_tf32(cr[0], ah[0], al[0]);
    bident::split_tf32(cr[8 * CS], ah[1], al[1]);
    bident::split_tf32(cr[4], ah[2], al[2]);
    bident::split_tf32(cr[8 * CS + 4], ah[3], al[3]);
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
            mma3(part[dj], ah, al, bh, bl);
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
      const float* bs_ = reinterpret_cast<const float*>(base);
      const int k0 = ns * SK8, k1 = min(k0 + SK8, NK8);
      for (int k8 = k0; k8 < k1; k8 += FOLD_K8) {
        for (int kk = k8; kk < min(k8 + FOLD_K8, k1); ++kk) {
          uint32_t ah[4], al[4];
          c_frag(kk, ah, al);
#pragma unroll
          for (int j = 0; j < SJ; ++j) {
            // B(k, n) = b[n][k]
            const float* br = bs_ + (j * 8 + g) * BS + (kk - k0) * 8 + t;
            uint32_t bh[2], bl[2];
            bident::split_tf32(br[0], bh[0], bl[0]);
            bident::split_tf32(br[4], bh[1], bl[1]);
            mma3(sp[j], ah, al, bh, bl);
          }
        }
        fold(s, sp);
      }

      if (ns == NSL - 1) {
        const float* vs_ = bs_ + BK * BS;
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
            const float* vr = vs_ + (j * 8 + 2 * t) * VS + g;
#pragma unroll
            for (int dj = 0; dj < DJ; ++dj) {
              uint32_t bh[2], bl[2];
              bident::split_tf32(vr[dj * 8], bh[0], bl[0]);
              bident::split_tf32(vr[VS + dj * 8], bh[1], bl[1]);
              mma3(part[dj], gh, gl, bh, bl);
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
    float* out = y + ((size_t)(bb * T_len + tt) * H + h) * P;
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int p = p0 + dj * 8 + 2 * t + cc;
        if (p < P) out[p] = acc[dj][2 * hr + cc];
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
// f32 at N = 64: 3xTF32 wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace tf {

constexpr int NW = 64;          // the route's narrow N: c and b rows of 64 floats
constexpr int WIDE_MIN = 128;   // the wide design's N: multiples of 64 from
constexpr int WIDE_MAX = 448;   // ... WIDE_MIN to WIDE_MAX (c's 64 rows in shared memory)
constexpr int PW = 64;          // columns of P a block
constexpr int KVT = 32;         // chunk rows a tile, in both kernels
constexpr int ST_FOLD = 32;     // chunk rows a fresh accumulator of a chunk state
constexpr int N_FOLD = 32;      // N a fresh accumulator of c b^T and c S_in
constexpr int ST_STAGES = 6;    // b / v tiles in flight, state kernel
constexpr int SBUF = 3;         // staged tiles in flight, state kernel
constexpr int OUT_STAGES = 3;   // b / v tiles in flight, outputs kernel
constexpr int NSPLIT = 2;       // its split kv tiles (1: two blocks an SM)
constexpr int SLOTS = 4;        // chunks whose w the state kernel's cum warp keeps
constexpr int WIDE_STAGES = 2;  // items in flight, wide outputs kernel
constexpr int WIDE_SPLITS = 2;  // its split items
constexpr int WIDE_SPLIT_WARPS = 3;  // its warps that split (of 4; warp 4 loads)
constexpr int WI = 64;          // N, kv rows or P of its items (two sub-tiles)
constexpr int SMS = 132;        // the card's SMs: the state tile's rule
constexpr uint32_t SUB = KVT * 128;   // a tile of KVT rows of 32 floats
constexpr uint32_t SUB64 = 64 * 128; // a tile of 64 rows of 32 floats
static_assert(KVT == 32 && ST_FOLD % KVT == 0 && N_FOLD % 8 == 0 &&
                  NW % N_FOLD == 0 && WIDE_MIN % WI == 0 &&
                  WI % N_FOLD == 0 && N_FOLD % 32 == 0 && WI == 2 * KVT,
              "tiles of one 128-byte swizzle row; folds on tile bounds");

using hopper::swz;

// x as its TF32 hi term (rounded, split_tf32: low 13 bits zero, so the
// tensor cores read it exactly) and lo = x - hi
__device__ __forceinline__ float hi_of(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// a landed tile's TF32 terms: hi into `hi` (which may be x: in place),
// lo into `lo` (the same layout), by `n` threads (thread i)
__device__ __forceinline__ void split_tile(const uint8_t* x, uint8_t* hi,
                                           uint8_t* lo, uint32_t bytes,
                                           int i, int n) {
  for (uint32_t e = i; e < bytes / 16; e += n) {
    const float4 v = reinterpret_cast<const float4*>(x)[e];
    const float4 h = make_float4(hi_of(v.x), hi_of(v.y), hi_of(v.z),
                                 hi_of(v.w));
    reinterpret_cast<float4*>(hi)[e] = h;
    reinterpret_cast<float4*>(lo)[e] =
        make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
  }
}

// 8 consecutive rows r0 .. r0 + 7 of column `col` of a tile of KVT rows
// (sub-tiles of 32 columns, `sub` bytes apart), each times w[r] (w null:
// 1), as a K-major row of the transposed tile: its hi and lo terms at
// (row, r0) of `hi` and `lo`; `perm`: in the order 0, 2, 4, 6, 1, 3, 5, 7
// (the G v fragment's kv order, see the note at the head of the file)
__device__ __forceinline__ void transpose8(const uint8_t* src, uint32_t sub,
                                           int col, int r0, const float* w,
                                           bool perm, uint8_t* hi,
                                           uint8_t* lo, int row) {
  const uint8_t* s = src + col / 32 * sub;
  float x[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    x[r] = *reinterpret_cast<const float*>(s + swz(r0 + r, col % 32));
    if (w != nullptr) x[r] *= w[r0 + r];
  }
  const float4 a = perm ? make_float4(x[0], x[2], x[4], x[6])
                        : make_float4(x[0], x[1], x[2], x[3]);
  const float4 b = perm ? make_float4(x[1], x[3], x[5], x[7])
                        : make_float4(x[4], x[5], x[6], x[7]);
  const float4 ah = make_float4(hi_of(a.x), hi_of(a.y), hi_of(a.z),
                                hi_of(a.w));
  const float4 bh = make_float4(hi_of(b.x), hi_of(b.y), hi_of(b.z),
                                hi_of(b.w));
  const uint32_t o0 = swz(row, r0), o4 = swz(row, r0 + 4);
  *reinterpret_cast<float4*>(hi + o0) = ah;
  *reinterpret_cast<float4*>(hi + o4) = bh;
  *reinterpret_cast<float4*>(lo + o0) =
      make_float4(a.x - ah.x, a.y - ah.y, a.z - ah.z, a.w - ah.w);
  *reinterpret_cast<float4*>(lo + o4) =
      make_float4(b.x - bh.x, b.y - bh.y, b.z - bh.z, b.w - bh.w);
}

// a K-major tile's descriptor at k8 step kk (32 floats a swizzled row)
__device__ __forceinline__ uint64_t kdesc(uint32_t addr, int kk) {
  return hopper::make_desc(addr + kk % 4 * 32, 16, 1024, 128);
}

// ---- the chunk states and the carry (state_tf32_kernel) ----

// Shared memory of the state kernel, from a 1024-byte aligned base: the
// ring's b tiles (KVT rows of NS columns) and v tiles (KVT rows of 64),
// SBUF staged (w o b)^T tiles (hi and lo, NS rows of KVT), the cum warp's
// SLOTS chunks of w and tot, and the mbarriers.
template <int NS>
struct StateSmem {
  static constexpr uint32_t B_BYTES = NS / 32 * SUB, V_BYTES = PW / 32 * SUB;
  static constexpr uint32_t STAGE = B_BYTES + V_BYTES;
  static constexpr uint32_t BH = 0, BL = NS * 128, BUF = 2 * NS * 128;
  static constexpr uint32_t BUF_OFF = ST_STAGES * STAGE;
  static constexpr uint32_t W_OFF = BUF_OFF + SBUF * BUF;
  static constexpr uint32_t W_SLOT = CMAX + 4;      // floats: w, then tot
  static constexpr uint32_t BAR_OFF = W_OFF + 4 * SLOTS * W_SLOT;
  static constexpr size_t BYTES =
      1024 + BAR_OFF + 8 * 2 * (ST_STAGES + SBUF + SLOTS);
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

// One block owns one (b, h, 64 columns of P, NS state rows) and walks the
// chunks in order with S^T (64 x NS) in f32 registers, wgmma's
// accumulator layout; 320 threads.  Warp 8 loads each tile's b and v into
// the ring by TMA; warp 9 computes each chunk's cum and w = exp(tot -
// cum) into a slot ahead of the others; warpgroup 1 stages each tile's
// (w o b)^T as TF32 hi and lo, K-major, up to SBUF tiles ahead;
// warpgroup 0 reads v^T's A fragments straight from the landed v tile
// (split into TF32 hi and lo in registers, the next tile's while this
// tile's wgmmas run) and runs per k8 step v^T_hi.(wb)_lo,
// v^T_lo.(wb)_hi, v^T_hi.(wb)_hi into a fresh accumulator every ST_FOLD
// rows, added to the chunk's state in f32.  After a chunk's last tile,
// S^T goes out as the state entering the chunk (S_in^T, K-major for the
// outputs kernel) and is carried, S = S exp(tot) + state, a product and
// then a sum, each rounded.
template <int NS>
__global__ void __launch_bounds__(320, 1)
    state_tf32_kernel(const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const float* __restrict__ log_a,
                      const float* __restrict__ s0, float* __restrict__ work,
                      float* __restrict__ s_final, int T_len, int H, int N,
                      int P, int C, int nc) {
  using L = StateSmem<NS>;
  const int PTL = (P + PW - 1) / PW;
  int idx = blockIdx.x;
  const int pt = idx % PTL;
  idx /= PTL;
  const int nt = idx % (N / NS), bh = idx / (N / NS);
  const int bb = bh / H, h = bh % H, p0 = pt * PW, n0 = nt * NS;
  const int kt = (C + KVT - 1) / KVT, ntiles = nc * kt;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* Buf = base + L::BUF_OFF;
  float* W = reinterpret_cast<float*>(base + L::W_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* empty = full + ST_STAGES;
  uint64_t* s_full = empty + ST_STAGES;
  uint64_t* s_empty = s_full + SBUF;
  uint64_t* w_full = s_empty + SBUF;
  uint64_t* w_empty = w_full + SLOTS;

  const int tid = threadIdx.x;
  const int wid = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < ST_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);    // the staging and MMA warps
    }
    for (int s = 0; s < SBUF; ++s) {
      hopper::mbar_init(&s_full[s], 4);   // the staging warps
      hopper::mbar_init(&s_empty[s], 4);  // the MMA warps
    }
    for (int s = 0; s < SLOTS; ++s) {
      hopper::mbar_init(&w_full[s], 32);  // the cum warp's lanes
      hopper::mbar_init(&w_empty[s], 8);  // the staging and MMA warps
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wid == 8) {
    // ---- producer: every chunk's b and v tiles, in order ----
    if (lane != 0) return;
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % ST_STAGES, r0 = j / kt * C + j % kt * KVT;
      if (j >= ST_STAGES)
        hopper::mbar_wait(&empty[s], ((j / ST_STAGES) & 1) ^ 1);
      uint8_t* st = base + s * L::STAGE;
      hopper::mbar_expect_tx(&full[s], L::STAGE);
      for (int k = 0; k < NS / 32; ++k)
        hopper::tma_load_4d(st + k * SUB, &bmap, &full[s], n0 + 32 * k, h,
                            r0, bb);
      for (int k = 0; k < PW / 32; ++k)
        hopper::tma_load_4d(st + L::B_BYTES + k * SUB, &vmap, &full[s],
                            p0 + 32 * k, h, r0, bb);
    }
    return;
  }
  if (wid == 9) {
    // ---- cum warp: each chunk's w = exp(tot - cum) (0 past C) and tot ----
    for (int ci = 0; ci < nc; ++ci) {
      const int slot = ci % SLOTS;
      if (ci >= SLOTS)
        hopper::mbar_wait(&w_empty[slot], ((ci / SLOTS) & 1) ^ 1);
      float* w = W + slot * L::W_SLOT;
      chunk_cumsum(log_a, w, bb, h, ci * C, T_len, H, C, lane);
      __syncwarp();
      const float tot = w[C - 1];
      __syncwarp();
      for (int i = lane; i < kt * KVT; i += 32)
        w[i] = i < C ? expf(tot - w[i]) : 0.f;
      if (lane == 0) w[CMAX] = tot;
      __syncwarp();
      hopper::mbar_arrive(&w_full[slot]);
    }
    return;
  }
  if (wid >= 4) {
    // ---- staging warpgroup: tile j's (w o b)^T into buffer j % SBUF ----
    const int si = tid - 128;
    for (int j = 0; j < ntiles; ++j) {
      const int ci = j / kt, jj = j % kt, slot = ci % SLOTS;
      const int s = j % ST_STAGES, sb = j % SBUF;
      if (jj == 0) hopper::mbar_wait(&w_full[slot], (ci / SLOTS) & 1);
      const float* w = W + slot * L::W_SLOT + jj * KVT;
      hopper::mbar_wait(&full[s], (j / ST_STAGES) & 1);
      if (j >= SBUF) hopper::mbar_wait(&s_empty[sb], ((j / SBUF) & 1) ^ 1);
      const uint8_t* st = base + s * L::STAGE;
      uint8_t* bf = Buf + sb * L::BUF;
#pragma unroll
      for (int e = si; e < NS * KVT / 8; e += 128)
        transpose8(st, SUB, e % NS, e / NS * 8, w, false, bf + L::BH,
                   bf + L::BL, e % NS);
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_arrive(&empty[s]);
        hopper::mbar_arrive(&s_full[sb]);
        if (jj == kt - 1) hopper::mbar_arrive(&w_empty[slot]);
      }
    }
    return;
  }

  // ---- MMA warpgroup: the chunk states, S_in^T and the carry ----
  const int warp = tid / 32, g = lane / 4, t = lane % 4;
  // element x of S^T and of a chunk's state: row p (of P), column n (of
  // N) of this block's tile
  auto at = [&](int x, int& p, int& n) {
    p = p0 + 16 * warp + g + 8 * ((x >> 1) & 1);
    n = n0 + 8 * (x >> 2) + 2 * t + (x & 1);
  };
  float S[NS / 2], cs[NS / 2], part[NS / 2];
#pragma unroll
  for (int x = 0; x < NS / 2; ++x) {
    int p, n;
    at(x, p, n);
    S[x] = s0 != nullptr && p < P ? s0[((size_t)bh * N + n) * P + p] : 0.f;
  }
  const uint32_t buf_addr = hopper::smem_u32(Buf);
  // v^T's A fragments of tile j, k8 step kk: (p, t), (p + 8, t), (p, t +
  // 4), (p + 8, t + 4) with p = 16 warp + g, t the tile's row, as TF32 hi
  // and lo; read from the landed v tile, whose ring stage is then freed
  const int pc = 16 * warp + g;
  auto frags = [&](int j, uint32_t (&ah)[KVT / 8][4],
                   uint32_t (&al)[KVT / 8][4]) {
    const int s = j % ST_STAGES;
    hopper::mbar_wait(&full[s], (j / ST_STAGES) & 1);
    const uint8_t* vs = base + s * L::STAGE + L::B_BYTES + pc / 32 * SUB;
#pragma unroll
    for (int kk = 0; kk < KVT / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 8 * kk + t + 4 * (r >> 1), col = pc % 32 + 8 * (r & 1);
        bident::split_tf32(*reinterpret_cast<const float*>(vs + swz(row, col)),
                           ah[kk][r], al[kk][r]);
      }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  };
  float tot = 0.f;
  // tile j's products with the A fragments (ah, al), the next tile's
  // fragments read into (nh, nl) while they run; then its fold, and after
  // a chunk's last tile S_in^T and the carry
  auto tile = [&](int j, uint32_t (&ah)[KVT / 8][4], uint32_t (&al)[KVT / 8][4],
                  uint32_t (&nh)[KVT / 8][4], uint32_t (&nl)[KVT / 8][4]) {
    const int ci = j / kt, jj = j % kt, slot = ci % SLOTS, sb = j % SBUF;
    if (jj == 0) {
      hopper::mbar_wait(&w_full[slot], (ci / SLOTS) & 1);
      tot = W[slot * L::W_SLOT + CMAX];
    }
    hopper::mbar_wait(&s_full[sb], (j / SBUF) & 1);
    // a fresh accumulator where a fold begins
    const bool fresh = jj * KVT % ST_FOLD == 0;
    const uint32_t bf = buf_addr + sb * L::BUF;
    hopper::reg_fence(ah);
    hopper::reg_fence(al);
    hopper::reg_fence(part);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KVT / 8; ++kk) {
      const uint64_t bh = kdesc(bf + L::BH, kk), bl = kdesc(bf + L::BL, kk);
      hopper::WgmmaTf32<NS>::rs(part, ah[kk], bl, !(fresh && kk == 0));
      hopper::WgmmaTf32<NS>::rs(part, al[kk], bh, 1);
      hopper::WgmmaTf32<NS>::rs(part, ah[kk], bh, 1);
    }
    hopper::wgmma_commit();
    if (j + 1 < ntiles) frags(j + 1, nh, nl);
    hopper::wgmma_wait<0>();
    hopper::reg_fence(part);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&s_empty[sb]);
    if ((jj + 1) * KVT % ST_FOLD == 0 || jj == kt - 1) {
#pragma unroll
      for (int x = 0; x < NS / 2; ++x)
        cs[x] = (jj + 1) * KVT <= ST_FOLD ? part[x] : cs[x] + part[x];
    }
    if (jj == kt - 1) {
      // S_in^T of this chunk, then the carry
      float* out = work + (size_t)(bh * nc + ci) * P * N;
      const float d = expf(tot);
#pragma unroll
      for (int x = 0; x < NS / 2; x += 2) {
        int p, n;
        at(x, p, n);
        if (p < P)
          *reinterpret_cast<float2*>(out + (size_t)p * N + n) =
              make_float2(S[x], S[x + 1]);
      }
#pragma unroll
      for (int x = 0; x < NS / 2; ++x)
        S[x] = __fadd_rn(__fmul_rn(S[x], d), cs[x]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&w_empty[slot]);
    }
  };
  uint32_t ah0[KVT / 8][4], al0[KVT / 8][4], ah1[KVT / 8][4], al1[KVT / 8][4];
  frags(0, ah0, al0);
  for (int j = 0; j < ntiles; j += 2) {
    tile(j, ah0, al0, ah1, al1);
    if (j + 1 < ntiles) tile(j + 1, ah1, al1, ah0, al0);
  }
#pragma unroll
  for (int x = 0; x < NS / 2; ++x) {
    int p, n;
    at(x, p, n);
    if (p < P) s_final[((size_t)bh * N + n) * P + p] = S[x];
  }
}

// ---- the chunk outputs (out_tf32_kernel) ----

// Shared memory of the outputs kernel, from a 1024-byte aligned base: c
// (64 rows), whose tile then holds S_in^T's lo tile, S_in^T (64 rows of
// P), the ring's b and v tiles (KVT rows), NSPLIT buffers of a kv tile's
// split (b lo; v^T hi and lo, 64 rows of KVT), cum, and the mbarriers.
struct OutSmem {
  static constexpr uint32_t C_OFF = 0, SL_OFF = 0;
  static constexpr uint32_t S_OFF = 2 * SUB64;
  static constexpr uint32_t RING_OFF = 4 * SUB64, STAGE = 4 * SUB;
  static constexpr uint32_t BL = 0, VTH = 2 * SUB, VTL = VTH + SUB64;
  static constexpr uint32_t BUF = VTL + SUB64;
  static constexpr uint32_t BUF_OFF = RING_OFF + OUT_STAGES * STAGE;
  static constexpr uint32_t CUM_OFF = BUF_OFF + NSPLIT * BUF;
  static constexpr uint32_t BAR_OFF = CUM_OFF + 4 * CMAX;
  static constexpr size_t BYTES = 1024 + BAR_OFF + 8 * (3 + 2 * OUT_STAGES);
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

// One block owns one (b, h, chunk, 64-row q tile, 64 columns of P): one
// consumer warpgroup and a producer warp.  The producer loads c and
// S_in^T once, the kv tiles' b and v into the ring, and the chunk's cum.
// The consumers hold c's A fragments for all of N in registers as TF32 hi
// and lo (read once from its landed tile) and round S_in^T in place to
// its hi term beside a lo tile (over c's); the inter term c S_in in two
// fresh accumulators over N (N_FOLD each), acc = exp(cum_i) (c S_in)_i;
// then per kv tile j: the score c b^T (two fresh accumulators over N,
// added), G = score o exp(cum_i - cum_j) masked and split in registers,
// G v into a fresh accumulator added to acc.  With NSPLIT = 2, tile j +
// 1's split (b rounded in place with its lo tile, v^T hi and lo) runs
// while the score of tile j does, and the score of tile j + 1 behind G v
// of tile j; with one buffer, tile j + 1 is split once G v of tile j is
// done, and two blocks share an SM instead.  Only B operands come from
// shared memory, so the wgmmas leave its bandwidth to the TMA loads and
// the splits.
__global__ void __launch_bounds__(160, 3 - NSPLIT)
    out_tf32_kernel(const __grid_constant__ CUtensorMap cmap,
                    const __grid_constant__ CUtensorMap bmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap smap,
                    const float* __restrict__ log_a, float* __restrict__ y,
                    int T_len, int H, int P, int C, int nc) {
  using L = OutSmem;
  const int PTL = (P + PW - 1) / PW, QT = (C + 63) / 64;
  // the block: the P tile fastest, then the q tiles of a chunk, heaviest
  // first
  int idx = blockIdx.x;
  const int pt = idx % PTL;
  idx /= PTL;
  const int qt = QT - 1 - idx % QT;
  idx /= QT;
  const int ci = idx % nc, bh = idx / nc;
  const int bb = bh / H, h = bh % H;
  const int t0 = ci * C, q0 = qt * 64, p0 = pt * PW;
  const int Cv = min(C, T_len - t0);   // the chunk's rows within T
  if (q0 >= Cv) return;                // the whole q tile is padding
  const int nk = (min(Cv, q0 + 64) + KVT - 1) / KVT;   // kv tiles

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* ring = base + L::RING_OFF;
  uint8_t* Buf = base + L::BUF_OFF;
  float* cum = reinterpret_cast<float*>(base + L::CUM_OFF);
  uint64_t* c_full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* s_full = c_full + 1;
  uint64_t* cum_full = s_full + 1;
  uint64_t* full = cum_full + 1;
  uint64_t* empty = full + OUT_STAGES;

  const int tid = threadIdx.x;
  const int wid = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  if (tid == 0) {
    hopper::mbar_init(c_full, 1);
    hopper::mbar_init(s_full, 1);
    hopper::mbar_init(cum_full, 32);      // the producer's lanes
    for (int s = 0; s < OUT_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);    // the consumer warps
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wid == 4) {
    // ---- producer: c, S_in^T and the first kv tiles, cum, the rest ----
    auto issue = [&](int j) {
      const int s = j % OUT_STAGES, r0 = t0 + j * KVT;
      uint8_t* st = ring + s * L::STAGE;
      hopper::mbar_expect_tx(&full[s], L::STAGE);
      for (int k = 0; k < 2; ++k) {
        hopper::tma_load_4d(st + k * SUB, &bmap, &full[s], 32 * k, h, r0, bb);
        hopper::tma_load_4d(st + (2 + k) * SUB, &vmap, &full[s], p0 + 32 * k,
                            h, r0, bb);
      }
    };
    if (lane == 0) {
      hopper::mbar_expect_tx(c_full, 2 * SUB64);
      hopper::mbar_expect_tx(s_full, 2 * SUB64);
      for (int k = 0; k < 2; ++k) {
        hopper::tma_load_4d(base + L::C_OFF + k * SUB64, &cmap, c_full,
                            32 * k, h, t0 + q0, bb);
        hopper::tma_load_3d(base + L::S_OFF + k * SUB64, &smap, s_full,
                            32 * k, p0, bh * nc + ci);
      }
      for (int j = 0; j < min(OUT_STAGES, nk); ++j) issue(j);
    }
    chunk_cumsum(log_a, cum, bb, h, t0, T_len, H, C, lane);
    __syncwarp();
    hopper::mbar_arrive(cum_full);
    if (lane == 0)
      for (int j = OUT_STAGES; j < nk; ++j) {
        const int s = j % OUT_STAGES;
        hopper::mbar_wait(&empty[s], ((j / OUT_STAGES) & 1) ^ 1);
        issue(j);
      }
    return;
  }

  // ---- consumers: one warpgroup ----
  const int i = tid, warp = i / 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + 16 * warp + g;   // and row0 + 8
  // kv tile j landed: b rounded in place, its lo tile, v^T hi and lo (kv
  // order permuted) into buffer j % 2; the ring stage stays until the
  // score has read b
  auto split = [&](int j) {
    const int s = j % OUT_STAGES;
    hopper::mbar_wait(&full[s], (j / OUT_STAGES) & 1);
    uint8_t* st = ring + s * L::STAGE;
    uint8_t* bf = Buf + j % NSPLIT * L::BUF;
    split_tile(st, st, bf + L::BL, 2 * SUB, i, 128);
#pragma unroll
    for (int e = i; e < PW * KVT / 8; e += 128)
      transpose8(st + 2 * SUB, SUB, e % PW, e / PW * 8, nullptr, true,
                 bf + L::VTH, bf + L::VTL, e % PW);
    hopper::fence_proxy_async();
  };
  // c's A fragments of k8 step kk (N's columns 8 kk ..): (g, t), (g + 8,
  // t), (g, t + 4), (g + 8, t + 4) of the warp's 16 rows, TF32 hi and lo
  uint32_t ch[NW / 8][4], cl[NW / 8][4];
  hopper::mbar_wait(c_full, 0);
#pragma unroll
  for (int kk = 0; kk < NW / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * warp + g + 8 * (r & 1), col = 8 * kk + t + 4 * (r >> 1);
      bident::split_tf32(*reinterpret_cast<const float*>(
                             base + L::C_OFF + col / 32 * SUB64 +
                             swz(row, col % 32)),
                         ch[kk][r], cl[kk][r]);
    }
  hopper::named_bar_sync(1, 128);        // c's tile read by every thread
  hopper::mbar_wait(s_full, 0);
  split_tile(base + L::S_OFF, base + L::S_OFF, base + L::SL_OFF, 2 * SUB64,
             i, 128);
  split(0);
  hopper::named_bar_sync(1, 128);
  const uint32_t s_addr = hopper::smem_u32(base + L::S_OFF);
  const uint32_t sl_addr = hopper::smem_u32(base + L::SL_OFF);
  const uint32_t ring_addr = hopper::smem_u32(ring);
  const uint32_t buf_addr = hopper::smem_u32(Buf);
  // per k8 step c_lo.x_hi, c_hi.x_lo, c_hi.x_hi against a K-major tile x
  // (its hi term at xh, lo at xl; 32-float sub-tiles `sub` bytes apart)
  // for N's k8 steps k0 .. k1 - 1, the first into a fresh accumulator
  auto c_mma = [&](auto& d, uint32_t xh, uint32_t xl, uint32_t sub, int k0,
                   int k1) {
#pragma unroll
    for (int kk = k0; kk < k1; ++kk) {
      const uint32_t xo = kk / 4 * sub;
      const uint64_t dh = kdesc(xh + xo, kk), dl = kdesc(xl + xo, kk);
      using M = hopper::WgmmaTf32<sizeof(d) / sizeof(float) * 2>;
      M::rs(d, cl[kk], dh, kk > k0);
      M::rs(d, ch[kk], dl, 1);
      M::rs(d, ch[kk], dh, 1);
    }
  };
  // the score of kv tile j, over N in folds of N_FOLD: sc, then sp
  float sc[KVT / 2], sp[KVT / 2];
  auto score = [&](int j) {
    const uint32_t bh = ring_addr + j % OUT_STAGES * L::STAGE;
    const uint32_t bl = buf_addr + j % NSPLIT * L::BUF + L::BL;
    hopper::reg_fence(sc);
    hopper::reg_fence(sp);
    hopper::wgmma_fence();
    c_mma(sc, bh, bl, SUB, 0, N_FOLD / 8);
    c_mma(sp, bh, bl, SUB, N_FOLD / 8, NW / 8);
    hopper::wgmma_commit();
  };

  // inter: c S_in over N in folds of N_FOLD, acc then part
  float acc[PW / 2], part[PW / 2];
  hopper::reg_fence(ch);
  hopper::reg_fence(cl);
  hopper::wgmma_fence();
  c_mma(acc, s_addr, sl_addr, SUB64, 0, N_FOLD / 8);
  c_mma(part, s_addr, sl_addr, SUB64, N_FOLD / 8, NW / 8);
  hopper::wgmma_commit();
  score(0);
  hopper::mbar_wait(cum_full, 0);
  float cum_i[2], e_i[2];   // each row's cum and exp(cum) (0 past Cv)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    cum_i[hr] = row < Cv ? cum[row] : 0.f;
    e_i[hr] = row < Cv ? expf(cum_i[hr]) : 0.f;
  }
  hopper::wgmma_wait<1>();
  hopper::reg_fence(acc);
  hopper::reg_fence(part);
#pragma unroll
  for (int x = 0; x < PW / 2; ++x) {
    acc[x] = e_i[(x >> 1) & 1] * acc[x];
    if (N_FOLD < NW) acc[x] += e_i[(x >> 1) & 1] * part[x];
  }
  // a tile needs the mask where it reaches above the q tile's first row,
  // or where the q tile has rows past the chunk's
  const bool rows_past = q0 + 64 > Cv;
  for (int j = 0; j < nk; ++j) {
    if (NSPLIT == 2 && j + 1 < nk) split(j + 1);
    hopper::wgmma_wait<0>();             // the score of tile j
    hopper::reg_fence(sc);
    hopper::reg_fence(sp);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[j % OUT_STAGES]);
    // G = score o exp(cum_i - cum_j): element 4 jn + e is row row0 + 8 (e
    // / 2), kv column j KVT + 8 jn + 2t + e % 2; then its TF32 terms in
    // the A fragment of k8 step jn: (g, kv 2t), (g + 8, kv 2t), (g, kv 2t
    // + 1), (g + 8, kv 2t + 1)
    const bool mask = (j + 1) * KVT - 1 > q0 || rows_past;
    uint32_t gh[KVT / 8][4], gl[KVT / 8][4];
#pragma unroll
    for (int jn = 0; jn < KVT / 8; ++jn) {
      float gx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, row = row0 + 8 * hr;
        const int col = j * KVT + 8 * jn + 2 * t + (e & 1);
        float x = sc[4 * jn + e];
        if (N_FOLD < NW) x += sp[4 * jn + e];
        const float gv = x * expf(cum_i[hr] - cum[col]);
        gx[e] = !mask || (col <= row && row < Cv) ? gv : 0.f;
      }
      bident::split_tf32(gx[0], gh[jn][0], gl[jn][0]);
      bident::split_tf32(gx[2], gh[jn][1], gl[jn][1]);
      bident::split_tf32(gx[1], gh[jn][2], gl[jn][2]);
      bident::split_tf32(gx[3], gh[jn][3], gl[jn][3]);
    }
    if (NSPLIT == 2)
      hopper::named_bar_sync(1, 128);    // tile j + 1 split by every thread
    // G v of tile j into a fresh accumulator: G_lo.v_hi, G_hi.v_lo,
    // G_hi.v_hi per k8 step; then the score of tile j + 1
    const uint32_t vth = buf_addr + j % NSPLIT * L::BUF + L::VTH;
    const uint32_t vtl = buf_addr + j % NSPLIT * L::BUF + L::VTL;
    hopper::reg_fence(gh);
    hopper::reg_fence(gl);
    hopper::reg_fence(part);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KVT / 8; ++kk) {
      const uint64_t dh = kdesc(vth, kk);
      hopper::WgmmaTf32<PW>::rs(part, gl[kk], dh, kk > 0);
      hopper::WgmmaTf32<PW>::rs(part, gh[kk], kdesc(vtl, kk), 1);
      hopper::WgmmaTf32<PW>::rs(part, gh[kk], dh, 1);
    }
    hopper::wgmma_commit();
    if (NSPLIT == 1) {
      hopper::wgmma_wait<0>();
      if (j + 1 < nk) {      // the buffer is free: tile j + 1's split, score
        split(j + 1);
        hopper::named_bar_sync(1, 128);
        score(j + 1);
      }
    } else if (j + 1 < nk) {
      score(j + 1);
      hopper::wgmma_wait<1>();
    } else {
      hopper::wgmma_wait<0>();
    }
    hopper::reg_fence(part);
#pragma unroll
    for (int x = 0; x < PW / 2; ++x) acc[x] += part[x];
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row >= Cv) continue;
    float* out = y + ((size_t)(bb * T_len + t0 + row) * H + h) * P;
#pragma unroll
    for (int jn = 0; jn < PW / 8; ++jn) {
      const int p = p0 + 8 * jn + 2 * t;
      if (p < P)
        *reinterpret_cast<float2*>(out + p) =
            make_float2(acc[4 * jn + 2 * hr], acc[4 * jn + 2 * hr + 1]);
    }
  }
}

// ---- the chunk outputs at N above 64 (out_wide_tf32_kernel) ----

// Shared memory of the wide outputs kernel at N, from a 1024-byte aligned
// base: c (64 rows of N: N / 32 sub-tiles of 32 columns), the ring's
// WIDE_STAGES stages of one item each (two 64-row sub-tiles, 16 KB),
// WIDE_SPLITS split buffers (an item's two hi tiles, then its two lo
// tiles), cum, and the mbarriers.
struct WideSmem {
  static constexpr uint32_t STAGE = 2 * SUB64, SPLIT = 4 * SUB64;
  static constexpr __host__ __device__ uint32_t ring_off(int N) {
    return N / 32 * SUB64;
  }
  static constexpr __host__ __device__ uint32_t split_off(int N) {
    return ring_off(N) + WIDE_STAGES * STAGE;
  }
  static constexpr __host__ __device__ uint32_t cum_off(int N) {
    return split_off(N) + WIDE_SPLITS * SPLIT;
  }
  static constexpr __host__ __device__ uint32_t bar_off(int N) {
    return cum_off(N) + 4 * CMAX;
  }
  static constexpr __host__ __device__ size_t bytes(int N) {
    return 1024 + bar_off(N) + 8 * (2 + WIDE_STAGES + 2 * WIDE_SPLITS);
  }
};
static_assert(WideSmem::bytes(WIDE_MAX) <= 232448,
              "over the 227 KB a block may use");

// One block owns one (b, h, chunk, 64-row q tile, 64 columns of P): two
// warpgroups, 256 threads.  The block's items, each two 64-row sub-tiles
// of 32 columns, stream through a ring of WIDE_STAGES: S_in^T's 64 rows
// of P by WI of N, N / WI of them; then for each pair of kv tiles (WI
// chunk rows) its b by WI of N, N / WI of them, and its v tile, WI
// columns of P.  Warpgroup 1's last WIDE_SPLIT_WARPS warps split each
// landed item into one of WIDE_SPLITS buffers as TF32 hi and lo tiles (a
// v tile as v^T, the kv order permuted), which frees its ring stage; its
// first warp computes cum, and its thread 0 loads c once by TMA and each
// item WIDE_STAGES ahead (a split warp that also issued the loads held
// the splits back: measured slower, kernel_variants.py's wide_split4).
// Warpgroup 0 runs each split item as a group of m64n64k8 wgmmas in two
// chains of fresh accumulators (da, db), their instructions interleaved
// (a chain of three products on 32 of K depends on each product before
// it, and one chain alone leaves the tensor cores waiting on it), with
// c's A fragments of the item's WI columns (read from c's tile, split in
// registers) or G's: an S_in^T item adds exp(cum_i) (c S_in) to acc over
// two folds of 32 of N (N_FOLD; one chain where N_FOLD is 64), a b item
// adds c b^T over the same folds to the score of the kv pair (64 x 64 in
// the accumulator layout), and a v tile adds G v over the pair's two kv
// tiles of KVT (their fresh accumulators, as the mma.sync kernels'), G =
// score o exp(cum_i - cum_j) masked and split in registers once the
// pair's last fold is in.  A warpgroup issuing wgmmas stalls until the
// tensor cores take them, so the splits run in a warpgroup of their own
// (one warpgroup splitting the next item behind its products measured
// slower in development builds).  Eight warps keep 255 registers a thread
// (a ninth, a producer warp, would cap them at 168: an SM quarter's 16 K
// registers over its 3 warps).
__global__ void __launch_bounds__(256, 1)
    out_wide_tf32_kernel(const __grid_constant__ CUtensorMap cmap,
                         const __grid_constant__ CUtensorMap bmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap smap,
                         const float* __restrict__ log_a,
                         float* __restrict__ y, int T_len, int H, int N,
                         int P, int C, int nc) {
  using L = WideSmem;
  const int PTL = (P + PW - 1) / PW, QT = (C + 63) / 64, NI = N / WI;
  // the block: the P tile fastest, then the q tiles of a chunk, heaviest
  // first
  int idx = blockIdx.x;
  const int pt = idx % PTL;
  idx /= PTL;
  const int qt = QT - 1 - idx % QT;
  idx /= QT;
  const int ci = idx % nc, bh = idx / nc;
  const int bb = bh / H, h = bh % H;
  const int t0 = ci * C, q0 = qt * 64, p0 = pt * PW;
  const int Cv = min(C, T_len - t0);   // the chunk's rows within T
  if (q0 >= Cv) return;                // the whole q tile is padding
  // kv pairs up to the q tile's last row (a pair's tile past it is masked)
  const int nkp = (min(Cv, q0 + 64) + WI - 1) / WI;
  const int n_items = NI + nkp * (NI + 1);
  // item it: S_in^T's columns WI it .. (it < NI), else kv pair j's b,
  // columns WI f .. (f < NI), or its v tile (f = NI)
  auto fold_of = [&](int it) { return it < NI ? it : (it - NI) % (NI + 1); };
  auto pair_of = [&](int it) { return (it - NI) / (NI + 1); };

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* ring = base + L::ring_off(N);
  uint8_t* Split = base + L::split_off(N);
  float* cum = reinterpret_cast<float*>(base + L::cum_off(N));
  uint64_t* c_full = reinterpret_cast<uint64_t*>(base + L::bar_off(N));
  uint64_t* cum_full = c_full + 1;
  uint64_t* full = cum_full + 1;           // an item landed
  uint64_t* ready = full + WIDE_STAGES;    // an item split
  uint64_t* sfree = ready + WIDE_SPLITS;   // its split buffer free again

  const int tid = threadIdx.x;
  const int wid = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  if (tid == 0) {
    hopper::mbar_init(c_full, 1);
    hopper::mbar_init(cum_full, 32);      // warp 4's lanes
    for (int s = 0; s < WIDE_STAGES; ++s) hopper::mbar_init(&full[s], 1);
    for (int s = 0; s < WIDE_SPLITS; ++s) {
      hopper::mbar_init(&ready[s], 1);    // the split warpgroup's thread 0
      hopper::mbar_init(&sfree[s], 4);    // the MMA warps
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wid >= 4) {
    // ---- split warpgroup: the loads (thread 0), cum (warp 4), and each
    // landed item's TF32 terms into split buffer it % WIDE_SPLITS ----
    const int si = tid - 128;
    auto issue = [&](int it) {      // item it into ring stage it % WIDE_STAGES
      const int s = it % WIDE_STAGES, f = fold_of(it);
      uint8_t* st = ring + s * L::STAGE;
      const int r0 = t0 + (it < NI ? 0 : pair_of(it)) * WI;
      hopper::mbar_expect_tx(&full[s], L::STAGE);
      for (int k = 0; k < 2; ++k) {
        if (it < NI)
          hopper::tma_load_3d(st + k * SUB64, &smap, &full[s],
                              WI * f + 32 * k, p0, bh * nc + ci);
        else if (f < NI)
          hopper::tma_load_4d(st + k * SUB64, &bmap, &full[s],
                              WI * f + 32 * k, h, r0, bb);
        else
          hopper::tma_load_4d(st + k * SUB64, &vmap, &full[s], p0 + 32 * k,
                              h, r0, bb);
      }
    };
    if (si == 0) {
      hopper::mbar_expect_tx(c_full, N / 32 * SUB64);
      for (int k = 0; k < N / 32; ++k)
        hopper::tma_load_4d(base + k * SUB64, &cmap, c_full, 32 * k, h,
                            t0 + q0, bb);
      for (int it = 0; it < min(WIDE_STAGES, n_items); ++it) issue(it);
    }
    if (wid == 4) {
      chunk_cumsum(log_a, cum, bb, h, t0, T_len, H, C, lane);
      __syncwarp();
      hopper::mbar_arrive(cum_full);
    }
    // the split threads: the warpgroup's last WIDE_SPLIT_WARPS warps, so
    // that thread 0's loads do not hold up a warp that splits
    constexpr int NSP = 32 * WIDE_SPLIT_WARPS;
    const int sj = tid - (256 - NSP);
    for (int it = 0; it < n_items; ++it) {
      const int s = it % WIDE_STAGES, sp = it % WIDE_SPLITS;
      if (sj >= 0) {
        hopper::mbar_wait(&full[s], (it / WIDE_STAGES) & 1);
        if (it >= WIDE_SPLITS)
          hopper::mbar_wait(&sfree[sp], ((it / WIDE_SPLITS) & 1) ^ 1);
        const uint8_t* st = ring + s * L::STAGE;
        uint8_t* sb = Split + sp * L::SPLIT;
        if (fold_of(it) == NI) {
          // v^T: 64 rows of P by kv 0-31 and 32-63, hi then lo
          for (int e = sj; e < PW * WI / 8; e += NSP) {
            const int p = e % PW, r0 = e / PW * 8, half = r0 / 32;
            transpose8(st + half * 32 * 128, SUB64, p, r0 % 32, nullptr,
                       true, sb + half * SUB64, sb + (2 + half) * SUB64, p);
          }
        } else {
          split_tile(st, sb, sb + 2 * SUB64, L::STAGE, sj, NSP);
        }
        hopper::fence_proxy_async();
      }
      hopper::named_bar_sync(2, 128);   // the item split, its stage read
      if (si == 0) {
        hopper::mbar_arrive(&ready[sp]);
        if (it + WIDE_STAGES < n_items) issue(it + WIDE_STAGES);
      }
    }
    return;
  }

  // ---- MMA warpgroup ----
  const int warp = wid, g = lane / 4, t = lane % 4;
  const int row0 = q0 + 16 * warp + g;   // and row0 + 8
  const uint32_t split_addr = hopper::smem_u32(Split);
  // c's A fragments of item it's WI columns of N: k8 step kk's (g, t), (g
  // + 8, t), (g, t + 4), (g + 8, t + 4) of the warp's 16 rows, TF32 hi and
  // lo
  uint32_t ah[WI / 8][4], al[WI / 8][4];
  auto c_frags = [&](int it) {
    const uint8_t* cf = base + fold_of(it) * 2 * SUB64;
#pragma unroll
    for (int kk = 0; kk < WI / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * warp + g + 8 * (r & 1);
        const int col = 8 * (kk % 4) + t + 4 * (r >> 1);
        bident::split_tf32(*reinterpret_cast<const float*>(
                               cf + kk / 4 * SUB64 + swz(row, col)),
                           ah[kk][r], al[kk][r]);
      }
  };

  float acc[PW / 2];              // y's tile
  float da[WI / 2], db[WI / 2];   // the item's two chains
  float sc[WI / 2];               // the kv pair's score
  float cum_i[2], e_i[2];         // each row's cum and exp(cum) (0 past Cv)
  // a pair needs the mask where it reaches above the q tile's first row,
  // or where the q tile has rows past the chunk's
  const bool rows_past = q0 + 64 > Cv;
  constexpr bool TWO = N_FOLD == 32;   // two folds of N a b or S_in^T item
  // item it's products: per k8 step x_lo.y_hi, x_hi.y_lo, x_hi.y_hi, the
  // first half of K into da and the second into db (or on into da where
  // it is one fold), with the A fragments against the K-major sub-tiles
  // of y (hi at yh0 / yh1, lo at yl0 / yl1)
  auto products = [&](uint32_t yh0, uint32_t yl0, uint32_t yh1, uint32_t yl1,
                      bool two) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t h0 = kdesc(yh0, kk), h1 = kdesc(yh1, kk);
      const uint64_t l0 = kdesc(yl0, kk), l1 = kdesc(yl1, kk);
      using M = hopper::WgmmaTf32<WI>;
      M::rs(da, al[kk], h0, kk > 0);
      if (two) M::rs(db, al[kk + 4], h1, kk > 0);
      M::rs(da, ah[kk], l0, 1);
      if (two) M::rs(db, ah[kk + 4], l1, 1);
      M::rs(da, ah[kk], h0, 1);
      if (two) M::rs(db, ah[kk + 4], h1, 1);
    }
    if (!two)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t h1 = kdesc(yh1, kk);
        using M = hopper::WgmmaTf32<WI>;
        M::rs(da, al[kk + 4], h1, 1);
        M::rs(da, ah[kk + 4], kdesc(yl1, kk), 1);
        M::rs(da, ah[kk + 4], h1, 1);
      }
  };

  hopper::mbar_wait(c_full, 0);
  c_frags(0);
  hopper::mbar_wait(cum_full, 0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    cum_i[hr] = row < Cv ? cum[row] : 0.f;
    e_i[hr] = row < Cv ? expf(cum_i[hr]) : 0.f;
  }
#pragma unroll
  for (int x = 0; x < PW / 2; ++x) acc[x] = 0.f;
  for (int it = 0; it < n_items; ++it) {
    const int sp = it % WIDE_SPLITS, f = fold_of(it);
    const uint32_t sb = split_addr + sp * L::SPLIT;
    const bool gv = f == NI;
    hopper::mbar_wait(&ready[sp], (it / WIDE_SPLITS) & 1);
    hopper::reg_fence(ah);
    hopper::reg_fence(al);
    hopper::reg_fence(da);
    hopper::reg_fence(db);
    hopper::wgmma_fence();
    products(sb, sb + 2 * SUB64, sb + SUB64, sb + 3 * SUB64, gv || TWO);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(da);
    hopper::reg_fence(db);
    hopper::reg_fence(ah);
    hopper::reg_fence(al);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sfree[sp]);
    if (it < NI) {
#pragma unroll
      for (int x = 0; x < PW / 2; ++x) {
        acc[x] += e_i[(x >> 1) & 1] * da[x];
        if (TWO) acc[x] += e_i[(x >> 1) & 1] * db[x];
      }
    } else if (!gv) {
#pragma unroll
      for (int x = 0; x < WI / 2; ++x) {
        sc[x] = f == 0 ? da[x] : sc[x] + da[x];
        if (TWO) sc[x] += db[x];
      }
    } else {
#pragma unroll
      for (int x = 0; x < PW / 2; ++x) {
        acc[x] += da[x];
        acc[x] += db[x];
      }
    }
    if (it + 1 == n_items) break;
    if (f == NI - 1 && it >= NI) {
      // G = score o exp(cum_i - cum_j): element 4 jn + e is row row0 + 8
      // (e / 2), kv column j WI + 8 jn + 2t + e % 2; then its TF32 terms
      // in the A fragment of k8 step jn: (g, kv 2t), (g + 8, kv 2t), (g,
      // kv 2t + 1), (g + 8, kv 2t + 1)
      const int j = pair_of(it);
      const bool mask = (j + 1) * WI - 1 > q0 || rows_past;
#pragma unroll
      for (int jn = 0; jn < WI / 8; ++jn) {
        float gx[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, row = row0 + 8 * hr;
          const int col = j * WI + 8 * jn + 2 * t + (e & 1);
          const float gv = sc[4 * jn + e] * expf(cum_i[hr] - cum[col]);
          gx[e] = !mask || (col <= row && row < Cv) ? gv : 0.f;
        }
        bident::split_tf32(gx[0], ah[jn][0], al[jn][0]);
        bident::split_tf32(gx[2], ah[jn][1], al[jn][1]);
        bident::split_tf32(gx[1], ah[jn][2], al[jn][2]);
        bident::split_tf32(gx[3], ah[jn][3], al[jn][3]);
      }
    } else {
      c_frags(it + 1);
    }
  }

  // y's rows of P floats: pairs of columns on 8 bytes where P is even
  const bool pairs =
      P % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 7) == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row >= Cv) continue;
    float* out = y + ((size_t)(bb * T_len + t0 + row) * H + h) * P;
#pragma unroll
    for (int jn = 0; jn < PW / 8; ++jn) {
      const int p = p0 + 8 * jn + 2 * t;
      const float a0 = acc[4 * jn + 2 * hr], a1 = acc[4 * jn + 2 * hr + 1];
      if (pairs) {
        if (p < P) *reinterpret_cast<float2*>(out + p) = make_float2(a0, a1);
      } else {
        if (p < P) out[p] = a0;
        if (p + 1 < P) out[p + 1] = a1;
      }
    }
  }
}

// v's rows (B T H of P floats, at any alignment) into rows of P4 floats
// at vp (16-byte aligned), zeros past P, for TMA: a thread a 16-byte
// chunk of vp.
__global__ void __launch_bounds__(256)
    pad_v_kernel(const float* __restrict__ v, float* __restrict__ vp,
                 long long rows, int P, int P4) {
  const long long q = P4 / 4, n = rows * q;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n;
       e += (long long)gridDim.x * 256) {
    const long long r = e / q;
    const int c0 = (int)(e - r * q) * 4;
    const float* src = v + r * P + c0;
    float x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = c0 + k < P ? src[k] : 0.f;
    reinterpret_cast<float4*>(vp)[e] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The rule, decided before the launch: this design where TMA reads c and
// b (16-byte aligned bases) and either N is a multiple of 64 from
// WIDE_MIN to WIDE_MAX (v at any P: by TMA where it can, else by the
// producers' plain loads) or N is 64 and TMA reads v too (a 16-byte
// aligned base, P a multiple of 4 and at least one 32-column box); the
// mma.sync kernels elsewhere.
inline bool tma_route(const void* c, const void* b, const void* v, int N,
                      int P) {
  return bident::aligned16(c) && bident::aligned16(b) &&
         ((N % 64 == 0 && N >= WIDE_MIN && N <= WIDE_MAX) ||
          (N == NW && P % 4 == 0 && P >= 32 && bident::aligned16(v)));
}

// Where the wide route's v has rows TMA cannot read (P not a multiple of
// 4 or under 32, or a base off 16 bytes: xLSTM-125M's mLSTM at P = 385),
// the C entry first copies v into `work` past the chunk states, at
// pad_offset floats, as rows of padded_p floats (pad_v_kernel).
inline bool pad_v(const void* v, int N, int P) {
  return N != NW && !(P % 4 == 0 && P >= 32 && bident::aligned16(v));
}
inline int padded_p(int P) { return max(round_up(P, 4), 32); }
inline size_t pad_offset(int B, int H, int nc, int N, int P) {
  return ((size_t)B * H * nc * ((size_t)N * P + 1) + 3) / 4 * 4;
}

// state rows a block of the state kernel: 32 where 64-row tiles would
// leave half the card's SMs without a walker, else 64
inline int state_cols(long long blocks64) {
  return 2 * blocks64 <= SMS ? 32 : 64;
}

template <int NS>
cudaError_t launch_state(const CUtensorMap& bm, const CUtensorMap& vm,
                         const float* log_a, const float* s0, float* work,
                         float* s_final, int B, int T_len, int H, int N,
                         int P, int C, int nc, cudaStream_t stream) {
  cudaError_t err =
      bident::allow_smem(state_tf32_kernel<NS>, StateSmem<NS>::BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * (N / NS) * ((P + PW - 1) / PW);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  state_tf32_kernel<NS><<<(unsigned)blocks, 320, StateSmem<NS>::BYTES,
                          stream>>>(bm, vm, log_a, s0, work, s_final, T_len,
                                    H, N, P, C, nc);
  return cudaGetLastError();
}

// The f32 scan on this design (the calls tma_route takes): v's padded
// copy where TMA cannot read v (pad_v), the state kernel (S_in^T of every
// chunk into `work`, (B, H, nc, P, N); the final state), then the chunk
// outputs, out_tf32_kernel at N = 64, out_wide_tf32_kernel above.
cudaError_t launch(const void* c, const void* b, const void* v,
                   const float* log_a, const float* s0, void* y,
                   float* s_final, float* work, int B, int T_len, int H,
                   int N, int P, int C, cudaStream_t stream) {
  const int nc = (T_len + C - 1) / C, PTL = (P + PW - 1) / PW;
  const bool wide = N != NW;
  int PV = P;   // the row length of v as TMA reads it
  if (pad_v(v, N, P)) {
    PV = padded_p(P);
    float* vp = work + pad_offset(B, H, nc, N, P);
    const long long rows = (long long)B * T_len * H;
    const long long chunks = rows * (PV / 4);
    const int grid = (int)(chunks < 132LL * 8 * 256
                               ? (chunks + 255) / 256 : 132LL * 8);
    pad_v_kernel<<<grid, 256, 0, stream>>>(static_cast<const float*>(v), vp,
                                           rows, P, PV);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    v = vp;
  }
  CUtensorMap cm{}, bm{}, vm{}, sm{}, bw{}, vw{};
  if (!(hopper::encode_bthd(&cm, c, B, T_len, H, N, 32, 64, 4) &&
        hopper::encode_bthd(&bm, b, B, T_len, H, N, 32, KVT, 4) &&
        hopper::encode_bthd(&vm, v, B, T_len, H, PV, 32, KVT, 4) &&
        (!wide || (hopper::encode_bthd(&bw, b, B, T_len, H, N, 32, WI, 4) &&
                   hopper::encode_bthd(&vw, v, B, T_len, H, PV, 32, WI, 4))) &&
        hopper::encode_f32_3d(&sm, work, N, P, B * H * nc, 64)))
    return cudaErrorInvalidValue;
  cudaError_t err =
      state_cols((long long)B * H * (N / 64) * PTL) == 32
          ? launch_state<32>(bm, vm, log_a, s0, work, s_final, B, T_len, H,
                             N, P, C, nc, stream)
          : launch_state<64>(bm, vm, log_a, s0, work, s_final, B, T_len, H,
                             N, P, C, nc, stream);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)B * H * nc * ((C + 63) / 64) * PTL;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* yf = static_cast<float*>(y);
  if (!wide) {
    err = bident::allow_smem(out_tf32_kernel, OutSmem::BYTES);
    if (err != cudaSuccess) return err;
    out_tf32_kernel<<<(unsigned)blocks, 160, OutSmem::BYTES, stream>>>(
        cm, bm, vm, sm, log_a, yf, T_len, H, P, C, nc);
  } else {
    err = bident::allow_smem(out_wide_tf32_kernel, WideSmem::bytes(WIDE_MAX));
    if (err != cudaSuccess) return err;
    out_wide_tf32_kernel<<<(unsigned)blocks, 256, WideSmem::bytes(N),
                           stream>>>(cm, bw, vw, sm, log_a, yf, T_len,
                                     H, N, P, C, nc);
  }
  return cudaGetLastError();
}

}  // namespace tf

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The f32 scan on the mma.sync kernels (ASYNC: rows by cp.async)
template <bool ASYNC>
cudaError_t launch(const float* c, const float* b, const float* v,
                   const float* log_a, const float* s0, float* y,
                   float* s_final, float* work, int B, int T_len, int H,
                   int N, int P, int C, cudaStream_t stream) {
  const int nc = (T_len + C - 1) / C, BH = B * H;
  const int pt = (P + PT - 1) / PT, nsl = (N + SL - 1) / SL;
  float* states = work;                          // BH x nc x N x P
  float* tot = work + (size_t)BH * nc * N * P;   // BH x nc

  cudaError_t err;
  const size_t smem1 = StateLayout::smem(N);
  if (N <= 64) {
    err = bident::allow_smem(state_kernel<ASYNC, 1>, smem1);
    if (err != cudaSuccess) return err;
    state_kernel<ASYNC, 1><<<dim3(nc, BH, pt * nsl), NT, smem1, stream>>>(
        b, v, log_a, states, tot, T_len, H, N, P, C, nc);
  } else {
    err = bident::allow_smem(state_kernel<ASYNC, 2>, smem1);
    if (err != cudaSuccess) return err;
    state_kernel<ASYNC, 2><<<dim3(nc, BH, pt * nsl), NT, smem1, stream>>>(
        b, v, log_a, states, tot, T_len, H, N, P, C, nc);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long n_state = (long long)BH * N * P;
  pass_kernel<<<(unsigned)((n_state + 255) / 256), 256, 0, stream>>>(
      s0, states, tot, s_final, BH, N * P, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem3 = OutLayout::smem(N);
  err = bident::allow_smem(out_kernel<ASYNC>, smem3);
  if (err != cudaSuccess) return err;
  const int QT = (C + BQ - 1) / BQ;
  out_kernel<ASYNC><<<dim3(QT * nc, BH, pt), NT, smem3, stream>>>(
      c, b, v, log_a, states, y, T_len, H, N, P, C, nc);
  return cudaGetLastError();
}

cudaError_t launch_aligned(const void* c, const void* b, const void* v,
                           const float* log_a, const float* s0, void* y,
                           float* s_final, float* work, int B, int T_len,
                           int H, int N, int P, int C, cudaStream_t stream) {
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(b);
  const float* vf = static_cast<const float*>(v);
  float* yf = static_cast<float*>(y);
  // cp.async needs every row of c, b and v to start on a 16-byte boundary
  return bident::aligned16(c) && bident::aligned16(b) &&
                 bident::aligned16(v) && N % 4 == 0 && P % 4 == 0
             ? launch<true>(cf, bf, vf, log_a, s0, yf, s_final, work, B,
                            T_len, H, N, P, C, stream)
             : launch<false>(cf, bf, vf, log_a, s0, yf, s_final, work, B,
                             T_len, H, N, P, C, stream);
}

}  // namespace

// C entry point (bound with ctypes).  c, b (B,T,H,N) and v (B,T,H,P) in
// float32 or (bf16 != 0) bfloat16; log_a (B,T,H) float32; s0 (B,H,N,P)
// float32 or NULL for a zero initial state; y (B,T,H,P) in v's dtype;
// s_final (B,H,N,P) float32; work, float32 scratch of B*H*nc*(N*P + 1)
// elements with nc = ceil(T / C): each chunk's S_in, (B,H,nc,N,P) for PR
// 13's kernels and the bf16 design, (B,H,nc,P,N) for the f32 wgmma
// design; then the mma.sync design's tot; and, where the f32 wgmma design
// above N = 64 copies v (tf::pad_v), from the next multiple of 4 floats
// (tf::pad_offset) B*T*H rows of tf::padded_p(P) floats more.  All
// contiguous device buffers.  The chunk length C is at most 256 and N at
// most 496; P is tiled 64 columns a block (at most 65535 blocks of grid z
// in the mma.sync design's state kernel: ceil(P / 64) times ceil(N /
// 128)).  The design is chosen before the launch by an explicit rule,
// never on error: bf16 takes the wgmma design; f32 with c and b readable
// by TMA at N = 64 (v too) or at N 128-448 (tf::tma_route) the 3xTF32
// wgmma design; every other f32 call the three mma.sync kernels.  Runs
// its kernels on `stream`; returns the first cudaError_t (0 on success).
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
  if (bf16)
    return wg::launch(c, b, v, la, st, y, sf, wk, B, T_len, H, N, P, C, s);
  if (tf::tma_route(c, b, v, N, P))
    return tf::launch(c, b, v, la, st, y, sf, wk, B, T_len, H, N, P, C, s);
  return launch_aligned(c, b, v, la, st, y, sf, wk, B, T_len, H, N, P, C, s);
}
