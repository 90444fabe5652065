// Blockwise causal GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_attn_kernel` of
// src/repro/kernels/flash_attention.py.  Same contract: q (B,Tq,Hq,D),
// k and v (B,Tk,Hk,D) with Hq % Hk == 0 (query head h reads kv head
// h / (Hq/Hk)); scores scaled by 1/sqrt(D) in f32; online softmax with
// f32 running max m, denominator l (clamped at 1e-30) and accumulator; kv
// positions past Tk and, when causal, above the diagonal (q_offset +
// query row < kv position) masked with -1e30; with `causal`, kv tiles
// wholly above the diagonal are skipped; output in q's dtype.  As in the
// Pallas kernel, the products are f32-accurate and p is never rounded to
// bf16.  Three designs, chosen before the launch by an explicit rule in
// the C entry (never on error): bf16 on `wgmma` fed by TMA; f32 at D 64,
// 128 and 160 with q, k, v on 16-byte boundaries on 3xTF32 `wgmma` fed by
// TMA (`tf::tma_route`); every other f32 call (D 16, 32, operands off 16
// bytes) on 3xTF32 `mma.sync`.
//
// ---- bf16: wgmma and TMA (attn_wgmma_kernel) ----
//
// A bf16 q.k product is exact in f32, so S = Q K^T runs as one bf16 pass
// on `wgmma` (m64nBKk16, both operands from shared memory, f32
// accumulator), and the 1/sqrt(D) scale, folded with log2(e) for `ex2`,
// is applied to S in f32 after the product (q * scale is not a bf16
// number at D 32, 128, 160).  P is kept above bf16 as two bf16 terms,
// hi = bf16(p) and lo = bf16(p - hi) (16 significant bits), and P V runs
// as two bf16 passes against the same V tile: wgmma with P as the register
// A operand (S's accumulator layout is the A fragment layout, so P never
// passes through shared memory) and V as the transposed (N-major) B
// operand from shared memory.  O is scaled by alpha and the wgmmas
// accumulate into it.  The least work under this contract is 6 D bf16
// operations per (query, key) pair: 2 D for Q K^T and 2 x 2 D for P V.  At
// Llama-3.2-1B's prefill (q (4, 1024, 32, 64), 67.17 M causal pairs) that
// is 25.8 GFLOP: 26.1 us at 989 TFLOP/s against 12.5 us for the bytes, so
// the kernel is bound by operations; at D 128 52.1 us, at D 160 65.2 us.
// Beside the tensor cores each pair costs an `ex2` (16 a clock an SM) and
// about seven ALU operations (the fma that scales and subtracts the max,
// max, sum, and three to split p), which at D 64 come close to the
// products' time: it is the overlap of the two, not the tensor rate, that
// sets the pace at small heads (PERF.md).
//
// Roles: one block is one (batch, head, 128-row query tile), 288 threads.
// Warp 8 is the producer: one thread issues TMA loads, Q once and each kv
// tile's K and V into a ring of 3 stages (2 where 3 do not fit), each with
// its own mbarrier for K, for V and for the stage's release.  Warpgroups
// 0 and 1 each own 64 query rows.  A thread holds O (D / 2 registers), S
// (BK / 2) and P's two terms (BK / 2); the register file of an SM quarter
// (16 K registers for its 3 warps) caps a thread at 168 registers, and
// `setmaxnreg` did not give the consumers more (the compiler kept them
// within 168 and spilled), so the kv tile is chosen to fit: 64 rows at D
// 128, 32 at D 64 and 160, and P V of tile j - 1 runs behind S of tile j
// (see attn_wgmma_kernel).  Tiles are 4-D TMA boxes over (D, H, T, B), so
// rows past Tk read zeros within their own batch, in the swizzled layout
// both TMA and wgmma read (hopper.cuh): 64 columns with the 128-byte
// swizzle, 32 (D 160, 32) with the 64-byte one, 16 with the 32-byte one.
// Operands off a 16-byte boundary cannot be read by TMA; for them the
// producer warp loads the same layout with plain loads (a variant of the
// kernel, chosen before the launch).  With `causal` the query tiles run
// heaviest first, and a warpgroup skips the kv tiles that lie wholly above
// its own rows.  No atomics: a run is bitwise repeatable.
//
// ---- f32 at D 64, 128, 160: 3xTF32 wgmma fed by TMA (tf::attn_tf32_kernel) ----
//
// f32-accurate products take three TF32 ones (common.cuh): a.b ~
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, in every k8 step of both products.
// The tensor cores read the top 19 bits of a raw f32 operand (they
// truncate: kernel_variants.py's `one_tf32` at the expert GLU), so a raw
// tile is its own hi term and a lo tile holds x - trunc19(x);
// tests/test_torch_tf32x3.py emulates the kernel's two chains on the CPU
// and decided what follows.
//
// (1) TF32 `wgmma` takes no transpose: both shared-memory operands are
// K-major.  S = Q K^T reads Q (rows x D) and K (kv x D) straight from their
// TMA tiles.  V (kv x D) is N-major for P V, so the warpgroup that
// consumes a kv tile writes V^T itself as two K-major tiles: V^T hi (the
// raw bits) and V^T lo, rows of 32 kv in the 128-byte swizzle (of 16 in the
// 64-byte one where kv tiles have 16 rows).  The alternative, O^T = V^T
// P^T with V^T from registers, would send P through shared memory every
// tile and move alpha across threads (the accumulator's rows would be O's
// columns).
// (2) P stays in registers as the A operand.  S's accumulator gives thread
// (g, t) kv columns 2t and 2t + 1 of each 8-column slice, where the TF32 A
// fragment holds columns t and t + 4; V^T holds each 8 kv positions in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (A's k index t stands for kv 2t, t + 4 for
// kv 2t + 1), so P's registers are the fragment as they lie.
// (3) Q is scaled by 1/sqrt(D) once, in place in its tile, with its lo
// tile beside it; each kv tile's K lo is split off with its V^T.  P is
// split into hi (rounded to TF32) and lo in registers.  P V of a tile is
// summed in a fresh accumulator and folded in as O alpha + pv with an f32
// add, 32 of O's columns a pass.  The tensor cores' accumulator truncates
// at every step; summed straight into O the truncations of the whole kv
// walk shrink every output by ~4e-6 of itself at T 1024 (the CPU
// emulation; a fresh accumulator a tile: ~1.5e-6), inside the bucket of
// 3e-5, but the main path's chain (a sort and a top-8 routing behind the
// attention) carried that shift past its oracle's bound on the card.
// (4) Budgets.  A consumer thread holds O (D / 2 registers), the pass's
// accumulator (16), S (BK / 2) and P's two terms (BK): 144 at D 64 with
// kv tiles of 64, 112 at D 128 with 32, 120 at D 160 with 16, within the
// 168 a thread of 288 may have (ptxas spills 76, 20 and 16 bytes).
// Shared memory: Q and its lo tile (2 x 64 x D x 4 B), a ring of K and V
// tiles (2 x BK x D x 4 B a stage) and each consumer warpgroup's K lo,
// V^T hi and V^T lo (3 x BK x D x 4 B): 32 + 3 x 32 + 2 x 48 = 224 KB at
// D 64 (3 stages), 64 + 2 x 32 + 2 x 48 = 224 KB at D 128 (2 stages), of
// the 227 KB a block may use.  At D 160 one stage of 32 kv rows would need
// 80 + 40 + 2 x 60 = 240 KB, so its kv tiles have 16 rows: 80 + 4 x 20 +
// 2 x 30 = 221 KB (4 stages), and warpgroup 1 hands its (m, l, O) (43 KB,
// more than its own 30) through Q and its lo tile once both walks are
// done.  The price is S at N 16: an m64n16k8 reads 2 KB of Q for 512 bytes
// of K, 2.5x the shared-memory bytes an operation of N 64, so a 16-row
// tile's S, P V, split and TMA store move ~250 KB of shared memory a
// warpgroup: ~1950 clocks at 128 bytes a clock against ~960 of tensor
// work (3xTF32): by this count shared memory bounds D 160 (PERF.md).  D
// 16 and 32 (rows narrower than the 128-byte swizzle) and operands off 16
// bytes (TMA cannot read them) stay on the mma.sync kernel.
// (5) The grid.  A block owns one (batch, head, 64-row query tile), and
// its two consumer warpgroups take alternate kv tiles (even, odd), each
// with its own m, l and O; warpgroup 1 then hands (m, l, O) to warpgroup
// 0 through shared memory, which merges them in that fixed order.  At the
// main path (1 x 1024 x 16 x 64, causal) that is 256 blocks, heaviest
// first, whose heaviest walks 1024 kv rows with two warpgroups: ~13 us at
// one SM's share of the TF32 rate, where 128-row blocks (128 of them, one
// wave) would take 27 us in the heaviest.  Blocks run every head's query
// tile together; one kv head's query heads side by side (their K and V
// shared in L2) was slower on the card at D 128 and 160 (PERF.md).
// (6) No atomics and no order that varies: a run is bitwise repeatable.
// (7) Tiles are 4-D TMA boxes of 32 floats over (D, H, T, B)
// (hopper::encode_bthd), so rows past Tq or Tk read zeros within their
// own batch.
//
// Roles: 288 threads.  Warp 8's first thread loads Q once and each kv
// tile's K and V into a ring of stages (an mbarrier each for full and
// empty).  Consumer warpgroup w walks kv tiles w, w + 2, ...: it splits
// the tile's K lo and V^T into its own tiles, runs S, frees the stage,
// runs the online softmax in base 2 (log2(e) applied to S, as the bf16
// kernel does), scales O, splits P and runs P V.
//
// ---- f32 elsewhere: 3xTF32 mma.sync (attn_kernel) ----
//
// Design for the card, not the TPU grid.  The Pallas grid walks kv blocks
// as a sequential grid axis carrying m/l/acc in VMEM scratch; here one
// block owns one (batch, head, 64-row query tile) and loops over 64-row
// kv tiles itself, in the FlashAttention-2 layout: each of its 4 warps
// owns 16 query rows, so S = Q K^T, the softmax and O += P V stay inside
// the warp.  Both products run on the tensor cores as `m16n8k8` TF32
// `mma.sync` in the 3xTF32 split (common.cuh), which keeps f32 accuracy.
// A thread holds two columns of two rows of each S tile, so a row's max
// and sum are two xor-shuffles inside its quad of lanes.
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
// D = 160 (StableLM-12B's head) with an operand off 16 bytes (the rule
// sends aligned ones to tf::attn_tf32_kernel).  The split q (2 x 64 x 164
// x 4 B = 82 KB) and the double-buffered K and V tiles (4 x 64 x 164 x 4
// B = 164 KB) come to 246 KB, over the 227 KB a block may have.  There q is
// kept once, scaled, as f32 (41 KB; 205 KB in all) and each `ldmatrix`
// fragment is split into hi and lo in registers: the same bits as the
// stored split, for 12 more integer and float operations per 8-deep step
// of 24 products.  O's accumulator grows to 20 n8 tiles a warp; P V is
// then summed in two passes of 10 tiles each, so the fresh accumulator
// `pv` holds 40 registers rather than 80.  Each output tile's sum over kv
// runs in the same order in either pass, so the result is the one-pass
// result, bit for bit.
//
// Bound of both f32 designs: at the main-path shape (1 x 1024 x 16 x 64,
// causal) the work is 2.15 GFLOP of products against ~17 MB of traffic;
// f32-accurate products cost three TF32 ones: 3 x 2.15 GFLOP / 495
// TFLOP/s = 13 us on the tensor cores, against 5 us for the bytes, so
// the kernels are bound by operations.
#include <cmath>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // kv rows per tile
constexpr int NT = 128;       // 4 warps
constexpr int SJ = BK / 8;    // n8 tiles of S per warp
constexpr float NEG_INF = -1e30f;

constexpr int VEC = 4;        // floats a 16-byte chunk

template <int D>
struct Layout {
  static constexpr int QS = D + 4;    // row stride of the Q hi / lo tiles
  static constexpr int KS = D + VEC;  // row stride of the K and V tiles
  static constexpr size_t KV_BYTES = sizeof(float) * BK * KS;   // one tile
  // q as its split (hi and lo tiles), or as one f32 tile split at each
  // fragment load where the split does not fit beside 2 x (K, V)
  static constexpr bool Q_SPLIT =
      2 * sizeof(uint32_t) * BQ * QS + 4 * KV_BYTES <= 232448;
  static constexpr size_t Q_BYTES =
      (Q_SPLIT ? 2 : 1) * sizeof(uint32_t) * BQ * QS;
  static constexpr size_t SMEM = Q_BYTES + 4 * KV_BYTES;    // 2 x (K, V)
  static_assert(SMEM <= 232448, "over the 227 KB of shared memory a block may use");
};

// The TF32 operands of one K or V value: its hi and lo parts.
__device__ __forceinline__ void operand(float x, uint32_t& hi, uint32_t& lo) {
  bident::split_tf32(x, hi, lo);
}

// c += a.b in 3xTF32
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  bident::mma_tf32(c, al, bh);
  bident::mma_tf32(c, ah, bl);
  bident::mma_tf32(c, ah, bh);
}

template <int D, bool ASYNC>
__global__ void __launch_bounds__(NT)
    attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int B,
                int Tq, int Tk, int Hq, int Hk, int causal, int q_offset,
                float scale) {
  using L = Layout<D>;
  constexpr int QS = L::QS, KS = L::KS;
  constexpr int DJ = D / 8;   // n8 tiles of O per warp
  // n8 tiles of O per pass of P V (two passes above 16 tiles)
  constexpr int DH = DJ > 16 ? DJ / 2 : DJ;
  static_assert(DJ % DH == 0, "P V passes must cover O");
  extern __shared__ float4 smem4[];
  // TF32 hi parts of q (without Q_SPLIT: q itself, scaled, as f32 bits)
  uint32_t* Qh = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* Ql = Qh + BQ * QS;                         // ... and lo parts
  float* KV =
      reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + L::Q_BYTES);

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
        tq < Tq ? q[((size_t)(b * Tq + tq) * Hq + h) * D + c] * scale : 0.f;
    if constexpr (L::Q_SPLIT)
      bident::split_tf32(qv, Qh[r * QS + c], Ql[r * QS + c]);
    else
      Qh[r * QS + c] = __float_as_uint(qv);
  }

  // K and V of kv tile kt into buffer s (zero past Tk)
  auto load_tile = [&](int kt, int s) {
    float* Ks = KV + (2 * s) * BK * KS;
    float* Vs = Ks + BK * KS;
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
    const float* Ks = KV + (2 * (kt & 1)) * BK * KS;
    const float* Vs = Ks + BK * KS;

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
        const float* kr = Ks + (j * 8 + g) * KS + kk * 8 + t;   // B(k, n) = K[n][k]
        uint32_t bh[2], bl[2];
        operand(kr[0], bh[0], bl[0]);
        operand(kr[4], bh[1], bl[1]);
        mma3(s[j], ah, al, bh, bl);
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
        const float* vr = Vs + (j * 8 + 2 * t) * KS + g + d0 * 8;
#pragma unroll
        for (int dj = 0; dj < DH; ++dj) {
          uint32_t bh[2], bl[2];
          operand(vr[dj * 8], bh[0], bl[0]);        // V[8j + 2t][8dj + g]
          operand(vr[KS + dj * 8], bh[1], bl[1]);   // V[8j + 2t + 1][...]
          mma3(pv[dj], ph, pl, bh, bl);
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
    float* out = o + ((size_t)(b * Tq + tq) * Hq + h) * D;
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
        out[dj * 8 + 2 * t + cc] = acc[dj][2 * hr + cc] / lc;
  }
}

template <int D, bool ASYNC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Tq, int Tk, int Hq, int Hk, int causal,
                   int q_offset, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::SMEM;
  cudaError_t err = bident::allow_smem(attn_kernel<D, ASYNC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Tq + BQ - 1) / BQ);
  attn_kernel<D, ASYNC><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), B, Tq, Tk, Hq,
      Hk, causal, q_offset,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_aligned(const void* q, const void* k, const void* v,
                           void* o, int B, int Tq, int Tk, int Hq, int Hk,
                           int causal, int q_offset, cudaStream_t stream) {
  return bident::aligned16(k) && bident::aligned16(v)
             ? launch<D, true>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal,
                               q_offset, stream)
             : launch<D, false>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal,
                                q_offset, stream);
}

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA, warp-specialised
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;        // query rows a block: 64 per consumer warpgroup
constexpr int NT = 288;        // two consumer warpgroups + one producer warp
constexpr int MAX_STAGES = 3;  // K / V tiles in flight, where they fit
constexpr double LOG2E = 1.4426950408889634;

// kv rows a tile.  A consumer thread holds S (BK / 2 registers), P's two
// bf16 terms (BK / 2) and O (D / 2) within the 168 registers a thread of
// this block may have; of the tiles that fit, the fastest on the card
// (kernel_variants.py's kv32 / kv64 / kv128, PERF.md)
__host__ __device__ constexpr int kv_tile(int D) { return D == 128 ? 64 : 32; }

template <int D>
struct Cfg {
  static constexpr int BK = kv_tile(D);
  // columns of a shared-memory sub-tile (the TMA box): 64, else 32, else 16
  static constexpr int CW = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int SW = 2 * CW;   // bytes of a sub-tile row = swizzle
  static constexpr int NSUB = D / CW;
  static constexpr uint32_t Q_SUB = BQ * SW, KV_SUB = BK * SW;
  static constexpr uint32_t Q_BYTES = NSUB * Q_SUB;     // = BQ x D x 2
  static constexpr uint32_t KV_BYTES = NSUB * KV_SUB;   // one K or V tile
  // 1024 bytes of slack to align the tiles, Q and its mbarrier, and per
  // stage K, V and three mbarriers
  static constexpr size_t FIXED = 1024 + Q_BYTES + 8;
  static constexpr size_t PER_STAGE = 2 * KV_BYTES + 24;
  static constexpr int STAGES = FIXED + MAX_STAGES * PER_STAGE <= 232448
                                    ? MAX_STAGES
                                    : MAX_STAGES - 1;
  static constexpr size_t SMEM = FIXED + STAGES * PER_STAGE;
  static_assert(SMEM <= 232448, "over the 227 KB of shared memory a block may use");
  static_assert(STAGES >= 2 && D % 16 == 0 && BK % 16 == 0, "wgmma k16 steps");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The thread-load path (operands not 16-byte aligned): rows t0 .. t0 +
// rows - 1 of head hh of batch b of x (B, T, H, D) into the swizzled
// sub-tiles at dst, rows past T as zeros; by the 32 lanes of one warp.
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, uint32_t sub_bytes,
                                          const __nv_bfloat16* x, int b,
                                          int T, int H, int hh, int t0,
                                          int rows, int lane) {
  using C = Cfg<D>;
  constexpr int CH = D / 8;   // 16-byte chunks a row
  for (int c = lane; c < rows * CH; c += 32) {
    const int r = c / CH, ch = c % CH, tt = t0 + r;
    alignas(16) __nv_bfloat16 e[8];
    const __nv_bfloat16* src = x + ((size_t)(b * T + tt) * H + hh) * D + ch * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = tt < T ? src[i] : __float2bfloat16(0.f);
    uint32_t off = r * C::SW + (ch % (C::CW / 8)) * 16;
    off ^= ((off >> 7) & (C::SW / 16 - 1)) << 4;
    *reinterpret_cast<uint4*>(dst + (ch * 8 / C::CW) * sub_bytes + off) =
        *reinterpret_cast<const uint4*>(e);
  }
  hopper::fence_proxy_async();
  __syncwarp();
}

// O += P V for one kv tile (V's tile at shared address vs): P's hi term,
// then its lo term, each BK / 16 wgmmas of k16
template <int D, int BK>
__device__ __forceinline__ void pv_mma(float (&acc)[D / 2],
                                       uint32_t (&hi)[BK / 16][4],
                                       uint32_t (&lo)[BK / 16][4],
                                       uint32_t vs) {
  using C = Cfg<D>;
  hopper::reg_fence(acc);
  hopper::reg_fence(hi);
  hopper::reg_fence(lo);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    hopper::Wgmma<D>::rs(acc, hi[kk],
                         hopper::make_desc(vs + kk * 16 * C::SW, C::KV_SUB,
                                           8 * C::SW, C::SW));
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    hopper::Wgmma<D>::rs(acc, lo[kk],
                         hopper::make_desc(vs + kk * 16 * C::SW, C::KV_SUB,
                                           8 * C::SW, C::SW));
  hopper::wgmma_commit();
}

// S = Q K^T for one kv tile (K's tile at shared address ks), issued and
// committed: D / 16 wgmmas of k16 over the swizzled sub-tiles of Q and K
template <int D>
__device__ __forceinline__ void s_mma(float (&sc)[Cfg<D>::BK / 2],
                                      uint32_t qs, uint32_t ks) {
  using C = Cfg<D>;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int st = kk * 16 / C::CW;               // sub-tile
    const uint32_t col = (kk * 16 % C::CW) * 2;   // bytes into its rows
    hopper::Wgmma<C::BK>::ss(
        sc, hopper::make_desc(qs + st * C::Q_SUB + col, 16, 8 * C::SW, C::SW),
        hopper::make_desc(ks + st * C::KV_SUB + col, 16, 8 * C::SW, C::SW),
        kk > 0);
  }
  hopper::wgmma_commit();
}

// The online softmax in base 2 of one kv tile's S (kv rows from kbase):
// masked entries (past Tk, or above the diagonal where `mask` says the
// tile reaches it) set to -1e30, the row max taken on S and scaled, then
// p = 2^(S scale_log2 - m) in one fma; sc becomes p, alpha = 2^(m_old -
// m), l (this thread's share) = l alpha + sum p.  Element 4 jn + e of sc:
// row qpos0 + 8 (e / 2), kv column kbase + 8 jn + 2t + e % 2.
template <int BK>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        float scale_log2, bool mask,
                                        int kbase, int qpos0, int Tk,
                                        int causal, int t) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kpos = kbase + (i / 4) * 8 + 2 * t + (i & 1);
      const int qpos = qpos0 + 8 * ((i >> 1) & 1);
      if (kpos >= Tk || (causal && qpos < kpos)) sc[i] = NEG_INF;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    // element i of the row's BK / 4: sc[4 (i / 2) + 2 hr + i % 2]; four
    // partial maxima and sums, then one
    float mx[4], ps[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i] = sc[4 * (i / 2) + 2 * hr + i % 2];
#pragma unroll
    for (int i = 4; i < BK / 4; ++i)
      mx[i % 4] = fmaxf(mx[i % 4], sc[4 * (i / 2) + 2 * hr + i % 2]);
    float mr = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    const float m_new = fmaxf(m[hr], mr * scale_log2);
    alpha[hr] = ex2(m[hr] - m_new);
    m[hr] = m_new;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      float& x = sc[4 * (i / 2) + 2 * hr + i % 2];
      x = ex2(fmaf(x, scale_log2, -m_new));
      ps[i % 4] = i < 4 ? x : ps[i % 4] + x;
    }
    l[hr] = l[hr] * alpha[hr] + ((ps[0] + ps[1]) + (ps[2] + ps[3]));
  }
}

// P as hi = bf16(p) and lo = bf16(p - hi), in wgmma's A layout: k-slice
// kk's register r holds elements 8 kk + 2r and 8 kk + 2r + 1 of sc
template <int BK>
__device__ __forceinline__ void split_p(const float (&sc)[BK / 2],
                                        uint32_t (&hi)[BK / 16][4],
                                        uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
      const __nv_bfloat162 ph = __floats2bfloat162_rn(x0, x1);
      const __nv_bfloat162 pl = __floats2bfloat162_rn(x0 - __low2float(ph),
                                                      x1 - __high2float(ph));
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&ph);
      lo[kk][r] = *reinterpret_cast<const uint32_t*>(&pl);
    }
}

// lane 0 of each warp frees a stage (8 arrivals: the consumer warps)
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// One block owns one (batch, head, 128-row query tile); see the note at
// the head of the file.  Consumer warpgroup w (0 or 1) works on kv tile j
// in this order: S_j = Q K_j^T issued; O = O alpha_{j-1} + P_{j-1} V_{j-1}
// issued behind it; S_j awaited; the softmax of S_j (while P_{j-1} V_{j-1}
// runs); P_{j-1} V_{j-1} awaited and its stage freed; P_j split into its
// two bf16 terms.  Tile 0 (no P V before it) and the last tile's P V are
// peeled off the loop, so that every wgmma in the loop is unconditional
// (else the compiler serialises them).
template <int D, bool TMA>
__global__ void __launch_bounds__(NT, 1)
    attn_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int Tq, int Tk, int Hq,
                      int Hk, int causal, int q_offset, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, SW = C::SW, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* Qs = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* Ks = Qs + C::Q_BYTES;                 // stage s at s x KV_BYTES
  uint8_t* Vs = Ks + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int hk = h / (Hq / Hk);
  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q_offset + q0 + BQ - 1) / BK + 1);
  const int tid = threadIdx.x;
  // warpgroups 0 and 1 consume, warp 8 (role 2) produces; read as
  // warp-uniform (a shuffle) so that the compiler sees each warpgroup's
  // wgmmas as converged
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (role == 2) {
    // ---- producer ----
    const int lane = tid - 256;
    if constexpr (TMA) {
      if (lane != 0) return;
      hopper::mbar_expect_tx(q_full, C::Q_BYTES);
      for (int st = 0; st < C::NSUB; ++st)
        hopper::tma_load_4d(Qs + st * C::Q_SUB, &qmap, q_full, st * C::CW, h,
                            q0, b);
    } else {
      load_rows<D>(Qs, C::Q_SUB, q, b, Tq, Hq, h, q0, BQ, lane);
      if (lane == 0) hopper::mbar_arrive(q_full);
    }
    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES;
      if (j >= STAGES) hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      uint8_t* kd = Ks + s * C::KV_BYTES;
      uint8_t* vd = Vs + s * C::KV_BYTES;
      if constexpr (TMA) {
        hopper::mbar_expect_tx(&k_full[s], C::KV_BYTES);
        for (int st = 0; st < C::NSUB; ++st)
          hopper::tma_load_4d(kd + st * C::KV_SUB, &kmap, &k_full[s],
                              st * C::CW, hk, j * BK, b);
        hopper::mbar_expect_tx(&v_full[s], C::KV_BYTES);
        for (int st = 0; st < C::NSUB; ++st)
          hopper::tma_load_4d(vd + st * C::KV_SUB, &vmap, &v_full[s],
                              st * C::CW, hk, j * BK, b);
      } else {
        load_rows<D>(kd, C::KV_SUB, k, b, Tk, Hk, hk, j * BK, BK, lane);
        if (lane == 0) hopper::mbar_arrive(&k_full[s]);
        load_rows<D>(vd, C::KV_SUB, v, b, Tk, Hk, hk, j * BK, BK, lane);
        if (lane == 0) hopper::mbar_arrive(&v_full[s]);
      }
    }
  } else {
    // ---- consumers ----
    const int w = role;                        // rows w x 64 .. of the tile
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + w * 64 + warp * 16 + g;   // and row0 + 8
    const int qpos0 = q_offset + row0;
    const int qfirst = q_offset + q0 + w * 64;      // the warpgroup's first
    // kv tiles this warpgroup needs (the block's cover the other's rows)
    const int nk_w = causal ? min(nk, (qfirst + 63) / BK + 1) : nk;

    const uint32_t q_addr = hopper::smem_u32(Qs) + w * 64 * SW;
    const uint32_t k_addr = hopper::smem_u32(Ks);
    const uint32_t v_addr = hopper::smem_u32(Vs);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // running max (in units of S scale_log2) and this thread's share of l
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t hi[BK / 16][4], lo[BK / 16][4];   // P of the last tile

    hopper::mbar_wait(q_full, 0);
    // a tile needs the mask where it reaches past Tk or above the diagonal
    auto masked = [&](int j) {
      return (j + 1) * BK > Tk || (causal && (j + 1) * BK - 1 > qfirst);
    };
    {   // kv tile 0: S, softmax, P
      hopper::mbar_wait(&k_full[0], 0);
      float sc[BK / 2];
      s_mma<D>(sc, q_addr, k_addr);
      hopper::wgmma_wait<0>();
      hopper::reg_fence(sc);
      softmax<BK>(sc, m, l, alpha, scale_log2, masked(0), 0, qpos0, Tk,
                  causal, t);
      split_p<BK>(sc, hi, lo);
    }
    for (int j = 1; j < nk_w; ++j) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      hopper::mbar_wait(&k_full[s], (j / STAGES) & 1);
      float sc[BK / 2];
      s_mma<D>(sc, q_addr, k_addr + s * C::KV_BYTES);
      // O = O alpha + P V of tile j - 1, behind S of tile j
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      hopper::mbar_wait(&v_full[sp], ((j - 1) / STAGES) & 1);
      pv_mma<D, BK>(acc, hi, lo, v_addr + sp * C::KV_BYTES);
      hopper::wgmma_wait<1>();          // S of tile j
      hopper::reg_fence(sc);
      softmax<BK>(sc, m, l, alpha, scale_log2, masked(j), j * BK, qpos0, Tk,
                  causal, t);
      hopper::wgmma_wait<0>();          // P V of tile j - 1
      hopper::reg_fence(acc);
      release(&empty[sp], lane);
      split_p<BK>(sc, hi, lo);
    }
    {   // the last tile's P V
      const int s = (nk_w - 1) % STAGES;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      hopper::mbar_wait(&v_full[s], ((nk_w - 1) / STAGES) & 1);
      pv_mma<D, BK>(acc, hi, lo, v_addr + s * C::KV_BYTES);
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
      release(&empty[s], lane);
    }
    // tiles wholly above this warpgroup's rows: free their stages
    for (int j = nk_w; j < nk; ++j) {
      const int s = j % STAGES;
      hopper::mbar_wait(&k_full[s], (j / STAGES) & 1);
      release(&empty[s], lane);
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lq = l[hr];
      lq += __shfl_xor_sync(0xffffffffu, lq, 1);
      lq += __shfl_xor_sync(0xffffffffu, lq, 2);
      const int row = row0 + 8 * hr;
      if (row >= Tq) continue;
      const float lc = fmaxf(lq, 1e-30f);
      __nv_bfloat16* out = o + ((size_t)(b * Tq + row) * Hq + h) * D + 2 * t;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * jn) =
            __floats2bfloat162_rn(acc[4 * jn + 2 * hr] / lc,
                                  acc[4 * jn + 2 * hr + 1] / lc);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Tq, int Tk, int Hq, int Hk, int causal,
                   int q_offset, cudaStream_t stream) {
  using C = Cfg<D>;
  // TMA reads from 16-byte aligned bases; other operands take plain loads
  const bool tma = bident::aligned16(q) && bident::aligned16(k) &&
                   bident::aligned16(v);
  CUtensorMap qm{}, km{}, vm{};
  if (tma && !(hopper::encode_bthd(&qm, q, B, Tq, Hq, D, C::CW, BQ) &&
               hopper::encode_bthd(&km, k, B, Tk, Hk, D, C::CW, C::BK) &&
               hopper::encode_bthd(&vm, v, B, Tk, Hk, D, C::CW, C::BK)))
    return cudaErrorInvalidValue;
  const auto kernel =
      tma ? attn_wgmma_kernel<D, true> : attn_wgmma_kernel<D, false>;
  cudaError_t err = bident::allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Tq + BQ - 1) / BQ);
  kernel<<<grid, NT, C::SMEM, stream>>>(
      qm, km, vm, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Tq, Tk, Hq, Hk, causal, q_offset,
      static_cast<float>(LOG2E / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int Tq, int Tk, int Hq, int Hk,
                     int causal, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 32: return launch<32>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 64: return launch<64>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 128: return launch<128>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 160: return launch<160>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32 at D 64 and 128: 3xTF32 wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

namespace tf {

constexpr int BQ = 64;         // query rows a block, both warpgroups' rows
constexpr int NT = 288;        // two consumer warpgroups + one producer warp
constexpr int RING = 4;        // K / V stages in flight: the most that fit, up to this
constexpr double LOG2E = 1.4426950408889634;

// kv rows a tile (flash_attention.f32_kv_tile in the Python module): a
// consumer thread holds O (D / 2 registers), P V's accumulator, S (BK / 2)
// and P's two TF32 terms (BK), and each warpgroup's K lo and V^T tiles
// fit beside the ring (at D 160 only with 16 rows: note (4))
__host__ __device__ constexpr int kv_tile(int D) { return D == 160 ? 16 : D == 128 ? 32 : 64; }

// the deepest ring of at most RING stages that fits beside `fixed` bytes
constexpr int ring_stages(size_t fixed, size_t per_stage) {
  int s = RING;
  while (s > 2 && fixed + s * per_stage > 232448) --s;
  return s;
}

template <int D>
struct Cfg {
  static constexpr int BK = kv_tile(D);
  // O's columns a P V pass: its fresh accumulator takes DH / 2 registers
  // (32 columns: the fewest spills, and the fastest on the card)
  static constexpr int DH = 32;
  static constexpr int NSUB = D / 32;                // 32-float sub-tiles of a row
  static constexpr uint32_t Q_SUB = BQ * 128, KV_SUB = BK * 128;
  static constexpr uint32_t Q_BYTES = NSUB * Q_SUB;      // = BQ x D x 4
  static constexpr uint32_t KV_BYTES = NSUB * KV_SUB;    // one K or V tile
  // V^T: D rows of BK kv, as sub-tiles of VT_W kv whose rows of VT_SW
  // bytes take the VT_SW-byte swizzle (32 kv and 128 bytes; 16 and 64 at
  // BK 16)
  static constexpr int VT_W = BK < 32 ? BK : 32;
  static constexpr int VT_SW = 4 * VT_W;
  static constexpr uint32_t VT_SUB = D * VT_SW;
  static constexpr uint32_t VT_BYTES = BK / VT_W * VT_SUB;   // = KV_BYTES
  // a consumer warpgroup's own tiles: K lo, V^T hi, V^T lo
  static constexpr uint32_t WG_BYTES = KV_BYTES + 2 * VT_BYTES;
  // warpgroup 1 hands O, m and l to warpgroup 0 through its own tiles or,
  // where they are too small (D 160), through Q and its lo tile
  static constexpr uint32_t HAND_BYTES = 4 * 128 * (D / 2 + 4);
  static constexpr bool HAND_IN_Q = WG_BYTES < HAND_BYTES;
  // 1024 bytes of slack to align the tiles; Q, its lo tile, the two
  // warpgroups' tiles and Q's mbarrier; per stage K, V and two mbarriers
  static constexpr size_t FIXED = 1024 + 2 * Q_BYTES + 2 * WG_BYTES + 8;
  static constexpr size_t PER_STAGE = 2 * KV_BYTES + 16;
  static constexpr int STAGES = ring_stages(FIXED, PER_STAGE);
  static constexpr size_t SMEM = FIXED + STAGES * PER_STAGE;
  static_assert(SMEM <= 232448, "over the 227 KB of shared memory a block may use");
  static_assert(D % 32 == 0 && BK % 16 == 0 && BK % VT_W == 0,
                "128-byte rows of 32 floats; V^T rows of 64 or 128 bytes");
  static_assert((HAND_IN_Q ? 2 * Q_BYTES : WG_BYTES) >= HAND_BYTES,
                "the merge's buffer");
};

using hopper::swz;

// x - (what the tensor cores read of x: its top 19 bits), exactly
__device__ __forceinline__ float lo19(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
__device__ __forceinline__ float4 lo19(float4 x) {
  return make_float4(lo19(x.x), lo19(x.y), lo19(x.z), lo19(x.w));
}

// A landed kv tile's K lo tile and V^T's two tiles, by the 128 threads of
// the warpgroup that consumes it (thread i).  V^T (D rows of BK kv, K-major
// for P V, in sub-tiles of VT_W kv) holds each 8 kv positions in the order
// 0, 2, 4, 6, 1, 3, 5, 7, so that A's k index t stands for kv 2t and t + 4
// for kv 2t + 1 (P's registers as S's accumulator left them).  A warp reads
// one kv row of 32 consecutive d and writes 32 rows of V^T: both spread
// over all banks (in either swizzle).
template <int D>
__device__ __forceinline__ void split_tile(const uint8_t* ks, const uint8_t* vs,
                                           uint8_t* klo, uint8_t* vth,
                                           uint8_t* vtl, int i) {
  using C = Cfg<D>;
#pragma unroll
  for (int e = i; e < C::KV_BYTES / 16; e += 128)
    reinterpret_cast<float4*>(klo)[e] =
        lo19(reinterpret_cast<const float4*>(ks)[e]);
#pragma unroll
  for (int e = i; e < D * C::BK / 8; e += 128) {
    const int d = e % D, kv0 = e / D * 8;   // 8 kv rows from kv0, column d
    const uint8_t* src = vs + d / 32 * C::KV_SUB;
    float x[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      x[r] = *reinterpret_cast<const float*>(src + swz(kv0 + r, d % 32));
    const float4 even = make_float4(x[0], x[2], x[4], x[6]);
    const float4 odd = make_float4(x[1], x[3], x[5], x[7]);
    const uint32_t off = kv0 / C::VT_W * C::VT_SUB;
    const uint32_t a0 = off + swz<C::VT_SW>(d, kv0 % C::VT_W);
    const uint32_t a4 = off + swz<C::VT_SW>(d, kv0 % C::VT_W + 4);
    *reinterpret_cast<float4*>(vth + a0) = even;
    *reinterpret_cast<float4*>(vth + a4) = odd;
    *reinterpret_cast<float4*>(vtl + a0) = lo19(even);
    *reinterpret_cast<float4*>(vtl + a4) = lo19(odd);
  }
}

// S = Q K^T for one kv tile, issued and committed: per k8 step Q_lo.K,
// Q.K_lo, Q.K (raw tiles are their own hi terms)
template <int D>
__device__ __forceinline__ void s_mma(float (&sc)[Cfg<D>::BK / 2], uint32_t qs,
                                      uint32_t ql, uint32_t ks, uint32_t kl) {
  using C = Cfg<D>;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t qo = kk / 4 * C::Q_SUB + kk % 4 * 32;
    const uint32_t ko = kk / 4 * C::KV_SUB + kk % 4 * 32;
    const uint64_t dq = hopper::make_desc(qs + qo, 16, 1024, 128);
    const uint64_t dk = hopper::make_desc(ks + ko, 16, 1024, 128);
    hopper::WgmmaTf32<C::BK>::ss(sc, hopper::make_desc(ql + qo, 16, 1024, 128),
                                 dk, kk > 0);
    hopper::WgmmaTf32<C::BK>::ss(sc, dq, hopper::make_desc(kl + ko, 16, 1024, 128), 1);
    hopper::WgmmaTf32<C::BK>::ss(sc, dq, dk, 1);
  }
  hopper::wgmma_commit();
}

// pv = P V over DH of O's columns (V^T's rows from vth / vtl) for one kv
// tile, in a fresh accumulator, issued and committed: per k8 step
// P_lo.V^T, P_hi.V^T_lo, P_hi.V^T (V^T's raw tile is its hi term)
template <int D, int DH, int BK>
__device__ __forceinline__ void pv_mma(float (&pv)[DH / 2],
                                       uint32_t (&hi)[BK / 8][4],
                                       uint32_t (&lo)[BK / 8][4],
                                       uint32_t vth, uint32_t vtl) {
  using C = Cfg<D>;
  hopper::reg_fence(hi);
  hopper::reg_fence(lo);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint32_t off = kk / (C::VT_W / 8) * C::VT_SUB + kk % (C::VT_W / 8) * 32;
    const uint64_t dh = hopper::make_desc(vth + off, 16, 8 * C::VT_SW, C::VT_SW);
    hopper::WgmmaTf32<DH>::rs(pv, lo[kk], dh, kk > 0);
    hopper::WgmmaTf32<DH>::rs(pv, hi[kk], hopper::make_desc(vtl + off, 16, 8 * C::VT_SW, C::VT_SW), 1);
    hopper::WgmmaTf32<DH>::rs(pv, hi[kk], dh, 1);
  }
  hopper::wgmma_commit();
}

// One block owns one (batch, head, 64-row query tile); see the note at
// the head of the file.  Consumer warpgroup w walks kv tiles w, w + 2, ...
// with its own m, l and O: each tile landed, its K lo and V^T split off,
// S, its stage freed, the online softmax in base 2, O scaled by alpha, P
// split into TF32 hi and lo, P V into O.  Warpgroup 1 then hands (m, l, O)
// to warpgroup 0, which merges and writes the tile.
template <int D>
__global__ void __launch_bounds__(NT, 1)
    attn_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     float* __restrict__ o, int Tq, int Tk, int Hq, int Hk,
                     int causal, int q_offset, float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, DH = C::DH, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* Qs = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* Ql = Qs + C::Q_BYTES;
  uint8_t* Wt = Ql + C::Q_BYTES;               // warpgroup w's at w x WG_BYTES
  uint8_t* Ks = Wt + 2 * C::WG_BYTES;          // stage s at s x KV_BYTES
  uint8_t* Vs = Ks + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * C::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int hk = h / (Hq / Hk);
  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q_offset + q0 + BQ - 1) / BK + 1);
  const int tid = threadIdx.x;
  // warpgroups 0 and 1 consume, warp 8 (role 2) produces; warp-uniform
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);   // the 4 warps of the tile's warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (role == 2) {
    // ---- producer: one thread keeps the ring's TMA loads in flight ----
    if (tid != 256) return;
    hopper::mbar_expect_tx(q_full, C::Q_BYTES);
    for (int st = 0; st < C::NSUB; ++st)
      hopper::tma_load_4d(Qs + st * C::Q_SUB, &qmap, q_full, st * 32, h, q0, b);
    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES;
      if (j >= STAGES) hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      hopper::mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
      for (int st = 0; st < C::NSUB; ++st) {
        hopper::tma_load_4d(Ks + s * C::KV_BYTES + st * C::KV_SUB, &kmap,
                            &full[s], st * 32, hk, j * BK, b);
        hopper::tma_load_4d(Vs + s * C::KV_BYTES + st * C::KV_SUB, &vmap,
                            &full[s], st * 32, hk, j * BK, b);
      }
    }
    return;
  }

  // ---- consumers ----
  const int w = role, i = tid % 128;
  const int warp = i / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;            // and row0 + 8
  const int qpos0 = q_offset + row0;
  uint8_t* Klo = Wt + w * C::WG_BYTES;
  uint8_t* Vth = Klo + C::KV_BYTES;
  uint8_t* Vtl = Vth + C::VT_BYTES;

  // q scaled by 1/sqrt(D) in place, and its lo tile, by both warpgroups
  hopper::mbar_wait(q_full, 0);
  for (int e = tid; e < C::Q_BYTES / 16; e += 256) {
    float4 x = reinterpret_cast<float4*>(Qs)[e];
    x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    reinterpret_cast<float4*>(Qs)[e] = x;
    reinterpret_cast<float4*>(Ql)[e] = lo19(x);
  }
  hopper::fence_proxy_async();
  hopper::named_bar_sync(1, 256);

  const uint32_t qs = hopper::smem_u32(Qs), ql = hopper::smem_u32(Ql);
  const uint32_t kl = hopper::smem_u32(Klo);
  const uint32_t vth = hopper::smem_u32(Vth), vtl = hopper::smem_u32(Vtl);
  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  // running max (in units of S log2(e)) and this thread's share of l
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  const float log2e = static_cast<float>(LOG2E);
  for (int j = w; j < nk; j += 2) {
    const int s = j % STAGES;
    const uint8_t* ks = Ks + s * C::KV_BYTES;
    // this warpgroup's last P V has finished reading its tiles
    hopper::named_bar_sync(2 + w, 128);
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);
    split_tile<D>(ks, Vs + s * C::KV_BYTES, Klo, Vth, Vtl, i);
    hopper::fence_proxy_async();
    hopper::named_bar_sync(2 + w, 128);
    float sc[BK / 2];
    s_mma<D>(sc, qs, ql, hopper::smem_u32(ks), kl);
    hopper::wgmma_wait<0>();
    hopper::reg_fence(sc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);   // K and V read
    const bool masked = (j + 1) * BK > Tk ||
                        (causal && (j + 1) * BK - 1 > q_offset + q0);
    wg::softmax<BK>(sc, m, l, alpha, log2e, masked, j * BK, qpos0, Tk,
                    causal, t);
    // P in the A fragment of k8 step kk: (g, kv 2t), (g + 8, kv 2t),
    // (g, kv 2t + 1), (g + 8, kv 2t + 1) of kv slice kk
    uint32_t hi[BK / 8][4], lo[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      bident::split_tf32(sc[4 * kk], hi[kk][0], lo[kk][0]);
      bident::split_tf32(sc[4 * kk + 2], hi[kk][1], lo[kk][1]);
      bident::split_tf32(sc[4 * kk + 1], hi[kk][2], lo[kk][2]);
      bident::split_tf32(sc[4 * kk + 3], hi[kk][3], lo[kk][3]);
    }
    // O = O alpha + P V with an f32 add, DH columns a pass
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += DH) {
      float pv[DH / 2];
      pv_mma<D, DH, BK>(pv, hi, lo, vth + c0 * C::VT_SW, vtl + c0 * C::VT_SW);
      hopper::wgmma_wait<0>();
      hopper::reg_fence(pv);
#pragma unroll
      for (int x = 0; x < DH / 2; ++x)
        acc[c0 / 2 + x] = acc[c0 / 2 + x] * alpha[(x >> 1) & 1] + pv[x];
    }
  }
  // l of each row over its quad
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }

  // warpgroup 1 hands (O, m, l) to warpgroup 0, element x of thread i at
  // x x 128 + i, through its own tiles or (HAND_IN_Q) through Q and its lo
  // tile once both walks are done (warpgroup 0's last S has read them);
  // warpgroup 0 merges them
  float* hand = reinterpret_cast<float*>(C::HAND_IN_Q ? Qs : Wt + C::WG_BYTES);
  if constexpr (C::HAND_IN_Q) hopper::named_bar_sync(1, 256);
  if (w == 1) {
    // every P V of warpgroup 1 is done
    if constexpr (!C::HAND_IN_Q) hopper::named_bar_sync(3, 128);
#pragma unroll
    for (int x = 0; x < D / 2; ++x) hand[x * 128 + i] = acc[x];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      hand[(D / 2 + hr) * 128 + i] = m[hr];
      hand[(D / 2 + 2 + hr) * 128 + i] = l[hr];
    }
    hopper::named_bar_sync(1, 256);
    return;
  }
  hopper::named_bar_sync(1, 256);
  float a0[2], a1[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float m1 = hand[(D / 2 + hr) * 128 + i];
    const float l1 = hand[(D / 2 + 2 + hr) * 128 + i];
    const float mm = fmaxf(m[hr], m1);
    a0[hr] = wg::ex2(m[hr] - mm);
    a1[hr] = wg::ex2(m1 - mm);
    l[hr] = l[hr] * a0[hr] + l1 * a1[hr];
  }
#pragma unroll
  for (int x = 0; x < D / 2; ++x)
    acc[x] = acc[x] * a0[(x >> 1) & 1] + hand[x * 128 + i] * a1[(x >> 1) & 1];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row >= Tq) continue;
    const float lc = fmaxf(l[hr], 1e-30f);
    float* out = o + ((size_t)(b * Tq + row) * Hq + h) * D + 2 * t;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      *reinterpret_cast<float2*>(out + 8 * jn) =
          make_float2(acc[4 * jn + 2 * hr] / lc, acc[4 * jn + 2 * hr + 1] / lc);
  }
}

// The f32 route's rule, decided before the launch: this kernel where it is
// instantiated (D 64, 128, 160) and TMA reads q, k and v (16-byte aligned
// bases; o is written by plain stores); the mma.sync attn_kernel elsewhere.
inline bool tma_route(const void* q, const void* k, const void* v, int D) {
  return (D == 64 || D == 128 || D == 160) && bident::aligned16(q) &&
         bident::aligned16(k) && bident::aligned16(v);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Tq, int Tk, int Hq, int Hk, int causal,
                   int q_offset, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qm{}, km{}, vm{};
  if (!(hopper::encode_bthd(&qm, q, B, Tq, Hq, D, 32, BQ, 4) &&
        hopper::encode_bthd(&km, k, B, Tk, Hk, D, 32, C::BK, 4) &&
        hopper::encode_bthd(&vm, v, B, Tk, Hk, D, 32, C::BK, 4)))
    return cudaErrorInvalidValue;
  cudaError_t err = bident::allow_smem(attn_tf32_kernel<D>, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Tq + BQ - 1) / BQ);
  attn_tf32_kernel<D><<<grid, NT, C::SMEM, stream>>>(
      qm, km, vm, static_cast<float*>(o), Tq, Tk, Hq, Hk, causal, q_offset,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int Tq, int Tk, int Hq, int Hk,
                     int causal, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<64>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 128: return launch<128>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 160: return launch<160>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tf

// f32 on the mma.sync kernel (attn_kernel)
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int Tq, int Tk, int Hq, int Hk,
                     int causal, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_aligned<16>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 32: return launch_aligned<32>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 64: return launch_aligned<64>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 128: return launch_aligned<128>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
    case 160: return launch_aligned<160>(q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, stream);
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
  if (bf16)
    return wg::dispatch(D, q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, s);
  // f32: TF32 wgmma where the rule says TMA reads every operand at an
  // instantiated D, else the mma.sync kernel (never on error)
  if (tf::tma_route(q, k, v, D))
    return tf::dispatch(D, q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, s);
  return dispatch(D, q, k, v, o, B, Tq, Tk, Hq, Hk, causal, q_offset, s);
}
