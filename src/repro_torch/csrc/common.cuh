// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel reads f32 or bf16 operands, sums in f32, reduces in a
// fixed order (no atomics, no split reduction, so a run is bitwise
// reproducible) and writes in the operand dtype.
//
// Products.  Every kernel (expert_glu, flash_attention, ssd_scan) runs
// its products on the tensor cores with `mma.sync`.  One TF32 product
// keeps 11 significant bits of each operand, about 3e-4 of the largest
// output at the main path's K, which the f32 bucket of 3e-5 does not
// hold.  They use the 3xTF32 split instead: a = a_hi + a_lo with
// a_hi = tf32(a), a_lo = a - a_hi (to TF32), and a.b ~ a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi (the lo.lo term, ~2^-22 of the product, is
// dropped), which keeps f32 accuracy (tests/test_torch_tf32x3.py emulates
// both).  A bf16 value is exact in TF32, so its lo part is zero and its
// products drop.  The tensor cores' f32 accumulator truncates at every
// `mma` (on the card one chain over K = 1024 drifts to 1.7e-5 of the
// largest output, PERF.md), so each kernel sums a bounded stretch of K in
// a fresh accumulator and adds it to the running sum with an f32 add
// (round to nearest).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bident {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Opt the kernel into `bytes` of dynamic shared memory (above 48 KB the
// launch is refused without it).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// tensor cores
// ---------------------------------------------------------------------------

// The 3xTF32 split: x = hi + lo to ~2^-22 of x.  hi is x rounded to TF32
// (nearest, ties away from zero, as `cvt.rna.tf32.f32`, but in two integer
// operations: add half a TF32 ulp to the bits, clear the 13 low ones); lo
// = x - hi exactly, passed as f32, of which the tensor cores read the top
// 19 bits.  On the card this gives the errors of two `cvt.rna` (which
// compile to a longer compare-and-select sequence) in 15-30% less time
// (PERF.md).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a.b on one 16x8x8 TF32 tile (f32 accumulator).  Fragments, with
// g = lane / 4 and t = lane % 4: a {(g,t), (g+8,t), (g,t+4), (g+8,t+4)},
// b {(t,g), (t+4,g)} as (k, n), c {(g,2t), (g,2t+1), (g+8,2t), (g+8,2t+1)}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b on one 16x8x16 bf16 tile (f32 accumulator).  Each register
// holds two bf16 of consecutive k, the lower k in the low half: a
// {(g,2t), (g+8,2t), (g,2t+8), (g+8,2t+8)}, b {(2t,g), (2t+8,g)}; c as
// for TF32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 tiles of 16-bit elements from shared memory; lane l gives the
// address of row l % 8 of tile l / 8, and receives in r[i] elements
// (l / 4, 2 (l % 4) .. +1) of tile i (with TRANS, of its transpose).
// A 32-bit element counts as two 16-bit ones, so for TF32 lane (g, t)
// receives element (g, t) of four 8 x 4 tiles.
template <bool TRANS = false>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s)
        : "memory");
}

// ---------------------------------------------------------------------------
// asynchronous copies into shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One 16-byte chunk (16 / sizeof(T) elements) from device memory into
// shared memory, elements from n_valid on set to zero.  ASYNC: a
// `cp.async` (n_valid is 0 or the whole chunk, src 16-byte aligned; a
// chunk with nothing valid reads nothing and is zero-filled).  Otherwise
// plain loads and one 16-byte store, for rows that are not aligned.
template <bool ASYNC, typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src,
                                           int n_valid) {
  constexpr int VEC = 16 / sizeof(T);
  if constexpr (ASYNC) {
    const uint32_t s =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
                 "l"(src), "r"(n_valid > 0 ? 16 : 0)
                 : "memory");
  } else {
    alignas(16) T e[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      e[i] = i < n_valid ? src[i] : from_f32<T>(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(e);
  }
}

}  // namespace bident
