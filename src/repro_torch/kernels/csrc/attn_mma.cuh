// Tensor-core attention helpers shared by the bf16 flash kernel
// (flash_attention.cu, wgmma) and the bf16 paged prefill kernel
// (paged_prefill.cu, mma.sync).
//
// Both kernels keep scores in the accumulator layout of the tensor-core
// product: thread `lane` of a warp holds rows lane/4 and lane/4 + 8 of the
// warp's 16-row slice, two adjacent columns per 8-column chunk.  A row's
// values therefore sit in the four threads of one quad, and its max and
// sum are two shuffles.  The same registers are, chunk pair by chunk pair,
// the A operand of the next product (P·V), so probabilities never go
// through shared memory.
//
// P is carried as two bf16 terms, P = hi + lo with hi = bf16(p) and
// lo = bf16(p − hi), so P·V keeps ~16 bits of p (the plain version keeps
// 24): the products are exact and sum in f32, so the kernel's f32 result
// differs from the plain version's by far less than half a bf16 ulp and
// both round to within one ulp of each other.  A single bf16 P would add
// a relative error of up to 2⁻⁹ per key, which breaks the one-ulp gate on
// outputs near zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

// log2(e): scores are scaled into the exp2 domain once, in f32
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_elem, float hi_elem) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_elem, hi_elem);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p = (x, y) as hi + lo, each a packed bf16 pair (x in the low half)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// 2^x by the SFU (max relative error 2^-22; results below 2^-126 flush to
// 0, negligible beside a row's largest term, which is 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step of one row: `mx` the tile's (masked, scaled)
// row max, `m` the running max.  Returns the rescale factor of the old
// state and sets `m_use`, the max to subtract (0 while the row has seen
// no live key, so exp2(−inf − m_use) = 0 and nothing is NaN).
__device__ __forceinline__ float online_step(float mx, float& m,
                                             float& m_use) {
  const float m_new = fmaxf(m, mx);
  m_use = m_new == -INFINITY ? 0.f : m_new;
  const float alpha = exp2f(m - m_use);   // m = −inf → 0
  m = m_new;
  return alpha;
}

// ---------------------------------------------------------------------------
// warp-level tensor-core product and its operand loads (Ampere and later)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d (16×8, f32) += a (16×16, bf16, row) · b (16×8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global → shared, L2 only; src_bytes 0 writes 16 zero bytes and
// reads nothing
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace attn
