// Tensor-core and asynchronous-copy helpers of the port's Hopper kernels:
// warp-level mma.sync (TF32 m16n8k8, and bf16 or f16 m16n8k16, f32
// accumulators), the TF32 hi/lo split that keeps f32 accuracy through three
// TF32 products and the two-term 16-bit splits,
// ldmatrix fragment loads for 16-bit tiles, and cp.async 16- and 4-byte
// copies with zero-fill. Fragment layouts (PTX ISA, "Matrix fragments for
// mma.m16n8k8 / m16n8k16"), with g = lane / 4 and t = lane % 4:
//   tf32 A (16x8):  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   tf32 B (8x8):   b0 (k=t, n=g), b1 (k=t+4, n=g)
//   16-bit A (16x16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..)
//   16-bit B (16x8):  b0 (k=2t..2t+1, n=g), b1 (k=2t+8.., n=g)
//   C/D (16x8):     c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dl4j {

// x rounded to TF32 (10 mantissa bits, round to nearest, ties away from
// zero: cvt.rna.tf32.f32's rounding), as the f32 bit pattern with its low
// 13 bits zero. Written as two integer operations on the bits (half of the
// dropped 13 bits added to the magnitude, then cleared; a carry moves into
// the exponent as it should): ptxas expands cvt.rna.tf32.f32 into a
// compare-and-branch sequence per value on sm_90a. The operands here are
// finite; inf stays inf.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both TF32. The split must round: the tensor
// core drops the low 13 bits itself, which would leave lo wrong.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a·b, m16n8k8, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b with f32 accuracy from three TF32 products (a_lo·b_lo, about
// 2^-22 of the product, is dropped): the small terms first.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// d += a·b, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (lo, hi) as two bf16x2 registers, lo in the low half (the lower column):
// x = first + second + O(2^-17 |x|), the second term carrying what the
// first one's rounding dropped.
__device__ __forceinline__ void split_bf16x2(float lo, float hi,
                                             uint32_t& first,
                                             uint32_t& second) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 back = __bfloat1622float2(h);
  __nv_bfloat162 r = __floats2bfloat162_rn(lo - back.x, hi - back.y);
  first = *reinterpret_cast<uint32_t*>(&h);
  second = *reinterpret_cast<uint32_t*>(&r);
}

// d += a·b, m16n8k16, f16 operands, f32 accumulators.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// split_bf16x2's f16 twin: x = first + second + O(2^-22 |x|) for normal
// f16 values (terms under 2^-14 keep fewer bits as f16 subnormals).
__device__ __forceinline__ void split_f16x2(float lo, float hi,
                                            uint32_t& first,
                                            uint32_t& second) {
  __half2 h = __floats2half2_rn(lo, hi);
  const float2 back = __half22float2(h);
  __half2 r = __floats2half2_rn(lo - back.x, hi - back.y);
  first = *reinterpret_cast<uint32_t*>(&h);
  second = *reinterpret_cast<uint32_t*>(&r);
}

// The m16n8k16 product and the two-term split by 16-bit element type, for
// tile code written once for bf16 and f16.
template <typename T16>
struct Mma16;
template <>
struct Mma16<__nv_bfloat16> {
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
    mma_bf16(d, a, b);
  }
  __device__ static void split(float lo, float hi, uint32_t& first,
                               uint32_t& second) {
    split_bf16x2(lo, hi, first, second);
  }
};
template <>
struct Mma16<__half> {
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
    mma_f16(d, a, b);
  }
  __device__ static void split(float lo, float hi, uint32_t& first,
                               uint32_t& second) {
    split_f16x2(lo, hi, first, second);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses (16 bytes each, 16-byte aligned) of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: a k-major [k][n] tile gives B
// fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without staging in registers; with `pred`
// false nothing is read and the 16 bytes are zero-filled (src must still be
// a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes, zero-filled when `pred` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace dl4j
