// Shared pieces of the port's attention kernels: the masked score, and the
// tile geometry, warp reductions and CUDA-core tile helpers of K2's chunk
// route.
#pragma once

#include <cuda_runtime.h>

namespace dl4j {

// Masked scores, as in the JAX package: -1e30 rather than -inf keeps a row
// whose keys are all masked finite (uniform weights instead of 0/0).
constexpr float kNegInf = -1e30f;

// One CTA = 4 warps; each warp owns R query rows of the CTA's 4·R-row tile
// (R = kRows = 8 unless a kernel picks fewer), and each lane owns one key of
// the 32-key tile staged in shared memory.
constexpr int kWarps = 4;
constexpr int kRows = 8;
constexpr int kBlockK = 32;
constexpr int kThreads = kWarps * 32;

// f32 words of dynamic shared memory: q tile [4·R][D], K tile [kBlockK][D+1]
// (padded: lane j reads row j, so rows must not share a bank), V tile
// [kBlockK][D], key-validity row [kBlockK].
__host__ __device__ constexpr int smem_words(int D, int R) {
  return kWarps * R * D + kBlockK * (D + 1) + kBlockK * D + kBlockK;
}

// -inf: the score of a key that does not exist, so exp() gives exactly 0
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One online-softmax step for R query rows against the staged key tile.
// s[r] is lane j's score for row r and key j: kNegInf where masked, -inf
// where key j does not exist (past the sequence or the causal walk), so it
// contributes exactly nothing. acc[r][c] holds output column lane + 32*c.
template <int R, int D>
__device__ __forceinline__ void online_softmax_tile(
    const float (&s)[R], const float* __restrict__ vs, float (&m)[R],
    float (&l)[R], float (&acc)[R][D / 32], int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float m_new = fmaxf(m[r], warp_max(s[r]));
    const float p = expf(s[r] - m_new);
    const float alpha = expf(m[r] - m_new);
    l[r] = l[r] * alpha + warp_sum(p);
    m[r] = m_new;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[r][c] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[r][c] += pj * vs[j * D + lane + 32 * c];
    }
  }
}

// Scores of R query rows (staged pre-scaled in qs, starting at row0)
// against key `lane` of the staged K tile.
template <int R, int D>
__device__ __forceinline__ void tile_scores(const float* __restrict__ qs,
                                            const float* __restrict__ ks,
                                            int row0, int lane,
                                            float (&s)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    const float kc = ks[lane * (D + 1) + c];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] += qs[(row0 + r) * D + c] * kc;
  }
}

}  // namespace dl4j
