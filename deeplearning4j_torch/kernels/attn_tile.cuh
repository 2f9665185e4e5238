// Tile helpers shared by the port's tensor-core attention kernels, K1
// (flash_fwd.cu) and K3/K4 (flash_bwd.cu): warp-level products of a 16-row
// A operand (held as mma A fragments) with a tile staged in shared memory,
// A fragments from device or shared memory, the cp.async staging of a ring
// stage, and the epilogue store of an accumulator row.
//
// Every product keeps f32 accumulators. f32 runs m16n8k8 TF32 with each
// operand split into hi + lo and three products (mma_tf32x3); bf16 runs
// m16n8k16, with an accumulator operand (P, dS) in two bf16 terms.
// Fragment layouts are listed in mma.cuh; g = lane / 4, t = lane % 4.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace dl4j {

// S (16 x BN) += A (16 x D) · Bᵀ, B a [BN][STRIDE] f32 tile in shared
// memory, TF32 x3. qf holds this thread's raw f32 A fragments (k-step kk:
// columns 8kk + t, 8kk + t + 4 of rows g, g + 8).
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void scores_f32(const float (&qf)[D / 8][4],
                                           const float* __restrict__ kt,
                                           float (&s)[BN / 8][4], int g,
                                           int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(qf[kk][i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float* kr = kt + (8 * j + g) * STRIDE + 8 * kk + t;
      uint32_t bh[2], bl[2];
      tf32_split(kr[0], bh[0], bl[0]);
      tf32_split(kr[4], bh[1], bl[1]);
      mma_tf32x3(s[j], ah, al, bh, bl);
    }
  }
}

// O (16 x D) += P (16 x BN) · V, V a [BN][STRIDE] f32 tile, TF32 x3. The
// accumulator holds P[row][2t], P[row][2t+1] of each 8-key n-tile, so the k
// index t of the A fragment stands for key 2t and t + 4 for key 2t + 1; the
// B fragment reads V's rows in the same order.
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void pv_f32(const float (&p)[BN / 8][4],
                                       const float* __restrict__ vt,
                                       float (&acc)[D / 8][4], int g, int t) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    uint32_t ah[4], al[4];
    tf32_split(p[j][0], ah[0], al[0]);
    tf32_split(p[j][2], ah[1], al[1]);
    tf32_split(p[j][1], ah[2], al[2]);
    tf32_split(p[j][3], ah[3], al[3]);
    const float* vr = vt + (8 * j + 2 * t) * STRIDE + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh[2], bl[2];
      tf32_split(vr[8 * n], bh[0], bl[0]);
      tf32_split(vr[STRIDE + 8 * n], bh[1], bl[1]);
      mma_tf32x3(acc[n], ah, al, bh, bl);
    }
  }
}

// acc (16 x D) += P (16 x BN) · V as pv_f32 computes it, but the tile's sum
// is taken in fresh accumulators, 32 columns at a time, and added to acc by
// f32 adds that round to nearest. The tensor core adds into its accumulator
// with truncation, so in a long walk that keeps adding small terms into a
// large accumulator (dK/dV of the first keys over thousands of rows) the
// error grows with the walk; taken per tile it does not.
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void pv_f32_rn(const float (&p)[BN / 8][4],
                                          const float* __restrict__ vt,
                                          float (&acc)[D / 8][4], int g,
                                          int t) {
  constexpr int NC = D / 8 < 4 ? D / 8 : 4;  // n-tiles per chunk
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += NC) {
    float part[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      uint32_t ah[4], al[4];
      tf32_split(p[j][0], ah[0], al[0]);
      tf32_split(p[j][2], ah[1], al[1]);
      tf32_split(p[j][1], ah[2], al[2]);
      tf32_split(p[j][3], ah[3], al[3]);
      const float* vr = vt + (8 * j + 2 * t) * STRIDE + g + 8 * n0;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        uint32_t bh[2], bl[2];
        tf32_split(vr[8 * n], bh[0], bl[0]);
        tf32_split(vr[STRIDE + 8 * n], bh[1], bl[1]);
        mma_tf32x3(part[n], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// S += Q · Kᵀ in 16-bit m16n8k16 (T16 bf16 or f16); K fragments of two
// n-tiles per ldmatrix.x4.
template <int D, int BN, int STRIDE, typename T16>
__device__ __forceinline__ void scores_16(const uint32_t (&qa)[D / 16][4],
                                          const T16* __restrict__ kt,
                                          float (&s)[BN / 8][4], int lane) {
  const int key = (lane & 7) + ((lane >> 4) << 3);
  const int col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj) {
      uint32_t r[4];
      ldmatrix_x4(r, kt + (16 * jj + key) * STRIDE + 16 * kk + col);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      Mma16<T16>::mma(s[2 * jj], qa[kk], b0);
      Mma16<T16>::mma(s[2 * jj + 1], qa[kk], b1);
    }
  }
}

template <int D, int BN, int STRIDE>
__device__ __forceinline__ void scores_bf16(
    const uint32_t (&qa)[D / 16][4], const __nv_bfloat16* __restrict__ kt,
    float (&s)[BN / 8][4], int lane) {
  scores_16<D, BN, STRIDE>(qa, kt, s, lane);
}

// O += P · V in 16-bit m16n8k16 (T16 bf16 or f16). P's accumulator pairs
// are the A fragment as they stand; P goes in as two 16-bit terms (hi +
// lo), since one bf16 rounding of P (2^-9) moves O by a bf16 step where |O|
// is large. V fragments of two n-tiles per ldmatrix.x4.trans.
template <int D, int BN, int STRIDE, typename T16>
__device__ __forceinline__ void pv_16(const float (&p)[BN / 8][4],
                                      const T16* __restrict__ vt,
                                      float (&acc)[D / 8][4], int lane) {
  const int key = lane & 15;
  const int col = (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks) {
    uint32_t ah[4], al[4];
    Mma16<T16>::split(p[2 * ks][0], p[2 * ks][1], ah[0], al[0]);
    Mma16<T16>::split(p[2 * ks][2], p[2 * ks][3], ah[1], al[1]);
    Mma16<T16>::split(p[2 * ks + 1][0], p[2 * ks + 1][1], ah[2], al[2]);
    Mma16<T16>::split(p[2 * ks + 1][2], p[2 * ks + 1][3], ah[3], al[3]);
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vt + (16 * ks + key) * STRIDE + 16 * nn + col);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      Mma16<T16>::mma(acc[2 * nn], al, b0);
      Mma16<T16>::mma(acc[2 * nn], ah, b0);
      Mma16<T16>::mma(acc[2 * nn + 1], al, b1);
      Mma16<T16>::mma(acc[2 * nn + 1], ah, b1);
    }
  }
}

template <int D, int BN, int STRIDE>
__device__ __forceinline__ void pv_bf16(const float (&p)[BN / 8][4],
                                        const __nv_bfloat16* __restrict__ vt,
                                        float (&acc)[D / 8][4], int lane) {
  pv_16<D, BN, STRIDE>(p, vt, acc, lane);
}

// The same products by operand type, for kernels written once for both.
// S (16 x BN) += A · Bᵀ, B a [BN][STRIDE] tile:
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void tile_abt(const float (&a)[D / 8][4],
                                         const float* __restrict__ b,
                                         float (&s)[BN / 8][4], int lane) {
  scores_f32<D, BN, STRIDE>(a, b, s, lane >> 2, lane & 3);
}
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void tile_abt(const uint32_t (&a)[D / 16][4],
                                         const __nv_bfloat16* __restrict__ b,
                                         float (&s)[BN / 8][4], int lane) {
  scores_bf16<D, BN, STRIDE>(a, b, s, lane);
}
// acc (16 x D) += P · B, P an accumulator fragment (16 x BN), B a [BN][STRIDE]
// tile, f32 summed per tile:
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void tile_pb(const float (&p)[BN / 8][4],
                                        const float* __restrict__ b,
                                        float (&acc)[D / 8][4], int lane) {
  pv_f32_rn<D, BN, STRIDE>(p, b, acc, lane >> 2, lane & 3);
}
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void tile_pb(const float (&p)[BN / 8][4],
                                        const __nv_bfloat16* __restrict__ b,
                                        float (&acc)[D / 8][4], int lane) {
  pv_bf16<D, BN, STRIDE>(p, b, acc, lane);
}

// A fragments of rows r0 = row g and r1 = row g + 8 of a [Tlen][D] tensor,
// straight from device memory (rows past Tlen are zero): f32 raw (split at
// use), bf16 or f16 as packed pairs.
template <int D>
__device__ __forceinline__ void load_a_rows(const float* __restrict__ q,
                                            int r0, int r1, int Tlen, int t,
                                            float (&qf)[D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = 8 * kk + t;
    qf[kk][0] = r0 < Tlen ? q[(size_t)r0 * D + c] : 0.f;
    qf[kk][1] = r1 < Tlen ? q[(size_t)r1 * D + c] : 0.f;
    qf[kk][2] = r0 < Tlen ? q[(size_t)r0 * D + c + 4] : 0.f;
    qf[kk][3] = r1 < Tlen ? q[(size_t)r1 * D + c + 4] : 0.f;
  }
}

template <int D, typename T16>
__device__ __forceinline__ void load_a_rows(const T16* __restrict__ q, int r0,
                                            int r1, int Tlen, int t,
                                            uint32_t (&qa)[D / 16][4]) {
  static_assert(sizeof(T16) == 2, "16-bit A fragments");
  auto word = [&](int row, int c) -> uint32_t {
    return row < Tlen ? *reinterpret_cast<const uint32_t*>(
                            q + (size_t)row * D + c)
                      : 0u;
  };
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
    qa[kk][0] = word(r0, c);
    qa[kk][1] = word(r1, c);
    qa[kk][2] = word(r0, c + 8);
    qa[kk][3] = word(r1, c + 8);
  }
}

// The A fragments of a [16][STRIDE] tile in shared memory (a warp's rows).
template <int D, int STRIDE>
__device__ __forceinline__ void load_a_smem(const float* __restrict__ rows,
                                            int lane, float (&f)[D / 8][4]) {
  const float* r = rows + (lane >> 2) * STRIDE + (lane & 3);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    f[kk][0] = r[8 * kk];
    f[kk][1] = r[8 * STRIDE + 8 * kk];
    f[kk][2] = r[8 * kk + 4];
    f[kk][3] = r[8 * STRIDE + 8 * kk + 4];
  }
}

template <int D, int STRIDE>
__device__ __forceinline__ void load_a_smem(
    const __nv_bfloat16* __restrict__ rows, int lane,
    uint32_t (&f)[D / 16][4]) {
  const __nv_bfloat16* r = rows + (lane & 15) * STRIDE + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(f[kk], r + 16 * kk);
}

// Rows [r0, r0 + ROWS) of two [Tlen][D] tensors (same row offsets) into two
// [ROWS][STRIDE] shared tiles by 16-byte cp.async from THREADS threads. Rows
// past Tlen are zero-filled, never left stale: 0·NaN would poison a
// product.
template <typename T, int D, int ROWS, int STRIDE, int THREADS>
__device__ __forceinline__ void stage_rows2(T* __restrict__ da,
                                            T* __restrict__ db,
                                            const T* __restrict__ sa,
                                            const T* __restrict__ sb, int r0,
                                            int Tlen, int tid) {
  constexpr int kPerCopy = 16 / (int)sizeof(T);
  constexpr int kPerRow = D / kPerCopy;
#pragma unroll
  for (int i = tid; i < ROWS * kPerRow; i += THREADS) {
    const int j = i / kPerRow, c = (i % kPerRow) * kPerCopy;
    const bool ok = r0 + j < Tlen;
    const size_t src = (size_t)(ok ? r0 + j : 0) * D + c;
    cp_async16(da + j * STRIDE + c, sa + src, ok);
    cp_async16(db + j * STRIDE + c, sb + src, ok);
  }
}

// Entries [r0, r0 + N) of an f32 row into shared memory by 4-byte
// cp.async, zero past Tlen.
template <int N, int THREADS>
__device__ __forceinline__ void stage_vals(float* __restrict__ d,
                                           const float* __restrict__ s,
                                           int r0, int Tlen, int tid) {
  for (int i = tid; i < N; i += THREADS) {
    const bool ok = r0 + i < Tlen;
    cp_async4(d + i, s + (ok ? r0 + i : 0), ok);
  }
}

// Row g (hr = 0) or g + 8 (hr = 1) of an accumulator tile (16 x D), times
// mul, to dst (the row's first element): this thread's columns 8n + 2t and
// 8n + 2t + 1.
template <typename T, int D>
__device__ __forceinline__ void store_acc_row(T* __restrict__ dst,
                                              const float (&acc)[D / 8][4],
                                              int hr, int t, float mul) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float x0 = acc[n][2 * hr] * mul, x1 = acc[n][2 * hr + 1] * mul;
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(dst + 8 * n + 2 * t) = make_float2(x0, x1);
    else
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n + 2 * t) =
          __floats2bfloat162_rn(x0, x1);
  }
}

}  // namespace dl4j
