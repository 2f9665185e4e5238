// Tile helpers shared by the port's tensor-core attention kernels, K1
// (flash_fwd.cu) and K3/K4 (flash_bwd.cu): warp-level products of a 16-row
// A operand (held as mma A fragments) with a tile staged in shared memory,
// A fragments from device or shared memory, the cp.async staging of a ring
// stage, and the epilogue store of an accumulator row.
//
// Every product keeps f32 accumulators. f32 runs m16n8k8 TF32 with each
// operand split into hi + lo and three products (mma_tf32x3); bf16 and f16
// run m16n8k16, with an accumulator operand (P, dS) in two 16-bit terms.
// A head dim of 8 is half a k-step of m16n8k16: its score products run
// m16n8k8, its 16-bit A fragments hold two registers ([0][0..1]) in the
// one-entry Frag16 array, and its 16-byte rows are read four (or two
// k-steps') 8x8 matrices per ldmatrix. Head dims 8 and 16 in f32 are one
// and two TF32 k-steps and need nothing of their own.
// The *_pad helpers at the end serve the padded instantiations of other
// head dims (common.cuh), tile_abt_smem the wide ones (past 128).
// Fragment layouts are listed in mma.cuh; g = lane / 4, t = lane % 4.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace dl4j {

// 16-bit A fragments of a 16 x D tile: one m16n8k16 k-step per 16 columns,
// one (half used) for D = 8.
template <int D>
using Frag16 = uint32_t[(D + 15) / 16][4];

// Row stride in elements of a [rows][D] tile of T in shared memory: 16
// bytes of padding keep the fragment loads free of bank conflicts and every
// row 16-byte aligned for cp.async, except for 16-byte rows (16-bit D = 8),
// which stay unpadded: an ldmatrix phase then reads 8 consecutive rows, 128
// contiguous bytes, while 32-byte rows would put rows r and r + 4 on one
// bank.
template <typename T, int D>
constexpr int tile_stride() {
  return D * (int)sizeof(T) == 16 ? D : D + 16 / (int)sizeof(T);
}

// n-tiles per fresh-accumulator chunk of a D-column product (pv_f32_rn and
// K2's int8 and split-plane products): 4 where that divides the D / 8
// n-tiles, else 3 or 2 (D = 48: 6 n-tiles; D = 80: 10), so no chunk runs
// past the accumulator
template <int D>
__host__ __device__ constexpr int n_chunk() {
  return (D / 8) % 4 == 0 ? 4 : (D / 8) % 3 == 0 ? 3 : (D / 8) % 2 == 0 ? 2
                                                                      : 1;
}

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
  constexpr int NC = n_chunk<D>();  // n-tiles per chunk
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
// n-tiles per ldmatrix.x4. D = 8: one m16n8k8 per n-tile, K fragments of
// four n-tiles (lane l addresses key row l of 32) per ldmatrix.x4.
template <int D, int BN, int STRIDE, typename T16>
__device__ __forceinline__ void scores_16(const Frag16<D>& qa,
                                          const T16* __restrict__ kt,
                                          float (&s)[BN / 8][4], int lane) {
  if constexpr (D == 8) {
    static_assert(BN % 32 == 0, "d=8 loads 32 keys per ldmatrix.x4");
#pragma unroll
    for (int jj = 0; jj < BN / 32; ++jj) {
      uint32_t r[4];
      ldmatrix_x4(r, kt + (32 * jj + lane) * STRIDE);
#pragma unroll
      for (int i = 0; i < 4; ++i) Mma16<T16>::mma_k8(s[4 * jj + i], qa[0], r[i]);
    }
    return;
  }
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

// O += P · V in 16-bit m16n8k16 (T16 bf16 or f16). P's accumulator pairs
// are the A fragment as they stand; P goes in as two 16-bit terms (hi +
// lo), since one bf16 rounding of P (2^-9) moves O by a bf16 step where |O|
// is large. V fragments of two n-tiles per ldmatrix.x4.trans; D = 8 (one
// n-tile) takes the V fragments of two k-steps (lane l addresses key row l
// of 32) per ldmatrix.x4.trans.
template <int D, int BN, int STRIDE, typename T16>
__device__ __forceinline__ void pv_16(const float (&p)[BN / 8][4],
                                      const T16* __restrict__ vt,
                                      float (&acc)[D / 8][4], int lane) {
  if constexpr (D == 8) {
    static_assert(BN % 32 == 0, "d=8 loads 32 keys per ldmatrix.x4");
#pragma unroll
    for (int k2 = 0; k2 < BN / 32; ++k2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vt + (32 * k2 + lane) * STRIDE);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = 2 * k2 + h;
        uint32_t ah[4], al[4];
        Mma16<T16>::split(p[2 * ks][0], p[2 * ks][1], ah[0], al[0]);
        Mma16<T16>::split(p[2 * ks][2], p[2 * ks][3], ah[1], al[1]);
        Mma16<T16>::split(p[2 * ks + 1][0], p[2 * ks + 1][1], ah[2], al[2]);
        Mma16<T16>::split(p[2 * ks + 1][2], p[2 * ks + 1][3], ah[3], al[3]);
        const uint32_t b[2] = {r[2 * h], r[2 * h + 1]};
        Mma16<T16>::mma(acc[0], al, b);
        Mma16<T16>::mma(acc[0], ah, b);
      }
    }
    return;
  }
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

// The same products by operand type, for kernels written once for both.
// S (16 x BN) += A · Bᵀ, B a [BN][STRIDE] tile:
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void tile_abt(const float (&a)[D / 8][4],
                                         const float* __restrict__ b,
                                         float (&s)[BN / 8][4], int lane) {
  scores_f32<D, BN, STRIDE>(a, b, s, lane >> 2, lane & 3);
}
template <int D, int BN, int STRIDE, typename T16>
__device__ __forceinline__ void tile_abt(const Frag16<D>& a,
                                         const T16* __restrict__ b,
                                         float (&s)[BN / 8][4], int lane) {
  scores_16<D, BN, STRIDE>(a, b, s, lane);
}
// acc (16 x D) += P · B, P an accumulator fragment (16 x BN), B a [BN][STRIDE]
// tile, f32 summed per tile:
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void tile_pb(const float (&p)[BN / 8][4],
                                        const float* __restrict__ b,
                                        float (&acc)[D / 8][4], int lane) {
  pv_f32_rn<D, BN, STRIDE>(p, b, acc, lane >> 2, lane & 3);
}
template <int D, int BN, int STRIDE, typename T16>
__device__ __forceinline__ void tile_pb(const float (&p)[BN / 8][4],
                                        const T16* __restrict__ b,
                                        float (&acc)[D / 8][4], int lane) {
  static_assert(sizeof(T16) == 2, "16-bit B tile");
  pv_16<D, BN, STRIDE>(p, b, acc, lane);
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
                                            Frag16<D>& qa) {
  static_assert(sizeof(T16) == 2, "16-bit A fragments");
  auto word = [&](int row, int c) -> uint32_t {
    return row < Tlen ? *reinterpret_cast<const uint32_t*>(
                            q + (size_t)row * D + c)
                      : 0u;
  };
  if constexpr (D == 8) {  // the m16n8k8 A fragment: a0, a1
    qa[0][0] = word(r0, 2 * t);
    qa[0][1] = word(r1, 2 * t);
    qa[0][2] = qa[0][3] = 0u;
    return;
  }
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

template <int D, int STRIDE, typename T16>
__device__ __forceinline__ void load_a_smem(const T16* __restrict__ rows,
                                            int lane, Frag16<D>& f) {
  static_assert(sizeof(T16) == 2 && D >= 16, "16-bit rows of 16+ columns");
  const T16* r = rows + (lane & 15) * STRIDE + (lane >> 4) * 8;
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

// Two adjacent outputs (the element pair of an accumulator fragment) in
// the output type, rounded to nearest even once.
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store2(__half* p, float x0, float x1) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x0, x1);
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
    store2(dst + 8 * n + 2 * t, x0, x1);
  }
}

// ----------------------------------------------------------- padded widths
// The helpers above read and write rows of exactly D elements. A padded
// instantiation (common.cuh) runs a head dim dh < D, or dh = D at 48, 80
// and 96, on D-column tiles: its rows are dh elements apart in device
// memory, the columns from dh on are zero in every fragment and tile, and
// only the first dh columns are stored.

// load_a_rows for rows of dh elements: columns from dh on are zero.
template <int D>
__device__ __forceinline__ void load_a_rows_pad(const float* __restrict__ q,
                                                int r0, int r1, int Tlen,
                                                int t, float (&qf)[D / 8][4],
                                                int dh) {
  auto at = [&](int row, int c) -> float {
    return row < Tlen && c < dh ? q[(size_t)row * dh + c] : 0.f;
  };
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = 8 * kk + t;
    qf[kk][0] = at(r0, c);
    qf[kk][1] = at(r1, c);
    qf[kk][2] = at(r0, c + 4);
    qf[kk][3] = at(r1, c + 4);
  }
}

template <int D, typename T16>
__device__ __forceinline__ void load_a_rows_pad(const T16* __restrict__ q,
                                                int r0, int r1, int Tlen,
                                                int t, Frag16<D>& qa,
                                                int dh) {
  static_assert(sizeof(T16) == 2, "16-bit A fragments");
  // with dh even a pair of columns (c even) lies wholly before dh or wholly
  // after it, and its 4 bytes are aligned; with dh odd the pair is read
  // as two 2-byte elements, the one at dh zero
  auto word = [&](int row, int c) -> uint32_t {
    if (row >= Tlen || c >= dh) return 0u;
    const T16* p = q + (size_t)row * dh + c;
    if ((dh & 1) == 0) return *reinterpret_cast<const uint32_t*>(p);
    const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
    const uint32_t hi =
        c + 1 < dh ? *reinterpret_cast<const unsigned short*>(p + 1) : 0u;
    return lo | (hi << 16);
  };
  if constexpr (D == 8) {  // the m16n8k8 A fragment: a0, a1
    qa[0][0] = word(r0, 2 * t);
    qa[0][1] = word(r1, 2 * t);
    qa[0][2] = qa[0][3] = 0u;
    return;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
    qa[kk][0] = word(r0, c);
    qa[kk][1] = word(r1, c);
    qa[kk][2] = word(r0, c + 8);
    qa[kk][3] = word(r1, c + 8);
  }
}

// stage_rows2 for rows of dh elements, by cp.async of BYTES: copies of the
// columns from dh on, and of rows past Tlen, write zeros. sb == nullptr
// stages one tensor.
template <typename T, int D, int ROWS, int STRIDE, int THREADS, int BYTES>
__device__ __forceinline__ void stage_rows2_pad_n(
    T* __restrict__ da, T* __restrict__ db, const T* __restrict__ sa,
    const T* __restrict__ sb, int r0, int Tlen, int tid, int dh) {
  constexpr int kPerCopy = BYTES / (int)sizeof(T);
  constexpr int kPerRow = D / kPerCopy;
  for (int i = tid; i < ROWS * kPerRow; i += THREADS) {
    const int j = i / kPerRow, c = (i % kPerRow) * kPerCopy;
    const bool ok = r0 + j < Tlen && c < dh;
    const size_t src = ok ? (size_t)(r0 + j) * dh + c : 0;
    cp_async_n<BYTES>(da + j * STRIDE + c, sa + src, ok);
    if (sb != nullptr) cp_async_n<BYTES>(db + j * STRIDE + c, sb + src, ok);
  }
}

// The unsigned integer of an element's size (its bits, copied as they are)
template <typename T>
using bits_t = typename std::conditional<
    sizeof(T) == 4, uint32_t,
    typename std::conditional<sizeof(T) == 2, unsigned short,
                              unsigned char>::type>::type;

// The same for rows that are not a multiple of 4 bytes (16-bit rows of odd
// dh): element loads and stores into the tile, synchronous (visible to
// the CTA at its next barrier, as the ring's copies are once waited for).
template <typename T, int D, int ROWS, int STRIDE, int THREADS>
__device__ __forceinline__ void stage_rows2_elem(
    T* __restrict__ da, T* __restrict__ db, const T* __restrict__ sa,
    const T* __restrict__ sb, int r0, int Tlen, int tid, int dh) {
  using U = bits_t<T>;
  const U* ua = reinterpret_cast<const U*>(sa);
  const U* ub = reinterpret_cast<const U*>(sb);
  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int j = i / D, c = i % D;
    const bool ok = r0 + j < Tlen && c < dh;
    const size_t src = (size_t)(r0 + j) * dh + c;
    reinterpret_cast<U*>(da)[j * STRIDE + c] = ok ? ua[src] : U(0);
    if (sb != nullptr)
      reinterpret_cast<U*>(db)[j * STRIDE + c] = ok ? ub[src] : U(0);
  }
}

// the widest copy a row of dh elements keeps aligned (common.cuh::
// copy_bytes): 16, 8 or 4 bytes (f32 rows: 16 where dh % 4 == 0), or
// element loads below 4
template <typename T, int D, int ROWS, int STRIDE, int THREADS>
__device__ __forceinline__ void stage_rows2_pad(T* __restrict__ da,
                                                T* __restrict__ db,
                                                const T* __restrict__ sa,
                                                const T* __restrict__ sb,
                                                int r0, int Tlen, int tid,
                                                int dh) {
  switch (copy_bytes(dh * (int)sizeof(T))) {
    case 16:
      stage_rows2_pad_n<T, D, ROWS, STRIDE, THREADS, 16>(da, db, sa, sb, r0,
                                                         Tlen, tid, dh);
      break;
    case 8:
      stage_rows2_pad_n<T, D, ROWS, STRIDE, THREADS, 8>(da, db, sa, sb, r0,
                                                        Tlen, tid, dh);
      break;
    case 4:
      stage_rows2_pad_n<T, D, ROWS, STRIDE, THREADS, 4>(da, db, sa, sb, r0,
                                                        Tlen, tid, dh);
      break;
    default:
      stage_rows2_elem<T, D, ROWS, STRIDE, THREADS>(da, db, sa, sb, r0, Tlen,
                                                    tid, dh);
  }
}

// One output in the output type, rounded to nearest even once.
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store1(__half* p, float x) {
  *p = __float2half_rn(x);
}

// store2 of columns c and c + 1 of a row of which dl columns exist from p
// - c on: nothing from dl on; a pair store where dl is even (the pair is
// then aligned, rows being an even number of elements apart), else two
// element stores.
template <typename T>
__device__ __forceinline__ void store2_pad(T* p, float x0, float x1, int c,
                                           int dl) {
  if (c >= dl) return;
  if ((dl & 1) == 0) {
    store2(p, x0, x1);
    return;
  }
  store1(p, x0);
  if (c + 1 < dl) store1(p + 1, x1);
}

// store_acc_row's columns before dl only (dst: the row's first element).
template <typename T, int D>
__device__ __forceinline__ void store_acc_row_pad(T* __restrict__ dst,
                                                  const float (&acc)[D / 8][4],
                                                  int hr, int t, float mul,
                                                  int dl) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    store2_pad(dst + c, acc[n][2 * hr] * mul, acc[n][2 * hr + 1] * mul, c,
               dl);
  }
}

// ------------------------------------------------------------- wide widths
// S (16 x BN) += A (16 x D) · Bᵀ with A's 16 rows in a [16][ASTRIDE] tile in
// shared memory, read one k-step at a time (8 f32 or 16 16-bit columns)
// rather than held as D-wide fragments, which past a width of 128 would
// not fit in registers beside the accumulators: the products are
// tile_abt's. In f32 each k-step's three TF32 products are summed in fresh
// accumulators and added to S by f32 adds that round to nearest: the
// tensor core's accumulation truncates, and over the 20 to 32 k-steps of a
// wide row its bias moves dP − delta, a difference of large terms, by
// more than phase 6's 1e-5 of max|dK| (an H100, d = 200).
template <int D, int BN, int ASTRIDE, int STRIDE, typename T>
__device__ __forceinline__ void tile_abt_smem(const T* __restrict__ a,
                                              const T* __restrict__ b,
                                              float (&s)[BN / 8][4],
                                              int lane) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int K = kF32 ? 8 : 16;  // columns of a k-step
  using Frag =
      typename std::conditional<kF32, float[1][4], Frag16<16>>::type;
  for (int kk = 0; kk < D / K; ++kk) {
    Frag f;
    load_a_smem<K, ASTRIDE>(a + K * kk, lane, f);
    if constexpr (kF32) {
      float part[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
      tile_abt<K, BN, STRIDE>(f, b + K * kk, part, lane);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
    } else {
      tile_abt<K, BN, STRIDE>(f, b + K * kk, s, lane);
    }
  }
}

}  // namespace dl4j
