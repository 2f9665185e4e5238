// K1: flash-attention forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces deeplearning4j_tpu/ops/pallas_attention.py::_attn_fwd_kernel
// (launched by _flash_forward). Computes O = softmax(q kᵀ/√d) v over
// [B, H, T, d] with the online-softmax recurrence in f32, an optional causal
// mask and an optional [B, T] key-validity row (nonzero = valid), and writes
// O in the input type plus the row logsumexp lse [B·H, T, 1] in f32.
//
// What bounds it on this card: at the slice's T=128 the work is tiny and
// the kernel is bound by launch latency and by bytes (q, k, v, o: 4·B·H·T·d
// elements); at long T by operations, 4·B·H·T²·d FLOPs (half of them under
// causal), on the tensor cores.
//
// Design (FlashAttention-2 style): one CTA per (b·h, 64-row q tile), 4 warps
// of 16 rows, one mma m-tile each; the heaviest causal q tiles launch first
// (the q tile index counts down with blockIdx.y). Q stays in registers as
// mma A fragments. The CTA streams 64-key K/V tiles (32 for f32 at d=128,
// for registers) through a two-stage shared-memory ring filled by cp.async
// 16-byte copies, so tile j+1 is in flight while tile j is computed; keys
// past T are zero-filled, never left stale (0·NaN would poison P·V).
// S = Q·Kᵀ and O += P·V are warp-level mma.sync with f32 accumulators:
// bf16 as m16n8k16 (K and V fragments by ldmatrix; P enters P·V as two
// bf16 terms, hi + lo, since one rounding of P, as FlashAttention-2 does it,
// moves large outputs by a bf16 step); f32 as m16n8k8 TF32 with every operand
// split into TF32 hi + lo and three products (hi·hi + hi·lo + lo·hi), which
// keeps about 2^-21 relative error where one TF32 product keeps 1e-3. The
// online softmax runs on the accumulator fragment: each thread holds two
// rows, so a row max is two quad shuffles; the row sum stays a per-thread
// partial until the end. Scores are scaled by 1/√d in f32 after the
// product (lse keeps its meaning for K3/K4). Masked keys score -1e30 and
// keys past T -inf (they add exactly 0); causal CTAs stop at their last row
// and mask only the tiles that reach past a warp's first row. l is clamped
// at 1e-30 before the divide, as _attn_fwd_kernel does, so a fully masked
// row stays finite (uniform over the keys the kernel walks). Each output is
// written by one thread in a fixed order: two calls are bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace dl4j {

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kBlockM = kFwdWarps * 16;  // q rows of a CTA

template <typename T, int D>
struct FwdTile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // keys per K/V tile: f32 at d=128 halves it to keep S and O in registers
  static constexpr int kBlockN = (kF32 && D == 128) ? 32 : 64;
  // row stride in elements: the padding (16 bytes) keeps the fragment loads
  // free of bank conflicts and every row 16-byte aligned for cp.async
  static constexpr int kStride = D + 16 / (int)sizeof(T);
  static constexpr int kTile = kBlockN * kStride;
  // two stages of K and V, plus two stages of the key-mask row
  static constexpr int kSmemBytes =
      2 * 2 * kTile * (int)sizeof(T) + 2 * kBlockN * (int)sizeof(float);
};

// S (16 x BN) = Q (16 x D) · Kᵀ, TF32 x3. qf holds this thread's raw f32 A
// fragments (k-step kk: columns 8kk + t, 8kk + t + 4 of rows g, g + 8).
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

// O (16 x D) += P (16 x BN) · V, TF32 x3. The accumulator holds P[row][2t],
// P[row][2t+1] of each 8-key n-tile, so the k index t of the A fragment
// stands for key 2t and t + 4 for key 2t + 1; the B fragment reads V's rows
// in the same order.
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

// S = Q · Kᵀ in bf16 m16n8k16; K fragments of two n-tiles per ldmatrix.x4.
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void scores_bf16(
    const uint32_t (&qa)[D / 16][4], const __nv_bfloat16* __restrict__ kt,
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
      mma_bf16(s[2 * jj], qa[kk], b0);
      mma_bf16(s[2 * jj + 1], qa[kk], b1);
    }
  }
}

// O += P · V in bf16 m16n8k16. P's accumulator pairs are the A fragment as
// they stand; P goes in as two bf16 terms (hi + lo), since one bf16
// rounding of P (2^-9) moves O by a bf16 step where |O| is large. V
// fragments of two n-tiles per ldmatrix.x4.trans.
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void pv_bf16(const float (&p)[BN / 8][4],
                                        const __nv_bfloat16* __restrict__ vt,
                                        float (&acc)[D / 8][4], int lane) {
  const int key = lane & 15;
  const int col = (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks) {
    uint32_t ah[4], al[4];
    split_bf16x2(p[2 * ks][0], p[2 * ks][1], ah[0], al[0]);
    split_bf16x2(p[2 * ks][2], p[2 * ks][3], ah[1], al[1]);
    split_bf16x2(p[2 * ks + 1][0], p[2 * ks + 1][1], ah[2], al[2]);
    split_bf16x2(p[2 * ks + 1][2], p[2 * ks + 1][3], ah[3], al[3]);
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vt + (16 * ks + key) * STRIDE + 16 * nn + col);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16(acc[2 * nn], al, b0);
      mma_bf16(acc[2 * nn], ah, b0);
      mma_bf16(acc[2 * nn + 1], al, b1);
      mma_bf16(acc[2 * nn + 1], ah, b1);
    }
  }
}

// Q's A fragments straight from device memory (rows past T are zero).
template <int D>
__device__ __forceinline__ void load_q(const float* __restrict__ q, int r0,
                                       int r1, int Tlen, int t,
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

template <int D>
__device__ __forceinline__ void load_q(const __nv_bfloat16* __restrict__ q,
                                       int r0, int r1, int Tlen, int t,
                                       uint32_t (&qa)[D / 16][4]) {
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

template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ o, float* __restrict__ lse, int H,
                     int Tlen, float scale, int causal) {
  using C = FwdTile<T, D>;
  constexpr int BN = C::kBlockN;
  constexpr int STRIDE = C::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);                      // [2][BN][STRIDE]
  T* vs = ks + 2 * C::kTile;                                   // [2][BN][STRIDE]
  float* kok = reinterpret_cast<float*>(vs + 2 * C::kTile);    // [2][BN]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;  // heaviest first
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 16 * warp;  // the warp's first row
  const int r0 = wrow + g, r1 = r0 + 8;
  const size_t base = (size_t)bh * Tlen * D;
  const T* kb = k + base;
  const T* vb = v + base;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)b * Tlen;

  const int kend = causal ? min(Tlen, q0 + kBlockM) : Tlen;
  const int ntiles = (kend + BN - 1) / BN;

  // one K/V tile (and its mask row) into ring stage st, rows past T zeroed
  auto stage = [&](int tile, int st) {
    constexpr int kPerCopy = 16 / (int)sizeof(T);
    constexpr int kPerRow = D / kPerCopy;
    const int k0 = tile * BN;
    T* kd = ks + st * C::kTile;
    T* vd = vs + st * C::kTile;
#pragma unroll
    for (int i = tid; i < BN * kPerRow; i += kFwdThreads) {
      const int j = i / kPerRow, c = (i % kPerRow) * kPerCopy;
      const bool ok = k0 + j < Tlen;
      const size_t src = (size_t)(ok ? k0 + j : 0) * D + c;
      cp_async16(kd + j * STRIDE + c, kb + src, ok);
      cp_async16(vd + j * STRIDE + c, vb + src, ok);
    }
    if (mrow != nullptr) {
      for (int i = tid; i < BN; i += kFwdThreads) {
        const bool ok = k0 + i < Tlen;
        cp_async4(kok + st * BN + i, mrow + (ok ? k0 + i : 0), ok);
      }
    }
  };

  stage(0, 0);
  cp_async_commit();

  using QFrag = typename std::conditional<C::kF32, float[D / 8][4],
                                          uint32_t[D / 16][4]>::type;
  QFrag qfrag;
  load_q<D>(q + base, r0, r1, Tlen, t, qfrag);

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) stage(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed (tile it+1 may be in flight)
    __syncthreads();
    const T* kt = ks + (it & 1) * C::kTile;
    const T* vt = vs + (it & 1) * C::kTile;
    const float* okt = kok + (it & 1) * BN;
    const int k0 = it * BN;

    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (C::kF32)
      scores_f32<D, BN, STRIDE>(qfrag, kt, s, g, t);
    else
      scores_bf16<D, BN, STRIDE>(qfrag, kt, s, lane);

    // scale, then mask: only tiles that reach past T, past the warp's first
    // row (causal), or under a key mask need the per-element test
    const bool edge = mrow != nullptr || k0 + BN > Tlen ||
                      (causal && k0 + BN - 1 > wrow);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (col >= Tlen)
            x = neg_inf();
          else if ((causal && col > row) ||
                   (mrow != nullptr && okt[col - k0] == 0.f))
            x = kNegInf;
        }
        s[j][e] = x;
      }
    }

    // online softmax on the fragment: rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = m[hr];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = expf(m[hr] - mx);
      m[hr] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          s[j][e] = expf(s[j][e] - mx);
          sum += s[j][e];
        }
      }
      l[hr] = l[hr] * alpha + sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * hr] *= alpha;
        acc[n][2 * hr + 1] *= alpha;
      }
    }

    if constexpr (C::kF32)
      pv_f32<D, BN, STRIDE>(s, vt, acc, g, t);
    else
      pv_bf16<D, BN, STRIDE>(s, vt, acc, lane);
    __syncthreads();  // stage it & 1 is consumed: the next stage() may fill it
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lr = l[hr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = hr ? r1 : r0;
    if (row >= Tlen) continue;
    const float lc = fmaxf(lr, 1e-30f);
    T* orow = o + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = acc[n][2 * hr] / lc, x1 = acc[n][2 * hr + 1] / lc;
      if constexpr (C::kF32)
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(x0, x1);
    }
    if (t == 0) lse[(size_t)bh * Tlen + row] = m[hr] + logf(lc);
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, const float* mask,
           void* o, float* lse, int B, int H, int Tlen, int causal,
           cudaStream_t stream) {
  constexpr int smem = FwdTile<T, D>::kSmemBytes;
  // above 48 KB only as opted-in dynamic shared memory; asked once per
  // instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  const int qtiles = (Tlen + kBlockM - 1) / kBlockM;
  if (qtiles > 65535) return -1;
  const dim3 grid(B * H, qtiles);
  flash_fwd_kernel<T, D><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, Tlen,
      (float)(1.0 / std::sqrt((double)D)), causal);
  return 0;
}

}  // namespace dl4j

// Launches K1 on `stream`; returns 0 after a launch (the caller checks it
// with cudaGetLastError), or a nonzero code for an unsupported
// configuration, which launches nothing.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const float* mask, void* o, float* lse, int B,
                              int H, int Tlen, int D, int is_bf16, int causal,
                              cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (Tlen < 1 || B * H < 1 || B * H > 65535) return -1;
  switch (D) {
    case 32:
      return is_bf16 ? dl4j::launch_flash<bf16, 32>(q, k, v, mask, o, lse, B, H, Tlen, causal, stream)
                     : dl4j::launch_flash<float, 32>(q, k, v, mask, o, lse, B, H, Tlen, causal, stream);
    case 64:
      return is_bf16 ? dl4j::launch_flash<bf16, 64>(q, k, v, mask, o, lse, B, H, Tlen, causal, stream)
                     : dl4j::launch_flash<float, 64>(q, k, v, mask, o, lse, B, H, Tlen, causal, stream);
    case 128:
      return is_bf16 ? dl4j::launch_flash<bf16, 128>(q, k, v, mask, o, lse, B, H, Tlen, causal, stream)
                     : dl4j::launch_flash<float, 128>(q, k, v, mask, o, lse, B, H, Tlen, causal, stream);
    default:
      return -2;
  }
}
