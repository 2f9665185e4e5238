// K1: flash-attention forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces deeplearning4j_tpu/ops/pallas_attention.py::_attn_fwd_kernel
// (launched by _flash_forward). Computes O = softmax(q kᵀ/√d) v over
// [B, H, T, d] with the online-softmax recurrence in f32, an optional causal
// mask and an optional [B, T] key-validity row (nonzero = valid), and writes
// O in the input type (f32, bf16 or f16, rounded once at the end) plus the
// row logsumexp lse [B·H, T, 1] in f32. Head dims 8, 16, 32, 64 and 128
// run their own instantiation; any other d with 4 <= d <= 128 and
// d % 4 == 0 runs the padded instantiation of the next of 8, 16, 32, 48,
// 64, 80, 96, 128 (common.cuh): zero columns past d in the K/V tiles and q
// fragments, rows of d elements in device memory, the scale 1/√d.
//
// What bounds it on this card: at the slice's T=128 the work is tiny and
// the kernel is bound by launch latency and by bytes (q, k, v, o: 4·B·H·T·d
// elements); at long T by operations, 4·B·H·T²·d FLOPs (half of them under
// causal), on the tensor cores.
//
// Design (FlashAttention-2 style): one CTA per (b·h, 64-row q tile), 4 warps
// of 16 rows, one mma m-tile each; the heaviest causal q tiles launch first
// (the q tile index counts down with blockIdx.y). Q stays in registers as
// mma A fragments. The CTA streams 64-key K/V tiles (32 for f32 past
// d=64, for registers) through a two-stage shared-memory ring filled by cp.async
// 16-byte copies, so tile j+1 is in flight while tile j is computed; keys
// past T are zero-filled, never left stale (0·NaN would poison P·V).
// S = Q·Kᵀ and O += P·V are warp-level mma.sync with f32 accumulators:
// bf16 and f16 as m16n8k16 (K and V fragments by ldmatrix; P enters P·V as
// two 16-bit terms, hi + lo, since one rounding of P, as FlashAttention-2
// does it, moves large outputs by a 16-bit step; at d=8 the scores run
// m16n8k8 and a 16-byte K/V row is read unpadded); f32 as m16n8k8 TF32
// with every operand
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
// written by one thread in a fixed order: two calls are bitwise equal. The
// tile products, fragment loads and ring staging live in attn_tile.cuh,
// shared with K3/K4.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "attn_tile.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace dl4j {

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kBlockM = kFwdWarps * 16;  // q rows of a CTA

template <typename T, int D>
struct FwdTile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // keys per K/V tile: f32 past d=64 (80, 96, 128) halves it to keep S
  // and O in registers
  static constexpr int kBlockN = (kF32 && D > 64) ? 32 : 64;
  // row stride in elements (attn_tile.cuh::tile_stride)
  static constexpr int kStride = tile_stride<T, D>();
  static constexpr int kTile = kBlockN * kStride;
  // two stages of K and V, plus two stages of the key-mask row
  static constexpr int kSmemBytes =
      2 * 2 * kTile * (int)sizeof(T) + 2 * kBlockN * (int)sizeof(float);
};

// The kernel's body: PAD false for a head dim of exactly D (dh = D), true
// for a padded instantiation (rows of dh elements, common.cuh).
template <typename T, int D, bool PAD>
__device__ __forceinline__ void flash_fwd_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
    int H, int Tlen, float scale, int causal, int dh) {
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
  const size_t base = (size_t)bh * Tlen * (PAD ? dh : D);
  const T* kb = k + base;
  const T* vb = v + base;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)b * Tlen;

  const int kend = causal ? min(Tlen, q0 + kBlockM) : Tlen;
  const int ntiles = (kend + BN - 1) / BN;

  // one K/V tile (and its mask row) into ring stage st, rows past T zeroed
  auto stage = [&](int tile, int st) {
    const int k0 = tile * BN;
    if constexpr (PAD)
      stage_rows2_pad<T, D, BN, STRIDE, kFwdThreads>(ks + st * C::kTile,
                                                     vs + st * C::kTile, kb,
                                                     vb, k0, Tlen, tid, dh);
    else
      stage_rows2<T, D, BN, STRIDE, kFwdThreads>(ks + st * C::kTile,
                                                 vs + st * C::kTile, kb, vb,
                                                 k0, Tlen, tid);
    if (mrow != nullptr)
      stage_vals<BN, kFwdThreads>(kok + st * BN, mrow, k0, Tlen, tid);
  };

  stage(0, 0);
  cp_async_commit();

  using QFrag =
      typename std::conditional<C::kF32, float[D / 8][4], Frag16<D>>::type;
  QFrag qfrag;
  if constexpr (PAD)
    load_a_rows_pad<D>(q + base, r0, r1, Tlen, t, qfrag, dh);
  else
    load_a_rows<D>(q + base, r0, r1, Tlen, t, qfrag);

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
      scores_16<D, BN, STRIDE>(qfrag, kt, s, lane);

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
      pv_16<D, BN, STRIDE>(s, vt, acc, lane);
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
    T* orow = o + base + (size_t)row * (PAD ? dh : D) + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (PAD && 8 * n + 2 * t >= dh) continue;
      const float x0 = acc[n][2 * hr] / lc, x1 = acc[n][2 * hr + 1] / lc;
      store2(orow + 8 * n, x0, x1);
    }
    if (t == 0) lse[(size_t)bh * Tlen + row] = m[hr] + logf(lc);
  }
}

// a head dim of exactly D
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ o, float* __restrict__ lse, int H,
                     int Tlen, float scale, int causal) {
  flash_fwd_body<T, D, false>(q, k, v, mask, o, lse, H, Tlen, scale, causal,
                              D);
}

// a head dim dh padded to D (common.cuh)
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads)
    flash_fwd_pad_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ mask, T* __restrict__ o,
                         float* __restrict__ lse, int H, int Tlen,
                         float scale, int causal, int dh) {
  flash_fwd_body<T, D, true>(q, k, v, mask, o, lse, H, Tlen, scale, causal,
                             dh);
}

// dh: the head dim; D == dh runs flash_fwd_kernel, D > dh (or a width
// with no exact instantiation) flash_fwd_pad_kernel
template <typename T, int D, bool PAD>
int launch_flash(const void* q, const void* k, const void* v, const float* mask,
           void* o, float* lse, int B, int H, int Tlen, int causal, int dh,
           cudaStream_t stream) {
  constexpr int smem = FwdTile<T, D>::kSmemBytes;
  // above 48 KB only as opted-in dynamic shared memory; asked once per
  // instantiation and device
  static PerDevice opt;
  const cudaError_t attr = once_per_device(opt, [](int, int&) {
    if constexpr (PAD)
      return cudaFuncSetAttribute(flash_fwd_pad_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
    else
      return cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  });
  if (attr != cudaSuccess) return (int)attr;
  const int qtiles = (Tlen + kBlockM - 1) / kBlockM;
  if (qtiles > 65535) return -1;
  const dim3 grid(B * H, qtiles);
  const float scale = (float)(1.0 / std::sqrt((double)dh));
  if constexpr (PAD)
    flash_fwd_pad_kernel<T, D><<<grid, kFwdThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, Tlen,
        scale, causal, dh);
  else
    flash_fwd_kernel<T, D><<<grid, kFwdThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, Tlen,
        scale, causal);
  return 0;
}

}  // namespace dl4j

// One case of the width switches below, by q's type (0 f32, 1 bf16, 2
// f16); PAD selects the padded instantiation.
#define DL4J_FWD_CASE(DIM, PAD)                                             \
  case DIM:                                                                 \
    switch (dtype) {                                                        \
      case 0:                                                               \
        return dl4j::launch_flash<float, DIM, PAD>(                         \
            q, k, v, mask, o, lse, B, H, Tlen, causal, D, stream);          \
      case 1:                                                               \
        return dl4j::launch_flash<__nv_bfloat16, DIM, PAD>(                 \
            q, k, v, mask, o, lse, B, H, Tlen, causal, D, stream);          \
      case 2:                                                               \
        return dl4j::launch_flash<__half, DIM, PAD>(                        \
            q, k, v, mask, o, lse, B, H, Tlen, causal, D, stream);          \
      default:                                                              \
        return -5;                                                          \
    }

// Launches K1 on `stream`; returns 0 after a launch (the caller checks it
// with cudaGetLastError), or a nonzero code for an unsupported
// configuration, which launches nothing (-2: a head dim D no kernel
// takes). dtype: q's, k's, v's and o's type, 0 f32, 1 bf16, 2 f16.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const float* mask, void* o, float* lse, int B,
                              int H, int Tlen, int D, int dtype, int causal,
                              cudaStream_t stream) {
  if (Tlen < 1 || B * H < 1 || B * H > 65535) return -1;
  if (dl4j::exact_dim(D)) {
    switch (D) {
      DL4J_FWD_CASE(8, false)
      DL4J_FWD_CASE(16, false)
      DL4J_FWD_CASE(32, false)
      DL4J_FWD_CASE(64, false)
      DL4J_FWD_CASE(128, false)
    }
  }
  switch (dl4j::pad_dim(D)) {
    DL4J_FWD_CASE(8, true)
    DL4J_FWD_CASE(16, true)
    DL4J_FWD_CASE(32, true)
    DL4J_FWD_CASE(48, true)
    DL4J_FWD_CASE(64, true)
    DL4J_FWD_CASE(80, true)
    DL4J_FWD_CASE(96, true)
    DL4J_FWD_CASE(128, true)
    default:
      return -2;
  }
}

#undef DL4J_FWD_CASE

// Dynamic shared memory of one K1 CTA in bytes (for reports) at the width a
// head dim D runs at; dtype as for dl4j_flash_fwd; -2 for a head dim no
// kernel takes.
extern "C" int dl4j_flash_fwd_smem(int D, int dtype) {
#define DL4J_FWD_SMEM(DIM)                                            \
  case DIM:                                                           \
    return dtype == 0 ? dl4j::FwdTile<float, DIM>::kSmemBytes         \
                      : dl4j::FwdTile<__half, DIM>::kSmemBytes;
  switch (dl4j::pad_dim(D)) {
    DL4J_FWD_SMEM(8)
    DL4J_FWD_SMEM(16)
    DL4J_FWD_SMEM(32)
    DL4J_FWD_SMEM(48)
    DL4J_FWD_SMEM(64)
    DL4J_FWD_SMEM(80)
    DL4J_FWD_SMEM(96)
    DL4J_FWD_SMEM(128)
    default:
      return -2;
  }
#undef DL4J_FWD_SMEM
}
