// K3 and K4: flash-attention backward for Hopper (sm_90a), dQ and dK/dV,
// on the tensor cores.
//
// Replace deeplearning4j_tpu/ops/pallas_attention.py::_attn_dq_kernel (K3)
// and ::_attn_dkv_kernel (K4), both launched by _flash_backward. Given the
// forward's inputs q, k, v [B, H, T, d], the upstream gradient dO, the row
// logsumexp lse [B·H, T, 1] that K1 wrote and delta = rowsum(dO·O)
// [B·H, T, 1] (f32, computed by the caller), each rebuilds the attention
// weights P = exp(q·kᵀ/√d − lse) tile by tile, so the [T, T] matrices never
// reach device memory:
//
//   dP = dO·vᵀ,  dS = P ⊙ (dP − delta),
//   dQ = (dS·k)/√d  (K3),   dV = Pᵀ·dO,  dK = (dSᵀ·q)/√d  (K4).
//
// Scores are masked exactly as K1 masks them, so P is built from the same
// set of keys that lse counts: a key past the causal diagonal or refused by
// the optional [B, T] key row (nonzero = valid) scores -1e30, and a key or
// row past T gets P = 0 exactly. Both kernels accumulate in f32 and write in
// the input type (f32, bf16 or f16, rounded once at the end), at head dims
// 8, 16, 32, 64 and 128 in their own instantiations and at any other d with
// 4 <= d <= 128, d % 4 == 0 in the padded instantiation of the next of 8,
// 16, 32, 48, 64, 80, 96, 128 (common.cuh; 1/√d the scale).
//
// What bounds them on this card: at the training slice's T=128, d=32 both
// are tiny, bound by launch latency and by bytes (K3 moves q, k, v, dO, dQ;
// K4 q, k, v, dO, dK, dV; both lse and delta); at long T by operations, 6d
// (K3) and 8d (K4) FLOPs per visible (row, key) pair, on the tensor cores.
//
// Design (K1's, attn_tile.cuh): warp-level mma.sync with f32 accumulators,
// f32 as m16n8k8 TF32 with three products of hi/lo splits (about 2^-21
// relative, where one TF32 product keeps 1e-3), bf16 and f16 as m16n8k16
// with P and dS entering their products as two 16-bit terms, as K1's P·V
// does (at d=8 the A·Bᵀ products run m16n8k8 on unpadded 16-byte rows).
// - K3 is one CTA per (b·h, 64-row q tile), 4 warps of 16 rows, the
//   heaviest causal tiles first. The warp's q and dO rows are A fragments;
//   K/V tiles of about 8 KB a tensor (64 keys; 32 for f32 at d=48 and 64
//   and 16-bit past 64, 16 for f32 past 64) stream through a two-stage shared-memory ring
//   filled by 16-byte cp.async, with the key-mask row beside each tile, up
//   to the diagonal tile when causal. S = q·Kᵀ and dP = dO·Vᵀ, dS is built
//   on the accumulator, and dQ += dS·K takes dS as A from the accumulator
//   (K1's key-reordered TF32 fragment; bf16 K by ldmatrix.trans).
// - K4 is K3 with rows and keys swapped: one CTA per (b·h, 64-key tile),
//   4 warps of 16 keys, the low key tiles (which walk the most q tiles
//   under causal) first. The warp's K and V rows are A fragments; q/dO
//   tiles stream through the ring with their lse and delta rows, from the
//   tile holding row k0 when causal. Sᵀ = K·qᵀ and dPᵀ = V·dOᵀ; Pᵀ and dSᵀ
//   are built on the accumulator; dV += Pᵀ·dO and dK += dSᵀ·q.
// Where a row is at most 128 bytes the A fragments stay in registers for
// the whole CTA; wider rows would not fit beside the d-wide accumulators
// and are read again from a shared-memory copy for each tile. In f32 each
// tile's dQ, dK and dV are summed in fresh accumulators and added by
// round-to-nearest f32 adds (pv_f32_rn: the tensor core's accumulation
// truncates; one accumulator over T=2048 rows read 2.6e-5 of max|dV| on an
// H100). 1/√d scales the scores after the product and dQ/dK once in the
// epilogue. Each output element is written by one thread after a loop in a
// fixed order, with no atomics, so two calls on the same inputs give
// bitwise-equal results; that is why the backward is two kernels, as in
// the JAX package.
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

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * 32;
// a CTA's own rows (K3) or keys (K4): one m16 tile per warp
constexpr int kBwdBlock = kBwdWarps * 16;

template <typename T, int D>
struct BwdTile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // rows of at most 128 bytes (f32 d=32, bf16 d<=64): the CTA's own rows
  // stay in registers as A fragments. Wider rows would not fit beside the
  // d-wide accumulators: they are re-read from a shared copy each tile.
  static constexpr bool kARegs = D * (int)sizeof(T) <= 128;
  // rows of a streamed tile (K3: keys, K4: q rows): about 8 KB of each
  // tensor, a power of two of at most 64 rows; 16 rows for f32 at d=128
  // (and 80, 96), so that two CTAs fit on an SM
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kBlockN =
      kRowBytes <= 128 ? 64 : pow2_floor(8192 / kRowBytes);
  // row stride in elements (attn_tile.cuh::tile_stride)
  static constexpr int kStride = tile_stride<T, D>();
  static constexpr int kTile = kBlockN * kStride;
  static constexpr int kOwn = kBwdBlock * kStride;
  // two stages of two streamed tiles and of two f32 rows (K3: the key mask;
  // K4: lse and delta), and the CTA's own two tiles when not in registers
  static constexpr int kSmemBytes =
      (2 * 2 * kTile + (kARegs ? 0 : 2 * kOwn)) * (int)sizeof(T) +
      2 * 2 * kBlockN * (int)sizeof(float);
  using AFrag =
      typename std::conditional<kF32, float[D / 8][4], Frag16<D>>::type;
};

// ------------------------------------------------------------------ K3: dQ
// PAD: false for a head dim of exactly D (dh = D), true for a padded
// instantiation (rows of dh elements, common.cuh)
template <typename T, int D, bool PAD>
__device__ __forceinline__ void flash_bwd_dq_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ mask,
    T* __restrict__ dq, int H, int Tlen, float scale, int causal, int dh) {
  using C = BwdTile<T, D>;
  constexpr int BN = C::kBlockN;
  constexpr int STRIDE = C::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [2][BN][STRIDE]
  T* vs = ks + 2 * C::kTile;               // [2][BN][STRIDE]
  T* qs = vs + 2 * C::kTile;               // [64][STRIDE] (wide rows)
  T* dos = qs + C::kOwn;                   // [64][STRIDE] (wide rows)
  float* kok = reinterpret_cast<float*>(qs + (C::kARegs ? 0 : 2 * C::kOwn));

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdBlock;  // heaviest first
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 16 * warp;  // the warp's first row
  const int r0 = wrow + g, r1 = r0 + 8;
  const size_t base = (size_t)bh * Tlen * (PAD ? dh : D);
  const T* kb = k + base;
  const T* vb = v + base;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)b * Tlen;

  const int kend = causal ? min(Tlen, q0 + kBwdBlock) : Tlen;
  const int ntiles = (kend + BN - 1) / BN;

  // one K/V tile (and its mask row) into ring stage st, rows past T zeroed
  auto stage = [&](int tile, int st) {
    const int k0 = tile * BN;
    if constexpr (PAD)
      stage_rows2_pad<T, D, BN, STRIDE, kBwdThreads>(ks + st * C::kTile,
                                                     vs + st * C::kTile, kb,
                                                     vb, k0, Tlen, tid, dh);
    else
      stage_rows2<T, D, BN, STRIDE, kBwdThreads>(ks + st * C::kTile,
                                                 vs + st * C::kTile, kb, vb,
                                                 k0, Tlen, tid);
    if (mrow != nullptr)
      stage_vals<BN, kBwdThreads>(kok + st * BN, mrow, k0, Tlen, tid);
  };

  if constexpr (!C::kARegs && PAD)
    stage_rows2_pad<T, D, kBwdBlock, STRIDE, kBwdThreads>(
        qs, dos, q + base, dout + base, q0, Tlen, tid, dh);
  else if constexpr (!C::kARegs)
    stage_rows2<T, D, kBwdBlock, STRIDE, kBwdThreads>(
        qs, dos, q + base, dout + base, q0, Tlen, tid);
  stage(0, 0);
  cp_async_commit();

  typename C::AFrag qf, dof;
  if constexpr (C::kARegs && PAD) {
    load_a_rows_pad<D>(q + base, r0, r1, Tlen, t, qf, dh);
    load_a_rows_pad<D>(dout + base, r0, r1, Tlen, t, dof, dh);
  } else if constexpr (C::kARegs) {
    load_a_rows<D>(q + base, r0, r1, Tlen, t, qf);
    load_a_rows<D>(dout + base, r0, r1, Tlen, t, dof);
  }
  // rows past T: q = dO = 0 and lse = delta = 0, so their dS is exactly 0
  const size_t rbase = (size_t)bh * Tlen;
  const float lse_r[2] = {r0 < Tlen ? lse[rbase + r0] : 0.f,
                          r1 < Tlen ? lse[rbase + r1] : 0.f};
  const float delta_r[2] = {r0 < Tlen ? delta[rbase + r0] : 0.f,
                            r1 < Tlen ? delta[rbase + r1] : 0.f};

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

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    if constexpr (!C::kARegs) load_a_smem<D, STRIDE>(qs + 16 * warp * STRIDE,
                                                     lane, qf);
    tile_abt<D, BN, STRIDE>(qf, kt, s, lane);     // S = q·Kᵀ
    if constexpr (!C::kARegs) load_a_smem<D, STRIDE>(dos + 16 * warp * STRIDE,
                                                     lane, dof);
    tile_abt<D, BN, STRIDE>(dof, vt, dp, lane);   // dP = dO·Vᵀ

    // only tiles that reach past T, past the warp's first row (causal), or
    // under a key mask need the per-element test
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
        const float p = expf(x - lse_r[e >> 1]);
        s[j][e] = p * (dp[j][e] - delta_r[e >> 1]);   // dS
      }
    }
    tile_pb<D, BN, STRIDE>(s, kt, acc, lane);       // dQ += dS·K
    __syncthreads();  // stage it & 1 is consumed: the next stage() may fill it
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = hr ? r1 : r0;
    if (row >= Tlen) continue;
    if constexpr (PAD)
      store_acc_row_pad<T, D>(dq + base + (size_t)row * dh, acc, hr, t,
                              scale, dh);
    else
      store_acc_row<T, D>(dq + base + (size_t)row * D, acc, hr, t, scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ mask, T* __restrict__ dq,
                        int H, int Tlen, float scale, int causal) {
  flash_bwd_dq_body<T, D, false>(q, k, v, dout, lse, delta, mask, dq, H,
                                 Tlen, scale, causal, D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_pad_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const float* __restrict__ mask,
                            T* __restrict__ dq, int H, int Tlen, float scale,
                            int causal, int dh) {
  flash_bwd_dq_body<T, D, true>(q, k, v, dout, lse, delta, mask, dq, H, Tlen,
                                scale, causal, dh);
}

// --------------------------------------------------------------- K4: dK/dV
template <typename T, int D, bool PAD>
__device__ __forceinline__ void flash_bwd_dkv_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ mask,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Tlen, float scale,
    int causal, int dh) {
  using C = BwdTile<T, D>;
  constexpr int BN = C::kBlockN;
  constexpr int STRIDE = C::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [2][BN][STRIDE]
  T* dos = qs + 2 * C::kTile;              // [2][BN][STRIDE]
  T* ks = dos + 2 * C::kTile;              // [64][STRIDE] (wide rows)
  T* vs = ks + C::kOwn;                    // [64][STRIDE] (wide rows)
  // [2][lse BN, delta BN]
  float* rowv = reinterpret_cast<float*>(ks + (C::kARegs ? 0 : 2 * C::kOwn));

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int k0 = blockIdx.y * kBwdBlock;  // low key tiles (most work) first
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wkey = k0 + 16 * warp;  // the warp's first key
  const int key0 = wkey + g, key1 = key0 + 8;
  const size_t base = (size_t)bh * Tlen * (PAD ? dh : D);
  const size_t rbase = (size_t)bh * Tlen;
  const T* qb = q + base;
  const T* db = dout + base;
  // this thread's two keys against the key row (a key past T is never
  // written, so its flag does not matter)
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)b * Tlen;
  const bool key_ok[2] = {
      mrow == nullptr || (key0 < Tlen && mrow[key0] != 0.f),
      mrow == nullptr || (key1 < Tlen && mrow[key1] != 0.f)};

  // causal: rows before the tile holding row k0 see none of these keys
  const int first = causal ? k0 / BN : 0;
  const int ntiles = (Tlen + BN - 1) / BN - first;

  // one q/dO tile and its lse and delta rows into ring stage st, rows past
  // T zeroed
  auto stage = [&](int tile, int st) {
    const int r0 = tile * BN;
    if constexpr (PAD)
      stage_rows2_pad<T, D, BN, STRIDE, kBwdThreads>(qs + st * C::kTile,
                                                     dos + st * C::kTile, qb,
                                                     db, r0, Tlen, tid, dh);
    else
      stage_rows2<T, D, BN, STRIDE, kBwdThreads>(qs + st * C::kTile,
                                                 dos + st * C::kTile, qb, db,
                                                 r0, Tlen, tid);
    stage_vals<BN, kBwdThreads>(rowv + st * 2 * BN, lse + rbase, r0, Tlen,
                                tid);
    stage_vals<BN, kBwdThreads>(rowv + st * 2 * BN + BN, delta + rbase, r0,
                                Tlen, tid);
  };

  if constexpr (!C::kARegs && PAD)
    stage_rows2_pad<T, D, kBwdBlock, STRIDE, kBwdThreads>(
        ks, vs, k + base, v + base, k0, Tlen, tid, dh);
  else if constexpr (!C::kARegs)
    stage_rows2<T, D, kBwdBlock, STRIDE, kBwdThreads>(
        ks, vs, k + base, v + base, k0, Tlen, tid);
  stage(first, 0);
  cp_async_commit();

  typename C::AFrag kf, vf;
  if constexpr (C::kARegs && PAD) {
    load_a_rows_pad<D>(k + base, key0, key1, Tlen, t, kf, dh);
    load_a_rows_pad<D>(v + base, key0, key1, Tlen, t, vf, dh);
  } else if constexpr (C::kARegs) {
    load_a_rows<D>(k + base, key0, key1, Tlen, t, kf);
    load_a_rows<D>(v + base, key0, key1, Tlen, t, vf);
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) stage(first + it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed (tile it+1 may be in flight)
    __syncthreads();
    const T* qt = qs + (it & 1) * C::kTile;
    const T* dot = dos + (it & 1) * C::kTile;
    const float* lse_t = rowv + (it & 1) * 2 * BN;
    const float* delta_t = lse_t + BN;
    const int q0 = (first + it) * BN;

    // Sᵀ (16 keys x BN rows) and dPᵀ on the accumulators
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    if constexpr (!C::kARegs) load_a_smem<D, STRIDE>(ks + 16 * warp * STRIDE,
                                                     lane, kf);
    tile_abt<D, BN, STRIDE>(kf, qt, s, lane);     // Sᵀ = K·qᵀ
    if constexpr (!C::kARegs) load_a_smem<D, STRIDE>(vs + 16 * warp * STRIDE,
                                                     lane, vf);
    tile_abt<D, BN, STRIDE>(vf, dot, dp, lane);   // dPᵀ = V·dOᵀ

    // only tiles that reach past T, before the warp's last key (causal),
    // or under a key mask need the per-element test
    const bool edge = mrow != nullptr || q0 + BN > Tlen ||
                      (causal && q0 < wkey + 15);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);  // the row within the tile
        float x = s[j][e] * scale;
        if (edge && ((causal && (e < 2 ? key0 : key1) > q0 + c) ||
                     !key_ok[e >> 1]))
          x = kNegInf;
        float p = expf(x - lse_t[c]);
        if (edge && q0 + c >= Tlen) p = 0.f;
        s[j][e] = p;                                 // Pᵀ
        dp[j][e] = p * (dp[j][e] - delta_t[c]);      // dSᵀ
      }
    }
    tile_pb<D, BN, STRIDE>(s, dot, dv_acc, lane);   // dV += Pᵀ·dO
    tile_pb<D, BN, STRIDE>(dp, qt, dk_acc, lane);   // dK += dSᵀ·q
    __syncthreads();  // stage it & 1 is consumed: the next stage() may fill it
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = hr ? key1 : key0;
    if (key >= Tlen) continue;
    if constexpr (PAD) {
      store_acc_row_pad<T, D>(dk + base + (size_t)key * dh, dk_acc, hr, t,
                              scale, dh);
      store_acc_row_pad<T, D>(dv + base + (size_t)key * dh, dv_acc, hr, t,
                              1.f, dh);
    } else {
      store_acc_row<T, D>(dk + base + (size_t)key * D, dk_acc, hr, t, scale);
      store_acc_row<T, D>(dv + base + (size_t)key * D, dv_acc, hr, t, 1.f);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ mask, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Tlen, float scale,
                         int causal) {
  flash_bwd_dkv_body<T, D, false>(q, k, v, dout, lse, delta, mask, dk, dv, H,
                                  Tlen, scale, causal, D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkv_pad_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ mask,
                             T* __restrict__ dk, T* __restrict__ dv, int H,
                             int Tlen, float scale, int causal, int dh) {
  flash_bwd_dkv_body<T, D, true>(q, k, v, dout, lse, delta, mask, dk, dv, H,
                                 Tlen, scale, causal, dh);
}

// ------------------------------------------------------------------ launch
// The kernels' shared memory is opted in above 48 KB once per instantiation
// and device (``once_per_device``). dh is the head dim: PAD false runs the
// kernel of exactly D = dh, PAD true its padded twin (common.cuh).
template <typename T, int D, bool PAD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* mask,
              void* dq, void* /*unused*/, int B, int H, int Tlen, int causal,
              int dh, cudaStream_t stream) {
  constexpr int smem = BwdTile<T, D>::kSmemBytes;
  static PerDevice opt;
  const cudaError_t attr = once_per_device(opt, [](int, int&) {
    if constexpr (PAD)
      return cudaFuncSetAttribute(flash_bwd_dq_pad_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
    else
      return cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  });
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (Tlen + kBwdBlock - 1) / kBwdBlock;
  if (tiles > 65535) return -1;
  const dim3 grid(B * H, tiles);
  const float scale = (float)(1.0 / std::sqrt((double)dh));
  if constexpr (PAD)
    flash_bwd_dq_pad_kernel<T, D><<<grid, kBwdThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        mask, static_cast<T*>(dq), H, Tlen, scale, causal, dh);
  else
    flash_bwd_dq_kernel<T, D><<<grid, kBwdThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        mask, static_cast<T*>(dq), H, Tlen, scale, causal);
  return 0;
}

template <typename T, int D, bool PAD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* mask,
               void* dk, void* dv, int B, int H, int Tlen, int causal, int dh,
               cudaStream_t stream) {
  constexpr int smem = BwdTile<T, D>::kSmemBytes;
  static PerDevice opt;
  const cudaError_t attr = once_per_device(opt, [](int, int&) {
    if constexpr (PAD)
      return cudaFuncSetAttribute(flash_bwd_dkv_pad_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
    else
      return cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  });
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (Tlen + kBwdBlock - 1) / kBwdBlock;
  if (tiles > 65535) return -1;
  const dim3 grid(B * H, tiles);
  const float scale = (float)(1.0 / std::sqrt((double)dh));
  if constexpr (PAD)
    flash_bwd_dkv_pad_kernel<T, D><<<grid, kBwdThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        mask, static_cast<T*>(dk), static_cast<T*>(dv), H, Tlen, scale,
        causal, dh);
  else
    flash_bwd_dkv_kernel<T, D><<<grid, kBwdThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        mask, static_cast<T*>(dk), static_cast<T*>(dv), H, Tlen, scale,
        causal);
  return 0;
}

}  // namespace dl4j

// One case of the width switches below, by the tensors' type (0 f32, 1
// bf16, 2 f16); PAD selects the padded instantiation.
#define DL4J_BWD_CASE(DIM, PAD, LAUNCH)                                     \
  case DIM:                                                                 \
    switch (dtype) {                                                        \
      case 0:                                                               \
        return dl4j::LAUNCH<float, DIM, PAD>(q, k, v, dout, lse, delta,     \
                                             mask, out0, out1, B, H, Tlen,  \
                                             causal, D, stream);            \
      case 1:                                                               \
        return dl4j::LAUNCH<__nv_bfloat16, DIM, PAD>(                       \
            q, k, v, dout, lse, delta, mask, out0, out1, B, H, Tlen, causal, \
            D, stream);                                                     \
      case 2:                                                               \
        return dl4j::LAUNCH<__half, DIM, PAD>(q, k, v, dout, lse, delta,    \
                                              mask, out0, out1, B, H, Tlen, \
                                              causal, D, stream);           \
      default:                                                              \
        return -5;                                                          \
    }

// The exact instantiation of D where there is one, else the padded one of
// pad_dim(D); -2 for a head dim no kernel takes.
#define DL4J_BWD_SWITCH(LAUNCH)                                             \
  if (dl4j::exact_dim(D)) {                                                 \
    switch (D) {                                                            \
      DL4J_BWD_CASE(8, false, LAUNCH)                                       \
      DL4J_BWD_CASE(16, false, LAUNCH)                                      \
      DL4J_BWD_CASE(32, false, LAUNCH)                                      \
      DL4J_BWD_CASE(64, false, LAUNCH)                                      \
      DL4J_BWD_CASE(128, false, LAUNCH)                                     \
    }                                                                       \
  }                                                                         \
  switch (dl4j::pad_dim(D)) {                                               \
    DL4J_BWD_CASE(8, true, LAUNCH)                                          \
    DL4J_BWD_CASE(16, true, LAUNCH)                                         \
    DL4J_BWD_CASE(32, true, LAUNCH)                                         \
    DL4J_BWD_CASE(48, true, LAUNCH)                                         \
    DL4J_BWD_CASE(64, true, LAUNCH)                                         \
    DL4J_BWD_CASE(80, true, LAUNCH)                                         \
    DL4J_BWD_CASE(96, true, LAUNCH)                                         \
    DL4J_BWD_CASE(128, true, LAUNCH)                                        \
    default:                                                                \
      return -2;                                                            \
  }

// Launch K3 (dq into out0) on `stream`; 0 after a launch (the caller checks
// it with cudaGetLastError), nonzero for an unsupported configuration,
// which launches nothing. dtype as for DL4J_BWD_CASE.
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const float* mask,
                                 void* dq, int B, int H, int Tlen, int D,
                                 int dtype, int causal,
                                 cudaStream_t stream) {
  if (Tlen < 1 || B * H < 1 || B * H > 65535) return -1;
  void* out0 = dq;
  void* out1 = nullptr;
  DL4J_BWD_SWITCH(launch_dq)
}

// Launch K4 (dk into out0, dv into out1) on `stream`; return codes as above.
extern "C" int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const float* mask,
                                  void* dk, void* dv, int B, int H, int Tlen,
                                  int D, int dtype, int causal,
                                  cudaStream_t stream) {
  if (Tlen < 1 || B * H < 1 || B * H > 65535) return -1;
  void* out0 = dk;
  void* out1 = dv;
  DL4J_BWD_SWITCH(launch_dkv)
}

#undef DL4J_BWD_SWITCH
#undef DL4J_BWD_CASE

// Dynamic shared memory of one K3 or K4 CTA in bytes (the two kernels'
// layouts take the same size; for reports) at the width a head dim D runs
// at; dtype as for dl4j_flash_bwd_dq; -2 for a head dim no kernel takes.
extern "C" int dl4j_flash_bwd_smem(int D, int dtype) {
#define DL4J_BWD_SMEM(DIM)                                            \
  case DIM:                                                           \
    return dtype == 0 ? dl4j::BwdTile<float, DIM>::kSmemBytes         \
                      : dl4j::BwdTile<__half, DIM>::kSmemBytes;
  switch (dl4j::pad_dim(D)) {
    DL4J_BWD_SMEM(8)
    DL4J_BWD_SMEM(16)
    DL4J_BWD_SMEM(32)
    DL4J_BWD_SMEM(48)
    DL4J_BWD_SMEM(64)
    DL4J_BWD_SMEM(80)
    DL4J_BWD_SMEM(96)
    DL4J_BWD_SMEM(128)
    default:
      return -2;
  }
#undef DL4J_BWD_SMEM
}
