// K2: paged-KV attention read for Hopper (sm_90a): the kernels and their
// launchers, shared by paged_attn.cu (the exact head dims and the C entry
// points) and paged_attn_pad.cu (the padded head dims, a translation unit
// of its own so that the two compile in parallel).
//
// Replaces deeplearning4j_tpu/nn/conf/layers/paged_attention.py::
// _paged_attn_kernel (launched by _pallas_paged_attention). Attends a query
// chunk q [B, H, T, d] (T = 1 for decode, up to the prefill chunk; f32,
// bf16 or f16) over the pool pages that row b's block table bt [B, NP]
// names, read in place from kp, vp [P, H, ps, d] (of q's type, or int8
// codes with the f32 per-token-per-head scales kscales, vscales
// [P, H, ps]). Key column c of row b is pool page bt[b, c / ps] at offset
// c % ps. Query row r sees columns c <= pos[b] + r, and with a [B, NP·ps]
// key-valid plane only the columns it marks nonzero. Output: the
// pre-projection context [B, H, T, d] in q's type. As in the Pallas
// kernel, every value is widened to f32 as it lands, the softmax and w·V
// accumulate in f32, and o is rounded to q's type once at the end.
//
// What bounds it on this card: bytes. A decode step reads every resident
// K/V byte of every row once and does 4·d FLOPs per key (< 1 FLOP/byte in
// f32, < 2 in 16 bits); prefill chunks raise the ratio to about T FLOPs
// per byte, still far under the ridge at the slice's widths.
//
// Two routes. Both read bt[b, i] themselves (Hopper has no scalar
// prefetch) and walk columns only up to their causal limit
// min(NP·ps, pos[b] + last row + 1): the JAX kernel walks all NP pages.
// Both fold keys in with an online softmax in f32, so the gathered
// [B, H, NP·ps, d] view the plain version builds never exists. The JAX
// kernel instead runs one max-subtract softmax at its last page (to stay
// bitwise equal to its gather path); this port's contract is allclose on
// the context plus exact greedy tokens through the server. Masked columns
// score -1e30 and l is clamped before the divide, so a row whose columns
// are all masked (a padded row routed to garbage page 0) comes out finite.
// Each output is written by one thread in a fixed order and no route uses
// atomics: two calls are bitwise equal.
//
// Head dims 8, 16, 32, 64 and 128 run their own instantiations. Any other
// d with 4 <= d <= 128 and d % 4 == 0 runs a padded instantiation
// (common.cuh): the chunk route at the next of 8, 16, 32, 48, 64, 80, 96,
// 128, the decode route at the next power of two (its lane groups split a
// key row over a power-of-two number of lanes: d = 48 runs at 64, 80 and
// 96 at 128, so a quarter to three eighths of the lanes of a row load
// nothing). Pages keep rows of d elements; the padded kernels read them
// into zero-filled columns past d, by the widest copy a row of d elements
// keeps aligned (16 bytes; 8 for 16-bit rows of d % 8 == 4 and int8 rows of
// d % 16 == 8; 4 for int8 rows of d % 8 == 4), the decode route by
// 4-element vectors (16, 8 or 4 bytes), and scale by 1/√d.
//
// Decode route (T <= 4: decode and speculative verify): one CTA of 8 warps
// per (b, h). The walked pages are cut into 8 contiguous ranges, one per
// warp, so each warp pays the memory latency of its own range once and not
// that of every tile of the row. A warp loads its slice of the block-table
// row once (a lane per page, handed out by shuffle), then reads its keys as
// 16-byte (4 f32 or 8 bf16/f16) or 8-byte (8 int8) vectors widened to f32,
// d / (vector width) lanes per key row (a head's page is contiguous, [ps,
// d]): at d=8 one lane holds a whole bf16/f16 or int8 row and two lanes an
// f32 one, at d=16 two or four, every lane on a full vector; each warp step
// covers 32 / (lanes per row) key rows, and a batch of steps (64 key rows
// a warp) is in flight per lane before any arithmetic. The q rows sit in registers and each loaded key
// serves all of them. Each lane group keeps its own (m, l, acc); the groups
// merge by shuffle, then the 8 warps' partials merge in shared memory in
// fixed warp order. A warp with an empty range keeps m = -1e30, l = 0 and
// adds nothing.
//
// Chunk route (T > 4: prefill): K1's tensor-core design (flash_fwd.cu) with
// a block-table loader. One CTA per (b, h, 64-row q tile), 4 warps of 16
// rows, one mma m-tile each; q is pre-scaled by log2(e)/√d and held as mma
// A fragments, so the softmax runs in base 2 (one ex2.approx per score);
// rows past T are zeros and are not stored. The CTA first copies the
// block-table entries of the pages it walks into shared memory, then
// streams 64-key K/V tiles (32 past d=64 for f32 and int8 pools, for
// registers) through a cp.async
// ring of three stages (two for f32 at d=128, so that two CTAs fit on an
// SM): each key row resolves its pool row from one shared read,
// ((bt[c / ps]·H + h)·ps + c % ps), so a tile may cross pages and any ps
// works, and lands as 16-byte copies (int8 as codes, 16 a copy; bf16/f16
// 8 a copy; an int8 row of d=8 as one 8-byte copy); its
// key-valid column and, for int8, its two scales land in the same stage by
// 4-byte copies. Columns at or past the walk's end are zero-filled (0·NaN
// would poison P·V) and score -inf. The products are warp-level mma.sync
// m16n8k8 TF32 with f32 accumulators. f32 pools run three products of TF32
// hi/lo splits (about 2^-21 relative error where one TF32 product keeps
// 1e-3), as K1 does, but each landed K/V tile is split once by the whole
// CTA into a hi plane (in place) and a lo plane, not once per warp. int8
// pools use that a code in [-127, 127] is exact in TF32: the codes stay as
// staged, q and P ⊙ vscale are split in three TF32 parts (about 2^-33
// relative error), so S = kscale[c]·(q·code) and O += (P ⊙ vscale[c])·code
// are the exact products up to f32 adds, three products each, every 8-key
// group summed in fresh accumulators. (Two-part splits, with the codes or
// with code·scale dequantized in shared memory, moved a greedy token of
// the int8 serve at a near-tie: the later layers quantize the K/V that
// this read feeds, and any rounding pattern of the read shows there.)
// P·V is summed per tile in fresh
// accumulators added by f32 adds (as attn_tile.cuh::pv_f32_rn), since the
// tensor core's accumulation truncates and a walk reaches thousands of
// keys. 16-bit pools take K1's 16-bit path (attn_tile.cuh::scores_16,
// pv_16): q as m16n8k16 A fragments of its own type, K and V fragments by
// ldmatrix straight from the ring (no split planes, so a CTA needs less
// than half the f32 shared memory), the scores scaled after the product,
// and P in two 16-bit terms; an int8 pool under a 16-bit q runs the int8
// path above on q widened to f32. The online softmax runs on the
// accumulator fragments. Masks run
// only where needed: the key-valid test on tiles holding a masked column
// (found by one __syncthreads_and), the causal and walk-end tests on tiles
// that reach past a warp's first row; a warp whose 16 rows all precede a
// tile causally skips it (it would add exactly 0). Where the grid would
// hold fewer CTAs than the card has SMs (the prefill rounds of a few short
// prompts), the walk of each q tile is cut into `splits` contiguous ranges
// of whole tiles, one CTA each, that write their unnormalised (m, l, acc)
// to a workspace; paged_merge_kernel then merges each row's partials in
// fixed split order. An empty range writes m = -1e30, l = 0, acc = 0 and
// adds nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>
#include <type_traits>

#include "attn_tile.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace dl4j {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kDecodeMaxT = 4;  // chunks of up to 4 rows take the decode route

// q and o elements widened to f32 and rounded back (round to nearest even)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// One vector load of a key row's slice, widened to f32: 4 f32 (16 bytes),
// 8 int8 codes (8 bytes) or 8 bf16/f16 values (16 bytes).
template <typename KV>
struct KvVec;
template <>
struct KvVec<float> {
  using type = float4;
  static constexpr int kN = 4;
  __device__ static void widen(const float4& x, float (&f)[4]) {
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  }
};
template <>
struct KvVec<int8_t> {
  using type = int2;
  static constexpr int kN = 8;
  __device__ static void widen(const int2& x, float (&f)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = (float)(signed char)(x.x >> (8 * i));
      f[4 + i] = (float)(signed char)(x.y >> (8 * i));
    }
  }
};
template <>
struct KvVec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int kN = 8;
  // a bf16 value is the high half of its f32: the widening is exact
  __device__ static void widen(const uint4& x, float (&f)[8]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct KvVec<__half> {
  using type = uint4;
  static constexpr int kN = 8;
  __device__ static void widen(const uint4& x, float (&f)[8]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
};

// Four elements a lane, for the decode route's padded instantiations (a
// row of d % 8 == 4 16-bit elements is only 8-byte aligned, of int8 ones
// 4-byte): f32 as KvVec<float>, 16-bit values 8 bytes, int8 codes 4 bytes.
template <typename KV>
struct KvVec4;
template <>
struct KvVec4<float> : KvVec<float> {};
template <>
struct KvVec4<int8_t> {
  using type = int;
  static constexpr int kN = 4;
  __device__ static void widen(const int& x, float (&f)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = (float)(signed char)(x >> (8 * i));
  }
};
template <>
struct KvVec4<__nv_bfloat16> {
  using type = uint2;
  static constexpr int kN = 4;
  __device__ static void widen(const uint2& x, float (&f)[4]) {
    const uint32_t w[2] = {x.x, x.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct KvVec4<__half> {
  using type = uint2;
  static constexpr int kN = 4;
  __device__ static void widen(const uint2& x, float (&f)[4]) {
    const uint32_t w[2] = {x.x, x.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
};

// Decode route: see the header. R = 1 (T = 1) or kDecodeMaxT (T <= 4; rows
// past T are computed on zeros and not stored). QT is q's and o's type, KV
// the pools' (QT itself, or int8 codes). Vec is KvVec<KV> and PAD false
// for a head dim of exactly D (dh = D); Vec is KvVec4<KV> and PAD true for
// a head dim dh padded to the power of two D: the lanes of a key row whose
// columns lie past dh load nothing and hold zeros.
template <typename QT, typename KV, int D, int R, typename Vec, bool PAD>
__device__ __forceinline__ void paged_decode_body(
    const QT* __restrict__ q, const void* __restrict__ kp_,
    const void* __restrict__ vp_, const float* __restrict__ kscales,
    const float* __restrict__ vscales, const int* __restrict__ bt,
    const int* __restrict__ pos, const float* __restrict__ key_valid,
    QT* __restrict__ o, int H, int T, int ps, int NP, float scale, int dh) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int kN = Vec::kN;           // elements per lane per key row
  constexpr int kLanes = D / kN;        // lanes per key row (power of 2)
  constexpr int kKeys = 32 / kLanes;    // key rows per warp step
  constexpr int kU = (64 / kKeys) < 8 ? (64 / kKeys) : 8;  // steps in flight
  const KV* kp = static_cast<const KV*>(kp_);
  const KV* vp = static_cast<const KV*>(vp_);

  __shared__ float red_m[kDecodeWarps][R];
  __shared__ float red_l[kDecodeWarps][R];
  __shared__ float red_acc[kDecodeWarps][R][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane / kLanes, sub = lane % kLanes;
  const int Tmax = NP * ps;
  const int ld = PAD ? dh : D;          // elements per row in memory
  // this lane's columns hold data (PAD: the lanes past dh hold zeros)
  const bool cols = !PAD || sub * kN < dh;
  const size_t qbase = ((size_t)b * H + h) * T * ld;

  float qr[R][kN];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < kN; ++e)
      qr[r][e] = r < T && cols
                     ? to_f32(q[qbase + (size_t)r * ld + sub * kN + e]) * scale
                     : 0.f;

  float m[R], l[R], acc[R][kN];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[r][e] = 0.f;
  }

  // this warp's contiguous range of the walked pages
  const int p0 = pos[b];
  const int kend = min(Tmax, p0 + T);
  const int npages = (kend + ps - 1) / ps;
  const int per_warp = (npages + kDecodeWarps - 1) / kDecodeWarps;
  const int pg_begin = min(npages, warp * per_warp);
  const int pg_end = min(npages, pg_begin + per_warp);
  const int* btb = bt + (size_t)b * NP;
  const float* kvrow =
      key_valid == nullptr ? nullptr : key_valid + (size_t)b * Tmax;

  for (int pc = pg_begin; pc < pg_end; pc += 32) {
    // a lane per page of this chunk of the warp's block-table slice
    const int npc = min(32, pg_end - pc);
    const int my_page = lane < npc ? btb[pc + lane] : 0;
    const int c_end = min(kend, (pc + npc) * ps);
    for (int c0 = pc * ps; c0 < c_end; c0 += kU * kKeys) {
      typename Vec::type kr[kU], vr[kU];
      float ksc[kU], vsc[kU];
      bool ok[kU], seen[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = c0 + u * kKeys + grp;
        ok[u] = c < c_end;
        const int page = __shfl_sync(0xffffffffu, my_page,
                                     ok[u] ? c / ps - pc : 0);
        const size_t row = ((size_t)page * H + h) * ps + c % ps;
        const size_t off = row * ld + sub * kN;
        const bool ld_ok = ok[u] && cols;
        kr[u] = ld_ok ? *reinterpret_cast<const typename Vec::type*>(kp + off)
                      : typename Vec::type{};
        vr[u] = ld_ok ? *reinterpret_cast<const typename Vec::type*>(vp + off)
                      : typename Vec::type{};
        if (QUANT) {
          ksc[u] = ok[u] ? kscales[row] : 0.f;
          vsc[u] = ok[u] ? vscales[row] : 0.f;
        }
        seen[u] = ok[u] && (kvrow == nullptr || kvrow[c] != 0.f);
      }

      float s[kU][R];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float kf[kN];
        Vec::widen(kr[u], kf);
        if (QUANT) {
#pragma unroll
          for (int e = 0; e < kN; ++e) kf[e] *= ksc[u];
        }
        const int c = c0 + u * kKeys + grp;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < kN; ++e) part += qr[r][e] * kf[e];
#pragma unroll
          for (int x = 1; x < kLanes; x <<= 1)
            part += __shfl_xor_sync(0xffffffffu, part, x);
          s[u][r] = !ok[u] ? neg_inf()
                           : (seen[u] && c <= p0 + r ? part : kNegInf);
        }
      }

#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < kU; ++u) mx = fmaxf(mx, s[u][r]);
        const float alpha = expf(m[r] - mx);
        m[r] = mx;
        l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[r][e] *= alpha;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float p = expf(s[u][r] - mx);
          float vf[kN];
          Vec::widen(vr[u], vf);
          l[r] += p;
#pragma unroll
          for (int e = 0; e < kN; ++e)
            acc[r][e] += p * (QUANT ? vf[e] * vsc[u] : vf[e]);
        }
      }
    }
  }

  // merge the lane groups of the warp (lanes sub, sub + kLanes, ...)
#pragma unroll
  for (int x = kLanes; x < 32; x <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], x);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], x);
      const float mx = fmaxf(m[r], mo);
      const float ea = expf(m[r] - mx), eb = expf(mo - mx);
      l[r] = l[r] * ea + lo * eb;
#pragma unroll
      for (int e = 0; e < kN; ++e)
        acc[r][e] = acc[r][e] * ea +
                    __shfl_xor_sync(0xffffffffu, acc[r][e], x) * eb;
      m[r] = mx;
    }
  }
  if (lane < kLanes) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < kN; ++e) red_acc[warp][r][sub * kN + e] = acc[r][e];
      if (lane == 0) {
        red_m[warp][r] = m[r];
        red_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // merge the warps' partials in fixed warp order
  for (int i = tid; i < min(T, R) * D; i += kDecodeThreads) {
    const int r = i / D, c = i % D;
    if (PAD && c >= dh) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, red_m[w][r]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float e = expf(red_m[w][r] - mx);
      lsum += red_l[w][r] * e;
      out += red_acc[w][r][c] * e;
    }
    o[qbase + (size_t)r * ld + c] = from_f32<QT>(out / fmaxf(lsum, 1e-30f));
  }
}

template <typename QT, typename KV, int D, int R>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_kernel(const QT* __restrict__ q,
                        const void* __restrict__ kp_,
                        const void* __restrict__ vp_,
                        const float* __restrict__ kscales,
                        const float* __restrict__ vscales,
                        const int* __restrict__ bt, const int* __restrict__ pos,
                        const float* __restrict__ key_valid,
                        QT* __restrict__ o, int H, int T, int ps, int NP,
                        float scale) {
  paged_decode_body<QT, KV, D, R, KvVec<KV>, false>(
      q, kp_, vp_, kscales, vscales, bt, pos, key_valid, o, H, T, ps, NP,
      scale, D);
}

template <typename QT, typename KV, int D, int R>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_pad_kernel(const QT* __restrict__ q,
                            const void* __restrict__ kp_,
                            const void* __restrict__ vp_,
                            const float* __restrict__ kscales,
                            const float* __restrict__ vscales,
                            const int* __restrict__ bt,
                            const int* __restrict__ pos,
                            const float* __restrict__ key_valid,
                            QT* __restrict__ o, int H, int T, int ps, int NP,
                            float scale, int dh) {
  paged_decode_body<QT, KV, D, R, KvVec4<KV>, true>(
      q, kp_, vp_, kscales, vscales, bt, pos, key_valid, o, H, T, ps, NP,
      scale, dh);
}

// dh: the head dim (PAD false: dh = D)
template <typename QT, typename KV, int D, int R, bool PAD>
int launch_decode(const QT* q, const void* kp, const void* vp,
                  const float* kscales, const float* vscales, const int* bt,
                  const int* pos, const float* key_valid, QT* o, int B,
                  int H, int T, int ps, int NP, int dh, cudaStream_t stream) {
  const dim3 grid(H, B);
  const float scale = (float)(1.0 / std::sqrt((double)dh));
  if constexpr (PAD)
    paged_decode_pad_kernel<QT, KV, D, R><<<grid, kDecodeThreads, 0, stream>>>(
        q, kp, vp, kscales, vscales, bt, pos, key_valid, o, H, T, ps, NP,
        scale, dh);
  else
    paged_decode_kernel<QT, KV, D, R><<<grid, kDecodeThreads, 0, stream>>>(
        q, kp, vp, kscales, vscales, bt, pos, key_valid, o, H, T, ps, NP,
        scale);
  return 0;
}

constexpr int kChunkWarps = 4;
constexpr int kChunkThreads = kChunkWarps * 32;
constexpr int kChunkRows = kChunkWarps * 16;  // q rows of a CTA

template <typename KV_, int D>
struct ChunkTile {
  using KV = KV_;
  static constexpr bool kCodes = std::is_same<KV, int8_t>::value;
  static constexpr bool kF32 = std::is_same<KV, float>::value;
  // keys per tile: 32 past d=64 (80, 96, 128) keeps S and O in registers
  // for f32 and int8 (their q fragments are f32), as in K1; 16-bit pools
  // keep 64
  static constexpr int kBlockN = (D > 64 && sizeof(KV) != 2) ? 32 : 64;
  // row stride in elements (attn_tile.cuh::tile_stride), but int8 rows of
  // d = 16, 48 and 80 take 32 bytes of padding: a stride of a multiple of
  // 32 bytes would put rows g and g + 4 (or g + 2) of a fragment read on
  // one bank, a stride of 16 more than a multiple of 32 spreads the 8 rows
  // over all 32
  static constexpr int kStride =
      (kCodes && D % 32 == 16) ? D + 32 : tile_stride<KV, D>();
  static constexpr int kTileBytes = kBlockN * kStride * (int)sizeof(KV);
  // f32 rows of a stage beside K and V: key-valid, and for int8 the K and
  // V scales
  static constexpr int kVals = kCodes ? 3 : 1;
  static constexpr int kStageBytes =
      2 * kTileBytes + kVals * kBlockN * (int)sizeof(float);
  // ring stages: three keep two tiles in flight; f32 at d=128 keeps two,
  // so that two CTAs fit on an SM
  static constexpr int kStages = (kF32 && D == 128) ? 2 : 3;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // f32: the TF32 lo planes of the current K and V tiles ([BN][kStride],
  // written once per tile; their hi parts replace the raw values in the
  // ring stage); int8 and 16-bit pools are read from the ring as they are
  static constexpr int kLoBytes = kF32 ? 2 * kTileBytes : 0;
  // bytes of one key-row copy: 16, or the whole row where it is shorter
  // (int8 at d=8: 8 bytes)
  static constexpr int kCopyBytes =
      D * (int)sizeof(KV) < 16 ? D * (int)sizeof(KV) : 16;
  // copies of K (and as many of V) per tile at the exact widths: a whole
  // number per thread, or (d <= 16) fewer than one per thread (checked in
  // the kernel; padded widths copy by stage_kv_pad)
  static constexpr int kCopies = kBlockN * D * (int)sizeof(KV) / kCopyBytes;
};

// 2^x as one MUFU.EX2 (ex2.approx.ftz: about 2^-22 relative error; a
// result under 2^-126 flushes to 0, which adds nothing a softmax sum could
// show)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = a + b + c + O(2^-33 |x|), all three TF32: three rounding splits.
__device__ __forceinline__ void tf32_split3(float x, uint32_t& a, uint32_t& b,
                                            uint32_t& c) {
  a = tf32_rna(x);
  const float r = x - __uint_as_float(a);  // exact
  b = tf32_rna(r);
  c = tf32_rna(r - __uint_as_float(b));
}

// TF32 bits of an int8 code: |code| <= 127 needs 7 significant bits, so
// the f32 value is already a TF32 value.
__device__ __forceinline__ uint32_t code_tf32(int8_t c) {
  return __float_as_uint((float)c);
}

// d (16 x 8) += (a1 + a2 + a3)·b for exact TF32 b, the three products summed
// smallest first in a fresh accumulator and added to d by f32 adds that
// round to nearest: the tensor core's accumulation truncates.
__device__ __forceinline__ void mma_split3_rn(float (&d)[4],
                                              const uint32_t (&a1)[4],
                                              const uint32_t (&a2)[4],
                                              const uint32_t (&a3)[4],
                                              const uint32_t (&b)[2]) {
  float f[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(f, a3, b);
  mma_tf32(f, a2, b);
  mma_tf32(f, a1, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += f[e];
}

// S (16 x BN) += A (16 x D) · Cᵀ, C a [BN][STRIDE] tile of int8 codes in
// shared memory: A (raw f32 fragments, as scores_f32 takes them) split in
// three TF32 parts at use, the codes exact, so the sum is the exact dot
// product up to f32 adds.
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void scores_codes(const float (&qf)[D / 8][4],
                                             const int8_t* __restrict__ ct,
                                             float (&s)[BN / 8][4], int g,
                                             int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t a1[4], a2[4], a3[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split3(qf[kk][i], a1[i], a2[i], a3[i]);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int8_t* cr = ct + (8 * j + g) * STRIDE + 8 * kk + t;
      const uint32_t b[2] = {code_tf32(cr[0]), code_tf32(cr[4])};
      mma_split3_rn(s[j], a1, a2, a3, b);
    }
  }
}

// acc (16 x D) += (P ⊙ sc) (16 x BN) · C, C a [BN][STRIDE] int8 code tile
// and sc its BN per-key scales, in pv_f32_rn's fragment order: the scaled
// P split in three TF32 parts, the codes exact, each 8-key group summed in
// fresh accumulators and added by f32 adds.
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void pv_codes_rn(const float (&p)[BN / 8][4],
                                            const float* __restrict__ sc,
                                            const int8_t* __restrict__ ct,
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
      const float s0 = sc[8 * j + 2 * t], s1 = sc[8 * j + 2 * t + 1];
      uint32_t a1[4], a2[4], a3[4];
      tf32_split3(p[j][0] * s0, a1[0], a2[0], a3[0]);
      tf32_split3(p[j][2] * s0, a1[1], a2[1], a3[1]);
      tf32_split3(p[j][1] * s1, a1[2], a2[2], a3[2]);
      tf32_split3(p[j][3] * s1, a1[3], a2[3], a3[3]);
      const int8_t* cr = ct + (8 * j + 2 * t) * STRIDE + g + 8 * n0;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const uint32_t b[2] = {code_tf32(cr[8 * n]),
                               code_tf32(cr[STRIDE + 8 * n])};
        mma_split3_rn(part[n], a1, a2, a3, b);
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// S (16 x BN) += A (16 x D) · Bᵀ as scores_f32 computes it, with B
// already split: kh holds its TF32 hi parts (as f32 bit patterns) and kl its
// lo parts, both [BN][STRIDE].
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void scores_planes(const float (&qf)[D / 8][4],
                                              const float* __restrict__ kh,
                                              const float* __restrict__ kl,
                                              float (&s)[BN / 8][4], int g,
                                              int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(qf[kk][i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int off = (8 * j + g) * STRIDE + 8 * kk + t;
      const uint32_t bh[2] = {__float_as_uint(kh[off]),
                              __float_as_uint(kh[off + 4])};
      const uint32_t bl[2] = {__float_as_uint(kl[off]),
                              __float_as_uint(kl[off + 4])};
      mma_tf32x3(s[j], ah, al, bh, bl);
    }
  }
}

// acc (16 x D) += P (16 x BN) · V as pv_f32_rn computes it (fresh
// accumulators per tile, added by f32 adds), with V already split into its
// hi plane vh and lo plane vl.
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void pv_planes_rn(const float (&p)[BN / 8][4],
                                             const float* __restrict__ vh,
                                             const float* __restrict__ vl,
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
      const int off = (8 * j + 2 * t) * STRIDE + g + 8 * n0;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const uint32_t bh[2] = {__float_as_uint(vh[off + 8 * n]),
                                __float_as_uint(vh[off + STRIDE + 8 * n])};
        const uint32_t bl[2] = {__float_as_uint(vl[off + 8 * n]),
                                __float_as_uint(vl[off + STRIDE + 8 * n])};
        mma_tf32x3(part[n], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// The rows of a [BN][STRIDE] f32 tile split in place into TF32 hi (left in
// the tile) and lo (written to lo at the same offsets), 4 values a thread
// at a time: each K/V value is split once per CTA, not once per warp.
template <int D, int BN, int STRIDE>
__device__ __forceinline__ void split_tile(float* __restrict__ x,
                                           float* __restrict__ lo, int tid) {
  constexpr int kVec = BN * D / 4;
  static_assert(kVec % kChunkThreads == 0, "vectors must split evenly");
#pragma unroll
  for (int n = 0; n < kVec / kChunkThreads; ++n) {
    const int i = tid + n * kChunkThreads;
    const int off = (i / (D / 4)) * STRIDE + (i % (D / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(x + off);
    uint32_t h[4], l[4];
    tf32_split(v.x, h[0], l[0]);
    tf32_split(v.y, h[1], l[1]);
    tf32_split(v.z, h[2], l[2]);
    tf32_split(v.w, h[3], l[3]);
    *reinterpret_cast<float4*>(x + off) =
        make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                    __uint_as_float(h[2]), __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(lo + off) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// q rows r0 and r1 as f32 A fragments (as load_a_rows reads f32), widened
// from q's type: the f32 and int8 pools' products split them at use.
template <int D, typename QT>
__device__ __forceinline__ void load_q_f32(const QT* __restrict__ q, int r0,
                                           int r1, int T, int t,
                                           float (&qf)[D / 8][4]) {
  if constexpr (std::is_same<QT, float>::value) {
    load_a_rows<D>(q, r0, r1, T, t, qf);
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = 8 * kk + t;
      qf[kk][0] = r0 < T ? to_f32(q[(size_t)r0 * D + c]) : 0.f;
      qf[kk][1] = r1 < T ? to_f32(q[(size_t)r1 * D + c]) : 0.f;
      qf[kk][2] = r0 < T ? to_f32(q[(size_t)r0 * D + c + 4]) : 0.f;
      qf[kk][3] = r1 < T ? to_f32(q[(size_t)r1 * D + c + 4]) : 0.f;
    }
  }
}

// load_q_f32 for rows of dh elements, columns from dh on zero.
template <int D, typename QT>
__device__ __forceinline__ void load_q_f32_pad(const QT* __restrict__ q,
                                               int r0, int r1, int T, int t,
                                               float (&qf)[D / 8][4], int dh) {
  if constexpr (std::is_same<QT, float>::value) {
    load_a_rows_pad<D>(q, r0, r1, T, t, qf, dh);
  } else {
    auto at = [&](int row, int c) -> float {
      return row < T && c < dh ? to_f32(q[(size_t)row * dh + c]) : 0.f;
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
}

// One K/V tile's key rows for a padded instantiation: rows of dh elements
// by cp.async of BYTES, the columns from dh on and the rows at or past kend
// zero-filled; pool_row(col) is the walked column's pool row.
template <typename KV, int D, int BN, int STRIDE, int BYTES, typename RowOf>
__device__ __forceinline__ void stage_kv_pad_n(KV* __restrict__ ks,
                                               KV* __restrict__ vs,
                                               const KV* __restrict__ kp,
                                               const KV* __restrict__ vp,
                                               int k0, int kend, int dh,
                                               int tid, RowOf pool_row) {
  constexpr int kPer = BYTES / (int)sizeof(KV);
  constexpr int kPerRow = D / kPer;
  for (int i = tid; i < BN * kPerRow; i += kChunkThreads) {
    const int j = i / kPerRow, c = (i % kPerRow) * kPer;
    const bool ok = k0 + j < kend && c < dh;
    const size_t src = ok ? pool_row(k0 + j) * dh + c : 0;
    cp_async_n<BYTES>(ks + j * STRIDE + c, kp + src, ok);
    cp_async_n<BYTES>(vs + j * STRIDE + c, vp + src, ok);
  }
}

// ... by the widest copy a row of dh elements keeps aligned
// (common.cuh::copy_bytes; f32 rows always 16 bytes, 16-bit rows 16 or 8)
template <typename KV, int D, int BN, int STRIDE, typename RowOf>
__device__ __forceinline__ void stage_kv_pad(KV* __restrict__ ks,
                                             KV* __restrict__ vs,
                                             const KV* __restrict__ kp,
                                             const KV* __restrict__ vp, int k0,
                                             int kend, int dh, int tid,
                                             RowOf pool_row) {
  const int nb = copy_bytes(dh * (int)sizeof(KV));
  if (sizeof(KV) == 4 || nb == 16)
    stage_kv_pad_n<KV, D, BN, STRIDE, 16>(ks, vs, kp, vp, k0, kend, dh, tid,
                                          pool_row);
  else if (sizeof(KV) == 2 || nb == 8)
    stage_kv_pad_n<KV, D, BN, STRIDE, 8>(ks, vs, kp, vp, k0, kend, dh, tid,
                                         pool_row);
  else
    stage_kv_pad_n<KV, D, BN, STRIDE, 4>(ks, vs, kp, vp, k0, kend, dh, tid,
                                         pool_row);
}

// Chunk route: see the header. QT is q's and o's type, KV the pools' (f32,
// int8 codes, or q's 16-bit type). part is the split workspace (unused when
// splits == 1): [splits][B·H·T][dh] f32 accumulators, then
// [splits][B·H·T][2] (m, l). PAD false: a head dim of exactly D (dh = D);
// PAD true: dh padded to D (common.cuh).
template <typename QT, typename KV, int D, bool PAD>
__device__ __forceinline__ void paged_chunk_body(
    const QT* __restrict__ q, const void* __restrict__ kp_,
    const void* __restrict__ vp_, const float* __restrict__ kscales,
    const float* __restrict__ vscales, const int* __restrict__ bt,
    const int* __restrict__ pos, const float* __restrict__ key_valid,
    QT* __restrict__ o, float* __restrict__ part, int H, int T, int ps,
    int NP, int splits, float scale, int dh) {
  using C = ChunkTile<KV, D>;
  constexpr bool QUANT = C::kCodes;
  constexpr bool k16 = sizeof(KV) == 2;
  static_assert(!k16 || std::is_same<QT, KV>::value,
                "16-bit pools are read with a query of their own type");
  static_assert(PAD || C::kCopies % kChunkThreads == 0 ||
                    C::kCopies < kChunkThreads,
                "copies must split evenly");
  constexpr int BN = C::kBlockN;
  constexpr int STRIDE = C::kStride;
  constexpr int kPerCopy = C::kCopyBytes / (int)sizeof(KV);
  constexpr int kPerRow = D / kPerCopy;
  const KV* kp = static_cast<const KV*>(kp_);
  const KV* vp = static_cast<const KV*>(vp_);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // after the ring: the lo planes (f32), then the block-table entries of
  // the walked pages
  float* klo = reinterpret_cast<float*>(smem_raw + C::kRingBytes);
  float* vlo = klo + C::kTileBytes / (int)sizeof(float);
  int* bts = reinterpret_cast<int*>(smem_raw + C::kRingBytes + C::kLoBytes);

  const int h = blockIdx.y, b = blockIdx.z;
  const int split = blockIdx.x % splits;
  const int qtiles = gridDim.x / splits;
  const int q0 = (qtiles - 1 - blockIdx.x / splits) * kChunkRows;  // longest walks first
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 16 * warp;  // the warp's first row
  const int r0 = wrow + g, r1 = r0 + 8;
  const int Tmax = NP * ps;
  const int ld = PAD ? dh : D;  // elements per row in memory
  const size_t qbase = ((size_t)b * H + h) * T * ld;
  const float* kvrow =
      key_valid == nullptr ? nullptr : key_valid + (size_t)b * Tmax;

  // causal walk: the tile's last row sees columns up to pos[b] + that row;
  // this CTA takes its split's contiguous range of whole key tiles
  const int p0 = pos[b];
  const int kend = min(Tmax, p0 + min(q0 + kChunkRows, T));
  const int ntiles = (kend + BN - 1) / BN;
  const int per = (ntiles + splits - 1) / splits;
  const int it0 = min(ntiles, split * per);
  const int it1 = min(ntiles, it0 + per);

  const int pg0 = it0 * BN / ps;
  const int npg = it1 > it0 ? (min(kend, it1 * BN) - 1) / ps - pg0 + 1 : 0;
  for (int i = tid; i < npg; i += kChunkThreads)
    bts[i] = bt[(size_t)b * NP + pg0 + i];
  __syncthreads();

  // pool row of walked column col (shifts for a power-of-two page size)
  const int psh = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  auto pool_row = [&](int col) -> size_t {
    const int pg = psh >= 0 ? col >> psh : col / ps;
    const int off = psh >= 0 ? col & (ps - 1) : col % ps;
    return ((size_t)bts[pg - pg0] * H + h) * ps + off;
  };
  // one K/V tile into ring stage st: key rows by 16-byte copies (8-byte
  // for an int8 row of d=8), then the tile's key-valid columns and (int8)
  // scales by 4-byte copies; columns at or past kend zero-filled
  auto stage = [&](int tile, int st) {
    unsigned char* base = smem_raw + st * C::kStageBytes;
    KV* ks = reinterpret_cast<KV*>(base);
    KV* vs = reinterpret_cast<KV*>(base + C::kTileBytes);
    float* vals = reinterpret_cast<float*>(base + 2 * C::kTileBytes);
    const int k0 = tile * BN;
    if constexpr (PAD) {
      stage_kv_pad<KV, D, BN, STRIDE>(ks, vs, kp, vp, k0, kend, dh, tid,
                                      pool_row);
    } else if constexpr (C::kCopies % kChunkThreads == 0) {
#pragma unroll
      for (int n = 0; n < C::kCopies / kChunkThreads; ++n) {
        const int i = tid + n * kChunkThreads;
        const int j = i / kPerRow, c = (i % kPerRow) * kPerCopy;
        const bool ok = k0 + j < kend;
        const size_t src = (ok ? pool_row(k0 + j) : 0) * D + c;
        cp_async16(ks + j * STRIDE + c, kp + src, ok);
        cp_async16(vs + j * STRIDE + c, vp + src, ok);
      }
    } else if (tid < C::kCopies) {
      const int j = tid / kPerRow, c = (tid % kPerRow) * kPerCopy;
      const bool ok = k0 + j < kend;
      const size_t src = (ok ? pool_row(k0 + j) : 0) * D + c;
      if constexpr (C::kCopyBytes == 16) {
        cp_async16(ks + j * STRIDE + c, kp + src, ok);
        cp_async16(vs + j * STRIDE + c, vp + src, ok);
      } else {
        cp_async8(ks + j * STRIDE + c, kp + src, ok);
        cp_async8(vs + j * STRIDE + c, vp + src, ok);
      }
    }
    for (int j = tid; j < BN; j += kChunkThreads) {
      const bool ok = k0 + j < kend;
      if (kvrow != nullptr) cp_async4(vals + j, kvrow + (ok ? k0 + j : 0), ok);
      if constexpr (QUANT) {
        const size_t row = ok ? pool_row(k0 + j) : 0;
        cp_async4(vals + BN + j, kscales + row, ok);
        cp_async4(vals + 2 * BN + j, vscales + row, ok);
      }
    }
  };

  // the first kStages - 1 tiles in flight, one commit group each
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (it0 + i < it1) stage(it0 + i, i);
    cp_async_commit();
  }

  // f32 and int8 pools: q widened to f32 and pre-scaled by log2(e)/√d (the
  // softmax runs in base 2); 16-bit pools: q as 16-bit A fragments, the
  // scores scaled after the product (the tensor core forms each product of
  // two 16-bit values exactly and sums in f32)
  using QFrag =
      typename std::conditional<k16, Frag16<D>, float[D / 8][4]>::type;
  QFrag qf;
  if constexpr (k16 && PAD) {
    load_a_rows_pad<D>(q + qbase, r0, r1, T, t, qf, dh);
  } else if constexpr (k16) {
    load_a_rows<D>(q + qbase, r0, r1, T, t, qf);
  } else {
    if constexpr (PAD)
      load_q_f32_pad<D>(q + qbase, r0, r1, T, t, qf, dh);
    else
      load_q_f32<D>(q + qbase, r0, r1, T, t, qf);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[kk][i] *= scale;
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bool has_rows = wrow < T;  // warp-uniform: a warp past T only stages

  for (int it = it0; it < it1; ++it) {
    const int st = (it - it0) % C::kStages;
    cp_async_wait<C::kStages - 2>();  // this thread's copies of tile it
    unsigned char* base = smem_raw + st * C::kStageBytes;
    const KV* kt = reinterpret_cast<const KV*>(base);
    const KV* vt = reinterpret_cast<const KV*>(base + C::kTileBytes);
    const float* vals =
        reinterpret_cast<const float*>(base + 2 * C::kTileBytes);
    const int k0 = it * BN;
    // kv_full: the key-valid plane masks no walked column of the tile
    // (thread j < BN reads the column it copied itself). The barrier also
    // marks tile it landed for every thread and tile it - 1 consumed by
    // every warp, so its stage may take the next tile.
    const bool kv_full = __syncthreads_and(kvrow == nullptr || tid >= BN ||
                                           k0 + tid >= kend ||
                                           vals[tid] != 0.f);
    if (it + C::kStages - 1 < it1)
      stage(it + C::kStages - 1, (st + C::kStages - 1) % C::kStages);
    cp_async_commit();
    if constexpr (C::kF32) {
      // f32: each K/V value split once per CTA into TF32 hi (in place) and
      // lo (the lo planes)
      split_tile<D, BN, STRIDE>(reinterpret_cast<float*>(base), klo, tid);
      split_tile<D, BN, STRIDE>(
          reinterpret_cast<float*>(base + C::kTileBytes), vlo, tid);
      __syncthreads();  // the planes are complete
    }
    // A warp whose 16 rows all lie causally before the tile skips it: its
    // columns would score -1e30 and add exactly 0 to a row that has seen a
    // column (alpha = 1, p = 0).
    if (has_rows && k0 <= p0 + wrow + 15) {
      float s[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (QUANT) {
        // int8: the exact code products, then each column's key scale
        scores_codes<D, BN, STRIDE>(qf, kt, s, g, t);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] *= vals[BN + 8 * j + 2 * t + (e & 1)];
      } else if constexpr (k16) {
        scores_16<D, BN, STRIDE>(qf, kt, s, lane);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      } else {
        scores_planes<D, BN, STRIDE>(qf, kt, klo, s, g, t);
      }

      // masks, each only on the tiles that need it: this thread's columns
      // are 8j + 2t + (e & 1) of the tile
      if (!kv_full) {  // masked columns
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (vals[8 * j + 2 * t + (e & 1)] == 0.f) s[j][e] = kNegInf;
      }
      if (k0 + BN > kend || k0 + BN - 1 > p0 + wrow) {
        // the causal limit col <= pos + row, then columns past the walk
        const int kl = kend - k0 - 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lim = p0 + (e < 2 ? r0 : r1) - k0 - 2 * t;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = 8 * j + (e & 1);
            if (c > lim) s[j][e] = kNegInf;
            if (c >= kl) s[j][e] = neg_inf();
          }
        }
      }

      // online softmax on the fragment: rows g (e = 0, 1) and g + 8 (e = 2,
      // 3); the row sum stays a per-thread partial until the end
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = m[hr];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = fast_exp2(m[hr] - mx);
        m[hr] = mx;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          s[j][2 * hr] = fast_exp2(s[j][2 * hr] - mx);
          s[j][2 * hr + 1] = fast_exp2(s[j][2 * hr + 1] - mx);
          sum0 += s[j][2 * hr];
          sum1 += s[j][2 * hr + 1];
        }
        l[hr] = l[hr] * alpha + (sum0 + sum1);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * hr] *= alpha;
          acc[n][2 * hr + 1] *= alpha;
        }
      }

      if constexpr (QUANT)
        pv_codes_rn<D, BN, STRIDE>(s, vals + 2 * BN, vt, acc, g, t);
      else if constexpr (k16)
        pv_16<D, BN, STRIDE>(s, vt, acc, lane);
      else
        pv_planes_rn<D, BN, STRIDE>(s, vt, vlo, acc, g, t);
    }
  }

  const size_t rows = (size_t)gridDim.z * H * T;  // B·H·T
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lr = l[hr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = hr ? r1 : r0;
    if (row >= T) continue;
    if (splits == 1) {
      const float lc = fmaxf(lr, 1e-30f);
      QT* orow = o + qbase + (size_t)row * ld + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        if (PAD && 8 * n + 2 * t >= dh) continue;
        store2(orow + 8 * n, acc[n][2 * hr] / lc, acc[n][2 * hr + 1] / lc);
      }
    } else {
      // this split's partial of the row, unnormalised
      const size_t pr = (size_t)split * rows + qbase / ld + row;
      if constexpr (PAD)
        store_acc_row_pad<float, D>(part + pr * dh, acc, hr, t, 1.f, dh);
      else
        store_acc_row<float, D>(part + pr * D, acc, hr, t, 1.f);
      if (t == 0) {
        float* ml = part + (size_t)splits * rows * ld + pr * 2;
        ml[0] = m[hr];
        ml[1] = lr;
      }
    }
  }
}

template <typename QT, typename KV, int D>
__global__ void __launch_bounds__(kChunkThreads)
    paged_chunk_kernel(const QT* __restrict__ q,
                       const void* __restrict__ kp_,
                       const void* __restrict__ vp_,
                       const float* __restrict__ kscales,
                       const float* __restrict__ vscales,
                       const int* __restrict__ bt, const int* __restrict__ pos,
                       const float* __restrict__ key_valid,
                       QT* __restrict__ o, float* __restrict__ part, int H,
                       int T, int ps, int NP, int splits, float scale) {
  paged_chunk_body<QT, KV, D, false>(q, kp_, vp_, kscales, vscales, bt, pos,
                                     key_valid, o, part, H, T, ps, NP, splits,
                                     scale, D);
}

template <typename QT, typename KV, int D>
__global__ void __launch_bounds__(kChunkThreads)
    paged_chunk_pad_kernel(const QT* __restrict__ q,
                           const void* __restrict__ kp_,
                           const void* __restrict__ vp_,
                           const float* __restrict__ kscales,
                           const float* __restrict__ vscales,
                           const int* __restrict__ bt,
                           const int* __restrict__ pos,
                           const float* __restrict__ key_valid,
                           QT* __restrict__ o, float* __restrict__ part,
                           int H, int T, int ps, int NP, int splits,
                           float scale, int dh) {
  paged_chunk_body<QT, KV, D, true>(q, kp_, vp_, kscales, vscales, bt, pos,
                                    key_valid, o, part, H, T, ps, NP, splits,
                                    scale, dh);
}

// The split chunk route's second pass: each output element merges its
// row's `splits` partials in fixed split order (max, then the rescaled sums
// of l and acc, in base 2 as the walk's m is), as the decode route merges
// its warps. o is written in q's type OT.
template <typename OT>
__global__ void __launch_bounds__(256)
    paged_merge_kernel(const float* __restrict__ part, OT* __restrict__ o,
                       int rows, int D, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * D) return;
  const size_t r = i / D, c = i % D;
  const float* ml = part + (size_t)splits * rows * D;
  float mx = kNegInf;
  for (int sp = 0; sp < splits; ++sp)
    mx = fmaxf(mx, ml[((size_t)sp * rows + r) * 2]);
  float lsum = 0.f, out = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t pr = (size_t)sp * rows + r;
    const float e = exp2f(ml[pr * 2] - mx);
    lsum += ml[pr * 2 + 1] * e;
    out += part[pr * D + c] * e;
  }
  o[i] = from_f32<OT>(out / fmaxf(lsum, 1e-30f));
}

// Dynamic shared memory of a chunk CTA: the ring, the lo planes, and NP
// block-table entries (the most a walk can stage).
template <typename KV, int D>
int chunk_smem_bytes(int NP) {
  return ChunkTile<KV, D>::kRingBytes + ChunkTile<KV, D>::kLoBytes + 4 * NP;
}

template <typename QT, typename KV, int D, bool PAD>
int launch_chunk(const QT* q, const void* kp, const void* vp,
                 const float* kscales, const float* vscales, const int* bt,
                 const int* pos, const float* key_valid, QT* o, float* part,
                 int splits, int B, int H, int T, int ps, int NP, int dh,
                 cudaStream_t stream) {
  // the opt-in limit, asked once per instantiation and device: the
  // block-table slice makes the size depend on NP
  static PerDevice opt;
  int limit = 0;
  const cudaError_t attr = once_per_device(opt, [](int dev, int& most) {
    cudaError_t e = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) {
      if constexpr (PAD)
        e = cudaFuncSetAttribute(paged_chunk_pad_kernel<QT, KV, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
      else
        e = cudaFuncSetAttribute(paged_chunk_kernel<QT, KV, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    }
    return e;
  }, &limit);
  if (attr != cudaSuccess) return (int)attr;
  const int smem = chunk_smem_bytes<KV, D>(NP);
  if (smem > limit) return -3;
  const long long qtiles = (T + kChunkRows - 1) / kChunkRows;
  if (qtiles * splits > 0x7fffffffLL) return -1;
  const dim3 grid((unsigned)(qtiles * splits), H, B);
  const float scale = (float)(1.4426950408889634 / std::sqrt((double)dh));
  if constexpr (PAD)
    paged_chunk_pad_kernel<QT, KV, D><<<grid, kChunkThreads, smem, stream>>>(
        q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, H, T, ps,
        NP, splits, scale, dh);
  else
    paged_chunk_kernel<QT, KV, D><<<grid, kChunkThreads, smem, stream>>>(
        q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, H, T, ps,
        NP, splits, scale);
  if (splits > 1) {
    const long long n = (long long)B * H * T * dh;
    paged_merge_kernel<QT><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        part, o, B * H * T, dh, splits);
  }
  return 0;
}

// decode-sized chunks (T <= 4) or prefill-sized ones, at a head dim of
// exactly D
template <typename QT, typename KV, int D>
int launch_paged(const void* q_, const void* kp, const void* vp,
                 const float* kscales, const float* vscales, const int* bt,
                 const int* pos, const float* key_valid, void* o_, float* part,
                 int splits, int B, int H, int T, int ps, int NP,
                 cudaStream_t stream) {
  const QT* q = static_cast<const QT*>(q_);
  QT* o = static_cast<QT*>(o_);
  if (T == 1)
    return launch_decode<QT, KV, D, 1, false>(q, kp, vp, kscales, vscales, bt,
                                              pos, key_valid, o, B, H, T, ps,
                                              NP, D, stream);
  if (T <= kDecodeMaxT)
    return launch_decode<QT, KV, D, kDecodeMaxT, false>(
        q, kp, vp, kscales, vscales, bt, pos, key_valid, o, B, H, T, ps, NP,
        D, stream);
  return launch_chunk<QT, KV, D, false>(q, kp, vp, kscales, vscales, bt, pos,
                                        key_valid, o, part, splits, B, H, T,
                                        ps, NP, D, stream);
}

// the decode route of a head dim dh padded to the power of two D
template <typename QT, typename KV, int D>
int launch_decode_pad(const void* q, const void* kp, const void* vp,
                      const float* kscales, const float* vscales,
                      const int* bt, const int* pos, const float* key_valid,
                      void* o, int B, int H, int T, int ps, int NP, int dh,
                      cudaStream_t stream) {
  if (T == 1)
    return launch_decode<QT, KV, D, 1, true>(
        static_cast<const QT*>(q), kp, vp, kscales, vscales, bt, pos,
        key_valid, static_cast<QT*>(o), B, H, T, ps, NP, dh, stream);
  return launch_decode<QT, KV, D, kDecodeMaxT, true>(
      static_cast<const QT*>(q), kp, vp, kscales, vscales, bt, pos, key_valid,
      static_cast<QT*>(o), B, H, T, ps, NP, dh, stream);
}

// the chunk route of a head dim dh padded to D
template <typename QT, typename KV, int D>
int launch_chunk_pad(const void* q, const void* kp, const void* vp,
                     const float* kscales, const float* vscales, const int* bt,
                     const int* pos, const float* key_valid, void* o,
                     float* part, int splits, int B, int H, int T, int ps,
                     int NP, int dh, cudaStream_t stream) {
  return launch_chunk<QT, KV, D, true>(
      static_cast<const QT*>(q), kp, vp, kscales, vscales, bt, pos, key_valid,
      static_cast<QT*>(o), part, splits, B, H, T, ps, NP, dh, stream);
}

}  // namespace dl4j
