// K2: paged-KV attention read for Hopper (sm_90a).
//
// Replaces deeplearning4j_tpu/nn/conf/layers/paged_attention.py::
// _paged_attn_kernel (launched by _pallas_paged_attention). Attends a query
// chunk q [B, H, T, d] (T = 1 for decode, up to the prefill chunk) over the
// pool pages that row b's block table bt [B, NP] names, read in place from
// kp, vp [P, H, ps, d] (f32, or int8 dequantized on load against the f32
// per-token-per-head scales kscales, vscales [P, H, ps]). Key column c of
// row b is pool page bt[b, c / ps] at offset c % ps. Query row r sees
// columns c <= pos[b] + r, and with a [B, NP·ps] key-valid plane only the
// columns it marks nonzero. Output: the pre-projection context [B, H, T, d].
//
// What bounds it on this card: bytes. A decode step reads every resident
// K/V byte of every row once and does 4·d FLOPs per key (< 1 FLOP/byte in
// f32); prefill chunks raise the ratio to about T FLOPs per byte, still far
// under the ridge at the slice's widths.
//
// Two routes, one launch per call either way. Both read bt[b, i] themselves
// (Hopper has no scalar prefetch) and walk columns only up to their causal
// limit min(NP·ps, pos[b] + last row + 1): the JAX kernel walks all NP
// pages. Both fold keys in with an online softmax in f32, so the gathered
// [B, H, NP·ps, d] view the plain version builds never exists. The JAX
// kernel instead runs one max-subtract softmax at its last page (to stay
// bitwise equal to its gather path); this port's contract is allclose on
// the context plus exact greedy tokens through the server. Masked columns
// score -1e30 and l is clamped before the divide, so a row whose columns
// are all masked (a padded row routed to garbage page 0) comes out finite.
//
// Decode route (T <= 4: decode and speculative verify): one CTA of 8 warps
// per (b, h). The walked pages are cut into 8 contiguous ranges, one per
// warp, so each warp pays the memory latency of its own range once and not
// that of every tile of the row. A warp loads its slice of the block-table
// row once (a lane per page, handed out by shuffle), then reads its keys as
// 16-byte (f32) or 8-byte (int8) vectors, a few lanes per key row (a head's
// page is contiguous, [ps, d]), with a batch of key rows in flight per lane
// before any arithmetic. The q rows sit in registers and each loaded key
// serves all of them. Each lane group keeps its own (m, l, acc); the groups
// merge by shuffle, then the 8 warps' partials merge in shared memory in
// fixed warp order, so two calls are bitwise equal. A warp with an empty
// range keeps m = -1e30, l = 0 and adds nothing.
//
// Chunk route (T > 4: prefill): one CTA per (b, h, 32-row q tile), 4 warps
// of 8 rows; 32-column K/V tiles are staged through shared memory,
// dequantized to f32 as they land.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include <cmath>

#include "common.cuh"

namespace dl4j {

template <bool QUANT, int D, int R>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const float* __restrict__ q, const void* __restrict__ kp_,
                      const void* __restrict__ vp_,
                      const float* __restrict__ kscales,
                      const float* __restrict__ vscales,
                      const int* __restrict__ bt, const int* __restrict__ pos,
                      const float* __restrict__ key_valid,
                      float* __restrict__ o, int H, int T, int ps, int NP,
                      float scale) {
  using KV = typename std::conditional<QUANT, int8_t, float>::type;
  const KV* kp = static_cast<const KV*>(kp_);
  const KV* vp = static_cast<const KV*>(vp_);

  extern __shared__ float smem[];
  constexpr int kBlockQ = kWarps * R;
  float* qs = smem;                      // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;          // [kBlockK][D+1]
  float* vs = ks + kBlockK * (D + 1);    // [kBlockK][D]
  float* kvalid = vs + kBlockK * D;      // [kBlockK]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * R;
  const bool has_rows = q0 + row0 < T;   // warp-uniform
  const int Tmax = NP * ps;
  const size_t qbase = ((size_t)b * H + h) * T * D;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int t = q0 + i / D;
    qs[i] = t < T ? q[qbase + (size_t)t * D + i % D] * scale : 0.f;
  }

  float m[R], l[R], acc[R][D / 32];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[r][c] = 0.f;
  }

  // causal walk: the tile's last row sees columns up to pos[b] + that row
  const int p0 = pos[b];
  const int last_row = min(q0 + kBlockQ, T) - 1;
  const int kend = min(Tmax, p0 + last_row + 1);
  const int* btb = bt + (size_t)b * NP;
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, c = i % D, col = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (col < kend) {
        const size_t row = ((size_t)btb[col / ps] * H + h) * ps + col % ps;
        kv = (float)kp[row * D + c];
        vv = (float)vp[row * D + c];
        if (QUANT) {
          kv *= kscales[row];
          vv *= vscales[row];
        }
      }
      ks[j * (D + 1) + c] = kv;
      vs[j * D + c] = vv;
    }
    if (tid < kBlockK) {
      const int col = k0 + tid;
      kvalid[tid] = (col < kend && (key_valid == nullptr ||
                                    key_valid[(size_t)b * Tmax + col] != 0.f))
                        ? 1.f : 0.f;
    }
    __syncthreads();
    if (!has_rows) continue;

    float s[R];
    tile_scores<R, D>(qs, ks, row0, lane, s);
    const int col = k0 + lane;
    const bool walked = col < kend;
    const bool col_ok = kvalid[lane] != 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ok = col_ok && col <= p0 + q0 + row0 + r;
      s[r] = walked ? (ok ? s[r] : kNegInf) : neg_inf();
    }
    online_softmax_tile<R, D>(s, vs, m, l, acc, lane);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= T) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      o[qbase + (size_t)qi * D + lane + 32 * c] = acc[r][c] / lc;
  }
}

template <bool QUANT, int D, int R>
int launch_rows(const float* q, const void* kp, const void* vp,
                const float* kscales, const float* vscales, const int* bt,
                const int* pos, const float* key_valid, float* o, int B,
                int H, int T, int ps, int NP, cudaStream_t stream) {
  constexpr int smem = smem_words(D, R) * (int)sizeof(float);
  // above 48 KB (d = 128) only as opted-in dynamic shared memory; asked
  // once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_attn_kernel<QUANT, D, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((T + kWarps * R - 1) / (kWarps * R), H, B);
  paged_attn_kernel<QUANT, D, R><<<grid, kThreads, smem, stream>>>(
      q, kp, vp, kscales, vscales, bt, pos, key_valid, o, H, T, ps, NP,
      (float)(1.0 / std::sqrt((double)D)));
  return 0;
}

constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kDecodeMaxT = 4;  // chunks of up to 4 rows take the decode route

// One vector load of a key row's slice: 4 f32 (16 bytes) or 8 int8 codes
// (8 bytes), widened to f32.
template <bool QUANT>
struct KvVec;
template <>
struct KvVec<false> {
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
struct KvVec<true> {
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

// Decode route: see the header. R = 1 (T = 1) or kDecodeMaxT (T <= 4; rows
// past T are computed on zeros and not stored).
template <bool QUANT, int D, int R>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_kernel(const float* __restrict__ q,
                        const void* __restrict__ kp_,
                        const void* __restrict__ vp_,
                        const float* __restrict__ kscales,
                        const float* __restrict__ vscales,
                        const int* __restrict__ bt, const int* __restrict__ pos,
                        const float* __restrict__ key_valid,
                        float* __restrict__ o, int H, int T, int ps, int NP,
                        float scale) {
  using KV = typename std::conditional<QUANT, int8_t, float>::type;
  using Vec = KvVec<QUANT>;
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
  const size_t qbase = ((size_t)b * H + h) * T * D;

  float qr[R][kN];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < kN; ++e)
      qr[r][e] = r < T ? q[qbase + (size_t)r * D + sub * kN + e] * scale : 0.f;

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
        const size_t off = row * D + sub * kN;
        kr[u] = ok[u] ? *reinterpret_cast<const typename Vec::type*>(kp + off)
                      : typename Vec::type{};
        vr[u] = ok[u] ? *reinterpret_cast<const typename Vec::type*>(vp + off)
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
    o[qbase + (size_t)r * D + c] = out / fmaxf(lsum, 1e-30f);
  }
}

template <bool QUANT, int D, int R>
int launch_decode(const float* q, const void* kp, const void* vp,
                  const float* kscales, const float* vscales, const int* bt,
                  const int* pos, const float* key_valid, float* o, int B,
                  int H, int T, int ps, int NP, cudaStream_t stream) {
  const dim3 grid(H, B);
  paged_decode_kernel<QUANT, D, R><<<grid, kDecodeThreads, 0, stream>>>(
      q, kp, vp, kscales, vscales, bt, pos, key_valid, o, H, T, ps, NP,
      (float)(1.0 / std::sqrt((double)D)));
  return 0;
}

// decode-sized chunks (T <= 4) or prefill-sized ones
template <bool QUANT, int D>
int launch_paged(const float* q, const void* kp, const void* vp,
                 const float* kscales, const float* vscales, const int* bt,
                 const int* pos, const float* key_valid, float* o, int B,
                 int H, int T, int ps, int NP, cudaStream_t stream) {
  if (T == 1)
    return launch_decode<QUANT, D, 1>(q, kp, vp, kscales, vscales, bt, pos,
                                      key_valid, o, B, H, T, ps, NP, stream);
  if (T <= kDecodeMaxT)
    return launch_decode<QUANT, D, kDecodeMaxT>(
        q, kp, vp, kscales, vscales, bt, pos, key_valid, o, B, H, T, ps, NP,
        stream);
  return launch_rows<QUANT, D, kRows>(q, kp, vp, kscales, vscales, bt, pos,
                                      key_valid, o, B, H, T, ps, NP, stream);
}

}  // namespace dl4j

// Launches K2 on `stream`; returns 0 after a launch (the caller checks it
// with cudaGetLastError), or a nonzero code for an unsupported
// configuration, which launches nothing. kscales/vscales are read only when
// quant is set; key_valid may be null.
extern "C" int dl4j_paged_attn(const float* q, const void* kp, const void* vp,
                               const float* kscales, const float* vscales,
                               const int* bt, const int* pos,
                               const float* key_valid, float* o, int B, int H,
                               int T, int D, int ps, int NP, int quant,
                               cudaStream_t stream) {
  if (T < 1 || B < 1 || H < 1 || ps < 1 || NP < 1 || B > 65535 || H > 65535)
    return -1;
  switch (D) {
    case 32:
      return quant ? dl4j::launch_paged<true, 32>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, B, H, T, ps, NP, stream)
                   : dl4j::launch_paged<false, 32>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, B, H, T, ps, NP, stream);
    case 64:
      return quant ? dl4j::launch_paged<true, 64>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, B, H, T, ps, NP, stream)
                   : dl4j::launch_paged<false, 64>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, B, H, T, ps, NP, stream);
    case 128:
      return quant ? dl4j::launch_paged<true, 128>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, B, H, T, ps, NP, stream)
                   : dl4j::launch_paged<false, 128>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, B, H, T, ps, NP, stream);
    default:
      return -2;
  }
}
