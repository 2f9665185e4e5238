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
// Design: one CTA per (b, h, q tile of the chunk): 4 warps of R rows, R = 8
// for prefill chunks and R = 1 for decode (T <= 4), so a decode CTA does not
// score 31 rows that do not exist; a warp with no row skips the arithmetic
// and only helps stage the tiles. The CTA reads
// bt[b, i] itself (Hopper has no scalar prefetch) and walks pages only up
// to its causal limit pos[b] + last row, never past it: the JAX kernel
// walks all NP pages. 32-column K/V tiles are staged through shared memory,
// dequantized to f32 as they land, and folded in with an online softmax in
// f32, so the gathered [B, H, NP·ps, d] view the plain version builds never
// exists. The JAX kernel instead runs one max-subtract softmax at its last
// page (to stay bitwise equal to its gather path); this port's contract is
// allclose on the context plus exact greedy tokens through the server.
// Masked columns score -1e30 and l is clamped before the divide, so a row
// whose columns are all masked (a padded prefill row routed to garbage page
// 0) comes out finite.
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
  const int smem = smem_words(D, R) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      paged_attn_kernel<QUANT, D, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + kWarps * R - 1) / (kWarps * R), H, B);
  paged_attn_kernel<QUANT, D, R><<<grid, kThreads, smem, stream>>>(
      q, kp, vp, kscales, vscales, bt, pos, key_valid, o, H, T, ps, NP,
      (float)(1.0 / std::sqrt((double)D)));
  return 0;
}

// decode-sized chunks (T <= 4: one row per warp) or prefill-sized ones
template <bool QUANT, int D>
int launch_paged(const float* q, const void* kp, const void* vp,
                 const float* kscales, const float* vscales, const int* bt,
                 const int* pos, const float* key_valid, float* o, int B,
                 int H, int T, int ps, int NP, cudaStream_t stream) {
  if (T <= kWarps)
    return launch_rows<QUANT, D, 1>(q, kp, vp, kscales, vscales, bt, pos,
                                    key_valid, o, B, H, T, ps, NP, stream);
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
