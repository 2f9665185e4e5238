// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces deeplearning4j_tpu/ops/pallas_attention.py::_attn_fwd_kernel
// (launched by _flash_forward). Computes O = softmax(q kᵀ/√d) v over
// [B, H, T, d] with the online-softmax recurrence in f32, an optional causal
// mask and an optional [B, T] key-validity row (nonzero = valid), and writes
// O in the input type plus the row logsumexp lse [B·H, T, 1] in f32.
//
// What bounds it on this card: at the slice's T=128 the work is tiny and
// the kernel is bound by launch latency and by bytes (q, k, v, o: 4·B·H·T·d
// elements); at long T it is bound by operations, 4·B·H·T²·d FLOPs (half of
// them under causal). This first version runs the products on the f32 CUDA
// cores, not on the tensor cores, so at long T it sits far under the
// card's bf16 peak; wgmma and TMA staging are later work.
//
// Design: one CTA per (b·h, 32-row q tile), 4 warps of 8 rows each. The CTA
// streams 32-key K/V tiles through shared memory (converted to f32 on
// load), each lane scoring one key against the warp's 8 rows, so K/V are
// read from device memory once per q tile and the [T, T] scores never leave
// the SM. Causal CTAs stop at the diagonal tile. T needs no block
// divisibility: keys past T score -inf (contribute exactly 0) and rows past
// T are not stored. The running sum l is clamped at 1e-30 before the divide,
// as _attn_fwd_kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace dl4j {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ o, float* __restrict__ lse, int H,
                     int Tlen, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int kBlockQ = kWarps * kRows;
  float* qs = smem;                      // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;          // [kBlockK][D+1]
  float* vs = ks + kBlockK * (D + 1);    // [kBlockK][D]
  float* kvalid = vs + kBlockK * D;      // [kBlockK]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * kRows;
  const size_t base = (size_t)bh * Tlen * D;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int t = q0 + i / D;
    qs[i] = t < Tlen ? to_f32<T>(q[base + (size_t)t * D + i % D]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][D / 32];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[r][c] = 0.f;
  }

  // causal: tiles strictly above the diagonal contribute nothing
  const int kend = causal ? min(Tlen, q0 + kBlockQ) : Tlen;
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, c = i % D, t = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (t < Tlen) {
        kv = to_f32<T>(k[base + (size_t)t * D + c]);
        vv = to_f32<T>(v[base + (size_t)t * D + c]);
      }
      ks[j * (D + 1) + c] = kv;
      vs[j * D + c] = vv;
    }
    if (tid < kBlockK) {
      const int t = k0 + tid;
      kvalid[tid] = (t < Tlen && (mask == nullptr ||
                                  mask[(size_t)b * Tlen + t] != 0.f))
                        ? 1.f : 0.f;
    }
    __syncthreads();

    float s[kRows];
    tile_scores<kRows, D>(qs, ks, row0, lane, s);
    const int key = k0 + lane;
    const bool exists = key < Tlen;
    const bool key_ok = kvalid[lane] != 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + row0 + r;
      const bool ok = key_ok && (!causal || key <= qi);
      s[r] = exists ? (ok ? s[r] : kNegInf) : neg_inf();
    }
    online_softmax_tile<kRows, D>(s, vs, m, l, acc, lane);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= Tlen) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      o[base + (size_t)qi * D + lane + 32 * c] = from_f32<T>(acc[r][c] / lc);
    if (lane == 0) lse[(size_t)bh * Tlen + qi] = m[r] + logf(lc);
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, const float* mask,
           void* o, float* lse, int B, int H, int Tlen, int causal,
           cudaStream_t stream) {
  const int smem = smem_words(D, kRows) * (int)sizeof(float);
  // above 48 KB only as opted-in dynamic shared memory (D = 128)
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tlen + kWarps * kRows - 1) / (kWarps * kRows), B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
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
