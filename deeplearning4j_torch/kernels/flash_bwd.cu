// K3 and K4: flash-attention backward for Hopper (sm_90a), dQ and dK/dV.
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
//   dQ = (dS·k)/√d  (K3),   dV = Pᵀ·dO,  dK = dSᵀ·(q/√d)  (K4).
//
// Scores are masked exactly as K1 masks them, so P is built from the same
// set of keys that lse counts: a key past the causal diagonal or refused by
// the optional [B, T] key row (nonzero = valid) scores -1e30, and a key past
// T, in the ragged last tile, gets P = 0 exactly. Both kernels accumulate in
// f32 and write in the input type (f32 or bf16).
//
// What bounds them on this card: at the training slice's T=128, d=32 both
// are tiny, bound by launch latency and by bytes (K3 moves q, k, v, dO, dQ;
// K4 q, k, v, dO, dK, dV; both lse and delta); at long T they are bound by
// operations, 6d (K3) and 8d (K4) FLOPs per visible (row, key) pair. Like
// K1, this first version runs its products on the f32 CUDA cores; wgmma,
// TMA staging and a fused single-pass backward are later work.
//
// Design: K3 is one CTA per (b·h, 32-row q tile), 4 warps of 8 rows; it
// stages the tile's q (pre-scaled) and dO once and streams 32-key K/V tiles
// through shared memory, one key per lane, and stops at the diagonal tile
// when causal, as K1 does. dQ[r][c] = Σ_j dS[r][j]·k[j][c] is a reduction
// over the lanes: each lane broadcasts its dS with a warp shuffle and every
// lane accumulates the columns c = lane + 32·i it owns, in registers.
// K4 is one CTA per (b·h, 32-key tile), 4 warps of 8 keys; it keeps its K/V
// tile in shared memory and streams 32-row q/dO/lse/delta tiles, one row
// per lane, starting at the tile that holds row k0 when causal (rows above
// it see none of these keys). dV and dK are reductions over the rows, done
// the same way by shuffle. Each output element is written by exactly one
// thread after a loop in a fixed order, with no atomics, so two calls on
// the same inputs give bitwise-equal results; that is why the backward is
// two kernels, as in the JAX package.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace dl4j {

constexpr int kTile = kWarps * kRows;  // 32 rows (K3) or 32 keys (K4)
static_assert(kTile == kBlockK, "the backward tiles rows and keys alike");

// f32 words of dynamic shared memory of either kernel: two [32][D] tiles,
// two [32][D+1] tiles (padded: a lane per row reads without bank
// conflicts) and three 32-entry rows (key validity, lse, delta).
__host__ __device__ constexpr int bwd_smem_words(int D) {
  return 2 * kTile * D + 2 * kTile * (D + 1) + 3 * kTile;
}

// ------------------------------------------------------------------ K3: dQ
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ mask, T* __restrict__ dq,
                        int H, int Tlen, float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kTile][D], pre-scaled
  float* dos = qs + kTile * D;           // [kTile][D]
  float* ks = dos + kTile * D;           // [kBlockK][D+1]
  float* vs = ks + kBlockK * (D + 1);    // [kBlockK][D+1]
  float* kvalid = vs + kBlockK * (D + 1);  // [kBlockK]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * kRows;
  const size_t base = (size_t)bh * Tlen * D;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int t = q0 + i / D;
    const size_t at = base + (size_t)t * D + i % D;
    qs[i] = t < Tlen ? to_f32<T>(q[at]) * scale : 0.f;
    dos[i] = t < Tlen ? to_f32<T>(dout[at]) : 0.f;
  }
  // rows past T have dO = 0 and lse = delta = 0, so their dS is exactly 0
  float row_lse[kRows], row_delta[kRows], acc[kRows][D / 32];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + row0 + r;
    row_lse[r] = qi < Tlen ? lse[(size_t)bh * Tlen + qi] : 0.f;
    row_delta[r] = qi < Tlen ? delta[(size_t)bh * Tlen + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[r][c] = 0.f;
  }

  const int kend = causal ? min(Tlen, q0 + kTile) : Tlen;
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and q/dO are staged)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, c = i % D, t = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (t < Tlen) {
        kv = to_f32<T>(k[base + (size_t)t * D + c]);
        vv = to_f32<T>(v[base + (size_t)t * D + c]);
      }
      ks[j * (D + 1) + c] = kv;
      vs[j * (D + 1) + c] = vv;
    }
    if (tid < kBlockK) {
      const int t = k0 + tid;
      kvalid[tid] = (t < Tlen && (mask == nullptr ||
                                  mask[(size_t)b * Tlen + t] != 0.f))
                        ? 1.f : 0.f;
    }
    __syncthreads();

    float s[kRows], dp[kRows];
    tile_scores<kRows, D>(qs, ks, row0, lane, s);    // q/√d · k_lane
    tile_scores<kRows, D>(dos, vs, row0, lane, dp);  // dO · v_lane
    const int key = k0 + lane;
    const bool exists = key < Tlen;
    const bool key_ok = kvalid[lane] != 0.f;
    float ds[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + row0 + r;
      const bool ok = key_ok && (!causal || key <= qi);
      const float p = exists ? expf((ok ? s[r] : kNegInf) - row_lse[r]) : 0.f;
      ds[r] = p * (dp[r] - row_delta[r]);
    }
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float kj[D / 32];
#pragma unroll
      for (int c = 0; c < D / 32; ++c) kj[c] = ks[j * (D + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
        for (int c = 0; c < D / 32; ++c) acc[r][c] += dsj * kj[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= Tlen) continue;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      dq[base + (size_t)qi * D + lane + 32 * c] = from_f32<T>(acc[r][c] * scale);
  }
}

// --------------------------------------------------------------- K4: dK/dV
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ mask, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Tlen, float scale,
                         int causal) {
  extern __shared__ float smem[];
  float* ks = smem;                      // [kTile][D]
  float* vs = ks + kTile * D;            // [kTile][D]
  float* qs = vs + kTile * D;            // [kTile][D+1], pre-scaled
  float* dos = qs + kTile * (D + 1);     // [kTile][D+1]
  float* kvalid = dos + kTile * (D + 1);  // [kTile]
  float* lse_s = kvalid + kTile;         // [kTile]
  float* delta_s = lse_s + kTile;        // [kTile]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int key0 = (tid >> 5) * kRows;   // this warp's 8 keys of the tile
  const size_t base = (size_t)bh * Tlen * D;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int t = k0 + i / D;
    const size_t at = base + (size_t)t * D + i % D;
    ks[i] = t < Tlen ? to_f32<T>(k[at]) : 0.f;
    vs[i] = t < Tlen ? to_f32<T>(v[at]) : 0.f;
  }
  if (tid < kTile) {
    const int t = k0 + tid;
    kvalid[tid] = (t < Tlen && (mask == nullptr ||
                                mask[(size_t)b * Tlen + t] != 0.f))
                      ? 1.f : 0.f;
  }

  float dk_acc[kRows][D / 32], dv_acc[kRows][D / 32];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      dk_acc[j][c] = 0.f;
      dv_acc[j][c] = 0.f;
    }
  }

  // causal: rows before k0 see none of this tile's keys
  for (int q0 = causal ? k0 : 0; q0 < Tlen; q0 += kTile) {
    __syncthreads();  // the previous q tile is consumed (and K/V are staged)
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int r = i / D, c = i % D, t = q0 + r;
      const size_t at = base + (size_t)t * D + c;
      qs[r * (D + 1) + c] = t < Tlen ? to_f32<T>(q[at]) * scale : 0.f;
      dos[r * (D + 1) + c] = t < Tlen ? to_f32<T>(dout[at]) : 0.f;
    }
    if (tid < kTile) {
      const int t = q0 + tid;
      lse_s[tid] = t < Tlen ? lse[(size_t)bh * Tlen + t] : 0.f;
      delta_s[tid] = t < Tlen ? delta[(size_t)bh * Tlen + t] : 0.f;
    }
    __syncthreads();

    // lane = query row qi of the tile; j = the warp's keys
    const int qi = q0 + lane;
    float s[kRows], dp[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      s[j] = 0.f;
      dp[j] = 0.f;
    }
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float qc = qs[lane * (D + 1) + c];
      const float dc = dos[lane * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        s[j] += qc * ks[(key0 + j) * D + c];
        dp[j] += dc * vs[(key0 + j) * D + c];
      }
    }
    const float row_lse = lse_s[lane];
    const float row_delta = delta_s[lane];
    float p[kRows], ds[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int kj = k0 + key0 + j;
      const bool ok = kvalid[key0 + j] != 0.f && (!causal || kj <= qi);
      p[j] = (qi < Tlen && kj < Tlen)
                 ? expf((ok ? s[j] : kNegInf) - row_lse) : 0.f;
      ds[j] = p[j] * (dp[j] - row_delta);
    }
    // dV[j][c] += Σ_i P[i][j]·dO[i][c], dK[j][c] += Σ_i dS[i][j]·q[i][c]
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      float pi[kRows], dsi[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        pi[j] = __shfl_sync(0xffffffffu, p[j], i);
        dsi[j] = __shfl_sync(0xffffffffu, ds[j], i);
      }
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        const float doc = dos[i * (D + 1) + lane + 32 * c];
        const float qc = qs[i * (D + 1) + lane + 32 * c];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          dv_acc[j][c] += pi[j] * doc;
          dk_acc[j][c] += dsi[j] * qc;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int kj = k0 + key0 + j;
    if (kj >= Tlen) continue;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      const size_t at = base + (size_t)kj * D + lane + 32 * c;
      dk[at] = from_f32<T>(dk_acc[j][c]);
      dv[at] = from_f32<T>(dv_acc[j][c]);
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* mask,
              void* dq, void* /*unused*/, int B, int H, int Tlen, int causal,
              cudaStream_t stream) {
  const int smem = bwd_smem_words(D) * (int)sizeof(float);
  // above 48 KB only as opted-in dynamic shared memory (D = 128)
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tlen + kTile - 1) / kTile, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      static_cast<T*>(dq), H, Tlen, (float)(1.0 / std::sqrt((double)D)),
      causal);
  return 0;
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* mask,
               void* dk, void* dv, int B, int H, int Tlen, int causal,
               cudaStream_t stream) {
  const int smem = bwd_smem_words(D) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tlen + kTile - 1) / kTile, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tlen,
      (float)(1.0 / std::sqrt((double)D)), causal);
  return 0;
}

}  // namespace dl4j

// One case of the (head dim, type) switch below.
#define DL4J_BWD_CASE(DIM, LAUNCH)                                           \
  case DIM:                                                                  \
    return is_bf16                                                           \
               ? dl4j::LAUNCH<__nv_bfloat16, DIM>(q, k, v, dout, lse, delta, \
                                                   mask, out0, out1, B, H,   \
                                                   Tlen, causal, stream)     \
               : dl4j::LAUNCH<float, DIM>(q, k, v, dout, lse, delta, mask,   \
                                          out0, out1, B, H, Tlen, causal,    \
                                          stream);

// Launch K3 (dq into out0) on `stream`; 0 after a launch (the caller checks
// it with cudaGetLastError), nonzero for an unsupported configuration,
// which launches nothing.
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const float* mask,
                                 void* dq, int B, int H, int Tlen, int D,
                                 int is_bf16, int causal,
                                 cudaStream_t stream) {
  if (Tlen < 1 || B * H < 1 || B * H > 65535) return -1;
  void* out0 = dq;
  void* out1 = nullptr;
  switch (D) {
    DL4J_BWD_CASE(32, launch_dq)
    DL4J_BWD_CASE(64, launch_dq)
    DL4J_BWD_CASE(128, launch_dq)
    default:
      return -2;
  }
}

// Launch K4 (dk into out0, dv into out1) on `stream`; return codes as above.
extern "C" int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const float* mask,
                                  void* dk, void* dv, int B, int H, int Tlen,
                                  int D, int is_bf16, int causal,
                                  cudaStream_t stream) {
  if (Tlen < 1 || B * H < 1 || B * H > 65535) return -1;
  void* out0 = dk;
  void* out1 = dv;
  switch (D) {
    DL4J_BWD_CASE(32, launch_dkv)
    DL4J_BWD_CASE(64, launch_dkv)
    DL4J_BWD_CASE(128, launch_dkv)
    default:
      return -2;
  }
}

#undef DL4J_BWD_CASE
