// Shared pieces of the port's attention kernels: the scores of masked and
// of missing keys, and the head-dim padding rule.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace dl4j {

// Dynamic shared memory above 48 KB is opted in per kernel in each device's
// context, so a launch function opts its kernel in once per device (a mesh
// over several cards launches one instantiation on each): ``fn(dev,
// value)`` runs the first time the current device launches, may leave a
// number in ``value`` (the device's opt-in limit, returned in ``*value_out``
// on every call), and its error is kept.
constexpr int kMaxDevices = 64;

struct PerDevice {
  std::once_flag once[kMaxDevices];
  cudaError_t err[kMaxDevices] = {};
  int value[kMaxDevices] = {};
};

template <typename F>
cudaError_t once_per_device(PerDevice& s, F&& fn, int* value_out = nullptr) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(s.once[dev], [&] { s.err[dev] = fn(dev, s.value[dev]); });
  if (value_out != nullptr) *value_out = s.value[dev];
  return s.err[dev];
}

// Masked scores, as in the JAX package: -1e30 rather than -inf keeps a row
// whose keys are all masked finite (uniform weights instead of 0/0).
constexpr float kNegInf = -1e30f;

// -inf: the score of a key that does not exist, so exp() gives exactly 0
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Head dims: every d with 1 <= d <= 256. Every kernel is instantiated at
// the widths 8, 16, 32, 64, 128 and 256 for a head dim of exactly that
// width, and at 8, 16, 32, 48, 64, 80, 96, 128, 160, 192, 224 and 256
// ("padded" instantiations, a runtime head dim dh beside the compile-time
// width) for any other d: d <= width < d + 32 (d = 1..3 run at 8). A
// padded kernel reads and writes rows of dh elements in device memory;
// its shared-memory tiles and fragments hold the width's columns, the ones
// from dh on zero, so every product adds exact zeros there, and the
// softmax scale is 1/sqrt(dh). Rows are copied by the widest cp.async that
// a row of dh elements keeps aligned (copy_bytes); a row of 16-bit
// elements with odd dh, or of int8 ones with dh % 4 != 0, is below the
// narrowest cp.async (4 bytes) and is staged by element loads instead,
// synchronously, into the same zero-filled tiles.
//
// Widths past 128 ("wide") split the output's columns in two halves, one
// CTA each (halves()), in K1, K2's chunk route and K4: each CTA forms the
// scores over the full width and accumulates only its half of O, or of dK
// and dV, so it holds the accumulators of a width of at most 128. K3's dQ
// alone fits a CTA at 256 and is not split. The A operand of the score
// products is read from shared memory one k-step at a time
// (attn_tile.cuh::tile_abt_smem), not held in registers.

// whether d has an exact instantiation
__host__ __device__ constexpr bool exact_dim(int d) {
  return d == 8 || d == 16 || d == 32 || d == 64 || d == 128 || d == 256;
}

// the padded width a head dim d runs at, or 0 where no kernel takes it
__host__ __device__ constexpr int pad_dim(int d) {
  if (d < 1 || d > 256) return 0;
  return d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 48 ? 48
       : d <= 64 ? 64 : d <= 80 ? 80 : d <= 96 ? 96 : d <= 128 ? 128
       : d <= 160 ? 160 : d <= 192 ? 192 : d <= 224 ? 224 : 256;
}

// the power-of-two width K2's decode route pads d to (its lane groups
// split a key row over a power-of-two number of lanes), or 0
__host__ __device__ constexpr int pad_dim_pow2(int d) {
  if (pad_dim(d) == 0) return 0;
  return d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
       : d <= 128 ? 128 : 256;
}

// the output-column halves of a width in K1, K2's chunk route and K4: 2
// past 128 (one CTA each), else 1
__host__ __device__ constexpr int halves(int width) {
  return width > 128 ? 2 : 1;
}

// the largest power of two <= x (x >= 1)
__host__ __device__ constexpr int pow2_floor(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

// the widest cp.async (16, 8 or 4 bytes) that a row of `row_bytes` bytes
// keeps aligned from row to row, or 0 where the row is not a multiple of 4
// bytes (element loads)
__host__ __device__ constexpr int copy_bytes(int row_bytes) {
  return row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8
       : row_bytes % 4 == 0 ? 4 : 0;
}

}  // namespace dl4j
