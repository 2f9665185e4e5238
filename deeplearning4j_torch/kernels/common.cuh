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

// Head dims. Every kernel is instantiated at the widths 8, 16, 32, 64 and
// 128 for a head dim of exactly that width, and at 8, 16, 32, 48, 64, 80,
// 96 and 128 ("padded" instantiations, a runtime head dim dh beside the
// compile-time width) for any other head dim d with 4 <= d <= 128 and
// d % 4 == 0. A padded kernel reads and writes rows of dh elements in
// device memory; its shared-memory tiles and fragments hold the width's
// columns, the ones from dh on zero, so every product adds exact zeros
// there, and the softmax scale is 1/sqrt(dh). dh % 4 == 0 keeps every row
// of f32, 16-bit and int8 elements 16-, 8- and 4-byte aligned.

// whether d has an exact instantiation
__host__ __device__ constexpr bool exact_dim(int d) {
  return d == 8 || d == 16 || d == 32 || d == 64 || d == 128;
}

// the padded width a head dim d runs at, or 0 where no kernel takes it
__host__ __device__ constexpr int pad_dim(int d) {
  if (d < 4 || d > 128 || d % 4 != 0) return 0;
  return d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 48 ? 48
       : d <= 64 ? 64 : d <= 80 ? 80 : d <= 96 ? 96 : 128;
}

// the power-of-two width K2's decode route pads d to (its lane groups
// split a key row over a power-of-two number of lanes), or 0
__host__ __device__ constexpr int pad_dim_pow2(int d) {
  if (pad_dim(d) == 0) return 0;
  return d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// the largest power of two <= x (x >= 1)
__host__ __device__ constexpr int pow2_floor(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

// the widest cp.async (16, 8 or 4 bytes) that a row of `row_bytes` bytes
// (a multiple of 4) keeps aligned from row to row
__host__ __device__ constexpr int copy_bytes(int row_bytes) {
  return row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : 4;
}

}  // namespace dl4j
