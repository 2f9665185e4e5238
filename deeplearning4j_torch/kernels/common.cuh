// Shared pieces of the port's attention kernels: the scores of masked and
// of missing keys.
#pragma once

#include <cuda_runtime.h>

namespace dl4j {

// Masked scores, as in the JAX package: -1e30 rather than -inf keeps a row
// whose keys are all masked finite (uniform weights instead of 0/0).
constexpr float kNegInf = -1e30f;

// -inf: the score of a key that does not exist, so exp() gives exactly 0
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

}  // namespace dl4j
