// Shared by every kernel library: the error hook and the two finalizers.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

// The C error hook the Python side calls to name a code that an entry
// point returned (each library is built from one .cu, so this is defined
// once per library).
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// The two matmul-form finalizers: identity, and sqrt(max(a, 0)) (euclidean,
// and Hellinger once its 1/2 prefactor is folded into alpha, hx and hy).
enum Finalize : int { kIdentity = 0, kSqrt = 1 };

__device__ __forceinline__ float finalize(float a, int fin) {
  return fin == kSqrt ? sqrtf(fmaxf(a, 0.0f)) : a;
}

}  // namespace repro
