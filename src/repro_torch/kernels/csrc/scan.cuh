// What the two scan kernels' entry points share (fused_knn.cu and
// fused_knn_masked.cu walk contiguous tiles of the whole database,
// ivf_scan.cu the tile table of the cells its probe lists name; the walk
// itself is fused_knn.cuh's): the storage-type codes of gy, the dispatch
// over them, and the checks of K and of shared memory.
#pragma once

#include <type_traits>

#include "select.cuh"

namespace repro {

constexpr size_t kMaxSmem = 232448;  // shared memory a block can have

// Storage types of gy, by the code the Python side passes.
enum GyDtype : int { kF32 = 0, kBf16 = 1, kI8 = 2 };

template <typename T>
struct Type {
  using type = T;
};

// f(Type<TB>{}, std::bool_constant<scaled>{}) for the storage type of gy
// that `gy_dtype` names and for the presence of the scale operand: each
// scan kernel is compiled once per pair, and picked here at run time.
template <typename F>
int dispatch_gy(int gy_dtype, bool scaled, F&& f) {
  switch (gy_dtype) {
    case kF32:
      return scaled ? f(Type<float>{}, std::true_type{}) : f(Type<float>{}, std::false_type{});
    case kBf16:
      return scaled ? f(Type<Bf16>{}, std::true_type{}) : f(Type<Bf16>{}, std::false_type{});
    case kI8:
      return scaled ? f(Type<int8_t>{}, std::true_type{}) : f(Type<int8_t>{}, std::false_type{});
    default:
      return cudaErrorInvalidValue;
  }
}

inline bool valid_k(int K, int cap = kMaxK) { return K > 0 && K <= cap && (K & (K - 1)) == 0; }

}  // namespace repro
