// Fused kNN without a filter bitmap: the C entry points of the kernels of
// fused_knn.cuh (the kernel, its layouts and its design are described
// there), instantiated unmasked.  fused_knn_masked.cu is the same kernel
// with the per-query bitmap, in a library of its own.
#include "fused_knn.cuh"

// The launch parameters of this compiled kernel at BM query rows (128 for
// K <= 32, or 64), width K (up to 4096), gy storage type (0 fp32, 1 bf16,
// 2 int8) and with or without a scale: out[0] = CTAs resident per SM
// (registers and shared memory both counted), out[1] = database columns per
// tile, out[2] = dynamic shared memory per CTA in bytes.
extern "C" int fused_knn_occupancy(int bm, int K, int gy_dtype, int scaled, int* out) {
  return repro::fused_occupancy<false>(bm, K, gy_dtype, scaled, out);
}

// gy [n, d] in the storage type gy_dtype names; gs: the per-row scales [n],
// or null.  out_v/out_i:
// [splits, m, K]; split s holds the partial set of database tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split).
extern "C" int fused_knn(const float* fx, const void* gy, const float* gs, const float* hx,
                         const float* hy, float* out_v, int* out_i, int m, int n, int d, int K,
                         int n_real, int exclude_self, int threshold_skip, float alpha, int fin,
                         int gy_dtype, int bm, int splits, int tiles_per_split, void* stream) {
  return repro::fused_launch<false>(fx, gy, gs, nullptr, hx, hy, out_v, out_i, m, n, d, K,
                                    n_real, 0, exclude_self, threshold_skip, alpha, fin,
                                    gy_dtype, bm, splits, tiles_per_split, stream);
}
