// Fused kNN with the per-query filter bitmap (the reference's q_mask,
// DESIGN.md §17): the C entry points of the kernels of fused_knn.cuh,
// instantiated masked, in a library of their own so that the unmasked
// kernels (fused_knn.cu) carry no trace of the bitmap, and the two build
// side by side.
#include "fused_knn.cuh"

// As fused_knn_occupancy, for the masked kernels.
extern "C" int fused_knn_masked_occupancy(int bm, int K, int gy_dtype, int scaled, int* out) {
  return repro::fused_occupancy<true>(bm, K, gy_dtype, scaled, out);
}

// As fused_knn, and qm: the bitmap, query row i's ceil(n / 32) words at qm + i * qm_stride (a stride
// of 0 shares one row), not null.
extern "C" int fused_knn_masked(const float* fx, const void* gy, const float* gs,
                                const unsigned* qm, const float* hx, const float* hy,
                                float* out_v, int* out_i, int m, int n, int d, int K, int n_real,
                                int qm_stride, int exclude_self, int threshold_skip, float alpha,
                                int fin, int gy_dtype, int bm, int splits, int tiles_per_split,
                                void* stream) {
  return repro::fused_launch<true>(fx, gy, gs, qm, hx, hy, out_v, out_i, m, n, d, K, n_real,
                                   qm_stride, exclude_self, threshold_skip, alpha, fin, gy_dtype,
                                   bm, splits, tiles_per_split, stream);
}
