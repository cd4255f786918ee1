// Merge of partial top-K sets: [S, m, K] -> [m, K].
//
// Runs after fused_knn when the database axis was split across CTAs (a
// serving batch has too few query tiles to fill the card): split s holds,
// per row, the K smallest of the s-th range of columns, ascending by
// (value, column).  The TPU kernel needs no such pass, since one program
// walks the whole database axis; the JAX package's counterpart is the
// bitonic tree merge core/topk.py::merge_many_sorted.
//
// Bound on the H100: bytes.  One warp owns a row: it loads split 0 into its
// shared-memory K-buffer, then offers every later list through warp_offer
// (select.cuh).  A list is read only until its first batch of 32 in which
// nothing beats the K-th entry, since the rest of it is larger still; at
// K <= 32 that batch is the whole list, so every entry is read once.
// Since the order is lexicographic on (value, column) and lower splits hold
// lower columns, lower splits win ties, as in one unsplit pass.
#include "select.cuh"

namespace repro {

constexpr int kMergeWarps = 8;

__global__ void __launch_bounds__(kMergeWarps * 32)
    merge_partials_kernel(const float* __restrict__ pv, const int* __restrict__ pi,
                          float* __restrict__ ov, int* __restrict__ oi, int m, int S,
                          int K) {
  __shared__ float sv[kMergeWarps][kMaxK];
  __shared__ int si[kMergeWarps][kMaxK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= m) return;
  float* rv = sv[warp];
  int* ri = si[warp];
  for (int j = lane; j < K; j += 32) {
    rv[j] = pv[static_cast<size_t>(row) * K + j];
    ri[j] = pi[static_cast<size_t>(row) * K + j];
  }
  __syncwarp();
  float kv = rv[K - 1];
  int ki = ri[K - 1];
  for (int s = 1; s < S; ++s) {
    const size_t base = (static_cast<size_t>(s) * m + row) * K;
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int j = j0 + lane;
      const bool valid = j < K;
      const float v = valid ? pv[base + j] : CUDART_INF_F;
      const int c = valid ? pi[base + j] : -1;
      const bool want = valid && lex_less(v, c, kv, ki);
      if (__ballot_sync(kFullMask, want) == 0) break;
      warp_offer(rv, ri, K, v, c, valid, true, kv, ki, lane);
    }
  }
  for (int j = lane; j < K; j += 32) {
    ov[static_cast<size_t>(row) * K + j] = rv[j];
    oi[static_cast<size_t>(row) * K + j] = ri[j];
  }
}

}  // namespace repro

// part_v/part_i: [S, m, K], each row of each split ascending; out: [m, K].
extern "C" int merge_partials_f32(const float* part_v, const int* part_i, float* out_v,
                                  int* out_i, int m, int S, int K, void* stream) {
  if (m <= 0 || S <= 0 || K <= 0 || K > repro::kMaxK || (K & (K - 1)) != 0)
    return cudaErrorInvalidValue;
  const int blocks = (m + repro::kMergeWarps - 1) / repro::kMergeWarps;
  repro::merge_partials_kernel<<<blocks, repro::kMergeWarps * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      part_v, part_i, out_v, out_i, m, S, K);
  return static_cast<int>(cudaGetLastError());
}
