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
//
// K up to kMaxK runs 8 warps a block; K = 512 and 1024 (a filtered search's
// wider fetch) run select.cuh's wide insertion, 4 warps a block, so that
// the buffers (4 x 1024 x 8 bytes) stay within the 48 KB a block gets
// without asking.  The buffers are dynamic shared memory, K entries a warp.
#include "select.cuh"

namespace repro {

template <int kCap, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    merge_partials_kernel(const float* __restrict__ pv, const int* __restrict__ pi,
                          float* __restrict__ ov, int* __restrict__ oi, int m, int S,
                          int K) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= m) return;
  float* rv = smem + warp * K;
  int* ri = reinterpret_cast<int*>(smem + kWarps * K) + warp * K;
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
      warp_offer<kCap>(rv, ri, K, v, c, valid, true, kv, ki, lane);
    }
  }
  for (int j = lane; j < K; j += 32) {
    ov[static_cast<size_t>(row) * K + j] = rv[j];
    oi[static_cast<size_t>(row) * K + j] = ri[j];
  }
}

template <int kCap, int kWarps>
int launch_merge(const float* pv, const int* pi, float* ov, int* oi, int m, int S, int K,
                 cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarps) * K * (sizeof(float) + sizeof(int));
  merge_partials_kernel<kCap, kWarps><<<(m + kWarps - 1) / kWarps, kWarps * 32, smem, stream>>>(
      pv, pi, ov, oi, m, S, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// part_v/part_i: [S, m, K], each row of each split ascending; out: [m, K].
extern "C" int merge_partials_f32(const float* part_v, const int* part_i, float* out_v,
                                  int* out_i, int m, int S, int K, void* stream) {
  using namespace repro;
  if (m <= 0 || S <= 0 || K <= 0 || K > kMaxSelectK || (K & (K - 1)) != 0)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (K <= kMaxK) return launch_merge<kMaxK, 8>(part_v, part_i, out_v, out_i, m, S, K, st);
  return launch_merge<kMaxSelectK, 4>(part_v, part_i, out_v, out_i, m, S, K, st);
}
