// Phase 2 of the paper: the k smallest of each row of a distance matrix,
// streamed over the columns, with the heap-top filter.
//
// Replaces stream_topk.py::stream_topk_pallas / _kernel of the JAX package
// (the per-row running K-buffer, fed one column tile at a time, merged only
// when the tile has an entry below the current K-th value).
//
// Bound on the H100: bytes.  Every element of x [m, n] is read once (4*m*n
// bytes) for a handful of compares.  The design gives each row to one warp
// that streams it with coalesced loads, four 128-byte requests in flight per
// warp, and keeps the row's K-buffer in shared memory (select.cuh).  The
// TPU's sequential grid axis over column tiles becomes this loop inside the
// warp; the threshold skip becomes a ballot over 32 candidates, uniform
// across the warp, so a batch with nothing to insert costs one compare per
// element.
#include "select.cuh"

namespace repro {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
    stream_topk_kernel(const float* __restrict__ x, float* __restrict__ ov,
                       int* __restrict__ oi, int m, int n, int K, int skip) {
  __shared__ float sv[kWarps][kMaxK];
  __shared__ int si[kWarps][kMaxK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= m) return;
  float* rv = sv[warp];
  int* ri = si[warp];
  warp_init(rv, ri, K, lane);
  float kv = CUDART_INF_F;
  int ki = -1;
  const float* xr = x + static_cast<size_t>(row) * n;
  for (int c0 = 0; c0 < n; c0 += 128) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * 32 + lane;
      v[u] = c < n ? __ldg(xr + c) : CUDART_INF_F;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * 32 + lane;
      warp_offer(rv, ri, K, v[u], c, c < n, skip != 0, kv, ki, lane);
    }
  }
  for (int j = lane; j < K; j += 32) {
    ov[static_cast<size_t>(row) * K + j] = rv[j];
    oi[static_cast<size_t>(row) * K + j] = ri[j];
  }
}

}  // namespace repro

extern "C" int stream_topk_f32(const float* x, float* out_v, int* out_i, int m, int n,
                               int K, int threshold_skip, void* stream) {
  if (m <= 0 || n <= 0 || K <= 0 || K > repro::kMaxK || (K & (K - 1)) != 0)
    return cudaErrorInvalidValue;
  const int blocks = (m + repro::kWarps - 1) / repro::kWarps;
  repro::stream_topk_kernel<<<blocks, repro::kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, out_v, out_i, m, n, K, threshold_skip);
  return static_cast<int>(cudaGetLastError());
}
