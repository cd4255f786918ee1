// Phase 2 of the paper: the k smallest of each row of a distance matrix,
// streamed over the columns, with the heap-top filter.
//
// Replaces stream_topk.py::stream_topk_pallas / _kernel of the JAX package
// (the per-row running K-buffer, fed one column tile at a time, merged only
// when the tile has an entry below the current K-th value).
//
// Bound on the H100: bytes.  Every element of x [m, n] is read once (4*m*n
// bytes) for a compare.  The design gives each row (or, when the rows are too
// few to fill the card, each range of a row's columns) to one CTA of 256
// threads.  The row streams through a ring of kStRing stages in shared
// memory, each stage kStStage columns filled by cp.async (16 bytes a thread
// where the rows are aligned to 16 bytes, else 4), so that about 20 KB are in
// flight per row while the CTA filters the stage that has landed.  A thread
// reads back only the columns it copied, so the ring needs no barrier.  The
// selection is select.cuh's staged bulk merge for every K up to
// kMaxSelectK: the row's K-buffer and its staging area lie in shared memory,
// a column that beats the K-th entry is appended with one warp-aggregated
// atomic, and the CTA sorts and merges the staging area into the buffer when
// it nears full.  The TPU's sequential grid axis over column tiles becomes
// the loop over stages; the threshold skip, the compare against the K-th
// entry before anything is staged.  One barrier a stage, where the warps'
// exact append counts (double-buffered by stage parity) are summed to decide
// a flush uniformly.  Column ranges of a split row are merged afterwards by
// merge_partials.cu, lower ranges winning ties as in one pass.
#include "select.cuh"

namespace repro {

constexpr int kStThreads = 256;
constexpr int kStWarps = kStThreads / 32;
constexpr int kStStage = 4 * kStThreads;  // columns a stage: four a thread
constexpr int kStRing = 6;                // stages in the ring
constexpr int kStFloor = 2 * kStStage;    // staging floor: the flush threshold cap - kStStage > 0

inline size_t st_smem_bytes(int K) {
  const int cap = staging_cap(K, kStFloor);
  return sizeof(float) * kStRing * kStStage + sizeof(Key) * (static_cast<size_t>(K) + cap);
}

// Row blockIdx.x, columns [blockIdx.y * cols_per_split, ...) of x into
// out[blockIdx.y][row]; kVec: 16-byte copies (n % 4 == 0, x aligned to 16).
template <bool kVec>
__global__ void __launch_bounds__(kStThreads)
    stream_topk_kernel(const float* __restrict__ x, float* __restrict__ ov,
                       int* __restrict__ oi, int m, int n, int K, int skip,
                       int cols_per_split) {
  extern __shared__ float4 st_smem[];
  __shared__ int cnt;                      // the staging area's atomic cursor
  __shared__ int warp_n[2][kStWarps];      // appends a warp made in a stage, by parity
  __shared__ TrimScratch ws;
  const int cap = staging_cap(K, kStFloor);
  float* ring = reinterpret_cast<float*>(st_smem);          // [kStRing][kStStage]
  Key* bk = reinterpret_cast<Key*>(ring + kStRing * kStStage);  // [K]: the buffer
  Key* sk = bk + K;                                            // [cap]: the staging area
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = blockIdx.x;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(n, c_begin + cols_per_split);
  const int nstages = (c_end - c_begin + kStStage - 1) / kStStage;
  const float* xr = x + static_cast<size_t>(row) * n;
  for (int j = tid; j < K; j += kStThreads) bk[j] = kEmptyKey;
  if (tid == 0) cnt = 0;

  // Stage s: this thread copies columns c_begin + s * kStStage + 4 tid .. + 3.
  auto issue = [&](int s) {
    if (s < nstages) {
      const int c = c_begin + s * kStStage + 4 * tid;
      float* dst = ring + (s % kStRing) * kStStage + 4 * tid;
      if constexpr (kVec) {
        const int valid = max(0, min(4, c_end - c));
        stage_copy16(dst, valid > 0 ? xr + c : xr, 4 * valid);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = c + u < c_end;
          stage_copy4(dst + u, ok ? xr + c + u : xr, ok ? 4 : 0);
        }
      }
    }
    stage_commit();  // an empty group past the end keeps the count of groups uniform
  };
  for (int s = 0; s < kStRing - 1; ++s) issue(s);
  __syncthreads();

  Key kth = kEmptyKey;  // the buffer's K-th entry, as of the last flush
  int staged = 0;  // pairs in the staging area, the same in every thread
  const auto sync = [] { __syncthreads(); };
  for (int s = 0; s < nstages; ++s) {
    issue(s + kStRing - 1);
    stage_wait<kStRing - 1>();
    const float4 q = *reinterpret_cast<const float4*>(ring + (s % kStRing) * kStStage + 4 * tid);
    const float vals[4] = {q.x, q.y, q.z, q.w};
    const int c = c_begin + s * kStStage + 4 * tid;
    int mine = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = c + u;
      const Key key = staged_key(vals[u], col);
      const bool want = col < c_end && (!skip || key < kth);
      mine += staged_append(sk, &cnt, key, want, lane);
    }
    if (lane == 0) warp_n[s & 1][warp] = mine;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kStWarps; ++w) staged += warp_n[s & 1][w];
    if (staged > cap - kStStage) {  // the next stage might not fit: flush
      if (tid == 0) cnt = 0;          // ordered before the next appends by the flush's barriers
      staged_flush<kStThreads>(bk, sk, &staged, 1, K, cap, tid, sync, &ws);
      kth = bk[K - 1];
    }
  }
  stage_wait<0>();
  if (staged > 0) staged_flush<kStThreads>(bk, sk, &staged, 1, K, cap, tid, sync, &ws);
  const size_t out = (static_cast<size_t>(blockIdx.y) * m + row) * K;
  for (int j = tid; j < K; j += kStThreads) {
    ov[out + j] = staged_value(bk[j]);
    oi[out + j] = staged_id(bk[j]);
  }
}

template <bool kVec>
bool st_prepare(int K) {
  return cudaFuncSetAttribute(stream_topk_kernel<kVec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(st_smem_bytes(K))) == cudaSuccess;
}

}  // namespace repro

static bool st_bad_k(int K) {
  return K <= 0 || K > repro::kMaxSelectK || (K & (K - 1)) != 0;
}

// out[0] = CTAs resident per SM, out[1] = dynamic shared memory per CTA in
// bytes, out[2] = stages in the ring, out[3] = bytes a stage.
extern "C" int stream_topk_occupancy(int K, int* out) {
  using namespace repro;
  if (st_bad_k(K) || !st_prepare<true>(K)) return cudaErrorInvalidValue;
  const size_t smem = st_smem_bytes(K);
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, stream_topk_kernel<true>, kStThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ctas;
  out[1] = static_cast<int>(smem);
  out[2] = kStRing;
  out[3] = static_cast<int>(sizeof(float)) * kStStage;
  return 0;
}

// x [m, n]; out_v/out_i [splits, m, K]: split s holds the K smallest of the
// columns [s * cols_per_split, (s + 1) * cols_per_split) of each row.  vec:
// n % 4 == 0 and x aligned to 16 bytes (16-byte copies).
extern "C" int stream_topk_f32(const float* x, float* out_v, int* out_i, int m, int n, int K,
                               int threshold_skip, int vec, int splits, int cols_per_split,
                               void* stream) {
  using namespace repro;
  if (m <= 0 || n <= 0 || st_bad_k(K) || splits < 1 || splits > 65535 ||
      cols_per_split <= 0 || cols_per_split % kStStage != 0 ||
      static_cast<long long>(splits - 1) * cols_per_split >= n ||
      static_cast<long long>(splits) * cols_per_split < n ||
      (vec && (n % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return cudaErrorInvalidValue;
  const dim3 grid(m, splits);
  const size_t smem = st_smem_bytes(K);
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (!st_prepare<true>(K)) return cudaErrorInvalidValue;
    stream_topk_kernel<true><<<grid, kStThreads, smem, st>>>(x, out_v, out_i, m, n, K,
                                                            threshold_skip, cols_per_split);
  } else {
    if (!st_prepare<false>(K)) return cudaErrorInvalidValue;
    stream_topk_kernel<false><<<grid, kStThreads, smem, st>>>(x, out_v, out_i, m, n, K,
                                                             threshold_skip, cols_per_split);
  }
  return static_cast<int>(cudaGetLastError());
}
