// Merge of partial top-K sets: [S, m, K] -> [m, K], as a merge tree.
//
// Runs after fused_knn, ivf_scan and pq_scan when the scanned axis was split
// across CTAs (a serving batch has too few query tiles to fill the card):
// split s holds, per row, the K smallest of the s-th range of columns,
// ascending by (value, column).  The TPU kernel needs no such pass, since one
// program walks the whole database axis; the JAX package's counterpart is the
// bitonic tree merge core/topk.py::merge_many_sorted.
//
// Bound on the H100: bytes (each partial entry read once, each output written
// once), but a row is a few KB, so what costs is latency: a chain of
// dependent steps per row.  The design reads all of a row's lists at once,
// with coalesced loads, into shared memory, and merges them pairwise in
// log2 S rounds, each fully parallel across the row's threads.  A merge keeps
// the K smallest of two sorted lists by a bitonic merge-and-truncate: list B
// is stored reversed (descending), the element-wise minimum of A[j] and
// B[j] is a bitonic sequence holding exactly the K smallest of A and B, and
// log2 K half-cleaner stages sort it, ascending where it is the even list of
// the next round's pair and descending where it is the odd one.  S is padded
// to a power of 2 with empty lists (+inf, -1); S = 1 is a copy.
//
// Order: the K smallest by (value, id), a total order on the entries (ids are
// distinct columns, and only empty slots share (+inf, -1)), so the result
// does not depend on the order of the merges; since lower splits hold lower
// columns, lower splits win ties, as in one unsplit pass.  An output slot
// holding +inf carries id -1.
//
// Two paths, by the row's padded size S' * K (S' = next_pow2(S)):
//   S' * K <= 512 (e.g. 16 splits x K 16, a serving batch): a warp owns a row,
//     in 4 KB of shared memory of its own, eight rows a block, __syncwarp
//     between stages;
//   else a 256-thread CTA owns a row, with up to kMergeCtaEntries (16,384
//     entries, 128 KB) in shared memory: all S' lists where they fit, else
//     groups of P lists, slot 0 of each later group holding the running result
//     (K = 4096 merges 4 lists a group).
#include "select.cuh"

namespace repro {

constexpr int kMergeWarpEntries = 512;  // a row of the warp path: S' * K entries
constexpr int kMergeWarps = 8;          // rows a block of the warp path
constexpr int kMergeCtaThreads = 256;
constexpr int kMergeCtaEntries = 16384;  // the widest group of the CTA path

// Compare-exchange of slots a < b: the smaller in a when `up`, in b otherwise.
__device__ __forceinline__ void merge_cx(float* v, int* id, int a, int b, bool up) {
  const float va = v[a], vb = v[b];
  const int ia = id[a], ib = id[b];
  if (up ? lex_less(vb, ib, va, ia) : lex_less(va, ia, vb, ib)) {
    v[a] = vb;
    id[a] = ib;
    v[b] = va;
    id[b] = ia;
  }
}

// Threads [0, T) of a row's group merge the n lists (n a power of 2) of K
// entries at slots [l K, (l + 1) K) -- list l ascending for even l,
// descending for odd l -- into list 0, ascending.  sync() orders the stages.
template <int T, typename Sync>
__device__ __forceinline__ void merge_tree(float* v, int* id, int n, int K, int t, Sync sync) {
  const int lk = __ffs(K) - 1;  // log2 K
  for (int span = K; span < n * K; span *= 2) {  // pairs of lists span apart
    const int pairs = n * K / (2 * span);
    // The minimum of A[j] and B[j] (B descending) into A's slots.
    for (int i = t; i < pairs * K; i += T) {
      const int a = (i >> lk) * 2 * span + (i & (K - 1)), b = a + span;
      if (lex_less(v[b], id[b], v[a], id[a])) {
        v[a] = v[b];
        id[a] = id[b];
      }
    }
    sync();
    // The clean-up: merged list q sorted, ascending when q is even.
    for (int dist = K / 2; dist > 0; dist /= 2) {
      for (int i = t; i < pairs * K / 2; i += T) {
        const int q = i >> (lk - 1), w = i & (K / 2 - 1);
        const int a = q * 2 * span + (((w & ~(dist - 1)) << 1) | (w & (dist - 1)));
        merge_cx(v, id, a, a + dist, (q & 1) == 0);
      }
      sync();
    }
  }
}

// Lists [s0, s0 + n) of `row` into slots [first, n) of the group's buffer,
// odd slots reversed; lists past S (and slots below `first`, which hold the
// running result) are not read, missing lists are empty.
template <int T>
__device__ __forceinline__ void merge_load(const float* __restrict__ pv,
                                           const int* __restrict__ pi, float* v, int* id,
                                           int row, int m, int S, int K, int s0, int first,
                                           int n, int t) {
  const int lk = __ffs(K) - 1;
  for (int i = first * K + t; i < n * K; i += T) {
    const int l = i >> lk, j = i & (K - 1), s = s0 + l;
    const int dst = (l & 1) ? l * K + K - 1 - j : i;
    if (s < S) {
      const size_t src = (static_cast<size_t>(s) * m + row) * K + j;
      v[dst] = pv[src];
      id[dst] = pi[src];
    } else {
      v[dst] = CUDART_INF_F;
      id[dst] = -1;
    }
  }
}

template <int T>
__device__ __forceinline__ void merge_store(const float* v, const int* id, float* __restrict__ ov,
                                            int* __restrict__ oi, int row, int K, int t) {
  for (int j = t; j < K; j += T) {
    const float x = v[j];
    ov[static_cast<size_t>(row) * K + j] = x;
    oi[static_cast<size_t>(row) * K + j] = x < CUDART_INF_F ? id[j] : -1;
  }
}

// A warp a row: the row's S' lists in the warp's own shared memory.
__global__ void __launch_bounds__(kMergeWarps * 32)
    merge_warp_kernel(const float* __restrict__ pv, const int* __restrict__ pi,
                      float* __restrict__ ov, int* __restrict__ oi, int m, int S, int n, int K) {
  __shared__ float sv[kMergeWarps][kMergeWarpEntries];
  __shared__ int si[kMergeWarps][kMergeWarpEntries];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= m) return;  // a whole warp; the kernel has no block-wide barrier
  merge_load<32>(pv, pi, sv[warp], si[warp], row, m, S, K, 0, 0, n, lane);
  __syncwarp();
  merge_tree<32>(sv[warp], si[warp], n, K, lane, [] { __syncwarp(); });
  merge_store<32>(sv[warp], si[warp], ov, oi, row, K, lane);
}

// A CTA a row: groups of P lists (P a power of 2, P * K <= kMergeCtaEntries);
// from the second group on, slot 0 holds the running result.
__global__ void __launch_bounds__(kMergeCtaThreads)
    merge_cta_kernel(const float* __restrict__ pv, const int* __restrict__ pi,
                     float* __restrict__ ov, int* __restrict__ oi, int m, int S, int P, int K) {
  extern __shared__ float smem[];
  float* v = smem;
  int* id = reinterpret_cast<int*>(smem + static_cast<size_t>(P) * K);
  const int row = blockIdx.x, t = threadIdx.x;
  auto sync = [] { __syncthreads(); };
  merge_load<kMergeCtaThreads>(pv, pi, v, id, row, m, S, K, 0, 0, P, t);
  __syncthreads();
  merge_tree<kMergeCtaThreads>(v, id, P, K, t, sync);
  for (int s0 = P; s0 < S; s0 += P - 1) {
    merge_load<kMergeCtaThreads>(pv, pi, v, id, row, m, S, K, s0 - 1, 1, P, t);
    __syncthreads();
    merge_tree<kMergeCtaThreads>(v, id, P, K, t, sync);
  }
  merge_store<kMergeCtaThreads>(v, id, ov, oi, row, K, t);
}

inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

}  // namespace repro

// part_v/part_i: [S, m, K], each row of each split ascending; out: [m, K].
extern "C" int merge_partials_f32(const float* part_v, const int* part_i, float* out_v,
                                  int* out_i, int m, int S, int K, void* stream) {
  using namespace repro;
  if (m <= 0 || S <= 0 || K <= 0 || K > kMaxSelectK || (K & (K - 1)) != 0)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = next_pow2(S);
  if (static_cast<long long>(n) * K <= kMergeWarpEntries) {
    merge_warp_kernel<<<(m + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, st>>>(
        part_v, part_i, out_v, out_i, m, S, n, K);
    return static_cast<int>(cudaGetLastError());
  }
  const int P = n * K <= kMergeCtaEntries ? n : kMergeCtaEntries / K;
  const size_t smem = static_cast<size_t>(P) * K * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(merge_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  merge_cta_kernel<<<m, kMergeCtaThreads, smem, st>>>(part_v, part_i, out_v, out_i, m, S, P, K);
  return static_cast<int>(cudaGetLastError());
}
