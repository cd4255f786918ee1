// The selection shared by the kNN kernels: a per-row ascending K-buffer in
// shared memory, owned by one warp.
//
// Replaces, on the device, stream_topk.py::_tile_reduce_topk (the bitonic
// reduce of a tile row to K) plus topk.merge_topk_sorted (the bitonic merge
// into the running buffer) of the JAX package.  The TPU needs that static
// network because it has no cheap per-lane control flow; a warp has it, so
// here each candidate is first held against the buffer's K-th entry (the
// paper's heap-top filter, one ballot for 32 candidates) and only the few
// that beat it are inserted, each in O(K / 32) steps per lane.
//
// Result contract, the same as the reference's: the K smallest candidates by
// (value, global column), ascending; an empty slot is (+inf, -1).  Since the
// order is lexicographic, a candidate equal in value to an entry with a lower
// column does not displace it: the running buffer (earlier columns) wins a
// tie, as in the reference merge, and a split of the columns into slices that
// are merged afterwards gives the same set (lower slices win ties).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kMaxK = 256;

__device__ __forceinline__ bool lex_less(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// Fill a warp's buffer with empty slots.
__device__ __forceinline__ void warp_init(float* rv, int* ri, int K, int lane) {
  for (int j = lane; j < K; j += 32) {
    rv[j] = CUDART_INF_F;
    ri[j] = -1;
  }
  __syncwarp();
}

// Insert (v, c) into the warp's ascending buffer; a no-op if it is not
// among the K smallest.  Every lane of the warp calls it with the same
// candidate.
__device__ __forceinline__ void warp_insert(float* rv, int* ri, int K, float v,
                                            int c, int lane) {
  int p = 0;  // entries strictly below (v, c): the insertion position
#pragma unroll
  for (int s = 0; s < kMaxK / 32; ++s) {
    if (s * 32 < K) {
      const int j = s * 32 + lane;
      const bool lt = j < K && lex_less(rv[j], ri[j], v, c);
      p += __popc(__ballot_sync(kFullMask, lt));
    }
  }
  if (p >= K) return;
  float tv[kMaxK / 32];
  int ti[kMaxK / 32];
#pragma unroll
  for (int s = 0; s < kMaxK / 32; ++s) {
    const int j = s * 32 + lane;
    if (s * 32 < K && j >= p && j < K - 1) {
      tv[s] = rv[j];
      ti[s] = ri[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kMaxK / 32; ++s) {
    const int j = s * 32 + lane;
    if (s * 32 < K && j >= p && j < K - 1) {
      rv[j + 1] = tv[s];
      ri[j + 1] = ti[s];
    }
  }
  if (lane == 0) {
    rv[p] = v;
    ri[p] = c;
  }
  __syncwarp();
}

// Offer one candidate per lane.  With the threshold skip on, a lane takes
// part only if its candidate beats the current K-th entry (kv, ki); a batch
// in which none does costs one ballot and no branch is taken.  With it off,
// every valid candidate goes through the insertion, which gives the same
// buffer.  kv, ki hold the K-th entry and are kept current for all lanes.
__device__ __forceinline__ void warp_offer(float* rv, int* ri, int K, float v,
                                           int c, bool valid, bool skip,
                                           float& kv, int& ki, int lane) {
  const bool want = valid && (!skip || lex_less(v, c, kv, ki));
  unsigned mask = __ballot_sync(kFullMask, want);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cv = __shfl_sync(kFullMask, v, src);
    const int cc = __shfl_sync(kFullMask, c, src);
    if (!skip || lex_less(cv, cc, kv, ki)) {
      warp_insert(rv, ri, K, cv, cc, lane);
      kv = rv[K - 1];
      ki = ri[K - 1];
    }
  }
}

}  // namespace repro
