// The selection shared by the kNN kernels.
//
// Replaces, on the device, stream_topk.py::_tile_reduce_topk (the bitonic
// reduce of a tile row to K) plus topk.merge_topk_sorted (the bitonic merge
// into the running buffer) of the JAX package.  The TPU needs that static
// network because it has no cheap per-lane control flow; a warp has it, so
// here each candidate is first held against the buffer's K-th entry (the
// paper's heap-top filter, one ballot for 32 candidates) and only the few
// that beat it are kept.  Three forms:
//   * one-at-a-time insertion into a per-row ascending K-buffer in shared
//     memory, owned by one warp (warp_offer; the scan kernels at K <= 256);
//   * the staged bulk merge, K-buffers and staging areas in shared memory
//     (staged_append, staged_flush; stream_topk, pq_scan and rescore at
//     every K up to kMaxSelectK);
//   * the same staging in shared memory flushed by one warp into a K-buffer
//     that is a row of the kernel's output in device memory
//     (warp_sort_keys, warp_merge_into_row; the scan kernels at K > 256).
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
constexpr int kMaxSelectK = 4096;  // the widest K every selection kernel takes on the card

__device__ __forceinline__ bool lex_less(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// Insert (v, c) into the warp's ascending buffer in shared memory (K <=
// kMaxK); a no-op if it is not among the K smallest.  Every lane of the warp
// calls it with the same candidate; each lane holds the entries it moves,
// all at once.
__device__ __forceinline__ void warp_insert(float* rv, int* ri, int K, float v, int c,
                                            int lane) {
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

// ---------------------------------------------------------------------------
// The staged bulk-merge selection (stream_topk.cu, pq_scan.cu, rescore.cu).
//
// A list's K-buffer (K <= kMaxSelectK, ascending) lives in shared memory
// beside a staging area of `cap` entries.  An entry is one 64-bit key that
// orders as (value, column) does (staged_key), so a compare-exchange is two
// 64-bit loads, a min and a max, and two stores, with no branch.  A
// candidate that beats the buffer's K-th entry is appended to the staging
// area, one shared atomic per warp and list for the candidates of a ballot;
// nothing is inserted one at a time.  When the staging area nears full, or at
// the end, the threads that own the lists flush them together: a bitonic
// sort of the staged keys, then a bitonic merge-and-truncate into the buffer
// (the element-wise minimum of the buffer and the reversed staged list is a
// bitonic sequence holding exactly the K smallest of both, and log2 K
// half-cleaner stages sort it), and the new K-th entry is read back.
//
// Exact: the K-th entry only falls between flushes, so a candidate that
// does not beat a stale one cannot be among the final K; (value, column) is
// a total order, so the result does not depend on the order the atomics
// give the appends, and a column split merged afterwards keeps one pass's
// tie rule.  Without the threshold skip every valid candidate is staged:
// the same result, more flushes.
// ---------------------------------------------------------------------------

using Key = unsigned long long;

// The key of (v, c): the float's bits made monotone in the high word (-0.0
// folded into +0.0, as the compare treats them), the column's in the low
// word with its sign bit flipped, so that an empty slot (+inf, -1) sorts
// after every finite value and before every (+inf, c >= 0).
__device__ __forceinline__ Key staged_key(float v, int c) {
  const unsigned u = __float_as_uint(v + 0.0f);
  const unsigned hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<Key>(hi) << 32) | (static_cast<unsigned>(c) ^ 0x80000000u);
}
__device__ __forceinline__ float staged_value(Key k) {
  const unsigned hi = static_cast<unsigned>(k >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}
__device__ __forceinline__ int staged_id(Key k) {
  return static_cast<int>(static_cast<unsigned>(k) ^ 0x80000000u);
}
constexpr Key kEmptyKey = 0xff8000007fffffffull;  // staged_key(+inf, -1)
constexpr Key kPadKey = ~0ull;                     // after every key

// The staging area of a list: twice K, at least `floor` (room for the flush
// period's appends beyond the flush threshold), at most kMaxSelectK.
__host__ __device__ inline int staging_cap(int K, int floor) {
  const int c = 2 * K < floor ? floor : 2 * K;
  return c < kMaxSelectK ? c : kMaxSelectK;
}

// Append key `k` to the staging area `sk` with counter *cnt where `want`
// holds; every lane of the warp calls it.  Returns the warp's appends.
__device__ __forceinline__ int staged_append(Key* sk, int* cnt, Key k, bool want, int lane) {
  const unsigned mask = __ballot_sync(kFullMask, want);
  if (mask == 0) return 0;
  const int n = __popc(mask);
  int base = 0;
  if (lane == 0) base = atomicAdd(cnt, n);
  base = __shfl_sync(kFullMask, base, 0);
  if (want) sk[base + __popc(mask & ((1u << lane) - 1u))] = k;
  return n;
}

// Compare-exchange of slots a, b: the smaller to a when `up`, else to b.
__device__ __forceinline__ void staged_cx(Key* k, int a, int b, bool up) {
  const Key x = k[a], y = k[b];
  const Key lo = x < y ? x : y, hi = x < y ? y : x;
  k[a] = up ? lo : hi;
  k[b] = up ? hi : lo;
}

// Shared scratch of a flush: the radix histogram and the selected bin.
struct TrimScratch {
  int hist[256];
  Key kmin, kmax;
  int bin, below, count, cursor;
};

constexpr int kTrimMin = 256;   // trim a staged list only when it holds more
constexpr int kTrimStop = 64;   // stop narrowing once the K-th's bin holds at most this many

// Drop from list l's staging area every key above a bound that the K-th
// smallest of buffer and staging does not exceed, so that the sort that
// follows has fewer keys.  The bound is found MSB first, 8 bits a pass (a
// histogram of the keys still in range, the bin where the K-th falls, that
// bin's range kept) until the bin holds at most kTrimStop keys, starting at
// the byte where the smallest and the largest key first differ (the bytes
// above it put every key in one bin); the staged keys at or below the bound
// are compacted in place.  n[l] becomes their count.  T threads (a multiple
// of 32, at most 256 * 32) take part; sync() orders the steps, the last one
// included.
template <int T, typename Sync>
__device__ void staged_trim(const Key* bk, Key* sk, int* n, int l, int K, int cap, int t,
                            Sync sync, TrimScratch* ws) {
  const int lane = t & 31, total = K + n[l];
  if (t == 0) {
    ws->kmin = ~0ull;
    ws->kmax = 0;
  }
  sync();
  Key mn = ~0ull, mx = 0;
  for (int j = t; j < total; j += T) {
    const Key e = j < K ? bk[l * K + j] : sk[l * cap + j - K];
    mn = min(mn, e);
    mx = max(mx, e);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(kFullMask, mn, o));
    mx = max(mx, __shfl_xor_sync(kFullMask, mx, o));
  }
  if (lane == 0) {
    atomicMin(&ws->kmin, mn);
    atomicMax(&ws->kmax, mx);
  }
  sync();
  const Key diff = ws->kmin ^ ws->kmax;
  const int top = diff == 0 ? 0 : (63 - __clzll(static_cast<long long>(diff))) / 8 * 8;
  Key lo = top == 56 ? 0 : ws->kmin & ~((1ull << (top + 8)) - 1);
  Key bound = top == 56 ? ~0ull : lo + ((1ull << (top + 8)) - 1);
  int below = 0;
  for (int shift = top;; shift -= 8) {
    for (int i = t; i < 256; i += T) ws->hist[i] = 0;
    sync();
    for (int j = t; j < total; j += T) {
      const Key e = j < K ? bk[l * K + j] : sk[l * cap + j - K];
      if (e >= lo && e <= bound) atomicAdd(&ws->hist[(e >> shift) & 255], 1);
    }
    sync();
    if (t < 32) {  // the bin that holds the K-th smallest
      int h[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += (h[i] = ws->hist[8 * lane + i]);
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, incl, o);
        if (lane >= o) incl += y;
      }
      int run = below + incl - sum;
      if (run < K && run + sum >= K) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (run + h[i] >= K) {
            ws->bin = 8 * lane + i;
            ws->below = run;
            ws->count = h[i];
            break;
          }
          run += h[i];
        }
      }
    }
    if (t == 0) ws->cursor = 0;
    sync();
    lo += static_cast<Key>(ws->bin) << shift;
    bound = lo + ((1ull << shift) - 1);
    below = ws->below;
    if (ws->count <= kTrimStop || shift == 0) break;
  }
  // Compact the staged keys at or below the bound in place, kHeld keys a
  // thread at a time: a round's keys are all read before any is written,
  // and its writes land below the end of the keys it read.
  constexpr int kHeld = 4;
  for (int j0 = 0; j0 < n[l]; j0 += kHeld * T) {
    Key held[kHeld];
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int j = j0 + t + i * T;
      held[i] = j < n[l] ? sk[l * cap + j] : kPadKey;
    }
    sync();
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      staged_append(sk + l * cap, &ws->cursor, held[i],
                    held[i] <= bound && j0 + t + i * T < n[l], lane);
    sync();
  }
  n[l] = ws->cursor;
  sync();  // every thread has read the count before the scratch is reused
}

// Flush `nl` lists at once: list l's buffer at bk + l * K, its staging area
// at sk + l * cap holding n[l] keys (reset to 0 on return).  T threads take
// part; sync() orders the stages and is called last, so the buffers are
// whole when it returns.  A list of more than kTrimMin staged keys is
// trimmed first; the staged keys are then padded to P, the next power of 2
// above the largest n[l], with kPadKey, which never enters a buffer.
template <int T, typename Sync>
__device__ void staged_flush(Key* bk, Key* sk, int* n, int nl, int K, int cap, int t,
                             Sync sync, TrimScratch* ws) {
  for (int l = 0; l < nl; ++l)
    if (n[l] > kTrimMin) staged_trim<T>(bk, sk, n, l, K, cap, t, sync, ws);
  int most = 0;
  for (int l = 0; l < nl; ++l) most = max(most, n[l]);
  int P = 1;
  while (P < most) P <<= 1;
  const int lp = __ffs(P) - 1, lk = __ffs(K) - 1;
  for (int i = t; i < nl * P; i += T) {
    const int l = i >> lp, j = i & (P - 1);
    if (j >= n[l]) sk[l * cap + j] = kPadKey;
  }
  sync();
  // Bitonic sort of each staged list, ascending.
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < nl * (P >> 1); i += T) {
        const int l = i >> (lp - 1), w = i & ((P >> 1) - 1);
        const int a = ((w & ~(stride - 1)) << 1) | (w & (stride - 1));
        staged_cx(sk + l * cap, a, a + stride, (a & size) == 0);
      }
      sync();
    }
  }
  // The minimum of buffer[j] and staged[K - 1 - j]: a bitonic sequence
  // holding the K smallest of both.
  for (int i = t; i < nl * K; i += T) {
    const int l = i >> lk, b = K - 1 - (i & (K - 1));
    if (b < P) bk[i] = min(bk[i], sk[l * cap + b]);
  }
  sync();
  for (int dist = K >> 1; dist > 0; dist >>= 1) {
    for (int i = t; i < nl * (K >> 1); i += T) {
      const int l = i >> (lk - 1), w = i & ((K >> 1) - 1);
      const int a = ((w & ~(dist - 1)) << 1) | (w & (dist - 1));
      staged_cx(bk + l * K, a, a + dist, true);
    }
    sync();
  }
  for (int l = 0; l < nl; ++l) n[l] = 0;
}

// ---------------------------------------------------------------------------
// The staged flush into device memory (fused_knn.cuh at K > kMaxK): one
// warp, one row, no CTA barrier, so that it can run inside the scan's
// product pipeline.  The row's K-buffer is a row of the kernel's output,
// values and ids apart, ascending, its first `fill` entries real and the
// rest not yet written (they are (+inf, -1) once the walk ends); its
// staging area of n distinct keys, each below the empty key, lies in
// shared memory.  The flush sorts the staged keys in place, then merges
// them into the row in one pass from the top down: each entry's new place
// is its own place plus its rank in the other list (merge path), so an
// entry that moves is read once and written once, and nothing is
// overwritten before it is read.  Whatever lands at or past K is dropped:
// that truncation is the flush's trim.
// ---------------------------------------------------------------------------

// Sort the n keys at k ascending, one warp: a bitonic network over P =
// next_pow2(n) slots in which every compare-exchange puts the smaller key
// first (the first step of each merge compares mirrored slots).  The slots at or past n are pads above every key that take no
// room: a compare-exchange that reaches one leaves both slots as they are.
__device__ __forceinline__ void warp_sort_keys(Key* k, int n, int lane) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int size = 2; size <= P; size <<= 1) {
    for (int w = lane; w < P / 2; w += 32) {
      const int o = w & ((size >> 1) - 1), base = (w - o) << 1;
      if (base + size - 1 - o < n) staged_cx(k, base + o, base + size - 1 - o, true);
    }
    __syncwarp();
    for (int stride = size >> 2; stride > 0; stride >>= 1) {
      for (int w = lane; w < P / 2; w += 32) {
        const int a = ((w & ~(stride - 1)) << 1) | (w & (stride - 1));
        if (a + stride < n) staged_cx(k, a, a + stride, true);
      }
      __syncwarp();
    }
  }
}

constexpr int kMergeRun = 8;  // consecutive entries of the row a lane holds in the merge

// A lane's run of kMergeRun entries of a row, as loaded (16-byte loads: the
// run starts at a multiple of 8), before they are made keys.
struct MergeRun {
  float4 v[kMergeRun / 4];
  int4 i[kMergeRun / 4];
};
__device__ __forceinline__ void merge_run_load(MergeRun& m, const float* rv, const int* ri,
                                               int j0) {
  if (j0 < 0) return;  // below the row: never read
#pragma unroll
  for (int q = 0; q < kMergeRun / 4; ++q) {
    m.v[q] = *reinterpret_cast<const float4*>(rv + j0 + 4 * q);
    m.i[q] = *reinterpret_cast<const int4*>(ri + j0 + 4 * q);
  }
}

// Merge the n ascending staged keys s (distinct from the row's entries,
// each below the empty key) into the row (rv, ri) of width K whose first
// `fill` entries are real, keeping the K smallest.  The warp takes the row
// 32 * kMergeRun entries at a time from the top, lane l entries g0 + 8 l ..
// + 7, the next group's loads in flight while a group is merged (they lie
// below everything the group writes), and finds each entry's rank r among
// the staged keys (a binary search for the first, then a walk up); entry j
// moves to j + r.  Staged key t has as many entries below it as the group
// has entries of rank at most t, plus g0: the lane whose first entry's
// rank is the last at most t holds them, and t goes to t + that count.  A
// group whose lowest entry has rank 0 is the last: below it nothing moves.
// The lane that writes place K - 1 stores its key at *kth.
__device__ __forceinline__ void warp_merge_into_row(float* __restrict__ rv, int* __restrict__ ri,
                                                    int K, int fill, const Key* s, int n,
                                                    Key* kth, int lane) {
  int P = 1;
  while (P < n) P <<= 1;
  constexpr int kGroup = 32 * kMergeRun;
  int carry = n;  // the rank of the entry above the group: every staged key is below it
  int g0 = ((fill + kMergeRun - 1) & ~(kMergeRun - 1)) - kGroup;
  MergeRun next;
  merge_run_load(next, rv, ri, g0 + kMergeRun * lane);
  for (;; g0 -= kGroup) {
    const int j0 = g0 + kMergeRun * lane;  // this lane's first entry
    Key a[kMergeRun];
#pragma unroll
    for (int q = 0; q < kMergeRun / 4; ++q) {
      const float v[4] = {next.v[q].x, next.v[q].y, next.v[q].z, next.v[q].w};
      const int id[4] = {next.i[q].x, next.i[q].y, next.i[q].z, next.i[q].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 4 * q + e;
        a[4 * q + e] = j < 0 ? 0 : j < fill ? staged_key(v[e], id[e]) : kEmptyKey;
      }
    }
    merge_run_load(next, rv, ri, j0 - kGroup);  // the next group, below this one
    int r[kMergeRun];
    int pos = 0;
    for (int step = P; step > 0; step >>= 1)
      if (pos + step <= n && s[pos + step - 1] < a[0]) pos += step;
    r[0] = pos;
#pragma unroll
    for (int e = 1; e < kMergeRun; ++e) {
      while (pos < n && s[pos] < a[e]) ++pos;
      r[e] = pos;
    }
    __syncwarp();  // the group is read before any of it is written
#pragma unroll
    for (int e = 0; e < kMergeRun; ++e) {
      const int j = j0 + e, to = j + r[e];
      if (j >= 0 && j < fill && r[e] > 0 && to < K) {
        rv[to] = staged_value(a[e]);
        ri[to] = staged_id(a[e]);
        if (to == K - 1) *kth = a[e];
      }
    }
    const int first = __shfl_sync(kFullMask, r[0], 0);
    for (int t0 = first; t0 < carry; t0 += 32) {
      const int t = t0 + lane;
      int L = 0;  // the last lane whose first entry's rank is at most t
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFullMask, r[0], L + step) <= t) L += step;
      int below = 0;
#pragma unroll
      for (int e = 0; e < kMergeRun; ++e) below += __shfl_sync(kFullMask, r[e], L) <= t;
      const int to = t + g0 + kMergeRun * L + below;
      if (t < carry && to < K) {
        const Key k = s[t];
        rv[to] = staged_value(k);
        ri[to] = staged_id(k);
        if (to == K - 1) *kth = k;
      }
    }
    carry = first;
    if (carry == 0) break;
  }
}

// cp.async of 16 bytes (src_bytes of them read, the rest zero-filled) or of
// 4, into shared memory; commit and wait on the groups.
__device__ __forceinline__ void stage_copy16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void stage_copy4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace repro
