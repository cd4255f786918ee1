// Fused kNN: distance tile and top-K selection in one pass, the [m, n]
// distance matrix never written to device memory.
//
// Replaces fused_knn.py::fused_knn_pallas / _kernel of the JAX package: the
// tile
//   finalize(alpha * (fx . gy^T) * gy_scale + hx + hy),
// columns >= n_real, (exclude_self) row == column and (with a mask) the
// columns the query's filter bitmap disallows set to +inf, then the
// threshold-skipped merge into each row's running top-K.  gy is fp32, or a
// bf16 / int8 scan replica (int8 with its per-row scale gy_scale): the TPU
// kernel upcasts it in VMEM after the compressed DMA, this one in shared
// memory after the compressed copy (gemm_tc.cuh).  The storage type, the
// presence of the scale and of the bitmap, the ring depth and the
// K-buffers' place are template parameters, one compiled kernel per
// combination, so the fp32 scan carries no scale code.
//
// The per-query filter (the reference's q_mask, DESIGN.md §17): a bit-packed
// [m, ceil(n / 32)] uint32 bitmap, bit c % 32 of word c / 32 set where query
// row i may see column c (LSB first), one bit a pair where the reference
// blocks an fp32 [m, n] operand beside the tile: 134 MB against 4.3 GB for
// a batch of 1024 over 1,048,576 rows.  A row stride of 0 shares one row of
// words across the batch (an allow-list).  A warp offers 32 consecutive
// columns of a row at a time, so one word, loaded once and read by every
// lane, gives each lane its bit; a disallowed column never enters, exactly
// as a column past n_real.  The masked kernels are instantiations of their
// own, built into a library of their own (fused_knn_masked.cu, compiled
// beside fused_knn.cu), so that the unmasked kernels carry no trace of the
// bitmap: the 128-row layout's accumulators take 128 of a thread's
// registers, and a bitmap test there, even one skipped at run time, spilled.
//
// Bound on the H100: operations.  The product is the 3xTF32 wgmma product of
// gemm_tc.cuh (three TF32 passes, two for a bf16 / int8 gy, at 495 TFLOP/s);
// the only bytes are the operands, the bitmap and the [m, K] results.  One
// CTA owns BM query rows and walks a range of 128-column database tiles: the
// TPU's sequential grid axis over database tiles becomes that walk.
//
// Layout of the CTA: 512 threads, two loader warpgroups and two consumer
// warpgroups (gemm_tc.cuh).  BM = 128 where K <= 32 (each consumer
// warpgroup takes 64 rows by 128 columns), else BM = 64 (64 rows by 64
// columns each), so that the K-buffers fit beside the stages.  Shared
// memory: two operand stages (64 KB each at BM 128, 48 KB at BM 64), R raw
// stages (32 / 24 KB for fp32 gy) and the K-buffers, [BM, K] values and
// [BM, K] ids:
//   BM 128, K <= 32:  R = 2, 225 KB at K = 32;
//   BM 64, K <= 128:  R = 2, 210 KB at K = 128;
//   BM 64, K = 256:   R = 0 (the rows land in the operand stages), 225 KB.
// (Ids kept in the CTA's rows of out_i, to give K = 128 the 128-row layout,
// made the all-pairs call slower: an insertion then reads them from L2.)
// K = 512 to 4096 (a filtered search's k + E, a post-filter's widened
// fetch, or the two-stage scan's overfetch of either) cannot stay beside the
// stages: [64, 512] entries are already 256 KB.
// Their K-buffers are the CTA's rows of its own output, out [splits, m, K],
// in device memory, filled by select.cuh's staged flush into device memory:
// R = 2 (145 KB for fp32 gy), and in the rest of the SM's shared memory a
// staging area of kScap 64-bit keys a row (160 for fp32 gy, 192 bf16, 208
// int8) with the row's count, fill and K-th key.  A column that beats the
// row's K-th entry (+inf until K have entered) is appended with one ballot,
// and nothing is inserted one at a time.  When a row's staging area cannot
// take the next batch of 32 columns, and once at the end of the walk, the
// warp that owns the row sorts the staged keys and merges them into the
// row in one pass (warp_merge_into_row), warp-local, inside the product
// pipeline; the row's first K candidates fill it in bulk.
// The finished [BM, 128] tile needs no room of its own: the epilogue writes
// it into the operand stage its last slice was multiplied from, and each
// consumer warp folds its rows of it (select.cuh) while the tensor cores
// multiply the next tile's first slice and the loaders split the next; the
// stage goes back to the loaders after the selection.  Columns at or past
// n_real, with exclude_self the row's own column, and the columns the
// bitmap clears never enter; dead rows arrive as hy = +inf.
//
// Occupancy: with few query tiles (a serving batch of 1024 queries is 8
// tiles of 128 against 132 SMs) the database axis is split across CTAs
// (grid.y = splits, each a contiguous range of tiles); every split writes a
// partial [m, K] set, which merge_partials.cu then merges, lower splits
// winning ties through the (value, column) order.  The caller picks the
// split from what fused_knn_occupancy reports of this compiled kernel.
//
// The walk (kTable): the contiguous range of tiles above, or, for
// ivf_scan.cu, a range of a tile table.  There the rows come in union tiles
// of tile_m queries, each with its own table of 128-column tiles (first
// column, and the end hi of the cell the tile starts in; columns at or past
// hi never enter), and a CTA owns rows of one union tile only: row block
// blockIdx.x % ceil(min(tile_m, m) / BM) of union tile blockIdx.x / that,
// the rows past the union tile's end dead.  Split s walks entries
// [bounds[s], bounds[s + 1]) of its union tile's table.
#pragma once

#include "gemm_tc.cuh"
#include "scan.cuh"

namespace repro {

constexpr int kFusedBN = 128;
constexpr int kWideMaxK = 32;  // the widest K the 128-row layout holds
// BM = 128 query rows (two warpgroups of 64 rows, each 128 columns wide), or
// 64 (the warpgroups 64 columns wide each).
template <int BM, typename TB>
using FusedGemm = Tf32x3Gemm<BM, kFusedBN, BM / 64, TB>;
static_assert(128 * kFusedBN * sizeof(float) <= FusedGemm<128, int8_t>::kStageBytes &&
                  64 * kFusedBN * sizeof(float) <= FusedGemm<64, int8_t>::kStageBytes,
              "the finished tile fits in a stage");

// Raw stages of the walk: two, or none (the rows land in place) where the
// K-buffers of K = 256 leave no room.
constexpr int fused_raw_stages(int K) { return K <= 128 ? 2 : 0; }

// A row of the wide layout (K > kMaxK): its K-th key as of its last flush
// (the empty key until K candidates have entered), its staged keys, and its
// real entries in the output.
struct WideRow {
  Key kth;
  int staged, fill;
};

// The wide layout's staging area, keys a row: what the SM's shared memory
// holds beside its ring and the rows' state, in multiples of 16.
template <int BM, typename TB>
__host__ __device__ constexpr int wide_staging_cap() {
  return static_cast<int>((kMaxSmem - ring_bytes<FusedGemm<BM, TB>, 2>() -
                           BM * sizeof(WideRow)) /
                          (BM * sizeof(Key))) /
         16 * 16;
}

// kCap: the widest K the kernel takes.  kMaxK keeps the K-buffers in
// shared memory; kMaxSelectK keeps them in the kernel's output and stages
// in shared memory.
template <int BM, typename TB, int R, int kCap>
constexpr size_t fused_smem_bytes(int K) {
  return ring_bytes<FusedGemm<BM, TB>, R>() +
         (kCap > kMaxK ? BM * (sizeof(WideRow) + sizeof(Key) * wide_staging_cap<BM, TB>())
                       : static_cast<size_t>(BM) * K * (sizeof(float) + sizeof(int)));
}

// The tile table's walk: the table (first column, cell end) of each union
// tile, table_stride entries a union tile, and the bounds of each split.
struct TileTable {
  const int2* table;
  const int* bounds;  // [union tiles, splits + 1]
  int table_stride;
  int tile_m;
};

template <int BM, typename TB, bool kScaled, bool kMasked, int R, int kCap, bool kTable>
__global__ void __launch_bounds__(tc::kThreads, 1)
    fused_knn_kernel(const float* __restrict__ fx, const TB* __restrict__ gy,
                     const float* __restrict__ gs, const unsigned* __restrict__ qm,
                     const float* __restrict__ hx, const float* __restrict__ hy,
                     float* __restrict__ out_v, int* __restrict__ out_i, int m, int n, int d,
                     int K, int n_real, int qm_stride, int exclude_self, int skip, float alpha,
                     int fin, int tiles_per_split, TileTable tt) {
  using G = FusedGemm<BM, TB>;
  constexpr bool kInOut = kCap > kMaxK;  // the K-buffers are the output's rows
  extern __shared__ float4 smem4[];
  unsigned char* ring = ring_base(smem4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.y;
  const int kslices = (d + tc::kBK - 1) / tc::kBK;
  // The CTA's rows [row0, row_end) and its range of tiles [t_begin, t_end):
  // tile t starts at column col_of(t), and its columns at or past hi_of(t)
  // never enter.
  int row0, row_end, t_begin, t_end;
  const int2* tiles = nullptr;
  if constexpr (kTable) {
    const int per_tile = (min(tt.tile_m, m) + BM - 1) / BM;
    const int ut = blockIdx.x / per_tile;
    row0 = ut * tt.tile_m + (blockIdx.x % per_tile) * BM;
    row_end = min(m, (ut + 1) * tt.tile_m);
    if (row0 >= row_end) return;  // a block past a short last union tile
    const int* b = tt.bounds + static_cast<size_t>(ut) * (gridDim.y + 1) + split;
    t_begin = b[0];
    t_end = b[1];
    tiles = tt.table + static_cast<size_t>(ut) * tt.table_stride;
  } else {
    row0 = blockIdx.x * BM;
    row_end = m;
    t_begin = split * tiles_per_split;
    t_end = min((n + kFusedBN - 1) / kFusedBN, t_begin + tiles_per_split);
  }
  auto col_of = [&](int t) -> int {
    if constexpr (kTable)
      return tiles[t_begin + t].x;
    else
      return (t_begin + t) * kFusedBN;
  };
  auto hi_of = [&](int t) -> int {
    if constexpr (kTable)
      return tiles[t_begin + t].y;
    else
      return n_real;
  };
  // Row r's K-buffer: in shared memory, or row row0 + r of split `split`
  // of the output; past the ring, the wide layout's rows and staging areas.
  float* rv_all = kInOut ? out_v + (static_cast<size_t>(split) * m + row0) * K
                         : reinterpret_cast<float*>(ring + ring_bytes<G, R>() - 1024);
  int* ri_all = kInOut ? out_i + (static_cast<size_t>(split) * m + row0) * K
                       : reinterpret_cast<int*>(rv_all + BM * K);
  WideRow* wrows = reinterpret_cast<WideRow*>(ring + ring_bytes<G, R>() - 1024);

  if constexpr (kInOut) {
    for (int i = tid; i < BM; i += tc::kThreads) wrows[i] = WideRow{kEmptyKey, 0, 0};
  } else {
    for (int i = tid; i < BM * K; i += tc::kThreads) {
      rv_all[i] = CUDART_INF_F;
      ri_all[i] = -1;
    }
  }
  float hxr[2];  // this thread's two accumulator rows' hx
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + G::row_of(2 * h);
    hxr[h] = r < row_end ? hx[r] : 0.f;
  }
  __syncthreads();

  auto load = [&](int s, unsigned char* raw, bool in_place, int lt) {
    G::load(raw, in_place, lt, fx, row_end, gy, n, d, row0, col_of(s / kslices),
            (s % kslices) * tc::kBK);
  };
  // Epilogue, in the reference's order (fused_knn.py _select):
  //   t = alpha * acc;  t *= gs[col] (with a scale);  finalize(t + hx + hy)
  // into the finished tile (tile_index), in the stage the last product read;
  // the tile's hy (and gs) lines are brought into L1 beside that product.
  auto pre = [&](int t) {
    const int col = col_of(t) + 32 * tid;
    if (tid < kFusedBN / 32 && col < n) {
      tc::prefetch_l1(hy + col);
      if constexpr (kScaled) tc::prefetch_l1(gs + col);
    }
    if constexpr (kMasked) {  // and each row's four words of the tile's bitmap
      const int col0 = col_of(t);
      if (tid < BM && row0 + tid < m && col0 < n_real)
        tc::prefetch_l1(qm + static_cast<size_t>(row0 + tid) * qm_stride + col0 / 32);
    }
  };
  auto epi = [&](int t, float(&a)[G::kAcc], unsigned char* st) {
    float* tile = reinterpret_cast<float*>(st);
    const int col0 = col_of(t);
#pragma unroll
    for (int j = 0; j < G::kAcc / 4; ++j) {
      const int c = G::col_of(4 * j);
      float hyv[2], gsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + c + e;
        hyv[e] = col < n ? hy[col] : CUDART_INF_F;
        if constexpr (kScaled) gsv[e] = col < n ? gs[col] : 1.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = alpha * a[4 * j + 2 * h + e];
          if constexpr (kScaled) x *= gsv[e];
          v[e] = finalize(x + hxr[h] + hyv[e], fin);
        }
        *reinterpret_cast<float2*>(tile + tile_index(G::row_of(2 * h), c)) =
            make_float2(v[0], v[1]);
      }
    }
  };
  // Selection, in one go beside the next tile's first product (the stage
  // goes back to the loaders after it): warp w folds rows w, w + 8, ... of
  // the finished tile.  With a bitmap, the warp first loads its rows' words
  // of the tile (four a row, col0 being a multiple of 128), one or two a
  // lane, all in flight at once; a row's batch of 32 columns then takes
  // its word from the lane holding it.
  constexpr int kSelWarps = tc::kConsumers / 32;
  constexpr int kHeld = BM / kSelWarps * (kFusedBN / 32) / 32;  // words a lane holds
  auto select = [&](int t, int kq, unsigned char* st) {
    if (kq != 0) return;
    const float* tile = reinterpret_cast<const float*>(st);
    const int col0 = col_of(t);
    const int col_hi = hi_of(t);
    unsigned held[kHeld];
    if constexpr (kMasked) {
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        const int e = h * 32 + lane, b = e % 4;  // word b of the warp's row e / 4
        const int grow = row0 + warp + kSelWarps * (e / 4);
        held[h] = grow < row_end && col0 + 32 * b < n_real
                      ? qm[static_cast<size_t>(grow) * qm_stride + col0 / 32 + b]
                      : 0u;
      }
    }
    for (int r = warp, rr = 0; r < BM; r += kSelWarps, ++rr) {
      const int grow = row0 + r;
      if (grow >= row_end) break;
      float* rv = rv_all + static_cast<size_t>(r) * K;
      int* ri = ri_all + static_cast<size_t>(r) * K;
      float kv = rv[K - 1];
      int ki = ri[K - 1];
#pragma unroll
      for (int b = 0; b < kFusedBN; b += 32) {
        const int c = col0 + b + lane;
        bool valid = c < col_hi && !(exclude_self && c == grow);
        if constexpr (kMasked) {
          const int e = rr * 4 + b / 32;  // this row's word b / 32, in lane e % 32
          const unsigned w = __shfl_sync(kFullMask, e < 32 ? held[0] : held[kHeld - 1], e % 32);
          valid = valid && ((w >> lane) & 1u);
        }
        warp_offer(rv, ri, K, tile[tile_index(r, b + lane)], c, valid, skip != 0, kv, ki,
                   lane);
      }
    }
  };
  if (tc::is_loader()) {
    tc::loader_regs();
    tc_load<G, R>(ring, t_end - t_begin, kslices, load);
    return;
  }
  tc::consumer_regs();

  if constexpr (kInOut) {
    // The wide layout: row r's staging area of kScap keys past the rows'
    // state.  Tile t's columns are appended beside tile t + 1's first
    // product; a row whose staging area cannot take a batch of 32 is
    // flushed there, before the batch is held against its new K-th, and
    // every row with staged keys once the walk ends.
    constexpr int kScap = wide_staging_cap<BM, TB>();
    static_assert(kScap >= 32, "a row stages a batch of 32 columns");
    Key* wstage = reinterpret_cast<Key*>(wrows + BM);
    auto flush = [&](int r, int ns) {  // row r's ns staged keys into its K-buffer
      WideRow& w = wrows[r];
      const int fill = w.fill;
      Key* sk = wstage + r * kScap;
      warp_sort_keys(sk, ns, lane);
      warp_merge_into_row(rv_all + static_cast<size_t>(r) * K,
                          ri_all + static_cast<size_t>(r) * K, K, fill, sk, ns, &w.kth, lane);
      __syncwarp();
      if (lane == 0) w.fill = min(K, fill + ns);
      __syncwarp();
    };
    auto select_wide = [&](int t, int kq, unsigned char* st) {
      if (kq != 0) return;
      const float* tile = reinterpret_cast<const float*>(st);
      const int col0 = col_of(t);
      const int col_hi = hi_of(t);
      // The bitmap's words and the column test repeat the narrow select's
      // text on purpose: shared between the two, they changed the spills of
      // the narrow kernels (tests/ptxas_registers.json).
      unsigned held[kHeld];
      if constexpr (kMasked) {
#pragma unroll
        for (int h = 0; h < kHeld; ++h) {
          const int e = h * 32 + lane, b = e % 4;
          const int grow = row0 + warp + kSelWarps * (e / 4);
          held[h] = grow < row_end && col0 + 32 * b < n_real
                        ? qm[static_cast<size_t>(grow) * qm_stride + col0 / 32 + b]
                        : 0u;
        }
      }
      for (int r = warp, rr = 0; r < BM; r += kSelWarps, ++rr) {
        const int grow = row0 + r;
        if (grow >= row_end) break;
        WideRow& w = wrows[r];
        Key* sk = wstage + r * kScap;
        Key thr = skip ? w.kth : kEmptyKey;
        int ns = w.staged;
#pragma unroll
        for (int b = 0; b < kFusedBN; b += 32) {
          const int c = col0 + b + lane;
          bool valid = c < col_hi && !(exclude_self && c == grow);
          if constexpr (kMasked) {
            const int e = rr * 4 + b / 32;
            const unsigned wd =
                __shfl_sync(kFullMask, e < 32 ? held[0] : held[kHeld - 1], e % 32);
            valid = valid && ((wd >> lane) & 1u);
          }
          const Key key = staged_key(tile[tile_index(r, b + lane)], c);
          unsigned mask = __ballot_sync(kFullMask, valid && key < thr);
          if (ns + __popc(mask) > kScap) {  // full: flush, then hold the batch to the new K-th
            flush(r, ns);
            ns = 0;
            thr = skip ? w.kth : kEmptyKey;
            mask = __ballot_sync(kFullMask, valid && key < thr);
          }
          if ((mask >> lane) & 1u) sk[ns + __popc(mask & ((1u << lane) - 1u))] = key;
          ns += __popc(mask);
        }
        __syncwarp();
        if (lane == 0) w.staged = ns;
      }
      __syncwarp();
    };
    tc_multiply<G, R>(ring, t_end - t_begin, kslices, pre, epi, select_wide);
    // The last flushes, and the empty slots past each row's entries.
    for (int r = warp; r < BM && row0 + r < row_end; r += kSelWarps) {
      if (wrows[r].staged > 0) flush(r, wrows[r].staged);
      for (int j = wrows[r].fill + lane; j < K; j += 32) {
        rv_all[static_cast<size_t>(r) * K + j] = CUDART_INF_F;
        ri_all[static_cast<size_t>(r) * K + j] = -1;
      }
    }
  } else {
    tc_multiply<G, R>(ring, t_end - t_begin, kslices, pre, epi, select);
    // The CTA's rows' K-buffers, as split `split` of out [splits, m, K].
    for (int r = warp; r < BM; r += tc::kConsumers / 32) {
      const int grow = row0 + r;
      if (grow >= row_end) break;
      const size_t base = (static_cast<size_t>(split) * m + grow) * K;
      for (int j = lane; j < K; j += 32) {
        out_v[base + j] = rv_all[r * K + j];
        out_i[base + j] = ri_all[r * K + j];
      }
    }
  }
}

// Allow the kernel of (BM, TB, kScaled, kMasked, kTable) at width K its
// dynamic shared memory; f(kernel, bytes), or an error if BM and K have no
// layout that fits an SM (BM 128 takes K up to kWideMaxK, BM 64 up to
// kMaxSelectK).
template <typename TB, bool kScaled, bool kMasked, bool kTable, typename F>
int with_fused_kernel(int bm, int K, F&& f) {
  auto go = [&](auto kernel, size_t smem) -> int {
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return f(kernel, smem);
  };
  if (bm == 128 && K <= kWideMaxK)
    return go(fused_knn_kernel<128, TB, kScaled, kMasked, 2, kMaxK, kTable>,
              fused_smem_bytes<128, TB, 2, kMaxK>(K));
  if (bm != 64) return cudaErrorInvalidValue;
  if (K > kMaxK)
    return go(fused_knn_kernel<64, TB, kScaled, kMasked, 2, kMaxSelectK, kTable>,
              fused_smem_bytes<64, TB, 2, kMaxSelectK>(K));
  if (fused_raw_stages(K) == 2)
    return go(fused_knn_kernel<64, TB, kScaled, kMasked, 2, kMaxK, kTable>,
              fused_smem_bytes<64, TB, 2, kMaxK>(K));
  return go(fused_knn_kernel<64, TB, kScaled, kMasked, 0, kMaxK, kTable>,
            fused_smem_bytes<64, TB, 0, kMaxK>(K));
}

// out[0] = CTAs resident per SM of `kernel` with `smem` bytes, out[1] =
// database columns per tile, out[2] = the bytes.
template <typename Kernel>
int fused_report(Kernel kernel, size_t smem, int* out) {
  int ctas = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, tc::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ctas;
  out[1] = kFusedBN;
  out[2] = static_cast<int>(smem);
  return 0;
}

// out[0] = CTAs resident per SM of the kernel at (bm, K, gy_dtype, scaled),
// registers and shared memory both counted; out[1] = database columns per
// tile; out[2] = dynamic shared memory per CTA in bytes.
template <bool kMasked>
int fused_occupancy(int bm, int K, int gy_dtype, int scaled, int* out) {
  if (!valid_k(K, kMaxSelectK)) return cudaErrorInvalidValue;
  return dispatch_gy(gy_dtype, scaled != 0, [&](auto tb, auto sc) -> int {
    using TB = typename decltype(tb)::type;
    constexpr bool kS = decltype(sc)::value;
    return with_fused_kernel<TB, kS, kMasked, false>(
        bm, K, [&](auto kernel, size_t smem) { return fused_report(kernel, smem, out); });
  });
}

// The launch, checked: gy [n, d] in the storage type gy_dtype names; gs the
// per-row scales [n] or null; qm the bitmap (kMasked only), query row i's
// ceil(n / 32) words at qm + i * qm_stride; out [splits, m, K].
template <bool kMasked>
int fused_launch(const float* fx, const void* gy, const float* gs, const unsigned* qm,
                 const float* hx, const float* hy, float* out_v, int* out_i, int m, int n, int d,
                 int K, int n_real, int qm_stride, int exclude_self, int threshold_skip,
                 float alpha, int fin, int gy_dtype, int bm, int splits, int tiles_per_split,
                 void* stream) {
  const int n_tiles = (n + kFusedBN - 1) / kFusedBN;
  if (m <= 0 || n <= 0 || d <= 0 || d % 4 != 0 || !valid_k(K, kMaxSelectK) || n_real < 0 ||
      n_real > n || (kMasked && (qm == nullptr || qm_stride < 0)) || splits < 1 ||
      tiles_per_split < 1 || (splits - 1) * tiles_per_split >= n_tiles ||
      splits * tiles_per_split < n_tiles || splits > 65535)
    return cudaErrorInvalidValue;
  return dispatch_gy(gy_dtype, gs != nullptr, [&](auto tb, auto sc) -> int {
    using TB = typename decltype(tb)::type;
    constexpr bool kS = decltype(sc)::value;
    return with_fused_kernel<TB, kS, kMasked, false>(bm, K, [&](auto kernel, size_t smem) {
      const dim3 grid((m + bm - 1) / bm, splits);
      kernel<<<grid, tc::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          fx, static_cast<const TB*>(gy), gs, qm, hx, hy, out_v, out_i, m, n, d, K, n_real,
          qm_stride, exclude_self, threshold_skip, alpha, fin, tiles_per_split, TileTable{});
      return static_cast<int>(cudaGetLastError());
    });
  });
}

}  // namespace repro
