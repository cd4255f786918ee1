// IVF cell-probed scan: the fused kNN scan restricted to the cells each
// query tile probes.
//
// Replaces ivf_scan.py::ivf_scan_pallas / _kernel of the JAX package.  The
// corpus is cell-packed (core/ivf.py::pack_cells): cell c owns the
// contiguous slots [c * cell_cap, (c + 1) * cell_cap), its rows first, pad
// slots after them dead through hy = +inf.  Each tile of tile_m queries has
// a probe list, the ascending union of its queries' probed cells, padded by
// repeating the last one (core/ivf.py::tile_probe_lists).  Every query of a
// tile scans the whole union: tile_m is part of the result's definition, as
// in the reference, not a block size.  Ids are packed slots
// cell * cell_cap + lane.
//
// The TPU kernel names each probed cell's block in its index map (scalar
// prefetch), so a cell not in the list is never read.  Here the wrapper
// turns the lists into a tile table (kernels/ivf_scan.py::tile_table): per
// union tile, one entry for each 128-column tile of each distinct cell of
// its list, in ascending slot order, up to the cell's extent (one past its
// last live slot; the slots past it are +inf and can never be selected).
// An entry holds the tile's first column and the cell's end hi; columns at
// or past hi never enter, so a tile that runs into the next cell (cell_cap
// not a multiple of 128) takes nothing of it.  A slot equal to its
// predecessor adds no entry; the reference sets such a slot's tile to +inf,
// and under the (value, slot) order that gives the same set.
//
// Bound on the H100: operations (2 * rows * scanned rows * d, as three TF32
// passes on the tensor cores, two for a bf16 / int8 gy).  The walk is the
// fused kernel's (fused_knn.cuh, kTable): the 3xTF32 wgmma product of
// gemm_tc.cuh with two loader and two consumer warpgroups, the selection
// beside the next tile's product, BM 128 rows for K <= 32 (else 64), the
// K-buffers in the output's rows for K > 256.  Grid: (row blocks of the
// union tiles, splits).  A CTA owns rows of one union tile only, so union
// tiles of fewer than BM queries run with dead rows.  Each split takes a
// range of its union tile's table, by tiles, so that cells of uneven size
// balance; the ranges are ascending, so merge_partials.cu merges the splits'
// partial sets with the tie rule of one pass.
#include <algorithm>

#include "fused_knn.cuh"

namespace repro {

// f(kernel, smem) of the table-walking kernel for (gy_dtype, scaled).
template <typename TB, bool kScaled, typename F>
int with_ivf_kernel(int bm, int K, F&& f) {
  return with_fused_kernel<TB, kScaled, false, true>(bm, K, static_cast<F&&>(f));
}

// The tile table and the split bounds, on the card (kernels/ivf_scan.py's
// tile_table and split_bounds are the plain versions), in one launch with no
// read back: a CTA a union tile.  Slot j of the list adds ceil(extent / 128)
// entries when it names a cell and differs from its predecessor; a scan
// over the slots, 256 at a time, places each slot's entries.  The caller
// sizes the rows (T entries) by the bound min(W, ncells) * ceil(cell_cap /
// 128), so the count is never read on the host; entries past it are not
// written, and the bounds never reach them.
constexpr int kTableThreads = 256;

__global__ void __launch_bounds__(kTableThreads)
    ivf_table_kernel(const int* __restrict__ probes, const int* __restrict__ extent,
                     int2* __restrict__ table, int* __restrict__ bounds, int W, int ncells,
                     int cell_cap, int T, int splits) {
  __shared__ int warp_sum[kTableThreads / 32];
  __shared__ int carry;
  const int u = blockIdx.x, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int* p = probes + static_cast<size_t>(u) * W;
  int2* row = table + static_cast<size_t>(u) * T;
  if (t == 0) carry = 0;
  __syncthreads();
  for (int j0 = 0; j0 < W; j0 += kTableThreads) {
    const int j = j0 + t;
    int cell = 0, ext = 0, n = 0;
    if (j < W) {
      cell = p[j];
      if (cell >= 0 && cell < ncells && (j == 0 || cell != p[j - 1])) {
        ext = min(max(extent[cell], 0), cell_cap);
        n = (ext + kFusedBN - 1) / kFusedBN;
      }
    }
    int x = n;  // the inclusive scan of n over the warp
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int y = __shfl_up_sync(kFullMask, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    int first = carry + x - n, total = 0;  // this slot's first entry; the chunk's entries
    for (int w = 0; w < kTableThreads / 32; ++w) {
      first += w < warp ? warp_sum[w] : 0;
      total += warp_sum[w];
    }
    const int base = cell * cell_cap;
    for (int i = 0; i < n; ++i) row[first + i] = make_int2(base + i * kFusedBN, base + ext);
    __syncthreads();  // carry and warp_sum are read before they change
    if (t == 0) carry += total;
    __syncthreads();
  }
  for (int s = t; s <= splits; s += kTableThreads)
    bounds[static_cast<size_t>(u) * (splits + 1) + s] =
        static_cast<int>(static_cast<long long>(carry) * s / splits);
}

}  // namespace repro

// probes [nt, W]; extent [ncells]; table [nt, T, 2] (first column, cell
// end); bounds [nt, splits + 1].
extern "C" int ivf_scan_table(const int* probes, const int* extent, int* table, int* bounds,
                              int nt, int W, int ncells, int cell_cap, int T, int splits,
                              void* stream) {
  using namespace repro;
  if (nt <= 0 || W <= 0 || ncells <= 0 || cell_cap <= 0 || T <= 0 || splits < 1 ||
      static_cast<long long>(std::min(W, ncells)) * ((cell_cap + kFusedBN - 1) / kFusedBN) > T)
    return cudaErrorInvalidValue;
  ivf_table_kernel<<<nt, kTableThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      probes, extent, reinterpret_cast<int2*>(table), bounds, W, ncells, cell_cap, T, splits);
  return static_cast<int>(cudaGetLastError());
}

// The launch parameters of this compiled kernel at BM query rows (128 for
// K <= 32, or 64), width K (up to 4096), gy storage type and scale, as
// fused_knn_occupancy reports them.
extern "C" int ivf_scan_occupancy(int bm, int K, int gy_dtype, int scaled, int* out) {
  using namespace repro;
  if (!valid_k(K, kMaxSelectK)) return cudaErrorInvalidValue;
  return dispatch_gy(gy_dtype, scaled != 0, [&](auto tb, auto sc) -> int {
    using TB = typename decltype(tb)::type;
    constexpr bool kS = decltype(sc)::value;
    return with_ivf_kernel<TB, kS>(
        bm, K, [&](auto kernel, size_t smem) { return fused_report(kernel, smem, out); });
  });
}

// table [ceil(m / tile_m), T, 2]: per union tile, its tile table (first
// column, cell end; ivf_scan_table), T entries a row; bounds
// [ceil(m / tile_m), splits + 1]: split
// s walks entries [bounds[s], bounds[s + 1]).  gy [S, d] in the storage type
// gy_dtype names; gs (nullable) and hy [S]; out_v/out_i: [splits, m, K].
extern "C" int ivf_scan(const int* table, const int* bounds, const float* fx, const void* gy,
                        const float* gs, const float* hx, const float* hy, float* out_v,
                        int* out_i, int m, int d, int S, int T, int K, int tile_m,
                        int threshold_skip, float alpha, int fin, int gy_dtype, int bm,
                        int splits, void* stream) {
  using namespace repro;
  if (table == nullptr || bounds == nullptr || m <= 0 || d <= 0 || d % 4 != 0 ||
      !valid_k(K, kMaxSelectK) || S <= 0 || T <= 0 || tile_m <= 0 || (bm != 64 && bm != 128) ||
      splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  const int n_tiles = (m + tile_m - 1) / tile_m;
  const int per_tile = (std::min(tile_m, m) + bm - 1) / bm;
  const TileTable tt{reinterpret_cast<const int2*>(table), bounds, T, tile_m};
  return dispatch_gy(gy_dtype, gs != nullptr, [&](auto tb, auto sc) -> int {
    using TB = typename decltype(tb)::type;
    constexpr bool kS = decltype(sc)::value;
    return with_ivf_kernel<TB, kS>(bm, K, [&](auto kernel, size_t smem) {
      const dim3 grid(n_tiles * per_tile, splits);
      kernel<<<grid, tc::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          fx, static_cast<const TB*>(gy), gs, nullptr, hx, hy, out_v, out_i, m, S, d, K, S, 0,
          0, threshold_skip, alpha, fin, 0, tt);
      return static_cast<int>(cudaGetLastError());
    });
  });
}
