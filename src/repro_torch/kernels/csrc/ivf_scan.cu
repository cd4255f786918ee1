// IVF cell-probed scan: the fused kNN scan restricted to the cells each
// query tile probes.
//
// Replaces ivf_scan.py::ivf_scan_pallas / _kernel of the JAX package.  The
// corpus is cell-packed (core/ivf.py::pack_cells): cell c owns the
// contiguous slots [c * cell_cap, (c + 1) * cell_cap), its rows first, pad
// slots after them dead through hy = +inf.  probes [nt, W] holds, per tile
// of tile_m queries, the ascending union of its queries' probed cells,
// padded by repeating the last one (core/ivf.py::tile_probe_lists).  Every
// query of a tile scans the whole union: tile_m is part of the result's
// definition, as in the reference, not a block size.  Ids are packed slots
// cell * cell_cap + lane.
//
// The TPU kernel names each probed cell's block in its index map (scalar
// prefetch), so a cell not in the list is never read.  Here a CTA reads its
// tile's probe list and walks only those cells' rows: the same property,
// since the column loop starts at the cell's base.  The walk also ends at
// each cell's extent (one past its last live slot, from the wrapper's live
// mask), rounded up to a 128-column tile, instead of at cell_cap: the pad
// and dead slots past it are +inf and can never be selected, so the result
// is the whole-cell scan's.  A slot
// equal to its predecessor is skipped; the reference sets such a slot's
// tile to +inf, and under the (value, slot) order that gives the same set.
//
// Bound on the H100: operations (2 * rows * scanned rows * d fp32 FMAs, as
// in fused_knn.cu), for every storage type of gy.  Grid: (query blocks of BM
// rows, splits of the probe list).  Each CTA belongs to one union tile, so
// BM divides tile_m or the batch is one tile; it walks a contiguous range of
// the W slots with the tile walk of scan.cuh.  Ranges of ascending cells
// hold ascending slots, so merge_partials.cu merges the splits' partial
// sets with the same tie rule as one pass.
#include "scan.cuh"

namespace repro {

template <int BM, typename TB, bool kScaled>
__global__ void __launch_bounds__(kThreads)
    ivf_scan_kernel(const int* __restrict__ probes, const int* __restrict__ extent,
                    const float* __restrict__ fx, const TB* __restrict__ gy,
                    const float* __restrict__ gs, const float* __restrict__ hx,
                    const float* __restrict__ hy, float* __restrict__ out_v,
                    int* __restrict__ out_i, int m, int d, int S, int W, int K, int cell_cap,
                    int tile_m, int skip, float alpha, int fin, int slots_per_split) {
  extern __shared__ float4 smem4[];
  const ScanSmem<BM> s(reinterpret_cast<float*>(smem4), K);
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int* plist = probes + static_cast<size_t>(row0 / tile_m) * W;
  const int j_begin = split * slots_per_split;
  const int j_end = min(W, j_begin + slots_per_split);
  float hxr[BM / 16];
  scan_init<BM>(s, K, hx, row0, m, hxr);
  for (int j = j_begin; j < j_end; ++j) {
    const int cell = plist[j];
    if (j > 0 && cell == plist[j - 1]) continue;  // duplicate padding
    const int base = cell * cell_cap;
    if (cell < 0 || base >= S) continue;
    const int hi = base + max(0, min(extent[cell], cell_cap));
    for (int col0 = base; col0 < hi; col0 += kBN)
      scan_tile<BM, TB, kScaled>(s, K, fx, m, d, gy, gs, hy, S, row0, col0, hi, 0, skip != 0,
                                 alpha, fin, hxr);
  }
  scan_store<BM>(s, K, row0, m, split, out_v, out_i);
}

template <int BM, typename TB, bool kScaled>
int launch_ivf(const int* probes, const int* extent, const float* fx, const TB* gy,
               const float* gs, const float* hx, const float* hy, float* vals, int* idx, int m,
               int d, int S, int W, int K, int cell_cap, int tile_m, int skip, float alpha,
               int fin, int splits, int slots_per_split, cudaStream_t stream) {
  const size_t smem = scan_prepare<BM>(ivf_scan_kernel<BM, TB, kScaled>, K);
  if (smem == 0) return cudaErrorInvalidValue;
  const dim3 grid((m + BM - 1) / BM, splits);
  ivf_scan_kernel<BM, TB, kScaled><<<grid, kThreads, smem, stream>>>(
      probes, extent, fx, gy, gs, hx, hy, vals, idx, m, d, S, W, K, cell_cap, tile_m, skip,
      alpha, fin, slots_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// As fused_knn_occupancy, for this kernel.
extern "C" int ivf_scan_occupancy(int bm, int K, int gy_dtype, int scaled, int* out) {
  using namespace repro;
  if (!valid_k(K)) return cudaErrorInvalidValue;
  return dispatch_gy(gy_dtype, scaled != 0, [&](auto tb, auto sc) -> int {
    using TB = typename decltype(tb)::type;
    constexpr bool kS = decltype(sc)::value;
    if (bm == 128 && K <= 128) return scan_occupancy<128>(ivf_scan_kernel<128, TB, kS>, K, out);
    if (bm == 64) return scan_occupancy<64>(ivf_scan_kernel<64, TB, kS>, K, out);
    return cudaErrorInvalidValue;
  });
}

// probes [ceil(m / tile_m), W]; extent [S / cell_cap]: the leading slots
// of each cell to scan; gy [S, d] in the storage type
// gy_dtype names; gs (nullable) and hy [S]; out_v/out_i: [splits, m, K];
// split s holds the partial set of the slots [s * slots_per_split,
// (s + 1) * slots_per_split) of each tile's list.
extern "C" int ivf_scan(const int* probes, const int* extent, const float* fx, const void* gy,
                        const float* gs, const float* hx, const float* hy, float* out_v,
                        int* out_i, int m, int d, int S, int W, int K, int cell_cap, int tile_m,
                        int threshold_skip, float alpha, int fin, int gy_dtype, int bm,
                        int splits, int slots_per_split, void* stream) {
  using namespace repro;
  if (extent == nullptr || m <= 0 || d <= 0 || d % 4 != 0 || !valid_k(K) || cell_cap <= 0 ||
      S <= 0 ||
      S % cell_cap != 0 || W <= 0 || tile_m <= 0 || (tile_m % bm != 0 && m > tile_m) ||
      splits < 1 || slots_per_split < 1 || (splits - 1) * slots_per_split >= W ||
      splits * slots_per_split < W || splits > 65535)
    return cudaErrorInvalidValue;
  return dispatch_gy(gy_dtype, gs != nullptr, [&](auto tb, auto sc) -> int {
    using TB = typename decltype(tb)::type;
    constexpr bool kS = decltype(sc)::value;
    const TB* g = static_cast<const TB*>(gy);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bm == 128 && K <= 128)
      return launch_ivf<128, TB, kS>(probes, extent, fx, g, gs, hx, hy, out_v, out_i, m, d, S,
                                     W, K, cell_cap, tile_m, threshold_skip, alpha, fin, splits,
                                     slots_per_split, st);
    if (bm == 64)
      return launch_ivf<64, TB, kS>(probes, extent, fx, g, gs, hx, hy, out_v, out_i, m, d, S,
                                    W, K, cell_cap, tile_m, threshold_skip, alpha, fin, splits,
                                    slots_per_split, st);
    return cudaErrorInvalidValue;
  });
}
