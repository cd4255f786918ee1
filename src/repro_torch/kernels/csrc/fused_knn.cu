// Fused kNN: distance tile and top-K selection in one pass, the [m, n]
// distance matrix never written to device memory.
//
// Replaces fused_knn.py::fused_knn_pallas / _kernel of the JAX package
// without the per-query mask: the tile
//   finalize(alpha * (fx . gy^T) * gy_scale + hx + hy),
// columns >= n_real and (exclude_self) row == column set to +inf, then the
// threshold-skipped merge into each row's running top-K.  gy is fp32, or a
// bf16 / int8 scan replica (int8 with its per-row scale gy_scale): the TPU
// kernel upcasts it in VMEM after the compressed DMA, this one in registers
// after the compressed load (gemm.cuh), so the product stays fp32.  The
// storage type and the presence of the scale are template parameters, one
// compiled kernel per pair, so the fp32 scan carries no scale code.
//
// Bound on the H100: operations (2*m*n*d fp32 FMAs; the only bytes are the
// operands and [m, K] results), for every storage type: the replica cuts the
// bytes of the database stream, not the FMAs.  One CTA owns BM query rows
// and walks a range of 128-column database tiles (scan.cuh): the TPU's
// sequential grid axis over database tiles becomes this loop.
//
// Occupancy: with few query tiles (a serving batch of 1024 queries is 8
// tiles of 128 against 132 SMs) the database axis is split across CTAs
// (grid.y = splits, each a contiguous range of tiles); every split writes a
// partial [m, K] set, which merge_partials.cu then merges, lower splits
// winning ties through the (value, column) order.  BM = 128 for K <= 128;
// K = 256 needs BM = 64.  The caller picks BM and the split from what
// fused_knn_occupancy reports of this compiled kernel.
#include "scan.cuh"

namespace repro {

template <int BM, typename TB, bool kScaled>
__global__ void __launch_bounds__(kThreads)
    fused_knn_kernel(const float* __restrict__ fx, const TB* __restrict__ gy,
                     const float* __restrict__ gs, const float* __restrict__ hx,
                     const float* __restrict__ hy, float* __restrict__ out_v,
                     int* __restrict__ out_i, int m, int n, int d, int K, int n_real,
                     int exclude_self, int skip, float alpha, int fin, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  const ScanSmem<BM> s(reinterpret_cast<float*>(smem4), K);
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  float hxr[BM / 16];
  scan_init<BM>(s, K, hx, row0, m, hxr);
  for (int t = t_begin; t < t_end; ++t)
    scan_tile<BM, TB, kScaled>(s, K, fx, m, d, gy, gs, hy, n, row0, t * kBN, n_real,
                               exclude_self, skip != 0, alpha, fin, hxr);
  scan_store<BM>(s, K, row0, m, split, out_v, out_i);
}

template <int BM, typename TB, bool kScaled>
int launch_fused(const float* fx, const TB* gy, const float* gs, const float* hx,
                 const float* hy, float* vals, int* idx, int m, int n, int d, int K,
                 int n_real, int exclude_self, int skip, float alpha, int fin, int splits,
                 int tiles_per_split, cudaStream_t stream) {
  const size_t smem = scan_prepare<BM>(fused_knn_kernel<BM, TB, kScaled>, K);
  if (smem == 0) return cudaErrorInvalidValue;
  const dim3 grid((m + BM - 1) / BM, splits);
  fused_knn_kernel<BM, TB, kScaled><<<grid, kThreads, smem, stream>>>(
      fx, gy, gs, hx, hy, vals, idx, m, n, d, K, n_real, exclude_self, skip, alpha, fin,
      tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// The launch parameters of this compiled kernel at BM query rows, width K,
// gy storage type (0 fp32, 1 bf16, 2 int8) and with or without a scale:
// out[0] = CTAs resident per SM (registers and shared memory both counted),
// out[1] = database columns per tile, out[2] = dynamic shared memory per CTA
// in bytes.
extern "C" int fused_knn_occupancy(int bm, int K, int gy_dtype, int scaled, int* out) {
  using namespace repro;
  if (!valid_k(K)) return cudaErrorInvalidValue;
  return dispatch_gy(gy_dtype, scaled != 0, [&](auto tb, auto sc) -> int {
    using TB = typename decltype(tb)::type;
    constexpr bool kS = decltype(sc)::value;
    if (bm == 128 && K <= 128) return scan_occupancy<128>(fused_knn_kernel<128, TB, kS>, K, out);
    if (bm == 64) return scan_occupancy<64>(fused_knn_kernel<64, TB, kS>, K, out);
    return cudaErrorInvalidValue;
  });
}

// gy [n, d] in the storage type gy_dtype names; gs: the per-row scales [n],
// or null.  out_v/out_i: [splits, m, K]; split s holds the partial set of
// database tiles [s * tiles_per_split, (s + 1) * tiles_per_split).
extern "C" int fused_knn(const float* fx, const void* gy, const float* gs, const float* hx,
                         const float* hy, float* out_v, int* out_i, int m, int n, int d, int K,
                         int n_real, int exclude_self, int threshold_skip, float alpha, int fin,
                         int gy_dtype, int bm, int splits, int tiles_per_split, void* stream) {
  using namespace repro;
  const int n_tiles = (n + kBN - 1) / kBN;
  if (m <= 0 || n <= 0 || d <= 0 || d % 4 != 0 || !valid_k(K) || n_real < 0 || n_real > n ||
      splits < 1 || tiles_per_split < 1 || (splits - 1) * tiles_per_split >= n_tiles ||
      splits * tiles_per_split < n_tiles || splits > 65535)
    return cudaErrorInvalidValue;
  return dispatch_gy(gy_dtype, gs != nullptr, [&](auto tb, auto sc) -> int {
    using TB = typename decltype(tb)::type;
    constexpr bool kS = decltype(sc)::value;
    const TB* g = static_cast<const TB*>(gy);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bm == 128 && K <= 128)
      return launch_fused<128, TB, kS>(fx, g, gs, hx, hy, out_v, out_i, m, n, d, K, n_real,
                                       exclude_self, threshold_skip, alpha, fin, splits,
                                       tiles_per_split, st);
    if (bm == 64)
      return launch_fused<64, TB, kS>(fx, g, gs, hx, hy, out_v, out_i, m, n, d, K, n_real,
                                      exclude_self, threshold_skip, alpha, fin, splits,
                                      tiles_per_split, st);
    return cudaErrorInvalidValue;
  });
}
