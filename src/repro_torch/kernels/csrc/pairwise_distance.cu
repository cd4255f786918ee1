// Phase 1 of the paper: the full distance matrix in matmul form,
//   out[m, n] = finalize(alpha * fx . gy^T + hx + hy).
//
// Replaces pairwise_distance.py::pairwise_distance_pallas / _matmul_kernel
// of the JAX package (the MXU tile product with its epilogue).
//
// Bound on the H100: operations.  The product is the 3xTF32 wgmma product of
// gemm_tc.cuh: 3 * 2*m*n*d TF32 operations at 495 TFLOP/s, against 4*m*n
// bytes written (at 8192 x 160,000 x 256: 4.1 ms of operations, 5.2 GB or
// 1.56 ms of output).  Each CTA takes 128 x 128 output tiles (one consumer
// warpgroup per 64 rows, two loader warpgroups) through two operand stages
// and one raw stage, with a 64 KB tile of its own for the epilogue (225 KB,
// one CTA per SM).  The grid is persistent, one CTA per SM walking tiles
// blockIdx.x, + gridDim.x, ..., in bands of 64 row tiles a column at a
// time, so that the CTAs resident at once share their operands in L2.  The
// rank-1 epilogue and the finalizer are applied to the accumulators in
// registers, and the tile is written out a band of rows beside each of the
// next tile's products, each output element once, as float4s where the row
// allows.  Ragged edges (m, n, d not multiples of 128, 128, 32) are masked
// here: rows past m or n and the d tail read as zeros, outputs past m or n
// are not written, so a large database is never padded or copied.
#include <algorithm>

#include "gemm_tc.cuh"

namespace repro {

constexpr int kPairBM = 128, kPairBN = 128, kPairRaw = 1;
constexpr int kBandTiles = 64;  // row tiles of a band: 8192 query rows
using PairGemm = Tf32x3Gemm<kPairBM, kPairBN, 2, float>;
constexpr size_t kPairTileBytes = kPairBM * kPairBN * sizeof(float);
constexpr size_t kPairSmem = ring_bytes<PairGemm, kPairRaw>() + kPairTileBytes;

__global__ void __launch_bounds__(tc::kThreads, 1)
    pairwise_distance_kernel(const float* __restrict__ fx, const float* __restrict__ gy,
                             const float* __restrict__ hx, const float* __restrict__ hy,
                             float* __restrict__ out, int m, int n, int d, float alpha,
                             int fin, int row_tiles, int col_tiles, int n_tiles) {
  extern __shared__ float4 smem4[];
  unsigned char* ring = ring_base(smem4);
  const int kslices = (d + tc::kBK - 1) / tc::kBK;
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  // Tile order: bands of kBandTiles row tiles, each walked a column of
  // tiles at a time, so the CTAs resident at once share a few database
  // tiles and one band of query rows, both held in L2 (a row-major order
  // would stream the whole database from device memory once per row tile).
  auto origin = [&](int t, int& row0, int& col0) {
    const int tile = blockIdx.x + t * gridDim.x;
    const int band = tile / (kBandTiles * col_tiles), in_band = tile % (kBandTiles * col_tiles);
    const int rows = min(kBandTiles, row_tiles - band * kBandTiles);
    row0 = (band * kBandTiles + in_band % rows) * kPairBM;
    col0 = (in_band / rows) * kPairBN;
  };
  auto load = [&](int s, unsigned char* raw, bool in_place, int lt) {
    int row0, col0;
    origin(s / kslices, row0, col0);
    PairGemm::load(raw, in_place, lt, fx, m, gy, n, d, row0, col0, (s % kslices) * tc::kBK);
  };
  // Epilogue, in two halves.  Right after a tile's last product each
  // consumer applies alpha, hx, hy (their lines brought into L1 beside that
  // product) and the finalizer to its sums and writes them to a [128, 128]
  // fp32 tile of their own (tile_index).  Then, a band of 128 / kslices rows
  // beside each of the next tile's products, the consumers copy the tile out
  // a row at a time (a warp takes a row's 32 chunks) as float4s: the stores
  // drain while the products run.
  float* tile = reinterpret_cast<float*>(ring + ring_bytes<PairGemm, kPairRaw>() - 1024);
  auto pre = [&](int t) {
    int row0, col0;
    origin(t, row0, col0);
    const int i = threadIdx.x;
    if (i < kPairBN / 32 && col0 + 32 * i < n) tc::prefetch_l1(hy + col0 + 32 * i);
    if (i < kPairBM / 32 && row0 + 32 * i < m) tc::prefetch_l1(hx + row0 + 32 * i);
  };
  auto epi = [&](int t, float(&a)[PairGemm::kAcc], unsigned char*) {
    int row0, col0;
    origin(t, row0, col0);
    float h[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + PairGemm::row_of(2 * i);
      h[i] = r < m ? hx[r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < PairGemm::kAcc / 4; ++j) {
      const int c = PairGemm::col_of(4 * j), gc = col0 + c;
      const float hy0 = gc < n ? hy[gc] : 0.f, hy1 = gc + 1 < n ? hy[gc + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = 4 * j + 2 * i;
        *reinterpret_cast<float2*>(tile + tile_index(PairGemm::row_of(k), c)) =
            make_float2(finalize(alpha * a[k] + h[i] + hy0, fin),
                        finalize(alpha * a[k + 1] + h[i] + hy1, fin));
      }
    }
  };
  const bool vec4 = (n % 4) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int band = (kPairBM + kslices - 1) / kslices;
  auto store = [&](int t, int kq, unsigned char*) {
    int row0, col0;
    origin(t, row0, col0);
    const int r_end = min(kPairBM, (kq + 1) * band);
    for (int q = kq * band * (kPairBN / 4) + threadIdx.x; q < r_end * (kPairBN / 4);
         q += tc::kConsumers) {
      const int r = q / (kPairBN / 4), p = q % (kPairBN / 4);
      const int gr = row0 + r, gc = col0 + 4 * (p ^ (r & 7));
      if (gr >= m || gc >= n) continue;
      const float4 v = *reinterpret_cast<const float4*>(tile + r * kPairBN + 4 * p);
      float* o = out + static_cast<size_t>(gr) * n + gc;
      if (vec4) {  // gc + 3 < n: n and gc are multiples of 4
        *reinterpret_cast<float4*>(o) = v;
      } else {
        const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gc + e < n) o[e] = e4[e];
      }
    }
  };
  if (tc::is_loader()) {
    tc::loader_regs();
    tc_load<PairGemm, kPairRaw>(ring, mine, kslices, load);
    return;
  }
  tc::consumer_regs();
  tc_multiply<PairGemm, kPairRaw>(ring, mine, kslices, pre, epi, store);
}

}  // namespace repro

extern "C" int pairwise_distance_f32(const float* fx, const float* gy, const float* hx,
                                     const float* hy, float* out, int m, int n, int d,
                                     float alpha, int fin, void* stream) {
  using namespace repro;
  if (m <= 0 || n <= 0 || d <= 0 || d % 4 != 0) return cudaErrorInvalidValue;
  const long long col_tiles = (n + kPairBN - 1) / kPairBN;
  const long long row_tiles = (m + kPairBM - 1) / kPairBM;
  const long long n_tiles = col_tiles * row_tiles;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pairwise_distance_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kPairSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pairwise_distance_kernel,
                                                           tc::kThreads, kPairSmem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(std::min<long long>(n_tiles, 1LL * sms * per_sm));
  pairwise_distance_kernel<<<grid, tc::kThreads, kPairSmem, static_cast<cudaStream_t>(stream)>>>(
      fx, gy, hx, hy, out, m, n, d, alpha, fin, static_cast<int>(row_tiles),
      static_cast<int>(col_tiles),
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}
