// Fused kNN: distance tile and top-K selection in one pass, the [m, n]
// distance matrix never written to device memory.
//
// Replaces fused_knn.py::fused_knn_pallas / _kernel of the JAX package for
// an fp32 gy without a per-query mask: the tile
//   finalize(alpha * fx . gy^T + hx + hy),
// columns >= n_real and (exclude_self) row == column set to +inf, then the
// threshold-skipped merge into each row's running top-K.
//
// Bound on the H100: operations (2*m*n*d fp32 FMAs; the only bytes are the
// operands and [m, K] results).  One CTA owns BM query rows and walks a range
// of 128-column database tiles: the TPU's sequential grid axis over database
// tiles becomes this loop.  Per tile: SimtGemm forms the product in
// registers, the epilogue writes the finished tile to shared memory, and each
// warp folds its rows into their K-buffers (select.cuh), which stay in shared
// memory for the whole walk.
//
// Occupancy: with few query tiles (a serving batch of 1024 queries is 8
// tiles of 128 against 132 SMs) the database axis is split across CTAs
// (grid.y = splits, each a contiguous range of tiles); every split writes a
// partial [m, K] set, which merge_partials.cu then merges, lower splits
// winning ties through the (value, column) order.
//
// Shared memory per CTA: the GEMM slices, the [BM, 128] tile and the
// [BM, K] value and index buffers.  BM = 128 for K <= 128 (210 KB at
// K = 128); K = 256 needs BM = 64.  The caller picks BM and the split, from
// what fused_knn_occupancy reports of this compiled kernel.
#include "gemm.cuh"
#include "select.cuh"

namespace repro {

constexpr int kBN = 128, kBK = 16, kTN = 8, kThreads = 256;
constexpr int kTileLd = kBN + 4;  // row stride of the tile: float4-aligned

template <int BM>
using FusedGemm = SimtGemm<BM, kBN, kBK, BM / 16, kTN>;

template <int BM>
constexpr size_t fused_smem_bytes(int K) {
  return sizeof(float) * (FusedGemm<BM>::kSmemFloats + static_cast<size_t>(BM) * kTileLd) +
         static_cast<size_t>(BM) * K * (sizeof(float) + sizeof(int));
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
    fused_knn_kernel(const float* __restrict__ fx, const float* __restrict__ gy,
                     const float* __restrict__ hx, const float* __restrict__ hy,
                     float* __restrict__ out_v, int* __restrict__ out_i, int m, int n,
                     int d, int K, int n_real, int exclude_self, int skip, float alpha,
                     int fin, int tiles_per_split) {
  using G = FusedGemm<BM>;
  static_assert(G::kThreads == kThreads, "one thread layout");
  constexpr int TM = BM / 16;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ts = smem + G::kSmemFloats;  // [BM][kTileLd]
  float* RV = Ts + BM * kTileLd;      // [BM][K]
  int* RI = reinterpret_cast<int*>(RV + BM * K);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  for (int i = tid; i < BM * K; i += kThreads) {
    RV[i] = CUDART_INF_F;
    RI[i] = -1;
  }
  float hxr[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + G::row_of(ty, i);
    hxr[i] = r < m ? hx[r] : 0.f;
  }
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * kBN;
    float acc[TM][kTN];
    G::run(fx, m, gy, n, d, row0, col0, smem, acc);

    // Epilogue: the finished tile into shared memory.
#pragma unroll
    for (int g = 0; g < kTN / 4; ++g) {
      const int c = G::col_of(tx, g * 4);
      float hyv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) hyv[e] = (col0 + c + e < n) ? hy[col0 + c + e] : CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = finalize(alpha * acc[i][g * 4 + e] + hxr[i] + hyv[e], fin);
        *reinterpret_cast<float4*>(Ts + G::row_of(ty, i) * kTileLd + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();

    // Selection: warp w folds rows w, w + 8, ... of the tile.
    for (int r = warp; r < BM; r += kWarps) {
      const int grow = row0 + r;
      if (grow >= m) break;
      float* rv = RV + r * K;
      int* ri = RI + r * K;
      float kv = rv[K - 1];
      int ki = ri[K - 1];
#pragma unroll
      for (int b = 0; b < kBN; b += 32) {
        const int c = col0 + b + lane;
        const bool valid = c < n_real && !(exclude_self && c == grow);
        warp_offer(rv, ri, K, Ts[r * kTileLd + b + lane], c, valid, skip != 0, kv, ki,
                   lane);
      }
    }
    __syncthreads();
  }

  for (int r = warp; r < BM; r += kWarps) {
    const int grow = row0 + r;
    if (grow >= m) break;
    const size_t base = (static_cast<size_t>(split) * m + grow) * K;
    for (int j = lane; j < K; j += 32) {
      out_v[base + j] = RV[r * K + j];
      out_i[base + j] = RI[r * K + j];
    }
  }
}

// Allow the kernel its dynamic shared memory; returns the bytes, or 0 if
// they exceed the SM's.
template <int BM>
size_t prepare_fused(int K) {
  const size_t smem = fused_smem_bytes<BM>(K);
  if (smem > 232448) return 0;
  if (cudaFuncSetAttribute(fused_knn_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  return smem;
}

template <int BM>
int launch_fused(const float* fx, const float* gy, const float* hx, const float* hy,
                 float* vals, int* idx, int m, int n, int d, int K, int n_real,
                 int exclude_self, int skip, float alpha, int fin, int splits,
                 int tiles_per_split, cudaStream_t stream) {
  const size_t smem = prepare_fused<BM>(K);
  if (smem == 0) return cudaErrorInvalidValue;
  const dim3 grid((m + BM - 1) / BM, splits);
  fused_knn_kernel<BM><<<grid, kThreads, smem, stream>>>(
      fx, gy, hx, hy, vals, idx, m, n, d, K, n_real, exclude_self, skip, alpha, fin,
      tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int occupancy(int K, int* out) {
  const size_t smem = prepare_fused<BM>(K);
  if (smem == 0) return cudaErrorInvalidValue;
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, fused_knn_kernel<BM>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ctas;
  out[1] = kBN;
  out[2] = static_cast<int>(smem);
  return 0;
}

}  // namespace repro

// The launch parameters of this compiled kernel at BM query rows and width
// K: out[0] = CTAs resident per SM (registers and shared memory both
// counted), out[1] = database columns per tile, out[2] = dynamic shared
// memory per CTA in bytes.
extern "C" int fused_knn_occupancy(int bm, int K, int* out) {
  if (K <= 0 || K > repro::kMaxK || (K & (K - 1)) != 0) return cudaErrorInvalidValue;
  if (bm == 128 && K <= 128) return repro::occupancy<128>(K, out);
  if (bm == 64) return repro::occupancy<64>(K, out);
  return cudaErrorInvalidValue;
}

// out_v/out_i: [splits, m, K]; split s holds the partial set of database
// tiles [s * tiles_per_split, (s + 1) * tiles_per_split).
extern "C" int fused_knn_f32(const float* fx, const float* gy, const float* hx,
                             const float* hy, float* out_v, int* out_i, int m, int n, int d,
                             int K, int n_real, int exclude_self, int threshold_skip,
                             float alpha, int fin, int bm, int splits, int tiles_per_split,
                             void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (n + repro::kBN - 1) / repro::kBN;
  if (m <= 0 || n <= 0 || d <= 0 || d % 4 != 0 || K <= 0 || K > repro::kMaxK ||
      (K & (K - 1)) != 0 || n_real < 0 || n_real > n || splits < 1 ||
      tiles_per_split < 1 || (splits - 1) * tiles_per_split >= n_tiles ||
      splits * tiles_per_split < n_tiles || splits > 65535)
    return cudaErrorInvalidValue;
  if (bm == 128 && K <= 128)
    return repro::launch_fused<128>(fx, gy, hx, hy, out_v, out_i, m, n, d, K, n_real,
                                    exclude_self, threshold_skip, alpha, fin, splits,
                                    tiles_per_split, stream);
  if (bm == 64)
    return repro::launch_fused<64>(fx, gy, hx, hy, out_v, out_i, m, n, d, K, n_real,
                                   exclude_self, threshold_skip, alpha, fin, splits,
                                   tiles_per_split, stream);
  return cudaErrorInvalidValue;
}
