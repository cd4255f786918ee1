// Phase 1 of the paper: the full distance matrix in matmul form,
//   out[m, n] = finalize(alpha * fx . gy^T + hx + hy).
//
// Replaces pairwise_distance.py::pairwise_distance_pallas / _matmul_kernel
// of the JAX package (the MXU tile product with its epilogue).
//
// Bound on the H100: operations.  2*m*n*d fp32 FMAs on the CUDA cores (TF32
// is ruled out, see gemm.cuh) against 4*m*n bytes written: at d = 256 that
// is 128 FLOP per byte, above the card's fp32 ridge (about 20).  The design
// keeps the product in registers (SimtGemm, 128 x 128 tiles, 8 x 8 per
// thread), applies the rank-1 epilogue and the finalizer there, and writes
// each output element once, as float4s where the row allows.  Ragged edges
// (m, n not multiples of 128) are masked here rather than padded by the
// caller, so a large database is never copied.
#include "gemm.cuh"

namespace repro {

constexpr int kBM = 128, kBN = 128, kBK = 16, kTM = 8, kTN = 8;
using PairGemm = SimtGemm<kBM, kBN, kBK, kTM, kTN>;

__global__ void __launch_bounds__(PairGemm::kThreads)
    pairwise_distance_kernel(const float* __restrict__ fx, const float* __restrict__ gy,
                             const float* __restrict__ hx, const float* __restrict__ hy,
                             float* __restrict__ out, int m, int n, int d, float alpha,
                             int fin) {
  __shared__ __align__(16) float smem[PairGemm::kSmemFloats];
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
  PairGemm::run(fx, m, gy, n, d, row0, col0, smem, acc);

  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  const bool vec = (n % 4) == 0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + PairGemm::row_of(ty, i);
    if (r >= m) continue;
    const float h = hx[r];
    float* orow = out + static_cast<size_t>(r) * n;
#pragma unroll
    for (int g = 0; g < kTN / 4; ++g) {
      const int c = col0 + PairGemm::col_of(tx, g * 4);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hyv = (c + e < n) ? hy[c + e] : 0.f;
        v[e] = finalize(alpha * acc[i][g * 4 + e] + h + hyv, fin);
      }
      if (vec && c + 3 < n) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < n) orow[c + e] = v[e];
      }
    }
  }
}

}  // namespace repro

extern "C" int pairwise_distance_f32(const float* fx, const float* gy, const float* hx,
                                     const float* hy, float* out, int m, int n, int d,
                                     float alpha, int fin, void* stream) {
  if (m <= 0 || n <= 0 || d <= 0 || d % 4 != 0) return cudaErrorInvalidValue;
  const dim3 grid((n + repro::kBN - 1) / repro::kBN, (m + repro::kBM - 1) / repro::kBM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  repro::pairwise_distance_kernel<<<grid, repro::PairGemm::kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      fx, gy, hx, hy, out, m, n, d, alpha, fin);
  return static_cast<int>(cudaGetLastError());
}
