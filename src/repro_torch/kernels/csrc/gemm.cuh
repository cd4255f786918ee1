// The fp32 tile product both distance kernels start from:
//   acc[BM x BN] = A[row0 : row0+BM, :] . B[col0 : col0+BN, :]^T
// with A [rows_a, d] and B [rows_b, d] row-major (d contiguous), d % 4 == 0.
//
// Plain FMA on the CUDA cores, in full fp32: the distances must not shift
// the way TF32 would move them (about 1e-3 relative, enough to change ids).
// Classic register-blocked SIMT GEMM: each of the 256 threads holds a
// TM x TN block of the tile in registers; the d axis streams through shared
// memory in BK-wide slices, stored transposed so that a thread reads its
// TM (TN) operands as float4s; the next slice is loaded into registers while
// the current one is multiplied.  A thread's rows (columns) come in groups
// of four, spread BM / (TM/4) apart, which keeps the float4 reads of a
// quarter-warp on distinct banks.  Rows past rows_a / rows_b and the d tail
// past d read as zeros.
#pragma once

#include "common.cuh"

namespace repro {

template <int BM, int BN, int BK, int TM, int TN>
struct SimtGemm {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kSmemFloats = BK * (BM + BN);
  static constexpr int kGM = TM / 4, kGN = TN / 4;
  static constexpr int kLoadsA = BM * BK / 4 / kThreads;
  static constexpr int kLoadsB = BN * BK / 4 / kThreads;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "thread blocks come in float4s");
  static_assert(kLoadsA * kThreads * 4 == BM * BK, "A slice splits evenly");
  static_assert(kLoadsB * kThreads * 4 == BN * BK, "B slice splits evenly");

  // Row (column) of the tile that a thread's i-th accumulator row holds.
  static __device__ __forceinline__ int row_of(int ty, int i) {
    return (i / 4) * (BM / kGM) + ty * 4 + (i % 4);
  }
  static __device__ __forceinline__ int col_of(int tx, int j) {
    return (j / 4) * (BN / kGN) + tx * 4 + (j % 4);
  }

  template <int N>
  static __device__ __forceinline__ void load(const float* __restrict__ X,
                                              int rows, int d, int r0, int k0,
                                              float4 (&reg)[N], int tid) {
#pragma unroll
    for (int l = 0; l < N; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / (BK / 4), kq = idx % (BK / 4);
      const int gr = r0 + r, gk = k0 + kq * 4;
      reg[l] = (gr < rows && gk < d)
                   ? *reinterpret_cast<const float4*>(X + static_cast<size_t>(gr) * d + gk)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  template <int N>
  static __device__ __forceinline__ void store(float* S, int ld, const float4 (&reg)[N],
                                               int tid) {
#pragma unroll
    for (int l = 0; l < N; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / (BK / 4), kq = idx % (BK / 4);
      S[(kq * 4 + 0) * ld + r] = reg[l].x;
      S[(kq * 4 + 1) * ld + r] = reg[l].y;
      S[(kq * 4 + 2) * ld + r] = reg[l].z;
      S[(kq * 4 + 3) * ld + r] = reg[l].w;
    }
  }

  // Ends with a __syncthreads(): the caller may reuse smem right after.
  static __device__ __forceinline__ void run(const float* __restrict__ A, int rows_a,
                                             const float* __restrict__ B, int rows_b,
                                             int d, int row0, int col0, float* smem,
                                             float (&acc)[TM][TN]) {
    float* As = smem;            // [BK][BM]
    float* Bs = smem + BK * BM;  // [BK][BN]
    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN), ty = tid / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    float4 ra[kLoadsA], rb[kLoadsB];
    load(A, rows_a, d, row0, 0, ra, tid);
    load(B, rows_b, d, col0, 0, rb, tid);
    store(As, BM, ra, tid);
    store(Bs, BN, rb, tid);
    __syncthreads();
    for (int k0 = 0; k0 < d; k0 += BK) {
      const bool more = k0 + BK < d;
      if (more) {
        load(A, rows_a, d, row0, k0 + BK, ra, tid);
        load(B, rows_b, d, col0, k0 + BK, rb, tid);
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int g = 0; g < kGM; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(As + k * BM + g * (BM / kGM) + ty * 4);
          a[g * 4 + 0] = t.x; a[g * 4 + 1] = t.y; a[g * 4 + 2] = t.z; a[g * 4 + 3] = t.w;
        }
#pragma unroll
        for (int g = 0; g < kGN; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(Bs + k * BN + g * (BN / kGN) + tx * 4);
          b[g * 4 + 0] = t.x; b[g * 4 + 1] = t.y; b[g * 4 + 2] = t.z; b[g * 4 + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
      if (more) {
        store(As, BM, ra, tid);
        store(Bs, BN, rb, tid);
        __syncthreads();
      }
    }
  }
};

}  // namespace repro
