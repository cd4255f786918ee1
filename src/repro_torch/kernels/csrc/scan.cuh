// The scan both fused kNN kernels share: a CTA owns BM query rows, keeps each
// row's K-buffer in shared memory, and folds database tiles of 128 columns
// into it one at a time.  fused_knn.cu walks a contiguous range of tiles of
// the whole database; ivf_scan.cu walks the cell blocks its probe list names.
//
// Per tile: SimtGemm forms alpha * fx . gy^T in registers (gy fp32, bf16 or
// int8, widened to fp32 as it is loaded), the epilogue
//   t = alpha * acc;  t *= gs[col] (with a scale);  finalize(t + hx + hy)
// -- the reference's order, fused_knn.py _select -- writes the finished tile
// to shared memory, and each warp offers its rows' 128 candidates to their
// K-buffers (select.cuh).  Columns at or past col_hi, and with exclude_self
// the row's own column, never enter; dead rows arrive as hy = +inf.
//
// Shared memory per CTA: the GEMM slices, the [BM, 128] tile and the
// [BM, K] value and index buffers: 210 KB at BM = 128, K = 128.
#pragma once

#include <type_traits>

#include "gemm.cuh"
#include "select.cuh"

namespace repro {

constexpr int kBN = 128, kBK = 16, kTN = 8, kThreads = 256;
constexpr int kTileLd = kBN + 4;  // row stride of the tile: float4-aligned
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;

template <int BM>
using ScanGemm = SimtGemm<BM, kBN, kBK, BM / 16, kTN>;

template <int BM>
constexpr size_t scan_smem_bytes(int K) {
  return sizeof(float) * (ScanGemm<BM>::kSmemFloats + static_cast<size_t>(BM) * kTileLd) +
         static_cast<size_t>(BM) * K * (sizeof(float) + sizeof(int));
}

// The CTA's shared memory, carved: GEMM slices, the tile, the K-buffers.
template <int BM>
struct ScanSmem {
  float* gemm;
  float* tile;  // [BM][kTileLd]
  float* rv;    // [BM][K]
  int* ri;      // [BM][K]
  __device__ ScanSmem(float* smem, int K)
      : gemm(smem),
        tile(smem + ScanGemm<BM>::kSmemFloats),
        rv(tile + BM * kTileLd),
        ri(reinterpret_cast<int*>(rv + BM * K)) {}
};

// Empty K-buffers, and the thread's rows' hx terms.
template <int BM>
__device__ __forceinline__ void scan_init(const ScanSmem<BM>& s, int K, const float* hx,
                                          int row0, int m, float (&hxr)[BM / 16]) {
  const int tid = threadIdx.x;
  const int ty = tid / (kBN / kTN);
  for (int i = tid; i < BM * K; i += kThreads) {
    s.rv[i] = CUDART_INF_F;
    s.ri[i] = -1;
  }
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int r = row0 + ScanGemm<BM>::row_of(ty, i);
    hxr[i] = r < m ? hx[r] : 0.f;
  }
  __syncthreads();
}

// Fold database columns [col0, col0 + 128) into the CTA's K-buffers.
// gy has n rows; hy, and gs when kScaled, have n entries.  Without a scale
// the epilogue holds no trace of it: the fp32 scan compiles as if the
// scale did not exist.
template <int BM, typename TB, bool kScaled>
__device__ __forceinline__ void scan_tile(const ScanSmem<BM>& s, int K, const float* fx,
                                          int m, int d, const TB* gy, const float* gs,
                                          const float* hy, int n, int row0, int col0,
                                          int col_hi, int exclude_self, bool skip,
                                          float alpha, int fin,
                                          const float (&hxr)[BM / 16]) {
  using G = ScanGemm<BM>;
  static_assert(G::kThreads == kThreads, "one thread layout");
  constexpr int TM = BM / 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  float acc[TM][kTN];
  G::run(fx, m, gy, n, d, row0, col0, s.gemm, acc);

  // Epilogue: the finished tile into shared memory.
#pragma unroll
  for (int g = 0; g < kTN / 4; ++g) {
    const int c = G::col_of(tx, g * 4);
    float hyv[4], gsv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + c + e;
      hyv[e] = col < n ? hy[col] : CUDART_INF_F;
      if constexpr (kScaled) gsv[e] = col < n ? gs[col] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = alpha * acc[i][g * 4 + e];
        if constexpr (kScaled) t *= gsv[e];
        v[e] = finalize(t + hxr[i] + hyv[e], fin);
      }
      *reinterpret_cast<float4*>(s.tile + G::row_of(ty, i) * kTileLd + c) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();

  // Selection: warp w folds rows w, w + 8, ... of the tile.
  for (int r = warp; r < BM; r += kWarps) {
    const int grow = row0 + r;
    if (grow >= m) break;
    float* rv = s.rv + r * K;
    int* ri = s.ri + r * K;
    float kv = rv[K - 1];
    int ki = ri[K - 1];
#pragma unroll
    for (int b = 0; b < kBN; b += 32) {
      const int c = col0 + b + lane;
      const bool valid = c < col_hi && !(exclude_self && c == grow);
      warp_offer(rv, ri, K, s.tile[r * kTileLd + b + lane], c, valid, skip, kv, ki, lane);
    }
  }
  __syncthreads();
}

// Write the CTA's rows' K-buffers as split `split` of out [splits, m, K].
template <int BM>
__device__ __forceinline__ void scan_store(const ScanSmem<BM>& s, int K, int row0, int m,
                                           int split, float* out_v, int* out_i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kWarps) {
    const int grow = row0 + r;
    if (grow >= m) break;
    const size_t base = (static_cast<size_t>(split) * m + grow) * K;
    for (int j = lane; j < K; j += 32) {
      out_v[base + j] = s.rv[r * K + j];
      out_i[base + j] = s.ri[r * K + j];
    }
  }
}

// Allow `kernel` its dynamic shared memory at BM, K; the bytes, or 0 if
// they exceed the SM's.
template <int BM, typename Kernel>
size_t scan_prepare(Kernel kernel, int K) {
  const size_t smem = scan_smem_bytes<BM>(K);
  if (smem > kMaxSmem) return 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  return smem;
}

// out[0] = CTAs of `kernel` resident per SM at BM, K (registers and shared
// memory both counted), out[1] = columns per tile, out[2] = dynamic shared
// memory per CTA in bytes.
template <int BM, typename Kernel>
int scan_occupancy(Kernel kernel, int K, int* out) {
  const size_t smem = scan_prepare<BM>(kernel, K);
  if (smem == 0) return cudaErrorInvalidValue;
  int ctas = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ctas;
  out[1] = kBN;
  out[2] = static_cast<int>(smem);
  return 0;
}

// Storage types of gy, by the code the Python side passes.
enum GyDtype : int { kF32 = 0, kBf16 = 1, kI8 = 2 };

template <typename T>
struct Type {
  using type = T;
};

// f(Type<TB>{}, std::bool_constant<scaled>{}) for the storage type of gy
// that `gy_dtype` names and for the presence of the scale operand: each
// scan kernel is compiled once per pair, and picked here at run time.
template <typename F>
int dispatch_gy(int gy_dtype, bool scaled, F&& f) {
  switch (gy_dtype) {
    case kF32:
      return scaled ? f(Type<float>{}, std::true_type{}) : f(Type<float>{}, std::false_type{});
    case kBf16:
      return scaled ? f(Type<Bf16>{}, std::true_type{}) : f(Type<Bf16>{}, std::false_type{});
    case kI8:
      return scaled ? f(Type<int8_t>{}, std::true_type{}) : f(Type<int8_t>{}, std::false_type{});
    default:
      return cudaErrorInvalidValue;
  }
}

inline bool valid_k(int K, int cap = kMaxK) { return K > 0 && K <= cap && (K & (K - 1)) == 0; }

}  // namespace repro
