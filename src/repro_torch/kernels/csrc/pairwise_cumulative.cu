// Phase 1 of the paper for a general distance: the full matrix by the
// per-coordinate (cumulative) route,
//   out[i, j] = finalize(fold_c accumulate(x[i, c], y[j, c]) from init).
//
// Replaces pairwise_distance.py::pairwise_distance_cumulative_pallas /
// _cumulative_kernel / _coord_accumulate of the JAX package, which fold one
// coordinate at a time into a [bm, bn] accumulator on the TPU's vector unit.
// This is the paper's own phase-1 design (Sect. 5, DESIGN.md §2): chunks of
// kBK coordinates of both operands are staged through shared memory with
// coalesced float4 loads (the next chunk loaded into registers while the
// current one is folded), stored transposed so that a thread reads its rows'
// and columns' values as float4s, and each of the 256 threads folds an
// 8 x 8 register tile of accumulators one coordinate at a time.
//
// The accumulator and the finalizer are template parameters, picked at run
// time from the codes the one C entry point takes:
//   kSqeuclidean  acc += (a - b)^2                        3 operations
//   kNegDot       acc -= a * b                            2 operations
//   kHellinger    acc += (sqrt(max(a,0)) - sqrt(max(b,0)))^2       3
//   kKl           acc += p * (log p - log q), p = max(a,eps), q = max(b,eps)  3
// per (pair, coordinate).  The square roots and logarithms depend on one
// element only, so they are taken once per element as the chunk is staged,
// not once per pair: the per-pair arithmetic is the same, and the values
// agree with the plain version to rounding.  Coordinates past d and rows
// past m / n load as zeros: a zero coordinate adds exactly 0 under each of
// the four accumulators (kKl: eps * (log eps - log eps)), so the caller pads
// nothing but d, to a multiple of 4.
//
// Bound on the H100: operations (2 or 3 fp32 operations per pair and
// coordinate against 4 bytes written per pair: above the card's fp32 ridge
// at any d past a few dozen).
#include "common.cuh"

namespace repro {

enum Accumulate : int { kSqeuclidean = 0, kNegDot = 1, kHellinger = 2, kKl = 3 };
// Finalizers: kIdentity and kSqrt (common.cuh), and sqrt(max(a / 2, 0)) for
// the cumulative Hellinger sum.
constexpr int kHalfSqrt = 2;

constexpr int kCBM = 128, kCBN = 128, kCBK = 16, kCTM = 8, kCTN = 8;
constexpr int kCThreads = (kCBM / kCTM) * (kCBN / kCTN);  // 256
constexpr int kCLoads = kCBM * kCBK / 4 / kCThreads;       // float4 loads per operand
constexpr float kEps = 1e-12f;

template <int ACC>
struct Cumulative {
  // Per-element maps at staging time: x -> (u, v), y -> w.
  static __device__ __forceinline__ float u(float a) {
    if constexpr (ACC == kHellinger) return sqrtf(fmaxf(a, 0.f));
    if constexpr (ACC == kKl) return fmaxf(a, kEps);
    return a;
  }
  static __device__ __forceinline__ float v(float a) { return logf(fmaxf(a, kEps)); }
  static __device__ __forceinline__ float w(float b) {
    if constexpr (ACC == kHellinger) return sqrtf(fmaxf(b, 0.f));
    if constexpr (ACC == kKl) return logf(fmaxf(b, kEps));
    return b;
  }
  static constexpr bool kTwoX = ACC == kKl;  // x carries (p, log p)
  static __device__ __forceinline__ float step(float acc, float ux, float vx, float wy) {
    if constexpr (ACC == kNegDot) return acc - ux * wy;
    if constexpr (ACC == kKl) return acc + ux * (vx - wy);
    const float dlt = ux - wy;
    return acc + dlt * dlt;
  }
};

__device__ __forceinline__ float finalize_cumulative(float a, int fin) {
  return fin == kHalfSqrt ? sqrtf(fmaxf(0.5f * a, 0.f)) : finalize(a, fin);
}

// Rows [r0, r0 + kCBM) x coordinates [k0, k0 + kCBK) of X [rows, d] into
// registers, four coordinates a thread.
__device__ __forceinline__ void load_chunk(const float* __restrict__ X, int rows, int d, int r0,
                                           int k0, float4 (&reg)[kCLoads], int tid) {
#pragma unroll
  for (int l = 0; l < kCLoads; ++l) {
    const int idx = tid + l * kCThreads;
    const int r = idx / (kCBK / 4), kq = idx % (kCBK / 4);
    const int gr = r0 + r, gk = k0 + kq * 4;
    reg[l] = (gr < rows && gk < d)
                 ? *reinterpret_cast<const float4*>(X + static_cast<size_t>(gr) * d + gk)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The registers into S [kCBK][kCBM] (transposed), through the map f.
template <typename F>
__device__ __forceinline__ void store_chunk(float* S, const float4 (&reg)[kCLoads], int tid,
                                            F f) {
#pragma unroll
  for (int l = 0; l < kCLoads; ++l) {
    const int idx = tid + l * kCThreads;
    const int r = idx / (kCBK / 4), kq = idx % (kCBK / 4);
    S[(kq * 4 + 0) * kCBM + r] = f(reg[l].x);
    S[(kq * 4 + 1) * kCBM + r] = f(reg[l].y);
    S[(kq * 4 + 2) * kCBM + r] = f(reg[l].z);
    S[(kq * 4 + 3) * kCBM + r] = f(reg[l].w);
  }
}

template <int ACC, int FIN>
__global__ void __launch_bounds__(kCThreads)
    pairwise_cumulative_kernel(const float* __restrict__ x, const float* __restrict__ y,
                               float* __restrict__ out, int m, int n, int d, float init) {
  using C = Cumulative<ACC>;
  __shared__ __align__(16) float Us[kCBK * kCBM];
  __shared__ __align__(16) float Vs[C::kTwoX ? kCBK * kCBM : 4];
  __shared__ __align__(16) float Ws[kCBK * kCBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kCBN / kCTN), ty = tid / (kCBN / kCTN);
  const int row0 = blockIdx.y * kCBM, col0 = blockIdx.x * kCBN;
  // A thread's rows (columns) come in two groups of four, kCBM / 2 apart,
  // so that the float4 reads of a quarter-warp hit distinct banks.
  auto row_of = [&](int i) { return (i / 4) * (kCBM / 2) + ty * 4 + (i % 4); };
  auto col_of = [&](int j) { return (j / 4) * (kCBN / 2) + tx * 4 + (j % 4); };

  float acc[kCTM][kCTN];
#pragma unroll
  for (int i = 0; i < kCTM; ++i)
#pragma unroll
    for (int j = 0; j < kCTN; ++j) acc[i][j] = init;

  float4 rx[kCLoads], ry[kCLoads];
  auto stage = [&]() {
    store_chunk(Us, rx, tid, [](float a) { return C::u(a); });
    if constexpr (C::kTwoX) store_chunk(Vs, rx, tid, [](float a) { return C::v(a); });
    store_chunk(Ws, ry, tid, [](float b) { return C::w(b); });
  };
  load_chunk(x, m, d, row0, 0, rx, tid);
  load_chunk(y, n, d, col0, 0, ry, tid);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < d; k0 += kCBK) {
    const bool more = k0 + kCBK < d;
    if (more) {
      load_chunk(x, m, d, row0, k0 + kCBK, rx, tid);
      load_chunk(y, n, d, col0, k0 + kCBK, ry, tid);
    }
#pragma unroll
    for (int k = 0; k < kCBK; ++k) {
      float a[kCTM], av[kCTM], b[kCTN];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(Us + k * kCBM + g * (kCBM / 2) + ty * 4);
        a[g * 4 + 0] = t.x; a[g * 4 + 1] = t.y; a[g * 4 + 2] = t.z; a[g * 4 + 3] = t.w;
        const float4 s = *reinterpret_cast<const float4*>(Ws + k * kCBN + g * (kCBN / 2) + tx * 4);
        b[g * 4 + 0] = s.x; b[g * 4 + 1] = s.y; b[g * 4 + 2] = s.z; b[g * 4 + 3] = s.w;
        if constexpr (C::kTwoX) {
          const float4 r = *reinterpret_cast<const float4*>(Vs + k * kCBM + g * (kCBM / 2) + ty * 4);
          av[g * 4 + 0] = r.x; av[g * 4 + 1] = r.y; av[g * 4 + 2] = r.z; av[g * 4 + 3] = r.w;
        } else {
          av[g * 4 + 0] = av[g * 4 + 1] = av[g * 4 + 2] = av[g * 4 + 3] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kCTM; ++i)
#pragma unroll
        for (int j = 0; j < kCTN; ++j) acc[i][j] = C::step(acc[i][j], a[i], av[i], b[j]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

  const bool vec = (n % 4) == 0;
#pragma unroll
  for (int i = 0; i < kCTM; ++i) {
    const int r = row0 + row_of(i);
    if (r >= m) continue;
    float* orow = out + static_cast<size_t>(r) * n;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c = col0 + col_of(g * 4);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = finalize_cumulative(acc[i][g * 4 + e], FIN);
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

template <int ACC, int FIN>
int launch_cumulative(const float* x, const float* y, float* out, int m, int n, int d,
                      float init, cudaStream_t stream) {
  const dim3 grid((n + kCBN - 1) / kCBN, (m + kCBM - 1) / kCBM);
  pairwise_cumulative_kernel<ACC, FIN><<<grid, kCThreads, 0, stream>>>(x, y, out, m, n, d,
                                                                      init);
  return static_cast<int>(cudaGetLastError());
}

template <int ACC>
int dispatch_fin(int fin, const float* x, const float* y, float* out, int m, int n, int d,
                 float init, cudaStream_t st) {
  switch (fin) {
    case kIdentity: return launch_cumulative<ACC, kIdentity>(x, y, out, m, n, d, init, st);
    case kSqrt: return launch_cumulative<ACC, kSqrt>(x, y, out, m, n, d, init, st);
    case kHalfSqrt: return launch_cumulative<ACC, kHalfSqrt>(x, y, out, m, n, d, init, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// x [m, d], y [n, d] fp32 row-major, d % 4 == 0; out [m, n].  acc: the
// Accumulate code; fin: 0 identity, 1 sqrt(max(a, 0)), 2 sqrt(max(a/2, 0)).
extern "C" int pairwise_cumulative(const float* x, const float* y, float* out, int m, int n,
                                   int d, int acc, int fin, float init, void* stream) {
  using namespace repro;
  if (m <= 0 || n <= 0 || d <= 0 || d % 4 != 0 || (m + kCBM - 1) / kCBM > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (acc) {
    case kSqeuclidean: return dispatch_fin<kSqeuclidean>(fin, x, y, out, m, n, d, init, st);
    case kNegDot: return dispatch_fin<kNegDot>(fin, x, y, out, m, n, d, init, st);
    case kHellinger: return dispatch_fin<kHellinger>(fin, x, y, out, m, n, d, init, st);
    case kKl: return dispatch_fin<kKl>(fin, x, y, out, m, n, d, init, st);
    default: return cudaErrorInvalidValue;
  }
}
