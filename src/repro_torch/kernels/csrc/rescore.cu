// Exact rescore: each query row against its own gathered candidate rows, then
// the top-K candidate POSITIONS.
//
// Replaces rescore.py::rescore_topk_pallas / _kernel of the JAX package:
//   acc[i, c] = sum_d fx[i, d] * cand[i, c, d]          (a batched row dot)
//   tile = finalize(alpha * acc + hx[i] + hy_cand[i, c])
// and the K smallest of each row by (value, position).  A slot whose
// hy_cand is +inf (an empty candidate) never enters; its output slot reads
// (+inf, -1).  The gather cand = gy(db[cand_idx]) stays outside, as the
// reference leaves it to XLA; the wrapper maps positions back to rows.
//
// Bound on the H100: bytes.  The gathered [m, Kp, d] block is read once
// (64 MiB at m = 1024, Kp = 64, d = 256) for 2 FLOP a float.  There is no
// [bm, bn] tile for a matrix unit here, so the design is the streaming one:
// one warp per query row keeps the row's fx in shared memory, lanes split d
// so that each candidate row is read as coalesced float4s, eight candidates
// are in flight at a time, and a butterfly of shuffles reduces each dot.
// Lane j keeps candidate j of each batch of 32, which is then offered to the
// row's K-buffer with the threshold skip (select.cuh).  K above 256 (up to
// kMaxSelectK) runs a wide instantiation of its own, whose K-buffer is the
// row of its output, in device memory: the 8 warps' [K] buffers would take
// 256 KB of shared memory at K = 4096.
#include "select.cuh"

namespace repro {

constexpr int kRescoreWarps = 8;
constexpr int kRescoreUnroll = 8;
constexpr size_t kRescoreMaxSmem = 232448;

// The warps' fx rows, and their K-buffers unless they are the output's rows.
__host__ __device__ constexpr size_t rescore_smem_bytes(int d, int K, bool in_out) {
  return static_cast<size_t>(kRescoreWarps) * (static_cast<size_t>(d) + (in_out ? 0 : 2 * K)) *
         4;
}

template <int kCap>
__global__ void __launch_bounds__(kRescoreWarps * 32)
    rescore_kernel(const float* __restrict__ fx, const float* __restrict__ cand,
                   const float* __restrict__ hx, const float* __restrict__ hy_cand,
                   float* __restrict__ out_v, int* __restrict__ out_p, int m, int Kp, int d,
                   int K, float alpha, int fin) {
  constexpr bool kInOut = kCap > kMaxK;  // the K-buffer is the output's row
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRescoreWarps + warp;
  if (row >= m) return;  // a whole warp; the kernel has no block-wide barrier
  float* base = reinterpret_cast<float*>(smem4);
  float4* xs = reinterpret_cast<float4*>(base + static_cast<size_t>(warp) * d);
  float* rv = kInOut ? out_v + static_cast<size_t>(row) * K
                     : base + static_cast<size_t>(kRescoreWarps) * d + warp * K;
  int* ri = kInOut ? out_p + static_cast<size_t>(row) * K
                   : reinterpret_cast<int*>(base + static_cast<size_t>(kRescoreWarps) * (d + K)) +
                         warp * K;
  const int d4 = d / 4;
  const float4* xg = reinterpret_cast<const float4*>(fx + static_cast<size_t>(row) * d);
  for (int q = lane; q < d4; q += 32) xs[q] = xg[q];
  warp_init(rv, ri, K, lane);  // ends with __syncwarp: xs is visible too

  const float h = hx[row];
  const float4* rows = reinterpret_cast<const float4*>(cand + static_cast<size_t>(row) * Kp * d);
  const float* hy = hy_cand + static_cast<size_t>(row) * Kp;
  float kv = CUDART_INF_F;
  int ki = -1;
  for (int c0 = 0; c0 < Kp; c0 += 32) {
    float mine = 0.f;  // lane j: the dot of candidate c0 + j
    for (int j0 = 0; j0 < 32 && c0 + j0 < Kp; j0 += kRescoreUnroll) {
      float part[kRescoreUnroll];
#pragma unroll
      for (int e = 0; e < kRescoreUnroll; ++e) part[e] = 0.f;
      for (int q = lane; q < d4; q += 32) {
        const float4 a = xs[q];
#pragma unroll
        for (int e = 0; e < kRescoreUnroll; ++e) {
          const int c = c0 + j0 + e;
          if (c < Kp) {
            const float4 b = rows[static_cast<size_t>(c) * d4 + q];
            part[e] = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, part[e]))));
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kRescoreUnroll; ++e) {
        float v = part[e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
        if (lane == j0 + e) mine = v;
      }
    }
    const int c = c0 + lane;
    float val = CUDART_INF_F;
    if (c < Kp) val = finalize(alpha * mine + h + hy[c], fin);
    warp_offer<kCap>(rv, ri, K, val, c, c < Kp && val < CUDART_INF_F, true, kv, ki, lane);
  }
  if constexpr (kInOut) return;
  for (int j = lane; j < K; j += 32) {
    out_v[static_cast<size_t>(row) * K + j] = rv[j];
    out_p[static_cast<size_t>(row) * K + j] = ri[j];
  }
}

}  // namespace repro

// fx [m, d]; cand [m, Kp, d]; hx [m]; hy_cand [m, Kp] (+inf = empty slot);
// out_v/out_pos: [m, K], positions into the candidate axis, -1 when empty.
extern "C" int rescore_f32(const float* fx, const float* cand, const float* hx,
                           const float* hy_cand, float* out_v, int* out_pos, int m, int Kp, int d,
                           int K, float alpha, int fin, void* stream) {
  using namespace repro;
  if (m <= 0 || Kp <= 0 || d <= 0 || d % 4 != 0 || K <= 0 || K > kMaxSelectK ||
      (K & (K - 1)) != 0)
    return cudaErrorInvalidValue;
  auto go = [&](auto kernel, bool in_out) -> int {
    const size_t smem = rescore_smem_bytes(d, K, in_out);
    if (smem > kRescoreMaxSmem) return cudaErrorInvalidValue;
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
    const int blocks = (m + kRescoreWarps - 1) / kRescoreWarps;
    kernel<<<blocks, kRescoreWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        fx, cand, hx, hy_cand, out_v, out_pos, m, Kp, d, K, alpha, fin);
    return static_cast<int>(cudaGetLastError());
  };
  return K <= kMaxK ? go(rescore_kernel<kMaxK>, false) : go(rescore_kernel<kMaxSelectK>, true);
}
