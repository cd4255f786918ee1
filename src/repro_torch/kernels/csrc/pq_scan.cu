// IVF-PQ ADC scan: per query tile, the cells of its union probe list scored
// by asymmetric distance computation over their uint8 codes.
//
// Replaces pq_scan.py::pq_scan_pallas / _kernel (and its tile, adc_tile) of
// the JAX package.  Per query q and packed slot s of a probed cell c:
//   score = finalize(sum_j lut[q][j][code[s][j]] (+ qc[q][c]) + hx[q] + hy[s])
// in the reference's order after the sum: ((sum + qc) + hx) + hy.  Dead and
// pad slots arrive as hy = +inf; ids are packed slots.
//
// The TPU kernel expands each code block into a one-hot operand and
// contracts it with the flattened LUTs on the MXU, because a TPU lane cannot
// gather.  A thread here can: a CTA keeps the LUTs of its QB queries in
// shared memory (pq_m * ncodes floats each, 32 KiB at pq_m = 32, nbits = 8,
// so QB is a handful, not the reference's 256), stages each 128-slot tile
// of a cell's codes (128 * pq_m contiguous bytes of the row-major [S, pq_m]
// array) into shared memory with a row stride of an odd number of words,
// so that consecutive slots fall on distinct banks, and each thread sums
// one (query, slot) pair's pq_m table entries.  The finished [QB, 128] tile
// goes to shared memory, and warp q offers row q's candidates to its
// K-buffer (select.cuh) by (value, packed slot).
//
// The probe-list walk is ivf_scan.cu's: a CTA belongs to one union tile of
// tile_m queries (QB divides tile_m, or the batch is one tile), walks the
// contiguous range [split * slots_per_split, ...) of its tile's list, skips
// a slot that repeats its predecessor, and stops each cell at its extent
// (one past its last live slot), so the slots past it cost nothing.  Ranges
// of ascending cells hold ascending slots, so merge_partials.cu merges the
// splits' partial sets with one pass's tie rule.
//
// Bound on the H100: operations, pq_m fp32 adds per (query, live row) pair
// (the table lookups are shared-memory loads, about one per add).  The codes
// and hy of a row are read from device memory once, and from L2 by every
// other CTA of the same union tile.
//
// K above 256 (up to kMaxSelectK, an IVF-PQ fetch widened by a filter's
// exclusions) runs a wide instantiation of its own: the QB K-buffers would
// not fit beside the LUTs (QB x 4096 x 8 bytes is 256 KB at QB 8), so they
// are the rows of the kernel's own output, in device memory.
#include <type_traits>

#include "select.cuh"

namespace repro {

constexpr int kPqThreads = 256, kPqTile = 128, kPqWarps = kPqThreads / 32;

// Words per staged code row: enough for pq_m bytes, and odd.
__host__ __device__ inline int code_words(int pq_m) { return ((pq_m + 3) / 4) | 1; }

// The LUTs, the tile, the staged codes, and the K-buffers unless they are
// the output's rows (kCap > kMaxK).
template <int QB, int kCap>
size_t pq_smem_bytes(int lut_floats, int pq_m, int K) {
  return sizeof(float) * (static_cast<size_t>(QB) * lut_floats + QB * kPqTile) +
         sizeof(unsigned) * static_cast<size_t>(kPqTile) * code_words(pq_m) +
         (kCap > kMaxK ? 0 : static_cast<size_t>(QB) * K * (sizeof(float) + sizeof(int)));
}

template <int QB, int kCap>
__global__ void __launch_bounds__(kPqThreads)
    pq_scan_kernel(const int* __restrict__ probes, const int* __restrict__ extent,
                   const float* __restrict__ luts, const uint8_t* __restrict__ codes,
                   const float* __restrict__ qc, const float* __restrict__ hx,
                   const float* __restrict__ hy, float* __restrict__ out_v,
                   int* __restrict__ out_i, int m, int pq_m, int ncodes, int S, int W, int K,
                   int cell_cap, int tile_m, int skip, int fin, int slots_per_split) {
  constexpr bool kInOut = kCap > kMaxK;  // the K-buffers are the output's rows
  extern __shared__ float4 smem4[];
  __shared__ float hxs[QB];
  const int L = pq_m * ncodes;
  const int cw = code_words(pq_m);
  float* lut = reinterpret_cast<float*>(smem4);  // [QB][L]
  float* tile = lut + QB * L;                    // [QB][kPqTile]
  unsigned* cs = reinterpret_cast<unsigned*>(tile + QB * kPqTile);  // [kPqTile][cw]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  // Row q's K-buffer at rv + q * K: in shared memory, or row row0 + q of
  // split `split` of the output.
  float* rv = kInOut ? out_v + (static_cast<size_t>(split) * m + row0) * K
                     : reinterpret_cast<float*>(cs + kPqTile * cw);  // [QB][K]
  int* ri = kInOut ? out_i + (static_cast<size_t>(split) * m + row0) * K
                   : reinterpret_cast<int*>(rv + QB * K);  // [QB][K]
  const int buf_rows = kInOut ? min(QB, m - row0) : QB;
  const int ncells = S / cell_cap;
  const int* plist = probes + static_cast<size_t>(row0 / tile_m) * W;

  // The block's LUTs (rows past m read zeros and are never stored), empty
  // K-buffers, and the rows' hx terms.
  for (int i = tid; i < QB * L; i += kPqThreads) {
    const int q = i / L, r = row0 + q;
    lut[i] = r < m ? luts[static_cast<size_t>(r) * L + (i - q * L)] : 0.f;
  }
  for (int i = tid; i < buf_rows * K; i += kPqThreads) {
    rv[i] = CUDART_INF_F;
    ri[i] = -1;
  }
  if (tid < QB) hxs[tid] = row0 + tid < m ? hx[row0 + tid] : 0.f;
  __syncthreads();

  const bool words = (pq_m % 4) == 0;
  const int j_begin = split * slots_per_split;
  const int j_end = min(W, j_begin + slots_per_split);
  for (int j = j_begin; j < j_end; ++j) {
    const int cell = plist[j];
    if (j > 0 && cell == plist[j - 1]) continue;  // duplicate padding
    const int base = cell * cell_cap;
    if (cell < 0 || base >= S) continue;
    const int hi = base + max(0, min(extent[cell], cell_cap));
    for (int col0 = base; col0 < hi; col0 += kPqTile) {
      const int ncol = min(kPqTile, hi - col0);
      // Stage the tile's codes: word loads where a row is whole words.
      if (words) {
        const int wpr = pq_m / 4;
        const unsigned* src =
            reinterpret_cast<const unsigned*>(codes + static_cast<size_t>(col0) * pq_m);
        for (int i = tid; i < ncol * wpr; i += kPqThreads) {
          const int s = i / wpr;
          cs[s * cw + (i - s * wpr)] = src[i];
        }
      } else {
        uint8_t* cb = reinterpret_cast<uint8_t*>(cs);
        const uint8_t* src = codes + static_cast<size_t>(col0) * pq_m;
        for (int i = tid; i < ncol * pq_m; i += kPqThreads) {
          const int s = i / pq_m;
          cb[s * cw * 4 + (i - s * pq_m)] = src[i];
        }
      }
      __syncthreads();

      // Scores: thread p sums pair (q, s) = (p / 128, p % 128).
      for (int p = tid; p < QB * kPqTile; p += kPqThreads) {
        const int q = p / kPqTile, s = p % kPqTile;
        float v = CUDART_INF_F;
        if (s < ncol) {
          const float* lq = lut + q * L;
          const unsigned* crow = cs + s * cw;
          float acc = 0.f;
          for (int w = 0; w * 4 < pq_m; ++w) {
            const unsigned word = crow[w];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jj = w * 4 + e;
              if (jj < pq_m) acc += lq[jj * ncodes + ((word >> (8 * e)) & 0xffu)];
            }
          }
          const int r = row0 + q;
          if (qc != nullptr && r < m) acc += qc[static_cast<size_t>(r) * ncells + cell];
          v = finalize(acc + hxs[q] + hy[col0 + s], fin);
        }
        tile[q * kPqTile + s] = v;
      }
      __syncthreads();

      // Selection: warp q folds row q's 128 candidates into its K-buffer.
      for (int q = warp; q < QB; q += kPqWarps) {
        if (row0 + q >= m) break;
        float* rvq = rv + q * K;
        int* riq = ri + q * K;
        float kv = rvq[K - 1];
        int ki = riq[K - 1];
#pragma unroll
        for (int b = 0; b < kPqTile; b += 32) {
          const int s = b + lane;
          warp_offer<kCap>(rvq, riq, K, tile[q * kPqTile + s], col0 + s, s < ncol, skip != 0,
                           kv, ki, lane);
        }
      }
      __syncthreads();
    }
  }

  if constexpr (kInOut) return;
  for (int q = warp; q < QB; q += kPqWarps) {
    const int r = row0 + q;
    if (r >= m) break;
    const size_t out = (static_cast<size_t>(split) * m + r) * K;
    for (int j = lane; j < K; j += 32) {
      out_v[out + j] = rv[q * K + j];
      out_i[out + j] = ri[q * K + j];
    }
  }
}

// Allow the kernel its dynamic shared memory; the bytes, or 0 if too many.
template <int QB, int kCap>
size_t pq_prepare(int lut_floats, int pq_m, int K) {
  const size_t smem = pq_smem_bytes<QB, kCap>(lut_floats, pq_m, K);
  if (smem > 232448 - sizeof(float) * QB) return 0;  // the static hx block too
  if (cudaFuncSetAttribute(pq_scan_kernel<QB, kCap>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  return smem;
}

template <int QB, int kCap>
int pq_occupancy(int lut_floats, int pq_m, int K, int* out) {
  const size_t smem = pq_prepare<QB, kCap>(lut_floats, pq_m, K);
  out[0] = out[1] = 0;
  if (smem == 0) return 0;  // does not fit an SM: zero CTAs
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, pq_scan_kernel<QB, kCap>, kPqThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ctas;
  out[1] = static_cast<int>(smem);
  return 0;
}

template <int QB, int kCap>
int launch_pq(const int* probes, const int* extent, const float* luts, const uint8_t* codes,
              const float* qc, const float* hx, const float* hy, float* out_v, int* out_i,
              int m, int pq_m, int ncodes, int S, int W, int K, int cell_cap, int tile_m,
              int skip, int fin, int splits, int slots_per_split, cudaStream_t stream) {
  const size_t smem = pq_prepare<QB, kCap>(pq_m * ncodes, pq_m, K);
  if (smem == 0) return cudaErrorInvalidValue;
  const dim3 grid((m + QB - 1) / QB, splits);
  pq_scan_kernel<QB, kCap><<<grid, kPqThreads, smem, stream>>>(
      probes, extent, luts, codes, qc, hx, hy, out_v, out_i, m, pq_m, ncodes, S, W, K,
      cell_cap, tile_m, skip, fin, slots_per_split);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, QB>{}) for the QB the Python side picked.
template <typename F>
int dispatch_qb(int qb, F&& f) {
  switch (qb) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// out[0] = CTAs resident per SM at QB (registers and shared memory both
// counted; 0 if the LUTs and buffers exceed an SM's shared memory),
// out[1] = dynamic shared memory per CTA in bytes.
extern "C" int pq_scan_occupancy(int qb, int lut_floats, int pq_m, int K, int* out) {
  using namespace repro;
  if (lut_floats <= 0 || pq_m <= 0 || K <= 0 || K > kMaxSelectK || (K & (K - 1)) != 0)
    return cudaErrorInvalidValue;
  return dispatch_qb(qb, [&](auto c) -> int {
    constexpr int kQB = decltype(c)::value;
    return K <= kMaxK ? pq_occupancy<kQB, kMaxK>(lut_floats, pq_m, K, out)
                      : pq_occupancy<kQB, kMaxSelectK>(lut_floats, pq_m, K, out);
  });
}

// probes [ceil(m / tile_m), W]; extent [S / cell_cap]: the leading slots of
// each cell to scan; luts [m, pq_m * ncodes]; codes [S, pq_m] uint8; qc
// (nullable) [m, S / cell_cap]; hx [m]; hy [S]; out_v/out_i: [splits, m, K];
// split s holds the partial set of the slots [s * slots_per_split,
// (s + 1) * slots_per_split) of each tile's list.
extern "C" int pq_scan(const int* probes, const int* extent, const float* luts,
                       const uint8_t* codes, const float* qc, const float* hx, const float* hy,
                       float* out_v, int* out_i, int m, int pq_m, int ncodes, int S, int W,
                       int K, int cell_cap, int tile_m, int threshold_skip, int fin, int qb,
                       int splits, int slots_per_split, void* stream) {
  using namespace repro;
  if ((qb != 1 && qb != 2 && qb != 4 && qb != 8) || extent == nullptr || m <= 0 || pq_m <= 0 ||
      ncodes < 2 || ncodes > 256 ||
      (ncodes & (ncodes - 1)) != 0 || K <= 0 || K > kMaxSelectK || (K & (K - 1)) != 0 ||
      cell_cap <= 0 || S <= 0 || S % cell_cap != 0 || W <= 0 || tile_m <= 0 ||
      (tile_m % qb != 0 && m > tile_m) || splits < 1 || slots_per_split < 1 ||
      (splits - 1) * slots_per_split >= W || splits * slots_per_split < W || splits > 65535 ||
      (pq_m % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 != 0))
    return cudaErrorInvalidValue;
  return dispatch_qb(qb, [&](auto c) -> int {
    constexpr int kQB = decltype(c)::value;
    auto go = [&](auto launch) {
      return launch(probes, extent, luts, codes, qc, hx, hy, out_v, out_i, m, pq_m, ncodes, S,
                    W, K, cell_cap, tile_m, threshold_skip, fin, splits, slots_per_split,
                    static_cast<cudaStream_t>(stream));
    };
    return K <= kMaxK ? go(launch_pq<kQB, kMaxK>) : go(launch_pq<kQB, kMaxSelectK>);
  });
}
