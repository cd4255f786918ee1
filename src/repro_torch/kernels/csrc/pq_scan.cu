// IVF-PQ ADC scan: per query block, the cells of its union probe list scored
// by asymmetric distance computation over their uint8 codes.
//
// Replaces pq_scan.py::pq_scan_pallas / _kernel (and its tile, adc_tile) of
// the JAX package.  Per query q and packed slot s of a probed cell c:
//   score = finalize(sum_j lut[q][j][code[s][j]] (+ qc[q][c]) + hx[q] + hy[s])
// in the reference's order after the sum: ((sum + qc) + hx) + hy.  Dead and
// pad slots arrive as hy = +inf; ids are packed slots.
//
// The TPU kernel expands each code block into a one-hot operand and
// contracts it with the flattened tables on the MXU, because a TPU lane
// cannot gather.  A lane here can, so the work is table lookups from shared
// memory: pq_m per (query, slot) pair.  Bound on the H100: the lookups.  The
// operations bound counts pq_m fp32 adds a pair at 67 TFLOP/s; the lookups
// themselves are shared-memory loads, at best one 32-lane wavefront a cycle
// per SM, which is the floor the design aims at.
//
// A CTA of 16 warps owns QB queries of one union tile (QB divides tile_m, or
// the batch is one tile) and walks the contiguous range [split *
// slots_per_split, ...) of its tile's list, skipping a slot that repeats its
// predecessor and stopping each cell at its extent.  The walk is cut into
// units of 32 slots of one cell, so a cell wastes at most 31 lanes, and a
// stage is 16 units: warp w scores unit w of each stage for all QB queries,
// lane l taking slot l of the unit.  Every warp runs the same walk (each
// holds a window of 32 list slots, one a lane, found by ballot), so no warp
// waits on another for its units.
//
// Ring mode (pq_m a multiple of 32, the tables in shared memory at once):
//   * the tables are staged once, transposed per block of 32 subspaces to
//     [code][32], so that lane l, reading subspace (l + t) mod 32 at step t,
//     always reads bank (l + t) mod 32: no bank conflicts, whatever the codes;
//   * each warp stages its own units' codes (32 x pq_m contiguous bytes)
//     with cp.async into a ring of kPqRing units, so the next units' loads
//     overlap this unit's lookups; a lane reads its row's 8 words of a block
//     rotated by l / 4 words (conflict-free too) and funnel-shifts them by
//     l % 4 bytes, so that step t's code is byte t, at a constant position.
// Generic mode (any other pq_m, or tables past the budget): the tables in
// their own layout [j][code], in chunks of `chunk` subspaces when one query's
// table exceeds the budget (reloaded a stage at a time, partial sums carried
// in registers across chunks); codes read from device memory.  Any table
// size serves.
//
// Selection: select.cuh's staged bulk merge, per query a K-buffer and a
// staging area in shared memory for every K up to kMaxSelectK.  The warp
// that scores a slot appends it to its query's staging area if it beats the
// K-th entry; there is no hand-off of a scored tile.  One barrier a stage,
// where the warps' exact append counts are summed to decide a flush.  Ranges
// of ascending cells hold ascending slots, so merge_partials.cu merges the
// splits' partial sets with one pass's tie rule.
#include <type_traits>

#include "select.cuh"

namespace repro {

constexpr int kPqThreads = 512, kPqWarps = kPqThreads / 32;
constexpr int kPqUnit = 32;                     // slots of one cell a warp scores
constexpr int kPqStage = kPqWarps * kPqUnit;    // slots a stage
constexpr int kPqRing = 3;                      // units in each warp's code ring
constexpr int kPqFloor = 2 * kPqStage;          // staging floor: threshold cap - kPqStage

// Bytes of dynamic shared memory: each warp's code ring (ring mode), the QB
// tables (a chunk of `chunk` subspaces each), the K-buffers and the staging
// areas.
inline size_t pq_smem_bytes(int qb, int ring, int chunk, int pq_m, int ncodes, int K) {
  const int cap = staging_cap(K, kPqFloor);
  return (ring ? static_cast<size_t>(kPqWarps) * kPqRing * kPqUnit * (pq_m + 4) : 0) +
         sizeof(float) * static_cast<size_t>(qb) * chunk * ncodes +
         sizeof(Key) * static_cast<size_t>(qb) * (K + cap);
}

// The walk over a tile's list slots [j_begin, j_end) in units of up to 32
// slots of one cell, numbered in walk order.  Every lane of the warp holds the
// same state; lane l also holds list slot wj + l of the current window: its
// cell's first slot and end (hi == base when the slot is skipped: a repeat of
// its predecessor, no cell, or an empty one) and the units before it in the
// window.  unit(U) finds the unit numbered U by one ballot; U only grows.
struct UnitWalk {
  const int* plist;
  const int* extent;
  int j_end, cell_cap, S, lane;
  int wj, wu0, wn;                // the window's first slot, the units before it, its units
  int wcell, wbase, whi, wpre;    // this lane's slot of it
  int total;                      // units of the whole range

  // List slot j's cell, first slot and end.
  __device__ void slot(int j, int& c, int& base, int& hi) const {
    c = j < j_end ? plist[j] : -1;
    const bool dup = j < j_end && j > 0 && plist[j - 1] == c;  // duplicate padding
    base = c * cell_cap;
    hi = c >= 0 && base < S && !dup ? base + max(0, min(extent[c], cell_cap)) : base;
  }

  // Load the window at list slot j0; its units.
  __device__ int load(int j0) {
    wj = j0;
    slot(j0 + lane, wcell, wbase, whi);
    const int units = (whi - wbase + kPqUnit - 1) / kPqUnit;
    int incl = units;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += y;
    }
    wpre = incl - units;
    return __shfl_sync(kFullMask, incl, 31);
  }

  __device__ void start(const int* list, const int* ext, int j_begin, int j_end_, int cap,
                        int S_, int lane_) {
    plist = list;
    extent = ext;
    j_end = j_end_;
    cell_cap = cap;
    S = S_;
    lane = lane_;
    int units = 0;
    for (int j = j_begin + lane; j < j_end; j += 32) {
      int c, base, hi;
      slot(j, c, base, hi);
      units += (hi - base + kPqUnit - 1) / kPqUnit;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) units += __shfl_xor_sync(kFullMask, units, o);
    total = units;
    wu0 = 0;
    wn = load(j_begin);
  }

  // Unit U (< total): its first slot, its slots (1..32) and its cell.
  __device__ void unit(int U, int& col0, int& ncol, int& cell) {
    while (U >= wu0 + wn) {
      wu0 += wn;
      wn = load(wj + 32);
    }
    const int rel = U - wu0;
    const unsigned at = __ballot_sync(kFullMask, whi > wbase && wpre <= rel);
    const int p = 31 - __clz(at);
    const int base = __shfl_sync(kFullMask, wbase, p);
    col0 = base + kPqUnit * (rel - __shfl_sync(kFullMask, wpre, p));
    ncol = min(kPqUnit, __shfl_sync(kFullMask, whi, p) - col0);
    cell = __shfl_sync(kFullMask, wcell, p);
  }

  // This warp's unit of stage s (warp w takes unit kPqWarps * s + w), or
  // ncol = 0 past the end.
  __device__ void stage(int s, int w, int& col0, int& ncol, int& cell) {
    col0 = ncol = cell = 0;
    const int U = kPqWarps * s + w;
    if (U < total) unit(U, col0, ncol, cell);
  }
};

// kL: a query's table in floats when known at compile time (ring mode at
// pq_m 32, 256 codes: 8192), so that each query's lookup is an immediate
// offset from one address; 0 takes it at run time.
template <int QB, bool kRing, int kL>
__global__ void __launch_bounds__(kPqThreads)
    pq_scan_kernel(const int* __restrict__ probes, const int* __restrict__ extent,
                   const float* __restrict__ luts, const uint8_t* __restrict__ codes,
                   const float* __restrict__ qc, const float* __restrict__ hx,
                   const float* __restrict__ hy, float* __restrict__ out_v,
                   int* __restrict__ out_i, int m, int pq_m, int ncodes, int S, int W, int K,
                   int cell_cap, int tile_m, int skip, int fin, int slots_per_split,
                   int chunk) {
  extern __shared__ float4 smem4[];
  __shared__ int cnt[QB];                   // the staging areas' atomic cursors
  __shared__ int warp_n[2][kPqWarps][QB];   // appends a warp made in a stage, by parity
  __shared__ TrimScratch ws;
  const int L = kL ? kL : pq_m * ncodes;
  const int cap = staging_cap(K, kPqFloor);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int ncells = S / cell_cap;
  // The code ring ([kPqRing][kPqWarps] units of 32 rows of pq_m code bytes
  // and their 32 hy terms, ring mode; a multiple of 16 bytes), the QB tables
  // (an even number of floats), then the [QB][K] buffers and the [QB][cap]
  // staging areas.
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  float* lut = reinterpret_cast<float*>(
      ring + (kRing ? static_cast<size_t>(kPqWarps) * kPqRing * kPqUnit * (pq_m + 4) : 0));
  const int lut_q = chunk * ncodes;  // floats of a query's table (chunk)
  Key* bk = reinterpret_cast<Key*>(lut + QB * lut_q);
  Key* sk = bk + QB * K;
  const int* plist = probes + static_cast<size_t>(row0 / tile_m) * W;
  const int j_begin = split * slots_per_split;
  const int j_end = min(W, j_begin + slots_per_split);
  const int lg_nc = __ffs(ncodes) - 1;

  // A chunk of the QB tables: subspaces [j0, j0 + nj), rows past m zero.
  auto load_tables = [&](int j0, int nj) {
    if constexpr (kRing) {  // transposed: [blk][code][32]
      for (int i = tid; i < QB * L; i += kPqThreads) {
        const int jj = i & 31, rest = i >> 5;
        const int c = rest & (ncodes - 1), bq = rest >> lg_nc;
        const int blk = bq % (pq_m / 32), q = bq / (pq_m / 32);
        const int r = row0 + q;
        lut[i] = r < m ? __ldg(luts + static_cast<size_t>(r) * L + (blk * 32 + jj) * ncodes + c)
                       : 0.f;
      }
    } else {  // as stored: [j][code]
      const int per = nj * ncodes;
      for (int i = tid; i < QB * per; i += kPqThreads) {
        const int q = i / per, e = i - q * per, r = row0 + q;
        lut[q * lut_q + e] =
            r < m ? __ldg(luts + static_cast<size_t>(r) * L + j0 * ncodes + e) : 0.f;
      }
    }
  };

  for (int i = tid; i < QB * K; i += kPqThreads) bk[i] = kEmptyKey;
  if (tid < QB) cnt[tid] = 0;
  float hxq[QB];
  Key kth[QB];  // each buffer's K-th entry, as of the last flush
  int staged[QB];
#pragma unroll
  for (int q = 0; q < QB; ++q) {
    hxq[q] = row0 + q < m ? hx[row0 + q] : 0.f;
    kth[q] = kEmptyKey;
    staged[q] = 0;
  }
  const int nchunks = (pq_m + chunk - 1) / chunk;
  if (nchunks == 1) load_tables(0, pq_m);

  UnitWalk walk;
  walk.start(plist, extent, j_begin, j_end, cell_cap, S, lane);
  const auto sync = [] { __syncthreads(); };

  // The QB cell-bias terms of a unit's cell (0 without qc).
  auto cell_bias = [&](int cell, int ncol, float (&out)[QB]) {
#pragma unroll
    for (int q = 0; q < QB; ++q)
      out[q] = qc != nullptr && ncol > 0 && row0 + q < m
                   ? qc[static_cast<size_t>(row0 + q) * ncells + cell] : 0.f;
  };

  // Scores of this warp's unit (first slot col0, ncol slots) for the QB
  // queries, into their staging areas: acc holds the table sums, hyv this
  // lane's hy term, bias the cell-bias terms.
  auto offer = [&](const float (&acc)[QB], int col0, int ncol, float hyv,
                   const float (&bias)[QB], int par) {
    const int slot = col0 + lane;
    const bool valid = lane < ncol;
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      const int r = row0 + q;
      int mine = 0;
      if (r < m && ncol > 0) {
        const float s = qc != nullptr ? acc[q] + bias[q] : acc[q];
        const Key key = staged_key(finalize(s + hxq[q] + hyv, fin), slot);
        const bool want = valid && (!skip || key < kth[q]);
        mine = staged_append(sk + q * cap, &cnt[q], key, want, lane);
      }
      if (lane == 0) warp_n[par][warp][q] = mine;
    }
  };

  // After a stage's barrier: the exact staged counts, and a flush if a list
  // might not take another stage.
  auto settle = [&](int par) {
    bool full = false;
#pragma unroll
    for (int q = 0; q < QB; ++q) {
#pragma unroll
      for (int w = 0; w < kPqWarps; ++w) staged[q] += warp_n[par][w][q];
      full |= staged[q] > cap - kPqStage;
    }
    if (full) {
      if (tid < QB) cnt[tid] = 0;  // ordered before the next appends by the flush's barriers
      staged_flush<kPqThreads>(bk, sk, staged, QB, K, cap, tid, sync, &ws);
#pragma unroll
      for (int q = 0; q < QB; ++q) kth[q] = bk[q * K + K - 1];
    }
  };

  if constexpr (kRing) {
    __syncthreads();  // the tables, buffers and cursors
    const int nblk = pq_m / 32;
    const int words = pq_m / 4;
    const int unit_bytes = kPqUnit * (pq_m + 4);  // the codes, then the hy terms
    // This warp's units of the next kPqRing stages: first slot, slots, and
    // the cell-bias terms, loaded as the unit's codes are.
    int qcol[kPqRing], qn[kPqRing];
    float qbias[kPqRing][QB];
    auto produce = [&](int t, int at) {
      int a, b, c;
      walk.stage(t, warp, a, b, c);
      uint8_t* dst = ring + (static_cast<size_t>(t % kPqRing) * kPqWarps + warp) * unit_bytes;
      if (b > 0) {
        const uint8_t* src = codes + static_cast<size_t>(a) * pq_m;
        const int bytes = b * pq_m;
        for (int g = lane * 16; g < kPqUnit * pq_m; g += 32 * 16) {
          const int n = max(0, min(16, bytes - g));
          stage_copy16(dst + g, n > 0 ? src + g : codes, n);
        }
        stage_copy4(dst + kPqUnit * pq_m + 4 * lane, lane < b ? hy + a + lane : hy,
                    lane < b ? 4 : 0);
      }
      stage_commit();
      float bias[QB];
      cell_bias(c, b, bias);
#pragma unroll
      for (int i = 0; i < kPqRing; ++i) {
        if (i == at) {
          qcol[i] = a;
          qn[i] = b;
#pragma unroll
          for (int q = 0; q < QB; ++q) qbias[i][q] = bias[q];
        }
      }
    };
#pragma unroll
    for (int t = 0; t < kPqRing - 1; ++t) produce(t, t);
    const int a4 = 8 * (lane & 3), rot = lane >> 2;
    for (int s = 0; kPqWarps * s < walk.total; ++s) {
      produce(s + kPqRing - 1, kPqRing - 1);
      stage_wait<kPqRing - 1>();
      __syncwarp();
      float acc[QB];
#pragma unroll
      for (int q = 0; q < QB; ++q) acc[q] = 0.f;
      if (qn[0] > 0) {
        const unsigned* cw = reinterpret_cast<const unsigned*>(
            ring + (static_cast<size_t>(s % kPqRing) * kPqWarps + warp) * unit_bytes) +
            lane * words;
        for (int blk = 0; blk < nblk; ++blk) {
          unsigned w[8], r8[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) w[i] = cw[blk * 8 + ((i + rot) & 7)];
#pragma unroll
          for (int i = 0; i < 8; ++i) r8[i] = __funnelshift_r(w[i], w[(i + 1) & 7], a4);
          const float* lb = lut + blk * ncodes * 32;
#pragma unroll
          for (int t = 0; t < 32; ++t) {
            const unsigned code = (r8[t >> 2] >> (8 * (t & 3))) & 0xffu;
            const float* e = lb + (code << 5) + ((lane + t) & 31);
#pragma unroll
            for (int q = 0; q < QB; ++q) acc[q] += e[q * L];
          }
        }
      }
      const float* hyr = reinterpret_cast<const float*>(
          ring + (static_cast<size_t>(s % kPqRing) * kPqWarps + warp) * unit_bytes +
          kPqUnit * pq_m);
      offer(acc, qcol[0], qn[0], lane < qn[0] ? hyr[lane] : CUDART_INF_F, qbias[0], s & 1);
#pragma unroll
      for (int i = 0; i + 1 < kPqRing; ++i) {
        qcol[i] = qcol[i + 1];
        qn[i] = qn[i + 1];
#pragma unroll
        for (int q = 0; q < QB; ++q) qbias[i][q] = qbias[i + 1][q];
      }
      __syncthreads();
      settle(s & 1);
    }
    stage_wait<0>();
  } else {
    __syncthreads();
    const bool words = pq_m % 4 == 0 && chunk % 4 == 0;
    for (int s = 0; kPqWarps * s < walk.total; ++s) {
      int col0, ncol, cell;
      walk.stage(s, warp, col0, ncol, cell);
      float acc[QB];
#pragma unroll
      for (int q = 0; q < QB; ++q) acc[q] = 0.f;
      const uint8_t* crow = codes + static_cast<size_t>(col0 + lane) * pq_m;
      const bool valid = lane < ncol;
      for (int ch = 0; ch < nchunks; ++ch) {
        const int j0 = ch * chunk, nj = min(chunk, pq_m - j0);
        if (nchunks > 1) {
          __syncthreads();  // every warp is done with the previous chunk
          load_tables(j0, nj);
          __syncthreads();
        }
        if (ncol == 0) continue;
        if (words) {
          for (int j = 0; j < nj; j += 4) {
            const unsigned wd =
                valid ? __ldg(reinterpret_cast<const unsigned*>(crow + j0 + j)) : 0u;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int idx = (j + e) * ncodes + ((wd >> (8 * e)) & 0xffu);
#pragma unroll
              for (int q = 0; q < QB; ++q) acc[q] += lut[q * lut_q + idx];
            }
          }
        } else {
          for (int j = 0; j < nj; ++j) {
            const int idx = j * ncodes + (valid ? __ldg(crow + j0 + j) : 0);
#pragma unroll
            for (int q = 0; q < QB; ++q) acc[q] += lut[q * lut_q + idx];
          }
        }
      }
      float bias[QB];
      cell_bias(cell, ncol, bias);
      offer(acc, col0, ncol, lane < ncol ? hy[col0 + lane] : CUDART_INF_F, bias, s & 1);
      __syncthreads();
      settle(s & 1);
    }
  }

  bool any = false;
#pragma unroll
  for (int q = 0; q < QB; ++q) any |= staged[q] > 0;
  if (any) staged_flush<kPqThreads>(bk, sk, staged, QB, K, cap, tid, sync, &ws);
  for (int i = tid; i < QB * K; i += kPqThreads) {
    const int q = i / K, r = row0 + q;
    if (r < m) {
      const size_t out = (static_cast<size_t>(split) * m + r) * K + (i - q * K);
      out_v[out] = staged_value(bk[i]);
      out_i[out] = staged_id(bk[i]);
    }
  }
}

// Allow the kernel its dynamic shared memory; the bytes, or 0 if too many.
template <int QB, bool kRing, int kL>
size_t pq_prepare(int chunk, int pq_m, int ncodes, int K) {
  const size_t smem = pq_smem_bytes(QB, kRing, chunk, pq_m, ncodes, K);
  constexpr size_t kStatic = sizeof(int) * (QB + 2 * kPqWarps * QB) + sizeof(TrimScratch);
  if (smem > 232448 - kStatic) return 0;
  if (cudaFuncSetAttribute(pq_scan_kernel<QB, kRing, kL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  return smem;
}

template <int QB, bool kRing, int kL>
int pq_occupancy(int chunk, int pq_m, int ncodes, int K, int* out) {
  const size_t smem = pq_prepare<QB, kRing, kL>(chunk, pq_m, ncodes, K);
  out[0] = out[1] = 0;
  if (smem == 0) return 0;  // does not fit an SM: zero CTAs
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, pq_scan_kernel<QB, kRing, kL>, kPqThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ctas;
  out[1] = static_cast<int>(smem);
  return 0;
}

template <int QB, bool kRing, int kL>
int launch_pq(const int* probes, const int* extent, const float* luts, const uint8_t* codes,
              const float* qc, const float* hx, const float* hy, float* out_v, int* out_i,
              int m, int pq_m, int ncodes, int S, int W, int K, int cell_cap, int tile_m,
              int skip, int fin, int splits, int slots_per_split, int chunk,
              cudaStream_t stream) {
  const size_t smem = pq_prepare<QB, kRing, kL>(chunk, pq_m, ncodes, K);
  if (smem == 0) return cudaErrorInvalidValue;
  const dim3 grid((m + QB - 1) / QB, splits);
  pq_scan_kernel<QB, kRing, kL><<<grid, kPqThreads, smem, stream>>>(
      probes, extent, luts, codes, qc, hx, hy, out_v, out_i, m, pq_m, ncodes, S, W, K,
      cell_cap, tile_m, skip, fin, slots_per_split, chunk);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, QB>{}, std::bool_constant<ring>{},
// std::integral_constant<int, kL>{}) for the QB and mode the Python side
// picked (kL 8192 for ring mode at pq_m 32, 256 codes; else 0).
template <typename F>
int dispatch_pq(int qb, int ring, int pq_m, int ncodes, F&& f) {
  auto by_qb = [&](auto r, auto l) -> int {
    switch (qb) {
      case 1: return f(std::integral_constant<int, 1>{}, r, l);
      case 2: return f(std::integral_constant<int, 2>{}, r, l);
      case 4: return f(std::integral_constant<int, 4>{}, r, l);
      case 8: return f(std::integral_constant<int, 8>{}, r, l);
      default: return cudaErrorInvalidValue;
    }
  };
  if (!ring) return by_qb(std::false_type{}, std::integral_constant<int, 0>{});
  if (pq_m == 32 && ncodes == 256)
    return by_qb(std::true_type{}, std::integral_constant<int, 32 * 256>{});
  return by_qb(std::true_type{}, std::integral_constant<int, 0>{});
}

}  // namespace repro

// A mode the kernel takes: ring mode wants pq_m a multiple of 32 and the
// whole table (chunk == pq_m); a chunk is 1..pq_m subspaces.
static bool pq_bad_mode(int ring, int chunk, int pq_m, int ncodes, int K) {
  return pq_m <= 0 || ncodes < 2 || ncodes > 256 || (ncodes & (ncodes - 1)) != 0 || K <= 0 ||
         K > repro::kMaxSelectK || (K & (K - 1)) != 0 || chunk <= 0 || chunk > pq_m ||
         (ring && (pq_m % 32 != 0 || chunk != pq_m));
}

// out[0] = CTAs resident per SM (registers and shared memory both counted;
// 0 if it exceeds an SM's shared memory), out[1] = dynamic shared memory per
// CTA in bytes.
extern "C" int pq_scan_occupancy(int qb, int ring, int chunk, int pq_m, int ncodes, int K,
                                 int* out) {
  using namespace repro;
  if (pq_bad_mode(ring, chunk, pq_m, ncodes, K)) return cudaErrorInvalidValue;
  return dispatch_pq(qb, ring, pq_m, ncodes, [&](auto c, auto r, auto l) -> int {
    return pq_occupancy<decltype(c)::value, decltype(r)::value, decltype(l)::value>(
        chunk, pq_m, ncodes, K, out);
  });
}

// probes [ceil(m / tile_m), W]; extent [S / cell_cap]: the leading slots of
// each cell to scan; luts [m, pq_m * ncodes]; codes [S, pq_m] uint8; qc
// (nullable) [m, S / cell_cap]; hx [m]; hy [S]; out_v/out_i: [splits, m, K];
// split s holds the partial set of the slots [s * slots_per_split,
// (s + 1) * slots_per_split) of each tile's list.  ring: 1 for ring mode
// (codes aligned to 16 bytes); chunk: subspaces of a staged table chunk.
extern "C" int pq_scan(const int* probes, const int* extent, const float* luts,
                       const uint8_t* codes, const float* qc, const float* hx, const float* hy,
                       float* out_v, int* out_i, int m, int pq_m, int ncodes, int S, int W,
                       int K, int cell_cap, int tile_m, int threshold_skip, int fin, int qb,
                       int splits, int slots_per_split, int ring, int chunk, void* stream) {
  using namespace repro;
  if ((qb != 1 && qb != 2 && qb != 4 && qb != 8) || extent == nullptr || m <= 0 ||
      pq_bad_mode(ring, chunk, pq_m, ncodes, K) || cell_cap <= 0 || S <= 0 ||
      S % cell_cap != 0 || W <= 0 || tile_m <= 0 || (tile_m % qb != 0 && m > tile_m) ||
      splits < 1 || slots_per_split < 1 || (splits - 1) * slots_per_split >= W ||
      splits * slots_per_split < W || splits > 65535 ||
      (ring && reinterpret_cast<uintptr_t>(codes) % 16 != 0) ||
      (pq_m % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 != 0))
    return cudaErrorInvalidValue;
  return dispatch_pq(qb, ring, pq_m, ncodes, [&](auto c, auto r, auto l) -> int {
    return launch_pq<decltype(c)::value, decltype(r)::value, decltype(l)::value>(
        probes, extent, luts, codes, qc, hx, hy, out_v, out_i, m, pq_m, ncodes, S, W, K,
        cell_cap, tile_m, threshold_skip, fin, splits, slots_per_split, chunk,
        static_cast<cudaStream_t>(stream));
  });
}
