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
// (64 MiB at m = 1024, Kp = 64, d = 256) for 2 FLOP a float, so the design
// keeps bytes in flight.  A CTA of 8 warps takes qb query rows (qb chosen
// by the host: enough rows that a stage gives every warp a unit, as many as
// shared memory holds); a unit is 32 candidates of one row, and warp w
// takes units w, w + 8, ... .  Each warp streams its units through a ring
// of kRsRing slots in shared memory, 32 floats of d of the 32 candidate
// rows a slot, filled by cp.async (16 bytes a copy, three slots in flight
// while the fourth is read), so that about 96 KB a CTA are in flight.  Lane
// j dots candidate j in fp32 on the CUDA cores: the slot's rows are padded
// to 36 floats, so the float4 reads of 32 rows at one offset fall on
// distinct banks a quarter-warp at a time, and the row of fx is one
// broadcast read.  The selection is select.cuh's staged bulk merge for
// every K up to kMaxSelectK: each row's K-buffer and staging area of 64-bit
// keys lie in shared memory (32 + 32 KB at K = 4096), a candidate that
// beats the row's K-th entry is appended with one warp-aggregated atomic,
// and the CTA flushes (trims, sorts and merges) when a staging area could
// not take the next stage.  One barrier a stage, where the warps' exact
// append counts (double-buffered by stage parity) decide a flush
// uniformly, as in stream_topk.cu.
#include "select.cuh"

namespace repro {

constexpr int kRsThreads = 256;
constexpr int kRsWarps = kRsThreads / 32;
constexpr int kRsChunk = 32;                // floats of d a slot holds of each candidate
constexpr int kRsPitch = kRsChunk + 4;      // a slot's row, padded: conflict-free float4 reads
constexpr int kRsSlot = 32 * kRsPitch;      // floats a slot: one unit of 32 candidates
constexpr int kRsRing = 4;                  // slots in each warp's ring
constexpr int kRsStage = kRsWarps * 32;     // candidates a stage: a unit a warp
constexpr int kRsFloor = 2 * kRsStage;      // staging floor: the flush threshold cap - kRsStage > 0
constexpr int kRsMaxRows = 8;               // query rows a CTA takes at most
constexpr size_t kRsMaxSmem = 232448;       // shared memory a block can have
// The kernel's static shared memory: cursors, append counts, a flush's scratch.
constexpr size_t kRsStatic = sizeof(int) * (kRsMaxRows + 2 * kRsWarps) + sizeof(TrimScratch);

// Shared memory of a CTA of qb rows: the warps' rings, the rows of fx (d
// rounded up to a slot's width, zero past d), and each row's K-buffer and
// staging area.
inline size_t rs_smem_bytes(int qb, int d, int K) {
  const size_t dp = (d + kRsChunk - 1) / kRsChunk * kRsChunk;
  return sizeof(float) * (static_cast<size_t>(kRsWarps) * kRsRing * kRsSlot + qb * dp) +
         sizeof(Key) * static_cast<size_t>(qb) * (K + staging_cap(K, kRsFloor));
}

// Rows a CTA takes: the fewest that give a stage a unit for every warp (at
// most kRsMaxRows), halved until shared memory holds them; 0 if one row
// does not fit.
inline int rs_rows(int Kp, int d, int K) {
  const int units = (Kp + 31) / 32;
  int qb = 1;
  while (qb < kRsMaxRows && qb * units < kRsWarps) qb <<= 1;
  while (qb > 1 && rs_smem_bytes(qb, d, K) + kRsStatic > kRsMaxSmem) qb >>= 1;
  return rs_smem_bytes(qb, d, K) + kRsStatic <= kRsMaxSmem ? qb : 0;
}

__global__ void __launch_bounds__(kRsThreads)
    rescore_kernel(const float* __restrict__ fx, const float* __restrict__ cand,
                   const float* __restrict__ hx, const float* __restrict__ hy_cand,
                   float* __restrict__ out_v, int* __restrict__ out_p, int m, int Kp, int d,
                   int K, int qb, float alpha, int fin) {
  extern __shared__ float4 rs_smem[];
  __shared__ int cnt[kRsMaxRows];             // the staging areas' atomic cursors
  __shared__ int warp_n[2][kRsWarps];         // appends a warp made in a stage, by parity
  __shared__ TrimScratch ws;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cap = staging_cap(K, kRsFloor);
  const int dp = (d + kRsChunk - 1) / kRsChunk * kRsChunk;
  const int chunks = dp / kRsChunk;
  float* ring = reinterpret_cast<float*>(rs_smem);                 // [warps][kRsRing][kRsSlot]
  float* xs = ring + kRsWarps * kRsRing * kRsSlot;                 // [qb][dp]
  Key* bk = reinterpret_cast<Key*>(xs + static_cast<size_t>(qb) * dp);  // [qb][K]
  Key* sk = bk + static_cast<size_t>(qb) * K;                      // [qb][cap]
  const int row0 = blockIdx.x * qb;
  const int rows = min(qb, m - row0);
  const int per_row = (Kp + 31) / 32;  // units a row
  const int units = rows * per_row;

  for (int i = tid; i < qb * dp; i += kRsThreads) {
    const int q = i / dp, k = i % dp;
    xs[i] = q < rows && k < d ? fx[static_cast<size_t>(row0 + q) * d + k] : 0.f;
  }
  for (int i = tid; i < qb * K; i += kRsThreads) bk[i] = kEmptyKey;
  if (tid < kRsMaxRows) cnt[tid] = 0;

  // This warp's walk: item i is slot-chunk i % chunks of its unit
  // warp + kRsWarps * (i / chunks).  Lane l copies float4 l % 8 of the
  // chunk of candidates l / 8 + 4 e: each copy instruction reads four rows'
  // 128 contiguous bytes.
  const int items = (units > warp ? (units - warp + kRsWarps - 1) / kRsWarps : 0) * chunks;
  float* my_ring = ring + warp * kRsRing * kRsSlot;
  auto issue = [&](int i) {
    if (i < items) {
      const int u = warp + kRsWarps * (i / chunks), k0 = (i % chunks) * kRsChunk;
      const int q = u / per_row, c0 = (u % per_row) * 32;
      const float* src = cand + (static_cast<size_t>(row0 + q) * Kp + c0) * d;
      float* dst = my_ring + (i % kRsRing) * kRsSlot;
      const int f = lane % 8, k = k0 + 4 * f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = lane / 8 + 4 * e;
        const bool ok = c0 + c < Kp && k < d;
        stage_copy16(dst + c * kRsPitch + 4 * f, ok ? src + static_cast<size_t>(c) * d + k : cand,
                     ok ? 16 : 0);
      }
    }
    stage_commit();  // an empty group past the end keeps the count of groups uniform
  };
  for (int i = 0; i < kRsRing - 1; ++i) issue(i);
  __syncthreads();  // xs, the buffers and the cursors

  Key kth[kRsMaxRows];  // each row's K-th entry, as of the last flush
  int staged[kRsMaxRows];  // keys in each row's staging area, the same in every thread
#pragma unroll
  for (int q = 0; q < kRsMaxRows; ++q) {
    kth[q] = kEmptyKey;
    staged[q] = 0;
  }
  const auto sync = [] { __syncthreads(); };
  const int nstages = (units + kRsWarps - 1) / kRsWarps;
  int item = 0;
  for (int s = 0; s < nstages; ++s) {
    const int u = s * kRsWarps + warp;
    int mine = 0;
    if (u < units) {
      const int q = u / per_row, c = (u % per_row) * 32 + lane;
      const float* xq = xs + q * dp;
      float acc = 0.f;  // lane j: the dot of candidate j of the unit
      for (int kc = 0; kc < chunks; ++kc, ++item) {
        issue(item + kRsRing - 1);
        stage_wait<kRsRing - 1>();
        __syncwarp();  // the slot's copies by every lane have landed
        const float* row = my_ring + (item % kRsRing) * kRsSlot + lane * kRsPitch;
#pragma unroll
        for (int f = 0; f < kRsChunk / 4; ++f) {
          const float4 a = *reinterpret_cast<const float4*>(xq + kc * kRsChunk + 4 * f);
          const float4 b = *reinterpret_cast<const float4*>(row + 4 * f);
          acc = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
        }
        __syncwarp();  // every lane has read the slot before it is refilled
      }
      Key thr = kEmptyKey;
#pragma unroll
      for (int r = 0; r < kRsMaxRows; ++r)
        if (r == q) thr = kth[r];
      const size_t g = static_cast<size_t>(row0 + q) * Kp + c;
      const float val = c < Kp ? finalize(alpha * acc + hx[row0 + q] + hy_cand[g], fin)
                               : CUDART_INF_F;
      const Key key = staged_key(val, c);
      mine = staged_append(sk + static_cast<size_t>(q) * cap, &cnt[q], key, c < Kp && key < thr,
                           lane);
    }
    if (lane == 0) warp_n[s & 1][warp] = mine;
    __syncthreads();
    for (int w = 0; w < kRsWarps; ++w) {
      const int uw = s * kRsWarps + w;
      const int add = uw < units ? warp_n[s & 1][w] : 0, qw = uw / per_row;
#pragma unroll
      for (int r = 0; r < kRsMaxRows; ++r) staged[r] += r == qw ? add : 0;
    }
    bool full = false;
#pragma unroll
    for (int r = 0; r < kRsMaxRows; ++r) full |= staged[r] > cap - kRsStage;
    if (full) {  // the next stage might not fit: flush
      if (tid < kRsMaxRows) cnt[tid] = 0;  // ordered before the next appends by the flush

      staged_flush<kRsThreads>(bk, sk, staged, qb, K, cap, tid, sync, &ws);
#pragma unroll
      for (int r = 0; r < kRsMaxRows; ++r)
        if (r < qb) kth[r] = bk[static_cast<size_t>(r) * K + K - 1];
    }
  }
  stage_wait<0>();
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRsMaxRows; ++r) any |= staged[r] > 0;
  if (any) staged_flush<kRsThreads>(bk, sk, staged, qb, K, cap, tid, sync, &ws);
  for (int i = tid; i < rows * K; i += kRsThreads) {
    out_v[static_cast<size_t>(row0) * K + i] = staged_value(bk[i]);
    out_p[static_cast<size_t>(row0) * K + i] = staged_id(bk[i]);
  }
}

}  // namespace repro

// out[0] = query rows a CTA takes, out[1] = CTAs resident per SM, out[2] =
// dynamic shared memory per CTA in bytes, for candidates [m, Kp, d] at
// width K.
extern "C" int rescore_occupancy(int Kp, int d, int K, int* out) {
  using namespace repro;
  if (Kp <= 0 || d <= 0 || K <= 0 || K > kMaxSelectK || (K & (K - 1)) != 0)
    return cudaErrorInvalidValue;
  const int qb = rs_rows(Kp, d, K);
  if (qb == 0) return cudaErrorInvalidValue;
  const size_t smem = rs_smem_bytes(qb, d, K);
  cudaError_t err = cudaFuncSetAttribute(
      rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, rescore_kernel, kRsThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = qb;
  out[1] = ctas;
  out[2] = static_cast<int>(smem);
  return 0;
}

// fx [m, d]; cand [m, Kp, d]; hx [m]; hy_cand [m, Kp] (+inf = empty slot);
// out_v/out_pos: [m, K], positions into the candidate axis, -1 when empty.
extern "C" int rescore_f32(const float* fx, const float* cand, const float* hx,
                           const float* hy_cand, float* out_v, int* out_pos, int m, int Kp, int d,
                           int K, float alpha, int fin, void* stream) {
  using namespace repro;
  if (m <= 0 || Kp <= 0 || d <= 0 || d % 4 != 0 || K <= 0 || K > kMaxSelectK ||
      (K & (K - 1)) != 0)
    return cudaErrorInvalidValue;
  const int qb = rs_rows(Kp, d, K);
  if (qb == 0) return cudaErrorInvalidValue;
  const size_t smem = rs_smem_bytes(qb, d, K);
  const cudaError_t err = cudaFuncSetAttribute(
      rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rescore_kernel<<<(m + qb - 1) / qb, kRsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fx, cand, hx, hy_cand, out_v, out_pos, m, Kp, d, K, qb, alpha, fin);
  return static_cast<int>(cudaGetLastError());
}
