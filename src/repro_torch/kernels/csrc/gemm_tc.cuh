// The Hopper tile product of the two matmul-form kernels (pairwise_distance.cu,
// fused_knn.cu):
//   acc[BM x BN] = A[row0 : row0+BM, :] . B[col0 : col0+BN, :]^T
// with A [rows_a, d] fp32 and B [rows_b, d] fp32, bf16 or int8, both
// row-major (d contiguous: the K-major "TN" layout TF32 wgmma requires of
// both operands), d % 4 == 0.
//
// Product: wgmma.mma_async m64nNk8 with tf32 inputs and fp32 accumulators,
// two warpgroups per CTA, operands from shared memory (SS).  Plain TF32
// moves distances by about 1e-3 relative, enough to change ids, so each fp32
// operand is split, hi = tf32_rna(x), lo = tf32_rna(x - hi), and three
// products of each 32-wide slice of d go into one accumulator, the small ones
// first:
//   acc = A_lo.B_hi;  acc += A_hi.B_lo;  acc += A_hi.B_hi,
// and the slices' accumulators are summed in registers (tc_multiply).
// hi + lo carries 22 significant bits of x, and the dropped A_lo.B_lo term is
// 2^-22 of each product, so a dot product lands within about
// d * max|a b| * 2^-21 of the fp32 one.  A bf16 or int8 row is exact in
// TF32: its lo is zero, and two products suffice (A_lo.B, A_hi.B).
//
// Staging: the d axis streams through shared memory 32 fp32 (128 bytes) of
// every row at a time.  cp.async copies each operand's raw rows (16 bytes a
// copy for fp32, 8 for bf16, 4 for int8; rows past rows_a / rows_b and the d
// tail past d are zero-filled by a source size of 0) into a ring of R raw
// stages, laid out as wgmma's 128-byte swizzle wants it: row r at r * 128
// bytes, its 16-byte chunk c at chunk c ^ (r % 8).  Each thread then splits
// the chunks it copied into one of two operand stages ([A_hi | A_lo | B_hi |
// B_lo]; a bf16 / int8 chunk is copied plainly and widened into B_hi).
// With R = 0 the raw rows land in the operand stage and are split in place.
//
// Where the split happens, and its cost: in the kernel, as a slice is
// staged: (BM + BN) * 32 elements a slice, each read once from shared memory
// and written twice, with two integer operations for each rounding (cvt.rna
// takes more).  The alternative, a split copy of both operands kept in
// device memory, would add 8 bytes a row element: 2 GiB beside the 1 GiB
// fp32 replica at the query_1m cell, past the 1 GB the design allows.  The
// split's shared-memory traffic (96 KB a 128 x 128 slice) comes on top of
// the copies' (32 KB) and the products' own operand reads (144 KB): about
// 2,200 cycles of shared-memory bandwidth a slice against 1,540 of
// tensor-core work, so shared memory, not the tensor cores, bounds this
// design (PERF.md).
//
// Warp specialisation (tc_load, tc_multiply): two loader warpgroups copy and
// split, two consumer warpgroups issue the products and run the epilogue,
// handing the two operand stages back and forth through named barriers, so
// that the split of slice s + 1 and the copies of the slices after it run
// while the tensor cores multiply slice s, and the next tile's slices while
// a tile's epilogue runs.  setmaxnreg gives the consumers the registers.
//
// Shared memory: 2 * (2 * BM + 2 * BN) * 128 bytes of operand stages, R raw
// stages of (BM * 4 + BN * sizeof(B)) * 32 bytes, plus 1 KB to align them to
// the swizzle's 1024-byte period.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {

namespace tc {

constexpr int kBK = 32;         // fp32 elements of a row per stage (128 bytes)
constexpr int kRowBytes = 128;  // one swizzle row
constexpr int kConsumers = 256;  // two warpgroups issue the products
constexpr int kLoaders = 256;    // two warpgroups copy and split the operands
constexpr int kThreads = kConsumers + kLoaders;
// Registers a thread, rebalanced once the roles split (65,536 in all at
// 512 threads): the consumers hold the accumulators.
constexpr int kLoaderRegs = 56, kConsumerRegs = 200;
static_assert(kLoaders * kLoaderRegs + kConsumers * kConsumerRegs <= 65536, "register file");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled operand.
__device__ __forceinline__ int swz(int r, int c) { return r * kRowBytes + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes, bool valid) {
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Named barriers between the loader and the consumer warpgroups (barrier 0
// is __syncthreads).  sync waits for `count` arrivals;
// arrive adds this warp's and goes on.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Bring the 128-byte line holding p into L1, with no register to wait on.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}
// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses to the accumulators across the
// asynchronous product (which reads and writes them behind its back).
template <int N>
__device__ __forceinline__ void fence_operand(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(a[i])::"memory");
}

// round-to-nearest, ties away from zero, to TF32 (the low 13 mantissa bits
// zero); the same rounding as kernels/tf32.py::tf32_split.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}
// The split of x: hi in place, lo returned.  A non-finite hi (inf, nan)
// carries the value alone: its lo is 0, as in tf32_split.
__device__ __forceinline__ float split_lo(float& x) {
  const float hi = tf32_rna(x);
  const bool finite = (__float_as_uint(hi) & 0x7f800000u) != 0x7f800000u;
  const float lo = finite ? tf32_rna(x - hi) : 0.f;
  x = hi;
  return lo;
}
// TF32 rounding of finite x whose TF32 value is finite, as two integer
// operations on the bits (half an ulp of TF32 added to the magnitude, the 13
// low bits cleared): cvt.rna's result, which its own instruction sequence
// takes several more operations for.
__device__ __forceinline__ uint32_t rna_bits(uint32_t u) { return (u + 0x1000u) & 0xffffe000u; }

// The split of four values: hi in place, lo returned.  Where every hi is
// finite (|x| below 0x7f7ff000 as bits) the integer rounding serves;
// otherwise each value takes split_lo.
__device__ __forceinline__ float4 split4(float4& v) {
  const uint32_t u[4] = {__float_as_uint(v.x), __float_as_uint(v.y), __float_as_uint(v.z),
                         __float_as_uint(v.w)};
  const uint32_t big = max(max(u[0] & 0x7fffffffu, u[1] & 0x7fffffffu),
                           max(u[2] & 0x7fffffffu, u[3] & 0x7fffffffu));
  float4 lo;
  if (big < 0x7f7ff000u) {
    float hi[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = __uint_as_float(rna_bits(u[e]));
      l[e] = __uint_as_float(rna_bits(__float_as_uint(__uint_as_float(u[e]) - hi[e])));
    }
    v = make_float4(hi[0], hi[1], hi[2], hi[3]);
    lo = make_float4(l[0], l[1], l[2], l[3]);
  } else {
    lo.x = split_lo(v.x);
    lo.y = split_lo(v.y);
    lo.z = split_lo(v.z);
    lo.w = split_lo(v.w);
  }
  return lo;
}

// Four consecutive stored elements, widened to fp32.
__device__ __forceinline__ float4 widen4(const unsigned char* p, Bf16) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // element 0 in the low half
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 widen4(const unsigned char* p, int8_t) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address >> 4 (bits 0-13), leading byte offset 1 (unused by
// a swizzled K-major layout), stride byte offset 1024 >> 4 between 8-row
// groups (bits 32-45), layout type 1 = 128-byte swizzle (bits 62-63).  The
// ring is 1024-byte aligned, so the base offset (bits 49-51) is 0; a k8 step
// (32 bytes) advances the start address by 2.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// acc (m64nNk8, tf32 x tf32 -> fp32); scale_d = 0 overwrites acc.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "the widths the kernels use");
  if constexpr (N == 64)
    wgmma_m64n64k8(d, da, db, scale_d);
  else
    wgmma_m64n128k8(d, da, db, scale_d);
}

}  // namespace tc

// The product of a BM x BN tile by two warpgroups laid out WM x (2 / WM):
// warpgroup g takes rows [64 (g / WN), +64) and columns [kWgN (g % WN),
// +kWgN) of the tile.  TB is B's storage type (float, Bf16 or int8_t).
template <int BM, int BN, int WM, typename TB>
struct Tf32x3Gemm {
  static constexpr int WN = 2 / WM;
  static constexpr int kWgN = BN / WN;
  static constexpr int kAcc = kWgN / 2;  // accumulators per thread
  static constexpr bool kSplitB = std::is_same<TB, float>::value;
  static constexpr int kABytes = BM * tc::kRowBytes;
  static constexpr int kBBytes = BN * tc::kRowBytes;
  static constexpr int kStageBytes = 2 * kABytes + 2 * kBBytes;
  // Stage layout: [A_hi | A_lo | B_hi | B_lo]; a bf16 / int8 B is staged raw
  // (row r's chunk c at (r * 8 + c) * 4 * sizeof(TB)) in B_lo's room.
  static constexpr int kALo = kABytes, kBHi = 2 * kABytes, kBLo = 2 * kABytes + kBBytes;
  static constexpr int kChunkB = 4 * static_cast<int>(sizeof(TB));  // bytes of 4 elements
  static constexpr int kRawBytes = kABytes + BN * tc::kBK * static_cast<int>(sizeof(TB));
  static constexpr int kCopiesA = BM * 8 / tc::kLoaders;
  static constexpr int kCopiesB = BN * 8 / tc::kLoaders;
  static_assert(WM == 1 || WM == 2, "two warpgroups");
  static_assert(BM / WM == 64, "wgmma takes 64 rows a warpgroup");
  static_assert(kCopiesA * tc::kLoaders == BM * 8 && kCopiesB * tc::kLoaders == BN * 8,
                "a stage splits evenly over the loader threads");
  static_assert(sizeof(TB) == 4 || kBBytes >= BN * 8 * kChunkB, "raw staging fits");

  // Where slice s's raw rows go: a raw stage of their own ([A fp32 | B in
  // its storage type]), or, in place, the operand stage they are split
  // into (A and an fp32 B over their hi halves, a bf16 / int8 B in B_lo's
  // room).
  static __device__ __forceinline__ unsigned char* raw_b(unsigned char* raw, bool in_place) {
    return raw + (in_place ? (kSplitB ? kBHi : kBLo) : kABytes);
  }

  // Loader thread lt copies its chunks of slice [k0, k0 + 32) of the tile's
  // rows: fp32 rows swizzled as the operand stage lays them out, a bf16 /
  // int8 B plainly (row r's chunk c at (r * 8 + c) * 4 * sizeof(TB)).
  static __device__ __forceinline__ void load(unsigned char* raw, bool in_place, int lt,
                                              const float* __restrict__ A, int rows_a,
                                              const TB* __restrict__ B, int rows_b, int d,
                                              int row0, int col0, int k0) {
    const uint32_t sa = tc::smem_addr(raw), sb = tc::smem_addr(raw_b(raw, in_place));
#pragma unroll
    for (int l = 0; l < kCopiesA; ++l) {
      const int q = lt + l * tc::kLoaders, r = q >> 3, c = q & 7;
      const int gr = row0 + r, gk = k0 + 4 * c;
      const bool ok = gr < rows_a && gk < d;
      tc::cp_async(sa + tc::swz(r, c), ok ? A + static_cast<size_t>(gr) * d + gk : A, 16, ok);
    }
#pragma unroll
    for (int l = 0; l < kCopiesB; ++l) {
      const int q = lt + l * tc::kLoaders, r = q >> 3, c = q & 7;
      const int gr = col0 + r, gk = k0 + 4 * c;
      const bool ok = gr < rows_b && gk < d;
      const TB* src = ok ? B + static_cast<size_t>(gr) * d + gk : B;
      if constexpr (kSplitB)
        tc::cp_async(sb + tc::swz(r, c), src, 16, ok);
      else
        tc::cp_async(sb + q * kChunkB, src, kChunkB, ok);
    }
  }

  // Loader thread lt splits (widens) the chunks it copied, once they have
  // landed, from `raw` into the operand stage `op` (raw == op in place).
  static __device__ __forceinline__ void convert(unsigned char* raw, bool in_place, int lt,
                                                 unsigned char* op) {
    const unsigned char* rb = raw_b(raw, in_place);
#pragma unroll
    for (int l = 0; l < kCopiesA; ++l) {
      const int q = lt + l * tc::kLoaders, off = tc::swz(q >> 3, q & 7);
      float4 v = *reinterpret_cast<const float4*>(raw + off);
      const float4 lo = tc::split4(v);
      *reinterpret_cast<float4*>(op + off) = v;
      *reinterpret_cast<float4*>(op + kALo + off) = lo;
    }
#pragma unroll
    for (int l = 0; l < kCopiesB; ++l) {
      const int q = lt + l * tc::kLoaders, off = tc::swz(q >> 3, q & 7);
      if constexpr (kSplitB) {
        float4 v = *reinterpret_cast<const float4*>(rb + off);
        const float4 lo = tc::split4(v);
        *reinterpret_cast<float4*>(op + kBHi + off) = v;
        *reinterpret_cast<float4*>(op + kBLo + off) = lo;
      } else {
        *reinterpret_cast<float4*>(op + kBHi + off) = tc::widen4(rb + q * kChunkB, TB{});
      }
    }
  }

  // Issue this warpgroup's products of the stage at `st` into acc (first:
  // overwrite acc rather than add to it), and commit them as one group.
  static __device__ __forceinline__ void mma(unsigned char* st, float (&acc)[kAcc], bool first) {
    const int g = threadIdx.x / 128;
    const uint32_t s = tc::smem_addr(st);
    const uint64_t a_hi = tc::desc(s + (g / WN) * 64 * tc::kRowBytes);
    const uint64_t a_lo = tc::desc(s + kALo + (g / WN) * 64 * tc::kRowBytes);
    const uint64_t b_hi = tc::desc(s + kBHi + (g % WN) * kWgN * tc::kRowBytes);
    const uint64_t b_lo = tc::desc(s + kBLo + (g % WN) * kWgN * tc::kRowBytes);
    tc::fence_operand(acc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < tc::kBK / 8; ++kk) {
      const uint64_t k = 2 * kk;  // 32 bytes, in the descriptor's 16-byte units
      tc::wgmma<kWgN>(acc, a_lo + k, b_hi + k, (first && kk == 0) ? 0 : 1);
      if constexpr (kSplitB) tc::wgmma<kWgN>(acc, a_hi + k, b_lo + k, 1);
      tc::wgmma<kWgN>(acc, a_hi + k, b_hi + k, 1);
    }
    tc::wgmma_commit();
    tc::fence_operand(acc);
  }

  // Tile row and column of this thread's accumulator i (wgmma's m64nN
  // layout: warp w of the warpgroup holds rows 16w .. 16w + 15, a quad of
  // lanes one row's columns in pairs).
  static __device__ __forceinline__ int row_of(int i) {
    const int t = threadIdx.x % 128, g = threadIdx.x / 128;
    return (g / WN) * 64 + (t / 32) * 16 + (t % 32) / 4 + 8 * ((i / 2) % 2);
  }
  static __device__ __forceinline__ int col_of(int i) {
    const int t = threadIdx.x % 128, g = threadIdx.x / 128;
    return (g % WN) * kWgN + 8 * (i / 4) + 2 * (t % 4) + (i % 2);
  }
};

// Index of element (r, c) of a finished [rows, 128] fp32 tile kept in a
// stage: row r at r * 128, its 16-byte chunk c / 4 at chunk (c / 4) ^ (r % 8).
// The float2 writes of an accumulator quad's eight rows then fall on
// distinct banks, and a warp reading 32 consecutive columns of a row reads
// one row's 128 bytes.
__device__ __forceinline__ int tile_index(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7))) << 2) + (c & 3);
}

// Shared-memory bytes of the walk's two operand stages and R raw stages
// (R = 0: the raw rows land in the operand stage), with the alignment slack.
template <typename G, int R>
__host__ __device__ constexpr size_t ring_bytes() {
  return 1024 + 2 * static_cast<size_t>(G::kStageBytes) + static_cast<size_t>(R) * G::kRawBytes;
}

// The ring's start in the dynamic shared memory, 1024-byte aligned.
__device__ __forceinline__ unsigned char* ring_base(void* smem) {
  const uint32_t a = tc::smem_addr(smem);
  return static_cast<unsigned char*>(smem) + ((1024 - (a & 1023)) & 1023);
}

namespace tc {
// Named barriers of the walk: operand stage i full (1 + i), empty (3 + i),
// and the consumers among themselves (5).
constexpr int kBarFull = 1, kBarEmpty = 3, kBarConsumers = 5;
__device__ __forceinline__ void consumers_sync() { bar_sync(kBarConsumers, kConsumers); }

// The role split of a kernel that walks with tc_load / tc_multiply: a
// warpgroup takes its role's registers (setmaxnreg; the two paths never
// rejoin).
__device__ __forceinline__ bool is_loader() { return threadIdx.x >= kConsumers; }
__device__ __forceinline__ void loader_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoaderRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// Operand stage s % 2 and raw stage s % R of the walk (R = 0: in place).
template <typename G, int R>
__device__ __forceinline__ unsigned char* op_stage(unsigned char* ring, int s) {
  return ring + (s & 1) * G::kStageBytes;
}
template <typename G, int R>
__device__ __forceinline__ unsigned char* raw_stage(unsigned char* ring, int s) {
  if constexpr (R == 0)
    return op_stage<G, R>(ring, s);
  else
    return ring + 2 * G::kStageBytes + (s % R) * G::kRawBytes;
}
}  // namespace tc

// The walk of a CTA over `n_tiles` output tiles of `kslices` d slices each,
// warp-specialised.  The loader warpgroups (threads 256-511) copy slice
// s + R ahead into the raw ring and split slice s into operand stage s % 2
// once the consumers have released it (tc_load); the two consumer
// warpgroups (threads 0-255) multiply each operand stage as it fills, one
// product group queued behind the next (tc_multiply).  Named barriers hand
// the two operand stages back and forth; the roles never meet otherwise.
//
// load(s, raw, in_place, lt) issues slice s's copies (tile s / kslices) for
// loader thread lt.
template <typename G, int R, typename Load>
__device__ __forceinline__ void tc_load(unsigned char* ring, int n_tiles, int kslices,
                                        Load&& load) {
  constexpr bool kInPlace = R == 0;
  const int total = n_tiles * kslices;
  const int lt = threadIdx.x - tc::kConsumers;
  if constexpr (!kInPlace) {
#pragma unroll
    for (int p = 0; p < R; ++p) {
      if (p < total) load(p, tc::raw_stage<G, R>(ring, p), false, lt);
      tc::cp_async_commit();
    }
  }
  for (int s = 0; s < total; ++s) {
    unsigned char* raw = tc::raw_stage<G, R>(ring, s);
    if (s >= 2) tc::bar_sync(tc::kBarEmpty + (s & 1), tc::kThreads);  // slice s - 2 released
    if constexpr (kInPlace) {
      load(s, raw, true, lt);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
    } else {
      tc::cp_async_wait<(kInPlace ? 0 : R - 1)>();  // slice s has landed
    }
    G::convert(raw, kInPlace, lt, tc::op_stage<G, R>(ring, s));
    tc::fence_proxy_async();
    if constexpr (!kInPlace) {  // this thread's chunks of the raw stage are split: refill them
      if (s + R < total) load(s + R, raw, false, lt);
      tc::cp_async_commit();
    }
    tc::bar_arrive(tc::kBarFull + (s & 1), tc::kThreads);
  }
}

// The consumers' side.  Each slice's product starts from zero on the tensor
// cores and is then added to the tile's sum in registers: the tensor cores
// add each k8 step into the accumulator with a rounding that does not
// average out, about half an ulp of the accumulator a step, so a running
// accumulator of a long dot product (96 steps of d = 256 in three passes)
// drifts by about 48 ulps of its size -- 1.5e-3 on a distance of 5.8 whose
// dot product is near 256 (the k-means pass of chip_smoke.py's IVF phase),
// past the checks' 1e-3.  Restarting every slice bounds the drift by the
// slice's own sum (12 steps) and leaves the rest to fp32 adds rounded to
// nearest.  The price is the queue: a slice's product is issued once the
// previous one has been added in.  (Two accumulators taking even and odd
// slices, to keep one product queued behind the other, made ptxas
// serialise every wgmma -- C7514 -- and ran slower still.)
//
// pre(t) runs beside tile t's last product (to load
// what the epilogue needs besides the accumulators); epi(t, acc, stage) runs
// after that product and may write its operand stage as scratch.  after(t, kq, stage)
// then runs once beside each of tile t + 1's products (kq = 0 .. kslices-1,
// stage = the one epi wrote), so its work may be spread over them; that
// stage goes back to the loaders once after(t, 0, ...) is done.
template <typename G, int R, typename Pre, typename Epi, typename After>
__device__ __forceinline__ void tc_multiply(unsigned char* ring, int n_tiles, int kslices,
                                            Pre&& pre, Epi&& epi, After&& after) {
  const int total = n_tiles * kslices;
  float acc[G::kAcc];  // the product of one slice, on the tensor cores
  float sum[G::kAcc];  // the tile's sum of them, in fp32 adds rounded to nearest
  int s = 0;           // the slice being multiplied, over the whole stream
  for (int t = 0; t < n_tiles; ++t) {
    for (int kq = 0; kq < kslices; ++kq, ++s) {
      tc::bar_sync(tc::kBarFull + (s & 1), tc::kThreads);
      if (kq > 0) {  // fold slice s - 1's product into the tile's sum
        tc::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < G::kAcc; ++i) sum[i] = kq == 1 ? acc[i] : sum[i] + acc[i];
      }
      G::mma(tc::op_stage<G, R>(ring, s), acc, true);
      if (t > 0) after(t - 1, kq, tc::op_stage<G, R>(ring, s - kq - 1));
      if (kq == kslices - 1) pre(t);
      if (s >= 1 && s + 1 < total)  // slice s - 1's product is done: release its stage
        tc::bar_arrive(tc::kBarEmpty + ((s + 1) & 1), tc::kThreads);
    }
    tc::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < G::kAcc; ++i) sum[i] = kslices == 1 ? acc[i] : sum[i] + acc[i];
    tc::consumers_sync();  // both warpgroups' products have read the stage
    epi(t, sum, tc::op_stage<G, R>(ring, s - 1));
    tc::consumers_sync();
  }
  if (n_tiles > 0) {
    for (int kq = 0; kq < kslices; ++kq)
      after(n_tiles - 1, kq, tc::op_stage<G, R>(ring, total - 1));
    tc::consumers_sync();
  }
}

}  // namespace repro
