// Building blocks of the SA-GAN attention kernels' bf16 tensor-core paths
// on Hopper (sm_90a): the warpgroup matrix multiply wgmma.mma_async
// (m64nNk16, bf16 operands, f32 accumulators) with its shared-memory matrix
// descriptors, 16-byte cp.async with commit and wait groups, and tile
// loaders into the layout wgmma reads.
//
// A block of these kernels is one warpgroup (128 threads, 4 warps) that owns
// 64 rows.  wgmma's f32 accumulator of a 64 x N product gives warp w rows
// 16w..16w+15; with g = lane / 4 and t = lane % 4, d[4j + e] holds
// (row 16w + g + 8 (e / 2), column 8j + 2t + e % 2): the mma.m16n8k16 C
// layout, once per 8-column tile.  Packed to bf16, the accumulators of 16
// columns are the A fragment of a register-sourced wgmma over those 16 as
// its k: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..).  That is
// the FlashAttention register handoff of p and ds, with no trip through
// shared memory.
//
// Shared tiles use wgmma's no-swizzle layout: 8 x 8 "core matrices" of 8
// rows of 16 bytes stored as 128 contiguous bytes, so an R x C bf16 tile is
// blocked [R/8][C/8][8][8] (blk below).  One tile serves as a K-major
// operand (its rows are M or N, its columns K) and as an MN-major one (its
// rows are K, its columns N, read transposed).  In the descriptor the
// leading byte offset is the stride between core matrices along K and the
// stride byte offset the stride along M or N, for either major-ness.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_mma {

using bf16 = __nv_bfloat16;

// --- PTX primitives ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy writes to shared memory (stores and
// cp.async) visible to wgmma, which reads through the async proxy.  Called
// by every writer before the barrier that precedes the wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x by the special-function unit (ex2.approx.ftz: about 2 ulp, 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Order register writes before the wgmma that reads them (its A fragments
// and accumulators).
__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may neither move their uses across this point nor reuse them before it.
template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void keep(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (64 x N f32, N/2 a thread) += A . B, asynchronously.  ss: A and B from
// shared-memory descriptors (A K-major), for the N the kernels use; rs: A
// from registers.  TB = 1 reads B MN-major (transposed).  scale_d = 0
// ignores d's old value.
template <int N, int TB>
struct Gmma;

template <int TB>
struct Gmma<16, TB> {
  __device__ __forceinline__ static void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct Gmma<32, TB> {
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  __device__ __forceinline__ static void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct Gmma<48, TB> {
  __device__ __forceinline__ static void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct Gmma<64, TB> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

// --- layouts and operands ---------------------------------------------------------

// Two f32 values rounded to bf16 (nearest even) in one register, lo in the
// low half: the element with the smaller column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x - bf16(x) for both halves of a pair packed by pack_bf16, itself packed:
// the low part of a two-term bf16 split, x ~ hi + lo to about 2^-17 of x.
__device__ __forceinline__ uint32_t pack_bf16_lo(float lo, float hi, uint32_t packed) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&packed);
  return pack_bf16(lo - __low2float(v), hi - __high2float(v));
}

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// Element offset of (r, c) in a blocked tile of C columns (C % 8 == 0).
__host__ __device__ __forceinline__ int blk(int r, int c, int C) {
  return (((r >> 3) * (C >> 3) + (c >> 3)) << 6) + ((r & 7) << 3) + (c & 7);
}

__device__ __forceinline__ uint64_t gmma_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// K-major view of a blocked tile of C columns: rows from r0 (a multiple of
// 8) as M or N, columns [16 ks, 16 ks + 16) as K.
__device__ __forceinline__ uint64_t desc_k(const bf16* t, int C, int r0, int ks) {
  return gmma_desc(t + blk(r0, 16 * ks, C), 128, 16 * C);
}

// MN-major view: rows [16 ks, 16 ks + 16) as K, columns from c0 (a multiple
// of 8) as N.
__device__ __forceinline__ uint64_t desc_mn(const bf16* t, int C, int ks, int c0) {
  return gmma_desc(t + blk(16 * ks, c0, C), 16 * C, 128);
}

// acc (64 x NC f32) += A . B over one k-step: A from registers, B the
// MN-major view of the blocked tile t (C columns) at k-step ks, columns
// [0, NC); in wgmma calls of 64 columns and one of the rest.
template <int NC>
__device__ __forceinline__ void gmma_rs_cols(float (&acc)[NC / 2], const uint32_t (&a)[4],
                                             const bf16* t, int C, int ks) {
  static_assert(NC % 16 == 0, "columns come in 16s");
#pragma unroll
  for (int c0 = 0; c0 + 64 <= NC; c0 += 64)
    Gmma<64, 1>::rs(*reinterpret_cast<float(*)[32]>(&acc[c0 / 2]), a, desc_mn(t, C, ks, c0), 1);
  constexpr int REM = NC % 64;
  if constexpr (REM > 0)
    Gmma<REM, 1>::rs(*reinterpret_cast<float(*)[REM / 2]>(&acc[(NC - REM) / 2]), a,
                     desc_mn(t, C, ks, NC - REM), 1);
}

// Rows [r0, r0 + rows) of the row-major (L, w) bf16 matrix `src` into the
// blocked tile `s` of C columns, columns [0, w); rows % 8 == 0.  Rows past L
// are zeroed.  Rows of 16-byte-aligned data (w % 8 == 0 and an aligned base)
// go by cp.async in the caller's current group; otherwise the elements are
// copied by plain loads and stores.  Columns [w, C) are the caller's to zero
// once (zero_cols).
template <int THREADS>
__device__ __forceinline__ void load_tile(bf16* s, int C, const bf16* __restrict__ src, int r0,
                                          int rows, int L, int w) {
  const int tid = threadIdx.x;
  if ((w & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // Eight lanes in a row take the 8 rows of one 16-byte column, so each
    // eight fill one 128-byte core matrix and a warp's writes hit every bank
    // once.  The (row group, column) pairs advance THREADS / 8 at a time,
    // without a division per chunk.
    constexpr int STEP = THREADS / 8;
    const int cw = w >> 3, rr = tid & 7;
    int grp = (tid >> 3) / cw, c = (tid >> 3) - grp * cw;
    while (grp < (rows >> 3)) {
      const int r = 8 * grp + rr;
      bf16* dst = s + blk(r, 8 * c, C);
      if (r0 + r < L)
        cp_async16(dst, src + (size_t)(r0 + r) * w + 8 * c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      for (c += STEP; c >= cw; c -= cw) ++grp;
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int idx = tid; idx < rows * w; idx += THREADS) {
      const int r = idx / w, c = idx - r * w;
      s[blk(r, c, C)] = (r0 + r < L) ? src[(size_t)(r0 + r) * w + c] : zero;
    }
  }
}

// Columns c and c + 1 (c even) of a row of w bf16 values: one 4-byte store
// where both lie in the row and w is even, else one store each.
__device__ __forceinline__ void store_pair(bf16* row, int c, int w, float x0, float x1) {
  if (c + 1 < w && (w & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < w) row[c] = __float2bfloat16(x0);
    if (c + 1 < w) row[c + 1] = __float2bfloat16(x1);
  }
}

// Zero columns [w, C) of `rows` rows of a blocked tile: the padding of the
// k-dimension to wgmma's multiple of 16, or of a width to its template's.
template <int THREADS>
__device__ __forceinline__ void zero_cols(bf16* s, int C, int rows, int w) {
  const int pad = C - w;
  if (pad <= 0) return;
  const bf16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < rows * pad; idx += THREADS) {
    const int r = idx / pad;
    s[blk(r, w + (idx - r * pad), C)] = zero;
  }
}

// Let `kernel` take `smem` bytes of dynamic shared memory, and ask for the
// largest shared-memory carveout so that as many blocks as fit run on an SM
// (the default split may leave room for fewer).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace attn_mma
