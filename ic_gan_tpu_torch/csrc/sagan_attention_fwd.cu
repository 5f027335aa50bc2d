// SA-GAN attention forward for Hopper (sm_90a): o = softmax(theta . phi^T) . g
//
// Replaces the TPU kernel ic_gan_tpu/ops/pallas/attention.py:_attn_kernel
// (launched by _attention_fwd_impl).  Same function: unscaled, non-causal,
// f32 logits, f32 row max and row sum, p cast to g's type before the second
// product, f32 accumulation, one divide by the row sum at the end, output in
// g's type.  theta (N, Lq, d), phi (N, Lk, d), g (N, Lk, dv), all contiguous,
// bf16 or f32; d <= 128, dv <= 256, any Lq and Lk (the ragged edge is masked
// here).  On request it also writes each row's log-sum-exp m + log(l) in f32,
// (N, Lq): the backward's softmax statistics.
//
// Bound on the H100 at the 256^2 generator's shape (N 128, Lq 4096, Lk 1024,
// d 48, dv 192, bf16): 2*N*Lq*Lk*(d+dv) = 257.7 GFLOP against ~314 MB moved,
// about 820 FLOP per byte, far above the card's ~295 FLOP/byte ridge: the
// work is bound by operations (0.26 ms at the 989 TFLOP/s bf16 tensor-core
// peak, 0.094 ms for the bytes at 3.35 TB/s).
//
// Design.  The TPU kernel keeps a whole (512, Lk) f32 logit tile in VMEM and
// takes an exact one-shot softmax.  A Hopper block has at most 227 KB of
// shared memory and blocks run in parallel with nothing carried between
// them, so one block owns one (sample, query tile), streams phi and g
// through shared memory in 64-key tiles and keeps an online softmax (running
// max and sum per row, f32 accumulators rescaled when the max moves).  The
// logits never reach device memory.
//
// bf16 (sagan_attention_fwd_mma): Hopper's warpgroup MMA.  A block is two to
// four warpgroups (4 warps each) of 64 query rows, as many as the registers
// let share an SM, and they share every key tile: the streamed bytes, not
// the products, bound this kernel, and they fall with the rows a block owns.
// theta's tile stays in shared memory as bf16; phi and g stream through a
// three-slot ring filled by cp.async, two tiles ahead.  S = theta .
// phi^T is a wgmma (m64n64k16, both operands from shared memory, f32
// accumulation); bf16 x bf16 products are exact in f32, so the logits match
// the plain version's up to summation order.  The online softmax runs on
// S's accumulator fragments: row max by quad shuffles, the row sum kept per
// thread and reduced once at the end, the accumulators rescaled only when a
// row's max moved.  p is rounded to bf16 in registers, as the TPU kernel's
// p.astype(g.dtype), and O += P . g is a wgmma with P straight from S's
// registers and g's tile read transposed from shared memory.  The
// k-dimension is zero-padded in shared memory to a multiple of 16 (d 24 ->
// 32 at the 128^2 model's widths), and rows that are not 16-byte aligned
// (d % 8 != 0) are copied element by element.  The output width is a
// template parameter (the 64 x dv f32 accumulator: 96 registers a thread at
// dv 192); d is a loop bound.  The output is staged through shared memory
// and written 16 bytes a thread.
//
// f32 (sagan_attention_fwd_kernel): CUDA-core FP32 FMAs, 16x16 threads each
// owning 4 query rows; no TF32, so the f32 result keeps full precision.
//
// Rounding differs from the TPU kernel in one place on either path: p is
// rounded against the running max rather than the final one, which stays
// within bf16 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "attention_mma.cuh"

namespace {

using attn_mma::bf16;
constexpr int MAX_D = 128;
constexpr int MAX_DV = 256;
constexpr float LOG2E = 1.4426950408889634f;

// --- bf16: tensor cores -------------------------------------------------------

constexpr int MMA_BK = 64;     // keys per streamed tile
constexpr int MMA_STAGES = 3;  // tiles in the ring: two loading while one computes

// A block is WGS warpgroups of 64 query rows sharing each streamed key
// tile, as many as the registers allow beside each other on one SM.
template <int DVP>
struct FwdShape {
  static constexpr int WGS = DVP <= 96 ? 4 : DVP <= 192 ? 3 : 2;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int BQ = 64 * WGS;
};

__host__ __device__ __forceinline__ size_t mma_smem_elems(int bq, int dp, int dvp) {
  return (size_t)bq * dp + MMA_STAGES * (size_t)MMA_BK * (dp + dvp);
}

// DVP: the output width, dv padded to a multiple of 32.
template <int DVP>
__global__ void __launch_bounds__(FwdShape<DVP>::THREADS)
sagan_attention_fwd_mma(const bf16* __restrict__ theta, const bf16* __restrict__ phi,
                        const bf16* __restrict__ g, bf16* __restrict__ out,
                        float* __restrict__ lse, int Lq, int Lk, int d, int dv) {
  using namespace attn_mma;
  constexpr int THREADS = FwdShape<DVP>::THREADS, BQ = FwdShape<DVP>::BQ;
  const int dp = round16(d);
  extern __shared__ uint4 smem_u4[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_u4);  // BQ x dp, blocked
  bf16* s_k = s_q + BQ * dp;                     // STAGES x BK x dp
  bf16* s_v = s_k + MMA_STAGES * MMA_BK * dp;    // STAGES x BK x DVP

  // Warp w owns rows 16w..16w+15 of the block: the 64 rows of its
  // warpgroup w / 4 start at 64 (w / 4).
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.y, q0 = blockIdx.x * BQ;
  const bf16* theta_n = theta + (size_t)n * Lq * d;
  const bf16* phi_n = phi + (size_t)n * Lk * d;
  const bf16* g_n = g + (size_t)n * Lk * dv;
  const int n_tiles = (Lk + MMA_BK - 1) / MMA_BK;
  auto load_keys = [&](int t) {
    if (t < n_tiles) {
      const int slot = t % MMA_STAGES;
      load_tile<THREADS>(s_k + slot * MMA_BK * dp, dp, phi_n, t * MMA_BK, MMA_BK, Lk, d);
      load_tile<THREADS>(s_v + slot * MMA_BK * DVP, DVP, g_n, t * MMA_BK, MMA_BK, Lk, dv);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };

  zero_cols<THREADS>(s_q, dp, BQ, d);
  zero_cols<THREADS>(s_k, dp, MMA_STAGES * MMA_BK, d);
  zero_cols<THREADS>(s_v, DVP, MMA_STAGES * MMA_BK, dv);
  load_tile<THREADS>(s_q, dp, theta_n, q0, BQ, Lq, d);
  for (int t = 0; t < MMA_STAGES - 1; ++t) load_keys(t);

  float o[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the warp

  for (int t = 0; t < n_tiles; ++t) {
    load_keys(t + MMA_STAGES - 1);
    cp_async_wait<MMA_STAGES - 1>();  // tile t has landed
    fence_proxy_async();
    __syncthreads();
    const bf16* kt = s_k + (t % MMA_STAGES) * MMA_BK * dp;
    const bf16* vt = s_v + (t % MMA_STAGES) * MMA_BK * DVP;

    // S = theta . phi^T: the warpgroup's 64 rows x 64 keys.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    keep(s);
    gmma_fence();
    for (int ks = 0; ks < dp / 16; ++ks)
      Gmma<64, 0>::ss(s, desc_k(s_q, dp, 64 * (warp >> 2), ks), desc_k(kt, dp, 0, ks), 1);
    gmma_commit();
    gmma_wait<0>();
    keep(s);
    const int k0 = t * MMA_BK;
    if (k0 + MMA_BK > Lk) {  // the ragged last tile: keys past Lk get -inf
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1) >= Lk) s[i] = -INFINITY;
    }

    // Online softmax on the fragments.  Every tile holds at least one real
    // key, so the new max is finite; on the first tile m is -inf and alpha 0.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = s[2 * r];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2_approx((m[r] - m_new) * LOG2E);
      const float ms = m_new * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], LOG2E, -ms));
          sum += s[4 * j + e];  // the row sum keeps f32 p; the product sees bf16 p
        }
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
    // Rescale the accumulators only when some row's max moved.
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    }

    // O += P . g: P (bf16) from S's registers, g as the MN-major B.
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* c = &s[4 * (2 * kk + h) + 2 * r];
          a[kk][2 * h + r] = pack_bf16(c[0], c[1]);
        }
    keep(o);
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) gmma_rs_cols<DVP>(o, a[kk], vt, DVP, kk);
    gmma_commit();
    gmma_wait<0>();
    keep(o);
    keep(a);
    __syncthreads();  // tile t is consumed before its slot is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // shared memory is free: it stages the output

  // Normalize, round to bf16 and stage each warpgroup's rows row-major in
  // shared memory (stride dv + 8: the quads of a store land in distinct
  // banks), then copy them out 16 bytes a thread, so that the writes to
  // device memory are whole lines.  Rows past Lq are staged but not copied.
  bf16* out_n = out + (size_t)n * Lq * dv;
  const int lds = dv + 8;
  bf16* stage = s_q;  // BQ x lds, over theta's tile and the ring
  const bool vec = (dv & 7) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                   (size_t)BQ * lds <= mma_smem_elems(BQ, dp, DVP);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int lrow = warp * 16 + (lane >> 2) + 8 * r, row = q0 + lrow;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j)
      store_pair(vec ? stage + lrow * lds : out_n + (size_t)row * dv, 8 * j + 2 * (lane & 3),
                 vec || row < Lq ? dv : 0, o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0 && row < Lq)
      lse[(size_t)n * Lq + row] = m[r] + logf(l[r]);
  }
  if (vec) {
    __syncthreads();
    const int cw = dv >> 3, rows = min(BQ, Lq - q0);
    for (int idx = tid; idx < rows * cw; idx += THREADS) {
      const int r = idx / cw, c = (idx - r * cw) << 3;
      *reinterpret_cast<uint4*>(out_n + (size_t)(q0 + r) * dv + c) =
          *reinterpret_cast<const uint4*>(stage + r * lds + c);
    }
  }
}

template <int DVP>
cudaError_t launch_mma(const void* theta, const void* phi, const void* g, void* out,
                       float* lse, int N, int Lq, int Lk, int d, int dv, cudaStream_t stream) {
  using S = FwdShape<DVP>;
  const size_t smem = sizeof(bf16) * mma_smem_elems(S::BQ, attn_mma::round16(d), DVP);
  auto kernel = sagan_attention_fwd_mma<DVP>;
  cudaError_t err = attn_mma::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + S::BQ - 1) / S::BQ, N);
  kernel<<<grid, S::THREADS, smem, stream>>>(
      static_cast<const bf16*>(theta), static_cast<const bf16*>(phi),
      static_cast<const bf16*>(g), static_cast<bf16*>(out), lse, Lq, Lk, d, dv);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* theta, const void* phi, const void* g, void* out,
                         float* lse, int N, int Lq, int Lk, int d, int dv,
                         cudaStream_t stream) {
  if (dv <= 32) return launch_mma<32>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
  if (dv <= 64) return launch_mma<64>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
  if (dv <= 96) return launch_mma<96>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
  if (dv <= 128) return launch_mma<128>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
  if (dv <= 192) return launch_mma<192>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
  return launch_mma<256>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
}

// --- f32: CUDA-core FMAs ----------------------------------------------------------

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per streamed tile
constexpr int THREADS = 256;     // 16 x 16 threads
constexpr int RPT = BQ / 16;     // query rows per thread
constexpr int KPT = BK / 16;     // keys per thread in the logit tile
constexpr int LDP = BK + 4;      // padded row stride of the p tile

__device__ __forceinline__ float row_max16(float v) {
  // The 16 threads of one row group are one half-warp (lanes differ in tx only).
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NC: dv columns per thread, 16 apart (dv <= 16 * NC).
template <int NC>
__global__ void __launch_bounds__(THREADS)
sagan_attention_fwd_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
                           const float* __restrict__ g, float* __restrict__ out,
                           float* __restrict__ lse, int Lq, int Lk, int d, int dv) {
  extern __shared__ float smem[];
  const int ldq = d + 1;         // odd strides: column walks hit distinct banks
  const int ldg = 16 * NC;       // g rows zero-padded to the thread layout
  float* s_theta = smem;                 // BQ x ldq
  float* s_phi = s_theta + BQ * ldq;     // BK x ldq
  float* s_g = s_phi + BK * ldq;         // BK x ldg
  float* s_p = s_g + BK * ldg;           // BQ x LDP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* theta_n = theta + (size_t)n * Lq * d;
  const float* phi_n = phi + (size_t)n * Lk * d;
  const float* g_n = g + (size_t)n * Lk * dv;
  float* out_n = out + (size_t)n * Lq * dv;

  for (int idx = tid; idx < BQ * d; idx += THREADS) {
    const int r = idx / d, c = idx - r * d;
    s_theta[r * ldq + c] = (q0 + r < Lq) ? theta_n[(size_t)(q0 + r) * d + c] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; theta is stored
    for (int idx = tid; idx < BK * d; idx += THREADS) {
      const int k = idx / d, c = idx - k * d;
      s_phi[k * ldq + c] = (k0 + k < Lk) ? phi_n[(size_t)(k0 + k) * d + c] : 0.f;
    }
    for (int idx = tid; idx < BK * ldg; idx += THREADS) {
      const int k = idx / ldg, c = idx - k * ldg;
      s_g[idx] = (k0 + k < Lk && c < dv) ? g_n[(size_t)(k0 + k) * dv + c] : 0.f;
    }
    __syncthreads();

    // Logit tile: rows ty*RPT + i, keys tx + 16*j.
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[RPT], b[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = s_theta[(ty * RPT + i) * ldq + c];
#pragma unroll
      for (int j = 0; j < KPT; ++j) b[j] = s_phi[(tx + 16 * j) * ldq + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j)
      if (k0 + tx + 16 * j >= Lk)
#pragma unroll
        for (int i = 0; i < RPT; ++i) s[i][j] = -INFINITY;

    // Online softmax.  Every tile holds at least one real key, so the new
    // max is finite; on the first tile m is -inf and alpha is 0.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float tmax = s[i][0];
#pragma unroll
      for (int j = 1; j < KPT; ++j) tmax = fmaxf(tmax, s[i][j]);
      const float m_new = fmaxf(m[i], row_max16(tmax));
      const float alpha = expf(m[i] - m_new);
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        tsum += p;
        s_p[(ty * RPT + i) * LDP + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(tsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p . g over this tile's real keys.
    const int kmax = min(BK, Lk - k0);
    for (int k = 0; k < kmax; ++k) {
      float pv[RPT], gv[NC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = s_p[(ty * RPT + i) * LDP + k];
#pragma unroll
      for (int j = 0; j < NC; ++j) gv[j] = s_g[k * ldg + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], gv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    if (r >= Lq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c < dv) out_n[(size_t)r * dv + c] = acc[i][j] / l[i];
    }
    if (lse != nullptr && tx == 0) lse[(size_t)n * Lq + r] = m[i] + logf(l[i]);
  }
}

template <int NC>
cudaError_t launch(const void* theta, const void* phi, const void* g, void* out, float* lse,
                   int N, int Lq, int Lk, int d, int dv, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (d + 1) + (size_t)BK * 16 * NC + (size_t)BQ * LDP);
  auto kernel = sagan_attention_fwd_kernel<NC>;
  cudaError_t err = attn_mma::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BQ - 1) / BQ, N);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(theta),
                                          static_cast<const float*>(phi),
                                          static_cast<const float*>(g), static_cast<float*>(out),
                                          lse, Lq, Lk, d, dv);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* theta, const void* phi, const void* g, void* out,
                         float* lse, int N, int Lq, int Lk, int d, int dv,
                         cudaStream_t stream) {
  const int nc = (dv + 15) / 16;
  if (nc <= 1) return launch<1>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
  if (nc <= 2) return launch<2>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
  if (nc <= 4) return launch<4>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
  if (nc <= 6) return launch<6>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
  if (nc <= 8) return launch<8>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
  if (nc <= 12) return launch<12>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
  return launch<16>(theta, phi, g, out, lse, N, Lq, Lk, d, dv, stream);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  lse is an
// (N, Lq) f32 output, or null when the caller does not need it.  Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream` and
// allocates nothing.
extern "C" int sagan_attention_fwd(const void* theta, const void* phi, const void* g,
                                   void* out, void* lse, int N, int Lq, int Lk, int d, int dv,
                                   int dtype, void* stream) {
  if (N <= 0 || N > 65535 || Lq <= 0 || Lk <= 0 || d <= 0 || d > MAX_D || dv <= 0 ||
      dv > MAX_DV)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return (int)dispatch_f32(theta, phi, g, out, l, N, Lq, Lk, d, dv, s);
  if (dtype == 1) return (int)dispatch_mma(theta, phi, g, out, l, N, Lq, Lk, d, dv, s);
  return (int)cudaErrorInvalidValue;
}
