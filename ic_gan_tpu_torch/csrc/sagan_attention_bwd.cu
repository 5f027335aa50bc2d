// SA-GAN attention backward for Hopper (sm_90a): dtheta, dphi, dg of
// o = softmax(theta . phi^T) . g for an output gradient do.
//
// Replaces the TPU kernel ic_gan_tpu/ops/pallas/attention.py:_attn_bwd_kernel
// (launched by _attention_bwd_impl behind the custom_vjp).  Same function:
// unscaled logits in f32, the exact softmax p in f32, dp = do . g^T,
// ds = p * (dp - rowsum(dp * p)), dtheta = ds . phi, dphi = ds^T . theta,
// dg = p^T . do, every sum in f32, each gradient stored in its input's type.
// theta (N, Lq, d), phi (N, Lk, d), g (N, Lk, dv), do (N, Lq, dv), all
// contiguous, bf16 or f32; d <= 128, dv <= 256, any Lq and Lk (the ragged
// edges are masked here).
//
// Bound on the H100 at the 256^2 training step's G shape (N 32, Lq 4096,
// Lk 1024, d 48, dv 192, bf16): 2*N*Lq*Lk*(3d + 2dv) = 141.7 GFLOP against
// ~107 MB moved, so it is bound by operations (0.143 ms at the 989 TFLOP/s
// bf16 tensor-core peak, 0.032 ms for the bytes at 3.35 TB/s).
//
// Design.  The TPU kernel walks the q-tiles of one sample in sequence and
// adds each tile's dphi and dg into one revisited output block; that is safe
// only because a TPU grid runs in order.  CUDA blocks run concurrently, so
// the work is split in two passes, neither with atomics:
//   q-tile pass, one block per (sample, 64 queries): theta and do stay in
//     shared memory while phi and g stream through in 64-key tiles.  A first
//     sweep keeps each row's running max, sum and sum of e * dp (rescaled
//     like the sum, as an online softmax does), giving the row's log-sum-exp
//     and delta = rowsum(dp * p).  A second sweep recomputes the logits and
//     dp, forms ds exactly and accumulates dtheta in registers.  It writes
//     dtheta and the (N, Lq) f32 log-sum-exp and delta.
//   k-tile pass, one block per (sample, 64 keys): phi and g stay in shared
//     memory while theta, do and the row statistics stream through in
//     32-query tiles.  p is recomputed from the saved log-sum-exp, ds from p,
//     dp and delta, and dphi = sum ds^T theta and dg = sum p^T do accumulate
//     in registers over all the query tiles, then are written once.
// The logits, p and ds never reach device memory.  Delta is rowsum(dp * p)
// as the TPU kernel forms it, not the rowsum(do * o) shortcut, so no
// forward output is saved.  This first version does its arithmetic with
// CUDA-core FP32 FMAs: 2*N*Lq*Lk*(5d + 4dv) in all, the logits and dp twice
// in the q-tile pass and once more in the k-tile pass, so it cannot beat
// ~4.0 ms at the 67 TFLOP/s FP32 peak at the shape above; mma/wgmma
// tensor-core tiles are the next step toward the bound.  Inputs of either
// type are widened to f32 as they are loaded into shared memory (a runtime
// flag, so each pass is compiled once per register layout).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int BQ = 64;         // q-tile pass: query rows per block
constexpr int BK = 64;         // keys per tile: streamed (q pass), per block (k pass)
constexpr int BQK = 32;        // k-tile pass: query rows per streamed tile
constexpr int RPT = 4;         // rows a thread owns: queries (q pass), keys (k pass)
constexpr int KPT = BK / 16;   // q pass: keys a thread owns in the logit tile
constexpr int QPT = BQK / 16;  // k pass: queries a thread owns in the logit tile
constexpr int LDS = BK + 1;    // row stride of the p and ds tiles
constexpr int MAX_D = 128;
constexpr int MAX_DV = 256;

__device__ __forceinline__ float load_elem(const void* p, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_elem(void* p, size_t i, float v, bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);  // round to nearest even
  else
    static_cast<float*>(p)[i] = v;
}

// Rows [r0, r0 + rows) of the (L, w) matrix at element offset `base` of src,
// widened to f32 into s[r * ld + c] for c < fill; zero past L and past w.
__device__ __forceinline__ void load_tile(float* s, int ld, int fill, const void* src,
                                          size_t base, int r0, int rows, int L, int w,
                                          bool bf16) {
  for (int idx = threadIdx.x; idx < rows * fill; idx += THREADS) {
    const int r = idx / fill, c = idx - r * fill;
    s[r * ld + c] =
        (r0 + r < L && c < w) ? load_elem(src, base + (size_t)(r0 + r) * w + c, bf16) : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float v) {
  // The 16 threads of one row group are one half-warp (lanes differ in tx only).
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Odd row strides: a column walk by the 16 lanes of a half-warp hits 16 banks.
__host__ __device__ __forceinline__ int odd(int x) { return x | 1; }

__host__ __device__ __forceinline__ size_t q_pass_floats(int d, int dv, int nd) {
  return (size_t)BQ * odd(d) + (size_t)BQ * odd(dv) + (size_t)BK * (16 * nd + 1) +
         (size_t)BK * odd(dv) + (size_t)BQ * LDS;
}

__host__ __device__ __forceinline__ size_t k_pass_floats(int d, int dv, int nd, int nc) {
  return (size_t)BK * odd(d) + (size_t)BK * odd(dv) + (size_t)BQK * (16 * nd + 1) +
         (size_t)BQK * (16 * nc + 1) + 2 * (size_t)BQK * LDS + 2 * (size_t)BQK;
}

// Stream one key tile of phi and g into shared memory, between barriers.
__device__ __forceinline__ void load_keys(float* s_phi, float* s_g, int ldp, int ldv,
                                          const void* phi, const void* g, size_t bk, int k0,
                                          int Lk, int d, int dv, int fill_phi, bool bf16) {
  __syncthreads();  // the previous tile is consumed
  load_tile(s_phi, ldp, fill_phi, phi, bk * d, k0, BK, Lk, d, bf16);
  load_tile(s_g, ldv, dv, g, bk * dv, k0, BK, Lk, dv, bf16);
  __syncthreads();
}

// q-tile pass: logits s and dp of the thread's query rows ty*RPT + i against
// keys tx + 16*j of the resident key tile; -inf logits for keys past Lk.
__device__ __forceinline__ void q_tile_products(float (&s)[RPT][KPT], float (&dp)[RPT][KPT],
                                                const float* s_theta, const float* s_do,
                                                const float* s_phi, const float* s_g,
                                                int ldq, int ldv, int ldp, int d, int dv,
                                                int k0, int Lk, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int c = 0; c < d; ++c) {
    float a[RPT], b[KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = s_theta[(ty * RPT + i) * ldq + c];
#pragma unroll
    for (int j = 0; j < KPT; ++j) b[j] = s_phi[(tx + 16 * j) * ldp + c];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
  for (int c = 0; c < dv; ++c) {
    float a[RPT], b[KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = s_do[(ty * RPT + i) * ldv + c];
#pragma unroll
    for (int j = 0; j < KPT; ++j) b[j] = s_g[(tx + 16 * j) * ldv + c];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) dp[i][j] = fmaf(a[i], b[j], dp[i][j]);
  }
#pragma unroll
  for (int j = 0; j < KPT; ++j)
    if (k0 + tx + 16 * j >= Lk)
#pragma unroll
      for (int i = 0; i < RPT; ++i) s[i][j] = -INFINITY;
}

// q-tile pass.  Thread (ty, tx) owns query rows ty*RPT + i of the tile, keys
// tx + 16*j of each key tile, and dtheta columns tx + 16*j (j < ND).
template <int ND>
__global__ void __launch_bounds__(THREADS)
attn_bwd_q_pass(const void* __restrict__ theta, const void* __restrict__ phi,
                const void* __restrict__ g, const void* __restrict__ dout,
                void* __restrict__ dtheta, float* __restrict__ lse_out,
                float* __restrict__ delta_out, int Lq, int Lk, int d, int dv, bool bf16) {
  extern __shared__ float smem[];
  const int ldq = odd(d), ldv = odd(dv), ldp = 16 * ND + 1;
  float* s_theta = smem;                 // BQ x ldq
  float* s_do = s_theta + BQ * ldq;      // BQ x ldv
  float* s_phi = s_do + BQ * ldv;        // BK x ldp (zero past d)
  float* s_g = s_phi + BK * ldp;         // BK x ldv
  float* s_ds = s_g + BK * ldv;          // BQ x LDS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t bq = (size_t)n * Lq, bk = (size_t)n * Lk;

  load_tile(s_theta, ldq, d, theta, bq * d, q0, BQ, Lq, d, bf16);
  load_tile(s_do, ldv, dv, dout, bq * dv, q0, BQ, Lq, dv, bf16);

  float s[RPT][KPT], dp[RPT][KPT];
  // Sweep 1: running max m, sum l and sum of e * dp per row.  Every key
  // tile holds at least one real key, so the new max is finite; on the
  // first tile m is -inf and alpha is 0.
  float m[RPT], l[RPT], ed[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = ed[i] = 0.f;
  }
  for (int k0 = 0; k0 < Lk; k0 += BK) {
    load_keys(s_phi, s_g, ldp, ldv, phi, g, bk, k0, Lk, d, dv, 16 * ND, bf16);
    q_tile_products(s, dp, s_theta, s_do, s_phi, s_g, ldq, ldv, ldp, d, dv, k0, Lk, tx, ty);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float tmax = s[i][0];
#pragma unroll
      for (int j = 1; j < KPT; ++j) tmax = fmaxf(tmax, s[i][j]);
      const float m_new = fmaxf(m[i], row_max16(tmax));
      const float alpha = expf(m[i] - m_new);
      float tsum = 0.f, tdot = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float e = expf(s[i][j] - m_new);
        tsum += e;
        tdot = fmaf(e, dp[i][j], tdot);
      }
      l[i] = l[i] * alpha + row_sum16(tsum);
      ed[i] = ed[i] * alpha + row_sum16(tdot);
      m[i] = m_new;
    }
  }
  float lse[RPT], delta[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    lse[i] = m[i] + logf(l[i]);
    delta[i] = ed[i] / l[i];
    const int r = q0 + ty * RPT + i;
    if (tx == 0 && r < Lq) {
      lse_out[bq + r] = lse[i];
      delta_out[bq + r] = delta[i];
    }
  }

  // Sweep 2: ds = p * (dp - delta) exactly, dtheta += ds . phi.
  float acc[RPT][ND];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += BK) {
    load_keys(s_phi, s_g, ldp, ldv, phi, g, bk, k0, Lk, d, dv, 16 * ND, bf16);
    q_tile_products(s, dp, s_theta, s_do, s_phi, s_g, ldq, ldv, ldp, d, dv, k0, Lk, tx, ty);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - lse[i]);  // 0 for masked keys
        s_ds[(ty * RPT + i) * LDS + tx + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    const int kmax = min(BK, Lk - k0);
    for (int k = 0; k < kmax; ++k) {
      float a[RPT], b[ND];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = s_ds[(ty * RPT + i) * LDS + k];
#pragma unroll
      for (int j = 0; j < ND; ++j) b[j] = s_phi[k * ldp + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    if (r >= Lq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store_elem(dtheta, (bq + r) * d + c, acc[i][j], bf16);
    }
  }
}

// k-tile pass.  Thread (ty, tx) owns keys ty*RPT + i of the block, queries
// tx + 16*j of each query tile, dphi columns tx + 16*j (j < ND) and dg
// columns tx + 16*j (j < NC).
template <int ND, int NC>
__global__ void __launch_bounds__(THREADS)
attn_bwd_k_pass(const void* __restrict__ theta, const void* __restrict__ phi,
                const void* __restrict__ g, const void* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                void* __restrict__ dphi, void* __restrict__ dg, int Lq, int Lk, int d,
                int dv, bool bf16) {
  extern __shared__ float smem[];
  const int ldk = odd(d), ldg = odd(dv), ldq = 16 * ND + 1, ldo = 16 * NC + 1;
  float* s_phi = smem;                   // BK x ldk
  float* s_g = s_phi + BK * ldk;         // BK x ldg
  float* s_theta = s_g + BK * ldg;       // BQK x ldq (zero past d)
  float* s_do = s_theta + BQK * ldq;     // BQK x ldo (zero past dv)
  float* s_p = s_do + BQK * ldo;         // BQK x LDS
  float* s_ds = s_p + BQK * LDS;         // BQK x LDS
  float* s_lse = s_ds + BQK * LDS;       // BQK
  float* s_delta = s_lse + BQK;          // BQK

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n = blockIdx.y, k0 = blockIdx.x * BK;
  const size_t bq = (size_t)n * Lq, bk = (size_t)n * Lk;

  load_tile(s_phi, ldk, d, phi, bk * d, k0, BK, Lk, d, bf16);
  load_tile(s_g, ldg, dv, g, bk * dv, k0, BK, Lk, dv, bf16);

  float acc_phi[RPT][ND], acc_g[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < ND; ++j) acc_phi[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc_g[i][j] = 0.f;
  }

  for (int q0 = 0; q0 < Lq; q0 += BQK) {
    __syncthreads();  // the previous query tile is consumed; phi and g are stored
    load_tile(s_theta, ldq, 16 * ND, theta, bq * d, q0, BQK, Lq, d, bf16);
    load_tile(s_do, ldo, 16 * NC, dout, bq * dv, q0, BQK, Lq, dv, bf16);
    for (int r = tid; r < BQK; r += THREADS) {
      // A missing query gets p = exp(0 - inf) = 0, hence ds = 0.
      s_lse[r] = (q0 + r < Lq) ? lse[bq + q0 + r] : INFINITY;
      s_delta[r] = (q0 + r < Lq) ? delta[bq + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[RPT][QPT], dp[RPT][QPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < QPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[RPT], b[QPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = s_phi[(ty * RPT + i) * ldk + c];
#pragma unroll
      for (int j = 0; j < QPT; ++j) b[j] = s_theta[(tx + 16 * j) * ldq + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < QPT; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    for (int c = 0; c < dv; ++c) {
      float a[RPT], b[QPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = s_g[(ty * RPT + i) * ldg + c];
#pragma unroll
      for (int j = 0; j < QPT; ++j) b[j] = s_do[(tx + 16 * j) * ldo + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < QPT; ++j) dp[i][j] = fmaf(a[i], b[j], dp[i][j]);
    }
    // Keys past Lk get values here too, but their rows are never written.
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int q = tx + 16 * j;
      const float lq = s_lse[q], dq = s_delta[q];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = expf(s[i][j] - lq);
        s_p[q * LDS + ty * RPT + i] = p;
        s_ds[q * LDS + ty * RPT + i] = p * (dp[i][j] - dq);
      }
    }
    __syncthreads();

    const int qmax = min(BQK, Lq - q0);
    for (int q = 0; q < qmax; ++q) {
      float pv[RPT], dsv[RPT], tv[ND], ov[NC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = s_p[q * LDS + ty * RPT + i];
        dsv[i] = s_ds[q * LDS + ty * RPT + i];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) tv[j] = s_theta[q * ldq + tx + 16 * j];
#pragma unroll
      for (int j = 0; j < NC; ++j) ov[j] = s_do[q * ldo + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int j = 0; j < ND; ++j) acc_phi[i][j] = fmaf(dsv[i], tv[j], acc_phi[i][j]);
#pragma unroll
        for (int j = 0; j < NC; ++j) acc_g[i][j] = fmaf(pv[i], ov[j], acc_g[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int k = k0 + ty * RPT + i;
    if (k >= Lk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store_elem(dphi, (bk + k) * d + c, acc_phi[i][j], bf16);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c < dv) store_elem(dg, (bk + k) * dv + c, acc_g[i][j], bf16);
    }
  }
}

struct Args {
  const void *theta, *phi, *g, *dout;
  void *dtheta, *dphi, *dg;
  float *lse, *delta;
  int N, Lq, Lk, d, dv;
  bool bf16;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int ND>
cudaError_t launch_q(const Args& a) {
  const size_t smem = sizeof(float) * q_pass_floats(a.d, a.dv, ND);
  auto kernel = attn_bwd_q_pass<ND>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.N);
  kernel<<<grid, THREADS, smem, a.stream>>>(a.theta, a.phi, a.g, a.dout, a.dtheta, a.lse,
                                            a.delta, a.Lq, a.Lk, a.d, a.dv, a.bf16);
  return cudaGetLastError();
}

template <int ND, int NC>
cudaError_t launch_k(const Args& a) {
  const size_t smem = sizeof(float) * k_pass_floats(a.d, a.dv, ND, NC);
  auto kernel = attn_bwd_k_pass<ND, NC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + BK - 1) / BK, a.N);
  kernel<<<grid, THREADS, smem, a.stream>>>(a.theta, a.phi, a.g, a.dout, a.lse, a.delta,
                                            a.dphi, a.dg, a.Lq, a.Lk, a.d, a.dv, a.bf16);
  return cudaGetLastError();
}

// Column groups of 16 a thread holds: ND for d in {16, 32, 48, 64, 128},
// NC for dv in {16, 32, 64, 96, 128, 192, 256}.
template <int ND>
cudaError_t launch_k_nc(const Args& a) {
  const int nc = (a.dv + 15) / 16;
  if (nc <= 1) return launch_k<ND, 1>(a);
  if (nc <= 2) return launch_k<ND, 2>(a);
  if (nc <= 4) return launch_k<ND, 4>(a);
  if (nc <= 6) return launch_k<ND, 6>(a);
  if (nc <= 8) return launch_k<ND, 8>(a);
  if (nc <= 12) return launch_k<ND, 12>(a);
  return launch_k<ND, 16>(a);
}

template <int ND>
cudaError_t launch_both(const Args& a) {
  cudaError_t err = launch_q<ND>(a);
  if (err != cudaSuccess) return err;
  return launch_k_nc<ND>(a);  // same stream: it starts after the q-tile pass ends
}

cudaError_t dispatch(const Args& a) {
  const int nd = (a.d + 15) / 16;
  if (nd <= 1) return launch_both<1>(a);
  if (nd <= 2) return launch_both<2>(a);
  if (nd <= 3) return launch_both<3>(a);
  if (nd <= 4) return launch_both<4>(a);
  return launch_both<8>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse and delta are (N, Lq) f32 scratch
// the caller allocates.  Returns a cudaError_t (0 on success); both passes
// are launched asynchronously on `stream`, and nothing is allocated here.
extern "C" int sagan_attention_bwd(const void* theta, const void* phi, const void* g,
                                   const void* dout, void* dtheta, void* dphi, void* dg,
                                   void* lse, void* delta, int N, int Lq, int Lk, int d,
                                   int dv, int dtype, void* stream) {
  if (N <= 0 || N > 65535 || Lq <= 0 || Lk <= 0 || d <= 0 || d > MAX_D || dv <= 0 ||
      dv > MAX_DV || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{theta, phi, g, dout, dtheta, dphi, dg,
               static_cast<float*>(lse), static_cast<float*>(delta),
               N, Lq, Lk, d, dv, dtype == 1, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a);
}
