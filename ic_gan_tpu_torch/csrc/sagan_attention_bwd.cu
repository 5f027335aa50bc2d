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
// edges are masked here).  It takes the forward's per-row log-sum-exp lse
// (N, Lq) f32, so p = exp(s - lse) needs no statistics sweep.
//
// Bound on the H100 at the 256^2 training step's G shape (N 32, Lq 4096,
// Lk 1024, d 48, dv 192, bf16): 2*N*Lq*Lk*(3d + 2dv) = 141.7 GFLOP against
// ~107 MB moved, so it is bound by operations (0.143 ms at the 989 TFLOP/s
// bf16 tensor-core peak, 0.032 ms for the bytes at 3.35 TB/s).
//
// Design.  The TPU kernel walks the q-tiles of one sample in sequence and
// adds each tile's dphi and dg into one revisited output block; that is safe
// only because a TPU grid runs in order.  CUDA blocks run concurrently, so
// the work is split in two passes, neither with atomics, so that the result
// is the same from run to run:
//   q-tile pass, one block per (sample, query tile): theta and do stay in
//     shared memory while phi and g stream through in 64-key tiles.  A first
//     sweep forms delta = rowsum(dp * p) from the logits and dp; a second
//     forms ds = p * (dp - delta) and accumulates dtheta = ds . phi.  It
//     writes dtheta and delta (N, Lq) f32.
//   k-tile pass, one block per (sample, key tile): phi and g stay in shared
//     memory while theta, do, lse and delta stream through in query tiles;
//     dphi = sum ds^T theta and dg = sum p^T do accumulate in registers over
//     all the query tiles and are written once.
// The logits, p and ds never reach device memory.
//
// Why delta is rowsum(dp * p) and not the FlashAttention shortcut
// rowsum(do * o): the forward's o is formed from p rounded to bf16 and is
// itself rounded to bf16, so do . o differs from rowsum(dp * p) by about
// 2^-9 of |dp|.  ds = p * (dp - delta) cancels where one key dominates a
// row, which the 256^2 models' unscaled logits (spread ~7) make common, and
// the shortcut then misses the bf16 bar atol 5e-2 + rtol 2e-2 against the
// f32 formula more than twofold (tests/test_torch_port_attention_bwd.py).  The first sweep costs 2*N*Lq*Lk*(d + dv).
//
// bf16 (attn_bwd_q_mma, attn_bwd_kv_mma): every product on the tensor cores
// as a Hopper warpgroup MMA (wgmma m64nNk16, f32 accumulation).  A block is
// one to three warpgroups of 64 rows (queries or keys), as many as fit on an
// SM, that share each tile streamed through a cp.async ring: the streamed
// bytes, which bound these passes more than the products do, fall with the
// rows a block owns.  The logits and dp come out of the tensor
// cores in f32 and p, dp - delta and ds stay f32 in registers; P and ds
// enter the next products straight from those registers, and theta, phi
// and do serve both as K-major operands (for the logits and dp) and, read
// transposed, as MN-major ones (for dtheta, dphi and dg), from one tile in
// shared memory.  P enters the dg product rounded to bf16; ds enters the
// dtheta and dphi products as a two-term bf16 split, hi = bf16(ds) and
// lo = bf16(ds - hi), two products each, because ds sums to zero over a row
// and a single bf16 rounding of it takes dphi past the bar at the G shape.  The operands theta, phi, g and do are bf16 already, so their
// products are exact in f32.  In all the two passes do 2*N*Lq*Lk*(7d + 4dv)
// with d and dv padded to multiples of 16: 2.1x the bound's count at d 48,
// dv 192.
//
// f32 (attn_bwd_q_pass, attn_bwd_k_pass): the same two passes with CUDA-core
// FP32 FMAs (no TF32), 16x16 threads each owning 4 rows, tiles loaded
// element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "attention_mma.cuh"

namespace {

constexpr int MAX_D = 128;
constexpr int MAX_DV = 256;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void *theta, *phi, *g, *dout;
  const float* lse;
  void *dtheta, *dphi, *dg;
  float* delta;
  int N, Lq, Lk, d, dv;
  cudaStream_t stream;
};

// --- bf16: tensor cores -------------------------------------------------------

using attn_mma::bf16;
constexpr int Q_BK = 64;     // q pass: keys per streamed tile
constexpr int K_STAGES = 3;  // k pass: query tiles in the ring

// A block is WGS warpgroups of 64 rows (queries or keys) sharing each
// streamed tile, as many as registers and shared memory allow on one SM.
template <int DP>
struct QShape {
  static constexpr int WGS = DP <= 64 ? 3 : 2;
  static constexpr int THREADS = 128 * WGS, ROWS = 64 * WGS;
};

// k pass: BQ queries a streamed tile, 64 where the dg accumulator (64 x
// DVP) already keeps a second block off the SM, so that the larger tile
// costs no occupancy and halves the tiles; elsewhere 32, which keeps two
// blocks an SM (at dv 96 it measured faster than 64 on the H100).
template <int DP, int DVP>
struct KShape {
  static constexpr int WGS = DP <= 64 && DVP <= 192 ? 2 : 1;
  static constexpr int THREADS = 128 * WGS, ROWS = 64 * WGS;
  static constexpr int BQ = (DVP == 128 || DVP == 192) && DP <= 64 ? 64 : 32;
};

// Store a warpgroup's (64 x NC) f32 accumulator to rows r0.. of the (L, w)
// bf16 matrix dst, rows below L and columns below w.
template <int NC>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[NC / 2], int r0, int L,
                                          int w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
      attn_mma::store_pair(dst + (size_t)row * w, 8 * j + 2 * (lane & 3), w, acc[4 * j + 2 * r],
                           acc[4 * j + 2 * r + 1]);
  }
}

// A fragments of k-steps [0, KS) from a (64 x 16 KS) f32 accumulator:
// bf16(x), and with `lo` also the low parts x - bf16(x).
template <int KS>
__device__ __forceinline__ void to_frags(const float (&x)[8 * KS], uint32_t (&hi)[KS][4],
                                         uint32_t (*lo)[4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* c = &x[4 * (2 * kk + h) + 2 * r];
        hi[kk][2 * h + r] = attn_mma::pack_bf16(c[0], c[1]);
        if (lo != nullptr) lo[kk][2 * h + r] = attn_mma::pack_bf16_lo(c[0], c[1], hi[kk][2 * h + r]);
      }
}

__host__ __device__ __forceinline__ size_t q_mma_elems(int rows, int dp, int dvp) {
  return (size_t)(rows + 2 * Q_BK) * (dp + dvp);
}

__host__ __device__ __forceinline__ size_t k_mma_elems(int rows, int bq, int dp, int dvp) {
  return (size_t)(rows + K_STAGES * bq) * (dp + dvp);
}

// q-tile pass.  DP: d padded to 16, 32, 48, 64 or 128 (dtheta's width).
template <int DP>
__global__ void __launch_bounds__(QShape<DP>::THREADS)
attn_bwd_q_mma(const bf16* __restrict__ theta, const bf16* __restrict__ phi,
               const bf16* __restrict__ g, const bf16* __restrict__ dout,
               const float* __restrict__ lse, bf16* __restrict__ dtheta,
               float* __restrict__ delta_out, int Lq, int Lk, int d, int dv) {
  using namespace attn_mma;
  constexpr int THREADS = QShape<DP>::THREADS, ROWS = QShape<DP>::ROWS;
  const int dvp = round16(dv);
  extern __shared__ uint4 smem_u4[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_u4);  // ROWS x DP, blocked
  bf16* s_do = s_q + ROWS * DP;                  // ROWS x dvp
  bf16* s_k = s_do + ROWS * dvp;                 // 2 x BK x DP
  bf16* s_v = s_k + 2 * Q_BK * DP;               // 2 x BK x dvp

  // Warp w owns queries 16w..16w+15 of the block, in warpgroup w / 4.
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg_row = 64 * (warp >> 2);
  const int n = blockIdx.y, q0 = blockIdx.x * ROWS;
  const size_t bq = (size_t)n * Lq, bk = (size_t)n * Lk;
  const bf16* phi_n = phi + bk * d;
  const bf16* g_n = g + bk * dv;

  zero_cols<THREADS>(s_q, DP, ROWS, d);
  zero_cols<THREADS>(s_do, dvp, ROWS, dv);
  zero_cols<THREADS>(s_k, DP, 2 * Q_BK, d);
  zero_cols<THREADS>(s_v, dvp, 2 * Q_BK, dv);
  load_tile<THREADS>(s_q, DP, theta + bq * d, q0, ROWS, Lq, d);
  load_tile<THREADS>(s_do, dvp, dout + bq * dv, q0, ROWS, Lq, dv);
  load_tile<THREADS>(s_k, DP, phi_n, 0, Q_BK, Lk, d);
  load_tile<THREADS>(s_v, dvp, g_n, 0, Q_BK, Lk, dv);
  cp_async_commit();

  // lse of rows g and g + 8 of the warp, in base 2; a missing row gets +inf,
  // hence p = 0.
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = row < Lq ? lse[bq + row] * LOG2E : INFINITY;
  }

  float delta[2] = {0.f, 0.f};
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const int dks = round16(d) / 16, vks = dvp / 16;
  const int n_tiles = (Lk + Q_BK - 1) / Q_BK;
  // Sweep 1 (it < n_tiles): delta.  Sweep 2: dtheta.  One ring for both.
  for (int it = 0; it < 2 * n_tiles; ++it) {
    if (it + 1 < 2 * n_tiles) {
      const int nb = (it + 1) & 1, k1 = ((it + 1) % n_tiles) * Q_BK;
      load_tile<THREADS>(s_k + nb * Q_BK * DP, DP, phi_n, k1, Q_BK, Lk, d);
      load_tile<THREADS>(s_v + nb * Q_BK * dvp, dvp, g_n, k1, Q_BK, Lk, dv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if (it == n_tiles) {  // sweep 1 done: reduce delta over the quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
      }
    }
    const bf16* kt = s_k + (it & 1) * Q_BK * DP;
    const bf16* vt = s_v + (it & 1) * Q_BK * dvp;
    const int k0 = (it % n_tiles) * Q_BK;

    // s = theta . phi^T and dp = do . g^T: the warpgroup's 64 queries x 64
    // keys.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    keep(s);
    keep(dp);
    gmma_fence();
    for (int ks = 0; ks < dks; ++ks)
      Gmma<64, 0>::ss(s, desc_k(s_q, DP, wg_row, ks), desc_k(kt, DP, 0, ks), 1);
    for (int ks = 0; ks < vks; ++ks)
      Gmma<64, 0>::ss(dp, desc_k(s_do, dvp, wg_row, ks), desc_k(vt, dvp, 0, ks), 1);
    gmma_commit();
    gmma_wait<0>();
    keep(s);
    keep(dp);
    // p = exp(s - lse), 0 for keys past Lk; then the delta terms or ds.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool real = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1) < Lk;
      const int r = (i >> 1) & 1;
      const float p = real ? exp2_approx(fmaf(s[i], LOG2E, -lse2[r])) : 0.f;
      if (it < n_tiles)
        delta[r] = fmaf(p, dp[i], delta[r]);
      else
        s[i] = p * (dp[i] - delta[r]);
    }
    if (it >= n_tiles) {
      // dtheta += ds . phi, ds as hi + lo bf16 parts, phi as the MN-major B.
      uint32_t hi[4][4], lo[4][4];
      to_frags<4>(s, hi, lo);
      keep(acc);
      gmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        gmma_rs_cols<DP>(acc, hi[kk], kt, DP, kk);
        gmma_rs_cols<DP>(acc, lo[kk], kt, DP, kk);
      }
      gmma_commit();
      gmma_wait<0>();
      keep(acc);
      keep(hi);
      keep(lo);
    }
    __syncthreads();  // this tile is consumed before its buffer is refilled
  }
  cp_async_wait<0>();

  store_acc<DP>(dtheta + bq * d, acc, q0, Lq, d);
  if ((lane & 3) == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < Lq) delta_out[bq + row] = delta[r];
    }
}

// k-tile pass.  DP and DVP: d and dv padded to the widths of dphi and dg.
template <int DP, int DVP>
__global__ void __launch_bounds__((KShape<DP, DVP>::THREADS))
attn_bwd_kv_mma(const bf16* __restrict__ theta, const bf16* __restrict__ phi,
                const bf16* __restrict__ g, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dphi, bf16* __restrict__ dg, int Lq, int Lk, int d, int dv) {
  using namespace attn_mma;
  constexpr int THREADS = KShape<DP, DVP>::THREADS, ROWS = KShape<DP, DVP>::ROWS;
  constexpr int K_BQ = KShape<DP, DVP>::BQ;
  extern __shared__ uint4 smem_u4[];
  __shared__ float s_lse[K_STAGES][K_BQ], s_delta[K_STAGES][K_BQ];
  bf16* s_k = reinterpret_cast<bf16*>(smem_u4);  // ROWS x DP, blocked
  bf16* s_v = s_k + ROWS * DP;                   // ROWS x DVP
  bf16* s_q = s_v + ROWS * DVP;                  // STAGES x BQ x DP
  bf16* s_do = s_q + K_STAGES * K_BQ * DP;       // STAGES x BQ x DVP

  // Warp w owns keys 16w..16w+15 of the block, in warpgroup w / 4.
  const int tid = threadIdx.x, lane = tid & 31, wg_row = 64 * (tid >> 7);
  const int n = blockIdx.y, k0 = blockIdx.x * ROWS;
  const size_t bq = (size_t)n * Lq, bk = (size_t)n * Lk;
  const bf16* theta_n = theta + bq * d;
  const bf16* do_n = dout + bq * dv;

  const int n_tiles = (Lq + K_BQ - 1) / K_BQ;
  // Query tile t into its slot of the ring: theta, do, lse and delta.  A
  // missing query gets p = exp2(-inf) = 0, hence ds = 0.
  auto load_queries = [&](int t) {
    if (t < n_tiles) {
      const int slot = t % K_STAGES, qs = t * K_BQ;
      load_tile<THREADS>(s_q + slot * K_BQ * DP, DP, theta_n, qs, K_BQ, Lq, d);
      load_tile<THREADS>(s_do + slot * K_BQ * DVP, DVP, do_n, qs, K_BQ, Lq, dv);
      for (int r = tid; r < K_BQ; r += THREADS) {
        const bool real = qs + r < Lq;
        s_lse[slot][r] = real ? lse[bq + qs + r] * LOG2E : INFINITY;
        s_delta[slot][r] = real ? delta[bq + qs + r] : 0.f;
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };

  zero_cols<THREADS>(s_k, DP, ROWS, d);
  zero_cols<THREADS>(s_v, DVP, ROWS, dv);
  zero_cols<THREADS>(s_q, DP, K_STAGES * K_BQ, d);
  zero_cols<THREADS>(s_do, DVP, K_STAGES * K_BQ, dv);
  load_tile<THREADS>(s_k, DP, phi + bk * d, k0, ROWS, Lk, d);
  load_tile<THREADS>(s_v, DVP, g + bk * dv, k0, ROWS, Lk, dv);
  for (int t = 0; t < K_STAGES - 1; ++t) load_queries(t);

  float acc_phi[DP / 2], acc_g[DVP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_phi[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) acc_g[i] = 0.f;
  const int dks = round16(d) / 16, vks = round16(dv) / 16;
  for (int t = 0; t < n_tiles; ++t) {
    load_queries(t + K_STAGES - 1);
    cp_async_wait<K_STAGES - 1>();  // tile t has landed
    fence_proxy_async();
    __syncthreads();
    const int b = t % K_STAGES;
    const bf16* qt = s_q + b * K_BQ * DP;
    const bf16* ot = s_do + b * K_BQ * DVP;

    // s^T = phi . theta^T and dp^T = g . do^T: the warpgroup's 64 keys x
    // BQ queries.
    constexpr int KS = K_BQ / 16;  // k-steps of the dg and dphi products
    float s[K_BQ / 2], dp[K_BQ / 2];
#pragma unroll
    for (int i = 0; i < K_BQ / 2; ++i) s[i] = dp[i] = 0.f;
    keep(s);
    keep(dp);
    gmma_fence();
    for (int ks = 0; ks < dks; ++ks)
      Gmma<K_BQ, 0>::ss(s, desc_k(s_k, DP, wg_row, ks), desc_k(qt, DP, 0, ks), 1);
    for (int ks = 0; ks < vks; ++ks)
      Gmma<K_BQ, 0>::ss(dp, desc_k(s_v, DVP, wg_row, ks), desc_k(ot, DVP, 0, ks), 1);
    gmma_commit();
    gmma_wait<0>();
    keep(s);
    keep(dp);
    // Column (query) 8j + 2(lane%4) + e%2 of tile j: p^T, then ds^T in dp.
#pragma unroll
    for (int i = 0; i < K_BQ / 2; ++i) {
      const int q = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const float p = exp2_approx(fmaf(s[i], LOG2E, -s_lse[b][q]));
      s[i] = p;
      dp[i] = p * (dp[i] - s_delta[b][q]);
    }
    // dg += p^T . do and dphi += ds^T . theta (ds as hi + lo bf16 parts),
    // do and theta as MN-major B.  Keys past Lk got values too, but their
    // rows are not written.
    uint32_t pa[KS][4], hi[KS][4], lo[KS][4];
    to_frags<KS>(s, pa, nullptr);
    to_frags<KS>(dp, hi, lo);
    keep(acc_g);
    keep(acc_phi);
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      gmma_rs_cols<DVP>(acc_g, pa[kk], ot, DVP, kk);
      gmma_rs_cols<DP>(acc_phi, hi[kk], qt, DP, kk);
      gmma_rs_cols<DP>(acc_phi, lo[kk], qt, DP, kk);
    }
    gmma_commit();
    gmma_wait<0>();
    keep(acc_g);
    keep(acc_phi);
    keep(pa);
    keep(hi);
    keep(lo);
    __syncthreads();  // tile t is consumed before its slot is refilled
  }
  cp_async_wait<0>();

  store_acc<DP>(dphi + bk * d, acc_phi, k0, Lk, d);
  store_acc<DVP>(dg + bk * dv, acc_g, k0, Lk, dv);
}

template <int DP>
cudaError_t launch_q_mma(const Args& a) {
  using S = QShape<DP>;
  const size_t smem = sizeof(bf16) * q_mma_elems(S::ROWS, DP, attn_mma::round16(a.dv));
  auto kernel = attn_bwd_q_mma<DP>;
  cudaError_t err = attn_mma::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + S::ROWS - 1) / S::ROWS, a.N);
  kernel<<<grid, S::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.theta), static_cast<const bf16*>(a.phi),
      static_cast<const bf16*>(a.g), static_cast<const bf16*>(a.dout), a.lse,
      static_cast<bf16*>(a.dtheta), a.delta, a.Lq, a.Lk, a.d, a.dv);
  return cudaGetLastError();
}

template <int DP, int DVP>
cudaError_t launch_kv_mma(const Args& a) {
  using S = KShape<DP, DVP>;
  const size_t smem = sizeof(bf16) * k_mma_elems(S::ROWS, S::BQ, DP, DVP);
  auto kernel = attn_bwd_kv_mma<DP, DVP>;
  cudaError_t err = attn_mma::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + S::ROWS - 1) / S::ROWS, a.N);
  kernel<<<grid, S::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.theta), static_cast<const bf16*>(a.phi),
      static_cast<const bf16*>(a.g), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dphi), static_cast<bf16*>(a.dg), a.Lq, a.Lk, a.d, a.dv);
  return cudaGetLastError();
}

// dv padded to 32, 64, 96, 128, 192 or 256.
template <int DP>
cudaError_t launch_kv_dv(const Args& a) {
  if (a.dv <= 32) return launch_kv_mma<DP, 32>(a);
  if (a.dv <= 64) return launch_kv_mma<DP, 64>(a);
  if (a.dv <= 96) return launch_kv_mma<DP, 96>(a);
  if (a.dv <= 128) return launch_kv_mma<DP, 128>(a);
  if (a.dv <= 192) return launch_kv_mma<DP, 192>(a);
  return launch_kv_mma<DP, 256>(a);
}

template <int DP>
cudaError_t launch_both_mma(const Args& a) {
  cudaError_t err = launch_q_mma<DP>(a);
  if (err != cudaSuccess) return err;
  return launch_kv_dv<DP>(a);  // same stream: it starts after the q-tile pass ends
}

// d padded to 16, 32, 48, 64 or 128.
cudaError_t dispatch_mma(const Args& a) {
  if (a.d <= 16) return launch_both_mma<16>(a);
  if (a.d <= 32) return launch_both_mma<32>(a);
  if (a.d <= 48) return launch_both_mma<48>(a);
  if (a.d <= 64) return launch_both_mma<64>(a);
  return launch_both_mma<128>(a);
}

// --- f32: CUDA-core FMAs ----------------------------------------------------------

constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int BQ = 64;         // q-tile pass: query rows per block
constexpr int BK = 64;         // keys per tile: streamed (q pass), per block (k pass)
constexpr int BQK = 32;        // k-tile pass: query rows per streamed tile
constexpr int RPT = 4;         // rows a thread owns: queries (q pass), keys (k pass)
constexpr int KPT = BK / 16;   // q pass: keys a thread owns in the logit tile
constexpr int QPT = BQK / 16;  // k pass: queries a thread owns in the logit tile
constexpr int LDS = BK + 1;    // row stride of the p and ds tiles

// Rows [r0, r0 + rows) of the (L, w) matrix at src into s[r * ld + c] for
// c < fill; zero past L and past w.
__device__ __forceinline__ void load_tile(float* s, int ld, int fill, const float* src, int r0,
                                          int rows, int L, int w) {
  for (int idx = threadIdx.x; idx < rows * fill; idx += THREADS) {
    const int r = idx / fill, c = idx - r * fill;
    s[r * ld + c] = (r0 + r < L && c < w) ? src[(size_t)(r0 + r) * w + c] : 0.f;
  }
}

__device__ __forceinline__ float row_sum16(float v) {
  // The 16 threads of one row group are one half-warp (lanes differ in tx only).
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
                                          const float* phi, const float* g, int k0, int Lk,
                                          int d, int dv, int fill_phi) {
  __syncthreads();  // the previous tile is consumed
  load_tile(s_phi, ldp, fill_phi, phi, k0, BK, Lk, d);
  load_tile(s_g, ldv, dv, g, k0, BK, Lk, dv);
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
attn_bwd_q_pass(const float* __restrict__ theta, const float* __restrict__ phi,
                const float* __restrict__ g, const float* __restrict__ dout,
                const float* __restrict__ lse_in, float* __restrict__ dtheta,
                float* __restrict__ delta_out, int Lq, int Lk, int d, int dv) {
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
  const float* phi_n = phi + bk * d;
  const float* g_n = g + bk * dv;

  load_tile(s_theta, ldq, d, theta + bq * d, q0, BQ, Lq, d);
  load_tile(s_do, ldv, dv, dout + bq * dv, q0, BQ, Lq, dv);

  float s[RPT][KPT], dp[RPT][KPT];
  float lse[RPT], delta[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    lse[i] = r < Lq ? lse_in[bq + r] : INFINITY;  // a missing row gets p = 0
    delta[i] = 0.f;
  }
  // Sweep 1: delta = rowsum(p * dp), p = exp(s - lse).
  for (int k0 = 0; k0 < Lk; k0 += BK) {
    load_keys(s_phi, s_g, ldp, ldv, phi_n, g_n, k0, Lk, d, dv, 16 * ND);
    q_tile_products(s, dp, s_theta, s_do, s_phi, s_g, ldq, ldv, ldp, d, dv, k0, Lk, tx, ty);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float tdot = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) tdot = fmaf(expf(s[i][j] - lse[i]), dp[i][j], tdot);
      delta[i] += row_sum16(tdot);
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    if (tx == 0 && r < Lq) delta_out[bq + r] = delta[i];
  }

  // Sweep 2: ds = p * (dp - delta) exactly, dtheta += ds . phi.
  float acc[RPT][ND];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += BK) {
    load_keys(s_phi, s_g, ldp, ldv, phi_n, g_n, k0, Lk, d, dv, 16 * ND);
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
      if (c < d) dtheta[(bq + r) * d + c] = acc[i][j];
    }
  }
}

// k-tile pass.  Thread (ty, tx) owns keys ty*RPT + i of the block, queries
// tx + 16*j of each query tile, dphi columns tx + 16*j (j < ND) and dg
// columns tx + 16*j (j < NC).
template <int ND, int NC>
__global__ void __launch_bounds__(THREADS)
attn_bwd_k_pass(const float* __restrict__ theta, const float* __restrict__ phi,
                const float* __restrict__ g, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dphi, float* __restrict__ dg, int Lq, int Lk, int d,
                int dv) {
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

  load_tile(s_phi, ldk, d, phi + bk * d, k0, BK, Lk, d);
  load_tile(s_g, ldg, dv, g + bk * dv, k0, BK, Lk, dv);

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
    load_tile(s_theta, ldq, 16 * ND, theta + bq * d, q0, BQK, Lq, d);
    load_tile(s_do, ldo, 16 * NC, dout + bq * dv, q0, BQK, Lq, dv);
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
      if (c < d) dphi[(bk + k) * d + c] = acc_phi[i][j];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c < dv) dg[(bk + k) * dv + c] = acc_g[i][j];
    }
  }
}

template <int ND>
cudaError_t launch_q(const Args& a) {
  const size_t smem = sizeof(float) * q_pass_floats(a.d, a.dv, ND);
  auto kernel = attn_bwd_q_pass<ND>;
  cudaError_t err = attn_mma::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.N);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.theta), static_cast<const float*>(a.phi),
      static_cast<const float*>(a.g), static_cast<const float*>(a.dout), a.lse,
      static_cast<float*>(a.dtheta), a.delta, a.Lq, a.Lk, a.d, a.dv);
  return cudaGetLastError();
}

template <int ND, int NC>
cudaError_t launch_k(const Args& a) {
  const size_t smem = sizeof(float) * k_pass_floats(a.d, a.dv, ND, NC);
  auto kernel = attn_bwd_k_pass<ND, NC>;
  cudaError_t err = attn_mma::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + BK - 1) / BK, a.N);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.theta), static_cast<const float*>(a.phi),
      static_cast<const float*>(a.g), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dphi), static_cast<float*>(a.dg), a.Lq, a.Lk, a.d, a.dv);
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

cudaError_t dispatch_f32(const Args& a) {
  const int nd = (a.d + 15) / 16;
  if (nd <= 1) return launch_both<1>(a);
  if (nd <= 2) return launch_both<2>(a);
  if (nd <= 3) return launch_both<3>(a);
  if (nd <= 4) return launch_both<4>(a);
  return launch_both<8>(a);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  lse is the
// forward's (N, Lq) f32 log-sum-exp; delta is (N, Lq) f32 scratch the
// caller allocates.  Returns a cudaError_t (0 on success); both passes are
// launched asynchronously on `stream`, and nothing is allocated here.
extern "C" int sagan_attention_bwd(const void* theta, const void* phi, const void* g,
                                   const void* dout, const void* lse, void* dtheta, void* dphi,
                                   void* dg, void* delta, int N, int Lq, int Lk, int d, int dv,
                                   int dtype, void* stream) {
  if (N <= 0 || N > 65535 || Lq <= 0 || Lk <= 0 || d <= 0 || d > MAX_D || dv <= 0 ||
      dv > MAX_DV)
    return (int)cudaErrorInvalidValue;
  const Args a{theta, phi, g, dout, static_cast<const float*>(lse), dtheta, dphi, dg,
               static_cast<float*>(delta), N, Lq, Lk, d, dv, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch_f32(a);
  if (dtype == 1) return (int)dispatch_mma(a);
  return (int)cudaErrorInvalidValue;
}
