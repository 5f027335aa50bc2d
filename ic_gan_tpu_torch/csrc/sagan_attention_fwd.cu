// SA-GAN attention forward for Hopper (sm_90a): o = softmax(theta . phi^T) . g
//
// Replaces the TPU kernel ic_gan_tpu/ops/pallas/attention.py:_attn_kernel
// (launched by _attention_fwd_impl).  Same function: unscaled, non-causal,
// f32 logits, f32 row max and row sum, p cast to g's type before the second
// product, f32 accumulation, one divide by the row sum at the end, output in
// g's type.  theta (N, Lq, d), phi (N, Lk, d), g (N, Lk, dv), all contiguous,
// bf16 or f32; d <= 128, dv <= 256, any Lq and Lk (the ragged edge is masked
// here).
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
// them, so here one block owns one (sample, 64-row query tile), streams phi
// and g through shared memory in 64-key tiles and keeps an online softmax:
// running max and running sum per row, f32 accumulators in registers,
// rescaled when the max moves.  The logits never reach device memory, so the
// bytes stay at their floor and only the arithmetic is left.  This first
// version does that arithmetic with CUDA-core FP32 FMAs (16x16 threads, each
// owning 4 query rows), so it cannot beat ~3.9 ms at the 67 TFLOP/s FP32
// peak; mma/wgmma tensor-core tiles are the next step toward the 0.26 ms
// bound.  Rounding differs from the TPU kernel in one place: p is rounded to
// bf16 against the running max rather than the final one, which stays within
// bf16 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per streamed tile
constexpr int THREADS = 256;     // 16 x 16 threads
constexpr int RPT = BQ / 16;     // query rows per thread
constexpr int KPT = BK / 16;     // keys per thread in the logit tile
constexpr int LDP = BK + 4;      // padded row stride of the p tile
constexpr int MAX_D = 128;
constexpr int MAX_DV = 256;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
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

// NC: dv columns per thread, 16 apart (dv <= 16 * NC).
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
sagan_attention_fwd_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                           const T* __restrict__ g, T* __restrict__ out,
                           int Lq, int Lk, int d, int dv) {
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
  const T* theta_n = theta + (size_t)n * Lq * d;
  const T* phi_n = phi + (size_t)n * Lk * d;
  const T* g_n = g + (size_t)n * Lk * dv;
  T* out_n = out + (size_t)n * Lq * dv;

  for (int idx = tid; idx < BQ * d; idx += THREADS) {
    const int r = idx / d, c = idx - r * d;
    s_theta[r * ldq + c] = (q0 + r < Lq) ? to_f32(theta_n[(size_t)(q0 + r) * d + c]) : 0.f;
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
      s_phi[k * ldq + c] = (k0 + k < Lk) ? to_f32(phi_n[(size_t)(k0 + k) * d + c]) : 0.f;
    }
    for (int idx = tid; idx < BK * ldg; idx += THREADS) {
      const int k = idx / ldg, c = idx - k * ldg;
      s_g[idx] = (k0 + k < Lk && c < dv) ? to_f32(g_n[(size_t)(k0 + k) * dv + c]) : 0.f;
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
        // The second product sees p in g's type; the row sum keeps f32 p.
        s_p[(ty * RPT + i) * LDP + tx + 16 * j] = to_f32(from_f32<T>(p));
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
      if (c < dv) out_n[(size_t)r * dv + c] = from_f32<T>(acc[i][j] / l[i]);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* theta, const void* phi, const void* g, void* out,
                   int N, int Lq, int Lk, int d, int dv, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (d + 1) + (size_t)BK * 16 * NC + (size_t)BQ * LDP);
  auto kernel = sagan_attention_fwd_kernel<T, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BQ - 1) / BQ, N);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(theta),
                                          static_cast<const T*>(phi),
                                          static_cast<const T*>(g), static_cast<T*>(out),
                                          Lq, Lk, d, dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* theta, const void* phi, const void* g, void* out,
                     int N, int Lq, int Lk, int d, int dv, cudaStream_t stream) {
  const int nc = (dv + 15) / 16;
  if (nc <= 1) return launch<T, 1>(theta, phi, g, out, N, Lq, Lk, d, dv, stream);
  if (nc <= 2) return launch<T, 2>(theta, phi, g, out, N, Lq, Lk, d, dv, stream);
  if (nc <= 4) return launch<T, 4>(theta, phi, g, out, N, Lq, Lk, d, dv, stream);
  if (nc <= 6) return launch<T, 6>(theta, phi, g, out, N, Lq, Lk, d, dv, stream);
  if (nc <= 8) return launch<T, 8>(theta, phi, g, out, N, Lq, Lk, d, dv, stream);
  if (nc <= 12) return launch<T, 12>(theta, phi, g, out, N, Lq, Lk, d, dv, stream);
  return launch<T, 16>(theta, phi, g, out, N, Lq, Lk, d, dv, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success);
// the launch is asynchronous on `stream` and allocates nothing.
extern "C" int sagan_attention_fwd(const void* theta, const void* phi, const void* g,
                                   void* out, int N, int Lq, int Lk, int d, int dv,
                                   int dtype, void* stream) {
  if (N <= 0 || N > 65535 || Lq <= 0 || Lk <= 0 || d <= 0 || d > MAX_D || dv <= 0 ||
      dv > MAX_DV)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(theta, phi, g, out, N, Lq, Lk, d, dv, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(theta, phi, g, out, N, Lq, Lk, d, dv, s);
  return (int)cudaErrorInvalidValue;
}
