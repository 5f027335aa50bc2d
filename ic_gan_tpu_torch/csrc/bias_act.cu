// Fused bias + activation + gain + clamp for Hopper (sm_90a):
//   y = clamp(gain * act(x + b), -clamp, clamp)
//
// Replaces the TPU kernel ic_gan_tpu/ops/pallas/bias_act.py:_forward
// (bodies _kernel_bias / _kernel_nobias).  Same function over the nine
// activations of ic_gan_tpu/ops/bias_act.py; one read of x (and b), the
// arithmetic in f32, one rounding to the output's type, one write.  The
// bias index is (i / inner) % C, so NCHW activations (bias on dim 1, inner =
// H*W) and (N, C) features (inner = 1) both run with no transpose, and there
// is no shape gate: the TPU kernel's C % 128 fallback has no reason here.
//
// Bound on the H100: a handful of operations per element against 4 (bf16)
// or 8 (f32) bytes moved, far below the ~295 FLOP/byte ridge, so bytes bound
// it.  At the StyleGAN2 256^2 blocks' largest call, (16, 64, 256, 256) bf16,
// that is 2 x 134 MB, 0.080 ms at 3.35 TB/s.
//
// Design: a grid-stride loop, one element per thread per iteration, so
// neighbouring threads touch neighbouring addresses; the channel index uses
// 32-bit division when the tensor has fewer than 2^31 elements.  Vector
// (16-byte) loads are the next step toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Activation codes, in the order of the port's activation table.
__device__ __forceinline__ float activate(float v, int act, float alpha) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);                                   // relu
    case 2: return v >= 0.f ? v : v * alpha;                        // lrelu
    case 3: return tanhf(v);                                        // tanh
    case 4: return sigmoid(v);                                      // sigmoid
    case 5: return v > 0.f ? v : expm1f(v);                         // elu
    case 6: return 1.0507009873554805f * (v > 0.f ? v : 1.6732632423543772f * expm1f(v));  // selu
    case 7: return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));        // softplus
    case 8: return v * sigmoid(v);                                  // swish
    default: return v;                                              // linear
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS)
bias_act_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ y, I n, I C,
                I inner, int act, float alpha, float gain, float clamp) {
  const I stride = (I)gridDim.x * THREADS;
  for (I i = (I)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    float v = to_f32(x[i]);
    if (b != nullptr) v += to_f32(b[(i / inner) % C]);
    v = activate(v, act, alpha);
    if (gain != 1.f) v *= gain;
    if (clamp >= 0.f) v = fminf(fmaxf(v, -clamp), clamp);
    y[i] = from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* b, void* y, long long n, int C, long long inner,
                   int act, float alpha, float gain, float clamp, cudaStream_t stream) {
  // Enough blocks to fill the card several times over; the loop takes the rest.
  const long long want = (n + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (n < (1LL << 31) - THREADS * (long long)blocks)
    bias_act_kernel<T, uint32_t><<<blocks, THREADS, 0, stream>>>(
        xp, bp, yp, (uint32_t)n, (uint32_t)C, (uint32_t)inner, act, alpha, gain, clamp);
  else
    bias_act_kernel<T, uint64_t><<<blocks, THREADS, 0, stream>>>(
        xp, bp, yp, (uint64_t)n, (uint64_t)C, (uint64_t)inner, act, alpha, gain, clamp);
  return cudaGetLastError();
}

}  // namespace

// x, y: n elements (contiguous); b: C elements or null.  act: 0 linear, 1 relu,
// 2 lrelu, 3 tanh, 4 sigmoid, 5 elu, 6 selu, 7 softplus, 8 swish.  clamp < 0
// means none.  dtype: 0 = float32, 1 = bfloat16 (x, b and y alike).  Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
extern "C" int bias_act_fwd(const void* x, const void* b, void* y, long long n, int C,
                            long long inner, int act, float alpha, float gain, float clamp,
                            int dtype, void* stream) {
  if (n <= 0 || C <= 0 || inner <= 0 || act < 0 || act > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, b, y, n, C, inner, act, alpha, gain, clamp, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, b, y, n, C, inner, act, alpha, gain, clamp, s);
  return (int)cudaErrorInvalidValue;
}
