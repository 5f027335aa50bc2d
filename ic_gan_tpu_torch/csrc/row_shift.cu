// Per-row fractional shift for Hopper (sm_90a), the ADA warp's shear pass:
//   out[r, l] = (1 - f_r) * x[r, l + k_r] + f_r * x[r, l + k_r + 1],  l < l_out,
// with k_r = floor(off_r), f_r = off_r - k_r, and x read as zero outside [0, L).
//
// Replaces the TPU kernel ic_gan_tpu/ops/pallas/row_shift.py:_shift_kernel
// (launched by _row_shift_impl).  The TPU has no cheap per-lane gather, so
// that kernel shifts whole tiles with a log2 barrel shifter of lane rolls
// over host-padded rows.  A GPU thread reads any address, so here each row's
// window [k, k + l_out] is read directly, coalesced (neighbouring threads read
// neighbouring addresses, each element twice through L1), the host padding
// becomes a bounds check, and the lerp runs in f32 before one rounding to the
// input's type.  One kernel serves the forward (l_out < L) and its adjoint,
// the same shift with -off from a row of l_out to one of L (l_out > L).  Rows
// whose shift reads nothing in frame come out zero, as the TPU kernel's
// sentinel clamp gives.
//
// Bound on the H100: one multiply-add pair per output against 8 bytes (f32)
// moved, so bytes bound it.  At the StyleGAN2-ADA 256^2 path shape, 38,016
// rows of 1584 -> 792 f32, each row's 793-element window in and 792 out,
// about 120.6 + 120.4 MB: 0.072 ms at 3.35 TB/s.
//
// Design: one block of 256 threads per row (rows on blockIdx.x, so any row
// count), threads striding over the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
row_shift_kernel(const T* __restrict__ x, const float* __restrict__ off, T* __restrict__ out,
                 int L, int l_out) {
  const size_t r = blockIdx.x;
  const T* xr = x + r * (size_t)L;
  T* orow = out + r * (size_t)l_out;
  const float o = off[r];
  const float kf = floorf(o);
  // A shift outside [-(l_out + 1), L] reads nothing in frame for any output;
  // the test also catches NaN and keeps the int conversion in range.
  if (!(kf >= -(float)l_out - 1.f && kf <= (float)L)) {
    for (int l = threadIdx.x; l < l_out; l += THREADS) orow[l] = from_f32<T>(0.f);
    return;
  }
  const int k = (int)kf;
  const float f = o - kf;
  const float w0 = 1.f - f;
  for (int l = threadIdx.x; l < l_out; l += THREADS) {
    const int j = l + k;
    const float a = (j >= 0 && j < L) ? to_f32(xr[j]) : 0.f;
    const float c = (j + 1 >= 0 && j + 1 < L) ? to_f32(xr[j + 1]) : 0.f;
    orow[l] = from_f32<T>(a * w0 + c * f);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* off, void* out, int B, int L, int l_out,
                   cudaStream_t stream) {
  row_shift_kernel<T><<<B, THREADS, 0, stream>>>(static_cast<const T*>(x), off,
                                                static_cast<T*>(out), L, l_out);
  return cudaGetLastError();
}

}  // namespace

// x (B, L) and out (B, l_out), contiguous, of one type; off (B,) float32.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream` and allocates nothing.
extern "C" int row_shift(const void* x, const float* off, void* out, int B, int L, int l_out,
                         int dtype, void* stream) {
  if (B <= 0 || L <= 0 || l_out <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, off, out, B, L, l_out, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, off, out, B, L, l_out, s);
  return (int)cudaErrorInvalidValue;
}
