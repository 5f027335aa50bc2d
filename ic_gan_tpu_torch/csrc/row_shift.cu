// Per-row fractional shift for Hopper (sm_90a), the ADA warp's shear pass:
//   out[r, l] = (1 - f_r) * x[r, l + k_r] + f_r * x[r, l + k_r + 1],  l < l_out,
// with k_r = floor(off_r), f_r = off_r - k_r, and x read as zero outside [0, L).
//
// Replaces the TPU kernel ic_gan_tpu/ops/pallas/row_shift.py:_shift_kernel
// (launched by _row_shift_impl).  The TPU has no cheap per-lane gather, so
// that kernel shifts whole tiles with a log2 barrel shifter of lane rolls
// over host-padded rows.  A GPU thread reads any address, so here each row's
// window [k, k + l_out] is read directly, the host padding becomes a bounds
// check, and the lerp runs in f32 before one rounding to the input's type.
// One kernel serves the forward (l_out < L) and its adjoint, the same shift
// with -off from a row of l_out to one of L (l_out > L).  Rows whose finite
// shift reads nothing in frame come out zero, as the TPU kernel's sentinel
// clamp gives; rows whose offset is NaN or +-inf come out NaN, as there
// (its weights (1 - f) * valid are NaN).
//
// Bound on the H100: one multiply-add pair per output against 8 bytes (f32)
// moved, so bytes bound it.  At the StyleGAN2-ADA 256^2 path shape, 38,016
// rows of 1584 -> 792 f32, each row's 793-element window in and 792 out,
// about 120.6 + 120.4 MB: 0.072 ms at 3.35 TB/s.
//
// Design, for the memory system:
// - One warp per row, ROWS rows per block, so a row of any length keeps its
//   lanes busy but for the last 16-byte vector group, and no block idles
//   most of its threads on a short last iteration.
// - The row's window is read once, in aligned 16-byte vectors from the
//   vector boundary at or below k: lane j loads vector q + j (q = floor(k /
//   VEC)) and takes vector q + j + 1 from lane j + 1 by a warp shuffle (lane
//   31 loads it itself).  The VEC outputs of lane j need elements r .. r + VEC
//   of those two vectors, r = k - q * VEC, the same r for the whole row: a
//   switch on r, uniform across the warp, picks them by compile-time index,
//   so they stay in registers.  No input element is read twice from L1, and
//   no load is unaligned.
// - Each lane writes its VEC outputs (4 f32 or 8 bf16) as one 16-byte store.
// - The vector path needs 16-byte aligned rows in and out (L and l_out
//   multiples of VEC, aligned base pointers); a scalar path in the same kernel
//   (lanes striding over the row, two loads an output) takes the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;             // rows (warps) per block
constexpr int THREADS = 32 * ROWS;
constexpr int UNROLL = 2;           // vector groups per lane in flight
constexpr unsigned FULL = 0xffffffffu;

template <typename T> struct Vec;   // VEC elements of T in 16 bytes
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

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

// 16 bytes as VEC floats, and back (one rounding to T).
__device__ __forceinline__ void unpack(const uint4& q, float* v, float) {
  v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float* v, __nv_bfloat16) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float* v, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Vector i of a row of n vectors, zero outside [0, n) or when not needed.
__device__ __forceinline__ uint4 load_or_zero(const uint4* row, int i, int n, bool need) {
  return (need && i >= 0 && i < n) ? row[i] : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ uint4 shfl_down(const uint4& v) {
  return make_uint4(__shfl_down_sync(FULL, v.x, 1), __shfl_down_sync(FULL, v.y, 1),
                    __shfl_down_sync(FULL, v.z, 1), __shfl_down_sync(FULL, v.w, 1));
}

// The VEC outputs from elements R .. R + VEC of a (2 * VEC floats).
template <int V, int R>
__device__ __forceinline__ void lerp(const float* a, float w0, float f, float* out) {
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = a[R + i] * w0 + a[R + i + 1] * f;
}

template <int V>
__device__ __forceinline__ void lerp_at(int r, const float* a, float w0, float f, float* out) {
  switch (r) {
    case 0: lerp<V, 0>(a, w0, f, out); break;
    case 1: lerp<V, 1>(a, w0, f, out); break;
    case 2: lerp<V, 2>(a, w0, f, out); break;
    case 3: lerp<V, 3>(a, w0, f, out); break;
    default:
      if constexpr (V == 8) {
        switch (r) {
          case 4: lerp<V, 4>(a, w0, f, out); break;
          case 5: lerp<V, 5>(a, w0, f, out); break;
          case 6: lerp<V, 6>(a, w0, f, out); break;
          default: lerp<V, 7>(a, w0, f, out); break;
        }
      }
  }
}

template <typename T>
__device__ __forceinline__ void vector_row(const T* xr, T* orow, int L, int l_out, int k,
                                           float w0, float f, int lane) {
  constexpr int V = Vec<T>::N;
  const uint4* xin = reinterpret_cast<const uint4*>(xr);
  uint4* xo = reinterpret_cast<uint4*>(orow);
  const int n_in = L / V, n_out = l_out / V;
  const int q = k >= 0 ? k / V : -((-k + V - 1) / V);  // floor(k / V)
  const int r = k - q * V;                              // in [0, V)
  for (int base = 0; base < n_out; base += 32 * UNROLL) {
    uint4 lo[UNROLL], hi[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      // Output vector j needs input vectors q + j and q + j + 1: those up to
      // q + n_out.
      const int j = base + 32 * u + lane;
      lo[u] = load_or_zero(xin, q + j, n_in, j <= n_out);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + 32 * u + lane;
      hi[u] = shfl_down(lo[u]);
      if (lane == 31) hi[u] = load_or_zero(xin, q + j + 1, n_in, j + 1 <= n_out);
      if (j < n_out) {
        float a[2 * V], out[V];
        unpack(lo[u], a, T());
        unpack(hi[u], a + V, T());
        lerp_at<V>(r, a, w0, f, out);
        xo[j] = pack(out, T());
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void scalar_row(const T* xr, T* orow, int L, int l_out, int k,
                                           float w0, float f, int lane) {
  for (int l = lane; l < l_out; l += 32) {
    const int j = l + k;
    const float a = (j >= 0 && j < L) ? to_f32(xr[j]) : 0.f;
    const float c = (j + 1 >= 0 && j + 1 < L) ? to_f32(xr[j + 1]) : 0.f;
    orow[l] = from_f32<T>(a * w0 + c * f);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
row_shift_kernel(const T* __restrict__ x, const float* __restrict__ off, T* __restrict__ out,
                 int B, int L, int l_out, bool vec) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= B) return;  // the whole warp leaves together
  const T* xr = x + row * (size_t)L;
  T* orow = out + row * (size_t)l_out;
  const float o = off[row];
  const float kf = floorf(o);
  // A shift outside [-(l_out + 1), L] reads nothing in frame for any output;
  // the test also catches NaN and +-inf and keeps the int conversion in
  // range.  Those rows come out NaN (their fraction is NaN, as in the JAX
  // package), a finite shift out of frame zero.
  if (!(kf >= -(float)l_out - 1.f && kf <= (float)L)) {
    if (!isfinite(o)) {
      for (int l = lane; l < l_out; l += 32) orow[l] = from_f32<T>(__int_as_float(0x7fc00000));
    } else if (vec) {
      for (int j = lane; j < l_out / Vec<T>::N; j += 32)
        reinterpret_cast<uint4*>(orow)[j] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int l = lane; l < l_out; l += 32) orow[l] = from_f32<T>(0.f);
    }
    return;
  }
  const int k = (int)kf;
  const float f = o - kf;
  const float w0 = 1.f - f;
  if (vec)
    vector_row<T>(xr, orow, L, l_out, k, w0, f, lane);
  else
    scalar_row<T>(xr, orow, L, l_out, k, w0, f, lane);
}

template <typename T>
cudaError_t launch(const void* x, const float* off, void* out, int B, int L, int l_out,
                   cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const bool vec = ((uintptr_t)x | (uintptr_t)out) % 16 == 0 && L % V == 0 && l_out % V == 0;
  const int blocks = (int)(((long long)B + ROWS - 1) / ROWS);
  row_shift_kernel<T><<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(x), off,
                                                     static_cast<T*>(out), B, L, l_out, vec);
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
