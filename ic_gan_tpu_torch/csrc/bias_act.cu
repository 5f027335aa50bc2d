// Fused bias + activation + gain + clamp for Hopper (sm_90a), forward and
// backward:
//   forward   y  = clamp(gain * act(x + b), -clamp, clamp)
//   backward  gx = gy * (act'(x + b) * gain) * [|gain * act(x + b)| <= clamp]
//
// The forward replaces the TPU kernel ic_gan_tpu/ops/pallas/bias_act.py:_forward
// (bodies _kernel_bias / _kernel_nobias).  The backward is the one elementwise
// pass that XLA fuses the JAX custom_jvp's tangent into (_fused_bias_jvp,
// the formula of ic_gan_tpu/ops/bias_act.py differentiated), as upstream's
// CUDA op has gradient modes for the same reason.  Same function over the
// nine activations of ic_gan_tpu/ops/bias_act.py: the arithmetic in f32, one
// rounding to the output's type.  The bias lies along one dim: element i takes
// b[(i / inner) % C], so NCHW activations (inner = H*W) and (N, C) features
// (inner = 1) both run with no transpose; there is no shape gate.
//
// Bound on the H100: a handful of operations per element against 4 (bf16) or
// 8 (f32) bytes moved forward, 6 or 12 backward, far below the ~295 FLOP/byte
// ridge, so bytes bound both.  At the StyleGAN2 256^2 blocks' largest call,
// (16, 64, 256, 256) bf16, the forward moves 2 x 134 MB (0.080 ms at 3.35
// TB/s), the backward 3 x 134 MB (0.120 ms).
//
// Design, for the memory system:
// - 16-byte accesses: a thread moves 8 bf16 or 4 f32 per load and store, and
//   keeps UNROLL such vectors (per operand) in flight, so that an SM has
//   enough bytes outstanding to cover HBM latency.  Lane t of a block reads
//   vector base + u*THREADS + t, so each warp's access is 512 contiguous bytes.
//   Two vectors a thread in blocks of 128 beat four, or blocks of 256 and 512,
//   on the card at the path shape: fewer registers a thread let more blocks
//   stay resident, and that hides the latency better than a deeper unroll.
// - No division per element: the channel is formed once per vector.  Where
//   inner % VEC == 0 (every conv layer: the smallest plane is 4x4 = 16) a
//   vector lies in one plane and takes one bias value; where inner == 1 and
//   C % VEC == 0 (the fully connected layers) it covers VEC consecutive
//   channels and the bias is read as a vector too.  The index arithmetic is
//   32-bit when the tensor allows.  (A 2-D grid over planes would need no
//   division at all, but gives 4x4 planes a block of 256 threads for 16
//   elements and the plane count a grid-dimension limit; one flat loop covers
//   every plane size and count with full blocks.)
// - The activation, the bias's presence and the clamp's presence are template
//   parameters: one dispatch per launch, none per element.
// - A scalar path inside the same kernel takes what the vectors cannot: a
//   pointer that is not 16-byte aligned, a bias layout that breaks the vector
//   conditions, and the ragged tail of a tensor with no bias.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 2;
constexpr float SELU_SCALE = 1.0507009873554805f;
constexpr float SELU_ALPHA = 1.6732632423543772f;

// Layouts of the vector path (Args::mode).
constexpr int SCALAR = 0;  // every element on the scalar path
constexpr int PLANE = 1;   // a vector lies in one channel (or there is no bias)
constexpr int ROW = 2;     // inner == 1: a vector covers VEC consecutive channels

template <typename T> struct Vec;  // VEC elements of T in 16 bytes
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
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
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
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Activation codes, in the order of the port's activation table: 0 linear,
// 1 relu, 2 lrelu, 3 tanh, 4 sigmoid, 5 elu, 6 selu, 7 softplus, 8 swish.
template <int A> __device__ __forceinline__ float activate(float v, float alpha) {
  if constexpr (A == 1) return fmaxf(v, 0.f);
  else if constexpr (A == 2) return v >= 0.f ? v : v * alpha;
  else if constexpr (A == 3) return tanhf(v);
  else if constexpr (A == 4) return sigmoid(v);
  else if constexpr (A == 5) return v > 0.f ? v : expm1f(v);
  else if constexpr (A == 6) return SELU_SCALE * (v > 0.f ? v : SELU_ALPHA * expm1f(v));
  else if constexpr (A == 7) return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  else if constexpr (A == 8) return v * sigmoid(v);
  else return v;
}

// act'(v), as the port's plain formula has it (lrelu: slope 1 at v >= 0).
template <int A> __device__ __forceinline__ float derivative(float v, float alpha) {
  if constexpr (A == 1) return v > 0.f ? 1.f : 0.f;
  else if constexpr (A == 2) return v >= 0.f ? 1.f : alpha;
  else if constexpr (A == 3) { const float t = tanhf(v); return 1.f - t * t; }
  else if constexpr (A == 4) { const float s = sigmoid(v); return s * (1.f - s); }
  else if constexpr (A == 5) return v > 0.f ? 1.f : expf(v);
  else if constexpr (A == 6) return SELU_SCALE * (v > 0.f ? 1.f : SELU_ALPHA * expf(v));
  else if constexpr (A == 7) return sigmoid(v);
  else if constexpr (A == 8) { const float s = sigmoid(v); return s * (1.f + v * (1.f - s)); }
  else return 1.f;
}

struct Args {
  const void* x;
  const void* gy;   // backward only
  const void* b;    // null: no bias
  void* y;          // forward: y; backward: gx
  long long n;      // elements
  long long nvec;   // elements [0, nvec * VEC) take the vector path
  long long inner;  // elements per channel step
  int C;
  int mode;         // SCALAR, PLANE or ROW
  bool small;       // n < 2^31: 32-bit index arithmetic
  float alpha, gain, clamp;
};

// One element, from its pre-activation v = x + b (and, backward, gy).
template <int A, bool CLAMP, bool BWD>
__device__ __forceinline__ float element(float v, float g, const Args& a) {
  if constexpr (BWD) {
    float gx = g * (derivative<A>(v, a.alpha) * a.gain);
    if constexpr (CLAMP) {
      if (!(fabsf(activate<A>(v, a.alpha) * a.gain) <= a.clamp)) gx = 0.f;
    }
    return gx;
  } else {
    float y = activate<A>(v, a.alpha) * a.gain;
    if constexpr (CLAMP) y = fminf(fmaxf(y, -a.clamp), a.clamp);
    return y;
  }
}

// (q / inner) % C in 32 bits when the tensor allows.
__device__ __forceinline__ int channel(long long q, long long inner, int C, bool small) {
  if (small) return (int)(((uint32_t)q / (uint32_t)inner) % (uint32_t)C);
  return (int)((q / inner) % C);
}

template <typename T, int A, bool HAS_B, bool CLAMP, bool BWD>
__device__ __forceinline__ void body(const Args& a) {
  constexpr int V = Vec<T>::N;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ gy = static_cast<const T*>(a.gy);
  const T* __restrict__ b = static_cast<const T*>(a.b);
  T* __restrict__ y = static_cast<T*>(a.y);

  // The vector path: UNROLL vectors per thread per iteration.
  const long long chunk = (long long)THREADS * UNROLL;
  const long long inner_v = a.inner / V;  // PLANE: vectors per channel step
  for (long long base = (long long)blockIdx.x * chunk; base < a.nvec;
       base += (long long)gridDim.x * chunk) {
    float xv[UNROLL][V];
    float gv[UNROLL][BWD ? V : 1];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long q = base + u * THREADS + threadIdx.x;
      if (q < a.nvec) {
        load_vec(x + q * V, xv[u]);
        if constexpr (BWD) load_vec(gy + q * V, gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long q = base + u * THREADS + threadIdx.x;
      if (q >= a.nvec) continue;
      if constexpr (HAS_B) {
        if (a.mode == ROW) {
          // C % V == 0, so the vector's channels start at a multiple of V.
          const int c0 = (int)(a.small ? (uint32_t)q % (uint32_t)(a.C / V)
                                       : q % (long long)(a.C / V)) * V;
          float bv[V];
          load_vec(b + c0, bv);
#pragma unroll
          for (int i = 0; i < V; ++i) xv[u][i] += bv[i];
        } else {
          const float bb = to_f32(b[channel(q, inner_v, a.C, a.small)]);
#pragma unroll
          for (int i = 0; i < V; ++i) xv[u][i] += bb;
        }
      }
      float out[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        out[i] = element<A, CLAMP, BWD>(xv[u][i], BWD ? gv[u][BWD ? i : 0] : 0.f, a);
      store_vec(y + q * V, out);
    }
  }

  // The scalar path: the rest, one element per thread per iteration.
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = a.nvec * V + (long long)blockIdx.x * THREADS + threadIdx.x; i < a.n;
       i += stride) {
    float v = to_f32(x[i]);
    if constexpr (HAS_B) v += to_f32(b[channel(i, a.inner, a.C, a.small)]);
    const float g = BWD ? to_f32(gy[i]) : 0.f;
    y[i] = from_f32<T>(element<A, CLAMP, BWD>(v, g, a));
  }
}

template <typename T, int A, bool HAS_B, bool CLAMP>
__global__ void __launch_bounds__(THREADS) bias_act_fwd_kernel(const Args a) {
  body<T, A, HAS_B, CLAMP, false>(a);
}

template <typename T, int A, bool HAS_B, bool CLAMP>
__global__ void __launch_bounds__(THREADS) bias_act_bwd_kernel(const Args a) {
  body<T, A, HAS_B, CLAMP, true>(a);
}

template <typename T, bool BWD, int A, bool HAS_B, bool CLAMP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long work = a.nvec > 0 ? (a.nvec + THREADS * UNROLL - 1) / (THREADS * UNROLL)
                                    : (a.n + THREADS - 1) / THREADS;
  const int blocks = (int)(work < (1LL << 20) ? work : (1LL << 20));  // the loops take the rest
  if constexpr (BWD)
    bias_act_bwd_kernel<T, A, HAS_B, CLAMP><<<blocks, THREADS, 0, stream>>>(a);
  else
    bias_act_fwd_kernel<T, A, HAS_B, CLAMP><<<blocks, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool BWD, int A>
cudaError_t dispatch_flags(const Args& a, cudaStream_t s) {
  const bool clamp = a.clamp >= 0.f;
  if (a.b != nullptr)
    return clamp ? launch<T, BWD, A, true, true>(a, s) : launch<T, BWD, A, true, false>(a, s);
  return clamp ? launch<T, BWD, A, false, true>(a, s) : launch<T, BWD, A, false, false>(a, s);
}

template <typename T, bool BWD>
cudaError_t dispatch(Args a, int act, cudaStream_t s) {
  constexpr int V = Vec<T>::N;
  // The vector path needs every pointer it moves vectors through 16-byte
  // aligned, and vectors that do not straddle a channel boundary.
  const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.y | (BWD ? (uintptr_t)a.gy : 0);
  a.mode = SCALAR;
  if (ptrs % 16 == 0) {
    if (a.b == nullptr || a.inner % V == 0)
      a.mode = PLANE;
    else if (a.inner == 1 && a.C % V == 0 && (uintptr_t)a.b % 16 == 0)
      a.mode = ROW;
  }
  a.nvec = a.mode == SCALAR ? 0 : a.n / V;
  a.small = a.n < (1LL << 31);
  switch (act) {
    case 0: return dispatch_flags<T, BWD, 0>(a, s);
    case 1: return dispatch_flags<T, BWD, 1>(a, s);
    case 2: return dispatch_flags<T, BWD, 2>(a, s);
    case 3: return dispatch_flags<T, BWD, 3>(a, s);
    case 4: return dispatch_flags<T, BWD, 4>(a, s);
    case 5: return dispatch_flags<T, BWD, 5>(a, s);
    case 6: return dispatch_flags<T, BWD, 6>(a, s);
    case 7: return dispatch_flags<T, BWD, 7>(a, s);
    case 8: return dispatch_flags<T, BWD, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool bwd, const void* gy, const void* x, const void* b, void* out, long long n, int C,
        long long inner, int act, float alpha, float gain, float clamp, int dtype,
        void* stream) {
  if (n <= 0 || C <= 0 || inner <= 0 || act < 0 || act > 8) return (int)cudaErrorInvalidValue;
  Args a{x, gy, b, out, n, 0, inner, C, SCALAR, false, alpha, gain, clamp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(bwd ? dispatch<float, true>(a, act, s) : dispatch<float, false>(a, act, s));
  if (dtype == 1)
    return (int)(bwd ? dispatch<__nv_bfloat16, true>(a, act, s)
                     : dispatch<__nv_bfloat16, false>(a, act, s));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y: n elements (contiguous); b: C elements or null, element i taking
// b[(i / inner) % C].  act: 0 linear, 1 relu, 2 lrelu, 3 tanh, 4 sigmoid,
// 5 elu, 6 selu, 7 softplus, 8 swish.  clamp < 0 means none.  dtype: 0 =
// float32, 1 = bfloat16 (x, b and y alike).  Returns a cudaError_t (0 on
// success); the launch is asynchronous on `stream` and allocates nothing.
extern "C" int bias_act_fwd(const void* x, const void* b, void* y, long long n, int C,
                            long long inner, int act, float alpha, float gain, float clamp,
                            int dtype, void* stream) {
  return run(false, nullptr, x, b, y, n, C, inner, act, alpha, gain, clamp, dtype, stream);
}

// gx = gy * (act'(x + b) * gain), zero where |gain * act(x + b)| > clamp (or
// is NaN) when clamp >= 0.  gy, x, gx: n elements (contiguous), of one type;
// the rest as bias_act_fwd.
extern "C" int bias_act_bwd(const void* gy, const void* x, const void* b, void* gx,
                            long long n, int C, long long inner, int act, float alpha,
                            float gain, float clamp, int dtype, void* stream) {
  return run(true, gy, x, b, gx, n, C, inner, act, alpha, gain, clamp, dtype, stream);
}
