// Elementwise fake quantization Q(I,F), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/quant_cast.py ::
// _quant_cast_kernel (reached through quant_cast_2d and ops.quant_cast).
// Per element, in float32:
//   s = x * 2^F                      (__fmul_rn: no contraction into an FMA)
//   q = trunc(s + copysign(0.5, s))  (round half away from zero, literally:
//                                    roundf differs at 0.49999997, where
//                                    s + 0.5 rounds up to 1.0 in float32;
//                                    rintf rounds half to even)
//   q = clip(q, qmin, qmax)          (by comparisons, so a NaN stays NaN
//                                    as in jnp.clip)
//   y = q * 2^-F                     (exact: a power of two)
// and y is stored in the input's type (bf16 by __float2bfloat16_rn, the
// round-to-nearest-even of a torch cast). It equals
// repro_torch.core.fixedpoint.fake_quant bit for bit. 2^F, 2^-F, qmin and
// qmax come from the caller as floats made by ldexp (exact powers of two).
// Built without --use_fast_math.
//
// What bounds it on an H100: bytes. It reads and writes each element once
// and does ~6 flops per element. Design: a grid-stride loop over 16-byte
// vectors (4 float32 or 8 bf16 per thread per step), so every load and
// store is one 128-bit access, and a scalar loop for the tail (or for
// everything, when a pointer is not 16-byte aligned).
//
// Built by repro_torch/kernels/build.py into a shared library with the
// plain C interface at the bottom.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Format {
  float scale, inv_scale, qmin, qmax;
};

__device__ __forceinline__ float fake_quant(float x, const Format& f) {
  const float s = __fmul_rn(x, f.scale);
  float q = truncf(__fadd_rn(s, copysignf(0.5f, s)));
  q = q < f.qmin ? f.qmin : q;
  q = q > f.qmax ? f.qmax : q;
  return __fmul_rn(q, f.inv_scale);
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_cast_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                  long long nvec, Format f) {
  using V = Vec<T>;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const V* xv = reinterpret_cast<const V*>(x);
  V* yv = reinterpret_cast<V*>(y);
  for (long long i = first; i < nvec; i += stride) {
    V a = xv[i];
#pragma unroll
    for (int j = 0; j < V::kN; ++j)
      a.v[j] = from_f32<T>(fake_quant(to_f32(a.v[j]), f));
    yv[i] = a;
  }
  for (long long i = nvec * V::kN + first; i < n; i += stride)
    y[i] = from_f32<T>(fake_quant(to_f32(x[i]), f));
}

template <typename T>
int launch(const void* x, void* y, long long n, Format f, int num_sms,
           cudaStream_t stream) {
  // 16-byte vectors where both pointers allow them, scalars otherwise
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const long long nvec = aligned ? n / Vec<T>::kN : 0;
  const long long work = aligned ? nvec + Vec<T>::kN : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(num_sms) * 16;
  if (blocks > cap) blocks = cap;
  quant_cast_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, nvec, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = fake_quant(x) over n contiguous elements (device pointers). dtype:
// 0 float32, 1 bfloat16. Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
int quant_cast_launch(const void* x, void* y, long long n, int dtype,
                      float scale, float inv_scale, float qmin, float qmax,
                      int num_sms, void* stream) {
  if (n < 0 || num_sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Format f{scale, inv_scale, qmin, qmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, n, f, num_sms, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, n, f, num_sms, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* quant_cast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
