// Matrix product with an integer-grid weight and per-channel scales, for
// sm_90a: out (M, N) f32 = (a (M, K) f32|bf16 @ wq (K, N) int8|int16) * s.
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul.py :: _qmm_kernel
// (reached through quant_matmul and ops.qmatmul). As there, the int grid is
// converted to float tile by tile on chip (int8 and int16 convert exactly),
// never written back as a dequantized weight, and the per-output-channel
// scales multiply once, after the whole K sum. Every product and sum is a
// float32 FMA (no TF32 anywhere); a bf16 `a` is widened to float32 exactly
// when its tile is staged. Ragged M, N and K are masked (zero-filled tiles),
// never padded by copies.
//
// What bounds it on an H100: at decode (M of a few rows) bytes, the int8
// weight read once (242 MB for qwen2-72b's up-projection); at M = 256
// operations. Design: the classic shared-memory tiled product, one block
// per (BM x BN) output tile walking K in BK steps, each thread holding a
// TM x TN register tile. Two shapes: BM = 16 for a few rows (so the weight
// stream, not wasted rows, sets the time, and N / 64 blocks keep the SMs
// busy) and 128 x 128 for many. The tensor cores (mma.sync / wgmma on bf16
// operands), TMA staging and split-K for decode are left for later.
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

template <typename AT, typename WT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const AT* __restrict__ a,         // (M, K)
           const WT* __restrict__ w,         // (K, N)
           const float* __restrict__ scales, // (N,)
           float* __restrict__ out,          // (M, N)
           int M, int N, int K) {
  constexpr int TX = BN / TN;  // threads along N
  static_assert(TX * (BM / TM) == kThreads, "tile does not match the block");
  __shared__ float sa[BK][BM + 1];  // a tile, transposed; +1 against conflicts
  __shared__ float sw[BK][BN];      // weight tile as float32

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int m = i / BK, k = i % BK, gm = m0 + m, gk = k0 + k;
      sa[k][m] = (gm < M && gk < K)
                     ? to_f32(a[static_cast<long long>(gm) * K + gk])
                     : 0.f;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int k = i / BN, n = i % BN, gk = k0 + k, gn = n0 + n;
      sw[k][n] = (gk < K && gn < N)
                     ? static_cast<float>(w[static_cast<long long>(gk) * N + gn])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float ar[TM], wr[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ar[i] = sa[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wr[j] = sw[k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx + j * TX;
    if (n >= N) continue;
    const float s = scales[n];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m < M) out[static_cast<long long>(m) * N + n] = acc[i][j] * s;
    }
  }
}

template <typename AT, typename WT, int BM, int BN, int BK, int TM, int TN>
int launch_tiled(const void* a, const void* w, const float* s, float* out,
                 int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<AT, WT, BM, BN, BK, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const AT*>(a), static_cast<const WT*>(w), s, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename AT, typename WT>
int launch(const void* a, const void* w, const float* s, float* out, int M,
           int N, int K, cudaStream_t stream) {
  if (M <= 32)
    return launch_tiled<AT, WT, 16, 64, 64, 1, 4>(a, w, s, out, M, N, K,
                                                  stream);
  return launch_tiled<AT, WT, 128, 128, 16, 8, 8>(a, w, s, out, M, N, K,
                                                  stream);
}

template <typename AT>
int dispatch_w(int w_dtype, const void* a, const void* w, const float* s,
               float* out, int M, int N, int K, cudaStream_t stream) {
  if (w_dtype == 0) return launch<AT, int8_t>(a, w, s, out, M, N, K, stream);
  if (w_dtype == 1) return launch<AT, int16_t>(a, w, s, out, M, N, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out = (a @ wq) * scales on `stream`; all contiguous device buffers.
// a_dtype: 0 float32, 1 bfloat16; w_dtype: 0 int8, 1 int16. Returns the
// cudaError_t of the launch (0 = ok).
int quant_matmul_launch(const void* a, const void* wq, const float* scales,
                        float* out, int M, int N, int K, int a_dtype,
                        int w_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M > 65535 * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0)
    return dispatch_w<float>(w_dtype, a, wq, scales, out, M, N, K, st);
  if (a_dtype == 1)
    return dispatch_w<__nv_bfloat16>(w_dtype, a, wq, scales, out, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
