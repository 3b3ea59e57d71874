// Matrix product with an integer-grid weight and per-channel scales, for
// sm_90a: out (M, N) f32 = (a (M, K) f32|bf16 @ wq (K, N) int8|int16) * s.
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul.py :: _qmm_kernel
// (reached through quant_matmul and ops.qmatmul). As there, the int grid is
// converted tile by tile on chip (int8 and int16 convert exactly), never
// written back as a dequantized weight, and the per-output-channel scales
// multiply once, after the whole K sum. No TF32 anywhere.
//
// What bounds it on an H100: at decode (M of a few rows) bytes, the int8
// weight read once (242 MB for qwen2-72b's up-projection); at M = 256
// operations. Two kernels, chosen by the wrapper from the call (dtype,
// shape and alignment; a failed build or launch raises, nothing falls back):
//
// qmm_mma_kernel, the tensor-core kernel (an int8 grid, N % 16 == 0, rows of
// a 16-byte aligned). mma.sync m16n8k16 on bf16 operands, float32
// accumulation in the fragments:
//  - the weight is the MMA's B operand exactly, as its int8 grid: 16-byte
//    cp.async copies of raw int8 tiles go into a ring of 3 stages; each
//    tile is widened to bf16 once per block (widen16, exact, no conversion
//    instructions) into a bf16 tile that the warps read with
//    ldmatrix.trans, as the attention kernel reads V;
//  - a bf16 `a` is an exact A operand, read with ldmatrix from its staged
//    tile; a float32 `a` is split, once per staged tile, into kParts = 2
//    bf16 parts (hi = bf16(x), lo = bf16(x - hi); ~2^-17 relative), two
//    MMAs per fragment;
//  - one template, two tiles: decode (M <= 32) 32 x 128 blocks of 4 warps,
//    each warp 32 x 32 (m-tiles past the last real row are skipped, so 8
//    rows issue one MMA row), with split-K planned by the wrapper so that
//    the grid fills the card; prefill 128 x 128 blocks of 8 warps, each
//    64 x 32, at most 128 registers so two blocks fit an SM;
//  - split-K: each split covers a contiguous run of K steps and writes its
//    float32 partial to a workspace (splits, M, N); qmm_merge_kernel sums
//    the partials in split order and multiplies by the scales
//    (deterministic, no atomics). One split applies the scales itself.
//
// qmm_kernel, the float32-FMA kernel (int16 grids, N not
// a multiple of 16, unaligned rows): the classic shared-memory tiled
// product, one block per (BM x BN) output tile walking K in BK steps, each
// thread holding a TM x TN register tile; BM = 16 for a few rows and
// 128 x 128 for many. Ragged M, N and K are masked (zero-filled tiles).
//
// Built by repro_torch/kernels/build.py into a shared library with the
// plain C interface at the bottom.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int kParts = 2;    // bf16 parts of a float32 `a`

// BM x BN block tiles stepping BK of K, warp tiles WM x WN, a ring of
// STAGES raw tiles, registers capped for MINB blocks per SM
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_, int MINB_>
struct QmmTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr int WARPS = (BM / WM) * (BN / WN);
  static constexpr int THREADS = WARPS * 32;
};
using DecodeTile = QmmTile<32, 128, 64, 32, 32, 3, 4>;
using PrefillTile = QmmTile<128, 128, 32, 64, 32, 3, 2>;

// Shared memory of one block, in bytes: the ring of raw weight tiles
// (BK rows of BN int8), the ring of raw `a` tiles (BM rows of BK values;
// bf16 rows padded by 16 bytes so ldmatrix reads them without bank
// conflicts), the widened bf16 weight tile (rows padded by 16 bytes) and,
// for a float32 `a`, its kParts bf16 part tiles.
template <typename AT, typename T>
struct QmmSmem {
  static constexpr bool F32 = std::is_same<AT, float>::value;
  static constexpr int W_RAW = T::BK * T::BN;
  static constexpr int A_PITCH = T::BK * static_cast<int>(sizeof(AT)) +
                                 (F32 ? 0 : 16);
  static constexpr int A_RAW = T::BM * A_PITCH;
  static constexpr int WIDE_PITCH = 2 * T::BN + 16;
  static constexpr int PART_PITCH = 2 * T::BK + 16;
  static constexpr int PART = T::BM * PART_PITCH;
  static constexpr int a_raw = T::STAGES * W_RAW;
  static constexpr int wide = a_raw + T::STAGES * A_RAW;
  static constexpr int parts = wide + T::BK * WIDE_PITCH;
  static constexpr int total = parts + (F32 ? kParts * PART : 0);
};

struct QmmArgs {
  const void* a;            // (M, K) float32 or bf16
  const int8_t* w;          // (K, N) int8 grid
  const float* scales;      // (N,)
  float* out;               // (M, N)
  float* part;              // (n_splits, M, N), n_splits > 1 only
  int M, N, K, steps_per_split, n_splits;
};

// 16 bytes global -> shared, or 16 zero bytes where `full` is false (the
// source is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// One block per (row tile, column tile, split). Warp w owns rows
// wm0 .. wm0 + WM and columns wn0 .. wn0 + WN of the block's tile.
template <typename AT, typename T>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
qmm_mma_kernel(const QmmArgs p) {
  using L = QmmSmem<AT, T>;
  constexpr bool F32 = L::F32;
  constexpr int MT = T::WM / 16, NT = T::WN / 8, KS = T::BK / 16;
  constexpr int EPC = 16 / static_cast<int>(sizeof(AT));  // a values a chunk
  constexpr int ACH = T::BK / EPC;     // 16-byte chunks of a staged a row
  constexpr int WCH = T::BN / 16;      // 16-byte chunks of a weight row
  constexpr int NP = F32 ? kParts : 1;
  static_assert(NT % 2 == 0 && T::BK % 16 == 0, "tile shape");

  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int split = blockIdx.z;
  const int wm0 = warp / (T::BN / T::WN) * T::WM;
  const int wn0 = warp % (T::BN / T::WN) * T::WN;
  // rows staged and multiplied: the block's real rows, rounded up to 16
  const int rows = min(T::BM, (p.M - m0 + 15) / 16 * 16);
  const int ksteps = (p.K + T::BK - 1) / T::BK;
  const int s0 = split * p.steps_per_split;
  const int nsteps = min(s0 + p.steps_per_split, ksteps) - s0;
  const AT* a = static_cast<const AT*>(p.a);

  auto issue = [&](int t) {
    const int slot = t % T::STAGES, k0 = (s0 + t) * T::BK;
    unsigned char* wdst = smem + slot * L::W_RAW;
    for (int i = tid; i < T::BK * WCH; i += T::THREADS) {
      const int r = i / WCH, ch = i % WCH, gk = k0 + r, gn = n0 + 16 * ch;
      const bool ok = gk < p.K && gn < p.N;
      cp_async16_zfill(wdst + r * T::BN + 16 * ch,
                       ok ? p.w + static_cast<long long>(gk) * p.N + gn : p.w,
                       ok);
    }
    unsigned char* adst = smem + L::a_raw + slot * L::A_RAW;
    for (int i = tid; i < rows * ACH; i += T::THREADS) {
      const int r = i / ACH, ch = i % ACH, gm = m0 + r, gk = k0 + EPC * ch;
      const bool ok = gm < p.M && gk < p.K;
      cp_async16_zfill(adst + r * L::A_PITCH + 16 * ch,
                       ok ? a + static_cast<long long>(gm) * p.K + gk : a, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  unsigned char* wide = smem + L::wide;
  constexpr int APITCH = F32 ? L::PART_PITCH : L::A_PITCH;
  // ldmatrix row addresses: B (.trans) k rows (lane % 8) + 8 * ((lane / 8)
  // % 2), column chunk lane / 16; A rows lane % 16, k chunk lane / 16
  const int b_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * L::WIDE_PITCH +
                    (lane >> 4) * 16 + 2 * wn0;
  const int a_off = (wm0 + (lane & 15)) * APITCH + (lane >> 4) * 16;

#pragma unroll
  for (int t = 0; t < T::STAGES - 1; ++t) {
    if (t < nsteps) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    const int slot = t % T::STAGES;
    // groups committed: STAGES - 1 + t; step t's is done when at most
    // STAGES - 2 newer ones are pending
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();   // step t staged; slot (t - 1) % STAGES, the widened
                       // tile and the part tiles free
    if (t + T::STAGES - 1 < nsteps) issue(t + T::STAGES - 1);
    cp_async_commit();
    const unsigned char* wraw = smem + slot * L::W_RAW;
    for (int i = tid; i < T::BK * WCH; i += T::THREADS) {
      const int r = i / WCH, ch = i % WCH;
      widen16<8>(wraw + r * T::BN + 16 * ch, wide + r * L::WIDE_PITCH + 32 * ch);
    }
    const unsigned char* araw = smem + L::a_raw + slot * L::A_RAW;
    const unsigned char* abase = araw;
    if constexpr (F32) {
      // hi = bf16(x), lo = bf16(x - hi), four values a thread a pass
      for (int i = tid; i < rows * (T::BK / 4); i += T::THREADS) {
        const int r = i / (T::BK / 4), q = i % (T::BK / 4);
        const float4 x =
            *reinterpret_cast<const float4*>(araw + r * L::A_PITCH + 16 * q);
        const float h[4] = {bf16_round(x.x), bf16_round(x.y), bf16_round(x.z),
                            bf16_round(x.w)};
        unsigned char* d = smem + L::parts + r * L::PART_PITCH + 8 * q;
        *reinterpret_cast<uint2*>(d) =
            make_uint2(bf16x2(h[0], h[1]), bf16x2(h[2], h[3]));
        *reinterpret_cast<uint2*>(d + L::PART) = make_uint2(
            bf16x2(x.x - h[0], x.y - h[1]), bf16x2(x.z - h[2], x.w - h[3]));
      }
      abase = smem + L::parts;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bf[NT / 2][4];
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp)
        ldmatrix_x4_trans(bf[jp], wide + b_off + 16 * kk * L::WIDE_PITCH +
                                      32 * jp);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (wm0 + 16 * mt >= rows) continue;   // no real row: warp-uniform
#pragma unroll
        for (int pp = 0; pp < NP; ++pp) {
          uint32_t af[4];
          ldmatrix_x4(af, abase + pp * L::PART + a_off + 16 * mt * APITCH +
                              32 * kk);
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            mma_bf16(acc[mt][2 * jp], af, bf[jp][0], bf[jp][1]);
            mma_bf16(acc[mt][2 * jp + 1], af, bf[jp][2], bf[jp][3]);
          }
        }
      }
    }
  }

  // acc[mt][nt][2h + e] is row wm0 + 16 mt + g + 8h, column wn0 + 8 nt +
  // 2c + e; N % 16 == 0, so a column pair is in or out together
  const bool direct = p.n_splits == 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm0 + 16 * mt + g + 8 * h;
      if (row >= p.M) continue;
      float* dst = direct ? p.out + static_cast<long long>(row) * p.N
                          : p.part + (static_cast<long long>(split) * p.M +
                                      row) * p.N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn0 + 8 * nt + 2 * c;
        if (n >= p.N) continue;
        float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (direct) {
          const float2 s = *reinterpret_cast<const float2*>(p.scales + n);
          v.x *= s.x;
          v.y *= s.y;
        }
        *reinterpret_cast<float2*>(dst + n) = v;
      }
    }
}

// out = (sum of the n splits' partials, in split order) * scales; one
// float4 a thread (N % 16 == 0)
__global__ void __launch_bounds__(256)
qmm_merge_kernel(const float4* __restrict__ part,
                 const float4* __restrict__ scales, float4* __restrict__ out,
                 long long mn4, int n4, int n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= mn4) return;
  float4 s = part[i];
  for (int j = 1; j < n; ++j) {
    const float4 v = part[j * mn4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float4 sc = scales[i % n4];
  out[i] = make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w);
}

// Launches the tensor-core kernel (and, with splits, the merge); with
// `query` set, answers a query instead: query[0..5] = resident blocks per
// SM, dynamic shared memory of a block, the tile's BM, BN, BK and the bf16
// parts of an `a` value.
template <typename AT, typename T>
int launch_mma(const QmmArgs& p, cudaStream_t stream, int* query) {
  using L = QmmSmem<AT, T>;
  auto kern = qmm_mma_kernel<AT, T>;
  // once per instantiation and device
  static unsigned long long smem_set = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 64 || !(smem_set >> device & 1ull)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::total);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 64) smem_set |= 1ull << device;
  }
  if (query) {
    query[1] = L::total;
    query[2] = T::BM;
    query[3] = T::BN;
    query[4] = T::BK;
    query[5] = L::F32 ? kParts : 1;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        query, kern, T::THREADS, L::total));
  }
  const long long n_tiles = (p.N + T::BN - 1) / T::BN;
  const long long ksteps = (p.K + T::BK - 1) / T::BK;
  if (p.N % 16 || n_tiles > 65535 || p.n_splits < 1 || p.n_splits > 65535 ||
      p.steps_per_split < 1 ||
      static_cast<long long>(p.steps_per_split) * (p.n_splits - 1) >= ksteps ||
      static_cast<long long>(p.steps_per_split) * p.n_splits < ksteps ||
      (p.n_splits > 1 && p.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.M + T::BM - 1) / T::BM, n_tiles, p.n_splits);
  kern<<<grid, T::THREADS, L::total, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_splits == 1) return static_cast<int>(e);
  const long long mn4 = static_cast<long long>(p.M) * p.N / 4;
  qmm_merge_kernel<<<static_cast<unsigned>((mn4 + 255) / 256), 256, 0,
                     stream>>>(reinterpret_cast<const float4*>(p.part),
                               reinterpret_cast<const float4*>(p.scales),
                               reinterpret_cast<float4*>(p.out), mn4,
                               p.N / 4, p.n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename AT>
int dispatch_tile(int tile, const QmmArgs& p, cudaStream_t st, int* query) {
  if (tile == 0) return launch_mma<AT, DecodeTile>(p, st, query);
  if (tile == 1) return launch_mma<AT, PrefillTile>(p, st, query);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_mma(int a_dtype, int tile, const QmmArgs& p, cudaStream_t st,
                 int* query) {
  if (a_dtype == 0) return dispatch_tile<float>(tile, p, st, query);
  if (a_dtype == 1) return dispatch_tile<__nv_bfloat16>(tile, p, st, query);
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

// The tensor-core kernel: out = (a @ wq) * scales for an int8 grid, with
// `tile` 0 (decode, 32 x 128) or 1 (prefill, 128 x 128), the K steps
// (64 / 32 of K) cut into n_splits runs of steps_per_split; part is the
// (n_splits, M, N) float32 workspace when n_splits > 1. N % 16 == 0 and
// every row of a 16-byte aligned. Returns the cudaError_t of the launches.
int quant_matmul_mma_launch(const void* a, const void* wq, const float* scales,
                            float* out, float* part, int M, int N, int K,
                            int a_dtype, int tile, int steps_per_split,
                            int n_splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const QmmArgs p{a, static_cast<const int8_t*>(wq), scales, out, part,
                  M, N, K, steps_per_split, n_splits};
  return dispatch_mma(a_dtype, tile, p, static_cast<cudaStream_t>(stream),
                      nullptr);
}

// The tensor-core kernel's instantiation (a_dtype, tile), no launch:
// query[0] resident blocks per SM (CUDA's occupancy calculator), query[1]
// dynamic shared memory bytes of a block, query[2..4] its BM, BN, BK,
// query[5] the bf16 parts of an `a` value (kParts for float32, else 1).
int quant_matmul_mma_config(int a_dtype, int tile, int* query) {
  const QmmArgs p{};
  return dispatch_mma(a_dtype, tile, p, nullptr, query);
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
