// Paged variable-length GQA attention over a quantized KV pool, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_kv_attention.py
// :: _chunk_kernel (reached through paged_kv_attention_chunk with
// block_kv=False and through paged_kv_attention_decode). It computes, for
// S chunk queries per row b, attention over the row's pages: each page is
// dequantized as grid * page_scale (int8 grid, int4 fields packed 8 per
// int32 word and sign-extended, or float pages), key position pos is
// visible to query i iff pos <= q_start[b] + i and pos < kv_len[b], the
// softmax runs online across pages in float32 with NEG_INF = -1e30 and
// sm_scale = 1/sqrt(hd), and the output is acc / max(l, 1e-30) in float32.
// Query head h belongs to KV head h / G (the reference's
// q.reshape(B, S, KV, G, hd) grouping).
//
// What bounds it on an H100: bytes. Decode reads every visible page of the
// row once per KV head and does ~4 flops per byte read; the page loop is
// the whole cost. Design: one block per (query block, KV head, row); the
// block reads its own page-table entries (no scalar prefetch on Hopper),
// stages a tile of up to 64 keys (whole pages) dequantized into shared
// memory, and stops at the last page a real query of the block can see
// (exact: page 0 always holds a visible key, so a fully masked later page
// would only add exp(-1e30 - m) = 0). Query blocks of one row re-read the
// same pages (bq * G <= 64 rows share a tile), and the products run on
// float32 FMAs: reuse across query blocks, tensor cores (wgmma), TMA
// staging and split-KV decode are left for later.
//
// The KV-head-blocked variant further down (block_kv=True) replaces
// _chunk_kernel_kvblock; its note stands beside it.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with the plain C interface at the bottom.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory floats for R query rows, T staged keys, head dim hd. Rows
// of q and k are padded to hd + 1 floats so that threads reading different
// rows at one column hit different banks.
__host__ __device__ inline size_t smem_floats(int R, int T, int hd) {
  const size_t ld = static_cast<size_t>(hd) + 1;
  return R * ld + static_cast<size_t>(R) * hd + T * ld +
         static_cast<size_t>(T) * hd + static_cast<size_t>(R) * T + 3 * R;
}

// BITS: 0 = float pages (PT float or bf16), 8 = int8 grid, 4 = int4 fields
// packed 8 per int32 word (PT int32, hdw = hd / 8).
template <typename QT, typename PT, int BITS>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const QT* __restrict__ q,           // (B, S, H, hd)
                  const PT* __restrict__ k_pages,     // (P, ps, KV, hdw)
                  const PT* __restrict__ v_pages,     // (P, ps, KV, hdw)
                  const float* __restrict__ k_scale,  // (P,)
                  const float* __restrict__ v_scale,  // (P,)
                  const int* __restrict__ page_table, // (B, NP)
                  const int* __restrict__ q_start,    // (B,)
                  const int* __restrict__ kv_len,     // (B,)
                  float* __restrict__ out,            // (B, S, H, hd)
                  int S, int H, int KV, int hd, int ps, int NP, int bq,
                  int tile_pages, float sm_scale) {
  const int qb = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int R = bq * G;            // query rows of this block: (i, g)
  const int T = tile_pages * ps;   // keys staged per tile
  const int ld = hd + 1;
  const int hdw = (BITS == 4) ? hd / 8 : hd;

  extern __shared__ float smem[];
  float* sq = smem;                // R x ld: queries * sm_scale
  float* sacc = sq + R * ld;       // R x hd: output accumulators
  float* sk = sacc + R * hd;       // T x ld: dequantized keys
  float* sv = sk + T * ld;         // T x hd: dequantized values
  float* ss = sv + T * hd;         // R x T: scores, then probabilities
  float* sm = ss + R * T;          // R: running max
  float* sl = sm + R;              // R: running denominator
  float* sc = sl + R;              // R: this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = qb * bq;          // first chunk query of the block
  for (int i = tid; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const int s = q0 + r / G, h = kh * G + r % G;
    float x = 0.f;
    if (s < S) x = to_f32(q[((static_cast<long long>(b) * S + s) * H + h) * hd + d]) * sm_scale;
    sq[r * ld + d] = x;
    sacc[i] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }

  const int qs = q_start[b], len = kv_len[b];
  const int s_hi = min(q0 + bq, S) - 1;                // last real query
  const int last_pos = min(qs + s_hi, len - 1);        // last visible key
  const int n_pages = min(last_pos / ps + 1, NP);
  __syncthreads();

  for (int p0 = 0; p0 < n_pages; p0 += tile_pages) {
    // stage the tile: whole pages of KV head kh, dequantized to float32
    for (int i = tid; i < T * hdw; i += blockDim.x) {
      const int t = i / hdw, w = i % hdw;
      const int pi = p0 + t / ps;
      float* krow = sk + t * ld;
      float* vrow = sv + t * hd;
      const int vpw = (BITS == 4) ? 8 : 1;
      if (pi < n_pages) {
        const int page = page_table[static_cast<long long>(b) * NP + pi];
        const long long off =
            ((static_cast<long long>(page) * ps + t % ps) * KV + kh) * hdw + w;
        const float ks = k_scale[page], vs = v_scale[page];
        if constexpr (BITS == 4) {
          const int kw = static_cast<int>(k_pages[off]);
          const int vw = static_cast<int>(v_pages[off]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            krow[w * 8 + j] = static_cast<float>((((kw >> (4 * j)) & 15) ^ 8) - 8) * ks;
            vrow[w * 8 + j] = static_cast<float>((((vw >> (4 * j)) & 15) ^ 8) - 8) * vs;
          }
        } else {
          krow[w] = to_f32(k_pages[off]) * ks;
          vrow[w] = to_f32(v_pages[off]) * vs;
        }
      } else {
        for (int j = 0; j < vpw; ++j) {
          krow[w * vpw + j] = 0.f;
          vrow[w * vpw + j] = 0.f;
        }
      }
    }
    __syncthreads();

    // masked scores against absolute query positions
    for (int i = tid; i < R * T; i += blockDim.x) {
      const int r = i / T, t = i % T;
      const int pos = p0 * ps + t;
      const int qpos = qs + q0 + r / G;
      const float* qr = sq + r * ld;
      const float* kr = sk + t * ld;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
      ss[i] = (pos <= qpos && pos < len) ? acc : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per row
    const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
    for (int r = warp; r < R; r += nwarps) {
      float* row = ss + r * T;
      float mx = kNegInf;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < T; t += 32) {
        const float e = expf(row[t] - m_new);
        row[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sl[r] = sl[r] * corr + sum;
        sm[r] = m_new;
        sc[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v
    for (int i = tid; i < R * hd; i += blockDim.x) {
      const int r = i / hd, d = i % hd;
      const float* pr = ss + r * T;
      float a = sacc[i] * sc[r];
      for (int t = 0; t < T; ++t) a = fmaf(pr[t], sv[t * hd + d], a);
      sacc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const int s = q0 + r / G;
    if (s < S) {
      const int h = kh * G + r % G;
      out[((static_cast<long long>(b) * S + s) * H + h) * hd + d] =
          sacc[i] / fmaxf(sl[r], 1e-30f);
    }
  }
}

// ---------------------------------------------------------------------------
// The KV-head-blocked variant (block_kv=True).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_kv_attention.py
// :: _chunk_kernel_kvblock. Same math as paged_attn_kernel; one block per
// (query block, row) walks the row's pages and stages each WHOLE page, all
// KV heads (a contiguous (ps, KV, hdw) run of the pool), so every visible
// page is read once per query block instead of once per KV head and query
// block. What bounds it on an H100: bytes, as the default kernel. The
// softmax state covers KV * bq * G rows, one mask shared by every head. Decode gives only B * nq blocks, so the block is wide
// (1024 threads) and its loops run over all heads at once. Staged keys
// are laid out [head][key] so that the threads of a warp, on neighbouring
// keys of one head, read different banks. The per-row arithmetic is the
// default kernel's; only the tile of keys per online-softmax step may
// differ, so the two agree to float rounding, not bitwise.
// ---------------------------------------------------------------------------
constexpr int kThreadsKV = 1024;

// Shared-memory floats for RR = KV * R query rows, T staged keys per head.
__host__ __device__ inline size_t smem_floats_kvblock(int RR, int T, int KV,
                                                      int hd) {
  const size_t ld = static_cast<size_t>(hd) + 1;
  const size_t TK = static_cast<size_t>(T) * KV;
  return RR * ld + static_cast<size_t>(RR) * hd + TK * ld + TK * hd +
         static_cast<size_t>(RR) * T + 3 * static_cast<size_t>(RR);
}

template <typename QT, typename PT, int BITS>
__global__ void __launch_bounds__(kThreadsKV)
paged_attn_kvblock_kernel(const QT* __restrict__ q,           // (B, S, H, hd)
                          const PT* __restrict__ k_pages,     // (P, ps, KV, hdw)
                          const PT* __restrict__ v_pages,     // (P, ps, KV, hdw)
                          const float* __restrict__ k_scale,  // (P,)
                          const float* __restrict__ v_scale,  // (P,)
                          const int* __restrict__ page_table, // (B, NP)
                          const int* __restrict__ q_start,    // (B,)
                          const int* __restrict__ kv_len,     // (B,)
                          float* __restrict__ out,            // (B, S, H, hd)
                          int S, int H, int KV, int hd, int ps, int NP, int bq,
                          int tile_pages, float sm_scale) {
  const int qb = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int R = bq * G;            // query rows of one head: (i, g)
  const int RR = KV * R;           // rows of the block: (head, i, g)
  const int T = tile_pages * ps;   // keys staged per tile
  const int ld = hd + 1;
  const int hdw = (BITS == 4) ? hd / 8 : hd;
  const int vpw = (BITS == 4) ? 8 : 1;

  extern __shared__ float smem[];
  float* sq = smem;                // RR x ld: queries * sm_scale
  float* sacc = sq + RR * ld;      // RR x hd: output accumulators
  float* sk = sacc + RR * hd;      // (KV x T) x ld: dequantized keys
  float* sv = sk + KV * T * ld;    // (KV x T) x hd: dequantized values
  float* ss = sv + KV * T * hd;    // RR x T: scores, then probabilities
  float* sm = ss + RR * T;         // RR: running max
  float* sl = sm + RR;             // RR: running denominator
  float* sc = sl + RR;             // RR: this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = qb * bq;
  for (int i = tid; i < RR * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const int kh = r / R, rr = r % R;
    const int s = q0 + rr / G, h = kh * G + rr % G;
    float x = 0.f;
    if (s < S) x = to_f32(q[((static_cast<long long>(b) * S + s) * H + h) * hd + d]) * sm_scale;
    sq[r * ld + d] = x;
    sacc[i] = 0.f;
  }
  for (int r = tid; r < RR; r += blockDim.x) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }

  const int qs = q_start[b], len = kv_len[b];
  const int s_hi = min(q0 + bq, S) - 1;                // last real query
  const int last_pos = min(qs + s_hi, len - 1);        // last visible key
  const int n_pages = min(last_pos / ps + 1, NP);
  const int page_words = KV * hdw;                     // words of one key
  __syncthreads();

  for (int p0 = 0; p0 < n_pages; p0 += tile_pages) {
    // stage the tile: whole pages, every KV head, dequantized to float32
    for (int i = tid; i < T * page_words; i += blockDim.x) {
      const int t = i / page_words, rem = i % page_words;
      const int kh = rem / hdw, w = rem % hdw;
      const int pi = p0 + t / ps;
      float* krow = sk + (kh * T + t) * ld;
      float* vrow = sv + (kh * T + t) * hd;
      if (pi < n_pages) {
        const int page = page_table[static_cast<long long>(b) * NP + pi];
        const long long off =
            (static_cast<long long>(page) * ps + t % ps) * page_words + rem;
        const float ks = k_scale[page], vs = v_scale[page];
        if constexpr (BITS == 4) {
          const int kw = static_cast<int>(k_pages[off]);
          const int vw = static_cast<int>(v_pages[off]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            krow[w * 8 + j] = static_cast<float>((((kw >> (4 * j)) & 15) ^ 8) - 8) * ks;
            vrow[w * 8 + j] = static_cast<float>((((vw >> (4 * j)) & 15) ^ 8) - 8) * vs;
          }
        } else {
          krow[w] = to_f32(k_pages[off]) * ks;
          vrow[w] = to_f32(v_pages[off]) * vs;
        }
      } else {
        for (int j = 0; j < vpw; ++j) {
          krow[w * vpw + j] = 0.f;
          vrow[w * vpw + j] = 0.f;
        }
      }
    }
    __syncthreads();

    // masked scores; one causal/length mask for every head
    for (int i = tid; i < RR * T; i += blockDim.x) {
      const int r = i / T, t = i % T;
      const int kh = r / R;
      const int pos = p0 * ps + t;
      const int qpos = qs + q0 + (r % R) / G;
      const float* qr = sq + r * ld;
      const float* kr = sk + (kh * T + t) * ld;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
      ss[i] = (pos <= qpos && pos < len) ? acc : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per row
    const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
    for (int r = warp; r < RR; r += nwarps) {
      float* row = ss + r * T;
      float mx = kNegInf;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < T; t += 32) {
        const float e = expf(row[t] - m_new);
        row[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sl[r] = sl[r] * corr + sum;
        sm[r] = m_new;
        sc[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v, per head
    for (int i = tid; i < RR * hd; i += blockDim.x) {
      const int r = i / hd, d = i % hd;
      const float* pr = ss + r * T;
      const float* vh = sv + (r / R) * T * hd + d;
      float a = sacc[i] * sc[r];
      for (int t = 0; t < T; ++t) a = fmaf(pr[t], vh[t * hd], a);
      sacc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < RR * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const int kh = r / R, rr = r % R;
    const int s = q0 + rr / G;
    if (s < S) {
      const int h = kh * G + rr % G;
      out[((static_cast<long long>(b) * S + s) * H + h) * hd + d] =
          sacc[i] / fmaxf(sl[r], 1e-30f);
    }
  }
}

template <typename QT, typename PT, int BITS>
int launch(bool block_kv, const void* q, const void* k_pages,
           const void* v_pages, const float* k_scale, const float* v_scale,
           const int* page_table, const int* q_start, const int* kv_len,
           float* out, int B, int S, int H, int KV, int hd, int ps, int NP,
           int bq, int tile_pages, float sm_scale, cudaStream_t stream) {
  const int R = bq * (H / KV);
  const dim3 grid_kv((S + bq - 1) / bq, KV, B), grid_blk((S + bq - 1) / bq, B);
  const size_t smem =
      (block_kv ? smem_floats_kvblock(KV * R, tile_pages * ps, KV, hd)
                : smem_floats(R, tile_pages * ps, hd)) * sizeof(float);
  auto kern = block_kv ? paged_attn_kvblock_kernel<QT, PT, BITS>
                       : paged_attn_kernel<QT, PT, BITS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<block_kv ? grid_blk : grid_kv, block_kv ? kThreadsKV : kThreads,
         smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages), k_scale, v_scale, page_table, q_start,
      kv_len, out, S, H, KV, hd, ps, NP, bq, tile_pages, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_pages(bool block_kv, int page_dtype, int bits, const void* q,
                   const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* pt, const int* qs,
                   const int* lens, float* out, int B, int S, int H, int KV,
                   int hd, int ps, int NP, int bq, int tile_pages,
                   float sm_scale, cudaStream_t stream) {
  // page_dtype: 0 float32, 1 bfloat16, 2 int8, 3 int32
  if (bits == 8 && page_dtype == 2)
    return launch<QT, int8_t, 8>(block_kv, q, kp, vp, ks, vs, pt, qs, lens,
                                 out, B, S, H, KV, hd, ps, NP, bq, tile_pages,
                                 sm_scale, stream);
  if (bits == 4 && page_dtype == 3)
    return launch<QT, int32_t, 4>(block_kv, q, kp, vp, ks, vs, pt, qs, lens,
                                  out, B, S, H, KV, hd, ps, NP, bq, tile_pages,
                                  sm_scale, stream);
  if (bits == 0 && page_dtype == 0)
    return launch<QT, float, 0>(block_kv, q, kp, vp, ks, vs, pt, qs, lens, out,
                                B, S, H, KV, hd, ps, NP, bq, tile_pages,
                                sm_scale, stream);
  if (bits == 0 && page_dtype == 1)
    return launch<QT, __nv_bfloat16, 0>(block_kv, q, kp, vp, ks, vs, pt, qs,
                                        lens, out, B, S, H, KV, hd, ps, NP, bq,
                                        tile_pages, sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, so the caller can size its tile.
size_t paged_kv_attention_smem_bytes(int rows, int tile_keys, int hd) {
  return smem_floats(rows, tile_keys, hd) * sizeof(float);
}

// The same for the KV-head-blocked kernel: `rows` query rows per head.
size_t paged_kv_attention_kvblock_smem_bytes(int rows, int tile_keys, int kv,
                                             int hd) {
  return smem_floats_kvblock(kv * rows, tile_keys, kv, hd) * sizeof(float);
}

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// q_dtype: 0 float32, 1 bfloat16; block_kv: 0 the per-head kernel, 1 the
// KV-head-blocked one. All pointers are device pointers to
// contiguous tensors of the shapes in the kernel's comments.
int paged_kv_attention_launch(const void* q, const void* k_pages,
                              const void* v_pages, const float* k_scale,
                              const float* v_scale, const int* page_table,
                              const int* q_start, const int* kv_len,
                              float* out, int B, int S, int H, int KV, int hd,
                              int ps, int NP, int bits, int q_dtype,
                              int page_dtype, int block_q, int tile_pages,
                              int block_kv, float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || block_q <= 0 ||
      tile_pages <= 0 || (bits == 4 && hd % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_pages<float>(block_kv != 0, page_dtype, bits, q, k_pages,
                                 v_pages, k_scale, v_scale, page_table,
                                 q_start, kv_len, out, B, S, H, KV, hd, ps,
                                 NP, block_q, tile_pages, sm_scale, st);
  if (q_dtype == 1)
    return dispatch_pages<__nv_bfloat16>(
        block_kv != 0, page_dtype, bits, q, k_pages, v_pages, k_scale,
        v_scale, page_table, q_start, kv_len, out, B, S, H, KV, hd, ps, NP,
        block_q, tile_pages, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_kv_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
