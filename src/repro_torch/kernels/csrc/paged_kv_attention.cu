// Paged variable-length GQA attention over a quantized KV pool, for sm_90a.
//
// Replaces the Pallas TPU kernels of repro/kernels/paged_kv_attention.py:
// _chunk_kernel (B1: paged_kv_attention_chunk with block_kv=False, and
// paged_kv_attention_decode) and _chunk_kernel_kvblock (B2: block_kv=True).
// Both compute, for S chunk queries per row b, attention over the row's
// pages: each page is grid * page_scale (int8 grid, int4 fields packed 8
// per int32 word and sign-extended, or float pages), key position pos is
// visible to query i iff pos <= q_start[b] + i and pos < kv_len[b], the
// softmax runs online across keys in float32 with NEG_INF = -1e30 and
// sm_scale = 1/sqrt(hd), and the output is acc / max(l, 1e-30) in float32.
// Query head h belongs to KV head h / G (the reference's
// q.reshape(B, S, KV, G, hd) grouping).
//
// What bounds them on an H100: bytes at decode (every visible page read
// once per KV head, ~4 flops per byte); at S = 32 with int8/int4 pages,
// operations at the bf16 tensor-core rate. The tensor-core kernels
// (paged_attn_mma_kernel, int8 / int4 / bf16 pages) do this about it:
//  - QK^T and P.V run on mma.sync m16n8k16 (bf16 in, float32 accumulate).
//    The operands are exact: int8 and int4 grid values and bf16 pages are
//    bf16 as they are, so the page's integer grid is the MMA operand and
//    the per-page scales are applied outside it: s = (q . grid_k) *
//    k_scale * sm_scale per key column of the accumulator, and v_scale is
//    folded into P in float32. P * v_scale is split into hi = bf16(x) and
//    lo = bf16(x - hi), two MMAs (~2^-17 relative), and a float32 q into
//    three bf16 parts, which keeps the 1e-4 tolerance against the float32
//    plain version.
//  - Raw page bytes are staged, never a dequantized float tile: B1 copies
//    its KV head's slice of each key row with 16-byte cp.async into a ring
//    of up to 4 tiles of 16 keys; B2 copies whole key rows of every head
//    with cp.async.bulk, completing on an mbarrier per ring slot, and one
//    or two warps per KV head read them. int8/int4 tiles are widened to
//    bf16 once per block in shared memory (exactly, with byte permutes and
//    float bias tricks, no conversion instructions), so the warps sharing
//    a tile do not each convert it; the warps read their fragments with
//    ldmatrix (.trans for V). The block reads its
//    split's page-table entries and scales into shared memory before the
//    first copy, and each slot's per-key scales as it issues the copy.
//  - Split-KV: a host-side planner cuts the page-table columns into
//    splits from the shapes alone (B, KV, S, NP, SM count), so runs are
//    bitwise repeatable; each split writes its partial (m, l, acc) and
//    merge_partials_kernel combines them in fixed split order. One split
//    writes the output directly. The same code serves S = 1 and S > 1.
//  - At S > 1 a B1 block holds up to 128 query rows (bq * G) over 8 warps,
//    so each staged page serves them all; every block stops at the last key
//    a real query of it can see (exact: key 0 is always visible, so a fully
//    masked key would only add exp(-1e30 - m) = 0). Scores are kept in
//    log2 units (log2(e) folded into the key scale) for exp2.
//  - B1 and B2 step the softmax over the same 16-key tiles and take the
//    same split plan, and a row's MMA results do not depend on the other
//    rows of its tile, so the two agree bit for bit.
//
// Float32 pages (bits 0 with float32 storage), head dims other than 32, 64
// and 128, and more than 8 warps of query rows (G > 128, or B2 with
// KV * ceil(G / 16) > 8) are dispatched explicitly, by the wrapper, to the
// float32-FMA kernels paged_attn_kernel and
// paged_attn_kvblock_kernel below (their notes stand beside them): an MMA
// on float32 pages would need a three-way split of every page value, and
// no served configuration stores float32 pages. This is dispatch by
// argument type and shape, not a fallback: a failed build or launch raises.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas=-v
// into a shared library with the plain C interface at the bottom.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

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

// ---------------------------------------------------------------------------
// The float32-FMA kernels: float32 pages and the shapes the tensor-core
// kernels do not take (see the note at the top). One block per (query
// block, KV head, row) stages a tile of up to 64 keys (whole pages)
// dequantized into float32 shared memory and runs the products on float32
// FMAs, with the same early stop.
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
// The KV-head-blocked float32-FMA kernel (block_kv=True on the FMA route).
//
// B2's FMA counterpart, for float32 pages and the shapes the tensor-core
// kernel does not take. Same math as paged_attn_kernel; one block per
// (query block, row) walks the row's pages and stages each WHOLE page, all
// KV heads (a contiguous (ps, KV, hdw) run of the pool), so every visible
// page is read once per query block instead of once per KV head and query
// block. What bounds it on an H100: bytes, as the default kernel. The
// softmax state covers KV * bq * G rows, one mask shared by every head.
// Decode gives only B * nq blocks, so the block is wide
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

// ---------------------------------------------------------------------------
// The tensor-core kernels (B1 and B2 on int8, int4 and bf16 pages).
// ---------------------------------------------------------------------------
// keys per staged tile, one MMA k-chunk: B1 and B2 step the online softmax
// over the same tiles (B2's tile of every KV head leaves no room for more),
// so with the same splits they agree bit for bit
constexpr int kKeys = 16;
constexpr int kMaxWarps = 16;     // 16 query rows per warp
// ring slots: 3 beat 2 and 4 at decode on the H100 (the 1-warp decode
// blocks' shared memory sets how many are resident); fewer where shared
// memory ends
constexpr int kMaxStages = 3;
static_assert(kMaxStages <= 4, "the shared-memory layout keeps 4 mbarriers");
constexpr float kLog2e = 1.4426950408889634f;

// Page formats: BITS 8 = int8 grid, 4 = int4 fields in int32 words, 16 =
// bf16 pages. RB is the bytes of one KV head's row of one key.
template <int BITS, int HD>
struct PageFmt {
  static constexpr int RB = BITS == 8 ? HD : (BITS == 4 ? HD / 2 : 2 * HD);
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct MmaArgs {
  const void* q;            // (B, S, H, hd) float32 or bf16
  const unsigned char* kp;  // (P, ps, KV, hdw) raw page bytes
  const unsigned char* vp;
  const float* k_scale;     // (P,)
  const float* v_scale;
  const int* page_table;    // (B, NP)
  const int* q_start;       // (B,)
  const int* kv_len;        // (B,)
  float* out;               // (B, S, H, hd)
  float* part_m;            // (n_splits, B, S, H), n_splits > 1 only
  float* part_l;
  float* part_acc;          // (n_splits, B, S, H, hd)
  int S, H, KV, ps, NP, bq, pps, n_splits, tph, stages;
  int pitch_raw, pitch_bf;  // bytes per staged key row: raw pages, bf16
  float sm_scale;
};

// Shared memory, in order: the ring slots' mbarriers (B2; 32 bytes), the
// split's page ids and scales (pps each), each ring slot's per-key scales
// (2 x kKeys floats), then at 128-byte boundaries the q fragments (per
// warp), the ring of raw tiles (K rows then V rows) and, for int8/int4, one
// widened bf16 tile.
struct MmaSmem {
  size_t keys, qfrag, ring, tile, total;
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

__host__ __device__ inline MmaSmem mma_smem(int pps, int stages, int warps,
                                            int qfrag_bytes, int pitch_raw,
                                            int pitch_bf) {
  MmaSmem s;
  s.keys = 32 + 12 * static_cast<size_t>(pps);
  s.qfrag = align128(s.keys + 8 * static_cast<size_t>(kKeys) * stages);
  s.ring = align128(s.qfrag + static_cast<size_t>(warps) * qfrag_bytes);
  s.tile = s.ring + static_cast<size_t>(stages) * 2 * kKeys * pitch_raw;
  s.total = s.tile + static_cast<size_t>(2) * kKeys * pitch_bf;
  return s;
}

// One block per (query block x split, KV head, row) for B1 and per (query
// block x split, -, row) for B2. A B1 warp owns 16 query rows (i, g) of the
// block's KV head; a B2 warp owns 16 rows of KV head warp / tph.
template <typename QT, int BITS, int HD, bool KVB>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
paged_attn_mma_kernel(const MmaArgs a) {
  using F = PageFmt<BITS, HD>;
  constexpr int KS = HD / 16;                 // MMA k-steps of QK^T
  constexpr int NJ = HD / 8;                  // MMA n-tiles of P.V
  constexpr int QP = std::is_same<QT, float>::value ? 3 : 1;
  constexpr bool WIDEN = BITS != 16;
  constexpr int TK = kKeys;                   // keys per tile
  constexpr int NU = TK / 8;                  // QK^T n-tiles per tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int G = a.H / a.KV;
  const int nq = (a.S + a.bq - 1) / a.bq;
  const int qb = blockIdx.x % nq, split = blockIdx.x / nq;
  const int b = blockIdx.z;
  const int kh = KVB ? warp / a.tph : blockIdx.y;
  const int tile = KVB ? warp % a.tph : warp;
  const int R = a.bq * G, q0 = qb * a.bq;
  const int heads = KVB ? a.KV : 1;           // heads staged per key row

  // the split's keys, cut at the last key a real query of the block sees
  const int qs = a.q_start[b], len = a.kv_len[b];
  const int s_hi = min(q0 + a.bq, a.S) - 1;
  const int last_pos = min(qs + s_hi, len - 1);
  const int p_begin = split * a.pps;
  const int key_begin = p_begin * a.ps;
  const int key_stop = min(min(p_begin + a.pps, a.NP) * a.ps, last_pos + 1);
  const int n_tiles =
      key_stop > key_begin ? (key_stop - key_begin + TK - 1) / TK : 0;
  const int n_pg = n_tiles ? (key_stop - 1) / a.ps - p_begin + 1 : 0;

  extern __shared__ __align__(128) unsigned char smem_bytes[];
  const MmaSmem L = mma_smem(a.pps, a.stages, nwarps, QP * KS * 512,
                             a.pitch_raw, WIDEN ? a.pitch_bf : 0);
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem_bytes);
  int* spage = reinterpret_cast<int*>(smem_bytes + 32);
  float* sks = reinterpret_cast<float*>(spage + a.pps);
  float* svs = sks + a.pps;
  float* slot_scale = reinterpret_cast<float*>(smem_bytes + L.keys);
  uint4* qfrag = reinterpret_cast<uint4*>(smem_bytes + L.qfrag) +
                 warp * QP * KS * 32;
  unsigned char* ring = smem_bytes + L.ring;
  unsigned char* wide = smem_bytes + L.tile;
  const int slot_bytes = 2 * TK * a.pitch_raw;

  for (int j = tid; j < n_pg; j += blockDim.x) {
    const int p = a.page_table[static_cast<long long>(b) * a.NP + p_begin + j];
    spage[j] = p;
    sks[j] = a.k_scale[p] * a.sm_scale * kLog2e;   // scores in log2 units
    svs[j] = a.v_scale[p];
  }
  if (KVB && tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(mbar + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // this thread's two query rows, tile rows g and g + 8, and its q
  // fragments (the A operand: rows g / g + 8, columns 2c, 2c+1 / +8), a
  // float32 q split into three bf16 parts, kept in this warp's shared slot
  int qi[2], qh[2];
  bool qv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rb = tile * 16 + g + 8 * r;
    qi[r] = rb / G;
    qh[r] = kh * G + rb % G;
    qv[r] = rb < R && q0 + qi[r] < a.S;
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    float x[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long base =
          ((static_cast<long long>(b) * a.S + q0 + qi[r]) * a.H + qh[r]) * HD +
          16 * ks + 2 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long i = base + (e & 1) + 8 * (e >> 1);
        if (!qv[r])
          x[r][e] = 0.f;
        else if constexpr (std::is_same<QT, float>::value)
          x[r][e] = static_cast<const float*>(a.q)[i];
        else
          x[r][e] = __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i]);
      }
    }
#pragma unroll
    for (int p = 0; p < QP; ++p) {
      float h[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[r][e] = bf16_round(x[r][e]);
          x[r][e] -= h[r][e];
        }
      qfrag[(p * KS + ks) * 32 + lane] =
          make_uint4(bf16x2(h[0][0], h[0][1]), bf16x2(h[1][0], h[1][1]),
                     bf16x2(h[0][2], h[0][3]), bf16x2(h[1][2], h[1][3]));
    }
  }
  __syncthreads();

  // stage tile t into ring slot t % stages: thread (row, K or V) of each
  // warp copies its row's 16-byte chunks; keys past key_stop copy the last
  // real key (finite bytes; their scores are masked)
  const int row_bytes = heads * F::RB;
  auto issue = [&](int t) {
    const int slot = t % a.stages;
    unsigned char* dst0 = ring + slot * slot_bytes;
    for (int pr = lane; pr < 2 * TK; pr += 32) {
      const int row = pr >> 1, which = pr & 1;
      const int pos = min(key_begin + t * TK + row, key_stop - 1);
      const int pl = pos / a.ps - p_begin;
      const long long off =
          (static_cast<long long>(spage[pl]) * a.ps + pos % a.ps) * a.KV *
              F::RB + (KVB ? 0 : kh * F::RB);
      const unsigned char* src = (which ? a.vp : a.kp) + off;
      unsigned char* dst = dst0 + (which * TK + row) * a.pitch_raw;
      if (warp == 0 && which == 0) {
        slot_scale[slot * 2 * TK + row] = sks[pl];
        slot_scale[slot * 2 * TK + TK + row] = svs[pl];
      }
      if constexpr (KVB) {
        if (warp == 0) {
          if (lane == 0) mbar_expect_tx(mbar + slot, 2 * TK * row_bytes);
          __syncwarp();
          bulk_copy(dst, src, row_bytes, mbar + slot);
        }
      } else {
        for (int ch = warp; ch < F::RB / 16; ch += nwarps)
          cp_async16(dst + 16 * ch, src + 16 * ch);
      }
    }
  };

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int qpos[2] = {qs + q0 + qi[0], qs + q0 + qi[1]};
  const int pitch = WIDEN ? a.pitch_bf : a.pitch_raw;
  const int col = KVB ? kh * HD * 2 : 0;      // this warp's head, in bytes
  // ldmatrix row addresses: K rows 8u + (lane % 8), hd chunk lane / 8; V
  // rows (lane % 8) + 8 * ((lane / 8) % 2), hd chunk lane / 16
  const int k_off = (lane & 7) * pitch + (lane >> 3) * 16 + col;
  const int v_off = TK * pitch + ((lane & 7) + 8 * ((lane >> 3) & 1)) * pitch +
                    (lane >> 4) * 16 + col;
  const int chunks = row_bytes / 16;          // widening: chunks of a row
  const int w_row = tid / chunks, w_chunk = tid % chunks;
  const int w_drow = blockDim.x / chunks, w_dchunk = blockDim.x % chunks;

  for (int t = 0; t < a.stages - 1; ++t) {
    if (t < n_tiles) issue(t);
    if constexpr (!KVB) cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % a.stages;
    if constexpr (KVB) {
      mbar_wait(mbar + slot, (t / a.stages) & 1);
    } else {
      // groups committed: stages - 1 + t; tile t's is done when at most
      // stages - 2 newer ones are pending
      if (a.stages == 3) cp_async_wait<1>();
      else cp_async_wait<0>();
    }
    __syncthreads();   // tile t visible; slot (t - 1) % stages and the
                       // widened tile free
    if (t + a.stages - 1 < n_tiles) issue(t + a.stages - 1);
    if constexpr (!KVB) cp_async_commit();
    const unsigned char* raw = ring + slot * slot_bytes;
    const unsigned char* tile_base = raw;
    if constexpr (WIDEN) {
      // widen the whole tile (every staged head, K and V) once per block:
      // thread tid takes 16-byte chunks tid, tid + blockDim.x, ... of the
      // 2 * TK rows, stepping (row, chunk) without a division
      for (int r = w_row, ch = w_chunk; r < 2 * TK;) {
        widen16<BITS>(raw + r * a.pitch_raw + 16 * ch,
                      wide + r * a.pitch_bf + ch * (BITS == 8 ? 32 : 64));
        r += w_drow;
        ch += w_dchunk;
        if (ch >= chunks) {
          ch -= chunks;
          ++r;
        }
      }
      __syncthreads();
      tile_base = wide;
    }
    const float* ksc = slot_scale + slot * 2 * TK;
    const float* vsc = ksc + TK;
    const int kpos0 = key_begin + t * TK;

    // S = Q K^T for TK keys; n-tile u: keys 8u + g (B) / 8u + 2c (C)
    float s[NU][4];
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[u][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < KS / 2; ++kp) {
#pragma unroll
      for (int p = 0; p < QP; ++p) {
        const uint4 q0v = qfrag[(p * KS + 2 * kp) * 32 + lane];
        const uint4 q1v = qfrag[(p * KS + 2 * kp + 1) * 32 + lane];
        const uint32_t qa[4] = {q0v.x, q0v.y, q0v.z, q0v.w};
        const uint32_t qb2[4] = {q1v.x, q1v.y, q1v.z, q1v.w};
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          uint32_t kb[4];
          ldmatrix_x4(kb, tile_base + k_off + 8 * u * pitch + 64 * kp);
          mma_bf16(s[u], qa, kb[0], kb[1]);
          mma_bf16(s[u], qb2, kb[2], kb[3]);
        }
      }
    }

    // scale, mask, online softmax (rows g and g + 8; a quad shares a row)
    float vk[NU][2];
    // keys every row of the block sees need no mask
    const bool full = kpos0 + TK <= min(key_stop, qs + q0 + 1);
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * u + 2 * c + e, pos = kpos0 + key;
        const float k_s = ksc[key];
        vk[u][e] = vsc[key];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool ok = full || (pos < key_stop && pos <= qpos[r]);
          s[u][2 * r + e] = ok ? s[u][2 * r + e] * k_s : kNegInf;
        }
      }
    // P as the A operand of k-chunk kc: a[r] keys 16kc + 2c, +1 (n-tile
    // 2kc), a[2 + r] keys 16kc + 8 + 2c, +1 (n-tile 2kc + 1)
    uint32_t phi[NU / 2][4], plo[NU / 2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < NU; ++u)
        mx = fmaxf(mx, fmaxf(s[u][2 * r], s[u][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      const float corr = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[u][2 * r + e] - m_new);
          sum += p;
          pv[e] = p * vk[u][e];
        }
        const float h0 = bf16_round(pv[0]), h1 = bf16_round(pv[1]);
        phi[u >> 1][2 * (u & 1) + r] = bf16x2(h0, h1);
        plo[u >> 1][2 * (u & 1) + r] = bf16x2(pv[0] - h0, pv[1] - h1);
      }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }

    // O += P V: per k-chunk, n-tiles 2jp and 2jp + 1 from one transposed
    // load
#pragma unroll
    for (int kc = 0; kc < NU / 2; ++kc) {
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, tile_base + v_off + 16 * kc * pitch + 32 * jp);
        mma_bf16(acc[2 * jp], phi[kc], vb[0], vb[1]);
        mma_bf16(acc[2 * jp], plo[kc], vb[0], vb[1]);
        mma_bf16(acc[2 * jp + 1], phi[kc], vb[2], vb[3]);
        mma_bf16(acc[2 * jp + 1], plo[kc], vb[2], vb[3]);
      }
    }
  }

  // acc[j][2r + e] is row g + 8r, hd 8j + 2c + e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (!qv[r]) continue;
    const long long row =
        (static_cast<long long>(b) * a.S + q0 + qi[r]) * a.H + qh[r];
    const bool divide = a.n_splits == 1;
    const long long prow =
        static_cast<long long>(split) * gridDim.z * a.S * a.H + row;
    float* dst = divide ? a.out + row * HD : a.part_acc + prow * HD;
    if (!divide && c == 0) {
      a.part_m[prow] = m[r];
      a.part_l[prow] = l[r];
    }
    const float den = divide ? fmaxf(l[r], 1e-30f) : 1.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * c) =
          make_float2(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
  }
}

// Combines the splits' partials of each (b, s, h) row in fixed split
// order: M = max m_i, L = sum 2^(m_i - M) l_i, out = sum 2^(m_i - M) acc_i /
// max(L, 1e-30) (m in log2 units, as the kernel keeps it). A split that saw
// no visible key holds m = -1e30, l = 0. HD / 4 threads per row, one float4
// each, kMergeRows rows per block.
constexpr int kMergeRows = 4;

template <int HD>
__global__ void __launch_bounds__(HD / 4 * kMergeRows)
merge_partials_kernel(const float* __restrict__ pm,
                      const float* __restrict__ pl,
                      const float4* __restrict__ pacc,
                      float4* __restrict__ out, int rows, int n) {
  const int r = blockIdx.x * kMergeRows + threadIdx.x / (HD / 4);
  const int d = threadIdx.x % (HD / 4);
  if (r >= rows) return;
  float M = kNegInf;
  for (int i = 0; i < n; ++i)
    M = fmaxf(M, pm[static_cast<long long>(i) * rows + r]);
  float L = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n; ++i) {
    const long long k = static_cast<long long>(i) * rows + r;
    const float w = exp2f(pm[k] - M);
    L += w * pl[k];
    const float4 v = pacc[k * (HD / 4) + d];
    o.x += w * v.x;
    o.y += w * v.y;
    o.z += w * v.z;
    o.w += w * v.w;
  }
  const float den = fmaxf(L, 1e-30f);
  out[static_cast<long long>(r) * (HD / 4) + d] =
      make_float4(o.x / den, o.y / den, o.z / den, o.w / den);
}

// Row pitch of a staged tile: the bytes of a key row padded to 16 modulo
// 128, so that the 8 rows of an ldmatrix (or of a widening pass) fall on
// distinct banks.
inline int staged_pitch(int row_bytes) {
  return row_bytes + ((16 - row_bytes) % 128 + 128) % 128;
}

template <typename QT, int BITS, int HD, bool KVB>
int launch_mma(MmaArgs a, int B, cudaStream_t stream, int* blocks_per_sm,
               int* smem_bytes) {
  using F = PageFmt<BITS, HD>;
  constexpr int QP = std::is_same<QT, float>::value ? 3 : 1;
  const int G = a.H / a.KV;
  const int rows = a.bq * G;
  const int warps = KVB ? a.KV * a.tph : (rows + 15) / 16;
  if (warps < 1 || warps > kMaxWarps || (KVB && a.tph * 16 < rows) ||
      a.pps <= 0 || a.n_splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int heads = KVB ? a.KV : 1;
  a.pitch_raw = staged_pitch(heads * F::RB);
  a.pitch_bf = BITS == 16 ? 0 : staged_pitch(heads * HD * 2);
  a.stages = 0;
  size_t smem = 0;
  for (int s = kMaxStages; s >= 2 && !a.stages; --s) {
    smem = mma_smem(a.pps, s, warps, QP * (HD / 16) * 512,
                    a.pitch_raw, a.pitch_bf).total;
    if (smem <= 232448) a.stages = s;
  }
  if (!a.stages) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_attn_mma_kernel<QT, BITS, HD, KVB>;
  // once per instantiation and device: the most shared memory it may take
  static unsigned long long smem_set = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 64 || !(smem_set >> device & 1ull)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 64) smem_set |= 1ull << device;
  }
  cudaError_t err;
  if (blocks_per_sm) {   // an occupancy query: no launch
    *smem_bytes = static_cast<int>(smem);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kern, warps * 32, smem));
  }
  const int nq = (a.S + a.bq - 1) / a.bq;
  const dim3 grid(nq * a.n_splits, KVB ? 1 : a.KV, B);
  kern<<<grid, warps * 32, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return static_cast<int>(err);
  const int out_rows = B * a.S * a.H;
  merge_partials_kernel<HD>
      <<<(out_rows + kMergeRows - 1) / kMergeRows, HD / 4 * kMergeRows, 0,
         stream>>>(a.part_m, a.part_l,
                   reinterpret_cast<const float4*>(a.part_acc),
                   reinterpret_cast<float4*>(a.out), out_rows, a.n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, int BITS, bool KVB>
int launch_mma_hd(const MmaArgs& a, int B, int hd, cudaStream_t stream,
                  int* bps, int* smem) {
  if (hd == 32) return launch_mma<QT, BITS, 32, KVB>(a, B, stream, bps, smem);
  if (hd == 64) return launch_mma<QT, BITS, 64, KVB>(a, B, stream, bps, smem);
  if (hd == 128) return launch_mma<QT, BITS, 128, KVB>(a, B, stream, bps, smem);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename QT, bool KVB>
int launch_mma_pages(const MmaArgs& a, int B, int hd, int bits, int page_dtype,
                     cudaStream_t stream, int* bps, int* smem) {
  // page_dtype: 0 float32, 1 bfloat16, 2 int8, 3 int32
  if (bits == 8 && page_dtype == 2)
    return launch_mma_hd<QT, 8, KVB>(a, B, hd, stream, bps, smem);
  if (bits == 4 && page_dtype == 3)
    return launch_mma_hd<QT, 4, KVB>(a, B, hd, stream, bps, smem);
  if (bits == 0 && page_dtype == 1)
    return launch_mma_hd<QT, 16, KVB>(a, B, hd, stream, bps, smem);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename QT, typename PT, int BITS>
int launch_fma(bool block_kv, const void* q, const void* k_pages,
               const void* v_pages, const float* k_scale,
               const float* v_scale, const int* page_table,
               const int* q_start, const int* kv_len, float* out, int B,
               int S, int H, int KV, int hd, int ps, int NP, int bq,
               int tile_pages, float sm_scale, cudaStream_t stream) {
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
    return launch_fma<QT, int8_t, 8>(block_kv, q, kp, vp, ks, vs, pt, qs,
                                     lens, out, B, S, H, KV, hd, ps, NP, bq,
                                     tile_pages, sm_scale, stream);
  if (bits == 4 && page_dtype == 3)
    return launch_fma<QT, int32_t, 4>(block_kv, q, kp, vp, ks, vs, pt, qs,
                                      lens, out, B, S, H, KV, hd, ps, NP, bq,
                                      tile_pages, sm_scale, stream);
  if (bits == 0 && page_dtype == 0)
    return launch_fma<QT, float, 0>(block_kv, q, kp, vp, ks, vs, pt, qs, lens,
                                    out, B, S, H, KV, hd, ps, NP, bq,
                                    tile_pages, sm_scale, stream);
  if (bits == 0 && page_dtype == 1)
    return launch_fma<QT, __nv_bfloat16, 0>(block_kv, q, kp, vp, ks, vs, pt,
                                            qs, lens, out, B, S, H, KV, hd,
                                            ps, NP, bq, tile_pages, sm_scale,
                                            stream);
  return static_cast<int>(cudaErrorInvalidValue);
}


int dispatch_mma(const MmaArgs& a, int B, int hd, int bits, int q_dtype,
                 int page_dtype, bool block_kv, cudaStream_t st, int* bps,
                 int* smem) {
  if (q_dtype == 0)
    return block_kv ? launch_mma_pages<float, true>(a, B, hd, bits, page_dtype,
                                                    st, bps, smem)
                    : launch_mma_pages<float, false>(a, B, hd, bits,
                                                     page_dtype, st, bps, smem);
  if (q_dtype == 1)
    return block_kv ? launch_mma_pages<__nv_bfloat16, true>(
                          a, B, hd, bits, page_dtype, st, bps, smem)
                    : launch_mma_pages<__nv_bfloat16, false>(
                          a, B, hd, bits, page_dtype, st, bps, smem);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the FMA kernel needs, so the caller
// can size its tile.
size_t paged_kv_attention_smem_bytes(int rows, int tile_keys, int hd) {
  return smem_floats(rows, tile_keys, hd) * sizeof(float);
}

// The same for the KV-head-blocked FMA kernel: `rows` query rows per head.
size_t paged_kv_attention_kvblock_smem_bytes(int rows, int tile_keys, int kv,
                                             int hd) {
  return smem_floats_kvblock(kv * rows, tile_keys, kv, hd) * sizeof(float);
}

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// q_dtype: 0 float32, 1 bfloat16; block_kv: 0 B1, 1 B2 (KV-head-blocked).
// route 0: the float32-FMA kernels, query block `block_q`, `tile_pages`
// pages per tile. route 1: the tensor-core kernels, query block `block_q`,
// `pps` page-table columns per split, `n_splits` splits; with more than one
// split the partials go to part_m / part_l ((n_splits, B, S, H) float32)
// and part_acc ((n_splits, B, S, H, hd)) and a merge kernel writes `out`.
// All pointers are device pointers to contiguous tensors of the shapes in
// the kernels' comments; page pointers 16-byte aligned.
int paged_kv_attention_launch(const void* q, const void* k_pages,
                              const void* v_pages, const float* k_scale,
                              const float* v_scale, const int* page_table,
                              const int* q_start, const int* kv_len,
                              float* out, float* part_m, float* part_l,
                              float* part_acc, int B, int S, int H, int KV,
                              int hd, int ps, int NP, int bits, int q_dtype,
                              int page_dtype, int route, int block_q,
                              int tile_pages, int pps, int n_splits,
                              int block_kv, float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || block_q <= 0 ||
      (bits == 4 && hd % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (tile_pages <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (q_dtype == 0)
      return dispatch_pages<float>(block_kv != 0, page_dtype, bits, q,
                                   k_pages, v_pages, k_scale, v_scale,
                                   page_table, q_start, kv_len, out, B, S, H,
                                   KV, hd, ps, NP, block_q, tile_pages,
                                   sm_scale, st);
    if (q_dtype == 1)
      return dispatch_pages<__nv_bfloat16>(
          block_kv != 0, page_dtype, bits, q, k_pages, v_pages, k_scale,
          v_scale, page_table, q_start, kv_len, out, B, S, H, KV, hd, ps, NP,
          block_q, tile_pages, sm_scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != 1 || (n_splits > 1 && (!part_m || !part_l || !part_acc)))
    return static_cast<int>(cudaErrorInvalidValue);
  MmaArgs a{};
  a.q = q;
  a.kp = static_cast<const unsigned char*>(k_pages);
  a.vp = static_cast<const unsigned char*>(v_pages);
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.page_table = page_table;
  a.q_start = q_start;
  a.kv_len = kv_len;
  a.out = out;
  a.part_m = part_m;
  a.part_l = part_l;
  a.part_acc = part_acc;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.ps = ps;
  a.NP = NP;
  a.bq = block_q;
  a.pps = pps;
  a.n_splits = n_splits;
  a.tph = (block_q * (H / KV) + 15) / 16;
  a.sm_scale = sm_scale;
  return dispatch_mma(a, B, hd, bits, q_dtype, page_dtype, block_kv != 0, st,
                      nullptr, nullptr);
}

// Resident blocks per SM of the tensor-core kernel for these shapes (the
// split planner's input) in *blocks_per_sm, and its dynamic shared memory
// per block in *smem_bytes; returns the cudaError_t.
int paged_kv_attention_blocks_per_sm(int H, int KV, int hd, int bits,
                                     int q_dtype, int page_dtype, int block_q,
                                     int pps, int block_kv,
                                     int* blocks_per_sm, int* smem_bytes) {
  if (KV <= 0 || H % KV != 0 || block_q <= 0 || !blocks_per_sm || !smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  MmaArgs a{};
  a.H = H;
  a.KV = KV;
  a.bq = block_q;
  a.pps = pps;
  a.n_splits = 1;
  a.tph = (block_q * (H / KV) + 15) / 16;
  return dispatch_mma(a, 1, hd, bits, q_dtype, page_dtype, block_kv != 0,
                      nullptr, blocks_per_sm, smem_bytes);
}

const char* paged_kv_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
