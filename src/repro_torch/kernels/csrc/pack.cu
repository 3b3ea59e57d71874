// N-bit <-> int32 lane packing, for sm_90a: pack and unpack.
//
// Replaces the Pallas TPU kernels repro/kernels/pack.py :: _pack_kernel and
// _unpack_kernel (reached through pack_2d / unpack_2d and ops.pack /
// ops.unpack). A word holds vpw = 32 / BITS grid values, BITS in
// {2, 4, 8, 16}; field i sits at bits [i*BITS, (i+1)*BITS) (little-endian
// within the word), as repro_torch.core.qtensor.pack_bits.
//   pack:   word = OR_i ((uint32(x_i) & mask) << (i * BITS))
//   unpack: x_i  = int32(f ^ sign) - int32(sign),  f = (word >> i*BITS) & mask
// All bit work is on uint32_t (a left shift of a negative int is undefined
// in C++17); each value is masked before it is shifted.
//
// What bounds it on an H100: bytes. Each value and each word is read or
// written once, with a few integer operations per value. Since a row holds
// whole words (N % vpw == 0), a (M, N) grid is a flat run of M*N/vpw words,
// and the kernels work on the flat buffers with grid-stride loops. Pack
// gives each thread one word and loads its vpw values as 16-byte vectors
// (8-byte for BITS = 16, where a word holds two values). Unpack gives each
// thread 4 values (2 at BITS = 16) of one word and stores them as one
// vector, so neighbouring threads store neighbouring 16 bytes; the threads
// of one word read it together.
//
// Built by repro_torch/kernels/build.py into a shared library with the
// plain C interface at the bottom.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int N>
struct alignas(N * 4 >= 16 ? 16 : N * 4) Ints {
  int32_t v[N];
};

template <int BITS>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const int32_t* __restrict__ q, int32_t* __restrict__ w,
            long long words) {
  constexpr int kVpw = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  using V = Ints<kVpw>;
  const V* qv = reinterpret_cast<const V*>(q);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < words; i += stride) {
    const V x = qv[i];
    uint32_t word = 0u;
#pragma unroll
    for (int j = 0; j < kVpw; ++j)
      word |= (static_cast<uint32_t>(x.v[j]) & kMask) << (j * BITS);
    w[i] = static_cast<int32_t>(word);
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const int32_t* __restrict__ w, int32_t* __restrict__ q,
              long long words) {
  constexpr int kVpw = 32 / BITS;
  constexpr int kC = kVpw < 4 ? kVpw : 4;   // values per thread and step
  constexpr int kPer = kVpw / kC;           // steps per word
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  constexpr uint32_t kSign = 1u << (BITS - 1);
  using V = Ints<kC>;
  V* qv = reinterpret_cast<V*>(q);
  const long long chunks = words * kPer;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < chunks; i += stride) {
    const uint32_t word = static_cast<uint32_t>(w[i / kPer]);
    const int j0 = static_cast<int>(i % kPer) * kC;
    V x;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const uint32_t f = (word >> ((j0 + j) * BITS)) & kMask;
      x.v[j] = static_cast<int32_t>(f ^ kSign) - static_cast<int32_t>(kSign);
    }
    qv[i] = x;
  }
}

int grid_for(long long words, int num_sms) {
  long long blocks = (words + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(num_sms) * 16;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

template <int BITS>
int launch(bool unpack, const int32_t* in, int32_t* out, long long words,
           int num_sms, cudaStream_t stream) {
  constexpr int kVpw = 32 / BITS;
  const long long items = unpack ? words * (kVpw < 4 ? 1 : kVpw / 4) : words;
  const int grid = grid_for(items, num_sms);
  if (unpack)
    unpack_kernel<BITS><<<grid, kThreads, 0, stream>>>(in, out, words);
  else
    pack_kernel<BITS><<<grid, kThreads, 0, stream>>>(in, out, words);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool unpack, const int32_t* in, int32_t* out, long long words,
             int bits, int num_sms, void* stream) {
  if (words <= 0 || num_sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(unpack, in, out, words, num_sms, st);
    case 4: return launch<4>(unpack, in, out, words, num_sms, st);
    case 8: return launch<8>(unpack, in, out, words, num_sms, st);
    case 16: return launch<16>(unpack, in, out, words, num_sms, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Packs words * (32 / bits) int32 values at `q` into `words` int32 words at
// `w` (contiguous device buffers, 16-byte aligned). Launches on `stream`
// and returns the cudaError_t of the launch (0 = ok).
int pack_launch(const int32_t* q, int32_t* w, long long words, int bits,
                int num_sms, void* stream) {
  return dispatch(false, q, w, words, bits, num_sms, stream);
}

// Unpacks `words` int32 words at `w` into words * (32 / bits) sign-extended
// int32 values at `q` (same conventions as pack_launch).
int unpack_launch(const int32_t* w, int32_t* q, long long words, int bits,
                  int num_sms, void* stream) {
  return dispatch(true, w, q, words, bits, num_sms, stream);
}

const char* pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
