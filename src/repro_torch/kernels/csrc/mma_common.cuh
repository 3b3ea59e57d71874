// Device helpers shared by the tensor-core kernels of this directory
// (paged_kv_attention.cu, quant_matmul.cu), for sm_90a: bf16 packing,
// mma.sync m16n8k16 on bf16 operands, ldmatrix, cp.async and
// cp.async.bulk with mbarriers, and the exact widening of int8 / int4
// bytes to bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8. Without .trans thread (g, c) receives row g, columns 2c, 2c + 1
// of each; with .trans rows 2c, 2c + 1 of column g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete; traps (a launch error the
// caller sees) rather than hang if the copies never arrive.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 16 raw bytes of int8 or int4 page values, widened to bf16 (exact) and
// stored as 16 (int8) or 32 (int4) consecutive bf16 values at `dst`.
template <int BITS>
__device__ __forceinline__ void widen16(const unsigned char* src,
                                        unsigned char* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (BITS == 8) {
    // byte b as u = b ^ 0x80 under the float32 2^23 (0x4B0000uu), minus
    // 2^23 + 128, is b exactly; a small integer's float32 ends in 16 zero
    // bits, so its upper half is its bf16. No conversion instructions.
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = w[i] ^ 0x80808080u;
      uint32_t f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        f[k] = __float_as_uint(
            __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + k)) -
            8388736.f);
      o[2 * i] = __byte_perm(f[0], f[1], 0x7632);
      o[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632);
    }
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  } else {
    // int4: field f of a word sits at bits 4f (sign-extended); 128 + u for
    // u = field ^ 8 in 0..15 is exact in bf16 (0x4300 | u), and
    // (128 + u) - 136 = field
    const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x88888888u;
      uint32_t p[4];   // fields (f, f + 4) for f = 0..3
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        uint32_t v = ((u >> (4 * f)) & 0x000f000fu) | 0x43004300u;
        const __nv_bfloat162 h =
            __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v), bias);
        p[f] = *reinterpret_cast<const uint32_t*>(&h);
      }
      // fields (0, 4), (1, 5), (2, 6), (3, 7) -> (0, 1), (2, 3), (4, 5), (6, 7)
      *reinterpret_cast<uint4*>(dst + 16 * i) = make_uint4(
          __byte_perm(p[0], p[1], 0x5410), __byte_perm(p[2], p[3], 0x5410),
          __byte_perm(p[0], p[1], 0x7632), __byte_perm(p[2], p[3], 0x7632));
    }
  }
}

}  // namespace
