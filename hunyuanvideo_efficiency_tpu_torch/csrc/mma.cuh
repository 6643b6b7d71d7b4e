// Shared helpers for the hand-written Hopper kernels: the warp-level
// m16n8k16 tensor-core product (fp32 accumulate) for bf16 and fp16, and
// packing of two floats into one 32-bit register of the input type.
//
// Fragment layouts (PTX ISA, mma.m16n8k16), lane = 4*g + t:
//   A (16x16, row-major): a0 = (g, 2t..2t+1),   a1 = (g+8, 2t..2t+1),
//                         a2 = (g, 2t+8..+9),   a3 = (g+8, 2t+8..+9)
//   B (16x8, k x n):      b0 = (k=2t..2t+1, n=g), b1 = (k=2t+8..+9, n=g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// The lower column / k index sits in the lower 16 bits of each register.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hv {

template <typename T> struct Vec2;
template <> struct Vec2<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Vec2<__half> { using type = __half2; };

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b, __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b, __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 32-bit word (two consecutive 16-bit values) from shared memory.
template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace hv
