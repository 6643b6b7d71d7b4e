// Shared helpers for the hand-written Hopper kernels: the warp-level
// m16n8k16 tensor-core product (fp32 accumulate) for bf16 and fp16, the
// m16n8k32 s8 x s8 -> s32 product, packing of two floats into one 32-bit
// register of the input type, and the symmetric int8 rounding.
//
// Fragment layouts (PTX ISA, mma.m16n8k16), lane = 4*g + t:
//   A (16x16, row-major): a0 = (g, 2t..2t+1),   a1 = (g+8, 2t..2t+1),
//                         a2 = (g, 2t+8..+9),   a3 = (g+8, 2t+8..+9)
//   B (16x8, k x n):      b0 = (k=2t..2t+1, n=g), b1 = (k=2t+8..+9, n=g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// The lower column / k index sits in the lower 16 bits of each register.
//
// mma.m16n8k32 with s8 operands packs four int8 per register:
//   A (16x32, row-major): a0 = (g, 4t..4t+3),   a1 = (g+8, 4t..4t+3),
//                         a2 = (g, 4t+16..+19), a3 = (g+8, 4t+16..+19)
//   B (32x8, k x n):      b0 = (k=4t..4t+3, n=g), b1 = (k=4t+16..+19, n=g)
//   C (16x8, s32):        as the fp32 C above.
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

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 32-bit word (two 16-bit or four 8-bit values) from shared memory.
template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// round(x * inv) to the nearest int8 code, ties to even, as the TPU
// kernels' jnp.round(x * (1 / scale)).astype(int8); |x * inv| <= 127 up
// to rounding of the scale, the clamp only guards that.
__device__ __forceinline__ int quant_s8(float x, float inv) {
  const int q = __float2int_rn(__fmul_rn(x, inv));
  return max(-127, min(127, q));
}

// Eight values of T (one 16-byte load) as eight int8 codes (8 bytes).
template <typename T>
__device__ __forceinline__ uint2 quant8_s8(uint4 v, float inv) {
  const T* e = reinterpret_cast<const T*>(&v);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j >> 2] |= (uint32_t)(quant_s8(to_f32(e[j]), inv) & 0xff)
                 << (8 * (j & 3));
  return make_uint2(w[0], w[1]);
}

// max |x| over eight values of T.
template <typename T>
__device__ __forceinline__ float absmax8(uint4 v, float m) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(to_f32(e[j])));
  return m;
}

// Block-wide max of one non-negative float per thread (blockDim.x a
// multiple of 32, at most 1024); every thread gets the result.
__device__ __forceinline__ float block_max(float m) {
  __shared__ float part[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // part[] may still be read by a previous call
  if (lane == 0) part[warp] = m;
  __syncthreads();
  m = lane < (blockDim.x >> 5) ? part[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

}  // namespace hv
