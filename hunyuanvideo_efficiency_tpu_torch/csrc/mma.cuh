// Shared helpers for the hand-written Hopper kernels: packing of two floats
// into one 32-bit register of the input type, the conversion of one value
// to float, and the symmetric int8 rounding of the quantizing pre-passes
// (codes, absmax, a block-wide max).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hv {

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
