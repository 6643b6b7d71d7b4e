// The warpgroup flash-attention pieces shared by flash_attention.cu (K1, K2,
// B5f), flash_int8.cu (B8a, B8b), flash_backward.cu (B5q, B5kv) and, through
// sta_wg.cuh, sta_direct.cu (B4, B4q, B10) and sta_permuted.cu (B7, B6a/b,
// B6q): the block's tile sizes, the consumer warpgroups' turns, the static
// or online softmax of one 64 x 128 score tile in log2 units (each kernel
// gives its own score of an element; the bf16 and s8 score products S =
// Q.K^T with their softmax), P packed from the accumulator layout into
// wgmma A fragments, the rescale of O, and the P.V product with V MN-major
// in shared memory.
//
// A block of THREADS = 384 owns BM = 128 query rows of one (b, h):
// warpgroup 0 is the producer (TMA), warpgroups 1 and 2 consume 64 rows
// each, walking tiles of BN = 128 keys through a ring of STAGES slots.
// Accumulator and fragment layouts: see hopper.cuh.
#pragma once

#include "hopper.cuh"
#include "mma.cuh"

namespace hv {
namespace flash {

using namespace hv::sm90;

constexpr int BM = 128;      // query rows per block: two consumer warpgroups
constexpr int BN = 128;      // keys per tile
constexpr int STAGES = 3;    // K/V ring slots
constexpr int THREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A row sum from the four threads of a quad that share the row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, 256 threads each: one warpgroup waits, the other
// arrives), so that one's softmax runs under the other's products
// (flash_int8.cu, flash_backward.cu).
__device__ __forceinline__ void turn_wait(int wgc) { bar_sync(1 + wgc, 256); }
__device__ __forceinline__ void turn_pass(int wgc) {
  bar_arrive(2 - wgc, 256);
}

// Scores -> probabilities, x[i] = score(i) in log2 units (scale, bias and
// any static offset applied; score may read x[i] itself, x being the score
// tile in place). RUNNING: the online softmax; m_r and l_r are updated,
// corr is the factor the running output must take (l_r already has it).
// Static: p = exp2(score), corr stays 1.
template <bool RUNNING, typename Score>
__device__ __forceinline__ void softmax_scores(float (&x)[64], Score score,
                                               float (&m_r)[2],
                                               float (&l_r)[2],
                                               float (&corr)[2]) {
  corr[0] = corr[1] = 1.f;
  if (RUNNING) {
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      x[4 * j + 0] = score(4 * j + 0);
      x[4 * j + 1] = score(4 * j + 1);
      x[4 * j + 2] = score(4 * j + 2);
      x[4 * j + 3] = score(4 * j + 3);
      mx[0] = fmaxf(mx[0], fmaxf(x[4 * j + 0], x[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(x[4 * j + 2], x[4 * j + 3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      x[4 * j + 0] = exp2f(x[4 * j + 0] - m_r[0]);
      x[4 * j + 1] = exp2f(x[4 * j + 1] - m_r[0]);
      x[4 * j + 2] = exp2f(x[4 * j + 2] - m_r[1]);
      x[4 * j + 3] = exp2f(x[4 * j + 3] - m_r[1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      x[4 * j + 0] = exp2f(score(4 * j + 0));
      x[4 * j + 1] = exp2f(score(4 * j + 1));
      x[4 * j + 2] = exp2f(score(4 * j + 2));
      x[4 * j + 3] = exp2f(score(4 * j + 3));
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    l_r[0] += x[4 * j + 0] + x[4 * j + 1];
    l_r[1] += x[4 * j + 2] + x[4 * j + 3];
  }
}

// S = Q.K^T for one key tile: 64 query rows (A, K-major at q_addr) x 128
// keys (B, K-major at k_addr), D/16 k16 steps, one commit group.
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qoff = (kk >> 2) * (BM * 128) + (kk & 3) * 32;
    const uint32_t koff = (kk >> 2) * (BN * 128) + (kk & 3) * 32;
    wgmma_m64n128k16_ss(sc, desc_sw128(q_addr + qoff, 16, 1024),
                        desc_sw128(k_addr + koff, 16, 1024), kk > 0, T());
  }
  wgmma_commit();
}

// Scores -> probabilities in place, in log2 units: sc*scale*log2(e) plus
// the tile's bias bs (log2 units, less the static offset).
template <bool RUNNING>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[64], const float* bs, float sl2, int t, float (&m_r)[2],
    float (&l_r)[2], float (&corr)[2]) {
  float2 bb[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    bb[j] = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
  softmax_scores<RUNNING>(
      sc,
      [&](int i) {
        return fmaf(sc[i], sl2, (i & 1) ? bb[i >> 2].y : bb[i >> 2].x);
      },
      m_r, l_r, corr);
}

// s32 -> fp32, exact for |s| < 2^22, on the integer and FADD pipes.
__device__ __forceinline__ float s32_to_f32(int s) {
  return __int_as_float(s + 0x4B400000) - 12582912.f;
}

// The descriptor of an int8 code tile of D-byte rows, K-major: D = 128
// the 128-byte swizzle (8-row atoms of 1024 bytes), D = 64 the 64-byte one
// (atoms of 512 bytes).
template <int D>
__device__ __forceinline__ uint64_t desc_s8(uint32_t addr) {
  if constexpr (D == 128)
    return desc_sw128(addr, 16, 1024);
  else
    return desc_sw64(addr, 16, 512);
}

// S = Q8.K8^T for one key tile: 64 query rows (A at q_addr) x 128 keys (B
// at k_addr), D/32 k32 steps of 32 bytes, one commit group.
template <int D>
__device__ __forceinline__ void issue_qk_s8(int (&sc)[64], uint32_t q_addr,
                                            uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    wgmma_m64n128k32_s8_ss(sc, desc_s8<D>(q_addr + kk * 32),
                           desc_s8<D>(k_addr + kk * 32), kk > 0);
  wgmma_commit();
}

// Scores -> probabilities in x, in log2 units: s * factor + bias, with
// fb[p] = {factor(2p), factor(2p+1), bias(2p), bias(2p+1)} for the key
// pair p = 4j + t that this thread's columns 8j + 2t, 8j + 2t + 1 hold.
template <bool RUNNING>
__device__ __forceinline__ void softmax_tile_s8(
    const int (&sc)[64], float (&x)[64], const float4* fb, int t,
    float (&m_r)[2], float (&l_r)[2], float (&corr)[2]) {
  softmax_scores<RUNNING>(
      x,
      [&](int i) {
        const float4 w = fb[4 * (i >> 2) + t];
        return (i & 1) ? fmaf(s32_to_f32(sc[i]), w.y, w.w)
                       : fmaf(s32_to_f32(sc[i]), w.x, w.z);
      },
      m_r, l_r, corr);
}

// P rounded to T, the accumulator layout packed into the A fragments of
// the k16 steps over the tile's 128 keys.
template <typename T>
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = hv::pack2(sc[8 * kk + 0], sc[8 * kk + 1], T());
    pa[kk][1] = hv::pack2(sc[8 * kk + 2], sc[8 * kk + 3], T());
    pa[kk][2] = hv::pack2(sc[8 * kk + 4], sc[8 * kk + 5], T());
    pa[kk][3] = hv::pack2(sc[8 * kk + 6], sc[8 * kk + 7], T());
  }
}

// O *= corr for the running max's moves (rows r0 and r0 + 8); skipped,
// exactly, when no row of the warp moved its max.
template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2],
                                        const float (&corr)[2]) {
  if (!__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j + 0] *= corr[0];
    acc[4 * j + 1] *= corr[0];
    acc[4 * j + 2] *= corr[1];
    acc[4 * j + 3] *= corr[1];
  }
}

// O += P.V of one tile: P in registers (A fragments of T), V MN-major at
// v_addr (D/64 TMA boxes of [BN][64], 128-byte swizzle), 16 keys = 16 rows
// = 2048 bytes a k16 step. One commit group.
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs_tb<D, T>(acc, pa[kk],
                      desc_sw128(v_addr + kk * 2048, BN * 128, 1024));
  wgmma_commit();
}

// Keeps P's registers live until an asynchronous product that reads them
// has been waited for.
__device__ __forceinline__ void fence_pa(uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kk][i]) :: "memory");
}

}  // namespace flash
}  // namespace hv
