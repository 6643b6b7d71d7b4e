// The warpgroup flash-attention pieces shared by flash_attention.cu (K1, K2,
// B5f) and flash_int8.cu (B8a, B8b): the block's tile sizes, the static or
// online softmax of one 64 x 128 score tile in log2 units (each kernel
// gives its own score of an element), P packed from the
// accumulator layout into wgmma A fragments, the rescale of O, and the P.V
// product with V MN-major in shared memory.
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
