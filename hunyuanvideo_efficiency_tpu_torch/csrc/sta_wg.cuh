// The consumer warpgroups of the STA kernels sta_direct.cu (B4, B4q, B10)
// and sta_permuted.cu (B7, B6a/B6b, B6q): a ring slot's sizes, and the
// chunk loop over it. Chunk j's S = Q.K^T is issued together with chunk
// j-1's P.V, so that its softmax runs under that product (K1's loop,
// flash_attention.cu), and the two warpgroups take turns to issue (B8's
// turns, flash_wg.cuh), so that one's softmax runs under the other's
// products. The static softmax (a per-key bias less the offset C, or under
// QUANT a per-key factor and bias) or, under RUNNING, the online softmax
// with O rescaled once the previous chunk's P.V is done (K2's).
#pragma once

#include "flash_wg.cuh"

namespace hv {
namespace flash {

// A ring slot: a chunk's K and V and per key its bias (QUANT: (factor,
// bias) pairs as B8 keeps them): 128 keys of 16-bit K, or under QUANT 128
// keys of int8 K or a text chunk's 64 keys of 16-bit K (both BN * D
// bytes), and V of as many keys.
template <int D, bool QUANT>
struct StaSlot {
  static constexpr int STAGES = 3;
  static constexpr int TXT = QUANT ? 64 : BN;  // keys a text chunk
  static constexpr int K_BYTES = BN * D * (QUANT ? 1 : 2);
  static constexpr int V_BYTES = BN * D * 2;
  static constexpr int W_BYTES = BN * (QUANT ? 8 : 4);
};

// The kinds of a chunk's products: 128 keys of 16-bit K (B4's chunks), of
// int8 codes (B4q's image chunks, every chunk of B6q), or a text chunk of
// 64 keys of 16-bit K (B4q's).
enum class Kind { bf16, s8, txt64 };

// S = Q.K^T for a text chunk of 64 keys: 64 query rows (A at q_addr) x 64
// keys (B, K-major: D/64 boxes of [64][64]), D/16 k16 steps, one commit
// group.
template <typename T, int D>
__device__ __forceinline__ void issue_qk_n64(float (&sc)[32], uint32_t q_addr,
                                             uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qoff = (kk >> 2) * (BM * 128) + (kk & 3) * 32;
    const uint32_t koff = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
    wgmma_m64n64k16_ss(sc, desc_sw128(q_addr + qoff, 16, 1024),
                       desc_sw128(k_addr + koff, 16, 1024), kk > 0, T());
  }
  wgmma_commit();
}

// O += P.V of a chunk: 128 keys (issue_pv) or a text chunk's 64 (V as D/64
// boxes of [64][64], P in pa[0..3]). One commit group.
template <Kind K, typename T, int D>
__device__ __forceinline__ void issue_pv_of(float (&acc)[D / 2],
                                            const uint32_t (&pa)[BN / 16][4],
                                            uint32_t v_addr) {
  if constexpr (K == Kind::txt64) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<D, T>(acc, pa[kk],
                        desc_sw128(v_addr + kk * 2048, 64 * 128, 1024));
    wgmma_commit();
  } else {
    issue_pv<T, D>(acc, pa, v_addr);
  }
}

// A consumer warpgroup's pieces of the chunk loop: where the ring lies,
// and one chunk's products and softmax. RUNNING (16-bit chunks only): the
// online softmax of K2, m_r the running row max in log2 units.
template <typename T, int D, bool QUANT, bool RUNNING = false>
struct Consumer {
  static_assert(!(QUANT && RUNNING), "the int8 arm has a static offset");
  using L = StaSlot<D, QUANT>;
  static constexpr int STAGES = L::STAGES;
  static constexpr int W_FLOATS = L::W_BYTES / 4;
  uint64_t* full;
  uint64_t* empty;
  uint32_t q_addr, q8_addr, k_base, v_base;  // this warpgroup's Q rows
  const float* w_base;                        // the slots' per-key values
  float sl2;                                  // scale * log2(e)
  int t, lane, wgc;

  // S of chunk `it` (kind SK), issued after chunk it-1's P.V (kind PK;
  // none for the FIRST chunk), then as probabilities packed into pa.
  // Frees chunk it-1's slot.
  template <Kind SK, Kind PK, bool FIRST = false>
  __device__ __forceinline__ void step(int it, float (&acc)[D / 2],
                                       float (&m_r)[2], float (&l_r)[2],
                                       uint32_t (&pa)[BN / 16][4]) const {
    const int s = it % STAGES, sp = FIRST ? 0 : (it - 1) % STAGES;
    const float* w = w_base + s * W_FLOATS;
    const float4* fb = reinterpret_cast<const float4*>(w);
    float corr[2];
    mbar_wait(&full[s], (it / STAGES) & 1);
    __syncwarp();  // converged for the .aligned wgmma instructions
    turn_wait(wgc);
    wgmma_fence();
    if constexpr (SK == Kind::txt64) {
      float x[32];
      issue_qk_n64<T, D>(x, q_addr, k_base + s * L::K_BYTES);
      if constexpr (!FIRST)
        issue_pv_of<PK, T, D>(acc, pa, v_base + sp * L::V_BYTES);
      turn_pass(wgc);
      wgmma_wait<FIRST ? 0 : 1>();  // S is done; the P.V may still run
      fence_regs(x);
      // static softmax of the chunk's 64 keys: (factor, bias) pairs
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 f = fb[4 * j + t];
        x[4 * j + 0] = exp2f(fmaf(x[4 * j + 0], f.x, f.z));
        x[4 * j + 1] = exp2f(fmaf(x[4 * j + 1], f.y, f.w));
        x[4 * j + 2] = exp2f(fmaf(x[4 * j + 2], f.x, f.z));
        x[4 * j + 3] = exp2f(fmaf(x[4 * j + 3], f.y, f.w));
        l_r[0] += x[4 * j + 0] + x[4 * j + 1];
        l_r[1] += x[4 * j + 2] + x[4 * j + 3];
      }
      finish<FIRST>(sp, acc, pa);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = hv::pack2(x[8 * kk + 0], x[8 * kk + 1], T());
        pa[kk][1] = hv::pack2(x[8 * kk + 2], x[8 * kk + 3], T());
        pa[kk][2] = hv::pack2(x[8 * kk + 4], x[8 * kk + 5], T());
        pa[kk][3] = hv::pack2(x[8 * kk + 6], x[8 * kk + 7], T());
      }
    } else if constexpr (SK == Kind::s8) {
      int si[64];
      float x[64];
      issue_qk_s8<D>(si, q8_addr, k_base + s * L::K_BYTES);
      if constexpr (!FIRST)
        issue_pv_of<PK, T, D>(acc, pa, v_base + sp * L::V_BYTES);
      turn_pass(wgc);
      wgmma_wait<FIRST ? 0 : 1>();  // S is done; the P.V may still run
      fence_regs(si);
      softmax_tile_s8<false>(si, x, fb, t, m_r, l_r, corr);
      finish<FIRST>(sp, acc, pa);
      pack_p<T>(x, pa);
    } else {
      float x[64];
      issue_qk<T, D>(x, q_addr, k_base + s * L::K_BYTES);
      if constexpr (!FIRST)
        issue_pv_of<PK, T, D>(acc, pa, v_base + sp * L::V_BYTES);
      turn_pass(wgc);
      wgmma_wait<FIRST ? 0 : 1>();  // S is done; the P.V may still run
      fence_regs(x);
      softmax_tile<RUNNING>(x, w, sl2, t, m_r, l_r, corr);
      finish<FIRST>(sp, acc, pa);
      // O takes the max's move once the previous P.V has added to it
      if constexpr (RUNNING) rescale<D>(acc, corr);
      pack_p<T>(x, pa);
    }
  }

  // The previous chunk's P.V is done: its slot sp is free.
  template <bool FIRST>
  __device__ __forceinline__ void finish(int sp, float (&acc)[D / 2],
                                         uint32_t (&pa)[BN / 16][4]) const {
    wgmma_wait<0>();
    fence_regs(acc);
    fence_pa(pa);
    if (!FIRST && lane == 0) mbar_arrive(&empty[sp]);
  }

  // The last chunk's P.V (kind PK, chunk it).
  template <Kind PK>
  __device__ __forceinline__ void last(int it, float (&acc)[D / 2],
                                       uint32_t (&pa)[BN / 16][4]) const {
    turn_wait(wgc);
    wgmma_fence();
    issue_pv_of<PK, T, D>(acc, pa, v_base + (it % STAGES) * L::V_BYTES);
    // the second warpgroup's last pass would find no one to wait for it
    if (wgc == 0) turn_pass(wgc);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_pa(pa);
  }
};

}  // namespace flash
}  // namespace hv
