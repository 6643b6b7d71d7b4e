// The mma.sync inner step of the sliding-tile attention kernels
// (sta_attention.cu, with their int8 arms) and of the training backward
// (flash_backward.cu); flash_attention.cu and flash_int8.cu have their own
// wgmma design (flash_wg.cuh on hopper.cuh). A block of 4 warps
// owns BQ = 64 query rows; each warp holds its 16 rows of Q as mma.sync A
// fragments (bf16/fp16, or int8 codes for the int8 Q.K^T), and key chunks
// of BK = 64 are staged in padded shared memory (K row-major, V transposed)
// and folded into fp32 registers: S and P never leave them, since the
// m16n8k16 accumulator layout is the A layout of the P.V product (and the
// m16n8k32 s32 layout is the same).
#pragma once

#include "mma.cuh"

namespace hv {

constexpr int BQ = 64;      // query rows per block: 4 warps x 16 rows
constexpr int BK = 64;      // keys per chunk
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

// Dynamic shared memory of one block: Q [BQ][D+8], K [BK][D+8] and V^T
// [D][BK+8] (padded rows: conflict-free fragment loads).
template <typename T, int D>
constexpr int tile_smem_bytes() {
  return (BQ * (D + 8) + BK * (D + 8) + D * (BK + 8)) * sizeof(T);
}

// V row r's 8 elements from column c, transposed.
template <typename T>
__device__ __forceinline__ void stage_v(T* Vt, int r, int c, uint4 vv) {
  const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
  for (int j = 0; j < 8; ++j) Vt[(c + j) * (BK + 8) + r] = ve[j];
}

// Key row r's 8 elements from column c: K as is, V transposed.
template <typename T, int D>
__device__ __forceinline__ void stage_kv(T* Ks, T* Vt, int r, int c,
                                         uint4 kv, uint4 vv) {
  *reinterpret_cast<uint4*>(Ks + r * (D + 8) + c) = kv;
  stage_v(Vt, r, c, vv);
}

// A fragments of this thread's query rows r0 and r0 + 8 (lane = 4g + t).
template <typename T, int D>
__device__ __forceinline__ void load_q(const T* Qs, int r0, int t,
                                       uint32_t (&qa)[D / 16][4]) {
  constexpr int DP = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = ld32(Qs + r0 * DP + kk * 16 + 2 * t);
    qa[kk][1] = ld32(Qs + (r0 + 8) * DP + kk * 16 + 2 * t);
    qa[kk][2] = ld32(Qs + r0 * DP + kk * 16 + 8 + 2 * t);
    qa[kk][3] = ld32(Qs + (r0 + 8) * DP + kk * 16 + 8 + 2 * t);
  }
}

// Row stride in bytes of the int8 Q and K tiles: D + 16 keeps fragment
// loads conflict-free and rows 16-byte aligned.
template <int D>
__host__ __device__ constexpr int s8_row() {
  return D + 16;
}

// A fragments (m16n8k32) of this thread's int8 query rows r0 and r0 + 8.
template <int D>
__device__ __forceinline__ void load_q8(const int8_t* Q8, int r0, int t,
                                        uint32_t (&qa)[D / 32][4]) {
  constexpr int RP = s8_row<D>();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    qa[kk][0] = ld32(Q8 + r0 * RP + kk * 32 + 4 * t);
    qa[kk][1] = ld32(Q8 + (r0 + 8) * RP + kk * 32 + 4 * t);
    qa[kk][2] = ld32(Q8 + r0 * RP + kk * 32 + 16 + 4 * t);
    qa[kk][3] = ld32(Q8 + (r0 + 8) * RP + kk * 32 + 16 + 4 * t);
  }
}

// Raw scores Q.K^T of one staged chunk (fp32 accumulation in T).
template <typename T, int D>
__device__ __forceinline__ void qk_chunk(const uint32_t (&qa)[D / 16][4],
                                         const T* Ks, float (&s)[BK / 8][4],
                                         int g, int t) {
  constexpr int DP = D + 8;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const T* krow = Ks + (nt * 8 + g) * DP;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bf[2] = {ld32(krow + kk * 16 + 2 * t),
                        ld32(krow + kk * 16 + 8 + 2 * t)};
      mma16816(s[nt], qa[kk], bf, T());
    }
  }
}

// Raw int8 scores of one staged chunk: the exact s32 Q8.K8^T as fp32.
template <int D>
__device__ __forceinline__ void qk_chunk_s8(const uint32_t (&qa)[D / 32][4],
                                            const int8_t* K8,
                                            float (&s)[BK / 8][4], int g,
                                            int t) {
  constexpr int RP = s8_row<D>();
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    int acc[4] = {0, 0, 0, 0};
    const int8_t* krow = K8 + (nt * 8 + g) * RP;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t bf[2] = {ld32(krow + kk * 32 + 4 * t),
                        ld32(krow + kk * 32 + 16 + 4 * t)};
      mma_s8(acc, qa[kk], bf);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s[nt][j] = (float)acc[j];
  }
}

// Fold raw scores s of one chunk into the state of rows r0 and r0 + 8;
// the scores are multiplied by `scale` here (the softmax scale, or
// sq*sk*scale for int8 scores). bias[nt][j] is the additive bias of key
// nt*8 + 2t + j (NEG_INF = masked).
//   RUNNING = false: p = exp(s*scale + (bias - c_off)), the static offset;
//   RUNNING = true:  online softmax with running max m_r and rescale.
// l_r is this thread's part of the row sums (reduce with quad_sum). P is
// rounded to T before P.V (V^T staged in Vt); acc is fp32.
template <typename T, int D, bool RUNNING>
__device__ __forceinline__ void fold_scores(
    float (&s)[BK / 8][4], const T* Vt, const float (&bias)[BK / 8][2],
    float scale, float c_off, float (&acc)[D / 8][4], float (&m_r)[2],
    float (&l_r)[2], int g, int t) {
  constexpr int KP = BK + 8;
  // scores -> probabilities, in place
  if (RUNNING) {
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = s[nt][j] * scale + bias[nt][j];
        s[nt][2 + j] = s[nt][2 + j] * scale + bias[nt][j];
        mx[0] = fmaxf(mx[0], s[nt][j]);
        mx[1] = fmaxf(mx[1], s[nt][2 + j]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m_r[i] - mx[i]);
      m_r[i] = mx[i];
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = expf(s[nt][j] - m_r[0]);
        s[nt][2 + j] = expf(s[nt][2 + j] - m_r[1]);
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float off = bias[nt][j] - c_off;
        s[nt][j] = expf(s[nt][j] * scale + off);
        s[nt][2 + j] = expf(s[nt][2 + j] * scale + off);
      }
  }
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    l_r[0] += s[nt][0] + s[nt][1];
    l_r[1] += s[nt][2] + s[nt][3];
  }

  // acc += P.V with P rounded to V's type
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1], T()),
                      pack2(s[2 * kk][2], s[2 * kk][3], T()),
                      pack2(s[2 * kk + 1][0], s[2 * kk + 1][1], T()),
                      pack2(s[2 * kk + 1][2], s[2 * kk + 1][3], T())};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const T* vrow = Vt + (dn * 8 + g) * KP + kk * 16;
      uint32_t bf[2] = {ld32(vrow + 2 * t), ld32(vrow + 8 + 2 * t)};
      mma16816(acc[dn], pa, bf, T());
    }
  }
}

// Fold one staged chunk (K row-major in Ks, V^T in Vt) into the state of
// rows r0 and r0 + 8: qk_chunk, then fold_scores with the softmax scale.
template <typename T, int D, bool RUNNING>
__device__ __forceinline__ void fold_chunk(
    const uint32_t (&qa)[D / 16][4], const T* Ks, const T* Vt,
    const float (&bias)[BK / 8][2], float scale, float c_off,
    float (&acc)[D / 8][4], float (&m_r)[2], float (&l_r)[2], int g,
    int t) {
  float s[BK / 8][4];
  qk_chunk<T, D>(qa, Ks, s, g, t);
  fold_scores<T, D, RUNNING>(s, Vt, bias, scale, c_off, acc, m_r, l_r, g,
                             t);
}

// A row sum from the four threads of a quad that share the row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace hv
