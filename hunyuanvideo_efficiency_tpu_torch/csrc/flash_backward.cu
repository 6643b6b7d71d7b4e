// Flash attention backward for training: the two kernels that recompute the
// probabilities from the row log-sum-exp lse that the training forward wrote
// (flash_attention.cu, LSE = true, the port of _fwd_kernel).
//
// Replaces two Pallas TPU kernels of the JAX package
// (ops/flash_backward.py):
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel: per 64-query tile, over key
//       chunks: P = exp(S*scale + kb - lse), dP = dO.V^T,
//       dS = P*(dP - delta), dQ = scale * sum dS.K;
//   flash_bwd_dkv_kernel  <- _bwd_dkv_kernel: the transposed form per
//       64-key tile, over query chunks: P^T = exp(K.Q^T*scale + kb - lse),
//       dV = sum P^T.dO, dP^T = V.dO^T, dS^T = P^T*(dP^T - delta),
//       dK = scale * sum dS^T.Q.
// delta = rowsum(dO * O) is computed outside (fp32), as in the JAX package.
//
// Layout: q/k/v are [B, S, H*D] with each head a column slice (row strides
// are arguments); dO, dQ, dK and dV are contiguous [B, S, H*D]; lse and
// delta are [B, H, Sq] fp32; the key bias kb is [B, Sk] fp32 (entries <= 0)
// or null. Ragged edges are masked here: missing keys read as zero K/V with
// bias -1e30 (P = 0), missing query rows read as zero Q/dO with lse = +1e30
// in the transposed kernel (P^T = 0) and are not stored. A masked key
// (bias -1e30) gets P = 0 exactly, so its dK and dV are exactly 0.
//
// Numerics kept from the TPU kernels: every product in the input type with
// fp32 accumulation; P rounded to the input type before P.V and P^T.dO; dS
// rounded before dS.K and dS^T.Q; fp32 sums; `scale` applied to dQ and dK at
// the end. Each output element has one writer (no atomics), so results are
// the same from run to run.
//
// Bound on the H100: 6 (dQ) and 8 (dK/dV) times B*H*Sq*Sk*D tensor-core
// operations, far above the bytes moved at the main path's lengths, so both
// are bound by operations (989 TFLOP/s bf16 dense).
// This first design: a block of 4 warps owns 64 rows (16 per warp) and loops
// over 64-row chunks of the other axis itself; all four tiles stay row-major
// in padded shared memory. Operands contracted over their feature axis are
// read as plain 32-bit fragment loads; operands contracted over their ROW
// axis (K in dS.K, dO in P^T.dO, Q in dS^T.Q) are read with ldmatrix.trans,
// so no transposed copy is staged. S, P and dS never leave registers (the
// m16n8k16 accumulator layout is the A layout of the next product). The
// dK/dV kernel holds two fp32 [16, D] accumulators per warp, so it walks a
// query chunk in two halves of 32 columns to keep the score registers small.
// Not yet done: wgmma, TMA, a cp.async ring, fusing the two backward kernels.
#include "flash_tile.cuh"

namespace {

using hv::BK;
using hv::BQ;
using hv::NEG_INF;
using hv::THREADS;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* kb;     // [B, Sk] or null
  const float* lse;    // [B, H, Sq]
  const void* d_o;     // dO [B, Sq, H*D]
  const float* delta;  // [B, H, Sq]
  void* dq;            // [B, Sq, H*D]
  void* dk;            // [B, Sk, H*D]
  void* dv;            // [B, Sk, H*D]
  int H, Sq, Sk;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  float scale;
};

// Rows [row0, row0 + 64) of one head's [S, D] slice (row stride rs) into a
// padded [64][D + 8] shared tile; rows at or beyond S read as zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long rs, int row0, int S,
                                           int tid) {
  constexpr int DP = D + 8, CH = D / 8;
  for (int i = tid; i < 64 * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * rs +
                                            c);
    *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
  }
}

// The A fragment (rows r0 and r0 + 8, features kk*16 .. kk*16 + 15) of a
// padded shared tile.
template <typename T, int D>
__device__ __forceinline__ void load_a(const T* Xs, int r0, int t, int kk,
                                       uint32_t (&a)[4]) {
  constexpr int DP = D + 8;
  a[0] = hv::ld32(Xs + r0 * DP + kk * 16 + 2 * t);
  a[1] = hv::ld32(Xs + (r0 + 8) * DP + kk * 16 + 2 * t);
  a[2] = hv::ld32(Xs + r0 * DP + kk * 16 + 8 + 2 * t);
  a[3] = hv::ld32(Xs + (r0 + 8) * DP + kk * 16 + 8 + 2 * t);
}

// acc[16, D] += A[16, 16] . X[krow0 .. krow0 + 15, :] for a row-major padded
// shared tile X; `a` is the A fragment over those 16 rows of X.
template <typename T, int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4],
                                         const uint32_t (&a)[4], const T* Xs,
                                         int krow0, int lane) {
  constexpr int DP = D + 8;
  const T* base = Xs + (krow0 + (lane & 15)) * DP + ((lane >> 4) << 3);
#pragma unroll
  for (int dn = 0; dn < D / 8; dn += 2) {
    uint32_t bf[4];
    hv::ldmatrix_x4_trans(bf, base + dn * 8);
    hv::mma16816(acc[dn], a, bf, T());
    hv::mma16816(acc[dn + 1], a, bf + 2, T());
  }
}

// Rows r0 and r0 + 8 of a [16, D] fp32 accumulator times `mul`, rounded to T,
// into one head's column slice of a contiguous [S, H*D] output.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, long long rs, int row0,
                                           int S, const float (&acc)[D / 8][4],
                                           float mul, int r0, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + r0 + 8 * i;
    if (r >= S) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(dst + r * rs + dn * 8 + 2 * t) =
          hv::pack2(acc[dn][2 * i] * mul, acc[dn][2 * i + 1] * mul, T());
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Args a) {
  constexpr int DP = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][DP]
  T* Os = Qs + BQ * DP;                     // [BQ][DP], dO
  T* Ks = Os + BQ * DP;                     // [BK][DP]
  T* Vs = Ks + BK * DP;                     // [BK][DP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const long long o_rs = (long long)a.H * D;

  const T* qh = static_cast<const T*>(a.q) + b * a.q_bs + (long long)h * D;
  const T* kh = static_cast<const T*>(a.k) + b * a.k_bs + (long long)h * D;
  const T* vh = static_cast<const T*>(a.v) + b * a.v_bs + (long long)h * D;
  const T* doh = static_cast<const T*>(a.d_o) + (long long)b * Sq * o_rs +
                 (long long)h * D;
  const float* kbb = a.kb ? a.kb + (long long)b * Sk : nullptr;
  const long long row_base = ((long long)b * a.H + h) * Sq;

  stage_rows<T, D>(Qs, qh, a.q_rs, q0, Sq, tid);
  stage_rows<T, D>(Os, doh, o_rs, q0, Sq, tid);

  const int r0 = warp * 16 + g;  // this thread's query rows: r0 and r0 + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    lse_r[i] = r < Sq ? a.lse[row_base + r] : 0.f;
    del_r[i] = r < Sq ? a.delta[row_base + r] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tiles
    stage_rows<T, D>(Ks, kh, a.k_rs, k0, Sk, tid);
    stage_rows<T, D>(Vs, vh, a.v_rs, k0, Sk, tid);
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T, both [16, 64] per warp
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<T, D>(Qs, r0, t, kk, qa);
      load_a<T, D>(Os, r0, t, kk, da);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const T* krow = Ks + (nt * 8 + g) * DP + kk * 16;
        const T* vrow = Vs + (nt * 8 + g) * DP + kk * 16;
        uint32_t bk[2] = {hv::ld32(krow + 2 * t), hv::ld32(krow + 8 + 2 * t)};
        uint32_t bv[2] = {hv::ld32(vrow + 2 * t), hv::ld32(vrow + 8 + 2 * t)};
        hv::mma16816(s[nt], qa, bk, T());
        hv::mma16816(dp[nt], da, bv, T());
      }
    }

    // dS = P * (dP - delta), in place of S
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + nt * 8 + 2 * t + j;
        const float bias = key < Sk ? (kbb ? kbb[key] : 0.f) : NEG_INF;
        const float p0 = expf(s[nt][j] * a.scale + bias - lse_r[0]);
        const float p1 = expf(s[nt][2 + j] * a.scale + bias - lse_r[1]);
        s[nt][j] = p0 * (dp[nt][j] - del_r[0]);
        s[nt][2 + j] = p1 * (dp[nt][2 + j] - del_r[1]);
      }

    // acc += dS.K with dS rounded to K's type
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sa[4] = {hv::pack2(s[2 * kk][0], s[2 * kk][1], T()),
                        hv::pack2(s[2 * kk][2], s[2 * kk][3], T()),
                        hv::pack2(s[2 * kk + 1][0], s[2 * kk + 1][1], T()),
                        hv::pack2(s[2 * kk + 1][2], s[2 * kk + 1][3], T())};
      mma_rows<T, D>(acc, sa, Ks, kk * 16, lane);
    }
  }

  T* dqh = static_cast<T*>(a.dq) + (long long)b * Sq * o_rs + (long long)h * D;
  store_rows<T, D>(dqh, o_rs, q0, Sq, acc, a.scale, r0, t);
}

// ---------------------------------------------------------------------------
// backward: dK and dV (transposed form)
// ---------------------------------------------------------------------------

constexpr int HALF = 32;  // query columns handled per pass of the dK/dV body

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Args a) {
  constexpr int DP = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [BK][DP]
  T* Vs = Ks + BK * DP;                     // [BK][DP]
  T* Qs = Vs + BK * DP;                     // [BQ][DP]
  T* Os = Qs + BQ * DP;                     // [BQ][DP], dO
  float* lse_s = reinterpret_cast<float*>(Os + BQ * DP);  // [BQ]
  float* del_s = lse_s + BQ;                               // [BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const long long o_rs = (long long)a.H * D;

  const T* qh = static_cast<const T*>(a.q) + b * a.q_bs + (long long)h * D;
  const T* kh = static_cast<const T*>(a.k) + b * a.k_bs + (long long)h * D;
  const T* vh = static_cast<const T*>(a.v) + b * a.v_bs + (long long)h * D;
  const T* doh = static_cast<const T*>(a.d_o) + (long long)b * Sq * o_rs +
                 (long long)h * D;
  const float* kbb = a.kb ? a.kb + (long long)b * Sk : nullptr;
  const long long row_base = ((long long)b * a.H + h) * Sq;

  stage_rows<T, D>(Ks, kh, a.k_rs, k0, Sk, tid);
  stage_rows<T, D>(Vs, vh, a.v_rs, k0, Sk, tid);

  const int r0 = warp * 16 + g;  // this thread's key rows: r0 and r0 + 8
  float bias_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r0 + 8 * i;
    bias_r[i] = key < Sk ? (kbb ? kbb[key] : 0.f) : NEG_INF;
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dk[dn][0] = dk[dn][1] = dk[dn][2] = dk[dn][3] = 0.f;
    dv[dn][0] = dv[dn][1] = dv[dn][2] = dv[dn][3] = 0.f;
  }

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous tiles
    stage_rows<T, D>(Qs, qh, a.q_rs, q0, Sq, tid);
    stage_rows<T, D>(Os, doh, o_rs, q0, Sq, tid);
    if (tid < BQ) {
      // a missing query column: lse = +1e30 gives P^T = 0 (and its dO is 0)
      const int r = q0 + tid;
      lse_s[tid] = r < Sq ? a.lse[row_base + r] : 1e30f;
      del_s[tid] = r < Sq ? a.delta[row_base + r] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += HALF) {
      // S^T = K.Q^T and dP^T = V.dO^T, both [16, 32] per warp
      float st[HALF / 8][4], dpt[HALF / 8][4];
#pragma unroll
      for (int nt = 0; nt < HALF / 8; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a<T, D>(Ks, r0, t, kk, ka);
        load_a<T, D>(Vs, r0, t, kk, va);
#pragma unroll
        for (int nt = 0; nt < HALF / 8; ++nt) {
          const T* qrow = Qs + (c0 + nt * 8 + g) * DP + kk * 16;
          const T* orow = Os + (c0 + nt * 8 + g) * DP + kk * 16;
          uint32_t bq[2] = {hv::ld32(qrow + 2 * t),
                            hv::ld32(qrow + 8 + 2 * t)};
          uint32_t bo[2] = {hv::ld32(orow + 2 * t),
                            hv::ld32(orow + 8 + 2 * t)};
          hv::mma16816(st[nt], ka, bq, T());
          hv::mma16816(dpt[nt], va, bo, T());
        }
      }

      // P^T in place of S^T, dS^T = P^T * (dP^T - delta) in place of dP^T
#pragma unroll
      for (int nt = 0; nt < HALF / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c0 + nt * 8 + 2 * t + j;
          const float l = lse_s[col], dl = del_s[col];
          const float p0 = expf(st[nt][j] * a.scale + bias_r[0] - l);
          const float p1 = expf(st[nt][2 + j] * a.scale + bias_r[1] - l);
          dpt[nt][j] = p0 * (dpt[nt][j] - dl);
          dpt[nt][2 + j] = p1 * (dpt[nt][2 + j] - dl);
          st[nt][j] = p0;
          st[nt][2 + j] = p1;
        }

      // dv += P^T.dO and dk += dS^T.Q, both rounded to the input type
#pragma unroll
      for (int kk = 0; kk < HALF / 16; ++kk) {
        uint32_t pa[4] = {hv::pack2(st[2 * kk][0], st[2 * kk][1], T()),
                          hv::pack2(st[2 * kk][2], st[2 * kk][3], T()),
                          hv::pack2(st[2 * kk + 1][0], st[2 * kk + 1][1], T()),
                          hv::pack2(st[2 * kk + 1][2], st[2 * kk + 1][3],
                                    T())};
        uint32_t sa[4] = {
            hv::pack2(dpt[2 * kk][0], dpt[2 * kk][1], T()),
            hv::pack2(dpt[2 * kk][2], dpt[2 * kk][3], T()),
            hv::pack2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1], T()),
            hv::pack2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3], T())};
        mma_rows<T, D>(dv, pa, Os, c0 + kk * 16, lane);
        mma_rows<T, D>(dk, sa, Qs, c0 + kk * 16, lane);
      }
    }
  }

  T* dkh = static_cast<T*>(a.dk) + (long long)b * Sk * o_rs + (long long)h * D;
  T* dvh = static_cast<T*>(a.dv) + (long long)b * Sk * o_rs + (long long)h * D;
  store_rows<T, D>(dkh, o_rs, k0, Sk, dk, a.scale, r0, t);
  store_rows<T, D>(dvh, o_rs, k0, Sk, dv, 1.f, r0, t);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Which { BWD_DQ = 0, BWD_DKV = 1 };

template <typename T, int D>
cudaError_t launch(int which, const Args& a, int B, cudaStream_t stream) {
  constexpr int tiles4 = 4 * 64 * (D + 8) * (int)sizeof(T);
  void (*kern)(Args);
  int smem, rows;
  if (which == BWD_DQ) {
    kern = flash_bwd_dq_kernel<T, D>;
    smem = tiles4;
    rows = a.Sq;
  } else {
    kern = flash_bwd_dkv_kernel<T, D>;
    smem = tiles4 + 2 * BQ * (int)sizeof(float);
    rows = a.Sk;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + 63) / 64, a.H, B);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(int dtype, int head_dim, int which, const Args& a, int B,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(which, a, B, st);
  if (dtype == 0 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(which, a, B, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__half, 128>(which, a, B, st);
  if (dtype == 1 && head_dim == 64)
    return launch<__half, 64>(which, a, B, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16; head_dim 64 or 128. kb may be null. Each
// returns the cudaError_t of its launch.

extern "C" int hv_flash_bwd_dq(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, const void* d_o,
                               const float* kb, const float* lse,
                               const float* delta, void* dq, int B, int H,
                               int Sq, int Sk, long long q_bs, long long q_rs,
                               long long k_bs, long long k_rs, long long v_bs,
                               long long v_rs, float scale, void* stream) {
  Args a = {q,    k,    v,    kb,   lse,  d_o,  delta, dq,   nullptr, nullptr,
            H,    Sq,   Sk,   q_bs, q_rs, k_bs, k_rs,  v_bs, v_rs,    scale};
  return dispatch(dtype, head_dim, BWD_DQ, a, B, stream);
}

extern "C" int hv_flash_bwd_dkv(int dtype, int head_dim, const void* q,
                                const void* k, const void* v, const void* d_o,
                                const float* kb, const float* lse,
                                const float* delta, void* dk, void* dv, int B,
                                int H, int Sq, int Sk, long long q_bs,
                                long long q_rs, long long k_bs, long long k_rs,
                                long long v_bs, long long v_rs, float scale,
                                void* stream) {
  Args a = {q,    k,    v,    kb,   lse,  d_o,  delta, nullptr, dk,   dv,
            H,    Sq,   Sk,   q_bs, q_rs, k_bs, k_rs,  v_bs,    v_rs, scale};
  return dispatch(dtype, head_dim, BWD_DKV, a, B, stream);
}
