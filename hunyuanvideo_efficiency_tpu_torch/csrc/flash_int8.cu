// Flash attention with int8 Q.K^T over the MM-DiT joint [img | txt]
// sequence (SageAttention-style, arXiv 2410.02367).
//
// Replaces two Pallas TPU kernels of the JAX package, as one source with a
// template flag:
//   RUNNING = false: ops/flash_attention.py:_flash_int8_nomax_kernel, the
//     static per-(batch, head) exponent offset C (inflated by the caller to
//     bound the int8-rounded scores): p = exp(s + (kb - C));
//   RUNNING = true:  ops/flash_attention.py:_flash_int8_kernel, the online
//     softmax with a running row max.
// with s = s32(Q8.K8^T) * (sq * sk * scale), then out = acc / max(l, 1e-37).
//
// Quantization groups are the TPU kernels' blocks: one symmetric scale per
// (b, head, group of gq query rows) and per (b, head, group of gk key rows),
// scale = max(max|x|, 1e-6) * (1/127), codes round(x * (1/scale)) with ties
// to even. A 64-row tile sees only part of its group, so group_scales_kernel
// first reduces each group (a second pass would otherwise be needed inside
// the attention kernel); the attention kernel then quantizes its Q tile
// once and each key chunk as it stages it. Rows beyond the sequence are
// zeros and change no absmax; keys beyond it carry bias -1e30.
//
// Layout: q/k/v [B, S, H*D] with each head a column slice (row strides are
// arguments), kb [B, Sk] fp32 (entries <= 0), C [B, H] fp32.
//
// Numerics kept from the TPU kernels: exact s32 Q8.K8^T; fp32 softmax
// bookkeeping; p rounded to V's type before a bf16/fp16 P.V with fp32
// accumulation.
//
// Bound on the H100: 2*B*H*Sq*Sk*D int8 operations for Q.K^T (1,979 TOP/s)
// plus as many bf16 operations for P.V (989 TFLOP/s), far above the bytes
// of q/k/v/out at the main path's lengths: bound by operations. This first
// design is the flash kernels' (flash_tile.cuh): one block of 4 warps owns
// 64 query rows of one (b, h) and loops over 64-key chunks; Q8 stays in
// registers as m16n8k32 A fragments; K8 and V^T go through padded shared
// memory; S and P never leave registers. Not yet done: wgmma, TMA, a
// cp.async ring.
#include "flash_tile.cuh"

namespace {

using hv::BK;
using hv::BQ;
using hv::NEG_INF;
using hv::THREADS;

// One scale per (b, h, group of `group` rows) of x [B, S, H*D]:
// max(max|x|, 1e-6) * (1/127) (the float of the double 1/127, as the TPU
// kernels' weak-typed constant).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
group_scales_kernel(const T* __restrict__ x, long long bs, long long rs,
                    int H, int S, int group, float* __restrict__ out) {
  constexpr int CH = D / 8;
  const int gi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const T* xh = x + b * bs + (long long)h * D;
  const int r0 = gi * group, r1 = min(r0 + group, S);
  float m = 0.f;
  for (int i = r0 * CH + threadIdx.x; i < r1 * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    m = hv::absmax8<T>(*reinterpret_cast<const uint4*>(xh + r * rs + c), m);
  }
  m = hv::block_max(m);
  if (threadIdx.x == 0)
    out[((long long)b * H + h) * gridDim.x + gi] =
        fmaxf(m, 1e-6f) * (float)(1.0 / 127.0);
}

template <typename T, int D, bool RUNNING>
__global__ void __launch_bounds__(THREADS)
flash_int8_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  const float* __restrict__ kb, const float* __restrict__ cb,
                  const float* __restrict__ sq_g,
                  const float* __restrict__ sk_g, int H, int Sq, int Sk,
                  int gq, int gk, int nq_groups, int nk_groups,
                  long long q_bs, long long q_rs, long long k_bs,
                  long long k_rs, long long v_bs, long long v_rs,
                  float scale) {
  constexpr int RP = hv::s8_row<D>();  // int8 tile row stride (bytes)
  constexpr int CH = D / 8;            // 16-byte chunks of a bf16 row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* Q8 = reinterpret_cast<int8_t*>(smem_raw);  // [BQ][RP]
  int8_t* K8 = Q8 + BQ * RP;                          // [BK][RP]
  T* Vt = reinterpret_cast<T*>(K8 + BK * RP);         // [D][BK + 8]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;

  const T* qh = q + b * q_bs + (long long)h * D;
  const T* kh = k + b * k_bs + (long long)h * D;
  const T* vh = v + b * v_bs + (long long)h * D;
  const float* kbb = kb ? kb + (long long)b * Sk : nullptr;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  // the tile's 64 rows lie in one query group (gq is a multiple of 64)
  const float sq = sq_g[bh * nq_groups + q0 / gq];
  const float inv_q = 1.f / sq;
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero4;
    if (q0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(qh + (q0 + r) * q_rs + c);
    *reinterpret_cast<uint2*>(Q8 + r * RP + c) = hv::quant8_s8<T>(val, inv_q);
  }
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[D / 32][4];
  hv::load_q8<D>(Q8, r0, t, qa);

  const float c_off = RUNNING ? 0.f : cb[bh];
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    // the chunk's 64 keys lie in one key group (gk is a multiple of 64)
    const float sk = sk_g[bh * nk_groups + k0 / gk];
    const float inv_k = 1.f / sk;
    __syncthreads();  // every warp is done with the previous chunk
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero4, vv = zero4;
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kh + (k0 + r) * k_rs + c);
        vv = *reinterpret_cast<const uint4*>(vh + (k0 + r) * v_rs + c);
      }
      *reinterpret_cast<uint2*>(K8 + r * RP + c) =
          hv::quant8_s8<T>(kv, inv_k);
      hv::stage_v(Vt, r, c, vv);
    }
    __syncthreads();

    float bias[BK / 8][2];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + nt * 8 + 2 * t + j;
        bias[nt][j] = key < Sk ? (kbb ? kbb[key] : 0.f) : NEG_INF;
      }
    float s[BK / 8][4];
    hv::qk_chunk_s8<D>(qa, K8, s, g, t);
    hv::fold_scores<T, D, RUNNING>(s, Vt, bias, sq * sk * scale, c_off, acc,
                                   m_r, l_r, g, t);
  }

  const long long o_rs = (long long)H * D;
  T* oh = o + (long long)b * Sq * o_rs + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float denom = fmaxf(hv::quad_sum(l_r[i]), 1e-37f);
    const int r = q0 + r0 + 8 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(oh + r * o_rs + dn * 8 + 2 * t) =
          hv::pack2(acc[dn][2 * i] / denom, acc[dn][2 * i + 1] / denom,
                    T());
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  const float *kb, *c;
  float *sq, *sk;
  int B, H, Sq, Sk, gq, gk;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool RUNNING>
cudaError_t launch(const Args& a) {
  const int nq = (a.Sq + a.gq - 1) / a.gq, nk = (a.Sk + a.gk - 1) / a.gk;
  group_scales_kernel<T, D><<<dim3(nq, a.H, a.B), THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), a.q_bs, a.q_rs, a.H, a.Sq, a.gq, a.sq);
  group_scales_kernel<T, D><<<dim3(nk, a.H, a.B), THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.k), a.k_bs, a.k_rs, a.H, a.Sk, a.gk, a.sk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = flash_int8_kernel<T, D, RUNNING>;
  const int smem = (BQ + BK) * hv::s8_row<D>() + D * (BK + 8) * sizeof(T);
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.kb, a.c, a.sq,
      a.sk, a.H, a.Sq, a.Sk, a.gq, a.gk, nq, nk, a.q_bs, a.q_rs, a.k_bs,
      a.k_rs, a.v_bs, a.v_rs, a.scale);
  return cudaGetLastError();
}

template <typename T, bool RUNNING>
cudaError_t dispatch_d(int head_dim, const Args& a) {
  if (head_dim == 128) return launch<T, 128, RUNNING>(a);
  if (head_dim == 64) return launch<T, 64, RUNNING>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_mode(int running, int head_dim, const Args& a) {
  return running ? dispatch_d<T, true>(head_dim, a)
                 : dispatch_d<T, false>(head_dim, a);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. running: 0 = static offset c [B, H], 1 =
// running max. kb may be null (no key bias). gq, gk: rows per query / key
// quantization group, multiples of 64. sq [B, H, ceil(Sq/gq)] and sk
// [B, H, ceil(Sk/gk)] fp32 receive the group scales. Returns the
// cudaError_t of the launches.
extern "C" int hv_flash_int8_fwd(
    int dtype, int running, int head_dim, const void* q, const void* k,
    const void* v, void* o, const float* kb, const float* c, float* sq,
    float* sk, int B, int H, int Sq, int Sk, int gq, int gk, long long q_bs,
    long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, float scale, void* stream) {
  if (gq % BQ != 0 || gk % BK != 0) return cudaErrorInvalidValue;
  if (!running && c == nullptr) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, kb, c, sq, sk, B, H, Sq, Sk, gq, gk, q_bs, q_rs,
               k_bs, k_rs, v_bs, v_rs, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_mode<__nv_bfloat16>(running, head_dim, a);
  if (dtype == 1) return dispatch_mode<__half>(running, head_dim, a);
  return cudaErrorInvalidValue;
}
