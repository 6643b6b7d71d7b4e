// Flash attention forward over the MM-DiT joint [img | txt] sequence.
//
// Replaces two Pallas TPU kernels of the JAX package, as one source with a
// template flag:
//   RUNNING = false: ops/flash_attention.py:_flash_nomax_kernel, the softmax
//     with a static per-(batch, head) exponent offset C (no running max):
//       p = exp(s*scale + (kb - C)),  l += sum(p),  acc += p.V
//   RUNNING = true:  ops/flash_attention.py:_flash_kernel, the classic
//     online softmax with a running row max m and rescale exp(m_old - m_new).
// Both finish with out = acc / max(l, 1e-37) and can write the partial-
// softmax state (m, l) as [B, Sq, H] fp32 (m = C for the static kernel).
//
// Layout: q/k/v are [B, S, H*D] with each head a column slice (row strides
// are arguments), the key bias kb is [B, Sk] fp32 with entries <= 0, C is
// [B, H] fp32. The ragged q/k edge is masked here: missing keys read as zero
// K/V with bias -1e30, missing query rows are not stored.
//
// Numerics kept from the TPU kernels: Q.K^T in the input type with fp32
// accumulation; p rounded to V's type before P.V; fp32 l and acc.
//
// Bound on the H100: 4*B*H*Sq*Sk*D operations on the tensor cores; at the
// main path's lengths (thousands of tokens, D = 128) that is far above the
// bytes of q/k/v/out, so the kernel is bound by operations (989 TFLOP/s
// bf16 dense). This first design: one block of 4 warps owns 64 query rows
// of one (b, h) and loops over 64-key tiles itself (the loop replaces the
// TPU's sequential grid axis and VMEM scratch). Q stays in registers as
// mma.sync A fragments; K and V^T tiles go through padded shared memory;
// S and P never leave registers (the m16n8k16 accumulator layout is the A
// layout of the P.V product). Not yet done: wgmma, TMA, a cp.async ring
// overlapping the next tile's load with this tile's math.
#include "flash_tile.cuh"

namespace {

using hv::BK;
using hv::BQ;
using hv::NEG_INF;
using hv::THREADS;

template <typename T, int D, bool RUNNING>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const float* __restrict__ kb, const float* __restrict__ cb,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int H, int Sq, int Sk, long long q_bs, long long q_rs,
                 long long k_bs, long long k_rs, long long v_bs,
                 long long v_rs, float scale) {
  constexpr int DP = D + 8;   // padded rows: conflict-free fragment loads
  constexpr int CH = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][DP]
  T* Ks = Qs + BQ * DP;                     // [BK][DP]
  T* Vt = Ks + BK * DP;                     // [D][BK + 8], V transposed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;

  const T* qh = q + b * q_bs + (long long)h * D;
  const T* kh = k + b * k_bs + (long long)h * D;
  const T* vh = v + b * v_bs + (long long)h * D;
  const float* kbb = kb ? kb + (long long)b * Sk : nullptr;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero4;
    if (q0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(qh + (q0 + r) * q_rs + c);
    *reinterpret_cast<uint4*>(Qs + r * DP + c) = val;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[D / 16][4];
  hv::load_q<T, D>(Qs, r0, t, qa);

  const float c_off = RUNNING ? 0.f : cb[b * H + h];
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // running max, rows r0 and r0 + 8
  float l_r[2] = {0.f, 0.f};          // this thread's part of the row sums

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero4, vv = zero4;
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kh + (k0 + r) * k_rs + c);
        vv = *reinterpret_cast<const uint4*>(vh + (k0 + r) * v_rs + c);
      }
      hv::stage_kv<T, D>(Ks, Vt, r, c, kv, vv);
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
    hv::fold_chunk<T, D, RUNNING>(qa, Ks, Vt, bias, scale, c_off, acc, m_r,
                                  l_r, g, t);
  }

  const long long o_rs = (long long)H * D;
  T* oh = o + (long long)b * Sq * o_rs + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] = hv::quad_sum(l_r[i]);
    const float denom = fmaxf(l_r[i], 1e-37f);
    const int r = q0 + r0 + 8 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(oh + r * o_rs + dn * 8 + 2 * t) =
          hv::pack2(acc[dn][2 * i] / denom, acc[dn][2 * i + 1] / denom,
                    T());
    if (m_out != nullptr && t == 0) {
      const long long idx = ((long long)b * Sq + r) * H + h;
      m_out[idx] = RUNNING ? m_r[i] : c_off;
      l_out[idx] = l_r[i];
    }
  }
}

template <typename T, int D, bool RUNNING>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const float* kb, const float* c, float* m_out,
                   float* l_out, int B, int H, int Sq, int Sk,
                   long long q_bs, long long q_rs, long long k_bs,
                   long long k_rs, long long v_bs, long long v_rs,
                   float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D, RUNNING>;
  const int smem = hv::tile_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kb, c, m_out, l_out, H,
      Sq, Sk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale);
  return cudaGetLastError();
}

template <typename T, bool RUNNING>
cudaError_t dispatch_d(int head_dim, const void* q, const void* k,
                       const void* v, void* o, const float* kb,
                       const float* c, float* m_out, float* l_out, int B,
                       int H, int Sq, int Sk, long long q_bs, long long q_rs,
                       long long k_bs, long long k_rs, long long v_bs,
                       long long v_rs, float scale, cudaStream_t stream) {
  if (head_dim == 128)
    return launch<T, 128, RUNNING>(q, k, v, o, kb, c, m_out, l_out, B, H, Sq,
                                   Sk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                                   scale, stream);
  if (head_dim == 64)
    return launch<T, 64, RUNNING>(q, k, v, o, kb, c, m_out, l_out, B, H, Sq,
                                  Sk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                                  scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. running: 0 = static offset C, 1 = running max.
// kb, m_out and l_out may be null (no key bias / no state). Returns the
// cudaError_t of the launch.
extern "C" int hv_flash_attention_fwd(
    int dtype, int running, int head_dim, const void* q, const void* k,
    const void* v, void* o, const float* kb, const float* c, float* m_out,
    float* l_out, int B, int H, int Sq, int Sk, long long q_bs,
    long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && running == 0)
    return dispatch_d<__nv_bfloat16, false>(head_dim, q, k, v, o, kb, c,
                                            m_out, l_out, B, H, Sq, Sk, q_bs,
                                            q_rs, k_bs, k_rs, v_bs, v_rs,
                                            scale, st);
  if (dtype == 0 && running == 1)
    return dispatch_d<__nv_bfloat16, true>(head_dim, q, k, v, o, kb, c,
                                           m_out, l_out, B, H, Sq, Sk, q_bs,
                                           q_rs, k_bs, k_rs, v_bs, v_rs,
                                           scale, st);
  if (dtype == 1 && running == 0)
    return dispatch_d<__half, false>(head_dim, q, k, v, o, kb, c, m_out,
                                     l_out, B, H, Sq, Sk, q_bs, q_rs, k_bs,
                                     k_rs, v_bs, v_rs, scale, st);
  if (dtype == 1 && running == 1)
    return dispatch_d<__half, true>(head_dim, q, k, v, o, kb, c, m_out,
                                    l_out, B, H, Sq, Sk, q_bs, q_rs, k_bs,
                                    k_rs, v_bs, v_rs, scale, st);
  return cudaErrorInvalidValue;
}
