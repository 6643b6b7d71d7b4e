// Sliding-tile attention (STA) forward for the image queries of the MM-DiT
// joint [img | txt] sequence: the permuted kernels with a static offset.
// (The direct kernels B4, B4q and the ring kernel B10 are sta_direct.cu, the
// permuted running-max kernel B7 sta_permuted.cu.)
//
// Replaces three Pallas TPU kernels of the JAX package's ops/sta.py, as one
// source with a template flag:
//   QUANT = false: _sta_nomax_fused_kernel and _sta_nomax_kernel (the same
//     function; the TPU masked or skipped the border slots, this kernel
//     skips them). q is tile-major [B, S_pad, H*D]; the keys are kcat =
//     [image tiles | text padded to whole tiles], the text blocks being
//     extra slots n_tiles + j of the neighbour table; kb [B, S_pad +
//     txt_pad] carries the padding mask and the text bias.
//   QUANT = true: the `quant=True` arm of the first, int8 Q.K^T on mma.sync
//     m16n8k32. One symmetric scale per (b, head, query tile) and per (b,
//     head, key tile), scale = max(max|x|, 1e-6) / 127, codes round(x *
//     (1/scale)) with ties to even; the text blocks are key tiles like any
//     other and are quantized. A key tile's scale does not depend on the
//     query tile, so tile_scales_kernel computes every scale once per
//     launch and the attention kernel reads them. s = s32 * (sq * sk *
//     scale).
// The softmax is the static flash kernels': p = exp(s*scale + (kb - C)),
// then out = acc / max(l, 1e-37). Rows of padding tokens are stored as
// zeros.
//
// Neighbour table nbr [n_tiles, n_slots] int32: key tile (or text block)
// of each slot, -1 = none. Every slot is tested; the TPU's forward-filled
// DMA index table is not used (it would fold a tile twice).
//
// Numerics kept from the TPU kernels: Q.K^T in the input type with fp32
// accumulation (or exact s32 under QUANT); p rounded to V's type before
// P.V; fp32 l and acc.
//
// Bound on the H100: 4*D operations per valid query-key pair on the tensor
// cores (under QUANT half of them int8, at 1,979 TOP/s); a query sees up to
// 27 tiles of 256 keys, far above the bytes of q/k/v/out, so the kernel is
// bound by operations (989 TFLOP/s bf16 dense).
// The design is the first flash kernel's (flash_tile.cuh): one block of 4
// warps owns 64 query rows of one (b, h, query tile) and walks the tile's
// valid slots in 64-key chunks; Q stays in registers as mma.sync A
// fragments; K and V^T go through padded shared memory; S and P never leave
// registers. Positions beyond the grid are masked here (no zero-padded copy
// of K/V), and a chunk with no valid key, or a 64-query block with no valid
// query, is skipped whole. Not yet done: sta_permuted.cu's wgmma + TMA ring.
#include "flash_tile.cuh"

namespace {

using hv::BK;
using hv::BQ;
using hv::NEG_INF;
using hv::THREADS;

struct Geometry {
  int T, Hg, Wg;   // token grid
  int tt, th, tw;  // tile
  int nt, nh, nw;  // tiles along t, h and w
};

// Row-major token index of flat position f of tile `tile`, or -1 when the
// position lies beyond the grid (ragged edge tiles).
__device__ __forceinline__ int token_of(const Geometry& g, int tile, int f) {
  const int a = tile / (g.nh * g.nw);
  const int bb = (tile / g.nw) % g.nh;
  const int cc = tile % g.nw;
  const int t = a * g.tt + f / (g.th * g.tw);
  const int h = bb * g.th + (f / g.tw) % g.th;
  const int w = cc * g.tw + f % g.tw;
  if (t >= g.T || h >= g.Hg || w >= g.Wg) return -1;
  return (t * g.Hg + h) * g.Wg + w;
}

// One int8 scale per (b, h, tile) of tile-major x: max(max|x|, 1e-6) / 127
// over the tile's rows tile*block + f.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
tile_scales_kernel(const T* __restrict__ x, long long bs, long long rs,
                   Geometry geo, int H, float* __restrict__ out) {
  constexpr int CH = D / 8;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int block = geo.tt * geo.th * geo.tw;
  const T* xh = x + b * bs + (long long)h * D;
  float m = 0.f;
  for (int i = threadIdx.x; i < block * CH; i += THREADS) {
    const int row = tile * block + i / CH, c = (i % CH) * 8;
    m = hv::absmax8<T>(*reinterpret_cast<const uint4*>(xh + row * rs + c),
                       m);
  }
  m = hv::block_max(m);
  if (threadIdx.x == 0)
    out[((long long)b * H + h) * gridDim.x + tile] = fmaxf(m, 1e-6f) / 127.f;
}

template <typename T, int D, bool QUANT>
__global__ void __launch_bounds__(THREADS)
sta_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               const float* __restrict__ kb, const float* __restrict__ cb,
               const int* __restrict__ nbr, const float* __restrict__ sq_t,
               const float* __restrict__ sk_t, Geometry geo, int H,
               int n_slots, int n_ktiles, long long q_bs, long long q_rs,
               long long k_bs, long long k_rs, long long v_bs,
               long long v_rs, long long o_bs, long long o_rs,
               long long kb_bs, float scale) {
  constexpr int DP = D + 8;   // padded rows: conflict-free fragment loads
  constexpr int CH = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][DP]
  T* Ks = Qs + BQ * DP;                     // [BK][DP]
  T* Vt = Ks + BK * DP;                     // [D][BK + 8], V transposed
  // QUANT: int8 Q [BQ][RP] after V^T; int8 K [BK][RP] in the K region
  constexpr int RP = hv::s8_row<D>();
  int8_t* Q8 = reinterpret_cast<int8_t*>(Vt + D * (BK + 8));
  int8_t* K8 = reinterpret_cast<int8_t*>(Ks);
  __shared__ int q_row[BQ];     // memory row of each query
  __shared__ int q_ok[BQ];      // the query token exists
  __shared__ int k_row[BK];     // memory row of each key of the chunk
  __shared__ float k_bias[BK];  // its additive bias (NEG_INF: masked)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int block = geo.tt * geo.th * geo.tw;
  const int q_subs = block / BQ, k_subs = block / BK;
  const int qi = blockIdx.x / q_subs, f0 = (blockIdx.x % q_subs) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  T* oh = o + b * o_bs + (long long)h * D;

  int valid = 0;
  if (tid < BQ) {
    valid = token_of(geo, qi, f0 + tid) >= 0;
    q_ok[tid] = valid;
    q_row[tid] = qi * block + f0 + tid;
  }
  if (!__syncthreads_or(valid)) {  // no query of these 64 rows exists
    for (int i = tid; i < BQ * CH; i += THREADS)
      *reinterpret_cast<uint4*>(oh + q_row[i / CH] * o_rs + (i % CH) * 8) =
          zero4;
    return;
  }

  const T* qh = q + b * q_bs + (long long)h * D;
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero4;
    if (q_ok[r])
      val = *reinterpret_cast<const uint4*>(qh + q_row[r] * q_rs + c);
    *reinterpret_cast<uint4*>(Qs + r * DP + c) = val;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const long long bh = (long long)b * H + h;
  uint32_t qa[D / 16][4];   // Q fragments (bf16/fp16 chunks)
  uint32_t qa8[D / 32][4];  // int8 Q fragments (QUANT)
  float sq = 0.f;
  if constexpr (QUANT) {
    sq = sq_t[bh * (gridDim.x / q_subs) + qi];  // one scale per tile
    const float inv_q = 1.f / sq;
    for (int i = tid; i < BQ * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      *reinterpret_cast<uint2*>(Q8 + r * RP + c) = hv::quant8_s8<T>(
          *reinterpret_cast<const uint4*>(Qs + r * DP + c), inv_q);
    }
    __syncthreads();
    hv::load_q8<D>(Q8, r0, t, qa8);
  } else {
    hv::load_q<T, D>(Qs, r0, t, qa);
  }

  const float c_off = cb[b * H + h];
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // unused by the static softmax
  float l_r[2] = {0.f, 0.f};          // this thread's part of the row sums

  // Chunks: k_subs per slot.
  const int n_chunks = n_slots * k_subs;
  const int* nbr_q = nbr + (long long)qi * n_slots;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int nb = nbr_q[ci / k_subs];
    if (nb < 0) continue;  // uniform across the block
    __syncthreads();       // every warp is done with the previous chunk
    int any = 0;
    if (tid < BK) {
      const int row = nb * block + (ci % k_subs) * BK + tid;
      const float bias = kb[b * kb_bs + row];
      any = bias > 0.5f * NEG_INF;
      k_row[tid] = any ? row : -1;  // masked keys read as zero K/V
      k_bias[tid] = any ? bias : NEG_INF;
    }
    if (!__syncthreads_or(any)) continue;  // no valid key in this chunk

    const T* kh = k + b * k_bs + (long long)h * D;
    const T* vh = v + b * v_bs + (long long)h * D;
    // int8 chunk: any key tile of the permuted layout
    const float sk = QUANT ? sk_t[bh * n_ktiles + nb] : 0.f;
    const float inv_k = QUANT ? 1.f / sk : 0.f;
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero4, vv = zero4;
      const int row = k_row[r];
      if (row >= 0) {
        kv = *reinterpret_cast<const uint4*>(kh + row * k_rs + c);
        vv = *reinterpret_cast<const uint4*>(vh + row * v_rs + c);
      }
      if (QUANT) {
        *reinterpret_cast<uint2*>(K8 + r * RP + c) =
            hv::quant8_s8<T>(kv, inv_k);
        hv::stage_v(Vt, r, c, vv);
      } else {
        hv::stage_kv<T, D>(Ks, Vt, r, c, kv, vv);
      }
    }
    __syncthreads();

    float bias[BK / 8][2];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) bias[nt][j] = k_bias[nt * 8 + 2 * t + j];
    if constexpr (QUANT) {
      float s[BK / 8][4];
      hv::qk_chunk_s8<D>(qa8, K8, s, g, t);
      hv::fold_scores<T, D, false>(s, Vt, bias, sq * sk * scale, c_off, acc,
                                   m_r, l_r, g, t);
    } else {
      hv::fold_chunk<T, D, false>(qa, Ks, Vt, bias, scale, c_off, acc, m_r,
                                  l_r, g, t);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = hv::quad_sum(l_r[i]);
    const int r = r0 + 8 * i;
    const int row = q_row[r];
    // a missing query row is stored as zeros
    const float inv = q_ok[r] ? 1.f / fmaxf(l, 1e-37f) : 0.f;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(oh + row * o_rs + dn * 8 + 2 * t) =
          hv::pack2(acc[dn][2 * i] * inv, acc[dn][2 * i + 1] * inv, T());
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  const float *kb, *c;
  const int* nbr;
  float *sq, *sk;
  int B, H, n_slots, n_tiles, n_ktiles;
  Geometry geo;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, kb_bs;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool QUANT>
cudaError_t launch(const Args& a) {
  if (QUANT) {
    tile_scales_kernel<T, D>
        <<<dim3(a.n_tiles, a.H, a.B), THREADS, 0, a.stream>>>(
            static_cast<const T*>(a.q), a.q_bs, a.q_rs, a.geo, a.H, a.sq);
    tile_scales_kernel<T, D>
        <<<dim3(a.n_ktiles, a.H, a.B), THREADS, 0, a.stream>>>(
            static_cast<const T*>(a.k), a.k_bs, a.k_rs, a.geo, a.H, a.sk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kern = sta_fwd_kernel<T, D, QUANT>;
  const int smem = hv::tile_smem_bytes<T, D>()
                   + (QUANT ? BQ * hv::s8_row<D>() : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int block = a.geo.tt * a.geo.th * a.geo.tw;
  dim3 grid(a.n_tiles * (block / BQ), a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.kb, a.c, a.nbr,
      a.sq, a.sk, a.geo, a.H, a.n_slots, a.n_ktiles, a.q_bs, a.q_rs, a.k_bs,
      a.k_rs, a.v_bs, a.v_rs, a.o_bs, a.o_rs, a.kb_bs, a.scale);
  return cudaGetLastError();
}

template <typename T, bool QUANT>
cudaError_t dispatch_d(int head_dim, const Args& a) {
  if (head_dim == 128) return launch<T, 128, QUANT>(a);
  if (head_dim == 64) return launch<T, 64, QUANT>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// The static permuted kernels. dtype: 0 = bf16, 1 = fp16. q tile-major [B,
// S_pad rows], k/v the kcat/vcat keys [B, n_ktiles * tile tokens rows], o
// [B, S_pad rows], each row H*D wide (batch and row strides in elements);
// kb [B, keys] fp32; c [B, H] fp32 the static offset. quant: 1 = int8
// Q.K^T; sq [B, H, n_tiles] and sk [B, H, n_ktiles] fp32 receive the tile
// scales. Tile token count a multiple of 64. Returns the cudaError_t of
// the launches.
extern "C" int hv_sta_attention_fwd(
    int dtype, int quant, int head_dim, const void* q, const void* k,
    const void* v, void* o, const float* kb, const float* c, const int* nbr,
    float* sq, float* sk, int B, int H, int n_slots, int n_ktiles, int T,
    int Hg, int Wg, int tt, int th, int tw, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    long long o_bs, long long o_rs, long long kb_bs, float scale,
    void* stream) {
  const int nt = (T + tt - 1) / tt, nh = (Hg + th - 1) / th,
            nw = (Wg + tw - 1) / tw;
  if ((tt * th * tw) % BQ != 0 || kb == nullptr || c == nullptr)
    return cudaErrorInvalidValue;
  if (quant && (sq == nullptr || sk == nullptr)) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, kb, c, nbr, sq, sk, B, H, n_slots, nt * nh * nw,
               n_ktiles, Geometry{T, Hg, Wg, tt, th, tw, nt, nh, nw}, q_bs,
               q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, kb_bs, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return quant ? dispatch_d<__nv_bfloat16, true>(head_dim, a)
                 : dispatch_d<__nv_bfloat16, false>(head_dim, a);
  if (dtype == 1)
    return quant ? dispatch_d<__half, true>(head_dim, a)
                 : dispatch_d<__half, false>(head_dim, a);
  return cudaErrorInvalidValue;
}
