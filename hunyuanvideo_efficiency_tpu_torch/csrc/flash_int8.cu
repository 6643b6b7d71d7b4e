// Flash attention with int8 Q.K^T over the MM-DiT joint [img | txt]
// sequence (SageAttention-style, arXiv 2410.02367), for Hopper (sm_90a):
// s8 wgmma products fed by a TMA ring.
//
// Replaces two Pallas TPU kernels of the JAX package, as one source with a
// template flag:
//   RUNNING = false: ops/flash_attention.py:_flash_int8_nomax_kernel (:657),
//     the static per-(batch, head) exponent offset C (inflated by the caller
//     to bound the int8-rounded scores): p = exp(s + (kb - C));
//   RUNNING = true:  ops/flash_attention.py:_flash_int8_kernel (:593), the
//     online softmax with a running row max.
// with s = s32(Q8.K8^T) * (sq * sk * scale), then out = acc / max(l, 1e-37).
//
// Quantization groups are the TPU kernels' blocks: one symmetric scale per
// (b, head, group of gq query rows) and per (b, head, group of gk key rows),
// scale = max(max|x|, 1e-6) * (1/127), codes round(x * (1/scale)) with ties
// to even (hv::quant8_s8).
//
// Layout: q/k/v [B, S, H*D] with each head a column slice (row strides are
// arguments; v may be a column view of a fused projection), kb [B, Sk] fp32
// (entries <= 0), C [B, H] fp32. Numerics kept from the TPU kernels: exact
// s32 Q8.K8^T; fp32 softmax bookkeeping; p rounded to V's type before a
// bf16/fp16 P.V with fp32 accumulation.
//
// Bound on the H100: 2*B*H*Sq*Sk*D int8 operations for Q.K^T (1,979 TOP/s)
// plus as many bf16 operations for P.V (989 TFLOP/s), far above the bytes
// of q/k/v/out at the main path's lengths: bound by operations.
//
// Design: two kernels.
//   1. quantize_groups_kernel, one block a (b, h, group) of q or k (both in
//      one launch): the group's absmax, then its codes, written as int8
//      [B, S, H*D] beside the scales [B, H, groups] (and the key scales
//      once per 64 keys). The second read walks the rows backwards, so that
//      it starts on the rows still in L2.
//   2. flash_int8_kernel, on flash_attention.cu's loop (flash_wg.cuh): a
//      producer warpgroup (setmaxnreg down) and two consumer warpgroups of
//      64 query rows, BM = 128 rows a work item, tiles of BN = 128 keys in
//      a 3-slot full/empty mbarrier ring. Q8 and K8 arrive by TMA as
//      [rows][D] int8 boxes: at D = 128 a code row is one 128-byte swizzle
//      row, at D = 64 one 64-byte swizzle row (descriptor layout 2). S =
//      Q8.K8^T runs on wgmma m64n128k32 s32.s8.s8, both operands K-major
//      from shared memory, D/32 steps of 32 bytes inside the row; V comes as
//      bf16/fp16 boxes, read MN-major by K1's RS P.V. Tile j's S is issued
//      with tile j-1's P.V, the first tile peeled off (every wait
//      unconditional, so ptxas keeps the products asynchronous), and the
//      two consumer warpgroups take turns to issue (one's softmax under the
//      other's products). The s32 scores become fp32 without I2F (16 a
//      clock an SM, as ex2): adding 0x4B400000 to the bits gives 1.5 * 2^23
//      + s exactly (|s| <= 127^2 * D < 2^22), and one FADD takes 1.5 * 2^23
//      away; the FFMA with the factor comes after it, so no large terms
//      cancel.
//      Beside each tile, per key and per consumer warpgroup, the factor sq
//      * sk(key) * scale * log2(e) and the bias (kb - C) * log2(e) (-1e30
//      past Sk): a consumer's 64 rows lie in one query group (gq is a
//      multiple of 64), and the factor is per key, so key groups of 64 need
//      no special case. Timed on the card, what the first version of this
//      loop lost was the producer, not the math: one warp wrote those pairs
//      and issued the TMA, so every tile waited on its key loads, and the
//      runtime divisions (key / gk, the work item's indices) went to the
//      same slow pipe as ex2. Now warp 0 only issues TMA, warp s + 1 writes
//      slot s's pairs with its keys' data loaded a turn (three tiles)
//      ahead, the pre-pass gives the key scales per 64 keys (a shift, no
//      division), and the grid is persistent: one CTA an SM walks the
//      (query tile, head, batch) items with Q double-buffered, so the next
//      item's loads run under this one's last tiles and epilogue.
#include "flash_wg.cuh"

namespace {

using namespace hv::flash;

constexpr int QUANT_THREADS = 1024;
constexpr int RING = STAGES;  // producer warps 1..RING own one slot each
static_assert(RING <= 3, "the producer warpgroup has 3 warps beside TMA's");

// One operand of the pre-pass: x [B, S, H*D] (row stride rs, batch stride
// bs, in elements), `n` groups of `group` rows; codes [B, S, H*D] int8,
// scales [B, H, n] fp32 and, if not null, the same scales once per 64 rows,
// scales64 [B, H, ceil(S/64)] (the attention kernel's producer indexes
// them with a shift where the group would take a division).
struct QuantOperand {
  const void* x;
  long long bs, rs;
  int S, group, n;
  int8_t* codes;
  float* scales;
  float* scales64;
};

// Blocks [0, qa.n) quantize groups of q, the rest groups of k.
template <typename T, int D>
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_groups_kernel(QuantOperand qa, QuantOperand ka, int H) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  const bool is_q = blockIdx.x < qa.n;
  const QuantOperand a = is_q ? qa : ka;
  const int gi = is_q ? blockIdx.x : blockIdx.x - qa.n;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* xh = static_cast<const T*>(a.x) + b * a.bs + (long long)h * D;
  const int r0 = gi * a.group, r1 = min(r0 + a.group, a.S);
  float m = 0.f;
#pragma unroll 4
  for (int i = r0 * CH + threadIdx.x; i < r1 * CH; i += QUANT_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    m = hv::absmax8<T>(
        *reinterpret_cast<const uint4*>(xh + r * a.rs + c), m);
  }
  m = hv::block_max(m);
  // the float of the double 1/127, as the TPU kernels' weak-typed constant
  const float scale = fmaxf(m, 1e-6f) * (float)(1.0 / 127.0);
  if (threadIdx.x == 0) a.scales[((long long)b * H + h) * a.n + gi] = scale;
  if (a.scales64 != nullptr) {
    const int n64 = (a.S + 63) / 64;
    for (int j = r0 / 64 + threadIdx.x; j < (r1 + 63) / 64;
         j += QUANT_THREADS)
      a.scales64[((long long)b * H + h) * n64 + j] = scale;
  }
  const float inv = 1.f / scale;
  const long long crs = (long long)H * D;
  int8_t* ch = a.codes + (long long)b * a.S * crs + (long long)h * D;
#pragma unroll 4
  for (int i = r1 * CH - 1 - threadIdx.x; i >= r0 * CH; i -= QUANT_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    *reinterpret_cast<uint2*>(ch + r * crs + c) = hv::quant8_s8<T>(
        *reinterpret_cast<const uint4*>(xh + r * a.rs + c), inv);
  }
}

// Row r0 + 8 * i of this thread (i = 0, 1) of O * inv, as T, to orow.
template <typename T, int D>
__device__ __forceinline__ void store_row(T* orow, const float (&acc)[D / 2],
                                          int i, int t, float inv) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
        hv::pack2(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv,
                  T());
}

// Shared memory, byte offsets from a 1024-aligned base: two Q8 [BM][D]
// buffers (the next work item's rows load while this one's are in use),
// the K8 [BN][D] code tiles (one box each), V as D/64 boxes of [BN][64] T,
// and per slot the two consumer warpgroups' (factor, bias) pairs.
template <int D>
struct Smem {
  static constexpr int Q_BYTES = BM * D;
  static constexpr int K_BYTES = BN * D;
  static constexpr int V_BYTES = BN * D * 2;
  static constexpr int FB_BYTES = 2 * (BN / 2) * 16;   // [2][BN/2] float4
  static constexpr int Q = 0;                           // [2] Q8 tiles
  static constexpr int K = Q + 2 * Q_BYTES;             // [RING] K8 tiles
  static constexpr int V = K + RING * K_BYTES;          // [RING] V tiles
  static constexpr int FB = V + RING * V_BYTES;         // [RING] pairs
  static constexpr int BAR = FB + RING * FB_BYTES;
  // q_full[2], q_empty[2], full[RING], empty[RING]
  static constexpr int BYTES = BAR + (4 + 2 * RING) * 8;
  static constexpr int ALLOC = BYTES + 1024;            // base alignment
};

// A work item: 128 query rows of one (b, h), items numbered with the query
// tile fastest, so that the CTAs in flight share their heads' keys in L2.
struct Item {
  int qt, h, b;
};

__device__ __forceinline__ Item item_of(int i, int q_tiles, int H) {
  return Item{i % q_tiles, (i / q_tiles) % H, i / (q_tiles * H)};
}

template <typename T, int D, bool RUNNING>
__global__ void __launch_bounds__(THREADS, 1)
flash_int8_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  T* __restrict__ o, const float* __restrict__ kb,
                  const float* __restrict__ cb,
                  const float* __restrict__ sq_g,
                  const float* __restrict__ sk64, float* __restrict__ m_out,
                  float* __restrict__ l_out, int B, int H, int Sq, int Sk,
                  int gq, int nq, float scale) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = bars + 4 + RING;

  const int q_tiles = (Sq + BM - 1) / BM;
  const int n_items = q_tiles * H * B;
  const int n_it = (Sk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], CONSUMER_WARPS);
    }
    for (int s = 0; s < RING; ++s) {
      // the slot's (factor, bias) warp and the TMA lane's expect_tx
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], CONSUMER_WARPS);  // one lane of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    reg_dealloc<40>();
    const int pw = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int my_items =
        (int)blockIdx.x < n_items
            ? (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
            : 0;
    if (pw == 0) {
      // warp 0, one lane: the TMA loads, Q per item and K8/V per tile
      if (lane == 0) {
        int gt = 0;  // tiles through the ring so far
        for (int i = 0; i < my_items; ++i) {
          const Item w = item_of(blockIdx.x + i * gridDim.x, q_tiles, H);
          const int qb = i & 1;
          mbar_wait(&q_empty[qb], ((i >> 1) & 1) ^ 1);
          mbar_arrive_expect_tx(&q_full[qb], L::Q_BYTES);
          tma_load_3d(sm + L::Q + qb * L::Q_BYTES, &tm_q, &q_full[qb],
                      w.h * D, w.qt * BM, w.b);
          for (int it = 0; it < n_it; ++it, ++gt) {
            const int s = gt % RING;
            mbar_wait(&empty[s], ((gt / RING) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[s], L::K_BYTES + L::V_BYTES);
            tma_load_3d(sm + L::K + s * L::K_BYTES, &tm_k, &full[s], w.h * D,
                        it * BN, w.b);
#pragma unroll
            for (int c = 0; c < D / 64; ++c)
              tma_load_3d(sm + L::V + s * L::V_BYTES + c * BN * 128, &tm_v,
                          &full[s], w.h * D + 64 * c, it * BN, w.b);
          }
        }
      }
    } else if (pw <= RING) {
      // warp s + 1: the (factor, bias) pairs of every tile of ring slot s
      // (the tiles g = i * n_it + it with g % RING == s, item i of this
      // CTA), each tile's key data loaded one of its turns (RING tiles)
      // ahead, so that no load's latency stands between a free slot and
      // its full barrier. This lane's keys of a tile are k0 + lane + 32u.
      const int s = pw - 1;
      const float sl2 = scale * LOG2E;
      const int n64 = (Sk + 63) / 64;
      float kx[BN / 32], ks[BN / 32], c_off = 0.f, sq0 = 0.f, sq1 = 0.f;
      int li = -1;                 // the item whose values are loaded
      const float* kbb = nullptr;  // its key bias row
      const float* skk = nullptr;  // its per-64-key scales
      auto load = [&](int i, int it) {
        if (i != li) {  // a new item: once per item, not per tile
          li = i;
          const Item w = item_of(blockIdx.x + i * gridDim.x, q_tiles, H);
          const long long bh = (long long)w.b * H + w.h;
          const int q0 = w.qt * BM;
          c_off = RUNNING ? 0.f : cb[bh];
          // each consumer warpgroup's query group (rows past Sq: the last)
          sq0 = sq_g[bh * nq + min(q0 / gq, nq - 1)];
          sq1 = sq_g[bh * nq + min((q0 + 64) / gq, nq - 1)];
          kbb = kb ? kb + (long long)w.b * Sk : nullptr;
          skk = sk64 + bh * n64;
        }
#pragma unroll
        for (int u = 0; u < BN / 32; ++u) {
          const int key = it * BN + lane + 32 * u;
          const bool valid = key < Sk;
          kx[u] = valid ? (kbb ? kbb[key] : 0.f) : NEG_INF;
          ks[u] = valid ? skk[key >> 6] : 0.f;
        }
      };
      int i = 0, it = s;
      while (i < my_items && it >= n_it) it -= n_it, ++i;
      if (i < my_items) load(i, it);
      for (int use = 0; i < my_items; ++use) {
        mbar_wait(&empty[s], (use & 1) ^ 1);
        float* fb = reinterpret_cast<float*>(sm + L::FB + s * L::FB_BYTES);
#pragma unroll
        for (int u = 0; u < BN / 32; ++u) {
          const int idx = lane + 32 * u;
          const float bias = (kx[u] - c_off) * LOG2E;
          const float fk = ks[u] * sl2;
          float* p = fb + (idx >> 1) * 4 + (idx & 1);
          p[0] = sq0 * fk;
          p[2] = bias;
          p[BN * 2] = sq1 * fk;      // the second warpgroup's pairs
          p[BN * 2 + 2] = bias;
        }
        it += RING;  // this slot's next tile
        while (i < my_items && it >= n_it) it -= n_it, ++i;
        if (i < my_items) load(i, it);
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    reg_alloc<232>();
    const int ct = threadIdx.x - 128;
    const int wgc = ct >> 7;                 // consumer warpgroup: 0 or 1
    const int warp = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const float4* fb_base =
        reinterpret_cast<const float4*>(sm + L::FB) + wgc * (BN / 2);
    constexpr int FB_STRIDE = L::FB_BYTES / 16;  // float4s a slot
    const uint32_t k_base = smem_u32(sm + L::K);
    const uint32_t v_base = smem_u32(sm + L::V);
    int gt = 0;  // tiles through the ring so far
    for (int i = 0, item = blockIdx.x; item < n_items;
         ++i, item += gridDim.x) {
      const Item w = item_of(item, q_tiles, H);
      const int qb = i & 1;
      const uint32_t q_addr =
          smem_u32(sm + L::Q + qb * L::Q_BYTES) + wgc * 64 * D;
      float acc[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
      float m_r[2] = {NEG_INF * LOG2E, NEG_INF * LOG2E};  // log2 units
      float l_r[2] = {0.f, 0.f};  // this thread's part of the row sums
      uint32_t pa[BN / 16][4];    // P of the previous tile, T in A layout
      float corr[2] = {1.f, 1.f};
      if (wgc == 1) turn_pass(wgc);  // the first warpgroup issues first
      mbar_wait(&q_full[qb], (i >> 1) & 1);
      // Tile it's S is issued together with tile it-1's P.V; the first
      // tile is peeled off, so that every wait in the loop is
      // unconditional.
      {
        const int s = gt % RING;
        mbar_wait(&full[s], (gt / RING) & 1);
        __syncwarp();  // converged for the .aligned wgmma instructions
        int sc[64];
        turn_wait(wgc);
        wgmma_fence();
        issue_qk_s8<D>(sc, q_addr, k_base + s * L::K_BYTES);
        turn_pass(wgc);
        wgmma_wait<0>();
        fence_regs(sc);
        float x[64];
        softmax_tile_s8<RUNNING>(sc, x, fb_base + s * FB_STRIDE, t, m_r,
                                 l_r, corr);
        pack_p<T>(x, pa);
      }
      for (int it = 1; it < n_it; ++it) {
        const int s = (gt + it) % RING;
        const int s_prev = (gt + it - 1) % RING;
        mbar_wait(&full[s], ((gt + it) / RING) & 1);
        __syncwarp();
        int sc[64];
        turn_wait(wgc);
        wgmma_fence();
        issue_qk_s8<D>(sc, q_addr, k_base + s * L::K_BYTES);
        issue_pv<T, D>(acc, pa, v_base + s_prev * L::V_BYTES);
        turn_pass(wgc);
        wgmma_wait<1>();  // S is done; the previous P.V may still run
        fence_regs(sc);
        float x[64];
        softmax_tile_s8<RUNNING>(sc, x, fb_base + s * FB_STRIDE, t, m_r,
                                 l_r, corr);
        wgmma_wait<0>();  // the previous tile's P.V is done
        fence_regs(acc);
        fence_pa(pa);
        if (lane == 0) mbar_arrive(&empty[s_prev]);
        if (RUNNING) rescale<D>(acc, corr);
        pack_p<T>(x, pa);
      }
      {  // the last tile's P.V; then its slot and the Q buffer are free
        const int s_last = (gt + n_it - 1) % RING;
        turn_wait(wgc);
        wgmma_fence();
        issue_pv<T, D>(acc, pa, v_base + s_last * L::V_BYTES);
        // the second warpgroup's last pass would find no one to wait for
        // it; it passes at the next item's start instead
        if (wgc == 0) turn_pass(wgc);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_pa(pa);
        if (lane == 0) {
          mbar_arrive(&empty[s_last]);
          mbar_arrive(&q_empty[qb]);
        }
      }
      gt += n_it;

      // epilogue: rows r0 and r0 + 8 of this thread
      const int r0 = w.qt * BM + wgc * 64 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float l = quad_sum(l_r[j]);
        const int r = r0 + 8 * j;
        if (r >= Sq) continue;
        store_row<T, D>(
            o + ((long long)w.b * Sq + r) * H * D + (long long)w.h * D, acc,
            j, t, 1.f / fmaxf(l, 1e-37f));
        if (m_out != nullptr && t == 0) {  // the partial-softmax state
          const long long idx = ((long long)w.b * Sq + r) * H + w.h;
          m_out[idx] = RUNNING ? m_r[j] * LN2 : cb[(long long)w.b * H + w.h];
          l_out[idx] = l;
        }
      }
    }
  }
}

struct Args {
  const void *q8, *k8, *v;
  void* o;
  const float *kb, *c, *sq, *sk64;
  float *m_out, *l_out;
  int B, H, Sq, Sk, gq;
  long long v_bs, v_rs;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool RUNNING>
cudaError_t launch(const Args& a) {
  const long long crs = (long long)a.H * D;  // code row stride (bytes)
  CUtensorMap tq, tk, tv;
  if (!encode_rows_s8(&tq, a.q8, a.H * D, a.Sq, a.B, crs, crs * a.Sq, D,
                      BM) ||
      !encode_rows_s8(&tk, a.k8, a.H * D, a.Sk, a.B, crs, crs * a.Sk, D,
                      BN) ||
      !encode_rows<T>(&tv, a.v, a.H * D, a.Sk, a.B, a.v_rs, a.v_bs, BN))
    return cudaErrorInvalidValue;
  auto kern = flash_int8_kernel<T, D, RUNNING>;
  const int smem = Smem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (a.Sq + a.gq - 1) / a.gq;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  // one persistent CTA an SM, each walking every sms-th work item
  const long long items = (long long)((a.Sq + BM - 1) / BM) * a.H * a.B;
  const int grid = (int)(items < sms ? items : sms);
  kern<<<grid, THREADS, smem, a.stream>>>(
      tq, tk, tv, static_cast<T*>(a.o), a.kb, a.c, a.sq, a.sk64, a.m_out,
      a.l_out, a.B, a.H, a.Sq, a.Sk, a.gq, nq, a.scale);
  return cudaGetLastError();
}

template <typename T, bool RUNNING>
cudaError_t dispatch_d(int head_dim, const Args& a) {
  if (head_dim == 128) return launch<T, 128, RUNNING>(a);
  if (head_dim == 64) return launch<T, 64, RUNNING>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t quantize(int head_dim, const QuantOperand& qa,
                     const QuantOperand& ka, int B, int H,
                     cudaStream_t stream) {
  const dim3 grid(qa.n + ka.n, H, B);
  if (head_dim == 128)
    quantize_groups_kernel<T, 128><<<grid, QUANT_THREADS, 0, stream>>>(
        qa, ka, H);
  else if (head_dim == 64)
    quantize_groups_kernel<T, 64><<<grid, QUANT_THREADS, 0, stream>>>(
        qa, ka, H);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// The pre-pass: q [B, Sq, H*D] and k [B, Sk, H*D] (row and batch strides in
// elements) in groups of gq / gk rows (multiples of 64) to int8 codes q8
// [B, Sq, H*D], k8 [B, Sk, H*D] and fp32 scales sq [B, H, ceil(Sq/gq)], sk
// [B, H, ceil(Sk/gk)], and, if sk64 is not null, the key scales once per 64
// keys, sk64 [B, H, ceil(Sk/64)] (what hv_flash_int8_fwd reads). dtype: 0 =
// bf16, 1 = fp16. Returns the cudaError_t of the launch.
extern "C" int hv_quantize_groups(int dtype, int head_dim, const void* q,
                                  long long q_bs, long long q_rs, int Sq,
                                  int gq, const void* k, long long k_bs,
                                  long long k_rs, int Sk, int gk, int B,
                                  int H, void* q8, void* k8, float* sq,
                                  float* sk, float* sk64, void* stream) {
  if (gq % 64 != 0 || gk % 64 != 0 || gq <= 0 || gk <= 0)
    return cudaErrorInvalidValue;
  const QuantOperand qa{q, q_bs, q_rs, Sq, gq, (Sq + gq - 1) / gq,
                        static_cast<int8_t*>(q8), sq, nullptr};
  const QuantOperand ka{k, k_bs, k_rs, Sk, gk, (Sk + gk - 1) / gk,
                        static_cast<int8_t*>(k8), sk, sk64};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return quantize<__nv_bfloat16>(head_dim, qa, ka, B, H, st);
  if (dtype == 1) return quantize<__half>(head_dim, qa, ka, B, H, st);
  return cudaErrorInvalidValue;
}

// The attention on the pre-pass's codes and scales: q8/k8 contiguous int8
// [B, S, H*D], sq [B, H, ceil(Sq/gq)], sk64 [B, H, ceil(Sk/64)], v [B, Sk,
// H*D] of type dtype (0 = bf16, 1 = fp16; row and batch strides in
// elements), o [B, Sq, H*D]. running: 0 = static offset c [B, H], 1 =
// running max. kb may be null (no key bias). m_out and l_out, both null or
// both [B, Sq, H] fp32, take the partial-softmax state (m in natural units,
// = C for the static offset; l the row sums), what merge_flash_states
// folds. Returns the cudaError_t of the launch.
extern "C" int hv_flash_int8_fwd(
    int dtype, int running, int head_dim, const void* q8, const void* k8,
    const void* v, void* o, const float* kb, const float* c, const float* sq,
    const float* sk64, float* m_out, float* l_out, int B, int H, int Sq,
    int Sk, int gq, long long v_bs, long long v_rs, float scale,
    void* stream) {
  if (gq % 64 != 0 || gq <= 0 || Sk <= 0 || sk64 == nullptr)
    return cudaErrorInvalidValue;
  if (!running && c == nullptr) return cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  const Args a{q8, k8, v, o, kb, c, sq, sk64, m_out, l_out, B, H, Sq, Sk,
               gq, v_bs, v_rs, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return running ? dispatch_d<__nv_bfloat16, true>(head_dim, a)
                   : dispatch_d<__nv_bfloat16, false>(head_dim, a);
  if (dtype == 1)
    return running ? dispatch_d<__half, true>(head_dim, a)
                   : dispatch_d<__half, false>(head_dim, a);
  return cudaErrorInvalidValue;
}
