// Sliding-tile attention (STA) forward for the image queries of the MM-DiT
// joint [img | txt] sequence on the permuted (tile-major) layout, for Hopper
// (sm_90a): wgmma products fed by a TMA ring.
//
// Replaces four Pallas kernels of the JAX package's ops/sta.py, as one
// source with template flags:
//   RUNNING = true (B7, _sta_kernel :267): the online softmax with a running
//     row max m and rescale exp(m_old - m_new);
//   RUNNING = false (B6a/B6b, _sta_nomax_fused_kernel :400 and
//     _sta_nomax_kernel :329, one function: the TPU masked or skipped the
//     border slots, this kernel skips them): the static per-(batch, head)
//     offset C, p = exp(s*scale + kb - C);
//   QUANT = true (B6q, their quant=True arms :366-376, :446-458): Q.K^T in
//     int8 for every key tile, the text blocks included; one symmetric scale
//     per (batch, head, tile) of qp and of kcat, scale = max(max|x|, 1e-6) /
//     127 over the tile's rows, codes round(x * (1/scale)) with ties to even
//     (tile_codes_kernel, a pre-pass), s = s32(Q8.K8^T) * (sq * sk * scale);
// out = acc / max(l, 1e-37) in every arm.
// qp is [B, S_pad, H*D], the image queries in tile-major order (tile i's
// tokens, in (t, h, w) order, at rows i*block...); kcat/vcat are [B,
// n_ktiles*block, H*D] = [image tiles | text padded to whole tiles]; kb [B,
// n_ktiles*block] fp32 is the key bias (-1e30 on padding tokens, then the
// text bias); nbr [n_tiles, n_slots] int32 is the key tile of each slot of a
// query tile (the text blocks are slots n_tiles + j), -1 none. Numerics kept
// from the TPU kernels: Q.K^T in the input type with fp32 accumulation (or
// exact s32 under QUANT); p rounded to V's type before P.V; fp32 l and acc.
// Rows of padding tokens are stored as zeros.
//
// Bound on the H100: 4*D operations per valid query-key pair on the tensor
// cores (989 TFLOP/s bf16 dense; under QUANT the Q.K^T half at the int8
// rate, 1,979 TOP/s); a query sees up to 27 tiles of 256 keys plus the
// text, far above the bytes of q/k/v/out, so the kernel is bound by
// operations. The design is K1/K2's block (flash_attention.cu) on the
// neighbour table's key walk, with sta_direct.cu's (B4's) producer:
//   * A block of three warpgroups owns R = 128 rows of one (b, h, query
//     tile) (R = 64 when the tile's token count is not a multiple of 128:
//     both consumer warpgroups take the same rows and the first stores
//     them), loaded once as a box of a 3-D map (H*D columns, rows, B; under
//     QUANT one box of D int8 columns of the codes). Blocks are numbered
//     box, query tile (w innermost), head, batch, so the blocks in flight
//     share their neighbours' keys in L2. A block none of whose rows is a
//     token writes zeros and returns.
//   * Keys arrive in chunks of 128 (128 / R boxes of R rows of kcat/vcat;
//     under QUANT of the kcat codes and vcat) through a ring of 3 slots:
//     each non-negative slot of nbr[qtile] in slot order, a tile's boxes in
//     turn, the text blocks like any other tile. Before the walk all
//     threads mark the live boxes (a warp a box: any key not masked in kb),
//     so that a box all of whose keys are masked (an edge tile's padding
//     frames, the text padding) is not loaded. Warp 0 of the producer
//     warpgroup walks the marks by counters and issues TMA, writing each
//     chunk's box rows beside its slot; warp s + 1 writes slot s's per-key
//     bias from kb, less C (-1e30 for a short chunk's repeated box), in log2
//     units, as B8's and B4's warps do; under QUANT beside each key's factor
//     sq * sk * scale, sk that of the key's own tile (with R = 64 a chunk
//     pairs boxes of two tiles).
//   * The consumers run sta_wg.cuh's loop: S = Q.K^T by wgmma (SS,
//     K-major; under QUANT s8 m64n128k32 on the codes), the static or the
//     online softmax, P packed to T and P.V by wgmma (RS, V MN-major);
//     chunk j's S is issued with chunk j-1's P.V, under RUNNING O is
//     rescaled once that P.V is done, and the two warpgroups take turns to
//     issue.
//   * B6q's pre-pass (tile_codes_kernel) writes the codes of qp and kcat in
//     their own tile-major rows and the scales: one block a (tile, head,
//     batch), a tile being `block` contiguous rows. The 16-bit Q box is not
//     loaded under QUANT (every chunk is s8), so a slot holds 128 keys of
//     int8 K and their V (48 KB at D = 128) and the block takes 164 KB.
#include "sta_wg.cuh"

namespace {

using namespace hv::flash;

constexpr int KB = 2;          // the most key boxes a chunk (R = 64)
constexpr int LIVE_WORDS = 32;  // marks of up to 1024 boxes a query tile
constexpr int CODES_THREADS = 256;

struct Geo {
  int T, Hg, Wg;   // token grid
  int tt, th, tw;  // tile
  int nh, nw;      // tiles along h and w
  int rows;        // R: rows of a box, 128 or 64
  int subs;        // boxes a tile
  int n_slots;     // slots of the neighbour table
};

// Shared memory, byte offsets from a 1024-aligned base: Q (D/64 TMA boxes of
// [128][64] T, 128-byte rows, swizzled; under QUANT [128][D] int8 codes, one
// swizzled row a token), the ring's slots (StaSlot: K, V, the per-key bias
// or (factor, bias) pairs), beside each slot its chunk's box rows, the
// barriers and the live boxes' marks.
template <int D, bool QUANT>
struct Smem : StaSlot<D, QUANT> {
  using S = StaSlot<D, QUANT>;
  static constexpr int STAGES = S::STAGES;
  static constexpr int Q_BYTES = BM * D * (QUANT ? 1 : 2);
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;                 // [STAGES] K tiles
  static constexpr int V = K + STAGES * S::K_BYTES;     // [STAGES] V tiles
  static constexpr int W = V + STAGES * S::V_BYTES;     // [STAGES] biases
  static constexpr int BOX = W + STAGES * S::W_BYTES;   // [STAGES] int[KB]
  // barriers: q, full[], empty[], boxed[] (a slot's box rows are written)
  static constexpr int BAR = BOX + STAGES * KB * 4;
  static constexpr int LIVE = BAR + (1 + 3 * STAGES) * 8;
  static constexpr int BYTES = LIVE + LIVE_WORDS * 4;
  static constexpr int ALLOC = BYTES + 1024;            // base alignment
};

// Whether flat position f of query tile (a, b, c) is a token of the grid.
__device__ __forceinline__ bool is_token(const Geo& g, int a, int b, int c,
                                         int f) {
  return a * g.tt + f / (g.th * g.tw) < g.T &&
         b * g.th + (f / g.tw) % g.th < g.Hg && c * g.tw + f % g.tw < g.Wg;
}

template <typename T, int D, bool RUNNING, bool QUANT>
__global__ void __launch_bounds__(THREADS, 1)
sta_permuted_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    T* __restrict__ o, const float* __restrict__ kb,
                    const float* __restrict__ cb, const int* __restrict__ nbr,
                    const float* __restrict__ sq_t,
                    const float* __restrict__ sk_t, Geo geo, int H,
                    int n_ktiles, long long o_bs, long long o_rs,
                    long long kb_bs, float scale) {
  static_assert(!(QUANT && RUNNING), "the int8 arm has a static offset");
  using L = Smem<D, QUANT>;
  constexpr int STAGES = L::STAGES;
  const int block = geo.rows * geo.subs;
  const int qtile = blockIdx.x / geo.subs, qsub = blockIdx.x % geo.subs;
  const int qa = qtile / (geo.nh * geo.nw), qb = (qtile / geo.nw) % geo.nh,
            qc = qtile % geo.nw;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qtile * block + qsub * geo.rows;  // the block's first row
  T* ob = o + b * o_bs + (long long)q0 * o_rs + (long long)h * D;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  uint64_t* boxed = bars + 1 + 2 * STAGES;
  int* box_s = reinterpret_cast<int*>(sm + L::BOX);
  uint32_t* live_s = reinterpret_cast<uint32_t*>(sm + L::LIVE);

  // All threads at once: whether any of the block's rows is a token, and
  // the live key boxes of the query tile's slots (a warp a box).
  const int n_boxes = geo.n_slots * geo.subs;
  if (threadIdx.x < LIVE_WORDS) live_s[threadIdx.x] = 0u;
  const bool any_row = __syncthreads_or(
      threadIdx.x < geo.rows &&
      is_token(geo, qa, qb, qc, qsub * geo.rows + threadIdx.x));
  const int warp_id = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  const int* nbr_q = nbr + (long long)qtile * geo.n_slots;
  const float* kbb = kb + b * kb_bs;
  if (any_row) {
    for (int i = warp_id; i < n_boxes; i += THREADS / 32) {
      const int nb = nbr_q[i / geo.subs];
      bool live = false;
      if (nb >= 0) {
        const float* x =
            kbb + (long long)nb * block + (i % geo.subs) * geo.rows;
        for (int j = lane_id; j < geo.rows; j += 32)
          live |= x[j] > 0.5f * NEG_INF;
      }
      if (__any_sync(0xffffffffu, live) && lane_id == 0)
        atomicOr(&live_s[i >> 5], 1u << (i & 31));
    }
  }
  __syncthreads();
  int n_live = 0;
  for (int w = 0; w < (n_boxes + 31) / 32; ++w) n_live += __popc(live_s[w]);
  if (n_live == 0) {
    // no query row, or no key: zeros, as the plain version stores for
    // padding rows (a row of tokens with every key masked has l = 0)
    constexpr int CH = D / 8;  // 16-byte chunks of a row
    for (int i = threadIdx.x; i < geo.rows * CH; i += THREADS)
      *reinterpret_cast<uint4*>(ob + (i / CH) * o_rs + (i % CH) * 8) =
          make_uint4(0, 0, 0, 0);
    return;
  }
  const int kbc = BN / geo.rows;  // key boxes a chunk
  const int n_chunks = (n_live + kbc - 1) / kbc;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the slot's bias warp and the TMA lane's expect_tx
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], CONSUMER_WARPS);  // one lane of each consumer warp
      mbar_init(&boxed[s], 1);               // the TMA lane
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    // setmaxnreg moves registers within the block's own 168 a thread:
    // 128 x 40 + 256 x 232 is all of them
    reg_dealloc<40>();
    const int pw = warp_id, lane = lane_id;
    if (pw == 0) {
      if (lane == 0) {
        // warp 0, one lane: the TMA loads, Q once, then K/V chunk by chunk
        const uint32_t qbar = smem_u32(q_full);
        mbar_arrive_expect_tx(qbar, geo.rows * D * (QUANT ? 1 : 2));
        if (QUANT) {
          tma_load_3d(smem_u32(sm + L::Q), &tm_q, qbar, h * D, q0, b);
        } else {
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            tma_load_3d(smem_u32(sm + L::Q + c * BM * 128), &tm_q, qbar,
                        h * D + 64 * c, q0, b);
        }
        // the walk over the marks: box i = slot * subs + sub, by counters
        int i = 0, slot = 0, sub = 0;
        auto next = [&](int& row) {
          while (i < n_boxes) {
            const bool live = (live_s[i >> 5] >> (i & 31)) & 1u;
            const int box_slot = slot, box_sub = sub;
            ++i;
            if (++sub == geo.subs) sub = 0, ++slot;
            if (live) {
              row = nbr_q[box_slot] * block + box_sub * geo.rows;
              return true;
            }
          }
          return false;
        };
        for (int it = 0; it < n_chunks; ++it) {
          const int s = it % STAGES;
          // the chunk's box rows (-1: a repeated box, masked), walked while
          // its slot may still be in use
          int r0, r1;
          next(r0);  // a chunk's first box is always live
          if (kbc != 2 || !next(r1)) r1 = -1;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          const uint32_t kdst = smem_u32(sm + L::K + s * L::K_BYTES);
          const uint32_t vdst = smem_u32(sm + L::V + s * L::V_BYTES);
          const uint32_t bar = smem_u32(&full[s]);
          box_s[KB * s] = r0;
          box_s[KB * s + 1] = r1;
          mbar_arrive(&boxed[s]);
          mbar_arrive_expect_tx(bar, BN * D * (QUANT ? 3 : 4));
          for (int u = 0; u < kbc; ++u) {
            // a short chunk loads its first box again, masked
            const int row = u == 1 && r1 >= 0 ? r1 : r0;
            if (QUANT)
              tma_load_3d(kdst + u * geo.rows * D, &tm_k, bar, h * D, row, b);
#pragma unroll
            for (int c = 0; c < D / 64; ++c) {
              const uint32_t off = c * BN * 128 + u * geo.rows * 128;
              if (!QUANT)
                tma_load_3d(kdst + off, &tm_k, bar, h * D + 64 * c, row, b);
              tma_load_3d(vdst + off, &tm_v, bar, h * D + 64 * c, row, b);
            }
          }
        }
      }
    } else if (pw <= STAGES) {
      // warp s + 1: the per-key bias of every chunk of ring slot s (chunks
      // s, s + STAGES, ...), from the box rows the TMA lane writes beside
      // the slot: kb at the key's row, less C, in log2 units; under QUANT
      // beside the key's factor sq * sk * scale (log2 units), sk that of
      // the key's own tile
      const int s = pw - 1;
      const long long bh = (long long)b * H + h;
      const float c_off = RUNNING ? 0.f : cb[bh];
      const float fq =
          QUANT ? sq_t[bh * (gridDim.x / geo.subs) + qtile] * scale * LOG2E
                : 0.f;
      const float* skb = QUANT ? sk_t + bh * n_ktiles : nullptr;
      float* ws = reinterpret_cast<float*>(sm + L::W + s * L::W_BYTES);
      for (int it = s, use = 0; it < n_chunks; it += STAGES, ++use) {
        mbar_wait(&boxed[s], use & 1);
#pragma unroll
        for (int i = 0; i < BN / 32; ++i) {
          const int key = lane + 32 * i;
          const int u = key >= geo.rows;  // the key's box in the chunk
          const int row = box_s[KB * s + u];
          const float x =
              row >= 0 ? kbb[row + key - u * geo.rows] : NEG_INF;
          const float bias = (x - c_off) * LOG2E;
          if (QUANT) {
            float* p = ws + (key >> 1) * 4 + (key & 1);
            p[0] = row >= 0 ? fq * skb[row / block] : 0.f;
            p[2] = bias;
          } else {
            ws[key] = bias;
          }
        }
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
    const int row0 = geo.rows == BM ? wgc * 64 : 0;  // the warpgroup's rows
    // Q's rows: 128-byte rows of the 16-bit boxes, or D-byte rows of the
    // codes (QUANT)
    const uint32_t q_addr =
        smem_u32(sm + L::Q) + row0 * (QUANT ? D : 128);
    const Consumer<T, D, QUANT, RUNNING> cs{
        full, empty, q_addr, q_addr, smem_u32(sm + L::K), smem_u32(sm + L::V),
        reinterpret_cast<const float*>(sm + L::W), scale * LOG2E, t, lane,
        wgc};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_r[2] = {NEG_INF * LOG2E, NEG_INF * LOG2E};  // log2 units
    float l_r[2] = {0.f, 0.f};  // this thread's part of the row sums
    uint32_t pa[BN / 16][4];    // P of the previous chunk, T in A layout

    if (wgc == 1) turn_pass(wgc);  // the first warpgroup issues first
    mbar_wait(q_full, 0);
    // chunk 0 is peeled off, so that every wait in the loop is
    // unconditional
    constexpr Kind CK = QUANT ? Kind::s8 : Kind::bf16;
    cs.template step<CK, CK, true>(0, acc, m_r, l_r, pa);
    for (int it = 1; it < n_chunks; ++it)
      cs.template step<CK, CK>(it, acc, m_r, l_r, pa);
    cs.template last<CK>(n_chunks - 1, acc, pa);

    // epilogue: rows r and r + 8 of the box, zeros for a padding token; R
    // = 64 leaves the store to the first warpgroup
    if (geo.rows == BM || wgc == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + warp * 16 + g + 8 * i;
        const float l = quad_sum(l_r[i]);
        const float inv = is_token(geo, qa, qb, qc, qsub * geo.rows + r)
                              ? 1.f / fmaxf(l, 1e-37f)
                              : 0.f;
        T* orow = ob + r * o_rs;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
              hv::pack2(acc[4 * j + 2 * i] * inv,
                        acc[4 * j + 2 * i + 1] * inv, T());
      }
    }
  }
}

// B6q's pre-pass: one block a (tile, head, batch) of qp (blocks [0,
// n_tiles)) or of kcat (the rest): the absmax over the tile's `block` rows,
// padding rows included, the scale max(m, 1e-6) / 127 to sq [B, H, n_tiles]
// or sk [B, H, n_ktiles], then the rows' codes round(x * (1/scale)) to q8
// [B, n_tiles*block, H*D] or k8 [B, n_ktiles*block, H*D] int8 (contiguous).
template <typename T, int D>
__global__ void __launch_bounds__(CODES_THREADS)
tile_codes_kernel(const T* __restrict__ q, long long q_bs, long long q_rs,
                  const T* __restrict__ k, long long k_bs, long long k_rs,
                  int H, int n_tiles, int n_ktiles, int block,
                  int8_t* __restrict__ q8, int8_t* __restrict__ k8,
                  float* __restrict__ sq, float* __restrict__ sk) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  const bool is_q = (int)blockIdx.x < n_tiles;
  const int tile = is_q ? blockIdx.x : blockIdx.x - n_tiles;
  const int n = is_q ? n_tiles : n_ktiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = is_q ? q_rs : k_rs;
  const T* x = (is_q ? q + b * q_bs : k + b * k_bs) +
               (long long)tile * block * rs + (long long)h * D;
  float m = 0.f;
  for (int i = threadIdx.x; i < block * CH; i += CODES_THREADS)
    m = hv::absmax8<T>(
        *reinterpret_cast<const uint4*>(x + (i / CH) * rs + (i % CH) * 8), m);
  m = hv::block_max(m);
  const float scale = fmaxf(m, 1e-6f) / 127.f;
  if (threadIdx.x == 0)
    (is_q ? sq : sk)[((long long)b * H + h) * n + tile] = scale;
  const float inv = 1.f / scale;
  const long long crs = (long long)H * D;
  int8_t* codes = (is_q ? q8 : k8) +
                  ((long long)b * n + tile) * block * crs + (long long)h * D;
  for (int i = threadIdx.x; i < block * CH; i += CODES_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    *reinterpret_cast<uint2*>(codes + r * crs + c) = hv::quant8_s8<T>(
        *reinterpret_cast<const uint4*>(x + r * rs + c), inv);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  const float *kb, *c;
  const int* nbr;
  const float *sq, *sk;
  int B, H, n_ktiles;
  Geo geo;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, kb_bs;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool RUNNING, bool QUANT>
cudaError_t launch(const Args& a) {
  const Geo& g = a.geo;
  const int block = g.rows * g.subs;
  const int n_tiles = ((g.T + g.tt - 1) / g.tt) * g.nh * g.nw;
  const int cols = a.H * D;
  CUtensorMap tq, tk, tv;
  // under QUANT q and k are the pre-pass's codes: D-byte box rows
  const bool ok =
      (QUANT ? encode_rows_s8(&tq, a.q, cols, n_tiles * block, a.B, a.q_rs,
                              a.q_bs, D, g.rows) &&
                   encode_rows_s8(&tk, a.k, cols, a.n_ktiles * block, a.B,
                                  a.k_rs, a.k_bs, D, g.rows)
             : encode_rows<T>(&tq, a.q, cols, n_tiles * block, a.B, a.q_rs,
                              a.q_bs, g.rows) &&
                   encode_rows<T>(&tk, a.k, cols, a.n_ktiles * block, a.B,
                                  a.k_rs, a.k_bs, g.rows)) &&
      encode_rows<T>(&tv, a.v, cols, a.n_ktiles * block, a.B, a.v_rs,
                     a.v_bs, g.rows);
  if (!ok) return cudaErrorInvalidValue;
  auto kern = sta_permuted_kernel<T, D, RUNNING, QUANT>;
  const int smem = Smem<D, QUANT>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles * g.subs, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      tq, tk, tv, static_cast<T*>(a.o), a.kb, a.c, a.nbr, a.sq, a.sk, g, a.H,
      a.n_ktiles, a.o_bs, a.o_rs, a.kb_bs, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_arm(int running, int quant, const Args& a) {
  if (running) return launch<T, D, true, false>(a);
  if (quant) return launch<T, D, false, true>(a);
  return launch<T, D, false, false>(a);
}

template <typename T>
cudaError_t dispatch_d(int head_dim, int running, int quant, const Args& a) {
  if (head_dim == 128) return dispatch_arm<T, 128>(running, quant, a);
  if (head_dim == 64) return dispatch_arm<T, 64>(running, quant, a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t codes(int head_dim, const void* q, long long q_bs, long long q_rs,
                  const void* k, long long k_bs, long long k_rs, int B,
                  int H, int n_tiles, int n_ktiles, int block, void* q8,
                  void* k8, float* sq, float* sk, cudaStream_t stream) {
  const dim3 grid(n_tiles + n_ktiles, H, B);
  auto run = [&](auto kern) {
    kern<<<grid, CODES_THREADS, 0, stream>>>(
        static_cast<const T*>(q), q_bs, q_rs, static_cast<const T*>(k), k_bs,
        k_rs, H, n_tiles, n_ktiles, block, static_cast<int8_t*>(q8),
        static_cast<int8_t*>(k8), sq, sk);
    return cudaGetLastError();
  };
  if (head_dim == 128) return run(tile_codes_kernel<T, 128>);
  if (head_dim == 64) return run(tile_codes_kernel<T, 64>);
  return cudaErrorInvalidValue;
}

}  // namespace

// B6q's pre-pass. qp [B, n_tiles*block rows] and kcat [B, n_ktiles*block
// rows], each row H*D wide (batch and row strides in elements; dtype 0 =
// bf16, 1 = fp16), to int8 codes q8 [B, n_tiles*block, H*D] and k8 [B,
// n_ktiles*block, H*D] (contiguous) with one scale per (b, h, tile), sq [B,
// H, n_tiles] and sk [B, H, n_ktiles] fp32. Returns the cudaError_t of the
// launch.
extern "C" int hv_sta_permuted_codes(int dtype, int head_dim, const void* q,
                                     long long q_bs, long long q_rs,
                                     const void* k, long long k_bs,
                                     long long k_rs, int B, int H,
                                     int n_tiles, int n_ktiles, int block,
                                     void* q8, void* k8, float* sq,
                                     float* sk, void* stream) {
  if (block <= 0 || block % 64 != 0 || n_tiles <= 0 || n_ktiles <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return codes<__nv_bfloat16>(head_dim, q, q_bs, q_rs, k, k_bs, k_rs, B, H,
                                n_tiles, n_ktiles, block, q8, k8, sq, sk, st);
  if (dtype == 1)
    return codes<__half>(head_dim, q, q_bs, q_rs, k, k_bs, k_rs, B, H,
                         n_tiles, n_ktiles, block, q8, k8, sq, sk, st);
  return cudaErrorInvalidValue;
}

// B7 (running = 1), B6a/B6b (running = 0) and B6q (running = 0, quant =
// 1). dtype: 0 = bf16, 1 = fp16. q tile-major [B, S_pad rows], k/v the
// kcat/vcat keys [B, n_ktiles * tile tokens rows], o [B, S_pad rows], each
// row H*D wide (batch and row strides in elements); under quant q and k are
// hv_sta_permuted_codes' q8 and k8 and sq/sk its scales. kb [B, keys] fp32
// (batch stride kb_bs), nbr [n_tiles, n_slots] int32; c [B, H] fp32, the
// static offset (unused by the running arm, may be null there). Tile token
// count a multiple of 64, at most 1024 boxes a query tile (n_slots * tile
// tokens / R). Returns the cudaError_t of the launch.
extern "C" int hv_sta_permuted_fwd(
    int dtype, int running, int quant, int head_dim, const void* q,
    const void* k, const void* v, void* o, const float* kb, const float* c,
    const int* nbr, const float* sq, const float* sk, int B, int H,
    int n_slots, int n_ktiles, int T, int Hg, int Wg, int tt, int th, int tw,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs,
    long long kb_bs, float scale, void* stream) {
  const int block = tt * th * tw;
  const int rows = block % BM == 0 ? BM : 64;
  if (block <= 0 || block % 64 != 0 || kb == nullptr || nbr == nullptr ||
      (running != 0 && running != 1) || (quant != 0 && quant != 1) ||
      (running && quant) || (!running && c == nullptr) ||
      (quant && (sq == nullptr || sk == nullptr)) ||
      n_slots * (block / rows) > 32 * LIVE_WORDS)
    return cudaErrorInvalidValue;
  const Geo g{T, Hg, Wg, tt, th, tw, (Hg + th - 1) / th, (Wg + tw - 1) / tw,
              rows, block / rows, n_slots};
  const Args a{q, k, v, o, kb, c, nbr, sq, sk, B, H, n_ktiles, g, q_bs, q_rs,
               k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, kb_bs, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16>(head_dim, running, quant, a);
  if (dtype == 1) return dispatch_d<__half>(head_dim, running, quant, a);
  return cudaErrorInvalidValue;
}
