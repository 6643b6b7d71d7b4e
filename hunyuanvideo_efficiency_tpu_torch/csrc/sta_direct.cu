// Sliding-tile attention (STA) forward for the image queries of the MM-DiT
// joint [img | txt] sequence, queries read and written in the row-major
// token grid, for Hopper (sm_90a): wgmma products fed by a TMA ring.
//
// Replaces two kernels of the JAX package's ops/sta.py, as one source with
// template flags:
//   _sta_nomax_direct_kernel (:602), both of its arms:
//   QUANT = false (B4): the static per-(batch, head) exponent offset C,
//     p = exp(s*scale + bias - C), out = acc / max(l, 1e-37), Q.K^T in the
//     input type with fp32 accumulation;
//   QUANT = true (B4q, its quant=True arm, :648-663 and :693-707): the image
//     keys' scores s = s32(Q8.K8^T) * (sq * sk * scale), one symmetric scale
//     per (batch, head, tile) of q and of k, scale = max(max|x|, 1e-6) / 127
//     over the tile's tokens inside the grid, codes round(x * (1/scale))
//     with ties to even; the text keys' scores in the input type;
//   RING = true (B10, _sta_ring_kernel :950): B4's function with the image
//     keys and values read from kp/vp [B, S_pad, H*D], zero-padded in w-major
//     tile order (tile s = (c*nt + a)*nh + b, each tile's tokens in (t, h, w)
//     order), in the ring kernel's slot order: window column c, then run a,
//     then the wh tiles of the run from sb = clamp(qb - wh/2, 0, nh - wh),
//     those with |b - qb| > wh/2 skipped (for an odd window the tile set is
//     B4's). No neighbour table and no image key bias: a key's validity comes
//     from the geometry, as the TPU's col_bias.
// q/k/v are [B, T*Hg*Wg, H*D], the row-major tokens of a (T, Hg, Wg) patch
// grid cut into (tt, th, tw) tiles (row and batch strides are arguments; v
// may be a column view of a fused projection). A query of tile (a, b, c)
// attends the image keys of the tiles inside the (wt, wh, ww) window around
// it, then every text key of tk/tv [B, Lt, H*D] (bias tb [B, Lt]); kb
// [B, T*Hg*Wg] is an optional image key bias, C is [B, H] fp32. p is rounded
// to V's type before P.V; l and acc are fp32.
//
// Bound on the H100: 4*D operations per valid query-key pair on the tensor
// cores (989 TFLOP/s bf16; under QUANT the image keys' Q.K^T half at the
// int8 rate, 1,979 TOP/s). A query sees up to 27 tiles of 256 keys plus the
// text, far above the bytes of q/k/v/out, so the kernel is bound by
// operations. The design keeps the tensor cores fed as K1 does (K1 reaches
// 62% of its bound on the same pieces):
//   * The grid without a copy: a 5-D tensor map over q/k/v as (H*D columns,
//     Wg, Hg, T, B) reads R = min(128, tile tokens) rows of a tile (whole
//     (h, w) planes, or whole rows of one plane) as one box of (64 columns,
//     bw, bh, bt, 1). The box lands in shared memory as R rows of 128 bytes
//     with the 128-byte swizzle, the layout of a 2-D box, so K1's wgmma
//     descriptors read it unchanged. TMA zero-fills past the grid's edge.
//     RING: a key box is R contiguous rows of kp/vp, one box of a 3-D map
//     (H*D columns, S_pad rows, B), its rows in the same order.
//   * The block is K1's: three warpgroups own one query box (R = 128: two
//     consumer warpgroups of 64 rows; R = 64: both take the same rows and
//     the first stores them). Blocks are numbered box, query tile (w
//     innermost), head, batch, so the blocks in flight share keys in L2
//     (RING: the runs of a window column; the TPU's VMEM ring of ww + 1
//     columns does not fit in 227 KB, one head's column being 590 KB).
//   * Keys arrive in chunks of 128 (128 / R boxes) through a ring of 3
//     slots: the live boxes of the window's tiles in tile_plan's slot order
//     (RING: ring_plan's), a box whose first token lies past the grid
//     skipped, then the text keys as boxes of a 3-D map, up to the last one
//     not masked (masked keys add nothing). All threads count the live boxes
//     and find that key at the start, in parallel. Warp 0 of the producer
//     warpgroup walks the window by counters (no integer division: measured
//     on the card, a walk with divisions made the TMA lane the kernel's
//     bottleneck) ahead of each slot's release and issues TMA, writing each
//     chunk's boxes beside its slot; warp s + 1 writes slot s's per-key bias
//     from them (the key bias, the text bias, or -1e30 for a key past the
//     grid, less C, in log2 units; under QUANT beside each key's factor), as
//     B8's warps do (flash_int8.cu).
//   * The consumers run K1's loop (sta_wg.cuh): S = Q.K^T by wgmma (SS,
//     K-major; under QUANT the image chunks on s8 m64n128k32), the static
//     softmax, P packed to T and P.V by wgmma (RS, V MN-major); chunk j's S
//     is issued with chunk j-1's P.V, so the softmax runs under a product,
//     and the two warpgroups take turns to issue (B8's turns).
//   * Rows are stored one by one into the row-major grid, those past the
//     grid's edge skipped.
//   * B4q: a pre-pass (tile_codes_kernel) writes q's and k's int8 codes in
//     the row-major grid, each token with its own tile's scale, and the
//     scales; the kernel then loads int8 boxes through 5-D maps of the codes.
//     The bf16 Q box (32 KB at D = 128, for the text chunks), the Q8 box
//     (16 KB) and three slots of bf16 K + V (192 KB) would exceed 227 KB,
//     and two slots cost B4 a third of its speed (measured), so each slot
//     holds 128 keys of int8 K and their V (48 KB) and the text keys come in
//     chunks of 64: their bf16 K takes the same 16 KB, S is m64n64 and
//     P.V four k16 steps.
#include "sta_wg.cuh"

namespace {

using namespace hv::flash;

constexpr int CODES_THREADS = 256;

struct Geo {
  int T, Hg, Wg;   // token grid
  int tt, th, tw;  // tile
  int nt, nh, nw;  // tiles along t, h and w
  int wt, wh, ww;  // window in tiles
  int rows;        // R: tokens of a box, min(128, tile tokens)
  int bt, bh, bw;  // a box's frames, rows and columns
  int subs;        // boxes a tile
  int Lt;          // text keys
};

constexpr int KB = 2;  // the most key boxes a chunk (R = 64)

// The first token (t, h, w) of a box.
struct Box {
  int t, h, w;
};

__device__ __forceinline__ Box box_at(const Geo& g, int a, int b, int c,
                                      int sub) {
  const int f0 = sub * g.rows;
  return Box{a * g.tt + f0 / (g.th * g.tw), b * g.th + (f0 / g.tw) % g.th,
             c * g.tw};
}

// The live image key boxes of query tile (qa, qb, qc), in walk order: the
// window's tiles in tile_plan's slot order (da, then db, then dc), each
// tile's boxes in turn; a box whose first token lies past the grid holds no
// key and is skipped. Stepped by counters, without divisions: the TMA lane
// walks it as it goes, one chunk at a time.
struct Walk {
  int qa, qb, qc;
  int da = 0, db = 0, dc = 0;  // the window slot, offsets from its corner
  int sub = 0, dt = 0, dh = 0;  // the tile's next box and its first token

  // The next live box and its tile; false once the window is done.
  __device__ __forceinline__ bool next(const Geo& g, Box& box, int& tile) {
    for (; da < g.wt; ++da, db = 0) {
      const int a = qa + da - g.wt / 2;
      if (a < 0 || a >= g.nt) continue;
      for (; db < g.wh; ++db, dc = 0) {
        const int b = qb + db - g.wh / 2;
        if (b < 0 || b >= g.nh) continue;
        for (; dc < g.ww; ++dc, sub = dt = dh = 0) {
          const int c = qc + dc - g.ww / 2;
          if (c < 0 || c >= g.nw) continue;
          while (sub < g.subs) {
            box = Box{a * g.tt + dt, b * g.th + dh, c * g.tw};
            ++sub;
            dh += g.bh;
            if (dh >= g.th) dh = 0, dt += g.bt;
            if (box.t < g.T && box.h < g.Hg) {
              tile = (a * g.nh + b) * g.nw + c;
              return true;
            }
          }
        }
      }
    }
    return false;
  }
};

// B10's live image key boxes of query tile (qa, qb, qc), in ring_plan's
// slot order: window column dc, then run da, then tile r of the run from
// sb (those outside the h-window skipped), each tile's boxes in turn; a box
// whose first token lies past the grid holds no key and is skipped.
// Stepped by counters, without divisions, as Walk; `row` is the box's first
// row of the w-major kp/vp.
struct RingWalk {
  int qa, qb, qc, sb;
  int dc = 0, da = 0, r = 0;    // the window slot
  int sub = 0, dt = 0, dh = 0;  // the tile's next box and its first token

  // The next live box and its row; false once the window is done.
  __device__ __forceinline__ bool next(const Geo& g, Box& box, int& row) {
    for (; dc <= 2 * (g.ww / 2); ++dc, da = 0) {
      const int c = qc + dc - g.ww / 2;
      if (c < 0 || c >= g.nw) continue;
      for (; da < g.wt; ++da, r = 0) {
        const int a = qa + da - g.wt / 2;
        if (a < 0 || a >= g.nt) continue;
        for (; r < g.wh; ++r, sub = dt = dh = 0) {
          const int b = sb + r;
          if (b - qb > g.wh / 2 || qb - b > g.wh / 2) continue;
          while (sub < g.subs) {
            box = Box{a * g.tt + dt, b * g.th + dh, c * g.tw};
            row = (((c * g.nt + a) * g.nh + b) * g.subs + sub) * g.rows;
            ++sub;
            dh += g.bh;
            if (dh >= g.th) dh = 0, dt += g.bt;
            if (box.t < g.T && box.h < g.Hg) return true;
          }
        }
      }
    }
    return false;
  }
};

// Shared memory, byte offsets from a 1024-aligned base. A tile of R rows is
// D/64 TMA boxes of [R][64] T (128-byte rows, swizzled), one after another;
// int8 codes are [R][D] (one swizzled row a token). Q is laid out for 128
// rows whatever R is. Then the ring's slots (StaSlot: K, V, the per-key
// values) and beside each slot its chunk's boxes.
template <int D, bool QUANT>
struct Smem : StaSlot<D, QUANT> {
  using S = StaSlot<D, QUANT>;
  static constexpr int STAGES = S::STAGES;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int Q8_BYTES = QUANT ? BM * D : 0;
  static constexpr int Q = 0;
  static constexpr int Q8 = Q + Q_BYTES;
  static constexpr int K = Q8 + Q8_BYTES;               // [STAGES] K tiles
  static constexpr int V = K + STAGES * S::K_BYTES;     // [STAGES] V tiles
  static constexpr int W = V + STAGES * S::V_BYTES;     // [STAGES] biases
  static constexpr int BOX = W + STAGES * S::W_BYTES;   // [STAGES] int4[KB]
  // barriers: q, full[], empty[], boxed[] (a slot's boxes are written)
  static constexpr int BAR = BOX + STAGES * KB * 16;
  // per warp: live key boxes, last unmasked text key
  static constexpr int RED = BAR + (1 + 3 * STAGES) * 8;
  static constexpr int BYTES = RED + 2 * THREADS / 32 * 4;
  static constexpr int ALLOC = BYTES + 1024;            // base alignment
};

template <typename T, int D, bool QUANT, bool RING>
__global__ void __launch_bounds__(THREADS, 1)
sta_direct_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_tk,
                  const __grid_constant__ CUtensorMap tm_tv,
                  const __grid_constant__ CUtensorMap tm_q8,
                  const __grid_constant__ CUtensorMap tm_k8,
                  T* __restrict__ o, const float* __restrict__ kb,
                  const float* __restrict__ tb, const float* __restrict__ cb,
                  const float* __restrict__ sq_t,
                  const float* __restrict__ sk_t, Geo geo, int H,
                  long long o_bs, long long o_rs, float scale) {
  static_assert(!(QUANT && RING), "the ring arm has no int8 arm");
  using L = Smem<D, QUANT>;
  constexpr int STAGES = L::STAGES;
  const int n_tiles = geo.nt * geo.nh * geo.nw;
  const int qtile = blockIdx.x / geo.subs;
  const int qa = qtile / (geo.nh * geo.nw), qb = (qtile / geo.nw) % geo.nh,
            qc = qtile % geo.nw;
  const Box qbox = box_at(geo, qa, qb, qc, blockIdx.x % geo.subs);
  if (qbox.t >= geo.T || qbox.h >= geo.Hg) return;  // no query of the box
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  uint64_t* boxed = bars + 1 + 2 * STAGES;
  int4* box_s = reinterpret_cast<int4*>(sm + L::BOX);
  int* red_s = reinterpret_cast<int*>(sm + L::RED);

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
  // RING: the first tile row of the query tile's h-runs
  const int sb = min(max(qb - geo.wh / 2, 0), geo.nh - geo.wh);
  // All threads at once: the live key boxes of the window (a thread a
  // (window slot, box)), and the last text key not masked, so that the
  // chunks of masked text keys past it, which add nothing, are not walked.
  int n_live = 0, txt_last = -1;
  const int n_cols = RING ? 2 * (geo.ww / 2) + 1 : geo.ww;
  for (int i = threadIdx.x; i < geo.wt * geo.wh * n_cols * geo.subs;
       i += THREADS) {
    const int s = i / geo.subs;
    int a, bb, c;
    if (RING) {  // slot (column, run, tile of the run)
      c = qc + s / (geo.wt * geo.wh) - geo.ww / 2;
      a = qa + (s / geo.wh) % geo.wt - geo.wt / 2;
      bb = sb + s % geo.wh;
      if (abs(bb - qb) > geo.wh / 2) continue;
    } else {     // slot (frame, row, column) of tile_plan
      a = qa + s / (geo.wh * geo.ww) - geo.wt / 2;
      bb = qb + (s / geo.ww) % geo.wh - geo.wh / 2;
      c = qc + s % geo.ww - geo.ww / 2;
    }
    if (a < 0 || a >= geo.nt || bb < 0 || bb >= geo.nh || c < 0 ||
        c >= geo.nw)
      continue;
    const Box bx = box_at(geo, a, bb, c, i % geo.subs);
    n_live += bx.t < geo.T && bx.h < geo.Hg;
  }
  for (int j = threadIdx.x; j < geo.Lt; j += THREADS)
    if (tb == nullptr || tb[(long long)b * geo.Lt + j] > 0.5f * NEG_INF)
      txt_last = j;
  n_live = __reduce_add_sync(0xffffffffu, n_live);
  txt_last = __reduce_max_sync(0xffffffffu, txt_last);
  if ((threadIdx.x & 31) == 0) {
    red_s[threadIdx.x >> 5] = n_live;
    red_s[THREADS / 32 + (threadIdx.x >> 5)] = txt_last;
  }
  __syncthreads();
  n_live = 0;
  txt_last = -1;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    n_live += red_s[w];
    txt_last = max(txt_last, red_s[THREADS / 32 + w]);
  }
  const int kbc = BN / geo.rows;  // key boxes a chunk
  const int n_img = (n_live + kbc - 1) / kbc;
  const int n_chunks = n_img + (txt_last + L::TXT) / L::TXT;

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    // setmaxnreg moves registers within the block's own 168 a thread:
    // 128 x 40 + 256 x 232 is all of them
    reg_dealloc<40>();
    const int pw = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (pw == 0) {
      if (lane == 0) {
        // warp 0, one lane: the TMA loads, Q once, then K/V chunk by chunk
        const uint32_t qbar = smem_u32(q_full);
        mbar_arrive_expect_tx(qbar, geo.rows * D * (QUANT ? 3 : 2));
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_5d(smem_u32(sm + L::Q + c * BM * 128), &tm_q, qbar,
                      h * D + 64 * c, qbox.w, qbox.h, qbox.t, b);
        if (QUANT)
          tma_load_5d(smem_u32(sm + L::Q8), &tm_q8, qbar, h * D, qbox.w,
                      qbox.h, qbox.t, b);
        // the window's walk (RING: a box's `tile` is its kp/vp row)
        std::conditional_t<RING, RingWalk, Walk> w{qa, qb, qc};
        if constexpr (RING) w.sb = sb;
        for (int it = 0; it < n_chunks; ++it) {
          const int s = it % STAGES;
          // the chunk's boxes (tile -1: a repeated box, masked), walked
          // while its slot may still be in use
          int4 b0 = make_int4(0, 0, 0, -1), b1 = b0;
          if (it < n_img) {
            Box bx;
            int tile;
            w.next(geo, bx, tile);  // a chunk's first box is always live
            b0 = make_int4(bx.t, bx.h, bx.w, tile);
            // a chunk short of boxes loads its first again, masked
            b1 = kbc == 2 && w.next(geo, bx, tile)
                     ? make_int4(bx.t, bx.h, bx.w, tile)
                     : make_int4(b0.x, b0.y, b0.z, -1);
          }
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          const uint32_t kdst = smem_u32(sm + L::K + s * L::K_BYTES);
          const uint32_t vdst = smem_u32(sm + L::V + s * L::V_BYTES);
          const uint32_t bar = smem_u32(&full[s]);
          if (it < n_img) {
            // the boxes for the bias warp, then their loads
            box_s[KB * s] = b0;
            box_s[KB * s + 1] = b1;
            mbar_arrive(&boxed[s]);
            mbar_arrive_expect_tx(bar, BN * D * (QUANT ? 3 : 4));
            for (int u = 0; u < kbc; ++u) {
              const int4 bq = box_s[KB * s + u];
              if constexpr (RING) {
                // a repeated box reads the chunk's first box's rows again
                const int row = bq.w >= 0 ? bq.w : box_s[KB * s].w;
#pragma unroll
                for (int c = 0; c < D / 64; ++c) {
                  const uint32_t off = c * BN * 128 + u * geo.rows * 128;
                  tma_load_3d(kdst + off, &tm_k, bar, h * D + 64 * c, row, b);
                  tma_load_3d(vdst + off, &tm_v, bar, h * D + 64 * c, row, b);
                }
              } else {
                if (QUANT)
                  tma_load_5d(kdst + u * geo.rows * D, &tm_k8, bar, h * D,
                              bq.z, bq.y, bq.x, b);
#pragma unroll
                for (int c = 0; c < D / 64; ++c) {
                  const uint32_t off = c * BN * 128 + u * geo.rows * 128;
                  if (!QUANT)
                    tma_load_5d(kdst + off, &tm_k, bar, h * D + 64 * c, bq.z,
                                bq.y, bq.x, b);
                  tma_load_5d(vdst + off, &tm_v, bar, h * D + 64 * c, bq.z,
                              bq.y, bq.x, b);
                }
              }
            }
          } else {
            const int j0 = (it - n_img) * L::TXT;
            mbar_arrive(&boxed[s]);
            mbar_arrive_expect_tx(bar, L::TXT * D * 4);
#pragma unroll
            for (int c = 0; c < D / 64; ++c) {
              tma_load_3d(kdst + c * L::TXT * 128, &tm_tk, bar,
                          h * D + 64 * c, j0, b);
              tma_load_3d(vdst + c * L::TXT * 128, &tm_tv, bar,
                          h * D + 64 * c, j0, b);
            }
          }
        }
      }
    } else if (pw <= STAGES) {
      // warp s + 1: the per-key bias of every chunk of ring slot s (chunks
      // s, s + STAGES, ...), from the boxes the TMA lane writes beside the
      // slot. This lane's keys of a chunk are lane + 32 * i, kp[i] packing
      // the key's box in the chunk (bits 24 on) and its frame, row and
      // column in the box (bits 16, 8 and 0).
      const int s = pw - 1;
      const float c_off = cb[bh];
      const float sl2 = scale * LOG2E;
      const float fq = QUANT ? sq_t[bh * n_tiles + qtile] * sl2 : 0.f;
      const float* skb = QUANT ? sk_t + bh * n_tiles : nullptr;
      const float* kbb =
          kb ? kb + (long long)b * geo.T * geo.Hg * geo.Wg : nullptr;
      const float* tbb = tb ? tb + (long long)b * geo.Lt : nullptr;
      int kp[BN / 32];
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int key = lane + 32 * i, r = key % geo.rows;
        kp[i] = (key / geo.rows) << 24 | (r / (geo.bh * geo.bw)) << 16 |
                ((r / geo.bw) % geo.bh) << 8 | (r % geo.bw);
      }
      float* ws = reinterpret_cast<float*>(sm + L::W + s * L::W_BYTES);
      for (int it = s, use = 0; it < n_chunks; it += STAGES, ++use) {
        mbar_wait(&boxed[s], use & 1);
        const bool img = it < n_img;
#pragma unroll
        for (int i = 0; i < BN / 32; ++i) {
          const int key = lane + 32 * i;
          float x, f;
          if (img) {
            // unpacked here: hoisted out of the loop, the twelve offsets
            // would not fit the producer's 40 registers
            int k = kp[i];
            asm volatile("" : "+r"(k));
            const int4 bq = box_s[KB * s + (k >> 24)];
            const int t = bq.x + ((k >> 16) & 255);
            const int hh = bq.y + ((k >> 8) & 255);
            const int ww = bq.z + (k & 255);
            const bool ok = bq.w >= 0 && t < geo.T && hh < geo.Hg &&
                            ww < geo.Wg;
            x = ok ? (kbb ? kbb[((long long)t * geo.Hg + hh) * geo.Wg + ww]
                          : 0.f)
                   : NEG_INF;
            // QUANT: sq * sk * scale in log2 units
            f = QUANT && bq.w >= 0 ? fq * skb[bq.w] : 0.f;
          } else {
            const int j = (it - n_img) * L::TXT + key;
            if (key >= L::TXT) break;  // past a 64-key text chunk
            x = j < geo.Lt ? (tbb ? tbb[j] : 0.f) : NEG_INF;
            f = sl2;
          }
          const float bias = (x - c_off) * LOG2E;
          if (QUANT) {
            float* p = ws + (key >> 1) * 4 + (key & 1);
            p[0] = f;
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
    const uint32_t q_addr = smem_u32(sm + L::Q) + row0 * 128;
    const uint32_t q8_addr = smem_u32(sm + L::Q8) + row0 * D;
    const Consumer<T, D, QUANT> cs{full, empty, q_addr, q8_addr,
                                   smem_u32(sm + L::K), smem_u32(sm + L::V),
                                   reinterpret_cast<const float*>(sm + L::W),
                                   scale * LOG2E, t, lane, wgc};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_r[2];               // unused: the static softmax keeps no max
    float l_r[2] = {0.f, 0.f};  // this thread's part of the row sums
    uint32_t pa[BN / 16][4];    // P of the previous chunk, T in A layout

    if (wgc == 1) turn_pass(wgc);  // the first warpgroup issues first
    mbar_wait(q_full, 0);
    // chunk 0 (image keys of the query's own tile) is peeled off, so that
    // every wait in the loops is unconditional
    constexpr Kind IMG = QUANT ? Kind::s8 : Kind::bf16;
    cs.template step<IMG, IMG, true>(0, acc, m_r, l_r, pa);
    if constexpr (QUANT) {
      for (int it = 1; it < n_img; ++it)
        cs.template step<Kind::s8, Kind::s8>(it, acc, m_r, l_r, pa);
      if (n_img < n_chunks) {
        cs.template step<Kind::txt64, Kind::s8>(n_img, acc, m_r, l_r, pa);
        for (int it = n_img + 1; it < n_chunks; ++it)
          cs.template step<Kind::txt64, Kind::txt64>(it, acc, m_r, l_r, pa);
        cs.template last<Kind::txt64>(n_chunks - 1, acc, pa);
      } else {
        cs.template last<Kind::s8>(n_chunks - 1, acc, pa);
      }
    } else {
      for (int it = 1; it < n_chunks; ++it)
        cs.template step<Kind::bf16, Kind::bf16>(it, acc, m_r, l_r, pa);
      cs.template last<Kind::bf16>(n_chunks - 1, acc, pa);
    }

    // epilogue: rows r and r + 8 of the box; R = 64 leaves the store to the
    // first warpgroup
    const float l[2] = {quad_sum(l_r[0]), quad_sum(l_r[1])};
    if (geo.rows == BM || wgc == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + warp * 16 + g + 8 * i;
        const int tt = qbox.t + r / (geo.bh * geo.bw);
        const int hh = qbox.h + (r / geo.bw) % geo.bh;
        const int ww = qbox.w + r % geo.bw;
        if (tt >= geo.T || hh >= geo.Hg || ww >= geo.Wg) continue;
        const float inv = 1.f / fmaxf(l[i], 1e-37f);
        T* orow = o + b * o_bs +
                  (((long long)tt * geo.Hg + hh) * geo.Wg + ww) * o_rs +
                  (long long)h * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
              hv::pack2(acc[4 * j + 2 * i] * inv,
                        acc[4 * j + 2 * i + 1] * inv, T());
      }
    }
  }
}

// B4q's pre-pass: one block a (tile, head, batch) of q (blocks [0, n_tiles))
// or of k (the rest): the absmax over the tile's tokens inside the grid, the
// scale max(m, 1e-6) / 127 to scales [B, H, n_tiles], then every token's
// codes round(x * (1/scale)) to codes [B, T*Hg*Wg, H*D] int8 at its own row.
template <typename T, int D>
__global__ void __launch_bounds__(CODES_THREADS)
tile_codes_kernel(const T* __restrict__ q, long long q_bs, long long q_rs,
                  const T* __restrict__ k, long long k_bs, long long k_rs,
                  Geo geo, int H, int8_t* __restrict__ q8,
                  int8_t* __restrict__ k8, float* __restrict__ sq,
                  float* __restrict__ sk) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  const int n_tiles = geo.nt * geo.nh * geo.nw;
  const bool is_q = (int)blockIdx.x < n_tiles;
  const int tile = is_q ? blockIdx.x : blockIdx.x - n_tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* x = (is_q ? q + b * q_bs : k + b * k_bs) + (long long)h * D;
  const long long rs = is_q ? q_rs : k_rs;
  const int a = tile / (geo.nh * geo.nw), bb = (tile / geo.nw) % geo.nh,
            cc = tile % geo.nw;
  const int block = geo.tt * geo.th * geo.tw;
  // the row-major token of flat position f of the tile, or -1 past the grid
  auto token = [&](int f) -> long long {
    const int t = a * geo.tt + f / (geo.th * geo.tw);
    const int hh = bb * geo.th + (f / geo.tw) % geo.th;
    const int w = cc * geo.tw + f % geo.tw;
    if (t >= geo.T || hh >= geo.Hg || w >= geo.Wg) return -1;
    return ((long long)t * geo.Hg + hh) * geo.Wg + w;
  };
  float m = 0.f;
  for (int i = threadIdx.x; i < block * CH; i += CODES_THREADS) {
    const long long tok = token(i / CH);
    if (tok >= 0)
      m = hv::absmax8<T>(
          *reinterpret_cast<const uint4*>(x + tok * rs + (i % CH) * 8), m);
  }
  m = hv::block_max(m);
  const float scale = fmaxf(m, 1e-6f) / 127.f;
  if (threadIdx.x == 0)
    (is_q ? sq : sk)[((long long)b * H + h) * n_tiles + tile] = scale;
  const float inv = 1.f / scale;
  const long long crs = (long long)H * D;
  int8_t* codes = (is_q ? q8 : k8) +
                  (long long)b * geo.T * geo.Hg * geo.Wg * crs +
                  (long long)h * D;
  for (int i = threadIdx.x; i < block * CH; i += CODES_THREADS) {
    const long long tok = token(i / CH);
    const int c = (i % CH) * 8;
    if (tok >= 0)
      *reinterpret_cast<uint2*>(codes + tok * crs + c) = hv::quant8_s8<T>(
          *reinterpret_cast<const uint4*>(x + tok * rs + c), inv);
  }
}

// The geometry of a launch, false outside the kernel's gate: tile tokens a
// multiple of 64, R = min(128, tokens) dividing them, and an R-token query
// box of whole (h, w) planes (th*tw divides R) or of whole rows of one plane
// (R divides th*tw, tw divides R); odd windows, or under `ring` (B10) any
// window with at least wh tile rows and ww >= 2. ops/sta.py:plan_sta_direct
// and plan_sta_ring describe the same on the host.
bool make_geo(Geo& g, int T, int Hg, int Wg, int tt, int th, int tw, int wt,
              int wh, int ww, int Lt, bool ring = false) {
  const int block = tt * th * tw, plane = th * tw;
  const int rows = block < BM ? block : BM;
  if (block <= 0 || block % 64 != 0 || block % rows != 0) return false;
  if (wt < 1 || wh < 1 || ww < 1 || Lt < 0) return false;
  if (ring ? (Hg + th - 1) / th < wh || ww < 2
           : wt % 2 == 0 || wh % 2 == 0 || ww % 2 == 0)
    return false;
  g = Geo{T, Hg, Wg, tt, th, tw, (T + tt - 1) / tt, (Hg + th - 1) / th,
          (Wg + tw - 1) / tw, wt, wh, ww, rows, 1, th, tw, block / rows, Lt};
  if (rows % plane == 0) {
    g.bt = rows / plane;
  } else if (plane % rows == 0 && rows % tw == 0) {
    g.bh = rows / tw;
  } else {
    return false;
  }
  return true;
}

// A 5-D map over a grid operand [B, T, Hg, Wg, cols] of `esize`-byte
// elements (row and batch strides in elements) with boxes of `box_cols`
// columns x (bw, bh, bt) tokens: rows of one box are R contiguous rows of
// `box_cols * esize` bytes in shared memory. Tokens past the grid read as
// zero.
bool encode_grid(CUtensorMap* map, CUtensorMapDataType dt,
                 CUtensorMapSwizzle swizzle, const void* base, int esize,
                 int cols, int B, long long rs, long long bs, const Geo& g,
                 int box_cols) {
  if (B == 1) bs = rs * g.T * g.Hg * g.Wg;  // unused, but valid
  const cuuint64_t dims[5] = {(cuuint64_t)cols, (cuuint64_t)g.Wg,
                              (cuuint64_t)g.Hg, (cuuint64_t)g.T,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {
      (cuuint64_t)(rs * esize), (cuuint64_t)(rs * g.Wg * esize),
      (cuuint64_t)(rs * g.Wg * g.Hg * esize), (cuuint64_t)(bs * esize)};
  const cuuint32_t box[5] = {(cuuint32_t)box_cols, (cuuint32_t)g.bw,
                             (cuuint32_t)g.bh, (cuuint32_t)g.bt, 1};
  return encode_map(map, dt, swizzle, base, 5, dims, strides, box);
}

struct Args {
  const void *q, *k, *v;
  void* o;
  const void *tk, *tv;
  const float *kb, *tb, *c;
  const void *q8, *k8;
  const float *sq, *sk;
  int B, H;
  Geo geo;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, tk_bs, tk_rs, tv_bs, tv_rs,
      o_bs, o_rs;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool QUANT, bool RING>
cudaError_t launch(const Args& a) {
  const Geo& g = a.geo;
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const int cols = a.H * D;
  // without text keys the text maps are never read: encode them over q
  const bool txt = g.Lt > 0;
  CUtensorMap tq, tk, tv, ttk, ttv, tq8, tk8;
  // RING: kp/vp [B, S_pad, H*D] in w-major tile order, boxes of R rows
  const int s_pad = g.nt * g.tt * g.nh * g.th * g.nw * g.tw;
  if (!encode_grid(&tq, dt, sw, a.q, 2, cols, a.B, a.q_rs, a.q_bs, g, 64) ||
      !(RING ? encode_rows<T>(&tk, a.k, cols, s_pad, a.B, a.k_rs, a.k_bs,
                              g.rows)
             : encode_grid(&tk, dt, sw, a.k, 2, cols, a.B, a.k_rs, a.k_bs, g,
                           64)) ||
      !(RING ? encode_rows<T>(&tv, a.v, cols, s_pad, a.B, a.v_rs, a.v_bs,
                              g.rows)
             : encode_grid(&tv, dt, sw, a.v, 2, cols, a.B, a.v_rs, a.v_bs, g,
                           64)) ||
      !encode_rows<T>(&ttk, txt ? a.tk : a.q, cols, txt ? g.Lt : 1, a.B,
                      txt ? a.tk_rs : a.q_rs, txt ? a.tk_bs : a.q_bs,
                      Smem<D, QUANT>::TXT) ||
      !encode_rows<T>(&ttv, txt ? a.tv : a.q, cols, txt ? g.Lt : 1, a.B,
                      txt ? a.tv_rs : a.q_rs, txt ? a.tv_bs : a.q_bs,
                      Smem<D, QUANT>::TXT))
    return cudaErrorInvalidValue;
  tq8 = tq;
  tk8 = tk;
  if (QUANT) {
    // the pre-pass's codes: contiguous [B, T*Hg*Wg, H*D] int8
    const long long crs = cols, cbs = crs * g.T * g.Hg * g.Wg;
    const auto sw8 = D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B;
    if (!encode_grid(&tq8, CU_TENSOR_MAP_DATA_TYPE_UINT8, sw8, a.q8, 1, cols,
                     a.B, crs, cbs, g, D) ||
        !encode_grid(&tk8, CU_TENSOR_MAP_DATA_TYPE_UINT8, sw8, a.k8, 1, cols,
                     a.B, crs, cbs, g, D))
      return cudaErrorInvalidValue;
  }
  auto kern = sta_direct_kernel<T, D, QUANT, RING>;
  const int smem = Smem<D, QUANT>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(g.nt * g.nh * g.nw * g.subs, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      tq, tk, tv, ttk, ttv, tq8, tk8, static_cast<T*>(a.o), a.kb, a.tb, a.c,
      a.sq, a.sk, g, a.H, a.o_bs, a.o_rs, a.scale);
  return cudaGetLastError();
}

template <typename T, bool QUANT, bool RING = false>
cudaError_t dispatch_d(int head_dim, const Args& a) {
  if (head_dim == 128) return launch<T, 128, QUANT, RING>(a);
  if (head_dim == 64) return launch<T, 64, QUANT, RING>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t codes(int head_dim, const void* q, long long q_bs, long long q_rs,
                  const void* k, long long k_bs, long long k_rs, int B,
                  int H, const Geo& g, void* q8, void* k8, float* sq,
                  float* sk, cudaStream_t stream) {
  const dim3 grid(2 * g.nt * g.nh * g.nw, H, B);
  auto run = [&](auto kern) {
    kern<<<grid, CODES_THREADS, 0, stream>>>(
        static_cast<const T*>(q), q_bs, q_rs, static_cast<const T*>(k), k_bs,
        k_rs, g, H, static_cast<int8_t*>(q8), static_cast<int8_t*>(k8), sq,
        sk);
    return cudaGetLastError();
  };
  if (head_dim == 128) return run(tile_codes_kernel<T, 128>);
  if (head_dim == 64) return run(tile_codes_kernel<T, 64>);
  return cudaErrorInvalidValue;
}

}  // namespace

// B4q's pre-pass: q and k [B, T*Hg*Wg, H*D] (row and batch strides in
// elements; dtype 0 = bf16, 1 = fp16) to int8 codes q8, k8 [B, T*Hg*Wg,
// H*D] (contiguous) with one scale per (b, h, tile), sq and sk [B, H,
// n_tiles] fp32. Returns the cudaError_t of the launch.
extern "C" int hv_sta_tile_codes(int dtype, int head_dim, const void* q,
                                 long long q_bs, long long q_rs,
                                 const void* k, long long k_bs,
                                 long long k_rs, int B, int H, int T, int Hg,
                                 int Wg, int tt, int th, int tw, void* q8,
                                 void* k8, float* sq, float* sk,
                                 void* stream) {
  Geo g;
  if (!make_geo(g, T, Hg, Wg, tt, th, tw, 1, 1, 1, 0))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return codes<__nv_bfloat16>(head_dim, q, q_bs, q_rs, k, k_bs, k_rs, B, H,
                                g, q8, k8, sq, sk, st);
  if (dtype == 1)
    return codes<__half>(head_dim, q, q_bs, q_rs, k, k_bs, k_rs, B, H, g, q8,
                         k8, sq, sk, st);
  return cudaErrorInvalidValue;
}

// B4 (quant = 0) and B4q (quant = 1). q/k/v [B, T*Hg*Wg rows] row-major
// over the grid, tk/tv [B, Lt rows], o [B, T*Hg*Wg rows], each row H*D wide
// (batch and row strides in elements; dtype 0 = bf16, 1 = fp16); kb
// [B, T*Hg*Wg] and tb [B, Lt] fp32 may be null, c [B, H] fp32. Under quant,
// q8/k8, sq/sk are hv_sta_tile_codes' outputs. Returns the cudaError_t of
// the launch.
extern "C" int hv_sta_direct_fwd(
    int dtype, int quant, int head_dim, const void* q, const void* k,
    const void* v, void* o, const void* tk, const void* tv, const float* kb,
    const float* tb, const float* c, const void* q8, const void* k8,
    const float* sq, const float* sk, int B, int H, int Lt, int T, int Hg,
    int Wg, int tt, int th, int tw, int wt, int wh, int ww, long long q_bs,
    long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, long long tk_bs, long long tk_rs, long long tv_bs,
    long long tv_rs, long long o_bs, long long o_rs, float scale,
    void* stream) {
  Geo g;
  if (!make_geo(g, T, Hg, Wg, tt, th, tw, wt, wh, ww, Lt) || c == nullptr ||
      (quant && (q8 == nullptr || k8 == nullptr || sq == nullptr ||
                 sk == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, tk, tv, kb, tb, c, q8, k8, sq, sk, B, H, g,
               q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, tk_bs, tk_rs, tv_bs,
               tv_rs, o_bs, o_rs, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return quant ? dispatch_d<__nv_bfloat16, true>(head_dim, a)
                 : dispatch_d<__nv_bfloat16, false>(head_dim, a);
  if (dtype == 1)
    return quant ? dispatch_d<__half, true>(head_dim, a)
                 : dispatch_d<__half, false>(head_dim, a);
  return cudaErrorInvalidValue;
}

// B10, the ring arm. dtype: 0 = bf16, 1 = fp16. q [B, T*Hg*Wg rows]
// row-major over the grid, kp/vp [B, S_pad rows] in w-major tile order
// (zero on padding tokens), o [B, T*Hg*Wg rows], tk/tv [B, Lt rows], each
// row H*D wide with the given batch and row strides (in elements); tb
// [B, Lt] fp32 may be null, c [B, H] fp32. The ring gate: at least wh tile
// rows and ww >= 2, and B4's tile gate. Returns the cudaError_t of the
// launch.
extern "C" int hv_sta_ring_fwd(
    int dtype, int head_dim, const void* q, const void* kp, const void* vp,
    void* o, const void* tk, const void* tv, const float* tb, const float* c,
    int B, int H, int Lt, int T, int Hg, int Wg, int tt, int th, int tw,
    int wt, int wh, int ww, long long q_bs, long long q_rs, long long k_bs,
    long long k_rs, long long v_bs, long long v_rs, long long tk_bs,
    long long tk_rs, long long tv_bs, long long tv_rs, long long o_bs,
    long long o_rs, float scale, void* stream) {
  Geo g;
  if (!make_geo(g, T, Hg, Wg, tt, th, tw, wt, wh, ww, Lt, true) ||
      c == nullptr)
    return cudaErrorInvalidValue;
  const Args a{q, kp, vp, o, tk, tv, nullptr, tb, c, nullptr, nullptr,
               nullptr, nullptr, B, H, g, q_bs, q_rs, k_bs, k_rs, v_bs,
               v_rs, tk_bs, tk_rs, tv_bs, tv_rs, o_bs, o_rs, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16, false, true>(head_dim, a);
  if (dtype == 1) return dispatch_d<__half, false, true>(head_dim, a);
  return cudaErrorInvalidValue;
}
