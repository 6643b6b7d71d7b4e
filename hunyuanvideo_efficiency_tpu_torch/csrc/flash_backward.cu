// Flash attention backward for training, for Hopper (sm_90a): the two
// kernels that recompute the probabilities from the row log-sum-exp lse that
// the training forward wrote (flash_attention.cu, LSE = true, the port of
// _fwd_kernel), on wgmma products fed by a TMA ring.
//
// Replaces two Pallas TPU kernels of the JAX package
// (ops/flash_backward.py):
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel (:138): per query tile, over key
//       tiles: P = exp(S*scale + kb - lse), dP = dO.V^T,
//       dS = P*(dP - delta), dQ = scale * sum dS.K;
//   flash_bwd_dkv_kernel  <- _bwd_dkv_kernel (:165): the transposed form per
//       key tile, over query tiles: P^T = exp(K.Q^T*scale + kb - lse),
//       dV = sum P^T.dO, dP^T = V.dO^T, dS^T = P^T*(dP^T - delta),
//       dK = scale * sum dS^T.Q.
// delta = rowsum(dO * O) is computed outside (fp32), as in the JAX package.
//
// Layout: q/k/v are [B, S, H*D] with each head a column slice (row and
// batch strides are arguments; v may be a column view of a fused
// projection); dO, dQ, dK and dV are contiguous [B, S, H*D]; lse and delta
// are [B, H, Sq] fp32; the key bias kb is [B, Sk] fp32 (entries <= 0) or
// null.
//
// Numerics kept from the TPU kernels: every product in the input type with
// fp32 accumulation; P rounded to the input type before P^T.dO; dS rounded
// before dS.K and dS^T.Q; fp32 P and dS; `scale` applied to dQ and dK at the
// end. The exponentials are exp2 with log2(e) folded into the scale, the
// bias and lse. Each output element has one writer (no atomics), so results
// are the same from run to run.
//
// Bound on the H100: 6 (dQ) and 8 (dK/dV) times B*H*Sq*Sk*D tensor-core
// operations (S and dP recomputed in both), far above the bytes moved at the
// main path's lengths, so both are bound by operations (989 TFLOP/s bf16
// dense).
//
// Design. Against what held the first, mma.sync design at under a fifth
// of this bound (32-bit fragment loads from padded tiles, copies staged
// between two __syncthreads with no overlap, 64-row blocks of 4 warps),
// both kernels take the forward's block (flash_attention.cu): warpgroup 0
// is the producer (its registers handed to the consumers with setmaxnreg),
// warpgroups 1 and 2 consume 64 rows each of the ROWS = 128 rows the block
// owns; those rows' two operands arrive once by TMA, and the other side
// walks through a ring of RING slots of TILE = 64 rows, its copy running
// under the previous tile's math. All products are wgmma:
//   dK/dV (a block owns 128 keys; K and V once, Q and dO through the ring):
//     S^T = K.Q^T and dP^T = V.dO^T (SS, both K-major, m64n64), then
//     dV += P^T.dO and dK += dS^T.Q (RS: P^T and dS^T packed from the
//     accumulators to the input type; dO and Q read MN-major through the
//     descriptor's transpose bit, never transposed). P^T is computed while
//     dP^T's product runs, dS^T while dV's does. Four fp32 accumulators a
//     thread: 32 + 32 + D/2 + D/2 (issuing the next tile's S^T and dP^T
//     under this tile's dV and dK ran 27% slower on the H100 and was
//     dropped).
//   dQ (a block owns 128 queries; Q and dO once, K and V through the ring):
//     S = Q.K^T and dP = dO.V^T (SS), dQ += dS.K (RS, K MN-major). Tile j's
//     S and dP are issued together with tile j-1's dS.K, so that the
//     elementwise work of one tile runs under the products of the next (the
//     first tile peeled off, so that every wait in the loop is
//     unconditional and ptxas keeps the products asynchronous).
// In both, the two consumer warpgroups take turns to issue their score
// products (turn_wait / turn_pass, as B8), so that one's exponentials run
// under the other's products: 12% off dQ's time, 7% off dK/dV's (H100).
// Per-row scalars: producer warp 0 only issues TMA; warp 1 writes each
// slot's per-tile scalars (dQ: the key bias; dK/dV: lse and delta of the
// query rows), loaded one turn ahead (as flash_int8.cu's producer: one that
// writes per-key data serially holds the products back). Ragged edges:
// TMA reads rows past Sq or Sk as zero; keys past Sk get the bias -1e30 and
// query rows past Sq an lse of +1e30, so their P is exactly 0 and every
// term they add is exactly 0; rows past the edge are not stored. A masked
// key (bias -1e30) gets P = 0 exactly, so its dK and dV are exactly 0.
#include "flash_wg.cuh"

namespace {

using namespace hv::flash;

constexpr int ROWS = 128;  // rows a block owns: two consumer warpgroups
constexpr int TILE = 64;   // rows of the other operand a ring slot holds
constexpr int RING = 3;    // ring slots
constexpr float LSE_PAD = 1e30f;  // lse of a query row past Sq: P = 0

// acc = A.B^T over D for 64 rows: A K-major at a_addr (D/64 boxes of a_rows
// rows), B TILE rows K-major at b_addr (D/64 boxes of TILE rows); D/16 k16
// steps, the first overwriting acc. One commit group.
template <typename T, int D>
__device__ __forceinline__ void issue_scores(float (&acc)[32],
                                             uint32_t a_addr, int a_rows,
                                             uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t aoff = (kk >> 2) * (a_rows * 128) + (kk & 3) * 32;
    const uint32_t boff = (kk >> 2) * (TILE * 128) + (kk & 3) * 32;
    wgmma_m64n64k16_ss(acc, desc_sw128(a_addr + aoff, 16, 1024),
                       desc_sw128(b_addr + boff, 16, 1024), kk > 0, T());
  }
  wgmma_commit();
}

// acc += A.B: A from registers (the TILE/16 k16 steps over B's rows), B
// TILE rows MN-major at b_addr (D/64 boxes of [TILE][64]; 16 rows = 2048
// bytes a k16 step). One commit group.
template <typename T, int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2],
                                          const uint32_t (&a)[TILE / 16][4],
                                          uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
    wgmma_rs_tb<D, T>(acc, a[kk],
                      desc_sw128(b_addr + kk * 2048, TILE * 128, 1024));
  wgmma_commit();
}

// An m64n64 accumulator rounded to T, packed into the A fragments of the
// k16 steps over its 64 columns (as pack_p).
template <typename T>
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[TILE / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = hv::pack2(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], T());
}

// Keeps packed A registers live until the product that reads them is done.
__device__ __forceinline__ void fence_a(uint32_t (&a)[TILE / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i]) :: "memory");
}

// Rows r0 and r0 + 8 (those below S) of an m64nD accumulator times `mul`,
// as T, into one head's slice of a contiguous [B, S, H*D] output; `out`
// points at the head's column 0 of row 0 of this batch.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* out, int H, int S, int r0,
                                          int t, const float (&acc)[D / 2],
                                          float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= S) continue;
    T* row = out + (long long)r * H * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) = hv::pack2(
          acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul, T());
  }
}

// Shared memory, byte offsets from a 1024-aligned base: the block's two
// operands ([ROWS][D] each, D/64 TMA boxes of [ROWS][64]), the ring's two
// operands ([RING] x [TILE][D] each), then per slot SCAL floats of per-tile
// scalars and the barriers (once, full[RING], empty[RING]).
template <int D, int SCAL>
struct Smem {
  static constexpr int OWN_BYTES = ROWS * D * 2;
  static constexpr int TILE_BYTES = TILE * D * 2;
  static constexpr int A = 0;                           // K (dkv), Q (dq)
  static constexpr int B = A + OWN_BYTES;               // V (dkv), dO (dq)
  static constexpr int RA = B + OWN_BYTES;              // [RING] Q or K
  static constexpr int RB = RA + RING * TILE_BYTES;     // [RING] dO or V
  static constexpr int SC = RB + RING * TILE_BYTES;     // [RING][SCAL] fp32
  static constexpr int BAR = SC + RING * SCAL * 4;
  static constexpr int BYTES = BAR + (1 + 2 * RING) * 8;
  static constexpr int ALLOC = BYTES + 1024;            // base alignment
};

struct Args {
  const float* kb;     // [B, Sk] or null
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* dq;            // [B, Sq, H*D]
  void* dk;            // [B, Sk, H*D]
  void* dv;            // [B, Sk, H*D]
  int H, Sq, Sk;
  float scale;
};

// The producer warp 0's TMA loads: the block's two operands once (rows
// own0.. of maps oa and ob), then per ring turn TILE rows of maps ra and rb
// (n_it tiles from row 0), each slot when its consumers have freed it.
template <int D, int SCAL>
__device__ __forceinline__ void produce_tiles(
    uint8_t* sm, const CUtensorMap* oa, const CUtensorMap* ob,
    const CUtensorMap* ra, const CUtensorMap* rb, uint64_t* once,
    uint64_t* full, uint64_t* empty, int h, int b, int own0, int n_it) {
  using L = Smem<D, SCAL>;
  mbar_arrive_expect_tx(once, 2 * L::OWN_BYTES);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    tma_load_3d(sm + L::A + c * ROWS * 128, oa, once, h * D + 64 * c, own0,
                b);
    tma_load_3d(sm + L::B + c * ROWS * 128, ob, once, h * D + 64 * c, own0,
                b);
  }
  for (int it = 0; it < n_it; ++it) {
    const int s = it % RING;
    mbar_wait(&empty[s], ((it / RING) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[s], 2 * L::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm + L::RA + s * L::TILE_BYTES + c * TILE * 128, ra,
                  &full[s], h * D + 64 * c, it * TILE, b);
      tma_load_3d(sm + L::RB + s * L::TILE_BYTES + c * TILE * 128, rb,
                  &full[s], h * D + 64 * c, it * TILE, b);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, Args a) {
  using L = Smem<D, TILE>;  // per slot: the key bias, log2 units
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* bias_s = reinterpret_cast<float*>(sm + L::SC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* once = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + RING;

  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int H = a.H, Sq = a.Sq, Sk = a.Sk;
  const int n_it = (Sk + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 33);               // TMA's expect_tx + warp 1
      mbar_init(&empty[s], CONSUMER_WARPS);  // one lane of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    reg_dealloc<40>();
    const int pw = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (pw == 0 && lane == 0) {
      produce_tiles<D, TILE>(sm, &tm_q, &tm_do, &tm_k, &tm_v, once, full,
                             empty, h, b, q0, n_it);
    } else if (pw == 1) {
      // each key tile's bias in log2 units (-1e30 past Sk), a turn ahead
      const float* kbb = a.kb ? a.kb + (long long)b * Sk : nullptr;
      float x[TILE / 32];
      auto load = [&](int it) {
#pragma unroll
        for (int u = 0; u < TILE / 32; ++u) {
          const int key = it * TILE + lane + 32 * u;
          x[u] = (key < Sk ? (kbb ? kbb[key] : 0.f) : NEG_INF) * LOG2E;
        }
      };
      if (n_it > 0) load(0);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % RING;
        mbar_wait(&empty[s], ((it / RING) & 1) ^ 1);
#pragma unroll
        for (int u = 0; u < TILE / 32; ++u)
          bias_s[s * TILE + lane + 32 * u] = x[u];
        if (it + 1 < n_it) load(it + 1);
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
    const float sl2 = a.scale * LOG2E;
    const int r0 = q0 + wgc * 64 + warp * 16 + g;  // rows r0 and r0 + 8
    const long long row_base = ((long long)b * H + h) * Sq;
    float lse2[2], del[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      lse2[i] = r < Sq ? a.lse[row_base + r] * LOG2E : 0.f;
      del[i] = r < Sq ? a.delta[row_base + r] : 0.f;
    }
    const uint32_t q_addr = smem_u32(sm + L::A) + wgc * 64 * 128;
    const uint32_t do_addr = smem_u32(sm + L::B) + wgc * 64 * 128;
    const uint32_t k_base = smem_u32(sm + L::RA);
    const uint32_t v_base = smem_u32(sm + L::RB);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    uint32_t da[TILE / 16][4];  // dS of the previous tile, T in A layout

    // S and dP of slot s -> dS, packed into da.
    auto scores = [&](int s, float (&sc)[32], float (&dp)[32]) {
      wgmma_wait<1>();  // S is done; dP may still run
      fence_regs(sc);
      const float* bs = bias_s + s * TILE;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
        sc[4 * j + 0] = exp2f(fmaf(sc[4 * j + 0], sl2, bb.x) - lse2[0]);
        sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], sl2, bb.y) - lse2[0]);
        sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], sl2, bb.x) - lse2[1]);
        sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], sl2, bb.y) - lse2[1]);
      }
      wgmma_wait<0>();  // dP is done
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dp[4 * j + 0] = sc[4 * j + 0] * (dp[4 * j + 0] - del[0]);
        dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - del[0]);
        dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - del[1]);
        dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - del[1]);
      }
      pack_a<T>(dp, da);
    };

    mbar_wait(once, 0);
    if (wgc == 1 && n_it > 0) turn_pass(wgc);  // warpgroup 0 goes first
    if (n_it > 0) {
      mbar_wait(&full[0], 0);
      __syncwarp();  // converged for the .aligned wgmma instructions
      float sc[32], dp[32];
      turn_wait(wgc);
      wgmma_fence();
      issue_scores<T, D>(sc, q_addr, ROWS, k_base);
      issue_scores<T, D>(dp, do_addr, ROWS, v_base);
      turn_pass(wgc);
      scores(0, sc, dp);
    }
    for (int it = 1; it < n_it; ++it) {
      const int s = it % RING;
      const int s_prev = (it - 1) % RING;
      mbar_wait(&full[s], (it / RING) & 1);
      __syncwarp();
      float sc[32], dp[32];
      turn_wait(wgc);
      wgmma_fence();
      issue_acc<T, D>(acc, da, k_base + s_prev * L::TILE_BYTES);
      issue_scores<T, D>(sc, q_addr, ROWS, k_base + s * L::TILE_BYTES);
      issue_scores<T, D>(dp, do_addr, ROWS, v_base + s * L::TILE_BYTES);
      turn_pass(wgc);
      wgmma_wait<2>();  // the previous tile's dS.K is done: its slot is free
      fence_regs(acc);
      fence_a(da);
      if (lane == 0) mbar_arrive(&empty[s_prev]);
      scores(s, sc, dp);
    }
    if (n_it > 0) {  // the last tile's dS.K
      turn_wait(wgc);
      wgmma_fence();
      issue_acc<T, D>(acc, da, k_base + ((n_it - 1) % RING) * L::TILE_BYTES);
      if (wgc == 0) turn_pass(wgc);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_a(da);
    }
    store_acc<T, D>(static_cast<T*>(a.dq) +
                        ((long long)b * Sq * H + h) * D,
                    H, Sq, r0, t, acc, a.scale);
  }
}

// ---------------------------------------------------------------------------
// backward: dK and dV (transposed form)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, Args a) {
  using L = Smem<D, 2 * TILE>;  // per slot: lse (log2 units), then delta
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* scal = reinterpret_cast<float*>(sm + L::SC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* once = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + RING;

  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int H = a.H, Sq = a.Sq, Sk = a.Sk;
  const int n_it = (Sq + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 33);               // TMA's expect_tx + warp 1
      mbar_init(&empty[s], CONSUMER_WARPS);  // one lane of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    reg_dealloc<24>();
    const int pw = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (pw == 0 && lane == 0) {
      produce_tiles<D, 2 * TILE>(sm, &tm_k, &tm_v, &tm_q, &tm_do, once, full,
                                 empty, h, b, k0, n_it);
    } else if (pw == 1) {
      // each query tile's lse (log2 units; +1e30 past Sq) and delta (0
      // past Sq), a turn ahead
      const float* lh = a.lse + ((long long)b * H + h) * Sq;
      const float* dh = a.delta + ((long long)b * H + h) * Sq;
      float l[TILE / 32], d[TILE / 32];
      auto load = [&](int it) {
#pragma unroll
        for (int u = 0; u < TILE / 32; ++u) {
          const int r = it * TILE + lane + 32 * u;
          l[u] = r < Sq ? lh[r] * LOG2E : LSE_PAD;
          d[u] = r < Sq ? dh[r] : 0.f;
        }
      };
      if (n_it > 0) load(0);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % RING;
        mbar_wait(&empty[s], ((it / RING) & 1) ^ 1);
#pragma unroll
        for (int u = 0; u < TILE / 32; ++u) {
          scal[s * 2 * TILE + lane + 32 * u] = l[u];
          scal[s * 2 * TILE + TILE + lane + 32 * u] = d[u];
        }
        if (it + 1 < n_it) load(it + 1);
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    reg_alloc<240>();
    const int ct = threadIdx.x - 128;
    const int wgc = ct >> 7;                 // consumer warpgroup: 0 or 1
    const int warp = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const float sl2 = a.scale * LOG2E;
    const int r0 = k0 + wgc * 64 + warp * 16 + g;  // keys r0 and r0 + 8
    const float* kbb = a.kb ? a.kb + (long long)b * Sk : nullptr;
    float bias2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = r0 + 8 * i;
      bias2[i] = (key < Sk ? (kbb ? kbb[key] : 0.f) : NEG_INF) * LOG2E;
    }
    const uint32_t k_addr = smem_u32(sm + L::A) + wgc * 64 * 128;
    const uint32_t v_addr = smem_u32(sm + L::B) + wgc * 64 * 128;
    const uint32_t q_base = smem_u32(sm + L::RA);
    const uint32_t do_base = smem_u32(sm + L::RB);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(once, 0);
    if (wgc == 1 && n_it > 0) turn_pass(wgc);  // warpgroup 0 goes first
    for (int it = 0; it < n_it; ++it) {
      const int s = it % RING;
      mbar_wait(&full[s], (it / RING) & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      const uint32_t q_addr = q_base + s * L::TILE_BYTES;
      const uint32_t do_addr = do_base + s * L::TILE_BYTES;
      const float* ls = scal + s * 2 * TILE;
      float st[32], dpt[32];
      turn_wait(wgc);
      wgmma_fence();
      issue_scores<T, D>(st, k_addr, ROWS, q_addr);
      issue_scores<T, D>(dpt, v_addr, ROWS, do_addr);
      if (wgc == 0 || it + 1 < n_it) turn_pass(wgc);
      wgmma_wait<1>();  // S^T is done; dP^T may still run
      fence_regs(st);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
        st[4 * j + 0] = exp2f(fmaf(st[4 * j + 0], sl2, bias2[0]) - l2.x);
        st[4 * j + 1] = exp2f(fmaf(st[4 * j + 1], sl2, bias2[0]) - l2.y);
        st[4 * j + 2] = exp2f(fmaf(st[4 * j + 2], sl2, bias2[1]) - l2.x);
        st[4 * j + 3] = exp2f(fmaf(st[4 * j + 3], sl2, bias2[1]) - l2.y);
      }
      uint32_t pa[TILE / 16][4], sa[TILE / 16][4];
      pack_a<T>(st, pa);
      wgmma_fence();
      issue_acc<T, D>(dv, pa, do_addr);
      wgmma_wait<1>();  // dP^T is done; dV may still run
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(ls + TILE + 8 * j + 2 * t);
        dpt[4 * j + 0] = st[4 * j + 0] * (dpt[4 * j + 0] - dl.x);
        dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - dl.y);
        dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - dl.x);
        dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - dl.y);
      }
      pack_a<T>(dpt, sa);
      wgmma_fence();
      issue_acc<T, D>(dk, sa, q_addr);
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_a(pa);
      fence_a(sa);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    const long long out0 = ((long long)b * Sk * H + h) * D;
    store_acc<T, D>(static_cast<T*>(a.dk) + out0, H, Sk, r0, t, dk,
                    a.scale);
    store_acc<T, D>(static_cast<T*>(a.dv) + out0, H, Sk, r0, t, dv, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Which { BWD_DQ = 0, BWD_DKV = 1 };

struct Operands {
  const void *q, *k, *v, *d_o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
};

template <typename T, int D>
cudaError_t launch(int which, const Operands& o, const Args& a, int B,
                   cudaStream_t stream) {
  // the block's own operands in boxes of ROWS rows, the ring's of TILE
  const bool dq = which == BWD_DQ;
  const int q_box = dq ? ROWS : TILE, k_box = dq ? TILE : ROWS;
  const long long o_rs = (long long)a.H * D;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_rows<T>(&tq, o.q, a.H * D, a.Sq, B, o.q_rs, o.q_bs, q_box) ||
      !encode_rows<T>(&tdo, o.d_o, a.H * D, a.Sq, B, o_rs, o_rs * a.Sq,
                      q_box) ||
      !encode_rows<T>(&tk, o.k, a.H * D, a.Sk, B, o.k_rs, o.k_bs, k_box) ||
      !encode_rows<T>(&tv, o.v, a.H * D, a.Sk, B, o.v_rs, o.v_bs, k_box))
    return cudaErrorInvalidValue;
  auto kern = dq ? &flash_bwd_dq_kernel<T, D> : &flash_bwd_dkv_kernel<T, D>;
  const int smem = dq ? Smem<D, TILE>::ALLOC : Smem<D, 2 * TILE>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = dq ? a.Sq : a.Sk;
  dim3 grid((rows + ROWS - 1) / ROWS, a.H, B);
  kern<<<grid, THREADS, smem, stream>>>(tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

cudaError_t dispatch(int dtype, int head_dim, int which, const Operands& o,
                     const Args& a, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(which, o, a, B, st);
  if (dtype == 0 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(which, o, a, B, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__half, 128>(which, o, a, B, st);
  if (dtype == 1 && head_dim == 64)
    return launch<__half, 64>(which, o, a, B, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16; head_dim 64 or 128. kb may be null. q/k/v
// base pointers and their row and batch strides must be 16-byte aligned
// (TMA); dO is contiguous. Each returns the cudaError_t of its launch.

extern "C" int hv_flash_bwd_dq(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, const void* d_o,
                               const float* kb, const float* lse,
                               const float* delta, void* dq, int B, int H,
                               int Sq, int Sk, long long q_bs, long long q_rs,
                               long long k_bs, long long k_rs, long long v_bs,
                               long long v_rs, float scale, void* stream) {
  const Operands o = {q, k, v, d_o, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs};
  const Args a = {kb, lse, delta, dq, nullptr, nullptr, H, Sq, Sk, scale};
  return dispatch(dtype, head_dim, BWD_DQ, o, a, B, stream);
}

extern "C" int hv_flash_bwd_dkv(int dtype, int head_dim, const void* q,
                                const void* k, const void* v, const void* d_o,
                                const float* kb, const float* lse,
                                const float* delta, void* dk, void* dv, int B,
                                int H, int Sq, int Sk, long long q_bs,
                                long long q_rs, long long k_bs, long long k_rs,
                                long long v_bs, long long v_rs, float scale,
                                void* stream) {
  const Operands o = {q, k, v, d_o, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs};
  const Args a = {kb, lse, delta, nullptr, dk, dv, H, Sq, Sk, scale};
  return dispatch(dtype, head_dim, BWD_DKV, o, a, B, stream);
}
