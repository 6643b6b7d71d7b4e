// W8A8 linear: y = act(s32(quant(x) . W8^T) * sx * scale_out + bias), for
// Hopper (sm_90a): a quantizing pre-pass, then a persistent s8 wgmma GEMM
// fed by a TMA ring.
//
// Replaces the Pallas TPU kernel ops/int8_matmul.py:_w8a8_kernel (:43) of
// the JAX package (and the XLA body models/dit.py:_int8_linear_body it
// shares its numerics with):
//   * per row of x: amax = max|x| in the input type, sx = max(amax, 1e-8) *
//     (1/127), codes round(x_f32 / sx) with ties to even (a division, as
//     the TPU kernel);
//   * s8 x s8 -> s32 on the tensor cores, exact: at most 127^2 * 15360 <
//     2^31, and split-K partial sums are added as integers;
//   * epilogue on fp32: y = float(s32) * sx * scale_out (+ bias), the
//     activation (none, gelu, gelu_tanh, relu, silu), one store in the
//     input type. Round-to-nearest intrinsics and no fused multiply-add, so
//     that without an activation it is the plain version's arithmetic bit
//     for bit (s32 -> fp32 rounds to nearest, as its float64 -> float32).
// Two arms for a row-parallel linear (K split over ranks, the tensor-
// parallel Llama tower's o_proj and down_proj): the caller may give sx (the
// pre-pass then quantizes with it and takes no amax of its own: the amax of
// the whole row, all-reduced over the ranks), and the epilogue may be off
// (act kS32: the s32 sums stored as they are, to be summed over the ranks
// as integers and dequantized after).
// The weight is the nn.Linear layout [N, K] int8 with a row stride (column
// slices of a fused projection and K slices of linear2 need no copy);
// scale_out [N] and bias [N] are fp32.
//
// Bound on the H100: 2*M*N*K int8 operations at 1,979 TOP/s against the
// bytes of x, W and y at 3.35 TB/s: the token-sized projections (thousands
// of rows) are bound by operations, the modulation matvecs (2 rows) by one
// read of the weight.
//
// Design: two kernels.
//   1. quant_rows_kernel: a row's absmax by 16-byte loads and warp
//      reductions, then its codes into xq [M, K] int8 and sx [M] fp32. At
//      the DiT's and the Llama tower's widths (K = 3072, 4096: four warps
//      a row; 12288, 14336: eight) the row stays in registers with all its
//      loads in flight at once: a call is about one wave of rows, so a
//      row's load latency is the kernel's time. Other K: one warp a row,
//      read twice. Extra blocks zero the split-K workspace of the GEMM
//      that follows.
//   2. w8a8_gemm_kernel: one CTA an SM walks work units (an output tile of
//      BM x BN and a range of 128-byte K steps). A producer warp issues TMA
//      only: per ring slot a box of BM code rows and one of BN weight rows,
//      128 bytes each (the 128-byte swizzle; the weight map takes the
//      weight's own row stride), full/empty mbarriers, a 192 KB ring.
//      Consumer warpgroups (64 rows each) run s8 wgmma m64nBNk32, both
//      operands K-major (the layout of xq and of the weight, so nothing is
//      transposed), s32 accumulators in registers. Tiles are walked in
//      groups of 8 row tiles, so that the tiles in flight share weight
//      columns in L2. The epilogue loads scale_out and bias once a tile,
//      swaps the packed outputs within each quad of lanes so that a lane
//      holds 8 consecutive columns, and stores 16 bytes a row; ragged rows
//      and a ragged last column tile are read as zero by the TMA and not
//      stored.
//   Three tile shapes, chosen on the host (ops/int8_matmul.py:plan_w8a8):
//   128 x 256 (two consumer warpgroups) and 128 x 128 for the token-sized
//   calls; 64 x 128 (one consumer warpgroup) for M <= 64, the modulation
//   matvecs, which are bound by one read of the weight: K is split in its
//   128-byte steps and each CTA takes an equal contiguous range of the
//   (tile, step) units (stream-K), so the weight streams through every
//   SM. A CTA's steps of one tile run as one segment; a segment over part
//   of K adds its s32 sums into the tile's sums in a workspace (integer
//   atomics), and the one that completes the tile's count of K steps reads
//   them back and runs the epilogue: exact, the same bits in every run.
//   Measured against these, a ping-pong of two consumer warpgroups on
//   128 x 128 tiles (one's epilogue under the other's products) lost to
//   the cooperative 128 x 256 tile at every token-sized shape.
#include "hopper.cuh"
#include "mma.cuh"

#include <atomic>

namespace {

using namespace hv::sm90;

constexpr int BK = 128;              // K step: one 128-byte swizzle row
constexpr int RING_BYTES = 196608;   // ring slots, every tile shape
constexpr int GROUP = 8;             // row tiles per raster group
constexpr int QUANT_ROWS = 8;        // pre-pass: warps a block

enum Act { kNone = 0, kGelu = 1, kGeluTanh = 2, kRelu = 3, kSilu = 4,
           kS32 = 5 };

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == kGelu) return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
  if (ACT == kGeluTanh) {
    const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
    return 0.5f * y * (1.f + tanhf(u));
  }
  if (ACT == kRelu) return fmaxf(y, 0.f);
  if (ACT == kSilu) return y / (1.f + expf(-y));
  return y;
}

// Eight values of T (one 16-byte load) as eight int8 codes round(x / s):
// a division and round-to-nearest-even, as the plain version.
template <typename T>
__device__ __forceinline__ uint2 quant8_div(uint4 v, float s) {
  const T* e = reinterpret_cast<const T*>(&v);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = max(-127, min(127, __float2int_rn(
                                         __fdiv_rn(hv::to_f32(e[j]), s))));
    w[j >> 2] |= (uint32_t)(q & 0xff) << (8 * (j & 3));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Row r of x [M, K] -> codes xq [M, K] int8 and scale sx[r]; with `given`
// sx[r] is the caller's scale, read and not written, and no amax is taken.
// NC > 0: W warps a row, K = 256 * NC * W, each warp holding its NC * 256 columns in
// registers (one read, every load in flight at once); NC = 0 (W = 1): one
// warp a row, any K, read twice (the second time from L1/L2). The blocks
// after the rows' blocks zero the first n_zero ints of `zero` (16-byte
// aligned, n_zero a multiple of 4).
template <typename T, int NC, int W>
__global__ void __launch_bounds__(QUANT_ROWS * 32)
quant_rows_kernel(const T* __restrict__ x, long long x_rs,
                  int8_t* __restrict__ xq, float* __restrict__ sx,
                  bool given, int M, int K, int* __restrict__ zero,
                  int n_zero) {
  constexpr int ROWS = QUANT_ROWS / W;  // rows a block
  const int row_blocks = (M + ROWS - 1) / ROWS;
  if ((int)blockIdx.x >= row_blocks) {
    const int nb = gridDim.x - row_blocks;
    for (int i = (blockIdx.x - row_blocks) * blockDim.x + threadIdx.x;
         i < n_zero / 4; i += nb * blockDim.x)
      reinterpret_cast<int4*>(zero)[i] = make_int4(0, 0, 0, 0);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + warp / W;
  const bool live = row < M;
  const long long r = live ? row : 0;
  const uint4* xr = reinterpret_cast<const uint4*>(x + r * x_rs) + lane;
  uint2* qr = reinterpret_cast<uint2*>(xq + r * K) + lane;
  if constexpr (NC > 0) {
    const int c0 = (warp % W) * NC * 32;  // this warp's first chunk
    uint4 v[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      v[c] = live ? __ldg(xr + c0 + 32 * c) : make_uint4(0, 0, 0, 0);
    float s;
    if (given) {  // uniform over the grid: no thread reaches the barrier
      s = live ? sx[row] : 1.f;
    } else {
      float m = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) m = hv::absmax8<T>(v[c], m);
      m = warp_max(m);
      if constexpr (W > 1) {  // the row's W warps share their maxima
        __shared__ float part[QUANT_ROWS];
        if (lane == 0) part[warp] = m;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < W; ++i) m = fmaxf(m, part[warp / W * W + i]);
      }
      s = fmaxf(m, 1e-8f) * (float)(1.0 / 127.0);
    }
    if (!live) return;
#pragma unroll
    for (int c = 0; c < NC; ++c) qr[c0 + 32 * c] = quant8_div<T>(v[c], s);
    if (!given && lane == 0 && warp % W == 0) sx[row] = s;
  } else {
    if (!live) return;
    const int n = K / 8;  // 16-byte chunks of the row
    float s;
    if (given) {
      s = sx[row];
    } else {
      float m = 0.f;
#pragma unroll 8
      for (int c = lane; c < n; c += 32)
        m = hv::absmax8<T>(__ldg(xr + (c - lane)), m);
      s = fmaxf(warp_max(m), 1e-8f) * (float)(1.0 / 127.0);
    }
#pragma unroll 4
    for (int c = lane; c < n; c += 32)
      qr[c - lane] = quant8_div<T>(__ldg(xr + (c - lane)), s);
    if (!given && lane == 0) sx[row] = s;
  }
}

template <typename T, int NC, int W>
void launch_quant_rows(const void* x, long long x_rs, int8_t* xq, float* sx,
                       bool given, int* zero, int n_zero, int M, int K,
                       cudaStream_t st) {
  constexpr int ROWS = QUANT_ROWS / W;
  // a block zeroes 1024 int4s a pass; at most one block an SM
  const int zero_blocks = min((n_zero / 4 + 1023) / 1024, 132);
  quant_rows_kernel<T, NC, W>
      <<<(M + ROWS - 1) / ROWS + zero_blocks, QUANT_ROWS * 32, 0, st>>>(
          static_cast<const T*>(x), x_rs, xq, sx, given, M, K, zero, n_zero);
}

// The row widths of the DiT (3072, 12288) and the Llama tower (4096,
// 14336) held in registers, at most 7 chunks a lane (more live registers
// around the division's slow-path call made ptxas spill); any other K read
// twice.
template <typename T>
void launch_quant(const void* x, long long x_rs, int8_t* xq, float* sx,
                  bool given, int* zero, int n_zero, int M, int K,
                  cudaStream_t st) {
  if (K == 3072)
    launch_quant_rows<T, 3, 4>(x, x_rs, xq, sx, given, zero, n_zero, M, K,
                               st);
  else if (K == 4096)
    launch_quant_rows<T, 4, 4>(x, x_rs, xq, sx, given, zero, n_zero, M, K,
                               st);
  else if (K == 12288)
    launch_quant_rows<T, 6, 8>(x, x_rs, xq, sx, given, zero, n_zero, M, K,
                               st);
  else if (K == 14336)
    launch_quant_rows<T, 7, 8>(x, x_rs, xq, sx, given, zero, n_zero, M, K,
                               st);
  else
    launch_quant_rows<T, 0, 1>(x, x_rs, xq, sx, given, zero, n_zero, M, K,
                               st);
}

// Shared memory of one tile shape, byte offsets from a 1024-aligned base:
// STAGES ring slots of [BM][128] codes then [BN][128] weight bytes, the
// full and empty barriers, and the split-K flag.
template <int CWG, int BN>
struct Cfg {
  static constexpr int BM = 64 * CWG;
  static constexpr int THREADS = 128 * (CWG + 1);
  static constexpr int A_BYTES = BM * BK;
  static constexpr int SLOT = A_BYTES + BN * BK;
  static constexpr int STAGES = RING_BYTES / SLOT;
  static constexpr int BAR = STAGES * SLOT;
  static constexpr int FLAG = BAR + 2 * STAGES * 8;
  static constexpr int ALLOC = FLAG + 16 + 1024;  // + base alignment
  static_assert(STAGES >= 4, "at least 4 ring slots");
  static_assert(ALLOC <= 232448, "227 KB of shared memory a block");
};

struct Params {
  const float* sx;    // [M]
  const float* so;    // [N]
  const void* bias;   // [N]: bias_type 0 none, 1 fp32, 2 the input type
  void* out;          // [M, N], the input type
  int* ws;            // split > 1: s32 sums [M, N], then tile counters
  int bias_type, M, N, split, m_tiles, n_tiles, k_steps, units;
};

// Work unit u: tile u / split (row tiles fastest within groups of GROUP),
// K steps [k0, k1) of its part u % split; ops/int8_matmul.py:plan_segments
// lists the same segments. With split = 1 CTA c takes units c, c + grid, ...
// (the tiles in flight together share weight columns); with split > 1 it
// takes the contiguous units [c * units / grid, (c + 1) * units / grid),
// and the parts of one tile among them run as one segment, their sums
// kept in registers, so that a CTA flushes partial sums about twice.
struct Unit {
  int m, n, k0, k1, tile;
};

__device__ __forceinline__ int units_begin(int c, const Params& p) {
  return p.split == 1 ? c : (int)((long long)c * p.units / gridDim.x);
}

__device__ __forceinline__ int units_end(int c, const Params& p) {
  return p.split == 1 ? p.units
                      : (int)((long long)(c + 1) * p.units / gridDim.x);
}

// The segment that starts at unit u, before unit `end`; *next is the unit
// after it.
__device__ __forceinline__ Unit segment_of(int u, int end, const Params& p,
                                           int* next) {
  const int tile = u / p.split, part = u - tile * p.split;
  const int last = p.split == 1 ? part : min(end - tile * p.split,
                                             p.split) - 1;
  *next = p.split == 1 ? u + gridDim.x : tile * p.split + last + 1;
  const int per_group = GROUP * p.n_tiles;
  const int grp = tile / per_group, first = grp * GROUP;
  const int rows = min(p.m_tiles - first, GROUP);
  const int r = tile - grp * per_group;
  return Unit{first + r % rows, r / rows, part * p.k_steps / p.split,
              (last + 1) * p.k_steps / p.split, tile};
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BN == 256)
    wgmma_m64n256k32_s8_ss(d, da, db, scale_d);
  else
    wgmma_m64n128k32_s8_ss(d, da, db, scale_d);
}

// Within a quad of lanes (t = lane & 3), v[q] holds columns 8q + 2t, +1 of
// four 8-column blocks; afterwards v[q] holds columns 8t + 2q, +1: the
// lane's 8 consecutive columns (a 4 x 4 transpose in two xor exchanges).
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool odd = t & 1, hi = t & 2;
  uint32_t a = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  uint32_t b = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  if (odd) {
    v[0] = a;
    v[2] = b;
  } else {
    v[1] = a;
    v[3] = b;
  }
  a = __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
  b = __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
  if (hi) {
    v[0] = a;
    v[1] = b;
  } else {
    v[2] = a;
    v[3] = b;
  }
}

// old = *p, *p += v at GPU scope, acquire and release: one thread's
// atomic, with the named barriers around it, orders the CTA's workspace
// adds before the count and the last segment's loads after it, where a
// fence in every thread would do the same work 128 times.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// The bias pair at columns col, col + 1 as fp32: none, fp32 or the input
// type T (exact either way).
template <typename T>
__device__ __forceinline__ float2 bias_pair(const void* bias, int type,
                                            int col) {
  if (type == 1) return *reinterpret_cast<const float2*>(
      static_cast<const float*>(bias) + col);
  if (type == 2) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        static_cast<const T*>(bias) + col);
    const T* e = reinterpret_cast<const T*>(&v);
    return make_float2(hv::to_f32(e[0]), hv::to_f32(e[1]));
  }
  return make_float2(0.f, 0.f);
}

// One consumer warpgroup's 64 x BN share of a finished segment.
// Accumulator layout (m64nBN s32): acc[4j + 2i + c] is row r0 + 8i, column
// n0 + 8j + 2t + c. A segment over part of K adds its sums into the
// workspace; the one that completes the tile's K stores it: dequantized in
// the input type, or under kS32 the s32 sums themselves.
template <typename T, int ACT, int CWG, int BN>
__device__ __forceinline__ void epilogue(int (&acc)[BN / 2], const Unit& w,
                                         const Params& p, int r0, int t,
                                         volatile int* flag) {
  const int n0 = w.n * BN;
  if (w.k1 - w.k0 < p.k_steps) {
    // the segment's partial sums into the tile's s32 sums (integer adds,
    // in any order the same), then one release/acquire on its counter of
    // K steps; the segment that completes the count reads the sums back
    // and stores the tile
    const long long mn = (long long)p.M * p.N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= p.M) continue;
      int* dst = p.ws + (long long)row * p.N + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (n0 + 8 * j < p.N) {
          atomicAdd(dst + 8 * j, acc[4 * j + 2 * i]);
          atomicAdd(dst + 8 * j + 1, acc[4 * j + 2 * i + 1]);
        }
      }
    }
    bar_sync(1, 128 * CWG);
    if (threadIdx.x == 128)
      *flag = atomic_add_acq_rel(p.ws + mn + w.tile, w.k1 - w.k0) ==
              p.k_steps - (w.k1 - w.k0);
    bar_sync(1, 128 * CWG);
    if (!*flag) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      const int* src = p.ws + (long long)row * p.N + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        int2 v = make_int2(0, 0);
        if (row < p.M && n0 + 8 * j < p.N)
          v = __ldcg(reinterpret_cast<const int2*>(src + 8 * j));
        acc[4 * j + 2 * i] = v.x;
        acc[4 * j + 2 * i + 1] = v.y;
      }
    }
  }
  if constexpr (ACT == kS32) {
    int* out = static_cast<int*>(p.out);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= p.M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        if (n0 + 8 * j < p.N)
          *reinterpret_cast<int2*>(out + (long long)row * p.N + n0 + 8 * j +
                                   2 * t) =
              make_int2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
    return;
  }
  float sr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    sr[i] = r0 + 8 * i < p.M ? p.sx[r0 + 8 * i] : 0.f;
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int g4 = 0; g4 < BN / 32; ++g4) {
    const int c0 = n0 + 32 * g4;  // the 32 columns of 4 blocks j = 4*g4+q
    if (c0 >= p.N) break;         // N is a multiple of 128
    float2 sc[4], bs[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = c0 + 8 * q + 2 * t;
      sc[q] = *reinterpret_cast<const float2*>(p.so + col);
      bs[q] = bias_pair<T>(p.bias, p.bias_type, col);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int a = 4 * (4 * g4 + q) + 2 * i;
        float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[a]), sr[i]),
                             sc[q].x);
        float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[a + 1]), sr[i]),
                             sc[q].y);
        if (p.bias_type != 0) {
          y0 = __fadd_rn(y0, bs[q].x);
          y1 = __fadd_rn(y1, bs[q].y);
        }
        v[q] = hv::pack2(activate<ACT>(y0), activate<ACT>(y1), T());
      }
      quad_transpose(v, t);
      const int row = r0 + 8 * i;
      if (row < p.M)
        *reinterpret_cast<uint4*>(out + (long long)row * p.N + c0 + 8 * t) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// A consumer warpgroup's main loop over one segment: per 128-byte K step,
// the 4 k32 products of its 64-row A slice (a_off bytes into the slot)
// against the slot's BN weight rows; every slot released once the
// products that read it are done.
template <int BN, typename Cf>
__device__ __forceinline__ void mainloop(int (&acc)[BN / 2], const Unit& w,
                                         uint32_t base, int a_off,
                                         uint64_t* full, uint64_t* empty,
                                         int lane, int& s, int& phase) {
  int prev = 0;
  for (int k = w.k0; k < w.k1; ++k) {
    mbar_wait(&full[s], phase);
    __syncwarp();  // converged for the .aligned wgmma instructions
    const uint32_t a = base + s * Cf::SLOT + a_off;
    const uint32_t b = base + s * Cf::SLOT + Cf::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8<BN>(acc, desc_sw128(a + 32 * kk, 16, 1024),
                   desc_sw128(b + 32 * kk, 16, 1024), k > w.k0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done
    if (k > w.k0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == Cf::STAGES) s = 0, phase ^= 1;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(&empty[prev]);
}

template <typename T, int ACT, int CWG, int BN>
__global__ void __launch_bounds__(Cfg<CWG, BN>::THREADS, 1)
w8a8_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b, const Params p) {
  using C = Cfg<CWG, BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* empty = full + C::STAGES;
  volatile int* flag = reinterpret_cast<volatile int*>(sm + C::FLAG);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);         // the TMA lane's expect_tx
      mbar_init(&empty[s], 4 * CWG);  // one lane of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    if constexpr (CWG == 2) reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int s = 0, phase = 0;
      const int end = units_end(blockIdx.x, p);
      for (int u = units_begin(blockIdx.x, p), next; u < end; u = next) {
        const Unit w = segment_of(u, end, p, &next);
        for (int k = w.k0; k < w.k1; ++k) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_arrive_expect_tx(&full[s], C::SLOT);
          uint8_t* a = sm + s * C::SLOT;
          tma_load_3d(a, &tm_a, &full[s], k * BK, w.m * C::BM, 0);
          tma_load_3d(a + C::A_BYTES, &tm_b, &full[s], k * BK, w.n * BN, 0);
          if (++s == C::STAGES) s = 0, phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    if constexpr (CWG == 2) reg_alloc<232>();
    const int ct = threadIdx.x - 128;
    const int wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
    const uint32_t base = smem_u32(sm);
    int s = 0, phase = 0;
    const int end = units_end(blockIdx.x, p);
    for (int u = units_begin(blockIdx.x, p), next; u < end; u = next) {
      const Unit w = segment_of(u, end, p, &next);
      int acc[BN / 2];
      mainloop<BN, C>(acc, w, base, wg * 64 * BK, full, empty, lane, s,
                      phase);
      const int r0 = w.m * C::BM + wg * 64 + warp * 16 + (lane >> 2);
      epilogue<T, ACT, CWG, BN>(acc, w, p, r0, lane & 3, flag);
    }
  }
}

struct GemmArgs {
  const int8_t* xq;
  const int8_t* w;
  long long w_rs;
  Params p;
  int K, grid;
  cudaStream_t stream;
};

template <typename T, int ACT, int CWG, int BN>
cudaError_t launch_gemm(const GemmArgs& a) {
  using C = Cfg<CWG, BN>;
  auto kern = w8a8_gemm_kernel<T, ACT, CWG, BN>;
  // the shared-memory attribute once per instantiation and device
  static std::atomic<unsigned> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(configured.load() & (1u << dev))) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::ALLOC);
    if (err != cudaSuccess) return err;
    configured.fetch_or(1u << dev);
  }
  CUtensorMap ta, tb;
  const int M = a.p.M, N = a.p.N;
  if (!encode_rows_s8(&ta, a.xq, a.K, M, 1, a.K, 0, BK, C::BM) ||
      !encode_rows_s8(&tb, a.w, a.K, N, 1, a.w_rs, 0, BK, BN))
    return cudaErrorInvalidValue;
  kern<<<a.grid, C::THREADS, C::ALLOC, a.stream>>>(ta, tb, a.p);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t by_tile(int bm, int bn, const GemmArgs& a) {
  if (bm == 128 && bn == 256) return launch_gemm<T, ACT, 2, 256>(a);
  if (bm == 128 && bn == 128) return launch_gemm<T, ACT, 2, 128>(a);
  if (bm == 64 && bn == 128) return launch_gemm<T, ACT, 1, 128>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_act(int act, int bm, int bn, const GemmArgs& a) {
  switch (act) {
    case kNone: return by_tile<T, kNone>(bm, bn, a);
    case kGelu: return by_tile<T, kGelu>(bm, bn, a);
    case kGeluTanh: return by_tile<T, kGeluTanh>(bm, bn, a);
    case kRelu: return by_tile<T, kRelu>(bm, bn, a);
    case kSilu: return by_tile<T, kSilu>(bm, bn, a);
    case kS32: return by_tile<T, kS32>(bm, bn, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The pre-pass: x [M, K] (row stride x_rs elements, 16-byte aligned rows)
// of type dtype (0 = bf16, 1 = fp16) to codes xq [M, K] int8 and scales sx
// [M] fp32 (given != 0: sx holds the caller's scales, read only); the first
// n_zero ints of `zero` (the GEMM's split-K sums and
// counters; 16-byte aligned, n_zero a multiple of 4; may be null with
// n_zero 0) set to 0. K a multiple of 8. Returns the
// cudaError_t of the launch.
extern "C" int hv_w8a8_quantize(int dtype, const void* x, long long x_rs,
                                int8_t* xq, float* sx, int given, int* zero,
                                int n_zero, int M, int K, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0 || n_zero < 0 || n_zero % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_quant<__nv_bfloat16>(x, x_rs, xq, sx, given != 0, zero, n_zero,
                                M, K, st);
  else if (dtype == 1)
    launch_quant<__half>(x, x_rs, xq, sx, given != 0, zero, n_zero, M, K,
                         st);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// y = act(dequant(quant(x) . w^T) + bias): the pre-pass, then the GEMM on
// its codes, both launched on `stream`. x [M, K] of type dtype (0 = bf16,
// 1 = fp16; row stride x_rs elements, 16-byte aligned rows), w [N, K] int8
// with row stride w_rs (bytes, a multiple of 16), scale_out [N] fp32, bias
// [N] of bias_type (0 none, 1 fp32, 2 dtype; 8-byte aligned), out [M, N]
// contiguous of type dtype; scratch xq [M, K] int8 and sx [M] fp32 (given
// != 0: sx holds the caller's row scales, read only). act: 0 none, 1 gelu,
// 2 gelu_tanh, 3 relu, 4 silu, 5 none and no epilogue: out [M, N] s32 holds
// the sums (no bias; scale_out is not read). The schedule
// (ops/int8_matmul.py:plan_w8a8): tile bm x bn (128 x 256, 128 x 128 or
// 64 x 128), K split in `split` parts, `grid` persistent CTAs; split > 1
// needs ws (16-byte aligned): s32 sums [M * N], then one counter a tile,
// rounded up to a multiple of 4 ints (the pre-pass zeroes them all). N
// and K multiples of 128. Returns the cudaError_t
// of the launches.
extern "C" int hv_w8a8_linear(int dtype, int act, const void* x,
                              long long x_rs, const int8_t* w, long long w_rs,
                              const float* scale_out, const void* bias,
                              int bias_type, void* out, int8_t* xq, float* sx,
                              int* ws, int given, int M, int N, int K, int bm,
                              int bn, int split, int grid, void* stream) {
  if (M <= 0 || N % 128 != 0 || K % BK != 0 || N <= 0 || K <= 0 ||
      w_rs % 16 != 0 || split < 1 || split > K / BK || grid < 1 ||
      (split > 1 && ws == nullptr) || (bm != 64 && bm != 128) ||
      (bn != 128 && bn != 256) || bias_type < 0 || bias_type > 2 ||
      (bias_type != 0 && bias == nullptr) || (act == kS32 && bias_type) ||
      (split > 1 && (long long)M * N > (1ll << 30)))
    return cudaErrorInvalidValue;
  const int m_tiles = (M + bm - 1) / bm, n_tiles = (N + bn - 1) / bn;
  // split > 1: the pre-pass zeroes the sums and the counters
  const int n_ws = split > 1 ? (M * N + m_tiles * n_tiles + 3) / 4 * 4 : 0;
  cudaError_t err = static_cast<cudaError_t>(hv_w8a8_quantize(
      dtype, x, x_rs, xq, sx, given, ws, n_ws, M, K, stream));
  if (err != cudaSuccess) return err;
  const Params p{sx, scale_out, bias, out, ws, bias_type, M, N, split,
                 m_tiles, n_tiles, K / BK, m_tiles * n_tiles * split};
  const GemmArgs a{xq, w, w_rs, p, K, grid,
                   static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_act<__nv_bfloat16>(act, bm, bn, a);
  if (dtype == 1) return by_act<__half>(act, bm, bn, a);
  return cudaErrorInvalidValue;
}
