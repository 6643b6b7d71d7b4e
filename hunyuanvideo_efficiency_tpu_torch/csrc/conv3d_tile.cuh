// The Hopper (sm_90a) main loop of the stride-1 3x3x3 convolution over a
// pre-padded NDHWC input, shared by K3 (conv3d.cu, one output frame a
// block) and B11 (conv3d_v2.cu, one block sweeps T): wgmma products whose
// operands arrive by TMA into two rings of shared memory.
//
// The function (both kernels):
//   out[b, t, h, w, :] = bias + sum_{dt,dh,dw,ci}
//                        xp[b, t+dt, h+dh, w+dw, ci] * w[dt, dh, dw, ci, :]
// xp [B, T+2, H+2, W+2, Cin], weights transposed by the wrapper to
// [27, Cout, Cin] (tap = 9 dt + 3 dh + dw; Cin contiguous: a K-major B
// operand), out [B, T, H, W, Cout]; fp16 or bf16 with fp32 accumulation,
// the bias added in fp32 and one rounding to the output type.
//
// The GEMM: M = a tile of BH x BW = 256 output pixels of one frame (BW = 8,
// 16 or 32, picked by the host: ops/conv3d_cuda.py:conv_tile), N = BN output
// channels, K = 27 taps x Cin in slices of 64 channels (one 128-byte
// swizzled row a pixel). A block has three warpgroups: warpgroup 0 is the
// producer (one thread issues every TMA load; its registers go to the
// consumers through setmaxnreg), warpgroups 1 and 2 each own 128 of the
// 256 pixels and run m64nBNk16 wgmma products, two m64 halves a k16 step,
// with fp32 accumulators in registers.
//
// The A operand (pixels x channels). For a temporal tap dt, a 64-channel
// slice and a column tap dw, one TMA box of the padded input, (BH + 2)
// image rows x BW columns x 64 channels at (t + dt, h0, w0 + dw), lands in
// shared memory as (BH + 2) * BW rows of 128 bytes with the 128-byte
// swizzle. The tap (dh, dw) reads output pixel (r, c) at box row
// (r + dh) * BW + c: the box's rows shifted by dh * BW. BW is a multiple of
// 8, so the shift is a whole number of 1024-byte swizzle atoms, and the
// SS wgmma reads the shifted tile through desc_sw128 unchanged. Three boxes
// (dw = 0, 1, 2) a (dt, slice) take the place of nine shifted loads. The
// other layout, one (BH + 2) x (BW + 2) halo slab a (dt, slice), cannot be
// read by a descriptor at a one-pixel shift (128 bytes, inside an atom): it
// needs ldmatrix into RS products. The three boxes were taken for the
// simpler operand path; they cost more L2 bytes (below).
// The B operand (channels x Cout): a box of BN rows x 64 channels of the
// transposed weights a tap, in its own ring.
// Order: a box dw is loaded once and feeds its taps dh = 0, 1, 2 (and, in
// B11, those of all three temporal taps), then is freed, so the A ring is
// at box granularity: SA = 3 slots of one box (at most 40,960 bytes), and
// the B ring SB slots of one tap's weights (98,304 bytes in all). A slot
// is freed by the consumers once the products that read it are done
// (wgmma.wait_group 1: the newest product may still run).
//
// Summation order, the same in both kernels so that B11 equals K3 bit for
// bit: each output's fp32 sum starts at its bias, then takes its taps
// temporal tap first, then channel slice, then dw, then dh, each tap as 4
// k16 steps in channel order; one rounding at the store.
//
// Bytes per operation (through L2), at [1, 33, 256, 256, 128] -> 128 with
// BW = 16, BN = 128 (K3): per (dt, slice) a block reads 3 boxes of
// 18 x 16 x 128 B = 110,592 B of input and 9 x 16,384 B = 147,456 B of
// weights for 2 x 256 x 128 x 64 x 9 = 37.7e6 operations, 6.8e-3 B an
// operation: 13.1 GB for the call's 8,448 blocks (weights 7.5 GB, input
// 5.6 GB), against 14.9 + 2.3 GB for the mma.sync design's 128-pixel
// blocks. B11 (BN = 64, each box feeding three temporal taps) reads per
// (input frame, slice) 110,592 B of input and 27 x 8,192 B of weights for
// 56.6e6 operations, 5.9e-3 B an operation.
#pragma once

#include "hopper.cuh"
#include "mma.cuh"

namespace hv {
namespace conv {

using namespace hv::sm90;

constexpr int M = 256;             // output pixels a block
constexpr int BC = 64;             // input channels a slice (128-byte rows)
constexpr int SA = 3;              // input-box ring slots
constexpr int A_SLOT = 40960;      // bytes: (256 / 32 + 2) x 32 rows, max
constexpr int THREADS = 384;       // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;

// Bytes of one input box for a tile BW columns wide.
__host__ __device__ constexpr int a_box_bytes(int bw) {
  return (M / bw + 2) * bw * 128;
}

// Shared memory, byte offsets from a 1024-aligned base.
template <int BN>
struct Smem {
  static constexpr int B_BYTES = BN * 128;           // one tap's weights
  static constexpr int SB = 98304 / B_BYTES;         // weight ring slots
  static constexpr int A = 0;
  static constexpr int B = A + SA * A_SLOT;
  static constexpr int BAR = B + SB * B_BYTES;       // fullA, emptyA, fullB, emptyB
  static constexpr int BYTES = BAR + (2 * SA + 2 * SB) * 8;
  static constexpr int ALLOC = BYTES + 1024;         // base alignment
};

// One ring of shared-memory slots with full/empty barriers, as seen by one
// thread: the slot in use and its phase parity.
template <int SLOTS>
struct RingPos {
  uint32_t slot = 0, phase = 0;
  __device__ void next() {
    if (++slot == SLOTS) {
      slot = 0;
      phase ^= 1;
    }
  }
  __device__ uint32_t prev() const { return slot ? slot - 1 : SLOTS - 1; }
};

// The two rings (shared-memory addresses, 32 bits: fewer registers than
// pointers beside the consumers' accumulators).
template <int BN>
struct Rings {
  using L = Smem<BN>;
  uint32_t base;  // 1024-aligned start of the layout
  RingPos<SA> a;
  RingPos<L::SB> b;

  __device__ explicit Rings(uint32_t base_) : base(base_) {}
  __device__ uint32_t full_a(uint32_t s) const { return base + L::BAR + 8 * s; }
  __device__ uint32_t empty_a(uint32_t s) const {
    return base + L::BAR + 8 * (SA + s);
  }
  __device__ uint32_t full_b(uint32_t s) const {
    return base + L::BAR + 8 * (2 * SA + s);
  }
  __device__ uint32_t empty_b(uint32_t s) const {
    return base + L::BAR + 8 * (2 * SA + L::SB + s);
  }

  __device__ void init() const {
    for (int s = 0; s < SA; ++s) {
      mbar_init(full_a(s), 1);
      mbar_init(empty_a(s), CONSUMER_WARPS);
    }
    for (int s = 0; s < L::SB; ++s) {
      mbar_init(full_b(s), 1);
      mbar_init(empty_b(s), CONSUMER_WARPS);
    }
    fence_barrier_init();
  }

  // Producer (one thread): the input box of frame row `frow` (b * (T + 2)
  // + input frame), channel slice c, column tap dw.
  __device__ void load_box(const CUtensorMap* tm_x, int frow, int c, int dw,
                           int h0, int w0, uint32_t a_bytes) {
    mbar_wait(empty_a(a.slot), a.phase ^ 1);
    mbar_arrive_expect_tx(full_a(a.slot), a_bytes);
    tma_load_4d(base + L::A + a.slot * A_SLOT, tm_x, full_a(a.slot), c * BC,
                w0 + dw, h0, frow);
    a.next();
  }

  // Producer (one thread): tap `tap`'s weights for channel slice c and
  // output channels n0 .. n0 + BN - 1.
  __device__ void load_weights(const CUtensorMap* tm_w, int tap, int c,
                               int n0) {
    mbar_wait(empty_b(b.slot), b.phase ^ 1);
    mbar_arrive_expect_tx(full_b(b.slot), L::B_BYTES);
    tma_load_3d(base + L::B + b.slot * L::B_BYTES, tm_w, full_b(b.slot),
                c * BC, n0, tap);
    b.next();
  }
};

// Consumer warpgroup: `n_boxes` input boxes, each followed in the B ring by
// 3 * SETS weight tiles, j = 3 * set + dh: acc[set] += A(box, dh) . B(j).
// `a_row` is the warpgroup's first pixel row in a box (128 * warpgroup, in
// bytes), `shift` = BW * 128 the bytes of one image row of the box. Ends
// with every product done and every slot freed.
template <typename T, int BN, int SETS>
__device__ __forceinline__ void consume(float (&acc)[SETS][2][BN / 2],
                                        Rings<BN>& r, int n_boxes,
                                        uint32_t a_row, uint32_t shift,
                                        bool leader) {
  using L = Smem<BN>;
#pragma unroll 1
  for (int i = 0; i < n_boxes; ++i) {
    mbar_wait(r.full_a(r.a.slot), r.a.phase);
    const uint32_t a_addr = r.base + L::A + r.a.slot * A_SLOT + a_row;
#pragma unroll
    for (int j = 0; j < 3 * SETS; ++j) {
      mbar_wait(r.full_b(r.b.slot), r.b.phase);
      __syncwarp();  // converged for the .aligned wgmma instructions
      wgmma_fence();
      const uint32_t aa = a_addr + (j % 3) * shift;
      const uint32_t bb = r.base + L::B + r.b.slot * L::B_BYTES;
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          wgmma_ss<BN, T>(acc[j / 3][mi],
                          desc_sw128(aa + mi * 64 * 128 + kk * 32, 16, 1024),
                          desc_sw128(bb + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's products are done
      if (leader && (i > 0 || j > 0)) {
        mbar_arrive(r.empty_b(r.b.prev()));
        if (j == 0) mbar_arrive(r.empty_a(r.a.prev()));
      }
      r.b.next();
    }
    r.a.next();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < SETS; ++s) {
    fence_regs(acc[s][0]);
    fence_regs(acc[s][1]);
  }
  if (leader && n_boxes > 0) {
    mbar_arrive(r.empty_b(r.b.prev()));
    mbar_arrive(r.empty_a(r.a.prev()));
  }
}

// Starts an accumulator set (this thread's part of a 256 x BN tile) at the
// bias of its columns, in fp32 (zero without a bias): the bias is the first
// term of every output's sum in both kernels. The loads land in their own
// registers, fenced, before the accumulators are written: with the loads
// writing the accumulators directly, ptxas serialized K3's products (C7515,
// 3.1 against 2.7 ms at [1, 33, 256, 256, 128] -> 128 on the H100).
template <int BN>
__device__ __forceinline__ void init_set(float (&acc)[2][BN / 2],
                                         const float* __restrict__ bias,
                                         int n0) {
  const int t = threadIdx.x & 3;
  float2 tb[BN / 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    tb[j] = bias ? *reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * t)
                 : make_float2(0.f, 0.f);
    asm volatile("" : "+f"(tb[j].x), "+f"(tb[j].y) :: "memory");
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 bb = tb[j];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      acc[mi][4 * j + 0] = acc[mi][4 * j + 2] = bb.x;
      acc[mi][4 * j + 1] = acc[mi][4 * j + 3] = bb.y;
    }
  }
  fence_regs(acc[0]);
  fence_regs(acc[1]);
}

// Stores one accumulator set (this thread's part of a 256 x BN tile of
// output frame `frame` = b * T + t), rounded once to T; pixels past H or W
// are not stored.
template <typename T, int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[2][BN / 2],
                                           T* __restrict__ out,
                                           long long frame, int h0, int w0,
                                           int n0, int H, int W, int Cout,
                                           int bw_log2, int m0) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + 64 * mi + 16 * warp + g + 8 * hf;
      const int hh = h0 + (m >> bw_log2);
      const int ww = w0 + (m & ((1 << bw_log2) - 1));
      if (hh >= H || ww >= W) continue;
      T* orow = out + ((frame * H + hh) * W + ww) * Cout + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            hv::pack2(acc[mi][4 * j + 2 * hf], acc[mi][4 * j + 2 * hf + 1],
                      T());
    }
}

// Host: the tensor maps of the padded input (4-D: channels, Wp, Hp,
// B * (T + 2); boxes 64 x bw x (256 / bw + 2) x 1) and of the transposed
// weights (3-D: Cin, Cout, 27; boxes 64 x bn x 1). False if refused.
template <typename T>
bool encode_maps(CUtensorMap* tm_x, CUtensorMap* tm_w, const void* xp,
                 const void* wt, int B, int T_out, int H, int W, int Cin,
                 int Cout, int bw, int bn) {
  const long long Hp = H + 2, Wp = W + 2, es = sizeof(T);
  const cuuint64_t xd[4] = {(cuuint64_t)Cin, (cuuint64_t)Wp, (cuuint64_t)Hp,
                            (cuuint64_t)B * (T_out + 2)};
  const cuuint64_t xs[3] = {(cuuint64_t)(Cin * es),
                            (cuuint64_t)(Wp * Cin * es),
                            (cuuint64_t)(Hp * Wp * Cin * es)};
  const cuuint32_t xb[4] = {BC, (cuuint32_t)bw, (cuuint32_t)(M / bw + 2), 1};
  const cuuint64_t wd[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 27};
  const cuuint64_t ws[2] = {(cuuint64_t)(Cin * es),
                            (cuuint64_t)(Cout * Cin * es)};
  const cuuint32_t wb[3] = {BC, (cuuint32_t)bn, 1};
  return encode_box<T>(tm_x, xp, 4, xd, xs, xb) &&
         encode_box<T>(tm_w, wt, 3, wd, ws, wb);
}

__host__ __device__ constexpr int log2_bw(int bw) {
  return bw == 8 ? 3 : bw == 16 ? 4 : bw == 32 ? 5 : -1;
}

}  // namespace conv
}  // namespace hv
