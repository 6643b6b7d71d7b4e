// Implicit-GEMM stride-1 3x3x3 convolution over a pre-padded NDHWC input,
// for Hopper (sm_90a): one output frame a block.
//
// Replaces the Pallas TPU kernel ops/conv3d_pallas.py:_conv_kernel of the
// JAX package (the VAE's CausalConv3d; the caller does the causal
// edge-replicate pad, (2, 0) on T and (1, 1) on H and W):
//   out[b, t, h, w, :] = bias + sum_{dt,dh,dw,ci}
//                        xp[b, t+dt, h+dh, w+dw, ci] * w[dt, dh, dw, ci, :]
// with fp32 accumulation, bias added in fp32, one rounding to the output
// type (the TPU kernel rounded before its bias add; the plain version in
// ops/conv3d_cuda.py follows this kernel).
//
// Shapes: xp [B, T+2, H+2, W+2, Cin], weights transposed by the wrapper to
// [3, 3, 3, Cout, Cin] (Cin contiguous: the K-major B operand), out
// [B, T, H, W, Cout]; fp16 (the VAE's precision) or bf16.
// Gate: Cin % 128 == 0 and Cout % 128 == 0, as the TPU gate. Its H % 8 and
// the W 8-alignment over-pad are dropped: TMA zero-fills boxes past the
// padded H and W, and the epilogue masks the stores.
//
// Bound on the H100: 2*27*Cin*Cout*B*T*H*W operations on the tensor cores
// against one read of xp and one write of out; at the decoder's 128- to
// 512-channel stages that is hundreds of operations per byte, so the kernel
// is bound by operations (989 TFLOP/s fp16 dense).
//
// Design (the main loop is conv3d_tile.cuh's, shared with B11): a block of
// a producer and two consumer warpgroups owns 256 output pixels (a 256/BW x
// BW tile) of one (b, t) and BN output channels, BW and BN from the host
// (ops/conv3d_cuda.py: conv_tile, conv_block_n): BN = 128, or 64 where the
// grid is a wave or two and half-width blocks fill the last one better (the
// decoder's 512-channel stages at 9 frames of 32 x 32 and less).
// For each temporal tap dt, 64-channel slice and column tap dw the producer
// brings one input box by TMA, then the three row taps' weight tiles; the
// consumers run m64nBNk16 wgmma products on them as they arrive, with BN
// fp32 accumulators a thread. What held the mma.sync design (10.03 ms at
// [1, 33, 256, 256, 128] -> 128 fp16, 19% of the card's rate) and what this
// one does about it:
//   1. mma.sync fed by 32-bit shared-memory reads in every warp: wgmma
//      reads both operands from shared memory once a warpgroup product;
//   2. all the weights re-read by every 128-pixel block: 256 pixels a
//      block halve the weight bytes an operation (the arithmetic is in
//      conv3d_tile.cuh);
//   3. no copy overlapping compute: TMA rings of 3 input boxes and 96 KB
//      of weight tiles keep the next loads in flight under the products.
// Grid: (Cout / BN, tiles, B * T), the output-channel blocks of a tile
// adjacent so that they meet its input boxes in L2. The instruction's N
// does not change the sums: at BN = 64 and 128 the outputs are equal bit
// for bit, and equal to B11's (BN = 64).
#include "conv3d_tile.cuh"

namespace {

using namespace hv::sm90;
using namespace hv::conv;

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_s1_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const float* __restrict__ bias, T* __restrict__ out,
                 int T_out, int H, int W, int Cin, int Cout, int bw_log2,
                 int tiles_w) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Rings<BN> ring(raw + ((1024 - (raw & 1023)) & 1023));
  const int bw = 1 << bw_log2, bh = M / bw;
  const int n0 = blockIdx.x * BN;
  const int h0 = (blockIdx.y / tiles_w) * bh, w0 = (blockIdx.y % tiles_w) * bw;
  const int b = blockIdx.z / T_out, to = blockIdx.z % T_out;
  const int slices = Cin / BC;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      const uint32_t a_bytes = a_box_bytes(bw);
      for (int dt = 0; dt < 3; ++dt)
        for (int c = 0; c < slices; ++c)
          for (int dw = 0; dw < 3; ++dw) {
            ring.load_box(&tm_x, b * (T_out + 2) + to + dt, c, dw, h0, w0,
                          a_bytes);
            for (int dh = 0; dh < 3; ++dh)
              ring.load_weights(&tm_w, 9 * dt + 3 * dh + dw, c, n0);
          }
    }
  } else {
    // ---------------------------------------------------------- consumers
    reg_alloc<232>();
    const int wgc = (threadIdx.x - 128) >> 7;
    float acc[1][2][BN / 2];
    init_set<BN>(acc[0], bias, n0);
    consume<T, BN, 1>(acc, ring, 9 * slices, wgc * 128 * 128, bw * 128,
                      (threadIdx.x & 31) == 0);
    store_tile<T, BN>(acc[0], out, (long long)b * T_out + to, h0, w0, n0, H,
                      W, Cout, bw_log2, wgc * 128);
  }
}

template <typename T, int BN>
cudaError_t launch(const void* xp, const void* wt, const float* bias,
                   void* out, int B, int T_out, int H, int W, int Cin,
                   int Cout, int bw, cudaStream_t stream) {
  CUtensorMap tm_x, tm_w;
  if (!encode_maps<T>(&tm_x, &tm_w, xp, wt, B, T_out, H, W, Cin, Cout, bw,
                      BN))
    return cudaErrorInvalidValue;
  auto kern = conv3d_s1_kernel<T, BN>;
  const int smem = Smem<BN>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int bh = M / bw;
  const int tiles_w = (W + bw - 1) / bw, tiles_h = (H + bh - 1) / bh;
  dim3 grid(Cout / BN, tiles_h * tiles_w, B * T_out);
  kern<<<grid, THREADS, smem, stream>>>(
      tm_x, tm_w, bias, static_cast<T*>(out), T_out, H, W, Cin, Cout,
      log2_bw(bw), tiles_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bn(const void* xp, const void* wt, const float* bias,
                      void* out, int B, int T_out, int H, int W, int Cin,
                      int Cout, int bw, int bn, cudaStream_t stream) {
  if (bn == 128)
    return launch<T, 128>(xp, wt, bias, out, B, T_out, H, W, Cin, Cout, bw,
                          stream);
  return launch<T, 64>(xp, wt, bias, out, B, T_out, H, W, Cin, Cout, bw,
                       stream);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. bias (fp32, [Cout]) may be null. bw: the
// pixel tile's width, 8, 16 or 32 (its height is 256 / bw); bn: the output
// channels a block, 128 or 64. Requires Cin % 64 == 0 and Cout % bn == 0.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// refused shape or tensor map).
extern "C" int hv_conv3d_stride1(int dtype, const void* xp, const void* wt,
                                 const float* bias, void* out, int B,
                                 int T_out, int H, int W, int Cin, int Cout,
                                 int bw, int bn, void* stream) {
  if (Cin % BC != 0 || (bn != 128 && bn != 64) || Cout % bn != 0 ||
      T_out < 1 || log2_bw(bw) < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bn<__nv_bfloat16>(xp, wt, bias, out, B, T_out, H, W, Cin,
                                    Cout, bw, bn, st);
  if (dtype == 1)
    return launch_bn<__half>(xp, wt, bias, out, B, T_out, H, W, Cin, Cout,
                             bw, bn, st);
  return cudaErrorInvalidValue;
}
