// Implicit-GEMM stride-1 3x3x3 convolution over a pre-padded NDHWC input,
// with temporal reuse, for Hopper (sm_90a): each block sweeps T and brings
// every input frame of its pixel tile into shared memory once.
//
// Replaces the Pallas TPU kernel ops/conv3d_pallas.py:_conv_kernel_v2 of
// the JAX package. Same function and contract as conv3d.cu (K3):
//   out[b, t, h, w, :] = bias + sum_{dt,dh,dw,ci}
//                        xp[b, t+dt, h+dh, w+dw, ci] * w[dt, dh, dw, ci, :]
// xp [B, T+2, H+2, W+2, Cin], weights transposed by the wrapper to
// [3, 3, 3, Cout, Cin], out [B, T, H, W, Cout]; fp16 or bf16; fp32
// accumulation, bias added in fp32, one rounding to the output type.
//
// What differs from K3 is the schedule. K3 gives every output frame its own
// block, which loads the three input frames it needs: each input frame of a
// (b, pixel tile, Cout block) is read three times. The TPU kernel put T
// innermost in its grid and kept a circular buffer of the kt most recent
// widened frames (the gather form). Here one block owns a (b, 256-pixel
// tile, 64 output channels) and loops over the T + 2 input frames itself
// with rolling accumulators (the scatter form): each input box (frame tin,
// 64-channel slice, column tap dw) is loaded once by TMA and feeds the
// outputs tin, tin - 1 and tin - 2 (temporal taps 0, 1 and 2), each in its
// own fp32 accumulator set, through the main loop of conv3d_tile.cuh (9
// weight tiles a box: 3 temporal x 3 row taps). After frame tin the set of
// output tin - 2 holds all 27 taps and is stored, and the sets shift by
// one. The products of the ends' outputs that do not exist (-2, -1, T,
// T + 1) are computed and never stored, so that no product is conditional:
// 6 sets of 3 (T + 2), 3% of the work at T = 61.
// Why scatter and not gather: a consumer warpgroup holds 128 pixels; at
// BN = 64 a set costs 64 fp32 registers a thread, so three sets are 192 of
// the 240 a consumer gets (the producer keeps 24). That is tight: ptxas
// spills some addresses, and once (with the barriers as 64-bit pointers
// and the bias added at the store) it spilled accumulators while their
// products still ran, which gave wrong outputs and no error. The gather form needs the three most recent
// frames' boxes resident: 3 boxes x 36,864 B a frame and slice, 332 KB for
// one slice of three frames, over the 227 KB of shared memory. BN = 64
// rather than K3's 128 keeps three sets in registers; each box then feeds
// 27 products, so the block's input and weight bytes an operation (5.9e-3)
// are under K3's (6.8e-3) (conv3d_tile.cuh).
// The edges: T = 1, 2 and 3 work as any other T; ragged H and W tiles are
// zero-filled by TMA and masked at the store, as in K3. Edge-replicate
// padding is the caller's, as in K3.
//
// Bound on the H100: 2*27*Cin*Cout*B*T*H*W operations on the tensor cores
// (989 TFLOP/s fp16 dense) against one read of xp and one write of out:
// bound by operations, as K3.
#include "conv3d_tile.cuh"

namespace {

using namespace hv::sm90;
using namespace hv::conv;

constexpr int BN = 64;
constexpr int KT = 3;  // temporal taps

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_v2_kernel(const __grid_constant__ CUtensorMap tm_x,
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
  const int b = blockIdx.z, Tp = T_out + 2;
  const int slices = Cin / BC;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      const uint32_t a_bytes = a_box_bytes(bw);
      for (int tin = 0; tin < Tp; ++tin)
        for (int c = 0; c < slices; ++c)
          for (int dw = 0; dw < 3; ++dw) {
            ring.load_box(&tm_x, b * Tp + tin, c, dw, h0, w0, a_bytes);
            for (int dt = 0; dt < KT; ++dt)
              for (int dh = 0; dh < 3; ++dh)
                ring.load_weights(&tm_w, 9 * dt + 3 * dh + dw, c, n0);
          }
    }
  } else {
    // ---------------------------------------------------------- consumers
    reg_alloc<240>();
    const int wgc = (threadIdx.x - 128) >> 7;
    // acc[j]: output frame tin - j, which has received taps 0..j so far
    float acc[KT][2][BN / 2];
#pragma unroll
    for (int j = 0; j < KT; ++j) init_set<BN>(acc[j], bias, n0);
#pragma unroll 1
    for (int tin = 0; tin < Tp; ++tin) {
      consume<T, BN, KT>(acc, ring, 3 * slices, wgc * 128 * 128, bw * 128,
                         (threadIdx.x & 31) == 0);
      if (tin >= KT - 1)  // output frame tin - 2 has all 27 taps: store it
        store_tile<T, BN>(acc[KT - 1], out,
                          (long long)b * T_out + tin - (KT - 1), h0, w0, n0,
                          H, W, Cout, bw_log2, wgc * 128);
      // shift: output tin - 1 becomes tin' - 2 of the next frame, and so on
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          acc[2][mi][i] = acc[1][mi][i];
          acc[1][mi][i] = acc[0][mi][i];
        }
      init_set<BN>(acc[0], bias, n0);
    }
  }
}

template <typename T>
cudaError_t launch(const void* xp, const void* wt, const float* bias,
                   void* out, int B, int T_out, int H, int W, int Cin,
                   int Cout, int bw, cudaStream_t stream) {
  CUtensorMap tm_x, tm_w;
  if (!encode_maps<T>(&tm_x, &tm_w, xp, wt, B, T_out, H, W, Cin, Cout, bw,
                      BN))
    return cudaErrorInvalidValue;
  auto kern = conv3d_v2_kernel<T>;
  const int smem = Smem<BN>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int bh = M / bw;
  const int tiles_w = (W + bw - 1) / bw, tiles_h = (H + bh - 1) / bh;
  dim3 grid(Cout / BN, tiles_h * tiles_w, B);
  kern<<<grid, THREADS, smem, stream>>>(
      tm_x, tm_w, bias, static_cast<T*>(out), T_out, H, W, Cin, Cout,
      log2_bw(bw), tiles_w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. bias (fp32, [Cout]) may be null. bw: the
// pixel tile's width, 8, 16 or 32 (its height is 256 / bw). Requires
// Cin % 64 == 0 and Cout % 64 == 0. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a refused shape or tensor map).
extern "C" int hv_conv3d_stride1_v2(int dtype, const void* xp, const void* wt,
                                    const float* bias, void* out, int B,
                                    int T_out, int H, int W, int Cin,
                                    int Cout, int bw, void* stream) {
  if (Cin % BC != 0 || Cout % BN != 0 || T_out < 1 || log2_bw(bw) < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(xp, wt, bias, out, B, T_out, H, W, Cin,
                                 Cout, bw, st);
  if (dtype == 1)
    return launch<__half>(xp, wt, bias, out, B, T_out, H, W, Cin, Cout, bw,
                          st);
  return cudaErrorInvalidValue;
}
