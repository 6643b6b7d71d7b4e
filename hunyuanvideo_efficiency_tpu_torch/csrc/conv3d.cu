// Implicit-GEMM stride-1 3x3x3 convolution over a pre-padded NDHWC input.
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
// [3, 3, 3, Cout, Cin] (Cin contiguous: the mma B fragment), out
// [B, T, H, W, Cout]; fp16 (the VAE's precision) or bf16.
// Gate: Cin % 128 == 0 and Cout % 128 == 0, as the TPU gate. Its H % 8 and
// the W 8-alignment over-pad are dropped: this kernel masks the H and W
// edges of its tiles itself.
//
// Bound on the H100: 2*27*Cin*Cout*B*T*H*W operations on the tensor cores
// against one read of xp and one write of out; at the decoder's 128- to
// 512-channel stages that is hundreds of operations per byte, so the kernel
// is bound by operations (989 TFLOP/s fp16 dense). This first design: a
// block of 8 warps owns an output tile of 8 x 16 pixels of one (b, t) and
// 128 output channels (the GEMM's M = 128, N = 128). For each temporal tap
// and 32-channel slice of Cin it stages the (8+2) x (16+2) x 32 halo slab
// and the 9 spatial taps' weights in shared memory, then accumulates
// 9 taps x 32 channels with mma.sync m16n8k16 (fp32 accumulators in
// registers); the halo slab is read 9 times from shared memory, never
// again from device memory. Not yet done: wgmma, TMA, a double-buffered
// ring so the next slice loads while this one computes.
#include "mma.cuh"

namespace {

constexpr int BH = 8, BW = 16;  // output pixels per block: 8 rows x 16 cols
constexpr int BN = 128;         // output channels per block
constexpr int BC = 32;          // input channels per staged slice
constexpr int SH = BH + 2, SW = BW + 2;
constexpr int SP = BC + 8;      // padded channel stride in shared memory
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3d_s1_kernel(const T* __restrict__ xp, const T* __restrict__ wt,
                 const float* __restrict__ bias, T* __restrict__ out,
                 int T_out, int H, int W, int Cin, int Cout, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);  // [SH * SW][SP]
  T* ws = slab + SH * SW * SP;               // [9][BN][SP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // warp tile: 32 pixels x 64 ch
  const int h0 = (blockIdx.x / tiles_w) * BH, w0 = (blockIdx.x % tiles_w) * BW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z / T_out, to = blockIdx.z % T_out;
  const int Hp = H + 2, Wp = W + 2, Tp = T_out + 2;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  int pos[2][2];  // slab position of this thread's A rows (tap 0, 0)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wm * 32 + mi * 16 + g + 8 * hf;
      pos[mi][hf] = (m / BW) * SW + m % BW;
    }

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  for (int dt = 0; dt < 3; ++dt) {
    const T* xf = xp + ((long long)b * Tp + to + dt) * Hp * Wp * Cin;
    const T* wf = wt + (long long)dt * 9 * Cout * Cin;
    for (int c0 = 0; c0 < Cin; c0 += BC) {
      __syncthreads();  // every warp is done with the previous slice
      for (int i = tid; i < SH * SW * (BC / 8); i += THREADS) {
        const int p = i / (BC / 8), ch = (i % (BC / 8)) * 8;
        const int hh = h0 + p / SW, ww = w0 + p % SW;
        uint4 val = zero4;
        if (hh < Hp && ww < Wp)
          val = *reinterpret_cast<const uint4*>(
              xf + ((long long)hh * Wp + ww) * Cin + c0 + ch);
        *reinterpret_cast<uint4*>(slab + p * SP + ch) = val;
      }
      for (int i = tid; i < 9 * BN * (BC / 8); i += THREADS) {
        const int row = i / (BC / 8), ch = (i % (BC / 8)) * 8;
        const int tap = row / BN, n = row % BN;
        *reinterpret_cast<uint4*>(ws + row * SP + ch) =
            *reinterpret_cast<const uint4*>(
                wf + ((long long)tap * Cout + n0 + n) * Cin + c0 + ch);
      }
      __syncthreads();

#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * SW + tap % 3;
        const T* wtap = ws + tap * BN * SP;
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk) {
          const int kc = kk * 16 + 2 * t;
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const T* p0 = slab + (pos[mi][0] + off) * SP + kc;
            const T* p1 = slab + (pos[mi][1] + off) * SP + kc;
            a[mi][0] = hv::ld32(p0);
            a[mi][1] = hv::ld32(p1);
            a[mi][2] = hv::ld32(p0 + 8);
            a[mi][3] = hv::ld32(p1 + 8);
          }
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const T* wrow = wtap + (wn * 64 + ni * 8 + g) * SP + kc;
            uint32_t bf[2] = {hv::ld32(wrow), hv::ld32(wrow + 8)};
            hv::mma16816(acc[0][ni], a[0], bf, T());
            hv::mma16816(acc[1][ni], a[1], bf, T());
          }
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wm * 32 + mi * 16 + g + 8 * hf;
      const int hh = h0 + m / BW, ww = w0 + m % BW;
      if (hh >= H || ww >= W) continue;
      T* orow = out + (((long long)b * T_out + to) * H * W +
                       (long long)hh * W + ww) * Cout + n0;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = wn * 64 + ni * 8 + 2 * t;
        const float b0 = bias ? bias[n0 + n] : 0.f;
        const float b1 = bias ? bias[n0 + n + 1] : 0.f;
        *reinterpret_cast<uint32_t*>(orow + n) =
            hv::pack2(acc[mi][ni][2 * hf] + b0, acc[mi][ni][2 * hf + 1] + b1,
                      T());
      }
    }
}

template <typename T>
cudaError_t launch(const void* xp, const void* wt, const float* bias,
                   void* out, int B, int T_out, int H, int W, int Cin,
                   int Cout, cudaStream_t stream) {
  auto kern = conv3d_s1_kernel<T>;
  const int smem = (SH * SW * SP + 9 * BN * SP) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + BW - 1) / BW, tiles_h = (H + BH - 1) / BH;
  dim3 grid(tiles_h * tiles_w, Cout / BN, B * T_out);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wt), bias,
      static_cast<T*>(out), T_out, H, W, Cin, Cout, tiles_w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. bias (fp32, [Cout]) may be null. Requires
// Cin % 32 == 0 and Cout % 128 == 0. Returns the cudaError_t of the launch.
extern "C" int hv_conv3d_stride1(int dtype, const void* xp, const void* wt,
                                 const float* bias, void* out, int B,
                                 int T_out, int H, int W, int Cin, int Cout,
                                 void* stream) {
  if (Cin % BC != 0 || Cout % BN != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(xp, wt, bias, out, B, T_out, H, W, Cin,
                                 Cout, st);
  if (dtype == 1)
    return launch<__half>(xp, wt, bias, out, B, T_out, H, W, Cin, Cout, st);
  return cudaErrorInvalidValue;
}
