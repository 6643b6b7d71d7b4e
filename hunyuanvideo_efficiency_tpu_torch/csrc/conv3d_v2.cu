// Implicit-GEMM stride-1 3x3x3 convolution over a pre-padded NDHWC input,
// with temporal reuse: each block sweeps T and reads every input frame of
// its pixel tile once.
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
// block, which stages the kt = 3 input frames it needs: each input frame of
// a (b, pixel tile, Cout block) is read from device memory three times. The
// TPU kernel put T innermost in its grid and kept a circular buffer of the
// kt most recent widened frames, fetching one new frame a step. Here one
// block owns a (b, 8 x 16 pixel tile, 64 output channels) and loops over the
// T + 2 input frames itself, with rolling output accumulators (the scatter
// form of that reuse): input frame tin, staged once per 32-channel slice,
// feeds the output frames tin, tin - 1 and tin - 2 (temporal taps 0, 1 and
// 2), each in its own fp32 accumulator set; after frame tin the set of
// output tin - 2 holds all 27 taps and is stored, and the sets shift by one.
// So each input frame is read once a sweep. Why this and not a ring of the
// 3 most recent input planes in shared memory: a plane is (8+2) x (16+2) x
// Cin x 2 B, 46 KB at Cin = 128 and 184 KB at 512, so a ring of three would
// need a pixel tile per channel count; the accumulators cost registers
// instead, the same at every Cin: 3 sets x 32 fp32 a thread at 64 output
// channels (half of K3's 128, to stay under the register file). Two blocks
// an SM would cap a thread at 128 registers and spill the sets, so the
// kernel runs one block of 8 warps an SM. Sweeping T inside the block also
// leaves fewer blocks than K3 has (no block per output frame): a short,
// narrow stage fills only part of the card.
// The edges: T = 1, 2 and 3 work as any other T (outputs that do not exist
// get no taps and are never stored); ragged H and W tiles are masked as in
// K3. Edge-replicate padding is the caller's, as in K3.
//
// Bound on the H100: 2*27*Cin*Cout*B*T*H*W operations on the tensor cores
// (989 TFLOP/s fp16 dense) against one read of xp and one write of out:
// bound by operations, as K3. Not yet done: wgmma, TMA, a cp.async ring so
// the next slice loads while this one computes.
#include "mma.cuh"

namespace {

constexpr int BH = 8, BW = 16;  // output pixels per block: 8 rows x 16 cols
constexpr int BN = 64;          // output channels per block
constexpr int BC = 32;          // input channels per staged slice
constexpr int KT = 3;           // temporal taps
constexpr int SH = BH + 2, SW = BW + 2;
constexpr int SP = BC + 8;      // padded channel stride in shared memory
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3d_v2_kernel(const T* __restrict__ xp, const T* __restrict__ wt,
                 const float* __restrict__ bias, T* __restrict__ out,
                 int T_out, int H, int W, int Cin, int Cout, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);  // [SH * SW][SP]
  T* ws = slab + SH * SW * SP;               // [9][BN][SP], one temporal tap

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // warp tile: 32 pixels x 32 ch
  const int h0 = (blockIdx.x / tiles_w) * BH, w0 = (blockIdx.x % tiles_w) * BW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
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

  // acc[j]: output frame tin - j, which has received taps 0..j so far
  float acc[KT][2][4][4];
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        acc[j][mi][ni][0] = acc[j][mi][ni][1] = acc[j][mi][ni][2] =
            acc[j][mi][ni][3] = 0.f;

  for (int tin = 0; tin < Tp; ++tin) {
    const T* xf = xp + ((long long)b * Tp + tin) * Hp * Wp * Cin;
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
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        const int to = tin - dt;
        if (to < 0 || to >= T_out) continue;  // uniform: no such output
        __syncthreads();  // every warp is done with the previous tap's ws
        const T* wf = wt + (long long)dt * 9 * Cout * Cin;
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
            for (int ni = 0; ni < 4; ++ni) {
              const T* wrow = wtap + (wn * 32 + ni * 8 + g) * SP + kc;
              uint32_t bf[2] = {hv::ld32(wrow), hv::ld32(wrow + 8)};
              hv::mma16816(acc[dt][0][ni], a[0], bf, T());
              hv::mma16816(acc[dt][1][ni], a[1], bf, T());
            }
          }
        }
      }
    }

    if (tin >= KT - 1) {  // output frame tin - 2 has all 27 taps: store it
      const int to = tin - (KT - 1);
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
          for (int ni = 0; ni < 4; ++ni) {
            const int n = wn * 32 + ni * 8 + 2 * t;
            const float b0 = bias ? bias[n0 + n] : 0.f;
            const float b1 = bias ? bias[n0 + n + 1] : 0.f;
            *reinterpret_cast<uint32_t*>(orow + n) = hv::pack2(
                acc[KT - 1][mi][ni][2 * hf] + b0,
                acc[KT - 1][mi][ni][2 * hf + 1] + b1, T());
          }
        }
    }
    // shift: output tin - 1 becomes tin' - 2 of the next frame, and so on
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2][mi][ni][e] = acc[1][mi][ni][e];
          acc[1][mi][ni][e] = acc[0][mi][ni][e];
          acc[0][mi][ni][e] = 0.f;
        }
  }
}

template <typename T>
cudaError_t launch(const void* xp, const void* wt, const float* bias,
                   void* out, int B, int T_out, int H, int W, int Cin,
                   int Cout, cudaStream_t stream) {
  auto kern = conv3d_v2_kernel<T>;
  const int smem = (SH * SW * SP + 9 * BN * SP) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + BW - 1) / BW, tiles_h = (H + BH - 1) / BH;
  dim3 grid(tiles_h * tiles_w, Cout / BN, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wt), bias,
      static_cast<T*>(out), T_out, H, W, Cin, Cout, tiles_w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. bias (fp32, [Cout]) may be null. Requires
// Cin % 32 == 0 and Cout % 64 == 0. Returns the cudaError_t of the launch.
extern "C" int hv_conv3d_stride1_v2(int dtype, const void* xp, const void* wt,
                                    const float* bias, void* out, int B,
                                    int T_out, int H, int W, int Cin,
                                    int Cout, void* stream) {
  if (Cin % BC != 0 || Cout % BN != 0 || T_out < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(xp, wt, bias, out, B, T_out, H, W, Cin,
                                 Cout, st);
  if (dtype == 1)
    return launch<__half>(xp, wt, bias, out, B, T_out, H, W, Cin, Cout, st);
  return cudaErrorInvalidValue;
}
