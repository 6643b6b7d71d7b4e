// W8A8 linear: y = act(s32(quant(x) . W8^T) * sx * scale_out + bias).
//
// Replaces the Pallas TPU kernel ops/int8_matmul.py:_w8a8_kernel of the JAX
// package (and the XLA body models/dit.py:_int8_linear_body it shares its
// numerics with):
//   * per row of x: amax = max|x| in the input type, sx = max(amax, 1e-8) *
//     (1/127), codes round(x_f32 / sx) with ties to even (a division, as
//     the TPU kernel);
//   * s8 x s8 -> s32 on the tensor cores (mma.sync m16n8k32), exact: at
//     most 127^2 * 15360 < 2^31;
//   * epilogue on fp32: y = s32 * sx * scale_out (+ bias), the activation
//     (none, gelu, gelu_tanh, relu, silu), one store in the input type.
// The weight is the nn.Linear layout [N, K] int8 with a row stride (column
// slices of a fused projection need no copy), which is exactly the "col"
// operand of the mma; scale_out [N] and bias [N] are fp32.
//
// Bound on the H100: 2*M*N*K int8 operations at 1,979 TOP/s against the
// bytes of x, W, y at 3.35 TB/s: the token-sized projections (thousands of
// rows) are bound by operations, the modulation matvecs (2 rows) by the
// weight read. This first design: quant_rows_kernel writes the int8 codes
// and row scales (the TPU kernel kept them in VMEM for its L tile; a
// Hopper block cannot hold a 128 x 3072 bf16 row tile), then a block of 8
// warps computes a 128 x 128 output tile through a 3-stage cp.async ring
// of 128 x 64-byte A and B tiles; ragged rows are zero-filled on load and
// not stored. The fp32 epilogue uses round-to-nearest intrinsics so that
// it is the plain version's arithmetic exactly (no fused multiply-add).
// Not yet done: wgmma, TMA, a persistent grid, split-K for the matvecs.
#include "mma.cuh"

namespace {

constexpr int BM = 128, BN = 128;  // output tile
constexpr int BKB = 64;            // K step (bytes = int8 values)
constexpr int LDS = BKB + 16;      // padded smem row: conflict-free loads
constexpr int STAGES = 3;
constexpr int THREADS = 256;       // 8 warps: 2 (M) x 4 (N), 64 x 32 each
constexpr int QUANT_THREADS = 128;

enum Act { kNone = 0, kGelu = 1, kGeluTanh = 2, kRelu = 3, kSilu = 4 };

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

// Row r of x [M, K] -> codes xq [M, K] int8 and scale sx[r].
template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
quant_rows_kernel(const T* __restrict__ x, long long x_rs,
                  int8_t* __restrict__ xq, float* __restrict__ sx, int K) {
  const T* xr = x + blockIdx.x * x_rs;
  int8_t* qr = xq + (long long)blockIdx.x * K;
  float m = 0.f;
  for (int c = threadIdx.x * 8; c < K; c += QUANT_THREADS * 8)
    m = hv::absmax8<T>(*reinterpret_cast<const uint4*>(xr + c), m);
  const float s = fmaxf(hv::block_max(m), 1e-8f) * (float)(1.0 / 127.0);
  for (int c = threadIdx.x * 8; c < K; c += QUANT_THREADS * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const T* e = reinterpret_cast<const T*>(&v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = max(-127, min(127, __float2int_rn(
                                           __fdiv_rn(hv::to_f32(e[j]), s))));
      w[j >> 2] |= (uint32_t)(q & 0xff) << (8 * (j & 3));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(w[0], w[1]);
  }
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
w8a8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const int8_t* __restrict__ w, long long w_rs,
                 const float* __restrict__ so, const float* __restrict__ bias,
                 T* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGE = (BM + BN) * LDS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = K / BKB;

  auto load_stage = [&](int stage, int kt) {
    unsigned char* As = smem + stage * STAGE;
    unsigned char* Bs = As + BM * LDS;
    const int k0 = kt * BKB;
#pragma unroll
    for (int i = tid; i < BM * (BKB / 16); i += THREADS) {
      const int r = i / (BKB / 16), c = (i % (BKB / 16)) * 16;
      const bool ok = m0 + r < M;  // ragged rows: zero-filled
      cp_async16(As + r * LDS + c,
                 xq + (long long)(ok ? m0 + r : 0) * K + k0 + c, ok);
    }
#pragma unroll
    for (int i = tid; i < BN * (BKB / 16); i += THREADS) {
      const int r = i / (BKB / 16), c = (i % (BKB / 16)) * 16;
      cp_async16(Bs + r * LDS + c, w + (long long)(n0 + r) * w_rs + k0 + c,
                 true);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 is free for reuse
    if (kt + STAGES - 1 < nk)
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const unsigned char* As = smem + (kt % STAGES) * STAGE;
    const unsigned char* Bs = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BKB; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned char* a0 = As + (wm * 64 + mt * 16 + g) * LDS + kk;
        af[mt][0] = hv::ld32(a0 + 4 * t);
        af[mt][1] = hv::ld32(a0 + 8 * LDS + 4 * t);
        af[mt][2] = hv::ld32(a0 + 16 + 4 * t);
        af[mt][3] = hv::ld32(a0 + 8 * LDS + 16 + 4 * t);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned char* b0 = Bs + (wn * 32 + nt * 8 + g) * LDS + kk;
        bf[nt][0] = hv::ld32(b0 + 4 * t);
        bf[nt][1] = hv::ld32(b0 + 16 + 4 * t);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) hv::mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * i;
      if (row >= M) continue;
      const float sr = sx[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          y[j] = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * i + j], sr),
                           so[col + j]);
          if (bias != nullptr) y[j] = __fadd_rn(y[j], bias[col + j]);
          y[j] = activate<ACT>(y[j]);
        }
        *reinterpret_cast<uint32_t*>(out + (long long)row * N + col) =
            hv::pack2(y[0], y[1], T());
      }
    }
}

template <typename T, int ACT>
cudaError_t launch(const void* x, long long x_rs, const int8_t* w,
                   long long w_rs, const float* so, const float* bias,
                   void* out, int8_t* xq, float* sx, int M, int N, int K,
                   cudaStream_t stream) {
  quant_rows_kernel<T><<<M, QUANT_THREADS, 0, stream>>>(
      static_cast<const T*>(x), x_rs, xq, sx, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = w8a8_gemm_kernel<T, ACT>;
  constexpr int smem = STAGES * (BM + BN) * LDS;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(xq, sx, w, w_rs, so, bias,
                                        static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_act(int act, const void* x, long long x_rs,
                         const int8_t* w, long long w_rs, const float* so,
                         const float* bias, void* out, int8_t* xq, float* sx,
                         int M, int N, int K, cudaStream_t st) {
  switch (act) {
    case kNone:
      return launch<T, kNone>(x, x_rs, w, w_rs, so, bias, out, xq, sx, M, N,
                              K, st);
    case kGelu:
      return launch<T, kGelu>(x, x_rs, w, w_rs, so, bias, out, xq, sx, M, N,
                              K, st);
    case kGeluTanh:
      return launch<T, kGeluTanh>(x, x_rs, w, w_rs, so, bias, out, xq, sx, M,
                                  N, K, st);
    case kRelu:
      return launch<T, kRelu>(x, x_rs, w, w_rs, so, bias, out, xq, sx, M, N,
                              K, st);
    case kSilu:
      return launch<T, kSilu>(x, x_rs, w, w_rs, so, bias, out, xq, sx, M, N,
                              K, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16 (x and out). act: 0 none, 1 gelu, 2 gelu_tanh,
// 3 relu, 4 silu. x [M, K] with row stride x_rs (elements), w [N, K] int8
// with row stride w_rs (bytes), scale_out [N] fp32, bias [N] fp32 or null,
// out [M, N] contiguous; scratch xq [M, K] int8 and sx [M] fp32. N a
// multiple of 128, K of 64, x/w rows 16-byte aligned. Returns the
// cudaError_t of the launches.
extern "C" int hv_w8a8_linear(int dtype, int act, const void* x,
                              long long x_rs, const int8_t* w, long long w_rs,
                              const float* scale_out, const float* bias,
                              void* out, int8_t* xq, float* sx, int M, int N,
                              int K, void* stream) {
  if (N % BN != 0 || K % BKB != 0 || M <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_act<__nv_bfloat16>(act, x, x_rs, w, w_rs, scale_out,
                                       bias, out, xq, sx, M, N, K, st);
  if (dtype == 1)
    return dispatch_act<__half>(act, x, x_rs, w, w_rs, scale_out, bias, out,
                                xq, sx, M, N, K, st);
  return cudaErrorInvalidValue;
}
