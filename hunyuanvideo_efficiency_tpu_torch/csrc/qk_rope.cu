// QK-RMSNorm + interleaved 3-axis RoPE of the DiT's q and k, for Hopper
// (sm_90a): one pass over both tensors.
//
// Replaces no Pallas kernel: on the TPU, XLA fused the JAX package's
// ops/norms.py:rms_norm and ops/rope.py:apply_rotary_emb into the
// projection's consumers. In the port the same composition was plain
// PyTorch (ops/norms.py:rms_norm, then ops/rope.py:rotate_tokens), some 20
// elementwise launches a q/k pair over fp32 copies of [B, S, H, D]; its
// span (`dit.qk_rope`) took ~1.1 s of a 540p denoise step, ~36x the bytes
// it has to move at the card's memory rate.
//
// Per row of D values (one token, one head) of q and of k, the plain
// path's arithmetic and rounding points:
//   * the mean of the squares in fp32 (each square rounded, then summed),
//     r = rsqrt(mean + eps), each value x * r rounded to the input type T;
//   * times the norm's weight (a product of two T values, exact in fp32,
//     rounded once to T), widened to fp32 again;
//   * where the token has a row in the (cos, sin) table: x * cos +
//     rotate_half(x) * sin with pairs (x0, x1) -> (-x1, x0), products and
//     sum rounded in fp32 (no fused multiply-add), rounded once to T;
//     tokens past the table's rows are only normalized.
// The sum of squares is taken in the order of PyTorch's own reduction
// (`sum_squares`), so on the card the kernel gives the plain path's bits.
//
// Bound on the H100: bytes. Every q/k value is read once and written once
// in T (4 bytes a value at bf16/fp16), plus the table's fp32 rows once a
// launch; there are ~10 operations a value, far under the card's rate.
//
// Design: a block per token, 256 threads. A row of D values is D / 8 lanes
// of one warp, 16 bytes a lane, so the interleaved pairs of a lane stay in
// its registers (rotate_half needs no shuffle) and the row's sum of squares
// is a butterfly of shuffles over those lanes, in PyTorch's order. A lane's
// columns are fixed over the block, so it loads its part of the token's cos
// and sin rows and of both weights once, and reuses them over the B x H
// rows of q and of k (96 rows at 540p with CFG). q and k are read through their own batch,
// token and head strides (the column views of a fused [B, S, 3*H*D]
// projection, no copy), each lane keeping two rows' loads in flight before
// it computes; the outputs are contiguous [B, S, H, D]. No shared memory:
// nothing is read twice from device memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;   // rows a lane loads before it computes

template <typename T>
struct Conv;
template <>
struct Conv<__nv_bfloat16> {
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 round(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <>
struct Conv<__half> {
  static __device__ __forceinline__ float widen(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half round(float v) {
    return __float2half_rn(v);
  }
};

// 8 values of T in 16 bytes <-> fp32
template <typename T>
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = Conv<T>::widen(e[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = Conv<T>::round(f[i]);
  return u;
}

// The row's sum of squares, each square rounded, summed in the order of
// PyTorch's CUDA reduction over a contiguous last axis (ATen's Reduce.cuh,
// as `x.square().mean(-1)` runs it): 32 threads a row, then a tree of warp
// shuffles at offsets 16, 8, 4, 2, 1. At D = 128 a thread holds 4
// consecutive values (vectorized loads), summed in turn; at D = 64 the
// values j and j + 32. Here a lane holds 8 consecutive values, so it
// stands for two such threads (D = 128) or its values meet their partners
// by shuffles (D = 64). Every lane returns the row's sum.
template <int D>
__device__ __forceinline__ float sum_squares(const float (&x)[8]) {
  float sq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sq[i] = __fmul_rn(x[i], x[i]);
  if constexpr (D == 128) {
    // the two threads' sums; the tree's offsets 16, 8, 4, 2 are lanes 8,
    // 4, 2, 1 away, its offset 1 the lane's own pair
    float a = __fadd_rn(__fadd_rn(__fadd_rn(sq[0], sq[1]), sq[2]), sq[3]);
    float b = __fadd_rn(__fadd_rn(__fadd_rn(sq[4], sq[5]), sq[6]), sq[7]);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
      b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
    }
    return __fadd_rn(a, b);
  } else {
    static_assert(D == 64, "head_dim 64 or 128");
    // thread j's value pair (j, j + 32) is 4 lanes away; the tree's
    // offsets 16, 8 are 2 and 1 lanes away, 4, 2, 1 within the lane
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sq[i] = __fadd_rn(sq[i], __shfl_xor_sync(0xffffffffu, sq[i], o));
    }
#pragma unroll
    for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
      for (int i = 0; i < w; ++i) sq[i] = __fadd_rn(sq[i], sq[i + w]);
    }
    return sq[0];
  }
}

struct QkRopeArgs {
  const void* q;
  const void* k;
  long long q_sb, q_ss, q_sh;   // element strides of batch, token, head
  long long k_sb, k_ss, k_sh;
  const void* wq;               // [D] of T, or null: no weight
  const void* wk;
  const float* cos;             // [n_table, D] fp32, contiguous
  const float* sin;
  void* oq;                     // [B, S, H, D] of T, contiguous
  void* ok;
  int n_table, B, S, H;
  float eps;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
qk_norm_rope_kernel(const QkRopeArgs a) {
  constexpr int kLanes = D / 8;                  // 16-byte lanes a row
  constexpr int kRowsPerPass = kThreads / kLanes;
  const int s = blockIdx.x;
  const int lane = threadIdx.x % kLanes;
  const int slot = threadIdx.x / kLanes;
  const int col = lane * 8;
  const int bh = a.B * a.H;
  const int n_rows = 2 * bh;                     // q's rows, then k's

  const bool rotate = s < a.n_table;
  float c[8], sn[8];
  if (rotate) {
    const float4* cp =
        reinterpret_cast<const float4*>(a.cos + (long long)s * D + col);
    const float4* sp =
        reinterpret_cast<const float4*>(a.sin + (long long)s * D + col);
    const float4 c0 = __ldg(cp), c1 = __ldg(cp + 1);
    const float4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
    c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
    c[4] = c1.x; c[5] = c1.y; c[6] = c1.z; c[7] = c1.w;
    sn[0] = s0.x; sn[1] = s0.y; sn[2] = s0.z; sn[3] = s0.w;
    sn[4] = s1.x; sn[5] = s1.y; sn[6] = s1.z; sn[7] = s1.w;
  }
  // this lane's columns of the weights, where there are weights
  float wq[8], wk[8];
  const bool has_wq = a.wq != nullptr, has_wk = a.wk != nullptr;
  if (has_wq)
    unpack8<T>(__ldg(reinterpret_cast<const uint4*>(
                   static_cast<const T*>(a.wq) + col)), wq);
  if (has_wk)
    unpack8<T>(__ldg(reinterpret_cast<const uint4*>(
                   static_cast<const T*>(a.wk) + col)), wk);
  const float inv_d = 1.f / D;                   // exact: D is 64 or 128

  // the trip count is the same for every thread of the block, so that all
  // lanes of a warp reach the shuffles
  for (int base = 0; base < n_rows; base += kRowsPerPass * kUnroll) {
    uint4 v[kUnroll];
    int which[kUnroll];
    long long dst[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * kRowsPerPass + slot;
      v[u] = make_uint4(0, 0, 0, 0);
      dst[u] = -1;
      which[u] = 0;
      if (r < n_rows) {
        const int t = r >= bh;
        const int rr = r - t * bh;
        const int b = rr / a.H, h = rr - b * a.H;
        const T* src = static_cast<const T*>(t ? a.k : a.q) + col +
                       (t ? b * a.k_sb + s * a.k_ss + h * a.k_sh
                          : b * a.q_sb + s * a.q_ss + h * a.q_sh);
        v[u] = __ldg(reinterpret_cast<const uint4*>(src));
        dst[u] = (((long long)b * a.S + s) * a.H + h) * D + col;
        which[u] = t;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[8];
      unpack8<T>(v[u], x);
      const float ss = sum_squares<D>(x);
      const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), a.eps));
      if (dst[u] < 0) continue;
      const int t = which[u];
      const bool has_w = t ? has_wk : has_wq;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float n = Conv<T>::widen(Conv<T>::round(__fmul_rn(x[i], r)));
        if (has_w) {  // a select of registers: i is known when compiled
          const float wi = t ? wk[i] : wq[i];
          n = Conv<T>::widen(Conv<T>::round(__fmul_rn(n, wi)));
        }
        x[i] = n;
      }
      if (rotate) {
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          const float x0 = x[i], x1 = x[i + 1];
          x[i] = __fadd_rn(__fmul_rn(x0, c[i]), __fmul_rn(-x1, sn[i]));
          x[i + 1] =
              __fadd_rn(__fmul_rn(x1, c[i + 1]), __fmul_rn(x0, sn[i + 1]));
        }
      }
      T* out = static_cast<T*>(t ? a.ok : a.oq) + dst[u];
      *reinterpret_cast<uint4*>(out) = pack8<T>(x);
    }
  }
}

template <typename T>
cudaError_t launch(int d, const QkRopeArgs& a, cudaStream_t st) {
  if (d == 128)
    qk_norm_rope_kernel<T, 128><<<a.S, kThreads, 0, st>>>(a);
  else if (d == 64)
    qk_norm_rope_kernel<T, 64><<<a.S, kThreads, 0, st>>>(a);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// q and k [B, S, H, D] of type dtype (0 = bf16, 1 = fp16) with element
// strides (sb, ss, sh) and unit stride over D, each a multiple of 8, the
// pointers 16-byte aligned; weights wq, wk [D] of the same type or null;
// cos and sin [n_table, D] fp32 contiguous (null when n_table is 0): tokens
// s < n_table are rotated by row s, the rest only normalized; outputs oq,
// ok contiguous [B, S, H, D]. D is 64 or 128. One launch on `stream`.
// Returns the cudaError_t of the launch.
extern "C" int hv_qk_norm_rope(int dtype, int d, const void* q, const void* k,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               const void* wq, const void* wk,
                               const float* cos, const float* sin,
                               int n_table, void* oq, void* ok, int B, int S,
                               int H, float eps, void* stream) {
  const long long strides[6] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh};
  for (long long v : strides)
    if (v % 8 != 0) return cudaErrorInvalidValue;
  const void* ptrs[8] = {q, k, wq, wk, cos, sin, oq, ok};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0 || n_table < 0 || !q || !k || !oq || !ok ||
      (n_table > 0 && (!cos || !sin)))
    return cudaErrorInvalidValue;
  const QkRopeArgs a{q,  k,  q_sb,    q_ss, q_sh, k_sb, k_ss, k_sh, wq, wk,
                     cos, sin, oq,    ok,   n_table, B,  S,  H,    eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(d, a, st);
  if (dtype == 1) return launch<__half>(d, a, st);
  return cudaErrorInvalidValue;
}
