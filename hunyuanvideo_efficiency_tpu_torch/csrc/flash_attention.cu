// Flash attention forward over the MM-DiT joint [img | txt] sequence, for
// Hopper (sm_90a): wgmma products fed by a TMA ring.
//
// Replaces three Pallas TPU kernels of the JAX package, as one source with
// template flags:
//   RUNNING = false: ops/flash_attention.py:_flash_nomax_kernel (:122), the
//     softmax with a static per-(batch, head) exponent offset C (no running
//     max):  p = exp(s*scale + (kb - C)),  l += sum(p),  acc += p.V
//   RUNNING = true:  ops/flash_attention.py:_flash_kernel (:38), the classic
//     online softmax with a running row max m and rescale exp(m_old - m_new).
//   RUNNING = true, LSE = true: ops/flash_backward.py:_fwd_kernel (:40), the
//     training forward: the running-max kernel that also writes the row
//     log-sum-exp lse = m + log(max(l, 1e-37)) as [B, H, Sq] fp32, from which
//     the backward kernels (flash_backward.cu) recompute the probabilities.
// All finish with out = acc / max(l, 1e-37); without LSE they can write the
// partial-softmax state (m, l) as [B, Sq, H] fp32 (m = C for the static
// kernel).
//
// Layout: q/k/v are [B, S, H*D] with each head a column slice (row and
// batch strides are arguments; v may be a column view of a fused
// projection), the key bias kb is [B, Sk] fp32 with entries <= 0, C is
// [B, H] fp32. Numerics kept from the TPU kernels: Q.K^T in the input type
// with fp32 accumulation; p rounded to V's type before P.V; fp32 l and acc.
// The exponentials are exp2 with log2(e) folded into the scale and the bias
// (m is kept in log2 units and converted back for the state and the lse).
//
// Bound on the H100: 4*B*H*Sq*Sk*D tensor-core operations (989 TFLOP/s bf16
// dense); at the main path's lengths that is far above the bytes of
// q/k/v/out, so the kernel is bound by operations.
//
// Design. A block of three warpgroups owns BM = 128 query rows of one
// (b, h): warpgroup 0 is the producer (one warp issues TMA loads, its
// registers handed to the others with setmaxnreg), warpgroups 1 and 2 are
// consumers of 64 rows each. Against the causes that held the first,
// mma.sync design at 8% of the card's rate:
//   1. mma.sync only: both products are wgmma (m64n128k16), S = Q.K^T with
//      Q and K from shared memory (K-major), O += P.V with P from registers
//      (the S accumulator packed to T) and V from shared memory.
//   2. shared-memory traffic per flop: wgmma reads its operands from shared
//      memory once per warpgroup product, not per warp as 32-bit words, and
//      the tiles are 128 keys wide.
//   3. V transposed element by element: V is read as it lies, row-major over
//      keys, through the descriptor's transpose bit (MN-major B).
//   4. no copy overlapping compute: Q once, then K and V tiles of BN = 128
//      keys arrive by TMA (128-byte swizzle, matching the descriptors) into a
//      ring of STAGES = 3 slots with full/empty mbarriers, so the next tile's
//      copy runs under this tile's math. Within a warpgroup, tile j's
//      Q.K^T is issued together with tile j-1's P.V, and tile j's softmax
//      runs while that P.V is in flight (a slot is freed once its P.V is
//      done, hence the third slot). TMA's zero fill at the row bound
//      replaces manual masking; keys past Sk still get the -1e30 bias, which
//      the producer warp writes beside each tile; query rows past Sq are not
//      stored.
//   5. too few blocks for short query sets: the wrapper may split the key
//      range over `splits` blocks per query tile; each writes its unscaled
//      (acc, m, l) to fp32 scratch and flash_combine_kernel merges them with
//      the algebra of merge_flash_states (all parts share m = C in the
//      static kernel, so its weights are 1), including the state and lse.
#include "flash_wg.cuh"

namespace {

using namespace hv::flash;

// Shared memory, byte offsets from a 1024-aligned base. A tile of R rows is
// D/64 TMA boxes of [R][64] (128-byte rows, swizzled), one after another.
template <int D>
struct Smem {
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;                 // [STAGES] K tiles
  static constexpr int V = K + STAGES * KV_BYTES;       // [STAGES] V tiles
  static constexpr int BIAS = V + STAGES * KV_BYTES;    // [STAGES][BN] fp32
  static constexpr int BAR = BIAS + STAGES * BN * 4;    // q, full[], empty[]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;            // base alignment
};

template <typename T, int D, bool RUNNING, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 T* __restrict__ o, const float* __restrict__ kb,
                 const float* __restrict__ cb, float* __restrict__ m_out,
                 float* __restrict__ l_out, float* __restrict__ lse_out,
                 float* __restrict__ part, int H, int Sq, int Sk, int splits,
                 float scale) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* bias_s = reinterpret_cast<float*>(sm + L::BIAS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int B = gridDim.z;
  const int qt = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * BM;
  const int n_tiles = (Sk + BN - 1) / BN;
  const int t0 = (int)((long long)sp * n_tiles / splits);
  const int n_it = (int)((long long)(sp + 1) * n_tiles / splits) - t0;
  const float c_off = RUNNING ? 0.f : cb[b * H + h];

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);               // the producer warp's lanes
      mbar_init(&empty[s], CONSUMER_WARPS);  // one lane of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    reg_dealloc<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* kbb = kb ? kb + (long long)b * Sk : nullptr;
      if (lane == 0) {
        mbar_arrive_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(sm + L::Q + c * BM * 128, &tm_q, q_full, h * D + 64 * c,
                      q0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int k0 = (t0 + it) * BN;
        // the tile's bias in log2 units, less the static offset
        for (int i = lane; i < BN; i += 32) {
          const int key = k0 + i;
          const float x = key < Sk ? (kbb ? kbb[key] : 0.f) : NEG_INF;
          bias_s[s * BN + i] = (x - c_off) * LOG2E;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_3d(sm + L::K + s * L::KV_BYTES + c * BN * 128, &tm_k,
                        &full[s], h * D + 64 * c, k0, b);
            tma_load_3d(sm + L::V + s * L::KV_BYTES + c * BN * 128, &tm_v,
                        &full[s], h * D + 64 * c, k0, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    reg_alloc<232>();
    const int ct = threadIdx.x - 128;
    const int wgc = ct >> 7;                 // consumer warpgroup: 0 or 1
    const int warp = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const float sl2 = scale * LOG2E;
    const uint32_t q_addr = smem_u32(sm + L::Q) + wgc * 64 * 128;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_r[2] = {NEG_INF * LOG2E, NEG_INF * LOG2E};  // log2 units
    float l_r[2] = {0.f, 0.f};  // this thread's part of the row sums
    uint32_t pa[BN / 16][4];    // P of the previous tile, T in A layout

    mbar_wait(q_full, 0);
    const uint32_t k_base = smem_u32(sm + L::K);
    const uint32_t v_base = smem_u32(sm + L::V);
    float corr[2];
    // Tile it's S = Q.K^T is issued together with tile it-1's P.V, so that
    // tile it's softmax runs under that product. The first tile is peeled
    // off, so that every wait in the loop is unconditional (ptxas then
    // keeps the products asynchronous).
    if (n_it > 0) {
      mbar_wait(&full[0], 0);
      __syncwarp();  // converged for the .aligned wgmma instructions
      float sc[64];
      wgmma_fence();
      issue_qk<T, D>(sc, q_addr, k_base);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile<RUNNING>(sc, bias_s, sl2, t, m_r, l_r, corr);
      pack_p<T>(sc, pa);
    }
    for (int it = 1; it < n_it; ++it) {
      const int s = it % STAGES;
      const int s_prev = (it - 1) % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      __syncwarp();
      float sc[64];
      wgmma_fence();
      issue_qk<T, D>(sc, q_addr, k_base + s * L::KV_BYTES);
      issue_pv<T, D>(acc, pa, v_base + s_prev * L::KV_BYTES);
      wgmma_wait<1>();  // S is done; the previous P.V may still run
      fence_regs(sc);
      softmax_tile<RUNNING>(sc, bias_s + s * BN, sl2, t, m_r, l_r, corr);
      wgmma_wait<0>();  // the previous tile's P.V is done
      fence_regs(acc);
      fence_pa(pa);
      if (lane == 0) mbar_arrive(&empty[s_prev]);
      if (RUNNING) rescale<D>(acc, corr);
      pack_p<T>(sc, pa);
    }
    if (n_it > 0) {  // the last tile's P.V
      wgmma_fence();
      issue_pv<T, D>(acc, pa, v_base + ((n_it - 1) % STAGES) * L::KV_BYTES);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_pa(pa);
    }

    // epilogue: rows r0 and r0 + 8 of this thread
    const int r0 = q0 + wgc * 64 + warp * 16 + g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[i] = quad_sum(l_r[i]);
      const int r = r0 + 8 * i;
      if (r >= Sq) continue;
      const float m_nat = RUNNING ? m_r[i] * LN2 : c_off;
      if (splits > 1) {
        const long long plane = (long long)B * H * Sq;
        const long long row = ((long long)sp * B * H + (long long)b * H + h) *
                                  Sq + r;
        float* po = part + row * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(po + 8 * j + 2 * t) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        if (t == 0) {
          part[splits * plane * D + row] = m_nat;
          part[splits * plane * (D + 1) + row] = l_r[i];
        }
        continue;
      }
      const float denom = fmaxf(l_r[i], 1e-37f);
      const float inv = 1.f / denom;
      T* orow = o + ((long long)b * Sq + r) * H * D + (long long)h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            hv::pack2(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv,
                      T());
      if (t == 0) {
        if (LSE) {
          lse_out[((long long)b * H + h) * Sq + r] = m_nat + logf(denom);
        } else if (m_out != nullptr) {
          const long long idx = ((long long)b * Sq + r) * H + h;
          m_out[idx] = m_nat;
          l_out[idx] = l_r[i];
        }
      }
    }
  }
}

// Merges the `splits` partial states of the key-range split: one warp a
// (b, h, row), each lane D/32 columns. part holds acc [splits][B*H*Sq][D],
// then m and l [splits][B*H*Sq] (m in natural units).
template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(128)
flash_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ lse_out, int B, int H, int Sq,
                     int splits) {
  constexpr int E = D / 32;
  const long long plane = (long long)B * H * Sq;
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= plane) return;
  const int lane = threadIdx.x & 31;
  const int r = (int)(row % Sq);
  const int h = (int)((row / Sq) % H), b = (int)(row / ((long long)Sq * H));
  const float* pm = part + splits * plane * D;
  const float* pl = pm + splits * plane;
  float mx = -3.0e38f;
  for (int p = 0; p < splits; ++p) mx = fmaxf(mx, pm[p * plane + row]);
  float l = 0.f, a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = 0.f;
  for (int p = 0; p < splits; ++p) {
    const float w = expf(pm[p * plane + row] - mx);
    l += w * pl[p * plane + row];
    const float* src = part + (p * plane + row) * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] += w * src[e];
  }
  const float denom = fmaxf(l, 1e-37f);
  T* dst = o + ((long long)b * Sq + r) * H * D + (long long)h * D + lane * E;
#pragma unroll
  for (int e = 0; e < E; e += 2)
    *reinterpret_cast<uint32_t*>(dst + e) =
        hv::pack2(a[e] / denom, a[e + 1] / denom, T());
  if (lane == 0) {
    if (LSE) {
      lse_out[row] = mx + logf(denom);
    } else if (m_out != nullptr) {
      const long long idx = ((long long)b * Sq + r) * H + h;
      m_out[idx] = mx;
      l_out[idx] = l;
    }
  }
}

template <typename T, int D, bool RUNNING, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const float* kb, const float* c, float* m_out,
                   float* l_out, float* lse_out, float* part, int splits,
                   int B, int H, int Sq, int Sk, long long q_bs,
                   long long q_rs, long long k_bs, long long k_rs,
                   long long v_bs, long long v_rs, float scale,
                   cudaStream_t stream) {
  if (splits < 1 || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_rows<T>(&tq, q, H * D, Sq, B, q_rs, q_bs, BM) ||
      !encode_rows<T>(&tk, k, H * D, Sk, B, k_rs, k_bs, BN) ||
      !encode_rows<T>(&tv, v, H * D, Sk, B, v_rs, v_bs, BN))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_kernel<T, D, RUNNING, LSE>;
  const int smem = Smem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(((Sq + BM - 1) / BM) * splits, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), kb, c, m_out, l_out, lse_out, part, H,
      Sq, Sk, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long rows = (long long)B * H * Sq;
  flash_combine_kernel<T, D, LSE><<<(unsigned)((rows + 3) / 4), 128, 0,
                                    stream>>>(
      part, static_cast<T*>(o), m_out, l_out, lse_out, B, H, Sq, splits);
  return cudaGetLastError();
}

template <typename T, bool RUNNING, bool LSE = false>
cudaError_t dispatch_d(int head_dim, const void* q, const void* k,
                       const void* v, void* o, const float* kb,
                       const float* c, float* m_out, float* l_out,
                       float* lse_out, float* part, int splits, int B, int H,
                       int Sq, int Sk, long long q_bs, long long q_rs,
                       long long k_bs, long long k_rs, long long v_bs,
                       long long v_rs, float scale, cudaStream_t stream) {
  if (head_dim == 128)
    return launch<T, 128, RUNNING, LSE>(q, k, v, o, kb, c, m_out, l_out,
                                        lse_out, part, splits, B, H, Sq, Sk,
                                        q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                                        scale, stream);
  if (head_dim == 64)
    return launch<T, 64, RUNNING, LSE>(q, k, v, o, kb, c, m_out, l_out,
                                       lse_out, part, splits, B, H, Sq, Sk,
                                       q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                                       scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. running: 0 = static offset C, 1 = running max.
// kb, m_out and l_out may be null (no key bias / no state). splits > 1
// splits each query tile's keys over that many blocks, merged by a second
// launch; part is then fp32 scratch of splits * B * H * Sq * (D + 2)
// floats. Returns the cudaError_t of the launches.
extern "C" int hv_flash_attention_fwd(
    int dtype, int running, int head_dim, const void* q, const void* k,
    const void* v, void* o, const float* kb, const float* c, float* m_out,
    float* l_out, int B, int H, int Sq, int Sk, long long q_bs,
    long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, float scale, int splits, float* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && running == 0)
    return dispatch_d<__nv_bfloat16, false>(
        head_dim, q, k, v, o, kb, c, m_out, l_out, nullptr, part, splits, B,
        H, Sq, Sk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, st);
  if (dtype == 0 && running == 1)
    return dispatch_d<__nv_bfloat16, true>(
        head_dim, q, k, v, o, kb, c, m_out, l_out, nullptr, part, splits, B,
        H, Sq, Sk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, st);
  if (dtype == 1 && running == 0)
    return dispatch_d<__half, false>(
        head_dim, q, k, v, o, kb, c, m_out, l_out, nullptr, part, splits, B,
        H, Sq, Sk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, st);
  if (dtype == 1 && running == 1)
    return dispatch_d<__half, true>(
        head_dim, q, k, v, o, kb, c, m_out, l_out, nullptr, part, splits, B,
        H, Sq, Sk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, st);
  return cudaErrorInvalidValue;
}

// The training forward (running max, writes lse [B, H, Sq] fp32). dtype,
// head_dim, splits and part as above; kb may be null. Returns the
// cudaError_t of the launches.
extern "C" int hv_flash_fwd_lse(int dtype, int head_dim, const void* q,
                                const void* k, const void* v, void* o,
                                const float* kb, float* lse, int B, int H,
                                int Sq, int Sk, long long q_bs, long long q_rs,
                                long long k_bs, long long k_rs, long long v_bs,
                                long long v_rs, float scale, int splits,
                                float* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16, true, true>(
        head_dim, q, k, v, o, kb, nullptr, nullptr, nullptr, lse, part,
        splits, B, H, Sq, Sk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, st);
  if (dtype == 1)
    return dispatch_d<__half, true, true>(
        head_dim, q, k, v, o, kb, nullptr, nullptr, nullptr, lse, part,
        splits, B, H, Sq, Sk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, st);
  return cudaErrorInvalidValue;
}
