// Hopper (sm_90a) building blocks for the hand-written kernels: TMA tensor
// maps built on the host (16-bit operands and int8 codes), TMA tile loads
// into shared memory, mbarriers for a producer/consumer ring, named
// barriers, warpgroup register rebalancing, and the asynchronous warpgroup
// products (wgmma: bf16/fp16 and s8) with their shared-memory matrix
// descriptors.
//
// Shared-memory operands use the 128-byte swizzle that a TMA box of 64
// 16-bit columns (128 bytes a row) writes: rows of 128 bytes, 8-row atoms of
// 1024 bytes, the atom base 1024-byte aligned (int8 code tiles of 128
// columns are the same rows; those of 64 columns use the 64-byte swizzle:
// 64-byte rows, 8-row atoms of 512 bytes, layout 2). A wgmma descriptor
// (sm_90 GMMA descriptor: start address, leading and stride byte offsets,
// all >> 4; layout 1 = 128-byte swizzle in bits 62-63) reads such a tile
//   K-major (the contracted index runs along the 128-byte row): SBO = 1024
//     (the next 8 rows), LBO unused; a k16 step inside the row advances the
//     start address by 32 bytes;
//   MN-major (the transpose bit; the contracted index runs down the rows):
//     SBO = 1024 (the next 8 rows of the contracted index), LBO = the byte
//     distance to the next 64 columns (the next TMA box); a k16 step
//     advances the start address by 16 rows = 2048 bytes.
//
// wgmma accumulator layout (m64nN, fp32), thread = 32 * w + 4 * g + t of the
// warpgroup: d[4j + c] holds row 16w + g + 8 * (c >> 1), column
// 8j + 2t + (c & 1). The A fragment from registers (m64k16, 16-bit) is the
// mma.m16n8k16 A layout of each warp's 16 rows, so an accumulator becomes
// the next product's A operand by packing pairs (flash_attention.cu).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hv {
namespace sm90 {

// ---------------------------------------------------------------- host side

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime so
// that the library needs no -lcuda. Null if the driver lacks it.
inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tiled map of element type `dt` and swizzle `swizzle` (rank, dims,
// strides and box as cuTensorMapEncodeTiled takes them; elements past a
// dimension's end read as zero). Returns false if the driver refuses it.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType dt,
                       CUtensorMapSwizzle swizzle, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint64_t* byte_strides,
                       const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr || rank < 1 || rank > 5) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, dt, rank, const_cast<void*>(base), dims, byte_strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map over a 16-bit operand of `rank` dimensions (innermost first):
// `dims` elements each, `byte_strides` between consecutive entries of dims
// 1..rank-1, boxes of `box` elements (box[0] = 64 columns: 128-byte rows
// with the 128-byte swizzle). Entries past a dimension's end read as zero.
// Strides and the base must be 16-byte aligned. Returns false if
// cuTensorMapEncodeTiled refuses the map.
template <typename T>
bool encode_box(CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint64_t* byte_strides,
                const cuuint32_t* box) {
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_map(map, dt, CU_TENSOR_MAP_SWIZZLE_128B, base, rank, dims,
                    byte_strides, box);
}

// A 3-D map over a 16-bit operand addressed as (column, row, batch): `cols`
// contiguous elements a row, `rows` rows `row_stride` elements apart, and
// `batch` batches `batch_stride` elements apart. Boxes are 64 columns x
// `box_rows` rows; rows past `rows` read as zero.
template <typename T>
bool encode_rows(CUtensorMap* map, const void* base, int cols, int rows,
                 int batch, long long row_stride, long long batch_stride,
                 int box_rows) {
  if (batch == 1) batch_stride = row_stride * rows;  // unused, but valid
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * sizeof(T),
                                 (cuuint64_t)batch_stride * sizeof(T)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_box<T>(map, base, 3, dims, strides, box);
}

// A 3-D map over int8 codes addressed as (column, row, batch), strides in
// bytes; boxes of `box_cols` (128 or 64: one 128- or 64-byte swizzle row)
// x `box_rows`. Rows past `rows` read as zero.
inline bool encode_rows_s8(CUtensorMap* map, const void* base, int cols,
                           int rows, int batch, long long row_stride,
                           long long batch_stride, int box_cols,
                           int box_rows) {
  if (box_cols != 128 && box_cols != 64) return false;
  if (batch == 1) batch_stride = row_stride * rows;  // unused, but valid
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride,
                                 (cuuint64_t)batch_stride};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                    box_cols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                    base, 3, dims, strides, box);
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The barrier and copy helpers take shared-memory addresses (32 bits, as
// smem_u32 gives them); each has a pointer form that converts.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Makes the initialized barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box of a 3-D map into shared memory; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// One TMA box of a 4-D map into shared memory, as tma_load_3d.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  mbar_init(smem_u32(bar), count);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  mbar_arrive(smem_u32(bar));
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  mbar_arrive_expect_tx(smem_u32(bar), bytes);
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  tma_load_3d(smem_u32(dst), map, smem_u32(bar), c0, c1, c2);
}

// Named barrier `id` (1..15; 0 is __syncthreads') over `threads` threads,
// a multiple of 32: wait for the rest, or arrive without waiting.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// Descriptor of a 128-byte-swizzled shared-memory operand (offsets in
// bytes; see the head of this file).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr,
                                               uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Descriptor of a 64-byte-swizzled operand (layout 2): K-major, SBO = 512
// (the next 8 rows of 64 bytes), LBO unused.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t smem_addr,
                                              uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

#define HV_REGS32                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define HV_REGS64                                                            \
  HV_REGS32 ", "                                                             \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "  \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "  \
  "%60, %61, %62, %63"
#define HV_ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HV_ACC16(d, i) \
  HV_ACC4(d, i), HV_ACC4(d, i + 4), HV_ACC4(d, i + 8), HV_ACC4(d, i + 12)
#define HV_ACC32(d) \
  HV_ACC16(d, 0), HV_ACC16(d, 16)
#define HV_ACC64(d) \
  HV_ACC16(d, 0), HV_ACC16(d, 16), HV_ACC16(d, 32), HV_ACC16(d, 48)
#define HV_IACC4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define HV_IACC16(d, i) \
  HV_IACC4(d, i), HV_IACC4(d, i + 4), HV_IACC4(d, i + 8), HV_IACC4(d, i + 12)
#define HV_IACC64(d) \
  HV_IACC16(d, 0), HV_IACC16(d, 16), HV_IACC16(d, 32), HV_IACC16(d, 48)

// d (+)= A.B, m64n128k16, both operands K-major in shared memory; scale_d =
// 0 overwrites d.
#define HV_WGMMA_SS_N128(TY, T)                                              \
  __device__ __forceinline__ void wgmma_m64n128k16_ss(                      \
      float(&d)[64], uint64_t da, uint64_t db, int scale_d, T) {            \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
        "{" HV_REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                     \
        : HV_ACC64(d)                                                        \
        : "l"(da), "l"(db), "r"(scale_d));                                   \
  }

// d += A.B, m64nNk16, A (four 32-bit registers a thread) from registers, B
// MN-major in shared memory (the transpose bit).
#define HV_WGMMA_RS_TB(N, NREG, REGS, ACC, IA, ID, IS, TY, T)               \
  __device__ __forceinline__ void wgmma_m64n##N##k16_rs_tb(                 \
      float(&d)[NREG], const uint32_t(&a)[4], uint64_t db, T) {             \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"                      \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "     \
        "{" REGS "}, {" IA "}, " ID ", p, 1, 1, 1;\n}\n"                     \
        : ACC(d)                                                             \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));      \
  }

// d (+)= A.B, m64n64k16, both operands K-major in shared memory; scale_d =
// 0 overwrites d.
#define HV_WGMMA_SS_N64(TY, T)                                               \
  __device__ __forceinline__ void wgmma_m64n64k16_ss(                       \
      float(&d)[32], uint64_t da, uint64_t db, int scale_d, T) {            \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
        "{" HV_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                     \
        : HV_ACC32(d)                                                        \
        : "l"(da), "l"(db), "r"(scale_d));                                   \
  }

HV_WGMMA_SS_N128("bf16", __nv_bfloat16)
HV_WGMMA_SS_N128("f16", __half)
HV_WGMMA_SS_N64("bf16", __nv_bfloat16)
HV_WGMMA_SS_N64("f16", __half)
HV_WGMMA_RS_TB(128, 64, HV_REGS64, HV_ACC64, "%64, %65, %66, %67", "%68",
               "%69", "bf16", __nv_bfloat16)
HV_WGMMA_RS_TB(128, 64, HV_REGS64, HV_ACC64, "%64, %65, %66, %67", "%68",
               "%69", "f16", __half)
HV_WGMMA_RS_TB(64, 32, HV_REGS32, HV_ACC32, "%32, %33, %34, %35", "%36",
               "%37", "bf16", __nv_bfloat16)
HV_WGMMA_RS_TB(64, 32, HV_REGS32, HV_ACC32, "%32, %33, %34, %35", "%36",
               "%37", "f16", __half)

#undef HV_WGMMA_SS_N128
#undef HV_WGMMA_SS_N64
#undef HV_WGMMA_RS_TB

// d (+)= A.B, m64n128k32, s8 x s8 -> s32, both operands K-major in shared
// memory (the only layout 8-bit wgmma takes); scale_d = 0 overwrites d.
// Integer products take no scale or transpose immediates.
__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(int (&d)[64],
                                                       uint64_t da,
                                                       uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{" HV_REGS64 "}, %64, %65, p;\n}\n"
      : HV_IACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

#define HV_REGS128                                                           \
  HV_REGS64 ", "                                                             \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "  \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "  \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "  \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "      \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define HV_IACC128(d)                                                        \
  HV_IACC16(d, 0), HV_IACC16(d, 16), HV_IACC16(d, 32), HV_IACC16(d, 48),    \
      HV_IACC16(d, 64), HV_IACC16(d, 80), HV_IACC16(d, 96),                 \
      HV_IACC16(d, 112)

// d (+)= A.B, m64n256k32, s8 x s8 -> s32, both operands K-major in shared
// memory, as the n128 product above (128 accumulators a thread).
__device__ __forceinline__ void wgmma_m64n256k32_s8_ss(int (&d)[128],
                                                       uint64_t da,
                                                       uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{" HV_REGS128 "}, %128, %129, p;\n}\n"
      : HV_IACC128(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A.B over one k16 step with N = D columns (128 or 64).
template <int D, typename T>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[D / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (D == 128)
    wgmma_m64n128k16_rs_tb(d, a, db, T());
  else
    wgmma_m64n64k16_rs_tb(d, a, db, T());
}

// d += A.B over one k16 step with N columns (128 or 64), both operands
// K-major in shared memory.
template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 128)
    wgmma_m64n128k16_ss(d, da, db, 1, T());
  else
    wgmma_m64n64k16_ss(d, da, db, 1, T());
}

}  // namespace sm90
}  // namespace hv
