// Hopper (sm_90a) building blocks for the three flash-attention kernels, as
// inline PTX: shared-memory barriers (mbarrier), TMA tile loads
// (cp.async.bulk.tensor) described by tensor maps that the host encodes,
// warpgroup matrix products (wgmma.mma_async) with their shared-memory
// matrix descriptors and fences, and register rebalancing between
// warpgroups (setmaxnreg).  No CUTLASS or CuTe: a library that includes
// this header builds in seconds with a plain C interface.
//
// Shared-memory layout the pieces agree on: a "panel" is R rows of 64 bf16
// or f16 (128 bytes) stored with the 128-byte swizzle, i.e. the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8).  A TMA box of (64 columns x R rows) with
// CU_TENSOR_MAP_SWIZZLE_128B writes exactly that, and a wgmma descriptor
// with layout type 1 (128B swizzle) reads it, either
//   - K-major (the product's k index runs along the 128-byte row): one
//     k16 step is 32 bytes further along the row; 8-row groups are 1024
//     bytes apart (SBO); LBO is unused; or
//   - MN-major ("transposed", the k index runs down the rows, as for V in
//     P.V): one k16 step is 16 rows = 2048 bytes further down; 8-row groups
//     along k are 1024 bytes apart (SBO) and 64-column panels along n are
//     LBO bytes apart.
// Panels start on 1024-byte boundaries, so a descriptor's base offset is 0.
//
// The wgmma f32 accumulator of m64nN gives each thread of warp w in the
// warpgroup d[j][0..1] = row 16w + lane/4, cols 8j + 2(lane%4) + {0, 1} and
// d[j][2..3] = the same cols of row 16w + lane/4 + 8: mma.sync's m16n8 C
// layout repeated over n.  A register A operand uses mma.sync's m16n8k16 A
// layout in each warp's 16 rows, so an accumulator repacks into A as is.
//
// Every register operand of an asynchronous wgmma (accumulator, register A)
// passes fence_operands before wgmma_fence and after wgmma_wait, so the
// compiler neither writes it while the product runs nor reads it before the
// product is done.

#pragma once

#include <cuda.h>               // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// --- addresses, fences, barriers --------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes initialized barriers visible to the other threads and to the async
// proxy (TMA); follow with __syncthreads().
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrives and adds `bytes` to the transaction count of the current phase;
// the phase completes once every arrival and every byte (TMA) is in.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// --- register rebalancing ------------------------------------------------------

// Lowers (dec) or raises (inc) the register budget of every thread of the
// calling warpgroup to N (a multiple of 8 in [24, 256]); all four warps
// execute it together.  A producer warpgroup that only issues TMA hands its
// registers to the consumer warpgroups this way: the launch gives every
// thread 65536 / blockDim registers, and the pool of one block per SM is
// shared out again, e.g. 128 x 24 + 256 x 240 <= 65536 for one producer and
// two consumers.  ptxas honours it only where each path after the role
// split runs to the end of the kernel without rejoining the other (else it
// warns "setmaxnreg ignored").  sm_90a only.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Loads the box at coordinates (c0, c1, c2, c3) (innermost first) of a 4-D
// tensor map into shared memory at `dst`; completes `bytes` of `bar`'s
// transaction count.  Elements past the tensor's extent arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128B-swizzled operand at `addr`
// (a shared-window address); lbo / sbo in bytes, as described above.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

constexpr uint32_t SW128_SBO = 1024;   // 8 rows of 128 bytes

// The descriptor of the operand `bytes` further on: the address field is
// the low 14 bits of addr / 16, and shared addresses stay below 2^18, so
// adding to it never carries into the other fields.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties every register of an accumulator to this point of the program.
template <int J>
__device__ __forceinline__ void fence_operands(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

template <int J>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
  }
}

// The operand list of an m64nN float32 accumulator d[N / 8][4], and the
// register list that names it in a wgmma's PTX text.
#define SOFA_ACC4(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define SOFA_ACC_N32(d) \
  SOFA_ACC4(d, 0), SOFA_ACC4(d, 1), SOFA_ACC4(d, 2), SOFA_ACC4(d, 3)
#define SOFA_ACC_N64(d) \
  SOFA_ACC_N32(d), SOFA_ACC4(d, 4), SOFA_ACC4(d, 5), SOFA_ACC4(d, 6), \
      SOFA_ACC4(d, 7)
#define SOFA_ACC_N128(d)                                                    \
  SOFA_ACC_N64(d), SOFA_ACC4(d, 8), SOFA_ACC4(d, 9), SOFA_ACC4(d, 10),      \
      SOFA_ACC4(d, 11), SOFA_ACC4(d, 12), SOFA_ACC4(d, 13), SOFA_ACC4(d, 14), \
      SOFA_ACC4(d, 15)
#define SOFA_REGS_N32                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "           \
  "%8, %9, %10, %11, %12, %13, %14, %15}, "
#define SOFA_REGS_N64                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "           \
  "%8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, "    \
  "%24, %25, %26, %27, %28, %29, %30, %31}, "
#define SOFA_REGS_N128                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "           \
  "%8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, "    \
  "%24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, "    \
  "%40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, "    \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "

// D[64 x N] (+)= A[64 x 16] * B[16 x N] with A and B from shared memory
// (NAME_SS), or A from registers (NAME_RS: a[0..3] in the mma.sync m16n8k16
// A layout of each warp's 16 rows) and B from shared memory; TY is the
// inputs' PTX type (bf16 or f16), the sum float32.  The N 32 product has
// no register-A form here (nothing uses one).
#define SOFA_WGMMA_SS(NAME, N, TY, REGS, ACC, P, DA, DB, TB)                \
  template <int TRANS_B>                                                   \
  __device__ __forceinline__ void NAME(float (&d)[N / 8][4],               \
                                       uint64_t desc_a, uint64_t desc_b,   \
                                       int accumulate) {                   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
                 " " REGS "%" DA ", %" DB ", p, 1, 1, 0, %" TB ";\n}\n"    \
                 : ACC(d)                                                  \
                 : "l"(desc_a), "l"(desc_b), "r"(accumulate),              \
                   "n"(TRANS_B));                                          \
  }
#define SOFA_WGMMA_RS(NAME, N, TY, REGS, ACC, A0, A1, A2, A3, DB, P, TB)   \
  template <int TRANS_B>                                                   \
  __device__ __forceinline__ void NAME(float (&d)[N / 8][4],               \
                                       const uint32_t (&a)[4],             \
                                       uint64_t desc_b, int accumulate) {  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
                 " " REGS "{%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" DB      \
                 ", p, 1, 1, %" TB ";\n}\n"                                \
                 : ACC(d)                                                  \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),             \
                   "l"(desc_b), "r"(accumulate), "n"(TRANS_B));            \
  }

// bfloat16 (the Hopper kernels' and the general kernels' bf16 path) and
// float16 (the general kernels' f16 path).
SOFA_WGMMA_SS(wgmma_ss_n32, 32, "bf16", SOFA_REGS_N32, SOFA_ACC_N32, "18",
              "16", "17", "19")
SOFA_WGMMA_SS(wgmma_ss_n64, 64, "bf16", SOFA_REGS_N64, SOFA_ACC_N64, "34",
              "32", "33", "35")
SOFA_WGMMA_SS(wgmma_ss_n128, 128, "bf16", SOFA_REGS_N128, SOFA_ACC_N128, "66",
              "64", "65", "67")
SOFA_WGMMA_RS(wgmma_rs_n64, 64, "bf16", SOFA_REGS_N64, SOFA_ACC_N64, "32",
              "33", "34", "35", "36", "37", "38")
SOFA_WGMMA_RS(wgmma_rs_n128, 128, "bf16", SOFA_REGS_N128, SOFA_ACC_N128, "64",
              "65", "66", "67", "68", "69", "70")
SOFA_WGMMA_SS(wgmma_ss_n32_f16, 32, "f16", SOFA_REGS_N32, SOFA_ACC_N32, "18",
              "16", "17", "19")
SOFA_WGMMA_SS(wgmma_ss_n64_f16, 64, "f16", SOFA_REGS_N64, SOFA_ACC_N64, "34",
              "32", "33", "35")
SOFA_WGMMA_SS(wgmma_ss_n128_f16, 128, "f16", SOFA_REGS_N128, SOFA_ACC_N128,
              "66", "64", "65", "67")
SOFA_WGMMA_RS(wgmma_rs_n64_f16, 64, "f16", SOFA_REGS_N64, SOFA_ACC_N64, "32",
              "33", "34", "35", "36", "37", "38")
SOFA_WGMMA_RS(wgmma_rs_n128_f16, 128, "f16", SOFA_REGS_N128, SOFA_ACC_N128,
              "64", "65", "66", "67", "68", "69", "70")

// Dispatch on the product's width N (32, 64 or 128; 32 from shared memory
// only) and the inputs' element type E (__nv_bfloat16 by default, or
// __half).  TRANS_B = 0 reads B K-major (stored [n][k], as K in Q.K^T), 1
// MN-major (stored [k][n], as V in P.V).
template <int N, int TRANS_B, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N is 32, 64 or 128");
  constexpr bool F16 = std::is_same<E, __half>::value;
  static_assert(F16 || std::is_same<E, __nv_bfloat16>::value,
                "wgmma_ss: bf16 or f16 inputs");
  if constexpr (N == 32) {
    if constexpr (F16) wgmma_ss_n32_f16<TRANS_B>(d, desc_a, desc_b, accumulate);
    else wgmma_ss_n32<TRANS_B>(d, desc_a, desc_b, accumulate);
  } else if constexpr (N == 64) {
    if constexpr (F16) wgmma_ss_n64_f16<TRANS_B>(d, desc_a, desc_b, accumulate);
    else wgmma_ss_n64<TRANS_B>(d, desc_a, desc_b, accumulate);
  } else {
    if constexpr (F16) {
      wgmma_ss_n128_f16<TRANS_B>(d, desc_a, desc_b, accumulate);
    } else {
      wgmma_ss_n128<TRANS_B>(d, desc_a, desc_b, accumulate);
    }
  }
}

template <int N, int TRANS_B, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  constexpr bool F16 = std::is_same<E, __half>::value;
  static_assert(F16 || std::is_same<E, __nv_bfloat16>::value,
                "wgmma_rs: bf16 or f16 inputs");
  if constexpr (N == 64) {
    if constexpr (F16) wgmma_rs_n64_f16<TRANS_B>(d, a, desc_b, accumulate);
    else wgmma_rs_n64<TRANS_B>(d, a, desc_b, accumulate);
  } else {
    if constexpr (F16) wgmma_rs_n128_f16<TRANS_B>(d, a, desc_b, accumulate);
    else wgmma_rs_n128<TRANS_B>(d, a, desc_b, accumulate);
  }
}

// --- shared memory written by threads, read by the async proxy -----------

// Orders this thread's earlier generic-proxy writes to shared memory before
// later async-proxy reads (wgmma operands): write, fence, then arrive on
// the barrier the readers wait on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` over `count` threads (a multiple of 32).
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Byte offset of 2-byte element (r, c), c < 64, in a 128B-swizzled panel.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// --- host: tensor maps ---------------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the runtime so that the library
// needs no -lcuda and stays a plain ctypes library.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a contiguous [B, rows, heads, D] tensor (q, k, v, dO)
// of 2-byte elements of `type` (bfloat16 by default, or float16), seen as
// the 4-D tensor (D, heads, rows, B), whose box is 64 columns of one head
// over box_rows rows with the 128-byte swizzle: one box lands as one panel
// of box_rows rows, and columns past D and rows past `rows` arrive as
// zeros.  TMA needs a 16-byte aligned base and D % 8 == 0 (every stride a
// multiple of 16 bytes).  Returns cudaErrorInvalidValue when
// cuTensorMapEncodeTiled refuses the map (or cannot be found).
cudaError_t encode_heads(
    CUtensorMap* map, const void* base, uint64_t D, uint64_t heads,
    uint64_t rows, uint64_t B, uint32_t box_rows,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorInvalidValue;
  const uint64_t e = 2;                 // bytes of a bf16 or f16
  const cuuint64_t dims[4] = {D, heads, rows, B};
  const cuuint64_t strides[3] = {e * D, e * heads * D, e * rows * heads * D};
  const cuuint32_t box[4] = {64, 1, box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
