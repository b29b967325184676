// Pieces shared by the three general flash-attention kernels
// (sofa_flash_gen_fwd, sofa_flash_gen_bwd_kv, sofa_flash_gen_bwd_dq): the
// part of the TPU kernels' domain the Hopper kernels leave out, which is
// every (dtype, head dim) with dtype bfloat16, float16 or float32 and
// 1 <= D <= 256 except bfloat16 at D 64 and 128.  Each entry point takes
// the dtype code and dispatches (dispatch_paths) to one of two designs:
//
// The FMA tile loop (float32, in all three kernels), on the CUDA cores in
// float32 FMA (no tensor cores, so float32 inputs are multiplied in
// float32, not TF32):
//   - a block of 256 threads owns a tile of ROWS = 64 rows (queries, or
//     keys in the dK/dV kernel) and walks the other side in tiles of COLS
//     rows (64, or 32 at the head-dim cap 256), staged in shared memory as
//     float32 with a row stride of DC + 1 floats (no bank conflicts);
//   - the head dim is a compile-time cap DC (16, 32, 64, 128 or 256) with
//     the runtime D masked inside it: the loads zero the columns >= D, the
//     score products run over the true D, and the caller's scale is the true
//     D's d ** -0.5;
//   - thread (tx, ty) of a 16 x 16 grid holds rows ty + 16 i and columns
//     tx + 16 j of every product, so neighbouring threads read neighbouring
//     banks and each value read from shared memory feeds several FMAs.
//
// The tensor-core path (bfloat16 and float16, in all three kernels;
// csrc/hopper.cuh's building blocks): tiles in their own 16-bit type in
// 128B-swizzled panels of 64 columns (caps 16 and 32 pad to one panel),
// wgmma products accumulating in float32 registers.  A call whose rows TMA
// can describe (D % 8 == 0, 16-byte aligned bases) loads by TMA, which
// zero-fills the columns past D and the rows past T / Tk; any other loads
// the same panels thread by thread (load_panels), with the same zeros, and
// the same wgmma loop reads them.
//
// Each library instantiates the FMA loop at float32 (5 caps) and the
// tensor-core kernel at bfloat16 and float16 (10).

#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int GEN_THREADS = 256;   // a 16 x 16 grid of threads
constexpr int GEN_ROWS = 64;       // rows of the tile a block owns

// The dtype codes of the entry points (flash_cuda.py's _DTYPE_CODES).
enum GenDtype { GEN_F32 = 0, GEN_F16 = 1, GEN_BF16 = 2 };

// The tile geometry at head-dim cap DC.
template <int DC>
struct Gen {
  static constexpr int LD = DC + 1;                  // staged row, floats
  static constexpr int ROWS = GEN_ROWS;
  static constexpr int COLS = DC <= 128 ? 64 : 32;   // streamed tile rows
  static constexpr int LP = COLS + 1;                // [ROWS][COLS] scores
  static constexpr int RI = ROWS / 16;               // rows a thread holds
  static constexpr int CJ = COLS / 16;               // score columns
  static constexpr int DJ = DC / 16;                 // head-dim columns
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename E>
__device__ __forceinline__ E from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to E's precision, as the plain version's .to(dtype).float().
template <typename E>
__device__ __forceinline__ float round_as(float x) {
  return to_f(from_f<E>(x));
}

// Rows [0, rows) of a [.., D] tensor whose row r starts at src + r * stride
// into dst[rows][LD] as float32; rows >= valid and columns >= D are zero.
template <typename E, int DC>
__device__ __forceinline__ void load_tile(float* dst, const E* src,
                                          long long stride, int rows,
                                          int valid, int D) {
  for (int idx = threadIdx.x; idx < rows * DC; idx += GEN_THREADS) {
    const int r = idx / DC, c = idx % DC;
    dst[r * Gen<DC>::LD + c] =
        r < valid && c < D ? to_f(src[r * stride + c]) : 0.f;
  }
}

// acc[i][j] = sum over d < D of a[ty + 16 i][d] * b[tx + 16 j][d], both
// tiles staged with row stride LD.
template <int DC, int RI, int CJ>
__device__ __forceinline__ void products(float (&acc)[RI][CJ],
                                         const float* a, const float* b,
                                         int D) {
  constexpr int LD = Gen<DC>::LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum over n < N of p[ty + 16 i][n] * x[n][tx + 16 j]: p a
// [rows][N] tile with row stride N + 1, x a staged [N][LD] tile.
template <int DC, int N, int RI>
__device__ __forceinline__ void accumulate(float (&acc)[RI][DC / 16],
                                           const float* p, const float* x) {
  constexpr int LD = Gen<DC>::LD, DJ = DC / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float pv[RI], xv[DJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) pv[i] = p[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
    for (int j = 0; j < DJ; ++j) xv[j] = x[n * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], xv[j], acc[i][j]);
    }
  }
}

// Stores acc * mul, rows [0, valid) and columns [0, D) of a block tile, as
// O to a [.., D] tensor whose row r starts at dst + r * stride.
template <typename O, int DC, int RI>
__device__ __forceinline__ void store_tile(O* dst, long long stride,
                                           int valid, int D,
                                           const float (&acc)[RI][DC / 16],
                                           float mul) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < DC / 16; ++j) {
      const int c = tx + 16 * j;
      if (r < valid && c < D) dst[r * stride + c] = from_f<O>(acc[i][j] * mul);
    }
  }
}

// The element type E of a dispatch, as a value.
template <typename E>
struct Elem {
  using type = E;
};

// Calls f(std::integral_constant<int, DC>{}) for the smallest cap DC >= D;
// cudaErrorInvalidValue for a D outside 1..256.
template <typename F>
cudaError_t dispatch_cap(int D, F&& f) {
  if (D < 1) return cudaErrorInvalidValue;
  if (D <= 16) return f(std::integral_constant<int, 16>{});
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  if (D <= 128) return f(std::integral_constant<int, 128>{});
  if (D <= 256) return f(std::integral_constant<int, 256>{});
  return cudaErrorInvalidValue;
}

// Calls fma(Elem<float>{}, cap) for a float32 call and
// tc(Elem<E>{}, cap) for a bfloat16 or float16 one, cap the smallest
// head-dim cap >= D; cudaErrorInvalidValue for any other dtype or a D
// outside 1..256.
template <typename F, typename G>
cudaError_t dispatch_paths(int dtype, int D, F&& fma, G&& tc) {
  switch (dtype) {
    case GEN_F32:
      return dispatch_cap(D, [&](auto cap) { return fma(Elem<float>{}, cap); });
    case GEN_F16:
      return dispatch_cap(D, [&](auto cap) { return tc(Elem<__half>{}, cap); });
    case GEN_BF16:
      return dispatch_cap(
          D, [&](auto cap) { return tc(Elem<__nv_bfloat16>{}, cap); });
    default:
      return cudaErrorInvalidValue;
  }
}

// --- the tensor-core path ----------------------------------------------------

// The tensor map's element type of E.
template <typename E>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<E, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// True when TMA can describe a [.., D] tensor at each of `bases`: rows a
// multiple of 16 bytes and 16-byte aligned bases.
inline bool tma_fits(int D, std::initializer_list<const void*> bases) {
  if (D % 8 != 0) return false;
  for (const void* p : bases) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

// Two floats rounded to E (round to nearest) and packed, lo in the low half.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<E, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_f32(lo, hi);
  }
}

// The thread-by-thread load: rows [0, rows) of a [.., D] tensor of 2-byte
// elements whose row r starts at src + r * stride, into `panels`
// 128B-swizzled panels of `rows` rows at dst, panel_bytes apart, exactly as
// TMA lands them: columns >= D and rows >= valid are zeros.  Thread `idx`
// of `nthr` (a multiple of 64) writes column idx % 64 of each panel in rows
// idx / 64, idx / 64 + nthr / 64, ...; neighbouring threads read
// neighbouring elements.  The loops stay rolled: the dK/dV kernel runs this
// between tiles in threads that hold dK and dV (252 registers at cap 128).
template <typename E>
__device__ __forceinline__ void load_panels(uint32_t dst, int panels,
                                            int panel_bytes, const E* src,
                                            long long stride, int rows,
                                            int valid, int D, int idx,
                                            int nthr) {
  const int c0 = idx & 63, step = nthr >> 6;
  const uint16_t* row = reinterpret_cast<const uint16_t*>(src) + c0 +
                        (idx >> 6) * stride;
#pragma unroll 1
  for (int r = idx >> 6; r < rows; r += step, row += step * stride) {
    const uint32_t at = dst + sw128(r, c0);
#pragma unroll 1
    for (int p = 0; p < panels; ++p) {
      const uint16_t x = r < valid && p * 64 + c0 < D
                             ? row[p * 64] : static_cast<uint16_t>(0);
      st_shared_u16(at + p * panel_bytes, x);
    }
  }
}

// Stores one row of a float32 accumulator in the wgmma layout (half 0: the
// thread's first row, 1: its second) times `mul`, as O, into the row at
// dst_row: columns col0 + 8 j + 2 t + {0, 1}, those < D only.  An even D
// stores pairs, an odd one element by element (a pair may straddle an
// alignment boundary).
template <typename O, int J>
__device__ __forceinline__ void store_acc_row(O* dst_row,
                                              const float (&c)[J][4],
                                              int half, float mul, int t,
                                              int col0, int D) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (col >= D) continue;
    const float lo = c[j][2 * half] * mul, hi = c[j][2 * half + 1] * mul;
    if ((D & 1) == 0) {
      if constexpr (std::is_same<O, float>::value) {
        *reinterpret_cast<float2*>(dst_row + col) = make_float2(lo, hi);
      } else {
        *reinterpret_cast<uint32_t*>(dst_row + col) = pack2<O>(lo, hi);
      }
    } else {
      dst_row[col] = from_f<O>(lo);
      if (col + 1 < D) dst_row[col + 1] = from_f<O>(hi);
    }
  }
}

// The cap a head dim runs at (0 outside 1..256).
inline int gen_cap(int d) {
  return d < 1 ? 0 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
       : d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

}  // namespace
