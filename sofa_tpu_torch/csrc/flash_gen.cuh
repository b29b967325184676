// Pieces shared by the three general flash-attention kernels
// (sofa_flash_gen_fwd, sofa_flash_gen_bwd_kv, sofa_flash_gen_bwd_dq): the
// part of the TPU kernels' domain the Hopper kernels leave out, which is
// every (dtype, head dim) with dtype bfloat16, float16 or float32 and
// 1 <= D <= 256 except bfloat16 at D 64 and 128.
//
// The design is one simple tile loop on the CUDA cores, in float32 FMA (no
// tensor cores, so float32 inputs are multiplied in float32, not TF32):
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
// Every element type is instantiated at every cap (15 kernels a library).

#pragma once

#include <cuda_fp16.h>

#include <type_traits>

#include "flash_common.cuh"

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

// Calls f(Elem<E>{}, std::integral_constant<int, DC>{}) for the element
// type of `dtype` and the smallest cap DC >= D; cudaErrorInvalidValue for
// any other dtype or a D outside 1..256.
template <typename F>
cudaError_t dispatch(int dtype, int D, F&& f) {
  auto by_cap = [&](auto elem) -> cudaError_t {
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 16) return f(elem, std::integral_constant<int, 16>{});
    if (D <= 32) return f(elem, std::integral_constant<int, 32>{});
    if (D <= 64) return f(elem, std::integral_constant<int, 64>{});
    if (D <= 128) return f(elem, std::integral_constant<int, 128>{});
    if (D <= 256) return f(elem, std::integral_constant<int, 256>{});
    return cudaErrorInvalidValue;
  };
  switch (dtype) {
    case GEN_F32:
      return by_cap(Elem<float>{});
    case GEN_F16:
      return by_cap(Elem<__half>{});
    case GEN_BF16:
      return by_cap(Elem<__nv_bfloat16>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// The cap a head dim runs at (0 outside 1..256).
inline int gen_cap(int d) {
  return d < 1 ? 0 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
       : d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

}  // namespace
