// Pieces shared by the three flash-attention kernels (sofa_flash_fwd,
// sofa_flash_bwd_kv, sofa_flash_bwd_dq): the mask constants of the TPU
// kernels, the fast exp2, bf16 packing, the epilogue's row store, quad
// reductions over an accumulator row, and the shared-memory opt-in.  Their
// Hopper pieces (TMA, mbarriers, wgmma, setmaxnreg) are in hopper.cuh.
//
// An accumulator row here is the wgmma f32 accumulator's layout (hopper.cuh):
// a thread holds cols 8j + 2(lane%4) + {0, 1} of two rows, lane/4 and
// lane/4 + 8 of its warp's 16, in c[j][0..1] and c[j][2..3].
//
// Each kernel is its own shared library, so the one extern "C" function
// defined here exists once per library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e29f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The backward's p = exp(s * scale - lse), lse already clamped at M_FLOOR,
// rounded as the plain version rounds it: the product, then the difference
// (no fused multiply-add), then exp as __expf computes it (ex2.approx of
// x * log2 e), with subnormal results flushed to zero.
__device__ __forceinline__ float bwd_p(float s, float scale, float lse) {
  return fast_exp2(__fmul_rn(__fsub_rn(__fmul_rn(s, scale), lse), LOG2E));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stores one accumulator row (half 0: the thread's first row, 1: its
// second) of a [rows, D] output row, times `mul`, in bf16 or float32.
template <int NO>
__device__ __forceinline__ void store_row(void* dst_row, bool out_f32,
                                          const float (&c)[NO][4], int half,
                                          float mul, int t) {
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const float lo = c[j][2 * half] * mul, hi = c[j][2 * half + 1] * mul;
    if (out_f32) {
      *reinterpret_cast<float2*>(static_cast<float*>(dst_row) + j * 8 +
                                 2 * t) = make_float2(lo, hi);
    } else {
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dst_row) +
                                   j * 8 + 2 * t) = pack_f32(lo, hi);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Opts a kernel into `smem` bytes of dynamic shared memory (above 48 KB).
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" const char* sofa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
