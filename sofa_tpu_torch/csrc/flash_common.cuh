// Pieces shared by the three flash-attention kernels (sofa_flash_fwd,
// sofa_flash_bwd_kv, sofa_flash_bwd_dq): tile sizes, the mask constants of
// the TPU kernels, the mma.sync m16n8k16 bf16 product, fragment packing, a
// padded 64-row tile copy, and quad reductions over an accumulator row.
// The forward takes only the mask constants, pack_f32, store_row, the quad
// reductions and allow_smem from here; its Hopper pieces (TMA, mbarriers,
// wgmma) are in hopper.cuh.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A 16x16: a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//            a2 (row g, cols 2t+8..2t+9), a3 (row g+8, same cols);
//   B 16x8:  b0 (rows 2t..2t+1, col g), b1 (rows 2t+8..2t+9, col g);
//   C 16x8:  c0, c1 (row g, cols 2t..2t+1), c2, c3 (row g+8, same cols).
// So a product whose B operand is a row-major tile read along its rows
// ("X Y^T") takes one 32-bit load per register, and a product whose B is
// read down its columns ("P V") packs two 16-bit loads; an A operand can be
// built straight from a C accumulator of the previous product.
//
// Each kernel is its own shared library, so the one extern "C" function
// defined here exists once per library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;               // rows of a q or k/v tile
constexpr int WARPS = 4;                // each warp owns 16 rows of a tile
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;                  // shared-memory row padding (elements)
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e29f;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows [r, r + 8] x cols [c, c + 16) of a padded tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r,
                                       int c) {
  a[0] = ld_u32(tile + r * LD + c);
  a[1] = ld_u32(tile + (r + 8) * LD + c);
  a[2] = ld_u32(tile + r * LD + c + 8);
  a[3] = ld_u32(tile + (r + 8) * LD + c + 8);
}

// C[16 x 8 n] += A * X^T, with X a padded tile whose rows are the n index:
// c[n] covers X rows [8n, 8n + 8) and A spans cols [kk*16, kk*16 + 16).
template <int LD, int N>
__device__ __forceinline__ void mma_abt(float (&c)[N][4],
                                        const uint32_t (&a)[4],
                                        const __nv_bfloat16* x, int kk,
                                        int g, int t) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const __nv_bfloat16* row = x + (n * 8 + g) * LD + kk * 16 + 2 * t;
    mma_bf16_16816(c[n], a, ld_u32(row), ld_u32(row + 8));
  }
}

// C[16 x D] += P * Y, with P (bf16-rounded) taken from the accumulators
// p[2kk], p[2kk + 1] of a previous product (its cols kk*16 .. kk*16 + 15)
// and Y a padded tile whose rows are the k index.
template <int LD, int NO, int NP>
__device__ __forceinline__ void mma_py(float (&c)[NO][4],
                                       const float (&p)[NP][4],
                                       const __nv_bfloat16* y, int g,
                                       int t) {
#pragma unroll
  for (int kk = 0; kk < NP / 2; ++kk) {
    const uint32_t pa[4] = {
        pack_f32(p[2 * kk][0], p[2 * kk][1]),
        pack_f32(p[2 * kk][2], p[2 * kk][3]),
        pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const __nv_bfloat16* yk = y + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const __nv_bfloat16* yc = yk + j * 8;
      const uint32_t b0 = pack_bf16(yc[0], yc[LD]);
      const uint32_t b1 = pack_bf16(yc[8 * LD], yc[9 * LD]);
      mma_bf16_16816(c[j], pa, b0, b1);
    }
  }
}

// Copies rows [row0, row0 + 64) of a [rows, D] view with the given row stride
// (in elements) into a padded shared tile; rows at or past n_valid read as 0,
// so the ragged edge never feeds garbage (or NaN) into the products.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src, int row0,
                                          int n_valid, long long row_stride) {
  constexpr int CHUNKS = D / 8;         // 16-byte chunks per row
  constexpr int PER_THREAD = BLOCK * CHUNKS / THREADS;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * row_stride + c * 8);
    }
    *reinterpret_cast<uint4*>(tile + r * (D + PAD) + c * 8) = val;
  }
}

// Stores one accumulator row pair (cols 2t, 2t + 1 of each 8-col n-tile) of
// a [rows, D] output row, in bf16 or float32.
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
