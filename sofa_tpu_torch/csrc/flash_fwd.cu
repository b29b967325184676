// sofa_flash_fwd: fused attention forward for Hopper (sm_90a), bf16 in,
// f32 online softmax, bf16 out plus a per-row logsumexp in f32.
//
// Replaces the TPU kernel sofa_tpu/workloads/flash_pallas.py:_flash_kernel
// (launched as name="sofa_flash_fwd" by _flash_forward, flash_pallas.py:282)
// and computes the same function:
//   - key j is visible to query i iff j <= i + shift (0 = causal, >= Tk =
//     full attention, <= -Tk = nothing visible: out 0, lse ~ -1e29);
//   - optional segment ids mask pairs whose ids differ (packed sequences);
//   - GQA is native: query head h reads compact KV head h / (H / KVH);
//   - m is clamped at -1e29, masked scores are NEG_INF = -1e30, so a row
//     with no visible key accumulates exact zeros;
//   - p rounds to bf16 before the P.V product, l sums the unrounded p.
// The one deliberate difference: the running max starts at the clamp floor
// (-1e29) instead of NEG_INF, so a fully masked row reports lse ~ -1e29
// whatever the tiling (the TPU kernel gives -1e30 when it skips every block
// and -1e29 when it visits one).  Every visible row is unaffected.
//
// What bounds it on an H100: bf16 tensor-core operations.  Under causal
// masking the work is 4*B*H*D*T*(T+1)/2 flops against 2*(q+k+v+out) bytes;
// at the Llama-3-8B attention shape (B=4, T=2048, H=32, D=128) that is
// ~1.4e11 flops against ~0.17 GB, about 800 flops per byte, well above the
// card's ~295 flops/byte ridge.  So the design aims at keeping the tensor
// cores fed and skipping work the mask makes void:
//   - one thread block per (batch*head, 64-row q-tile); a loop inside the
//     block walks the 64-key K/V tiles only up to the causal frontier,
//     replacing the TPU's sequential k grid axis and its pl.when skip;
//   - four warps each own 16 query rows; both products run on mma.sync
//     m16n8k16 (bf16 in, f32 accumulate) with Q fragments held in
//     registers for the whole loop and the P fragments built straight from
//     the S accumulators (no round trip through shared memory);
//   - the output accumulator and the softmax state (m, l) stay in f32
//     registers; the rescale by exp(m_old - m_new) is per register row;
//   - Q/K/V tiles live in shared memory with rows padded by 8 elements, so
//     every fragment load below is free of bank conflicts;
//   - the heaviest q-tiles (those nearest the end of a causal sequence)
//     are scheduled first, which evens out the tail of the grid.
// Loads are synchronous 16-byte copies; wgmma, TMA and a multi-stage
// pipeline are the known next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;             // query rows per block (4 warps x 16)
constexpr int BLOCK_N = 64;             // keys per K/V tile
constexpr int WARPS = 4;
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

// Copies rows [row0, row0 + 64) of a [rows, D] view with the given row stride
// (in elements) into a padded shared tile; rows at or past n_valid read as 0,
// so the ragged edge never feeds garbage (or NaN) into the products.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src, int row0,
                                          int n_valid, long long row_stride) {
  constexpr int CHUNKS = D / 8;         // 16-byte chunks per row
  constexpr int PER_THREAD = 64 * CHUNKS / THREADS;
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(THREADS) sofa_flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int T, int Tk, int H, int KVH, long long shift,
    float scale) {
  constexpr int LD = D + PAD;
  constexpr int KD = D / 16;            // k-steps of the S = Q K^T product
  constexpr int NS = BLOCK_N / 8;       // n-tiles of S (8 keys each)
  constexpr int NO = D / 8;             // n-tiles of O (8 columns each)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_tile = q_tile + BLOCK_M * LD;
  __nv_bfloat16* v_tile = k_tile + BLOCK_N * LD;
  int* segk_tile = reinterpret_cast<int*>(v_tile + BLOCK_N * LD);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // mma fragment row group / column pair

  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const __nv_bfloat16* q_base =
      q + static_cast<long long>(b) * T * q_stride + static_cast<long long>(h) * D;
  const __nv_bfloat16* k_base =
      k + static_cast<long long>(b) * Tk * kv_stride + static_cast<long long>(kvh) * D;
  const __nv_bfloat16* v_base =
      v + static_cast<long long>(b) * Tk * kv_stride + static_cast<long long>(kvh) * D;

  load_tile<D>(q_tile, q_base, q0, T, q_stride);
  __syncthreads();

  // This thread's two rows of the tile: r and r + 8 within its warp's 16.
  const int r = warp * 16 + g;
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    qa[kk][0] = ld_u32(q_tile + r * LD + kk * 16 + 2 * t);
    qa[kk][1] = ld_u32(q_tile + (r + 8) * LD + kk * 16 + 2 * t);
    qa[kk][2] = ld_u32(q_tile + r * LD + kk * 16 + 8 + 2 * t);
    qa[kk][3] = ld_u32(q_tile + (r + 8) * LD + kk * 16 + 8 + 2 * t);
  }
  const int row0 = q0 + r, row1 = row0 + 8;
  const bool segmented = seg_q != nullptr;
  int sq0 = 0, sq1 = 0;
  if (segmented) {
    sq0 = row0 < T ? seg_q[static_cast<long long>(b) * T + row0] : 0;
    sq1 = row1 < T ? seg_q[static_cast<long long>(b) * T + row1] : 0;
  }

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = M_FLOOR, m1 = M_FLOOR, l0 = 0.f, l1 = 0.f;

  // Causal frontier: the last key any row of this tile can see.
  const long long last = static_cast<long long>(q0) + BLOCK_M - 1 + shift;
  int n_tiles = 0;
  if (last >= 0) {
    const long long by_mask = last / BLOCK_N + 1;
    const long long by_len = (Tk + BLOCK_N - 1) / BLOCK_N;
    n_tiles = static_cast<int>(by_mask < by_len ? by_mask : by_len);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BLOCK_N;
    __syncthreads();                    // every warp is done with the last tile
    load_tile<D>(k_tile, k_base, k0, Tk, kv_stride);
    load_tile<D>(v_tile, v_base, k0, Tk, kv_stride);
    if (segmented && threadIdx.x < BLOCK_N) {
      const int j = k0 + threadIdx.x;
      segk_tile[threadIdx.x] =
          j < Tk ? seg_k[static_cast<long long>(b) * Tk + j] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = k_tile + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mma_bf16_16816(s[n], qa[kk], ld_u32(krow + kk * 16),
                       ld_u32(krow + kk * 16 + 8));
      }
    }

    // Scale, mask, and take the running row max.
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = n * 8 + 2 * t + (e & 1);
        const int key = k0 + jj;
        const int row = e < 2 ? row0 : row1;
        bool masked = key >= Tk || key > row + shift;
        if (segmented) masked = masked || segk_tile[jj] != (e < 2 ? sq0 : sq1);
        const float x = masked ? NEG_INF : s[n][e] * scale;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = __expf(s[n][0] - mn0);
      s[n][1] = __expf(s[n][1] - mn0);
      s[n][2] = __expf(s[n][2] - mn1);
      s[n][3] = __expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + quad_sum(ps0);
    l1 = l1 * alpha1 + quad_sum(ps1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha0; o[j][1] *= alpha0;
      o[j][2] *= alpha1; o[j][3] *= alpha1;
    }

    // O += P V, with P (rounded to bf16) taken from the S accumulators.
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]),
          pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vk = v_tile + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const __nv_bfloat16* vc = vk + j * 8;
        const uint32_t b0 = pack_bf16(vc[0], vc[LD]);
        const uint32_t b1 = pack_bf16(vc[8 * LD], vc[9 * LD]);
        mma_bf16_16816(o[j], pa, b0, b1);
      }
    }
  }

  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / lc0, inv1 = 1.f / lc1;
  if (row0 < T) {
    __nv_bfloat16* dst = out + (static_cast<long long>(b) * T + row0) * q_stride +
                         static_cast<long long>(h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_f32(o[j][0] * inv0, o[j][1] * inv0);
    }
    if (t == 0) lse[(static_cast<long long>(b) * H + h) * T + row0] = m0 + logf(lc0);
  }
  if (row1 < T) {
    __nv_bfloat16* dst = out + (static_cast<long long>(b) * T + row1) * q_stride +
                         static_cast<long long>(h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_f32(o[j][2] * inv1, o[j][3] * inv1);
    }
    if (t == 0) lse[(static_cast<long long>(b) * H + h) * T + row1] = m1 + logf(lc1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_k, void* out, float* lse,
                   int B, int T, int Tk, int H, int KVH, long long shift,
                   float scale, cudaStream_t stream) {
  const int smem = (BLOCK_M + 2 * BLOCK_N) * (D + PAD) *
                       static_cast<int>(sizeof(__nv_bfloat16)) +
                   BLOCK_N * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      sofa_flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T + BLOCK_M - 1) / BLOCK_M);
  sofa_flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg_q, seg_k,
      static_cast<__nv_bfloat16*>(out), lse, T, Tk, H, KVH, shift, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q [B,T,H,D], k/v [B,Tk,KVH,D]
// contiguous bf16; seg_q [B,T] / seg_k [B,Tk] int32 or both null; out
// [B,T,H,D] bf16 and lse [B,H,T] f32 are allocated by the caller.  Launches
// on `stream` without synchronizing and returns cudaGetLastError().
extern "C" int sofa_flash_fwd(const void* q, const void* k, const void* v,
                              const int* seg_q, const int* seg_k, void* out,
                              float* lse, int B, int T, int Tk, int H, int KVH,
                              int D, long long shift, float scale,
                              void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (T + BLOCK_M - 1) / BLOCK_M > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, seg_q, seg_k, out, lse, B, T,
                                         Tk, H, KVH, shift, scale, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, seg_q, seg_k, out, lse, B,
                                          T, Tk, H, KVH, shift, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* sofa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
